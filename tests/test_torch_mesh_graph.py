"""The port's mesh step and phase 2's selection as JAX compiles them, on
the CPU: `MeshGroup.run(fn, ctx=)` (the per-thread context a capture's
stream and a guard need), the property that lets the card capture a mesh
step and a phase-2 selection as CUDA graphs (nothing read back to the
host, in every shard body: `NoHostReads` is a thread-local torch function
mode, so it is entered through `ctx`), their purity, the plan's graph mode
of a mesh (`mesh_graph_mode`), and the mesh's public handle on its step
(`as_callable`, padded msearch) == the oracle == the JAX package's sharded
searcher on its 8 virtual CPU devices. On the CPU submit_many runs raw_fn
and phase 2 selects eagerly; the graphs are driven on the card by
chip_smoke.py (phase 8g).

The requests of chip_smoke.py's sharded path (c1-c10, mv1, p1, h2) on the
bench deployment at 6000 docs over 4 CPU shards, and its select and
catalog paths' phase-2 requests (p1-p4, tp) unsharded. Every comparison
is exact."""

import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.parallel.shard import make_mesh as jax_mesh
from tantivy_aggregations_tpu.models import flagship as jflag

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.aggs.compile import (ShardedProgram,
                                                         _padded_ranks,
                                                         mesh_graph_mode)
from tantivy_aggregations_tpu_torch.models import flagship as pflag
from tantivy_aggregations_tpu_torch.parallel import shard as SH
from tantivy_aggregations_tpu_torch.query import compile as qc

from test_torch_graph_step import (NoHostReads, _group, _raw_equal,
                                   _request, deps)  # noqa: F401 (fixture)

torch.set_num_threads(2)

#: the sharded path's requests (chip_smoke.py phases 7-8)
MESH_NAMES = [f"c{n}" for n in range(1, 11)] + ["mv1", "p1", "h2"]
#: phase-2 requests: (deployment, name), unsharded
PHASE2 = [("bench", "p1"), ("bench", "p2"), ("bench", "p3"),
          ("bench", "p4"), ("tags", "tp")]


def _guard(s):
    """MeshGroup.run's ctx: NoHostReads in every shard thread."""
    return NoHostReads()


@pytest.fixture(scope="module")
def mesh(deps):  # noqa: F811
    """The bench deployment over 4 CPU shards."""
    return deps["bench"][0].searcher(mesh=tt.make_mesh(devices=["cpu"] * 4))


def _mesh_prog(mesh, name):
    prog = mesh._program_for(*_request(tt, pflag, name))
    assert isinstance(prog, ShardedProgram), (name, prog)
    return prog


def _mesh_raw(prog, reqs, ctx=None, pad_to=None):
    p0 = prog.progs[0]
    rows = [p0._extract(q, a) for q, a in reqs]
    if pad_to is not None:
        rows += rows[-1:] * (pad_to - len(rows))
    return prog.raw_fn(qc.param_matrix(rows, p0._pkeys, "cpu"),
                       [pg._arrays for pg in prog.progs], ctx=ctx)


def _mesh_raw_equal(a, b):
    """Two mesh raw_fn results hold equal tensors: packed, and every
    shard's big state."""
    assert torch.equal(a["packed"], b["packed"])
    assert len(a["big"]) == len(b["big"])
    for x, y in zip(a["big"], b["big"]):
        _raw_equal({"packed": a["packed"], "big": x},
                   {"packed": b["packed"], "big": y})


# ---------------------------------------------------------------------------
# MeshGroup.run's ctx
# ---------------------------------------------------------------------------

class _Record(TorchFunctionMode):
    """Records the torch calls made on this thread, by shard."""

    def __init__(self, s, log):
        super().__init__()
        self.s, self.log = s, log

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.log.append((self.s, threading.get_ident(),
                         getattr(func, "__name__", str(func))))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("S_", [1, 2, 4])
def test_mesh_run_enters_ctx_on_every_shard_thread(S_):
    """ctx(s) is entered on shard s's own thread around its body and its
    collectives, the S = 1 branch (inline) included: each body sees its
    context, and the psum's fold, which runs on the thread of the last
    shard to arrive, runs under that shard's context; ctx is left after
    the run."""
    g = SH.MeshGroup(["cpu"] * S_)
    log, entered, inside = [], [], threading.local()

    class Ctx:
        def __init__(self, s):
            self.s, self.mode = s, _Record(s, log)

        def __enter__(self):
            entered.append((self.s, threading.get_ident()))
            inside.s = self.s
            self.mode.__enter__()

        def __exit__(self, *exc):
            self.mode.__exit__(*exc)
            inside.s = None

    def body(s):
        assert getattr(inside, "s", None) == s
        got = SH.psum(torch.full((3,), s + 1))
        assert getattr(inside, "s", None) == s
        return threading.get_ident(), got

    out = g.run(body, ctx=Ctx)
    want = torch.full((3,), S_ * (S_ + 1) // 2)
    assert all(torch.equal(t, want) for _, t in out)
    assert sorted(entered) == sorted((s, out[s][0]) for s in range(S_))
    if S_ == 1:
        assert out[0][0] == threading.get_ident()
    else:
        # the fold's adds run on the last shard's thread, under its ctx
        adds = [(s, th) for s, th, f in log if f == "add"]
        assert adds and all(s == S_ - 1 and th == out[S_ - 1][0]
                            for s, th in adds)
    assert getattr(inside, "s", None) is None
    # without ctx nothing is entered
    entered.clear()
    g.run(lambda s: SH.psum(torch.ones(2)))
    assert entered == []


def test_mesh_run_ctx_error_raises():
    """A ctx that raises in one shard stops the run with its error; the
    other shards do not hang."""
    g = SH.MeshGroup(["cpu"] * 3)

    class Boom:
        def __init__(self, s):
            self.s = s

        def __enter__(self):
            if self.s == 1:
                raise ValueError("ctx of shard 1")

        def __exit__(self, *exc):
            return False

    with pytest.raises(ValueError, match="ctx of shard 1"):
        g.run(lambda s: SH.psum(torch.ones(2)), ctx=Boom)
    assert [t.tolist() for t in g.run(lambda s: SH.psum(torch.ones(1)))] \
        == [[3.0]] * 3


# ---------------------------------------------------------------------------
# the mesh step: nothing read back, pure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MESH_NAMES)
def test_mesh_step_reads_nothing_back(deps, mesh, name):  # noqa: F811
    """The mesh raw_fn at B = 1 and 3 with NoHostReads entered in every
    shard body (MeshGroup.run's ctx): nothing is read back to the host in
    any shard body or collective, and the fruits == the oracle."""
    oracle = deps["bench"][0].oracle_searcher()
    prog = _mesh_prog(mesh, name)
    reqs = [_request(tt, pflag, name, k) for k in range(3)]
    for rs in (reqs[:1], reqs):
        raw = _mesh_raw(prog, rs, ctx=_guard)
        got = prog.finalize_many(raw, rs[0][1], len(rs))
        assert got == [oracle.agg_search(*r) for r in rs], name


def test_mesh_guard_is_not_vacuous(mesh):
    """A host read inside a shard body raises through the mesh's ctx (the
    guard reaches the shard threads)."""
    g = mesh._get_device_index().mesh
    with pytest.raises(AssertionError, match="host read"):
        g.run(lambda s: SH.psum(torch.ones(2)).sum().item(), ctx=_guard)
    with pytest.raises(AssertionError, match="host read"):
        g.run(lambda s: torch.tensor([s]), ctx=_guard)


@pytest.mark.parametrize("name", ["c5", "c9", "p1", "h2"])
def test_mesh_raw_fn_is_pure(mesh, name):
    """Two mesh raw_fn calls on one param matrix give equal packed and
    every shard's big, and a call on other requests between them changes
    neither."""
    prog = _mesh_prog(mesh, name)
    reqs = [_request(tt, pflag, name, k) for k in range(3)]
    first = _mesh_raw(prog, reqs, pad_to=4)
    kept = {"packed": first["packed"].clone(),
            "big": [{p: {k: v.clone() if torch.is_tensor(v) else v
                         for k, v in st.items()} for p, st in b.items()}
                    for b in first["big"]]}
    _mesh_raw(prog, [_request(tt, pflag, name, k) for k in (5, 6)])
    again = _mesh_raw(prog, reqs, pad_to=4)
    _mesh_raw_equal(first, kept)
    _mesh_raw_equal(again, kept)
    assert all(pg._ind_cache is None and pg._big is None
               for pg in prog.progs)


# ---------------------------------------------------------------------------
# phase 2's selection: nothing read back, pure, == the eager selection
# ---------------------------------------------------------------------------

def _phase2_case(prog, reqs, B, pad):
    """(raw fruits at the padded batch, host records, host ranks) of a
    phase-2 program's group: what finalize_many has when it selects."""
    p0 = getattr(prog, "progs", [prog])[0]
    if isinstance(prog, ShardedProgram):
        raw = _mesh_raw(prog, reqs[:B], pad_to=pad)
        big0 = raw["big"][0]
    else:
        rows = [prog._extract(q, a) for q, a in reqs[:B]]
        rows += rows[-1:] * (pad - B)
        raw = prog.raw_fn(qc.param_matrix(rows, prog._pkeys, "cpu"),
                          prog._arrays)
        big0 = raw["big"]
    vecs = prog.stage(raw, reqs[0][1]).numpy()
    hosts = [p0._unpack_host(vecs[b]) for b in range(B)]
    return raw, hosts, p0._phase2_ranks(hosts, big0)


def _raw_select(prog, raw, ranks, ctx=None):
    """{path: [Bp, ...]} the raw selection of each node over the whole
    padded state, the ranks already on the device (padded with zero rows:
    _padded_ranks), as the captured graph runs it."""
    out = {}
    for path, rk in ranks:
        if isinstance(prog, ShardedProgram):
            Bp = raw["big"][0][path]["cum"].shape[0]
            r = _padded_ranks(rk, Bp)
            out[path] = prog.mesh.run(
                lambda s: prog.progs[s].select_raw(
                    path, raw["big"][s][path], prog.progs[s]._arrays, r),
                ctx=ctx)[0]
        else:
            Bp = raw["big"][path]["cum"].shape[0]
            r = _padded_ranks(rk, Bp)
            if ctx is None:
                out[path] = prog.select_raw(path, raw["big"][path],
                                            prog._arrays, r)
            else:
                with ctx(0):
                    out[path] = prog.select_raw(path, raw["big"][path],
                                                prog._arrays, r)
    return out


def _phase2_progs(deps, mesh):  # noqa: F811
    """[(label, program, requests)] of the phase-2 cases."""
    out = []
    for dep, name in PHASE2:
        s = deps[dep][0].searcher(device="cpu")
        reqs = _group(tt, pflag, name, range(4))
        out.append((f"{name} unsharded", s._program_for(*reqs[0]), reqs))
    reqs = _group(tt, pflag, "p1", range(4))
    out.append(("p1 mesh", mesh._program_for(*reqs[0]), reqs))
    return out


@pytest.mark.parametrize("case", range(len(PHASE2) + 1))
def test_phase2_selection_reads_nothing_back(deps, mesh, case):  # noqa: F811
    """Phase 2's raw selection (select_raw: what its graph captures) of
    every node at B = 1 and 3 (padded to 4), the host ranks already on the
    device, under NoHostReads (in every shard body on the mesh): nothing
    is read back; two calls give equal rows (pure); its first B rows ==
    the eager _phase2_select's; and the fruits == the oracle."""
    label, prog, reqs = _phase2_progs(deps, mesh)[case]
    dep = PHASE2[case][0] if case < len(PHASE2) else "bench"
    oracle = deps[dep][0].oracle_searcher()
    assert any(isinstance(p, dict) and p.get("kind") == "percentiles"
               and not p["int_percents"] for p in prog.plan.values()), label
    for B, pad in ((1, 1), (3, 4)):
        raw, hosts, ranks = _phase2_case(prog, reqs, B, pad)
        got = _raw_select(prog, raw, ranks, ctx=_guard)
        again = _raw_select(prog, raw, ranks)
        eager = prog._phase2_select(ranks, raw["big"], B)
        assert got.keys() == eager.keys() == dict(ranks).keys()
        for path in got:
            assert got[path].shape[0] == pad
            assert torch.equal(got[path], again[path]), (label, path)
            assert torch.equal(got[path][:B], eager[path]), (label, path)
        fruits = prog.finalize_many(raw, reqs[0][1], B)
        assert fruits == [oracle.agg_search(*r) for r in reqs[:B]], label


def test_padded_ranks():
    """Host ranks padded to the graph's batch with zero rows."""
    rk = np.arange(12, dtype=np.int64).reshape(2, 3, 2)
    got = _padded_ranks(rk, 4)
    assert got.dtype == torch.int64 and tuple(got.shape) == (4, 3, 2)
    assert np.array_equal(got[:2].numpy(), rk) and not got[2:].any()


# ---------------------------------------------------------------------------
# the plan's graph mode on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices, graph", [
    (["cpu"] * 4, True), (["cpu"], True), (["cuda:0"] * 4, True),
    (["cuda:0"], True), (["cuda:0", "cuda:1"], False),
    (["cuda:0", "cuda:1", "cuda:0", "cuda:1"], False),
    ([torch.device("cuda", i) for i in range(4)], False)])
def test_mesh_graph_mode(devices, graph):
    """One device -> the step and phase 2 captured; two or more distinct
    devices -> eager, with the reason (graphs across cards need a machine
    with two or more cards). A function of the device list alone."""
    got, reason = mesh_graph_mode(devices)
    assert got is graph
    if graph:
        assert reason is None
    else:
        assert "two or more cards" in reason and \
            f"{len({str(d) for d in devices})} devices" in reason


def test_mesh_plans_record_the_graph_mode(mesh):
    """Every program of the sharded path on one device plans its step
    captured, on the mesh and on every shard, with no node marked
    eager."""
    for name in MESH_NAMES:
        prog = _mesh_prog(mesh, name)
        for plan in [prog.plan] + [pg.plan for pg in prog.progs]:
            assert plan["graph"] is True and "graph_reason" not in plan
            assert not [p for p in plan.values()
                        if isinstance(p, dict) and "graph" in p], name


# ---------------------------------------------------------------------------
# the mesh's public handle on its step == the oracle == JAX's sharded
# searcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_searcher(deps):  # noqa: F811
    """The JAX package's searcher over the bench deployment on its 8
    virtual CPU devices."""
    return deps["bench"][1].searcher(mesh=jax_mesh(8))


@pytest.mark.parametrize("name", ["c1", "c5", "c9", "p1", "h2"])
def test_mesh_as_callable_and_padded_msearch(deps, mesh, jax_mesh_searcher,
                                            name):  # noqa: F811
    """as_callable() on the mesh: the step on its own example inputs
    answers the program's request; submit_many(..., pad_to=4) on 3
    requests and a padded msearch of 7 requests (5 distinct, padded to 8)
    == the oracle == the JAX package's sharded searcher."""
    oracle = deps["bench"][0].oracle_searcher()
    q, aggs = _request(tt, pflag, name)
    prog = _mesh_prog(mesh, name)
    fn, args = prog.as_callable()
    assert fn == prog.raw_fn and args[1] == [pg._arrays for pg in prog.progs]
    want = oracle.agg_search(q, aggs)
    assert prog.finalize(fn(*args), aggs) == want
    reqs = _group(tt, pflag, name, range(3))
    raw = prog.submit_many([r for r, _ in reqs], reqs[0][1], pad_to=4)
    assert raw["packed"].shape[0] == 4
    got = prog.finalize_many(raw, reqs[0][1], 3)
    assert got == [oracle.agg_search(*r) for r in reqs]
    ks = [0, 1, 2, 0, 3, 4, 1]
    batch = mesh.agg_search_batch(_group(tt, pflag, name, ks))
    assert batch == [oracle.agg_search(*r)
                     for r in _group(tt, pflag, name, ks)]
    assert batch == jax_mesh_searcher.agg_search_batch(
        _group(tat, jflag, name, ks))


def test_mesh_searcher_pads_within_the_cap(deps, monkeypatch):  # noqa: F811
    """A mesh searcher pads each group of two or more distinct requests to
    the next power of two within the group's cap (max_batch and the
    ShardedProgram's batch_cap): the padded B a mesh graph is captured at
    never exceeds the cap; the fruits == the oracle."""
    import dataclasses
    s = deps["bench"][0].searcher(mesh=tt.make_mesh(devices=["cpu"] * 2))
    s.config = dataclasses.replace(s.config, max_batch=12)
    reqs = _group(tt, pflag, "c5", range(20))
    prog = s._program_for(*reqs[0])
    assert isinstance(prog, ShardedProgram)
    seen = []
    real = prog.submit_many

    def submit_many(queries, aggs, pad_to=None):
        seen.append((len(queries), pad_to))
        return real(queries, aggs, pad_to=pad_to)
    monkeypatch.setattr(prog, "submit_many", submit_many)
    oracle = deps["bench"][0].oracle_searcher()
    assert s.agg_search_batch(reqs[:17]) == \
        [oracle.agg_search(*r) for r in reqs[:17]]
    assert seen == [(12, 12), (5, 8)]
    monkeypatch.setattr(prog, "batch_cap", 6)
    seen.clear()
    assert list(s.agg_search_stream(iter(reqs[:11]), lookahead=2)) == \
        [oracle.agg_search(*r) for r in reqs[:11]]
    assert seen == [(6, 6), (5, 6)]
