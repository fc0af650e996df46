"""The port's device step as JAX compiles it, on the CPU: `Program.raw_fn`
/ `example_inputs` / `as_callable` (JAX's public handle on the step),
`submit_many(..., pad_to=)` and the searcher's power-of-two msearch
padding, and the property that lets the card capture the step as a CUDA
graph: raw_fn reads nothing back to the host. On the CPU submit_many runs
raw_fn itself; the graphs are driven on the card by chip_smoke.py.

The requests of chip_smoke.py's unsharded paths (row, default, multi,
tags, select, catalog, nomop; one of each where a case is parametrized
by path) at small sizes: the bench deployment (the JAX flagship writer,
6000 docs) and the tags / catalog deployment (chip_smoke.py's columns,
3000 docs). Every comparison is exact `==` against the port's oracle
and, where the JAX package has the call, the JAX package (Pallas in
interpret mode)."""

import dataclasses

import pytest
import torch
from torch.overrides import TorchFunctionMode

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.models import flagship as jflag

import chip_smoke as S
import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.aggs.compile import (Program,
                                                         ShardedProgram)
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as pflag
from tantivy_aggregations_tpu_torch.searcher import _HostFallback

from fixtures import basic_index
from test_torch_multi_query import persist

torch.set_num_threads(2)

ROW = EngineConfig(**S.ROW_MODES)
NOMOP = EngineConfig(**S.NOMOP)
#: the requests of chip_smoke.py's unsharded paths, by path: (deployment,
#: config, names); c-names are models/flagship.py configs
PATHS = {
    "row": ("bench", ROW, [f"c{n}" for n in range(1, 11)]),
    "default": ("bench", EngineConfig(), [f"c{n}" for n in range(1, 11)]),
    "multi": ("bench", EngineConfig(),
              ["mv1", "mv2", "mv3", "mv5", "mv6", "mv7"]),
    "tags": ("tags", EngineConfig(), ["t1", "t2", "t3"]),
    "select": ("bench", EngineConfig(), ["p1", "p2", "p3", "p4", "h1", "h2",
                                         "h3", "h4", "h5"]),
    "catalog": ("tags", EngineConfig(), ["tp", "th", "f1", "f2", "f3",
                                         "f4"]),
    "nomop": ("bench", NOMOP, ["c7"]),
}
#: one request of each path, for the padding and purity cases
ONE = {"row": "c5", "default": "c9", "multi": "mv7", "tags": "t1",
       "select": "p2", "catalog": "th", "nomop": "c7"}
JAX_CONFIGS = {"row": dict(use_cube=False, dense_mxu=False),
               "nomop": dict(use_member_ops=False)}


class NoHostReads(TorchFunctionMode):
    """Raises on every torch call that reads a tensor back to the host or
    waits for the device on the card (and so cannot run inside a CUDA
    graph capture): item / tolist / cpu / numpy, truth tests and int /
    float conversions, nonzero, unique, masked_select and boolean-mask
    indexing, bincount and tensor-count repeat_interleave (their output
    size), and host -> device uploads (torch.tensor / as_tensor, `.to`
    of a device)."""

    READS = {"item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__", "nonzero", "unique",
             "unique_consecutive", "masked_select", "bincount", "tensor",
             "as_tensor", "cuda"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if name in self.READS:
            raise AssertionError(f"host read in the device step: {name}")
        if name == "__getitem__" and _bool_index(args[1]):
            raise AssertionError("host read in the device step: a "
                                 "boolean-mask index")
        if name == "repeat_interleave" and len(args) > 1 \
                and torch.is_tensor(args[1]):
            raise AssertionError("host read in the device step: "
                                 "repeat_interleave by a tensor")
        if name == "to" and any(isinstance(a, (str, torch.device))
                                for a in (*args[1:], kwargs.get("device"))):
            raise AssertionError("host read in the device step: .to(a "
                                 "device)")
        return func(*args, **kwargs)


def _bool_index(ix) -> bool:
    items = ix if isinstance(ix, tuple) else (ix,)
    return any(torch.is_tensor(i) and i.dtype == torch.bool for i in items)


# ---------------------------------------------------------------------------
# deployments
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deps(tmp_path_factory):
    """{"bench" | "tags": (port Index, JAX Index)}."""
    root = tmp_path_factory.mktemp("graph")
    bench = str(root / "bench")
    jflag.build_bench_index(bench, 6000, seed=11, n_segments=2)
    tags = root / "tags"
    S.build_columnar_index(tt, tags, S.tags_schema(tt),
                           S.tags_columns(3000, 7), 3000, 2)
    return {name: (tt.Index.open(str(p)), tat.Index.open(str(p)))
            for name, p in (("bench", bench), ("tags", tags))}


def _request(mod, flag, name, k=0):
    """(query, aggs) of request `name` with parameter set k, in the IR of
    `mod` (tt or tat; `flag` its models.flagship): c1-c10 from the
    flagship's varied requests, the rest chip_smoke.py's."""
    if name.startswith("c"):
        n = int(name[1:])
        trees = dict(enumerate((a for _, _, a in flag.judged_configs()), 1))
        trees.update((c[0], c[3]) for c in flag.extra_configs())
        return flag.varied_requests(n, trees[n], k + 1)[k]
    return S.multi_requests(mod, name, k)


def _searcher(deps, path, **kw):
    dep, config, _ = PATHS[path]
    return deps[dep][0].searcher(device="cpu",
                                 config=dataclasses.replace(config, **kw))


def _jax_searcher(deps, path):
    dep = PATHS[path][0]
    return deps[dep][1].searcher(config=JaxConfig(
        pallas_interpret=True, **JAX_CONFIGS.get(path, {})))


def _planned(deps, path):
    """[(name, query, aggs, Program)] of every request of the path that
    plans a device Program."""
    s = _searcher(deps, path)
    out = []
    for name in PATHS[path][2]:
        q, aggs = _request(tt, pflag, name)
        prog = s._program_for(q, aggs)
        assert isinstance(prog, Program), (name, prog)
        out.append((name, q, aggs, prog))
    return out


# ---------------------------------------------------------------------------
# the public handle on the step
# ---------------------------------------------------------------------------

def test_program_public_entry_surface(tmp_path):
    """JAX's test_program_public_entry_surface (tests/test_features.py):
    `fn, args = prog.as_callable()`; `prog.finalize(fn(*args), aggs)` ==
    the oracle == the JAX package's. A [1, P] int32 param matrix takes
    the place of JAX's params dict."""
    path = persist(basic_index(), str(tmp_path / "idx"))
    idx, jidx = tt.Index.open(path), tat.Index.open(path)
    aggs = {"n": tt.count_agg(), "s": tt.sum_agg("qty")}
    q = tt.TermQuery("cat", "a")
    prog = idx.searcher(device="cpu")._program_for(q, aggs)
    fn, args = prog.as_callable()
    pmat, arrays = args
    assert fn == prog.raw_fn and arrays is prog._arrays
    assert pmat.dtype == torch.int32 and tuple(pmat.shape) == (
        1, len(prog._pkeys))
    got = prog.finalize(fn(*args), aggs)
    assert got == idx.oracle_searcher().agg_search(q, aggs)
    jaggs = {"n": tat.count_agg(), "s": tat.sum_agg("qty")}
    jprog = jidx.searcher()._program_for(tat.TermQuery("cat", "a"), jaggs)
    jfn, jargs = jprog.as_callable()
    assert got == jprog.finalize(jfn(*jargs), jaggs)


def test_example_inputs_answer_every_path(deps):
    """as_callable() on one request of each path: the step on its own
    example inputs answers the program's request == the oracle."""
    for path, name in ONE.items():
        s = _searcher(deps, path)
        q, aggs = _request(tt, pflag, name)
        prog = s._program_for(q, aggs)
        fn, args = prog.as_callable()
        assert prog.finalize(fn(*args), aggs) == \
            deps[PATHS[path][0]][0].oracle_searcher().agg_search(q, aggs), \
            path


# ---------------------------------------------------------------------------
# raw_fn: pure, and nothing read back to the host
# ---------------------------------------------------------------------------

def _raw_equal(a, b):
    """Two raw_fn results hold equal tensors (packed, and every big
    state's)."""
    assert torch.equal(a["packed"], b["packed"])
    assert a["big"].keys() == b["big"].keys()
    for path, st in a["big"].items():
        for k, v in st.items():
            w = b["big"][path][k]
            assert torch.equal(v, w) if torch.is_tensor(v) else v == w


def _pmat(prog, reqs):
    from tantivy_aggregations_tpu_torch.query import compile as qc
    return qc.param_matrix([prog._extract(q, a) for q, a in reqs],
                           prog._pkeys, "cpu")


@pytest.mark.parametrize("path", list(ONE))
def test_raw_fn_is_pure(deps, path):
    """Two raw_fn calls on one param matrix give equal packed and big,
    and a call on other requests between them changes neither; the
    program keeps no state of a run after it."""
    s = _searcher(deps, path)
    name = ONE[path]
    reqs = [_request(tt, pflag, name, k) for k in range(3)]
    other = [_request(tt, pflag, name, k) for k in range(5, 7)]
    prog = s._program_for(*reqs[0])
    pm = _pmat(prog, reqs)
    first = prog.raw_fn(pm, prog._arrays)
    kept = {"packed": first["packed"].clone(),
            "big": {path: {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in st.items()}
                    for path, st in first["big"].items()}}
    before = {k: v for k, v in vars(prog).items() if k != "_pack_spec"}
    prog.raw_fn(_pmat(prog, other), prog._arrays)
    again = prog.raw_fn(pm, prog._arrays)
    _raw_equal(first, kept)
    _raw_equal(again, kept)
    assert prog._ind_cache is None and prog._big is None
    assert {k: v for k, v in vars(prog).items()
            if k != "_pack_spec"}.keys() == before.keys()


@pytest.mark.parametrize("path", list(PATHS))
def test_raw_fn_reads_nothing_back(deps, path):
    """The CPU stand-in for "capturable": raw_fn on every planned request
    of the path, at B = 1 and B = 3, under a torch function mode that
    raises on every host read (NoHostReads); the fruits == the oracle."""
    oracle = deps[PATHS[path][0]][0].oracle_searcher()
    for name, q, aggs, prog in _planned(deps, path):
        reqs = [_request(tt, pflag, name, k) for k in range(3)]
        for rs in (reqs[:1], reqs):
            pm = _pmat(prog, rs)
            with NoHostReads():
                raw = prog.raw_fn(pm, prog._arrays)
            got = prog.finalize_many(raw, aggs, len(rs))
            assert got == [oracle.agg_search(*r) for r in rs], name


def test_no_host_reads_catches_reads():
    """The guard is not vacuous: each kind of read it names raises."""
    x = torch.arange(6)
    for read in (lambda: x[1].item(), lambda: bool(x.sum()),
                 lambda: x.nonzero(), lambda: x[x > 2], lambda: x.cpu(),
                 lambda: x.tolist(), lambda: torch.unique(x),
                 lambda: torch.tensor([1]), lambda: x.to("cpu"),
                 lambda: int(x[0]), lambda: x.masked_select(x > 1)):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostReads():
                read()


# ---------------------------------------------------------------------------
# padding (JAX searcher.py: every msearch group of two or more distinct
# requests at the next power of two)
# ---------------------------------------------------------------------------

def _group(mod, flag, name, ks):
    """Requests `name` with parameter sets ks, sharing one agg tree (a
    group of one shape)."""
    aggs = _request(mod, flag, name, ks[0])[1]
    return [(_request(mod, flag, name, k)[0], aggs) for k in ks]


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("path", list(ONE))
def test_submit_many_pad_to(deps, path, n):
    """submit_many(..., pad_to=8) on n distinct requests: the first n
    rows' fruits == the oracle == JAX's submit_many(..., pad_to=8); the
    padded rows repeat the last request."""
    name = ONE[path]
    reqs = _group(tt, pflag, name, range(n))
    jreqs = _group(tat, jflag, name, range(n))
    prog = _searcher(deps, path)._program_for(*reqs[0])
    raw = prog.submit_many([q for q, _ in reqs], reqs[0][1], pad_to=8)
    assert raw["packed"].shape[0] == 8
    assert torch.equal(raw["packed"][n:],
                       raw["packed"][n - 1:n].expand(8 - n, -1))
    got = prog.finalize_many(raw, reqs[0][1], n)
    oracle = deps[PATHS[path][0]][0].oracle_searcher()
    assert got == [oracle.agg_search(*r) for r in reqs]
    jprog = _jax_searcher(deps, path)._program_for(*jreqs[0])
    jraw = jprog.submit_many([q for q, _ in jreqs], jreqs[0][1], pad_to=8)
    assert got == jprog.finalize_many(jraw, jreqs[0][1], n)


@pytest.mark.parametrize("path", list(ONE))
def test_padded_msearch_with_dedup(deps, path):
    """agg_search_batch with dedup on over 7 requests of 5 distinct param
    sets (one group, padded to 8) == the JAX package's padded searcher ==
    the oracle, in request order."""
    name = ONE[path]
    ks = [0, 1, 2, 0, 3, 4, 1]
    reqs = _group(tt, pflag, name, ks)
    got = _searcher(deps, path).agg_search_batch(reqs)
    oracle = deps[PATHS[path][0]][0].oracle_searcher()
    assert got == [oracle.agg_search(*r) for r in reqs]
    assert got == _jax_searcher(deps, path).agg_search_batch(
        _group(tat, jflag, name, ks))


def test_searcher_pads_groups_to_powers_of_two(deps, monkeypatch):
    """The searcher submits a group of one distinct request at B = 1 and
    any other at the next power of two, capped at the group's cap
    (max_batch and Program.batch_cap); the stream pads as the batch
    does."""
    s = _searcher(deps, "row", max_batch=12, msearch_dedup=True)
    reqs = _group(tt, pflag, "c5", range(40))
    prog = s._program_for(*reqs[0])
    seen = []
    real = prog.submit_many

    def submit_many(queries, aggs, pad_to=None):
        seen.append((len(queries), pad_to))
        return real(queries, aggs, pad_to=pad_to)
    monkeypatch.setattr(prog, "submit_many", submit_many)
    oracle = deps["bench"][0].oracle_searcher()
    for sizes, want in (([3, 5], [(3, 4), (5, 8)]),
                        ([9, 1, 12], [(9, 12), (1, None), (12, 12)])):
        seen.clear()
        got, at = [], 0
        for n in sizes:
            group = reqs[at:at + n]
            at += n
            got += s.agg_search_batch(group)
        assert seen == want
        assert got == [oracle.agg_search(*r) for r in reqs[:at]]
    seen.clear()
    assert list(s.agg_search_stream(iter(reqs[:17]), lookahead=2)) == \
        [oracle.agg_search(*r) for r in reqs[:17]]
    assert seen == [(12, 12), (5, 8)]
    monkeypatch.setattr(prog, "batch_cap", 6)
    seen.clear()
    s.agg_search_batch(reqs[:11])
    assert seen == [(6, 6), (5, 6)]


# ---------------------------------------------------------------------------
# the plan's execution mode
# ---------------------------------------------------------------------------

def _graph_flags(plan):
    """{node path: its "graph" entry} of the nodes that carry one."""
    return {path: p["graph"] for path, p in plan.items()
            if isinstance(p, dict) and "graph" in p}


@pytest.mark.parametrize("path", list(PATHS))
def test_plan_records_the_graph_mode(deps, path):
    """Every unsharded Program of every path plans its step captured
    (plan["graph"] True, no reason), and no node is marked eager: a
    non-integer percentile node's phase-2 selection replays a graph of
    its own on the card too."""
    for name, _, _, prog in _planned(deps, path):
        assert prog.plan["graph"] is True and \
            "graph_reason" not in prog.plan, name
        assert _graph_flags(prog.plan) == {}, name


def test_sharded_replica_and_host_programs_stay_eager(deps):
    """Mesh and replica programs on one device plan a graph; the host
    path stays eager. A mesh's and a replica group's programs (two CPU
    shards of one device; one-shard groups) plan their step captured, on
    the mesh and every shard, with no reason; the step still answers
    through raw_fn / as_callable == the oracle (the CPU runs raw_fn); a
    host-path shape has no device plan at all."""
    idx = deps["bench"][0]
    oracle = idx.oracle_searcher()
    reqs = _group(tt, pflag, "p1", range(3))
    mesh = idx.searcher(mesh=tt.make_mesh(devices=["cpu"] * 2))
    rep = tt.ReplicatedSearcher(idx, replicas=2, devices=["cpu"] * 2)
    for s in (mesh, rep.searchers[0], rep.searchers[1]):
        prog = s._program_for(*reqs[0])
        assert isinstance(prog, ShardedProgram)
        for plan in [prog.plan] + [pg.plan for pg in prog.progs]:
            assert plan["graph"] is True and "graph_reason" not in plan
            assert _graph_flags(plan) == {}
        fn, args = prog.as_callable()
        assert prog.finalize(fn(*args), reqs[0][1]) == \
            oracle.agg_search(*reqs[0])
        raw = prog.submit_many([q for q, _ in reqs], reqs[0][1], pad_to=4)
        assert prog.finalize_many(raw, reqs[0][1], 3) == \
            [oracle.agg_search(*r) for r in reqs]
    fb = _searcher(deps, "default")._program_for(
        *S.multi_requests(tt, "deep_multi_nest", 0))
    assert isinstance(fb, _HostFallback) and not hasattr(fb, "plan")


def test_graph_output_buffers_keep_shared_rows():
    """A captured step's output buffers (_static_like / _out_view): a
    batch-stride-0 output keeps one row and is seen at its full shape
    again; any other output is a contiguous buffer of its own shape."""
    from tantivy_aggregations_tpu_torch.aggs.compile import (_out_view,
                                                             _static_like)
    rows = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    shared = rows[:1].expand(5, 4)
    for t in (rows, shared, rows.t(), torch.arange(3)):
        buf = _static_like(t)
        assert buf.is_contiguous() and buf.dtype == t.dtype
        assert buf.shape[0] == (1 if t is shared else t.shape[0])
        buf.copy_(t[:1] if t is shared else t)
        view = _out_view(buf.clone(), t.shape)
        assert view.shape == t.shape and torch.equal(view, t)
        assert (view.stride(0) == 0) == (t is shared)


class _FakeProgram:
    def __init__(self):
        self._graphs = {}


class _FakeGraph:
    serial = None

    def __init__(self, nbytes):
        self.nbytes = nbytes


def _book(budget):
    """A _GraphBook whose pools are numbered from 1 (the card's hands out
    torch.cuda.graph_pool_handle()s)."""
    from tantivy_aggregations_tpu_torch.aggs.compile import _GraphBook
    pools = iter(range(1, 100))
    return _GraphBook(lambda: next(pools), budget=budget)


def _capture(book, prog, B, nbytes, grown):
    g = prog._graphs[B] = _FakeGraph(nbytes)
    g.pool = book.pool
    book.add(prog, B, g, grown)
    return g


def test_graph_book_drops_least_recently_used_graphs():
    """Past its budget the book drops the least recently replayed graphs
    from their programs, counting each graph's own buffers and its pool's
    growth, and starts a new pool once a graph of the current one went."""
    book = _book(100)
    a, b = _FakeProgram(), _FakeProgram()
    ga = _capture(book, a, 1, 30, 0)
    _capture(book, b, 1, 30, 10)
    assert book.total() == 70 and book.dropped == 0
    book.touch(ga)  # replayed: b's graph is now the least recent
    _capture(book, a, 4, 30, 20)
    assert book.dropped == 1 and 1 not in b._graphs
    assert sorted(a._graphs) == [1, 4] and book.total() == 90
    assert book.pool == 2 and book.pools == {1: [30, 2]}
    _capture(book, b, 1, 30, 5)  # b's next use captures again, in pool 2
    assert book.dropped == 2 and list(a._graphs) == [4]
    # a's graph at B = 1 was of pool 1, no longer the current one
    assert book.total() == 95 and book.pool == 2
    assert book.pools == {1: [30, 1], 2: [5, 1]}


def test_graph_book_forgets_graphs_that_die_with_their_program():
    """A program the searcher's LRU evicts takes its graphs along; they
    leave the book, and a pool no graph is left in leaves the total."""
    book = _book(10 << 20)
    a, b = _FakeProgram(), _FakeProgram()
    _capture(book, a, 1, 8, 100)
    _capture(book, a, 2, 8, 0)
    book.pool = 7  # as after a drop: later captures go to a new pool
    _capture(book, b, 1, 8, 50)
    assert book.total() == 174
    del a
    assert len(book.graphs) == 1 and book.total() == 58
    assert book.pools == {7: [50, 1]} and book.dropped == 0


def test_graph_book_keeps_the_newest_graph_over_budget():
    """A capture whose pool alone exceeds the budget leaves the newest
    graph booked and drops every other."""
    book = _book(100)
    progs = [_FakeProgram() for _ in range(3)]
    for p in progs[:2]:
        _capture(book, p, 1, 10, 0)
    g = _capture(book, progs[2], 1, 10, 500)
    assert list(book.graphs) == [g.serial] and book.dropped == 2
    assert [list(p._graphs) for p in progs] == [[], [], [1]]


def test_graph_book_starts_a_new_pool_when_its_graphs_die():
    """When the last graph of the current pool dies (its program evicted,
    or its graphs cleared), later captures go to a new pool: the caching
    allocator refuses a capture into a pool it has released. A pool with
    graphs alive stays current."""
    book = _book(1 << 20)
    a, b = _FakeProgram(), _FakeProgram()
    _capture(book, a, 1, 8, 10)
    _capture(book, b, 1, 8, 20)
    assert book.pool == 1
    a._graphs.clear()
    assert book.pool == 1 and book.pools == {1: [30, 1]}
    del b._graphs[1]
    assert book.pool == 2 and book.pools == {} and book.total() == 0
    g = _capture(book, a, 4, 8, 5)
    assert g.pool == 2 and book.pools == {2: [5, 1]}
