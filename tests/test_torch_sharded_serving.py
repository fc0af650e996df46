"""Serving on a mesh in the PyTorch port, on the CPU: replica groups
(`ReplicatedSearcher`, R in {2, 4, 8} over eight CPU devices, the JAX
package's test_replicated_searcher), msearch, the stream and phase 2 on a
mesh (test_msearch.py's mesh cases), the cube with per-shard operands
(test_cube.py's sharded cases: one common piece layout, int32 dot vectors
psum'd, the build-row bound per shard), shapes the sharded planners refuse
(test_never_raise.py's mesh case), the cube's shard bound (S <= 128,
asserted) and make_mesh's defaults. Fruits port == JAX == oracle with
sharded plan parity (test_torch_sharded.py's harness)."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu import (
    MatchAllQuery,
    RangeQuery,
    SchemaBuilder,
    TermQuery,
    avg_agg,
    count_agg,
    filter_agg,
    histogram_agg,
    percentiles_agg,
    stats_agg,
    sum_agg,
    terms_agg,
)
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.ops import cube as jax_cube

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.ops import cube as C

from fixtures import basic_index, random_index
from test_cube import AGGS as CUBE_AGGS, QUERIES as CUBE_QUERIES, \
    build_index as cube_index
from test_never_raise import multi_index
from test_torch_multi_query import persist, to_port
from test_torch_sharded import mesh_env, sharded_check


def _port_reqs(reqs):
    return [(to_port(q), to_port(a)) for q, a in reqs]


@pytest.mark.parametrize("R", [2, 4, 8])
def test_replicated_searcher(tmp_path_factory, R):
    """R replica groups over eight devices, round-robin msearch: results
    == the oracle's and the JAX package's, in request order; every replica
    serves; the single-query API rotates."""
    path = persist(random_index(seed=77, n_docs=2000),
                   str(tmp_path_factory.mktemp("rep") / "ix"))
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    o = pidx.oracle_searcher()
    aggs = {"n": count_agg(), "s": sum_agg("qty"),
            "t": terms_agg("cat", size=5, sub_aggs={"a": avg_agg("price")})}
    aggs2 = {"h": histogram_agg("qty", interval=100)}
    reqs = []
    for j in range(37):  # several chunks, mixed shapes mid-stream
        q = (RangeQuery("qty", lower=j * 9) if j % 3
             else TermQuery("cat", "cat0001"))
        reqs.append((q, aggs if j % 5 else aggs2))
    preqs = _port_reqs(reqs)
    want = [o.agg_search(q, a) for q, a in preqs]
    rs = tt.ReplicatedSearcher(pidx, replicas=R, devices=["cpu"] * 8,
                               config=EngineConfig(max_batch=4))
    assert rs.replicas == R
    assert all(s._get_device_index().n_shards == 8 // R
               for s in rs.searchers)
    assert rs.agg_search_batch(preqs) == want
    assert list(rs.agg_search_stream(iter(preqs), lookahead=2)) == want
    assert all(len(s._programs) > 0 for s in rs.searchers)
    assert rs.agg_search(*preqs[0]) == want[0]
    assert rs.agg_search(*preqs[1]) == want[1]
    jrs = tat.ReplicatedSearcher(jidx, replicas=R,
                                 config=JaxConfig(max_batch=4))
    assert jrs.agg_search_batch(reqs) == want


def test_msearch_on_sharded_mesh(tmp_path):
    env = mesh_env(persist(basic_index(num_segments=2),
                           str(tmp_path / "ix")), 8)
    aggs = {"n": count_agg(), "s": sum_agg("price")}
    reqs = [(TermQuery("cat", c), aggs) for c in ["a", "b", "c", "a", "b"]]
    sharded_check(env, *reqs[0])
    preqs = _port_reqs(reqs)
    want = [env["oracle"].agg_search(q, a) for q, a in preqs]
    assert env["port"].agg_search_batch(preqs) == want
    assert env["jax"].agg_search_batch(reqs) == want


def test_stream_with_percentiles_and_mesh(tmp_path):
    env = mesh_env(persist(random_index(61, n_docs=300, n_segments=2),
                           str(tmp_path / "ix")), 8)
    aggs = {"p": percentiles_agg("price"),                 # in-run ranks
            "pn": percentiles_agg("price", percents=(99.9,)),  # phase 2
            "n": count_agg()}
    reqs = [(RangeQuery("qty", lower=50 * i), aggs) for i in range(6)]
    plan, _ = sharded_check(env, *reqs[0])
    assert plan[("a", "p")]["bisect"] and plan[("a", "pn")]["bisect"]
    preqs = _port_reqs(reqs)
    want = [env["oracle"].agg_search(q, a) for q, a in preqs]
    assert list(env["port"].agg_search_stream(iter(preqs))) == want
    assert list(env["jax"].agg_search_stream(iter(reqs))) == want


@pytest.fixture(scope="module")
def cube_path(tmp_path_factory):
    return persist(cube_index(), str(tmp_path_factory.mktemp("cube") / "ix"))


def _cube_sites(searcher) -> int:
    """Cube sites of a port searcher's plans (shard 0's)."""
    return sum(1 for prog in searcher._programs.values()
               for p in (getattr(prog, "plan", None) or {}).values()
               if isinstance(p, dict) and p.get("cube") is not None)


def test_cube_sharded_mesh(cube_path):
    """Per-shard cube operands with one common piece layout: metric,
    filter and bucket cubes plan on a 4-shard mesh (no pcube / scube) and
    stay exact, with the cube on and (every third query) off."""
    aggs = dict(CUBE_AGGS)
    aggs["h"] = histogram_agg("qty", interval=7,
                              sub_aggs={"s": sum_agg("delta"),
                                        "av": avg_agg("counts")})
    aggs["t"] = terms_agg("cat", size=3, sub_aggs={"s": sum_agg("qty")})
    aggs["p"] = percentiles_agg("price")
    on = mesh_env(cube_path, 4, use_cube=True)
    off = mesh_env(cube_path, 4, use_cube=False)
    for i, q in enumerate(CUBE_QUERIES):
        sharded_check(on, q, aggs)
        if i % 3 == 0:
            sharded_check(off, q, aggs)
    assert _cube_sites(on["port"]) >= 9
    assert _cube_sites(off["port"]) == 0
    for prog in on["port"]._programs.values():
        for p in prog.plan.values():
            if isinstance(p, dict):
                assert p.get("pcube") is None and p.get("scube") is None


def test_cube_sharded_msearch(cube_path):
    env = mesh_env(cube_path, 8, use_cube=True)
    aggs = {"h": histogram_agg("qty", interval=6,
                               sub_aggs={"s": sum_agg("delta")}),
            "t": terms_agg("cat", size=4, sub_aggs={"n2": count_agg()}),
            "n": count_agg()}
    reqs = [(TermQuery("cat", c), aggs) for c in "abcdef"] + \
        [(RangeQuery("delta", lower=int(lo), upper=int(lo) + 9), aggs)
         for lo in range(-12, 0, 2)]
    sharded_check(env, *reqs[0])
    preqs = _port_reqs(reqs)
    assert env["port"].agg_search_batch(preqs) == \
        [env["oracle"].agg_search(q, a) for q, a in preqs]
    assert _cube_sites(env["port"]) >= 3


def test_cube_shards_lift_build_rows_bound(tmp_path, monkeypatch):
    """The build-row bound applies per shard: past it unsharded the cube
    is off, on an 8-shard mesh each shard's chunk still cubes (the JAX
    package's test, with both packages' bound shrunk to one chunk)."""
    schema = (SchemaBuilder().add_keyword_field("cat")
              .add_u64_field("qty").add_i64_field("delta").build())
    big = tat.Index.create_in_ram(schema)
    w = big.writer()
    rng = np.random.default_rng(11)
    n = 40_000
    w.add_documents_columnar({
        "cat": np.asarray(list("abcdef"), object)[rng.integers(0, 6, n)],
        "qty": rng.integers(0, 40, n).astype(np.uint64),
        "delta": rng.integers(-25, 25, n).astype(np.int64)}, n)
    w.commit()
    path = persist(big, str(tmp_path / "ix"))
    env = mesh_env(path, 8, use_cube=True)
    chunk = env["port"]._get_device_index().T // 8
    monkeypatch.setattr(jax_cube, "MAX_BUILD_ROWS", chunk)
    monkeypatch.setattr(C, "MAX_BUILD_ROWS", chunk)
    aggs = {"st": stats_agg("qty"), "n": count_agg(),
            "f": filter_agg(TermQuery("cat", "b"),
                            sub_aggs={"s": sum_agg("delta")})}
    q = RangeQuery("qty", lower=4, upper=30)
    flat = tt.Index.open(path).searcher(device="cpu",
                                        config=EngineConfig(use_cube=True))
    pq, pa = to_port(q), to_port(aggs)
    want = env["oracle"].agg_search(pq, pa)
    assert flat.agg_search(pq, pa) == want
    assert _cube_sites(flat) == 0
    sharded_check(env, q, aggs)
    assert _cube_sites(env["port"]) >= 3


def test_sharded_never_raises(tmp_path):
    """Shapes without a sharded device lowering answer on the host path
    in both packages (and the rest of the tree on the device)."""
    env = mesh_env(persist(multi_index(), str(tmp_path / "ix")), 4)
    for aggs in ({"h": histogram_agg("qty", interval=10, sub_aggs={
                     "p": percentiles_agg("price")})},
                 {"t": terms_agg("tags", size=20, sub_aggs={
                     "h": histogram_agg("qty", interval=10)})},
                 # wslots: no weighted bisection on a mesh
                 {"t": terms_agg("tags", size=5, sub_aggs={
                     "p": percentiles_agg("price")})}):
        sharded_check(env, MatchAllQuery(), aggs)
        sharded_check(env, RangeQuery("qty", lower=5), aggs)
    plan, _ = sharded_check(env, MatchAllQuery(), {"t": terms_agg(
        "tags", size=5, sub_aggs={"p": percentiles_agg("price")})})
    assert plan is None


def test_shard_packs_match_jax_pack_groups_sharded():
    """One piece layout across the shards: each shard's pack of its own
    groups with the bounds merged across the shards (what the planner
    exchanges) == its slice of JAX `pack_groups_sharded`."""
    rng = np.random.default_rng(3)
    per = [[("cnt", rng.integers(0, 300 * (s + 1), 40)),
            ("sum", rng.integers(-2**40, 2**35, (3, 40)))]
           for s in range(4)]
    bounds = C.merge_bounds([C.group_bounds(g) for g in per])
    packs = [C.pack_groups(g, bounds) for g in per]
    want, wlay = jax_cube.pack_groups_sharded(
        [(nm, np.stack([p[i][1] for p in per]))
         for i, (nm, _) in enumerate(per[0])])
    for s, (pieces, lay) in enumerate(packs):
        assert lay == wlay
        assert np.array_equal(pieces, np.asarray(want)[s])


def test_cube_shard_bound_is_asserted():
    """S <= 128 keeps the psum of int32 dot lanes (each < 2^24) exact:
    asserted beside the psum, tripped at 129 shards."""
    ind = torch.ones(2, 16, dtype=torch.bool)
    op = C.device_operand(np.ones((16, 8), np.int8), "cpu")
    assert C.shard_dots(ind, op, C.MAX_SHARDS, lambda x: x * 2).shape \
        == (2, 8)
    with pytest.raises(AssertionError, match="MAX_SHARDS"):
        C.shard_dots(ind, op, C.MAX_SHARDS + 1, lambda x: x)


def test_make_mesh_defaults(monkeypatch):
    """make_mesh() is every CUDA device and raises without one; an
    explicit list may repeat a device; a Searcher takes a device or a
    mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.ReplicatedSearcher(None, replicas=1)
    assert tt.make_mesh(3, devices=["cpu"] * 8) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        tt.make_mesh(9, devices=["cpu"] * 8)
    idx = tt.Index.create_in_ram(tt.SchemaBuilder().add_u64_field("v")
                                 .build())
    with pytest.raises(ValueError, match="device or a mesh"):
        idx.searcher(device="cpu", mesh=["cpu"] * 2)


def _run_bounded(g, body, timeout=60):
    """g.run(body) on a thread joined with a timeout: its result, or the
    error it raised."""
    import threading
    got = {}

    def go():
        try:
            got["out"] = g.run(body)
        except BaseException as e:  # re-raised below, on the test's thread
            got["err"] = e

    t = threading.Thread(target=go)
    t.start()
    t.join(timeout=timeout)
    assert not t.is_alive(), "the mesh run hung"
    if "err" in got:
        raise got["err"]
    return got["out"]


def test_shard_failure_raises_and_mesh_recovers():
    """A shard that raises stops its siblings at their collectives (the
    call raises the first error, never hangs), and the mesh runs again."""
    from tantivy_aggregations_tpu_torch.parallel import shard as SH
    g = SH.MeshGroup(["cpu"] * 4)

    def body(s):
        x = SH.psum(torch.tensor([s]))
        if s == 2:
            raise KeyError("shard 2")
        return SH.psum(x)

    with pytest.raises(KeyError, match="shard 2"):
        _run_bounded(g, body)
    assert _run_bounded(
        g, lambda s: int(SH.psum(torch.tensor([s + 1])))) == [10] * 4
    with pytest.raises(RuntimeError, match="different collectives"):
        _run_bounded(g, lambda s: SH.psum(torch.tensor([s])) if s else None)


def test_mesh_turns_under_a_short_switch_interval():
    """16 shard threads (more than this box's cores) take 150 rounds of
    turns through psum, all_gather and pmax under a 1 us switch interval:
    every result is exact and in shard order (a lost or misordered
    hand-over would break one), and the run ends within its time bound."""
    import sys
    import threading
    from tantivy_aggregations_tpu_torch.parallel import shard as SH
    S, rounds = 16, 150
    g = SH.MeshGroup(["cpu"] * S)

    def body(s):
        acc = 0
        for r in range(rounds):
            x = torch.tensor([s * 1000 + r])
            want = [t * 1000 + r for t in range(S)]
            if int(SH.psum(x)) != sum(want):
                raise AssertionError(("psum", s, r))
            if SH.all_gather(x).flatten().tolist() != want:
                raise AssertionError(("all_gather", s, r))
            acc += int(SH.pmax(x))
        return acc

    out = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: out.append(g.run(body)))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert out == [[sum((S - 1) * 1000 + r for r in range(rounds))] * S]
