"""Doc-sharded execution in the PyTorch port, on the CPU: the cases of the
JAX package's tests/test_sharded.py, each run by the JAX package on its
virtual CPU devices (`make_mesh(n)`) and by the port on a mesh of n CPU
shards (`["cpu"] * n`, one thread per shard), over one on-disk index.
Every case asserts fruits port == JAX == the oracle, the two plans' modes
equal node by node (`sharded_modes`: bisect, slot_bisect, prefix, in-slot
top_hits, per-shard cube sites; the port keeps its kernels on a mesh, the
JAX package turns Pallas off, so the kernel flags are not compared), and
that a shape one planner refuses the other refuses too (the host path in
both). Every comparison is exact.

The harness here (`SHARDED_FLAGS`, `sharded_modes`, `mesh_env`,
`sharded_check`) is shared with test_torch_sharded_pct.py and
test_torch_sharded_serving.py."""

import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu import (
    BooleanQuery,
    MatchAllQuery,
    RangeQuery,
    TermQuery,
    avg_agg,
    count_agg,
    filter_agg,
    histogram_agg,
    max_agg,
    min_agg,
    percentiles_agg,
    stats_agg,
    sum_agg,
    terms_agg,
    top_hits_agg,
)
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.parallel.shard import make_mesh as jax_mesh

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.index.loader import ShardedIndex
from tantivy_aggregations_tpu_torch.searcher import _HostFallback

from fixtures import basic_index, random_index
from test_torch_multi_query import persist, to_port

torch.set_num_threads(2)

#: the plan flags a sharded parity check compares (beside kind, mode,
#: pmode, the cube modes, an expansion and a member operand)
SHARDED_FLAGS = ("mask_gather", "wslots", "plane_fanout", "bisect",
                 "slot_bisect", "phase2_vals", "in_slot", "int_percents")


def sharded_modes(plan) -> dict:
    """{agg path: (kind, mode, pmode, cube modes, flags, xpand, member)}."""
    out = {}
    for path, p in plan.items():
        if not (path and path[0] == "a" and isinstance(p, dict)):
            continue
        out[path] = (p.get("kind"), p.get("mode"), p.get("pmode"),
                     tuple(k for k in ("cube", "pcube", "scube")
                           if p.get(k) is not None),
                     tuple(k for k in SHARDED_FLAGS if p.get(k)),
                     p.get("xpand") is not None,
                     bool(p.get("member_op")))
    return out


def mesh_env(path, n, **cfg):
    """The JAX package on its n-device mesh, the port on n CPU shards and
    the port's oracle, over the index at `path`."""
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return {"jax": jidx.searcher(mesh=jax_mesh(n), config=JaxConfig(**cfg)),
            "port": pidx.searcher(mesh=tt.make_mesh(devices=["cpu"] * n),
                                  config=EngineConfig(**cfg)),
            "oracle": pidx.oracle_searcher(), "n": n}


def sharded_check(env, jq, jaggs):
    """port == JAX == oracle on the mesh, and plan parity; returns (the
    port's plan or None on the host path, fruits)."""
    from tantivy_aggregations_tpu.searcher import _HostFallback as JaxFb
    pq, paggs = to_port(jq), to_port(jaggs)
    want = env["oracle"].agg_search(pq, paggs)
    got = env["port"].agg_search(pq, paggs)
    assert got == want, f"\nport:   {got}\noracle: {want}"
    assert env["jax"].agg_search(jq, jaggs) == want, jq
    jp = env["jax"]._program_for(jq, jaggs)
    pp = env["port"]._program_for(pq, paggs)
    assert isinstance(jp, JaxFb) == isinstance(pp, _HostFallback), \
        (jq, getattr(jp, "reason", None), getattr(pp, "reason", None))
    if isinstance(pp, _HostFallback):
        return None, want
    a, b = sharded_modes(jp.plan), sharded_modes(pp.plan)
    assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
    di = env["port"]._get_device_index()
    assert isinstance(di, ShardedIndex) and di.n_shards == env["n"]
    return pp.plan, want


@pytest.fixture(scope="module")
def basic2(tmp_path_factory):
    return persist(basic_index(num_segments=2),
                   str(tmp_path_factory.mktemp("sh") / "basic2"))


@pytest.fixture(scope="module")
def rand3(tmp_path_factory):
    return persist(random_index(3, n_docs=500, n_segments=4),
                   str(tmp_path_factory.mktemp("sh") / "rand3"))


def test_sharded_metrics(basic2):
    sharded_check(mesh_env(basic2, 8), MatchAllQuery(), {
        "n": count_agg(), "s": sum_agg("price"), "st": stats_agg("qty"),
        "lo": min_agg("delta"), "hi": max_agg("delta"),
        "av": avg_agg("scores"), "sc": sum_agg("counts"),
    })


@pytest.mark.parametrize("q", [
    MatchAllQuery(), TermQuery("cat", "cat0001"),
    BooleanQuery(must=[RangeQuery("qty", lower=100)],
                 must_not=[TermQuery("tags", "t1")])])
def test_sharded_full_tree(rand3, q):
    sharded_check(mesh_env(rand3, 8), q, {
        "n": count_agg(),
        "sp": sum_agg("price"),
        "p": percentiles_agg("price"),
        "h": histogram_agg("qty", interval=131,
                           sub_aggs={"s": sum_agg("price")}),
        "t": terms_agg("cat", size=7,
                       sub_aggs={"s": sum_agg("qty"), "n": count_agg()}),
        "tt": terms_agg("tags", size=4, sub_aggs={"a": avg_agg("scores")}),
        "f": filter_agg(RangeQuery("price", lower=0.0),
                        sub_aggs={"n": count_agg()}),
        "th": top_hits_agg(5, "delta"),
    })


def test_sharded_deletes(tmp_path):
    path = persist(basic_index(num_segments=3, with_deletes=True),
                   str(tmp_path / "del"))
    sharded_check(mesh_env(path, 8), MatchAllQuery(), {
        "n": count_agg(), "t": terms_agg("cat", size=10),
        "h": histogram_agg("qty", interval=5,
                           sub_aggs={"s": sum_agg("price")}),
    })


def test_sharded_nested(tmp_path):
    path = persist(random_index(5, n_docs=400, n_segments=2),
                   str(tmp_path / "nest"))
    sharded_check(mesh_env(path, 8), MatchAllQuery(), {
        "t": terms_agg("cat", size=5, sub_aggs={
            "h": histogram_agg("qty", interval=211,
                               sub_aggs={"s": sum_agg("price")})})})


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mesh_sizes(basic2, n_dev):
    plan, _ = sharded_check(mesh_env(basic2, n_dev), MatchAllQuery(), {
        "n": count_agg(), "s": sum_agg("price"),
        "t": terms_agg("tags", size=3),
    })
    assert plan is not None


def test_sharded_highcard_terms_prefix(tmp_path):
    path = persist(random_index(11, n_docs=900, n_segments=3, card=600),
                   str(tmp_path / "hc"))
    env = mesh_env(path, 8)
    aggs = {"t": terms_agg("cat", size=7,
                           sub_aggs={"s": sum_agg("qty"), "n": count_agg(),
                                     "a": avg_agg("price")})}
    for q in [MatchAllQuery(), RangeQuery("qty", lower=100, upper=800),
              BooleanQuery(must=[RangeQuery("delta", lower=-250)],
                           must_not=[TermQuery("cat", "cat0001")])]:
        plan, _ = sharded_check(env, q, aggs)
        assert plan[("a", "t")]["mode"] == "prefix"
        assert plan[("a", "t")]["pallas_prefix"]  # chain_blocks per shard


def test_sharded_large_histogram_prefix(tmp_path):
    path = persist(random_index(12, n_docs=700, n_segments=2),
                   str(tmp_path / "lh"))
    env = mesh_env(path, 8)
    aggs = {"h": histogram_agg("qty", interval=2,
                               sub_aggs={"s": sum_agg("price"),
                                         "n": count_agg()})}
    for q in [MatchAllQuery(), RangeQuery("delta", lower=0)]:
        plan, _ = sharded_check(env, q, aggs)
        assert plan[("a", "h")]["mode"] == "prefix"
        assert plan[("a", "h")]["nb"] > 256


def test_sharded_index_layout(rand3):
    """Shard s holds the doc rows [s * T/S, (s+1) * T/S) of the padded doc
    axis (T a multiple of PAD_BLOCK * S) on mesh device s, value rows of
    a multi-valued field partitioned by owning shard with shard-local
    doc ids."""
    from tantivy_aggregations_tpu_torch.index.loader import (
        PAD_BLOCK, load_sharded_index)
    idx = tt.Index.open(rand3)
    si = load_sharded_index(idx, tt.make_mesh(devices=["cpu"] * 4))
    Ts = si.T // 4
    assert si.T % (PAD_BLOCK * 4) == 0 and all(
        d.T == Ts and d.global_T == si.T for d in si.shards)
    g = [d.column("qty")._host_mono for d in si.shards]
    tags = [d.column("tags") for d in si.shards]
    assert len({t._host_doc.shape[0] for t in tags}) == 1
    n_vals = sum(int(t._host_valid.sum()) for t in tags)
    assert n_vals == si.shards[0].column("tags")._parent.n_values
    for s, t in enumerate(tags):
        docs = t._host_doc[t._host_valid]
        assert docs.min(initial=0) >= 0 and docs.max(initial=0) < Ts
    assert all(x.shape[0] == Ts for x in g)
