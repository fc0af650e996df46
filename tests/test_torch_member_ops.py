"""EngineConfig.use_member_ops in the PyTorch port, on the CPU: with it off,
a prefix-mode bucket agg gated by one TermQuery on a dense multi-valued
field (bench c7, the shapes of tests/test_member_op.py) plans the
chain_blocks kernel over the bucket layout (`pallas_prefix`, the chain the
field's per-position planes) where the default plans a member operand.
Each case holds the plan's modes == the JAX package's under the same
config (`plan_modes`) and the fruits port == JAX (Pallas in interpret
mode) == the oracle; the default config still plans the member operand.
Two searchers of different configs share one device index and each plans
its own program; the prep cache written under one config serves the
other. Every comparison is exact."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.models import flagship as jflag

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as pflag
from tantivy_aggregations_tpu_torch.ops import kernels as K
from tantivy_aggregations_tpu_torch.utils import stats

from test_member_op import AGGS, rich_index
from test_multi_query_fields import planeable_index
from test_torch_multi_query import persist, plan_modes, to_port

torch.set_num_threads(2)

NOMOP = {"use_member_ops": False}


def _c7(m):
    return next((q, a) for i, _, q, a in m.extra_configs() if i == 7)


def _engines(path, **cfg):
    """The port on the CPU and the JAX package (interpret mode) at `cfg`,
    and the port's oracle, over the on-disk index at `path`."""
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return {"port": pidx.searcher(device="cpu", config=EngineConfig(**cfg)),
            "jax": jidx.searcher(config=JaxConfig(pallas_interpret=True,
                                                  **cfg)),
            "oracle": pidx.oracle_searcher()}


def _check(env, jq, ja, path=("a", "t")):
    """port == JAX == oracle with equal plan modes; returns the port's
    plan entry of the bucket node at `path`."""
    pq, pa = to_port(jq), to_port(ja)
    pp = env["port"]._program_for(pq, pa)
    jp = env["jax"]._program_for(jq, ja)
    assert plan_modes(pp.plan) == plan_modes(jp.plan), jq
    want = env["oracle"].agg_search(pq, pa)
    assert env["jax"].agg_search(jq, ja) == want, jq
    assert env["port"].agg_search(pq, pa) == want, pq
    return pp.plan[path]


@pytest.fixture(scope="module")
def member_indexes(tmp_path_factory):
    """tests/test_member_op.py's indexes on disk: the planeable index, the
    rich index (keyword member field, f64 and multi-valued payloads) and
    the rich index with deletes."""
    d = tmp_path_factory.mktemp("mop")
    dels = rich_index(n=800)
    w = dels.writer()
    w.delete_term("tags", "g03")
    w.commit()
    return {"planeable": persist(planeable_index(), str(d / "planeable")),
            "rich": persist(rich_index(), str(d / "rich")),
            "deletes": persist(dels, str(d / "deletes"))}


_HIST = {"h": tat.histogram_agg("amount", interval=1,
                                sub_aggs={"s": tat.sum_agg("amount")})}
_PAYLOADS = {"t": tat.terms_agg("sku", size=8,
                                sub_aggs={"sa": tat.sum_agg("amount"),
                                          "sp": tat.sum_agg("price"),
                                          "aw": tat.avg_agg("weights")})}
#: (index, query, aggs, bucket path) — the member-operand shapes of
#: tests/test_member_op.py: numeric member values (in and out of the
#: domain), a must-wrapped leaf, a histogram site, f64 and multi-valued
#: payloads, a keyword member field, deletes
SHAPES = [
    ("planeable", tat.TermQuery("weights", 42), AGGS, ("a", "t")),
    ("planeable", tat.TermQuery("weights", 0), AGGS, ("a", "t")),
    ("planeable", tat.TermQuery("weights", 10**9), AGGS, ("a", "t")),
    ("planeable", tat.BooleanQuery(must=[tat.TermQuery("weights", 7)]),
     AGGS, ("a", "t")),
    ("planeable", tat.TermQuery("weights", 77), _HIST, ("a", "h")),
    ("rich", tat.TermQuery("weights", 13), _PAYLOADS, ("a", "t")),
    ("rich", tat.TermQuery("tags", "g07"), AGGS, ("a", "t")),
    ("rich", tat.TermQuery("tags", "nope"), AGGS, ("a", "t")),
    ("deletes", tat.TermQuery("weights", 13), AGGS, ("a", "t")),
    ("deletes", tat.TermQuery("tags", "g07"), AGGS, ("a", "t")),
]


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_member_shapes_without_member_ops(member_indexes, i):
    name, jq, ja, path = SHAPES[i]
    p = _check(_engines(member_indexes[name], **NOMOP), jq, ja, path)
    assert p["mode"] == "prefix" and p["pallas_prefix"], p
    assert "member_op" not in p


@pytest.mark.parametrize("i", [0, 5, 6])
def test_member_shapes_default_still_plan_the_operand(member_indexes, i):
    name, jq, ja, path = SHAPES[i]
    p = _check(_engines(member_indexes[name]), jq, ja, path)
    assert "member_op" in p and not p["pallas_prefix"]


@pytest.fixture(scope="module")
def bench_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "idx")
    jflag.build_bench_index(path, 6000, seed=42, n_segments=4)
    return path


def test_c7_without_member_ops_runs_chain_blocks(bench_path, monkeypatch):
    """c7 at use_member_ops=False: JAX's plan, fruits == JAX == oracle;
    the varied batch (dedup on and off) == the per-query answers, through
    chain_blocks and never gather_rows."""
    env = _engines(bench_path, **NOMOP)
    jq, ja = _c7(jflag)
    p = _check(env, jq, ja)
    assert p["pallas_prefix"] and "member_op" not in p
    calls = {"chain_blocks": 0, "gather_rows": 0}
    for name in calls:
        def spy(*a, _f=getattr(K, name), _n=name):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(K, name, spy)
    pq, pa = _c7(pflag)
    reqs = pflag.varied_requests(7, pa, 40)
    port = env["port"]
    singles = [port.agg_search(q, a) for q, a in reqs]
    assert port.agg_search_batch(reqs) == singles
    nodedup = port.index.searcher(device="cpu", config=EngineConfig(
        msearch_dedup=False, **NOMOP))
    assert nodedup.agg_search_batch(reqs) == singles
    for (q, a), got in list(zip(reqs, singles))[:3]:
        assert got == env["oracle"].agg_search(q, a)
    assert calls["chain_blocks"] > 0 and calls["gather_rows"] == 0, calls


def test_two_configs_share_one_device_index(bench_path):
    """A default searcher and a use_member_ops=False one over ONE device
    index (as chip_smoke.py shares it): each plans its own c7 program, in
    turns, and both answer == the oracle."""
    idx = tt.Index.open(bench_path)
    mop = idx.searcher(device="cpu")
    nomop = idx.searcher(device="cpu", config=EngineConfig(**NOMOP))
    nomop._device_index = mop._get_device_index()
    nomop._device_epoch = mop._device_epoch
    oracle = idx.oracle_searcher()
    _, pa = _c7(pflag)
    for v in (500, 17, 999):
        q = tt.TermQuery("weights", v)
        want = oracle.agg_search(q, pa)
        assert mop.agg_search(q, pa) == want
        assert nomop.agg_search(q, pa) == want
    assert nomop._get_device_index() is mop._get_device_index()
    assert "member_op" in mop._program_for(q, pa).plan[("a", "t")]
    p = nomop._program_for(q, pa).plan[("a", "t")]
    assert p["pallas_prefix"] and "member_op" not in p


@pytest.mark.parametrize("first", [True, False])
def test_prep_cache_serves_the_other_config(tmp_path, first):
    """The prep cache written while planning c7 under one use_member_ops
    serves a fresh process-like restart under the other: no miss, fruits
    == the oracle."""
    path = str(tmp_path / "idx")
    pflag.build_bench_index(path, 4000, seed=3, n_segments=2)
    _, pa = _c7(pflag)
    q = tt.TermQuery("weights", 500)
    want = tt.Index.open(path).oracle_searcher().agg_search(q, pa)
    for use in (first, not first):
        stats.reset_prep()
        s = tt.Index.open(path).searcher(device="cpu", config=EngineConfig(
            use_member_ops=use))
        assert s.agg_search(q, pa) == want, use
        assert ("member_op" in s._program_for(q, pa).plan[("a", "t")]) \
            == use
    assert stats.prep_cache["misses"] == 0 and stats.prep_cache["hits"] > 0
