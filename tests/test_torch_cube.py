"""The value-domain cube and the dense products of the PyTorch port, on the
CPU: the port at its default EngineConfig (use_cube and dense_mxu on, as
the JAX package's default) == the JAX package at the same switches (Pallas
kernels in interpret mode) == the oracle == the port in row modes
(use_cube=False, dense_mxu=False), over one on-disk index written by the
JAX writer — the cases of tests/test_cube.py that run unsharded. The port
must also plan a cube, pcube, scube or dense product exactly where the JAX
program does (`_modes`), here and on the flagship configs c1-c10."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.models import flagship as jflag
from tantivy_aggregations_tpu.schema import Cardinality as JCard

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as pflag
from tantivy_aggregations_tpu_torch.ops import cube as pcube
from tantivy_aggregations_tpu_torch.ops import reductions as preductions

torch.set_num_threads(2)

ROW_MODES = EngineConfig(use_cube=False, dense_mxu=False)


def build_index(path, n=700, seed=3):
    """tests/test_cube.py's index, written to `path` by the JAX writer."""
    schema = (tat.SchemaBuilder()
              .add_keyword_field("cat")
              .add_keyword_field("opt")      # missing on some docs
              .add_u64_field("qty")
              .add_i64_field("delta")
              .add_f64_field("price")
              .add_u64_field("wide")         # wide single-valued
              .add_u64_field("counts", cardinality=JCard.MULTI)
              .build())
    idx = tat.Index.create(path, schema)
    w = idx.writer()
    rng = np.random.default_rng(seed)
    cats = ["a", "b", "c", "d", "e", "f"]
    for i in range(n):
        doc = {"cat": cats[rng.integers(len(cats))],
               "qty": int(rng.integers(0, 40)),
               "delta": int(rng.integers(-25, 25)),
               "price": float(np.round(rng.normal() * 50, 3)),
               "wide": int(rng.integers(0, 2**40)),
               "counts": [int(x)
                          for x in rng.integers(0, 7, rng.integers(0, 4))]}
        if rng.random() < 0.6:
            doc["opt"] = cats[rng.integers(3)]
        w.add_document(doc)
        if i == n // 2:
            w.commit()
    w.commit()
    return path


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    path = build_index(str(tmp_path_factory.mktemp("cube") / "idx"))
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return {
        "port": pidx.searcher(device="cpu"),
        "row": pidx.searcher(device="cpu", config=ROW_MODES),
        "oracle": pidx.oracle_searcher(),
        "jax": jidx.searcher(config=JaxConfig(use_cube=True, dense_mxu=True,
                                              pallas_interpret=True)),
    }


def _aggs(m):
    return {
        "n": m.count_agg(),
        "s": m.sum_agg("delta"),
        "sw": m.sum_agg("wide"),
        "st": m.stats_agg("qty"),
        "pr": m.stats_agg("price"),
        "wst": m.stats_agg("wide"),
        "av": m.avg_agg("counts"),
        "mc": m.stats_agg("counts"),
        "mn": m.min_agg("delta"),
        "mx": m.max_agg("price"),
        "f": m.filter_agg(m.RangeQuery("delta", lower=-10, upper=10),
                          {"inner": m.stats_agg("price"),
                           "c2": m.count_agg()}),
    }


def _queries(m):
    return [
        m.TermQuery("cat", "a"),
        m.TermQuery("cat", "nope"),              # missing term
        m.TermQuery("opt", "b"),                 # field missing on some docs
        m.RangeQuery("qty", lower=5, upper=30),
        m.RangeQuery("qty", lower=39, upper=5),  # empty range
        m.PrefixQuery("cat", "a"),
        m.TermSetQuery("cat", ("a", "c", "zz")),
        m.BooleanQuery(must=(m.TermQuery("cat", "b"),
                             m.RangeQuery("qty", lower=2, upper=35)),
                       must_not=(m.RangeQuery("delta", lower=0, upper=5),)),
        m.BooleanQuery(should=(m.TermQuery("cat", "a"),
                               m.TermQuery("opt", "c"))),
    ]


# ---------------------------------------------------------------------------
# plan parity: where the JAX program takes the cube and the dense products
# ---------------------------------------------------------------------------

_METRICS = ("SumAgg", "MinAgg", "MaxAgg", "AvgAgg", "StatsAgg")


def _kind(node):
    return type(node).__name__


def _jax_dense_paths(aggs, plan):
    """The paths where the JAX program runs a dense MXU product (read off
    JAX aggs/compile.py: `_slot_counts` / `_slot_sum_plane` under a
    MaskCtx-rooted dense bucket node (bid_static), and `_eval_metric`'s
    masked_sum_planes_mxu at MaskCtx scope)."""
    out = set()

    def walk(items, path, mask_scope):
        for name, node in items:
            pth = path + (name,)
            p = plan.get(pth) or {}
            k = _kind(node)
            if k in ("HistogramAgg", "TermsAgg"):
                if mask_scope and p.get("mode") == "dense" \
                        and p.get("cube") is None:
                    out.add(pth)
                    out.update(pth + (n2,) for n2, s2 in node.sub_aggs
                               if _kind(s2) in _METRICS + ("CountAgg",))
                walk(node.sub_aggs, pth, False)
            elif k in ("FilterAgg", "PostFilterAgg"):
                walk(node.sub_aggs, pth, mask_scope)
            elif k in _METRICS and mask_scope and p.get("cube") is None:
                need_sum = k in ("SumAgg", "AvgAgg", "StatsAgg")
                if p["multi"] or (need_sum and not p["direct"]):
                    out.add(pth)

    walk(aggs.items(), ("a",), True)
    return out


def _nodes(plan):
    """The plan's agg-node entries (the port's plan also records its step's
    execution mode under "graph")."""
    return {path: p for path, p in plan.items() if isinstance(path, tuple)}


def _modes(plan, dense):
    return {path: tuple(m for m in ("cube", "pcube", "scube")
                        if isinstance(p, dict) and p.get(m) is not None)
            + (("dense",) if path in dense else ())
            for path, p in _nodes(plan).items()}


def assert_plan_parity(jax_s, port_s, jq, jaggs, pq, paggs):
    """The port's program for (pq, paggs) carries cube / pcube / scube /
    dense-product modes exactly where the JAX program for (jq, jaggs)
    does."""
    jplan = jax_s._program_for(jq, jaggs).plan
    pplan = port_s._program_for(pq, paggs).plan
    port_dense = {path for path, p in _nodes(pplan).items()
                  if p.get("dense_mm")}
    assert _modes(pplan, port_dense) == \
        _modes(jplan, _jax_dense_paths(jaggs, jplan))


def n_sites(searcher, key="cube"):
    return sum(1 for prog in searcher._programs.values()
               for p in (getattr(prog, "plan", None) or {}).values()
               if isinstance(p, dict) and p.get(key) is not None)


def four_way(four, jq, jaggs, pq, paggs, jax=True):
    """port == row modes == oracle (== JAX at its default switches)."""
    want = four["oracle"].agg_search(pq, paggs)
    assert four["row"].agg_search(pq, paggs) == want, pq
    assert four["port"].agg_search(pq, paggs) == want, pq
    if jax:
        assert four["jax"].agg_search(jq, jaggs) == want, jq
        assert_plan_parity(four["jax"], four["port"], jq, jaggs, pq, paggs)
    return want


# ---------------------------------------------------------------------------
# tests/test_cube.py's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(9))
def test_cube_bit_identity(four, i):
    jq, pq = _queries(tat)[i], _queries(tt)[i]
    four_way(four, jq, _aggs(tat), pq, _aggs(tt), jax=i in (0, 3, 6, 7))
    assert n_sites(four["port"]) >= 9
    assert n_sites(four["row"]) == 0


def test_cube_msearch_batch(four):
    """A request group shares the static operand ([B, Dprod] x [Dprod, K]),
    dedup on and off."""
    aggs = _aggs(tt)
    reqs = [(tt.TermQuery("cat", c), aggs) for c in "abcdefab"] + \
        [(tt.RangeQuery("qty", lower=int(lo), upper=int(lo) + 7), aggs)
         for lo in range(6)]
    want = [four["oracle"].agg_search(q, a) for q, a in reqs]
    assert four["port"].agg_search_batch(reqs) == want
    assert four["row"].agg_search_batch(reqs) == want
    nodedup = four["port"].index.searcher(
        device="cpu", config=EngineConfig(msearch_dedup=False))
    assert nodedup.agg_search_batch(reqs) == want
    jaggs = _aggs(tat)
    assert four["jax"].agg_search(tat.TermQuery("cat", "c"), jaggs) == want[2]


def test_cube_gate_rejects_unsupported(four):
    """Chains over multi-valued or wide query fields, and param-free ones,
    keep the row paths (a multi-valued chain is a device Program over the
    per-position planes) and stay bit-identical there, with the JAX
    package's plan."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    s = four["port"].index.searcher(device="cpu")
    ja = {k: v for k, v in _aggs(tat).items() if k != "f"}
    pa = {k: v for k, v in _aggs(tt).items() if k != "f"}
    cases = [(tat.RangeQuery("counts", lower=1, upper=4),
              tt.RangeQuery("counts", lower=1, upper=4)),
             (tat.RangeQuery("wide", lower=0, upper=2**39),
              tt.RangeQuery("wide", lower=0, upper=2**39)),
             (tat.MatchAllQuery(), tt.MatchAllQuery())]
    for jq, pq in cases:
        want = four["oracle"].agg_search(pq, pa)
        assert s.agg_search(pq, pa) == want
        assert four["row"].agg_search(pq, pa) == want
        assert four["jax"].agg_search(jq, ja) == want
        assert_plan_parity(four["jax"], s, jq, ja, pq, pa)
    assert type(s._program_for(cases[0][1], pa)) is Program
    assert n_sites(s) == 0
    # an Exists leaf passes the gate, and its chain over a multi-valued
    # field's planes has no cube: a device Program with no cube site, as
    # in row modes
    q = tt.BooleanQuery(must=(tt.TermQuery("cat", "a"),
                              tt.ExistsQuery("counts")))
    jq = tat.BooleanQuery(must=(tat.TermQuery("cat", "a"),
                                tat.ExistsQuery("counts")))
    assert s.agg_search(q, pa) == four["oracle"].agg_search(q, pa)
    assert four["jax"].agg_search(jq, ja) == four["oracle"].agg_search(q, pa)
    assert_plan_parity(four["jax"], s, jq, ja, q, pa)
    assert type(s._program_for(q, pa)) is Program
    assert n_sites(s) == 0


def test_cube_filter_chain_under_matchall(four):
    """A parameterized filter chain cubes under a match-all root, and no
    row mask is evaluated: every reader is the cube's."""
    def aggs(m):
        return {"f": m.filter_agg(m.RangeQuery("delta", lower=-10, upper=10),
                                  {"inner": m.stats_agg("price"),
                                   "c2": m.count_agg()})}
    s = four["port"].index.searcher(device="cpu")
    four_way(dict(four, port=s), tat.MatchAllQuery(), aggs(tat),
             tt.MatchAllQuery(), aggs(tt))
    assert n_sites(s) == 3
    assert s._program_for(tt.MatchAllQuery(), aggs(tt))._root is None


def _bucket_aggs(m):
    return {
        "h": m.histogram_agg("qty", interval=7,
                             sub_aggs={"s": m.sum_agg("delta"),
                                       "av": m.avg_agg("counts"),
                                       "n2": m.count_agg(),
                                       "pw": m.sum_agg("price")}),
        "hf": m.histogram_agg("price", interval=25.0),
        "t": m.terms_agg("cat", size=3, sub_aggs={"s": m.sum_agg("qty")}),
        "to": m.terms_agg("opt", size=2, order=("s", "desc"),
                          sub_aggs={"s": m.sum_agg("qty")}),
        "ta": m.terms_agg("cat", size=4, order=("av", "asc"),
                          sub_aggs={"av": m.avg_agg("counts")}),
        "tw": m.terms_agg("wide", size=5),
    }


def _bucket_queries(m):
    return [m.TermQuery("cat", "b"),
            m.RangeQuery("delta", lower=-5, upper=20),
            m.TermQuery("opt", "a"),
            m.RangeQuery("qty", lower=30, upper=2),   # empty match
            m.MatchAllQuery()]                        # dense products


@pytest.mark.parametrize("i", range(5))
def test_cube_bucket_aggs(four, i):
    """Root-level dense bucket aggs with Count/Sum/Avg subs cube over a
    parameterized chain (key orders, f64 limb sums, multi-valued avg subs,
    missing-keyword buckets) and run as dense products under MatchAll."""
    four_way(four, _bucket_queries(tat)[i], _bucket_aggs(tat),
             _bucket_queries(tt)[i], _bucket_aggs(tt))
    prog = four["port"]._program_for(_bucket_queries(tt)[i],
                                     _bucket_aggs(tt))
    if i < 4:
        assert all(prog.plan[("a", k)].get("cube") for k in
                   ("h", "hf", "t", "to", "ta"))
    else:
        assert prog.plan[("a", "h", "pw")]["dense_mm"]
        assert prog.plan[("a", "t")]["dense_mm"]


def test_cube_bucket_under_filter(four):
    """A bucket agg under a parameterized filter cubes over the filter's
    chain even when the root query is match-all."""
    def aggs(m):
        return {"f": m.filter_agg(
            m.TermQuery("cat", "c"),
            {"h": m.histogram_agg("qty", interval=5,
                                  sub_aggs={"s": m.sum_agg("delta")})})}
    s = four["port"].index.searcher(device="cpu")
    four_way(dict(four, port=s), tat.MatchAllQuery(), aggs(tat),
             tt.MatchAllQuery(), aggs(tt))
    assert n_sites(s) >= 2


def test_cube_bucket_msearch(four):
    def aggs(m):
        return {"h": m.histogram_agg("qty", interval=6,
                                     sub_aggs={"s": m.sum_agg("delta")}),
                "t": m.terms_agg("cat", size=4,
                                 sub_aggs={"n2": m.count_agg()})}
    pa = aggs(tt)
    reqs = [(tt.TermQuery("cat", c), pa) for c in "abcdef"] + \
        [(tt.RangeQuery("delta", lower=int(lo), upper=int(lo) + 9), pa)
         for lo in range(-12, 0, 2)] + [(tt.MatchAllQuery(), pa)] * 3
    want = [four["oracle"].agg_search(q, a) for q, a in reqs]
    assert four["port"].agg_search_batch(reqs) == want
    assert four["row"].agg_search_batch(reqs) == want
    nodedup = four["port"].index.searcher(
        device="cpu", config=EngineConfig(msearch_dedup=False))
    assert nodedup.agg_search_batch(reqs) == want
    assert four["jax"].agg_search(tat.TermQuery("cat", "e"),
                                  aggs(tat)) == want[4]


@pytest.mark.parametrize("i", [0, 3, 4, 6, 7])
def test_cube_percentiles(four, i):
    """Flat integer-percent rank percentiles over a cube-able chain take
    the block-histogram product (pcube). Over a multi-valued field they
    rank its value rows, and non-integer percents take no pcube (their
    ranks resolve in phase 2), as in the JAX package; both == the oracle."""
    def aggs(m):
        return {"p": m.percentiles_agg("price"),
                "pq": m.percentiles_agg("qty", (25.0, 50.0, 75.0))}
    jq, pq = _queries(tat)[i], _queries(tt)[i]
    four_way(four, jq, aggs(tat), pq, aggs(tt))
    prog = four["port"]._program_for(pq, aggs(tt))
    assert prog.plan[("a", "p")]["pcube"] and prog.plan[("a", "pq")]["pcube"]

    def others(m):
        return {"pm": m.percentiles_agg("counts"),
                "pn": m.percentiles_agg("qty", (33.3,))}
    want = four["oracle"].agg_search(pq, others(tt))
    assert four["port"].agg_search(pq, others(tt)) == want
    assert four["jax"].agg_search(jq, others(tat)) == want
    prog = four["port"]._program_for(pq, others(tt))
    assert prog.plan[("a", "pn")]["pcube"] is None


def _slot_aggs(m):
    return {
        "t": m.terms_agg("cat", size=6,
                         sub_aggs={"p": m.percentiles_agg("price",
                                                          (25.0, 50.0, 75.0))}),
        "h": m.histogram_agg("qty", interval=10,
                             sub_aggs={"p": m.percentiles_agg("delta",
                                                              (50.0,))}),
    }


@pytest.mark.parametrize("i", range(4))
def test_cube_slot_rank_percentiles(four, i):
    """Nested (slot_rank) percentiles under bucket ancestors over a
    cube-able chain take the per-slot block-histogram product (scube),
    across terms and histogram ancestors, empty slots and empty
    matches."""
    four_way(four, _bucket_queries(tat)[i], _slot_aggs(tat),
             _bucket_queries(tt)[i], _slot_aggs(tt))
    prog = four["port"]._program_for(_bucket_queries(tt)[i], _slot_aggs(tt))
    assert prog.plan[("a", "t", "p")]["scube"]
    assert prog.plan[("a", "h", "p")]["scube"]
    assert prog.batch_cap is not None


def test_cube_under_bucket_aggs_unaffected(four):
    """in_slot metrics never plan cubes; nested trees stay identical."""
    def aggs(m):
        return {"t": m.terms_agg("cat", size=10,
                                 sub_aggs={"st": m.stats_agg("qty")}),
                "n": m.count_agg()}
    q = (tat.RangeQuery("qty", lower=3, upper=33),
         tt.RangeQuery("qty", lower=3, upper=33))
    four_way(four, q[0], aggs(tat), q[1], aggs(tt))
    prog = four["port"]._program_for(q[1], aggs(tt))
    # a stats sub (min / max) keeps the terms node on the row modes
    assert prog.plan[("a", "n")]["cube"]
    assert not prog.plan[("a", "t")].get("cube")
    assert not prog.plan[("a", "t", "st")].get("cube")


def test_dense_products_nested_and_chunked(four, monkeypatch):
    """Dense reductions under MatchAll over every sub kind (multi-valued
    and f64 limb sums, min / max, counts) and beside a nested bucket: the
    histogram's sums read contiguous int32 payload planes of its rows; the
    root metrics' masked-sums product with its operands built per row
    chunk (DENSE_OP_MEM = 0) and resident."""
    def aggs(m):
        return {"h": m.histogram_agg("qty", interval=9, sub_aggs={
                    "st": m.stats_agg("price"), "mc": m.stats_agg("counts"),
                    "w": m.sum_agg("wide"), "n": m.count_agg(),
                    "t": m.terms_agg("cat", size=3,
                                     sub_aggs={"s": m.sum_agg("delta")})}),
                "av": m.avg_agg("counts"), "pr": m.stats_agg("price"),
                "sw": m.sum_agg("wide")}
    want = four_way(four, tat.MatchAllQuery(), aggs(tat), tt.MatchAllQuery(),
                    aggs(tt))
    prog = four["port"]._program_for(tt.MatchAllQuery(), aggs(tt))
    plan = prog.plan
    rows = prog._arrays[plan[("a", "h")]["bid_key"]].shape
    keys = []
    for sub in ("st", "mc", "w"):
        for e in plan[("a", "h", sub)]["dense_mm"].values():
            keys += [k for _, k in ([e["pcnt"]] if "pcnt" in e else [])
                     + e["sums"] if k is not None]
    assert len(keys) >= 3
    for key in keys:
        pay = prog._arrays[key]
        assert pay.dtype == torch.int32 and pay.shape == rows \
            and pay.is_contiguous(), key
    assert plan[("a", "sw")]["dense_mm"]["planes"][1] is not None
    monkeypatch.setattr(preductions, "DENSE_OP_MEM", 0)
    s = four["port"].index.searcher(device="cpu")
    preductions.reset_mm_calls()
    assert s.agg_search(tt.MatchAllQuery(), aggs(tt)) == want
    plan = s._program_for(tt.MatchAllQuery(), aggs(tt)).plan
    assert plan[("a", "sw")]["dense_mm"]["planes"][1] is None
    assert all(preductions.mm_calls.values()), preductions.mm_calls


# ---------------------------------------------------------------------------
# the flagship configs c1-c10
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flag(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("flag") / "idx")
    jflag.build_bench_index(path, 6000, seed=5, n_segments=2)
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return {"port": pidx.searcher(device="cpu"),
            "row": pidx.searcher(device="cpu", config=ROW_MODES),
            "oracle": pidx.oracle_searcher(),
            "jax": jidx.searcher(config=JaxConfig(use_cube=True,
                                                  dense_mxu=True,
                                                  pallas_interpret=True))}


def _config(m, n):
    if n <= 5:
        _, q, a = m.judged_configs()[n - 1]
        return q, a
    return next((q, a) for i, _, q, a in m.extra_configs() if i == n)


#: the modes each config must carry on the port's default plan
FLAG_MODES = {2: "cube", 3: "dense", 5: "pcube", 8: "cube", 9: "scube",
              10: "cube"}


@pytest.mark.parametrize("n", range(1, 11))
def test_flagship_configs_plan_and_answer_as_jax(flag, n):
    """c1-c10 plan the JAX default program's modes (c2, c5, c8, c9, c10 on
    the cube, c5 a pcube, c9 a scube, c3 dense products; c1, c4, c6, c7
    none) and answer == the oracle == row modes; the port's products were
    called (their counters)."""
    jq, ja = _config(jflag, n)
    pq, pa = _config(pflag, n)
    assert_plan_parity(flag["jax"], flag["port"], jq, ja, pq, pa)
    plan = flag["port"]._program_for(pq, pa).plan
    dense = {path for path, p in _nodes(plan).items() if p.get("dense_mm")}
    modes = set().union(*_modes(plan, dense).values())
    assert modes == ({FLAG_MODES[n]} | ({"cube"} if n in (5, 9) else set())
                     if n in FLAG_MODES else set()), modes
    pcube.reset_calls()
    preductions.reset_mm_calls()
    want = flag["oracle"].agg_search(pq, pa)
    assert flag["port"].agg_search(pq, pa) == want
    assert flag["row"].agg_search(pq, pa) == want
    if n in (2, 5, 8, 9, 10):
        assert pcube.calls["cube_dots"] > 0
    assert (pcube.calls["block_counts"] > 0) == (n == 5)
    assert (pcube.calls["slot_block_counts"] > 0) == (n == 9)
    assert (preductions.mm_calls["dense_bucket_counts_mm"] > 0) == (n == 3)
    if n in (3, 5, 9, 10):
        assert flag["jax"].agg_search(jq, ja) == want
    reqs = pflag.varied_requests(n, pa, 12)
    assert flag["port"].agg_search_batch(reqs) == \
        [flag["oracle"].agg_search(q, a) for q, a in reqs[:12]]
