"""The port's slice end to end on the CPU: c1-c5 shaped requests through
`agg_search` / `agg_search_batch` of tantivy_aggregations_tpu_torch, held
by exact `==` against the port's oracle, the JAX package's Searcher (cube
off, Pallas kernels in interpret mode) and the JAX oracle — all four over
ONE on-disk index written by the JAX writer.

Two indexes: a persisted fixtures.random_index with dense_nb=8 (forcing
the prefix modes, as tests/test_pallas_prefix.py does), and a small
flagship bench index (models/flagship.py schema, 4 segments) with the
judged configs themselves. Both pin the row modes (use_cube=False,
dense_mxu=False), whose plans these tests check kernel by kernel; the
default config's cube and dense products are held in test_torch_cube.py."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.models import flagship as jflag

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as pflag
from tantivy_aggregations_tpu_torch.query import compile as pqc

from fixtures import random_index

torch.set_num_threads(2)


def _persist(ram, path):
    disk = tat.Index.create(path, ram.schema)
    for seg in ram.segments:
        disk._add_segment(seg)
    disk._commit_meta()
    return path


@pytest.fixture(scope="module")
def rnd(tmp_path_factory):
    path = _persist(random_index(seed=21, n_docs=20_000),
                    str(tmp_path_factory.mktemp("slice") / "idx"))
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return {
        "port": pidx.searcher(device="cpu", config=EngineConfig(
            dense_nb=8, use_cube=False, dense_mxu=False)),
        "port_oracle": pidx.oracle_searcher(),
        "jax": jidx.searcher(config=JaxConfig(dense_nb=8, use_cube=False,
                                              pallas_interpret=True)),
        "jax_oracle": jidx.oracle_searcher(),
    }


def _shapes(m):
    """c1-c5 shaped (query builder j -> query, aggs) over the fixture
    schema, built with module `m`'s IR (tat or tt)."""
    return {
        "c1": (lambda j: m.MatchAllQuery(),
               {"n": m.count_agg(), "s": m.sum_agg("qty")}),
        "c2": (lambda j: m.TermQuery("cat", f"cat00{10 + j % 4}"),
               {"lo": m.min_agg("price"), "hi": m.max_agg("price"),
                "avg_w": m.avg_agg("counts")}),
        "c3": (lambda j: m.MatchAllQuery(),
               {"h": m.histogram_agg("ts", interval=1_000_000,
                                     sub_aggs={"s": m.sum_agg("qty")})}),
        "c4": (lambda j: m.BooleanQuery(
                   must=[m.RangeQuery("qty", lower=j, upper=990 - j)]),
               {"t": m.terms_agg("cat", size=10,
                                 sub_aggs={"s": m.sum_agg("price"),
                                           "sq": m.sum_agg("qty"),
                                           "n": m.count_agg()})}),
        "c5": (lambda j: m.BooleanQuery(must=[
                   m.RangeQuery("qty", lower=100 + j, upper=900 - j,
                                include_upper=True)]),
               {"p": m.percentiles_agg("price"),
                "pf": m.post_filter_agg(
                    m.TermQuery("cat", "cat0020"),
                    sub_aggs={"n": m.count_agg(), "s": m.sum_agg("delta"),
                              "h": m.histogram_agg("delta", interval=100)}),
                "t": m.terms_agg("cat", size=4,
                                 sub_aggs={"s": m.sum_agg("qty")})}),
    }


#: the plan entries that must take each kernel mode
KERNEL_MODES = {
    "c1": [(("a", "s"), "fused")],
    "c3": [(("a", "h"), "pallas_prefix")],
    "c4": [(("a", "t"), "pallas_prefix")],
    "c5": [(("a", "p"), "pallas_counts"), (("a", "pf", "s"), "fused"),
           (("a", "pf", "h"), "pallas_prefix")],
}


@pytest.mark.parametrize("cfg", ["c1", "c2", "c3", "c4", "c5"])
def test_port_matches_jax_and_oracles(rnd, cfg):
    jb, jaggs = _shapes(tat)[cfg]
    pb, paggs = _shapes(tt)[cfg]
    for j in (0, 3):
        want = rnd["jax_oracle"].agg_search(jb(j), jaggs)
        assert rnd["jax"].agg_search(jb(j), jaggs) == want
        assert rnd["port_oracle"].agg_search(pb(j), paggs) == want
        assert rnd["port"].agg_search(pb(j), paggs) == want
    prog = rnd["port"]._program_for(pb(0), paggs)
    for path, key in KERNEL_MODES.get(cfg, []):
        assert prog.plan[path].get(key), (path, key, prog.plan[path])


@pytest.mark.parametrize("cfg", ["c2", "c4", "c5"])
def test_batch_matches_single(rnd, cfg):
    pb, paggs = _shapes(tt)[cfg]
    reqs = [(pb(j), paggs) for j in range(9)]
    reqs += reqs[:3]  # duplicates ride the msearch dedup
    got = rnd["port"].agg_search_batch(reqs)
    assert got == [rnd["port"].agg_search(q, a) for q, a in reqs]
    assert got[0] is not got[9]


@pytest.mark.parametrize("cfg", ["c1", "c3", "c5"])
def test_batch_without_dedup(rnd, cfg):
    """Identical and param-free requests as separate batch rows (B > 1
    through every kernel) give the per-query results."""
    pidx = rnd["port"].index
    s = pidx.searcher(device="cpu",
                      config=EngineConfig(dense_nb=8, msearch_dedup=False))
    pb, paggs = _shapes(tt)[cfg]
    reqs = [(pb(j % 2), paggs) for j in range(5)]
    assert s.agg_search_batch(reqs) == [s.agg_search(q, a) for q, a in reqs]


def test_collect_stats(rnd):
    pidx = rnd["port"].index
    s = pidx.searcher(device="cpu",
                      config=EngineConfig(dense_nb=8, collect_stats=True))
    pb, paggs = _shapes(tt)["c5"]
    assert s.agg_search(pb(1), paggs) == \
        rnd["port_oracle"].agg_search(pb(1), paggs)
    st = s.last_stats
    assert not st.program_cached and st.total_ms > 0
    s.agg_search(pb(2), paggs)
    assert s.last_stats.program_cached


def test_collect_stats_on_the_host_path(rnd):
    pidx = rnd["port"].index
    s = pidx.searcher(device="cpu",
                      config=EngineConfig(dense_nb=8, collect_stats=True))
    # a two-deep multi-valued nest: no device lowering here or in JAX
    q, aggs = tt.MatchAllQuery(), _deep_multi_nest(tt)
    assert s.agg_search(q, aggs) == rnd["port_oracle"].agg_search(q, aggs)
    st = s.last_stats
    assert st.device_ms > 0 and st.wait_ms == 0 and st.harvest_ms == 0
    assert st.total_ms == st.prepare_ms + st.device_ms


def _deep_multi_nest(m):
    """terms over three multi-valued fields nested: the second is the one
    cross-product expansion the planners lower, the third is past it."""
    return {"t": m.terms_agg("tags", sub_aggs={
        "c": m.terms_agg("counts", size=3, sub_aggs={
            "s": m.terms_agg("scores", size=2)})})}


def _unlowered(m):
    """(aggs, query) with module `m`'s IR: shapes that once answered on
    the port's host path — top_hits, non-integer percents at the root and
    under a histogram, a TermSet query — which it now lowers as the JAX
    package does, and three it leaves to the host path as the JAX package
    does: a two-deep multi-valued nest, non-integer percents under a
    multi-valued terms agg whose 10 tag slots exceed dense_nb = 8 (phase
    2 admits no slot space past the dense budget), and top_hits under a
    bucket space past prod(hdims) * k = 4096 (50 cat terms x 100 hits)."""
    return [
        ({"t": m.top_hits_agg(size=3)}, m.MatchAllQuery()),
        ({"p": m.percentiles_agg("price", (2.5, 50.0))}, m.MatchAllQuery()),
        ({"h": m.histogram_agg("qty", interval=250, sub_aggs={
            "p": m.percentiles_agg("price", (2.5, 50.0))})},
         m.MatchAllQuery()),
        (_deep_multi_nest(m), m.MatchAllQuery()),
        ({"n": m.count_agg()}, m.TermSetQuery("cat", ["cat0001"])),
        ({"t": m.terms_agg("tags", sub_aggs={
            "p": m.percentiles_agg("qty", (2.5, 50.0))})},
         m.RangeQuery("qty", lower=100)),
        ({"t": m.terms_agg("cat", size=50, sub_aggs={
            "h": m.top_hits_agg(size=100)})}, m.MatchAllQuery()),
    ]


@pytest.mark.parametrize("i", range(7))
def test_unlowered_shapes_answer_exactly(rnd, i):
    """agg_search never raises NotImplementedError, == the port's oracle
    == the JAX package; the port answers a shape on the exact host path
    iff the JAX package does (cases 3, 5 and 6), and plans a device
    Program for every other."""
    from tantivy_aggregations_tpu_torch.searcher import _HostFallback
    jaggs, jq = _unlowered(tat)[i]
    aggs, q = _unlowered(tt)[i]
    want = rnd["port_oracle"].agg_search(q, aggs)
    assert want == rnd["jax_oracle"].agg_search(jq, jaggs)
    assert rnd["jax"].agg_search(jq, jaggs) == want
    assert rnd["port"].agg_search(q, aggs) == want
    prog = rnd["port"]._program_for(q, aggs)
    jprog = rnd["jax"]._program_for(jq, jaggs)
    assert isinstance(prog, _HostFallback) == (not hasattr(jprog, "plan")) \
        == (i in (3, 5, 6)), (prog, jprog)


# ---------------------------------------------------------------------------
# set-type queries (TermSet / Fuzzy / Regex): the run-slot opcodes
# ---------------------------------------------------------------------------

def _set_shapes(m):
    """(query, aggs, plan checks) of set-query requests with module `m`'s
    IR over the fixture schema (dense_nb=8): TermSet on stringy, narrow
    and f64 (+-0) fields, Fuzzy and Regex on the keyword field, sets inside
    a BooleanQuery and a filter_agg, and sets under a prefix terms agg
    (chain_blocks), rank percentiles (chain_counts) and slot_rank
    percentiles (chain_slot_counts)."""
    metrics = {"n": m.count_agg(), "s": m.sum_agg("qty"),
               "st": m.stats_agg("price"), "d": m.min_agg("delta")}
    pct = m.percentiles_agg("qty", (1.0, 50.0, 99.0))
    return [
        (m.TermSetQuery("cat", ["cat0003", "cat0004", "cat0010", "nope"]),
         metrics, ()),
        (m.TermSetQuery("qty", [3, 4, 5, 999, 10**12]), metrics, ()),
        (m.TermSetQuery("price", [0.0, 12.5, -1.25, 1e300]), metrics, ()),
        (m.TermSetQuery("price", [-0.0]), metrics, ()),
        (m.FuzzyTermQuery("cat", "cat0010"), metrics, ()),
        (m.RegexQuery("cat", "cat00[1-3][02468]"), metrics, ()),
        (m.BooleanQuery(must=[m.TermSetQuery("cat", ["cat0001", "cat0002",
                                                     "cat0007"])],
                        must_not=[m.RegexQuery("cat", "cat000[2-5]")],
                        should=[m.TermSetQuery("qty", [1, 2])]),
         metrics, ()),
        (m.MatchAllQuery(),
         {"f": m.filter_agg(m.TermSetQuery("qty", list(range(0, 600, 13))),
                            sub_aggs={"s": m.sum_agg("delta"),
                                      "h": m.histogram_agg("delta",
                                                           interval=100)})},
         ()),
        (m.RegexQuery("cat", "cat00[0-4][13579]"),
         {"t": m.terms_agg("cat", size=5, sub_aggs={"s": m.sum_agg("qty")})},
         ((("a", "t"), "pallas_prefix"),)),
        (m.TermSetQuery("price", [0.0, 12.5, -1.25, 33.33]),
         {"p": pct}, ((("a", "p"), "pallas_counts"),)),
        (m.FuzzyTermQuery("cat", "cat0021"),
         {"t": m.terms_agg("cat", size=3, sub_aggs={"p": pct})},
         ((("a", "t", "p"), "pallas_slots"),)),
    ]


@pytest.mark.parametrize("i", range(11))
def test_set_queries_match_jax_and_oracles(rnd, i):
    jq, jaggs, _ = _set_shapes(tat)[i]
    pq, paggs, modes = _set_shapes(tt)[i]
    want = rnd["jax_oracle"].agg_search(jq, jaggs)
    assert rnd["jax"].agg_search(jq, jaggs) == want
    assert rnd["port_oracle"].agg_search(pq, paggs) == want
    assert rnd["port"].agg_search(pq, paggs) == want
    prog = rnd["port"]._program_for(pq, paggs)
    assert prog._set_shape
    for path, key in modes:
        assert prog.plan[path].get(key), (path, key, prog.plan[path])


def _build(path, docs):
    """A one-segment index of `docs` over fixtures.basic_schema, written by
    the JAX package's writer."""
    from fixtures import basic_schema
    idx = tat.Index.create(path, basic_schema())
    w = idx.writer()
    for d in docs:
        w.add_document(d)
    w.commit()
    return path


def test_set_queries_on_a_wide_integer_field(tmp_path):
    """OP_SET_WIDE over a u64 column spanning past 2^32 (a wide (hi, lo)
    plane pair), at the root and under a prefix terms agg."""
    big = [0, 5, 2**32 - 1, 2**32, 2**40 + 3, 2**62 + 7, 2**63 - 3]
    docs = [{"qty": big[i % len(big)] + (i // len(big)) % 3,
             "cat": f"c{i % 40:02d}", "delta": i} for i in range(600)]
    path = _build(str(tmp_path / "idx"), docs)
    reqs = []
    for m in (tat, tt):
        aggs = {"n": m.count_agg(), "s": m.sum_agg("delta"),
                "t": m.terms_agg("cat", size=4,
                                 sub_aggs={"s": m.sum_agg("delta")})}
        reqs.append([(m.TermSetQuery("qty", vals), aggs) for vals in (
            [2**32, 2**32 + 1, 2**62 + 8], [0, 6, 2**63 - 1, 2**63 - 2],
            [2**40 + 4, 1, 12345], [2**64 - 1, 3, 2**32 - 1])])
    port = _four_way(path, list(zip(*reqs)), EngineConfig(dense_nb=8))
    prog = port._program_for(*reqs[1][0])
    assert not prog.dindex.column("qty").narrow
    assert prog.plan[("a", "t")]["pallas_prefix"]
    ops = prog.plan[("a", "t")]["chainp"]["mp"].ops
    assert set(ops[:, 0].tolist()) == {pqc.OP_SET_WIDE}


@pytest.fixture(scope="module")
def scatter(tmp_path_factory):
    """200 keyword terms, every other one ending in "x": a regex over the
    "x" terms matches 100 runs, past the 64 regex slots."""
    docs = [{"cat": f"t{i:03d}x" if i % 2 else f"t{i:03d}", "qty": i}
            for i in range(200)]
    path = _build(str(tmp_path_factory.mktemp("scatter") / "idx"), docs)
    return tat.Index.open(path), tt.Index.open(path)


def _scatter_aggs(m):
    return {"n": m.count_agg(), "s": m.sum_agg("qty")}


def test_regex_run_overflow_host_path(scatter):
    """An overflowing regex answers exactly on the host path, before and
    after a fitting regex of the same shape planned its Program, and the
    Program stays cached."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    from tantivy_aggregations_tpu_torch.searcher import _HostFallback
    jidx, pidx = scatter
    s = pidx.searcher(device="cpu")
    aggs = _scatter_aggs(tt)
    fitting = tt.RegexQuery("cat", "t00.*")
    overflowing = tt.RegexQuery("cat", "t\\d{3}x")
    for q in (overflowing, fitting, overflowing, fitting):
        want = pidx.oracle_searcher().agg_search(q, aggs)
        assert want == jidx.oracle_searcher().agg_search(
            tat.RegexQuery(q.field, q.pattern), _scatter_aggs(tat))
        assert s.agg_search(q, aggs) == want
    dindex = s._get_device_index()
    assert len(pqc.match_runs(dindex, overflowing)) > 64
    assert len(pqc.match_runs(dindex, fitting)) <= 64
    prog = s._program_for(fitting, aggs)
    assert isinstance(prog, Program) and prog.accepts(fitting, aggs)
    assert not prog.accepts(overflowing, aggs)
    fb = s._program_for(overflowing, aggs)
    assert isinstance(fb, _HostFallback) and fb is s._overflow_fb
    assert s._program_for(fitting, aggs) is prog


def test_msearch_mixes_fitting_and_overflowing_sets(scatter):
    _, pidx = scatter
    aggs = _scatter_aggs(tt)
    # fitting, overflowing (100 runs), fitting x 2 (one group), overflowing,
    # fitting (50 runs)
    qs = [tt.RegexQuery("cat", "t00.*"), tt.RegexQuery("cat", "t\\d{3}x"),
          tt.RegexQuery("cat", "t01[0-9]x?"), tt.RegexQuery("cat", "t00.*"),
          tt.RegexQuery("cat", "t[01]\\d{2}x"),
          tt.RegexQuery("cat", "t1\\d{2}x")]
    oracle = pidx.oracle_searcher()
    want = [oracle.agg_search(q, aggs) for q in qs]
    for dedup in (True, False):
        s = pidx.searcher(device="cpu",
                          config=EngineConfig(msearch_dedup=dedup))
        got = s.agg_search_batch([(q, aggs) for q in qs])
        assert got == want
        groups = s._submit_batch([(q, aggs) for q in qs])
        assert [len(g[1]) for g in groups] == [1, 1, 2, 1, 1]


@pytest.mark.parametrize("q", [tt.MatchAllQuery(),
                               tt.TermQuery("cat", "cat0003")])
def test_counts_beside_fused_metrics_reuse_their_counts(rnd, monkeypatch, q):
    """A root count and a filter's doc count beside a metric that the
    fused_metrics kernel answers take its counts of the same mask: the
    mask is not counted again (ts_count is not called), and every fruit
    == the port's oracle."""
    from tantivy_aggregations_tpu_torch.ops import reductions as R
    aggs = {"n": tt.count_agg(), "s": tt.sum_agg("qty"),
            "f": tt.filter_agg(tt.RangeQuery("qty", lower=5, upper=400),
                               sub_aggs={"st": tt.stats_agg("qty"),
                                         "n": tt.count_agg()})}
    want = rnd["port_oracle"].agg_search(q, aggs)

    def no_count(mask):
        raise AssertionError("the mask was counted again")

    monkeypatch.setattr(R, "ts_count", no_count)
    assert rnd["port"].agg_search(q, aggs) == want
    assert rnd["port"].agg_search_batch([(q, aggs)] * 3) == [want] * 3


def _many_params(m):
    """(query, aggs, plan check) with module `m`'s IR: a 64-value f64
    TermSet (64 wide run slots, 256 params) and a range, at the root and
    as the chain of a prefix terms agg (chain_blocks) and of a rank
    percentiles agg (chain_counts)."""
    q = m.BooleanQuery(must=[
        m.TermSetQuery("price", [0.5 * (i + 1) for i in range(64)]),
        m.RangeQuery("qty", lower=10)])
    return [
        (q, {"n": m.count_agg(), "s": m.sum_agg("qty")}, None),
        (q, {"t": m.terms_agg("cat", size=5,
                              sub_aggs={"s": m.sum_agg("qty")})},
         (("a", "t"), "pallas_prefix")),
        (q, {"p": m.percentiles_agg("qty", (1.0, 50.0, 99.0))},
         (("a", "p"), "pallas_counts")),
    ]


@pytest.mark.parametrize("i", range(3))
def test_chain_of_many_params_runs_on_the_device_path(rnd, i):
    """A chain past 256 params plans a device Program (the chain kernels
    read param rows too long to stage in place, so P has no limit) and
    answers == the port's oracle == the JAX package."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    port = rnd["port"]
    jq, jaggs, _ = _many_params(tat)[i]
    q, aggs, mode = _many_params(tt)[i]
    dindex = port._get_device_index()
    assert len(pqc.chain_param_keys(((q, ("q",)),), dindex)) > 256
    want = rnd["port_oracle"].agg_search(q, aggs)
    assert want == rnd["jax_oracle"].agg_search(jq, jaggs)
    assert rnd["jax"].agg_search(jq, jaggs) == want
    assert port.agg_search(q, aggs) == want
    prog = port._program_for(q, aggs)
    assert type(prog) is Program
    if mode is not None:
        path, key = mode
        assert prog.plan[path].get(key), prog.plan[path]
        assert len(prog.plan[path]["chainp"]["mp"].param_keys) > 256


# ---------------------------------------------------------------------------
# the judged configs on a small flagship bench index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "idx")
    jflag.build_bench_index(path, 40_000, seed=42, n_segments=4)
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return (pidx.searcher(device="cpu", config=EngineConfig(
                use_cube=False, dense_mxu=False)),
            pidx.oracle_searcher(),
            jidx.searcher(config=JaxConfig(use_cube=False,
                                           pallas_interpret=True)),
            jidx.oracle_searcher())


@pytest.mark.parametrize("i", range(5))
def test_flagship_judged_configs(bench, i):
    port, port_oracle, jax_s, jax_oracle = bench
    _, jq, jaggs = jflag.judged_configs()[i]
    _, pq, paggs = pflag.judged_configs()[i]
    want = jax_oracle.agg_search(jq, jaggs)
    assert jax_s.agg_search(jq, jaggs) == want
    assert port_oracle.agg_search(pq, paggs) == want
    assert port.agg_search(pq, paggs) == want
    reqs = pflag.varied_requests(i + 1, paggs, 40)
    got = port.agg_search_batch(reqs)
    for (q, a), g in zip(reqs[:8], got[:8]):
        assert g == port_oracle.agg_search(q, a)
    assert got == [port.agg_search(q, a) for q, a in reqs]


@pytest.mark.parametrize("i", [0, 2, 3])
def test_matchall_root_stays_one_row(bench, monkeypatch, i):
    """c1, c3 and c4 (MatchAll roots) at B = 4 without msearch dedup: the
    root mask that reaches fused_metrics (c1) is one row shared by the
    batch (batch stride 0), and every fruit == the JAX package's."""
    from tantivy_aggregations_tpu_torch.ops import kernels as K
    port, _, jax_s, _ = bench
    _, jq, jaggs = jflag.judged_configs()[i]
    _, pq, paggs = pflag.judged_configs()[i]
    seen = []
    fused = K.fused_metrics

    def spy(mask, plane, minmax=True):
        seen.append((tuple(mask.shape), mask.stride(0), minmax))
        return fused(mask, plane, minmax)

    monkeypatch.setattr(K, "fused_metrics", spy)
    s = port.index.searcher(device="cpu",
                            config=EngineConfig(msearch_dedup=False))
    got = s.agg_search_batch([(pq, paggs)] * 4)
    assert got == [jax_s.agg_search(jq, jaggs)] * 4
    if i == 0:
        T = s._program_for(pq, paggs).dindex.T
        assert seen == [((4, T), 0, False)]


def test_flagship_plans_the_kernel_modes(bench):
    port = bench[0]
    plans = {}
    for name, q, aggs in pflag.judged_configs():
        plans[name] = port._program_for(q, aggs).plan
    assert plans["c1_count_sum"][("a", "s")]["fused"]
    assert plans["c4_terms_highcard_nested"][("a", "t")]["pallas_prefix"]
    c5 = plans["c5_percentiles_mixed_postfilter"]
    assert c5[("a", "p")]["pallas_counts"]
    assert c5[("a", "pf", "s")]["fused"]
    assert c5[("a", "t")]["mode"] == "dense"
    assert plans["c3_date_histogram_sum"][("a", "h")]["mode"] == "dense"


# ---------------------------------------------------------------------------
# c6-c10: member operands (c7), slot_rank nested percentiles (c9) and a
# TermSet query (c10)
# ---------------------------------------------------------------------------

EXTRA = [6, 7, 8, 9, 10]


def _extra(m, n):
    """(query, aggs) of extra config `n` built with module `m`'s flagship."""
    return next((q, a) for i, _, q, a in m.extra_configs() if i == n)


@pytest.mark.parametrize("n", EXTRA)
def test_flagship_extra_configs(bench, n):
    port, port_oracle, jax_s, jax_oracle = bench
    jq, jaggs = _extra(jflag, n)
    pq, paggs = _extra(pflag, n)
    want = jax_oracle.agg_search(jq, jaggs)
    assert jax_s.agg_search(jq, jaggs) == want
    assert port_oracle.agg_search(pq, paggs) == want
    assert port.agg_search(pq, paggs) == want
    reqs = pflag.varied_requests(n, paggs, 40)
    jreqs = jflag.varied_requests(n, jaggs, 40)
    got = port.agg_search_batch(reqs)
    for (q, a), (jq2, ja2), g in zip(reqs[:6], jreqs[:6], got[:6]):
        assert g == port_oracle.agg_search(q, a)
        assert g == jax_s.agg_search(jq2, ja2)
    singles = [port.agg_search(q, a) for q, a in reqs]
    assert got == singles
    nodedup = port.index.searcher(
        device="cpu", config=EngineConfig(msearch_dedup=False))
    assert nodedup.agg_search_batch(reqs) == singles


def test_smoke_c6_reference_matches_oracle(bench):
    """chip_smoke.py holds c6 at 10M docs to a numpy reference (the
    oracle's order-by-sub-metric path does not finish there); here the
    reference equals the oracle."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    port, port_oracle, _, _ = bench
    q, aggs = _extra(pflag, 6)
    assert smoke.c6_reference(tt, port.index, q, aggs) == \
        port_oracle.agg_search(q, aggs)


def test_flagship_plans_member_op_and_slot_rank(bench):
    port = bench[0]
    c7 = port._program_for(*_extra(pflag, 7))
    mo = c7.plan[("a", "t")]["member_op"]
    assert mo["cols"] == ["cnt", "s:amount:0"]
    assert not c7.plan[("a", "t")]["pallas_prefix"]
    assert c7._root is None  # TermQuery(weights) has no mask program
    c9 = port._program_for(*_extra(pflag, 9))
    p = c9.plan[("a", "t", "p")]
    assert p["pmode"] == "slot_rank" and p["pallas_slots"]
    assert p["nslots"] == 4
    assert c9.batch_cap >= EngineConfig().max_batch


def _c7_index(path, n_docs=6000):
    jflag.build_bench_index(path, n_docs, seed=5, n_segments=2)
    return path


def _four_way(path, reqs, config=None):
    """port == port oracle == JAX (cube off, interpret) == JAX oracle for
    each (jax request, port request) pair; returns the port searcher."""
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    port = pidx.searcher(device="cpu", config=config)
    jax_s = jidx.searcher(config=JaxConfig(use_cube=False,
                                           pallas_interpret=True))
    for (jq, ja), (pq, pa) in reqs:
        want = jidx.oracle_searcher().agg_search(jq, ja)
        assert jax_s.agg_search(jq, ja) == want, jq
        assert pidx.oracle_searcher().agg_search(pq, pa) == want, pq
        assert port.agg_search(pq, pa) == want, pq
    assert port.agg_search_batch([r[1] for r in reqs]) == \
        [port.agg_search(q, a) for _, (q, a) in reqs]
    return port


def _c7_reqs(values):
    _, ja = _extra(jflag, 7)
    _, pa = _extra(pflag, 7)
    return [((tat.TermQuery("weights", v), ja), (tt.TermQuery("weights", v),
                                                 pa)) for v in values]


def test_c7_member_op_with_deletes(tmp_path):
    path = _c7_index(str(tmp_path / "idx"))
    w = tt.Index.open(path).writer()
    w.delete_term("status", "archived")
    w.commit()
    port = _four_way(path, _c7_reqs([500, 0, 999, 17]))
    prog = port._program_for(tt.TermQuery("weights", 500),
                             _extra(pflag, 7)[1])
    assert "member_op" in prog.plan[("a", "t")]


def test_c7_out_of_domain_value_gives_zeros(tmp_path):
    port = _four_way(_c7_index(str(tmp_path / "idx")),
                     _c7_reqs([1000, 10**9, 2**63]))
    got = port.agg_search(tt.TermQuery("weights", 10**9),
                          _extra(pflag, 7)[1])
    assert got["t"] == {"buckets": [], "sum_other_doc_count": 0}


def _member_shapes(m):
    """c7-shaped member-operand requests over the fixture schema: numeric
    (counts) and keyword (tags: docs may hold a tag twice) member fields,
    a must-wrapped leaf, and f64 / multi-valued payloads."""
    aggs = {"t": m.terms_agg("cat", size=6,
                             sub_aggs={"s": m.sum_agg("qty"),
                                       "p": m.sum_agg("price"),
                                       "c": m.avg_agg("counts"),
                                       "n": m.count_agg()})}
    return [(m.TermQuery("counts", 42), aggs),
            (m.TermQuery("counts", 7), aggs),
            (m.TermQuery("tags", "t3"), aggs),
            (m.TermQuery("tags", "no-such-tag"), aggs),
            (m.BooleanQuery(must=[m.TermQuery("counts", 0)]), aggs)]


@pytest.mark.parametrize("i", range(5))
def test_member_op_shapes_on_random_index(rnd, i):
    jq, ja = _member_shapes(tat)[i]
    pq, pa = _member_shapes(tt)[i]
    want = rnd["jax_oracle"].agg_search(jq, ja)
    assert rnd["jax"].agg_search(jq, ja) == want
    assert rnd["port_oracle"].agg_search(pq, pa) == want
    assert rnd["port"].agg_search(pq, pa) == want
    assert "member_op" in rnd["port"]._program_for(pq, pa).plan[("a", "t")]


def _slot_shapes(m):
    """c9-shaped nested percentiles over the fixture schema (dense_nb=8):
    a terms ancestor (rows without a cat have no slot), a histogram
    ancestor, histogram > terms (250 composite slots), and a filter under
    the histogram whose empty slots give null values."""
    q = m.RangeQuery("qty", lower=50, upper=950, include_upper=True)
    pct = m.percentiles_agg("price", (1.0, 25.0, 50.0, 99.0))
    return [
        (q, {"t": m.terms_agg("cat", size=5, sub_aggs={"p": pct})}),
        (q, {"h": m.histogram_agg("ts", interval=2_000_000,
                                  sub_aggs={"p": m.percentiles_agg("qty")})}),
        (m.MatchAllQuery(),
         {"h": m.histogram_agg("ts", interval=2_000_000, sub_aggs={
             "t": m.terms_agg("cat", size=3, sub_aggs={"p": pct})})}),
        (q, {"h": m.histogram_agg("ts", interval=2_000_000, sub_aggs={
            "f": m.filter_agg(m.RangeQuery("ts", upper=3_000_000),
                              sub_aggs={"p": pct})})}),
    ]


@pytest.mark.parametrize("i", range(4))
def test_slot_rank_shapes_on_random_index(rnd, i):
    jq, ja = _slot_shapes(tat)[i]
    pq, pa = _slot_shapes(tt)[i]
    want = rnd["jax_oracle"].agg_search(jq, ja)
    assert rnd["jax"].agg_search(jq, ja) == want
    assert rnd["port_oracle"].agg_search(pq, pa) == want
    assert rnd["port"].agg_search(pq, pa) == want
    prog = rnd["port"]._program_for(pq, pa)
    assert any(p.get("pmode") == "slot_rank" for p in prog.plan.values()
               if isinstance(p, dict))


def test_slot_rank_empty_slots_are_null(rnd):
    pq, pa = _slot_shapes(tt)[3]
    got = rnd["port"].agg_search(pq, pa)
    nulls = [b["f"]["p"]["values"] for b in got["h"]["buckets"]
             if b["f"]["doc_count"] == 0]
    assert nulls and all(v is None for vals in nulls for v in vals.values())


def test_batch_cap_splits_groups(rnd, monkeypatch):
    from tantivy_aggregations_tpu_torch.aggs import compile as pcompile
    pidx = rnd["port"].index
    pq, pa = _slot_shapes(tt)[0]
    reqs = [(tt.RangeQuery("qty", lower=50 + j, upper=950,
                           include_upper=True), pa) for j in range(5)]
    want = [rnd["port"].agg_search(q, a) for q, a in reqs]
    prog = rnd["port"]._program_for(pq, pa)
    per_q = prog.plan[("a", "t", "p")]["layout"].n_rows // 32 * 50 * 8
    monkeypatch.setattr(pcompile.Program, "BATCH_MEM_BUDGET", 2 * per_q)
    s = pidx.searcher(device="cpu", config=EngineConfig(
        dense_nb=8, use_cube=False, dense_mxu=False))
    assert s._program_for(pq, pa).batch_cap == 2
    groups = s._submit_batch(reqs)
    assert [len(g[1]) for g in groups] == [2, 2, 1]
    assert [r for g in groups for r in s._collect_group(g)] == want
    assert s.agg_search_batch(reqs) == want


# ---------------------------------------------------------------------------
# device state carried across: the port's operands == the JAX package's
# ---------------------------------------------------------------------------

def test_member_operand_matches_jax(bench):
    """The JAX member operand (int8 7-bit pieces, [Df_pad, W/128, 128])
    decoded by its shift-sum equals the port's exact int64 cells."""
    port, _, jax_s, _ = bench
    jprog = jax_s._program_for(*_extra(jflag, 7))
    pprog = port._program_for(*_extra(pflag, 7))
    jmo = jprog.plan[("a", "t")]["member_op"]
    pmo = pprog.plan[("a", "t")]["member_op"]
    card = jmo["card"]
    assert pmo["card"] == card
    assert pmo["cols"] == [gk for gk, _ in jmo["cols"]]
    jop = np.asarray(jprog._arrays[jmo["key"]])
    flat = jop.reshape(jop.shape[0], -1).astype(np.int64)
    decoded, off = [], 0
    for _, n in jmo["cols"]:
        sl = flat[:, off * card:(off + n) * card].reshape(-1, n, card)
        decoded.append(sum(sl[:, i] << (7 * i) for i in range(n)))
        off += n
    want = np.stack(decoded, axis=1)  # [Df_pad, n_cols, card]
    pop = pprog._arrays[pmo["key"]].reshape(
        -1, len(pmo["cols"]), pmo["card_pad"])[:, :, :card].numpy()
    np.testing.assert_array_equal(pop, want)


def test_slot_plane_matches_jax(bench):
    port, _, jax_s, _ = bench
    jprog = jax_s._program_for(*_extra(jflag, 9))
    pprog = port._program_for(*_extra(pflag, 9))
    jp = jprog.plan[("a", "t", "p")]
    pp = pprog.plan[("a", "t", "p")]
    assert jp["pallas_slots"] and jp["slotk"] == pp["slotk"]
    np.testing.assert_array_equal(
        pprog._arrays[pp["prefix"] + pp["slotk"]].numpy(),
        np.asarray(jprog._arrays[jp["prefix"] + jp["slotk"]]))
