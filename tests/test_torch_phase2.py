"""Non-integer percents (phase 2) in the PyTorch port, on the CPU: the
program ships each query's match count, keeps its count prefix on the
device, the host resolves exact rational ranks and one device call per
node selects the rank rows for the group. Each request's fruits from the
port at its default EngineConfig == the port in row modes == the oracle ==
the JAX package (Pallas in interpret mode), and the port plans it as the
JAX package does (`assert_phase2_parity`: modes, the terms selection and
the percent kind, or the host path in both), at the root (single-valued,
value rows, the permuted multi planes, a tailed chain's gathered mask),
under terms for every order target, under a histogram and under a
multi-valued terms agg (wslots), over empty scopes, and in msearch groups
with a distinct m per query, dedup on and off. Every comparison is exact.

The helpers here (`bench_index`, `assert_phase2_parity`, `check`) are
shared with test_torch_top_hits.py, test_torch_facets.py and
test_torch_stream.py."""

import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.models import flagship as jflag

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig

from test_cross_mode import build_random
from test_torch_multi_query import (build_multi, engines, persist,
                                    plan_modes, to_port)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def bench_index(path, n=4000):
    """The flagship bench schema (models/flagship.py) at n docs in 2
    segments, written by the JAX writer."""
    jflag.build_bench_index(path, n, seed=42, n_segments=2)
    return path


def _sel_modes(plan) -> dict:
    """{path: what a parity check compares beyond plan_modes}: whether a
    terms node selects by the device top-k, a facet's child set, the
    percent kind of a percentile node, top_hits' in-slot and score
    flags."""
    out = {}
    for path, p in plan.items():
        if not (path and path[0] == "a" and isinstance(p, dict)):
            continue
        kind = p.get("kind")
        if kind == "terms":
            fc = p.get("facet_children")
            out[path] = (p["sel"] == "topk",
                         None if fc is None else tuple(fc.tolist()))
        elif kind == "percentiles":
            out[path] = bool(p["int_percents"])
        elif kind == "top_hits":
            out[path] = (bool(p["in_slot"]), bool(p.get("score")), p["k"])
    return out


def assert_phase2_parity(jax_s, port_s, jq, jaggs, pq, paggs) -> str:
    """The port plans (pq, paggs) as the JAX package plans (jq, jaggs):
    the host path in both, or device Programs with equal modes per node
    (plan_modes) and equal selections, percent kinds and top_hits flags
    (_sel_modes). Returns "host" or "device"."""
    from tantivy_aggregations_tpu.searcher import _HostFallback as JaxFb
    from tantivy_aggregations_tpu_torch.searcher import _HostFallback
    jp = jax_s._program_for(jq, jaggs)
    pp = port_s._program_for(pq, paggs)
    assert isinstance(jp, JaxFb) == isinstance(pp, _HostFallback), \
        (jq, getattr(pp, "reason", None), getattr(jp, "reason", None))
    if isinstance(pp, _HostFallback):
        return "host"
    for f in (plan_modes, _sel_modes):
        a, b = f(jp.plan), f(pp.plan)
        assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                        if a.get(k) != b.get(k)}
    return "device"


def check(env, jq, jaggs, where=None):
    """port == port row modes == oracle == JAX, with plan parity at both
    configs; `where`: "host" or "device", the path both must plan.
    Returns the fruits."""
    pq, paggs = to_port(jq), to_port(jaggs)
    want = env["oracle"].agg_search(pq, paggs)
    assert env["port"].agg_search(pq, paggs) == want, pq
    assert env["row"].agg_search(pq, paggs) == want, pq
    assert env["jax"].agg_search(jq, jaggs) == want, jq
    got = assert_phase2_parity(env["jax"], env["port"], jq, jaggs, pq, paggs)
    assert assert_phase2_parity(env["jax_row"], env["row"], jq, jaggs, pq,
                                paggs) == got
    if where is not None:
        assert got == where, (jq, got)
    return want


def plan_of(env, jq, jaggs, path):
    prog = env["port"]._program_for(to_port(jq), to_port(jaggs))
    return prog.plan[path]


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return engines(bench_index(str(tmp_path_factory.mktemp("p2") / "b")))


@pytest.fixture(scope="module")
def rnd(tmp_path_factory):
    return engines(persist(build_random(77, n=400),
                           str(tmp_path_factory.mktemp("p2") / "r")))


@pytest.fixture(scope="module")
def tailed(tmp_path_factory):
    return engines(build_multi(str(tmp_path_factory.mktemp("p2") / "t"),
                               n=600))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return engines(build_multi(str(tmp_path_factory.mktemp("p2") / "d"),
                               n=600, seed=14, tails=False))


def _rng(m, k=0):
    return m.RangeQuery("amount", lower=100 + k, upper=9000 - k,
                        include_upper=True)


# ---------------------------------------------------------------------------
# at the root
# ---------------------------------------------------------------------------

def _root_cases(m):
    """(query, aggs, plan flag of the percentile node) over the bench
    index: single-valued (chain_counts), a multi-valued percentile field's
    value rows, and a chain over the multi-valued weights' planes."""
    return [
        (_rng(m), {"p": m.percentiles_agg(
            "price", (1, 5, 25, 50, 75, 95, 99, 99.9))}, "pallas_counts"),
        (m.TermQuery("status", "active"),
         {"p": m.percentiles_agg("weights", (50, 99.9)),
          "n": m.count_agg()}, "pallas_counts"),
        (m.RangeQuery("weights", lower=100, upper=899),
         {"p": m.percentiles_agg("price", (99.5,))}, "pallas_counts"),
        (m.MatchAllQuery(), {"p": m.percentiles_agg("qty", (0.0, 12.5,
                                                            100.0))},
         "pallas_counts"),
    ]


@pytest.mark.parametrize("i", range(4))
def test_root_nonint_percents(bench, i):
    jq, jaggs, flag = _root_cases(tat)[i]
    check(bench, jq, jaggs, "device")
    p = plan_of(bench, jq, jaggs, ("a", "p"))
    assert p["pmode"] == "rank" and not p["int_percents"]
    assert p[flag] and p["pcube"] is None


def test_root_nonint_percents_gather_the_tailed_mask(tailed):
    """A chain over a field with an overflow tail gathers the scope's doc
    mask (mask_gather); phase 2's windows re-read it through pdoc."""
    aggs = {"p": tat.percentiles_agg("qty", (2.5, 50.0, 99.9)),
            "n": tat.count_agg()}
    for q in (tat.RangeQuery("vals", lower=10, upper=520),
              tat.TermQuery("vals", 517)):
        check(tailed, q, aggs, "device")
    assert plan_of(tailed, q, aggs, ("a", "p"))["mask_gather"]


def test_root_mixed_integer_and_phase2_nodes(rnd):
    """An integer node (ranks in the run) beside two phase-2 nodes, one
    under a filter."""
    aggs = {"pi": tat.percentiles_agg("f", (25, 50)),
            "pn": tat.percentiles_agg("f", (0.5, 99.9)),
            "fl": tat.filter_agg(tat.RangeQuery("i", lower=0), {
                "p": tat.percentiles_agg("u", (33.3, 66.6))})}
    check(rnd, tat.TermQuery("k", "key010"), aggs, "device")
    check(rnd, tat.MatchAllQuery(), aggs, "device")


# ---------------------------------------------------------------------------
# under buckets
# ---------------------------------------------------------------------------

_ORDERS = [None, ("_count", "asc"), ("_key", "asc"), ("_key", "desc"),
           ("s", "desc"), ("a", "asc"), ("mn", "asc"), ("c", "desc")]


@pytest.mark.parametrize("order", _ORDERS)
def test_under_terms_every_order_target(rnd, order):
    """A terms ancestor of a non-integer percentile selects on the host
    (its fruits stay full-slot-space), for every order target."""
    aggs = {"t": tat.terms_agg("k", size=5, order=order, sub_aggs={
        "p": tat.percentiles_agg("f", (12.5, 50.5, 99.9)),
        "s": tat.sum_agg("u"), "a": tat.avg_agg("i"),
        "mn": tat.min_agg("f"), "c": tat.count_agg()})}
    for q in (tat.MatchAllQuery(), tat.TermQuery("k", "key010"),
              tat.RangeQuery("u", lower=2**39)):
        check(rnd, q, aggs, "device")
    assert plan_of(rnd, q, aggs, ("a", "t"))["sel"] == "host"
    p = plan_of(rnd, q, aggs, ("a", "t", "p"))
    assert p["pmode"] == "slot_rank" and not p["int_percents"]


def test_under_bench_terms(bench):
    """p2's shape: terms(status){percentiles(price, 50, 99.9)}."""
    aggs = {"t": tat.terms_agg("status", 4, sub_aggs={
        "p": tat.percentiles_agg("price", (50, 99.9))})}
    for k in (0, 7):
        check(bench, _rng(tat, k), aggs, "device")


def test_under_histogram_and_nested(rnd):
    for aggs in (
            {"h": tat.histogram_agg("u", interval=2**38, sub_aggs={
                "p": tat.percentiles_agg("f", (0.0, 12.5, 99.9, 100.0))})},
            {"t": tat.terms_agg("k", size=4, sub_aggs={
                "h": tat.histogram_agg("u", interval=2**39, sub_aggs={
                    "p": tat.percentiles_agg("f", (37.5,))})})}):
        check(rnd, tat.MatchAllQuery(), aggs, "device")
        check(rnd, tat.RangeQuery("i", lower=-2**34), aggs, "device")


def test_under_a_multi_valued_terms_agg_wslots(dense):
    """wslots' phase 2: occurrence-weighted counts per slot, the weighted
    windows re-read in phase 2."""
    aggs = {"t": tat.terms_agg("tags", size=8, sub_aggs={
        "p": tat.percentiles_agg("qty", (12.5, 50.5, 99.9))})}
    for q in (tat.MatchAllQuery(), tat.TermQuery("cat", "c1"),
              tat.RangeQuery("qty", lower=40, upper=60)):
        check(dense, q, aggs, "device")
    p = plan_of(dense, q, aggs, ("a", "t", "p"))
    assert p["wslots"] and not p["int_percents"]


def test_past_the_dense_budget_answers_on_the_host_path(rnd):
    """Integer percents under a slot space past dense_nb lower through
    the big-slot admission; non-integer ones do not (as in JAX)."""
    jaggs = {"t": tat.terms_agg("k", size=40, sub_aggs={
        "h": tat.histogram_agg("u", interval=2**35, sub_aggs={
            "p": tat.percentiles_agg("f", (25.5,))})})}
    check(rnd, tat.MatchAllQuery(), jaggs, "host")


# ---------------------------------------------------------------------------
# empty scopes, and msearch groups
# ---------------------------------------------------------------------------

def test_m_zero_scopes(rnd, bench):
    """m == 0 resolves ranks (0, 0, 0.0) and every value is None."""
    empty = tat.RangeQuery("u", lower=2**62)
    got = check(rnd, empty, {"p": tat.percentiles_agg("f", (99.9,)),
                             "h": tat.histogram_agg("i", interval=2**34,
                                                    sub_aggs={
                "p": tat.percentiles_agg("f", (12.5,))})}, "device")
    assert got["p"]["values"] == {"99.9": None}
    got = check(bench, tat.RangeQuery("amount", lower=9000, upper=100),
                {"p": tat.percentiles_agg("price", (99.9,))}, "device")
    assert got["p"]["values"] == {"99.9": None}


@pytest.mark.parametrize("dedup", [True, False])
def test_msearch_groups_distinct_m(bench, dedup):
    """One group, a distinct m per query (repeats among them), root and
    slot phase-2 nodes: one phase-2 call per node for the group."""
    from tantivy_aggregations_tpu_torch.aggs.compile import Program
    jaggs = {"p": tat.percentiles_agg("price", (0.5, 37.5, 99.9)),
             "t": tat.terms_agg("status", 4, sub_aggs={
                 "p": tat.percentiles_agg("qty", (12.5, 99.9))})}
    paggs = to_port(jaggs)
    reqs = [(tt.RangeQuery("amount", lower=500 * (j % 7), upper=9000),
             paggs) for j in range(10)]
    reqs.append((tt.RangeQuery("amount", lower=9000, upper=1), paggs))
    want = [bench["oracle"].agg_search(q, a) for q, a in reqs]
    s = bench["port"].index.searcher(
        device="cpu", config=EngineConfig(msearch_dedup=dedup))
    calls = []
    orig = Program._select_rows

    def counted(self, p, st, arrays, ranks):
        calls.append(ranks.shape[0])
        return orig(self, p, st, arrays, ranks)

    Program._select_rows = counted
    try:
        assert s.agg_search_batch(reqs) == want
    finally:
        Program._select_rows = orig
    # the group's two phase-2 nodes, once each, over its distinct queries
    assert calls == [8 if dedup else 11] * 2
    jreqs = [(tat.RangeQuery("amount", lower=500 * (j % 7), upper=9000),
              jaggs) for j in range(4)]
    assert bench["jax"].agg_search_batch(jreqs) == want[:4]
