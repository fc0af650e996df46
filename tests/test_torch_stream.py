"""The staged fruit copy and `agg_search_stream` in the PyTorch port, on
the CPU: tests/test_msearch.py's stream cases and tests/test_never_raise.py's
host-path groups inside msearch and the stream (no mesh), at lookahead 1,
2 and 5: results in request order, == the oracle and == agg_search_batch,
mixed shapes, a host-fallback group inside the stream, non-integer
percentiles (phase 2) and top_hits in the stream; and Program.stage gives
each staged result a buffer of its own. Every comparison is exact."""

import pytest
import torch

import tantivy_aggregations_tpu as tat

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.searcher import _HostFallback

from fixtures import basic_index, random_index
from test_never_raise import multi_index
from test_torch_multi_query import persist

torch.set_num_threads(2)

LOOKAHEADS = (1, 2, 5)


def _open(ram, tmp_path_factory, name):
    path = persist(ram, str(tmp_path_factory.mktemp("st") / name))
    idx = tt.Index.open(path)
    return idx, idx.oracle_searcher(), tat.Index.open(path)


@pytest.fixture(scope="module")
def rnd(tmp_path_factory):
    return _open(random_index(61, n_docs=300, n_segments=2),
                 tmp_path_factory, "r")


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    return _open(basic_index(num_segments=2), tmp_path_factory, "b")


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    return _open(multi_index(), tmp_path_factory, "m")


def _stream_equals(idx, oracle, reqs, lookahead, max_batch=128):
    s = idx.searcher(device="cpu", config=EngineConfig(max_batch=max_batch))
    got = list(s.agg_search_stream(iter(reqs), lookahead=lookahead))
    assert len(got) == len(reqs)
    want = [oracle.agg_search(q, a) for q, a in reqs]
    assert got == want
    assert s.agg_search_batch(reqs) == got


@pytest.mark.parametrize("lookahead", LOOKAHEADS)
def test_stream_api(rnd, lookahead):
    idx, oracle, _ = rnd
    aggs = {"n": tt.count_agg(), "s": tt.sum_agg("price")}
    reqs = [(tt.RangeQuery("qty", lower=10 * i), aggs) for i in range(40)]
    _stream_equals(idx, oracle, reqs, lookahead, max_batch=7)


@pytest.mark.parametrize("lookahead", LOOKAHEADS)
def test_stream_mixed_shapes_order(basic, lookahead):
    idx, oracle, _ = basic
    a1, a2 = {"n": tt.count_agg()}, {"s": tt.sum_agg("price")}
    reqs = [(tt.MatchAllQuery(), a1), (tt.TermQuery("cat", "a"), a1),
            (tt.RangeQuery("qty", lower=3), a2), (tt.MatchAllQuery(), a1),
            (tt.RangeQuery("qty", lower=7), a2), (tt.TermQuery("cat", "b"),
                                                  a1)]
    _stream_equals(idx, oracle, reqs, lookahead)


@pytest.mark.parametrize("lookahead", LOOKAHEADS)
def test_stream_with_phase2_percentiles_and_top_hits(rnd, lookahead):
    """In-run ranks and phase-2 ranks in one program, top_hits beside
    them, groups of 4 in flight."""
    idx, oracle, _ = rnd
    aggs = {"p": tt.percentiles_agg("price"),
            "pn": tt.percentiles_agg("price", percents=(0.5, 99.9)),
            "n": tt.count_agg(),
            "t": tt.terms_agg("cat", size=3, sub_aggs={
                "p": tt.percentiles_agg("qty", (12.5, 87.5)),
                "h": tt.top_hits_agg(2, "price")}),
            "h": tt.top_hits_agg(3, "qty", ascending=True)}
    reqs = [(tt.RangeQuery("qty", lower=50 * (i % 9)), aggs)
            for i in range(20)]
    _stream_equals(idx, oracle, reqs, lookahead, max_batch=4)


@pytest.mark.parametrize("lookahead", LOOKAHEADS)
def test_host_path_groups_in_msearch_and_stream(multi, lookahead):
    """A shape the planners refuse (a two-deep multi-valued nest) passes
    through both drivers between device groups."""
    idx, oracle, jidx = multi
    device_aggs = {"n": tt.count_agg(), "s": tt.sum_agg("qty")}
    fb_aggs = {"t": tt.terms_agg("counts", size=5, sub_aggs={
        "c": tt.terms_agg("tags", size=3, sub_aggs={
            "d": tt.terms_agg("counts", size=2)})})}
    jfb = {"t": tat.terms_agg("counts", size=5, sub_aggs={
        "c": tat.terms_agg("tags", size=3, sub_aggs={
            "d": tat.terms_agg("counts", size=2)})})}
    assert not hasattr(jidx.searcher()._program_for(tat.MatchAllQuery(),
                                                    jfb), "plan")
    s = idx.searcher(device="cpu")
    assert isinstance(s._program_for(tt.MatchAllQuery(), fb_aggs),
                      _HostFallback)
    reqs = [(tt.MatchAllQuery(), device_aggs), (tt.MatchAllQuery(), fb_aggs),
            (tt.TermQuery("cat", "a"), device_aggs),
            (tt.TermQuery("cat", "a"), fb_aggs)] * 3
    _stream_equals(idx, oracle, reqs, lookahead)


def test_staged_results_keep_their_own_buffers(rnd):
    """Two groups of one program staged before either is finalized, then
    finalized in reverse order: each reads its own copy."""
    idx, oracle, _ = rnd
    s = idx.searcher(device="cpu")
    aggs = {"n": tt.count_agg(), "p": tt.percentiles_agg("price", (99.9,))}
    qa = [tt.RangeQuery("qty", lower=100), tt.RangeQuery("qty", lower=600)]
    qb = [tt.RangeQuery("qty", lower=0), tt.RangeQuery("qty", lower=2000)]
    prog = s._program_for(qa[0], aggs)
    raws = [prog.submit_many(qs, aggs) for qs in (qa, qb)]
    staged = [prog.stage(r, aggs) for r in raws]
    assert staged[0].host.data_ptr() != staged[1].host.data_ptr()
    for qs, raw, st in reversed(list(zip((qa, qb), raws, staged))):
        assert prog.finalize_many(raw, aggs, 2, staged=st) == \
            [oracle.agg_search(q, aggs) for q in qs]


def test_collect_stats_stages_the_copy(rnd):
    idx, oracle, _ = rnd
    s = idx.searcher(device="cpu", config=EngineConfig(collect_stats=True))
    aggs = {"p": tt.percentiles_agg("price", (37.5,))}
    q = tt.RangeQuery("qty", lower=200)
    assert s.agg_search(q, aggs) == oracle.agg_search(q, aggs)
    st = s.last_stats
    assert st.wait_ms >= 0 and st.harvest_ms >= 0 and st.total_ms > 0
