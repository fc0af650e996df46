"""Phrase queries and the gathered doc mask in the PyTorch port, on the
CPU — the cases of tests/test_phrase.py and tests/test_bucket_mask_gather.py
that run unsharded, on their indexes, each held by `four_way` (port default
== port row modes == oracle == the JAX package, plans equal at both
configs): phrases over the dense per-position planes and over the CSR
token stream (bodies past DENSE_MULTI_K tokens), under Boolean
composition, deletes and bucket aggs; and prefix-mode terms and
histograms whose chain is not dense (a phrase over a tailed text field, a
term over a tailed multi-valued field) through the static pdoc plane
(`mask_gather`)."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat

from test_bucket_mask_gather import HIST, TERMS, tailed_index, text_index
from test_phrase import build as phrase_index
from test_torch_multi_query import (engines, four_way, persist, port_plan,
                                    to_port)

torch.set_num_threads(2)

AGGS = {"n": tat.count_agg(), "s": tat.sum_agg("qty")}


def _long_docs():
    """tests/test_phrase.py's long-docs corpus (CSR stream path)."""
    rng = np.random.default_rng(4)
    vocab = ["w%d" % i for i in range(12)]
    docs = []
    for i in range(300):
        toks = [vocab[int(t)] for t in rng.integers(0, 12,
                                                    int(rng.integers(0, 30)))]
        docs.append({"body": " ".join(toks), "qty": int(i),
                     "cat": "c%d" % (i % 3)})
    docs.append({"body": " ".join(["w1 w2"] * 40), "qty": 7, "cat": "c0"})
    return docs


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    return engines(persist(phrase_index([
        {"body": "the quick brown fox", "cat": "a", "qty": 1},
        {"body": "quick the brown fox quick", "cat": "b", "qty": 2},
        {"body": "brown quick", "cat": "a", "qty": 4},
        {"body": "the quick", "cat": "b", "qty": 8},
        {"cat": "a", "qty": 16},  # no body
    ], segments_at=(1,)), str(tmp_path_factory.mktemp("mp") / "basic")))


@pytest.fixture(scope="module")
def long_docs(tmp_path_factory):
    return engines(persist(phrase_index(_long_docs(),
                                        deletes=(("cat", "c1"),),
                                        segments_at=(150,)),
                           str(tmp_path_factory.mktemp("mp") / "long")),
                   dense_nb=8)


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    return engines(persist(text_index(),
                           str(tmp_path_factory.mktemp("mp") / "text")))


@pytest.fixture(scope="module")
def tailed(tmp_path_factory):
    return engines(persist(tailed_index(),
                           str(tmp_path_factory.mktemp("mp") / "tailed")))


@pytest.mark.parametrize("phrase", [
    "quick brown", "the quick brown fox", "brown fox quick", "quick",
    "fox quick brown", "quick zebra", ""])
def test_phrase_basic(basic, phrase):
    four_way(basic, tat.PhraseQuery("body", phrase), AGGS)


@pytest.mark.parametrize("phrase", ["w1 w2", "w2 w1 w0", "w3", "w5 w5",
                                    "w0 w1 w2 w3"])
def test_phrase_long_docs_csr_stream_path(long_docs, phrase):
    four_way(long_docs, tat.PhraseQuery("body", phrase), AGGS)


def test_phrase_under_boolean_deletes_and_buckets(long_docs):
    q = tat.BooleanQuery(must=[tat.PhraseQuery("body", "w1 w2"),
                               tat.RangeQuery("qty", lower=10)],
                         must_not=[tat.TermQuery("cat", "c2")])
    aggs = {"t": tat.terms_agg("cat", size=3,
                               sub_aggs={"s": tat.sum_agg("qty")}),
            "h": tat.histogram_agg("qty", interval=50),
            "p": tat.percentiles_agg("qty")}
    four_way(long_docs, q, aggs)
    p = port_plan(long_docs, q, aggs, ("a", "p"))
    assert p.get("mask_gather"), p


def test_phrase_param_dispatch_one_program(basic):
    """Same token count, same program; an msearch group of phrases."""
    s = basic["port"]
    aggs = to_port(AGGS)
    p1 = s._program_for(to_port(tat.PhraseQuery("body", "aa bb")), aggs)
    p2 = s._program_for(to_port(tat.PhraseQuery("body", "the quick")), aggs)
    assert p1 is p2
    reqs = [(to_port(tat.PhraseQuery("body", t)), aggs)
            for t in ("the quick", "quick brown", "brown fox", "zz yy",
                      "the quick")]
    assert s.agg_search_batch(reqs) == \
        [basic["oracle"].agg_search(q, a) for q, a in reqs]


@pytest.mark.parametrize("q", [
    tat.PhraseQuery("body", "alpha beta"), tat.PhraseQuery("body", "omega"),
    tat.PhraseQuery("body", "alpha zebra"),
    tat.BooleanQuery(must=[tat.PhraseQuery("body", "beta gamma"),
                           tat.RangeQuery("amount", lower=100)])])
def test_phrase_gated_terms_plans_prefix(text, q):
    four_way(text, q, TERMS)
    p = port_plan(text, q, TERMS, ("a", "t"))
    assert p["mode"] == "prefix" and p.get("mask_gather"), p


@pytest.mark.parametrize("phrase", ["alpha beta", "delta omega"])
def test_phrase_gated_histogram_plans_prefix(text, phrase):
    q = tat.PhraseQuery("body", phrase)
    four_way(text, q, HIST)
    p = port_plan(text, q, HIST, ("a", "h"))
    assert p["mode"] == "prefix" and p.get("mask_gather"), p


@pytest.mark.parametrize("q", [tat.TermQuery("vals", 7),
                               tat.RangeQuery("vals", lower=10, upper=30),
                               tat.TermQuery("vals", 9999)])
def test_tail_gated_terms_plans_prefix(tailed, q):
    aggs = {"t": tat.terms_agg("sku", size=10,
                               sub_aggs={"s": tat.sum_agg("amount")})}
    four_way(tailed, q, aggs)
    p = port_plan(tailed, q, aggs, ("a", "t"))
    assert p["mode"] == "prefix" and p.get("mask_gather"), p


def test_mask_gather_msearch_batch(text):
    reqs = [(to_port(tat.PhraseQuery("body", ph)), to_port(TERMS))
            for ph in ("alpha beta", "omega", "beta gamma", "alpha beta",
                       "zeta delta")]
    want = [text["oracle"].agg_search(q, a) for q, a in reqs]
    assert text["port"].agg_search_batch(reqs) == want
    assert text["row"].agg_search_batch(reqs) == want


def test_mask_gather_with_deletes(tmp_path):
    idx = text_index(n=900)
    w = idx.writer()
    w.delete_term("sku", "s00007")
    w.commit()
    env = engines(persist(idx, str(tmp_path / "idx")))
    four_way(env, tat.PhraseQuery("body", "alpha beta"), TERMS)
