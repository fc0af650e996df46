"""Mask programs over multi-valued fields, Exists and Phrase in the PyTorch
port, on the CPU: for each query, the port's mask program over the port
loader's planes == the JAX package's eval_mask over the JAX loader's, and
the port's count == the oracle's — narrow, keyword and wide multi-valued
leaves (term, range, prefix, TermSet, Fuzzy, Regex) over the per-position
planes, Exists on every field kind, overflow tails (a value present only
past position DENSE_MULTI_K), and Phrase over the dense planes and over
the CSR token stream, across doc boundaries. Both engines read one on-disk
index written by the JAX writer. Every comparison is exact.

The helpers here (`to_port`, `persist`, `engines`, `four_way`,
`assert_plan_parity`) are shared with the other test_torch_multi_*
files."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.index.loader import \
    load_device_index as jax_load
from tantivy_aggregations_tpu.schema import Cardinality as JCard

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.index.loader import DENSE_MULTI_K
from tantivy_aggregations_tpu_torch.index.loader import \
    load_device_index as port_load
from tantivy_aggregations_tpu_torch.query import compile as pqc
from tantivy_aggregations_tpu_torch.searcher import _HostFallback

from test_torch_kernels import assert_mask_matches_jax

torch.set_num_threads(2)

ROW_MODES = EngineConfig(use_cube=False, dense_mxu=False)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def to_port(x):
    """The port's IR for a JAX-package query / agg tree (the two IRs are
    the same dataclasses in parallel modules)."""
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        mod = importlib.import_module(type(x).__module__.replace(
            "tantivy_aggregations_tpu", "tantivy_aggregations_tpu_torch", 1))
        if type(x).__name__ == "FacetAgg":  # its own constructor
            return mod.FacetAgg(x.field, x.path, x.size)
        # sub-aggs are frozen (name, agg) pairs, built from a mapping
        return getattr(mod, type(x).__name__)(
            **{f.name: to_port(dict(getattr(x, f.name))
                               if f.name == "sub_aggs"
                               else getattr(x, f.name))
               for f in dataclasses.fields(x) if f.init})
    return x


def persist(ram, path) -> str:
    """A JAX-package RAM index written to `path` (its segments as they
    are)."""
    disk = tat.Index.create(path, ram.schema)
    for seg in ram.segments:
        disk._add_segment(seg)
    disk._commit_meta()
    return path


def engines(path, dense_nb=256):
    """The searchers a four-way check reads, over one on-disk index: the
    port at its default config and in row modes, the port's oracle, and
    the JAX package at its default config (Pallas in interpret mode) and
    in row modes (planned only, for plan parity)."""
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return {
        "port": pidx.searcher(device="cpu",
                              config=EngineConfig(dense_nb=dense_nb)),
        "row": pidx.searcher(device="cpu", config=EngineConfig(
            dense_nb=dense_nb, use_cube=False, dense_mxu=False)),
        "oracle": pidx.oracle_searcher(),
        "jax": jidx.searcher(config=JaxConfig(dense_nb=dense_nb,
                                              pallas_interpret=True)),
        "jax_row": jidx.searcher(config=JaxConfig(
            dense_nb=dense_nb, use_cube=False, dense_mxu=False,
            pallas_interpret=True)),
    }


#: the plan flags a parity check compares (beside mode / pmode, the cube
#: modes, a member operand and an expansion)
_FLAGS = ("mask_gather", "wslots", "plane_fanout", "pallas_counts",
          "pallas_prefix", "pallas_slots")


def plan_modes(plan) -> dict:
    """{agg path: (kind, mode, pmode, cube modes, flags, xpand, member)}."""
    out = {}
    for path, p in plan.items():
        if not (path and path[0] == "a" and isinstance(p, dict)):
            continue
        out[path] = (p.get("kind"), p.get("mode"), p.get("pmode"),
                     tuple(k for k in ("cube", "pcube", "scube")
                           if p.get(k) is not None),
                     tuple(k for k in _FLAGS if p.get(k)),
                     p.get("xpand") is not None,
                     bool(p.get("member_op")))
    return out


def assert_plan_parity(jax_s, port_s, jq, jaggs, pq, paggs):
    """The port plans (pq, paggs) as the JAX package plans (jq, jaggs):
    the host path in both, or device Programs with equal modes per node.
    Returns "host" or "device". One divergence is on purpose and is not
    held here: an f64 histogram whose column spans more than MAX_HIST_NB
    buckets, under a range on its own field, plans on the device in the
    port (laid out over the range, aggs/compile.py `_range_layout`) and
    on the host path in the JAX package; its answers are held `==` the
    oracle and the JAX package in tests/test_torch_hist_range_layout.py."""
    from tantivy_aggregations_tpu.searcher import _HostFallback as JaxFb
    jp = jax_s._program_for(jq, jaggs)
    pp = port_s._program_for(pq, paggs)
    assert isinstance(jp, JaxFb) == isinstance(pp, _HostFallback), \
        (jq, getattr(pp, "reason", None), getattr(jp, "reason", None))
    if isinstance(pp, _HostFallback):
        return "host"
    a, b = plan_modes(jp.plan), plan_modes(pp.plan)
    assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
    return "device"


def four_way(env, jq, jaggs):
    """port == port row modes == oracle == JAX, with plan parity at both
    configs; returns (fruits, "host" | "device")."""
    pq, paggs = to_port(jq), to_port(jaggs)
    want = env["oracle"].agg_search(pq, paggs)
    assert env["port"].agg_search(pq, paggs) == want, pq
    assert env["row"].agg_search(pq, paggs) == want, pq
    assert env["jax"].agg_search(jq, jaggs) == want, jq
    where = assert_plan_parity(env["jax"], env["port"], jq, jaggs, pq,
                               paggs)
    assert assert_plan_parity(env["jax_row"], env["row"], jq, jaggs, pq,
                              paggs) == where
    return want, where


def port_plan(env, jq, jaggs, path, which="port"):
    """The port's plan entry at `path` of (jq, jaggs) in IR form."""
    prog = env[which]._program_for(to_port(jq), to_port(jaggs))
    assert not isinstance(prog, _HostFallback), prog.reason
    return prog.plan[path]


# ---------------------------------------------------------------------------
# the index: every multi-valued field kind, tails and a text field
# ---------------------------------------------------------------------------

def build_multi(path, n=1500, seed=13, tails=True):
    """narrow (vals, u64), keyword (tags), wide (big, u64 over 2^40;
    ratios, f64) multi-valued fields, a text field (body) and single-valued
    fields; with `tails`, one doc in 12 holds 9-14 values (the overflow
    tails) and 9-20 tokens (the CSR phrase stream), and values 500-549 of
    vals and tokens w12-w13 occur only there."""
    schema = (tat.SchemaBuilder()
              .add_u64_field("qty")
              .add_keyword_field("cat")
              .add_u64_field("vals", cardinality=JCard.MULTI)
              .add_keyword_field("tags", cardinality=JCard.MULTI)
              .add_u64_field("big", cardinality=JCard.MULTI)
              .add_f64_field("ratios", cardinality=JCard.MULTI)
              .add_text_field("body")
              .build())
    idx = tat.Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(seed)
    vocab = [f"t{i:03d}" for i in range(30)]
    words = [f"w{i}" for i in range(12)]
    for i in range(n):
        long = tails and rng.random() < 1 / 12
        nv = int(rng.integers(DENSE_MULTI_K + 1, DENSE_MULTI_K + 7)) \
            if long else int(rng.integers(0, 4))
        vals = [int(x) for x in rng.integers(0, 50, nv)]
        if long:
            vals[DENSE_MULTI_K:] = [500 + int(x) for x in
                                    rng.integers(0, 50, nv - DENSE_MULTI_K)]
        ntok = int(rng.integers(9, 21)) if long else int(rng.integers(0, 7))
        toks = [words[int(x)] for x in rng.integers(0, 12, ntok)]
        if long:
            toks[-2:] = ["w12", "w13"]
        w.add_document({
            "qty": int(rng.integers(0, 100)),
            "cat": f"c{int(rng.integers(0, 5))}",
            "vals": vals,
            "tags": [vocab[int(x)] for x in rng.integers(0, 30, nv)],
            "big": [int(x) if rng.random() < 0.8 else 7 * 2**33
                    for x in rng.integers(0, 2**40, nv)],
            "ratios": [float(np.round(x, 3))
                       for x in rng.lognormal(0.0, 2.0, nv)],
            "body": " ".join(toks)})
        if i in (n // 3, 2 * n // 3):
            w.commit()
    w.commit()
    return persist(idx, path)


@pytest.fixture(scope="module")
def tailed(tmp_path_factory):
    path = build_multi(str(tmp_path_factory.mktemp("mq") / "tailed"))
    return (jax_load(tat.Index.open(path)), port_load(tt.Index.open(path),
                                                      "cpu"),
            tt.Index.open(path))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    path = build_multi(str(tmp_path_factory.mktemp("mq") / "dense"),
                       seed=14, tails=False)
    return (jax_load(tat.Index.open(path)), port_load(tt.Index.open(path),
                                                      "cpu"),
            tt.Index.open(path))


def _leaves(m):
    """Leaves over each multi-valued field kind with module `m`'s IR."""
    return [
        m.TermQuery("vals", 7), m.RangeQuery("vals", lower=10, upper=20),
        m.TermSetQuery("vals", [3, 4, 5, 44, 999]),
        m.TermQuery("tags", "t005"), m.TermQuery("tags", "nope"),
        m.RangeQuery("tags", lower="t010", upper="t020"),
        m.PrefixQuery("tags", "t01"),
        m.TermSetQuery("tags", ["t001", "t002", "t029"]),
        m.FuzzyTermQuery("tags", "t012"), m.RegexQuery("tags", "t0[0-1][13]"),
        m.TermQuery("big", 7 * 2**33),
        m.RangeQuery("big", lower=2**35, upper=2**39),
        m.RangeQuery("big", upper=2**34, include_upper=False),
        m.TermSetQuery("big", [7 * 2**33, 999, 2**38]),
        m.RangeQuery("ratios", lower=0.5, upper=4.0),
        m.TermSetQuery("ratios", [0.5, 1.25]),
        m.BooleanQuery(must=[m.RangeQuery("vals", lower=5)],
                       must_not=[m.TermQuery("tags", "t001")],
                       should=[m.TermQuery("big", 7 * 2**33)]),
    ]


def _exists(m):
    """Exists on every field kind: narrow, keyword and wide multi-valued,
    text, single keyword, single numeric."""
    return [m.ExistsQuery(f) for f in ("vals", "tags", "big", "ratios",
                                       "body", "cat", "qty")]


def _tail_only(m):
    """Values and tokens that occur only past position DENSE_MULTI_K."""
    return [m.TermQuery("vals", 517), m.RangeQuery("vals", lower=500),
            m.TermSetQuery("vals", [501, 502, 503]),
            m.PhraseQuery("body", "w12 w13"), m.PhraseQuery("body", "w13"),
            m.BooleanQuery(must=[m.ExistsQuery("vals"),
                                 m.RangeQuery("vals", lower=540)])]


def _phrases(m):
    return [m.PhraseQuery("body", t) for t in
            ("w1 w2", "w2 w1 w0", "w3", "w5 w5", "w0 w1 w2 w3", "",
             "w1 zebra", "w11 w0")]


def _check_queries(dbs, build):
    jd, pd, pidx = dbs
    s = pidx.searcher(device="cpu")
    oracle = pidx.oracle_searcher()
    aggs = {"n": tt.count_agg(), "s": tt.sum_agg("qty")}
    modes = []
    for jq, pq in zip(build(tat), build(tt)):
        mp = assert_mask_matches_jax(jd, pd, jq, pq)
        assert s.agg_search(pq, aggs) == oracle.agg_search(pq, aggs), pq
        modes.append(mp)
    return modes


@pytest.mark.parametrize("which", ["tailed", "dense"])
def test_multi_leaves_match_jax_and_oracle(request, which):
    mps = _check_queries(request.getfixturevalue(which), _leaves)
    opcodes = {int(o) for mp in mps for o in mp.ops[:, 0]}
    assert pqc.OP_GT_IMM in opcodes
    assert (pqc.OP_ROWS_TO_DOCS in opcodes) == (which == "tailed")


@pytest.mark.parametrize("which", ["tailed", "dense"])
def test_exists_on_every_field_kind(request, which):
    mps = _check_queries(request.getfixturevalue(which), _exists)
    # narrow / keyword: mp0 > -1; wide: mpn > 0; text: mp0; single
    # keyword: w > -1; single numeric: TRUE
    assert [mp.ops[0, 0] for mp in mps] == [pqc.OP_GT_IMM] * 6 + \
        [pqc.OP_TRUE]
    assert all(mp.dense for mp in mps)


def test_tail_values_only_in_tails(tailed):
    jd, pd, pidx = tailed
    assert pd.column("vals").has_tail and pd.column("body").has_tail
    mps = _check_queries(tailed, _tail_only)
    assert not any(mp.dense for mp in mps)
    o = pidx.oracle_searcher()
    assert o.agg_search(tt.TermQuery("vals", 517),
                        {"n": tt.count_agg()})["n"]["value"] > 0


@pytest.mark.parametrize("which", ["tailed", "dense"])
def test_phrase_dense_planes_and_csr_stream(request, which):
    mps = _check_queries(request.getfixturevalue(which), _phrases)
    # the tailed body runs the CSR stream (doc space), the dense one an
    # OR over start positions of EQ32 compares
    csr = {mp.dense for mp in mps[:5]}
    assert csr == ({False} if which == "tailed" else {True})


def test_wide_tail_value_only_in_tail(tmp_path):
    """The JAX tests' three-doc cases: a value present only past position
    DENSE_MULTI_K of its doc matches, narrow and wide."""
    schema = (tat.SchemaBuilder().add_u64_field("q")
              .add_u64_field("vals", cardinality=JCard.MULTI)
              .add_u64_field("big", cardinality=JCard.MULTI).build())
    ram = tat.Index.create_in_ram(schema)
    w = ram.writer()
    w.add_document({"q": 1, "vals": list(range(DENSE_MULTI_K)) + [999],
                    "big": [i * 2**33 for i in range(DENSE_MULTI_K)]
                    + [5 * 2**40]})
    w.add_document({"q": 2, "vals": [999], "big": [5 * 2**40]})
    w.add_document({"q": 3, "vals": [1, 2], "big": [2**33, 2**34]})
    w.commit()
    env = engines(persist(ram, str(tmp_path / "idx")))
    aggs = {"n": tat.count_agg(), "s": tat.sum_agg("q")}
    for q in (tat.TermQuery("vals", 999), tat.TermQuery("big", 5 * 2**40),
              tat.RangeQuery("big", lower=2**39)):
        r, where = four_way(env, q, aggs)
        assert where == "device"
        assert r["n"]["value"] == 2 and r["s"]["value"] == 3


def test_phrase_does_not_cross_doc_boundary(tmp_path):
    """Stream-adjacent rows of two docs never make a phrase; values of one
    doc concatenate into one stream (the JAX tests' spec cases)."""
    schema = (tat.SchemaBuilder().add_text_field("body")
              .add_u64_field("qty").build())
    ram = tat.Index.create_in_ram(schema)
    w = ram.writer()
    for d in ({"body": "one two alpha", "qty": 1},
              {"body": "beta three", "qty": 2},
              {"body": "alpha beta", "qty": 4},
              {"body": ["red green", "blue"], "qty": 8},
              {"body": ["red", "green blue"], "qty": 16},
              {"body": " ".join(["w1 w2"] * 6) + " alpha", "qty": 32},
              {"body": "beta " + " ".join(["w2"] * 9), "qty": 64}):
        w.add_document(d)
    w.commit()
    env = engines(persist(ram, str(tmp_path / "idx")))
    aggs = {"n": tat.count_agg(), "s": tat.sum_agg("qty")}
    r, _ = four_way(env, tat.PhraseQuery("body", "alpha beta"), aggs)
    assert r["n"]["value"] == 1 and r["s"]["value"] == 4
    r, _ = four_way(env, tat.PhraseQuery("body", "green blue"), aggs)
    assert r["n"]["value"] == 2
    four_way(env, tat.PhraseQuery("body", "w2 w1 w2"), aggs)


@pytest.mark.parametrize("which", ["tailed", "dense"])
@pytest.mark.parametrize("field", ["vals", "tags", "big", "ratios", "body"])
def test_loader_value_rows_planes_and_tails_match_jax(request, which,
                                                      field):
    """The port loader's multi-valued column == the JAX loader's: the
    padded value rows (w or hi / lo, doc, valid, mono), the per-position
    planes (mp{k}, or mph{k} / mpl{k} and mpn) and the overflow tail (tw
    or th / tl, tdoc, tvalid)."""
    jd, pd, _ = request.getfixturevalue(which)
    jc, pc = jd.column(field), pd.column(field)
    assert (pc.narrow, pc.has_value_rows, pc.has_tail,
            pc.has_multi_planes, pc.has_multi_planes_wide) == \
        (jc.narrow, jc.has_value_rows, jc.has_tail, jc.has_multi_planes,
         jc.has_multi_planes_wide)
    assert pc.has_tail == (which == "tailed")
    for name in ("_w_host", "_hi_host", "_lo_host", "_host_doc",
                 "_valid8_host", "_host_mono", "_host_valid", "_mpn_host",
                 "_tail_w_host", "_tail_hi_host", "_tail_lo_host",
                 "_tail_doc_host", "_tail_valid8_host"):
        a, b = getattr(pc, name), getattr(jc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(pc.multi_planes_host or (), jc.multi_planes_host or ()):
        np.testing.assert_array_equal(a, b)
    for (ah, al), (bh, bl) in zip(pc.multi_planes_wide_host or (),
                                  jc.multi_planes_wide_host or ()):
        np.testing.assert_array_equal(ah, bh)
        np.testing.assert_array_equal(al, bl)
    np.testing.assert_array_equal(pc.global_doc_of_rows(pd.T),
                                  jc.global_doc_of_rows(jd.T))
    lp, lj = pc.value_layout(), jc.value_layout()
    np.testing.assert_array_equal(lp.perm, lj.perm)
    np.testing.assert_array_equal(lp.sorted_mono, lj.sorted_mono)
