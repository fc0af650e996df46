"""The port's kernels (tantivy_aggregations_tpu_torch/ops/kernels.py) held
against their Pallas originals (tantivy_aggregations_tpu/ops/pallas_kernels
.py) run in interpret mode on the same inputs, and the port's mask programs
held against the JAX package's eval_mask.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA
kernels are compared with those plain versions on the card by
chip_smoke.py). Every comparison is exact; numpy makes every input from a
seed, and both engines read one on-disk index."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.index.loader import \
    load_device_index as jax_load
from tantivy_aggregations_tpu.ops import pallas_kernels as PK
from tantivy_aggregations_tpu.query import compile as jqc

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.index.loader import PAD_BLOCK
from tantivy_aggregations_tpu_torch.index.loader import \
    load_device_index as port_load
from tantivy_aggregations_tpu_torch.ops import kernels as K
from tantivy_aggregations_tpu_torch.query import compile as pqc

from fixtures import random_index

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dual(tmp_path_factory):
    """(JAX device index, port device index) over ONE on-disk index written
    by the JAX writer (a persisted fixtures.random_index)."""
    ram = random_index(seed=5, n_docs=12_000)
    path = str(tmp_path_factory.mktemp("kidx") / "idx")
    disk = tat.Index.create(path, ram.schema)
    for seg in ram.segments:
        disk._add_segment(seg)
    disk._commit_meta()
    return (jax_load(tat.Index.open(path)),
            port_load(tt.Index.open(path), "cpu"))


def _params_value(jd, field, row=7):
    """A stored user value of a single-valued numeric field (for term
    queries that match)."""
    col = jd.column(field)
    return col._host_values[row]


# ---------------------------------------------------------------------------
# mask programs vs the JAX package's eval_mask
# ---------------------------------------------------------------------------

def _queries(m, jd):
    """The query set, built with module `m`'s IR classes (tat or tt)."""
    price = float(_params_value(jd, "price"))
    qty = int(_params_value(jd, "qty"))
    return [
        m.MatchAllQuery(),
        m.TermQuery("cat", "cat0003"),             # stringy
        m.TermQuery("cat", "no-such-term"),        # missing ordinal
        m.TermQuery("qty", qty),                   # narrow
        m.TermQuery("price", price),               # wide (f64)
        m.TermQuery("price", 0.0),                 # +-0 mono pair
        m.RangeQuery("qty", lower=10, upper=800),  # narrow
        m.RangeQuery("qty", lower=900, upper=100),  # empty
        m.RangeQuery("price", lower=-50.5, upper=20.25,
                     include_upper=True),           # wide
        m.RangeQuery("price", lower=0.0),         # wide, open upper
        m.RangeQuery("cat", lower="cat0010", upper="cat0020"),
        m.PrefixQuery("cat", "cat001"),
        m.BooleanQuery(must=[m.RangeQuery("qty", lower=100)],
                       must_not=[m.TermQuery("cat", "cat0001")]),
        m.BooleanQuery(should=[m.TermQuery("cat", "cat0002"),
                               m.RangeQuery("price", upper=-100.0)]),
        m.BooleanQuery(must=[m.TermQuery("cat", "cat0004")],
                       should=[m.TermQuery("qty", qty)]),
        m.BooleanQuery(must=[m.BooleanQuery(
            should=[m.RangeQuery("delta", lower=0),
                    m.TermQuery("price", price)])],
            must_not=[m.RangeQuery("ts", upper=5_000_000)]),
        # set-type queries: OP_SET32 (stringy, narrow) and OP_SET_WIDE
        m.TermSetQuery("cat", ["cat0003", "cat0004", "cat0010",
                               "no-such-term"]),
        m.TermSetQuery("qty", [qty, qty + 1, 5, 999, 10**12]),
        m.TermSetQuery("delta", [-500, -499, 0, 17]),
        m.TermSetQuery("price", [price, 0.0, -1.5, 1e300]),  # +-0 pair
        m.TermSetQuery("price", []),
        m.FuzzyTermQuery("cat", "cat0010"),
        m.RegexQuery("cat", "cat00[0-3][13579]"),
        m.BooleanQuery(must=[m.TermSetQuery("cat", ["cat0001", "cat0002"])],
                       must_not=[m.RegexQuery("cat", "cat000[2-9]")],
                       should=[m.TermSetQuery("qty", [qty])]),
    ]


def _jax_arrays(jd, q):
    out = {}
    for f in jqc.query_fields(q):
        col = jd.column(f)
        if col.narrow or col.ftype.is_stringy:
            out[f"{f}:w"] = col.w
        else:
            out[f"{f}:hi"], out[f"{f}:lo"] = col.hi, col.lo
    return out


def test_mask_program_matches_jax_eval_mask(dual):
    jd, pd = dual
    for q, pq in zip(_queries(tat, jd), _queries(tt, jd)):
        jparams = jqc.extract_params(q, jd)
        pparams = pqc.extract_params(pq, pd)
        assert jparams == pparams, q
        jm = np.asarray(jqc.eval_mask(
            q, jd, {k: jnp.int32(v) for k, v in jparams.items()}, ("q",),
            jd.T, _jax_arrays(jd, q)))
        mp = pqc.mask_program(((pq, ("q",)),), pd)
        assert mp.param_keys == tuple(jparams), q
        arrays = {k: getattr(pd.column(k.rsplit(":", 1)[0]),
                             k.rsplit(":", 1)[1]) for k in mp.plane_keys}
        arrays["alive"] = pd.alive
        pm = pqc.eval_mask(pq, pd, pparams, ("q",), arrays)[0].numpy()
        np.testing.assert_array_equal(pm, jm, err_msg=repr(q))


def _multi_jax_arrays(jd, q):
    """_jax_arrays plus, for a multi-valued field, its value rows (doc,
    valid) and per-position planes, as JAX Program._need_col_planes
    registers them."""
    out = {}
    for f in jqc.query_fields(q):
        col = jd.column(f)
        if col.narrow or col.ftype.is_stringy:
            out[f"{f}:w"] = col.w
        else:
            out[f"{f}:hi"], out[f"{f}:lo"] = col.hi, col.lo
        if col.multi:
            out[f"{f}:doc"], out[f"{f}:valid"] = col.doc_id, col.valid
            for k, pk in enumerate(col.multi_planes or ()):
                out[f"{f}:mp{k}"] = pk
            for k, (h, lo) in enumerate(col.multi_planes_wide or ()):
                out[f"{f}:mph{k}"], out[f"{f}:mpl{k}"] = h, lo
            if col.has_multi_planes_wide:
                out[f"{f}:mpn"] = col.mpn
            if col.has_tail:
                out[f"{f}:tdoc"] = col.tail_doc
                if col.has_multi_planes_wide:
                    out[f"{f}:th"], out[f"{f}:tl"] = col.tail_hi, col.tail_lo
                    out[f"{f}:tvalid"] = col.tail_valid
                else:
                    out[f"{f}:tw"] = col.tail_w
    return out


def assert_mask_matches_jax(jd, pd, q, pq):
    """The port's mask program over the port's planes == the JAX package's
    eval_mask over the JAX loader's, with equal extracted params."""
    jparams = jqc.extract_params(q, jd)
    pparams = pqc.extract_params(pq, pd)
    assert jparams == pparams, q
    jm = np.asarray(jqc.eval_mask(
        q, jd, {k: jnp.int32(v) for k, v in jparams.items()}, ("q",),
        jd.T, _multi_jax_arrays(jd, q)))
    mp = pqc.mask_program(((pq, ("q",)),), pd)
    assert mp.param_keys == tuple(jparams), q
    arrays = {k: pd.column(k.rsplit(":", 1)[0]).plane(k.rsplit(":", 1)[1])
              for k in mp.plane_keys}
    arrays["alive"] = pd.alive
    pm = pqc.eval_mask(pq, pd, pparams, ("q",), arrays)[0].numpy()
    np.testing.assert_array_equal(pm, jm, err_msg=repr(q))
    return mp


@pytest.mark.parametrize("q", [
    tt.ExistsQuery("cat"),
    tt.TermQuery("tags", "t1"),           # multi-valued field
    tt.TermSetQuery("tags", ["t1", "t3"]),  # a set over a multi-valued one
])
def test_mask_program_refuses_unported_shapes(dual, q):
    """The shapes mask_program once refused (Exists, leaves over a
    multi-valued field) now compile — an OP_GT_IMM guard, an OR over the
    per-position planes — and match the JAX package's eval_mask."""
    jd, pd = dual
    jq = {tt.ExistsQuery: tat.ExistsQuery, tt.TermQuery: tat.TermQuery,
          tt.TermSetQuery: tat.TermSetQuery}[type(q)](
        **{f: getattr(q, f) for f in q.__dataclass_fields__})
    mp = assert_mask_matches_jax(jd, pd, jq, q)
    assert mp.dense


# ---------------------------------------------------------------------------
# fused_metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("span", ["large", "signed"])
def test_fused_metrics_plain_matches_pallas(span):
    rng = np.random.default_rng(11)
    n = 32768
    if span == "large":
        vals = rng.integers(0, 2**30, n).astype(np.int32)
        max_abs = 2**30 - 1
    else:
        vals = rng.integers(-(2**25), 2**25, n).astype(np.int32)
        max_abs = (1 << 26) - 1
    masks = np.stack([rng.random(n) < 0.7, rng.random(n) < 0.01,
                      np.zeros(n, bool), np.ones(n, bool)])
    cnt, tot, mn, mx = K.fused_metrics(torch.from_numpy(masks),
                                       torch.from_numpy(vals))
    for b in range(masks.shape[0]):
        ref = PK.fused_metrics(jnp.asarray(masks[b]), jnp.asarray(vals),
                               interpret=True, max_abs=max_abs)
        assert (int(cnt[b]), int(tot[b]), int(mn[b]), int(mx[b])) == \
            tuple(int(x) for x in ref), b


#: rows of the fused_metrics edge cases (Pallas tiles any int32 plane at
#: 32-row blocks of 128 lanes: a multiple of 4096)
FUSED_N = 8192


def _pallas_fused(row, vals):
    """Pallas fused_metrics (interpret mode) of one mask row over any int32
    plane. The port selects nonzero mask bytes; Pallas selects positive
    ones, so it is handed the row as bool."""
    ref = PK.fused_metrics(jnp.asarray(np.asarray(row) != 0),
                           jnp.asarray(vals), interpret=True,
                           max_abs=2**31)
    return tuple(int(x) for x in ref)


def _fused_edge(case, rng):
    """(masks [B, n], plane [n]) of a fused_metrics edge case."""
    vals = rng.integers(-2**31, 2**31, FUSED_N).astype(np.int32)
    if case == "int8":  # -1, 2, 127 and -128 select like 1
        masks = rng.choice(np.array([0, 0, 1, -1, 2, 127, -128], np.int8),
                           (5, FUSED_N))
    elif case == "all-zero":  # the I32_MAX / I32_MIN sentinels
        masks = np.zeros((3, FUSED_N), np.int8)
    else:  # a plane at one int32 extreme, every row selected
        vals = np.full(FUSED_N, -2**31 if case == "int32-min" else 2**31 - 1,
                       np.int32)
        masks = np.ones((2, FUSED_N), bool)
    return masks, vals


@pytest.mark.parametrize("minmax", [True, False])
@pytest.mark.parametrize("case", ["int8", "all-zero", "int32-min",
                                  "int32-max"])
def test_fused_metrics_edges_match_pallas(case, minmax):
    masks, vals = _fused_edge(case, np.random.default_rng(12))
    got = K.fused_metrics(torch.from_numpy(masks), torch.from_numpy(vals),
                          minmax=minmax)
    assert (got[2] is None and got[3] is None) == (not minmax)
    for b in range(masks.shape[0]):
        ref = _pallas_fused(masks[b], vals)
        mine = tuple(int(x[b]) for x in got if x is not None)
        assert mine == (ref if minmax else ref[:2]), b
    if case == "all-zero" and minmax:
        assert got[2].tolist() == [K.I32_MAX] * 3
        assert got[3].tolist() == [K.I32_MIN] * 3


@pytest.mark.parametrize("minmax", [True, False])
@pytest.mark.parametrize("B", [1, 3, 33])
def test_fused_metrics_shared_mask_matches_pallas(B, minmax):
    """A mask of batch stride 0 (one row shared by B queries, as `expand`
    makes it) gives B contiguous copies of the row's result."""
    rng = np.random.default_rng(B)
    row = rng.random(FUSED_N) < 0.4
    vals = rng.integers(-2**31, 2**31, FUSED_N).astype(np.int32)
    mask = torch.from_numpy(row)[None].expand(B, -1)
    got = K.fused_metrics(mask, torch.from_numpy(vals), minmax=minmax)
    ref = _pallas_fused(row, vals)
    outs = [x for x in got if x is not None]
    assert len(outs) == (4 if minmax else 2)
    for x, want in zip(outs, ref):
        assert x.shape == (B,) and x.is_contiguous()
        assert x.tolist() == [want] * B


def test_fused_metrics_runs_a_shared_mask_once(monkeypatch):
    """The shared-row logic sits before the device routing: the plain
    version (on the card, the kernel) sees the one row, at B = 1."""
    seen = []
    plain = K.fused_metrics_plain

    def spy(mask, plane, minmax=True):
        seen.append(tuple(mask.shape))
        return plain(mask, plane, minmax)

    monkeypatch.setattr(K, "fused_metrics_plain", spy)
    mask = torch.ones(1, 128, dtype=torch.bool).expand(7, -1)
    cnt, tot, mn, mx = K.fused_metrics(mask, torch.arange(128,
                                                          dtype=torch.int32))
    assert seen == [(1, 128)]
    assert cnt.tolist() == [128] * 7 and tot.tolist() == [8128] * 7
    assert mn.tolist() == [0] * 7 and mx.tolist() == [127] * 7


def test_ts_count_chunks_and_reduces_a_shared_mask_once(monkeypatch):
    """ts_count (the root and filter `count`) casts at most _TMP_ELEMS
    mask elements to int64 at a time, and reduces a batch-stride-0 mask
    as its one row; the counts are exact int64."""
    from tantivy_aggregations_tpu_torch.ops import reductions as R
    rows = 1000
    mask = torch.from_numpy(np.random.default_rng(3).random((7, rows))
                            < 0.4)
    monkeypatch.setattr(R, "_TMP_ELEMS", 2 * rows)
    seen = []
    chunks = R._query_chunks

    def spy(B, n):
        sl = list(chunks(B, n))
        seen.append((B, n, [(s.start, s.stop) for s in sl]))
        return iter(sl)

    monkeypatch.setattr(R, "_query_chunks", spy)
    got = R.ts_count(mask)
    assert got.dtype == torch.int64
    assert got.tolist() == mask.numpy().sum(axis=1).tolist()
    assert seen == [(7, rows, [(0, 2), (2, 4), (4, 6), (6, 7)])]
    seen.clear()
    row = mask[3:4]
    got = R.ts_count(row.expand(7, rows))
    assert seen == [(1, rows, [(0, 1)])]
    assert got.is_contiguous() and got.tolist() == [int(row.sum())] * 7


# ---------------------------------------------------------------------------
# chain_blocks / chain_counts over real chains and index planes
# ---------------------------------------------------------------------------

def _chain_cases(m, jd):
    """Chain query builders j -> query over module `m`'s IR classes."""
    price = float(_params_value(jd, "price"))
    qty = int(_params_value(jd, "qty"))

    def ranged(j):
        return m.BooleanQuery(
            must=[m.RangeQuery("qty", lower=10 + 90 * j, upper=800)],
            must_not=[m.TermQuery("cat", f"cat000{j}")])

    def wide(j):
        return m.BooleanQuery(should=[
            m.RangeQuery("price", lower=-20.0 * j, upper=30.0),
            m.TermQuery("price", price)])

    def empty(j):
        return m.RangeQuery("qty", lower=900 + j, upper=100)

    # stored prices, so that the wide sets match rows
    prices = [float(_params_value(jd, "price", r)) for r in range(7, 47)]

    def every_op(j):
        # TRUE, AND, NOT, EQ32, RANGE32, RANGE_WIDE; EQ_WIDE_GUARD and
        # EQ32_GUARD each in an OR pair; SET32 and SET_WIDE
        return m.BooleanQuery(
            must=[m.TermQuery("cat", f"cat000{j}"),
                  m.RangeQuery("qty", lower=10 * j, upper=900),
                  m.RangeQuery("price", lower=-80.0 + j, upper=60.0)],
            must_not=[m.TermQuery("price", price), m.TermQuery("qty", qty),
                      m.TermSetQuery("qty", [qty + 1, qty + 2, 3 * j]),
                      m.TermSetQuery("price", [prices[j], 0.0])])

    def set32(j):  # stringy and narrow sets
        return m.BooleanQuery(should=[
            m.TermSetQuery("cat", [f"cat{(7 * j + 3 * i) % 50:04d}"
                                   for i in range(5)]),
            m.TermSetQuery("qty", [qty, 10 * j, 500 + j, 501 + j])])

    def set_wide(j):  # f64 values, the +-0 pair among them
        return m.TermSetQuery("price", prices[j:j + 5] + [0.0])

    def fuzzy(j):
        return m.FuzzyTermQuery("cat", f"cat00{10 + j}")

    def regex(j):
        return m.RegexQuery("cat", f"cat00[{j % 4}-4][13579]")

    def multi_narrow(j):  # per-position planes of counts and tags
        return m.BooleanQuery(
            must=[m.RangeQuery("counts", lower=5 + 3 * j, upper=80),
                  m.TermSetQuery("tags", [f"t{j % 10}", f"t{(j + 3) % 10}"])],
            must_not=[m.TermQuery("counts", 7 + j)])

    def multi_wide(j):  # (mph, mpl) pairs guarded by mpn
        return m.BooleanQuery(should=[
            m.RangeQuery("scores", lower=-1.0 + 0.1 * j, upper=1.0),
            m.TermQuery("scores", float(_multi_value(jd, "scores", j))),
            m.TermSetQuery("scores", [0.5, -0.25])])

    def multi_exists(j):
        return m.BooleanQuery(
            must=[m.ExistsQuery("tags"), m.RangeQuery("qty", lower=10 * j),
                  m.PrefixQuery("tags", "t")],
            must_not=[m.ExistsQuery("scores"), m.ExistsQuery("cat")])

    return [ranged, wide, empty, every_op, set32, set_wide, fuzzy, regex,
            multi_narrow, multi_wide, multi_exists]


def _multi_value(jd, field, j):
    """The j-th stored value of a multi-valued field (so that term leaves
    over it match rows)."""
    col = jd.column(field)
    return col._host_values[col._host_valid][7 * j]


#: the chain cases (_chain_cases) every chain kernel is held to here; the
#: set cases 4-7 run in test_torch_set_chains.py, a file of their own so
#: that a parallel run splits their Pallas interpret time
CHAIN_CASES = range(4)


def test_every_op_case_emits_every_opcode(dual):
    jd, pd = dual
    mp = pqc.mask_program(((_chain_cases(tt, jd)[3](0), ("q",)),), pd)
    assert set(mp.ops[:, 0].tolist()) == set(range(pqc.OP_SET_WIDE + 1))


def _chain_inputs(jd, pd, case, B):
    build = _chain_cases(tat, jd)[case]
    pbuild = _chain_cases(tt, jd)[case]
    chain_j = [((build(j), ("q",)),) for j in range(B)]
    mp = pqc.mask_program(((pbuild(0), ("q",)),), pd)
    pkeys = jqc.extract_params(build(0), jd)
    assert mp.param_keys == tuple(pkeys)
    pm = np.asarray([[jqc.extract_params(build(j), jd)[k] for k in pkeys]
                     or [0] for j in range(B)], np.int32)
    host = {}
    for key in mp.plane_keys:
        f, kind = key.rsplit(":", 1)
        host[key] = pd.column(f).host_plane(kind)
    avalid = jd.alive_host.astype(np.int8)
    return chain_j[0], mp, pkeys, pm, host, avalid


def _jax_mask_of(jd, chain, pkeys):
    def mask_of(vals, pvals):
        params = dict(zip(pkeys, pvals))
        m = vals["avalid"] > 0
        for q, qpath in chain:
            m = m & jqc.eval_mask(q, jd, params, qpath, vals["avalid"].shape,
                                  vals, "")
        return m
    return mask_of


def _pays(jd, L):
    """L int32 payload planes: the narrow delta w plane, then f64 limbs of
    price (signed 26-bit) and a large-span synthetic plane; past three, the
    signed extremes (all INT32_MIN, all INT32_MAX, the two alternating) and
    full-range int32 planes."""
    rng = np.random.default_rng(L)
    limbs = jd.column("price").sum_limbs_host()
    planes = [jd.column("delta")._w_host, limbs[:, 0],
              rng.integers(-(2**30), 2**30, jd.T).astype(np.int32)]
    if L > 3:
        alt = np.where(np.arange(jd.T) % 2 == 0, K.I32_MIN, K.I32_MAX)
        planes += [np.full(jd.T, K.I32_MIN), np.full(jd.T, K.I32_MAX), alt]
        planes += [rng.integers(K.I32_MIN, K.I32_MAX, jd.T, endpoint=True)
                   for _ in range(L - len(planes))]
    return [np.ascontiguousarray(p, np.int32) for p in planes[:L]]


def _run_jax(fn, pm, B):
    if B == 1:
        return fn(jnp.asarray(pm[0]))
    with jax.enable_x64(True):
        return jax.jit(jax.vmap(fn))(jnp.asarray(pm))


@pytest.mark.parametrize("case", CHAIN_CASES)
@pytest.mark.parametrize("B,L", [(1, 1), (4, 3), (33, 16)])
def test_chain_blocks_plain_matches_pallas(dual, case, B, L):
    jd, pd = dual
    chain, mp, pkeys, pm, host, avalid = _chain_inputs(jd, pd, case, B)
    pays = _pays(jd, L)
    counts, sums = K.chain_blocks(
        torch.from_numpy(pm), K.ops_tensor(mp.ops, "cpu"),
        [torch.from_numpy(host[k]) for k in mp.plane_keys],
        torch.from_numpy(avalid), [torch.from_numpy(p) for p in pays])
    cb = PK.make_chain_blocks(_jax_mask_of(jd, chain, pkeys),
                              interpret=True)
    planes = {k: jnp.asarray(PK.transpose_groups(v, 32))
              for k, v in host.items()}
    planes["avalid"] = jnp.asarray(PK.transpose_groups(avalid, 32))
    payd = {f"s{j}": jnp.asarray(PK.transpose_groups(p, 32))
            for j, p in enumerate(pays)}
    jc, js = _run_jax(lambda p: cb(p, planes, payd), pm, B)
    jc = np.asarray(jc).reshape(B, -1)
    np.testing.assert_array_equal(counts.numpy(), jc)
    for j in range(L):
        h, lo = js[f"s{j}"]
        tot = ((np.asarray(h).astype(np.int64) << 13)
               + np.asarray(lo).astype(np.int64)).reshape(B, -1)
        np.testing.assert_array_equal(sums[:, j].numpy(), tot)


@pytest.mark.parametrize("case", CHAIN_CASES)
@pytest.mark.parametrize("B", [1, 4, 33])
def test_chain_counts_plain_matches_pallas(dual, case, B):
    jd, pd = dual
    chain, mp, pkeys, pm, host, avalid = _chain_inputs(jd, pd, case, B)
    counts = K.chain_counts(
        torch.from_numpy(pm), K.ops_tensor(mp.ops, "cpu"),
        [torch.from_numpy(host[k]) for k in mp.plane_keys],
        torch.from_numpy(avalid))
    cc = PK.make_chain_counts(_jax_mask_of(jd, chain, pkeys),
                              interpret=True)
    planes = {k: jnp.asarray(PK.transpose_groups(v)) for k, v in host.items()}
    planes["avalid"] = jnp.asarray(PK.transpose_groups(avalid))
    jc = np.asarray(_run_jax(lambda p: cc(p, planes), pm, B)).reshape(B, -1)
    np.testing.assert_array_equal(counts.numpy(), jc)


#: param counts of the plan tests: the main path's few, a 64-slot wide
#: TermSet's 256, past that, and a chain long enough that eight warps'
#: param rows do not fit beside a wide stage
PLAN_PARAMS = (1, 256, 257, 5000)


def _warps_ok(warps, B, fits8):
    """chain_plan keeps min(B, 8) warps where their param rows fit, else
    fewer, but at least one."""
    full = min(B, K.CHAIN_WARPS)
    return warps == full if fits8 else 1 <= warps < full


@pytest.mark.parametrize("n_planes", range(9))
def test_chain_plan_fits_shared_memory(n_planes):
    """Every launch shape of the chain tile kernel that chain_fits accepts
    (here up to 8 chain planes, 16 payloads and 128 ops, params up to a
    few thousand) fits a CTA's shared memory, keeps no more warps than
    queries and only as many as fit their param rows, double-buffers the
    narrow programs (the main path's: up to 2 chain planes and payloads),
    and its tile divides every padded layout."""
    assert PAD_BLOCK % K.TILE_ROWS == 0
    for n_pay in range(17):
        stage = K._stage_bytes(n_planes + n_pay)
        for n_ops in (1, 128):
            for P in PLAN_PARAMS:
                assert K.chain_fits(n_planes, n_pay, n_ops, P)
                for B in (1, 31, 33, 128, 200):
                    warps, stages, smem = K.chain_plan(n_planes, n_pay,
                                                       n_ops, P, B)
                    assert smem <= K.SMEM_MAX
                    fits8 = (stage + n_ops * K.OP_WIDTH * 4
                             + min(B, K.CHAIN_WARPS) * P * 4 <= K.SMEM_MAX)
                    assert _warps_ok(warps, B, fits8)
                    assert stages in (1, 2)
                    if n_planes + n_pay <= 2 and P <= 256:
                        assert stages == 2
                    if stages == 2:
                        assert smem <= K.DOUBLE_BUFFER_MAX
    for R in (PAD_BLOCK, 306 * PAD_BLOCK):
        assert R % K.TILE_ROWS == 0


@pytest.mark.parametrize("n_planes", range(9))
def test_slot_plan_fits_shared_memory(n_planes):
    """Every launch shape of chain_slot_counts' tile kernel (the chain
    planes and the slot plane as sources) fits a CTA's shared memory for
    any slot count up to the cap, params up to a few thousand and any
    batch: the mask words kept past one slot chunk are capped at
    QWORD_BATCH queries; the main path's narrow programs (c9: one chain
    plane, ns = 4) double-buffer."""
    for n_ops in (1, 128):
        for ns in (1, 32, 33, K.PCT_SLOT_CAP):
            for P in PLAN_PARAMS:
                assert K.chain_fits(n_planes, 1, n_ops, P, ns)
                for B in (1, 33, 128, 200):
                    warps, stages, qb, smem = K.slot_plan(n_planes, n_ops, P,
                                                          B, ns)
                    assert smem <= K.SMEM_MAX
                    assert 1 <= warps <= min(B, K.CHAIN_WARPS)
                    if P <= 256:
                        assert warps == min(B, K.CHAIN_WARPS)
                    assert stages in (1, 2)
                    if ns <= K.SLOT_CHUNK:
                        assert qb == B
                    else:
                        assert 1 <= qb <= min(B, K.QWORD_BATCH)
                    if stages == 2:
                        assert smem <= K.DOUBLE_BUFFER_MAX
    if n_planes <= 2:
        assert K.slot_plan(n_planes, 8, 4, 128, 4)[1] == 2


@pytest.mark.parametrize("ns", [0, 4, 33, K.PCT_SLOT_CAP])
def test_chain_fits_is_the_shared_memory_edge(ns):
    """chain_fits accepts a program exactly while one stage, the op list,
    the slot words and one warp's param row fit SMEM_MAX, and never more
    sources than the kernel's source struct holds (MAX_SOURCES, sized to
    that edge); the plans of the largest accepted programs fit at every
    batch size, with fewer warps where eight param rows would not."""
    aux = 1 if ns else 0
    for n_ops in (1, 128, 1000):
        for P in PLAN_PARAMS:
            n = max(p for p in range(K.MAX_SOURCES + 2)
                    if K.chain_fits(p, aux, n_ops, P, ns))
            assert n + aux <= K.MAX_SOURCES
            assert not K.chain_fits(n + 1, aux, n_ops, P, ns)
            for B in (1, 128, 200):
                plan = (K.slot_plan(n, n_ops, P, B, ns) if ns
                        else K.chain_plan(n, 0, n_ops, P, B))
                assert plan[-1] <= K.SMEM_MAX and plan[0] >= 1
    assert K.chain_fits(K.MAX_SOURCES, 0, 1, 1)
    assert not K.chain_fits(K.MAX_SOURCES + 1, 0, 1, 1)
    # the params alone: a row of P ints beside a small program's stage
    big = (K.SMEM_MAX - K._stage_bytes(2) - 8 * K.OP_WIDTH * 4) // 4
    assert K.chain_fits(1, 1, 8, big) and not K.chain_fits(1, 1, 8, big + 1)


def test_ops_tensor_flags_set_opcodes():
    """ops_tensor records on the host whether an op list holds a set
    opcode (the kernel instance it runs), and the wrappers read an op list
    that lacks the flag from the tensor."""
    plain = np.array([[pqc.OP_TRUE] + [0] * 7], np.int32)
    sets = np.array([[pqc.OP_SET32, 0, 0, 2] + [0] * 4], np.int32)
    assert not K.ops_tensor(plain, "cpu").has_sets
    assert K.ops_tensor(sets, "cpu").has_sets
    assert K._has_sets(torch.from_numpy(sets))
    assert not K._has_sets(torch.from_numpy(plain))


@pytest.mark.parametrize(
    "B,ns,case",
    [(B, ns, case) for case in CHAIN_CASES
     for B, ns in ((1, 1), (1, 5), (4, 1), (4, 5))]
    # the kernel's 32-slot chunk edge at B = 33 (the Pallas kernel unrolls
    # B x ns in its trace, ~25 s a case): a ranged chain and every opcode
    + [(33, ns, case) for case in (0, 3) for ns in (32, 33)])
def test_chain_slot_counts_plain_matches_pallas(dual, case, B, ns):
    jd, pd = dual
    chain, mp, pkeys, pm, host, avalid = _chain_inputs(jd, pd, case, B)
    # slot -1 (no bucket) on about 1 row in (ns + 1)
    slot = np.random.default_rng(ns).integers(-1, ns, jd.T).astype(np.int32)
    counts = K.chain_slot_counts(
        torch.from_numpy(pm), K.ops_tensor(mp.ops, "cpu"),
        [torch.from_numpy(host[k]) for k in mp.plane_keys],
        torch.from_numpy(avalid), torch.from_numpy(slot), ns)
    csc = PK.make_chain_slot_counts(_jax_mask_of(jd, chain, pkeys), ns,
                                    interpret=True)
    planes = {k: jnp.asarray(PK.transpose_groups(v, 32))
              for k, v in host.items()}
    planes["avalid"] = jnp.asarray(PK.transpose_groups(avalid, 32))
    slot_t = jnp.asarray(PK.transpose_groups(slot, 32))
    jc = np.asarray(_run_jax(lambda p: csc(p, planes, slot_t), pm, B))
    np.testing.assert_array_equal(counts.numpy(), jc.reshape(B, ns, -1))


# ---------------------------------------------------------------------------
# gather_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", [[3], [3, 0, 6, 3]])
def test_gather_rows_plain_matches_pallas(idx):
    rng = np.random.default_rng(len(idx))
    op = rng.integers(-128, 128, (7, 4, 128)).astype(np.int8)
    ia = np.asarray(idx, np.int32)
    want = np.asarray(PK._gather_rows_batched(jnp.asarray(ia),
                                              jnp.asarray(op),
                                              interpret=True))
    got = K.gather_rows(torch.from_numpy(ia), torch.from_numpy(op))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same bytes through the port's 2-D int64 operand view
    op64 = torch.from_numpy(op).reshape(7, -1).view(torch.int64)
    got64 = K.gather_rows(torch.from_numpy(ia), op64)
    np.testing.assert_array_equal(
        got64.view(torch.int8).reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("idx", [[3], [3, 0, 6, 3, 6]])
def test_gather_rows_row_operand_matches_index_select(idx):
    """A RowOperand (checked once, as the planner builds it) gives
    index_select's rows, as the bare tensor does, call after call."""
    op = torch.from_numpy(np.random.default_rng(len(idx)).integers(
        -2**40, 2**40, (7, 6))).to(torch.int64)
    rows = K.RowOperand(op)
    assert not rows.cuda and rows.tail == (6,) and rows.chunks == 1
    ia = torch.tensor(idx, dtype=torch.int32)
    for _ in range(2):
        assert torch.equal(K.gather_rows(ia, rows), op.index_select(0, ia))
    assert torch.equal(K.gather_rows(ia, op), op.index_select(0, ia))
    assert torch.equal(K.gather_rows_plain(ia, rows), K.gather_rows(ia, op))


@pytest.mark.parametrize("bad", ["row bytes", "row too large", "empty rows",
                                 "1-D", "non-contiguous", "unknown device"])
def test_row_operand_refuses_bad_operands(bad):
    op = {"row bytes": lambda: torch.zeros(4, 8, dtype=torch.int8),
          "row too large": lambda: torch.empty(
              2, K.GATHER_ROW_MAX + 16, dtype=torch.int8, device="meta"),
          "empty rows": lambda: torch.zeros(4, 0, dtype=torch.int64),
          "1-D": lambda: torch.zeros(16, dtype=torch.int64),
          "non-contiguous": lambda: torch.zeros(16, 4, dtype=torch.int32).t(),
          "unknown device": lambda: torch.zeros(4, 16, dtype=torch.int8,
                                                device="meta")}[bad]()
    with pytest.raises(ValueError):
        K.RowOperand(op)


@pytest.mark.parametrize("idx_device", ["meta", "cpu-int64", "cpu-2d"])
def test_gather_rows_row_operand_refuses_bad_index(idx_device):
    """A RowOperand still refuses an index on another device, or not a
    contiguous int32 [B]."""
    rows = K.RowOperand(torch.zeros(4, 16, dtype=torch.int8))
    idx = {"meta": torch.zeros(2, dtype=torch.int32, device="meta"),
           "cpu-int64": torch.zeros(2, dtype=torch.int64),
           "cpu-2d": torch.zeros(2, 1, dtype=torch.int32)}[idx_device]
    with pytest.raises(ValueError, match="device" if idx_device == "meta"
                       else "idx"):
        K.gather_rows(idx, rows)


@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "meta")])
def test_kernel_wrappers_refuse_mixed_or_unknown_devices(devices):
    idx = torch.zeros(2, dtype=torch.int32, device=devices[0])
    op = torch.zeros(4, 16, dtype=torch.int8, device=devices[1])
    with pytest.raises(ValueError, match="device"):
        K.gather_rows(idx, op)


def test_kernel_wrappers_refuse_bad_operands():
    m = torch.zeros(1, 128, dtype=torch.bool)
    with pytest.raises(ValueError):
        K.fused_metrics(m, torch.zeros(128, dtype=torch.int64))
    ops = K.ops_tensor(np.zeros((1, pqc.OP_WIDTH), np.int32), "cpu")
    with pytest.raises(ValueError):  # rows not a multiple of 128
        K.chain_counts(torch.zeros(1, 1, dtype=torch.int32), ops, [],
                       torch.zeros(96, dtype=torch.int8))
    pm = torch.zeros(1, 1, dtype=torch.int32)
    av = torch.zeros(64, dtype=torch.int8)
    slot = torch.zeros(64, dtype=torch.int32)
    for bad in (0, K.PCT_SLOT_CAP + 1):  # slot count outside the cap
        with pytest.raises(ValueError):
            K.chain_slot_counts(pm, ops, [], av, slot, bad)
    with pytest.raises(ValueError):  # slot plane dtype
        K.chain_slot_counts(pm, ops, [], av, slot.to(torch.int64), 2)
    with pytest.raises(ValueError):  # slot plane length
        K.chain_slot_counts(pm, ops, [], av, slot[:32], 2)
    op = torch.zeros(4, 8, dtype=torch.int8)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):  # 8-byte rows: not 16-byte words
        K.gather_rows(idx, op)
    with pytest.raises(ValueError):  # index dtype
        K.gather_rows(idx.to(torch.int64), torch.zeros(4, 16,
                                                       dtype=torch.int8))
    with pytest.raises(ValueError):  # non-contiguous operand
        K.gather_rows(idx, torch.zeros(16, 4, dtype=torch.int8).t())
    bid = torch.zeros(128, dtype=torch.int32)
    for bad in ((m.to(torch.int32), bid, 3),  # mask dtype
                (m, bid.to(torch.int64), 3),  # bucket-id dtype
                (m, bid[:64], 3),  # rows
                (m, torch.zeros(128, 2, dtype=torch.int32)[:, 0], 3),
                (m, bid, 0),  # no bucket
                (m, bid, 3, bid[:64]),  # payload rows
                (m, bid, 3, bid.to(torch.int64))):  # payload dtype
        with pytest.raises(ValueError):
            K.dense_buckets(*bad)
    with pytest.raises(ValueError, match="device"):
        K.dense_buckets(m, bid.to("meta"), 3)


def test_dense_buckets_runs_a_shared_mask_once(monkeypatch):
    """As fused_metrics: the shared-row logic sits before the device
    routing, so the plain version (on the card, the kernel) sees the one
    row, and the result is that row broadcast."""
    seen = []
    plain = K.dense_buckets_plain

    def spy(mask, *a):
        seen.append(tuple(mask.shape))
        return plain(mask, *a)

    monkeypatch.setattr(K, "dense_buckets_plain", spy)
    mask = torch.ones(1, 128, dtype=torch.bool).expand(7, -1)
    bid = torch.arange(128, dtype=torch.int32) % 5 - 1
    got = K.dense_buckets(mask, bid, 3, torch.arange(128, dtype=torch.int32))
    assert seen == [(1, 128)] and got.shape == (7, 3)
    want = [sum(r for r in range(128) if r % 5 - 1 == j) for j in range(3)]
    assert got.tolist() == [want] * 7


# ---------------------------------------------------------------------------
# dense multi-valued planes (the member operands' source)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["counts", "tags", "scores"])
def test_multi_planes_match_jax_loader(dual, field):
    jd, pd = dual
    jc, pc = jd.column(field), pd.column(field)
    assert pc.has_multi_planes == jc.has_multi_planes
    assert pc.has_tail == jc.has_tail
    assert pc.has_multi_planes_wide == jc.has_multi_planes_wide
    if jc.has_multi_planes:
        assert len(pc.multi_planes_host) == len(jc.multi_planes_host)
        for a, b in zip(pc.multi_planes_host, jc.multi_planes_host):
            np.testing.assert_array_equal(a, b)
    if jc.has_multi_planes_wide:
        assert len(pc.multi_planes_wide_host) == \
            len(jc.multi_planes_wide_host)
        for (ah, al), (bh, bl) in zip(pc.multi_planes_wide_host,
                                      jc.multi_planes_wide_host):
            np.testing.assert_array_equal(ah, bh)
            np.testing.assert_array_equal(al, bl)
        np.testing.assert_array_equal(pc._mpn_host, jc._mpn_host)
