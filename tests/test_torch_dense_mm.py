"""The port's matrix products against their plain versions and the JAX
package's functions, on seeded numpy inputs:

- the dense products (ops/reductions.py dense_bucket_counts_mm,
  dense_bucket_sum_mm, masked_sum_planes_mm) == the `index_add_` /
  row-reduction versions == the JAX `*_mxu` functions;
- the cube products (ops/cube.py cube_dots, block_counts,
  slot_block_counts) and the block histograms they read == a numpy int64
  reference == the JAX ops/cube.py functions;
- recombine / split_rm at the int64 edges, and every exactness bound the
  port asserts, tripped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_aggregations_tpu.ops import cube as jcube
from tantivy_aggregations_tpu.ops import reductions as jred

from tantivy_aggregations_tpu_torch.ops import cube as C
from tantivy_aggregations_tpu_torch.ops import reductions as R

torch.set_num_threads(2)

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
I64_MIN, I64_MAX = -(2**63), 2**63 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planes(rng, rows):
    """int32 payload planes: full range, all INT32_MIN, all INT32_MAX,
    alternating extremes, small non-negative."""
    alt = np.where(np.arange(rows) % 2 == 0, I32_MIN, I32_MAX)
    return [rng.integers(I32_MIN, I32_MAX, rows, endpoint=True),
            np.full(rows, I32_MIN), np.full(rows, I32_MAX), alt,
            rng.integers(0, 9999, rows, endpoint=True)]


#: the queries of a batch also held against the JAX function (one JAX call
#: per query: the first and the last)
JAX_ROWS = (0, -1)


def _jax_rows(fn, valid):
    """A JAX per-query reduction over the JAX_ROWS rows of `valid`
    [B, rows], int64 under x64 -> numpy [len(JAX_ROWS), ...]."""
    with jax.enable_x64(True):
        return np.stack([np.asarray(fn(jnp.asarray(valid[b])))
                         for b in JAX_ROWS])


# ---------------------------------------------------------------------------
# dense products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,nb", [(1, 5), (17, 30), (31, 13)])
def test_dense_bucket_counts_mm(B, nb):
    rng = np.random.default_rng(B * 100 + nb)
    rows = 32768
    bid = rng.integers(-1, nb + 2, rows).astype(np.int32)  # out of range too
    valid = rng.random((B, rows)) < 0.6
    got = R.dense_bucket_counts_mm(_t(bid), _t(valid), nb)
    assert got.dtype == torch.int64 and got.shape == (B, nb)
    assert torch.equal(got, R.dense_bucket_counts(_t(bid), _t(valid), nb))
    want = _jax_rows(lambda v: jred.dense_bucket_counts_mxu(
        jnp.asarray(bid), v, nb), valid)
    np.testing.assert_array_equal(got.numpy()[list(JAX_ROWS)], want)


@pytest.mark.parametrize("B,nb", [(1, 7), (17, 3), (31, 30)])
def test_dense_bucket_sum_mm(B, nb):
    rng = np.random.default_rng(B + nb)
    rows = 32768
    bid = rng.integers(-1, nb + 1, rows).astype(np.int32)
    valid = rng.random((B, rows)) < 0.5
    for i, plane in enumerate(_planes(rng, rows)):
        plane = plane.astype(np.int32)
        bound = None if i < 4 else (0, 9999)
        got = R.dense_bucket_sum_mm(_t(bid), _t(valid), _t(plane), nb,
                                    bound=bound)
        assert torch.equal(got, R.dense_bucket_sum(_t(bid), _t(valid),
                                                   _t(plane), nb)), i
        if i in (0, 3, 4):  # full range, alternating extremes, bounded
            want = _jax_rows(lambda v: jred.dense_bucket_sum_mxu(
                jnp.asarray(bid), v, jnp.asarray(plane), nb, bound=bound),
                valid)
            np.testing.assert_array_equal(got.numpy()[list(JAX_ROWS)], want)


@pytest.mark.parametrize("B", [1, 17, 31])
def test_masked_sum_planes_mm(B):
    rng = np.random.default_rng(7 + B)
    rows = 32768
    planes = [p.astype(np.int32) for p in _planes(rng, rows)]
    planes.append(np.zeros(rows, np.int32))
    bounds = [None] * 4 + [(0, 9999), (0, 0)]
    mask = rng.random((B, rows)) < 0.7
    tp = [_t(p) for p in planes]
    got = R.masked_sum_planes_mm(_t(mask), tp, bounds)
    assert torch.equal(got, R.masked_sum_planes(_t(mask), tp))
    want = _jax_rows(lambda v: jred.masked_sum_planes_mxu(
        v, [jnp.asarray(p) for p in planes], bounds=bounds), mask)
    np.testing.assert_array_equal(got.numpy()[list(JAX_ROWS)], want)


@pytest.mark.parametrize("rows", [1000, 32768 + 4000, 3 * 32768])
def test_dense_products_row_tails_shared_masks_and_resident_ops(rows):
    """Rows that are not a multiple of the product chunk; a batch-stride-0
    mask (one product row, broadcast); the plan-time resident operand and
    the per-chunk build agree; every call counts once."""
    rng = np.random.default_rng(rows)
    nb, B = 11, 5
    bid = _t(rng.integers(-1, nb, rows).astype(np.int32))
    plane = _t(rng.integers(I32_MIN, I32_MAX, rows).astype(np.int32))
    row = _t(rng.random(rows) < 0.5)
    shared = row[None].expand(B, rows)
    R.reset_mm_calls()
    for mask in (shared, _t(rng.random((B, rows)) < 0.5)):
        want_c = R.dense_bucket_counts(bid, mask, nb)
        want_s = R.dense_bucket_sum(bid, mask, plane, nb)
        assert torch.equal(R.dense_bucket_counts_mm(bid, mask, nb), want_c)
        assert torch.equal(R.dense_bucket_counts_mm(
            bid, mask, nb, op=R.dense_counts_operand(bid, nb)), want_c)
        assert torch.equal(R.dense_bucket_sum_mm(bid, mask, plane, nb),
                           want_s)
        assert torch.equal(R.dense_bucket_sum_mm(
            bid, mask, plane, nb,
            op=R.dense_sum_operand(bid, plane, nb)), want_s)
        ps = [plane, bid]
        assert torch.equal(R.masked_sum_planes_mm(
            mask, ps, op=R.sum_planes_operand(ps)),
            R.masked_sum_planes(mask, ps))
    assert R.mm_calls == {"dense_bucket_counts_mm": 4,
                          "dense_bucket_sum_mm": 4,
                          "masked_sum_planes_mm": 2}


def test_dense_product_partial_bound_is_asserted(monkeypatch):
    """A product partial of more rows than MM_CHUNK_MAX could leave the
    exact range of its fp32 partials: the product refuses it."""
    monkeypatch.setattr(R, "MM_CHUNK", R.MM_CHUNK_MAX * 2)
    bid = torch.zeros(R.MM_CHUNK, dtype=torch.int32)
    with pytest.raises(AssertionError, match="exact"):
        R.dense_bucket_counts_mm(bid, torch.ones(1, R.MM_CHUNK,
                                                 dtype=torch.bool), 3)


def test_npieces_for_bound_matches_jax():
    for b in (None, (0, 0), (0, 127), (-128, 127), (-129, 0), (0, 9999),
              (0, 2**26 - 1), (-(2**26), 2**26), (I32_MIN, I32_MAX)):
        assert R.npieces_for_bound(b) == jred.npieces_for_bound(b), b


# ---------------------------------------------------------------------------
# cube products and host builders
# ---------------------------------------------------------------------------

def _groups(rng, D):
    return [("cnt", rng.integers(0, 5000, D)),
            ("sum", rng.integers(-2**40, 2**40, (3, D))),
            ("edge", np.array([I64_MIN, I64_MAX] * (D // 2)
                              + [0] * (D % 2), np.int64))]


@pytest.mark.parametrize("B,D", [(1, 1003), (17, 64), (31, 2049)])
def test_cube_dots_and_recombine(B, D):
    """cube_dots pads the batch (>= 32 rows) and Dprod / K (multiples of 8)
    itself; recombine restores every group exactly, the 10-piece int64
    edges included; == numpy int64 == the JAX functions."""
    rng = np.random.default_rng(B * D)
    groups = _groups(rng, D)
    pieces, layout = C.pack_groups(groups)
    jp, jl = jcube.pack_groups(groups)
    np.testing.assert_array_equal(pieces, jp)
    assert layout == jl and layout[-1] == ("edge", 1, 9)
    ind = rng.random((B, D)) < 0.5
    op = C.device_operand(pieces, "cpu")
    assert op.shape[0] % 8 == 0 and op.shape[1] % 8 == 0
    C.reset_calls()
    dots = C.cube_dots(_t(ind), op)
    assert C.calls["cube_dots"] == 1
    want = ind.astype(np.int64) @ pieces.astype(np.int64)
    np.testing.assert_array_equal(dots[:, :pieces.shape[1]].numpy(), want)
    rec = C.recombine(dots, layout)
    for name, arr in groups:
        a = np.asarray(arr, np.int64).reshape(-1, D)
        exact = [[sum(int(x) for x, m in zip(r, row) if m) for r in a]
                 for row in ind]
        got = rec[name].reshape(B, -1).numpy()
        wrapped = [[((v + 2**63) % 2**64) - 2**63 for v in row]
                   for row in exact]
        assert got.tolist() == wrapped, name
    with jax.enable_x64(True):
        for b in range(B):
            jd = jcube.cube_dots(jnp.asarray(ind[b].astype(np.int8)),
                                 jnp.asarray(pieces))
            np.testing.assert_array_equal(np.asarray(jd),
                                          dots[b, :pieces.shape[1]].numpy())
            jr = jcube.recombine(jd, jl)
            for name, _ in groups:
                np.testing.assert_array_equal(
                    np.asarray(jr[name]).reshape(-1),
                    rec[name][b].reshape(-1).numpy())


def test_recombine_many_pieces_against_python_ints():
    """A 9-piece group (the most an int64 takes) recombines with shifts to the Python
    integer value at I64_MIN / I64_MAX and around them."""
    vals = np.array([I64_MIN, I64_MAX, -1, 0, 1, I64_MIN + 1, I64_MAX - 1,
                     -(2**62), 2**62 + 12345], np.int64)
    n = C.npieces_i64(int(vals.min()), int(vals.max()))
    assert n == 9
    p = C.pieces_host(vals, n).astype(np.int32)
    layout = [("v", len(vals), n)]
    rec = C.recombine(_t(p.reshape(1, -1)), layout)["v"][0]
    assert rec.tolist() == vals.tolist()
    for v, row in zip(vals.tolist(), p.tolist()):
        assert sum(int(x) << (7 * i) for i, x in enumerate(row)) == v


def test_split_rm_sentinels_round_trip():
    rm = np.array([I64_MAX, I64_MIN, 0, -1, 2**40, -(2**40) + 3], np.int64)
    hi, lo = C.split_rm(rm)
    jh, jl = jcube.split_rm(rm)
    np.testing.assert_array_equal(hi, jh)
    np.testing.assert_array_equal(lo, jl)
    assert R.wide_recon(_t(hi), _t(lo)).tolist() == rm.tolist()


def test_minmax_builders_match_jax():
    rng = np.random.default_rng(4)
    D, n = 50, 3000
    cell = rng.integers(-1, D, n)
    w = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    rm = rng.integers(I64_MIN, I64_MAX, n)
    valid = rng.random(n) < 0.8
    for f in ("build_min32", "build_max32"):
        np.testing.assert_array_equal(getattr(C, f)(cell, w, D, valid),
                                      getattr(jcube, f)(cell, w, D, valid))
    for f in ("build_min64", "build_max64"):
        np.testing.assert_array_equal(getattr(C, f)(cell, rm, D),
                                      getattr(jcube, f)(cell, rm, D))
    cell2 = C.bucket_cell(cell, rng.integers(-1, 4, n), 4)
    np.testing.assert_array_equal(C.build_bucket_counts(cell2, D, 4),
                                  jcube.build_bucket_counts(cell2, D, 4))


def test_build_sum_exact_up_to_its_row_bound(monkeypatch):
    """build_sum is exact at INT32 extremes up to MAX_BUILD_ROWS rows per
    build, and refuses one row more."""
    monkeypatch.setattr(C, "MAX_BUILD_ROWS", 4096)
    rng = np.random.default_rng(9)
    cell = rng.integers(-1, 3, 4096)
    plane = np.where(rng.random(4096) < 0.5, I32_MIN, I32_MAX).astype(
        np.int32)
    got = C.build_sum(cell, plane, 3)
    want = [int(plane[cell == c].astype(np.int64).sum()) for c in range(3)]
    assert got.tolist() == want
    with pytest.raises(AssertionError, match="MAX_BUILD_ROWS"):
        C.build_sum(np.zeros(4097, np.int64), np.zeros(4097, np.int32), 1)


def test_cube_dom_cap_is_asserted(monkeypatch):
    monkeypatch.setattr(C, "CUBE_DOM_CAP", 64)
    op = C.device_operand(np.ones((65, 3), np.int8), "cpu")
    with pytest.raises(AssertionError, match="CUBE_DOM_CAP"):
        C.cube_dots(torch.ones(2, 65, dtype=torch.bool), op)


def _decode(hist, rows, D):
    """Port two-digit histogram [pad8(2 rows), pad8(D)] -> JAX's layout
    [D, 2 rows]."""
    return hist[:2 * rows, :D].numpy().T


@pytest.mark.parametrize("B", [1, 17, 31])
def test_block_counts_and_blockhist(B):
    rng = np.random.default_rng(B)
    R_, D, G = 8192, 37, 128
    NB = R_ // G
    cell = rng.integers(-1, D, R_).astype(np.int32)
    cell[: 3 * G] = 5  # whole blocks in one cell: counts == G (two digits)
    hist = C.build_blockhist(_t(cell), D, G)
    with jax.enable_x64(False):
        jh = np.asarray(jcube.build_blockhist(jnp.asarray(cell), D, G))
    np.testing.assert_array_equal(_decode(hist, NB, D), jh)
    ind = rng.random((B, D)) < 0.5
    ind[0, 5] = True
    C.reset_calls()
    got = C.block_counts(_t(ind), hist, NB)
    assert C.calls["block_counts"] == 1
    blk = np.arange(R_) // G
    want = np.stack([np.bincount(blk[(cell >= 0) & ind[b][np.maximum(cell,
                                                                       0)]],
                                 minlength=NB) for b in range(B)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == G
    for b in range(B):
        jb = jcube.block_counts(jnp.asarray(ind[b].astype(np.int8)),
                                jnp.asarray(jh))
        np.testing.assert_array_equal(np.asarray(jb), got[b].numpy())


@pytest.mark.parametrize("B,ns", [(1, 1), (17, 4), (31, 33)])
def test_slot_block_counts_and_slot_blockhist(B, ns):
    rng = np.random.default_rng(B * ns)
    R_, D, G = 4096, 19, 256
    NB = R_ // G
    cell = rng.integers(-1, D, R_).astype(np.int32)
    slot = rng.integers(-1, ns, R_).astype(np.int32)
    hist = C.build_slot_blockhist(_t(cell), _t(slot), ns, D, G)
    with jax.enable_x64(False):
        jh = np.asarray(jcube.build_slot_blockhist(
            jnp.asarray(cell), jnp.asarray(slot), ns, D, G))
    np.testing.assert_array_equal(_decode(hist, NB * ns, D), jh)
    ind = rng.random((B, D)) < 0.5
    C.reset_calls()
    got = C.slot_block_counts(_t(ind), hist, ns, NB)
    assert C.calls["slot_block_counts"] == 1 and got.shape == (B, ns, NB)
    blk = np.arange(R_) // G
    for b in range(B):
        ok = (cell >= 0) & (slot >= 0) & ind[b][np.maximum(cell, 0)]
        want = np.zeros((ns, NB), np.int64)
        np.add.at(want, (slot[ok], blk[ok]), 1)
        np.testing.assert_array_equal(got[b].numpy(), want)
        js = jcube.slot_block_counts(jnp.asarray(ind[b].astype(np.int8)),
                                     jnp.asarray(jh), ns)
        np.testing.assert_array_equal(np.asarray(js), want)


def test_dom_planes_and_host_cell_match_jax():
    facs = (("a", 5, 1), ("b", 7, 0), ("c", 3, 1))
    planes, D = C.dom_planes(facs, "cpu")
    with jax.enable_x64(False):
        jp, jD = jcube.dom_planes(facs)
    assert D == jD == 105
    for k in planes:
        np.testing.assert_array_equal(planes[k].numpy(), np.asarray(jp[k]))
    rng = np.random.default_rng(2)
    ws = [rng.integers(-1, 4, 100), rng.integers(0, 7, 100),
          rng.integers(-1, 2, 100)]
    alive = rng.random(100) < 0.9
    np.testing.assert_array_equal(C.host_cell(facs, ws, alive),
                                  jcube.host_cell(facs, ws, alive))
    assert C.strides_of(facs) == jcube.strides_of(facs)
    for n in (100, 2**20, 10_027_008):
        for D2 in (5, 10_000, 100_001):
            assert C.choose_block(n, D2) == jcube.choose_block(n, D2)
            assert C.choose_block_ns(n, D2, 4) == \
                jcube.choose_block_ns(n, D2, 4)
