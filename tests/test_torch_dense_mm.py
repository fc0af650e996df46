"""The port's dense reductions and matrix products against their plain
versions and the JAX package's functions, on seeded numpy inputs:

- the dense reductions (ops/reductions.py dense_bucket_counts_mm,
  dense_bucket_sum_mm: the dense_buckets kernel, ops/kernels.py; and the
  product masked_sum_planes_mm) == the `index_add_` / row-reduction
  versions == the JAX `*_mxu` functions; dense_buckets' tile choice, and
  its arithmetic emulated in numpy over the tiles it chooses under the
  layout csrc/kernels.cu defines (32-bit counters per copy, pieces folded
  every flush) == exact;
- the cube products (ops/cube.py cube_dots, block_counts,
  slot_block_counts) and the block histograms they read == a numpy int64
  reference == the JAX ops/cube.py functions;
- recombine / split_rm at the int64 edges, and every exactness bound the
  port asserts, tripped."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tantivy_aggregations_tpu.ops import cube as jcube
from tantivy_aggregations_tpu.ops import reductions as jred

from tantivy_aggregations_tpu_torch.ops import cube as C
from tantivy_aggregations_tpu_torch.ops import kernels as K
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
# dense reductions
# ---------------------------------------------------------------------------

def _bids(rng, rows, lo, hi):
    """int32 bucket ids in [lo, hi) (out of range too), a few at the int32
    extremes."""
    bid = rng.integers(lo, hi, rows).astype(np.int32)
    bid[rng.integers(0, rows, 16)] = I32_MIN
    bid[rng.integers(0, rows, 16)] = I32_MAX
    return bid


@pytest.mark.parametrize("B,nb", [(1, 5), (17, 30), (31, 13), (200, 300)])
def test_dense_bucket_counts_mm(B, nb):
    """== index_add_ == the JAX product, over a mask of B rows and over one
    row shared by all B (batch stride 0: run once, broadcast)."""
    rng = np.random.default_rng(B * 100 + nb)
    rows = 32768
    bid = _bids(rng, rows, -1, nb + 2)
    valid = rng.random((B, rows)) < 0.6
    got = R.dense_bucket_counts_mm(_t(bid), _t(valid), nb)
    assert got.dtype == torch.int64 and got.shape == (B, nb)
    assert torch.equal(got, R.dense_bucket_counts(_t(bid), _t(valid), nb))
    want = _jax_rows(lambda v: jred.dense_bucket_counts_mxu(
        jnp.asarray(bid), v, nb), valid)
    np.testing.assert_array_equal(got.numpy()[list(JAX_ROWS)], want)
    shared = _t(valid[:1]).expand(B, rows)
    got = R.dense_bucket_counts_mm(_t(bid), shared, nb)
    assert got.shape == (B, nb) and torch.equal(
        got, R.dense_bucket_counts(_t(bid), shared.contiguous(), nb))


@pytest.mark.parametrize("B,nb", [(1, 7), (17, 3), (31, 30), (200, 300)])
def test_dense_bucket_sum_mm(B, nb):
    """== index_add_ == the JAX product for full-range, INT32_MIN /
    INT32_MAX and negative payloads, each with its static bound as the plan
    passes it (None where it spans the int32 range)."""
    rng = np.random.default_rng(B + nb)
    rows = 32768
    bid = _bids(rng, rows, -1, nb + 1)
    valid = rng.random((B, rows)) < 0.5
    planes = _planes(rng, rows) + [rng.integers(-2**15, 2**15, rows)]
    bounds = [None] * 4 + [(0, 9999), (-2**15, 2**15 - 1)]
    for i, (plane, bound) in enumerate(zip(planes, bounds)):
        plane = plane.astype(np.int32)
        got = R.dense_bucket_sum_mm(_t(bid), _t(valid), _t(plane), nb,
                                    bound=bound)
        assert torch.equal(got, R.dense_bucket_sum(_t(bid), _t(valid),
                                                   _t(plane), nb)), i
        if i in (0, 3, 4, 5):  # full range, extremes, bounded, negative
            want = _jax_rows(lambda v: jred.dense_bucket_sum_mxu(
                jnp.asarray(bid), v, jnp.asarray(plane), nb, bound=bound),
                valid)
            np.testing.assert_array_equal(got.numpy()[list(JAX_ROWS)], want)
    shared = _t(valid[:1]).expand(B, rows)
    got = R.dense_bucket_sum_mm(_t(bid), shared, _t(planes[0].astype(
        np.int32)), nb)
    assert torch.equal(got, R.dense_bucket_sum(
        _t(bid), shared.contiguous(), _t(planes[0].astype(np.int32)), nb))


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
    """Rows that are not a multiple of a kernel step or of the product
    chunk; a batch-stride-0 mask (one row, broadcast); the kernel wrapper
    == its plain version, counts and sums; the
    masked-sums product's plan-time resident operand and its per-chunk
    build agree; the per-bucket min and max in one call; every call
    counts once, a (0, 0)-bounded sum (zeros) too."""
    rng = np.random.default_rng(rows)
    nb, B = 11, 5
    bid = _t(rng.integers(-1, nb, rows).astype(np.int32))
    plane = _t(rng.integers(I32_MIN, I32_MAX, rows).astype(np.int32))
    small = _t(rng.integers(0, 100, rows).astype(np.int32))
    row = _t(rng.random(rows) < 0.5)
    shared = row[None].expand(B, rows)
    R.reset_mm_calls()
    for mask in (shared, _t(rng.random((B, rows)) < 0.5)):
        want_c = R.dense_bucket_counts(bid, mask, nb)
        want_s = R.dense_bucket_sum(bid, mask, plane, nb)
        assert torch.equal(R.dense_bucket_counts_mm(bid, mask, nb), want_c)
        assert torch.equal(K.dense_buckets(mask, bid, nb), want_c)
        assert torch.equal(R.dense_bucket_sum_mm(bid, mask, plane, nb),
                           want_s)
        assert torch.equal(K.dense_buckets(mask.to(torch.uint8), bid, nb,
                                           small),
                           R.dense_bucket_sum(bid, mask, small, nb))
        assert torch.equal(R.dense_bucket_sum_mm(
            bid, mask, plane, nb, bound=(0, 0)), torch.zeros(B, nb,
                                                             dtype=torch.int64))
        mn, mx = R.dense_bucket_extremes_mm(bid, mask, nb, (plane,),
                                            (plane,))
        assert torch.equal(mn, R.dense_bucket_min(bid, mask.contiguous(),
                                                  plane, nb))
        assert torch.equal(mx, R.dense_bucket_max(bid, mask.contiguous(),
                                                  plane, nb))
        ps = [plane, bid]
        assert torch.equal(R.masked_sum_planes_mm(mask, ps),
                           R.masked_sum_planes(mask, ps))
        assert torch.equal(R.masked_sum_planes_mm(
            mask, ps, op=R.sum_planes_operand(ps)),
            R.masked_sum_planes(mask, ps))
    assert R.mm_calls == {"dense_bucket_counts_mm": 2,
                          "dense_bucket_sum_mm": 4,
                          "masked_sum_planes_mm": 4,
                          "dense_bucket_extremes_mm": 2}


def test_dense_product_partial_bound_is_asserted(monkeypatch):
    """A product partial of more rows than MM_CHUNK_MAX could leave the
    exact range of its fp32 partials: masked_sum_planes_mm refuses it."""
    monkeypatch.setattr(R, "MM_CHUNK", R.MM_CHUNK_MAX * 2)
    plane = torch.zeros(R.MM_CHUNK, dtype=torch.int32)
    with pytest.raises(AssertionError, match="exact"):
        R.masked_sum_planes_mm(torch.ones(1, R.MM_CHUNK, dtype=torch.bool),
                               [plane])


# dense_buckets' tiles and arithmetic (the kernel runs on the card only;
# chip_smoke.py holds it == its plain version there)

def _cu_layout():
    """dense_buckets' layout as csrc/kernels.cu defines it: its `constexpr
    int DB_*` values evaluated in order, so that these tests follow the
    kernel's source (on the card the wrapper reads the same values from
    the library)."""
    env = {}
    for name, expr in re.findall(r"constexpr int (DB_\w+) = ([^;]+);",
                                 K._SRC.read_text()):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return K.DenseLayout(env["DB_STEP"], env["DB_FLUSH_ROWS"],
                         env["DB_COPIES"], env["DB_TABLE_MAX"])


LAYOUT = _cu_layout()


def _emulate_dense_buckets(mask, bid, nb, payload, resident, lay=LAYOUT):
    """The dense_buckets kernel's arithmetic in numpy over the tiles,
    chunks and flushes its wrapper chooses under layout `lay`: per (item,
    flush window, query), 32-bit counters per (piece, bucket, copy), lane
    l adding into copy l % C (row r sits on lane (r % 128) // 4), wrapping
    as the card's do; each window's counters folded into int64."""
    B, T = mask.shape
    sums = payload is not None
    qt, Cp, nbt = K.dense_tile(B, nb, sums, lay)
    n_qt, n_bt = -(-B // qt), -(-nb // nbt)
    n_rc, chunk, flush = K.dense_chunks(T, n_qt * n_bt, resident, sums, lay)
    assert qt * nbt * (8 if sums else 4) * Cp <= lay.table_bytes
    copy = (np.arange(T) % 128) // 4 % Cp
    if sums:
        pieces = [(payload & 0xFFFF).astype(np.uint32),
                  (payload >> 16).astype(np.uint32)]
    else:
        pieces = [np.ones(T, np.uint32)]
    out = np.zeros((B, nb), np.int64)
    for rc in range(n_rc):
        r1 = min(T, (rc + 1) * chunk)
        for f0 in range(rc * chunk, r1, flush):
            w = slice(f0, min(r1, f0 + flush))
            for bt in range(n_bt):
                j0, nj = bt * nbt, min(nbt, nb - bt * nbt)
                ids = bid[w].astype(np.int64) - j0
                hit = (ids >= 0) & (ids < nj)
                for b in range(B):
                    sel = hit & (mask[b, w] != 0)
                    tabs = [np.zeros((nj, Cp), np.uint32) for _ in pieces]
                    for tab, pc in zip(tabs, pieces):
                        np.add.at(tab, (ids[sel], copy[w][sel]), pc[w][sel])
                    s = tabs[0].astype(np.int64).sum(1)
                    if sums:
                        s += tabs[1].view(np.int32).astype(np.int64).sum(1) \
                            * 65536
                    out[b, j0:j0 + nj] += s
    return out


@pytest.mark.parametrize("B,nb,sums,split", [
    (1, 31, True, False), (1, 10, False, False), (128, 31, False, False),
    (200, 31, True, False), (128, K.PCT_SLOT_CAP, False, True),
    (200, K.PCT_SLOT_CAP, True, True), (3, 100_000, True, True)])
def test_dense_tile_fits_and_splits_the_batch(B, nb, sums, split):
    """dense_tile: the table of qt queries x nbt buckets x C copies fits
    the layout's table bytes; the batch (and past one query's table, the
    buckets) splits only where the whole batch would not fit one copy
    each; c3's and c5's B = 1 histograms keep all 32 copies. dense_chunks:
    whole steps covering the rows once, about the resident CTAs in all, a
    sum's flush within the layout's flush rows."""
    lay = LAYOUT
    word = 8 if sums else 4
    qt, Cp, nbt = K.dense_tile(B, nb, sums, lay)
    assert 1 <= qt <= B and 1 <= nbt <= nb and Cp in (1, 2, 4, 8, 16, 32)
    assert qt * nbt * word * Cp <= lay.table_bytes
    assert (qt < B or nbt < nb) == split == (B * nb * word > lay.table_bytes)
    assert nbt == nb or nbt * word > lay.table_bytes - word
    if B == 1 and nb <= 32:
        assert Cp == lay.copies == 32
    if Cp < lay.copies:
        assert qt * nbt * word * Cp * 2 > lay.table_bytes
    items = -(-B // qt) * -(-nb // nbt)
    for T, resident in ((1000, 264), (10_027_008, 264), (10_027_008, 7),
                        (2**31 - 1, 1056)):
        n_rc, chunk, flush = K.dense_chunks(T, items, resident, sums, lay)
        assert chunk % lay.step == 0 and flush % lay.step == 0
        assert (n_rc - 1) * chunk < T <= n_rc * chunk
        assert flush <= chunk and (not sums or flush <= lay.flush_rows)
        assert items * n_rc <= max(resident, items) + items


@pytest.mark.parametrize("case", ["c3", "counts", "negative", "split",
                                  "bucket-tiles", "tail"])
def test_dense_buckets_tiles_emulated_exactly(case):
    """The kernel's arithmetic over its own tiles == exact (the plain
    version): every (query, bucket, row) counted once across query tiles,
    bucket tiles, row chunks and flush windows, whatever the resident
    CTAs; a table budget cut so that the batch and the buckets split."""
    rng = np.random.default_rng(len(case))
    T, B, nb, resident, lay = 20_000, 3, 31, 5, LAYOUT
    if case == "split":
        B, nb = 40, 300
        lay = lay._replace(table_bytes=16384)
    if case == "bucket-tiles":
        nb = 700
        lay = lay._replace(table_bytes=1024)
    if case == "tail":
        T, resident = 4 * lay.step + 13, 264
    bid = _bids(rng, T, -2, nb + 3)
    mask = rng.random((B, T)) < 0.6
    payload = {"c3": rng.integers(0, 10_000, T),
               "negative": rng.integers(-2**15, 2**15, T)}.get(
        case, rng.integers(I32_MIN, I32_MAX, T, endpoint=True))
    payload = payload.astype(np.int32)
    if case == "counts":
        payload = None
    got = _emulate_dense_buckets(mask, bid, nb, payload, resident, lay)
    want = K.dense_buckets_plain(_t(mask), _t(bid), nb,
                                 None if payload is None else _t(payload))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("v", [I32_MIN, I32_MAX])
def test_dense_buckets_pieces_hold_a_full_flush(v):
    """The 32-bit piece counters hold the layout's flush rows of a payload
    extreme (INT32_MIN / INT32_MAX) in one bucket and one copy over three
    flush windows; one window twice as long wraps them."""
    lay = LAYOUT._replace(copies=1)
    T = 2 * lay.flush_rows + lay.step
    bid = np.zeros(T, np.int32)
    mask = np.ones((1, T), bool)
    payload = np.full(T, v, np.int32)
    got = _emulate_dense_buckets(mask, bid, 1, payload, 1, lay)
    assert got.tolist() == [[v * T]]
    long = lay._replace(flush_rows=2 * lay.flush_rows)
    assert _emulate_dense_buckets(mask, bid, 1, payload, 1,
                                  long)[0, 0] != v * T


# dense_extremes' tiles and arithmetic (the kernel runs on the card only;
# chip_smoke.py holds it == its plain version there)

#: the identity key of each extreme (an empty bucket's)
KEY_NONE = {"min": np.uint64(2**64 - 1), "max": np.uint64(0)}


def _keys(planes):
    """The kernel's order-preserving unsigned keys of a payload: a narrow
    plane's values, or a wide (hi, lo) pair's rm value, sign bit flipped."""
    u = [np.asarray(p, np.int32).view(np.uint32) ^ np.uint32(0x80000000)
         for p in planes]
    if len(u) == 1:
        return u[0].astype(np.uint64)
    return (u[0].astype(np.uint64) << np.uint64(32)) | u[1].astype(np.uint64)


def _from_keys(k, wide):
    """Keys back to the output domain: int64 rm (wide) or int32."""
    if wide:
        return (k ^ np.uint64(2**63)).view(np.int64)
    return ((k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ^ np.uint32(0x80000000)).view(np.int32)


def _emulate_dense_extremes(mask, bid, nb, min_planes, max_planes,
                            resident, lay=LAYOUT):
    """The dense_extremes kernel's arithmetic in numpy over the tiles and
    chunks its wrapper chooses under layout `lay`: per (item, query) a
    table of 64-bit keys per (extreme, bucket, copy) starting at each
    extreme's identity, lane l folding its rows into copy l % C (row r sits
    on lane (r % 128) // 4); each item's table folded over its copies into
    the [ne, B, nb, n_rc] scratch; the scratch folded over the row chunks
    and written in the payload's domain. A batch-stride-0 torch `mask`
    runs once, broadcast."""
    shared = mask.shape[0] > 1 and mask.stride(0) == 0
    m = (mask[:1] if shared else mask).numpy() != 0
    B, T = m.shape
    asked = [(w, ps) for w, ps in (("min", min_planes), ("max", max_planes))
             if ps is not None]
    ne, wide = len(asked), len(asked[0][1]) == 2
    qt, Cp, nbt = K.extremes_tile(B, nb, ne, lay)
    n_qt, n_bt = -(-B // qt), -(-nb // nbt)
    n_rc, chunk, _ = K.dense_chunks(T, n_qt * n_bt, resident, False, lay)
    assert qt * nbt * 8 * ne * Cp <= lay.table_bytes
    assert (n_rc - 1) * chunk < T <= n_rc * chunk
    copy = (np.arange(T) % 128) // 4 % Cp
    keys = {w: _keys(ps) for w, ps in asked}
    part = {w: np.empty((B, nb, n_rc), np.uint64) for w, _ in asked}
    for rc in range(n_rc):
        rows = slice(rc * chunk, min(T, (rc + 1) * chunk))
        for bt in range(n_bt):
            j0, nj = bt * nbt, min(nbt, nb - bt * nbt)
            ids = bid[rows].astype(np.int64) - j0
            hit = (ids >= 0) & (ids < nj)
            for b in range(B):
                sel = hit & m[b, rows]
                for w, _ in asked:
                    tab = np.full((nj, Cp), KEY_NONE[w])
                    fold = np.minimum if w == "min" else np.maximum
                    fold.at(tab, (ids[sel], copy[rows][sel]),
                            keys[w][rows][sel])
                    part[w][b, j0:j0 + nj, rc] = fold.reduce(tab, axis=1)
    out = []
    for w in ("min", "max"):
        if w not in part:
            out.append(None)
            continue
        fold = np.minimum if w == "min" else np.maximum
        v = _from_keys(fold.reduce(part[w], axis=-1), wide)
        out.append(np.broadcast_to(v, (mask.shape[0], nb)) if shared else v)
    return out


def _extreme_payload(rng, T, width):
    """(w,) or (hi, lo) int32 planes holding INT32_MIN / INT32_MAX; a wide
    pair's hi drawn from seven values, so that most rows of a bucket tie
    on hi and lo decides."""
    lo = rng.integers(I32_MIN, I32_MAX, T, endpoint=True)
    lo[::7] = I32_MIN
    lo[3::11] = I32_MAX
    if width == 1:
        return (lo.astype(np.int32),)
    hi = rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1,
                              I32_MAX]), T)
    return hi.astype(np.int32), lo.astype(np.int32)


#: case: (B, nb, payload width, the max's own planes, extremes asked,
#: options: a table budget, a stride-0 mask, rows, resident CTAs)
EXTREME_CASES = {
    "narrow B=1 nb=50": (1, 50, 1, False, "both", {}),
    "wide B=1 nb=50": (1, 50, 2, False, "both", {}),
    "wide B=3 min and max planes": (3, 50, 2, True, "both", {}),
    "narrow B=3 min and max planes": (3, 50, 1, True, "both", {}),
    "wide B=128 nb=50": (128, 50, 2, False, "both", {}),
    "wide B=128 stride-0 mask": (128, 50, 2, False, "both",
                                 {"shared": True}),
    "narrow B=128 nb=4096": (128, 4096, 1, False, "both", {}),
    "wide B=3 nb=100000": (3, 100_000, 2, True, "both", {}),
    "wide B=1 nb=1": (1, 1, 2, False, "both", {}),
    "wide B=3 min only": (3, 50, 2, False, "min", {}),
    "narrow B=3 max only": (3, 50, 1, False, "max", {}),
    "wide split table": (40, 300, 2, True, "both", {"table": 16384}),
    "narrow tail rows": (3, 50, 1, False, "both",
                         {"rows": 4 * LAYOUT.step + 13, "resident": 264}),
}


@pytest.mark.parametrize("case", list(EXTREME_CASES))
def test_dense_extremes_tiles_emulated_exactly(case):
    """The kernel's arithmetic over its own tiles == the plain version
    (dense_bucket_min / dense_bucket_max, over wide_recon for a pair):
    every selected row folded once across query tiles, bucket tiles and
    row chunks; empty buckets at the identities (I32_MAX / I32_MIN, I64_MAX
    / I64_MIN), ids -2, -1 and >= nb matching nothing, INT32 extremes on hi
    and on lo, ties on hi broken by lo, a min and a max of different
    planes, one extreme alone, a stride-0 mask run once."""
    B, nb, width, sep, asked, opt = EXTREME_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + B)
    T = opt.get("rows", 20_000)
    lay = LAYOUT._replace(table_bytes=opt.get("table", LAYOUT.table_bytes))
    # ids from -2, past nb and at the int32 extremes; past 3 buckets the
    # last 3 stay empty
    bid = _bids(rng, T, -2, max(1, nb - 3))
    bid[rng.integers(0, T, 16)] = nb
    mask = _t(rng.random((1 if opt.get("shared") else B, T)) < 0.6)
    if opt.get("shared"):
        mask = mask.expand(B, T)
    ps = _extreme_payload(rng, T, width)
    mn = ps if asked != "max" else None
    mx = (_extreme_payload(rng, T, width) if sep else ps) \
        if asked != "min" else None
    got = _emulate_dense_extremes(mask, bid, nb, mn, mx,
                                  opt.get("resident", 5), lay)
    want = K.dense_extremes_plain(
        mask.contiguous(), _t(bid), nb,
        None if mn is None else tuple(map(_t, mn)),
        None if mx is None else tuple(map(_t, mx)))
    for g, w, fill in zip(got, want, ((I32_MAX, I64_MAX), (I32_MIN,
                                                           I64_MIN))):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert w.dtype == (torch.int64 if width == 2 else torch.int32)
        np.testing.assert_array_equal(g, w.numpy())
        assert nb <= 3 or (w[:, -3:] == fill[width - 1]).all()
    # the wrapper on the CPU gives the plain version's
    wrapped = K.dense_extremes(
        mask, _t(bid), nb, None if mn is None else tuple(map(_t, mn)),
        None if mx is None else tuple(map(_t, mx)))
    for g, w in zip(wrapped, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("pair", [(I32_MIN, I32_MIN), (I32_MIN, I32_MAX),
                                  (-1, I32_MAX), (0, I32_MIN), (0, -1),
                                  (I32_MAX, I32_MAX)])
def test_extreme_keys_keep_the_rm_order(pair):
    """A wide pair's key, sign bit flipped back, is wide_recon's rm value,
    and keys order as rm values do around the pair."""
    rng = np.random.default_rng(abs(pair[0]) % 97 + abs(pair[1]) % 89)
    hi = np.r_[pair[0], rng.integers(I32_MIN, I32_MAX, 64)].astype(np.int32)
    lo = np.r_[pair[1], rng.integers(I32_MIN, I32_MAX, 64)].astype(np.int32)
    rm = R.wide_recon(_t(hi), _t(lo)).numpy()
    k = _keys((hi, lo))
    np.testing.assert_array_equal(_from_keys(k, True), rm)
    np.testing.assert_array_equal(np.argsort(k, kind="stable"),
                                  np.argsort(rm, kind="stable"))


def _refused_args(case):
    T = 64
    i32 = torch.int32
    w = torch.zeros(T, dtype=i32)
    args = {"mask": torch.ones(2, T, dtype=torch.bool),
            "bid": torch.zeros(T, dtype=i32), "nb": 4,
            "min_planes": (w,), "max_planes": (w,)}
    args.update({
        "nothing asked": {"min_planes": None, "max_planes": None},
        "three planes": {"min_planes": (w, w, w), "max_planes": None},
        "mixed widths": {"max_planes": (w, w)},
        "bid rows": {"bid": torch.zeros(T + 4, dtype=i32)},
        "payload rows": {"min_planes": (torch.zeros(T - 4, dtype=i32),)},
        "mask rank": {"mask": torch.ones(T, dtype=torch.bool)},
        "mask dtype": {"mask": torch.ones(2, T)},
        "bid dtype": {"bid": torch.zeros(T, dtype=torch.int64)},
        "payload dtype": {"max_planes": (w.to(torch.int64),)},
        "payload not contiguous": {
            "min_planes": (torch.zeros(2 * T, dtype=i32)[::2],)},
        "bid not contiguous": {"bid": torch.zeros(2 * T, dtype=i32)[::2]},
        "no bucket": {"nb": 0},
    }[case])
    return args


@pytest.mark.parametrize("case", [
    "nothing asked", "three planes", "mixed widths", "bid rows",
    "payload rows", "mask rank", "mask dtype", "bid dtype", "payload dtype",
    "payload not contiguous", "bid not contiguous", "no bucket"])
def test_dense_extremes_refuses(case):
    with pytest.raises(ValueError, match="dense_extremes"):
        K.dense_extremes(**_refused_args(case))


@pytest.mark.parametrize("width,shared", [(1, False), (2, False), (2, True)])
def test_dense_extremes_cpu_tensors_take_the_plain_version(monkeypatch,
                                                           width, shared):
    """CPU tensors never reach the library or the launch counter."""
    def no_library():
        raise AssertionError("the CUDA library was loaded")
    monkeypatch.setattr(K, "_library", no_library)
    rng = np.random.default_rng(width)
    T, B, nb = 4096, 5, 9
    bid = _t(rng.integers(-1, nb + 1, T).astype(np.int32))
    ps = tuple(map(_t, _extreme_payload(rng, T, width)))
    mask = _t(rng.random((1 if shared else B, T)) < 0.5).expand(B, T)
    before = K.launches["dense_extremes"]
    got = K.dense_extremes(mask, bid, nb, ps, ps)
    want = K.dense_extremes_plain(mask.contiguous(), bid, nb, ps, ps)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.launches["dense_extremes"] == before


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
