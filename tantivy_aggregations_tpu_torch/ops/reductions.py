"""Masked / bucketed exact reductions over int32 planes (torch).

Batch-first counterparts of the JAX package's ops/reductions.py: every
mask is [B, rows] bool (one row per query of a request group), planes are
[rows] (query-independent) or [B, rows], and every result carries the
leading B axis. All arithmetic is integer: sums accumulate in int64 (CUDA
has native int64, so the TPU's 13-bit splits are not carried over) and no
float appears on any result path but masked_sum_planes_mm's fp32
partials, each an integer of magnitude at most 2^23 that fp32 holds
exactly.

Dense bucket reductions are integer `index_add_` / `scatter_reduce_` into
[B, nb] int64 (int32 for min/max) over static or composite bucket-id
planes; out-of-range ids (e.g. -1) match nothing. Their rows are docs or a
multi-valued field's value rows alike, so they also stand for the JAX
package's scatter `slot_*` reductions. Over a STATIC bucket-id
plane, counts and sums run as the dense_buckets kernel
(`dense_bucket_counts_mm`, `dense_bucket_sum_mm` below; ops/kernels.py),
of which the index_add_ functions are the plain versions, and mins and
maxes as the dense_extremes kernel (`dense_bucket_extremes_mm`), of which
the scatter_reduce_ functions are.

[B, rows]-sized int64 temporaries are built a few queries at a time
(`_query_chunks`), so a 128-query group over 10M rows stays within a
bounded working set. A mask whose rows are one shared row (batch stride
0, as `expand` makes it) is counted once (`shared_row`).
"""

from __future__ import annotations

import torch

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
I64_MAX = 2**63 - 1
I64_MIN = -(2**63)

#: element budget of one chunk's [b, rows] temporaries
_TMP_ELEMS = 1 << 27


def _query_chunks(B: int, rows: int):
    step = max(1, _TMP_ELEMS // max(rows, 1))
    for b0 in range(0, B, step):
        yield slice(b0, min(B, b0 + step))


def _rows(x, sl):
    """Rows `sl` of a [B, rows] operand; a [rows] operand is shared."""
    return x if x.dim() == 1 else x[sl]


def shared_row(mask):
    """(mask, rep): a [B, rows] mask whose rows are one shared row (batch
    stride 0, as `expand` makes it) as that row [1, rows] and B; any other
    mask as itself and 1."""
    if mask.shape[0] > 1 and mask.stride(0) == 0:
        return mask[:1], mask.shape[0]
    return mask, 1


def row_cumsum(x) -> torch.Tensor:
    """Inclusive int64 cumsum of each row of a [b, n] tensor, as ONE scan
    of the flattened tensor less each row's offset: a 1-D scan runs on
    the whole device, where a scan along the rows of a few long rows runs
    on few blocks (measured: torch's innermost-dim scan kernel)."""
    b, n = x.shape
    flat = torch.cumsum(x.reshape(-1), dim=0, dtype=torch.int64).reshape(b, n)
    if b > 1:
        flat[1:] -= flat[:-1, -1:].clone()
    return flat


def ts_count(mask) -> torch.Tensor:
    """[B, rows] bool -> [B] int64 exact counts. A batch-stride-0 mask is
    reduced once, as one row; any other in `_query_chunks` slices (the
    int64 sum casts its slice of the mask)."""
    mask, rep = shared_row(mask)
    B, rows = mask.shape
    out = torch.empty(B, dtype=torch.int64, device=mask.device)
    for sl in _query_chunks(B, rows):
        out[sl] = mask[sl].sum(dim=-1, dtype=torch.int64)
    return out if rep == 1 else out.expand(rep).contiguous()


def ts_sum_plane(plane, mask) -> torch.Tensor:
    """Exact [B] int64 sums of a masked int32 plane (signed allowed)."""
    B, rows = mask.shape
    out = torch.empty(B, dtype=torch.int64, device=mask.device)
    for sl in _query_chunks(B, rows):
        out[sl] = torch.where(mask[sl], _rows(plane, sl), 0).sum(
            dim=-1, dtype=torch.int64)
    return out


def masked_sum_planes(mask, planes) -> torch.Tensor:
    """[B, L] int64 exact masked sums of L int32 planes."""
    return torch.stack([ts_sum_plane(p, mask) for p in planes], dim=-1)


def masked_min_i32(plane, mask) -> torch.Tensor:
    return torch.where(mask, plane, I32_MAX).amin(dim=-1)


def masked_max_i32(plane, mask) -> torch.Tensor:
    return torch.where(mask, plane, -1).amax(dim=-1)


def wide_recon(hi, lo) -> torch.Tensor:
    """(hi, lo) monoized int32 planes -> order-isomorphic int64 ("rm"
    domain: rm = w - 2^63)."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2**31)


def masked_min_wide(hi, lo, mask) -> torch.Tensor:
    """Exact masked min of a wide (hi, lo) pair in the rm domain
    (lexicographic: min hi, then min lo among rows at that hi). Empty
    masks yield exactly I64_MAX, as the JAX package's form does."""
    mh = torch.where(mask, hi, I32_MAX).amin(dim=-1)
    ml = torch.where(mask & (hi == mh[:, None]), lo, I32_MAX).amin(dim=-1)
    return (mh.to(torch.int64) << 32) + (ml.to(torch.int64) + 2**31)


def masked_max_wide(hi, lo, mask) -> torch.Tensor:
    """Exact masked max of a wide (hi, lo) pair; empty masks yield I64_MIN."""
    mh = torch.where(mask, hi, I32_MIN).amax(dim=-1)
    ml = torch.where(mask & (hi == mh[:, None]), lo, I32_MIN).amax(dim=-1)
    return (mh.to(torch.int64) << 32) + (ml.to(torch.int64) + 2**31)


def values_hit_to_doc_mask(hits, doc, T: int) -> torch.Tensor:
    """Value-row hits [B, V] -> doc mask [B, T]: doc d is set where a hit
    row maps to it (a scatter-or, the JAX package's values_hit_to_doc_mask;
    only doc-space mask programs, over a multi-valued field's overflow tail
    or CSR token stream, reach it). Exact, in query chunks."""
    B, V = hits.shape
    out = torch.zeros(B, T, dtype=torch.bool, device=hits.device)
    d = doc.to(torch.int64)
    for sl in _query_chunks(B, max(V, T)):
        acc = torch.zeros(sl.stop - sl.start, T, dtype=torch.int32,
                          device=hits.device)
        acc.scatter_reduce_(1, d.expand(acc.shape[0], V),
                            hits[sl].to(torch.int32), "amax")
        out[sl] = acc > 0
    return out


# ---------------------------------------------------------------------------
# Dense bucket reductions (static or composite bucket-id planes)
# ---------------------------------------------------------------------------

def _bucket_index(bid, valid, nb: int, sl):
    """(flat [b*rows] int64 indices into a [b, nb] block, [b, rows] bool
    row-contributes) for query rows `sl`."""
    v = valid[sl]
    b = _rows(bid, sl)
    ok = v & (b >= 0) & (b < nb)
    n = v.shape[0]
    base = torch.arange(n, device=v.device, dtype=torch.int64)[:, None] * nb
    idx = base + b.clamp(0, nb - 1).to(torch.int64)
    return idx.reshape(-1), ok


def dense_bucket_counts(bid, valid, nb: int) -> torch.Tensor:
    """[rows] or [B, rows] int32 bucket ids + [B, rows] validity ->
    [B, nb] int64 counts."""
    B, rows = valid.shape
    out = torch.zeros(B, nb, dtype=torch.int64, device=valid.device)
    for sl in _query_chunks(B, rows):
        idx, ok = _bucket_index(bid, valid, nb, sl)
        out[sl].view(-1).index_add_(0, idx, ok.reshape(-1).to(torch.int64))
    return out


def dense_bucket_sum(bid, valid, plane, nb: int) -> torch.Tensor:
    """Exact per-bucket [B, nb] int64 sums of a masked int32 plane."""
    B, rows = valid.shape
    out = torch.zeros(B, nb, dtype=torch.int64, device=valid.device)
    for sl in _query_chunks(B, rows):
        idx, ok = _bucket_index(bid, valid, nb, sl)
        v = torch.where(ok, _rows(plane, sl).to(torch.int64), 0)
        out[sl].view(-1).index_add_(0, idx, v.reshape(-1))
    return out


def _dense_bucket_extreme(bid, valid, plane, nb: int, reduce: str, fill):
    B, rows = valid.shape
    out = torch.full((B, nb), fill, dtype=plane.dtype, device=valid.device)
    for sl in _query_chunks(B, rows):
        idx, ok = _bucket_index(bid, valid, nb, sl)
        v = torch.where(ok, _rows(plane, sl), fill)
        out[sl].view(-1).scatter_reduce_(0, idx, v.reshape(-1), reduce,
                                         include_self=True)
    return out


def dense_bucket_min(bid, valid, plane, nb: int) -> torch.Tensor:
    fill = I32_MAX if plane.dtype == torch.int32 else I64_MAX
    return _dense_bucket_extreme(bid, valid, plane, nb, "amin", fill)


def dense_bucket_max(bid, valid, plane, nb: int) -> torch.Tensor:
    fill = I32_MIN if plane.dtype == torch.int32 else I64_MIN
    return _dense_bucket_extreme(bid, valid, plane, nb, "amax", fill)


# ---------------------------------------------------------------------------
# 32-block prefix machinery (high-cardinality buckets over an OrderedLayout)
# ---------------------------------------------------------------------------

def block32_counts(mask) -> torch.Tensor:
    """[B, R] mask -> [B, R/32] int32 per-32-row counts."""
    B, R = mask.shape
    return mask.view(B, R // 32, 32).sum(dim=-1, dtype=torch.int32)


def block32_sums(mask, plane) -> torch.Tensor:
    """[B, R] mask, int32 [R] plane -> [B, R/32] int64 exact per-32-row
    sums of the masked plane (in query chunks)."""
    B, R = mask.shape
    out = torch.empty(B, R // 32, dtype=torch.int64, device=mask.device)
    for sl in _query_chunks(B, R):
        out[sl] = torch.where(mask[sl], plane, 0).view(-1, R // 32, 32).sum(
            dim=-1, dtype=torch.int64)
    return out


def slot_block_counts(mask, slots, ns: int) -> torch.Tensor:
    """[B, R] mask and K static int32 [R] slot planes (-1 = none) ->
    int32 [B, ns, R/32]: per query, slot s and 32-row block, the number
    of (row, plane) pairs with the row masked and the plane's slot s. An
    int32 index_add_ over s * R/32 + block, in query chunks (exact: a
    block holds at most 32 * K)."""
    B, R = mask.shape
    NB = R // 32
    out = torch.zeros(B, ns * NB, dtype=torch.int32, device=mask.device)
    blk = torch.arange(R, device=mask.device) // 32
    for slot in slots:
        ok = (slot >= 0) & (slot < ns)
        idx = slot.clamp(0, ns - 1).to(torch.int64) * NB + blk
        for sl in _query_chunks(B, R):
            out[sl].index_add_(1, idx, (mask[sl] & ok).to(torch.int32))
    return out.view(B, ns, NB)


def _prefix_at_bounds(block_vals, bounds32) -> torch.Tensor:
    """Exclusive int64 prefix over [B, R/32] block values, differenced at
    the 32-unit bucket bounds [card+1] -> per-bucket totals [B, card]."""
    B = block_vals.shape[0]
    pref = torch.cumsum(block_vals, dim=-1, dtype=torch.int64)
    pref = torch.cat([torch.zeros(B, 1, dtype=torch.int64,
                                  device=pref.device), pref], dim=1)
    at = pref[:, bounds32]
    return at[:, 1:] - at[:, :-1]


def prefix_diff_counts_from_blocks(c32, bounds32) -> torch.Tensor:
    """Per-bucket [B, card] int64 counts from per-32-block counts (the
    chain_blocks kernel output)."""
    return _prefix_at_bounds(c32, bounds32)


def prefix_diff_sums_from_blocks(s64, bounds32) -> torch.Tensor:
    """Per-bucket [B, card] exact sums from per-32-block int64 payload sums
    (the chain_blocks kernel output)."""
    return _prefix_at_bounds(s64, bounds32)


# ---------------------------------------------------------------------------
# Dense reductions over STATIC planes: the dense_buckets kernel and the
# masked-sums product
# ---------------------------------------------------------------------------
#
# Replaces the JAX package's ops/reductions.py `dense_bucket_counts_mxu`
# (:242), `dense_bucket_sum_mxu` (:258) and `masked_sum_planes_mxu` (:286),
# with their helpers `npieces_for_bound`, `_pieces`, `_recombine` and
# `_mxu_dense_chunk` (:163-224). When the bucket-id plane and the payload
# are query-independent (a dense bucket agg right under the root or a
# filter, or a metric at that scope), the JAX package multiplies the masks
# by an operand no query changes: the bucket one-hot, then the payload's
# 7-bit pieces under it. On the card a histogram of a few buckets is a
# streaming reduction instead: dense_bucket_counts_mm and
# dense_bucket_sum_mm launch the dense_buckets kernel (ops/kernels.py),
# which reads the bid plane, the payload and the mask once, no operand.
# masked_sum_planes_mm keeps the product: the masks by the [rows, K]
# operand of every plane's 7-bit pieces, which the planner builds once per
# program (`sum_planes_operand`, cached on the device index) where it fits
# DENSE_OP_MEM, else the product builds it per row chunk as the JAX
# package does. A mask whose rows are one shared row (batch stride 0: a
# MatchAll root) runs once, as one row, and the result is broadcast over
# the batch.
#
# The product's formulation on the card: `torch._int_mm` runs an int8
# product of this shape (a few output columns, 10M-deep) on very few CTAs —
# about 19 ms for [32, 10M] x [10M, 32] on the H100, whatever the chunking
# (PERF.md) — so the rows are cut into
# MM_CHUNK-row partials and multiplied as ONE batched bf16 product with
# fp32 partials (`torch.bmm(..., out_dtype=torch.float32)`). Exact by
# construction: the mask is 0/1 and every piece lies in [-128, 127], both
# exact in bf16; a partial sums at most MM_CHUNK * 128 <= 2^23 in magnitude,
# an integer every fp32 partial holds exactly; partials add up in int64. On
# the CPU the same partials are float32 products (exact for the same
# reason). The `index_add_` functions above are the plain versions.

#: rows per product partial (the exactness bound: |partial| <= 128 * MM_CHUNK
#: must stay <= 2^23); PAD_BLOCK (32768) rows divide every plane
MM_CHUNK = 1 << 15
MM_CHUNK_MAX = 1 << 16
#: byte budget of one resident dense operand (plan time; above it a product
#: builds its operand per row chunk)
DENSE_OP_MEM = 4 << 30
#: element budget of a product step's temporaries (the [B, chunk] mask copy
#: in the product dtype, a per-chunk operand)
_MM_STEP_ELEMS = 1 << 27

#: calls since the last reset_mm_calls() (a graph replay credits those its
#: capture enqueued: aggs/compile.py _StepGraph); each dense_bucket_*_mm
#: call launches dense_buckets once, but a sum of a payload bounded to
#: (0, 0), which is 0 and launches nothing; each dense_bucket_extremes_mm
#: call launches dense_extremes once
mm_calls = {"dense_bucket_counts_mm": 0, "dense_bucket_sum_mm": 0,
            "masked_sum_planes_mm": 0, "dense_bucket_extremes_mm": 0}


def reset_mm_calls() -> None:
    for k in mm_calls:
        mm_calls[k] = 0


def npieces_for_bound(bound) -> int:
    """Number of 7-bit pieces that decompose int32 values with static
    inclusive bounds `bound = (lo, hi)` exactly: low pieces are
    (v >> 7i) & 127 in [0, 127], the top piece is the arithmetic shift
    v >> 7(n-1) and must land in [-128, 127]. None -> 5 (full int32)."""
    if bound is None:
        return 5
    lo, hi = int(bound[0]), int(bound[1])
    for n in range(1, 5):
        s = 7 * (n - 1)
        if -128 <= (lo >> s) and (hi >> s) <= 127:
            return n
    return 5


def _pieces(v, n: int):
    """The n 7-bit pieces of int32 plane v (see npieces_for_bound)."""
    return [(v >> (7 * i)) & 127 if i < n - 1 else v >> (7 * (n - 1))
            for i in range(n)]


def _recombine(acc, n: int):
    """int64 piece sums [..., n, X] -> exact int64 totals [..., X]: one
    vectorized shift-sum over the piece axis."""
    shifts = torch.arange(n, dtype=torch.int64, device=acc.device) * 7
    return (acc << shifts[:, None]).sum(dim=-2)


def mm_dtype(device) -> torch.dtype:
    """The operand dtype of the dense products: bf16 on the card (tensor
    cores, fp32 partials), float32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def pad8(k: int) -> int:
    """k rounded up to a multiple of 8 (at least 8): the widths a
    tensor-core product's operands are padded to."""
    return max(8, -(-k // 8) * 8)


def _planes_cols(planes, nps, dtype):
    return torch.stack([p.to(dtype) for v, n in zip(planes, nps)
                        for p in _pieces(v, n)], dim=1)


def _fill(cols_of, rows: int, K: int, device, r0: int = 0, r1=None):
    """[r1 - r0, pad8(K)] operand rows r0..r1 from `cols_of(r0, r1)` (a
    [r, K] block), built MM_STEP-bounded slices at a time."""
    r1 = rows if r1 is None else r1
    dt = mm_dtype(device)
    out = torch.zeros(r1 - r0, pad8(K), dtype=dt, device=device)
    step = max(MM_CHUNK, (_MM_STEP_ELEMS // max(K, 1)) // MM_CHUNK
               * MM_CHUNK)
    for a in range(r0, r1, step):
        b = min(r1, a + step)
        out[a - r0:b - r0, :K] = cols_of(a, b, dt)
    return out


def _mm_sums(mask, K: int, op=None, cols_of=None):
    """Exact int64 [B, K] = mask [B, rows] (bool) @ operand [rows, K]: the
    resident operand `op` ([rows, pad8(K)]) or one built per row step by
    `cols_of(r0, r1, dtype)`. A batch-stride-0 mask runs once, as one row."""
    assert MM_CHUNK <= MM_CHUNK_MAX, \
        f"dense product partials of {MM_CHUNK} rows exceed the exact " \
        f"fp32 bound ({MM_CHUNK_MAX} rows: |partial| <= 2^23)"
    mask, rep = shared_row(mask)
    B, rows = mask.shape
    dev = mask.device
    Kp = pad8(K)
    dt = mm_dtype(dev)
    acc = torch.zeros(B, Kp, dtype=torch.int64, device=dev)
    step = max(MM_CHUNK, (_MM_STEP_ELEMS // max(B, Kp)) // MM_CHUNK
               * MM_CHUNK)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        rhs = op[r0:r1] if op is not None else _fill(cols_of, rows, K, dev,
                                                     r0, r1)
        lhs = mask[:, r0:r1].to(dt)
        # whole MM_CHUNK-row partials as one batch, a row tail as another
        full = (r1 - r0) // MM_CHUNK * MM_CHUNK
        for a, b, n in ((0, full, MM_CHUNK), (full, r1 - r0, r1 - r0 - full)):
            if b == a:
                continue
            nc = (b - a) // n
            x = lhs[:, a:b].reshape(B, nc, n).transpose(0, 1)
            y = rhs[a:b].reshape(nc, n, Kp)
            part = (torch.bmm(x, y, out_dtype=torch.float32)
                    if dev.type == "cuda" else torch.bmm(x, y))
            acc += part.to(torch.int64).sum(dim=0)
    acc = acc[:, :K]
    return acc if rep == 1 else acc.expand(rep, K)


def dense_bucket_counts_mm(bid, valid, nb: int) -> torch.Tensor:
    """dense_bucket_counts over a static contiguous int32 [rows] bid
    plane: [B, rows] validity -> [B, nb] int64 counts (ids outside
    [0, nb) match nothing), by the dense_buckets kernel (its plain
    version, dense_bucket_counts, for CPU tensors)."""
    from . import kernels  # kernels imports this module
    mm_calls["dense_bucket_counts_mm"] += 1
    return kernels.dense_buckets(valid, bid, nb)


def dense_bucket_sum_mm(bid, valid, plane, nb: int,
                        bound=None) -> torch.Tensor:
    """dense_bucket_sum over a static int32 bid plane and a static
    contiguous int32 payload -> [B, nb], by the dense_buckets kernel.
    `bound`: a static inclusive (lo, hi) on the payload's values or None:
    (0, 0) sums are 0 (nothing launches)."""
    from . import kernels  # kernels imports this module
    mm_calls["dense_bucket_sum_mm"] += 1
    if bound is not None and tuple(bound) == (0, 0):
        return torch.zeros(valid.shape[0], nb, dtype=torch.int64,
                           device=valid.device)
    return kernels.dense_buckets(valid, bid, nb, plane)


def dense_bucket_extremes_mm(bid, valid, nb: int, min_planes=None,
                             max_planes=None):
    """dense_bucket_min and / or dense_bucket_max over a static contiguous
    int32 [rows] bid plane in one launch of the dense_extremes kernel (its
    plain version for CPU tensors): `min_planes`, `max_planes` None or the
    extreme's static payload, `(w,)` an int32 plane or `(hi, lo)` a wide
    pair -> (min, max) [B, nb], int32 or int64 in the rm domain, None where
    not asked (ops/kernels.py dense_extremes)."""
    from . import kernels  # kernels imports this module
    mm_calls["dense_bucket_extremes_mm"] += 1
    return kernels.dense_extremes(valid, bid, nb, min_planes, max_planes)


def _live_planes(planes, bounds):
    if bounds is None:
        bounds = [None] * len(planes)
    live = [l for l in range(len(planes))
            if bounds[l] is None or tuple(bounds[l]) != (0, 0)]
    return live, [npieces_for_bound(bounds[l]) for l in live]


def sum_planes_operand(planes, bounds=None):
    live, nps = _live_planes(planes, bounds)
    lp = [planes[l] for l in live]
    return _fill(lambda a, b, d: _planes_cols([p[a:b] for p in lp], nps, d),
                 planes[0].shape[0], sum(nps), planes[0].device)


def masked_sum_planes_mm(mask, planes, bounds=None, op=None) -> torch.Tensor:
    """Exact [B, L] int64 masked sums of L static int32 planes in ONE
    product: the 7-bit pieces of every plane concatenate into one operand.
    `bounds`: optional static per-plane inclusive (lo, hi); a (0, 0) plane
    is dropped from the operand (its sums are 0)."""
    mm_calls["masked_sum_planes_mm"] += 1
    B = mask.shape[0]
    live, nps = _live_planes(planes, bounds)
    out = torch.zeros(B, len(planes), dtype=torch.int64, device=mask.device)
    if not live:
        return out
    lp = [planes[l] for l in live]
    acc = _mm_sums(mask, sum(nps), op,
                   lambda a, b, d: _planes_cols([p[a:b] for p in lp], nps,
                                                d))
    o = 0
    for l, n in zip(live, nps):
        out[:, l] = _recombine(acc[:, o:o + n, None], n)[:, 0]
        o += n
    return out
