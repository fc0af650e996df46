"""Masked / bucketed exact reductions over int32 planes (torch).

Batch-first counterparts of the JAX package's ops/reductions.py: every
mask is [B, rows] bool (one row per query of a request group), planes are
[rows] (query-independent) or [B, rows], and every result carries the
leading B axis. All arithmetic is integer: sums accumulate in int64 (CUDA
has native int64, so the TPU's 13-bit splits and 7-bit MXU pieces are not
carried over) and no float appears on any result path.

Dense bucket reductions are integer `index_add_` / `scatter_reduce_` into
[B, nb] int64 (int32 for min/max) over static or composite bucket-id
planes; out-of-range ids (e.g. -1) match nothing.

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
