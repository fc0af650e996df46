"""Value-domain cube lowering: per-query work without the row axis.

The port of the JAX package's ops/cube.py.

When every query-chain field is a SINGLE-VALUED narrow/stringy column and
the product of their w-domains is small (<= CUBE_DOM_CAP cells), the chain
mask is a pure elementwise function of the domain tuple: mask[r] =
f(w_1[r], .., w_k[r]). Every masked reduction the engine needs then
regroups by domain cell:

    count        = sum_v ind[v] * C[v]          C[v]   = #rows at cell v
    sum(plane)   = sum_v ind[v] * S[v]          S[v]   = sum of plane at v
    bucket j     = sum_v ind[v] * C[v, j]       (static bucket-id planes)
    min / max    = min/max over {M[v] : ind[v]}
    rank prefix  = sum_v ind[v] * H[b, v]       (per-block histograms)

with ind[v] = f(v) evaluated by the SAME mask program the kernels and the
row path run (query/compile.py `eval_ops`) over virtual domain planes
(`dom_planes`): the predicate semantics are identical by construction.
C/S/M/H are query-independent: exact int64 host pre-aggregates (counts by
bincount; sums by 13-bit-split float64 bincounts — each half-sum < 2^42 <
2^53, so the float accumulation is exact; min/max by ufunc.at), decomposed
into 7-bit int8 pieces. A request group then costs one [B, Dprod] indicator
evaluation and one [B, Dprod] x [Dprod, K] int8 product (`torch._int_mm`,
int32 partials) — no row pass.

Exactness: every piece is int8; a dot lane sums <= Dprod * 127 < 2^24
(Dprod <= CUBE_DOM_CAP = 2^17, asserted in `cube_dots`); recombination
shifts in int64. The cube is an exact regrouping of the same integer
addends, so results are bit-identical to the row formulation and to the
oracle.

Layout on the card: an operand is kept transposed, [K, Dprod] int8 with
both sides padded to multiples of 8 (`torch._int_mm`'s rule), and
multiplied as `ind @ op.t()` — the layout cuBLAS runs fast (on c8's
100,001-cell site a [Dprod, K] row-major operand takes about 7x longer on
the H100: chip_smoke.py phase 4p). The indicator is padded to at least 32
rows (the product needs more than 16).

Sharded meshes (JAX `pack_groups_sharded`): each shard builds the
pre-aggregates of its own rows and packs them itself; the piece count of
each group is chosen from its bounds across the shards (`group_bounds`,
exchanged at plan time, `merge_bounds`, `pack_groups(..., bounds=)`), so
every shard shares one column layout, dots its own operand, and one int32
psum of the dot vectors merges them (`shard_dots`): lanes stay below S *
2^24, so at most MAX_SHARDS = 128 shards (asserted).

Gating (aggs/compile.py `_cube_gate`): programs whose chain has at least
one extracted parameter. Match-all-shaped trees keep the row paths — the
cube is an access structure for parameterized queries, not a result cache
(EngineConfig.msearch_dedup covers repeated identical requests).
"""

from __future__ import annotations

import numpy as np
import torch

from .reductions import pad8

I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1

#: max product-domain cells for a cube: int32 dot lanes stay below
#: Dprod * 127 < 2^24 (and the [B, Dprod] indicator batch stays small)
CUBE_DOM_CAP = 1 << 17
#: max rows per build: bounds per-cell counts so the host build_sum
#: float64-bincount accumulation stays exact (each 13-bit half-sum < 2^42
#: < 2^53)
MAX_BUILD_ROWS = 1 << 24
#: max static piece columns per cube site
CUBE_COLS_CAP = 4096
#: max composite (domain cell x bucket) cells for a bucket-agg cube (host
#: bincount domain; 2^23 int64 cells = 64MB transient per build)
CUBE_BCELLS_CAP = 1 << 23
#: peak byte budget of a percentile block-histogram build, transient
#: scratch included (BLOCK_BUILD_FACTOR): the resident histogram is bounded
#: by a third of it. The JAX package's value; not re-tuned for 80 GB yet
CUBE_BLOCK_MEM = 384 << 20
#: candidate block sizes for block histograms: counts <= G decompose into
#: two base-128 digits (G >> 7 <= 64 <= 127 keeps the high digit in int8)
BLOCK_GS = (128, 256, 512, 1024, 2048, 4096, 8192)
#: transient-build multiplier of the block-histogram byte budget: the build
#: scatters into an int32 [NB * Dprod] count scratch (4x the int8 result
#: per digit = 2x the two-digit histogram) beside the result
BLOCK_BUILD_FACTOR = 3
#: least rows of a product's left operand (torch._int_mm needs > 16)
MM_MIN_ROWS = 32
#: most shards whose int32 dot lanes sum exactly: each shard's lanes stay
#: below 2^24 (CUBE_DOM_CAP * 127), so S shards below S * 2^24 <= 2^31
MAX_SHARDS = 1 << 7

#: product calls since the last reset_calls() (a graph replay credits
#: those its capture enqueued: aggs/compile.py _StepGraph)
calls = {"cube_dots": 0, "block_counts": 0, "slot_block_counts": 0}


def reset_calls() -> None:
    for k in calls:
        calls[k] = 0


def factor_meta(col):
    """(domain size, offset) of one chain field's w-domain. Stringy columns
    include the -1 missing sentinel as cell 0 (offset 1); numeric
    single-valued columns always hold a value (writer default 0), so their
    domain is [0, span]."""
    if col.ftype.is_stringy:
        return int(len(col.terms)) + 1, 1
    return int(col.span) + 1, 0


def npieces_i64(lo: int, hi: int) -> int:
    """Signed 7-bit piece count for int64 values in [lo, hi]: low pieces
    are (v >> 7i) & 127, the top piece is the arithmetic shift v >> 7(n-1)
    and must land in [-128, 127]. v == sum(p_i << 7i) exactly (two's
    complement identity), for any signed int64."""
    for n in range(1, 10):
        s = 7 * (n - 1)
        if -128 <= (lo >> s) and (hi >> s) <= 127:
            return n
    return 10


def pieces_host(x: np.ndarray, n: int) -> np.ndarray:
    """int64 [D] -> int8 [D, n] pieces (see npieces_i64)."""
    out = np.empty(x.shape + (n,), np.int8)
    for i in range(n):
        p = (x >> (7 * i)) & 127 if i < n - 1 else x >> (7 * (n - 1))
        out[..., i] = p.astype(np.int8)
    return out


def strides_of(factors):
    """Mixed-radix strides (last factor fastest), shared by the host cell
    index and the virtual domain planes."""
    strides = []
    s = 1
    for _, Df, _ in reversed(factors):
        strides.append(s)
        s *= Df
    return list(reversed(strides)), s


def dom_planes(factors, device):
    """Virtual w-planes over the product domain: plane[f"{field}:w"] holds
    the field's w value at every domain cell (iota decode). The chain's
    mask program over these planes IS the chain predicate as a function of
    the cell."""
    strides, Dprod = strides_of(factors)
    iota = torch.arange(Dprod, dtype=torch.int32, device=device)
    planes = {}
    for (f, Df, off), st in zip(factors, strides):
        planes[f"{f}:w"] = (iota // st) % Df - off
    return planes, Dprod


def host_cell(factors, host_ws, avalid) -> np.ndarray:
    """int64 cell index per row from host w-planes; rows outside the alive
    mask get -1 (dropped by every builder)."""
    strides, _ = strides_of(factors)
    cell = np.zeros(host_ws[0].shape[0], np.int64)
    for (f, Df, off), st, w in zip(factors, strides, host_ws):
        cell += (w.astype(np.int64) + off) * st
    return np.where(avalid, cell, -1)


def build_count(cell: np.ndarray, Dprod: int) -> np.ndarray:
    """Exact int64 per-cell row counts."""
    ok = cell >= 0
    return np.bincount(cell[ok], minlength=Dprod).astype(np.int64)


def build_sum(cell: np.ndarray, plane: np.ndarray, Dprod: int) -> np.ndarray:
    """Exact int64 per-cell sums of an int32 plane via 13-bit-split float64
    bincounts: |hi| <= 2^18 and counts <= 2^24, so each half-sum stays
    < 2^42 < 2^53 — every float add is exact."""
    assert cell.shape[0] <= MAX_BUILD_ROWS, \
        "build_sum exactness requires per-cell counts <= MAX_BUILD_ROWS " \
        f"(got {cell.shape[0]} rows)"
    ok = cell >= 0
    c = cell[ok]
    v = plane[ok].astype(np.int64)
    hi = v >> 13
    lo = v - (hi << 13)
    s_hi = np.bincount(c, weights=hi.astype(np.float64), minlength=Dprod)
    s_lo = np.bincount(c, weights=lo.astype(np.float64), minlength=Dprod)
    return (s_hi.astype(np.int64) << 13) + s_lo.astype(np.int64)


def build_min64(cell, rm, Dprod, valid=None) -> np.ndarray:
    """Per-cell int64 minimum (I64_MAX at empty cells — the engine's empty
    min sentinel)."""
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, I64_MAX, np.int64)
    np.minimum.at(out, cell[ok], rm[ok])
    return out


def build_max64(cell, rm, Dprod, valid=None) -> np.ndarray:
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, -(2**63), np.int64)
    np.maximum.at(out, cell[ok], rm[ok])
    return out


def build_min32(cell, w, Dprod, valid=None) -> np.ndarray:
    """Per-cell int32 minimum of a non-negative w plane (I32_MAX empty —
    matches reductions.masked_min_i32)."""
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, I32_MAX, np.int32)
    np.minimum.at(out, cell[ok], w[ok])
    return out


def build_max32(cell, w, Dprod, valid=None) -> np.ndarray:
    """Per-cell int32 maximum (empty -> -1 — matches masked_max_i32: w
    planes are non-negative)."""
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, -1, np.int32)
    np.maximum.at(out, cell[ok], w[ok])
    return out


def bucket_cell(cell: np.ndarray, bid: np.ndarray, nb: int) -> np.ndarray:
    """Composite (domain cell, bucket) index per row for bucket-agg cubes:
    cell * nb + bid, with dropped rows (dead docs / missing bucket values)
    at -1."""
    ok = (cell >= 0) & (bid >= 0)
    return np.where(ok, cell * np.int64(nb) + bid, -1)


def build_bucket_counts(cell2: np.ndarray, Dprod: int, nb: int) -> np.ndarray:
    """Exact int64 [nb, Dprod] per-(bucket, cell) row counts — row j is
    bucket j's count vector over the product domain."""
    ok = cell2 >= 0
    c = np.bincount(cell2[ok], minlength=Dprod * nb)
    return np.ascontiguousarray(c.reshape(Dprod, nb).T.astype(np.int64))


def build_bucket_sums(cell2: np.ndarray, plane: np.ndarray, Dprod: int,
                      nb: int) -> np.ndarray:
    """Exact int64 [nb, Dprod] per-(bucket, cell) sums of an int32 plane
    (same 13-bit-split exactness proof as build_sum over the composite
    domain)."""
    s = build_sum(cell2, plane, Dprod * nb)
    return np.ascontiguousarray(s.reshape(Dprod, nb).T)


def split_rm(rm: np.ndarray):
    """int64 rm values -> (hi, lo) int32 planes such that
    reductions.wide_recon(hi, lo) == rm exactly (incl. the I64_MAX/I64_MIN
    empty sentinels)."""
    hi = (rm >> 32).astype(np.int32)
    lo = (rm - (rm >> 32 << 32) - 2**31).astype(np.int64).astype(np.int32)
    return hi, lo


def group_bounds(groups):
    """[(lo, hi), ...]: each group's value bounds (0, 0 when empty)."""
    out = []
    for _, arr in groups:
        a = np.asarray(arr, np.int64)
        out.append((int(a.min()), int(a.max())) if a.size else (0, 0))
    return out


def merge_bounds(per_shard):
    """Every shard's group_bounds -> the bounds across the shards."""
    return [(min(b[i][0] for b in per_shard), max(b[i][1] for b in per_shard))
            for i in range(len(per_shard[0]))]


def pack_groups(groups, bounds=None):
    """[(name, int64 [m, Dprod] or [Dprod] cells), ...] -> (int8 [Dprod, K]
    pieces, layout) where layout = [(name, m, npieces), ...] in column
    order (group-major, value-row-major, piece-minor). `bounds` (a shard's
    pack): each group's piece count comes from these (lo, hi) instead of
    its own values."""
    cols = []
    layout = []
    bounds = bounds or group_bounds(groups)
    for (name, arr), (lo, hi) in zip(groups, bounds):
        a = np.asarray(arr, np.int64)
        if a.ndim == 1:
            a = a[None, :]  # [m=1, Dprod]
        n = npieces_i64(lo, hi)
        for row in a:
            cols.append(pieces_host(row, n))  # [Dprod, n]
        layout.append((name, a.shape[0], n))
    pieces = np.concatenate(cols, axis=1) if cols else \
        np.zeros((0, 0), np.int8)
    return pieces, layout


def device_operand(pieces: np.ndarray, device) -> torch.Tensor:
    """int8 [Dprod, K] host pieces -> the resident [pad8(K), pad8(Dprod)]
    int8 operand (transposed, zero-padded: see the module docstring)."""
    D, K = pieces.shape
    out = np.zeros((pad8(K), pad8(D)), np.int8)
    out[:K, :D] = pieces.T
    return torch.from_numpy(out).to(device)


def recombine(dots, layout):
    """int32 dot rows [B, K] -> {name: int64 [B, m] (or [B] where m == 1)}:
    one vectorized shift-sum per group over its pieces."""
    out = {}
    off = 0
    B = dots.shape[0]
    for name, m, n in layout:
        sl = dots[:, off:off + m * n].reshape(B, m, n).to(torch.int64)
        shifts = torch.arange(n, dtype=torch.int64, device=dots.device) * 7
        v = (sl << shifts).sum(dim=-1)
        out[name] = v[:, 0] if m == 1 else v
        off += m * n
    return out


def cube_dots(ind, op):
    """One int8 product: the [B, Dprod] bool (or int8) indicator by a
    resident [Kp, Dp] operand (`device_operand`) -> int32 [B, Kp]. Exact by
    dtype: lane sums <= Dprod * 127 < 2^24 (Dprod <= CUBE_DOM_CAP)."""
    calls["cube_dots"] += 1
    return _dots(ind, op)


def shard_dots(ind, op, n_shards: int, psum):
    """cube_dots of one shard's operand, summed over the mesh's n_shards
    shards by `psum`: exact while n_shards <= MAX_SHARDS."""
    assert n_shards <= MAX_SHARDS, \
        f"cube dots summed over {n_shards} shards exceed MAX_SHARDS " \
        f"({MAX_SHARDS}): int32 lanes must stay below 2^31"
    return psum(cube_dots(ind, op))


def _dots(ind, op):
    B, D = ind.shape
    assert D <= CUBE_DOM_CAP, \
        f"cube product over {D} cells exceeds CUBE_DOM_CAP ({CUBE_DOM_CAP}):" \
        " int32 dot lanes must stay below 2^24"
    Kp, Dp = op.shape
    assert D <= Dp and Kp % 8 == 0 and Dp % 8 == 0, (ind.shape, op.shape)
    a = ind.view(torch.int8) if ind.dtype == torch.bool else ind
    Bp = max(MM_MIN_ROWS, -(-B // 8) * 8)
    if (Bp, Dp) != (B, D):
        a = torch.nn.functional.pad(a, (0, Dp - D, 0, Bp - B))
    return torch._int_mm(a.contiguous(), op.t())[:B]


# -- percentile block histograms (rank-path prefix counts) -------------------

def choose_block(n_rows: int, Dprod: int):
    """Smallest block size whose two-digit [Dprod, 2 * n_rows/G] histogram
    AND its transient build scratch (BLOCK_BUILD_FACTOR x) fit the byte
    budget (smaller G = finer prefix = cheaper lazy window recompute at
    selection), or None."""
    for G in BLOCK_GS:
        if n_rows % G == 0 and \
                BLOCK_BUILD_FACTOR * 2 * (n_rows // G) * Dprod \
                <= CUBE_BLOCK_MEM:
            return G
    return None


def _two_digits(counts, rows: int, Dprod: int):
    """int32 [rows * Dprod] per-(column, cell) counts (each <= G <= 8192)
    -> the resident [pad8(2 rows), pad8(Dprod)] int8 operand: low digits
    (c & 127) in rows [0, rows), high digits (c >> 7) in [rows, 2 rows)."""
    c2 = counts.reshape(rows, Dprod)
    out = torch.zeros(pad8(2 * rows), pad8(Dprod), dtype=torch.int8,
                      device=counts.device)
    out[:rows, :Dprod] = (c2 & 127).to(torch.int8)
    out[rows:2 * rows, :Dprod] = (c2 >> 7).to(torch.int8)
    return out


def build_blockhist(cell_dev, Dprod: int, G: int):
    """One-time device build of the two-digit per-block cell histogram from
    an int32 cell plane over PERMUTED rows (cell < 0 = dropped): an int32
    index_add_ over [NB * Dprod], then the digits. Per-query block counts
    are then counts[b] = dot0[b] + (dot1[b] << 7) from one product."""
    R = cell_dev.shape[0]
    NB = R // G
    blk = torch.arange(R, dtype=torch.int64, device=cell_dev.device) // G
    ok = cell_dev >= 0
    idx = (blk * Dprod + cell_dev.to(torch.int64))[ok]
    counts = torch.zeros(NB * Dprod, dtype=torch.int32,
                         device=cell_dev.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return _two_digits(counts, NB, Dprod)


def block_counts(ind, hist, NB: int):
    """Per-block chain-match counts [B, NB] int32 from the two-digit
    histogram: exact (each dot < 2^24; counts <= G)."""
    calls["block_counts"] += 1
    dots = _dots(ind, hist)
    return dots[:, :NB] + (dots[:, NB:2 * NB] << 7)


def choose_block_ns(n_rows: int, Dprod: int, ns: int):
    """choose_block for per-SLOT block histograms: the [Dprod, ns * 2NB]
    operand (and its BLOCK_BUILD_FACTOR x build scratch) must fit the
    byte budget."""
    for G in BLOCK_GS:
        if n_rows % G == 0 and \
                BLOCK_BUILD_FACTOR * 2 * (n_rows // G) * ns * Dprod \
                <= CUBE_BLOCK_MEM:
            return G
    return None


def build_slot_blockhist(cell_dev, slot_dev, ns: int, Dprod: int, G: int):
    """Device build of the two-digit per-(block, slot) cell histogram (cell
    < 0 or slot < 0 = dropped): the slot_rank analog of build_blockhist.
    Columns are block-major slot-minor, so the counts reshape to [ns, NB]
    with one transpose."""
    R = cell_dev.shape[0]
    NB = R // G
    blk = torch.arange(R, dtype=torch.int64, device=cell_dev.device) // G
    ok = (cell_dev >= 0) & (slot_dev >= 0)
    comp = (blk * ns + slot_dev.clamp(min=0).to(torch.int64)) * Dprod \
        + cell_dev.to(torch.int64)
    idx = comp[ok]
    counts = torch.zeros(NB * ns * Dprod, dtype=torch.int32,
                         device=cell_dev.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return _two_digits(counts, NB * ns, Dprod)


def slot_block_counts(ind, hist, ns: int, NB: int):
    """Per-slot per-block chain-match counts [B, ns, NB] int32 from the
    slot block histogram (exact: counts <= G <= 8192, two digits)."""
    calls["slot_block_counts"] += 1
    M = NB * ns
    dots = _dots(ind, hist)
    c = dots[:, :M] + (dots[:, M:2 * M] << 7)
    return c.reshape(-1, NB, ns).transpose(1, 2)
