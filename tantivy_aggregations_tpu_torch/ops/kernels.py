"""The port's hand-written CUDA kernels (csrc/kernels.cu), their ctypes
bindings, and their plain PyTorch versions.

Each wrapper checks device, dtype, shape and contiguity. A tensor on the
CPU takes the plain version (the CPU tests); a CUDA tensor launches the
kernel, and the wrapper raises if the launch reports an error. There is no
fallback from one to the other. `launches[name]` counts kernel launches,
incremented where the kernel is enqueued and nowhere else; a step captured
as a CUDA graph (aggs/compile.py `_StepGraph`) counts nothing while it is
captured and credits the launches its capture enqueued on every replay.

The shared library is built from the checkout's sources at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a` into build/torch_kernels/
(keyed by the source's hash), then loaded with ctypes.

fused_metrics — replaces the JAX package's ops/pallas_kernels.py
  `fused_metrics` + `_kernel` (13-bit split int32 partials). Bound on the
  H100: HBM bytes, the B mask rows and the plane read once per batch (a
  stride-0 mask counts once), beside 2 int32 ops per (row, query) for
  count and sum and 2 more for min and max. Design (redesigned for
  Hopper): a persistent grid of the resident CTAs walks 4096-row tiles;
  each tile of the plane is staged once in shared memory (cp.async, two
  tiles ahead) and byte-sliced once, and the CTA's warps loop the B
  queries over it, so the plane is read once per batch. Per 4 rows and
  query: three integer ops turn the mask bytes into 0x80 / 0 (nonzero =
  selected), one __dp4a counts them and four __dp4a dot them with the
  byte slices; the 32-bit slice sums are summed across the warp
  (redux.sync) and recombined in int64 once per (tile, query), so no row
  costs an int64 add. min / max only where asked (`minmax`), with the
  DPX three-way __vimin3_s32 / __vimax3_s32. Each CTA writes one partial
  per query into a scratch; a second launch folds them and writes the
  outputs: no fill launch, no atomics. A mask whose rows are one shared
  row (batch stride 0) runs once at B = 1 and its result is written to
  every row.
chain_blocks — replaces `_chain_blocks_batched` / `make_chain_blocks`.
  Bound: one pass over the chain + payload planes and avalid per BATCH
  (HBM bytes), plus per query and row one int32 compare per leaf and one
  add per payload, plus per-query outputs of 4 + 8L bytes per 32 rows.
  Design (redesigned for Hopper): a lane owns one 32-row block and builds
  each query's block mask as a 32-bit word, the op list decoded once per
  (1024-row tile, query); a CTA stages each tile of every plane in shared
  memory with cp.async copies (double-buffered for narrow programs) and
  its warps split the queries; payload blocks are byte-sliced once per
  tile so a lane's masked sum is four __dp4a per 4 rows, recombined
  exactly in int64; a warp stores 32 consecutive counts and sums.
  `chain_plan` sizes the launch (fewer warps where eight param rows
  would not fit). The set opcodes (OP_SET32, OP_SET_WIDE: TermSet / Fuzzy
  / Regex) loop their run slots in `eval_word`, a range compare's word per
  non-empty slot, ORed, and OP_GT_IMM (the multi-valued planes' guards)
  compares a plane with an immediate; the three chain kernels share it,
  and an op list without these runs the kernel instance that carries none
  of their code. A doc-space opcode (a value-row scatter) is refused.
chain_counts — replaces `_chain_counts_batched` / `make_chain_counts`.
  Same bound and kernel, counts only; four lanes' counts fold into one
  128-row group by two shuffles.
chain_slot_counts — replaces `_chain_slot_counts_batched` /
  `make_chain_slot_counts`. Bound: one pass over the chain planes, avalid
  and the static slot plane per batch, plus ns int32 stores per 32 rows per
  query (the [B, ns, R/32] output, most of the bytes at B = 128). Design
  (redesigned for Hopper on chain_blocks' tile kernel): the slot plane is
  staged as one more source of the tile; per tile the CTA builds each
  block's slot words (bit r = row r holds slot s: the TPU kernel's hoisted
  one-hots) in shared memory, 32 slots at a time; per query a lane builds
  its block's mask word once per tile and stores __popc(mask & slot word)
  per slot, so a warp writes 32 consecutive counts per (query, slot).
  Past 32 slots the mask words of up to QWORD_BATCH queries are kept in
  shared memory while the slot chunks loop. `slot_plan` sizes the launch;
  the pointers go by value, as for chain_blocks.
gather_rows — replaces `_gather_rows_batched` / `make_gather_rows`.
  Bound: HBM bytes (each distinct picked row read once, B rows written).
  Design (redesigned for Hopper): one CTA per 16 KB (chunk, query) item,
  items chunk-major, so the CTAs in flight copy one stretch of every
  picked row and a row picked twice is read from L2; four 16-byte
  read-only loads in flight per thread, and streaming (evict-first) stores
  that leave the picked rows in L2. The index stays in device memory, so
  the caller never waits for the card. It copies rows as bytes, whatever
  the operand's dtype. Host side: `RowOperand` checks a resident operand
  once and keeps what a launch needs, so a call on it checks only the
  index, allocates the output and launches.
dense_buckets — replaces the one-hot products of the JAX package's
  ops/reductions.py `dense_bucket_counts_mxu` / `dense_bucket_sum_mxu`.
  Bound: HBM bytes, the bucket-id plane and the payload read once per
  query tile and each mask row once, beside one 32-bit shared-memory
  atomic per (selected row, query, piece). Design (written for Hopper):
  each CTA takes a tile of queries, a tile of buckets and a chunk of
  rows; a lane keeps 16 rows' ids and payloads in registers for
  all the tile's queries and adds each selected row into the CTA's
  table in shared memory, privatized up to 32 ways (lane l into copy
  l % C, copy-minor, so 32 copies never share a bank or an address); a
  sum adds two 16-bit pieces a row, folded into int64 partials every
  65,536 rows at most, so no 32-bit counter overflows and no atomic is
  64-bit. A second launch adds the chunks' partials: no global atomics,
  deterministic, exact. `dense_tile` / `dense_chunks` set the query tile,
  copies, bucket tile, chunks and flush from (B, nb, counts or sums, rows),
  the resident CTAs and the kernel's own layout (`DenseLayout`, read from
  the library): one algorithm for every shape, from c3's B = 1 shared MatchAll row to
  msearch groups of 200 distinct masks and slot planes of PCT_SLOT_CAP
  buckets. The plain versions are ops/reductions.py dense_bucket_counts /
  dense_bucket_sum (`index_add_`).
dense_extremes — replaces the JAX package's ops/reductions.py
  `dense_bucket_min` / `dense_bucket_max` (XLA one-hot reductions, no
  Pallas kernel), which the port ran as int64 `scatter_reduce_` passes.
  Bound: HBM bytes, the bucket-id plane and the payload planes read once
  per query tile and each mask row once. Design (written for Hopper): the
  dense_buckets pass, with a table of 64-bit order-preserving keys (a wide
  (hi, lo) pair's rm value, or a narrow value, with its sign bit flipped):
  a selected row reads its copy's extreme and issues a 64-bit shared
  atomicMin / atomicMax only where it improves on it; the min and the max
  of one payload (or of a multi-valued field's min and max planes) in one
  pass; the table folded once an item, a second launch folding the items.
  `extremes_tile` / `dense_chunks` set the launch as for dense_buckets.
  The plain versions are ops/reductions.py dense_bucket_min /
  dense_bucket_max (over `wide_recon` for a wide pair).

Every launch runs on its operands' device (`_on_device`: that device is
made current for the launch where it is not, so a shard on cuda:1 launches
there). The C launchers keep per-kernel occupancy state, so launches come
one at a time: a mesh's shard threads take turns (parallel/shard.py), and
one Searcher is not to be called from several threads at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops.reductions import (block32_counts, dense_bucket_counts,
                              dense_bucket_max, dense_bucket_min,
                              dense_bucket_sum, shared_row, wide_recon)
from ..query.compile import DOC_SPACE_OPS, OP_SET32, OP_WIDTH, eval_ops

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
_I32 = torch.int32
#: the chain tile kernel's layout (csrc/kernels.cu): 32 blocks of 32 rows
#: per tile, each staged block padded to 36 ints, its avalid to 48 bytes;
#: at most 8 warps per CTA, within the 227 KB of shared memory a CTA gets
TILE_BLOCKS = 32
TILE_ROWS = TILE_BLOCKS * 32
BLOCK_STRIDE = 36
AV_STRIDE = 48
CHAIN_WARPS = 8
SMEM_MAX = 232_448
#: the chain tile kernel's one limit is that shared memory: a stage of its
#: sources (chain planes, then payloads or the slot plane), the op list,
#: chain_slot_counts' words and one warp's param row must fit
#: (`chain_fits`); its source struct holds MAX_SOURCES pointers, the most
#: whose stage fits
MAX_SOURCES = 50
#: a CTA double-buffers its tiles only within a quarter of an SM's 228 KB,
#: so four CTAs (the register limit at 8 warps) stay resident: a second
#: stage of a wide program would halve them, and the resident CTAs' copies
#: already overlap each other's queries
DOUBLE_BUFFER_MAX = 57_344
#: slot count bound of chain_slot_counts (the planner's slot_rank cap)
PCT_SLOT_CAP = 4096
#: chain_slot_counts keeps the slot words of SLOT_CHUNK slots at a time
#: (4 KB), and past one chunk the mask words of up to QWORD_BATCH queries
#: (16 KB), in shared memory
SLOT_CHUNK = 32
QWORD_BATCH = 128
#: the largest gather_rows row, in bytes (the card's edge cases cover it),
#: and the bytes of a row one CTA copies (256 threads x 4 x 16 B); a
#: launch's (chunk, query) items index gridDim.x, so they stay under 2^31
GATHER_ROW_MAX = 1 << 30
GATHER_CHUNK = 256 * 4 * 16

_ROOT = Path(__file__).resolve().parents[2]
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "kernels.cu"
BUILD_DIR = _ROOT / "build" / "torch_kernels"

#: kernel launches per kernel since the last reset_launches() (a graph
#: replay credits those its capture enqueued)
launches = {"fused_metrics": 0, "chain_blocks": 0, "chain_counts": 0,
            "chain_slot_counts": 0, "gather_rows": 0, "dense_buckets": 0,
            "dense_extremes": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def build() -> Path:
    """Compile csrc/kernels.cu for sm_90a (unless this source's library is
    already built) and return the library path. ptxas's register/shared
    memory report is kept beside it as `<lib>.log`."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libtat_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_name(out.name + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tat_fused_metrics.argtypes = [vp, vp, i, ll, i, i, i, vp, vp, vp,
                                          vp, vp, vp]
        lib.tat_fused_metrics_grid.argtypes = [ll, i]
        for fn in (lib.tat_chain_blocks, lib.tat_chain_counts):
            fn.argtypes = [ctypes.POINTER(vp), i, i, vp, i, i, vp, i, vp, ll,
                           i, i, i, i, vp, vp, vp]
        lib.tat_chain_slot_counts.argtypes = [ctypes.POINTER(vp), i, vp, i,
                                              i, vp, i, vp, ll, i, i, i, i,
                                              i, i, vp, vp]
        lib.tat_gather_rows.argtypes = [vp, i, vp, ll, ll, vp, vp]
        lib.tat_dense_buckets_layout.argtypes = [ctypes.POINTER(i)]
        lib.tat_dense_buckets_layout.restype = None
        lib.tat_dense_buckets_resident.argtypes = [i, i]
        lib.tat_dense_buckets.argtypes = [vp, vp, vp, ll, i, i, i, i, i, i,
                                          ll, ll, i, vp, vp, vp]
        lib.tat_dense_extremes_resident.argtypes = [i, i, i]
        lib.tat_dense_extremes.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i,
                                           i, i, i, i, ll, i, i, i, vp, vp,
                                           vp, vp]
        for fn in (lib.tat_fused_metrics, lib.tat_fused_metrics_grid,
                   lib.tat_chain_blocks,
                   lib.tat_chain_counts, lib.tat_chain_slot_counts,
                   lib.tat_gather_rows, lib.tat_dense_buckets_resident,
                   lib.tat_dense_buckets, lib.tat_dense_extremes_resident,
                   lib.tat_dense_extremes):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


class _on_device:
    """Context of one kernel launch: CUDA device `dev` made current where
    it is not, and the previous device restored after."""

    __slots__ = ("dev", "prev")

    def __init__(self, dev: int):
        self.dev = dev

    def __enter__(self):
        cur = torch.cuda.current_device()
        self.prev = None if cur == self.dev else cur
        if self.prev is not None:
            torch.cuda.set_device(self.dev)

    def __exit__(self, *exc):
        if self.prev is not None:
            torch.cuda.set_device(self.prev)


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _route(name: str, tensors) -> bool:
    """True to launch the kernel (all tensors on one CUDA device), False to
    run the plain version (all on the CPU); anything else raises. (Reads
    only `is_cuda` / `get_device()` on the way through: a `.device` object
    costs more host time than the B = 1 kernel.)"""
    t0 = tensors[0]
    if t0.is_cuda:
        dev = t0.get_device()
        if all(t.is_cuda and t.get_device() == dev for t in tensors):
            return True
    elif all(t.is_cpu for t in tensors):
        return False
    devs = sorted({str(t.device) for t in tensors})
    if len(devs) > 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    raise ValueError(f"{name}: unsupported device {devs[0]}")


def _need(cond: bool, name: str, what) -> None:
    """Raise ValueError(name: what) unless cond; `what` is a message or a
    function that makes it (formatted only on failure: the checks run on
    every launch)."""
    if not cond:
        raise ValueError(f"{name}: {what() if callable(what) else what}")


# ---------------------------------------------------------------------------
# fused_metrics
# ---------------------------------------------------------------------------

def fused_metrics_plain(mask, plane, minmax: bool = True):
    """(count i64 [B], sum i64 [B], min i32 [B], max i32 [B]) of a masked
    int32 plane; empty masks give the I32_MAX / I32_MIN sentinels; min and
    max are None unless `minmax`."""
    m = mask.to(torch.bool)
    cnt = m.sum(dim=-1, dtype=torch.int64)
    tot = torch.where(m, plane, 0).sum(dim=-1, dtype=torch.int64)
    if not minmax:
        return cnt, tot, None, None
    mn = torch.where(m, plane, I32_MAX).amin(dim=-1)
    mx = torch.where(m, plane, I32_MIN).amax(dim=-1)
    return cnt, tot, mn, mx


@functools.lru_cache(maxsize=None)
def _fused_grid(dev: int, T: int, minmax: bool) -> int:
    """CTAs of fused_metrics' tile kernel over T rows on CUDA device `dev`
    (its resident CTAs, at most one per tile)."""
    with torch.cuda.device(dev):
        return _library().tat_fused_metrics_grid(T, int(minmax))


def fused_metrics(mask, plane, minmax: bool = True):
    """mask: bool/int8/uint8 [B, T] (nonzero = selected), its rows T apart
    or all one row (batch stride 0, as `expand` makes it); plane: int32
    [T]; T % 4 == 0 (loader-padded). Returns fused_metrics_plain's tuple.
    A stride-0 mask is run once, at B = 1, and its results are written to
    all B rows."""
    name = "fused_metrics"
    _need(mask.dim() == 2 and plane.dim() == 1
          and mask.shape[1] == plane.shape[0], name,
          lambda: f"shapes {tuple(mask.shape)} / {tuple(plane.shape)}")
    _need(mask.dtype in (torch.bool, torch.int8, torch.uint8), name,
          lambda: f"mask dtype {mask.dtype}")
    _need(plane.dtype == torch.int32, name,
          lambda: f"plane dtype {plane.dtype}")
    B, T = mask.shape
    mask, rep = shared_row(mask)
    if not _route(name, (mask, plane)):
        out = fused_metrics_plain(mask, plane, minmax)
        if rep == 1:
            return out
        return tuple(None if x is None else x.expand(rep).contiguous()
                     for x in out)
    Bq = mask.shape[0]
    _need(T % 4 == 0 and 0 < T <= I32_MAX and Bq > 0, name,
          lambda: f"shape {(B, T)}")
    _need(mask.is_contiguous() and plane.is_contiguous(), name,
          "mask rows must be T apart (or one shared row) and the plane "
          "contiguous")
    # the kernel reads the plane with 16-byte copies and the mask in words
    _need(plane.data_ptr() % 16 == 0 and mask.data_ptr() % 4 == 0, name,
          "plane must be 16-byte and mask 4-byte aligned")
    grid = _fused_grid(plane.get_device(), T, minmax)
    Bo = Bq * rep
    rows = 3 if minmax else 2
    # one allocation: counts, sums (and mins | maxes) [Bo] each, then the
    # scratch of Bq * grid partials (20 or 12 bytes each)
    part = -(-Bq * grid * (20 if minmax else 12) // 8)
    buf = plane.new_empty(rows * Bo + part, dtype=torch.int64)
    base = buf.data_ptr()
    with _on_device(plane.get_device()):
        rc = _library().tat_fused_metrics(
            mask.data_ptr(), plane.data_ptr(), Bq, T, grid, rep, int(minmax),
            base + 8 * rows * Bo, base, base + 8 * Bo, base + 16 * Bo,
            base + 20 * Bo, _stream(plane))
        launches[name] += 1
    _check_launch(name, rc)
    if not minmax:
        cnt, tot, _ = buf.split_with_sizes((Bo, Bo, part))
        return cnt, tot, None, None
    cnt, tot, mm, _ = buf.split_with_sizes((Bo, Bo, Bo, part))
    mn, mx = mm.view(torch.int32).split(Bo)
    return cnt, tot, mn, mx


# ---------------------------------------------------------------------------
# chain_blocks / chain_counts
# ---------------------------------------------------------------------------

def _chain_mask_plain(pmat, ops, planes, avalid):
    """[B, R] bool chain mask: the mask program over the planes, AND the
    layout's alive & valid plane."""
    R = avalid.shape[0]
    host = getattr(ops, "host_ops", None)
    m = eval_ops(ops.cpu().numpy() if host is None else host, planes, pmat,
                 (R,))
    return m & (avalid > 0)


def chain_blocks_plain(pmat, ops, planes, avalid, payloads):
    B = pmat.shape[0]
    R = avalid.shape[0]
    m = _chain_mask_plain(pmat, ops, planes, avalid)
    counts = block32_counts(m)
    sums = torch.empty(B, len(payloads), R // 32, dtype=torch.int64,
                       device=avalid.device)
    for j, pay in enumerate(payloads):
        sums[:, j] = torch.where(m, pay, 0).reshape(B, R // 32, 32).sum(
            dim=-1, dtype=torch.int64)
    return counts, sums


def chain_counts_plain(pmat, ops, planes, avalid):
    B = pmat.shape[0]
    R = avalid.shape[0]
    m = _chain_mask_plain(pmat, ops, planes, avalid)
    return m.reshape(B, R // 128, 128).sum(dim=-1, dtype=torch.int32)


def _check_chain(name, pmat, ops, planes, avalid, payloads, group):
    R = avalid.shape[0] if avalid.dim() == 1 else -1
    _need(pmat.dim() == 2 and pmat.dtype is _I32, name,
          lambda: f"pmat {tuple(pmat.shape)} {pmat.dtype}")
    _need(ops.dim() == 2 and ops.shape[1] == OP_WIDTH and ops.dtype is _I32,
          name, lambda: f"ops {tuple(ops.shape)}")
    _need(avalid.dtype is torch.int8 and R > 0 and R % group == 0, name,
          lambda: f"avalid {tuple(avalid.shape)} {avalid.dtype}")
    _need(not _doc_space(ops), name,
          "the op list holds a doc-space opcode (a value-row scatter), "
          "which no layout view evaluates")
    for t in (*planes, *payloads):
        if t.dtype is not _I32 or t.shape != (R,):
            raise ValueError(f"{name}: plane {tuple(t.shape)} {t.dtype}")
    return R


def _stage_bytes(n_src: int) -> int:
    """Shared-memory bytes of one stage: a tile of n_src sources and its
    avalid bytes."""
    return n_src * TILE_BLOCKS * BLOCK_STRIDE * 4 + TILE_BLOCKS * AV_STRIDE


def _slot_word_bytes(ns: int, qb: int) -> int:
    """chain_slot_counts' words in shared memory: one chunk of slot words
    and, where ns spans several chunks, the mask words of qb queries."""
    return (SLOT_CHUNK + (qb if ns > SLOT_CHUNK else 0)) * 32 * 4


def chain_fits(n_planes: int, n_aux: int, n_ops: int, P: int,
               ns: int = 0) -> bool:
    """True when the chain tile kernel takes a mask program of n_ops ops
    and P params over n_planes planes with n_aux payloads (chain_blocks)
    or, with ns slots, the slot plane (chain_slot_counts), at every batch
    size: one stage of its sources, the op list, the slot words and one
    warp's param row fit SMEM_MAX (chain_plan keeps fewer warps where
    eight param rows would not)."""
    n_src = n_planes + n_aux
    extra = _slot_word_bytes(ns, QWORD_BATCH) if ns else 0
    return (n_src <= MAX_SOURCES
            and _stage_bytes(n_src) + n_ops * OP_WIDTH * 4 + extra
            + max(P, 1) * 4 <= SMEM_MAX)


@functools.lru_cache(maxsize=None)
def chain_plan(n_planes: int, n_pay: int, n_ops: int, P: int, B: int,
               extra: int = 0):
    """Launch shape of the chain tile kernel: (warps, stages, shared-memory
    bytes). A stage holds one tile (TILE_ROWS rows) of every chain plane and
    payload plus its avalid bytes; two stages double-buffer the copies when
    they fit in DOUBLE_BUFFER_MAX beside the op list, each warp's param row
    and `extra` bytes (slot_plan's words), else one. The warps share each
    tile and split the B queries, so there are no more warps than queries,
    and no more than fit their param rows beside one stage in SMEM_MAX."""
    stage = _stage_bytes(n_planes + n_pay)
    base = n_ops * OP_WIDTH * 4 + extra
    warps = max(1, min(CHAIN_WARPS, B))
    while warps > 1 and stage + base + warps * P * 4 > SMEM_MAX:
        warps -= 1
    fixed = base + warps * P * 4
    stages = 2 if 2 * stage + fixed <= DOUBLE_BUFFER_MAX else 1
    return warps, stages, stages * stage + fixed


@functools.lru_cache(maxsize=None)
def slot_plan(n_planes: int, n_ops: int, P: int, B: int, ns: int):
    """Launch shape of chain_slot_counts' tile kernel: (warps, stages, qb,
    shared-memory bytes). chain_plan's, with the slot plane as one more
    source, plus one chunk of slot words (SLOT_CHUNK x 32 x 4 bytes) and,
    where ns spans several chunks, the mask words of qb = min(B,
    QWORD_BATCH) queries at a time (qb = B otherwise, nothing kept)."""
    qb = B if ns <= SLOT_CHUNK else min(B, QWORD_BATCH)
    warps, stages, smem = chain_plan(n_planes, 1, n_ops, P, B,
                                     _slot_word_bytes(ns, qb))
    return warps, stages, qb, smem


def _has_sets(ops) -> bool:
    """Whether an op list holds an opcode of the kernels' extended set
    (set loops, OP_GT_IMM): the flag `ops_tensor` keeps on the tensors it
    makes (so the main path never reads its op list back), else read from
    the tensor."""
    flag = getattr(ops, "has_sets", None)
    return bool((ops[:, 0] >= OP_SET32).any()) if flag is None else flag


def _doc_space(ops) -> bool:
    """Whether an op list holds a doc-space opcode (DOC_SPACE_OPS): the
    flag `ops_tensor` keeps, else read from the tensor."""
    flag = getattr(ops, "doc_space", None)
    if flag is None:
        return bool(np.isin(ops[:, 0].cpu().numpy(), DOC_SPACE_OPS).any())
    return flag


def _chain_sources(name, pmat, ops, planes, avalid, aux, ns=0):
    """Checks of the chain tile kernel's operands; returns the host array
    of source pointers (the planes, then `aux`: payloads or the slot plane)
    that the C launcher copies into the kernel's parameter struct."""
    _need(chain_fits(len(planes), len(aux), ops.shape[0], pmat.shape[1],
                     ns), name,
          lambda: f"{len(planes)} planes / {len(aux)} payloads or slot "
          f"planes / {ops.shape[0]} ops / {pmat.shape[1]} params exceed the "
          "kernel's shared memory")
    _need(pmat.is_contiguous() and ops.is_contiguous()
          and avalid.is_contiguous()
          and all(t.is_contiguous() for t in (*planes, *aux)), name,
          "operands must be contiguous")
    ptrs = [t.data_ptr() for t in (*planes, *aux)]
    # the kernel stages every source with 16-byte copies
    _need(avalid.data_ptr() % 16 == 0 and all(p % 16 == 0 for p in ptrs),
          name, "planes, payloads, slot plane and avalid must be 16-byte "
          "aligned")
    return (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)


def _launch_chain(name, fn, pmat, ops, planes, avalid, payloads, out):
    """chain_blocks' or chain_counts' launch: the plane and payload pointers
    go by value."""
    srcs = _chain_sources(name, pmat, ops, planes, avalid, payloads)
    B, P = pmat.shape
    n_ops = ops.shape[0]
    warps, stages, smem = chain_plan(len(planes), len(payloads), n_ops, P, B)
    counts, sums = out
    with _on_device(avalid.get_device()):
        rc = fn(srcs, len(planes), len(payloads), pmat.data_ptr(), B, P,
                ops.data_ptr(), n_ops, avalid.data_ptr(),
                avalid.shape[0] // 32, warps, stages, smem,
                int(_has_sets(ops)), counts.data_ptr(),
                0 if sums is None else sums.data_ptr(), _stream(avalid))
        launches[name] += 1
    _check_launch(name, rc)


def chain_blocks(pmat, ops, planes, avalid, payloads):
    """Per query b of pmat [B, P] int32: the mask program `ops` ([n, 8]
    int32) over `planes` (int32 [R] each) AND avalid (int8 [R]) ->
    (counts int32 [B, R/32], sums int64 [B, L, R/32]) per 32-row block, the
    sums over the int32 `payloads` [R]."""
    name = "chain_blocks"
    R = _check_chain(name, pmat, ops, planes, avalid, payloads, 32)
    if not _route(name, (pmat, ops, avalid, *planes, *payloads)):
        return chain_blocks_plain(pmat, ops, planes, avalid, payloads)
    B, G = pmat.shape[0], R // 32
    counts = torch.empty(B, G, dtype=torch.int32, device=avalid.device)
    sums = torch.empty(B, len(payloads), G, dtype=torch.int64,
                       device=avalid.device)
    _launch_chain(name, _library().tat_chain_blocks, pmat, ops, planes,
                  avalid, payloads, (counts, sums))
    return counts, sums


def chain_counts(pmat, ops, planes, avalid):
    """Per query: matched rows of the chain mask (as chain_blocks) in each
    128-row group -> int32 [B, R/128]."""
    name = "chain_counts"
    R = _check_chain(name, pmat, ops, planes, avalid, (), 128)
    if not _route(name, (pmat, ops, avalid, *planes)):
        return chain_counts_plain(pmat, ops, planes, avalid)
    counts = torch.empty(pmat.shape[0], R // 128, dtype=torch.int32,
                         device=avalid.device)
    _launch_chain(name, _library().tat_chain_counts, pmat, ops, planes,
                  avalid, (), (counts, None))
    return counts


def chain_slot_counts_plain(pmat, ops, planes, avalid, slot, ns):
    B = pmat.shape[0]
    R = avalid.shape[0]
    m = _chain_mask_plain(pmat, ops, planes, avalid)
    counts = torch.empty(B, ns, R // 32, dtype=torch.int32,
                         device=avalid.device)
    for s in range(ns):
        counts[:, s] = (m & (slot == s)).reshape(B, R // 32, 32).sum(
            dim=-1, dtype=torch.int32)
    return counts


def chain_slot_counts(pmat, ops, planes, avalid, slot, ns: int):
    """Per query: matched rows of the chain mask (as chain_blocks) in each
    32-row block, split by the static int32 slot plane `slot` [R] (values
    in [0, ns); -1 = no slot) -> int32 [B, ns, R/32]."""
    name = "chain_slot_counts"
    R = _check_chain(name, pmat, ops, planes, avalid, (), 32)
    _need(slot.dim() == 1 and slot.shape[0] == R
          and slot.dtype == torch.int32, name,
          lambda: f"slot {tuple(slot.shape)} {slot.dtype}")
    _need(0 < ns <= PCT_SLOT_CAP, name,
          lambda: f"ns {ns} outside (0, {PCT_SLOT_CAP}]")
    if not _route(name, (pmat, ops, avalid, slot, *planes)):
        return chain_slot_counts_plain(pmat, ops, planes, avalid, slot, ns)
    srcs = _chain_sources(name, pmat, ops, planes, avalid, (slot,), ns)
    B, P = pmat.shape
    n_ops = ops.shape[0]
    warps, stages, qb, smem = slot_plan(len(planes), n_ops, P, B, ns)
    counts = torch.empty(B, ns, R // 32, dtype=torch.int32,
                         device=avalid.device)
    with _on_device(avalid.get_device()):
        rc = _library().tat_chain_slot_counts(
            srcs, len(planes), pmat.data_ptr(), B, P, ops.data_ptr(), n_ops,
            avalid.data_ptr(), R // 32, warps, stages, smem,
            int(_has_sets(ops)), ns, qb, counts.data_ptr(), _stream(avalid))
        launches[name] += 1
    _check_launch(name, rc)
    return counts


# ---------------------------------------------------------------------------
# gather_rows
# ---------------------------------------------------------------------------

class RowOperand:
    """A gather_rows operand checked once: a contiguous tensor [Df, ...] of
    any dtype whose rows are a positive multiple of 16 bytes (at most
    GATHER_ROW_MAX) and, on the card, 16-byte aligned. It keeps what a
    launch needs (its device, the kernel's entry point, and the pointer,
    row count and 16-byte words per row as ctypes arguments), so that a
    gather_rows call on it checks only the index. aggs/compile.py builds
    one per resident member operand at plan time; the tensor must not be
    resized or moved while its RowOperand is in use."""

    __slots__ = ("op", "cuda", "dev", "tail", "chunks", "fn", "args")

    def __init__(self, op: torch.Tensor):
        name = "gather_rows"
        shape = op.shape
        _need(len(shape) >= 2 and shape[0] > 0, name,
              lambda: f"operand {tuple(shape)}")
        row_bytes = op.nbytes // shape[0]
        _need(row_bytes % 16 == 0 and 0 < row_bytes <= GATHER_ROW_MAX, name,
              lambda: f"row of {row_bytes} bytes is not a positive multiple "
              f"of 16 up to {GATHER_ROW_MAX}")
        _need(op.is_contiguous(), name, "operands must be contiguous")
        self.op = op
        self.cuda = _route(name, (op,))
        self.dev = op.get_device()
        self.tail = tuple(shape[1:])
        self.chunks = -(-row_bytes // GATHER_CHUNK)
        self.fn = self.args = None
        if self.cuda:
            _need(op.data_ptr() % 16 == 0, name,
                  "operand must be 16-byte aligned")
            self.fn = _library().tat_gather_rows
            self.args = (ctypes.c_void_p(op.data_ptr()),
                         ctypes.c_longlong(shape[0]),
                         ctypes.c_longlong(row_bytes // 16))


def gather_rows_plain(idx, op):
    if type(op) is RowOperand:
        op = op.op
    return op.index_select(0, idx)


def gather_rows(idx, op):
    """Rows `idx` (int32 [B], each in [0, Df)) of the operand `op` [Df, ...]
    -> [B, ...] of op's dtype. `op` is a RowOperand, or a tensor that is
    checked as one on this call."""
    name = "gather_rows"
    h = op if type(op) is RowOperand else RowOperand(op)
    _need(idx.dim() == 1 and idx.dtype is _I32 and idx.is_contiguous(), name,
          lambda: f"idx {tuple(idx.shape)} {idx.dtype} is not a contiguous "
          "int32 [B]")
    if not (h.cuda and idx.is_cuda and idx.get_device() == h.dev):
        _route(name, (idx, h.op))  # raises unless both lie on the CPU
        return gather_rows_plain(idx, h.op)
    B = idx.shape[0]
    _need(0 < B and h.chunks * B <= I32_MAX, name,
          lambda: f"batch of {B} rows of {h.chunks} chunks")
    out = h.op.new_empty((B, *h.tail))
    with _on_device(h.dev):
        rc = h.fn(idx.data_ptr(), B, *h.args, out.data_ptr(), _stream(idx))
        launches[name] += 1
    _check_launch(name, rc)
    return out


# ---------------------------------------------------------------------------
# dense_buckets
# ---------------------------------------------------------------------------

def dense_buckets_plain(mask, bid, nb: int, payload=None):
    """[B, nb] int64: per query, the rows whose mask byte is nonzero
    counted per bucket of the int32 bucket-id plane `bid` (ids outside
    [0, nb) match nothing), or with `payload` the int32 payload summed
    over them (ops/reductions.py dense_bucket_counts / dense_bucket_sum)."""
    m = mask.to(torch.bool)
    if payload is None:
        return dense_bucket_counts(bid, m, nb)
    return dense_bucket_sum(bid, m, payload, nb)


class DenseLayout(NamedTuple):
    """dense_buckets' layout, as csrc/kernels.cu defines it: the rows a CTA
    step covers, the most rows a sum's 16-bit pieces are added over before
    a fold, the most copies of a table and a table's most bytes."""
    step: int
    flush_rows: int
    copies: int
    table_bytes: int


def dense_tile(B: int, nb: int, sums: bool, lay: DenseLayout):
    """(qt, C, nbt) of a dense_buckets launch over B queries and nb
    buckets (sums: two 32-bit counters a bucket, counts: one): the
    buckets per tile (all of them unless one query's table would exceed
    the layout's table bytes), the queries per tile (as many as fit one
    copy each), then the most copies C (a power of two up to the
    layout's) that fit them."""
    return _tile(B, nb, 8 if sums else 4, lay)


def _tile(B: int, nb: int, word: int, lay: DenseLayout):
    """(qt, C, nbt) of a table of `word` bytes a (query, bucket, copy)."""
    nbt = min(nb, lay.table_bytes // word)
    qt = min(B, lay.table_bytes // (word * nbt))
    C = lay.copies
    while C > 1 and qt * nbt * word * C > lay.table_bytes:
        C //= 2
    return qt, C, nbt


def extremes_tile(B: int, nb: int, ne: int, lay: DenseLayout):
    """(qt, C, nbt) of a dense_extremes launch over B queries and nb
    buckets with ne extremes (min, max or both): dense_tile's choice for a
    64-bit word per extreme a bucket."""
    return _tile(B, nb, 8 * ne, lay)


def dense_chunks(T: int, items: int, resident: int, sums: bool,
                 lay: DenseLayout):
    """(n_rc, chunk, flush) of a dense_buckets launch over T rows whose
    (query tile, bucket tile) pairs are `items`: the rows cut into n_rc
    chunks of whole steps so that items x n_rc is about the card's
    `resident` CTAs (at least one chunk per item), and the rows a CTA adds
    before folding its table (a sum: at most the layout's flush rows, so
    no 32-bit piece counter overflows; counts: the chunk)."""
    steps = -(-T // lay.step)
    want = max(1, min(steps, -(-resident // items)))
    chunk = -(-steps // want) * lay.step
    flush = min(chunk, lay.flush_rows) if sums else chunk
    return -(-T // chunk), chunk, flush


@functools.lru_cache(maxsize=None)
def _dense_layout() -> DenseLayout:
    out = (ctypes.c_int * 4)()
    _library().tat_dense_buckets_layout(out)
    return DenseLayout(*out)


@functools.lru_cache(maxsize=None)
def _dense_resident(dev: int, sums: bool, smem: int) -> int:
    """Resident CTAs of dense_buckets' tile kernel on CUDA device `dev`."""
    with torch.cuda.device(dev):
        return _library().tat_dense_buckets_resident(int(sums), smem)


def dense_buckets(mask, bid, nb: int, payload=None):
    """mask: bool/int8/uint8 [B, T] (nonzero = selected), its rows T apart
    or all one row (batch stride 0, as `expand` makes it); bid: int32 [T]
    static bucket ids; payload: None (counts) or an int32 [T] static
    payload (sums).
    Returns dense_buckets_plain's [B, nb] int64. A stride-0 mask is run
    once, at B = 1, and its row is broadcast (an `expand` view)."""
    name = "dense_buckets"
    _need(mask.dim() == 2 and bid.dim() == 1
          and mask.shape[1] == bid.shape[0]
          and (payload is None or payload.shape == bid.shape), name,
          lambda: f"shapes {tuple(mask.shape)} / {tuple(bid.shape)} / "
          f"{None if payload is None else tuple(payload.shape)}")
    _need(mask.dtype in (torch.bool, torch.int8, torch.uint8), name,
          lambda: f"mask dtype {mask.dtype}")
    _need(bid.dtype is _I32 and (payload is None or payload.dtype is _I32),
          name, lambda: f"bid {bid.dtype}, payload "
          f"{None if payload is None else payload.dtype}")
    _need(bid.is_contiguous()
          and (payload is None or payload.is_contiguous()), name,
          "the bucket-id plane and the payload must be contiguous")
    _need(nb >= 1, name, lambda: f"nb {nb}")
    mask, rep = shared_row(mask)
    if not _route(name, (mask, bid) if payload is None
                  else (mask, bid, payload)):
        out = dense_buckets_plain(mask, bid, nb, payload)
        return out if rep == 1 else out.expand(rep, nb)
    Bq, T = mask.shape
    _need(0 < T <= I32_MAX and Bq > 0, name, lambda: f"shape {(Bq, T)}")
    mask = mask.contiguous()
    sums = payload is not None
    lay = _dense_layout()
    qt, C, nbt = dense_tile(Bq, nb, sums, lay)
    dev = bid.get_device()
    resident = _dense_resident(dev, sums, qt * nbt * (8 if sums else 4) * C)
    n_rc, chunk, flush = dense_chunks(T, -(-Bq // qt) * -(-nb // nbt),
                                      resident, sums, lay)
    pay = 0 if payload is None else payload.data_ptr()
    vec = (T % 4 == 0 and bid.data_ptr() % 16 == 0 and pay % 16 == 0
           and mask.data_ptr() % 4 == 0)
    # one allocation: the [Bq, nb] output, then the chunks' partials
    n_out = Bq * nb
    buf = bid.new_empty(n_out * (1 + n_rc), dtype=torch.int64)
    base = buf.data_ptr()
    with _on_device(dev):
        rc = _library().tat_dense_buckets(
            mask.data_ptr(), bid.data_ptr(), pay, T, Bq, nb, qt, C, nbt,
            n_rc, chunk, flush, int(vec), base + 8 * n_out, base,
            _stream(bid))
        launches[name] += 1
    _check_launch(name, rc)
    out = buf[:n_out].view(Bq, nb)
    return out if rep == 1 else out.expand(rep, nb)


# ---------------------------------------------------------------------------
# dense_extremes
# ---------------------------------------------------------------------------

def dense_extremes_plain(mask, bid, nb: int, min_planes=None,
                         max_planes=None):
    """(min, max) [B, nb] per bucket of the int32 bucket-id plane `bid`
    (ids outside [0, nb) match nothing) over the rows whose mask byte is
    nonzero, None where not asked: of an int32 plane (`(w,)`: int32, I32_MAX
    / I32_MIN for an empty bucket) or of a wide pair (`(hi, lo)`: int64 in
    the rm domain, I64_MAX / I64_MIN) — ops/reductions.py dense_bucket_min /
    dense_bucket_max over `w` or `wide_recon(hi, lo)`."""
    m = mask.to(torch.bool)

    def red(planes, fn):
        if planes is None:
            return None
        v = planes[0] if len(planes) == 1 else wide_recon(*planes)
        return fn(bid, m, v, nb)
    return red(min_planes, dense_bucket_min), red(max_planes,
                                                  dense_bucket_max)


@functools.lru_cache(maxsize=None)
def _extremes_resident(dev: int, wide: bool, sep: bool, smem: int) -> int:
    """Resident CTAs of dense_extremes' tile kernel on CUDA device `dev`."""
    with torch.cuda.device(dev):
        return _library().tat_dense_extremes_resident(int(wide), int(sep),
                                                      smem)


def dense_extremes(mask, bid, nb: int, min_planes=None, max_planes=None):
    """mask: bool/int8/uint8 [B, T] (nonzero = selected), its rows T apart
    or all one row (batch stride 0, as `expand` makes it); bid: int32 [T]
    static bucket ids; min_planes, max_planes: None, or the static payload
    of that extreme as a tuple of contiguous int32 [T] planes, `(w,)` or a
    wide `(hi, lo)` (both of one width; the same planes or, for a
    multi-valued field, its min's and its max's).
    Returns dense_extremes_plain's (min, max). A stride-0 mask is run once,
    at B = 1, and its rows are broadcast (`expand` views)."""
    name = "dense_extremes"
    asked = [p for p in (min_planes, max_planes) if p is not None]
    _need(len(asked) > 0, name, "neither a min nor a max asked")
    width = len(asked[0])
    _need(width in (1, 2) and all(len(p) == width for p in asked), name,
          lambda: f"payload widths {[len(p) for p in asked]}")
    planes = [t for p in asked for t in p]
    _need(mask.dim() == 2 and bid.dim() == 1
          and mask.shape[1] == bid.shape[0]
          and all(t.shape == bid.shape for t in planes), name,
          lambda: f"shapes {tuple(mask.shape)} / {tuple(bid.shape)} / "
          f"{[tuple(t.shape) for t in planes]}")
    _need(mask.dtype in (torch.bool, torch.int8, torch.uint8), name,
          lambda: f"mask dtype {mask.dtype}")
    _need(bid.dtype is _I32 and all(t.dtype is _I32 for t in planes), name,
          lambda: f"bid {bid.dtype}, payload {[t.dtype for t in planes]}")
    _need(bid.is_contiguous() and all(t.is_contiguous() for t in planes),
          name, "the bucket-id plane and the payload must be contiguous")
    _need(nb >= 1, name, lambda: f"nb {nb}")
    mask, rep = shared_row(mask)
    if not _route(name, (mask, bid, *planes)):
        out = dense_extremes_plain(mask, bid, nb, min_planes, max_planes)
        return tuple(x if x is None or rep == 1 else x.expand(rep, nb)
                     for x in out)
    Bq, T = mask.shape
    _need(0 < T <= I32_MAX and Bq > 0, name, lambda: f"shape {(Bq, T)}")
    mask = mask.contiguous()
    wide = width == 2
    do_min, do_max = min_planes is not None, max_planes is not None
    ne = len(asked)
    # the max reads planes of its own only where they differ from the min's
    sep = ne == 2 and any(a.data_ptr() != b.data_ptr()
                          for a, b in zip(min_planes, max_planes))
    p0 = [t.data_ptr() for t in asked[0]] + [0] * (2 - width)
    p1 = ([t.data_ptr() for t in max_planes] + [0] * (2 - width) if sep
          else [0, 0])
    lay = _dense_layout()
    qt, C, nbt = extremes_tile(Bq, nb, ne, lay)
    dev = bid.get_device()
    resident = _extremes_resident(dev, wide, sep, qt * nbt * 8 * ne * C)
    n_rc, chunk, _ = dense_chunks(T, -(-Bq // qt) * -(-nb // nbt), resident,
                                  False, lay)
    vec = (T % 4 == 0 and mask.data_ptr() % 4 == 0
           and all(p % 16 == 0 for p in (bid.data_ptr(), *p0, *p1)))
    # one allocation: the outputs ([ne, Bq, nb], int64 or int32), then the
    # items' keys [ne, Bq, nb, n_rc]
    n_out = Bq * nb
    buf = bid.new_empty(ne * n_out * (1 + n_rc), dtype=torch.int64)
    base = buf.data_ptr()
    obytes = 8 if wide else 4
    outs = buf[:ne * n_out] if wide else buf[:ne * n_out].view(_I32)
    with _on_device(dev):
        rc = _library().tat_dense_extremes(
            mask.data_ptr(), bid.data_ptr(), *p0, *p1, T, Bq, nb, qt, C,
            nbt, n_rc, chunk, int(vec), int(do_min), int(do_max),
            base + 8 * ne * n_out, base if do_min else 0,
            base + obytes * n_out * do_min if do_max else 0, _stream(bid))
        launches[name] += 1
    _check_launch(name, rc)

    def out(e):
        o = outs[e * n_out:(e + 1) * n_out].view(Bq, nb)
        return o if rep == 1 else o.expand(rep, nb)
    return (out(0) if do_min else None,
            out(int(do_min)) if do_max else None)


def ops_tensor(ops: np.ndarray, device) -> torch.Tensor:
    """A mask program's op list as the [n, OP_WIDTH] int32 operand, with
    its `has_sets` flag (an opcode of the extended set) and `doc_space`
    flag (a doc-space opcode) read here, on the host, and the host op list
    itself (`host_ops`, what the plain versions interpret): a launch or a
    plain run on it reads nothing back, so a captured step cannot sync."""
    ops = np.ascontiguousarray(ops, np.int32)
    t = torch.from_numpy(ops).to(device)
    t.has_sets = bool((ops[:, 0] >= OP_SET32).any())
    t.doc_space = bool(np.isin(ops[:, 0], DOC_SPACE_OPS).any())
    t.host_ops = ops
    return t
