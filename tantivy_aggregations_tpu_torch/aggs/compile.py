"""Agg-tree compiler: IR -> a batch-first torch program + host harvest.

The port of the JAX package's aggs/compile.py. `plan` resolves fields and
picks an execution MODE per node from static index metadata (the choices
the JAX package makes under the same EngineConfig, its Pallas gate on and
unsharded: the value-domain cube (`use_cube`), the dense products
(`dense_mxu`) and member operands (`use_member_ops`) on by default);
`raw_fn(pmat, arrays)` is the device step (JAX `Program.raw_fn`): the
whole tree for a [B, P] int32 param matrix — one row per query of an
msearch group, a single query is B = 1 — over the resident arrays, with
torch ops, the five CUDA kernels of ops/kernels.py and the matrix
products of ops/cube.py and ops/reductions.py; the copied `harvest`
reconstructs exact user-domain fruits (bit-identical to the oracle).

On the card the step runs as JAX runs its jitted one: `submit_many`
captures `raw_fn` as one CUDA graph per padded batch size at its first
use (`_StepGraph`; JAX jits at first use) and replays it on every later
call, so a call costs one param copy and one graph launch; phase 2's
selection in `finalize_many` replays one graph per node and padded batch
(`_phase2_replayed`; JAX's jitted `_lazy_phase2`), and a mesh whose
shards share one card captures its S shard bodies and their collectives
as one graph (`ShardedProgram`; JAX's `shard_map` under `jax.jit`). On
the CPU `submit_many` calls `raw_fn` itself and phase 2 selects eagerly.
The plan records the mode (`plan["graph"]`): captured, except on a mesh
over two or more cards (`mesh_graph_mode`, with its reason), whose shard
threads run eagerly.

The plan does not depend on the device: a program on CPU tensors plans and
runs exactly the modes the card runs (the kernels' plain versions execute
them there). A mode is chosen at plan time and recorded in the plan dict.

Modes:
- value-domain CUBE (ops/cube.py, `use_cube`): where the chain's fields
  are single-valued narrow / stringy columns whose product domain is small
  and the chain has a param, root/filter-scope counts and metrics
  (p["cube"]), root-level dense histogram / terms with Count/Sum/Avg subs
  (p["cube"] on the bucket node), integer-percent rank percentiles
  (p["pcube"]: per-block counts from a device-built block histogram) and
  slot_rank percentiles (p["scube"]) answer from [Dprod]-cell
  pre-aggregates: one indicator per (factors, chain) evaluated by the mask
  program over virtual domain planes, then int8 products. No row pass.
- metrics at the root or under filters (MaskCtx): narrow single-valued
  planes through the fused_metrics kernel; wide planes by exact torch
  reductions; multi-valued fields reduce static per-doc pre-aggregates;
  limb and pre-aggregate sums as one dense product (p["dense_mm"],
  `dense_mxu`).
- histogram / terms ("dense", and "scatter" for nested nodes past the
  dense budget — the same integer index_add_ in torch): per-query bucket
  reductions over STATIC bucket-id planes (nested buckets compose static
  slot ids; only validity is per query). A dense node right under the
  root or a filter, and the count and metric subs directly under it, run
  as the dense_buckets kernel (p["dense_mm"]: ops/reductions.py
  dense_bucket_*_mm, `dense_mxu`) over the static bucket plane and the
  payloads at its rows, each a resident contiguous int32 plane. An f64
  histogram's buckets span its column's [min, max], except where that
  passes MAX_HIST_NB buckets and the root query bounds the field by a
  range: they then span the range (`_range_layout`), whose bounds
  select the program in the searcher, and the bucket plane is built on
  the device and held by the program alone (`_range_bucket_ids`). The
  JAX package answers such a shape on its host path.
- high-cardinality root-level terms / histograms ("prefix"): bucket-sorted
  OrderedLayout scanned by the chain_blocks kernel (chain mask evaluated
  in-kernel, per-32-row-block counts + int64 payload sums), then per-bucket
  totals as cumsum differences at the 32-aligned bucket bounds. When the
  whole chain is one TermQuery on a dense multi-valued field, a MEMBER
  OPERAND replaces the scan: exact int64 per-(value, bucket) cells built
  once on the device, of which a query copies one row (gather_rows).
- percentiles ("rank"): value-sorted OrderedLayout scanned by the
  chain_counts kernel (per-128-row-group counts); integer ranks resolve to
  layout rows through torch.searchsorted over the count prefix plus a lazy
  128-row window recompute — no [R] mask per query.
- percentiles under dense single-valued bucket ancestors ("slot_rank"):
  the same value layout scanned by the chain_slot_counts kernel against a
  static composite ancestor-slot plane (per-32-row-block counts per slot),
  then the rank selection per slot over 32-row windows.

Set-type queries (TermSet / Fuzzy / Regex) compile to one run-slot opcode
of the mask program, so they take every mode above; `accepts` tells the
searcher when a request's runs exceed the compiled slots.

Multi-valued fields (the JAX package's CSR value rows and per-position
planes, index/loader.py):
- a query leaf over one is an OR over its doc-aligned per-position planes,
  which permute into the layouts like any plane: prefix terms, rank and
  slot_rank percentiles keep the chain kernels (a chain is "dense",
  _chain_is_dense). A field with an overflow tail, and a phrase over a
  tailed text field, add doc-space scatters: such a chain is evaluated
  over the doc axis only, and the prefix and rank modes read the scope's
  mask gathered through the static row->doc plane `pdoc` (`mask_gather`);
- percentiles over a multi-valued field rank its value rows (value-row
  layouts: every doc-aligned plane is read at the row's doc, `row_doc`);
- a bucket agg over one runs over its value rows ("dense" / "scatter":
  index_add_, or the dense products over the value rows' static bucket
  ids); its children chain per value row (a single-valued child reads its
  ids at the row's doc; a multi-valued child takes the static
  cross-product expansion `xpand`, one level); a short keyword at the
  root fans out over its per-position planes (`plane_fanout`), merging
  the fruits before one selection;
- percentiles under a multi-valued terms ancestor count each of a doc's
  value positions as a slot factor of its own (`wslots`: occurrence
  weights), with torch ops over the chain mask, as percentiles of a
  multi-valued field under single-valued buckets do.

Non-integer percents (99.9) resolve their ranks in a second phase: the
program ships each query's match count `m` in the packed fruits and keeps
its count prefix (and what the lazy window recompute reads) on the device
("big"); the host resolves exact rational ranks (utils/exact.py
percentile_rank) and one device call per node selects the rank rows for
the whole group (`finalize_many`). Such a node forces host-side selection
on its terms ancestors, so every fruit beside it stays full-slot-space.

top_hits sorts each row space once at plan time, by (sort key, doc), into
a static order (`_hit_order`); a query's flat hits are
the first k matched rows of that order (a cumsum and a searchsorted), and
in-slot hits one stable sort per query by composite slot. facet aggs are
terms aggs over the facet field's value rows with host-side selection of
the static child ordinals.

Sharded meshes (JAX `shard_map`, parallel/shard.py): a `ShardedProgram`
holds one Program per shard, each planned and run on its shard's
DeviceIndex (index/loader.py `load_sharded_index`) in a thread of its own,
in lockstep; the collectives sit where the JAX program's do: psum of counts
and exact sums (`_madd`), min / max merges (`_mmin`, `_mmax`), the cube's
int32 dot vectors psum'd before recombination (per-shard operands with one
common piece layout; at most cube.MAX_SHARDS shards), and the top_hits
k-way merges of per-shard candidates (`all_gather`, doc ids globalized).
The plan follows JAX's sharded plan node by node: no member operands, no
pcube or scube, rank percentiles select by cross-shard bisection of the
value domain (`bisect`; count(x) = psum of per-shard counts from the
chain_counts prefix plus a lazy window), slot_rank by per-slot bisection
(`slot_bisect`), non-integer percents bisect in phase 2 and emit values
(`phase2_vals`), wslots answer on the host path. The kernels run in every
shard body as they do unsharded (each works per 32- or 128-row block).

Every other shape — deeper multi-valued nests, top_hits under huge bucket
spaces, slot spaces past the device budget, a kernel chain
whose planes, payloads, ops and params overflow the chain tile kernel's
shared memory (K.chain_fits: about 50 planes, or tens of thousands of
params) — raises NotImplementedError at plan time naming the shape, and
the searcher answers it on the exact host path. A scope's mask is
evaluated only when a node reads it, so a chain that only a member
operand or the cube answers runs no row pass.

The cube's operands and block histograms, the layouts (index/loader.py)
and the top_hits orders are built once per index contents and persisted
across processes (utils/prep_cache.py, `_prep_cached`); the dense
products' operands are built on the device at each plan.
"""

from __future__ import annotations

import math
import types
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..aggs import ir as A
from ..index.loader import ALIGN, PAD_BLOCK, _put
from ..ops import cube as C
from ..ops import kernels as K
from ..ops import reductions as R
from ..parallel import shard as SH
from ..query import compile as qc
from ..query import ir as Q
from ..schema import FieldType
from ..utils import exact as _exact, mono as mono_mod, prep_cache as PC
from ..utils.stats import counters, lap, span

MAX_TERMS_CARD = 1 << 27
MAX_HIST_NB = 1 << 20  # f64 bucket-layout bound (host boundary list is O(nb))
MAX_HIST_NB_HOST = 1 << 24  # columns spanning more buckets than this are
# refused here (the JAX package routes them to its host path)

#: rows per chain_counts group (the lazy rank-selection window)
GROUP = 128
#: rows per chain_slot_counts block (the slot_rank selection window)
SLOT_GROUP = 32


def _f64_spanned(fn):
    """`fn` of utils/exact.py, lapped `tat.f64_exact` (a lap, not a
    profiler span: each call takes a few us)."""
    def spanned(*args):
        with lap("tat.f64_exact"):
            return fn(*args)
    return spanned


#: utils/exact.py as this module reads it, with the harvest's exact f64
#: work lapped `tat.f64_exact`: a sum put together from its limb planes
#: and rounded once, and a bucket key rounded (the harvest is a copy of
#: the JAX package's and keeps its text)
exact = types.SimpleNamespace(**{
    **vars(_exact),
    "f64_reconstruct_sum": _f64_spanned(_exact.f64_reconstruct_sum),
    "f64_histogram_key": _f64_spanned(_exact.f64_histogram_key)})


def _wrap64(x: int) -> int:
    return ((x + 2**63) % 2**64) - 2**63


class MaskCtx:
    """Root or filter scope: its [B, T] bool mask (batch stride 0 where one
    row is shared), made by `make` on first use — a scope whose readers the
    cube answers never evaluates it."""

    def __init__(self, make):
        self._make = make
        self._mask = None
        #: the mask's exact [B] int64 counts, once a node has them
        self.cnt: Optional[torch.Tensor] = None

    @property
    def mask(self) -> torch.Tensor:
        if self._mask is None:
            self._mask = self._make()
        return self._mask

    def count(self) -> torch.Tensor:
        if self.cnt is None:
            self.cnt = R.ts_count(self.mask)
        return self.cnt


@dataclass
class SlotCtx:
    """Bucket context: `bid` is the flat composite slot id per ROW ([rows]
    static or [B, rows], meaningful where `valid`), `valid` the per-query
    [B, rows] bool row validity. Rows are the docs (`doc` None) or the
    value rows of a multi-valued bucket field or a cross-product expansion
    (`doc`: the [rows] int64 doc of each row, where doc-aligned planes are
    read). `doc_rooted`: children read this context's slots per doc; in
    the row space of a multi-valued ancestor they chain per row instead
    (each value row of the ancestor is one collect of the child)."""
    bid: torch.Tensor
    valid: torch.Tensor
    dims: Tuple[int, ...]
    #: the node's plan entry when `bid` is a static plane of a dense node
    #: right under a MaskCtx and its reductions run as dense products
    mm: Optional[dict] = None
    doc: Optional[torch.Tensor] = None
    doc_rooted: bool = True

    @property
    def nslots(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def rows(self, plane):
        """A doc-aligned plane ([T] or [T, L]) read at this context's rows."""
        return plane if self.doc is None else plane[self.doc]

    def slots_of_docs(self, T: int):
        """([B, T] slot per doc, -1 for none; [B, T] bool valid): the
        context's slots scattered onto the docs (value rows of one doc
        share its slot where the field is single-cardinality)."""
        if self.doc is None:
            return torch.where(self.valid, self.bid, -1), self.valid
        B, rows = self.valid.shape
        sod = torch.full((B, T), -1, dtype=torch.int64,
                         device=self.valid.device)
        sod.scatter_reduce_(1, self.doc.expand(B, rows),
                            torch.where(self.valid, self.bid, -1)
                            .to(torch.int64).expand(B, rows), "amax")
        return sod, sod >= 0


class _Staged:
    """A program's packed [B, F] fruits on their way to the host
    (Program.stage), beside its phase-1 device state `big`. On the card
    the copy lands in a pinned buffer of this object's own behind a
    recorded event; `numpy` waits on the event before reading it."""

    __slots__ = ("host", "event", "big")

    def __init__(self, packed, big):
        self.big = big
        self.event = None
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed.clone()

    def numpy(self) -> np.ndarray:
        with span("tat.wait"):
            if self.event is not None:
                self.event.synchronize()
            return self.host.numpy()


#: device bytes the captured steps of one device may hold (_GraphBook):
#: 24 GiB of the H100's 80 GB, beside the resident planes and operands
GRAPH_MEM_BUDGET = 24 << 30


class _GraphBook:
    """The captured steps of one device and the memory they hold, least
    recently used first. Every program of every searcher on the device
    captures into one graph pool (a pool per graph would hold the
    intermediates of every (program, batch size) at once). A graph holds
    its own param and output buffers (`_StepGraph.nbytes`) and a share of
    the pool: the bytes by which its capture grew the device's reserved
    memory, counted for the pool while any graph captured into it lives
    (the caching allocator keeps a pool's segments until then). Past
    `budget` the least recently used graphs are dropped from their
    programs, to be captured again at their next use, until the total
    fits or only the newest is left; a drop also starts a new pool for
    later captures, so that the old one drains as its graphs go. A graph
    that dies with its program (the searcher's LRU) leaves the book by
    itself. A pool is captured into only while a graph of it lives: when
    the current pool's last graph goes, later captures start a new one
    (the caching allocator refuses a capture into a pool it has released,
    and frees that pool's memory at the next empty_cache)."""

    def __init__(self, new_pool, budget=GRAPH_MEM_BUDGET):
        self._new_pool = new_pool
        self.budget = budget
        self.pool = new_pool()
        #: serial -> (program weakref, B, graph weakref, own bytes, pool)
        self.graphs = OrderedDict()
        #: pool -> [bytes its captures grew, graphs captured into it alive]
        self.pools = {}
        #: graphs dropped for the budget
        self.dropped = 0
        self._serial = 0

    def total(self) -> int:
        return (sum(e[3] for e in self.graphs.values())
                + sum(b for b, live in self.pools.values() if live))

    def add(self, prog, B, graph, grown):
        """Book `graph`, prog's graph for key B just captured into
        `graph.pool` and grown it by `grown` bytes; then trim to the
        budget."""
        self._serial += 1
        n = graph.serial = self._serial
        self.graphs[n] = (weakref.ref(prog), B,
                          weakref.ref(graph, lambda _, n=n: self._gone(n)),
                          graph.nbytes, graph.pool)
        pb = self.pools.setdefault(graph.pool, [0, 0])
        pb[0] += grown
        pb[1] += 1
        self.trim()

    def touch(self, graph):
        if graph.serial in self.graphs:
            self.graphs.move_to_end(graph.serial)

    def _gone(self, n):
        e = self.graphs.pop(n, None)
        if e is not None:
            self.pools[e[4]][1] -= 1
            if not self.pools[e[4]][1]:
                del self.pools[e[4]]
                if e[4] == self.pool:
                    self.pool = self._new_pool()

    def trim(self):
        while self.total() > self.budget and len(self.graphs) > 1:
            n, (pref, B, gref, _, pool) = next(iter(self.graphs.items()))
            prog, graph = pref(), gref()
            if prog is not None and prog._graphs.get(B) is graph:
                del prog._graphs[B]
            del graph
            self._gone(n)  # where a caller still holds the graph
            self.dropped += 1
            counters["graph_drops"] += 1
            if pool == self.pool:
                self.pool = self._new_pool()


#: the graph book of each device
_BOOKS: Dict[int, _GraphBook] = {}
#: the stream each device's steps are warmed up and captured on
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _counters():
    """The launch and call counters a step's kernels and products bump
    (ops/kernels.py, ops/cube.py, ops/reductions.py)."""
    return K.launches, C.calls, R.mm_calls


def _static_like(t):
    """A buffer outside the graph pool for one output of the step: a
    batch-stride-0 tensor (one shared row) keeps one row."""
    one, _ = R.shared_row(t) if t.dim() > 1 else (t, 1)
    return torch.empty_like(one, memory_format=torch.contiguous_format)


def _out_view(static, shape):
    """`static` seen with the output's `shape` (a shared row expanded
    again)."""
    return static if static.shape == shape else static.expand(shape)


def _tensors_in(obj, out):
    """Every tensor reachable through dicts, lists, tuples and RowOperands
    of `obj`, appended to `out`."""
    if torch.is_tensor(obj):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors_in(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors_in(v, out)
    elif isinstance(obj, K.RowOperand):
        out.append(obj.op)
    return out


def _map_tensors(fn, tree, leaf=torch.is_tensor):
    """`tree` (dicts, lists and tuples of tensors and host values) with
    every tensor t (every `leaf`) replaced by fn(t)."""
    if leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v, leaf) for v in tree)
    return tree


def _zip_tensors(fn, a, b) -> None:
    """fn(x, y) on every pair of tensors at one place of two trees of one
    structure."""
    if torch.is_tensor(a):
        fn(a, b)
    elif isinstance(a, dict):
        for k, v in a.items():
            _zip_tensors(fn, v, b[k])
    elif isinstance(a, (list, tuple)):
        for v, w in zip(a, b):
            _zip_tensors(fn, v, w)


class _Buf:
    """A static buffer for one output of a captured function
    (`_static_like`) and the output's shape (`_out_view`)."""

    __slots__ = ("buf", "shape")

    def __init__(self, t):
        self.buf = _static_like(t)
        self.shape = t.shape

    def view(self, clone=False):
        return _out_view(self.buf.clone() if clone else self.buf, self.shape)


def _is_buf(x) -> bool:
    return isinstance(x, _Buf)


def _fill(buf, t) -> None:
    """Copy t into its static buffer (`_static_like`: one row where t is a
    shared row). A tensor of another shape raises."""
    if buf.dim() > 1 and buf.shape[0] != t.shape[0]:
        t = R.shared_row(t)[0]
    buf.copy_(t)


def _state_views(bufs, state):
    """A phase-2 node's state (its count prefix, sub-matrix or mask, G)
    read from its static buffers (`_static_like` of each tensor) at the
    state's shapes."""
    return {k: (_out_view(bufs[k], v.shape) if torch.is_tensor(v) else v)
            for k, v in state.items()}


def _padded_ranks(rk, Bp) -> torch.Tensor:
    """Host ranks [B, ...] as a [Bp, ...] int64 tensor, rows past B zero (a
    rank the selection of a padded row reads and nobody harvests)."""
    out = np.zeros((Bp,) + rk.shape[1:], np.int64)
    out[:rk.shape[0]] = rk
    return torch.from_numpy(out)


class _StepGraph:
    """A device function captured as one CUDA graph (JAX's jit at first
    use): a Program's or a mesh's step at one padded batch size B (the
    inputs: the [B, P] param matrix), or phase 2's selection of one node
    at the group's padded B (the inputs: the host ranks and a copy of the
    node's phase-1 state). The caller gives the static input buffers
    (`ins`, filled for the first call) and `fn(stream)`, the function over
    them, whose work goes to `stream` (a mesh makes it current in every
    shard thread: MeshGroup.run's ctx). fn runs once eagerly on the
    device's capture stream with any host sync an error (the warm-up also
    makes the library workspaces and the kernels' launch state that the
    capture then reuses); then fn is captured into the device's shared
    pool (`_GraphBook.pool`), ending in copies of every output tensor into
    buffers of the graph's own outside the pool. Nothing a caller reads
    lives in the pool, so graphs of any programs and sizes replay in any
    order. A capture or replay error propagates: no step answers eagerly
    instead. `keep_nodes` keeps the captured graph's nodes (`keep_graph`,
    then instantiated at once) for `CUDAGraph.debug_dump` (chip_smoke.py
    counts the nodes and the kernels in each).

    The kernels' launch counters and the products' call counters count
    where a kernel is enqueued, so the capture's counts (every shard
    body's on a mesh) are recorded (`credit`) and credited on each replay,
    and the capture itself counts nothing. The graph reads the program's
    resident tensors by address (the chain kernels take their plane
    pointers by value): `keep` holds them for the graph's life."""

    keep_nodes = False

    __slots__ = ("graph", "ins", "out", "keep", "credit", "book", "pool",
                 "nbytes", "grown", "serial", "__weakref__")

    def __init__(self, device, ins, fn, keep):
        di = device.index
        if di is None:
            di = torch.cuda.current_device()
        if di not in _BOOKS:
            _BOOKS[di] = _GraphBook(torch.cuda.graph_pool_handle)
            _CAPTURE_STREAMS[di] = torch.cuda.Stream(di)
        self.book = _BOOKS[di]
        self.ins = ins
        stream = _CAPTURE_STREAMS[di]
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                warm = fn(stream)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            #: a _Buf for each output tensor, in the tree of fn's result
            self.out = _map_tensors(_Buf, warm)
            del warm
            before = [dict(c) for c in _counters()]
            self.graph = torch.cuda.CUDAGraph(keep_graph=self.keep_nodes)
            # the ordinary pool's cached free blocks back to the device (as
            # torch.cuda.graph does before a capture): a capture cannot
            # free them when the graph pool must grow, and runs out of
            # memory with tens of GB cached but unused
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            self.pool = self.book.pool
            self.graph.capture_begin(pool=self.pool)
            try:
                _zip_tensors(lambda t, b: _fill(b.buf, t), fn(stream),
                             self.out)
            finally:
                self.graph.capture_end()
                self.grown = max(0, torch.cuda.memory_reserved(device)
                                 - reserved)
                # the capture launched nothing: its counts go to `credit`
                self.credit = []
                for c, b in zip(_counters(), before):
                    self.credit.append({k: c[k] - b[k] for k in c})
                    c.update(b)
            if self.keep_nodes:
                self.graph.instantiate()
        torch.cuda.current_stream(device).wait_stream(stream)
        bufs = _tensors_in(ins, [])
        _map_tensors(lambda b: bufs.append(b.buf), self.out, _is_buf)
        self.nbytes = sum(t.numel() * t.element_size() for t in bufs)
        self.keep = _tensors_in(keep, [])

    def replay(self, clone=()):
        """Launch the graph on the current stream; fn's outputs as views of
        the graph's buffers, except the top-level entries named in `clone`,
        cloned (a step's "big": agg_search_stream keeps groups in flight,
        so group n's phase 2 can run after group n+1 replayed this graph;
        its "packed" needs no clone: Program.stage copies it right after
        this launch, on the same stream, so the copy runs before any later
        replay)."""
        self.graph.replay()
        self.book.touch(self)
        for c, d in zip(_counters(), self.credit):
            for k, n in d.items():
                c[k] += n
        if not isinstance(self.out, dict):
            return _map_tensors(_Buf.view, self.out, _is_buf)
        return {k: _map_tensors(lambda b, c=k in clone: b.view(c), v,
                                _is_buf)
                for k, v in self.out.items()}


def _replayed(owner, key, alloc, fill, fn, keep, clone=()):
    """owner's graph for `key` (`owner._graphs`, booked on its device's
    _GraphBook), captured at its first use, replayed: alloc() makes the
    static inputs, fill(ins) writes this call's inputs into them (a
    pinned host copy or a device copy, on the current stream), fn(ins,
    stream) is the function (_StepGraph), `keep` what it reads by
    address; returns _StepGraph.replay(clone). Spanned: the capture
    `tat.capture`, the replay `tat.launch`."""
    g = owner._graphs.get(key)
    if g is None:
        ins = alloc()
        fill(ins)
        with span("tat.capture"):
            g = owner._graphs[key] = _StepGraph(
                owner.device, ins, lambda stream: fn(ins, stream), keep)
        g.book.add(owner, key, g, g.grown)
        counters["graph_captures"] += 1
    else:
        fill(g.ins)
    counters["graph_replays"] += 1
    with span("tat.launch"):
        return g.replay(clone)


def _phase2_replayed(owner, path, sts, rk, select):
    """Phase 2's selection of node `path` as owner's replayed graph at the
    state's padded batch Bp (JAX jits it per node): the host ranks `rk`
    through one pinned copy into a static int64 [Bp, ...] buffer, the
    group's phase-1 state (`sts`: one per shard) copied on the stream into
    static buffers of the graph's own, since the state a step's replay
    hands out is a clone that a group in flight keeps; select(ranks,
    states, stream) is the selection. Returns the graph's [Bp, ...]
    output buffer."""
    Bp = sts[0]["cum"].shape[0]

    def fill(ins):
        qc.to_device_async(_padded_ranks(rk, Bp), owner.device, out=ins[0])
        _zip_tensors(lambda t, b: _fill(b, t), sts, ins[1])
    return _replayed(
        owner, ("phase2", path, Bp),
        lambda: [torch.empty((Bp,) + rk.shape[1:], dtype=torch.int64,
                             device=owner.device),
                 _map_tensors(_static_like, sts)],
        fill, lambda ins, stream: select(
            ins[0], [_state_views(b, st) for b, st in zip(ins[1], sts)],
            stream), owner._keep())


def mesh_graph_mode(devices):
    """(plan["graph"], its reason or None) of a shard on a mesh of
    `devices`: a mesh whose shards share one device (four shards of one
    card, a replica group's one shard, CPU shards) runs its step as one
    captured graph, the shard bodies in turn on one stream; a mesh over
    two or more devices keeps its step eager."""
    devs = {torch.device(d) for d in devices}
    if len(devs) == 1:
        return True, None
    return False, (
        f"a mesh over {len(devs)} devices: a graph across cards would "
        "need cross-device capture, untested here (it needs a machine "
        "with two or more cards), so the shard threads run eagerly")


def _cols(x, idx, keep=None):
    """x[:, idx] of a [B, n] tensor (AND `keep`), a batch-stride-0 one
    gathered once and kept one shared row."""
    if x.shape[0] > 1 and x.stride(0) == 0:
        g = x[:1][:, idx]
        if keep is not None:
            g = g & keep
        return g.expand(x.shape[0], idx.shape[0])
    g = x[:, idx]
    return g if keep is None else g & keep


def _iter_set_queries(query, aggs):
    """Yield every set-type query node (TermSet/Fuzzy/Regex) reachable from
    the outer query and the agg tree's filter/post_filter queries."""
    def walk_q(q):
        if isinstance(q, (Q.TermSetQuery, Q.FuzzyTermQuery, Q.RegexQuery)):
            yield q
        elif isinstance(q, Q.BooleanQuery):
            for c in (*q.must, *q.should, *q.must_not):
                yield from walk_q(c)

    def walk_a(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from walk_a(v)
            return
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            yield from walk_q(node.query)
        for _, sub in getattr(node, "sub_aggs", ()):
            yield from walk_a(sub)

    yield from walk_q(query)
    yield from walk_a(aggs)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# f64 histograms laid out over the request's range
# ---------------------------------------------------------------------------

def _f64_nb(lo_m: int, hi_m: int, node) -> int:
    """Buckets of an f64 histogram over the values of mono [lo_m, hi_m]
    (what exact.f64_histogram_buckets would lay out, without building it)."""
    iv, off = Fraction(float(node.interval)), Fraction(float(node.offset))
    lo = Fraction(mono_mod.scalar_from_mono("f64", lo_m))
    hi = Fraction(mono_mod.scalar_from_mono("f64", hi_m))
    return int((hi - off) // iv - (lo - off) // iv) + 1


def _range_bounds(query, col):
    """(lo_m, hi_m): the inclusive mono bounds that the root query's ranges
    on `col`'s f64 field (a root RangeQuery, or RangeQuery clauses among a
    root BooleanQuery's must) put on every matching doc's value, clipped
    to the column's [min_mono, max_mono]; the column's least value alone
    where they match nothing (no doc then reaches a bucket); None where
    the root query bounds no value of the field. The bounds are
    normalized as the query's params are (`qc._extract`)."""
    clauses = ((query,) if isinstance(query, Q.RangeQuery) else
               query.must if isinstance(query, Q.BooleanQuery) else ())
    ranges = [c for c in clauses
              if isinstance(c, Q.RangeQuery) and c.field == col.name]
    if not ranges:
        return None
    lo_m, hi_m = col.min_mono, col.max_mono
    for q in ranges:
        if any(b is not None and math.isnan(float(b))
               for b in (q.lower, q.upper)):
            return col.min_mono, col.min_mono
        if q.lower is not None:
            lo_m = max(lo_m, qc._zero_bound(FieldType.F64, q.lower, True,
                                            q.include_lower)
                       + (0 if q.include_lower else 1))
        if q.upper is not None:
            hi_m = min(hi_m, qc._zero_bound(FieldType.F64, q.upper, False,
                                            q.include_upper)
                       - (0 if q.include_upper else 1))
    return (lo_m, hi_m) if lo_m <= hi_m else (col.min_mono, col.min_mono)


def _range_layout(query, col, node):
    """The mono span [lo_m, hi_m] an f64 histogram `node` over `col` is
    laid out on in place of the column's, or None for the column's: only
    where the column's span passes MAX_HIST_NB buckets and the root query
    bounds the field by a range. Only such a doc reaches any bucket, and a
    single-valued doc holds that one value, so buckets outside the range
    are never live and the layout stays exact."""
    if (node.calendar or col.ftype != FieldType.F64 or col.multi
            or col.n_values == 0
            or _f64_nb(col.min_mono, col.max_mono, node) <= MAX_HIST_NB):
        return None
    return _range_bounds(query, col)


def range_layout_fields(dindex, query, aggs) -> tuple:
    """The fields of the request's f64 histograms that are laid out over
    its range (`_range_layout`): their bounds select the program, so the
    searcher keys the shape's programs by them. Empty for every shape whose
    histograms all take the column's span."""
    out = set()

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
            return
        if isinstance(node, A.HistogramAgg) and dindex.schema.field(
                node.field).type == FieldType.F64 and _range_layout(
                    query, dindex.column(node.field), node) is not None:
            out.add(node.field)
        for _, sub in getattr(node, "sub_aggs", ()):
            walk(sub)

    walk(aggs)
    return tuple(sorted(out))


def range_layout_key(dindex, query, fields) -> tuple:
    """The range bounds of `fields` (range_layout_fields) in this request,
    which select its program among its shape's (the layouts read them)."""
    return tuple(_range_bounds(query, dindex.column(f)) for f in fields)


class Program:
    #: slot_rank flat-slot-space admission above the dense budget (up to
    #: K.PCT_SLOT_CAP slots): the byte bound on one query's [ns, R/32]
    #: int32 counts
    BIG_SLOT_MEM = 256 << 20
    #: byte budget of one [Df_pad, n_cols * card_pad] int64 member operand
    #: (resident for the layout's life; c7's is ~1.6 GB of the H100's 80 GB)
    MEMBER_MEM = 2 << 30
    #: device bytes an msearch group's per-query slot_rank state (the
    #: [ns, R/32] counts and their cumsum) may take: 8 GiB of the H100's
    #: 80 GB, the rest holding the resident planes, layouts and operands
    BATCH_MEM_BUDGET = 8 << 30

    def __init__(self, dindex, query: Q.Query, aggs: Dict[str, A.Agg],
                 config=None):
        from ..engine_config import EngineConfig
        A.validate_agg_tree(dindex.schema, aggs)
        # set-type queries: prepare-time type/param validation (TypeError/
        # ValueError, matching the oracle). Run-count overflow is NOT a
        # construction error — the program's run-slot shape is valid for
        # every fitting same-shape request; the searcher's accepts() gate
        # routes individual overflowing requests to the exact host path.
        from ..utils import termmatch
        self._set_shape = False
        for n in _iter_set_queries(query, aggs):
            self._set_shape = True
            termmatch.check_set_query_field(dindex.schema.field(n.field).type,
                                            n)
        self.dindex = dindex
        #: a shard of a mesh (JAX `_sharded`: a 1-device mesh is one too)
        self._sharded = dindex.mesh is not None
        self.query = query
        self.aggs = aggs
        self.config = config or EngineConfig()
        self.dense_nb = self.config.dense_nb
        self.device = dindex.device
        # every scalar param of this (query, aggs) shape, in one sorted
        # order: the columns of the [B, P] param matrix
        self._pkeys = tuple(sorted(self._extract(query, aggs)))
        self._pcol = {k: i for i, k in enumerate(self._pkeys)}
        self.plan: Dict[tuple, dict] = {}
        self._arrays: Dict[str, torch.Tensor] = {"alive": dindex.alive}
        self._root_chain = ((query, ("q",)),)
        #: set by the planner when a node reads the root MaskCtx
        self._reads_root = False
        #: the nearest multi-valued bucket ancestor whose value rows form
        #: the row space while planning (None: doc-rooted; "__deep__": a
        #: cross-product expansion already re-based it)
        self._mparent = None
        #: top_hits nodes planned, with their plan entries
        self._top_hits = []
        self._plan_aggs(aggs, ("a",), in_slot=False, hdims=(), tflat=1,
                        chain=self._root_chain, bchain=())
        self._root = (self._chain_entry(self._root_chain)
                      if self._reads_root else None)
        #: top_hits row orders, per node path: (order, key), built here so
        #: that the step uploads and reads back nothing (_hit_order)
        self._hit_cache = {p["path"]: self._hit_order(node, p)
                           for node, p in self._top_hits}
        # the execution mode: the step, and phase 2's selection of each
        # non-integer percentile node, captured as CUDA graphs per padded
        # batch on the card; on a mesh over several devices they stay eager
        # (mesh_graph_mode)
        graph, reason = ((True, None) if not self._sharded
                         else mesh_graph_mode(dindex.mesh.devices))
        self.plan["graph"] = graph
        if reason is not None:
            self.plan["graph_reason"] = reason
        #: msearch group bound (None: no per-query row-axis state)
        self.batch_cap = self._batch_cap()
        #: per-query fruit layout of the packed [B, F] int64 output
        self._pack_spec = None
        #: the captured steps on the card, per padded batch size
        self._graphs: Dict[int, _StepGraph] = {}

    def _batch_cap(self):
        """Queries per msearch group whose per-query state fits
        BATCH_MEM_BUDGET, or None when the program keeps no per-query
        row-axis state (`_per_query_bytes`)."""
        per_q = self._per_query_bytes()
        if per_q == 0:
            return None
        return max(1, self.BATCH_MEM_BUDGET // per_q)

    def _per_query_bytes(self) -> int:
        """Device bytes of one query's row-axis state: slot_rank's [ns,
        R/G] counts and their cumsum; a rank prefix ([R/G]) where the
        pcube computes it, phase 2 or a bisection reads it; a mask-gather
        node's gathered [R] mask (and, for phase 2, the scope's [T] doc
        mask its windows re-read); in-slot top_hits' [slots, k] hits (its
        sorts run a few queries at a time)."""
        per_q = 0
        for p in self.plan.values():
            if not isinstance(p, dict):
                continue
            if p.get("pmode") == "slot_rank":
                G = p["scube"]["G"] if p.get("scube") else SLOT_GROUP
                per_q += (p["layout"].n_rows // G) * p["nslots"] * 8
                # the torch slot path's [R] int32 composite slot per plane
                per_q += p["layout"].n_rows * 4 * len(p.get("slotks", ()))
            elif p.get("pmode") == "rank" and p.get("pcube"):
                per_q += (p["layout"].n_rows // p["pcube"]["G"]) * 8
            elif p.get("pmode") == "rank" and (not p["int_percents"]
                                               or p.get("bisect")):
                G = SLOT_GROUP if p.get("mask_gather") else GROUP
                per_q += (p["layout"].n_rows // G) * 8
                if p.get("mask_gather"):
                    per_q += self.dindex.T
            if p.get("mask_gather"):
                per_q += p["layout"].n_rows  # the gathered [R] bool mask
            if p.get("kind") == "top_hits" and p["in_slot"]:
                per_q += p["tflat"] * (16 * p["k"] + 8)
            # a nested bucket node's [rows] int64 composite slots, its
            # validity and their int64 temporaries
            per_q += p.get("slot_rows", 0) * 40
        return per_q

    # -- merges across the shards of a mesh (JAX `_madd`, `_mmin`, `_mmax`;
    # the identity on one device) --------------------------------------------

    def _madd(self, x):
        return SH.psum(x) if self._sharded else x

    def _mmin(self, x):
        return SH.pmin(x) if self._sharded else x

    def _mmax(self, x):
        return SH.pmax(x) if self._sharded else x

    def _merge_fruit(self, out: dict) -> dict:
        """A metric's fruits merged across the shards: counts and sums
        add, min / max fold."""
        if not self._sharded:
            return out
        return {k: (self._mmin(v) if k == "min" else
                    self._mmax(v) if k == "max" else self._madd(v))
                for k, v in out.items()}

    def _prep_cached(self, key, build, to_host, from_host):
        """Build-or-load one artifact of this index through the
        cross-process prep cache (JAX `_prep_cached`), under a key that
        names the shard on a mesh."""
        di = self.dindex
        return PC.cached(di.prep_anchor, di.prep_key(key), build, to_host,
                         from_host)

    # ======================================================================
    # public
    # ======================================================================

    def _extract(self, query, aggs) -> dict:
        params = qc.extract_params(query, self.dindex)
        self._extract_filter_params(aggs, ("a",), params)
        return params

    def param_key(self, query, aggs):
        """Canonical hashable key of a request's extracted device params.
        A program is a pure function of (params, resident planes), so equal
        keys imply bit-identical fruits — agg_search_batch computes
        repeated queries of a group ONCE (searcher._submit_group)."""
        return tuple(sorted((k, int(v))
                            for k, v in self._extract(query, aggs).items()))

    def accepts(self, query, aggs) -> bool:
        """True when this program can answer `query` exactly: a same-shape
        request whose set-type query expansions (if any) fit the compiled
        run slots. The searcher routes rejected requests to the exact host
        path without evicting the program."""
        if not self._set_shape:
            return True
        return Program.accepts_on(self.dindex, query, aggs)

    @staticmethod
    def accepts_on(dindex, query, aggs) -> bool:
        for n in _iter_set_queries(query, aggs):
            if len(qc.match_runs(dindex, n)) > Q.run_slots(n):
                return False
        return True

    def example_inputs(self):
        """(pmat, arrays) for this program's own (query, aggs) pair: valid
        example arguments for raw_fn (JAX `Program.example_inputs`). A
        [1, P] int32 param matrix takes the place of JAX's params dict:
        its columns are the program's sorted param keys."""
        return (qc.param_matrix([self._extract(self.query, self.aggs)],
                                self._pkeys, self.device), self._arrays)

    def as_callable(self):
        """(raw_fn, example_inputs()): the whole device step as a plain
        function plus example arguments (JAX `Program.as_callable`);
        `finalize(raw_fn(*args), aggs)` answers the program's request."""
        return self.raw_fn, self.example_inputs()

    def submit(self, query, aggs):
        return self.submit_many([query], aggs)

    def submit_many(self, queries, aggs, pad_to=None):
        """Run B same-shape queries as one [B, P] param matrix; returns the
        device-side fruits {"packed": [B, F] int64, "big": {path: phase-1
        state}} ("big": the non-integer percentile nodes' count prefixes,
        read by phase 2 in finalize_many). `pad_to` repeats the last
        request up to that many rows (JAX's padding, so that a few batch
        sizes serve every group); finalize_many harvests the first rows.
        On the card the step replays its graph for this B (captured at
        the first call of each B); on the CPU, and for a shard (its
        ShardedProgram runs it), raw_fn runs. Spanned as `tat.submit`:
        `tat.params`, then `tat.param_copy` and `tat.launch` (and
        `tat.capture` at a B's first call)."""
        with span("tat.submit"):
            mat = self._param_rows(queries, aggs, pad_to)
            if not self._captures():
                pmat = qc.to_device_async(mat, self.device)
                with span("tat.launch"):
                    return self.raw_fn(pmat, self._arrays)
            return _replayed(
                self, mat.shape[0], lambda: self._pmat_buffer(mat.shape[0]),
                lambda ins: qc.to_device_async(mat, self.device, out=ins[0]),
                lambda ins, _: self.raw_fn(ins[0], self._arrays),
                self._keep(), clone=("big",))

    def _param_rows(self, queries, aggs, pad_to=None) -> torch.Tensor:
        """The [B, P] int32 host param matrix of `queries`, the last
        request repeated up to `pad_to` rows (`tat.params`)."""
        with span("tat.params"):
            rows = [self._extract(q, aggs) for q in queries]
            if pad_to is not None:
                rows += rows[-1:] * (pad_to - len(rows))
            return qc.param_rows(rows, self._pkeys)

    def _captures(self) -> bool:
        """True where this program's step and phase-2 selections replay
        CUDA graphs: on the card, unsharded (a shard's run inside its
        ShardedProgram's graphs)."""
        return (self.device.type == "cuda" and self.plan["graph"]
                and not self._sharded)

    def _pmat_buffer(self, B):
        return [torch.empty((B, max(1, len(self._pkeys))), dtype=torch.int32,
                            device=self.device)]

    def _keep(self):
        """What this program's graphs read by address: the arrays, every
        tensor of the plan and the top_hits orders."""
        return (self._arrays, self.plan, self._hit_cache)

    def run(self, query, aggs):
        return self.finalize(self.submit(query, aggs), aggs)

    #: array-key prefixes of the batch-shared or per-query-sliced operands
    #: that scan_bytes leaves out: the cube's sites and block histograms,
    #: the member operand, the dense products' operands
    _NOT_SCANNED = ("CUBE#", "PCUBE#", "SCUBE#", "MOP#", "DMM#")

    def scan_bytes(self) -> int:
        """Bytes of the resident ROW-EXTENT device tensors this program's
        plan references (JAX `Program.scan_bytes`): the per-query memory
        traffic of a one-pass row formulation. A bench divides it by the
        measured stream time for the effective scan bandwidth against the
        card's HBM rate (above 100%: the cube, the member operand or a
        batch-shared pass answered without a row pass per query). A
        host-side sum; it launches nothing."""
        return sum(v.numel() * v.element_size()
                   for k, v in self._arrays.items()
                   if not k.startswith(self._NOT_SCANNED))

    def stage(self, raw, aggs):
        """Start the device->host copy of the packed fruits: on the card a
        non-blocking copy into a pinned host buffer of its own (one per
        staged result, so no later stage can overwrite a buffer before it
        is read), followed by an event; on the CPU a plain copy. The
        finalize calls wait on the event."""
        with span("tat.stage"):
            return _Staged(raw["packed"], raw["big"])

    def finalize(self, raw, aggs, staged=None):
        return self.finalize_many(raw, aggs, 1, staged=staged)[0]

    def finalize_many(self, raw, aggs, B: int, staged=None):
        """One device->host copy of the packed fruits (the staged one, or
        made here), host rank resolution and ONE phase-2 device call per
        non-integer percentile node for all B queries, one more host copy
        of the selected rows, then host harvest of the first B rows."""
        staged = staged if staged is not None else self.stage(raw, aggs)
        vecs = staged.numpy()
        with span("tat.harvest"):
            hosts = [self._unpack_host(vecs[b]) for b in range(B)]
            if staged.big:
                with span("tat.phase2"):
                    self._phase2(hosts, staged.big)
            return [self.harvest_host(h, aggs) for h in hosts]

    def _phase2(self, hosts, big):
        """Exact host ranks of each non-integer percentile node (rank:
        exact.percentile_rank per query, (0, 0, 0.0) when m == 0;
        slot_rank: _slot_ranks per slot), the rank rows selected on the
        device for the whole group at once (the same lazy windows as the
        integer path), then one host copy of every node's rows."""
        ranks = self._phase2_ranks(hosts, big)
        self._phase2_attach(hosts, self._phase2_select(ranks, big,
                                                       len(hosts)))

    def _phase2_ranks(self, hosts, big):
        """[(path, int64 [B, 2P] or [B, ns, 2P] host ranks)] of the group's
        phase-2 nodes (the global m: psum'd on a mesh)."""
        out = []
        for path in big:
            p = self.plan[path]
            if p["pmode"] == "slot_rank":
                rk = np.stack([self._slot_ranks(p, self._node_at(h, path))
                               for h in hosts])
            else:
                rk = []
                for h in hosts:
                    node_host = self._node_at(h, path)
                    m = int(node_host["m"])
                    fracs, ranks = [], []
                    for q in p["percents"]:
                        lo, hi, fr = ((0, 0, 0.0) if m == 0
                                      else exact.percentile_rank(q, m))
                        fracs.append(fr)
                        ranks.extend([lo, hi])
                    node_host["_fracs"] = fracs
                    rk.append(ranks)
                rk = np.asarray(rk, np.int64)
            out.append((path, rk))
        return out

    def _phase2_select(self, ranks, big, B):
        """{path: [B, ...] rows of the ranks} (values on a mesh, from the
        cross-shard bisection) on the device: on the card one replayed
        graph per node and padded batch (`_phase2_replayed`), else
        eagerly."""
        if self._captures():
            return {path: _phase2_replayed(
                self, path, [big[path]], rk,
                lambda r, sts, _, path=path: self.select_raw(
                    path, sts[0], self._arrays, r))[:B]
                for path, rk in ranks}
        sel = {}
        for path, rk in ranks:
            st = {k: (v[:B] if torch.is_tensor(v) else v)
                  for k, v in big[path].items()}
            sel[path] = self.select_raw(path, st, self._arrays,
                                        torch.from_numpy(rk).to(self.device))
        return sel

    def select_raw(self, path, st, arrays, ranks):
        """Phase 2's selection of node `path` (JAX's jitted `_lazy_phase2`
        function, `_bisect_phase2` on a mesh): the rows of the device
        ranks [Bp, 2P] (slot_rank [Bp, ns, 2P]) over its phase-1 state
        `st`, or on a mesh their values by the cross-shard bisection; a
        pure function of device tensors that reads nothing back."""
        p = self.plan[path]
        if p.get("bisect") or p.get("slot_bisect"):
            return self._bisect_values(p, st, arrays, ranks)
        return self._select_rows(p, st, arrays, ranks)

    def _phase2_attach(self, hosts, sel):
        """One host copy of every node's selected rows, attached."""
        B = len(hosts)
        rows = [(path, tuple(v.shape[1:]), v.reshape(B, -1))
                for path, v in sel.items()]
        got = torch.cat([r for _, _, r in rows], dim=1).cpu().numpy()
        off = 0
        for path, shape, r in rows:
            n = r.shape[1]
            for b, h in enumerate(hosts):
                self.attach_percentiles(
                    h, {path: got[b, off:off + n].reshape(shape)})
            off += n

    @staticmethod
    def _node_at(host, path):
        node = host
        for k in path[1:]:
            node = node[k]
        return node

    def _slot_ranks(self, p, node_host) -> np.ndarray:
        """[ns, 2P] exact 0-based rank pairs for a slot_rank phase-2 node."""
        m_vec = np.asarray(node_host["m"]).reshape(-1)
        ns = m_vec.shape[0]
        ranks = np.zeros((ns, 2 * len(p["percents"])), np.int64)
        for s in range(ns):
            m = int(m_vec[s])
            if m == 0:
                continue
            for i, q in enumerate(p["percents"]):
                lo, hi, _ = exact.percentile_rank(q, m)
                ranks[s, 2 * i], ranks[s, 2 * i + 1] = lo, hi
        return ranks

    def attach_percentiles(self, host, got):
        for path, vals in got.items():
            self._node_at(host, path)["pvals"] = vals

    def harvest_host(self, host, aggs):
        return {name: self._harvest(agg, host[name], ("a", name), None)
                for name, agg in aggs.items()}

    # ======================================================================
    # planning
    # ======================================================================

    def _col(self, field):
        return self.dindex.column(field)

    def _need(self, key, arr):
        self._arrays[key] = arr

    def _need_col_planes(self, col):
        """A column's value planes: w (or hi, lo) over its docs, or over
        its value rows with their doc and valid planes (multi-valued)."""
        kinds = ["w"] if col.narrow or col.ftype.is_stringy else ["hi", "lo"]
        if col.multi:
            kinds += ["doc", "valid"]
        for kind in kinds:
            self._need(f"{col.name}:{kind}", col.plane(kind))

    def _need_plane(self, key):
        """Register the device plane of a mask-program plane key."""
        f, kind = key.rsplit(":", 1)
        self._need(key, self._col(f).plane(kind))

    def _chain_is_dense(self, chain) -> bool:
        """True when every query field of the chain evaluates in ANY
        doc-aligned permuted row space: single-valued, or multi-valued with
        full per-position plane coverage (no overflow tail): the gate of
        the layout views that the chain kernels and the pcube read (JAX
        `_chain_is_dense`)."""
        for f in self._chain_fields(chain):
            col = self._col(f)
            if col.multi and (not (col.has_multi_planes
                                   or col.has_multi_planes_wide)
                              or col.has_tail):
                return False
        return True

    def _chain_entry(self, chain, prefix="", planes_of=None):
        """Compile a chain to its mask program and register what evaluating
        it needs: the planes (unpermuted, or the layout view under
        `prefix` via `planes_of`), the op list as a device operand, and the
        program's param columns of the [B, P] matrix."""
        mp = qc.mask_program(chain, self.dindex)
        if planes_of is None:
            for key in mp.plane_keys:
                self._need_plane(key)
        else:
            planes_of(mp.plane_keys)
        cols = [self._pcol[k] for k in mp.param_keys]
        return {"mp": mp, "prefix": prefix,
                "ops": K.ops_tensor(mp.ops, self.device),
                "cols": torch.tensor(cols, dtype=torch.int64,
                                     device=self.device)}

    @staticmethod
    def _need_chain_fit(entry, n_aux=0, ns=0):
        """Refuse at plan time a chain that the chain tile kernel cannot
        take with n_aux payloads (or the slot plane of ns slots): its one
        limit is a CTA's shared memory (K.chain_fits)."""
        mp = entry["mp"]
        if not K.chain_fits(len(mp.plane_keys), n_aux, len(mp.ops),
                            len(mp.param_keys), ns):
            raise NotImplementedError(
                f"query chain of {len(mp.plane_keys)} planes, {n_aux} "
                f"payload or slot planes, {len(mp.ops)} ops and "
                f"{len(mp.param_keys)} params exceeds the chain tile "
                f"kernel's shared memory ({K.SMEM_MAX} bytes)")

    def _chain_pmat(self, entry, pmat):
        """The [B, Pc] param sub-matrix a chain's mask program reads (one
        zero column for a param-free chain, so every query keeps a row)."""
        if entry["cols"].numel() == 0:
            return torch.zeros(pmat.shape[0], 1, dtype=torch.int32,
                               device=pmat.device)
        return pmat.index_select(1, entry["cols"]).contiguous()

    def _chain_mask(self, entry, pmat, arrays) -> torch.Tensor:
        mp = entry["mp"]
        planes = [arrays[entry["prefix"] + k] for k in mp.plane_keys]
        return qc.eval_ops(mp.ops, planes, self._chain_pmat(entry, pmat),
                           (self.dindex.T,))

    @staticmethod
    def _host_planes(col):
        """(w, None) or (hi, lo): the host planes behind a single-valued
        column's device planes."""
        if col.narrow or col.ftype.is_stringy:
            return col._w_host, None
        return col._hi_host, col._lo_host

    def _sum_limbs_host(self, col):
        if getattr(col, "_sum_limbs_host_cache", None) is None:
            col._sum_limbs_host_cache = col.sum_limbs_host()
        return col._sum_limbs_host_cache

    def _doc_preagg_host(self, col):
        return col.doc_preagg_host(self.dindex.T)

    def _need_preagg(self, col, need_sum, need_minmax):
        pre = self._doc_preagg_host(col)
        key = f"{col.name}:pre:"
        dev = self.device
        if key + "cnt" not in self._arrays:
            self._need(key + "cnt", _put(pre["cnt"], dev))
        if need_sum and key + "sum" not in self._arrays:
            self._need(key + "sum", _put(pre["sum"], dev))
        if need_minmax:
            names = ("minA", "maxA") if col.narrow else \
                ("minA", "minB", "maxA", "maxB")
            for nm in names:
                if key + nm not in self._arrays:
                    self._need(key + nm, _put(pre[nm], dev))

    # -- permuted (layout) views ---------------------------------------------

    def _avalid_host(self, layout, perm=None) -> np.ndarray:
        """int8 [R]: the layout row's doc is alive and the row is real
        (`perm`: the layout rows' docs, when they are not layout.perm)."""
        perm = layout.perm if perm is None else perm
        return ((self.dindex.alive_host[perm] > 0)
                & (layout.valid_perm_host > 0)).astype(np.int8)

    @staticmethod
    def _layout_docs(layout, row_doc):
        """The doc of each layout row: layout.perm over docs, or composed
        with the value rows' docs (`row_doc`) for a value-row layout."""
        if row_doc is None:
            return layout.perm
        return row_doc[layout.perm].astype(np.int64)

    def _build_chain_view(self, layout, prefix, chain, row_doc=None):
        """Register the untransposed permuted planes a chain kernel scans,
        cached on the layout: the combined alive & valid plane `avalid`
        (int8) and the chain's mask-program planes. A value-row layout
        (`row_doc`, the value rows' docs) reads every doc-aligned plane at
        its rows' docs. The chain must be dense (_chain_is_dense). Returns
        the chain entry."""
        perm = self._layout_docs(layout, row_doc)

        def cache(key, build):
            if key not in layout.cache:
                layout.cache[key] = _put(np.ascontiguousarray(build()),
                                         self.device)
            self._need(prefix + key, layout.cache[key])

        cache("avalid", lambda: self._avalid_host(layout, perm))

        def planes_of(keys):
            for key in keys:
                f, kind = key.rsplit(":", 1)
                ph = self._col(f).host_plane(kind)
                cache(key, lambda ph=ph: ph[perm])

        entry = self._chain_entry(chain, prefix, planes_of)
        if not entry["mp"].dense:
            raise NotImplementedError(
                "a query chain with doc-space opcodes has no layout view")
        return entry

    def _payload_view(self, layout, prefix, fields):
        """The bucket layout's permuted payload sum planes of `fields`
        (the Sum / Avg subs of a prefix node), cached on the layout:
        {field: meta}; meta["skeys"] are the field's sum-plane keys,
        meta["cnt_key"] its per-doc value-count plane (multi-valued
        payloads), meta["direct"] the flat-sum shape (_payload_planes)."""
        pay_plan = {}
        for g in fields:
            if g in pay_plan:
                continue
            meta, planes = self._payload_planes(g, f"pay:{g}:s",
                                                f"pay:{g}:cnt")
            for k, ph in planes:
                if k not in layout.cache:
                    layout.cache[k] = _put(np.ascontiguousarray(
                        ph[layout.perm]), self.device)
                self._need(prefix + k, layout.cache[k])
            pay_plan[g] = meta
        return pay_plan

    def _payload_planes(self, g, sum_key, cnt_key):
        """The host planes [T] a bucket's sum(g) payload adds up, under
        keys `sum_key`+i and `cnt_key`: (meta, [(key, plane)]). Sums are the
        w plane (a flat sum), the exact limb planes, or a multi-valued
        field's per-doc pre-aggregate limbs plus its per-doc value count;
        meta["skeys"] / meta["cnt_key"] name them and meta["direct"] marks
        the flat-sum shape."""
        colg = self._col(g)
        cnt = None
        if colg.multi:
            pre = self._doc_preagg_host(colg)
            sums = [pre["sum"][:, i] for i in range(pre["sum"].shape[1])]
            cnt = pre["cnt"]
        elif colg.sum_direct:
            sums = [self._host_planes(colg)[0]]
        else:
            limbs = self._sum_limbs_host(colg)
            sums = [limbs[:, i] for i in range(limbs.shape[1])]
        planes = [(f"{sum_key}{i}", ph) for i, ph in enumerate(sums)]
        meta = {"skeys": [k for k, _ in planes],
                "cnt_key": None if cnt is None else cnt_key,
                "direct": colg.sum_direct and not colg.multi}
        if cnt is not None:
            planes.append((cnt_key, cnt))
        return meta, planes

    # -- value-domain cubes (ops/cube.py) -------------------------------------

    @staticmethod
    def _cube_query_ok(q) -> bool:
        """Queries whose mask over a single-valued narrow/stringy field reads
        ONLY the `{f}:w` plane and is elementwise in w — the property that
        makes evaluation over the virtual domain planes the chain predicate
        itself. PhraseQuery (position windows over the token stream) is the
        one field-query that is not. (An Exists leaf passes here and is
        refused by mask_program: such a tree answers on the host path.)"""
        if isinstance(q, Q.BooleanQuery):
            return all(Program._cube_query_ok(c)
                       for c in (*q.must, *q.should, *q.must_not))
        return isinstance(q, (Q.MatchAllQuery, Q.ExistsQuery, Q.TermQuery,
                              Q.RangeQuery, Q.PrefixQuery, Q.TermSetQuery,
                              Q.FuzzyTermQuery, Q.RegexQuery))

    def _chain_fields(self, chain):
        out = set()
        for q, _ in chain:
            qc.query_fields(q, out)
        return out

    def _cube_gate(self, chain):
        """(factors, Dprod) for a cube-able chain, else None: every chain
        field single-valued narrow/stringy, every chain query elementwise
        in w, product domain <= CUBE_DOM_CAP (int32 dot lanes < 2^24), at
        most MAX_BUILD_ROWS rows (the host build_sum exactness), and at
        least one extracted query param — match-all shaped chains keep the
        row paths."""
        if not self.config.use_cube:
            return None
        if self.dindex.T > C.MAX_BUILD_ROWS:
            return None
        if not all(self._cube_query_ok(q) for q, _ in chain):
            return None
        facs = []
        Dprod = 1
        for f in sorted(self._chain_fields(chain)):
            col = self._col(f)
            if col.multi or not (col.narrow or col.ftype.is_stringy):
                return None
            Df, off = C.factor_meta(col)
            facs.append((f, Df, off))
            Dprod *= Df
        if Dprod > C.CUBE_DOM_CAP \
                or not qc.chain_param_keys(chain, self.dindex):
            return None
        return tuple(facs), Dprod

    def _cube_host_cell(self, facs):
        """Host int64 domain-cell index per doc row (alive rows only;
        cached on the device index — shared by every cube over the same
        factor set). Built only where an operand misses the prep cache."""
        cc = self.dindex.cube_cache
        key = ("cell",) + tuple(f for f, _, _ in facs)
        if key not in cc:
            ws = [self._host_planes(self._col(f))[0] for f, _, _ in facs]
            cc[key] = C.host_cell(facs, ws, self.dindex.alive_host > 0)
        return cc[key]

    def _cube_site(self, facs, sig, build_groups):
        """Register one packed int8 piece operand (built host-exact on a
        miss, cached on the device index and in the prep cache); returns
        (array key, column layout), or (None, None) when the site exceeds
        the static column cap (the caller keeps the row paths)."""
        cc = self.dindex.cube_cache
        fkey = tuple(f for f, _, _ in facs)
        key = ("site",) + fkey + (sig,)
        if key not in cc:
            cc[key] = self._site_operand(key, build_groups)
        if cc[key] is None:
            return None, None
        dev, layout = cc[key]
        akey = "CUBE#" + "|".join(fkey) + "#" + sig
        self._need(akey, dev)
        return akey, layout

    def _site_operand(self, key, build_groups):
        """(device operand, layout) of a cube site, or None past
        CUBE_COLS_CAP: its pieces from the prep cache, or packed from
        `build_groups()`. On a mesh each shard packs its own rows' groups
        with the piece counts of the bounds across the shards (one column
        layout, JAX `pack_groups_sharded`), and the shards agree on
        whether the cache holds every shard's pieces."""
        di = self.dindex
        h = PC.load(*di.prep_anchor, di.prep_key(key))
        if self._sharded and not all(SH.allgather_obj(
                h is not None, ("site-hit",) + key)):
            h = None
        if h is not None:
            if "over" in h:
                return None
            pieces = h["pieces"]
            layout = [(str(nm), int(m), int(n)) for nm, m, n
                      in zip(h["lnames"], h["lm"], h["ln"])]
        else:
            groups = build_groups()
            bounds = C.group_bounds(groups)
            if self._sharded:
                bounds = C.merge_bounds(SH.allgather_obj(
                    bounds, ("site",) + key))
            pieces, layout = C.pack_groups(groups, bounds)
            PC.save(*di.prep_anchor, di.prep_key(key),
                    {"over": np.ones(1, np.int8)}
                    if pieces.shape[-1] > C.CUBE_COLS_CAP else
                    {"pieces": pieces,
                     "lnames": np.asarray([nm for nm, _, _ in layout],
                                          dtype="U"),
                     "lm": np.asarray([m for _, m, _ in layout]),
                     "ln": np.asarray([n for _, _, n in layout])})
        if pieces.shape[-1] > C.CUBE_COLS_CAP:
            return None
        return C.device_operand(pieces, self.device), layout

    def _cube_base(self, facs, Dprod, chain):
        """The indicator of a cube site: the chain's mask program over the
        virtual domain planes (cached per factor set), memoized per run
        under `ind_key` — nodes sharing a chain share it."""
        cc = self.dindex.cube_cache
        dkey = ("dom",) + tuple(f for f, _, _ in facs)
        if dkey not in cc:
            cc[dkey] = C.dom_planes(facs, self.device)[0]
        return {"factors": facs, "Dprod": Dprod, "dom": cc[dkey],
                "ind": self._chain_entry(chain, planes_of=lambda keys: None),
                "ind_key": (facs, tuple(qp for _, qp in chain))}

    def _plan_cube_count(self, p, chain) -> bool:
        g = self._cube_gate(chain)
        if g is None:
            return False
        facs, Dprod = g
        key, layout = self._cube_site(
            facs, "cnt", lambda: [("cnt", C.build_count(
                self._cube_host_cell(facs), Dprod))])
        if key is None:
            return False
        p["cube"] = {**self._cube_base(facs, Dprod, chain),
                     "key": key, "layout": layout}
        return True

    def _plan_cube_metric(self, node, p, chain) -> bool:
        g = self._cube_gate(chain)
        if g is None:
            return False
        facs, Dprod = g
        col = self._col(node.field)
        need_min, need_max, need_sum = self._metric_needs(node)
        sig = (f"metric:{node.field}:"
               f"{int(need_min)}{int(need_max)}{int(need_sum)}")

        def build_groups():
            cell = self._cube_host_cell(facs)
            if col.multi:
                pre = self._doc_preagg_host(col)
                groups = [("cnt", C.build_sum(cell, pre["cnt"], Dprod))]
                if need_sum:
                    sm = pre["sum"]
                    groups.append(("sum", np.stack(
                        [C.build_sum(cell, sm[:, i], Dprod)
                         for i in range(sm.shape[1])])))
                return groups
            groups = [("cnt", C.build_count(cell, Dprod))]
            if need_sum:
                if col.sum_direct:
                    groups.append(("sum", C.build_sum(
                        cell, self._host_planes(col)[0], Dprod)))
                else:
                    limbs = self._sum_limbs_host(col)
                    groups.append(("sum", np.stack(
                        [C.build_sum(cell, limbs[:, i], Dprod)
                         for i in range(limbs.shape[1])])))
            return groups

        key, layout = self._cube_site(facs, sig, build_groups)
        if key is None:
            return False
        cb = {**self._cube_base(facs, Dprod, chain),
              "key": key, "layout": layout, "mm": {}, "mm_narrow": col.narrow}
        if need_min or need_max:
            self._cube_minmax(cb, facs, Dprod, col, need_min, need_max)
        p["cube"] = cb
        return True

    def _cube_minmax(self, cb, facs, Dprod, col, need_min, need_max):
        """Per-cell min/max planes (beside the product operand): narrow ->
        one int32 [Dprod] plane; wide -> a [2, Dprod] (hi, lo) split of the
        int64 rm min/max. Empty-cell sentinels match the row reductions
        exactly (I32_MAX / -1 narrow, I64_MAX / I64_MIN wide). On a mesh a
        shard's planes cover its own rows (merged by _mmin / _mmax)."""
        cc = self.dindex.cube_cache
        fkey = tuple(f for f, _, _ in facs)
        if col.multi:
            pre = self._doc_preagg_host(col)
            valid = pre["cnt"] > 0
            if col.narrow:
                srcs = {"min": pre["minA"], "max": pre["maxA"]}
            else:
                srcs = {"min": (pre["minA"], pre["minB"]),
                        "max": (pre["maxA"], pre["maxB"])}
        else:
            valid = None
            hp = self._host_planes(col)
            srcs = {"min": (hp[0] if col.narrow else (hp[0], hp[1])),
                    "max": (hp[0] if col.narrow else (hp[0], hp[1]))}
        for which, need in (("min", need_min), ("max", need_max)):
            if not need:
                continue
            ck = ("mm",) + fkey + (col.name, which, col.multi)
            if ck not in cc:
                def build(which=which):
                    src = srcs[which]
                    cell = self._cube_host_cell(facs)
                    if col.narrow:
                        return (C.build_min32(cell, src, Dprod, valid)
                                if which == "min"
                                else C.build_max32(cell, src, Dprod, valid))
                    hi, lo = src
                    rm = ((hi.astype(np.int64) << 32)
                          + lo.astype(np.int64) + 2**31)
                    m64 = (C.build_min64(cell, rm, Dprod, valid)
                           if which == "min"
                           else C.build_max64(cell, rm, Dprod, valid))
                    return np.stack(C.split_rm(m64))
                cc[ck] = _put(self._prep_cached(
                    ck, build, lambda a: {"a": a}, lambda h: h["a"]),
                    self.device)
            akey = (f"CUBE#{'|'.join(fkey)}#mm:{col.name}:{which}:"
                    f"{col.multi}")
            self._need(akey, cc[ck])
            cb["mm"][which] = akey

    def _cube_ind(self, cb, pmat):
        """[B, Dprod] bool chain indicator: the chain's mask program over
        the virtual domain planes — the same op list the kernels and the
        row path interpret, so the predicate semantics are identical by
        construction. Memoized per run (nodes sharing a chain share it)."""
        hit = self._ind_cache.get(cb["ind_key"])
        if hit is None:
            e = cb["ind"]
            hit = qc.eval_ops(e["mp"].ops,
                              [cb["dom"][k] for k in e["mp"].plane_keys],
                              self._chain_pmat(e, pmat), (cb["Dprod"],))
            self._ind_cache[cb["ind_key"]] = hit
        return hit

    def _cube_rec(self, cb, pmat, arrays):
        """Indicator + recombined group values ({name: [B] or [B, m]}). On
        a mesh each shard dots its own operand and the int32 dot vectors
        are psum'd (lanes < S * 2^24: C.shard_dots asserts S <=
        C.MAX_SHARDS) before the recombination, which is linear in them."""
        ind = self._cube_ind(cb, pmat)
        if self._sharded:
            dots = C.shard_dots(ind, arrays[cb["key"]], self.dindex.n_shards,
                                SH.psum)
        else:
            dots = C.cube_dots(ind, arrays[cb["key"]])
        return ind, C.recombine(dots, cb["layout"])

    @staticmethod
    def _cube_mm_eval(cb, ind, arrays, which, is_min):
        """min / max over the matched cells' planes: a where and a reduce
        over Dprod (no product)."""
        a = arrays[cb["mm"][which]]
        if cb["mm_narrow"]:
            v = torch.where(ind, a, C.I32_MAX if is_min else -1)
        else:
            v = torch.where(ind, R.wide_recon(a[0], a[1]),
                            R.I64_MAX if is_min else R.I64_MIN)
        return v.amin(dim=-1) if is_min else v.amax(dim=-1)

    def _eval_metric_cube(self, node, pmat, arrays, p):
        cb = p["cube"]
        need_min, need_max, need_sum = self._metric_needs(node)
        ind, rec = self._cube_rec(cb, pmat, arrays)
        out = {"cnt": rec["cnt"]}
        if need_min:
            out["min"] = self._mmin(
                self._cube_mm_eval(cb, ind, arrays, "min", True))
        if need_max:
            out["max"] = self._mmax(
                self._cube_mm_eval(cb, ind, arrays, "max", False))
        if need_sum:
            out["sum"] = rec["sum"]
        return out

    def _plan_cube_bucket(self, node, p, path, *, sig, chain, nb, bid_host,
                          sub_hdims, sub_tflat, sub_bchain) -> bool:
        """Cube lowering for a ROOT-LEVEL dense bucket agg (histogram or
        small-card terms) over a cube-able chain whose subs are
        Count/Sum/Avg and percentiles: per-bucket counts and the
        Count/Sum/Avg fruits become [nb, Dprod]-shaped exact piece operands
        — bucket j's fruit is one more dot lane of the SAME [B, Dprod]
        indicator product — and the percentiles plan in-slot (slot_rank).
        Records p["cube"] and plans the subs; False keeps the row modes."""
        CSA = (A.CountAgg, A.SumAgg, A.AvgAgg)
        sub_aggs = [ns2 for ns2 in node.sub_aggs if isinstance(ns2[1], CSA)]
        rest = [ns2 for ns2 in node.sub_aggs if not isinstance(ns2[1], CSA)]
        if not all(isinstance(s2, A.PercentilesAgg) for _, s2 in rest):
            return False
        g = self._cube_gate(chain)
        if g is None:
            return False
        facs, Dprod = g
        if Dprod * nb > C.CUBE_BCELLS_CAP:
            return False
        subs = {}
        for name, s in sub_aggs:
            if isinstance(s, A.CountAgg):
                continue
            scol = self._col(s.field)
            if scol.multi:
                subs[name] = {
                    "multi": True,
                    "L": int(self._doc_preagg_host(scol)["sum"].shape[1])}
            elif scol.sum_direct:
                subs[name] = {"multi": False, "L": 0}
            else:
                subs[name] = {
                    "multi": False,
                    "L": int(self._sum_limbs_host(scol).shape[1])}
        sig += "#" + "|".join(
            f"{name}:{type(s).__name__}:{getattr(s, 'field', '')}"
            for name, s in sub_aggs)

        def build_groups():
            cell2 = C.bucket_cell(self._cube_host_cell(facs), bid_host(),
                                  nb)
            groups = [("counts", C.build_bucket_counts(cell2, Dprod, nb))]
            for name, s in sub_aggs:
                if isinstance(s, A.CountAgg):
                    continue  # eval reuses the counts group
                scol = self._col(s.field)
                if scol.multi:
                    pre = self._doc_preagg_host(scol)
                    groups.append((f"c:{name}", C.build_bucket_sums(
                        cell2, pre["cnt"], Dprod, nb)))
                    limbs = pre["sum"]
                elif scol.sum_direct:
                    groups.append((f"s:{name}", C.build_bucket_sums(
                        cell2, self._host_planes(scol)[0], Dprod, nb)))
                    continue
                else:
                    limbs = self._sum_limbs_host(scol)
                S = np.stack(
                    [C.build_bucket_sums(cell2, limbs[:, i], Dprod, nb)
                     for i in range(limbs.shape[1])], axis=1)
                groups.append((f"s:{name}",
                               S.reshape(nb * limbs.shape[1], Dprod)))
            return groups

        key, layout = self._cube_site(facs, sig, build_groups)
        if key is None:
            return False
        p["mode"] = "dense"
        p["cube"] = {**self._cube_base(facs, Dprod, chain), "key": key,
                     "layout": layout, "nb": nb, "subs": subs}
        for name, sub in sub_aggs:
            if isinstance(sub, A.CountAgg):
                self.plan[path + (name,)] = {"kind": "count",
                                             "hdims": sub_hdims}
            else:
                self.plan[path + (name,)] = self._metric_plan_dict(
                    sub, sub_hdims)
        for name, sub in rest:
            self._plan_aggs(sub, path + (name,), in_slot=True,
                            hdims=sub_hdims, tflat=sub_tflat, chain=chain,
                            bchain=sub_bchain)
        return True

    def _eval_bucket_cube(self, node, p, pmat, arrays):
        """(counts [B, nb], sub_out) for a cube'd root bucket agg — the
        shapes of the dense row formulation's slot fruits (direct sums
        [B, nb], limb sums [B, nb, L]), so selection and harvest are
        shared; percentile subs evaluate as planned (they read no ctx)."""
        cb = p["cube"]
        nb = cb["nb"]
        _, rec = self._cube_rec(cb, pmat, arrays)
        B = pmat.shape[0]
        counts = rec["counts"].reshape(B, nb)
        sub_out = {}
        for name, sub in node.sub_aggs:
            if isinstance(sub, A.CountAgg):
                sub_out[name] = {"cnt": counts}
                continue
            if isinstance(sub, A.PercentilesAgg):
                sub_out[name] = self._eval_percentiles(
                    pmat, arrays, self.plan[p["path"] + (name,)])
                continue
            spec = cb["subs"][name]
            cnt = (rec[f"c:{name}"].reshape(B, nb) if spec["multi"]
                   else counts)
            s = rec[f"s:{name}"]
            sub_out[name] = {
                "cnt": cnt,
                "sum": (s.reshape(B, nb) if spec["L"] == 0
                        else s.reshape(B, nb, spec["L"]))}
        return counts, sub_out

    def _perm_cell(self, facs, layout):
        """int32 domain-cell plane over the layout's permuted rows (-1 on
        dead or padding rows), from the chain view's permuted w planes."""
        strides, _ = C.strides_of(facs)
        cell = torch.zeros(layout.n_rows, dtype=torch.int32,
                           device=self.device)
        for (f, _, off), st in zip(facs, strides):
            cell += (layout.cache[f"{f}:w"] + off) * st
        return torch.where(layout.cache["avalid"] > 0, cell, -1)

    def _plan_cube_pct(self, p, chain, layout):
        """Cube lowering for the flat rank-percentile prefix: per-G-row
        block chain-match counts from one int8 product against a static
        two-digit per-block cell histogram, built once on the device from
        the permuted chain planes the window recompute keeps resident.
        Unsharded only (JAX: its block axis is the layout row order, which
        a mesh bisects instead)."""
        g = None if self._sharded else self._cube_gate(chain)
        if g is None:
            return None
        facs, Dprod = g
        G = C.choose_block(layout.n_rows, Dprod)
        if G is None:
            return None
        fkey = tuple(f for f, _, _ in facs)
        cc = self.dindex.cube_cache
        ck = ("phist", p["prefix"], fkey, G)
        if ck not in cc:
            cc[ck] = self._prep_cached(
                ck, lambda: C.build_blockhist(self._perm_cell(facs, layout),
                                              Dprod, G),
                _t2h, lambda h: _h2t(h, self.device))
        key = f"PCUBE#{p['prefix']}#{'|'.join(fkey)}#{G}"
        self._need(key, cc[ck])
        return {**self._cube_base(facs, Dprod, chain), "key": key, "G": G,
                "NB": layout.n_rows // G}

    def _plan_cube_slots(self, p, chain, layout, nslots):
        """Cube lowering for slot_rank nested percentiles: per-(slot,
        block) chain-match counts from one int8 product against a static
        histogram over (composite ancestor slot, G-row block, domain cell),
        built once on the device from the permuted planes and the static
        composite-slot plane (p["slotk"]). Unsharded only."""
        g = None if self._sharded else self._cube_gate(chain)
        if g is None:
            return None
        facs, Dprod = g
        G = C.choose_block_ns(layout.n_rows, Dprod, nslots)
        if G is None:
            return None
        fkey = tuple(f for f, _, _ in facs)
        cc = self.dindex.cube_cache
        ck = ("shist", p["prefix"], fkey, G, p["slotk"])
        if ck not in cc:
            cc[ck] = self._prep_cached(
                ck, lambda: C.build_slot_blockhist(
                    self._perm_cell(facs, layout), layout.cache[p["slotk"]],
                    nslots, Dprod, G),
                _t2h, lambda h: _h2t(h, self.device))
        key = f"SCUBE#{p['prefix']}#{'|'.join(fkey)}#{G}#{p['slotk']}"
        self._need(key, cc[ck])
        return {**self._cube_base(facs, Dprod, chain), "key": key, "G": G,
                "NB": layout.n_rows // G}

    # -- dense products (ops/reductions.py *_mm) -----------------------------

    def _dense_op(self, key, K, rows, build):
        """Register the resident operand `build()` of masked_sum_planes_mm
        under `key` (cached on the device index) when its [rows, K] fits
        R.DENSE_OP_MEM, and return its array key; None where the product
        builds its operand per row chunk instead."""
        if rows * R.pad8(K) * R.mm_dtype(self.device).itemsize \
                > R.DENSE_OP_MEM:
            return None
        cc = self.dindex.cube_cache
        ck = ("dmm", key)
        if ck not in cc:
            cc[ck] = build()
        akey = f"DMM#{key}"
        self._need(akey, cc[ck])
        return akey

    def _dense_counts_plan(self, bid_key, doc=None):
        """The dense_buckets entry of a dense bucket node right under a
        MaskCtx (its counts, and its count and metric subs', run the
        kernel over its static bucket plane, array `bid_key`). `doc`: the
        rows' docs where the rows are a multi-valued field's value rows
        (its subs' payloads are read there)."""
        return {"bid_key": bid_key, "doc": doc}

    def _dense_sum_plan(self, sbid, key, plane, bound):
        """(bound, array key) of one payload plane's dense bucket sums
        under the static bucket plane of `sbid`: the doc-aligned payload
        `plane` (array key `key` where it is registered whole) at the
        bucket rows, as the contiguous int32 plane dense_buckets reads —
        itself, or a resident copy cached on the device index where the
        rows are a multi-valued field's value rows (`plane[doc]`) or the
        plane is a column of a wider array. The key is None for a payload
        bounded to (0, 0), whose sums are 0."""
        if bound is not None and tuple(bound) == (0, 0):
            return (bound, None)
        doc = sbid["doc"]
        if doc is None and self._arrays.get(key) is plane \
                and plane.is_contiguous():
            return (bound, key)
        rows_of = None if doc is None else sbid["bid_key"]
        cc = self.dindex.cube_cache
        ck = ("dense_pay", rows_of, key)
        if ck not in cc:
            cc[ck] = (plane if doc is None else plane[doc]).contiguous()
        akey = f"DPAY#{rows_of}#{key}"
        self._need(akey, cc[ck])
        return (bound, akey)

    def _dense_planes_plan(self, key, planes, bounds):
        """(bounds, operand key) of a MaskCtx metric's masked sums of
        several static planes as one product."""
        live = [b for b in bounds if tuple(b) != (0, 0)]
        K = sum(R.npieces_for_bound(b) for b in live)
        return (bounds, self._dense_op(
            f"{key}:{tuple(map(tuple, bounds))}", K, planes[0].shape[0],
            lambda: R.sum_planes_operand(planes, bounds)))

    # -- node planners -------------------------------------------------------

    def _plan_aggs(self, node, path, *, in_slot, hdims, tflat, chain,
                   bchain, sbid=None, parent_single=True):
        """`bchain`: the dense bucket ancestors a slot_rank percentile
        descendant composes its slot plane from — (("hist", field, hist
        plan) | ("terms", field, card) | ("mterms", field, card), ...) — or
        None once an ancestor cannot thread a static slot. `sbid`: the
        parent's dense product entries (_dense_counts_plan; one per
        per-position plane of a plane fan-out) when the parent is a dense
        bucket node right under a MaskCtx, so this node's counts and sums
        are dense products over its static bucket plane(s).
        `parent_single`: the slot context stays doc-rooted (no ancestor is
        a multi-valued bucket field whose value rows the children chain
        over)."""
        if isinstance(node, (dict, tuple)):
            items = node.items() if isinstance(node, dict) else node
            for name, sub in items:
                self._plan_aggs(sub, path + (name,), in_slot=in_slot,
                                hdims=hdims, tflat=tflat, chain=chain,
                                bchain=bchain, sbid=sbid,
                                parent_single=parent_single)
            return
        if isinstance(node, A.CountAgg):
            p = {"kind": "count", "hdims": hdims}
            if in_slot or not self._plan_cube_count(p, chain):
                self._reads_root = True
            if sbid is not None:
                p["dense_mm"] = {e["bid_key"]: {} for e in sbid}
            self.plan[path] = p
            return
        if isinstance(node, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg,
                             A.StatsAgg)):
            self._plan_metric(node, path, hdims,
                              chain=None if in_slot else chain, sbid=sbid)
            return
        if isinstance(node, A.PercentilesAgg):
            if in_slot:
                self._plan_percentiles_slots(node, path, hdims, chain,
                                             bchain)
            else:
                self._plan_percentiles(node, path, hdims, chain)
            return
        if isinstance(node, (A.HistogramAgg, A.TermsAgg)):
            plan = (self._plan_histogram if isinstance(node, A.HistogramAgg)
                    else self._plan_terms)
            plan(node, path, in_slot=in_slot, hdims=hdims, tflat=tflat,
                 chain=chain, bchain=bchain, parent_single=parent_single)
            return
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            sub_chain = chain + ((node.query, path + ("fq",)),)
            p = {"kind": "filter", "hdims": hdims}
            if in_slot or not self._plan_cube_count(p, sub_chain):
                self._reads_root = True
            p["fmask"] = self._chain_entry(((node.query, path + ("fq",)),))
            self.plan[path] = p
            self._plan_aggs(node.sub_aggs, path, in_slot=in_slot,
                            hdims=hdims, tflat=tflat, chain=sub_chain,
                            bchain=bchain, parent_single=parent_single)
            return
        if isinstance(node, A.TopHitsAgg):
            self._plan_top_hits(node, path, in_slot=in_slot, hdims=hdims,
                                tflat=tflat)
            return
        raise TypeError(f"unknown agg {type(node)!r}")

    def _plan_top_hits(self, node, path, *, in_slot, hdims, tflat):
        """top_hits, flat or in-slot (JAX `_plan_aggs`' top_hits branch):
        under buckets the shipped fruit is the selected buckets' [k] hits,
        so prod(hdims) * k bounds the transfer and tflat * k the device
        [slots, k] output; past either the shape answers on the host
        path. Score order where sort_field is None. On a mesh each shard
        keeps its own top k and the k-way merge keeps k of the index's."""
        k = min(node.size, self.dindex.global_T)
        if in_slot:
            out_flat = 1
            for d in hdims:
                out_flat *= d
            if out_flat * k > 4096 or tflat * k > (1 << 22):
                raise NotImplementedError(
                    "top_hits under huge bucket spaces answers through "
                    "the exact host fallback")
        p = {"kind": "top_hits", "hdims": hdims, "k": k, "in_slot": in_slot,
             "tflat": tflat, "path": path,
             "doc_key": self._row_doc(path) if in_slot else None}
        self.plan[path] = p
        self._reads_root = True
        self._top_hits.append((node, p))
        if node.sort_field is None:
            p["score"] = True
            return
        col = self._col(node.sort_field)
        if col.multi:
            raise TypeError("top_hits sort field must be single-valued")
        self._need_col_planes(col)
        p.update(narrow=col.narrow, min_mono=col.min_mono, ftype=col.ftype)

    @staticmethod
    def _metric_needs(node):
        need_min = isinstance(node, (A.MinAgg, A.StatsAgg))
        need_max = isinstance(node, (A.MaxAgg, A.StatsAgg))
        need_sum = isinstance(node, (A.SumAgg, A.AvgAgg, A.StatsAgg))
        return need_min, need_max, need_sum

    def _metric_plan_dict(self, node, hdims):
        """Harvest metadata for a metric node."""
        col = self._col(node.field)
        return {"kind": "metric", "ftype": col.ftype, "narrow": col.narrow,
                "multi": col.multi,
                "direct": col.sum_direct and not col.multi,
                "min_mono": col.min_mono,
                "min_user": (col.min_user() if col.ftype != FieldType.F64
                             else None),
                "base": col.f64_base_exp, "hdims": hdims}

    def _plan_metric(self, node, path, hdims, chain=None, sbid=None):
        """A metric node: on the cube where `chain` (root / filter scope)
        passes the gate; else its row planes, with p["dense_mm"] where its
        sums are dense products (in a static dense parent, `sbid`, or at
        root / filter scope for multi-valued and limb sums)."""
        col = self._col(node.field)
        need_min, need_max, need_sum = self._metric_needs(node)
        p = self._metric_plan_dict(node, hdims)
        self.plan[path] = p
        if chain is not None and self._plan_cube_metric(node, p, chain):
            return  # no row planes: the cube answers every fruit
        self._reads_root = True
        T = self.dindex.T
        if col.multi:
            self._need_preagg(col, need_sum, need_min or need_max)
            pre = f"{col.name}:pre:"
            pb = col.preagg_bounds(T)
            cnt = self._arrays[pre + "cnt"]
            sums = ([self._arrays[pre + "sum"][:, i]
                     for i in range(self._arrays[pre + "sum"].shape[1])]
                    if need_sum else [])
            if sbid is not None:
                p["dense_mm"] = {e["bid_key"]: {
                    "pcnt": self._dense_sum_plan(e, pre + "cnt", cnt,
                                                 pb["cnt"]),
                    "sums": [self._dense_sum_plan(e, f"{pre}sum{i}", v,
                                                  pb["sum"][i])
                             for i, v in enumerate(sums)]} for e in sbid}
            elif chain is not None and self.config.dense_mxu:
                p["dense_mm"] = {"planes": self._dense_planes_plan(
                    f"{pre}{int(need_sum)}", [cnt] + sums,
                    [pb["cnt"]] + (pb["sum"] if need_sum else []))}
            return
        self._need_col_planes(col)
        if need_sum and not col.sum_direct:
            self._need(f"{node.field}:limbs", col.sum_limbs())
        # root/filter-scope narrow metrics run the fused kernel
        p["fused"] = col.narrow and not hdims
        if sbid is not None:
            def sums_of(e):
                if need_sum and col.sum_direct:
                    return [self._dense_sum_plan(
                        e, f"{col.name}:w", col.w, (0, int(col.span)))]
                if need_sum:
                    limbs = col.sum_limbs()
                    return [self._dense_sum_plan(e, f"{col.name}:limbs{i}",
                                                 limbs[:, i], b)
                            for i, b in enumerate(col.limb_bounds())]
                return []
            p["dense_mm"] = {e["bid_key"]: {"sums": sums_of(e)}
                             for e in sbid}
        elif (chain is not None and self.config.dense_mxu and need_sum
              and not col.sum_direct):
            limbs = col.sum_limbs()
            p["dense_mm"] = {"planes": self._dense_planes_plan(
                f"{col.name}:limbs",
                [limbs[:, i] for i in range(limbs.shape[1])],
                col.limb_bounds())}

    def _plan_percentiles(self, node, path, hdims, chain):
        """Rank percentiles over the field's value layout (docs, or the
        value rows of a multi-valued field, each read at its doc): the
        pcube or the chain_counts kernel over the permuted chain planes
        where the chain is dense; else the scope's doc mask gathered
        through the static row->doc plane (`mask_gather`). Non-integer
        percents keep the count prefix for phase 2 and take no pcube (as
        in JAX)."""
        col = self._col(node.field)
        layout = col.value_layout()
        prefix = f"VL:{node.field}#"
        p = {"kind": "percentiles", "ftype": col.ftype, "narrow": col.narrow,
             "min_mono": col.min_mono, "percents": node.percents,
             "hdims": hdims, "pmode": "rank", "path": path,
             "int_percents": _int_percents(node),
             "layout": layout, "prefix": prefix,
             # a mesh selects by cross-shard bisection of the value domain
             "bisect": self._sharded, "span": col.span}
        self.plan[path] = p
        if p["bisect"]:
            self._need_sorted_values(col, layout, prefix)
        row_doc = (col.global_doc_of_rows(self.dindex.T) if col.multi
                   else None)
        if not self._chain_is_dense(chain):
            # overflow tails / token streams among the query fields: the
            # chain cannot be re-evaluated in permuted row space
            p["mask_gather"] = True
            p["pcube"] = None
            p["pallas_counts"] = False
            self._reads_root = True
            self._register_pdoc(layout, prefix, row_doc)
            return
        p["chainp"] = self._build_chain_view(layout, prefix, chain,
                                                row_doc=row_doc)
        # the value-domain cube: per-block counts from one int8 product
        # against a static block histogram, in place of chain_counts
        # (unsharded)
        p["pcube"] = (self._plan_cube_pct(p, chain, layout)
                      if p["int_percents"] else None)
        p["pallas_counts"] = p["pcube"] is None
        if p["pallas_counts"]:
            self._need_chain_fit(p["chainp"])

    def _need_sorted_values(self, col, layout, prefix):
        """Register the layout's ascending value plane `sv` (int64 [R]: w
        for a narrow column, rm = w - 2^63 for a wide one; I64_MAX on
        invalid and padding rows, which sort last): the domain a sharded
        bisection searches (JAX `_need_sorted_value_planes`)."""
        if "sv" not in layout.cache:
            from ..index.loader import _w_u64
            sm = layout.sorted_mono
            n = sm.shape[0]
            w = _w_u64(sm, col.min_mono)
            v = (w.astype(np.int64) if col.narrow
                 else (w - np.uint64(2**63)).view(np.int64))
            sv = np.full(layout.n_rows, R.I64_MAX, np.int64)
            sv[:n] = np.where(layout.valid_perm_host[:n] > 0, v, R.I64_MAX)
            layout.cache["sv"] = _put(sv, self.device)
        self._need(prefix + "sv", layout.cache["sv"])

    def _register_pdoc(self, layout, prefix, row_doc):
        """The static doc of each permuted layout row ("pdoc", int64) and
        the layout's row validity ("lvalid"): a non-dense chain's rows read
        the scope's doc mask at mask[:, pdoc]."""
        if "pdoc" not in layout.cache:
            layout.cache["pdoc"] = _put(
                self._layout_docs(layout, row_doc).astype(np.int64),
                self.device)
            layout.cache["lvalid"] = _put(layout.valid_perm_host > 0,
                                          self.device)
        self._need(prefix + "pdoc", layout.cache["pdoc"])
        self._need(prefix + "lvalid", layout.cache["lvalid"])

    def _plan_percentiles_slots(self, node, path, hdims, chain, bchain):
        """slot_rank: per-bucket percentiles under dense bucket ancestors,
        counted per (slot, 32-row block) of the field's value layout
        against a static composite slot plane (_build_slotcomp): by the
        chain_slot_counts kernel, or the scube. A multi-valued percentile
        field, and a multi-valued terms ancestor ("mterms": wslots, each
        of a doc's value positions a slot factor of its own, so a doc
        holding the bucket's value twice counts twice), count with torch
        ops over the chain mask instead (the JAX package's non-kernel
        path). Non-integer percents take the torch path too, with one
        composite slot plane under single-valued ancestors (JAX plans them
        without the kernel and the scube), and keep its count prefix for
        phase 2."""
        col = self._col(node.field)
        int_p = _int_percents(node)
        mts = [e for e in (bchain or ()) if e[0] == "mterms"]
        if not bchain or not self._chain_is_dense(chain) or len(mts) > 1:
            raise NotImplementedError(
                "percentiles under bucket aggs need dense ancestors (at "
                "most one multi-valued terms ancestor) and a dense chain")
        if mts and self._sharded:
            # JAX: the cross-shard bisection has no weighted variant
            raise NotImplementedError(
                "occurrence-weighted percentiles under a multi-valued terms "
                "ancestor answer on the host path on a mesh")
        nslots = 1
        for kind, _, meta in bchain:
            nslots *= meta["nb"] if kind == "hist" else meta
        layout = col.value_layout()
        ns_ok = nslots <= self.dense_nb
        if not ns_ok and int_p and nslots <= K.PCT_SLOT_CAP \
                and not col.multi and not self._sharded:
            # past the dense budget: the scube keeps [ns, R/G] state, the
            # kernel [ns, R/32] under a byte bound
            g = self._cube_gate(chain)
            ns_ok = ((g is not None and C.choose_block_ns(
                         layout.n_rows, g[1], nslots) is not None)
                     or (layout.n_rows // SLOT_GROUP) * nslots * 4
                     <= self.BIG_SLOT_MEM)
        if not ns_ok:
            raise NotImplementedError(
                f"slot_rank percentiles over {nslots} slots exceed the "
                "device budget")
        prefix = f"VL:{node.field}#"
        row_doc = (col.global_doc_of_rows(self.dindex.T) if col.multi
                   else None)
        entry = self._build_chain_view(layout, prefix, chain,
                                          row_doc=row_doc)
        p = {"kind": "percentiles", "ftype": col.ftype, "narrow": col.narrow,
             "min_mono": col.min_mono, "percents": node.percents,
             "hdims": hdims, "pmode": "slot_rank", "int_percents": int_p,
             "nslots": nslots, "layout": layout, "prefix": prefix,
             "chainp": entry, "wslots": bool(mts), "path": path,
             # a mesh selects by per-slot cross-shard bisection, and phase
             # 2 of non-integer percents emits values
             "slot_bisect": self._sharded,
             "phase2_vals": self._sharded and not int_p,
             "span": col.span}
        self.plan[path] = p
        if p["slot_bisect"]:
            self._need_sorted_values(col, layout, prefix)
        if mts or col.multi or not int_p:
            mcol = self._col(mts[0][1]) if mts else None
            K_ = len(mcol.multi_planes_host) if mts else 1
            p["slotks"] = [self._build_slotcomp(layout, prefix, bchain,
                                                row_doc, k if mts else None)
                           for k in range(K_)]
            p["scube"] = None
            p["pallas_slots"] = False
            return
        p["slotk"] = self._build_slotcomp(layout, prefix, bchain)
        # the value-domain cube: per-(slot, block) counts from one int8
        # product, in place of chain_slot_counts
        p["scube"] = self._plan_cube_slots(p, chain, layout, nslots)
        p["pallas_slots"] = p["scube"] is None
        if p["pallas_slots"]:
            self._need_chain_fit(entry, 1, nslots)

    def _build_slotcomp(self, layout, prefix, bchain, row_doc=None,
                        mpos=None) -> str:
        """The STATIC composite ancestor-slot plane over the value layout's
        rows (host-exact, cached on the layout): int32 [R], the flat slot
        in [0, nslots) row-major over the bchain, or -1 where a terms
        ancestor has no value. Hist ids come from _host_bucket_ids (the
        source of the dense bid planes), terms ids from the w / tid host
        planes, each read at the row's doc (`row_doc`: a value-row
        layout). An "mterms" ancestor contributes its bucket id through
        the doc's value at position `mpos` (JAX `_register_mslots`: the
        keyword ordinal, or a number's distinct-value id). Returns its key
        (registered under `prefix`)."""
        perm = self._layout_docs(layout, row_doc)
        sig = []
        for kind, f, meta in bchain:
            if kind == "terms":
                sig.append(f"t:{f}:{meta}")
            elif kind == "mterms":
                sig.append(f"m:{f}:{meta}:{mpos}")
            else:
                rb = meta.get("rbounds")
                sig.append("h:%s:%s:%s:%s:%s:%s" % (
                    f, meta["hmode"], meta["nb"], meta.get("w_base"),
                    meta.get("iv"),
                    None if rb is None else hash(rb.tobytes())))
        key = "slotcomp@" + "|".join(sig)
        if key not in layout.cache:
            slot = np.zeros(len(perm), np.int64)
            valid = np.ones(len(perm), bool)
            for kind, f, meta in bchain:
                colf = self._col(f)
                if kind == "hist":
                    bid = self._host_bucket_ids(colf, meta)[perm]
                    slot = slot * meta["nb"] + bid
                    continue
                if kind == "mterms":
                    ph = colf.multi_planes_host[mpos]
                    if colf.ftype.is_stringy:
                        ids = ph.astype(np.int64)
                    else:
                        uniq = colf.term_ids()[1]
                        ids = np.searchsorted(
                            uniq, ph.astype(np.int64) + colf.min_mono)
                        ids = np.where(ph >= 0,
                                       np.clip(ids, 0, len(uniq) - 1), -1)
                    ids = ids[perm]
                elif colf.ftype.is_stringy:
                    ids = self._host_planes(colf)[0][perm]
                else:
                    ids = colf.term_ids()[0][perm]
                valid &= ids >= 0
                slot = slot * meta + np.maximum(ids, 0)
            layout.cache[key] = _put(
                np.where(valid, slot, -1).astype(np.int32), self.device)
        self._need(prefix + key, layout.cache[key])
        return key

    def _hist_layout(self, col, node):
        if col.n_values == 0:
            return {"hmode": "empty", "k_min": 0, "nb": 1}
        if getattr(node, "calendar", None):
            # calendar intervals: static period boundaries over the
            # column's [min, max]; bucket keys are the period starts
            from ..utils import calendar as cal
            lo = mono_mod.scalar_from_mono("date", col.min_mono)
            hi = mono_mod.scalar_from_mono("date", col.max_mono)
            keys, inner = cal.calendar_layout(node.calendar, lo, hi)
            nb = len(keys)
            if nb > MAX_HIST_NB:
                raise NotImplementedError(
                    f"calendar histogram would span {nb} buckets on device")
            # rm domain: rm = (mono - min_mono) - 2^63; boundary micros b ->
            # mono = b - 2^63 (the u64->mono shift)
            rb = [_wrap64(((int(b) - 2**63) - col.min_mono) - 2**63)
                  for b in inner]
            return {"hmode": "bounds", "k_min": 0, "nb": nb,
                    "rbounds": np.asarray(rb, np.int64),
                    "keys": np.asarray(keys, np.int64)}
        if col.ftype == FieldType.F64:
            span_m = _range_layout(self.query, col, node)
            lo_m, hi_m = span_m or (col.min_mono, col.max_mono)
            nb = _f64_nb(lo_m, hi_m, node)
            if nb > MAX_HIST_NB:
                raise NotImplementedError(
                    f"f64 histogram would span {nb} buckets on device"
                    if span_m is None else
                    f"f64 histogram would span {nb} buckets on device "
                    f"over its query's range on {node.field!r}")
            k_min, bounds_mono = exact.f64_histogram_buckets(
                mono_mod.scalar_from_mono("f64", lo_m),
                mono_mod.scalar_from_mono("f64", hi_m),
                float(node.interval), float(node.offset))
            rb = [_wrap64((int(b) - col.min_mono) - 2**63)
                  for b in bounds_mono]
            out = {"hmode": "bounds", "k_min": k_min, "nb": nb,
                   "rbounds": np.asarray(rb, np.int64)}
            if span_m is not None:
                out["range"] = span_m
                counters["hist_range_layouts"] += 1
            return out
        iv, off = int(node.interval), int(node.offset)
        lo_u = col.min_user()
        hi_u = mono_mod.scalar_from_mono(col.ftype.value, col.max_mono)
        k_min = (lo_u - off) // iv
        k_max = (hi_u - off) // iv
        nb = k_max - k_min + 1
        if nb > MAX_HIST_NB_HOST:
            raise NotImplementedError(
                f"histogram column spans {nb} buckets (the host path "
                "applies the realized-span ceiling)")
        # j = (w - w_base) // iv with w_base = (off + k_min*iv) - lo_u <= 0
        w_base = (off + k_min * iv) - lo_u
        span_num = col.span - w_base
        if span_num <= 2**63 - 1:
            return {"hmode": "direct64", "k_min": k_min, "nb": nb,
                    "w_base": int(w_base), "iv": iv}
        raise NotImplementedError("histogram span exceeds 2^63")

    @staticmethod
    def _host_bucket_ids(col, p) -> np.ndarray:
        """Exact host computation of 0-based bucket indices per row
        (padding/invalid rows land in bucket 0; masked off at query time)."""
        from ..index.loader import _w_u64
        m = col._host_mono
        if p["hmode"] == "empty":
            return np.zeros(m.shape[0], np.int64)
        if p["hmode"] == "bounds":
            rm = (_w_u64(m, col.min_mono)
                  - np.uint64(2**63)).view(np.int64)
            return np.searchsorted(p["rbounds"], rm, side="right")
        w = _w_u64(m, col.min_mono)
        num = w + np.uint64(-p["w_base"])  # fits u64 (span_num checked)
        return (num // np.uint64(p["iv"])).astype(np.int64)

    def _sub_kinds_ok(self, node) -> bool:
        return all(isinstance(s, (A.CountAgg, A.SumAgg, A.AvgAgg))
                   for _, s in node.sub_aggs)

    def _plan_prefix(self, node, p, layout, prefix, chain, hdims, nb):
        """Prefix-mode lowering of a root-level bucket agg over a dense
        chain: a member operand when the chain allows one, else the
        chain_blocks kernel over the bucket layout's permuted view; a
        non-dense chain gathers the scope's doc mask through the static
        pdoc plane instead (`mask_gather`). The metric subs keep only
        harvest metadata (their sums come from the payloads)."""
        p["prefix"] = prefix
        if self._chain_is_dense(chain):
            p["pallas_prefix"] = not self._plan_member_op(node, p, chain,
                                                          layout, prefix)
            if p["pallas_prefix"]:
                self._plan_chain_blocks(node, p, layout, prefix, chain)
        else:
            p["pallas_prefix"] = False
            p["mask_gather"] = True
            p["layout"] = layout
            self._reads_root = True
            self._register_pdoc(layout, prefix, None)
            p["pay_plan"] = self._payload_view(layout, prefix,
                                               _payload_fields(node))
            self._need(prefix + "bounds32",
                       _put(layout.bounds.astype(np.int64), self.device))
        for name, sub in node.sub_aggs:
            if isinstance(sub, A.CountAgg):
                self.plan[p["path"] + (name,)] = {"kind": "count",
                                                  "hdims": hdims + (nb,)}
            else:
                self.plan[p["path"] + (name,)] = self._metric_plan_dict(
                    sub, hdims + (nb,))

    def _plan_chain_blocks(self, node, p, layout, prefix, chain):
        p["chainp"] = self._build_chain_view(layout, prefix, chain)
        p["pay_plan"] = self._payload_view(layout, prefix,
                                           _payload_fields(node))
        n_pay = sum(len(m["skeys"]) + (m["cnt_key"] is not None)
                    for m in p["pay_plan"].values())
        self._need_chain_fit(p["chainp"], n_pay)
        self._need(prefix + "bounds32",
                   _put(layout.bounds.astype(np.int64), self.device))

    # -- member operands (a TermQuery on a dense multi-valued field) --------

    def _member_eligible(self, q) -> bool:
        """A TermQuery on a dense non-f64 narrow / keyword multi-valued
        column: a doc matches TermQuery(f, v) iff v is in its value set, so
        per-(value, bucket) counts and payload sums are precomputable."""
        if not isinstance(q, Q.TermQuery):
            return False
        col = self._col(q.field)
        if not (col.multi and col.has_multi_planes and not col.has_tail
                and not col.has_multi_planes_wide
                and col.ftype != FieldType.F64):
            return False
        Df = self._member_domain(col)
        return 1 <= Df and Df * 8 <= self.MEMBER_MEM

    @staticmethod
    def _member_domain(col) -> int:
        """Df: a member value is a global ordinal (keyword) or a w value in
        [0, Df)."""
        return len(col.terms) if col.ftype.is_stringy else int(col.span) + 1

    def _member_split(self, chain):
        """(reduced_chain, member_specs): every POSITIVE CONJUNCTIVE
        (root-or-must position) eligible TermQuery leaf is replaced by
        MatchAll in place (params still come from the original query) and
        recorded as a member spec."""
        specs = []

        def walk(q, qpath):
            if self._member_eligible(q):
                col = self._col(q.field)
                specs.append({"field": q.field, "pkey": qc._key(qpath),
                              "stringy": col.ftype.is_stringy,
                              "Df": self._member_domain(col)})
                return Q.MatchAllQuery()
            if isinstance(q, Q.BooleanQuery):
                must = tuple(walk(c, qpath + ("m", i))
                             for i, c in enumerate(q.must))
                if any(m is not c for m, c in zip(must, q.must)):
                    return Q.BooleanQuery(must=must, should=q.should,
                                          must_not=q.must_not)
            return q

        red = tuple((walk(q, qp), qp) for q, qp in chain)
        return red, tuple(specs)

    @staticmethod
    def _chain_is_matchall(chain) -> bool:
        """True when every chain entry matches everything (alive-masked):
        MatchAll, or a Boolean whose musts all match everything with no
        must_not (should is a scoring hint under a non-empty must, and an
        all-matchall empty-should boolean is all-true)."""
        def all_q(q):
            if isinstance(q, Q.MatchAllQuery):
                return True
            if isinstance(q, Q.BooleanQuery):
                return (len(q.must) > 0 and not q.must_not
                        and all(all_q(c) for c in q.must))
            return False
        return all(all_q(q) for q, _ in chain)

    def _plan_member_op(self, node, p, chain, layout, prefix) -> bool:
        """Member operand lowering of a prefix-mode bucket agg whose whole
        chain is one eligible TermQuery (possibly inside pure must
        conjunctions): exact int64 cells [Df_pad, n_cols * card_pad] —
        column 0 the per-(value, bucket) matched count, then one column
        per payload sum plane (the chain_blocks payload sources) — built
        once per layout; a query copies the row of its value. Returns True
        when planned. Unsharded only (JAX `_member_split`), and only under
        EngineConfig.use_member_ops (off: the chain_blocks kernel)."""
        if not self.config.use_member_ops or self._sharded:
            return False
        rchain, member = self._member_split(chain)
        if len(member) != 1 or not self._chain_is_matchall(rchain):
            return False
        spec = member[0]
        col = self._col(spec["field"])
        card = len(layout.bounds) - 1
        planes = []   # (column key, host plane [T])
        pay_meta = {}
        for _, s in node.sub_aggs:
            if not isinstance(s, (A.SumAgg, A.AvgAgg)) or s.field in pay_meta:
                continue
            pay_meta[s.field], sub_planes = self._payload_planes(
                s.field, f"s:{s.field}:", f"c:{s.field}")
            planes += sub_planes
        cols = ["cnt"] + [gk for gk, _ in planes]
        # rows of 8-byte cells: an even card_pad keeps every row a
        # multiple of gather_rows' 16-byte words
        card_pad = card + (card & 1)
        Df_pad = -(-spec["Df"] // 32) * 32
        if Df_pad * len(cols) * card_pad * 8 > self.MEMBER_MEM:
            return False
        key = f"MOP#{prefix}{spec['field']}#" + "|".join(cols)
        if key not in layout.cache:
            layout.cache[key] = self._build_member_op(
                layout, col, Df_pad, card, card_pad,
                [ph for _, ph in planes])
        self._need(key, layout.cache[key])
        k = spec["pkey"]
        p["member_op"] = {
            "spec": spec, "key": key, "card": card, "card_pad": card_pad,
            "cols": cols, "pay": pay_meta,
            # checked once here, so a query's gather checks only its index
            "rows": K.RowOperand(layout.cache[key]),
            "tcol": self._pcol[k + (":t" if spec["stringy"] else ":t0")],
            "tvcol": None if spec["stringy"] else self._pcol[k + ":tv0"]}
        return True

    def _build_member_op(self, layout, col, Df_pad, card, card_pad,
                         pay_planes) -> torch.Tensor:
        """One-time device build of the member operand from the layout's
        permuted per-position planes: 32 domain values per chunk; a row
        matches value u when ANY position holds u (so a doc holding u twice
        counts once), AND alive & valid; 32-row block sums, an int64
        cumsum, differences at the 32-aligned bucket bounds."""
        dev = self.device
        perm = layout.perm
        mps = [_put(ph[perm], dev) for ph in col.multi_planes_host]
        avalid = _put(self._avalid_host(layout), dev) > 0
        pays = [_put(np.asarray(ph[perm], np.int32), dev)
                for ph in pay_planes]
        R = len(perm)
        NB = R // ALIGN  # layout.bounds count ALIGN-row blocks
        bnd = _put(layout.bounds.astype(np.int64), dev)
        U = 32
        op = torch.zeros(Df_pad, 1 + len(pays), card_pad, dtype=torch.int64,
                         device=dev)

        def cells(blocks):
            # [U, NB] int64 block sums -> [U, card] bucket totals
            pref = torch.cumsum(blocks, dim=1)
            at = torch.cat([torch.zeros(U, 1, dtype=torch.int64, device=dev),
                            pref], dim=1)[:, bnd]
            return at[:, 1:] - at[:, :-1]

        for u0 in range(0, Df_pad, U):
            u = torch.arange(u0, u0 + U, dtype=torch.int32, device=dev)
            m = torch.zeros(U, R, dtype=torch.bool, device=dev)
            for mp in mps:
                m |= mp[None, :] == u[:, None]
            m &= avalid[None, :]
            op[u0:u0 + U, 0, :card] = cells(
                m.reshape(U, NB, ALIGN).sum(dim=-1, dtype=torch.int64))
            for j, pv in enumerate(pays):
                op[u0:u0 + U, 1 + j, :card] = cells(
                    torch.where(m, pv[None, :], 0).reshape(U, NB, ALIGN)
                    .sum(dim=-1, dtype=torch.int64))
        return op.reshape(Df_pad, -1)

    def _dense_budget(self, node) -> int:
        """Dense-mode flat-slot admission of a bucket node: dense_nb,
        extended to PCT_SLOT_CAP when a percentile descendant needs the
        bucket in its slot_rank bchain (prefix and scatter ancestors cannot
        thread a static slot plane)."""
        if _has_pct_sub(node):
            return max(self.dense_nb, K.PCT_SLOT_CAP)
        return self.dense_nb

    #: cap on a cross-product expansion's rows (the JAX package's
    #: _XPAND_CAP): a larger fan-out answers on the exact host path
    XPAND_CAP = 1 << 23

    def _build_xpand(self, pfield: str, cfield: str):
        """The STATIC cross-product expansion of a multi-valued bucket
        child under a multi-valued row-space ancestor: one row per
        (parent value row, child value row) pair of one doc — `prow` /
        `crow` index the two fields' value rows, `doc` is the pair's doc,
        `valid` marks real rows. Cached on the child column; returns the
        registered array keys, or None past XPAND_CAP rows. On a mesh the
        pairs of a doc lie on its shard (both fields' value rows are
        partitioned by owning doc)."""
        pcol, ccol = self._col(pfield), self._col(cfield)
        if ccol._bid_cache is None:
            ccol._bid_cache = {}
        ckey = ("xpand", pfield)
        if ckey not in ccol._bid_cache:
            T = self.dindex.T
            pd, cd = (pcol._host_doc.astype(np.int64),
                      ccol._host_doc.astype(np.int64))
            idx_c = np.nonzero(ccol._host_valid)[0]
            cnt = np.bincount(cd[idx_c], minlength=T)
            coff = np.zeros(T + 1, np.int64)
            np.cumsum(cnt, out=coff[1:])
            idx_p = np.nonzero(pcol._host_valid)[0]
            reps = cnt[pd[idx_p]]
            E = int(reps.sum())
            prow = np.repeat(idx_p, reps)
            within = (np.arange(E, dtype=np.int64)
                      - np.repeat(np.cumsum(reps) - reps, reps))
            crow = idx_c[np.repeat(coff[pd[idx_p]], reps) + within]
            epad = max(PAD_BLOCK, -(-E // PAD_BLOCK) * PAD_BLOCK)
            if self._sharded:
                # a shard expands its own docs' pairs, padded to the
                # widest shard's length (JAX's per-shard cap)
                epad = max(SH.allgather_obj(epad, ("xpand", pfield, cfield)))
            if epad > self.XPAND_CAP:
                ccol._bid_cache[ckey] = None
            else:
                def padded(a, dtype):
                    out = np.zeros(epad, dtype)
                    out[:E] = a
                    return _put(out, self.device)
                ccol._bid_cache[ckey] = {
                    "prow": padded(prow, np.int64),
                    "crow": padded(crow, np.int64),
                    "doc": padded(pd[prow], np.int64),
                    "valid": padded(np.ones(E, bool), bool)}
        planes = ccol._bid_cache[ckey]
        if planes is None:
            return None
        keys = {}
        for nm, arr in planes.items():
            keys[nm] = f"XP:{pfield}>{cfield}#{nm}"
            self._need(keys[nm], arr)
        return keys

    def _plan_bucket_rows(self, node, p, col, *, in_slot, parent_single):
        """The multi-valued bucket field's part of a bucket plan: a child
        chained per row under a multi-valued ancestor takes the static
        cross-product expansion (one level; a deeper nest answers on the
        host path), and `chain_ok` records whether this node's children
        stay doc-rooted (single-valued, or single-cardinality CSR)."""
        if in_slot and not parent_single and col.multi:
            xp = (self._build_xpand(self._mparent, node.field)
                  if self._mparent not in (None, "__deep__") else None)
            if xp is None:
                raise NotImplementedError(
                    "multi-valued bucket agg nested under a multi-valued "
                    "bucket field (no device expansion for this shape)")
            p["xpand"] = xp
        entry = self.dindex.schema.field(node.field)
        p["chain_ok"] = (not col.multi) or entry.cardinality.value == "single"

    def _slot_rows(self, p, col, in_slot):
        """Record the rows of a nested bucket node's per-query composite
        slot plane (p["slot_rows"], budgeted by _batch_cap): the
        cross-product expansion's, the multi-valued ancestor's or this
        field's value rows, or the docs."""
        if not in_slot:
            return
        rows = self.dindex.T
        if "xpand" in p:
            rows = self._arrays[p["xpand"]["doc"]].shape[0]
        elif self._mparent not in (None, "__deep__"):
            rows = self._col(self._mparent).host_plane("doc").shape[0]
        elif col.multi:
            rows = col.host_plane("doc").shape[0]
        p["slot_rows"] = max(rows, self.dindex.T)

    def _row_doc(self, path):
        """The doc plane key of the row space a node at `path` reads: its
        nearest bucket ancestor's `row_doc` (None: the docs)."""
        for i in range(len(path) - 1, 0, -1):
            q = self.plan.get(path[:i])
            if isinstance(q, dict) and "row_doc" in q:
                return q["row_doc"]
        return None

    def _plan_children(self, node, p, col, path, *, in_slot, hdims, tflat,
                       chain, sub_bchain, parent_single, sbid):
        """Plan a row-mode bucket node's subs, tracking the multi-valued
        ancestor whose value rows they chain over (`_mparent`). The doc
        plane of their row space is decided here, once: `p["row_doc"]`,
        the array key _bucket_ctx reads (None: the docs)."""
        prev = self._mparent
        if "xpand" in p:
            self._mparent = "__deep__"  # expansion rows, not a field's rows
            p["row_doc"] = p["xpand"]["doc"]
        elif in_slot and not parent_single:
            # each row of the multi-valued ancestor is one collect
            p["row_doc"] = self._row_doc(path)
        elif col.multi and not p.get("plane_fanout"):
            self._mparent = node.field
            p["row_doc"] = f"{node.field}:doc"
        else:
            p["row_doc"] = None
        try:
            for name, sub in node.sub_aggs:
                self._plan_aggs(sub, path + (name,), in_slot=True,
                                hdims=hdims, tflat=tflat, chain=chain,
                                bchain=sub_bchain, sbid=sbid,
                                parent_single=parent_single
                                and p["chain_ok"])
        finally:
            self._mparent = prev

    def _dense_budget(self, node) -> int:
        """Dense-mode flat-slot admission of a bucket node: dense_nb,
        extended to PCT_SLOT_CAP when a percentile descendant needs the
        bucket in its slot_rank bchain (prefix and scatter ancestors cannot
        thread a static slot plane)."""
        if _has_pct_sub(node):
            return max(self.dense_nb, K.PCT_SLOT_CAP)
        return self.dense_nb

    def _plan_histogram(self, node, path, *, in_slot, hdims, tflat, chain,
                        bchain, parent_single):
        col = self._col(node.field)
        p = {"kind": "histogram", "ftype": col.ftype, "multi": col.multi,
             "hdims": hdims, "path": path}
        self._plan_bucket_rows(node, p, col, in_slot=in_slot,
                               parent_single=parent_single)
        p.update(self._hist_layout(col, node))
        nb = p["nb"]
        if tflat * nb >= 2**31:
            raise NotImplementedError(
                "composite bucket slot space exceeds 2^31 on device")
        bid_key = (f"{node.field}:bid:cal:{node.calendar}" if node.calendar
                   else f"{node.field}:bid:{node.interval}:{node.offset}")
        # a range layout's bucket plane is the program's own, so that it
        # goes when the searcher drops the program: the cube, prefix and
        # slot_rank percentile paths, which cache per layout on the index,
        # are not taken
        ranged = "range" in p
        if ranged and _has_pct_sub(node):
            raise NotImplementedError(
                "percentiles under an f64 histogram laid out over its "
                "query's range")
        hb = {}

        def bid_host():
            if "ids" not in hb:
                hb["ids"] = self._host_bucket_ids(col, p)
            return hb["ids"]

        self.plan[path] = p
        if tflat * nb <= self.dense_nb and not in_slot and not col.multi \
                and not ranged and self._plan_cube_bucket(
                    node, p, path, sig="h:" + bid_key, chain=chain, nb=nb,
                    bid_host=bid_host, sub_hdims=hdims + (nb,),
                    sub_tflat=tflat * nb,
                    sub_bchain=(bchain + (("hist", node.field, dict(p)),)
                                if bchain is not None else None)):
            return
        budget = self._dense_budget(node)
        if tflat * nb > budget and not in_slot and not col.multi \
                and not ranged and self._sub_kinds_ok(node):
            p["mode"] = "prefix"
            layout = col.layout_for_ids(bid_key, bid_host, nb)
            self._plan_prefix(node, p, layout, f"HL:{bid_key}#", chain,
                              hdims, nb)
            return
        self._reads_root = True
        p["mode"] = "dense" if tflat * nb <= budget else "scatter"
        self._slot_rows(p, col, in_slot)
        bid = (self._range_bucket_ids(col, p) if ranged
               else col.bucket_id_plane(bid_key, bid_host))
        self._need(bid_key, bid)
        if col.multi:
            self._need_col_planes(col)
        p["bid_key"] = bid_key
        if p["mode"] == "dense" and not in_slot and self.config.dense_mxu:
            p["dense_mm"] = self._dense_counts_plan(
                bid_key, col.plane("doc") if col.multi else None)
        sub_bchain = (bchain + (("hist", node.field, dict(p)),)
                      if bchain is not None and p["mode"] == "dense"
                      and not col.multi and not ranged else None)
        self._plan_children(node, p, col, path, in_slot=in_slot,
                            hdims=hdims + (nb,),
                            tflat=tflat * nb, chain=chain,
                            sub_bchain=sub_bchain,
                            parent_single=parent_single,
                            sbid=([p["dense_mm"]] if p.get("dense_mm")
                                  else None))

    @staticmethod
    def _range_bucket_ids(col, p) -> torch.Tensor:
        """_host_bucket_ids of a "bounds" layout, on the device: the rows'
        mono offsets rm = w - 2^63 from the column's w plane (narrow) or
        its (hi, lo) pair, against the layout's bounds. int32 [R]."""
        if col.narrow:
            rm = col.plane("w").to(torch.int64) + torch.iinfo(torch.int64).min
        else:
            rm = (col.plane("hi").to(torch.int64) * 2**32
                  + (col.plane("lo").to(torch.int64) + 2**31))
        rb = torch.as_tensor(p["rbounds"], dtype=torch.int64,
                             device=rm.device)
        return torch.searchsorted(rb, rm, right=True, out_int32=True)

    def _plan_terms(self, node, path, *, in_slot, hdims, tflat, chain,
                    bchain, parent_single):
        col = self._col(node.field)
        p = {"kind": "terms", "ftype": col.ftype, "multi": col.multi,
             "hdims": hdims, "path": path}
        self._plan_bucket_rows(node, p, col, in_slot=in_slot,
                               parent_single=parent_single)
        if col.ftype.is_stringy:
            card = col.card
            p["keys"] = col.terms
        else:
            card = col.card
            p["keys_mono"] = col.term_ids()[1]
        if card > MAX_TERMS_CARD:
            raise NotImplementedError(
                f"terms cardinality {card} exceeds the device bound")
        if tflat * card >= 2**31:
            raise NotImplementedError(
                "composite bucket slot space exceeds 2^31 on device")
        p["card"] = card
        p["keff"] = min(node.size, card)
        facet = isinstance(node, A.FacetAgg)
        if facet:
            # facet: host selection over the full per-ordinal count vector;
            # the child set is a static slice of the sorted term table
            p["facet_children"] = self._facet_children(col, node.path)
            p["keff"] = card
        # default order: composite-key top-k on device; any other order, a
        # facet, and a node above a non-integer percentile (whose phase 2
        # reads full-slot-space fruits) ship every bucket and select on
        # the host with the oracle's comparator (exact for every target)
        p["order"] = node.order
        p["sel"] = ("topk" if node.order == ("_count", "desc") and not facet
                    and not _has_nonint_pct_sub(node) else "host")
        # plane fan-out: a short multi-valued keyword at the root evaluates
        # per value position (doc-aligned planes) and merges the fruits
        # before any top-k (JAX `plane_fanout`)
        p["plane_fanout"] = (
            not in_slot and col.multi and col.ftype.is_stringy
            and not facet and col.has_multi_planes and not col.has_tail
            and tflat * card <= self.dense_nb
            and not _has_selection_sub(node))
        if p["plane_fanout"]:
            p["chain_ok"] = True
        self.plan[path] = p
        sub_hdims = hdims + ((card if p["sel"] == "host" else p["keff"]),)
        if tflat * card <= self.dense_nb and not in_slot and not col.multi \
                and not facet and self._plan_cube_bucket(
                    node, p, path, sig=f"t:{node.field}:{card}", chain=chain,
                    nb=card,
                    bid_host=lambda: (self._host_planes(col)[0]
                                      if col.ftype.is_stringy
                                      else col.term_ids()[0]),
                    sub_hdims=sub_hdims, sub_tflat=tflat * card,
                    sub_bchain=(bchain + (("terms", node.field, card),)
                                if bchain is not None else None)):
            return
        budget = self._dense_budget(node)
        if tflat * card > budget and not in_slot and not col.multi \
                and self._sub_kinds_ok(node):
            p["mode"] = "prefix"
            self._plan_prefix(node, p, col.bucket_layout(),
                              f"BL:{node.field}#", chain, hdims,
                              sub_hdims[-1])
            return
        self._reads_root = True
        p["mode"] = "dense" if tflat * card <= budget else "scatter"
        self._slot_rows(p, col, in_slot)
        if col.ftype.is_stringy:
            ids_key, ids = f"{node.field}:w", col.plane("w")
        else:
            ids_key, ids = f"{node.field}:tid", col.tid()
        self._need(ids_key, ids)
        sbid = None
        if p["plane_fanout"]:
            planes = [(f"{node.field}:mp{k}", col.plane(f"mp{k}"))
                      for k in range(len(col.multi_planes_host))]
            for key, pk in planes:
                self._need(key, pk)
            if self.config.dense_mxu:
                p["dense_mm"] = [self._dense_counts_plan(key)
                                 for key, _ in planes]
                sbid = p["dense_mm"]
        else:
            if col.multi:
                self._need_col_planes(col)
            if p["mode"] == "dense" and not in_slot and self.config.dense_mxu:
                p["dense_mm"] = self._dense_counts_plan(
                    ids_key, col.plane("doc") if col.multi else None)
                sbid = [p["dense_mm"]]
        sub_bchain = None
        if bchain is not None and p["mode"] == "dense":
            if p["chain_ok"] and not col.multi:
                sub_bchain = bchain + (("terms", node.field, card),)
            elif (col.multi and col.has_multi_planes and not col.has_tail
                  and not any(k == "mterms" for k, _, _ in bchain)):
                # an occurrence-weighted slot factor: percentile
                # descendants lower through wslots
                sub_bchain = bchain + (("mterms", node.field, card),)
        self._plan_children(node, p, col, path, in_slot=in_slot,
                            hdims=sub_hdims,
                            tflat=tflat * card, chain=chain,
                            sub_bchain=sub_bchain,
                            parent_single=parent_single, sbid=sbid)

    @staticmethod
    def _facet_children(col, path: str) -> np.ndarray:
        """Global ordinals of the immediate children of `path` (terms that
        start with path+'/' and have no further '/'), from the static
        sorted term table."""
        terms = col.terms
        pfx = (path.rstrip("/") + "/") if path else "/"
        lo = int(np.searchsorted(terms, pfx, side="left"))
        succ = qc._prefix_successor(pfx)
        hi = (int(np.searchsorted(terms, succ, side="left"))
              if succ is not None else len(terms))
        return np.asarray(
            [j for j in range(lo, hi)
             if "/" not in str(terms[j])[len(pfx):]], dtype=np.int64)

    def _extract_filter_params(self, node, path, out):
        if isinstance(node, (dict, tuple)):
            items = node.items() if isinstance(node, dict) else node
            for name, sub in items:
                self._extract_filter_params(sub, path + (name,), out)
            return
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            out.update(qc.extract_params(node.query, self.dindex,
                                         path=path + ("fq",)))
            self._extract_filter_params(node.sub_aggs, path, out)
            return
        if isinstance(node, (A.HistogramAgg, A.TermsAgg)):
            self._extract_filter_params(node.sub_aggs, path, out)

    # ======================================================================
    # evaluation
    # ======================================================================

    def raw_fn(self, pmat, arrays):
        """The device step (JAX `Program.raw_fn`): the fruits of the B
        queries of the [B, P] int32 param matrix `pmat` over the resident
        `arrays` (this program's `_arrays`), {"packed": [B, F] int64,
        "big": {path: phase-1 state}}. A pure function of its arguments:
        the run's memos live only while it runs, and it reads nothing back
        to the host, so the card can capture it (`_StepGraph`)."""
        self._ind_cache = {}  # cube indicators of this run, per chain
        self._defer_topk = 0  # > 0 inside a plane fan-out
        #: phase-1 state of this run's non-integer percentile nodes
        self._big = big = {}
        try:
            ctx = MaskCtx(lambda: self._root_mask(pmat, arrays))
            out = self._eval_level(self.aggs.items(), ctx, pmat, arrays,
                                   ("a",))
            return {"packed": self._pack_outputs(out, self.aggs,
                                                 pmat.shape[0]),
                    "big": big}
        finally:
            self._ind_cache = self._big = None

    def _root_mask(self, pmat, arrays):
        """The root scope's [B, T] mask: the root chain & alive."""
        assert self._root is not None, "no planned node reads the root mask"
        B, T = pmat.shape[0], self.dindex.T
        mask = self._chain_mask(self._root, pmat, arrays)
        alive = arrays["alive"] > 0
        if B > 1 and mask.stride(0) == 0:
            # a param-free root (MatchAll): one row shared by the batch
            # stays one row (a broadcast view, batch stride 0)
            mask = mask[:1] & alive
        else:
            mask = mask & alive
        return mask.expand(B, T)

    def _eval_level(self, items, ctx, pmat, arrays, path):
        """{name: fruit} of sibling aggs over one context. The metrics the
        fused_metrics kernel answers go first: the counts it returns are
        their mask's, which a sibling count, and a filter's own doc count,
        then take (MaskCtx.count) instead of counting the mask again."""
        items = list(items)
        fused = [(self.plan.get(path + (n,)) or {}).get("fused", False)
                 for n, _ in items]
        out = {}
        for first in (True, False):
            for (name, agg), f in zip(items, fused):
                if f == first:
                    out[name] = self._eval(agg, ctx, pmat, arrays,
                                           path + (name,))
        return {name: out[name] for name, _ in items}

    def _eval(self, node, ctx, pmat, arrays, path):
        p = self.plan.get(path)
        if isinstance(node, A.CountAgg):
            if p.get("cube"):
                return {"cnt": self._cube_rec(p["cube"], pmat, arrays)[1]
                        ["cnt"]}
            if isinstance(ctx, MaskCtx):
                return {"cnt": self._madd(ctx.count())}
            return {"cnt": self._madd(self._slot_counts(ctx, arrays))}
        if isinstance(node, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg,
                             A.StatsAgg)):
            if p.get("cube"):
                return self._eval_metric_cube(node, pmat, arrays, p)
            return self._merge_fruit(self._eval_metric(node, ctx, arrays, p))
        if isinstance(node, A.PercentilesAgg):
            return self._eval_percentiles(pmat, arrays, p, ctx)
        if isinstance(node, A.HistogramAgg):
            return self._eval_histogram(node, ctx, pmat, arrays, path, p)
        if isinstance(node, A.TermsAgg):
            return self._eval_terms(node, ctx, pmat, arrays, path, p)
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            if isinstance(ctx, MaskCtx):
                sub_ctx = MaskCtx(lambda: ctx.mask & self._chain_mask(
                    p["fmask"], pmat, arrays))
                cube_cnt = None
                if p.get("cube"):
                    cube_cnt = self._cube_rec(p["cube"], pmat,
                                              arrays)[1]["cnt"]
                    if not self._sharded:
                        # (on a mesh the scope's count stays its shard's)
                        sub_ctx.cnt = cube_cnt
                subs = self._eval_level(node.sub_aggs, sub_ctx, pmat, arrays,
                                        path)
                cnt = (cube_cnt if cube_cnt is not None
                       else self._madd(sub_ctx.count()))
                return {"cnt": cnt, **subs}
            fmask = self._chain_mask(p["fmask"], pmat, arrays)
            if ctx.doc is not None:
                fmask = _cols(fmask, ctx.doc)
            sub_ctx = SlotCtx(ctx.bid, ctx.valid & fmask, ctx.dims,
                              doc=ctx.doc, doc_rooted=ctx.doc_rooted)
            out = {"cnt": self._madd(R.dense_bucket_counts(
                sub_ctx.bid, sub_ctx.valid, sub_ctx.nslots))}
            out.update(self._eval_level(node.sub_aggs, sub_ctx, pmat, arrays,
                                        path))
            return out
        if isinstance(node, A.TopHitsAgg):
            if isinstance(ctx, MaskCtx):
                return self._eval_top_hits(node, ctx, arrays, p)
            return self._eval_top_hits_slots(node, ctx, arrays, p)
        raise TypeError(f"unknown agg {type(node)!r}")

    # -- metrics -------------------------------------------------------------

    def _slot_counts(self, ctx, arrays):
        """[B, ns] counts of a SlotCtx: the dense_buckets kernel over its
        static bucket plane (ctx.mm), else index_add_."""
        if ctx.mm is not None:
            return R.dense_bucket_counts_mm(ctx.bid, ctx.valid, ctx.nslots)
        return R.dense_bucket_counts(ctx.bid, ctx.valid, ctx.nslots)

    def _eval_metric(self, node, ctx, arrays, p):
        field = node.field
        col = self._col(field)
        need_min, need_max, need_sum = self._metric_needs(node)
        out = {}
        slot = isinstance(ctx, SlotCtx)
        valid = ctx.valid if slot else ctx.mask
        if not slot:
            dmm = p.get("dense_mm")
        else:
            dmm = (p["dense_mm"][ctx.mm["bid_key"]] if ctx.mm is not None
                   else None)

        # a SlotCtx over a dense node's static bucket plane: its sums run
        # dense_buckets over the plan's row-aligned payload planes
        dense = slot and dmm is not None

        def get(key):
            """A doc-aligned plane, read at the context's rows."""
            return ctx.rows(arrays[key]) if slot else arrays[key]

        def dsum(spec):
            """[B, ns] sums of one payload plane of the plan
            (_dense_sum_plan's (bound, array key))."""
            bound, key = spec
            return R.dense_bucket_sum_mm(
                ctx.bid, valid, None if key is None else arrays[key],
                ctx.nslots, bound=bound)

        def msum(plane):
            if slot:
                return R.dense_bucket_sum(ctx.bid, valid, plane, ctx.nslots)
            return R.ts_sum_plane(plane, valid)

        def msums(planes):
            """[..., L] sums of L planes: at root / filter scope one dense
            product over all of them where planned, else plane by plane."""
            if not slot and dmm is not None:
                bounds, key = dmm["planes"]
                return R.masked_sum_planes_mm(valid, planes, bounds,
                                              op=arrays.get(key))
            return torch.stack([msum(pl) for pl in planes], dim=-1)

        def mmin(plane, m):
            if slot:
                return R.dense_bucket_min(ctx.bid, m, plane, ctx.nslots)
            return R.masked_min_i32(plane, m)

        def mmax(plane, m):
            if slot:
                return R.dense_bucket_max(ctx.bid, m, plane, ctx.nslots)
            return R.masked_max_i32(plane, m)

        def limb_sums():
            if dense:
                return torch.stack([dsum(sp) for sp in dmm["sums"]], dim=-1)
            limbs = get(f"{field}:limbs")
            return msums([limbs[:, i] for i in range(limbs.shape[1])])

        if col.multi:
            pre = f"{field}:pre:"
            cnt_doc = get(pre + "cnt")
            if dense:
                sums = torch.stack([dsum(sp) for sp in
                                    [dmm["pcnt"]] + dmm["sums"]], dim=-1)
            else:
                planes = [cnt_doc]
                if need_sum:
                    sm = get(pre + "sum")
                    planes += [sm[:, i] for i in range(sm.shape[1])]
                sums = msums(planes)
            out["cnt"] = sums[..., 0]
            if need_sum:
                out["sum"] = sums[..., 1:]
            mm = valid & (cnt_doc > 0)
            for which, need, red in (("min", need_min, mmin),
                                     ("max", need_max, mmax)):
                if not need:
                    continue
                if col.narrow:
                    out[which] = red(get(pre + which + "A"), mm)
                elif slot:
                    v = R.wide_recon(get(pre + which + "A"),
                                     get(pre + which + "B"))
                    out[which] = red(v, mm)
                else:
                    wide = (R.masked_min_wide if which == "min"
                            else R.masked_max_wide)
                    out[which] = wide(arrays[pre + which + "A"],
                                      arrays[pre + which + "B"], mm)
            return out

        if p.get("fused"):
            cnt, tot, mn, mx = K.fused_metrics(valid, arrays[f"{field}:w"],
                                               minmax=need_min or need_max)
            if not slot and ctx.cnt is None:
                ctx.cnt = cnt
            out["cnt"] = cnt
            if need_min:
                out["min"] = mn
            if need_max:
                out["max"] = mx
            if need_sum:
                # narrow f64: exact signed limb planes
                out["sum"] = tot if p["direct"] else limb_sums()
            return out

        out["cnt"] = self._slot_counts(ctx, arrays) if slot else ctx.count()
        if need_min or need_max:
            if col.narrow:
                v = get(f"{field}:w")
                if need_min:
                    out["min"] = mmin(v, valid)
                if need_max:
                    out["max"] = mmax(v, valid)
            elif slot:
                v = R.wide_recon(get(f"{field}:hi"), get(f"{field}:lo"))
                if need_min:
                    out["min"] = mmin(v, valid)
                if need_max:
                    out["max"] = mmax(v, valid)
            else:
                hi, lo = arrays[f"{field}:hi"], arrays[f"{field}:lo"]
                if need_min:
                    out["min"] = R.masked_min_wide(hi, lo, valid)
                if need_max:
                    out["max"] = R.masked_max_wide(hi, lo, valid)
        if need_sum:
            if p["direct"]:
                out["sum"] = (dsum(dmm["sums"][0]) if dense
                              else msum(get(f"{field}:w")))
            else:
                out["sum"] = limb_sums()
        return out

    # -- percentiles ---------------------------------------------------------

    def _int_ranks(self, p, m):
        """0-based (lo, hi) rank pairs per percent, exact in int64:
        rank = (q * (m-1)) // 100 for integer q <= 100; matches
        utils/exact.py percentile_rank. m: [B] (or [B, ns]) -> [B, 2P]
        (or [B, ns, 2P])."""
        ms = (m - 1).clamp(min=0)
        ranks = []
        for q in p["percents"]:
            lo = (int(q) * ms) // 100
            hi = torch.minimum(lo + 1, ms)
            ranks.extend([lo, hi])
        return torch.stack(ranks, dim=-1)

    def _window_mask(self, p, sub_pmat, arrays, blk, G):
        """Chain-mask bits of the G-row windows at groups `blk` ([B, K];
        slot_rank: [B, ns, K], one row of groups per slot) -> bool
        [..., K, G], recomputed from the permuted planes (the kernels never
        materialize the [R] mask); slot_rank keeps each slot's rows only."""
        entry, prefix = p["chainp"], p["prefix"]
        rows = blk[..., None] * G + torch.arange(G, device=blk.device)
        planes = [arrays[prefix + k][rows] for k in entry["mp"].plane_keys]
        m = qc.eval_ops(entry["mp"].ops, planes, sub_pmat,
                        tuple(rows.shape[1:]))
        m = m & (arrays[prefix + "avalid"][rows] > 0)
        if p["pmode"] == "slot_rank":
            s = torch.arange(p["nslots"], device=blk.device)
            m = m & (arrays[prefix + p["slotk"]][rows]
                     == s.reshape(1, -1, 1, 1))
        return m

    def _gathered_window(self, p, mask, arrays, blk):
        """A mask-gather node's 32-row windows: the scope's [B, T] doc mask
        read at the windows' layout rows through pdoc, real rows only."""
        pre = p["prefix"]
        rows = blk[..., None] * SLOT_GROUP + torch.arange(
            SLOT_GROUP, device=blk.device)
        flat = rows.reshape(rows.shape[0], -1)
        m = torch.gather(mask, 1, arrays[pre + "pdoc"][flat]) \
            & arrays[pre + "lvalid"][flat]
        return m.reshape(rows.shape)

    def _weighted_window(self, p, sub_pmat, arrays, blk):
        """The torch slot path's 32-row windows: per (query, slot, block)
        the weight of each row in the slot (the number of its composite
        slot planes naming the slot, where the chain matches it)."""
        entry, prefix = p["chainp"], p["prefix"]
        rows = blk[..., None] * SLOT_GROUP + torch.arange(
            SLOT_GROUP, device=blk.device)
        vm = qc.eval_ops(entry["mp"].ops,
                         [arrays[prefix + k][rows]
                          for k in entry["mp"].plane_keys],
                         sub_pmat, tuple(rows.shape[1:])) \
            & (arrays[prefix + "avalid"][rows] > 0)
        s = torch.arange(p["nslots"], device=blk.device).reshape(1, -1, 1, 1)
        w = torch.zeros(rows.shape, dtype=torch.int32, device=blk.device)
        for k in p["slotks"]:
            w += vm & (arrays[prefix + k][rows] == s)
        return w

    def _window_fn(self, p, st, arrays):
        """blk [...] -> the [..., G] windows of a node's rows (bool, or the
        torch slot path's int32 weights), recomputed lazily."""
        if p.get("mask_gather"):
            return lambda blk: self._gathered_window(p, st["mask"], arrays,
                                                     blk)
        if p.get("slotks"):
            return lambda blk: self._weighted_window(p, st["sub"], arrays,
                                                     blk)
        return lambda blk: self._window_mask(p, st["sub"], arrays, blk,
                                             st["G"])

    def _select_rows(self, p, st, arrays, ranks):
        """The layout row of each 0-based rank ([B, 2P]; slot_rank
        [B, ns, 2P]) from a node's count prefix `st["cum"]` and the lazy
        recompute of its windows: the one selection of the integer path
        (in-run ranks) and of phase 2 (host ranks)."""
        return _rank_select_rows_lazy(st["cum"], ranks,
                                      self._window_fn(p, st, arrays), st["G"])

    def _bisect_values(self, p, st, arrays, ranks):
        """The value of each 0-based GLOBAL rank ([B, 2P]; slot_rank [B,
        ns, 2P]) on a mesh, by bisecting the value domain (JAX
        `_bisect_select_values` / `_bisect_select_slot_values`): the
        smallest x with count(x) >= rank + 1, where count(x) is the psum
        over the shards of this shard's matched rows (of the slot) with
        value <= x: the rows [0, pos) of its value-sorted layout, pos from
        a binary search of `sv`, counted from the node's count prefix plus
        one lazily recomputed window. One psum per step and no host round
        trip; span.bit_length() steps (31 for a 31-bit narrow span, 64 for
        a full wide one). Narrow columns yield w, wide ones rm (as the
        harvest reads them); a rank of an empty query or slot yields a
        value the harvest never reads (m == 0)."""
        sv = arrays[p["prefix"] + "sv"]
        window = self._window_fn(p, st, arrays)
        cum, G = st["cum"], st["G"]
        NB = cum.shape[-1]
        t = ranks + 1
        span = int(p["span"])
        lo0 = 0 if p["narrow"] else -(2**63)
        lo = torch.full_like(t, lo0)
        hi = torch.full_like(t, lo0 + span)
        cols = torch.arange(G, device=t.device)
        for _ in range(max(1, span.bit_length())):
            # floor((lo + hi) / 2) without int64 overflow
            mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
            pos = torch.searchsorted(sv, mid, right=True)
            blk = (pos // G).clamp(max=NB - 1)
            prev = torch.gather(cum, -1, (blk - 1).clamp(min=0))
            base = torch.where(blk > 0, prev.to(torch.int64), 0)
            inner = (window(blk) * (cols < (pos - blk * G)[..., None])) \
                .sum(dim=-1)
            ge = self._madd(base + inner) >= t
            hi = torch.where(ge, mid, hi)
            lo = torch.where(ge, lo, mid + 1)
        return lo

    def _eval_percentiles(self, pmat, arrays, p, ctx=None):
        """Per-group match counts from a chain kernel (rank: chain_counts
        per 128-row group -> [B, R/128]; slot_rank: chain_slot_counts per
        slot and 32-row block against the static slot plane ->
        [B, ns, R/32]), the pcube or scube, or torch ops; their cumsum
        along the groups. Integer percents select their rank rows here
        (searchsorted and a lazy window recompute); non-integer ones keep
        the prefix (`self._big`) for phase 2 and ship only m. A non-dense
        chain reads the scope's mask `ctx` through the pdoc plane."""
        if p.get("mask_gather"):
            st, m = self._percentile_counts_gather(p, arrays, ctx)
        elif p.get("slotks"):
            st, m = self._percentile_counts_torch_slots(pmat, arrays, p)
        else:
            st, m = self._percentile_counts(pmat, arrays, p)
        m = self._madd(m)
        if not p["int_percents"]:
            self._big[p["path"]] = st
            return {"m": m}
        ranks = self._int_ranks(p, m)
        if p.get("bisect") or p.get("slot_bisect"):
            return {"m": m, "vals": self._bisect_values(p, st, arrays,
                                                        ranks)}
        return {"m": m, "rows": self._select_rows(p, st, arrays, ranks)}

    def _percentile_counts(self, pmat, arrays, p):
        """(state, m) of a dense chain: the cube's, chain_counts' or
        chain_slot_counts' block counts and their cumsum."""
        entry, prefix = p["chainp"], p["prefix"]
        sub = self._chain_pmat(entry, pmat)
        planes = [arrays[prefix + k] for k in entry["mp"].plane_keys]
        avalid = arrays[prefix + "avalid"]
        cb = p.get("scube") or p.get("pcube")
        if cb:
            # the cube: per-(slot,) block counts from one int8 product
            G = cb["G"]
            ind = self._cube_ind(cb, pmat)
            if p["pmode"] == "slot_rank":
                counts = C.slot_block_counts(ind, arrays[cb["key"]],
                                             p["nslots"], cb["NB"])
                cum = torch.cumsum(counts, dim=-1, dtype=torch.int32)
            else:
                counts = C.block_counts(ind, arrays[cb["key"]], cb["NB"])
                cum = torch.cumsum(counts, dim=-1, dtype=torch.int64)
        elif p["pmode"] == "slot_rank":
            G = SLOT_GROUP
            counts = K.chain_slot_counts(sub, entry["ops"], planes, avalid,
                                         arrays[prefix + p["slotk"]],
                                         p["nslots"])
            # int32 is exact (totals <= R < 2^31) and halves the [B, ns, G]
            # state that batch_cap budgets
            cum = torch.cumsum(counts, dim=-1, dtype=torch.int32)
        else:
            G = GROUP
            counts = K.chain_counts(sub, entry["ops"], planes, avalid)
            cum = torch.cumsum(counts, dim=-1, dtype=torch.int64)
        return {"cum": cum, "sub": sub, "G": G}, cum[..., -1].to(torch.int64)

    def _percentile_counts_gather(self, p, arrays, ctx):
        """(state, m) of a non-dense chain: the gathered mask's per-32-row
        counts and their cumsum; the windows re-read the scope's doc
        mask (the gathered [B, R] mask does not outlive the counts)."""
        pre = p["prefix"]
        vm = _cols(ctx.mask, arrays[pre + "pdoc"], arrays[pre + "lvalid"])
        one, rep = R.shared_row(vm)  # a shared mask row is counted once
        cum = torch.cumsum(R.block32_counts(one), dim=-1, dtype=torch.int64)
        if rep > 1:
            cum = cum.expand(rep, -1)
        return {"cum": cum, "mask": ctx.mask, "G": SLOT_GROUP}, cum[..., -1]

    def _percentile_counts_torch_slots(self, pmat, arrays, p):
        """(state, m) of slot_rank counted with torch ops over the chain
        mask (a multi-valued percentile field, wslots, non-integer
        percents): per query, slot and 32-row block, the (row, slot plane)
        pairs of matched rows naming the slot — a row's weight in slot s
        is the number of its slot planes holding s — in query chunks
        (R.slot_block_counts)."""
        entry, prefix = p["chainp"], p["prefix"]
        sub = self._chain_pmat(entry, pmat)
        planes = [arrays[prefix + k] for k in entry["mp"].plane_keys]
        avalid = arrays[prefix + "avalid"] > 0
        slots = [arrays[prefix + k] for k in p["slotks"]]
        B, R_, ns = sub.shape[0], avalid.shape[0], p["nslots"]
        cum = torch.empty(B, ns, R_ // SLOT_GROUP, dtype=torch.int32,
                          device=avalid.device)
        for sl in R._query_chunks(B, R_ * (1 + len(slots))):
            vm = qc.eval_ops(entry["mp"].ops, planes, sub[sl], (R_,)) \
                & avalid
            # int32 is exact: a block weighs at most 32 * K, totals K * R
            torch.cumsum(R.slot_block_counts(vm, slots, ns), dim=-1,
                         dtype=torch.int32, out=cum[sl])
        return ({"cum": cum, "sub": sub, "G": SLOT_GROUP},
                cum[..., -1].to(torch.int64))

    # -- top_hits ------------------------------------------------------------

    def _hit_order(self, node, p):
        """(order, key) of a top_hits node's row space (the docs, or the
        rows whose docs the array `p["doc_key"]` holds), built at plan
        time: key [n] int64 is the sort field's rm at the row's doc (~rm
        descending; 0 in score order), order [n] int64 the rows sorted by
        (key, doc, row) — two stable sorts, once per row space (in the
        prep cache; the sort planes and the doc plane are resident). A
        query's hits in a slot are the first k of its matched rows in this
        order."""
        arrays = self._arrays
        doc_key = p["doc_key"]
        doc = None if doc_key is None else arrays[doc_key]
        n = self.dindex.T if doc is None else doc.shape[0]
        dev = self.device

        def build():
            if p.get("score"):
                key = torch.zeros(n, dtype=torch.int64, device=dev)
            else:
                f = node.sort_field
                if p["narrow"] or p["ftype"].is_stringy:
                    rm = arrays[f"{f}:w"].to(torch.int64)
                else:
                    rm = R.wide_recon(arrays[f"{f}:hi"], arrays[f"{f}:lo"])
                rm = rm if doc is None else rm[doc]
                key = rm if node.ascending else ~rm
            order = torch.arange(n, dtype=torch.int64, device=dev)
            if doc is not None:
                order = torch.sort(doc, stable=True).indices
            return order[torch.sort(key[order], stable=True).indices], key

        return self._prep_cached(
            ("hits", node.sort_field, bool(node.ascending),
             bool(p.get("score")), doc_key, n),
            build, lambda ok: {"order": ok[0].cpu().numpy(),
                               "key": ok[1].cpu().numpy()},
            lambda h: (_put(h["order"], dev), _put(h["key"], dev)))

    def _merge_hits(self, out):
        """On a mesh, the index's top k from every shard's (JAX's k-way
        merge): each shard's k candidates with doc ids globalized (doc +
        s * T_s, so ties break on the global doc id), gathered, sorted by
        (matched first, key, doc) and cut to k; m psum'd. No per-row data
        crosses shards."""
        keys, docs, m = out["keys"], out["docs"], out["m"]
        k = keys.shape[-1]
        j = torch.arange(k, device=keys.device)
        ok = j < m[..., None]
        gdoc = docs + SH.axis_index() * self.dindex.T

        def gathered(a):  # [S, ..., k] -> [..., S * k]
            g = SH.all_gather(a.contiguous())
            return g.movedim(0, -2).reshape(a.shape[:-1] + (-1,))

        ck, cd, ci = gathered(keys), gathered(gdoc), gathered(ok)
        # (unmatched last, key, doc): stable sorts, least significant first
        o = torch.sort(cd, dim=-1, stable=True).indices
        o = o.gather(-1, torch.sort(ck.gather(-1, o), dim=-1,
                                    stable=True).indices)
        o = o.gather(-1, torch.sort((~ci.gather(-1, o)).to(torch.int8),
                                    dim=-1, stable=True).indices)[..., :k]
        mt = self._madd(m)
        okm = j < mt[..., None]
        return {"keys": torch.where(okm, ck.gather(-1, o), 0),
                "docs": torch.where(okm, cd.gather(-1, o), 0), "m": mt}

    def _eval_top_hits(self, node, ctx, arrays, p):
        """Flat top_hits over the scope's [B, T] mask: a query's hits are
        the first k matched docs of the static (key, doc) order — the
        mask read in that order, its cumsum, and the rows where the cumsum
        first reaches 1..k (searchsorted). Matched-ness is the mask
        itself, never a key sentinel: ~rm of a wide column's minimum is
        I64_MAX. A shared mask row is selected once."""
        order, key = self._hit_cache[p["path"]]
        mask, rep = R.shared_row(ctx.mask)
        B, T, k = mask.shape[0], self.dindex.T, p["k"]
        dev = mask.device
        keys = torch.zeros(B, k, dtype=torch.int64, device=dev)
        docs = torch.zeros(B, k, dtype=torch.int64, device=dev)
        m = torch.empty(B, dtype=torch.int64, device=dev)
        t = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
        for sl in R._query_chunks(B, T * 2):
            c = R.row_cumsum(mask[sl][:, order])
            b = c.shape[0]
            pos = torch.searchsorted(c, t.expand(b, k).contiguous())
            rows = order[pos.clamp(max=T - 1)]
            ok = t[None, :] <= c[:, -1:]
            keys[sl] = torch.where(ok, key[rows], 0)
            docs[sl] = torch.where(ok, rows, 0)
            m[sl] = c[:, -1]
        out = {"keys": keys, "docs": docs, "m": m}
        if rep > 1:
            out = {n: v.expand((rep,) + v.shape[1:]) for n, v in out.items()}
        return self._merge_hits(out) if self._sharded else out

    def _eval_top_hits_slots(self, node, ctx, arrays, p):
        """In-slot top_hits: per query, the composite slot of every row
        read in the static (key, doc) order, one sort by slot (a packed
        (slot, position) int64 key, so rows keep that order within a
        slot), then each slot's first k rows found by searchsorted over
        the cumsum of its live rows — no scatter. Over value rows
        (ctx.doc) a doc counts once per slot: its rows are adjacent in the
        sorted order, and all but the first are dropped (JAX's collapse
        to one hit per (slot, doc)). Queries run a few at a time (the
        sort's [b, rows] state)."""
        doc = ctx.doc
        order, key = self._hit_cache[p["path"]]
        ns, k = ctx.nslots, p["k"]
        B, n = ctx.valid.shape
        dev = ctx.valid.device
        # the doc of each row in the sorted order
        rdoc = (order if doc is None else doc[order]).to(torch.int64)
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        slots = torch.arange(ns + 1, dtype=torch.int64, device=dev)
        j = torch.arange(k, dtype=torch.int64, device=dev)
        keys = torch.empty(B, ns, k, dtype=torch.int64, device=dev)
        docs = torch.empty(B, ns, k, dtype=torch.int64, device=dev)
        m = torch.empty(B, ns, dtype=torch.int64, device=dev)
        for sl in R._query_chunks(B, n * 16):
            bid = ctx.bid if ctx.bid.dim() == 1 else ctx.bid[sl]
            valid = ctx.valid[sl]
            slot = torch.where(valid & (bid >= 0), bid.to(torch.int64), ns)
            srt = torch.sort((slot[:, order] << 32) | pos, dim=1).values
            ss, sp = srt >> 32, srt & 0xFFFFFFFF
            live = ss < ns
            if doc is not None:
                d = rdoc[sp]
                live[:, 1:] &= ~((ss[:, 1:] == ss[:, :-1])
                                 & (d[:, 1:] == d[:, :-1]))
            b = ss.shape[0]
            # live rows before each slot's first row, and in the slot
            cx = torch.cat([torch.zeros(b, 1, dtype=torch.int64, device=dev),
                            R.row_cumsum(live)], dim=1)
            at = torch.gather(cx, 1, torch.searchsorted(
                ss, slots.expand(b, ns + 1).contiguous()))
            ms = at[:, 1:] - at[:, :-1]
            # the (j+1)-th live row of slot s: where cx first reaches it
            tgt = at[:, :-1, None] + j + 1
            hit = torch.searchsorted(cx, tgt.reshape(b, -1)).clamp(
                min=1, max=n) - 1
            r = order[torch.gather(sp, 1, hit)]
            ok = (j < ms[:, :, None]).reshape(b, -1)
            keys[sl] = torch.where(ok, key[r], 0).reshape(b, ns, k)
            docs[sl] = torch.where(ok, torch.gather(rdoc[sp], 1, hit), 0) \
                .reshape(b, ns, k)
            m[sl] = ms
        out = {"keys": keys, "docs": docs, "m": m}
        return self._merge_hits(out) if self._sharded else out

    # -- bucket aggs ---------------------------------------------------------

    def _eval_prefix_member(self, node, pmat, arrays, p):
        """Prefix-mode bucket totals from ONE row of the member operand per
        query, copied by the gather_rows kernel: (per-bucket counts
        [B, card] int64, sub_out). The row index comes straight from the
        param matrix, clamped on the device (no host sync); the value's
        validity param zeroes an out-of-domain value's row."""
        mo = p["member_op"]
        card, cols = mo["card"], mo["cols"]
        op = mo["rows"]
        t = pmat[:, mo["tcol"]]
        tv = (t >= 0) if mo["tvcol"] is None else pmat[:, mo["tvcol"]]
        idx = t.clamp(0, op.op.shape[0] - 1).contiguous()
        rows = K.gather_rows(idx, op).reshape(-1, len(cols), mo["card_pad"])
        rows = rows[..., :card] * tv.to(torch.int64)[:, None, None]
        groups = {gk: rows[:, j] for j, gk in enumerate(cols)}
        counts = groups["cnt"]
        sub_out = {}
        for name, sub in node.sub_aggs:
            if isinstance(sub, A.CountAgg):
                sub_out[name] = {"cnt": counts}
                continue
            meta = mo["pay"][sub.field]
            ssum = torch.stack([groups[sk] for sk in meta["skeys"]], dim=-1)
            gcnt = groups[meta["cnt_key"]] if meta["cnt_key"] else counts
            if len(meta["skeys"]) == 1 and meta["direct"]:
                sub_out[name] = {"cnt": gcnt, "sum": ssum[..., 0]}
            else:
                sub_out[name] = {"cnt": gcnt, "sum": ssum}
        return counts, sub_out

    def _eval_prefix_kernel(self, node, ctx, pmat, arrays, p):
        """Prefix-mode bucket totals via the chain_blocks kernel, the
        member operand, or (a non-dense chain) the scope's mask gathered
        through pdoc: (per-bucket counts [B, card] int64, sub_out)."""
        if "member_op" in p:
            return self._eval_prefix_member(node, pmat, arrays, p)
        prefix = p["prefix"]
        pay_keys = []
        for meta in p["pay_plan"].values():
            pay_keys += meta["skeys"]
            if meta["cnt_key"]:
                pay_keys.append(meta["cnt_key"])
        bounds32 = arrays[prefix + "bounds32"]
        if p.get("mask_gather"):
            # the scope's mask at the layout rows' docs, real rows only
            vm = _cols(ctx.mask, arrays[prefix + "pdoc"],
                       arrays[prefix + "lvalid"])
            counts = R.prefix_diff_counts_from_blocks(R.block32_counts(vm),
                                                      bounds32)

            def local_sums(key):
                return R.prefix_diff_sums_from_blocks(
                    R.block32_sums(vm, arrays[prefix + key]), bounds32)
        else:
            entry = p["chainp"]
            c32, sums = K.chain_blocks(
                self._chain_pmat(entry, pmat), entry["ops"],
                [arrays[prefix + k] for k in entry["mp"].plane_keys],
                arrays[prefix + "avalid"],
                [arrays[prefix + k] for k in pay_keys])
            counts = R.prefix_diff_counts_from_blocks(c32, bounds32)
            col_of = {k: j for j, k in enumerate(pay_keys)}

            def local_sums(key):
                return R.prefix_diff_sums_from_blocks(sums[:, col_of[key]],
                                                      bounds32)

        # each shard's per-bucket partials over its own layout (its own
        # bounds), psum'd
        counts = self._madd(counts)

        def bucket_sums(key):
            return self._madd(local_sums(key))

        sub_out = {}
        for name, sub in node.sub_aggs:
            if isinstance(sub, A.CountAgg):
                sub_out[name] = {"cnt": counts}
                continue
            meta = p["pay_plan"][sub.field]
            ssum = torch.stack([bucket_sums(k) for k in meta["skeys"]],
                               dim=-1)
            gcnt = bucket_sums(meta["cnt_key"]) if meta["cnt_key"] \
                else counts
            if len(meta["skeys"]) == 1 and meta["direct"]:
                sub_out[name] = {"cnt": gcnt, "sum": ssum[..., 0]}
            else:
                sub_out[name] = {"cnt": gcnt, "sum": ssum}
        return counts, sub_out

    def _bucket_ctx(self, node, ctx, p, own, nb, arrays, mm=None,
                    missing=False):
        """The sub-context of a row-mode bucket node whose row ids are
        `own` ([T] doc-aligned, or [V] over the field's value rows; -1 =
        none where `missing`, a terms node's) over `nb` buckets. Under a MaskCtx the rows are the docs or
        the field's value rows (each read at its doc); under a doc-rooted
        SlotCtx the parent's slot is read at the rows' docs; in a
        multi-valued ancestor's row space a single-valued child chains per
        ancestor row, and a multi-valued one over the static
        cross-product expansion (`xpand`). The rows' doc plane is the
        plan's (`p["row_doc"]`, _plan_children)."""
        f = node.field
        col = self._col(f)
        chain_ok = p["chain_ok"]
        doc = None if p["row_doc"] is None else arrays[p["row_doc"]]
        if isinstance(ctx, MaskCtx):
            if doc is not None:
                valid = _cols(ctx.mask, doc, arrays[f"{f}:valid"] > 0)
            else:
                valid = ctx.mask
            if missing:
                valid = valid & (own >= 0)
            return SlotCtx(own, valid, (nb,), mm, doc, chain_ok)
        dims = ctx.dims + (nb,)
        xp = p.get("xpand")
        if xp:
            pslot = _cols(torch.where(ctx.valid, ctx.bid, -1),
                          arrays[xp["prow"]])
            own_r = own[arrays[xp["crow"]]]
            valid = arrays[xp["valid"]] & (pslot >= 0)
        elif not ctx.doc_rooted:
            # each row of the multi-valued ancestor is one collect
            pslot = torch.where(ctx.valid, ctx.bid, -1)
            own_r, valid = ctx.rows(own), ctx.valid
        elif col.multi:
            sod, svd = ctx.slots_of_docs(self.dindex.T)
            pslot = _cols(sod, doc)
            valid = (arrays[f"{f}:valid"] > 0) & _cols(svd, doc)
            own_r = own
        elif ctx.doc is None:
            return SlotCtx(ctx.bid * nb + own,
                           ctx.valid & (own >= 0) if missing else ctx.valid,
                           dims)
        else:
            pslot, valid = ctx.slots_of_docs(self.dindex.T)
            own_r = own
        if missing:
            valid = valid & (own_r >= 0)
        bid = torch.where(valid, pslot * nb + own_r, -1)
        return SlotCtx(bid, valid, dims, None, doc,
                       chain_ok and ctx.doc_rooted)

    def _eval_histogram(self, node, ctx, pmat, arrays, path, p):
        nb = p["nb"]
        if p["mode"] == "prefix":
            counts, sub_out = self._eval_prefix_kernel(node, ctx, pmat,
                                                       arrays, p)
            return {"counts": counts, **sub_out}
        if p.get("cube"):
            counts, sub_out = self._eval_bucket_cube(node, p, pmat, arrays)
            return {"counts": counts, **sub_out}
        sub_ctx = self._bucket_ctx(node, ctx, p, arrays[p["bid_key"]], nb,
                                   arrays, p.get("dense_mm"))
        out = {"counts": self._madd(self._slot_counts(sub_ctx, arrays))}
        for name, sub in node.sub_aggs:
            out[name] = self._eval(sub, sub_ctx, pmat, arrays,
                                   path + (name,))
        return out

    def _eval_terms(self, node, ctx, pmat, arrays, path, p):
        card = p["card"]
        if p["mode"] == "prefix":
            counts, sub_out = self._eval_prefix_kernel(node, ctx, pmat,
                                                       arrays, p)
            return self._terms_select(p, counts, sub_out, 1)
        if p.get("cube"):
            counts, sub_out = self._eval_bucket_cube(node, p, pmat, arrays)
            return self._terms_select(p, counts, sub_out, 1)
        if p.get("plane_fanout"):
            return self._eval_plane_fanout(node, ctx, pmat, arrays, path, p)
        col = self._col(node.field)
        ids = arrays[f"{node.field}:w"] if col.ftype.is_stringy \
            else arrays[f"{node.field}:tid"]
        sub_ctx = self._bucket_ctx(node, ctx, p, ids, card, arrays,
                                   p.get("dense_mm"), missing=True)
        anc_flat = 1 if isinstance(ctx, MaskCtx) else ctx.nslots
        if sub_ctx.mm is not None and not col.multi:
            # a missing term (id -1) matches no bucket: the scope's mask
            # goes in as it is, a shared row staying one row
            counts = R.dense_bucket_counts_mm(ids, ctx.mask, card)
        else:
            counts = self._slot_counts(sub_ctx, arrays)
        counts = self._madd(counts)
        sub_out = {name: self._eval(sub, sub_ctx, pmat, arrays,
                                    path + (name,))
                   for name, sub in node.sub_aggs}
        return self._terms_select(p, counts, sub_out, anc_flat)

    def _eval_plane_fanout(self, node, ctx, pmat, arrays, path, p):
        """A short multi-valued keyword at the root: the subtree evaluated
        once per value position over the doc-aligned plane mp{k} (each a
        disjoint set of the docs' value occurrences), the fruits merged
        (sums add, extremes fold), then one selection — nested terms defer
        theirs until after the merge."""
        per_plane = []
        mms = p.get("dense_mm") or [None] * len(
            self._col(node.field).multi_planes_host)
        self._defer_topk += 1
        try:
            for k, mm in enumerate(mms):
                pk = arrays[f"{node.field}:mp{k}"]
                sub_ctx = SlotCtx(pk, ctx.mask & (pk >= 0), (p["card"],), mm)
                one = {"counts": self._madd(self._slot_counts(sub_ctx,
                                                              arrays))}
                for name, sub in node.sub_aggs:
                    one[name] = self._eval(sub, sub_ctx, pmat, arrays,
                                           path + (name,))
                per_plane.append(one)
        finally:
            self._defer_topk -= 1
        merged = _merge_plane_outs(per_plane)
        counts = merged.pop("counts")
        merged = self._apply_deferred_topk(node.sub_aggs, merged, path,
                                           p["card"])
        return self._terms_select(p, counts, merged, 1)

    def _apply_deferred_topk(self, sub_aggs, out, path, anc_flat):
        """After a plane fan-out's merge: the selection of every nested
        terms node, deepest first."""
        for name, sub in sub_aggs:
            if isinstance(sub, A.TermsAgg):
                sp = self.plan[path + (name,)]
                inner = self._apply_deferred_topk(
                    sub.sub_aggs, out[name], path + (name,),
                    anc_flat * sp["card"])
                counts = inner.pop("counts")
                out[name] = self._terms_select(sp, counts, inner, anc_flat)
            elif isinstance(sub, A.HistogramAgg):
                out[name] = self._apply_deferred_topk(
                    sub.sub_aggs, out[name], path + (name,),
                    anc_flat * self.plan[path + (name,)]["nb"])
            elif isinstance(sub, (A.FilterAgg, A.PostFilterAgg)):
                out[name] = self._apply_deferred_topk(
                    sub.sub_aggs, out[name], path + (name,), anc_flat)
        return out

    def _terms_select(self, p, counts, sub_out, anc_flat):
        """Dispatch the planned selection mode: device top-k or all buckets
        for host selection (none inside a plane fan-out: its merge selects
        once)."""
        if self._defer_topk:
            return {"counts": counts, **sub_out}
        card, keff = p["card"], p["keff"]
        B = counts.shape[0]
        c2 = counts.reshape(B, anc_flat, card)
        total = c2.sum(dim=-1)
        if p["sel"] == "host":
            return {"counts": counts, "total": total, **sub_out}
        # (count desc, key asc): unique composite keys, so top-k has no ties
        ids = torch.arange(card, dtype=torch.int64, device=counts.device)
        key = c2 * (1 << 27) + (card - 1 - ids)
        top = torch.topk(key, keff, dim=-1).indices  # [B, anc, keff]

        def gather(a):
            tail = a.shape[2:]
            rest = a.shape[1] // (anc_flat * card)
            b = a.reshape((B, anc_flat, card, rest) + tail)
            idx = top.reshape((B, anc_flat, keff) + (1,) * (1 + len(tail)))
            g = torch.gather(b, 2, idx.expand((B, anc_flat, keff, rest)
                                              + tail))
            return g.reshape((B, anc_flat * keff * rest) + tail)

        return {"counts": torch.gather(c2, 2, top).reshape(B, -1),
                "ids": top.reshape(B, -1).to(torch.int32),
                "total": total, **_tree_map(gather, sub_out)}

    # ======================================================================
    # fetch (one batched device->host copy)
    # ======================================================================

    def _pack_outputs(self, out, aggs, B):
        """Walk the agg tree in deterministic order and concatenate every
        fruit leaf into ONE [B, F] int64 tensor (all device fruits are
        integral: exact limb sums, w-domain min/max, counts, ids, rows)."""
        spec = []
        parts = []

        def keep(path, key, v):
            spec.append((path, key, tuple(v.shape[1:])))
            parts.append(v.expand((B,) + tuple(v.shape[1:]))
                         .reshape(B, -1).to(torch.int64))

        def strip(node, r, path):
            if isinstance(node, (dict, tuple)):
                items = node.items() if isinstance(node, dict) else node
                for n, s in items:
                    strip(s, r[n], path + (n,))
                return
            if isinstance(node, (A.HistogramAgg, A.TermsAgg,
                                 A.FilterAgg, A.PostFilterAgg)):
                for k, v in r.items():
                    if not isinstance(v, dict):
                        keep(path, k, v)
                for n, s in node.sub_aggs:
                    strip(s, r[n], path + (n,))
                return
            for k, v in r.items():  # metric / count / percentile leaves
                keep(path, k, v)

        strip(aggs, out, ("a",))
        self._pack_spec = spec
        return torch.cat(parts, dim=1)

    def _unpack_host(self, vec: np.ndarray):
        """One packed int64 host row -> nested fruit dict of np views."""
        host: Dict[str, dict] = {}
        off = 0
        for path, key, shape in self._pack_spec:
            node = host
            for k in path[1:]:
                node = node.setdefault(k, {})
            size = 1
            for d in shape:
                size *= d
            node[key] = (vec[off:off + size].reshape(shape) if shape
                         else vec[off])
            off += size
        return host

    # ======================================================================
    # harvest (copied from the JAX package's aggs/compile.py)
    # ======================================================================

    @staticmethod
    def _flat(raw, flat, key):
        """Fruit scalar for this node at flattened bucket-prefix index
        `flat` (None = root scope, raw entries are unbucketed scalars).
        The flat index is threaded down the recursion as a plain int
        (child = parent * child_axis + j) instead of re-raveling prefix
        tuples per bucket — np.ravel_multi_index boxing was ~60% of the
        measured host harvest cost on bucketed trees (74ms/128-query
        batch on bench c3)."""
        a = raw[key]
        if flat is None:
            return a
        return a[flat]

    def _harvest(self, node, raw, path, flat):
        """`flat`: flattened index of the enclosing bucket prefix under
        this node's hdims chain (row-major, matching the device fruit
        layout), or None at root."""
        if isinstance(node, A.CountAgg):
            return {"value": int(self._flat(raw, flat, "cnt"))}
        if isinstance(node, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg,
                             A.StatsAgg)):
            return self._harvest_metric(node, raw, path, flat)
        if isinstance(node, A.PercentilesAgg):
            return self._harvest_percentiles(node, raw, path, flat)
        if isinstance(node, A.HistogramAgg):
            return self._harvest_histogram(node, raw, path, flat)
        if isinstance(node, A.FacetAgg):
            return self._harvest_facet(node, raw, path, flat)
        if isinstance(node, A.TermsAgg):
            return self._harvest_terms(node, raw, path, flat)
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            out = {"doc_count": int(self._flat(raw, flat, "cnt"))}
            for name, sub in node.sub_aggs:
                out[name] = self._harvest(sub, raw[name], path + (name,),
                                          flat)
            return out
        if isinstance(node, A.TopHitsAgg):
            return self._harvest_top_hits(node, raw, path, flat)
        raise TypeError(f"unknown agg {type(node)!r}")

    def _mono_from_mm(self, p, raw_val) -> int:
        """Device min/max output (narrow: w int32; wide: rm int64) -> mono."""
        if p["narrow"]:
            w = int(raw_val)
        else:
            w = int(raw_val) + 2**63
        return _wrap64(p["min_mono"] + w)

    def _user_scalar(self, ftype, mono: int):
        v = mono_mod.scalar_from_mono(ftype.value, mono)
        return float(v) if ftype == FieldType.F64 else int(v)

    def _reconstruct_sum(self, p, sum_out, cnt: int):
        if p["ftype"] == FieldType.F64:
            return exact.f64_reconstruct_sum(
                np.atleast_1d(np.asarray(sum_out)), p["base"])
        if p["direct"] and np.ndim(sum_out) == 0:
            return int(sum_out) + cnt * int(p["min_user"])
        return exact.int_reconstruct_sum(np.asarray(sum_out)) \
            + cnt * int(p["min_user"])

    def _sum_at(self, p, raw, flat, cnt: int):
        """_reconstruct_sum for a bucketed node, with a vectorized fast
        path: integer limb accumulators recombine for ALL buckets in one
        int64 numpy pass (cached on the raw dict) when the per-limb
        magnitude bound proves the int64 math cannot overflow; per-bucket
        Python big-int exactness otherwise. Same result by construction —
        the fast path only runs when its values equal the big-int ones."""
        if flat is None or p["ftype"] == FieldType.F64:
            return self._reconstruct_sum(p, self._flat(raw, flat, "sum"),
                                         cnt)
        a = np.asarray(raw["sum"])
        if a.ndim < 2:  # direct mode: one int32-ranged scalar per bucket
            return int(a[flat]) + cnt * int(p["min_user"])
        tot = raw.get("_sumtot", None)
        if tot is None:
            tot = _limb_totals_vec(a)
            raw["_sumtot"] = False if tot is None else tot
        if tot is not False:
            return int(tot[flat]) + cnt * int(p["min_user"])
        return exact.int_reconstruct_sum(a[flat]) + cnt * int(p["min_user"])

    def _harvest_metric(self, node, raw, path, flat):
        p = self.plan[path]
        ftype = p["ftype"]
        cnt = int(self._flat(raw, flat, "cnt"))

        def mmval(key):
            if cnt == 0:
                return None
            return self._user_scalar(
                ftype,
                self._mono_from_mm(p, self._flat(raw, flat, key)))

        if isinstance(node, A.SumAgg):
            return {"value": self._sum_at(p, raw, flat, cnt)}
        if isinstance(node, A.MinAgg):
            return {"value": mmval("min")}
        if isinstance(node, A.MaxAgg):
            return {"value": mmval("max")}
        s = self._sum_at(p, raw, flat, cnt)
        avg = None if cnt == 0 else (
            s / cnt if ftype == FieldType.F64 else float(Fraction(s) / cnt))
        if isinstance(node, A.AvgAgg):
            return {"value": avg, "sum": s, "count": cnt}
        return {"count": cnt, "sum": s, "min": mmval("min"),
                "max": mmval("max"), "avg": avg}

    def _harvest_percentiles(self, node, raw, path, flat=None):
        p = self.plan[path]
        ftype = p["ftype"]
        if p.get("pmode") == "slot_rank":
            flat = 0 if flat is None else flat
            m = int(np.asarray(raw["m"]).reshape(-1)[flat])
            if m == 0:
                return {"values": {str(q): None for q in node.percents}}
            if "vals" in raw or ("rows" not in raw
                                 and p.get("phase2_vals")):
                # sharded slot bisection (in-trace "vals", or phase-2
                # "pvals" for non-integer percents) emitted the selected
                # VALUES directly (narrow: w domain; wide: rm domain)
                vals = np.asarray(raw["vals"] if "vals" in raw
                                  else raw["pvals"]).reshape(
                    -1, 2 * len(node.percents))[flat]
                out = {}
                for i, q in enumerate(node.percents):
                    _, _, frac = exact.percentile_rank(q, m)
                    v_lo = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i]))
                    v_hi = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i + 1]))
                    out[str(q)] = exact.interpolate(float(v_lo),
                                                    float(v_hi), frac)
                return {"values": out}
            rows = np.asarray(raw["rows"] if "rows" in raw
                              else raw["pvals"]).reshape(
                -1, 2 * len(node.percents))[flat]
            out = {}
            for i, q in enumerate(node.percents):
                _, _, frac = exact.percentile_rank(q, m)
                v_lo = self._user_scalar(
                    ftype, int(p["layout"].sorted_mono[int(rows[2 * i])]))
                v_hi = self._user_scalar(
                    ftype,
                    int(p["layout"].sorted_mono[int(rows[2 * i + 1])]))
                out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                                frac)
            return {"values": out}
        m = int(raw["m"])
        if m == 0:
            return {"values": {str(q): None for q in node.percents}}
        if p["pmode"] == "rank" and p.get("int_percents"):
            if p.get("bisect"):
                # cross-shard bisection emitted the selected VALUES directly
                # (narrow: w domain; wide: rm domain)
                vals = np.asarray(raw["vals"])
                out = {}
                for i, q in enumerate(node.percents):
                    _, _, frac = exact.percentile_rank(q, m)
                    v_lo = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i]))
                    v_hi = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i + 1]))
                    out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                                    frac)
                return {"values": out}
            rows = np.asarray(raw["rows"])
            out = {}
            for i, q in enumerate(node.percents):
                _, _, frac = exact.percentile_rank(q, m)
                v_lo = self._user_scalar(
                    ftype, int(p["layout"].sorted_mono[int(rows[2 * i])]))
                v_hi = self._user_scalar(
                    ftype, int(p["layout"].sorted_mono[int(rows[2 * i + 1])]))
                out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                                frac)
            return {"values": out}
        got = np.asarray(raw["pvals"])
        fracs = raw["_fracs"]
        out = {}
        for i, q in enumerate(node.percents):
            if p["pmode"] == "rank" and not p.get("bisect"):
                lo_mono = int(p["layout"].sorted_mono[int(got[2 * i])])
                hi_mono = int(p["layout"].sorted_mono[int(got[2 * i + 1])])
            else:  # bisect paths emitted rm (wide) or w (narrow) values
                def to_mono(v):
                    w = int(v) if p["narrow"] else int(v) + 2**63
                    return _wrap64(p["min_mono"] + w)
                lo_mono = to_mono(got[2 * i])
                hi_mono = to_mono(got[2 * i + 1])
            v_lo = self._user_scalar(ftype, lo_mono)
            v_hi = self._user_scalar(ftype, hi_mono)
            out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                            fracs[i])
        return {"values": out}

    def _harvest_histogram(self, node, raw, path, flat):
        p = self.plan[path]
        nb, k_min, ftype = p["nb"], p["k_min"], p["ftype"]
        base = (0 if flat is None else flat) * nb
        row = np.asarray(raw["counts"]).reshape(-1)[base:base + nb]
        buckets = []
        for j in np.nonzero(row)[0].tolist():
            c = int(row[j])
            k = k_min + j
            if "keys" in p:  # calendar: keys ARE the period-start micros
                key = int(p["keys"][k])
            elif ftype == FieldType.F64:
                key = exact.f64_histogram_key(k, float(node.interval),
                                              float(node.offset))
            else:
                key = int(node.offset) + k * int(node.interval)
            b = {"key": key, "doc_count": c}
            for name, sub in node.sub_aggs:
                b[name] = self._harvest(sub, raw[name], path + (name,),
                                        base + j)
            buckets.append(b)
        return {"buckets": buckets}

    def _term_key_user(self, p, tid: int):
        if p["ftype"] == FieldType.BYTES:
            return bytes(p["keys"][tid])
        if p["ftype"].is_stringy:
            return str(p["keys"][tid])
        return self._user_scalar(p["ftype"], int(p["keys_mono"][tid]))

    def _harvest_terms_hostsel(self, node, raw, path, flat):
        """Host-side exact selection for `order` modes the device cannot
        prove exact (avg, f64 sums, limb-plane sums): compares HARVESTED
        user values — the identical comparator to the oracle — with key-asc
        ties via the key-ascending bucket id order."""
        p = self.plan[path]
        card = p["card"]
        base = 0 if flat is None else flat
        cvec = np.asarray(raw["counts"]).reshape(-1, card)[base]
        present = np.nonzero(cvec > 0)[0].tolist()
        target, direction = p["order"]
        desc = direction == "desc"
        if target == "_count":
            # host-forced selection of a count-ordered node (e.g. a
            # non-integer-percent percentile sub pins the fruits to full
            # slot space): (count desc/asc, key asc) like the device top-k
            order_ids = sorted(present,
                               key=lambda j: (-int(cvec[j]) if desc
                                              else int(cvec[j]), j))
        elif target == "_key":
            order_ids = sorted(present, reverse=desc)
        else:
            sub = dict(node.sub_aggs)[target]
            vals = {j: self._harvest(sub, raw[target], path + (target,),
                                     base * card + j)["value"]
                    for j in present}
            ids = [j for j in present if vals[j] is not None]
            nones = [j for j in present if vals[j] is None]
            ids.sort(key=lambda j: vals[j], reverse=desc)
            order_ids = ids + nones
        top = order_ids[: node.size]
        buckets = []
        shown = 0
        for j in top:
            c = int(cvec[j])
            shown += c
            b = {"key": self._term_key_user(p, j), "doc_count": c}
            for name, s in node.sub_aggs:
                b[name] = self._harvest(s, raw[name], path + (name,),
                                        base * card + j)
            buckets.append(b)
        return {"buckets": buckets,
                "sum_other_doc_count": int(cvec.sum()) - shown}

    def _harvest_facet(self, node, raw, path, flat):
        """Facet harvest (§A.12): slice the full per-ordinal count vector
        to the static child ordinals, order (count desc, path asc)."""
        p = self.plan[path]
        card = p["card"]
        base = 0 if flat is None else flat
        cvec = np.asarray(raw["counts"]).reshape(-1, card)[base]
        rows = [(str(p["keys"][j]), int(cvec[j]))
                for j in p["facet_children"] if cvec[j] > 0]
        rows.sort(key=lambda kv: (-kv[1], kv[0]))
        return {"buckets": [{"key": k, "doc_count": c}
                            for k, c in rows[: node.size]]}

    def _harvest_terms(self, node, raw, path, flat):
        p = self.plan[path]
        if p["sel"] == "host":
            return self._harvest_terms_hostsel(node, raw, path, flat)
        keff = p["keff"]
        base = (0 if flat is None else flat) * keff
        crow = np.asarray(raw["counts"]).reshape(-1)[base:base + keff]
        ids = np.asarray(raw["ids"]).reshape(-1)
        total = np.asarray(raw["total"]).reshape(-1)
        total_here = int(total[0 if flat is None else flat])
        shown = 0
        buckets = []
        for i in np.nonzero(crow)[0].tolist():
            c = int(crow[i])
            tid = int(ids[base + i])
            key = self._term_key_user(p, tid)
            shown += c
            b = {"key": key, "doc_count": c}
            for name, sub in node.sub_aggs:
                b[name] = self._harvest(sub, raw[name], path + (name,),
                                        base + i)
            buckets.append(b)
        return {"buckets": buckets, "sum_other_doc_count": total_here - shown}

    def _harvest_top_hits(self, node, raw, path, flat=None):
        p = self.plan[path]
        if p.get("in_slot"):
            flat = 0 if flat is None else flat
            keys_a = np.asarray(raw["keys"])
            kcap = keys_a.shape[-1]
            m = int(np.asarray(raw["m"]).reshape(-1)[flat])
            k = min(node.size, m, kcap)
            keys = keys_a.reshape(-1, kcap)[flat][:k]
            docs = np.asarray(raw["docs"]).reshape(-1, kcap)[flat][:k]
        else:
            m = int(raw["m"])
            k = min(node.size, m)
            keys = np.asarray(raw["keys"])[:k]
            docs = np.asarray(raw["docs"])[:k]
        starts = self.dindex.seg_starts
        hits = []
        for kk, dd in zip(keys.tolist(), docs.tolist()):
            si = int(np.searchsorted(starts, dd, side="right")) - 1
            hit = {"segment": si, "doc": int(dd - starts[si])}
            if p.get("score"):
                hit["score"] = 1.0  # scoring-disabled constant score (§A.10)
            else:
                rm = int(kk) if node.ascending else int(~np.int64(kk))
                mono = self._mono_from_mm(p, rm)
                hit["value"] = self._user_scalar(p["ftype"], mono)
            hits.append(hit)
        return {"hits": hits}


def _limb_totals_vec(a: np.ndarray):
    """[H, L] int64 limb accumulators -> [H] exact totals as int64, or
    None when the magnitude bound cannot prove the recombination
    int64-overflow-free (caller falls back to per-bucket Python big
    ints). Proof: |sum_i a[h,i] << LIMB_BITS*i| and every prefix partial
    are <= sum_i max_h|a[h,i]| << LIMB_BITS*i = bound < 2^62."""
    if a.ndim != 2 or a.size == 0:
        return None
    mx = np.abs(a).max(axis=0)
    bound = sum(int(m) << (exact.LIMB_BITS * i)
                for i, m in enumerate(mx.tolist()))
    if bound >= 2 ** 62:
        return None
    tot = a[:, 0].astype(np.int64, copy=True)
    for i in range(1, a.shape[1]):
        tot += a[:, i].astype(np.int64) << np.int64(exact.LIMB_BITS * i)
    return tot


def _payload_fields(node):
    """The fields of a prefix node's Sum / Avg subs (its payloads)."""
    return [s.field for _, s in node.sub_aggs
            if isinstance(s, (A.SumAgg, A.AvgAgg))]


def _merge_plane_outs(outs):
    """Merge a plane fan-out's per-plane fruit trees: counts and sums add,
    min / max fold (each plane is a disjoint set of value occurrences)."""
    out = {}
    for key, v in outs[0].items():
        vals = [o[key] for o in outs]
        if isinstance(v, dict):
            out[key] = _merge_plane_outs(vals)
            continue
        r = vals[0]
        for x in vals[1:]:
            r = (torch.minimum(r, x) if key == "min"
                 else torch.maximum(r, x) if key == "max" else r + x)
        out[key] = r
    return out


def _has_selection_sub(node) -> bool:
    """True if a descendant's fruit is a selection (top_hits, percentiles):
    per-plane fruits of those do not merge."""
    for _, s in getattr(node, "sub_aggs", ()):
        if isinstance(s, (A.TopHitsAgg, A.PercentilesAgg)) \
                or _has_selection_sub(s):
            return True
    return False


def _int_percents(node) -> bool:
    """True when every percent of a PercentilesAgg is an integer (its
    ranks resolve in the run; any other resolves them in phase 2)."""
    return all(float(q).is_integer() for q in node.percents)


def _has_nonint_pct_sub(node) -> bool:
    """True when any descendant agg is a PercentilesAgg with non-integer
    percents (the shape whose phase-2 machinery needs full-slot-space
    fruits — see _plan_terms_order / _plan_percentiles)."""
    for _, sub in getattr(node, "sub_aggs", ()):
        if isinstance(sub, A.PercentilesAgg) \
                and not all(float(q).is_integer() for q in sub.percents):
            return True
        if _has_nonint_pct_sub(sub):
            return True
    return False


def _has_pct_sub(node) -> bool:
    """True when any descendant agg is a PercentilesAgg."""
    for _, sub in getattr(node, "sub_aggs", ()):
        if isinstance(sub, A.PercentilesAgg) or _has_pct_sub(sub):
            return True
    return False


def _rank_select_rows_lazy(cum, ranks, window_of, G):
    """For each 0-based rank r of each query (and slot): the layout row of
    the (r+1)-th matched row, from an inclusive per-G-row-group
    match-count prefix cum [..., NG] (int32 or int64) and a
    `window_of(blk [..., K]) -> bool [..., K, G]` recompute callback (no
    materialized mask). ranks: [..., K] int64 -> rows [..., K] int64. Ranks
    past the match count (m == 0) give rows the harvest never reads: the
    block index is clamped into [0, NG)."""
    targets = ranks + 1
    blk = torch.searchsorted(cum, targets.to(cum.dtype), side="left")
    blk = blk.clamp(max=cum.shape[-1] - 1)
    prev = torch.gather(cum, -1, (blk - 1).clamp(min=0)).to(torch.int64)
    base = torch.where(blk > 0, prev, 0)
    inner = torch.cumsum(window_of(blk), dim=-1)
    off = (inner < (targets - base)[..., None]).sum(dim=-1)
    return blk * G + off


def _t2h(t: torch.Tensor) -> dict:
    """A device artifact's host form for the prep cache."""
    return {"a": t.cpu().numpy()}


def _h2t(h: dict, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(h["a"])).to(device)


class ShardedProgram:
    """A Program over a doc-sharded index (JAX `shard_map`): one Program
    per shard, planned and run in lockstep on the mesh's shard threads
    (parallel/shard.py MeshGroup.run), each on its shard's DeviceIndex.
    Fruits leave every shard merged, so shard 0's packed copy is the one
    staged and harvested; phase 2 resolves host ranks once and bisects on
    every shard.

    On a mesh whose shards share one card (JAX's `shard_map` under
    `jax.jit`), the step is one CUDA graph per padded batch B holding the S
    shard bodies and their collectives, captured in turn order on one
    stream (`_StepGraph`; the bodies share one [B, P] param matrix), and
    phase 2's bisection of each node one graph per padded B; a mesh over
    several cards runs both eagerly (mesh_graph_mode), and the CPU runs
    raw_fn."""

    def __init__(self, sindex, query, aggs, config=None):
        self.mesh = sindex.mesh
        self.progs = self.mesh.run(
            lambda s: Program(sindex.shards[s], query, aggs, config=config))
        p0 = self.progs[0]
        for s, pg in enumerate(self.progs[1:], 1):
            if _plan_sig(pg.plan) != _plan_sig(p0.plan):
                raise RuntimeError(f"shard {s} planned other modes than "
                                   "shard 0")
        self.plan = p0.plan
        self.config = p0.config
        self.device = p0.device
        self.batch_cap = self._batch_cap()
        #: the captured steps and phase-2 selections on the card, per
        #: padded batch size (and node)
        self._graphs: Dict[object, _StepGraph] = {}

    def _batch_cap(self):
        """The msearch group bound: shards on one device share its
        BATCH_MEM_BUDGET."""
        per_dev = {}
        for pg in self.progs:
            d = str(pg.device)
            per_dev[d] = per_dev.get(d, 0) + pg._per_query_bytes()
        worst = max(per_dev.values())
        if worst == 0:
            return None
        return max(1, Program.BATCH_MEM_BUDGET // worst)

    def param_key(self, query, aggs):
        return self.progs[0].param_key(query, aggs)

    def accepts(self, query, aggs) -> bool:
        return self.progs[0].accepts(query, aggs)

    def example_inputs(self):
        """(pmat, [each shard's arrays]) for this program's own request:
        example arguments for raw_fn (JAX `Program.example_inputs`)."""
        p0 = self.progs[0]
        return p0.example_inputs()[0], [pg._arrays for pg in self.progs]

    def as_callable(self):
        """(raw_fn, example_inputs()): the mesh step as a plain function
        (JAX's `shard_map` step); on one card submit_many replays it as one
        captured graph."""
        return self.raw_fn, self.example_inputs()

    def submit(self, query, aggs):
        return self.submit_many([query], aggs)

    def _captures(self) -> bool:
        return self.device.type == "cuda" and self.plan["graph"]

    def _keep(self):
        return [pg._keep() for pg in self.progs]

    @staticmethod
    def _on(stream):
        """MeshGroup.run's ctx: `stream` current in every shard thread."""
        return lambda s: torch.cuda.stream(stream)

    def submit_many(self, queries, aggs, pad_to=None):
        """Each shard runs the [B, P] param matrix (`pad_to` repeats the
        last request, as Program.submit_many does): on one card the
        mesh's graph for this B (captured at the first call of each B)
        replayed, else raw_fn (the matrix built once, copied to each
        device). Spanned as Program.submit_many is."""
        p0 = self.progs[0]
        with span("tat.submit"):
            mat = p0._param_rows(queries, aggs, pad_to)
            arrays = [pg._arrays for pg in self.progs]
            if not self._captures():
                pmat = qc.to_device_async(mat, p0.device)
                with span("tat.launch"):
                    return self.raw_fn(pmat, arrays)
            return _replayed(
                self, mat.shape[0], lambda: p0._pmat_buffer(mat.shape[0]),
                lambda ins: qc.to_device_async(mat, self.device, out=ins[0]),
                lambda ins, stream: self.raw_fn(ins[0], arrays,
                                                ctx=self._on(stream)),
                self._keep(), clone=("big",))

    def raw_fn(self, pmat, arrays, ctx=None):
        """The mesh step: every shard runs its Program's raw_fn over its
        own arrays (`arrays[s]`) in lockstep, each inside `ctx(s)` where
        given (MeshGroup.run); {"packed": shard 0's merged fruits, "big":
        every shard's phase-1 state, or {} without phase 2}."""
        pms = [pmat if pg.device == pmat.device else pmat.to(pg.device)
               for pg in self.progs]
        raws = self.mesh.run(lambda s: self.progs[s].raw_fn(pms[s],
                                                            arrays[s]),
                             ctx=ctx)
        big = [r["big"] for r in raws] if raws[0]["big"] else {}
        return {"packed": raws[0]["packed"], "big": big}

    def run(self, query, aggs):
        return self.finalize(self.submit(query, aggs), aggs)

    def stage(self, raw, aggs):
        with span("tat.stage"):
            return _Staged(raw["packed"], raw["big"])

    def finalize(self, raw, aggs, staged=None):
        return self.finalize_many(raw, aggs, 1, staged=staged)[0]

    def finalize_many(self, raw, aggs, B: int, staged=None):
        staged = staged if staged is not None else self.stage(raw, aggs)
        p0 = self.progs[0]
        vecs = staged.numpy()
        with span("tat.harvest"):
            hosts = [p0._unpack_host(vecs[b]) for b in range(B)]
            if staged.big:
                bigs = staged.big
                with span("tat.phase2"):
                    ranks = p0._phase2_ranks(hosts, bigs[0])
                    p0._phase2_attach(hosts,
                                      self._phase2_select(ranks, bigs, B))
            return [p0.harvest_host(h, aggs) for h in hosts]

    def _phase2_select(self, ranks, bigs, B):
        """{path: [B, ...] values of the global ranks}: every shard's
        bisection of each node, shard 0's values; on one card one
        replayed graph per node and padded batch (the ranks through one
        pinned copy into one static buffer the shards share, each shard's
        phase-1 state copied into static buffers), else eagerly."""
        if not self._captures():
            return self.mesh.run(lambda s: self.progs[s]._phase2_select(
                ranks, bigs[s], B))[0]
        return {path: _phase2_replayed(
            self, path, [big[path] for big in bigs], rk,
            lambda r, sts, stream, path=path: self.mesh.run(
                lambda s: self.progs[s].select_raw(
                    path, sts[s], self.progs[s]._arrays, r),
                ctx=self._on(stream))[0])[:B]
            for path, rk in ranks}


def _plan_sig(plan) -> dict:
    """The modes of a plan, node by node (what every shard must agree
    on)."""
    keys = ("kind", "mode", "pmode", "sel", "bisect", "slot_bisect",
            "mask_gather", "in_slot", "pallas_counts", "pallas_prefix",
            "pallas_slots", "int_percents", "nb", "card", "k")
    return {path: (tuple(p.get(k) for k in keys),
                   bool(p.get("cube")), "xpand" in p)
            for path, p in plan.items() if isinstance(p, dict)}


def get_program(dindex, query, aggs, config=None):
    """The Program (a ShardedProgram on a mesh) of the request's shape:
    planning, and the cube, dense and member operands it builds
    (`tat.build`)."""
    from ..index.loader import ShardedIndex
    with span("tat.build"):
        if isinstance(dindex, ShardedIndex):
            return ShardedProgram(dindex, query, aggs, config=config)
        return Program(dindex, query, aggs, config=config)
