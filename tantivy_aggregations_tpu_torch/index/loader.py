"""Device index loader: host segments -> device-resident int32 column planes.

The port keeps the JAX package's plane ENCODING unchanged (so the copied
harvest code and the differential tests read the same numbers):

- Each numeric field maps through the order-preserving int64 "mono" domain
  (utils/mono.py) and is stored as int32 planes of the offset
  w = mono - min_mono: one plane `w` when the span fits int32 (narrow), else
  a lexicographic (hi, lo) monoized pair (wide). Exact sums read the narrow
  `w` plane directly or signed 26-bit limb planes (utils/exact.py).
- Single-cardinality keyword fields are DENSE: one int32 global-ordinal
  column (-1 = missing) aligned with the doc axis.
- Multi-valued fields keep their values as padded CSR VALUE ROWS (`w` or
  (`hi`, `lo`) over the value axis, with the owning `doc` and a `valid`
  plane), read by value-row layouts (percentiles and bucket aggs over the
  field) and through per-doc pre-aggregates (metric aggs in doc space).
  Query masks read DENSE doc-aligned per-position planes instead: value
  position k of each doc, k < DENSE_MULTI_K, as `mp{k}` (narrow / keyword
  w values, -1 where the doc has no k-th value) or as a lexicographic
  (`mph{k}`, `mpl{k}`) pair beside the value-count plane `mpn` (wide), plus
  an overflow TAIL of the value rows past position DENSE_MULTI_K-1 (`tw` |
  `th`/`tl`, `tdoc`, `tvalid`), which only doc-space evaluation reads.
- Segments are concatenated on one doc axis padded to PAD_BLOCK.
- OrderedLayout: a load-time argsort of a column with 32-aligned bucket
  padding (bucket layouts) or value order (value layouts), the static views
  the chain kernels scan.

Sharded loading (`load_sharded_index`, the JAX loader's
`load_device_index(index, mesh)`): the doc axis is padded to PAD_BLOCK * S
and split into S contiguous chunks of T/S rows; CSR value rows (and
overflow tails) are partitioned by owning shard, each shard's slice padded
to one common PAD_BLOCK multiple, with shard-local doc ids. Each shard is a
DeviceIndex of its own on its mesh device whose columns (`ShardColumn`) are
views of one global host column: the same encoding, dictionaries, term ids,
sum plans and pre-aggregate bounds, the shard's rows only. Layouts built on
a shard column sort its rows only, so a permutation never crosses a shard.

OrderedLayouts go through the cross-process prep cache
(utils/prep_cache.py, `_layout_cached`), keyed by column, layout kind and
shard. What the port leaves out: the packed host->device transport and
device limb derivation (the TPU's remote link made bytes expensive; here a
plane is one `torch.from_numpy(a).to(device)` copy and limb planes are
computed on the host).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..schema import Cardinality, FieldType, Schema
from ..utils import exact, mono as mono_mod, prep_cache as PC
from ..utils.stats import span

#: doc/value axes are padded to a multiple of this (kept from the JAX
#: package so both engines see the same padded row counts; a multiple of
#: 128, so every chain-kernel group is whole)
PAD_BLOCK = 32768
#: narrow-column span bound: span+1 must stay in int32
NARROW_MAX_SPAN = 2**31 - 2
#: OrderedLayout bucket boundaries are aligned to this many rows
ALIGN = 32
#: dense per-position planes of a narrow / keyword multi-valued field cover
#: value positions 0..DENSE_MULTI_K-1 of each doc
DENSE_MULTI_K = 8

I32 = np.int32


def _pad_to(n: int, block: int) -> int:
    return max(block, ((n + block - 1) // block) * block)


def _put(arr, device) -> torch.Tensor:
    """One host plane -> a device tensor (a single host->device copy)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _split_wide(w_u64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """u64 offsets -> (hi, lo) monoized int32 planes (lexicographic order
    over (hi, lo) == numeric order over w)."""
    hi = ((w_u64 >> np.uint64(32)).astype(np.int64) - 2**31).astype(I32)
    lo = ((w_u64 & np.uint64(0xFFFFFFFF)).astype(np.int64) - 2**31).astype(I32)
    return hi, lo


@dataclass
class OrderedLayout:
    """Static value-order view of a column (see module docstring)."""

    perm: np.ndarray  # [R] int32: row index (doc or value-row) per position
    n_rows: int  # padded length R (multiple of PAD_BLOCK, incl. dead pad)
    #: for bucket layouts: 32-aligned row offsets per bucket id [card+1]
    bounds: Optional[np.ndarray] = None
    valid_perm_host: Optional[np.ndarray] = None  # [R] int8: 0 on padding
    #: for percentile layouts: values in position order (host int64 mono)
    sorted_mono: Optional[np.ndarray] = None
    #: permuted device plane cache: key -> [R] tensor
    cache: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class DeviceColumn:
    """One loaded column. Device planes (`w`/`hi`/`lo`/...) are LAZY: the
    host plane is built at load, and ships on first use by a program."""

    name: str
    ftype: FieldType
    multi: bool  # multi-valued field (CSR value rows)
    narrow: bool = True
    # keyword: `w` holds global ordinals (dense: -1 = missing)
    terms: Optional[np.ndarray] = None  # global sorted term table (host)
    # -- static metadata ------------------------------------------------------
    min_mono: int = 0
    max_mono: int = 0
    n_values: int = 0
    span: int = 0  # max_mono - min_mono (as u64 width)
    # -- exact-sum plan -------------------------------------------------------
    sum_direct: bool = True  # narrow ints: sum the w plane directly
    f64_base_exp: int = 1
    sum_n_limbs: int = 1
    _device: object = "cuda"
    _host_values: Optional[np.ndarray] = None  # user-domain, padded layout
    _host_valid: Optional[np.ndarray] = None
    _host_mono: Optional[np.ndarray] = None  # int64 mono, padded layout
    _host_doc: Optional[np.ndarray] = None  # multi: int32 doc per value row
    _orig_docs: Optional[np.ndarray] = None  # multi: global doc per value
    _orig_values: Optional[np.ndarray] = None  # multi: values, doc order
    _w_host: Optional[np.ndarray] = None   # int32 [R] (narrow / ordinals)
    _hi_host: Optional[np.ndarray] = None  # int32 [R] (wide)
    _lo_host: Optional[np.ndarray] = None
    _valid8_host: Optional[np.ndarray] = None  # multi: int8 [V]
    #: lazily shipped device tensors, keyed by plane name
    _dev: Dict[str, torch.Tensor] = field(default_factory=dict)
    # -- numeric terms dictionary (lazy) --------------------------------------
    _term_ids_host: Optional[np.ndarray] = None
    _term_values_mono: Optional[np.ndarray] = None
    # -- ordered layouts (lazy) -----------------------------------------------
    _bucket_layout: Optional[OrderedLayout] = None
    _value_layout: Optional[OrderedLayout] = None
    # per-doc pre-aggregate planes for CSR metric sub-aggs (lazy, static)
    _doc_preagg: Optional[dict] = None
    #: narrow / keyword multi-valued fields: doc-aligned int32 [T] planes
    #: of the value at positions 0..DENSE_MULTI_K-1 of each doc (w values;
    #: keyword: global ordinals), -1 where the doc has no value there
    multi_planes_host: Optional[list] = None
    #: wide multi-valued fields: per position k a doc-aligned (hi, lo)
    #: int32 pair (the single-valued wide split, so the same params compare)
    #: and one shared value-count plane `mpn`, the validity guard (every
    #: (hi, lo) pair is an attainable value: no free sentinel)
    multi_planes_wide_host: Optional[list] = None
    _mpn_host: Optional[np.ndarray] = None
    #: the overflow tail of docs with more than DENSE_MULTI_K values: their
    #: value rows from position DENSE_MULTI_K on, as a padded CSR triple
    #: (narrow: `tw`, -1 fill; wide: `th`/`tl`) with `tdoc` and `tvalid`
    _tail_w_host: Optional[np.ndarray] = None
    _tail_hi_host: Optional[np.ndarray] = None
    _tail_lo_host: Optional[np.ndarray] = None
    _tail_doc_host: Optional[np.ndarray] = None
    _tail_valid8_host: Optional[np.ndarray] = None
    #: the prep cache anchor of the column's index: ((path, epoch,
    #: n_shards), key prefix); set by DeviceIndex.column
    _prep: Optional[tuple] = None

    @property
    def has_multi_planes(self) -> bool:
        return self.multi_planes_host is not None

    @property
    def has_multi_planes_wide(self) -> bool:
        return self.multi_planes_wide_host is not None

    @property
    def has_tail(self) -> bool:
        return (self._tail_w_host is not None
                or self._tail_hi_host is not None)

    @property
    def has_value_rows(self) -> bool:
        """A multi-valued column whose padded value rows carry a doc map:
        the gate of value-row layouts (percentiles over the field)."""
        return self.multi and self._host_doc is not None

    def global_doc_of_rows(self, T: int) -> np.ndarray:
        """[V] int64 doc id per value row (one device: the stored ids are
        global already)."""
        return self._host_doc.astype(np.int64)

    def host_plane(self, kind: str) -> np.ndarray:
        """The host plane behind the device plane `kind` (the part after
        the ':' of a mask program's plane key): w / hi / lo (doc rows, or
        value rows of a multi-valued field), doc / valid (value rows),
        mp{k}, mph{k}, mpl{k}, mpn (doc-aligned per-position planes), tw /
        th / tl / tdoc / tvalid (the overflow tail)."""
        fixed = {"w": self._w_host, "hi": self._hi_host, "lo": self._lo_host,
                 "doc": self._host_doc, "valid": self._valid8_host,
                 "mpn": self._mpn_host, "tw": self._tail_w_host,
                 "th": self._tail_hi_host, "tl": self._tail_lo_host,
                 "tdoc": self._tail_doc_host,
                 "tvalid": self._tail_valid8_host}
        if kind in fixed:
            return fixed[kind]
        if kind.startswith("mph"):
            return self.multi_planes_wide_host[int(kind[3:])][0]
        if kind.startswith("mpl"):
            return self.multi_planes_wide_host[int(kind[3:])][1]
        if kind.startswith("mp"):
            return self.multi_planes_host[int(kind[2:])]
        raise KeyError(f"column {self.name!r} has no plane {kind!r}")

    def plane(self, kind: str) -> torch.Tensor:
        """The device plane `kind` (see host_plane), shipped on first use."""
        return self._ship(kind, self.host_plane(kind))

    # -- lazy device planes ---------------------------------------------------

    def _ship(self, key: str, host):
        if host is None:
            return None
        if key not in self._dev:
            self._dev[key] = _put(host, self._device)
        return self._dev[key]

    @property
    def w(self):
        return self._ship("w", self._w_host)

    @property
    def hi(self):
        return self._ship("hi", self._hi_host)

    @property
    def lo(self):
        return self._ship("lo", self._lo_host)

    # -- exact-sum limb planes ------------------------------------------------

    def sum_limbs(self) -> torch.Tensor:
        """[T, L] int32 device limb planes (built on the host)."""
        if "limbs" not in self._dev:
            self._dev["limbs"] = _put(self.sum_limbs_host(), self._device)
        return self._dev["limbs"]

    def sum_limbs_host(self) -> np.ndarray:
        if self.ftype == FieldType.F64:
            return exact.f64_limb_planes(
                self._host_values, self.f64_base_exp, self.sum_n_limbs)
        wu = _w_u64(self._host_mono, self.min_mono)
        return exact.int_limb_planes(wu.view(np.int64), self.sum_n_limbs)

    def limb_bounds(self) -> list:
        """Per-plane static (lo, hi) value bounds of the sum_limbs() planes
        (plan-time metadata for the int8 piece decomposition of the dense
        products). Integer fields: limbs of the non-negative offset
        w <= span, so plane i is bounded by span >> 26i — the top plane of
        a modest-span column needs 1 piece instead of 5. f64: signed
        26-bit limbs."""
        if self.ftype == FieldType.F64:
            m = exact.LIMB_MASK
            return [(-m, m)] * self.sum_n_limbs
        return [(0, min(exact.LIMB_MASK,
                        int(self.span) >> (exact.LIMB_BITS * i)))
                for i in range(self.sum_n_limbs)]

    # -- lazy numeric terms dictionary ----------------------------------------

    def term_ids(self):
        """(host int32 term id per row, -1 = none; host sorted distinct
        monos) of a numeric column."""
        if self._term_ids_host is None:
            m = self._host_mono
            real = m if self._host_valid is None else m[self._host_valid]
            uniq = np.unique(real) if real.size else np.zeros(1, np.int64)
            ids = np.clip(np.searchsorted(uniq, m), 0, len(uniq) - 1) \
                .astype(I32)
            if self._host_valid is not None:
                ids = np.where(self._host_valid, ids, -1)
            self._term_ids_host = ids
            self._term_values_mono = uniq
        return self._term_ids_host, self._term_values_mono

    def tid(self) -> torch.Tensor:
        """Device term-id plane of a numeric column."""
        return self._ship("tid", self.term_ids()[0])

    @property
    def card(self) -> int:
        if self.ftype.is_stringy:
            return max(1, len(self.terms))
        self.term_ids()
        return max(1, len(self._term_values_mono))

    def min_user(self):
        return mono_mod.scalar_from_mono(self.ftype.value, self.min_mono)

    # -- precomputed histogram bucket ids (host-exact, cached per layout) -----
    _bid_cache: Optional[dict] = None

    def bucket_id_plane(self, key: str, build_host) -> torch.Tensor:
        """Cached device int32 plane of per-row bucket ids for a histogram
        shape (interval/offset static per program), computed host-side with
        exact integer/rational arithmetic once."""
        if self._bid_cache is None:
            self._bid_cache = {}
        if key not in self._bid_cache:
            self._bid_cache[key] = _put(build_host().astype(I32),
                                        self._device)
        return self._bid_cache[key]

    # -- per-doc pre-aggregates for CSR metric aggs ---------------------------

    def doc_preagg_host(self, T: int) -> dict:
        if self._doc_preagg is None:
            docs = self._orig_docs
            n = docs.shape[0]
            cnt = np.bincount(docs, minlength=T).astype(I32) if n \
                else np.zeros(T, I32)
            # per-doc exact sums -> canonical signed 26-bit limb planes
            if self.ftype == FieldType.F64:
                row_planes = exact.f64_limb_planes(
                    self._orig_values, self.f64_base_exp, self.sum_n_limbs)
            else:
                wu = _w_u64(np.asarray(mono_mod.to_mono(
                    self.ftype.value, self._orig_values), np.int64),
                    self.min_mono)
                row_planes = exact.int_limb_planes(
                    wu.view(np.int64), self.sum_n_limbs)
            L = row_planes.shape[1]
            plane_sums = np.zeros((T, L), np.int64)
            for i in range(L):
                # integer scatter-add (np.add.at): exact at any magnitude
                np.add.at(plane_sums[:, i], docs,
                          row_planes[:, i].astype(np.int64))
            sum_planes = exact.carry_normalize_planes(plane_sums)
            # per-doc min/max in mono domain (rows are doc-ascending)
            offs = np.zeros(T + 1, np.int64)
            np.cumsum(cnt, out=offs[1:])
            monos = np.asarray(mono_mod.to_mono(
                self.ftype.value, self._orig_values), np.int64) if n \
                else np.zeros(0, np.int64)
            has = cnt > 0
            mn = np.full(T, self.min_mono, np.int64)
            mx = np.full(T, self.min_mono, np.int64)
            if n:
                # reduceat needs indices < len(operand): append a duplicate
                # of the last value so index n is addressable (see the JAX
                # loader for the fuzz-found reason)
                ext = np.concatenate([monos, monos[-1:]])
                mn = np.where(has, np.minimum.reduceat(ext, offs[:-1]),
                              self.min_mono)
                mx = np.where(has, np.maximum.reduceat(ext, offs[:-1]),
                              self.min_mono)
            _, mnA, mnB = _mono_planes(mn, self.min_mono, self.span)
            _, mxA, mxB = _mono_planes(mx, self.min_mono, self.span)
            self._doc_preagg = {"cnt": cnt, "sum": sum_planes,
                                "minA": mnA, "minB": mnB,
                                "maxA": mxA, "maxB": mxB}
        return self._doc_preagg

    _preagg_bounds: Optional[dict] = None

    def preagg_bounds(self, T: int) -> dict:
        """Static (lo, hi) bounds of the doc_preagg planes, computed once
        from the host pre-aggregates (query-independent): 'cnt' for the
        per-doc value-count plane, 'sum' per carry-normalized limb plane.
        High limb planes of small-valued columns come back (0, 0) and are
        dropped from the int8 operands entirely."""
        if self._preagg_bounds is None:
            pre = self.doc_preagg_host(T)
            s = pre["sum"]
            self._preagg_bounds = {
                "cnt": (0, int(pre["cnt"].max(initial=0))),
                "sum": [(int(s[:, i].min(initial=0)),
                         int(s[:, i].max(initial=0)))
                        for i in range(s.shape[1])],
            }
        return self._preagg_bounds

    # -- ordered layouts ------------------------------------------------------

    def _layout_cached(self, kind_key, build) -> OrderedLayout:
        """Build-or-load an OrderedLayout through the cross-process prep
        cache (JAX `_layout_cached`): its perm, validity, bounds and sorted
        values as host arrays."""
        if self._prep is None:
            return build()
        anchor, pre = self._prep

        def to_host(lo):
            arrays = {"perm": lo.perm, "valid": lo.valid_perm_host}
            if lo.bounds is not None:
                arrays["bounds"] = lo.bounds
            if lo.sorted_mono is not None:
                arrays["sm"] = lo.sorted_mono
            return arrays

        def from_host(h):
            return OrderedLayout(
                perm=h["perm"], n_rows=int(h["perm"].shape[0]),
                bounds=h.get("bounds"), valid_perm_host=h["valid"],
                sorted_mono=h.get("sm"))

        return PC.cached(anchor, pre + ("layout", self.name, kind_key),
                         build, to_host, from_host)

    def layout_for_ids(self, key: str, ids_host, card: int) -> OrderedLayout:
        """Cached OrderedLayout over arbitrary static per-row bucket ids
        (e.g. precomputed histogram buckets; an array, or a function that
        makes it where the layout misses the prep cache): rows sorted by
        id with 32-aligned boundaries for prefix-difference reductions."""
        if self._bid_cache is None:
            self._bid_cache = {}
        lkey = ("layout", key)
        if lkey not in self._bid_cache:
            def build():
                ids = np.asarray(ids_host() if callable(ids_host)
                                 else ids_host, np.int64)
                if self._host_valid is not None:
                    ids = np.where(self._host_valid, ids, -1)
                return _build_bucket_layout(ids.astype(np.int32), card)
            self._bid_cache[lkey] = self._layout_cached(("ids", key, card),
                                                        build)
        return self._bid_cache[lkey]

    def bucket_layout(self) -> OrderedLayout:
        """Rows sorted by bucket id with 32-aligned bucket boundaries, for
        prefix-difference terms aggs."""
        if self._bucket_layout is None:
            def build():
                if self.ftype.is_stringy:
                    ids = np.where(self._host_valid,
                                   self._host_mono, -1).astype(I32)
                    card = max(1, len(self.terms))
                else:
                    ids = self.term_ids()[0]
                    card = self.card
                return _build_bucket_layout(ids, card)
            self._bucket_layout = self._layout_cached("bucket", build)
        return self._bucket_layout

    def value_layout(self) -> OrderedLayout:
        """Rows (docs, or the value rows of a multi-valued field) sorted by
        value (mono order) for rank-selection percentiles; invalid rows
        sort last. A shard column sorts its own rows only."""
        if self._value_layout is None:
            def build():
                m = self._host_mono
                valid = self._host_valid
                key = m.copy()
                if valid is not None:
                    key = np.where(valid, key, np.iinfo(np.int64).max)
                n = key.shape[0]
                perm = np.argsort(key, kind="stable").astype(I32)
                R = _pad_to(n, PAD_BLOCK)
                perm_p = np.zeros(R, I32)
                perm_p[:n] = perm
                vp = np.zeros(R, np.int8)
                vp[:n] = 1 if valid is None else valid[perm].astype(np.int8)
                return OrderedLayout(perm=perm_p, n_rows=R,
                                     valid_perm_host=vp,
                                     sorted_mono=key[perm])
            self._value_layout = self._layout_cached("value", build)
        return self._value_layout


def _bucket_layout_chunk(ids: np.ndarray, card: int):
    """(perm positions, bounds) for a bucket-sorted layout: row indices
    sorted by id, each bucket padded to a 32-row multiple so every bucket
    boundary is 32-aligned. Rows with id < 0 (missing) are excluded.
    Returns (perm_src, pos, bounds_raw[card+1])."""
    order = np.argsort(ids, kind="stable").astype(np.int64)
    sorted_ids = ids[order]
    start = int(np.searchsorted(sorted_ids, 0))
    order = order[start:]
    sorted_ids = sorted_ids[start:]
    counts = np.bincount(sorted_ids, minlength=card) if sorted_ids.size \
        else np.zeros(card, np.int64)
    padded = ((counts + ALIGN - 1) // ALIGN) * ALIGN
    bounds = np.zeros(card + 1, np.int64)
    np.cumsum(padded, out=bounds[1:])
    src_off = np.zeros(card + 1, np.int64)
    np.cumsum(counts, out=src_off[1:])
    pos = np.repeat(bounds[:-1], counts) + (
        np.arange(len(order)) - np.repeat(src_off[:-1], counts))
    return order, pos, bounds


def _build_bucket_layout(ids: np.ndarray, card: int) -> OrderedLayout:
    """Sort row indices by id with 32-aligned bucket boundaries; `bounds`
    is [card+1] in 32-row block units."""
    order, pos, bounds = _bucket_layout_chunk(ids, card)
    R = _pad_to(int(bounds[-1]), PAD_BLOCK)
    perm = np.zeros(R, I32)
    valid = np.zeros(R, np.int8)
    perm[pos] = order.astype(I32)
    valid[pos] = 1
    return OrderedLayout(perm=perm, n_rows=R,
                         bounds=(bounds // ALIGN).astype(I32),
                         valid_perm_host=valid)


@dataclass
class DeviceIndex:
    schema: Schema
    epoch: int
    T: int
    n_docs: int
    total_values: int
    columns: Dict[str, DeviceColumn]
    device: object
    seg_starts: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    #: host alive copy ([T] int8; 0 on padding and deleted docs)
    alive_host: Optional[np.ndarray] = None
    _alive_dev: Optional[torch.Tensor] = None
    #: deferred per-column builders (name -> thunk)
    _col_builders: Dict[str, object] = field(default_factory=dict)
    _max_addends: int = 1
    #: set-type query expansions (query/compile.py match_runs cache)
    set_query_runs: Dict[tuple, list] = field(default_factory=dict)
    #: query-independent operands of the value-domain cube and the dense
    #: products (aggs/compile.py), shared by every program on this index
    cube_cache: Dict[tuple, object] = field(default_factory=dict)
    #: on-disk index directory (None for RAM indexes) and its contents'
    #: digest at load: the anchor of the cross-process prep cache
    #: (utils/prep_cache.py)
    path: Optional[str] = None
    stamp: Optional[str] = None
    #: a shard of a mesh: the shard count, this shard's index, the mesh's
    #: MeshGroup (parallel/shard.py; None unsharded) and the doc rows of
    #: the whole index (T on one device)
    n_shards: int = 1
    shard: int = 0
    mesh: Optional[object] = None
    global_T: int = 0

    def __post_init__(self):
        if not self.global_T:
            self.global_T = self.T

    @property
    def prep_anchor(self) -> tuple:
        """(path, contents stamp, n_shards) of the prep cache."""
        return (self.path, self.stamp, self.n_shards)

    def prep_key(self, key) -> tuple:
        """A prep cache key of this index: a shard's keys name the shard."""
        return (("shard", self.shard),) + key if self.n_shards > 1 else key

    @property
    def alive(self) -> torch.Tensor:
        """[T] int8 device mask, shipped on first use."""
        if self._alive_dev is None:
            self._alive_dev = _put(self.alive_host, self.device)
        return self._alive_dev

    def column(self, name: str) -> DeviceColumn:
        col = self.columns.get(name)
        if col is not None:
            return col
        build = self._col_builders.get(name)
        if build is None:
            raise KeyError(f"field {name!r} not loaded (not FAST or unknown)")
        with span("tat.column"):
            col = build()
            if col.ftype.is_numeric and not isinstance(col, ShardColumn):
                _plan_sums(col, self._max_addends)
        col._prep = (self.prep_anchor, self.prep_key(()))
        self.columns[name] = col
        return col

    def keyword_ord(self, field: str, term: str) -> int:
        col = self.column(field)
        i = int(np.searchsorted(col.terms, term))
        if i < len(col.terms) and col.terms[i] == term:
            return i
        return -1


def load_device_index(index, device, D: int = 1) -> DeviceIndex:
    """Columns are DEFERRED: this registers a builder per fast field and
    returns (alive mask + metadata only). Each column's host prep runs on
    its first `column()` access (spanned `tat.column`, inside the plan
    that reads it); its planes ship to `device` on first use. D > 1: the
    global host columns of a D-shard mesh (doc axis padded to PAD_BLOCK *
    D, CSR rows partitioned by shard), which `load_sharded_index` slices
    into its shards. Spanned `tat.load`."""
    with span("tat.load"):
        return _load_device_index(index, device, D)


def _load_device_index(index, device, D: int = 1) -> DeviceIndex:
    device = torch.device(device)
    schema: Schema = index.schema
    segments = index.segments
    n_docs = sum(s.max_doc for s in segments)
    T = _pad_to(max(n_docs, 1), PAD_BLOCK * D)

    alive = np.zeros(T, dtype=np.int8)
    pos = 0
    for s in segments:
        alive[pos:pos + s.max_doc] = s.alive_mask()
        pos += s.max_doc

    builders: Dict[str, object] = {}
    total_values = 0
    for entry in schema.fields:
        if not entry.fast:
            continue
        nv = sum(int(s.fields[entry.name].values.shape[0]) for s in segments)
        total_values = max(total_values, nv)
        if entry.type.is_stringy:
            if entry.cardinality == Cardinality.SINGLE:
                builders[entry.name] = (
                    lambda e=entry: _load_keyword_dense(e, segments, T,
                                                        device))
            else:
                builders[entry.name] = (
                    lambda e=entry: _load_csr(e, segments, T, device,
                                              keyword=True, D=D))
        elif any(s.fields[entry.name].offsets is not None for s in segments):
            builders[entry.name] = (
                lambda e=entry: _load_csr(e, segments, T, device,
                                          keyword=False, D=D))
        else:
            builders[entry.name] = (
                lambda e=entry: _load_numeric_single(e, segments, T, device))

    if max(total_values, n_docs) >= exact.MAX_ADDENDS:
        raise ValueError("index exceeds the exact-sum addend bound (2^36)")

    path = getattr(index, "path", None)
    seg_starts = (np.cumsum([0] + [s.max_doc for s in segments])[:-1]
                  if segments else np.zeros(1))
    return DeviceIndex(schema=schema, epoch=index.epoch, T=T, n_docs=n_docs,
                       total_values=total_values, columns={}, device=device,
                       seg_starts=np.asarray(seg_starts, np.int64),
                       alive_host=alive, _col_builders=builders,
                       _max_addends=max(total_values, n_docs),
                       path=path,
                       stamp=PC.content_stamp(path) if path else None)


# ---------------------------------------------------------------------------
# sharded loading
# ---------------------------------------------------------------------------

@dataclass
class ShardColumn(DeviceColumn):
    """Shard s of a global host column: its doc rows [s*Ts, (s+1)*Ts) (or
    its slice of the partitioned value rows and tail) with the global
    column's encoding and metadata. Term ids, per-doc pre-aggregates and
    their bounds are the global column's, sliced; sums keep its plan."""

    _parent: Optional[DeviceColumn] = None
    _s: int = 0
    _S: int = 1
    _gT: int = 0

    def _doc_rows(self, a):
        if a is None:
            return None
        n = a.shape[0] // self._S
        return a[self._s * n:(self._s + 1) * n]

    def term_ids(self):
        if self._term_ids_host is None:
            ids, uniq = self._parent.term_ids()
            self._term_ids_host = self._doc_rows(ids)
            self._term_values_mono = uniq
        return self._term_ids_host, self._term_values_mono

    def doc_preagg_host(self, T: int) -> dict:
        if self._doc_preagg is None:
            self._doc_preagg = {
                k: self._doc_rows(v) for k, v in
                self._parent.doc_preagg_host(self._gT).items()}
        return self._doc_preagg

    def preagg_bounds(self, T: int) -> dict:
        return self._parent.preagg_bounds(self._gT)


def _shard_column(g: DeviceColumn, s: int, S: int, gT: int,
                  device) -> ShardColumn:
    """The shard-s view of global column g (see ShardColumn)."""
    base = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)
            if f.init and f.name not in ("_dev", "_bid_cache")}
    col = ShardColumn(**base, _parent=g, _s=s, _S=S, _gT=gT)
    col._device = device
    col._dev = {}
    col._bid_cache = None
    rows = col._doc_rows  # doc rows, or the value rows of a CSR column
    for name in ("_host_values", "_host_valid", "_host_mono", "_host_doc",
                 "_w_host", "_hi_host", "_lo_host", "_valid8_host",
                 "_mpn_host", "_tail_w_host", "_tail_hi_host",
                 "_tail_lo_host", "_tail_doc_host", "_tail_valid8_host"):
        setattr(col, name, rows(getattr(g, name)))
    if g.multi_planes_host is not None:
        col.multi_planes_host = [rows(p) for p in g.multi_planes_host]
    if g.multi_planes_wide_host is not None:
        col.multi_planes_wide_host = [(rows(h), rows(lo))
                                      for h, lo in g.multi_planes_wide_host]
    for name in ("_orig_docs", "_orig_values", "_term_ids_host",
                 "_term_values_mono", "_bucket_layout", "_value_layout",
                 "_doc_preagg", "_preagg_bounds"):
        setattr(col, name, None)
    return col


@dataclass
class ShardedIndex:
    """A doc-sharded index over a mesh: `shards[s]` is the DeviceIndex of
    shard s (its T/S doc rows on mesh device s); column metadata, the
    parameters a request extracts and set-query expansions are read from
    shard 0 (every shard holds the same)."""
    schema: Schema
    epoch: int
    T: int
    n_docs: int
    seg_starts: np.ndarray
    shards: list
    mesh: object
    path: Optional[str] = None

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> list:
        return [d.device for d in self.shards]

    @property
    def set_query_runs(self):
        return self.shards[0].set_query_runs

    def column(self, name: str) -> DeviceColumn:
        return self.shards[0].column(name)

    def keyword_ord(self, field: str, term: str) -> int:
        return self.shards[0].keyword_ord(field, term)


def load_sharded_index(index, devices) -> ShardedIndex:
    """The JAX loader's `load_device_index(index, mesh)`: S = len(devices)
    shards of T/S doc rows each (T padded to PAD_BLOCK * S), shard s on
    devices[s]. Global host columns build once, on first use by any shard;
    each shard's DeviceIndex holds views of them (`_shard_column`).
    Spanned `tat.load`."""
    with span("tat.load"):
        return _load_sharded_index(index, devices)


def _load_sharded_index(index, devices) -> ShardedIndex:
    from ..parallel.shard import MeshGroup
    S = len(devices)
    g = _load_device_index(index, "cpu", D=S)
    T, Ts = g.T, g.T // S
    mesh = MeshGroup(devices)
    shards = []
    for s, dev in enumerate(devices):
        # (the shard bodies take turns, so one builds a global column first)
        builders = {name: (lambda name=name, s=s, dev=dev: _shard_column(
            g.column(name), s, S, T, torch.device(dev)))
            for name in g._col_builders}
        shards.append(DeviceIndex(
            schema=g.schema, epoch=g.epoch, T=Ts, n_docs=g.n_docs,
            total_values=g.total_values, columns={},
            device=torch.device(dev), seg_starts=g.seg_starts,
            alive_host=g.alive_host[s * Ts:(s + 1) * Ts],
            _col_builders=builders, _max_addends=g._max_addends,
            set_query_runs=g.set_query_runs, path=g.path, stamp=g.stamp,
            n_shards=S,
            shard=s, mesh=mesh, global_T=T))
    return ShardedIndex(schema=g.schema, epoch=g.epoch, T=T,
                        n_docs=g.n_docs, seg_starts=g.seg_starts,
                        shards=shards, mesh=mesh, path=g.path)


def _plan_sums(col: DeviceColumn, max_addends: int) -> None:
    if col.ftype == FieldType.F64:
        col.sum_direct = False
        real = col._host_values if col._host_valid is None \
            else col._host_values[col._host_valid]
        base, n_limbs = exact.f64_sum_plan(real) if real.size else (1, 1)
        col.f64_base_exp, col.sum_n_limbs = base, n_limbs
    else:
        bits = max(1, int(col.span).bit_length())
        # direct = the narrow w plane itself is the exact addend
        col.sum_direct = col.narrow
        col.sum_n_limbs = (bits + exact.LIMB_BITS - 1) // exact.LIMB_BITS


def _w_u64(m: np.ndarray, min_mono: int) -> np.ndarray:
    """Exact unsigned offset w = mono - min_mono (wraparound u64)."""
    base = np.array(min_mono, np.int64).view(np.uint64)
    return m.view(np.uint64) - base


def _mono_planes(m: np.ndarray, min_mono: int, span: int):
    """int64 mono values -> (narrow?, w | (hi, lo)) int32 planes."""
    wu = _w_u64(m, min_mono)
    if span <= NARROW_MAX_SPAN:
        return True, wu.astype(np.int64).astype(I32), None
    hi, lo = _split_wide(wu)
    return False, hi, lo


def _load_numeric_single(entry, segments, T, device) -> DeviceColumn:
    from .segment import numeric_dtype
    parts = [s.fields[entry.name].values for s in segments]
    vals = (np.concatenate(parts) if parts
            else np.zeros(0, dtype=numeric_dtype(entry.type)))
    m = np.asarray(mono_mod.to_mono(entry.type.value, vals), dtype=np.int64)
    n = m.shape[0]
    min_mono = int(m.min()) if n else 0
    max_mono = int(m.max()) if n else 0
    span = ((max_mono - min_mono) % 2**64) if n else 0
    mono_p = np.full(T, min_mono, np.int64)
    mono_p[:n] = m
    host = np.zeros(T, dtype=vals.dtype if n else np.float64)
    host[:n] = vals
    if n:
        host[n:] = mono_mod.from_mono(entry.type.value,
                                      np.full(T - n, min_mono, np.int64))
    hvalid = np.zeros(T, bool)
    hvalid[:n] = True
    narrow, a, b = _mono_planes(mono_p, min_mono, span)
    col = DeviceColumn(
        name=entry.name, ftype=entry.type, multi=False, narrow=narrow,
        min_mono=min_mono, max_mono=max_mono, span=span, n_values=n,
        _device=device, _host_values=host, _host_valid=hvalid,
        _host_mono=mono_p)
    if narrow:
        col._w_host = a
    else:
        col._hi_host, col._lo_host = a, b
    return col


def _load_keyword_dense(entry, segments, T, device) -> DeviceColumn:
    """Single-cardinality keyword -> dense int32 global-ordinal column."""
    name = entry.name
    gterms = sorted(set().union(*[set(s.fields[name].terms or [])
                                  for s in segments])) if segments else []
    gterms = np.asarray(gterms, dtype=object)
    ords = np.full(T, -1, I32)
    base = 0
    for s in segments:
        fd = s.fields[name]
        local = np.asarray(fd.terms or [], dtype=object)
        remap = (np.searchsorted(gterms, local).astype(I32)
                 if len(local) else np.zeros(0, I32))
        offs = fd.offsets.astype(np.int64)
        has = np.diff(offs) > 0
        docs = np.nonzero(has)[0]
        ords[base + docs] = remap[fd.values[offs[:-1][has]].astype(np.int64)]
        base += s.max_doc
    n = int((ords >= 0).sum())
    col = DeviceColumn(
        name=name, ftype=entry.type, multi=False, narrow=True,
        terms=gterms, n_values=n, _device=device,
        _host_mono=ords.astype(np.int64), _host_valid=ords >= 0)
    col._w_host = ords
    return col


def _load_csr(entry, segments, T, device, keyword: bool,
              D: int = 1) -> DeviceColumn:
    """Multi-valued field: padded CSR value rows (a doc's values contiguous,
    docs ascending) with their doc ids and validity, the dense per-position
    planes and the overflow tail (the JAX loader's `_load_csr`); over D
    shards the value rows and the tail are partitioned by owning shard."""
    from .segment import numeric_dtype
    name = entry.name
    if keyword:
        gterms = sorted(set().union(*[set(s.fields[name].terms or [])
                                      for s in segments])) if segments else []
        gterms = np.asarray(gterms, dtype=object)
    vals_parts, doc_parts = [], []
    doc_base = 0
    for s in segments:
        fd = s.fields[name]
        offs = fd.offsets.astype(np.int64)
        reps = np.diff(offs)
        doc_of_val = np.repeat(np.arange(s.max_doc, dtype=np.int64), reps)
        if keyword:
            local = np.asarray(fd.terms or [], dtype=object)
            remap = (np.searchsorted(gterms, local).astype(np.int64)
                     if len(local) else np.zeros(0, np.int64))
            vals_parts.append(remap[fd.values.astype(np.int64)])
        else:
            vals_parts.append(fd.values)
        doc_parts.append(doc_of_val + doc_base)
        doc_base += s.max_doc
    if keyword:
        vals = (np.concatenate(vals_parts) if vals_parts
                else np.zeros(0, np.int64))
        m = vals.astype(np.int64)
    else:
        vals = (np.concatenate(vals_parts) if vals_parts
                else np.zeros(0, dtype=numeric_dtype(entry.type)))
        m = np.asarray(mono_mod.to_mono(entry.type.value, vals), np.int64)
    docs = (np.concatenate(doc_parts) if doc_parts
            else np.zeros(0, np.int64))
    n = m.shape[0]
    min_mono = int(m.min()) if n else 0
    max_mono = int(m.max()) if n else 0
    span = ((max_mono - min_mono) % 2**64) if n else 0
    if keyword:
        min_mono, max_mono, span = 0, max_mono, int(max_mono)

    # value rows partitioned by owning shard (doc // (T/D)), each shard's
    # slice padded to one common PAD_BLOCK multiple, shard-local doc ids
    chunk = T // D
    counts = (np.bincount(docs // chunk, minlength=D) if n
              else np.zeros(D, np.int64))
    Vp = _pad_to(int(counts.max()) if n else 1, PAD_BLOCK)
    V = D * Vp
    mono_out = np.full(V, min_mono, np.int64)
    doc_out = np.zeros(V, I32)
    valid_out = np.zeros(V, bool)
    host_out = np.zeros(V, np.int64 if keyword else
                        (vals.dtype if n else np.float64))
    if not keyword and n:
        host_out[:] = mono_mod.from_mono(entry.type.value,
                                         np.full(V, min_mono, np.int64))
    start = 0
    for d in range(D):
        c = int(counts[d])
        sel = slice(start, start + c)
        o = d * Vp
        mono_out[o:o + c] = m[sel]
        doc_out[o:o + c] = (docs[sel] - d * chunk).astype(I32)
        valid_out[o:o + c] = True
        host_out[o:o + c] = vals[sel]
        start += c
    col = DeviceColumn(
        name=name, ftype=entry.type, multi=True,
        terms=gterms if keyword else None,
        min_mono=min_mono, max_mono=max_mono, span=span, n_values=n,
        _device=device, _host_values=host_out, _host_valid=valid_out,
        _host_mono=mono_out, _host_doc=doc_out,
        _orig_docs=docs.astype(np.int64), _orig_values=vals)
    col._valid8_host = valid_out.astype(np.int8)
    if keyword:
        col.narrow = True
        col._w_host = np.where(valid_out, mono_out, -1).astype(I32)
    else:
        col.narrow, a, b = _mono_planes(mono_out, min_mono, span)
        if col.narrow:
            col._w_host = a
        else:
            col._hi_host, col._lo_host = a, b
    _multi_planes(col, m, docs, T, keyword, D)
    return col


def _shard_partition_csr(vals: np.ndarray, docs: np.ndarray, T: int, D: int,
                         fill):
    """Partition CSR rows by owning shard (doc // (T/D)), pad each shard's
    slice to a common PAD_BLOCK multiple, localize doc ids (JAX
    `_shard_partition_csr`). Returns (vals [V], doc [V] int32 shard-local,
    valid [V] bool)."""
    n = vals.shape[0]
    chunk = T // D
    shard_of_row = docs // chunk if n else docs
    counts = (np.bincount(shard_of_row.astype(np.int64), minlength=D)
              if n else np.zeros(D, np.int64))
    Vp = _pad_to(int(counts.max()) if n else 1, PAD_BLOCK)
    V = D * Vp
    vals_out = np.full(V, fill, dtype=vals.dtype)
    doc_out = np.zeros(V, I32)
    valid_out = np.zeros(V, bool)
    order = (np.argsort(shard_of_row, kind="stable") if n
             else np.zeros(0, np.int64))
    start = 0
    for d in range(D):
        c = int(counts[d])
        sel = order[start:start + c]
        o = d * Vp
        vals_out[o:o + c] = vals[sel]
        doc_out[o:o + c] = (docs[sel] - d * chunk).astype(I32)
        valid_out[o:o + c] = True
        start += c
    return vals_out, doc_out, valid_out


def _multi_planes(col: DeviceColumn, m: np.ndarray, docs: np.ndarray,
                  T: int, keyword: bool, D: int = 1) -> None:
    """The dense per-position planes of a multi-valued column and its
    overflow tail (rows of `m` are doc-ascending with their `docs`):
    narrow / keyword w values with the -1 fill, or wide (hi, lo) pairs
    beside the value-count plane; the tail's rows are partitioned by
    owning shard."""
    n = m.shape[0]
    cnt = np.bincount(docs, minlength=T) if n else np.zeros(T, np.int64)
    kmax = int(cnt.max()) if n else 0
    offs = np.zeros(T + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    K = max(min(kmax, DENSE_MULTI_K), 1)
    # overflow rows: value positions >= DENSE_MULTI_K of each doc
    tsel = (np.flatnonzero(np.arange(n, dtype=np.int64) - offs[:-1][docs]
                           >= DENSE_MULTI_K)
            if kmax > DENSE_MULTI_K else None)
    if col.narrow:
        wvals = m if keyword else _w_u64(m, col.min_mono).astype(np.int64)
        planes = []
        for k in range(K):
            pk = np.full(T, -1, np.int64)
            has = cnt > k
            pk[has] = wvals[offs[:-1][has] + k]
            planes.append(pk.astype(I32))
        col.multi_planes_host = planes
        if tsel is not None:
            tw, tdoc, tvalid = _shard_partition_csr(
                wvals[tsel].astype(I32), docs[tsel], T, D, fill=np.int32(-1))
            col._tail_w_host, col._tail_doc_host = tw, tdoc
            col._tail_valid8_host = tvalid.astype(np.int8)
        return
    wv = _w_u64(m, col.min_mono)
    planes = []
    for k in range(K):
        hp = np.zeros(T, I32)
        lp = np.zeros(T, I32)
        has = cnt > k
        hp[has], lp[has] = _split_wide(wv[offs[:-1][has] + k])
        planes.append((hp, lp))
    col.multi_planes_wide_host = planes
    col._mpn_host = np.minimum(cnt, 2**31 - 1).astype(I32)
    if tsel is not None:
        # partition the row indices once so both planes share the order
        tidx, tdoc, tvalid = _shard_partition_csr(tsel, docs[tsel], T, D,
                                                  fill=np.int64(0))
        col._tail_hi_host, col._tail_lo_host = _split_wide(
            np.where(tvalid, wv[tidx], np.uint64(0)))
        col._tail_doc_host = tdoc
        col._tail_valid8_host = tvalid.astype(np.int8)
