"""Query -> docid bitmask, torch form + in-kernel op-list form.

`extract_params` (copied from the JAX package's query/compile.py) maps
query constants into each column's w-domain with exact Python big-int
arithmetic, clamping bounds into representable range so evaluation is
branch-free.

Evaluation goes through ONE encoding of a query chain: `mask_program`
compiles (query, param path) pairs to a small postfix op list over int32
planes and int32 params (`MaskProgram`). The CUDA chain kernels
(csrc/kernels.cu) interpret it per row in-kernel; `eval_ops` interprets the
same list with torch ops over [B, ...] masks (the plain versions of those
kernels, every other mask in the port, and the value-domain cube's chain
indicator over its virtual domain planes, ops/cube.py `dom_planes`). This
replaces the JAX package's trace-time `eval_mask` closures.

Covered: MatchAll, Term, Range, Prefix, the set-type TermSet / Fuzzy /
Regex (one opcode that loops the query's run slots), Exists, Phrase and
Boolean must/should/must_not over single-valued columns (narrow, wide
(hi, lo) lexicographic, and stringy ordinals) and multi-valued ones: a leaf
is the OR over the field's doc-aligned per-position planes (the JAX
package's eval_mask), each compare guarded by one plane compare against an
immediate (OP_GT_IMM: a narrow position's -1 fill, a wide position's value
count). Two opcodes are DOC-SPACE ONLY (`DOC_SPACE_OPS`): the scatter-or of
value-row hits onto their docs (a field's overflow tail past
DENSE_MULTI_K values, Exists over bare value rows) and the CSR phrase
stream of a text field with a tail. A program holding one evaluates over
the doc axis with torch ops (`eval_ops`) and never reaches a chain kernel
or a permuted view (`MaskProgram.dense`).

Exactness notes (kept from the JAX package):
- Exclusive range bounds are normalized to inclusive in the mono domain
  (mono is an integer bijection, so v > b == v >= b+1 for every field type
  including f64).
- f64 signed zeros: -0.0 == 0.0 must hold; equality carries the ±0 mono
  pair, range bounds at zero pick the float-correct side.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..ops.reductions import values_hit_to_doc_mask
from ..query import ir as Q
from ..schema import FieldType
from ..utils import exact as exact_mod
from ..utils import mono as mono_mod
from ..utils.stats import span

U64_MAX = 2**64 - 1


def _mono(ftype: FieldType, value) -> int:
    return mono_mod.scalar_to_mono(ftype.value, value)


def _key(path) -> str:
    return "/".join(map(str, path))


def _wide_pair(w: int):
    """u64 w -> (hi, lo) monoized int32 params."""
    return (w >> 32) - 2**31, (w & 0xFFFFFFFF) - 2**31


def extract_params(query: Q.Query, dindex, path=("q",)) -> Dict[str, np.int32]:
    out: Dict[str, np.int32] = {}
    _extract(query, dindex, path, out)
    return out


def _term_w_params(col, ftype, value):
    """Exact w-domain equality targets for one user value: list of candidate
    monos (the ±0 pair for f64 zero), each -> (present, w). A NaN f64 term
    matches nothing (fields cannot store NaN; the oracle's IEEE == is
    all-false for NaN — same spec as NaN range bounds, §A.10)."""
    if ftype == FieldType.F64 and math.isnan(float(value)):
        return [None, None]
    monos = [_mono(ftype, value)]
    if ftype == FieldType.F64 and float(value) == 0.0:
        monos = [_mono(ftype, 0.0), _mono(ftype, -0.0)]
    outs = []
    for m in monos:
        if col.n_values and col.min_mono <= m <= col.max_mono:
            outs.append(m - col.min_mono)  # exact python int, in [0, span]
        else:
            outs.append(None)
    if len(outs) == 1:
        outs.append(outs[0])
    return outs


def match_runs(dindex, q) -> list:
    """Matched-set compare runs of a set-type query (TermSet/Fuzzy/Regex)
    against the GLOBAL term table / mono w-domain: inclusive (lo, hi) exact
    python ints, sorted, lo >= 0, adjacent values merged. Cached on the
    device index — msearch streams re-extract params per request, and the
    fuzzy/regex predicates scan the whole term table."""
    from ..utils import termmatch
    if isinstance(q, Q.TermSetQuery):
        key = ("tset", q.field, q.values)
    elif isinstance(q, Q.FuzzyTermQuery):
        key = ("fuzzy", q.field, q.term, q.distance, q.transpositions,
               q.prefix_length)
    else:
        key = ("regex", q.field, q.pattern)
    cache = dindex.set_query_runs
    hit = cache.get(key)
    if hit is not None:
        return hit
    entry = dindex.schema.field(q.field)
    col = dindex.column(q.field)
    termmatch.check_set_query_field(entry.type, q)
    if isinstance(q, Q.TermSetQuery):
        if entry.type.is_stringy:
            from ..schema import stringy_term
            ws = {dindex.keyword_ord(q.field, stringy_term(entry.type, v))
                  for v in q.values}
            ws.discard(-1)
        else:
            ws = set()
            for v in q.values:
                for w in _term_w_params(col, entry.type, v):
                    if w is not None:
                        ws.add(w)
        runs = termmatch.runs_from_sorted(sorted(ws))
    else:
        if isinstance(q, Q.FuzzyTermQuery):
            tmask = termmatch.fuzzy_term_mask(
                col.terms, str(q.term), q.distance, q.transpositions,
                q.prefix_length)
        else:
            tmask = termmatch.regex_term_mask(col.terms, str(q.pattern))
        runs = termmatch.runs_from_sorted(
            np.flatnonzero(tmask).tolist())
    cache[key] = runs
    return runs


def _extract(q, dindex, path, out) -> None:
    if isinstance(q, (Q.MatchAllQuery, Q.ExistsQuery)):
        return
    if isinstance(q, (Q.TermSetQuery, Q.FuzzyTermQuery, Q.RegexQuery)):
        entry = dindex.schema.field(q.field)
        col = dindex.column(q.field)
        runs = match_runs(dindex, q)
        S = Q.run_slots(q)
        if len(runs) > S:
            # plan-time acceptance (Program.accepts) keeps overflowing
            # queries off compiled programs; this guards direct callers
            raise NotImplementedError(
                f"set query expands to {len(runs)} runs > {S} slots")
        k = _key(path)
        narrow = entry.type.is_stringy or col.narrow
        for i in range(S):
            lo, hi = runs[i] if i < len(runs) else (1, 0)  # empty run
            if narrow:
                out[f"{k}:s{i}l"] = np.int32(lo)
                out[f"{k}:s{i}h"] = np.int32(hi)
            else:
                lh, ll = _wide_pair(lo)
                hh, hl = _wide_pair(hi)
                out[f"{k}:s{i}lh"], out[f"{k}:s{i}ll"] = (np.int32(lh),
                                                          np.int32(ll))
                out[f"{k}:s{i}hh"], out[f"{k}:s{i}hl"] = (np.int32(hh),
                                                          np.int32(hl))
        return
    if isinstance(q, Q.TermQuery):
        entry = dindex.schema.field(q.field)
        col = dindex.column(q.field)
        k = _key(path)
        if entry.type.is_stringy:
            from ..schema import stringy_term
            ordv = dindex.keyword_ord(q.field,
                                      stringy_term(entry.type, q.value))
            out[k + ":t"] = np.int32(ordv if ordv >= 0 else -2)
            return
        ws = _term_w_params(col, entry.type, q.value)
        if col.narrow:
            for i, w in enumerate(ws):
                out[f"{k}:t{i}"] = np.int32(w if w is not None else 0)
                out[f"{k}:tv{i}"] = np.int32(1 if w is not None else 0)
        else:
            for i, w in enumerate(ws):
                hi, lo = _wide_pair(w if w is not None else 0)
                out[f"{k}:th{i}"] = np.int32(hi)
                out[f"{k}:tl{i}"] = np.int32(lo)
                out[f"{k}:tv{i}"] = np.int32(1 if w is not None else 0)
        return
    if isinstance(q, Q.PhraseQuery):
        entry = dindex.schema.field(q.field)
        if entry.type != FieldType.TEXT:
            raise TypeError("phrase query requires a text field")
        k = _key(path)
        for i, tok in enumerate(q.tokens):
            ordv = dindex.keyword_ord(q.field, tok)
            # -2 sentinel (like missing TermQuery ordinals): never equals a
            # stored ordinal (>= 0) nor the -1 fill of shifted windows
            out[f"{k}:p{i}"] = np.int32(ordv if ordv >= 0 else -2)
        return
    if isinstance(q, Q.PrefixQuery):
        entry = dindex.schema.field(q.field)
        if not entry.type.is_stringy or entry.type == FieldType.BYTES:
            raise TypeError(
                "prefix query requires a keyword, text, or facet field")
        col = dindex.column(q.field)
        k = _key(path)
        # all prefix-extensions form one contiguous run of the sorted term
        # table: [prefix, successor(prefix)) where the successor increments
        # the last non-maximal character (carry towards the front)
        terms = col.terms
        lo_ord = int(np.searchsorted(terms, str(q.prefix), side="left"))
        succ = _prefix_successor(str(q.prefix))
        hi_ord = (int(np.searchsorted(terms, succ, side="left")) - 1
                  if succ is not None else len(terms) - 1)
        if len(terms) == 0 or hi_ord < lo_ord:
            lo_ord, hi_ord = 1, 0  # empty
        out[k + ":lo"] = np.int32(lo_ord)
        out[k + ":hi"] = np.int32(max(hi_ord, 0))
        return
    if isinstance(q, Q.RangeQuery):
        entry = dindex.schema.field(q.field)
        col = dindex.column(q.field)
        k = _key(path)
        if entry.type.is_stringy:
            from ..schema import stringy_term
            # lexicographic range -> inclusive global-ordinal range
            card = len(col.terms)
            lo_ord, hi_ord = 0, card - 1
            if q.lower is not None:
                side = "left" if q.include_lower else "right"
                lo_ord = int(np.searchsorted(
                    col.terms, stringy_term(entry.type, q.lower), side=side))
            if q.upper is not None:
                side = "right" if q.include_upper else "left"
                hi_ord = int(np.searchsorted(
                    col.terms, stringy_term(entry.type, q.upper),
                    side=side)) - 1
            if card == 0 or hi_ord < lo_ord or hi_ord < 0:
                lo_ord, hi_ord = 1, 0  # empty
            out[k + ":lo"] = np.int32(lo_ord)
            out[k + ":hi"] = np.int32(max(hi_ord, 0))
            return
        if not entry.type.is_numeric:
            raise TypeError("range query requires a numeric or string field")
        # normalize to inclusive mono bounds
        forced_empty = False
        if entry.type != FieldType.F64:
            # integer fields: exact bound normalization (SURVEY §A.10;
            # shared spec implementation in utils/exact.py, also used by
            # oracle/engine.py _range_mask)
            lo_r = exact_mod.norm_int_bound(entry.type.value, q.lower, True,
                                            q.include_lower)
            hi_r = exact_mod.norm_int_bound(entry.type.value, q.upper,
                                            False, q.include_upper)
            forced_empty = lo_r == "empty" or hi_r == "empty"
            lo_m = (_mono(entry.type, lo_r) if isinstance(lo_r, int)
                    else col.min_mono)
            hi_m = (_mono(entry.type, hi_r) if isinstance(hi_r, int)
                    else col.max_mono)
        elif ((q.lower is not None and math.isnan(float(q.lower)))
              or (q.upper is not None and math.isnan(float(q.upper)))):
            # NaN bounds match nothing on f64 fields too (the oracle's
            # IEEE compares are all-false for NaN; encode the same)
            forced_empty = True
            lo_m, hi_m = col.min_mono, col.max_mono
        else:
            if q.lower is not None:
                lo_m = _zero_bound(entry.type, q.lower, True,
                                   q.include_lower)
                if not q.include_lower:
                    lo_m += 1
            else:
                lo_m = col.min_mono
            if q.upper is not None:
                hi_m = _zero_bound(entry.type, q.upper, False,
                                   q.include_upper)
                if not q.include_upper:
                    hi_m -= 1
            else:
                hi_m = col.max_mono
        if forced_empty:
            lo_m, hi_m = 1, 0  # flows into the empty-range param encoding
        lo_w = lo_m - col.min_mono  # exact python ints
        hi_w = hi_m - col.min_mono
        if col.n_values == 0 or lo_w > col.span or hi_w < 0 or lo_w > hi_w:
            lo_w, hi_w = 1, 0  # empty
        else:
            lo_w = max(0, lo_w)
            hi_w = min(col.span, hi_w)
        if col.narrow:
            out[k + ":lo"] = np.int32(lo_w)
            out[k + ":hi"] = np.int32(hi_w)
        else:
            lh, ll = _wide_pair(min(max(lo_w, 0), U64_MAX))
            hh, hl = _wide_pair(min(max(hi_w, 0), U64_MAX))
            if lo_w > hi_w:  # empty: force lexicographic impossibility
                lh, ll = _wide_pair(1)
                hh, hl = _wide_pair(0)
            out[k + ":loh"], out[k + ":lol"] = np.int32(lh), np.int32(ll)
            out[k + ":hih"], out[k + ":hil"] = np.int32(hh), np.int32(hl)
        return
    if isinstance(q, Q.BooleanQuery):
        for i, c in enumerate(q.must):
            _extract(c, dindex, path + ("m", i), out)
        for i, c in enumerate(q.should):
            _extract(c, dindex, path + ("s", i), out)
        for i, c in enumerate(q.must_not):
            _extract(c, dindex, path + ("n", i), out)
        return
    raise TypeError(f"unknown query {type(q)!r}")


def _prefix_successor(prefix: str):
    """Smallest string greater than every prefix-extension, or None when no
    such string exists (prefix is all U+10FFFF)."""
    chars = list(prefix)
    for i in range(len(chars) - 1, -1, -1):
        if ord(chars[i]) < 0x10FFFF:
            return "".join(chars[:i]) + chr(ord(chars[i]) + 1)
    return None


def _zero_bound(ftype: FieldType, value, is_lower: bool, inclusive: bool) -> int:
    if ftype == FieldType.F64 and float(value) == 0.0:
        if (is_lower and inclusive) or (not is_lower and not inclusive):
            return _mono(ftype, -0.0)
        return _mono(ftype, 0.0)
    return _mono(ftype, value)


def query_fields(q: Q.Query, out=None) -> set:
    if out is None:
        out = set()
    if isinstance(q, (Q.TermQuery, Q.RangeQuery, Q.PrefixQuery,
                      Q.ExistsQuery, Q.PhraseQuery, Q.TermSetQuery,
                      Q.FuzzyTermQuery, Q.RegexQuery)):
        out.add(q.field)
    elif isinstance(q, Q.BooleanQuery):
        for c in (*q.must, *q.should, *q.must_not):
            query_fields(c, out)
    return out




# ---------------------------------------------------------------------------
# Mask programs: the op-list form of a query chain
# ---------------------------------------------------------------------------
#
# One instruction is OP_WIDTH int32 words: the opcode, then its operands.
# Plane operands index MaskProgram.plane_keys, param operands index
# MaskProgram.param_keys. Evaluation is a bool stack; every instruction
# pushes one value (after popping its inputs), and a program leaves exactly
# one. The opcode numbers are shared with csrc/kernels.cu.

OP_TRUE = 0           # push true
OP_AND = 1            # pop b, a; push a & b
OP_OR = 2             # pop b, a; push a | b
OP_NOT = 3            # pop a; push ~a
OP_RANGE32 = 4        # plane, plo, phi: p[plo] <= plane <= p[phi]
OP_EQ32 = 5           # plane, pt: plane == p[pt]
OP_EQ32_GUARD = 6     # plane, pt, ptv: plane == p[pt] and p[ptv] > 0
OP_RANGE_WIDE = 7     # hi, lo, ploh, plol, phih, phil: lexicographic range
OP_EQ_WIDE_GUARD = 8  # hi, lo, pth, ptl, ptv: (hi, lo) == (p[pth], p[ptl])
#                       and p[ptv] > 0
OP_SET32 = 9          # plane, p0, S: for some slot i < S,
#                       p[p0+2i] <= plane <= p[p0+2i+1]
OP_SET_WIDE = 10      # hi, lo, p0, S: for some slot i < S, (hi, lo) in the
#                       lexicographic range (p[p0+4i], p[p0+4i+1]) ..
#                       (p[p0+4i+2], p[p0+4i+3])
OP_GT_IMM = 11        # plane, imm: plane > imm (the immediate is in the op)
# doc-space only: the operands are value-row planes, the result a doc mask
OP_ROWS_TO_DOCS = 12  # doc: pop value-row hits [.., V]; push [.., T] with
#                       doc d set where some row r with doc[r] == d hits
OP_PHRASE_ROWS = 13   # w, valid, doc, p0, n: value row r starts the phrase
#                       p[p0..p0+n-1] (rows r..r+n-1 valid, of r's doc)
DOC_SPACE_OPS = (OP_ROWS_TO_DOCS, OP_PHRASE_ROWS)
OP_WIDTH = 8
#: bool stack depth the kernels carry (one bit per entry of a uint32)
MAX_STACK = 32
#: the set-type queries: a disjunction of run-slot range compares
SET_QUERIES = (Q.TermSetQuery, Q.FuzzyTermQuery, Q.RegexQuery)


class MaskProgram(NamedTuple):
    ops: np.ndarray          # int32 [n_ops, OP_WIDTH]
    plane_keys: tuple        # short plane keys ("{field}:w", ...), no prefix
    param_keys: tuple        # chain param keys, in extract_params order

    @property
    def dense(self) -> bool:
        """Every plane is doc-aligned and every op row-wise: the program
        evaluates over any permutation of the doc axis (the chain kernels'
        layouts), not only over the doc axis itself."""
        return not np.isin(self.ops[:, 0], DOC_SPACE_OPS).any()


def chain_param_keys(chain, dindex) -> list:
    """Deterministic flat order of a chain's query param keys (the JAX
    package's Program._chain_pkeys)."""
    keys = []
    for q, qpath in chain:
        keys.extend(extract_params(q, dindex, path=qpath))
    return keys


def mask_program(chain, dindex) -> MaskProgram:
    """Compile a chain of (query, param path) pairs — ANDed, as the agg
    planner's chains are — to a MaskProgram. Raises NotImplementedError
    for a chain deeper than the kernels' stack (the planner calls this at
    plan time, so no request of such a shape reaches a device path)."""
    pkeys = chain_param_keys(chain, dindex)
    pidx = {k: i for i, k in enumerate(pkeys)}
    planes: list = []
    code: list = []
    depth = [0, 0]  # current, max

    def plane(key):
        if key not in planes:
            planes.append(key)
        return planes.index(key)

    def emit(op, *args, pops=0):
        code.append((op,) + args + (0,) * (OP_WIDTH - 1 - len(args)))
        depth[0] += 1 - pops
        depth[1] = max(depth[1], depth[0])

    def set_slots(q, k, names):
        """(p0, S) of a set query: extract_params lays its S run slots'
        params out consecutively, slot i's `names` from p0 + len(names) * i
        on."""
        S = Q.run_slots(q)
        p0 = pidx[f"{k}:s0{names[0]}"]
        for i in range(S):
            for j, nm in enumerate(names):
                assert pidx[f"{k}:s{i}{nm}"] == p0 + len(names) * i + j, \
                    (k, i, nm)
        return p0, S

    def param_run(k, name, n):
        """Index of `k`+name+"0"; extract_params lays the n params name0 ..
        name{n-1} out consecutively."""
        p0 = pidx[f"{k}{name}0"]
        for i in range(n):
            assert pidx[f"{k}{name}{i}"] == p0 + i, (k, name, i)
        return p0

    def cmp32(q, k, w):
        """The leaf's compare over one narrow / ordinal plane `w`."""
        p = lambda s: pidx[k + s]  # noqa: E731
        if isinstance(q, SET_QUERIES):
            emit(OP_SET32, w, *set_slots(q, k, ("l", "h")))
        elif isinstance(q, Q.TermQuery) and dindex.column(
                q.field).ftype.is_stringy:
            emit(OP_EQ32, w, p(":t"))
        elif isinstance(q, Q.TermQuery):
            emit(OP_EQ32_GUARD, w, p(":t0"), p(":tv0"))
            emit(OP_EQ32_GUARD, w, p(":t1"), p(":tv1"))
            emit(OP_OR, pops=2)
        else:  # range (numeric or lexicographic) or keyword prefix
            emit(OP_RANGE32, w, p(":lo"), p(":hi"))

    def cmp_wide(q, k, hi, lo):
        """The leaf's lexicographic compare over one (hi, lo) pair."""
        p = lambda s: pidx[k + s]  # noqa: E731
        if isinstance(q, SET_QUERIES):
            emit(OP_SET_WIDE, hi, lo,
                 *set_slots(q, k, ("lh", "ll", "hh", "hl")))
        elif isinstance(q, Q.TermQuery):
            emit(OP_EQ_WIDE_GUARD, hi, lo, p(":th0"), p(":tl0"), p(":tv0"))
            emit(OP_EQ_WIDE_GUARD, hi, lo, p(":th1"), p(":tl1"), p(":tv1"))
            emit(OP_OR, pops=2)
        else:
            emit(OP_RANGE_WIDE, hi, lo, p(":loh"), p(":lol"), p(":hih"),
                 p(":hil"))

    def guarded(compare, guard_plane, imm):
        """compare() AND guard_plane > imm."""
        compare()
        emit(OP_GT_IMM, guard_plane, imm)
        emit(OP_AND, pops=2)

    def leaf(q, path):
        col = dindex.column(q.field)
        f = q.field
        k = _key(path)
        if col.multi and col.has_multi_planes:
            # an OR over the per-position planes; the -1 fill never
            # matches (term params are w values >= 0 or the -2 missing
            # ordinal, run slots start at >= 0, and a range carries an
            # explicit >= 0 guard); the tail's rows scatter onto their docs
            is_range = isinstance(q, (Q.RangeQuery, Q.PrefixQuery))

            def one(w):
                if is_range:
                    guarded(lambda: cmp32(q, k, w), w, -1)
                else:
                    cmp32(q, k, w)

            for kk in range(len(col.multi_planes_host)):
                one(plane(f"{f}:mp{kk}"))
                if kk:
                    emit(OP_OR, pops=2)
            if col.has_tail:
                one(plane(f"{f}:tw"))
                emit(OP_ROWS_TO_DOCS, plane(f"{f}:tdoc"), pops=1)
                emit(OP_OR, pops=2)
            return
        if col.multi:
            # wide: each position's pair guarded by the value count
            mpn = plane(f"{f}:mpn")
            for kk in range(len(col.multi_planes_wide_host)):
                hi, lo = plane(f"{f}:mph{kk}"), plane(f"{f}:mpl{kk}")
                guarded(lambda: cmp_wide(q, k, hi, lo), mpn, kk)
                if kk:
                    emit(OP_OR, pops=2)
            if col.has_tail:
                guarded(lambda: cmp_wide(q, k, plane(f"{f}:th"),
                                         plane(f"{f}:tl")),
                        plane(f"{f}:tvalid"), 0)
                emit(OP_ROWS_TO_DOCS, plane(f"{f}:tdoc"), pops=1)
                emit(OP_OR, pops=2)
            return
        if col.ftype.is_stringy or col.narrow:
            cmp32(q, k, plane(f"{f}:w"))
        else:
            cmp_wide(q, k, plane(f"{f}:hi"), plane(f"{f}:lo"))

    def exists(q):
        col = dindex.column(q.field)
        f = q.field
        if col.multi and col.has_multi_planes:
            emit(OP_GT_IMM, plane(f"{f}:mp0"), -1)  # a first value exists
        elif col.multi and col.has_multi_planes_wide:
            emit(OP_GT_IMM, plane(f"{f}:mpn"), 0)
        elif col.multi:
            emit(OP_GT_IMM, plane(f"{f}:valid"), 0)
            emit(OP_ROWS_TO_DOCS, plane(f"{f}:doc"), pops=1)
        elif col.ftype.is_stringy:
            emit(OP_GT_IMM, plane(f"{f}:w"), -1)
        else:
            emit(OP_TRUE)

    def phrase(q, path):
        col = dindex.column(q.field)
        f = q.field
        k = _key(path)
        n = len(q.tokens)
        K = len(col.multi_planes_host or ())
        if n == 0 or (not col.has_tail and K < n):
            emit(OP_TRUE)  # no start position: matches nothing
            emit(OP_NOT, pops=1)
            return
        p0 = param_run(k, ":p", n)
        if not col.has_tail:
            # the plane index IS the token position: an OR over start
            # positions of ANDed compares
            for s0 in range(K - n + 1):
                for j in range(n):
                    emit(OP_EQ32, plane(f"{f}:mp{s0 + j}"), p0 + j)
                    if j:
                        emit(OP_AND, pops=2)
                if s0:
                    emit(OP_OR, pops=2)
            return
        # the CSR token stream (positions in row order), then its docs
        doc = plane(f"{f}:doc")
        emit(OP_PHRASE_ROWS, plane(f"{f}:w"), plane(f"{f}:valid"), doc, p0,
             n)
        emit(OP_ROWS_TO_DOCS, doc, pops=1)

    def walk(q, path):
        if isinstance(q, Q.MatchAllQuery):
            emit(OP_TRUE)
        elif isinstance(q, (Q.TermQuery, Q.RangeQuery, Q.PrefixQuery,
                            *SET_QUERIES)):
            leaf(q, path)
        elif isinstance(q, Q.ExistsQuery):
            exists(q)
        elif isinstance(q, Q.PhraseQuery):
            phrase(q, path)
        elif isinstance(q, Q.BooleanQuery):
            emit(OP_TRUE)
            for i, c in enumerate(q.must):
                walk(c, path + ("m", i))
                emit(OP_AND, pops=2)
            if q.should and not q.must:
                for i, c in enumerate(q.should):
                    walk(c, path + ("s", i))
                    if i:
                        emit(OP_OR, pops=2)
                emit(OP_AND, pops=2)
            for i, c in enumerate(q.must_not):
                walk(c, path + ("n", i))
                emit(OP_NOT, pops=1)
                emit(OP_AND, pops=2)
        else:
            raise NotImplementedError(
                f"{type(q).__name__} has no mask-program encoding yet")

    for i, (q, qpath) in enumerate(chain):
        walk(q, qpath)
        if i:
            emit(OP_AND, pops=2)
    if not code:
        emit(OP_TRUE)
    if depth[1] > MAX_STACK:
        raise NotImplementedError(
            f"query chain needs a {depth[1]}-deep mask stack "
            f"(> {MAX_STACK})")
    return MaskProgram(np.asarray(code, np.int32).reshape(-1, OP_WIDTH),
                       tuple(planes), tuple(pkeys))


def eval_ops(ops, planes, pmat, shape) -> torch.Tensor:
    """Interpret a mask program with torch ops: `planes` are int32 (or
    int8) tensors of row shape `shape` (or broadcastable to it), `pmat` is
    the [B, P] int32 param matrix in param-key order. Returns bool
    [B, *shape] (a broadcast view where the mask does not depend on the
    params). A doc-space op (DOC_SPACE_OPS) reads value-row planes of its
    own length and takes `shape` as (T,), the doc axis."""
    B = pmat.shape[0]
    lead = (B,) + (1,) * len(shape)
    prm = [pmat[:, j].reshape(lead) for j in range(pmat.shape[1])]

    def wide_in(hi, lo, lh, ll, hh, hl):
        """(hi, lo) in the lexicographic range (p[lh], p[ll]) .. (p[hh],
        p[hl])."""
        ge = (hi > prm[lh]) | ((hi == prm[lh]) & (lo >= prm[ll]))
        le = (hi < prm[hh]) | ((hi == prm[hh]) & (lo <= prm[hl]))
        return ge & le

    stack = []
    for o in np.asarray(ops).tolist():
        op = o[0]
        if op == OP_TRUE:
            stack.append(torch.ones((1,) * len(lead), dtype=torch.bool,
                                    device=pmat.device))
        elif op in (OP_AND, OP_OR):
            b, a = stack.pop(), stack.pop()
            stack.append(a & b if op == OP_AND else a | b)
        elif op == OP_NOT:
            stack.append(~stack.pop())
        elif op == OP_RANGE32:
            v = planes[o[1]]
            stack.append((v >= prm[o[2]]) & (v <= prm[o[3]]))
        elif op == OP_EQ32:
            stack.append(planes[o[1]] == prm[o[2]])
        elif op == OP_EQ32_GUARD:
            stack.append((planes[o[1]] == prm[o[2]]) & (prm[o[3]] > 0))
        elif op == OP_RANGE_WIDE:
            stack.append(wide_in(planes[o[1]], planes[o[2]], *o[3:7]))
        elif op == OP_EQ_WIDE_GUARD:
            hi, lo = planes[o[1]], planes[o[2]]
            stack.append((hi == prm[o[3]]) & (lo == prm[o[4]])
                         & (prm[o[5]] > 0))
        elif op == OP_SET32:
            v, p0 = planes[o[1]], o[2]
            m = (v >= prm[p0]) & (v <= prm[p0 + 1])
            for i in range(1, o[3]):
                m |= (v >= prm[p0 + 2 * i]) & (v <= prm[p0 + 2 * i + 1])
            stack.append(m)
        elif op == OP_SET_WIDE:
            hi, lo, p0 = planes[o[1]], planes[o[2]], o[3]
            m = wide_in(hi, lo, *range(p0, p0 + 4))
            for j in range(p0 + 4, p0 + 4 * o[4], 4):
                m |= wide_in(hi, lo, *range(j, j + 4))
            stack.append(m)
        elif op == OP_GT_IMM:
            stack.append(planes[o[1]] > o[2])
        elif op == OP_ROWS_TO_DOCS:
            hits = stack.pop()
            stack.append(values_hit_to_doc_mask(
                hits.expand(B, hits.shape[-1]), planes[o[1]], shape[-1]))
        elif op == OP_PHRASE_ROWS:
            stack.append(_phrase_rows(planes[o[1]], planes[o[2]] > 0,
                                      planes[o[3]], prm[o[4]:o[4] + o[5]]))
        else:
            raise ValueError(f"unknown mask opcode {op}")
    (m,) = stack
    return m.expand((B,) + tuple(shape))


def _shift(x, j, fill):
    """x[r + j] at row r, `fill` past the end."""
    if j == 0:
        return x
    return torch.cat([x[j:], x.new_full((j,), fill)])


def _phrase_rows(w, valid, doc, toks):
    """[B, V] bool: value row r starts the phrase `toks` ([B, 1] params):
    w[r + j] == toks[j] for every j, and the window's last row is a valid
    row of r's doc (a doc's rows are contiguous, so the end points pin the
    whole window) — the JAX package's CSR phrase stream."""
    n = len(toks)
    hits = valid & (w == toks[0])
    for j in range(1, n):
        hits = hits & (_shift(w, j, -1) == toks[j])
    if n > 1:
        hits = hits & _shift(valid, n - 1, False) \
            & (_shift(doc, n - 1, -1) == doc)
    return hits


def to_device_async(t: torch.Tensor, device, out=None) -> torch.Tensor:
    """Copy a small host tensor to `device` (into `out`, a device buffer of
    its shape, where given) without waiting for the work already queued
    there: a CUDA copy is staged in pinned memory and made non-blocking
    (the caching host allocator keeps the staging buffer until the copy
    has run). A pageable copy would synchronize the stream. Spanned as
    `tat.param_copy`."""
    with span("tat.param_copy"):
        if torch.device(device).type != "cuda":
            return t.to(device) if out is None else out.copy_(t)
        if out is None:
            return t.pin_memory().to(device, non_blocking=True)
        return out.copy_(t.pin_memory(), non_blocking=True)


def param_rows(params_list, keys) -> torch.Tensor:
    """[B, len(keys)] int32 host matrix of extracted params. A key-less
    program gets one zero column so every matrix has rows."""
    mat = np.zeros((len(params_list), max(1, len(keys))), np.int32)
    for b, params in enumerate(params_list):
        for i, k in enumerate(keys):
            mat[b, i] = params[k]
    return torch.from_numpy(mat)


def param_matrix(params_list, keys, device, out=None) -> torch.Tensor:
    """[B, len(keys)] int32 device matrix of extracted params (one host
    build, `param_rows`, one asynchronous host->device copy, into `out`
    where given: a captured step's param buffer)."""
    return to_device_async(param_rows(params_list, keys), device, out)


def eval_mask(q, dindex, params, path, arrays, prefix="") -> torch.Tensor:
    """[1, T] bool mask of one query over the (possibly permuted, via
    `prefix`) planes in `arrays`, with `params` an extract_params dict —
    the single-request convenience form of mask_program + eval_ops."""
    mp = mask_program(((q, path),), dindex)
    planes = [arrays[prefix + k] for k in mp.plane_keys]
    T = (planes[0].shape[0] if planes
         else arrays[prefix + "alive"].shape[0])
    device = arrays[prefix + "alive"].device
    pmat = param_matrix([params], mp.param_keys, device)
    return eval_ops(mp.ops, planes, pmat, (T,))
