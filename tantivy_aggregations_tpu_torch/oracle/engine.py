"""Sequential CPU oracle — the executable semantics spec (SURVEY.md §4.1).

This is the stand-in for the (unbuildable, empty-mount) Rust reference: a
straightforward per-segment NumPy implementation of every query and agg per
SURVEY.md §A. The TPU engine's results must be **bit-identical** to this
oracle's — exact integer arithmetic and the shared harvest helpers in
utils/exact.py make that achievable regardless of device execution order.

Kept deliberately simple and independent of the device code path: the only
shared modules are the semantics helpers (mono mapping, exact sums,
percentile ranks, histogram keys), which *define* the spec.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..aggs import ir as A
from ..query import ir as Q
from ..schema import FieldType, stringy_term
from ..index.segment import Segment, numeric_dtype
from ..utils import exact
from ..utils import mono as mono_mod


class OracleSearcher:
    def __init__(self, index):
        self.index = index
        self.schema = index.schema

    # -- query evaluation: per segment -> bool doc mask ----------------------

    def _eval_query(self, q: Q.Query, seg: Segment) -> np.ndarray:
        if isinstance(q, Q.MatchAllQuery):
            return np.ones(seg.max_doc, dtype=bool)
        if isinstance(q, Q.TermQuery):
            return self._term_mask(q.field, q.value, seg)
        if isinstance(q, Q.ExistsQuery):
            fd = seg.fields[q.field]
            if fd.offsets is None:
                return np.ones(seg.max_doc, dtype=bool)
            return np.diff(fd.offsets.astype(np.int64)) > 0
        if isinstance(q, Q.PhraseQuery):
            # spec (§A.13): the doc's TEXT tokens form ONE concatenated
            # position-ordered stream (multi-value docs concatenate values,
            # so phrases may match across adjacent values); a doc matches
            # iff the stream contains the phrase tokens adjacently in
            # order. Zero tokens match nothing.
            entry = self.schema.field(q.field)
            if entry.type != FieldType.TEXT:
                raise TypeError("phrase query requires a text field")
            fd = seg.fields[q.field]
            toks = q.tokens
            if len(toks) == 0:
                return np.zeros(seg.max_doc, dtype=bool)
            terms = np.asarray(fd.terms, dtype=object)
            ords = []
            for t in toks:
                i = int(np.searchsorted(terms, t))
                if i >= len(terms) or terms[i] != t:
                    return np.zeros(seg.max_doc, dtype=bool)
                ords.append(np.uint32(i))
            v = fd.values
            n = len(ords)
            V = v.shape[0]
            if V < n:
                return np.zeros(seg.max_doc, dtype=bool)
            reps = np.diff(fd.offsets.astype(np.int64))
            doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
            hits = v[: V - n + 1] == ords[0]
            for j in range(1, n):
                hits &= v[j: V - n + 1 + j] == ords[j]
            hits &= doc_of_val[: V - n + 1] == doc_of_val[n - 1:]
            mask = np.zeros(seg.max_doc, dtype=bool)
            mask[doc_of_val[: V - n + 1][hits]] = True
            return mask
        if isinstance(q, Q.PrefixQuery):
            # spec-first (independent of the engine's ordinal-range
            # lowering): a term matches iff it startswith the prefix
            entry = self.schema.field(q.field)
            if not entry.type.is_stringy or entry.type == FieldType.BYTES:
                raise TypeError(
                    "prefix query requires a keyword, text, or facet field")
            fd = seg.fields[q.field]
            tmask = np.asarray([t.startswith(q.prefix) for t in fd.terms],
                               dtype=bool)
            hit_vals = (tmask[fd.values] if len(fd.terms)
                        else np.zeros(fd.values.shape, bool))
            return self._vals_hit_to_doc_mask(hit_vals, fd, seg)
        if isinstance(q, Q.TermSetQuery):
            # spec (§A.14): exactly the OR of per-value TermQuery matches
            m = np.zeros(seg.max_doc, dtype=bool)
            for v in q.values:
                m |= self._term_mask(q.field, v, seg)
            return m
        if isinstance(q, (Q.FuzzyTermQuery, Q.RegexQuery)):
            # spec-first (§A.14): the shared per-term predicate
            # (utils/termmatch.py) marks matching terms of the segment's
            # table; a doc matches iff it holds a marked term
            from ..utils import termmatch
            entry = self.schema.field(q.field)
            termmatch.check_set_query_field(entry.type, q)
            fd = seg.fields[q.field]
            if isinstance(q, Q.FuzzyTermQuery):
                tmask = termmatch.fuzzy_term_mask(
                    fd.terms, str(q.term), q.distance, q.transpositions,
                    q.prefix_length)
            else:
                tmask = termmatch.regex_term_mask(fd.terms, str(q.pattern))
            hit_vals = (tmask[fd.values] if len(fd.terms)
                        else np.zeros(fd.values.shape, bool))
            return self._vals_hit_to_doc_mask(hit_vals, fd, seg)
        if isinstance(q, Q.RangeQuery):
            return self._range_mask(q, seg)
        if isinstance(q, Q.BooleanQuery):
            m = np.ones(seg.max_doc, dtype=bool)
            for c in q.must:
                m &= self._eval_query(c, seg)
            if q.should and not q.must:
                s = np.zeros(seg.max_doc, dtype=bool)
                for c in q.should:
                    s |= self._eval_query(c, seg)
                m &= s
            for c in q.must_not:
                m &= ~self._eval_query(c, seg)
            return m
        raise TypeError(f"unknown query {type(q)!r}")

    def _term_mask(self, field: str, value, seg: Segment) -> np.ndarray:
        entry = self.schema.field(field)
        fd = seg.fields[field]
        if entry.type.is_stringy:
            term = stringy_term(entry.type, value)
            # binary search in the sorted segment-local term table
            i = np.searchsorted(np.asarray(fd.terms, dtype=object), term)
            if i >= len(fd.terms) or fd.terms[i] != term:
                return np.zeros(seg.max_doc, dtype=bool)
            hit_vals = fd.values == np.uint32(i)
        else:
            hit_vals = fd.values == numeric_dtype(entry.type)(value)
        return self._vals_hit_to_doc_mask(hit_vals, fd, seg)

    def _range_mask(self, q: Q.RangeQuery, seg: Segment) -> np.ndarray:
        entry = self.schema.field(q.field)
        fd = seg.fields[q.field]
        if entry.type.is_stringy:
            # lexicographic range over the sorted term table (ord order ==
            # lexicographic order)
            terms = np.asarray(fd.terms, dtype=object)
            lo_ord = 0
            hi_ord = len(terms) - 1
            if q.lower is not None:
                side = "left" if q.include_lower else "right"
                lo_ord = int(np.searchsorted(
                    terms, stringy_term(entry.type, q.lower), side=side))
            if q.upper is not None:
                side = "right" if q.include_upper else "left"
                hi_ord = int(np.searchsorted(
                    terms, stringy_term(entry.type, q.upper), side=side)) - 1
            hit = (fd.values >= np.uint32(max(lo_ord, 0))) \
                & (fd.values <= np.uint32(max(hi_ord, 0))) \
                if hi_ord >= lo_ord and hi_ord >= 0 \
                else np.zeros(fd.values.shape, bool)
            return self._vals_hit_to_doc_mask(hit, fd, seg)
        if not entry.type.is_numeric:
            raise TypeError("range query requires a numeric or string field")
        dtype = numeric_dtype(entry.type)
        v = fd.values
        hit = np.ones(v.shape, dtype=bool)
        for b, lower, inc in ((q.lower, True, q.include_lower),
                              (q.upper, False, q.include_upper)):
            if b is None:
                continue
            if entry.type != FieldType.F64:
                # exact integer bound normalization (SURVEY §A.10): the
                # shared spec implementation in utils/exact.py — fractional
                # bounds tighten, exclusivity folds in, out-of-domain
                # bounds become vacuous/empty instead of wrapping
                r = exact.norm_int_bound(entry.type.value, b, lower, inc)
                if r == "all":
                    continue
                if r == "empty":
                    hit = np.zeros_like(hit)
                    continue
                hit &= (v >= dtype(r)) if lower else (v <= dtype(r))
            else:
                bb = dtype(b)
                if lower:
                    hit &= (v >= bb) if inc else (v > bb)
                else:
                    hit &= (v <= bb) if inc else (v < bb)
        return self._vals_hit_to_doc_mask(hit, fd, seg)

    @staticmethod
    def _vals_hit_to_doc_mask(hit_vals: np.ndarray, fd, seg: Segment) -> np.ndarray:
        if fd.offsets is None:
            return hit_vals.copy()
        out = np.zeros(seg.max_doc, dtype=bool)
        idx = np.nonzero(hit_vals)[0]
        if idx.size:
            doc_of_val = np.searchsorted(fd.offsets, idx, side="right") - 1
            out[doc_of_val] = True
        return out

    # -- value extraction -----------------------------------------------------

    def _matched_values(self, field: str, seg: Segment, mask: np.ndarray) -> np.ndarray:
        """All values contributed by matched docs (multi-valued: every value,
        in doc order). Returned in the user dtype."""
        fd = seg.fields[field]
        if fd.offsets is None:
            return fd.values[mask]
        reps = np.diff(fd.offsets.astype(np.int64))
        vmask = np.repeat(mask, reps)
        return fd.values[vmask]

    def _matched_kw_ords(self, field: str, seg: Segment, mask: np.ndarray):
        fd = seg.fields[field]
        reps = np.diff(fd.offsets.astype(np.int64))
        vmask = np.repeat(mask, reps)
        doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
        return fd.values[vmask], doc_of_val[vmask]

    # -- entry point ----------------------------------------------------------

    def agg_search(self, query: Q.Query, aggs: Dict[str, A.Agg]) -> Dict[str, dict]:
        """Run the agg tree; returns the final merged fruit (host types)."""
        A.validate_agg_tree(self.schema, aggs)
        per_seg = []
        for seg in self.index.segments:
            mask = self._eval_query(query, seg) & seg.alive_mask()
            per_seg.append((seg, mask))
        return {name: self._run_agg(agg, per_seg) for name, agg in aggs.items()}

    # -- agg evaluation (merged across segments) ------------------------------

    def _run_agg(self, agg: A.Agg, per_seg: List[Tuple[Segment, np.ndarray]]) -> dict:
        if isinstance(agg, A.CountAgg):
            return {"value": int(sum(int(m.sum()) for _, m in per_seg))}

        if isinstance(agg, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg, A.StatsAgg)):
            return self._metric(agg, per_seg)

        if isinstance(agg, A.PercentilesAgg):
            return self._percentiles(agg, per_seg)

        if isinstance(agg, A.HistogramAgg):
            return self._histogram(agg, per_seg)

        if isinstance(agg, A.FacetAgg):
            return self._facet(agg, [(seg, m.astype(np.int64))
                                     for seg, m in per_seg])

        if isinstance(agg, A.TermsAgg):
            return self._terms(agg, per_seg)

        if isinstance(agg, (A.FilterAgg, A.PostFilterAgg)):
            refined = []
            for seg, mask in per_seg:
                fm = mask & self._eval_query(agg.query, seg)
                refined.append((seg, fm))
            out = {"doc_count": int(sum(int(m.sum()) for _, m in refined))}
            for name, sub in agg.sub_aggs:
                out[name] = self._run_agg(sub, refined)
            return out

        if isinstance(agg, A.TopHitsAgg):
            return self._top_hits(agg, per_seg)

        raise TypeError(f"unknown agg {type(agg)!r}")

    def _field_type(self, field: str) -> FieldType:
        return self.schema.field(field).type

    @staticmethod
    def _user_scalar(ftype: FieldType, v):
        if ftype == FieldType.F64:
            return float(v)
        return int(v)

    def _metric(self, agg, per_seg) -> dict:
        ftype = self._field_type(agg.field)
        all_vals = [self._matched_values(agg.field, seg, m) for seg, m in per_seg]
        vals = (np.concatenate(all_vals) if all_vals
                else np.zeros(0, dtype=numeric_dtype(ftype)))
        return self._metric_from_values(agg, ftype, vals)

    def _percentiles(self, agg: A.PercentilesAgg, per_seg) -> dict:
        ftype = self._field_type(agg.field)
        all_vals = [self._matched_values(agg.field, seg, m) for seg, m in per_seg]
        vals = (np.concatenate(all_vals) if all_vals
                else np.zeros(0, dtype=numeric_dtype(ftype)))
        return self._percentiles_from_values(agg, ftype, vals)

    def _histogram(self, agg: A.HistogramAgg, per_seg) -> dict:
        ftype = self._field_type(agg.field)
        # per segment: (doc ids, exact bucket keys) of matched value occurrences
        per_seg_rows = []
        for seg, mask in per_seg:
            fd = seg.fields[agg.field]
            if fd.offsets is None:
                docs = np.nonzero(mask)[0]
                vals = fd.values[docs]
            else:
                reps = np.diff(fd.offsets.astype(np.int64))
                doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
                vmask = mask[doc_of_val]
                docs = doc_of_val[vmask]
                vals = fd.values[vmask]
            keys = self._exact_bucket_keys(ftype, vals, agg.interval, agg.offset, agg.calendar)
            per_seg_rows.append((seg, docs, keys))
        all_keys = (np.concatenate([k for _, _, k in per_seg_rows])
                    if per_seg_rows else np.zeros(0, dtype=np.int64))
        uniq = np.unique(all_keys)
        self._check_hist_span(agg, uniq)
        out_buckets = []
        for k in uniq.tolist():
            refined = []
            doc_count = 0
            for seg, docs, keys in per_seg_rows:
                sel_docs = docs[keys == k]
                doc_count += int(sel_docs.shape[0])
                # sub-aggs see one "collect" per contributing value occurrence:
                # build an occurrence mask; metric sub-aggs weight by occurrence
                occ_mask = np.zeros(seg.max_doc, dtype=np.int64)
                np.add.at(occ_mask, sel_docs, 1)
                refined.append((seg, occ_mask))
            b = {"key": self._bucket_key_user(ftype, k, agg.interval, agg.offset, agg.calendar),
                 "doc_count": doc_count}
            for name, sub in agg.sub_aggs:
                b[name] = self._run_agg_weighted(sub, refined)
            out_buckets.append(b)
        return {"buckets": out_buckets}

    @staticmethod
    def _check_hist_span(agg: A.HistogramAgg, uniq: np.ndarray) -> None:
        """Resource-limit spec choice (SURVEY.md §A.5): a histogram whose
        REALIZED (matched) bucket-index span exceeds 2^24 is refused. This
        is the one refusal condition for both engines — the device planner
        routes wide-column trees to the host path (NotImplementedError),
        where this check decides. Calendar histograms are exempt: their
        keys are period-start micros, not bucket indices, and the period
        count is already bounded by utils/calendar.MAX_CAL_MICROS."""
        if agg.calendar is not None or not uniq.size:
            return
        span = int(uniq[-1]) - int(uniq[0]) + 1
        if span > (1 << 24):
            raise ValueError(
                f"histogram would span {span} buckets; raise the interval")

    def _exact_bucket_keys(self, ftype: FieldType, vals: np.ndarray,
                           interval, offset, calendar=None) -> np.ndarray:
        """key index k = floor((v - offset)/interval), exact (§A.5).
        Calendar intervals use the period start itself as the key
        (utils/calendar.py — the shared beyond-reference spec)."""
        if calendar is not None:
            from ..utils import calendar as cal
            ks = [cal.bucket_start_micros(int(v), calendar)
                  for v in vals.tolist()]
            return np.asarray(ks, dtype=np.int64)
        if ftype == FieldType.F64:
            ks = [int((Fraction(float(v)) - Fraction(offset)) // Fraction(interval))
                  for v in vals.tolist()]
            return np.asarray(ks, dtype=np.int64)
        iv, off = int(interval), int(offset)
        if iv <= 0:
            raise ValueError("interval must be > 0")
        ks = [(int(v) - off) // iv for v in vals.tolist()]
        return np.asarray(ks, dtype=np.int64)

    @staticmethod
    def _bucket_key_user(ftype: FieldType, k: int, interval, offset,
                         calendar=None):
        if calendar is not None:
            return int(k)  # calendar keys ARE the period-start micros
        if ftype == FieldType.F64:
            return exact.f64_histogram_key(k, interval, offset)
        return int(offset) + k * int(interval)

    def _facet(self, agg: A.FacetAgg, per_seg_w) -> dict:
        """Counts per immediate child of agg.path (§A.12). The writer
        indexes every ancestor prefix once per doc, so a child's count is
        its own per-ordinal (weighted) count, inclusive of descendants.
        Non-empty children only, ordered (count desc, path asc), truncated
        to size."""
        pfx = (agg.path.rstrip("/") + "/") if agg.path else "/"
        counter: Dict[str, int] = {}
        for seg, w in per_seg_w:
            fd = seg.fields[agg.field]
            terms = fd.terms or []
            if not terms:
                continue
            reps = np.diff(fd.offsets.astype(np.int64))
            doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
            wv = w[doc_of_val].astype(np.int64)
            counts = np.bincount(fd.values.astype(np.int64),
                                 weights=wv.astype(np.float64),
                                 minlength=len(terms)).astype(np.int64)
            for j, t in enumerate(terms):
                if (counts[j] > 0 and t.startswith(pfx)
                        and "/" not in t[len(pfx):]):
                    counter[t] = counter.get(t, 0) + int(counts[j])
        ordered = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        return {"buckets": [{"key": k, "doc_count": c}
                            for k, c in ordered[: agg.size]]}

    def _terms(self, agg: A.TermsAgg, per_seg) -> dict:
        ftype = self._field_type(agg.field)
        # collect (key, doc, segment) per matched value occurrence; keys are
        # term strings (keyword) or user numeric values
        counter: Dict[object, int] = {}
        per_seg_rows = []
        for seg, mask in per_seg:
            fd = seg.fields[agg.field]
            if fd.offsets is None:
                docs = np.nonzero(mask)[0]
                vals = fd.values[docs]
            else:
                reps = np.diff(fd.offsets.astype(np.int64))
                doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
                vmask = mask[doc_of_val]
                docs = doc_of_val[vmask]
                vals = fd.values[vmask]
            if ftype.is_stringy:
                terms = np.asarray(fd.terms, dtype=object)
                keys = terms[vals] if vals.size else np.zeros(0, dtype=object)
            else:
                keys = vals
            per_seg_rows.append((seg, docs, keys))
            uk, cnt = (np.unique(keys, return_counts=True) if keys.size
                       else (np.zeros(0, dtype=object), np.zeros(0, dtype=np.int64)))
            for k, c in zip(uk.tolist(), cnt.tolist()):
                kk = k if ftype.is_stringy else self._user_scalar(ftype, k)
                counter[kk] = counter.get(kk, 0) + int(c)
        return self._terms_finish(agg, counter, per_seg_rows, ftype)

    def _terms_finish(self, agg: A.TermsAgg, counter, per_seg_rows, ftype):
        """Shared terms selection + bucket building. Order semantics (§A.6):
        target "_count" (default desc) / "_key" / a single-valued metric
        sub-agg name, compared on the HARVESTED user value; ties always
        break by key ascending; null order metrics sort last (key asc)."""
        def refined_for(key):
            refined = []
            for seg, docs, keys in per_seg_rows:
                sel = keys == (key if ftype.is_stringy
                               else numeric_dtype(ftype)(key))
                sel_docs = docs[sel]
                occ = np.zeros(seg.max_doc, dtype=np.int64)
                np.add.at(occ, sel_docs, 1)
                refined.append((seg, occ))
            return refined

        target, direction = agg.order
        keys_sorted = sorted(counter.keys())
        if target == "_key":
            ordered = (keys_sorted if direction == "asc"
                       else list(reversed(keys_sorted)))
        elif target == "_count":
            # stable sort preserves the key-ascending base order on ties
            ordered = sorted(keys_sorted, key=lambda k: counter[k],
                             reverse=(direction == "desc"))
        else:
            sub = dict(agg.sub_aggs)[target]
            vals = {k: self._run_agg_weighted(sub, refined_for(k))["value"]
                    for k in keys_sorted}
            present = [k for k in keys_sorted if vals[k] is not None]
            missing = [k for k in keys_sorted if vals[k] is None]
            present.sort(key=lambda k: vals[k],
                         reverse=(direction == "desc"))
            ordered = present + missing
        top = ordered[: agg.size]
        sum_other = sum(counter[k] for k in ordered[agg.size:])
        out_buckets = []
        for key in top:
            refined = refined_for(key)
            b = {"key": key, "doc_count": counter[key]}
            for name, sub in agg.sub_aggs:
                b[name] = self._run_agg_weighted(sub, refined)
            out_buckets.append(b)
        return {"buckets": out_buckets, "sum_other_doc_count": int(sum_other)}

    def _top_hits(self, agg: A.TopHitsAgg, per_seg) -> dict:
        if agg.sort_field is None:
            # score order (§A.10): scoring-disabled constant score 1.0, so
            # order is the doc-address tie-break — first `size` matched
            # docs in (segment, doc) order
            hits = []
            for si, (seg, mask) in enumerate(per_seg):
                for d in np.nonzero(mask)[0].tolist():
                    hits.append({"segment": si, "doc": d, "score": 1.0})
                    if len(hits) >= agg.size:
                        return {"hits": hits}
            return {"hits": hits}
        ftype = self._field_type(agg.sort_field)
        rows = []
        for si, (seg, mask) in enumerate(per_seg):
            fd = seg.fields[agg.sort_field]
            if fd.offsets is not None:
                raise TypeError("top_hits sort field must be single-valued")
            docs = np.nonzero(mask)[0]
            vals = mono_mod.to_mono(ftype.value, fd.values[docs])
            for d, v in zip(docs.tolist(), vals.tolist()):
                rows.append((v, si, d))
        rows.sort(key=lambda r: (r[0], r[1], r[2]),
                  reverse=not agg.ascending)
        if not agg.ascending:
            # reverse=True flips doc tie-break too; re-sort ties ascending
            rows.sort(key=lambda r: (-r[0], r[1], r[2]))
        hits = [{"segment": si, "doc": d,
                 "value": self._user_scalar(ftype, mono_mod.scalar_from_mono(ftype.value, v))}
                for v, si, d in rows[: agg.size]]
        return {"hits": hits}

    # -- weighted evaluation for sub-aggs under buckets ------------------------
    # A bucket's sub-agg sees each doc once PER contributing value occurrence
    # of the parent (the reference's per-ordinal collect recursion, §3.2).
    # `weights` is an int64 occurrence count per doc.

    def _run_agg_weighted(self, agg: A.Agg, per_seg_w) -> dict:
        if isinstance(agg, A.CountAgg):
            return {"value": int(sum(int(w.sum()) for _, w in per_seg_w))}

        if isinstance(agg, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg, A.StatsAgg)):
            ftype = self._field_type(agg.field)
            parts = []
            for seg, w in per_seg_w:
                fd = seg.fields[agg.field]
                if fd.offsets is None:
                    docs = np.nonzero(w)[0]
                    vals = np.repeat(fd.values[docs], w[docs])
                else:
                    reps = np.diff(fd.offsets.astype(np.int64))
                    doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
                    vals = np.repeat(fd.values, w[doc_of_val])
                parts.append(vals)
            vals = (np.concatenate(parts) if parts
                    else np.zeros(0, dtype=numeric_dtype(ftype)))
            return self._metric_from_values(agg, ftype, vals)

        if isinstance(agg, A.PercentilesAgg):
            ftype = self._field_type(agg.field)
            parts = []
            for seg, w in per_seg_w:
                fd = seg.fields[agg.field]
                if fd.offsets is None:
                    docs = np.nonzero(w)[0]
                    vals = np.repeat(fd.values[docs], w[docs])
                else:
                    reps = np.diff(fd.offsets.astype(np.int64))
                    doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
                    vals = np.repeat(fd.values, w[doc_of_val])
                parts.append(vals)
            vals = (np.concatenate(parts) if parts
                    else np.zeros(0, dtype=numeric_dtype(ftype)))
            return self._percentiles_from_values(agg, ftype, vals)

        if isinstance(agg, (A.FilterAgg, A.PostFilterAgg)):
            refined = []
            for seg, w in per_seg_w:
                fm = self._eval_query(agg.query, seg)
                refined.append((seg, np.where(fm, w, 0)))
            out = {"doc_count": int(sum(int(w.sum()) for _, w in refined))}
            for name, sub in agg.sub_aggs:
                out[name] = self._run_agg_weighted(sub, refined)
            return out

        # nested bucket aggs under buckets: evaluate by expanding weights into
        # plain masks is NOT possible (weights > 1); handled by treating the
        # weighted recursion inside _histogram/_terms, which re-derive value
        # occurrences per segment.
        if isinstance(agg, A.HistogramAgg):
            return self._histogram_weighted(agg, per_seg_w)
        if isinstance(agg, A.FacetAgg):
            return self._facet(agg, per_seg_w)
        if isinstance(agg, A.TermsAgg):
            return self._terms_weighted(agg, per_seg_w)

        if isinstance(agg, A.TopHitsAgg):
            # spec choice (§A.9): hits are DOCS of the bucket — a doc in the
            # bucket via multiple parent value occurrences appears once
            return self._top_hits(agg, [(seg, w > 0) for seg, w in per_seg_w])

        raise TypeError(f"unsupported sub-agg {type(agg)!r}")

    def _metric_from_values(self, agg, ftype, vals: np.ndarray) -> dict:
        n = int(vals.shape[0])

        def exact_sum():
            if ftype == FieldType.F64:
                return exact.f64_exact_sum_host(vals)
            return int(np.sum(vals.astype(object))) if n else 0

        if isinstance(agg, A.SumAgg):
            return {"value": exact_sum()}
        if isinstance(agg, A.MinAgg):
            return {"value": None if n == 0 else self._user_scalar(ftype, vals.min())}
        if isinstance(agg, A.MaxAgg):
            return {"value": None if n == 0 else self._user_scalar(ftype, vals.max())}
        if isinstance(agg, A.AvgAgg):
            s = exact_sum()
            value = None if n == 0 else (
                float(Fraction(s) / n) if ftype != FieldType.F64 else s / n)
            return {"value": value, "sum": s, "count": n}
        if isinstance(agg, A.StatsAgg):
            s = exact_sum()
            return {"count": n, "sum": s,
                    "min": None if n == 0 else self._user_scalar(ftype, vals.min()),
                    "max": None if n == 0 else self._user_scalar(ftype, vals.max()),
                    "avg": None if n == 0 else (
                        float(Fraction(s) / n) if ftype != FieldType.F64 else s / n)}
        raise AssertionError

    def _percentiles_from_values(self, agg, ftype, vals: np.ndarray) -> dict:
        m = int(vals.shape[0])
        if m == 0:
            return {"values": {str(p): None for p in agg.percents}}
        mono = mono_mod.to_mono(ftype.value, vals)
        mono.sort()
        user_sorted = mono_mod.from_mono(ftype.value, mono)
        out = {}
        for p in agg.percents:
            lo, hi, frac = exact.percentile_rank(p, m)
            out[str(p)] = exact.interpolate(
                float(self._user_scalar(ftype, user_sorted[lo])),
                float(self._user_scalar(ftype, user_sorted[hi])), frac)
        return {"values": out}

    def _histogram_weighted(self, agg: A.HistogramAgg, per_seg_w) -> dict:
        ftype = self._field_type(agg.field)
        per_seg_rows = []
        for seg, w in per_seg_w:
            fd = seg.fields[agg.field]
            if fd.offsets is None:
                docs = np.nonzero(w)[0]
                docs = np.repeat(docs, w[docs])
                vals = fd.values[docs]
            else:
                reps = np.diff(fd.offsets.astype(np.int64))
                doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
                docs = np.repeat(doc_of_val, w[doc_of_val])
                vals = np.repeat(fd.values, w[doc_of_val])
            keys = self._exact_bucket_keys(ftype, vals, agg.interval, agg.offset, agg.calendar)
            per_seg_rows.append((seg, docs, keys))
        all_keys = (np.concatenate([k for _, _, k in per_seg_rows])
                    if per_seg_rows else np.zeros(0, dtype=np.int64))
        uniq = np.unique(all_keys)
        self._check_hist_span(agg, uniq)
        out_buckets = []
        for k in uniq.tolist():
            refined = []
            doc_count = 0
            for seg, docs, keys in per_seg_rows:
                sel_docs = docs[keys == k]
                doc_count += int(sel_docs.shape[0])
                occ = np.zeros(seg.max_doc, dtype=np.int64)
                np.add.at(occ, sel_docs, 1)
                refined.append((seg, occ))
            b = {"key": self._bucket_key_user(ftype, k, agg.interval, agg.offset, agg.calendar),
                 "doc_count": doc_count}
            for name, sub in agg.sub_aggs:
                b[name] = self._run_agg_weighted(sub, refined)
            out_buckets.append(b)
        return {"buckets": out_buckets}

    def _terms_weighted(self, agg: A.TermsAgg, per_seg_w) -> dict:
        ftype = self._field_type(agg.field)
        counter: Dict[object, int] = {}
        per_seg_rows = []
        for seg, w in per_seg_w:
            fd = seg.fields[agg.field]
            if fd.offsets is None:
                docs = np.nonzero(w)[0]
                docs = np.repeat(docs, w[docs])
                vals = fd.values[docs]
            else:
                reps = np.diff(fd.offsets.astype(np.int64))
                doc_of_val = np.repeat(np.arange(seg.max_doc), reps)
                docs = np.repeat(doc_of_val, w[doc_of_val])
                vals = np.repeat(fd.values, w[doc_of_val])
            if ftype.is_stringy:
                terms = np.asarray(fd.terms, dtype=object)
                keys = terms[vals] if vals.size else np.zeros(0, dtype=object)
            else:
                keys = vals
            per_seg_rows.append((seg, docs, keys))
            uk, cnt = (np.unique(keys, return_counts=True) if keys.size
                       else (np.zeros(0, dtype=object), np.zeros(0, dtype=np.int64)))
            for k, c in zip(uk.tolist(), cnt.tolist()):
                kk = k if ftype.is_stringy else self._user_scalar(ftype, k)
                counter[kk] = counter.get(kk, 0) + int(c)
        return self._terms_finish(agg, counter, per_seg_rows, ftype)
