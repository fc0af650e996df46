"""The plain reference: NumPy over the columns a generator drew from the
seed (perfbench/data/, the neutral form), answering the JSON request
trees of perfbench/traffic/ by the semantics of a sequential search.

It imports nothing of the port and takes nothing the port made: the
same columns that the port's writer indexed, and the request trees.
Each query kind is a file `queries/<kind>.py` with `mask(ref, args)`
(a bool per doc) and each agg kind a file `aggs/<kind>.py` with
`evaluate(ref, args, w)`, found by name, so a mix that needs a new kind
adds a file. An agg is evaluated under `w`, an int64 weight per doc: 1
for a matching doc at the top, and under a bucket the number of the
bucket's value occurrences the doc holds (a bucket's sub-aggs see a doc
once per occurrence, as a sequential collector visits it).

`lossy=True` is the control: the same reference in float32 (f64 values
rounded to float32, sums accumulated in float32), one precision below
the exact answers that the configurations guarantee. It must fail the
comparison.
"""

import importlib.util
from pathlib import Path

import numpy as np

from . import semantics

_HERE = Path(__file__).resolve().parent
_MODULES = {}


def _module(group: str, kind: str):
    key = (group, kind)
    if key not in _MODULES:
        path = _HERE / group / f"{kind}.py"
        if not path.exists():
            raise NotImplementedError(f"the reference has no {group} {kind!r}"
                                      f" ({path} is missing)")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_ref_{group}_{kind}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


class Reference:
    def __init__(self, columns: dict, n_docs: int, lossy: bool = False):
        self.cols = columns
        self.n = int(n_docs)
        self.lossy = lossy
        self._cache = {}

    # -- columns ----------------------------------------------------------

    def col(self, field: str) -> dict:
        return self.cols[field]

    def multi(self, field: str) -> bool:
        return "offsets" in self.cols[field]

    def doc_of_row(self, field: str) -> np.ndarray:
        """The doc of each value row of a multi-valued field."""
        key = ("doc_of_row", field)
        if key not in self._cache:
            offs = self.cols[field]["offsets"].astype(np.int64)
            self._cache[key] = np.repeat(np.arange(self.n), np.diff(offs))
        return self._cache[key]

    def row_weights(self, field: str, w: np.ndarray) -> np.ndarray:
        """The weight of each value (row) of `field` under doc weights w."""
        return w[self.doc_of_row(field)] if self.multi(field) else w

    def rows_to_docs(self, field: str, hit: np.ndarray) -> np.ndarray:
        """bool per doc: the doc holds a row where `hit` is True."""
        if not self.multi(field):
            return hit
        out = np.zeros(self.n, bool)
        out[self.doc_of_row(field)[hit]] = True
        return out

    def values(self, field: str) -> np.ndarray:
        """Numeric values per row (per doc where single-valued); float32-
        rounded f64 in the control."""
        c = self.cols[field]
        if c["type"] == "f64" and self.lossy:
            return c["values"].astype(np.float32).astype(np.float64)
        return c["values"]

    def scalar(self, field: str, v):
        return float(v) if self.cols[field]["type"] == "f64" else int(v)

    def code_of(self, field: str, term: str):
        """The code of `term` in a keyword or facet column, None if absent."""
        key = ("code_of", field)
        if key not in self._cache:
            self._cache[key] = {t: i for i, t in
                                enumerate(self.cols[field]["terms"])}
        return self._cache[key].get(term)

    def occurrences(self, field: str, code: int) -> np.ndarray:
        """int64 per doc: how often the doc holds `code` in `field`."""
        c = self.cols[field]
        if not self.multi(field):
            return (c["codes"] == code).astype(np.int64)
        key = ("by_code", field)
        if key not in self._cache:
            order = np.argsort(c["codes"], kind="stable")
            bounds = np.searchsorted(c["codes"][order],
                                     np.arange(len(c["terms"]) + 1))
            self._cache[key] = (self.doc_of_row(field)[order], bounds)
        docs, bounds = self._cache[key]
        return np.bincount(docs[bounds[code]:bounds[code + 1]],
                           minlength=self.n).astype(np.int64)

    def sorted_rows(self, field: str):
        """(row order of `field` by value, the values in that order): the
        total order of percentiles."""
        key = ("sorted", field, self.lossy)
        if key not in self._cache:
            v = self.values(field)
            m = (semantics.f64_to_mono(v) if self.cols[field]["type"] == "f64"
                 else v.astype(np.uint64))
            order = np.argsort(m, kind="stable")
            self._cache[key] = (order, v[order])
        return self._cache[key]

    def bucket_keys(self, field: str, interval: int, offset: int):
        """floor((v - offset) / interval) per row of integer `field`."""
        key = ("keys", field, interval, offset)
        if key not in self._cache:
            self._cache[key] = (self.cols[field]["values"].astype(np.int64)
                                - offset) // interval
        return self._cache[key]

    # -- exact arithmetic ---------------------------------------------------

    def weighted_sum(self, field: str, rw: np.ndarray):
        """sum(rw * value) over the rows of integer `field`, exact (a
        Python int); in float32 in the control. The values are split
        into 16-bit limbs, each summed as a float64 dot product, which
        is exact while max(rw) * 2**16 * rows < 2**53; past that, int64
        sums of 32-bit halves."""
        v = self.cols[field]["values"]
        if self.lossy:
            return float(np.sum((rw * v.astype(np.float32)).astype(
                np.float32), dtype=np.float32))
        limbs = self._limbs(field)
        if rw.size and int(rw.max()) * (1 << 16) * rw.size >= 1 << 53:
            u = v.astype(np.uint64)
            lo = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
            hi = (u >> np.uint64(32)).astype(np.int64)
            return int(np.dot(rw, lo)) + (int(np.dot(rw, hi)) << 32)
        f = rw.astype(np.float64)
        return sum(int(np.dot(f, limb)) << (16 * i)
                   for i, limb in enumerate(limbs))

    @staticmethod
    def counts(keys: np.ndarray, weights: np.ndarray, n: int) -> np.ndarray:
        """Exact int64 bincount of int64 weights (each float64 partial sum
        of 26-bit limbs stays below 2**53)."""
        lo = np.bincount(keys, weights=(weights & ((1 << 26) - 1)),
                         minlength=n)
        hi = np.bincount(keys, weights=(weights >> 26), minlength=n)
        return lo.astype(np.int64) + (hi.astype(np.int64) << 26)

    def _limbs(self, field: str):
        key = ("limbs", field)
        if key not in self._cache:
            u = self.cols[field]["values"].astype(np.uint64)
            top = int(u.max()) if u.size else 0
            self._cache[key] = [
                ((u >> np.uint64(16 * i)) & np.uint64(0xFFFF)).astype(
                    np.float64) for i in range(max(1, (top.bit_length()
                                                       + 15) // 16))]
        return self._cache[key]

    def bucket_subaggs(self, subs: dict, field: str, row_keys: np.ndarray,
                       w: np.ndarray, n_keys: int, wanted, occ) -> list:
        """The sub-agg fruits of buckets `wanted` of a bucket agg over
        `field` whose rows fall in bucket row_keys[row] (0 <= key <
        n_keys). Counts and sums of single-valued integer fields come from
        one exact bincount over all buckets; anything else, and the
        control, per bucket under its occurrence weights w * occ(k)."""
        simple = all(
            kind == "count" or (kind == "sum" and "offsets" not in
                                self.cols[a["field"]] and
                                self.cols[a["field"]]["type"] != "f64")
            for node in subs.values() for kind, a in node.items())
        if self.lossy or not simple or not len(w) or (
                int(w.max()) << 16) * len(row_keys) >= 1 << 53:
            return [self.sub_aggs(subs, w * occ(k)) for k in wanted]
        doc = self.doc_of_row(field) if self.multi(field) else None
        rw = w if doc is None else w[doc]
        out = [{} for _ in wanted]
        for name, node in subs.items():
            (kind, a), = node.items()
            if kind == "count":
                vals = self.counts(row_keys, rw, n_keys)
            else:
                vals = [0] * n_keys
                for i, limb in enumerate(self._limbs(a["field"])):
                    part = w * limb if doc is None else (w * limb)[doc]
                    got = np.bincount(row_keys, weights=part,
                                      minlength=n_keys)
                    vals = [v + (int(g) << (16 * i))
                            for v, g in zip(vals, got)]
            for o, k in zip(out, wanted):
                o[name] = {"value": int(vals[k])}
        return out

    # -- evaluation ---------------------------------------------------------

    def mask(self, node: dict) -> np.ndarray:
        (kind, args), = node.items()
        return _module("queries", kind).mask(self, args)

    def agg(self, node: dict, w: np.ndarray) -> dict:
        (kind, args), = node.items()
        return _module("aggs", kind).evaluate(self, args, w)

    def sub_aggs(self, tree: dict, w: np.ndarray) -> dict:
        return {name: self.agg(node, w) for name, node in tree.items()}

    def answer(self, request: dict) -> dict:
        """The final fruit of one request {"query", "aggs"}."""
        w = self.mask(request["query"]).astype(np.int64)
        return self.sub_aggs(request["aggs"], w)
