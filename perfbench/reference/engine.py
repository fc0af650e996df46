"""The plain reference: NumPy over the columns a generator drew from the
seed (perfbench/data/, the neutral form), answering the JSON request
trees of perfbench/traffic/ by the semantics of a sequential search.

It imports nothing of the port and takes nothing the port made: the
same columns that the port's writer indexed, and the request trees.
Each query kind is a file `queries/<kind>.py` with `mask(ref, args)`
(a bool per doc) and each agg kind a file `aggs/<kind>.py`, found by
name, so a mix that needs a new kind adds a file. An agg is evaluated
under `w`, an int64 weight per doc: 1 for a matching doc at the top,
and under a bucket the number of the bucket's value occurrences the doc
holds (a bucket's sub-aggs see a doc once per occurrence, as a
sequential collector visits it). A metric kind of one field names the
`PARTS` it is made of ("count", "sum", "min", "max") and builds its
fruit from them in `fruit(ref, field, p)`, so that a bucket agg
computes those parts for all its buckets in one pass; any other kind
has `evaluate(ref, args, w)`.

The neutral form: {field: {"type": "u64" | "i64" | "date" | "f64" |
"keyword" | "facet", "values": array} or, for keyword and facet fields,
{"terms": sorted list of str, "codes": int array into terms}, plus
"offsets" (n_docs + 1) for a multi-valued field, whose values or codes
are then one per value row}. Text and bytes fields are out.

Numeric semantics, as the port declares them:
  u64, date, i64  sums exact (a Python int of sum w * v); i64 values
                  order as signed integers; an average is the exact sum
                  over the count, rounded once to f64;
  f64             a sum is the exact rational sum of w * v rounded once
                  to the nearest f64, ties to even (0.0 for an exact zero
                  and for no values); an average is that rounded sum over
                  the count in f64 (s / n); values order by the IEEE total
                  order; NaN and infinities are refused;
  histograms      key index floor((v - offset) / interval) in exact
                  arithmetic (for f64 fields, interval and offset as
                  given; for integer fields, their int()); bucket key
                  offset + index * interval, for f64 rounded once; -0.0
                  falls where 0.0 does.

`lossy=True` is the control: the same reference in float32 (f64 values
rounded to float32, sums accumulated in float32), one precision below
the exact answers that the configurations guarantee. It must fail the
comparison.
"""

import importlib.util
import math
from fractions import Fraction
from pathlib import Path

import numpy as np

from . import semantics

_HERE = Path(__file__).resolve().parent
_MODULES = {}
KINDS = ("u64", "i64", "date", "f64", "keyword", "facet")
#: the widest span of bucket indices an f64 histogram takes (the port
#: refuses a wider one)
MAX_SPAN = 1 << 24
#: the key index of rows that no bucket reads
_NO_KEY = -(1 << 62)


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


def _to_f64(total: int, e: int) -> float:
    """total * 2**(e - 1075) rounded once to the nearest f64, ties to
    even (Python's int and Fraction division round so); 0.0 for 0."""
    if total == 0:
        return 0.0
    return float(Fraction(total) * Fraction(2) ** (e - 1075))


def _ceil_f64(x: Fraction) -> float:
    """The least f64 >= x."""
    f = float(x)
    return f if Fraction(f) >= x else math.nextafter(f, math.inf)


class Reference:
    def __init__(self, columns: dict, n_docs: int, lossy: bool = False):
        for name, c in columns.items():
            if c["type"] not in KINDS:
                raise NotImplementedError(
                    f"the reference has no {c['type']} field ({name!r}): "
                    "text and bytes fields are out")
        self.cols = columns
        self.n = int(n_docs)
        self.lossy = lossy
        self._cache = {}

    # -- columns ----------------------------------------------------------

    def col(self, field: str) -> dict:
        return self.cols[field]

    def multi(self, field: str) -> bool:
        return "offsets" in self.cols[field]

    def is_f64(self, field: str) -> bool:
        return self.cols[field]["type"] == "f64"

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
        return float(v) if self.is_f64(field) else int(v)

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
        total order of percentiles (signed for i64, IEEE for f64)."""
        key = ("sorted", field, self.lossy)
        if key not in self._cache:
            v = self.values(field)
            t = self.cols[field]["type"]
            m = (semantics.f64_to_mono(v) if t == "f64" else
                 v.astype(np.int64) if t == "i64" else v.astype(np.uint64))
            order = np.argsort(m, kind="stable")
            self._cache[key] = (order, v[order])
        return self._cache[key]

    # -- histogram keys -----------------------------------------------------

    def bucket_keys(self, field: str, interval, offset,
                    live: np.ndarray) -> np.ndarray:
        """floor((v - offset) / interval) per row of numeric `field`, exact
        on the rows where `live` is True (an f64 field's other rows get a
        key that no bucket reads)."""
        if self.is_f64(field):
            return self._f64_keys(field, interval, offset, live)
        interval, offset = int(interval), int(offset)
        key = ("keys", field, interval, offset)
        if key not in self._cache:
            self._cache[key] = (self.cols[field]["values"].astype(np.int64)
                                - offset) // interval
        return self._cache[key]

    def _f64_keys(self, field, interval, offset, live):
        """Estimated in float64, which is off by at most one while the
        index stays far below 2**51, then set right by comparing each
        value with its bucket's bounds offset + k * interval, each the
        least f64 at or above the exact rational (computed once per
        index): v >= bound(k) exactly when v >= offset + k * interval."""
        iv, off = Fraction(interval), Fraction(offset)
        if iv <= 0:
            raise ValueError("interval must be > 0")
        keys = np.full(live.shape, _NO_KEY, np.int64)
        v = self.values(field)[live]
        if not v.size:
            return keys
        if not np.isfinite(v).all():
            raise ValueError("NaN and infinities are not allowed in f64 "
                             "fields")
        est = np.floor((v - float(offset)) / float(interval))
        lo, hi = float(est.min()), float(est.max())
        if hi - lo >= MAX_SPAN or max(-lo, hi) >= 2.0 ** 50:
            raise ValueError(f"histogram would span {hi - lo + 1:.0f} "
                             "buckets; raise the interval")
        k = (est - lo).astype(np.int64)
        need = np.flatnonzero(np.bincount(k))
        need = np.union1d(need, need + 1)
        bound = np.empty(int(need[-1]) + 1)
        k0 = int(lo)
        bound[need] = [_ceil_f64(off + (k0 + j) * iv) for j in need.tolist()]
        down, up = v < bound[k], v >= bound[k + 1]
        keys[live] = k - down + up + k0
        return keys

    def bucket_key(self, field: str, interval, offset, k: int):
        """The key of bucket index k: offset + k * interval."""
        if self.is_f64(field):
            return float(Fraction(offset) + k * Fraction(interval))
        return int(offset) + k * int(interval)

    # -- exact arithmetic ---------------------------------------------------

    @staticmethod
    def counts(keys: np.ndarray, weights: np.ndarray, n: int) -> np.ndarray:
        """Exact int64 bincount of non-negative int64 weights, by one
        float64 bincount (no partial sum may reach 2**53)."""
        if int(weights.max(initial=0)) * weights.size >= 1 << 53:
            raise OverflowError("weights too large for an exact bincount")
        return np.bincount(keys, weights=weights, minlength=n).astype(
            np.int64)

    def _parts_of(self, field: str) -> dict:
        """The exact pieces of numeric `field`'s values, per row: "mag"
        (uint64) and "bits" (its largest bit length); for an integer
        field mag = v - base, "base" 0 for u64 and date fields and the
        least value for i64 ones (so signed values sum exactly); for an
        f64 field v = (-1)**neg * mag * 2**(exps[idx] - 1075), with "neg",
        "idx" (int64) and "exps" (the exponents present, ascending)."""
        key = ("parts", field)
        if key in self._cache:
            return self._cache[key]
        c = self.cols[field]
        v = c["values"]
        if c["type"] == "f64":
            bits = np.ascontiguousarray(v, dtype=np.float64).view(np.uint64)
            e = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
            if (e == 0x7FF).any():
                raise ValueError("NaN and infinities are not allowed in f64 "
                                 "fields")
            frac = bits & np.uint64((1 << 52) - 1)
            p = {"mag": np.where(e > 0, frac | np.uint64(1 << 52), frac),
                 "neg": (bits >> np.uint64(63)) != 0, "base": 0}
            e = np.maximum(e, 1)
            present = np.flatnonzero(np.bincount(e, minlength=2048))
            slot = np.zeros(2048, np.int64)
            slot[present] = np.arange(present.size)
            p["idx"], p["exps"] = slot[e], present.tolist()
        elif c["type"] == "i64" and v.size:
            base = int(v.min())
            p = {"mag": v.astype(np.int64).view(np.uint64)
                 - np.uint64(base % (1 << 64)), "base": base}
        else:
            p = {"mag": v.astype(np.uint64), "base": 0}
        p["bits"] = max(1, int(p["mag"].max()).bit_length() if v.size else 1)
        self._cache[key] = p
        return p

    def _limbs(self, field: str, rw: np.ndarray):
        """(b, limbs): each row's magnitude of `field` in limbs of b bits,
        float64 arrays (signed as the value for f64), b as wide as keeps
        every float64 sum of rw * limb over all rows an exact integer
        (below 2**53) with as few limbs as that allows. One set is kept
        per field: the last."""
        p = self._parts_of(field)
        room = 53 - (int(rw.max(initial=0)) * max(1, rw.size)).bit_length()
        if room < 1:
            raise OverflowError("weights too large for exact limb sums")
        n = -(-p["bits"] // room)
        b = -(-p["bits"] // n)
        key = ("limbs", field)
        if self._cache.get(key, (None,))[0] != b:
            self._cache.pop(key, None)
            mask = np.uint64((1 << b) - 1)
            limbs = [((p["mag"] >> np.uint64(b * i)) & mask).astype(
                np.float64) for i in range(n)]
            if "neg" in p:
                limbs = [np.where(p["neg"], -x, x) for x in limbs]
            self._cache[key] = (b, limbs)
        return self._cache[key]

    def sums(self, field: str, rw: np.ndarray, keys: np.ndarray = None,
             n_keys: int = 1, at: np.ndarray = None, wanted=None) -> list:
        """Exact sums of rw[i] * value(at[i]) of numeric `field` (value(i)
        where `at` is None) over the entries i of each key keys[i] (all
        of them where `keys` is None), for the keys `wanted` (all
        n_keys where None): a Python int each for an integer field, the
        exact sum rounded once to the nearest f64 for an f64 field. The
        magnitudes are split into limbs (`_limbs`), each summed as a
        float64 dot product or bincount, and put together as integers.
        In the control, each product rw * float32(value) is rounded to
        float32 and the sums are accumulated in float32."""
        wanted = list(range(n_keys)) if wanted is None else list(wanted)
        if self.lossy:
            v = self.cols[field]["values"].astype(np.float32)
            x = (rw * (v if at is None else v[at])).astype(np.float32)
            if keys is None:
                return [float(np.sum(x, dtype=np.float32))]
            acc = np.zeros(n_keys, np.float32)
            np.add.at(acc, keys, x)
            return acc[wanted].tolist()
        p = self._parts_of(field)
        b, limbs = self._limbs(field, rw)
        f = rw.astype(np.float64)
        bins, n_bins = keys, n_keys
        if "idx" in p:
            idx = p["idx"] if at is None else p["idx"][at]
            n_exp = len(p["exps"])
            bins = idx if keys is None else keys * n_exp + idx
            n_bins = n_keys * n_exp
        got = []
        for limb in limbs:
            x = limb if at is None else limb[at]
            if bins is None:
                got.append(np.array([np.dot(f, x)]))
            else:
                got.append(np.bincount(bins, weights=f * x,
                                       minlength=n_bins))
        if "idx" not in p:
            out = [sum(int(g[k]) << (b * i) for i, g in enumerate(got))
                   for k in wanted]
            if p["base"]:
                n = ([int(rw.sum())] if keys is None else
                     self.counts(keys, rw, n_keys)[wanted].tolist())
                out = [s + c * p["base"] for s, c in zip(out, n)]
            return out
        if not p["exps"]:
            return [0.0 for _ in wanted]
        e0 = p["exps"][0]
        got = [g.reshape(-1, len(p["exps"]))[wanted] for g in got]
        out = []
        for r in range(len(wanted)):
            total = 0
            for i, g in enumerate(got):
                for j in np.flatnonzero(g[r]).tolist():
                    total += int(g[r, j]) << (b * i + p["exps"][j] - e0)
            out.append(_to_f64(total, e0))
        return out

    def mean(self, field: str, s, n: int):
        """The average of n values whose sum is s; None for none."""
        if n == 0:
            return None
        return s / n if self.is_f64(field) else float(Fraction(s) / n)

    # -- metric parts -------------------------------------------------------

    def parts(self, field: str, rw: np.ndarray, names, keys=None,
              n_keys: int = 1, at=None, wanted=None) -> list:
        """The parts `names` of the values of `field` under row weights
        rw, per key as in `sums` (one dict where `keys` is None):
        "count" (the values, by weight), "sum", "min" and "max" (None
        where there is none)."""
        wanted = [0] if keys is None else list(wanted)
        out = [{} for _ in wanted]

        def put(name, vals):
            for o, v in zip(out, vals):
                o[name] = v
        if "count" in names:
            put("count", [int(rw.sum())] if keys is None else
                self.counts(keys, rw, n_keys)[wanted].tolist())
        if "sum" in names:
            put("sum", self.sums(field, rw, keys, n_keys, at, wanted))
        if "min" in names or "max" in names:
            lo, hi = self._extremes(field, rw, keys, n_keys, at, wanted)
            put("min", lo)
            put("max", hi)
        return out

    def _extremes(self, field, rw, keys, n_keys, at, wanted):
        """(least values, greatest values), per key, of the entries with
        rw > 0 (None where a key has none)."""
        v = self.values(field)
        live = rw > 0
        if keys is None:
            x = v[live]
            if not x.size:
                return [None], [None]
            return [self.scalar(field, x.min())], [self.scalar(field,
                                                              x.max())]
        x = (v if at is None else v[at])[live]
        k = keys[live]
        big = (np.inf if v.dtype.kind == "f" else np.iinfo(v.dtype).max)
        lo = np.full(n_keys, big, v.dtype)
        hi = np.full(n_keys, -big if v.dtype.kind == "f" else
                     np.iinfo(v.dtype).min, v.dtype)
        np.minimum.at(lo, k, x)
        np.maximum.at(hi, k, x)
        seen = np.bincount(k, minlength=n_keys) > 0
        return ([self.scalar(field, lo[j]) if seen[j] else None
                 for j in wanted],
                [self.scalar(field, hi[j]) if seen[j] else None
                 for j in wanted])

    def metric(self, args: dict, w: np.ndarray, parts, fruit) -> dict:
        """The fruit of a metric kind (its PARTS and fruit) over
        args["field"] under doc weights w."""
        field = args["field"]
        return fruit(self, field, self.parts(
            field, self.row_weights(field, w), parts)[0])

    def bucket_subaggs(self, subs: dict, field: str, row_keys: np.ndarray,
                       w: np.ndarray, n_keys: int, wanted, occ) -> list:
        """The sub-agg fruits of buckets `wanted` of a bucket agg over
        `field` whose rows fall in bucket row_keys[row] (0 <= key <
        n_keys). Counts, and metric kinds (PARTS) of single-valued
        numeric fields, come from one pass over all buckets; anything
        else per bucket under its occurrence weights w * occ(k)."""
        mods = {name: _module("aggs", kind)
                for name, node in subs.items() for kind in node}
        simple = all(
            kind == "count" or (hasattr(mods[name], "PARTS") and
                                not self.multi(a["field"]))
            for name, node in subs.items() for kind, a in node.items())
        if not simple:
            return [self.sub_aggs(subs, w * occ(k)) for k in wanted]
        doc = self.doc_of_row(field) if self.multi(field) else None
        rw = w if doc is None else w[doc]
        out = [{} for _ in wanted]
        for name, node in subs.items():
            (kind, a), = node.items()
            if kind == "count":
                fr = [{"value": c} for c in self.counts(
                    row_keys, rw, n_keys)[wanted].tolist()]
            else:
                fr = [mods[name].fruit(self, a["field"], p) for p in
                      self.parts(a["field"], rw, mods[name].PARTS, row_keys,
                                 n_keys, doc, wanted)]
            for o, f in zip(out, fr):
                o[name] = f
        return out

    # -- evaluation ---------------------------------------------------------

    def mask(self, node: dict) -> np.ndarray:
        (kind, args), = node.items()
        return _module("queries", kind).mask(self, args)

    def agg(self, node: dict, w: np.ndarray) -> dict:
        (kind, args), = node.items()
        mod = _module("aggs", kind)
        if hasattr(mod, "PARTS"):
            return self.metric(args, w, mod.PARTS, mod.fruit)
        return mod.evaluate(self, args, w)

    def sub_aggs(self, tree: dict, w: np.ndarray) -> dict:
        return {name: self.agg(node, w) for name, node in tree.items()}

    def answer(self, request: dict) -> dict:
        """The final fruit of one request {"query", "aggs"}."""
        w = self.mask(request["query"]).astype(np.int64)
        return self.sub_aggs(request["aggs"], w)
