"""Semantics helpers of the reference: frozen copies, at commit
3b8b2ac20aec56d4702b01e08d1cd415c047bb37, of
`tantivy_aggregations_tpu_torch/utils/exact.py::percentile_rank` and
`::interpolate` and of `utils/mono.py::f64_to_mono`. They define the
answers (exact rank split, the one f64 rounding of a percentile, the
total order of f64 values); the reference does not import them from the
port, so that a change there shows as a mismatch here.
"""

from fractions import Fraction

import numpy as np

_SIGN = np.uint64(0x8000000000000000)


def percentile_rank(p: float, m: int):
    """(lo, hi, frac) for percentile p over m sorted values: rank =
    (p / 100) * (m - 1) evaluated exactly (p as its IEEE rational); the
    answer is v[lo] + (v[hi] - v[lo]) * frac, frac the correctly rounded
    f64 of the exact fractional part."""
    if m <= 0:
        raise ValueError("no values")
    pi = int(p)
    if pi == p:
        num = pi * (m - 1)
        lo = max(0, min(num // 100, m - 1))
        hi = min(lo + 1, m - 1)
        return lo, hi, (num - 100 * lo) / 100
    r = Fraction(p) * (m - 1) / 100
    lo = max(0, min(int(r // 1), m - 1))
    hi = min(lo + 1, m - 1)
    return lo, hi, float(r - lo)


def interpolate(v_lo: float, v_hi: float, frac: float) -> float:
    return v_lo + (v_hi - v_lo) * frac


def f64_to_mono(v: np.ndarray) -> np.ndarray:
    """f64 -> order-preserving int64 (IEEE total order, NaN rejected)."""
    v = np.asarray(v, dtype=np.float64)
    if np.isnan(v).any():
        raise ValueError("NaN not allowed in f64 fast fields")
    bits = v.view(np.uint64)
    neg = (bits & _SIGN) != 0
    return np.where(neg, ~bits ^ _SIGN, bits).view(np.int64)
