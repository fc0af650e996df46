"""Test-only columns of f64 and signed fields, drawn from a seed, in the
neutral form of perfbench/data/ (the tests copy this file there):

  dist    f64, cents-rounded lognormal (a trip distance), 3% whole
          numbers, on the bounds of an interval-1 histogram;
  amount  f64, cents-rounded lognormal (a fare total), 4% negated, 1%
          -0.0 and 1% 0.0;
  tick    f64 on and beside the bounds of an interval-0.1 histogram:
          k / 10, k * 0.1 (which differs from k / 10 for some k), the
          f64 just below and just above k / 10, and -0.0;
  wide    f64, multi-valued (0-3 values a doc), signed 53-bit mantissas
          times 2**e for e in [-60, 60], 2% -0.0;
  fares   f64, multi-valued (0-3 values a doc), cents-rounded lognormal,
          5% negated;
  delta   i64, uniform in [-5000, 5000).
"""

import numpy as np


def _offsets(rng, n_docs):
    offsets = np.zeros(n_docs + 1, dtype=np.uint32)
    np.cumsum(rng.integers(0, 4, n_docs), out=offsets[1:])
    return offsets


def columns(n_docs: int, seed: int, params: dict) -> dict:
    rng = np.random.default_rng(seed)
    n = n_docs
    dist = np.round(rng.lognormal(0.8, 0.9, n), 2)
    whole = rng.random(n) < 0.03
    dist[whole] = rng.integers(0, 60, int(whole.sum()))
    amount = np.round(rng.lognormal(2.6, 0.7, n), 2)
    u = rng.random(n)
    amount[u < 0.04] *= -1
    amount[(u >= 0.04) & (u < 0.05)] = -0.0
    amount[(u >= 0.05) & (u < 0.06)] = 0.0
    k = rng.integers(-100, 400, n)
    tick = np.choose(rng.integers(0, 5, n), [
        k / 10, k * 0.1, np.nextafter(k / 10, -np.inf),
        np.nextafter(k / 10, np.inf), np.full(n, -0.0)])
    w_offs = _offsets(rng, n)
    m = int(w_offs[-1])
    wide = (rng.integers(-(1 << 53) + 1, 1 << 53, m).astype(np.float64)
            * np.exp2(rng.integers(-60, 61, m).astype(np.float64)))
    wide[rng.random(m) < 0.02] = -0.0
    f_offs = _offsets(rng, n)
    m = int(f_offs[-1])
    fares = np.round(rng.lognormal(2.0, 0.8, m), 2)
    fares[rng.random(m) < 0.05] *= -1
    delta = rng.integers(-5000, 5000, n, dtype=np.int64)
    return {"dist": {"type": "f64", "values": dist},
            "amount": {"type": "f64", "values": amount},
            "tick": {"type": "f64", "values": tick},
            "wide": {"type": "f64", "offsets": w_offs, "values": wide},
            "fares": {"type": "f64", "offsets": f_offs, "values": fares},
            "delta": {"type": "i64", "values": delta}}
