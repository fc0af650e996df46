"""Columns of the `nyc_taxis` deployment (Rally's nyc_taxis track: the NYC
TLC's 2015 yellow-cab trips), drawn from a seed in the neutral form of
perfbench/data/ (see bench_columns.py).

Only the three fields that the track's aggregation operations read are
drawn. The track maps the money and distance fields as `scaled_float`
with a scaling factor of 100, which Elasticsearch stores as a long and
reads back as long / 100.0: each f64 value here is a whole number of
cents (of a dollar or of a mile) divided by 100.0. Dates are whole
seconds (the track's format is `yyyy-MM-dd HH:mm:ss`) in microseconds.

The distributions are assumed (the configuration file says why); their
parameters come from the configuration's "params":

  trip_distance    lognormal in cents of a mile around `distance_median`
                   miles (log-sd `distance_sigma`); a share
                   `distance_zero_share` exactly 0; a share
                   `distance_tail_share` log-uniform over (50, 500]
                   miles; and impossible odometer readings,
                   `distance_far_share` of the trips but at least one,
                   log-uniform over `distance_far_miles`. Nothing is
                   clipped.
  total_amount     lognormal in cents around `amount_median` dollars
                   (log-sd `amount_sigma`); a share `amount_large_share`
                   log-uniform over `amount_large_dollars`; a share
                   `amount_refund_share` negated.
  dropoff_datetime uniform over 2015 in whole seconds; a share
                   `date_garbage_share` uniform over `garbage_years`
                   outside 2015.
"""

import numpy as np

#: 2015-01-01T00:00:00Z and 2016-01-01T00:00:00Z, seconds
Y2015, Y2016 = 1_420_070_400, 1_451_606_400


def _log_uniform(rng, lo, hi, k):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), k))


def _year_start(y: int) -> int:
    """Seconds of y-01-01T00:00:00Z."""
    return int(np.datetime64(f"{y}-01-01", "s").astype(np.int64))


def columns(n_docs: int, seed: int, params: dict) -> dict:
    p = params
    rng = np.random.default_rng(seed)
    n = n_docs

    cents = np.rint(rng.lognormal(np.log(100 * p["distance_median"]),
                                  p["distance_sigma"], n))
    u = rng.random(n)
    cents[u < p["distance_zero_share"]] = 0
    tail = u > 1 - p["distance_tail_share"]
    cents[tail] = np.rint(_log_uniform(rng, 5001, 50_000, int(tail.sum())))
    k_far = max(1, int(rng.binomial(n, p["distance_far_share"])))
    lo, hi = p["distance_far_miles"]
    cents[rng.integers(0, n, k_far)] = np.rint(
        _log_uniform(rng, 100 * lo, 100 * hi, k_far))
    trip_distance = cents / 100.0

    cents = np.rint(rng.lognormal(np.log(100 * p["amount_median"]),
                                  p["amount_sigma"], n))
    u = rng.random(n)
    large = u < p["amount_large_share"]
    lo, hi = p["amount_large_dollars"]
    cents[large] = np.rint(_log_uniform(rng, 100 * lo, 100 * hi,
                                        int(large.sum())))
    cents[u > 1 - p["amount_refund_share"]] *= -1
    total_amount = cents / 100.0

    secs = rng.integers(Y2015, Y2016, n)
    garbage = rng.random(n) < p["date_garbage_share"]
    g0, g1 = (_year_start(y) for y in p["garbage_years"])
    g = rng.integers(g0, g1 - (Y2016 - Y2015), int(garbage.sum()))
    secs[garbage] = np.where(g >= Y2015, g + (Y2016 - Y2015), g)
    dropoff = secs.astype(np.uint64) * np.uint64(1_000_000)

    return {"trip_distance": {"type": "f64", "values": trip_distance},
            "total_amount": {"type": "f64", "values": total_amount},
            "dropoff_datetime": {"type": "date", "values": dropoff}}
