"""Exact rank-interpolated percentiles over the matching values, each
value as often as its doc's weight (semantics.percentile_rank and
semantics.interpolate); None for each percent where nothing matches."""

import numpy as np

from perfbench.reference import semantics

DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)


def evaluate(ref, args, w):
    field = args["field"]
    percents = [float(p) for p in args.get("percents", DEFAULT_PERCENTS)]
    rw = ref.row_weights(field, w)
    m = int(rw.sum())
    if m == 0:
        return {"values": {str(p): None for p in percents}}
    order, vals = ref.sorted_rows(field)
    cum = np.cumsum(rw[order])

    def at(rank):
        return float(ref.scalar(field, vals[np.searchsorted(cum, rank,
                                                            side="right")]))
    out = {}
    for p in percents:
        lo, hi, frac = semantics.percentile_rank(p, m)
        out[str(p)] = semantics.interpolate(at(lo), at(hi), frac)
    return {"values": out}
