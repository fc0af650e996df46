"""Docs holding a value in [lower, upper] (each end inclusive or not, as
the args say; include_lower defaults to True, include_upper to False) of
a numeric field, any position of a multi-valued one. Integer fields take
integer bounds."""

import numpy as np


def mask(ref, args):
    field = args["field"]
    c = ref.col(field)
    v = c["values"]
    hit = np.ones(v.shape, bool)
    lower, upper = args.get("lower"), args.get("upper")
    if c["type"] != "f64":
        for b in (lower, upper):
            if b is not None and int(b) != b:
                raise NotImplementedError("fractional bounds on integer "
                                          "ranges are out")
    if lower is not None:
        lb = v.dtype.type(lower)
        hit &= (v >= lb) if args.get("include_lower", True) else (v > lb)
    if upper is not None:
        ub = v.dtype.type(upper)
        hit &= (v <= ub) if args.get("include_upper", False) else (v < ub)
    return ref.rows_to_docs(field, hit)
