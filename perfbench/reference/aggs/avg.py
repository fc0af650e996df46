"""Mean of an integer field's values: the exact sum over the count, one
rounding to f64; with the sum and the count beside it."""

from fractions import Fraction


def evaluate(ref, args, w):
    field = args["field"]
    if ref.col(field)["type"] == "f64":
        raise NotImplementedError("the reference averages integer fields "
                                  "only")
    rw = ref.row_weights(field, w)
    s = ref.weighted_sum(field, rw)
    n = int(rw.sum())
    return {"value": None if n == 0 else float(Fraction(s) / n),
            "sum": s, "count": n}
