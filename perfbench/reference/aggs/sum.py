"""Exact sum of an integer field's values (every value of a multi-valued
one), each as often as its doc's weight."""


def evaluate(ref, args, w):
    field = args["field"]
    if ref.col(field)["type"] == "f64":
        raise NotImplementedError("the reference sums integer fields only")
    return {"value": ref.weighted_sum(field, ref.row_weights(field, w))}
