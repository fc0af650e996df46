"""Least value of the matching docs; None where there is none."""


def evaluate(ref, args, w):
    field = args["field"]
    v = ref.values(field)[ref.row_weights(field, w) > 0]
    return {"value": None if v.size == 0 else ref.scalar(field, v.min())}
