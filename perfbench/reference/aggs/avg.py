"""Mean of a numeric field's values, with the exact sum and the count
beside it: for an integer field the exact sum over the count, rounded
once to f64; for an f64 field the rounded sum over the count in f64;
None where there is no value."""

PARTS = ("count", "sum")


def fruit(ref, field, p):
    return {"value": ref.mean(field, p["sum"], p["count"]),
            "sum": p["sum"], "count": p["count"]}
