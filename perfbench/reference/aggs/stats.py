"""count, sum, min, max and avg of a numeric field's values, as sum.py,
min.py, max.py and avg.py give them; min, max and avg None where there
is no value."""

PARTS = ("count", "sum", "min", "max")


def fruit(ref, field, p):
    return {"count": p["count"], "sum": p["sum"], "min": p["min"],
            "max": p["max"], "avg": ref.mean(field, p["sum"], p["count"])}
