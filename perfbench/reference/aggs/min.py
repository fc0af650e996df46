"""Least value of the matching docs; None where there is none."""

PARTS = ("min",)


def fruit(ref, field, p):
    return {"value": p["min"]}
