"""Greatest value of the matching docs; None where there is none."""

PARTS = ("max",)


def fruit(ref, field, p):
    return {"value": p["max"]}
