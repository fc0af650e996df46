"""Sum of a numeric field's values (every value of a multi-valued one),
each as often as its doc's weight: exact, a Python int for an integer
field, rounded once to the nearest f64 for an f64 field."""

PARTS = ("sum",)


def fruit(ref, field, p):
    return {"value": p["sum"]}
