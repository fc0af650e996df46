"""Docs holding the exact value (any position of a multi-valued field)."""

import numpy as np


def mask(ref, args):
    field, value = args["field"], args["value"]
    c = ref.col(field)
    if "codes" in c:
        code = ref.code_of(field, value)
        if code is None:
            return np.zeros(ref.n, bool)
        hit = c["codes"] == code
    else:
        hit = c["values"] == c["values"].dtype.type(value)
    return ref.rows_to_docs(field, hit)
