"""must: all of; should: any of (where there is no must); must_not: none
of."""

import numpy as np


def mask(ref, args):
    m = np.ones(ref.n, bool)
    for c in args.get("must", []):
        m &= ref.mask(c)
    if args.get("should") and not args.get("must"):
        s = np.zeros(ref.n, bool)
        for c in args["should"]:
            s |= ref.mask(c)
        m &= s
    for c in args.get("must_not", []):
        m &= ~ref.mask(c)
    return m
