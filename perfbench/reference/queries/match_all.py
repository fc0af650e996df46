"""Every doc."""

import numpy as np


def mask(ref, args):
    return np.ones(ref.n, bool)
