"""Seconds in which the card ran anything during the traced window
(torch.profiler, the union of its records), per request answered, ms."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"] or not run["answered"]:
        return None
    return tr["busy_s"] * 1e3 / run["answered"]
