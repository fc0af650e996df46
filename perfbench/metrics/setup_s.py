"""Seconds from process start to the first timed request: imports, the
index built in RAM from the seed, device load, planning, kernel build,
graph capture and warm-up of the cell's own batch sizes."""


def read(run):
    return run["setup"].get("setup_s")
