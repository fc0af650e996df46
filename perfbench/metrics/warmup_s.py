"""Seconds of set-up spent on the first calls of the cell's programs at
its batch sizes (device load, planning, kernel build, graph capture) and
one pass of warm-up through the window's entry point."""


def read(run):
    return run["setup"].get("warmup_s")
