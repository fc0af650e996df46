"""Seconds of set-up spent drawing the columns from the seed and building
the index in RAM: the benchmark's timer around the generator and the
port's writer."""


def read(run):
    return run["setup"].get("index_s")
