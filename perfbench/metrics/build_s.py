"""Seconds in the port's `tat.load` (index/loader.py: the device index)
and `tat.build` (aggs/compile.py get_program: planning, the columns'
first load, the cube, dense and member operands) spans: the process's
span table, read after the window (one run a process, as run.py runs
it). The cell plans every program in set-up, so these are set-up
seconds."""

from perfbench.lib import spans


def read(run):
    return spans.process_s("tat.load", "tat.build")
