"""Seconds in the port's `tat.capture` span (aggs/compile.py
_StepGraph: the eager warm-up call and the CUDA graph capture of a step
at a new batch size): the process's span table, read after the window
(one run a process, as run.py runs it). The cell captures its graphs in
set-up; a graph dropped and captured again in the window would add its
seconds. None on the CPU, which captures nothing."""

from perfbench.lib import spans


def read(run):
    return spans.process_s("tat.capture")
