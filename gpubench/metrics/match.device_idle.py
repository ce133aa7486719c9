"""The device's idle share of the traced window (%): 1 - the union of the
profiler's device operations (kernels, copies, sets) over the window."""

from gpubench.trace import idle_percent


def read(run):
    return idle_percent(run.trace)
