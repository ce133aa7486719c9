"""Seconds a map job spends in Pipeline.align (assembly decode, minimizer
indexes, anchors, flushes on the device, traceback, 05_map write): the
benchmark's span, the mean over the window's jobs."""


def read(run):
    v = run.per_job("align")
    return sum(v) / len(v) if v else None
