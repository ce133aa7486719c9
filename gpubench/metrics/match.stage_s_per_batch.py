"""Seconds of Pipeline.match a batch (index load, upload, kernels, fetch,
host assembly, 03_match write): the benchmark's span over a job, divided by
its batches, the mean over the window's jobs."""


def read(run):
    v = run.per_job("match")
    return sum(v) / len(v) / len(run.pool.batches) if v else None
