"""Seconds a match job spends in Pipeline.preprocess (normalising and
merging its read set), the mean over the window's jobs: the benchmark's
span."""


def read(run):
    v = run.per_job("preprocess")
    return sum(v) / len(v) if v else None
