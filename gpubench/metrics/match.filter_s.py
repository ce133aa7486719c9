"""Seconds a match job spends in Pipeline.filter (the global top-n with
ties over every batch's 03_match), the mean over the window's jobs."""


def read(run):
    v = run.per_job("filter")
    return sum(v) / len(v) if v else None
