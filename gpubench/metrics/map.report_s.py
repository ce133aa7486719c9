"""Seconds a map job spends in Pipeline.aggregate and Pipeline.stats
(io/sam, io/stats), the mean over the window's jobs."""


def read(run):
    a, s = run.per_job("aggregate"), run.per_job("stats")
    return (sum(a) + sum(s)) / len(a) if a else None
