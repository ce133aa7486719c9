"""Milliseconds of host-to-device copies a batch (the index upload of
models/matcher.upload_words, and the query hashes): the profiler's Memcpy
HtoD operations over the window, divided by the batches the window's jobs
searched."""


def read(run):
    n = len(run.jobs) * len(run.pool.batches)
    if run.trace is None or not n:
        return None
    s = run.trace.seconds(r"Memcpy HtoD", cats=("gpu_memcpy",))
    return s * 1e3 / n if s > 0 else None
