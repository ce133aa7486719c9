"""Milliseconds a batch of copies between the cards: the profiler's
Memcpy PtoP operations (and DtoD, where a copy between cards is traced so)
over the window, divided by the batches the window's jobs searched. On the
doc-sharded mesh they are the gather of each shard's top-k window to the
home card."""


def read(run):
    n = len(run.jobs) * len(run.pool.batches)
    if run.trace is None or not n:
        return None
    s = run.trace.seconds(r"Memcpy (PtoP|DtoD)", cats=("gpu_memcpy",))
    return s * 1e3 / n if s > 0 else None
