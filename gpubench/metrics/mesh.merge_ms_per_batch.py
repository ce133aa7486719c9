"""Milliseconds a batch of the mesh's window merge (B5d, merge_topk_kernel
in csrc/match_epilogue.cu), by kernel name from the profiler, over the
batches the window's jobs searched."""


def read(run):
    n = len(run.jobs) * len(run.pool.batches)
    if run.trace is None or not n:
        return None
    s = run.trace.seconds(r"\bmerge_topk_kernel\b")
    return s * 1e3 / n if s > 0 else None
