"""Milliseconds a map job of host-to-device and device-to-host copies (the
flushes' dispatch and fetch: engine._fused_dispatch, _fused_finish): the
profiler's Memcpy HtoD and DtoH operations over the window's jobs."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    s = run.trace.seconds(r"Memcpy (HtoD|DtoH)", cats=("gpu_memcpy",))
    return s * 1e3 / len(run.jobs) if s > 0 else None
