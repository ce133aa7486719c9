"""Milliseconds a map job of the chain kernel (B3, csrc/chain_scan.cu), by
kernel name from the profiler."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    s = run.trace.seconds(r"\bchain_scan_kernel\b")
    return s * 1e3 / len(run.jobs) if s > 0 else None
