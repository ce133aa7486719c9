"""Milliseconds a map job of the flush epilogue's kernels (B6:
chain_select, select_window, finish_pack, compact_cold in
csrc/flush_epilogue.cu), by kernel name from the profiler."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    s = run.trace.seconds(r"\b(chain_select|chain_select_warp|select_window|finish_pack|compact_cold)_kernel\b")
    return s * 1e3 / len(run.jobs) if s > 0 else None
