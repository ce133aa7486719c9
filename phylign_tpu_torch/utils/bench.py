"""Per-stage benchmark logging: the port's copy of
``phylign_tpu.utils.bench`` (``RamSampler`` and ``benchmark``), with the same TSV rows under
logs/benchmarks/{rule}/{wildcards}.txt (the reference's GNU-time contract,
scripts/benchmark.py:17-46), except that
the per-process I/O counters are optional. ``psutil.Process().io_counters()``
raises ValueError on kernels whose /proc/<pid>/io lacks the ``rchar`` field
(seen in sandboxed Linux hosts); the JAX package's version then fails the
stage it times. Here the FS_inputs/FS_outputs columns read 0 instead.
"""

from __future__ import annotations

import datetime
import os
import resource
import time
from contextlib import contextmanager
from pathlib import Path

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

HEADER = "real(s)\tsys(s)\tuser(s)\tpercent_CPU\tmax_RAM(kb)\tFS_inputs\tFS_outputs\twall_clock"


class RamSampler:
    """Whole-run system-RAM delta sampler (the reference's psutil poller,
    scripts/get_RAM_usage.py:10-22 + benchmark.py:49-74): samples used system
    memory at ``interval`` seconds and reports max delta from the start."""

    def __init__(self, interval: float = 0.1):
        self.interval = interval
        self._stop = None
        self._thread = None
        self.baseline_kb = 0
        self.max_delta_kb = 0

    def __enter__(self):
        if psutil is None:
            return self
        import threading

        self.baseline_kb = psutil.virtual_memory().used // 1024
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(self.interval):
                used = psutil.virtual_memory().used // 1024
                self.max_delta_kb = max(self.max_delta_kb, used - self.baseline_kb)

        self._thread = threading.Thread(target=poll, daemon=True, name="ram-sampler")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._stop is not None:
            self._stop.set()
            self._thread.join(timeout=2)
        return False


def _io_counts() -> tuple[int, int] | None:
    if psutil is None:
        return None
    try:
        c = psutil.Process().io_counters()
    except (AttributeError, ValueError, OSError, NotImplementedError):
        return None
    return c.read_count, c.write_count


@contextmanager
def benchmark(logs_dir: str | os.PathLike, rule: str, wildcards: str):
    """Context manager timing one pipeline unit; appends a TSV row to
    logs/benchmarks/{rule}/{wildcards}.txt."""
    out = Path(logs_dir) / "benchmarks" / rule
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{wildcards}.txt"

    r0 = resource.getrusage(resource.RUSAGE_SELF)
    io0 = _io_counts()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        sys_s = r1.ru_stime - r0.ru_stime
        user_s = r1.ru_utime - r0.ru_utime
        pct = int(100 * (sys_s + user_s) / dt) if dt > 0 else 0
        max_rss_kb = r1.ru_maxrss  # linux: kb
        io1 = _io_counts() if io0 is not None else None
        fs_in, fs_out = (
            (io1[0] - io0[0], io1[1] - io0[1]) if io1 is not None else (0, 0)
        )
        wall = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        new = not path.exists()
        with open(path, "a") as f:
            if new:
                f.write(HEADER + "\n")
            f.write(
                f"{dt:.2f}\t{sys_s:.2f}\t{user_s:.2f}\t{pct}%\t{max_rss_kb}\t{fs_in}\t{fs_out}\t{wall}\n"
            )
