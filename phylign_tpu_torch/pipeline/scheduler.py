"""Resource-aware job scheduler (the Snakemake-semaphore replacement; the
port's own copy of ``phylign_tpu/pipeline/scheduler.py``).

The reference throttles jobs with Snakemake resource counters:
``max_io_heavy_threads``, ``max_ram_mb``, ``max_download_threads``
(the reference's Snakefile:399-407, Makefile:23-29) and retries failed
jobs with exponentially escalated memory
(``mem_mb=lambda wc, attempt: base * 2**attempt``, Snakefile:507,540,573,592).

Here: an in-process thread pool over host-bound work (xz decode, tar
streaming, CIGAR traceback) with
  * a RAM accountant (condition variable over a byte budget),
  * an IO-heavy semaphore,
  * a device lock serializing device submissions (one GPU),
  * per-job retry with doubled RAM reservation.
Priorities mirror the reference's ``priority: 999`` on match jobs
(Snakefile:413): higher runs first.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

log = logging.getLogger("phylign_tpu_torch.sched")


def _is_oom(err: BaseException) -> bool:
    """OOM across allocators: Python/numpy raise MemoryError; torch raises
    torch.cuda.OutOfMemoryError ("CUDA out of memory"); lzma raises
    LZMAError on allocation failure with a memory message. The reference's
    Snakemake restart-with-2x-memory covers *any* failure of an OOM-killed
    job (its Snakefile:507,540,573,592) — matching by message keeps the
    retry as broad without retrying genuine logic errors. The exception
    chain (__cause__/__context__) is walked so an OOM wrapped by pipeline
    code still retries."""
    seen: set[int] = set()
    cur: BaseException | None = err
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, MemoryError):
            return True
        msg = str(cur).upper()
        generic = (
            "OUT OF MEMORY",
            "CANNOT ALLOCATE MEMORY",
            "MEMORY USAGE LIMIT",
            "ALLOCATION FAILURE",
        )
        if any(s in msg for s in generic):
            return True
        cur = cur.__cause__ if cur.__cause__ is not None else cur.__context__
    return False


class RamPool:
    def __init__(self, total_mb: int):
        self.total = total_mb
        self.free = total_mb
        self.cv = threading.Condition()

    def acquire(self, mb: int) -> None:
        mb = min(mb, self.total)  # a single over-sized job may still run alone
        with self.cv:
            while self.free < mb:
                self.cv.wait()
            self.free -= mb

    def release(self, mb: int) -> None:
        mb = min(mb, self.total)
        with self.cv:
            self.free += mb
            self.cv.notify_all()

    def available(self) -> int:
        """Snapshot of the free budget (advisory: another thread may take
        it immediately after; callers use it to AVOID blocking while they
        hold resources only they can release, not as a reservation)."""
        with self.cv:
            return self.free


@dataclass(order=True)
class _QJob:
    neg_priority: int
    seq: int
    job: "Job" = field(compare=False)


@dataclass
class Job:
    name: str
    fn: Callable[[], Any]
    mem_mb: int = 256
    io_heavy: bool = False
    priority: int = 0
    retries: int = 2

    def __repr__(self):
        return f"Job({self.name})"


class Scheduler:
    def __init__(
        self,
        workers: int,
        max_ram_mb: int,
        max_io_heavy: int,
        hbm_mb: int = 12 * 1024,
    ):
        self.workers = max(1, workers)
        self.ram = RamPool(max_ram_mb)
        self.io_sem = threading.Semaphore(max(1, max_io_heavy))
        self.device_lock = threading.Lock()
        # Device-memory accountant: index uploads reserve device bytes
        # BEFORE the upload, so an upload can overlap another batch's
        # scoring without over-committing device memory. The device_lock
        # then only serializes compute submissions.
        self.hbm = RamPool(hbm_mb)

    def run(self, jobs: list[Job]) -> dict[str, Any]:
        """Run all jobs; returns name -> result. Raises the first error after
        letting independent jobs finish (keep-going semantics)."""
        heap: list[_QJob] = []
        counter = itertools.count()
        for j in jobs:
            heapq.heappush(heap, _QJob(-j.priority, next(counter), j))
        results: dict[str, Any] = {}
        errors: list[tuple[str, BaseException]] = []
        lock = threading.Lock()

        def run_one(job: Job):
            attempt = 0
            while True:
                mem = job.mem_mb * (2**attempt)
                self.ram.acquire(mem)
                if job.io_heavy:
                    self.io_sem.acquire()
                try:
                    out = job.fn()
                    with lock:
                        results[job.name] = out
                    return
                except Exception as e:  # noqa: BLE001 - OOM-shaped only, see _is_oom
                    if not _is_oom(e) or attempt >= job.retries:
                        raise
                    attempt += 1
                    log.warning(
                        "job %s OOM (%s), retrying with %d MB",
                        job.name, type(e).__name__, mem * 2,
                    )
                finally:
                    if job.io_heavy:
                        self.io_sem.release()
                    self.ram.release(mem)

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futs = []
            while heap:
                qj = heapq.heappop(heap)
                futs.append((qj.job.name, pool.submit(run_one, qj.job)))
            for name, f in futs:
                try:
                    f.result()
                except BaseException as e:  # noqa: BLE001 - collect, re-raise first
                    errors.append((name, e))
        if errors:
            name, err = errors[0]
            log.error("%d job(s) failed; first: %s", len(errors), name)
            raise err
        return results

