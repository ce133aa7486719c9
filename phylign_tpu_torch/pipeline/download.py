"""Zenodo batch downloads with retry/backoff + xz integrity checks (the
port's own copy of ``phylign_tpu/pipeline/download.py``).

Mirrors the reference's download layer:
  * URL routing (the reference's Snakefile:195-207): COBS indexes split
    across two Zenodo records at batch name 'eubacterium'; assemblies live in
    record 4602622;
  * retry with linear backoff sleep wait*(attempt-1)
    (Snakefile:210-211, scripts/download.sh:24-29);
  * integrity = size >= 100 kB and a readable LZMA header
    (scripts/test_xz.py:13-27).

Downloads go through urllib; on a host without network access they fail
cleanly, and pre-staged files (or synthetic fixtures) are used instead.
"""

from __future__ import annotations

import logging
import lzma
import os
import threading
import time
import urllib.request
from pathlib import Path

log = logging.getLogger("phylign_tpu_torch.download")

ASM_ZENODO = 4602622
COBS_ZENODO_LOW = 6845083  # batches < 'eubacterium'
COBS_ZENODO_HIGH = 6849657  # batches >= 'eubacterium'
MIN_SIZE_BYTES = 100_000


def cobs_url(batch: str) -> str:
    rec = COBS_ZENODO_HIGH if batch >= "eubacterium" else COBS_ZENODO_LOW
    return f"https://zenodo.org/record/{rec}/files/{batch}.cobs_classic.xz"


def asms_url(batch: str) -> str:
    return f"https://zenodo.org/record/{ASM_ZENODO}/files/{batch}.tar.xz"


def check_xz(path: str | os.PathLike, min_size: int = MIN_SIZE_BYTES) -> None:
    """Raise ValueError unless the file passes the reference's checks."""
    p = Path(path)
    if p.stat().st_size < min_size:
        raise ValueError(f"{p} is too small ({p.stat().st_size} B), likely corrupted")
    try:
        with lzma.open(p) as f:
            f.read(10)
    except lzma.LZMAError as e:
        raise ValueError(f"{p} is not a valid xz archive") from e


def download_file(
    url: str,
    out_path: str | os.PathLike,
    retries: int = 3,
    retry_wait: int = 10,
    min_size: int = MIN_SIZE_BYTES,
) -> Path:
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    last: Exception | None = None
    for attempt in range(1, retries + 2):
        sleep = retry_wait * (attempt - 1)
        if sleep:
            log.warning("retrying %s after %ds backoff", url, sleep)
            time.sleep(sleep)
        tmp = out.with_suffix(out.suffix + ".part")
        try:
            with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
                while chunk := r.read(1 << 20):
                    f.write(chunk)
            check_xz(tmp, min_size)
            tmp.rename(out)
            return out
        except Exception as e:  # noqa: BLE001 - retry any failure
            last = e
            tmp.unlink(missing_ok=True)
            log.warning("download attempt %d for %s failed: %s", attempt, url, e)
    raise RuntimeError(f"download failed after {retries + 1} attempts: {url}") from last


def download_batches(
    batches: list[str],
    download_dir: str | os.PathLike,
    retries: int = 3,
    retry_wait: int = 10,
    only: str = "all",
    max_threads: int = 8,
    skip_existing: bool = True,
) -> dict[str, str]:
    """Fetch many batches' artifacts with bounded parallelism.

    The reference downloads with an N-way semaphore (``max_download_threads``,
    the reference's Snakefile:267-302, Makefile:29); here a thread pool
    of ``max_threads`` workers runs one artifact fetch per task, each with
    the standard per-file retry/backoff. Returns batch -> status
    ('downloaded (<kind>)' or 'already present'). Raises the first failure
    after letting in-flight fetches finish (keep-going semantics)."""
    from concurrent.futures import ThreadPoolExecutor

    d = Path(download_dir)
    todo: list[tuple[str, str, str, Path]] = []  # (batch, kind, url, out)
    status: dict[str, str] = {}
    for batch in batches:
        kinds = []
        if only in ("all", "cobs"):
            out = d / "cobs" / f"{batch}.cobs_classic.xz"
            if not (skip_existing and out.exists()):
                kinds.append(("cobs", cobs_url(batch), out))
        if only in ("all", "asms"):
            out = d / "asms" / f"{batch}.tar.xz"
            if not (skip_existing and out.exists()):
                kinds.append(("asms", asms_url(batch), out))
        if not kinds:
            status[batch] = "already present"
            continue
        status[batch] = "downloaded (%s)" % "+".join(k for k, _, _ in kinds)
        todo.extend((batch, k, url, out) for k, url, out in kinds)

    errors: list[tuple[str, Exception]] = []
    lock_err = threading.Lock()

    def fetch(task):
        batch, kind, url, out = task
        try:
            download_file(url, out, retries, retry_wait)
        except Exception as e:  # noqa: BLE001 - keep going, collect
            with lock_err:
                errors.append((f"{batch}:{kind}", e))

    with ThreadPoolExecutor(max_workers=max(1, max_threads)) as ex:
        list(ex.map(fetch, todo))
    if errors:
        name, err = errors[0]
        raise RuntimeError(
            f"{len(errors)} download(s) failed; first: {name}: {err}"
        ) from err
    return status


def download_batch(
    batch: str,
    download_dir: str | os.PathLike,
    retries: int = 3,
    retry_wait: int = 10,
    only: str = "all",
) -> tuple[Path | None, Path | None]:
    """Fetch one batch's artifacts; ``only`` in {all, cobs, asms} mirrors the
    reference's download / download_cobs / download_asms targets
    (the reference's Makefile:84-91)."""
    d = Path(download_dir)
    cobs = asms = None
    if only in ("all", "cobs"):
        cobs = download_file(
            cobs_url(batch), d / "cobs" / f"{batch}.cobs_classic.xz", retries, retry_wait
        )
    if only in ("all", "asms"):
        asms = download_file(
            asms_url(batch), d / "asms" / f"{batch}.tar.xz", retries, retry_wait
        )
    return cobs, asms
