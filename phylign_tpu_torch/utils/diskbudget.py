"""Shared LRU disk budget for the persistent on-disk caches.

Two caches can grow with the database scale: the device-format index cache
(``02_cobs_decompressed/{batch}/``, io.cobs.save_device_index) and the
decoded-genome assembly cache (``02_asms_decoded/{stem}.{json,codes}``,
io.asmtar.open_asm_cache). The reference documents an explicit ~120 GB
disk contract for a full-database run (ref: README.md:95-96)
and marks its decompressed-index cache opt-in (config.yaml:131-138); this
module is the analogue for the TPU build: a single byte budget across both
caches, evicting least-recently-*used* batch entries first.

Recency comes from the entry's metadata-file mtime, which the cache open
paths touch on every hit. Eviction of an entry another thread has open is
safe on POSIX (unlinked files stay readable through existing mmaps/fds);
the open paths tolerate a concurrent eviction by rebuilding.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Iterable, NamedTuple

log = logging.getLogger("phylign_tpu_torch.diskbudget")


class CacheEntry(NamedTuple):
    stamp: int  # mtime_ns of the metadata file (touched on access)
    size: int  # total bytes
    paths: tuple[Path, ...]  # unlink targets (files) / rmtree target (dir)


def _dir_size(d: Path) -> int:
    total = 0
    for root, _, files in os.walk(d):
        for f in files:
            try:
                total += os.stat(os.path.join(root, f)).st_size
            except OSError:
                pass
    return total


def scan_entries(dirs: Iterable[Path]) -> list[CacheEntry]:
    """Group cache files under ``dirs`` into per-batch LRU entries.

    Recognized shapes (anything else is left alone):
      * subdirectory with a ``meta.json`` -> one device-index entry;
      * ``{stem}.json`` + ``{stem}.codes`` file pair -> one asm entry.
    In-progress builds (``*.tmp*`` names) are invisible until their atomic
    rename, so scanning never counts or deletes half-built entries.
    """
    entries: list[CacheEntry] = []
    for d in dirs:
        d = Path(d)
        if not d.is_dir():
            continue
        for child in d.iterdir():
            try:
                if child.is_dir():
                    meta = child / "meta.json"
                    if meta.is_file():
                        entries.append(
                            CacheEntry(
                                meta.stat().st_mtime_ns,
                                _dir_size(child),
                                (child,),
                            )
                        )
                elif child.suffix == ".json" and ".tmp" not in child.name:
                    codes = child.with_suffix(".codes")
                    if codes.is_file():
                        entries.append(
                            CacheEntry(
                                child.stat().st_mtime_ns,
                                child.stat().st_size + codes.stat().st_size,
                                (child, codes),
                            )
                        )
            except OSError:
                continue  # concurrently evicted/renamed
    return entries


def enforce_budget(dirs: Iterable[Path], max_bytes: int) -> int:
    """Evict least-recently-used cache entries until total <= max_bytes.

    Returns bytes evicted. The newest entry is evicted last, so a budget
    smaller than one entry degrades to rebuild-per-run rather than
    breaking the run."""
    import shutil

    entries = scan_entries(dirs)
    total = sum(e.size for e in entries)
    if total <= max_bytes:
        return 0
    evicted = 0
    for e in sorted(entries, key=lambda e: e.stamp):
        if total <= max_bytes:
            break
        gone = True
        for p in e.paths:
            try:
                if p.is_dir():
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    p.unlink(missing_ok=True)
            except OSError:
                pass
            if p.exists():  # deletion silently failed (perms, NFS, ...)
                gone = False
        if not gone:
            # do NOT count undeletable bytes as freed — otherwise the
            # budget reports success while the disk stays over it
            log.warning(
                "disk budget: could not evict %s; budget may be exceeded",
                e.paths[0],
            )
            continue
        total -= e.size
        evicted += e.size
        log.info(
            "disk budget: evicted cache entry %s (%.1f MB)",
            e.paths[0].name, e.size / 1e6,
        )
    return evicted
