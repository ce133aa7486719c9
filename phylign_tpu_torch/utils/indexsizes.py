"""Decompressed-index size scanner (the port's own copy of
``phylign_tpu/utils/indexsizes.py``).

Regenerates ``data/decompressed_indexes_sizes.txt`` from local
``cobs/*.cobs_classic.xz`` files (the reference's one-off
scripts/get_decompressed_indexes_sizes.sh, which drives RAM-aware
scheduling via Snakefile:41-82; consumed here by Pipeline._index_mem_mb).

Uses ``xz --robot --list`` when the binary is available (reads the xz index
block, no decompression); falls back to streaming decompression-and-count.
"""

from __future__ import annotations

import lzma
import os
import shutil
import subprocess
from pathlib import Path


def xz_decompressed_size(path: str | os.PathLike) -> tuple[int, int]:
    """(uncompressed_bytes, decoder_memory_bytes) of one .xz file."""
    p = str(path)
    if shutil.which("xz"):
        out = subprocess.run(
            ["xz", "--robot", "--list", "-vv", p],
            check=True,
            capture_output=True,
            text=True,
        ).stdout
        for line in out.splitlines():
            f = line.split("\t")
            if f and f[0] == "totals":
                # xz robot totals row: [totals, streams, blocks, compressed,
                # uncompressed, ratio, checks, padding, files, ...,
                # memory-to-decompress (with -vv)]
                uncompressed = int(f[4])
                mem = int(f[10]) if len(f) > 10 and f[10].isdigit() else 0
                return uncompressed, mem
    # fallback: stream and count
    total = 0
    with lzma.open(p, "rb") as fh:
        while chunk := fh.read(1 << 22):
            total += len(chunk)
    return total, 0


def scan_index_sizes(
    cobs_dir: str | os.PathLike, out_path: str | os.PathLike
) -> int:
    """Write the sizes table for every cobs/*.cobs_classic.xz; returns count.
    Row format matches the reference: 'cobs/NAME  bytes  decode_ram_bytes'."""
    cobs_dir = Path(cobs_dir)
    rows = []
    for p in sorted(cobs_dir.glob("*.cobs_classic.xz")):
        size, mem = xz_decompressed_size(p)
        rows.append(f"cobs/{p.name}  {size}  {mem}")
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(r + "\n" for r in rows))
    return len(rows)
