"""Assembly batch tarballs: the writer the synthetic fixtures use (the
port's own copy of ``write_batch_tar`` from ``phylign_tpu/io/asmtar.py``;
the align stage's readers are not ported yet). One FASTA member per genome,
named by the genome; SAM rnames come from the contig headers inside.
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Iterable


def write_batch_tar(
    tar_path: str | os.PathLike,
    genomes: Iterable[tuple[str, list[tuple[str, bytes]]]],
) -> None:
    """Write a synthetic ``{batch}.tar.xz``: one FASTA member per genome."""
    with tarfile.open(str(tar_path), mode="w:xz", preset=1) as tar:
        for rname, contigs in genomes:
            buf = io.BytesIO()
            for cname, seq in contigs:
                buf.write(b">" + cname.encode() + b"\n" + seq + b"\n")
            data = buf.getvalue()
            info = tarfile.TarInfo(name=f"{rname}.fa")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
