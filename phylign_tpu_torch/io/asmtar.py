"""Assembly batch tarballs: streaming reader (and writer for fixtures); the
port's own copy of ``phylign_tpu/io/asmtar.py``.

The reference downloads per-batch ``asms/{batch}.tar.xz`` archives of
per-genome FASTA files and streams candidate members out of the tar
(ref: scripts/batch_align.py:93-123 iterate_over_batch;
Snakefile:204-207). The genome name is the member filename
stem; SAM rnames come from the contig headers inside each FASTA (golden
output shows e.g. 'SAMEA1410911.contig00015').
"""

from __future__ import annotations

import io
import os
import tarfile
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from phylign_tpu_torch.io.fastx import read_fastx
from phylign_tpu_torch.kmer import encode_seq


def iter_batch_assemblies(
    tar_path: str | os.PathLike, selected: set[str] | None = None
) -> Iterator[tuple[str, list[tuple[str, np.ndarray]]]]:
    """Yield (genome_name, [(contig_name, codes uint8)]) for tar members.

    ``selected`` restricts extraction to those genome names (the candidate
    set), skipping tar members without hits — the reference's key IO
    optimization (batch_align.py:93-123).
    """
    with tarfile.open(str(tar_path), mode="r:xz") as tar:
        for member in tar:
            if not member.isfile():
                continue
            rname = Path(member.name).stem
            if selected is not None and rname not in selected:
                continue
            f = tar.extractfile(member)
            if f is None:
                continue
            text = io.TextIOWrapper(f)
            contigs = [
                (rec.name, encode_seq(rec.seq.encode()))
                for rec in read_fastx(text)
            ]
            yield rname, contigs


class AsmCache:
    """Decoded-genome disk cache for one batch tar.

    One sequential tar.xz pass writes every genome's 2-bit-coded contigs
    (uint8 codes 0..3) into a single blob + a contig table; later align
    runs mmap the blob and touch ONLY candidate genomes' bytes. This is
    the assembly analogue of the reference's decompressed-index cache
    (config.yaml:131-138): the reference re-streams the whole tar.xz per
    run (batch_align.py:93-123) because CPU minimap2 wants FASTA text —
    decoded codes ARE this build's native genome format, so the cache
    also skips re-parsing and re-encoding."""

    def __init__(self, blob: np.ndarray, genomes: list, order: list[str]):
        self._blob = blob  # uint8 mmap
        self._genomes = dict(genomes)  # rname -> [(cname, off, length)]
        self._order = order  # tar member order (record-order contract)

    def iter_selected(
        self, selected: set[str] | None = None
    ) -> Iterator[tuple[str, list[tuple[str, np.ndarray]]]]:
        """iter_batch_assemblies-compatible iteration from the cache."""
        for rname in self._order:
            if selected is not None and rname not in selected:
                continue
            yield rname, [
                (cname, self._blob[off : off + ln])
                for cname, off, ln in self._genomes[rname]
            ]


def _tar_sig(tar_path: Path) -> list[int]:
    st = tar_path.stat()
    return [st.st_mtime_ns, st.st_size]


def open_asm_cache(
    tar_path: str | os.PathLike, cache_dir: str | os.PathLike
) -> AsmCache:
    """Open (building on first use) the decoded-genome cache for a tar."""
    import json

    tar_path = Path(tar_path)
    cache_dir = Path(cache_dir)
    stem = tar_path.name.split(".")[0]
    meta_p = cache_dir / f"{stem}.json"
    bin_p = cache_dir / f"{stem}.codes"
    sig = _tar_sig(tar_path)
    if meta_p.exists() and bin_p.exists():
        try:
            meta = json.loads(meta_p.read_text())
        except ValueError:
            meta = None
        if meta and meta.get("tar_sig") == sig:
            try:
                # a batch whose decoded blob is empty leaves a 0-byte
                # .codes file, which np.memmap refuses to map — mirror the
                # build path's `if off` guard so re-runs don't crash on it
                blob = (
                    np.memmap(bin_p, dtype=np.uint8, mode="r")
                    if bin_p.stat().st_size
                    else np.zeros(0, np.uint8)
                )
                os.utime(meta_p)  # LRU stamp for utils.diskbudget (inside
                # the guard: a concurrent eviction between the map and the
                # stamp must fall through to rebuild, not crash)
            except OSError:
                pass
            else:
                return AsmCache(blob, meta["genomes"], meta["order"])
    cache_dir.mkdir(parents=True, exist_ok=True)
    order: list[str] = []
    genomes: list[tuple[str, list]] = []
    off = 0
    # pid-unique tmp names: concurrent processes (multi-rank runs) may race
    # to build the same batch's cache; each builds privately and the atomic
    # renames make last-writer-wins safe
    tmp_bin = bin_p.with_suffix(f".codes.tmp{os.getpid()}")
    with open(tmp_bin, "wb") as out:
        for rname, contigs in iter_batch_assemblies(tar_path):
            order.append(rname)
            table = []
            for cname, codes in contigs:
                out.write(codes.tobytes())
                table.append((cname, off, int(codes.shape[0])))
                off += int(codes.shape[0])
            genomes.append((rname, table))
    tmp_meta = meta_p.with_suffix(f".json.tmp{os.getpid()}")
    tmp_meta.write_text(
        json.dumps({"tar_sig": sig, "order": order, "genomes": genomes})
    )
    os.replace(tmp_bin, bin_p)  # blob first: meta presence implies blob
    os.replace(tmp_meta, meta_p)
    blob = (
        np.memmap(bin_p, dtype=np.uint8, mode="r")
        if off
        else np.zeros(0, np.uint8)
    )
    return AsmCache(blob, genomes, order)


def iter_assemblies_cached(
    tar_path: str | os.PathLike,
    selected: set[str] | None = None,
    cache_dir: str | os.PathLike | None = None,
) -> Iterator[tuple[str, list[tuple[str, np.ndarray]]]]:
    """iter_batch_assemblies, served from the decoded cache when enabled."""
    if cache_dir is None:
        yield from iter_batch_assemblies(tar_path, selected)
        return
    yield from open_asm_cache(tar_path, cache_dir).iter_selected(selected)


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
