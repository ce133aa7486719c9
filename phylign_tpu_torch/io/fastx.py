"""FASTA/FASTQ streaming IO and query normalization.

Behavioral contracts mirrored from the reference pipeline:
  * record parsing semantics equivalent to lh3/readfq as used throughout the
    reference scripts (scripts/batch_align.py:41-90): FASTA
    records may be multi-line; FASTQ quality may be multi-line; the header
    comment (text after the first space) is preserved separately.
  * query preprocessing (Snakefile:314-333): convert to
    single-line FASTA, uppercase, drop comments, map non-ACGT bases to 'A'.
  * query merging (Snakefile:336-352): concatenation of the
    per-file normalized FASTAs; the merged stem is the '___'-join of the
    sorted input stems (Snakefile:37-38).

Supports transparent gzip and xz input by suffix, like xopen does for the
reference scripts.
"""

from __future__ import annotations

import gzip
import io
import lzma
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Sequence

from phylign_tpu_torch.kmer import normalize_seq

FASTX_SUFFIXES = ("fa", "fasta", "fq", "fastq")  # ref: Snakefile:13,24-25


@dataclass
class FastxRecord:
    name: str
    comment: str  # text after first whitespace in the header ('' if none)
    seq: str
    qual: str | None = None  # None for FASTA


def xopen_read(path: str | os.PathLike) -> io.TextIOBase:
    """Open text file with transparent .gz / .xz decompression."""
    p = str(path)
    if p.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(p, "rb"))
    if p.endswith(".xz"):
        return io.TextIOWrapper(lzma.open(p, "rb"))
    return open(p, "rt")


def xopen_write(path: str | os.PathLike) -> io.TextIOBase:
    p = str(path)
    if p.endswith(".gz"):
        # gzip level 1 ~ reference's `gzip --fast` intermediates (Snakefile:468)
        return io.TextIOWrapper(gzip.open(p, "wb", compresslevel=1))
    if p.endswith(".xz"):
        return io.TextIOWrapper(lzma.open(p, "wb"))
    return open(p, "wt")


def read_fastx(fp: Iterable[str]) -> Iterator[FastxRecord]:
    """Parse FASTA/FASTQ with readfq-equivalent semantics (incl. comments)."""
    last: str | None = None
    it = iter(fp)
    while True:
        if last is None:
            for line in it:
                if line and line[0] in ">@":
                    last = line.rstrip("\n")
                    break
            else:
                return
        header = last[1:]
        name, _, comment = header.partition(" ")
        last = None
        seqs: list[str] = []
        for line in it:
            if line and line[0] in "@+>":
                last = line.rstrip("\n")
                break
            seqs.append(line.rstrip("\n"))
        if last is None or last[0] != "+":
            yield FastxRecord(name, comment, "".join(seqs))
            if last is None:
                return
            continue
        # FASTQ: read quality until it covers the sequence length
        seq = "".join(seqs)
        last = None
        quals: list[str] = []
        got = 0
        for line in it:
            q = line.rstrip("\n")
            quals.append(q)
            got += len(q)
            if got >= len(seq):
                yield FastxRecord(name, comment, seq, "".join(quals))
                break
        else:
            yield FastxRecord(name, comment, seq)  # truncated fastq -> fasta
            return


def read_fastx_file(path: str | os.PathLike) -> Iterator[FastxRecord]:
    with xopen_read(path) as f:
        yield from read_fastx(f)


def write_fasta(fp, records: Iterable[FastxRecord], with_comment: bool = False) -> None:
    for r in records:
        if with_comment and r.comment:
            fp.write(f">{r.name} {r.comment}\n{r.seq}\n")
        else:
            fp.write(f">{r.name}\n{r.seq}\n")


def normalize_record(rec: FastxRecord) -> FastxRecord:
    """Uppercase + non-ACGT -> 'A', drop comment/qual (ref: Snakefile:330-332)."""
    seq = normalize_seq(rec.seq.encode()).decode()
    return FastxRecord(rec.name, "", seq, None)


def file_stem(path: str | os.PathLike) -> str:
    """Query-file stem: filename minus fastx (+.gz) suffixes (Snakefile:24-31)."""
    name = Path(path).name
    if name.endswith(".gz"):
        name = name[: -len(".gz")]
    for suf in FASTX_SUFFIXES:
        if name.endswith("." + suf):
            return name[: -(len(suf) + 1)]
    return Path(name).stem


def merged_stem(paths: Sequence[str | os.PathLike]) -> str:
    """'___'-join of sorted input stems (ref: Snakefile:37-38)."""
    return "___".join(sorted(file_stem(p) for p in paths))


def normalize_and_merge(
    paths: Sequence[str | os.PathLike],
) -> tuple[str, list[FastxRecord]]:
    """Stage 0+1: normalize every query file, concatenate in sorted-stem order.

    Returns (merged_stem, records). Query names must be globally unique
    (ref: README.md:201-203); duplicates raise ValueError.
    """
    ordered = sorted(paths, key=file_stem)
    records: list[FastxRecord] = []
    seen: set[str] = set()
    for p in ordered:
        for rec in read_fastx_file(p):
            if rec.name in seen:
                raise ValueError(f"duplicate query name across inputs: {rec.name!r}")
            seen.add(rec.name)
            records.append(normalize_record(rec))
    return merged_stem(ordered), records
