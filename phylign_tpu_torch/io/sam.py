"""SAM record formatting, headerless per-batch output, and aggregation (the
port's own copy of ``phylign_tpu/io/sam.py``).

Output contracts mirrored from the reference:
  * per-batch ``05_map/{batch}____{qfile}.sam.gz``: headerless SAM (all
    ``@`` lines stripped: Snakefile:556-560,
    batch_align.py:256-259);
  * final ``output/{qfile}.sam_summary.gz``: concatenation over batches of a
    gzip member containing ``\\n==> {per-batch path} <==`` followed by that
    batch's sam.gz bytes — multi-member gzip, decompresses to the joined
    text (ref: scripts/aggregate_sams.sh:13-24);
  * the acceptance oracle compares only columns 1-3 (qname, flag, rname):
    Makefile:40-55.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Sequence


@dataclass
class SamRecord:
    qname: str
    flag: int  # 0 fwd, 16 rev, 4 unmapped (sr preset: --secondary=no)
    rname: str  # contig name, '*' if unmapped
    pos: int  # 1-based leftmost, 0 if unmapped
    mapq: int
    cigar: str  # eqx-style ('='/'X'/'I'/'D'), '*' if unmapped
    seq: str
    tags: list[str] = field(default_factory=list)
    # deferred-MAPQ inputs (s1, s2_chain, cnt, dp_max) stashed by the align
    # engine at assembly time; engine._group_task_records finalizes ``mapq``
    # from these once the secondary-region DP probes are in (mm2's
    # mm_set_mapq needs dp_max2, which is only known after probe extension).
    # Excluded from equality so A/B record comparisons see emitted bytes.
    mapq_meta: tuple | None = field(default=None, repr=False, compare=False)

    def to_line(self) -> str:
        fields = [
            self.qname,
            str(self.flag),
            self.rname,
            str(self.pos),
            str(self.mapq),
            self.cigar,
            "*",  # RNEXT
            "0",  # PNEXT
            "0",  # TLEN
            self.seq,
            "*",  # QUAL (queries are FASTA by the align stage)
        ]
        return "\t".join(fields + self.tags)


class RawSamRecord:
    """A record whose final SAM line was assembled natively (one str slice
    of a per-chunk text blob; native/hostio.cpp assemble_sam_lines).

    Duck-types the post-assembly ``SamRecord`` surface: ``to_line`` /
    ``qname`` / ``flag`` are O(1); the remaining fields parse lazily from
    the line (only tests and rare fallbacks touch them). ``mapq_meta`` is
    always None — rows with deferred MAPQ take the python SamRecord path.
    Equality is by emitted line bytes, matching SamRecord field equality
    for any fully-assembled record."""

    __slots__ = ("_text", "_s", "_e", "qname", "flag")
    mapq_meta = None

    def __init__(self, text: str, s: int, e: int, qname: str, flag: int):
        self._text = text
        self._s = s
        self._e = e
        self.qname = qname
        self.flag = flag

    def to_line(self) -> str:
        return self._text[self._s : self._e]

    def _field(self, i: int) -> str:
        return self.to_line().split("\t")[i]

    @property
    def rname(self) -> str:
        return self._field(2)

    @property
    def pos(self) -> int:
        return int(self._field(3))

    @property
    def mapq(self) -> int:
        return int(self._field(4))

    @property
    def cigar(self) -> str:
        return self._field(5)

    @property
    def seq(self) -> str:
        return self._field(9)

    @property
    def tags(self) -> list[str]:
        return self.to_line().split("\t")[11:]

    def __eq__(self, other) -> bool:
        if isinstance(other, RawSamRecord):
            return self.to_line() == other.to_line()
        if isinstance(other, SamRecord):
            return self.to_line() == other.to_line()
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.to_line())

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"RawSamRecord({self.to_line()!r})"


def unmapped_record(qname: str, seq: str) -> SamRecord:
    # minimap2 emits unmapped records without optional tags
    return SamRecord(qname, 4, "*", 0, 0, "*", seq, [])


def write_batch_sam(path: str | os.PathLike, records: Iterable[SamRecord]) -> None:
    """Headerless SAM, gzip --fast equivalent."""
    with gzip.open(str(path), "wt", compresslevel=1) as f:
        for r in records:
            f.write(r.to_line() + "\n")


def aggregate_sams(
    out_path: str | os.PathLike,
    batch_sam_paths: Sequence[str | os.PathLike],
    banners: Sequence[str] | None = None,
) -> None:
    """Concatenate per-batch sam.gz files with gzip'd '==> path <==' banners
    between members (aggregate_sams.sh contract; relies on multi-member gzip).

    ``banners`` overrides the banner text per file (the pipeline passes
    workdir-relative paths so banner lines are byte-identical to the
    reference's, which runs from the workdir:
    scripts/aggregate_sams.sh:13-24)."""
    texts = [str(p) for p in batch_sam_paths] if banners is None else list(banners)
    with open(str(out_path), "wb") as out:
        for i, (p, text) in enumerate(zip(batch_sam_paths, texts)):
            banner = ("" if i == 0 else "\n") + f"==> {text} <==\n"
            out.write(gzip.compress(banner.encode(), compresslevel=1))
            with open(str(p), "rb") as f:
                out.write(f.read())


def read_sam_summary(path: str | os.PathLike) -> Iterator[str]:
    """Decompressed lines of a sam_summary.gz (or .xz for the golden file)."""
    p = str(path)
    if p.endswith(".xz"):
        import lzma

        opener = lzma.open
    else:
        opener = gzip.open
    with opener(p, "rt") as f:
        for line in f:
            yield line.rstrip("\n")


def summary_first3(path: str | os.PathLike) -> list[tuple[str, ...]]:
    """Columns 1-3 of every record line (the acceptance oracle projection);
    banner lines are kept verbatim as 1-tuples of their basename batch."""
    out: list[tuple[str, ...]] = []
    for line in read_sam_summary(path):
        if not line:
            continue
        if line.startswith("==>"):
            name = line.replace("==> ", "").replace(" <==", "")
            out.append((Path(name).name.split("____")[0],))
        else:
            parts = line.split("\t")
            out.append(tuple(parts[:3]))
    return out
