"""Final output statistics (the sam_summary.stats contract; the port's own
copy of ``phylign_tpu/io/stats.py``).

Mirrors scripts/final_stats.py:76-128: parse the aggregated
sam_summary, count queries/alignments per category, and emit the 8-key TSV
(plus the two query-derived keys when the merged query file is given).
rname parsing: 'accession.contig' splits at the FIRST dot
(final_stats.py get_match: rname.partition("."))."""

from __future__ import annotations

import os
from dataclasses import dataclass

from phylign_tpu_torch.io.fastx import read_fastx_file
from phylign_tpu_torch.io.sam import read_sam_summary


@dataclass
class SummaryStats:
    queries: int | None = None
    cumul_length_bps: int | None = None
    matched_queries: int = 0
    aligned_queries: int = 0
    aligned_segments: int = 0
    distinct_genome_query_pairs: int = 0
    target_genomes: int = 0
    target_batches: int = 0
    nonalignments: int = 0

    def to_tsv(self) -> str:
        rows = []
        if self.queries is not None:
            rows.append(("queries", self.queries))
            rows.append(("cumul_length_bps", self.cumul_length_bps))
        rows += [
            ("matched_queries", self.matched_queries),
            ("aligned_queries", self.aligned_queries),
            ("aligned_segments", self.aligned_segments),
            ("distinct_genome_query_pairs", self.distinct_genome_query_pairs),
            ("target_genomes", self.target_genomes),
            ("target_batches", self.target_batches),
            ("nonalignments", self.nonalignments),
        ]
        return "".join(f"{k}\t{v}\n" for k, v in rows)


def compute_stats(
    summary_path: str | os.PathLike, queries_path: str | os.PathLike | None = None
) -> SummaryStats:
    batches: set[str] = set()
    refs: set[str] = set()
    matched: set[str] = set()
    aligned: set[str] = set()
    pairs: set[str] = set()
    n_aln = 0
    n_non = 0
    batch = None
    for line in read_sam_summary(summary_path):
        line = line.strip()
        if not line:
            continue
        if line.startswith("=="):
            path = line.replace("==> ", "").replace(" <==", "")
            batch = os.path.basename(path).split("____")[0]
            continue
        parts = line.split("\t")
        qname, rname = parts[0], parts[2]
        matched.add(qname)
        if rname == "*":
            n_non += 1
            continue
        accession, _, _ = rname.partition(".")
        aligned.add(qname)
        n_aln += 1
        if batch is not None:
            batches.add(batch)
        refs.add(accession)
        pairs.add(f"{accession}__{qname}")

    st = SummaryStats(
        matched_queries=len(matched),
        aligned_queries=len(aligned),
        aligned_segments=n_aln,
        distinct_genome_query_pairs=len(pairs),
        target_genomes=len(refs),
        target_batches=len(batches),
        nonalignments=n_non,
    )
    if queries_path is not None:
        names: set[str] = set()
        bps = 0
        for rec in read_fastx_file(queries_path):
            names.add(rec.name)
            bps += len(rec.seq)
        st.queries = len(names)
        st.cumul_length_bps = bps
        assert matched <= names, "matched queries not a subset of input queries"
    return st
