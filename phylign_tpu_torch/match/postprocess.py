"""Per-batch match postprocessing and match-file IO.

Mirrors the reference contracts:
  * top-n + ties-at-rank-n truncation of each query's sorted hit list
    (ref: scripts/postprocess_cobs.py:21-39);
  * match-file text format ``*{qname}\\t{nmatches}`` header followed by
    ``_{accession}\\t{score}`` lines — the leading underscore is the residue
    of stripping the random doc-name prefix, preserved for drop-in
    compatibility with reference intermediates
    (ref: postprocess_cobs.py:16-18 emits '_' + rest; filter_queries.py
    cobs_iterator re-splits on '_').
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence, TextIO


@dataclass
class QueryMatches:
    qname: str
    n_total: int  # hits passing threshold, BEFORE top-n truncation
    hits: list[tuple[str, int]]  # (doc_name_with_rid, score), sorted


def top_n_with_ties(
    hits: Sequence[tuple[str, int]], keep: int
) -> list[tuple[str, int]]:
    """Keep the first ``keep`` hits of a score-desc-sorted list, plus any
    following hits whose score equals the rank-``keep`` score. keep <= 0
    keeps nothing (the reference's postprocess prints no hit lines for
    -n 0, ref: postprocess_cobs.py:28-39)."""
    if keep <= 0:
        return []
    if len(hits) <= keep:
        return list(hits)
    min_score = hits[keep - 1][1]
    out = list(hits[:keep])
    for name, score in hits[keep:]:
        if score != min_score:
            break
        out.append((name, score))
    return out


def write_match_file(fp: TextIO, matches: Iterable[QueryMatches], keep: int) -> None:
    """Emit postprocessed match text (the 03_match/ contract)."""
    from phylign_tpu_torch.io.cobs import strip_rid

    for m in matches:
        fp.write(f"*{m.qname}\t{m.n_total}\n")
        for name, score in top_n_with_ties(m.hits, keep):
            fp.write(f"_{strip_rid(name)}\t{score}\n")


def read_match_file(fp: Iterable[str]) -> Iterator[tuple[str, list[tuple[str, int]]]]:
    """Parse a match file -> (qname, [(accession, score)]). The qname drops any
    FASTA comment; accession drops the leading-underscore residue
    (ref: filter_queries.py cobs_iterator)."""
    qname: str | None = None
    buf: list[tuple[str, int]] = []
    for line in fp:
        line = line.strip()
        if not line:
            continue
        if line[0] == "*":
            if qname is not None:
                yield qname, buf
                buf = []
            parts = line[1:].split("\t")
            qname = parts[0].split(" ")[0]
        else:
            tmp_name, score = line.split()
            _, _, acc = tmp_name.partition("_")
            buf.append((acc, int(score)))
    if qname is not None:
        yield qname, buf
