"""Global candidate filter: cross-batch top-n (+ties) per query (the port's
own copy of ``phylign_tpu/match/filter.py``).

Reproduces the reference's scripts/filter_queries.py semantics exactly:
  * every query accumulates (batch, accession, score) triples from all
    per-batch match files;
  * kept set = sort by key ``(-score, batch, accession)``, truncate to
    ``keep`` entries, then re-include every following entry whose score
    equals the rank-``keep`` score (filter_queries.py:133-150 housekeeping —
    its incremental min-score pre-filter is equivalent to this single global
    pass because the cutoff is non-decreasing);
  * output is a FASTA whose header comment is the comma-joined accession
    list in kept order; queries with no matches still emit a record with an
    empty comment and a trailing space after the name
    (filter_queries.py:152-156: f">{name} {com}").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence, TextIO

from phylign_tpu_torch.io.fastx import FastxRecord


@dataclass
class FilteredQuery:
    qname: str
    seq: str
    candidates: list[tuple[str, str, int]] = field(default_factory=list)
    # (batch, accession, score) in kept order


def filter_candidates(
    matches: Sequence[tuple[str, str, int]], keep: int
) -> list[tuple[str, str, int]]:
    """(batch, accession, score) triples -> kept sorted subset with ties.

    keep <= 0 keeps nothing (deterministic edge: the reference's
    postprocess emits nothing for -n 0 and its filter crashes,
    ref: postprocess_cobs.py:28-39, filter_queries.py:133-150;
    Config validation rejects nb_best_hits < 1 before reaching here)."""
    if keep <= 0:
        return []
    ordered = sorted(matches, key=lambda x: (-x[2], x[0], x[1]))
    if len(ordered) <= keep:
        return ordered
    min_score = ordered[keep - 1][2]
    out = ordered[:keep]
    for t in ordered[keep:]:
        if t[2] != min_score:
            break
        out.append(t)
    return out


def filter_queries_streaming(
    query_records: Iterable[FastxRecord],
    per_batch_matches: Mapping[str, Iterable[tuple[str, list[tuple[str, int]]]]],
    keep: int,
) -> Iterable[FilteredQuery]:
    """Constant-memory variant: stream all match files in query lockstep.

    Requires every match file to list queries in merged-query order — true
    for files this pipeline (and cobs) produce. This is the capability of
    the reference's streaming experiment
    (scripts/filter_queries_2.py:196-207), productionized:
    memory is O(batches + one query's candidates) instead of O(all
    candidates of all queries).
    """
    iters = {b: iter(s) for b, s in per_batch_matches.items()}
    heads: dict[str, tuple[str, list[tuple[str, int]]] | None] = {
        b: next(it, None) for b, it in iters.items()
    }
    for rec in query_records:
        triples: list[tuple[str, str, int]] = []
        for b, it in iters.items():
            head = heads[b]
            if head is not None and head[0] == rec.name:
                triples.extend((b, acc, score) for acc, score in head[1])
                heads[b] = next(it, None)
        yield FilteredQuery(rec.name, rec.seq, filter_candidates(triples, keep))
    leftovers = [b for b, h in heads.items() if h is not None]
    if leftovers:
        raise ValueError(
            f"match files out of sync with the merged query order: "
            f"unconsumed entries in batches {leftovers[:3]}"
        )


def write_filtered_fasta(fp: TextIO, queries: Iterable[FilteredQuery]) -> None:
    """04_filter FASTA contract: '>{name} {acc1,acc2,...}' (always a space)."""
    for q in queries:
        com = ",".join(a for _, a, _ in q.candidates)
        fp.write(f">{q.qname} {com}\n{q.seq}\n")


def read_filtered_fasta(
    records: Iterable[FastxRecord],
) -> list[FilteredQuery]:
    """Inverse of write_filtered_fasta (consumed by the align stage like
    batch_align.py:126-171 load_qdicts)."""
    out = []
    for r in records:
        cands = [("", a, 0) for a in r.comment.split(",")] if r.comment else []
        out.append(FilteredQuery(r.name, r.seq, cands))
    return out


def filter_queries_arrays(
    query_records: Iterable[FastxRecord],
    parsed: "Mapping[str, object]",  # batch -> native.ParsedMatchFile
    keep: int,
) -> list[FilteredQuery]:
    """Vectorized filter over natively parsed match files.

    Same result as filter_queries_streaming, but the
    per-hit work is numpy over interned-accession arrays: one global
    lexsort by (query, -score, batch, accession) + a vectorized tie cut,
    instead of tens of millions of per-line python steps at full scale
    (305 batches; ref workload: filter_queries.py:123-150).

    Tie order: batches compare by NAME (the dict is keyed by name), and
    accessions compare as strings within a batch — encoded as per-batch
    name rank and per-batch accession rank.
    """
    import numpy as np

    records = list(query_records)
    name_to_qi = {r.name: i for i, r in enumerate(records)}

    batch_names = list(parsed)
    batch_rank = {b: r for r, b in enumerate(sorted(batch_names))}

    qs, scores, branks, arank_cols, bidx_cols, accid_cols = [], [], [], [], [], []
    for bi, b in enumerate(batch_names):
        pm = parsed[b]
        nq = len(pm.qnames)
        if nq == 0:
            continue
        # unknown query names get a synthetic empty-sequence record (the
        # reference tolerates them)
        for n in pm.qnames:
            if n not in name_to_qi:
                name_to_qi[n] = len(records)
                records.append(FastxRecord(n, "", ""))
        qidx = np.array([name_to_qi[n] for n in pm.qnames], np.int64)
        counts = np.diff(np.concatenate(([0], pm.hit_end)))
        if pm.hit_end[-1] == 0:
            continue
        rank = np.empty(len(pm.accs), np.int32)
        rank[np.argsort(pm.accs, kind="stable")] = np.arange(
            len(pm.accs), dtype=np.int32
        )
        nh = pm.score.shape[0]
        qs.append(np.repeat(qidx, counts))
        scores.append(pm.score)  # int32 straight from the parser
        branks.append(np.full(nh, batch_rank[b], np.int32))
        arank_cols.append(rank[pm.acc_id])
        bidx_cols.append(np.full(nh, bi, np.int32))
        accid_cols.append(pm.acc_id)

    out = [FilteredQuery(r.name, r.seq) for r in records]
    if not qs:
        return out
    q = np.concatenate(qs)
    sc = np.concatenate(scores)
    br = np.concatenate(branks)
    ar = np.concatenate(arank_cols)
    bx = np.concatenate(bidx_cols)
    ai = np.concatenate(accid_cols)

    smax = int(sc.max(initial=0))
    # packed-uint64 key bit budget: q 22, score 14, batch 10, acc-rank 18
    fits_packed = (
        len(records) < (1 << 22)
        and smax < (1 << 14)
        and len(batch_names) < (1 << 10)
        and int(ar.max(initial=0)) < (1 << 18)
    )

    # native sort+cut core: one C pass over the packed keys instead of a
    # dozen numpy full-array passes (returns kept original-row ids in kept
    # order, exactly like the numpy path below)
    from phylign_tpu_torch.native import native_filter_topk_rows

    if fits_packed:
        kept_native = native_filter_topk_rows(q, sc, br, ar, smax, keep)
        if kept_native is not None:
            acc_lists = [parsed[b].accs for b in batch_names]
            for qi, b_, a_, s_ in zip(
                q[kept_native].tolist(),
                bx[kept_native].tolist(),
                ai[kept_native].tolist(),
                sc[kept_native].tolist(),
            ):
                out[qi].candidates.append(
                    (batch_names[b_], acc_lists[b_][a_], s_)
                )
            return out

    # single packed-uint64 sort key when the ranges fit (3x faster than a
    # 4-key lexsort at tens of millions of rows)
    if fits_packed:
        key = (
            (q.astype(np.uint64) << 42)
            | ((smax - sc).astype(np.uint64) << 28)
            | (br.astype(np.uint64) << 18)
            | ar.astype(np.uint64)
        )
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort((ar, br, -sc, q))
    q_s = q[order]
    sc_s = sc[order]

    # per-query segments in the sorted order (every op below is either
    # NQ-sized or one of a handful of full passes — this box's cores are
    # slow enough that full-array passes dominate)
    qr = np.arange(len(records))
    seg_start = np.searchsorted(q_s, qr, side="left")
    seg_end = np.searchsorted(q_s, qr, side="right")
    seg_sizes = seg_end - seg_start
    # score at rank keep-1 per query; -1 sentinel (< any score) when the
    # whole segment fits, so the equality clause can't fire spuriously
    cut_idx = np.minimum(seg_start + keep - 1, np.maximum(seg_end - 1, seg_start))
    cut_q = np.where(
        seg_sizes > keep, sc_s[np.minimum(cut_idx, max(q_s.shape[0] - 1, 0))], -1
    )
    rank_in_q = np.arange(q_s.shape[0]) - np.repeat(seg_start, seg_sizes)
    keep_mask = (rank_in_q < keep) | (sc_s == np.repeat(cut_q, seg_sizes))

    kept = order[np.flatnonzero(keep_mask)]  # original-row ids, kept order
    acc_lists = [parsed[b].accs for b in batch_names]
    kq = q[kept].tolist()
    kb = bx[kept].tolist()
    ka = ai[kept].tolist()
    ks = sc[kept].tolist()
    for qi, b_, a_, s_ in zip(kq, kb, ka, ks):
        out[qi].candidates.append((batch_names[b_], acc_lists[b_][a_], s_))
    return out
