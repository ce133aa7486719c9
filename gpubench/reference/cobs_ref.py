"""Plain reference of the match stage: COBS classic search, the per-batch
03_match block and the global 04_filter record, in numpy and plain torch.

Semantics (cobs 0.2.1 classic search as Phylign runs it, and Phylign's
postprocess_cobs.py and filter_queries.py):
  * a k-mer is canonicalised to the lexicographically smaller of its ASCII
    text and its reverse complement's, then hashed with XXH64(text, seed 0);
    its Bloom row is the 64-bit hash modulo the index's row count;
  * score(query, doc) counts the query's k-mer positions whose row has the
    doc's bit set (positions are not deduplicated);
  * a doc qualifies when score >= threshold * n_kmers; a batch's block is
    ``*name<TAB>n_qualifying`` and the hits sorted by (-score, doc name),
    cut to the first n plus ties at the n-th score, each ``_acc<TAB>score``
    with the doc name's random prefix stripped;
  * the filter keeps, over all batches, the (batch, acc, score) triples
    sorted by (-score, batch, acc), cut to n plus ties.

Nothing here imports the program; the benchmark hands both sides the same
inputs.
"""

from __future__ import annotations

import numpy as np

K = 31
_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)
_ASCII = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def codes_of(seq: bytes) -> np.ndarray:
    """ACGT text -> codes 0..3 (any other byte reads as A)."""
    return _CODE[np.frombuffer(seq, np.uint8)]


def _rotl(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _le_words(b: np.ndarray, width: int) -> np.ndarray:
    """The little-endian integer of ``width`` bytes at every offset of b."""
    n = len(b) - width + 1
    out = np.zeros(max(n, 0), np.uint64)
    for i in range(width):
        out |= b[i : i + n].astype(np.uint64) << np.uint64(8 * i)
    return out


def _xxh64_31(lanes8: list, lane4, tail: list) -> np.ndarray:
    """XXH64 with seed 0 of 31-byte inputs given as three 8-byte lanes, one
    4-byte lane and three single bytes (the short-input path of the spec)."""
    h = np.full(len(lane4), _P5 + np.uint64(31), np.uint64)
    for lane in lanes8:
        k1 = _rotl(lane * _P2, 31) * _P1
        h = _rotl(h ^ k1, 27) * _P1 + _P4
    h = _rotl(h ^ (lane4 * _P1), 23) * _P2 + _P3
    for byte in tail:
        h = _rotl(h ^ (byte * _P5), 11) * _P1
    h ^= h >> np.uint64(33)
    h *= _P2
    h ^= h >> np.uint64(29)
    h *= _P3
    h ^= h >> np.uint64(32)
    return h


def kmer_hashes(seqs: list[bytes]) -> list[np.ndarray]:
    """Each sequence's canonical 31-mer XXH64 hashes (uint64), in k-mer
    order; an empty array for a sequence shorter than 31."""
    lens = np.array([len(s) for s in seqs], np.int64)
    if not len(seqs):
        return []
    c = codes_of(b"".join(seqs))
    n = len(c)
    old = np.seterr(over="ignore")
    try:
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        nk = np.maximum(lens - K + 1, 0)
        pos = np.concatenate([np.arange(s, s + m) for s, m in zip(starts, nk)]) if nk.sum() else np.zeros(0, np.int64)
        rc = (3 - c)[::-1].copy()
        fwd_val = np.zeros(max(n - K + 1, 0), np.uint64)
        rc_val = np.zeros_like(fwd_val)
        for i in range(K):
            sh = np.uint64(2 * (K - 1 - i))
            fwd_val |= c[i : i + len(fwd_val)].astype(np.uint64) << sh
            rc_val |= rc[i : i + len(rc_val)].astype(np.uint64) << sh
        rpos = n - K - pos  # the reverse complement's k-mer in rc
        use_fwd = fwd_val[pos] <= rc_val[rpos]
        hashes = np.zeros(len(pos), np.uint64)
        for take, src, at in ((use_fwd, c, pos), (~use_fwd, rc, rpos)):
            if not take.any():
                continue
            txt = _ASCII[src]
            at = at[take]
            w8 = _le_words(txt, 8)
            w4 = _le_words(txt, 4)
            t = txt.astype(np.uint64)
            hashes[take] = _xxh64_31(
                [w8[at], w8[at + 8], w8[at + 16]], w4[at + 24], [t[at + 28], t[at + 29], t[at + 30]]
            )
    finally:
        np.seterr(**old)
    return np.split(hashes, np.cumsum(nk)[:-1])


def bloom_rows(hashes: np.ndarray, rows: int, bits32: bool = False) -> np.ndarray:
    """Bloom rows of k-mer hashes: hash mod rows in 64-bit arithmetic, or
    (``bits32``, the control) of the hash's low 32 bits."""
    h = hashes & np.uint64(0xFFFFFFFF) if bits32 else hashes
    return (h % np.uint64(rows)).astype(np.int64)


def scores(words, row_lists: list[np.ndarray], n_docs: int, block: int = 1 << 16):
    """int64 [Q, n_docs]: each query's k-mer positions whose row has the
    doc's bit set. ``words``: int32 torch tensor [S, Wp] (bit d % 32 of word
    d // 32 is doc d's), on the device the reference runs on."""
    import torch

    s, wp = words.shape
    padded = torch.cat([words, torch.zeros((1, wp), dtype=words.dtype, device=words.device)])
    out = np.zeros((len(row_lists), n_docs), np.int64)
    i = 0
    while i < len(row_lists):
        kmax = max(1, len(row_lists[i]))
        j = i + 1
        while j < len(row_lists) and (j - i + 1) * max(kmax, len(row_lists[j])) <= block:
            kmax = max(kmax, len(row_lists[j]))
            j += 1
        idx = np.full((j - i, kmax), s, np.int64)
        for r, rows in enumerate(row_lists[i:j]):
            idx[r, : len(rows)] = rows
        g = padded[torch.from_numpy(idx).to(words.device)]  # [R, K, Wp]
        cnt = torch.stack([((g >> b) & 1).sum(1, dtype=torch.int64) for b in range(32)], dim=2)
        out[i:j] = cnt.reshape(j - i, wp * 32)[:, :n_docs].cpu().numpy()
        i = j
    return out


def strip_rid(doc: str) -> str:
    _, sep, rest = doc.partition("_")
    return rest if sep else doc


def top_n_with_ties(items: list, keep: int, score_at) -> list:
    if len(items) <= keep:
        return list(items)
    cut = score_at(items[keep - 1])
    out = list(items[:keep])
    for it in items[keep:]:
        if score_at(it) != cut:
            break
        out.append(it)
    return out


def batch_hits(score_row: np.ndarray, n_kmers: int, thres: float, doc_names: list[str], keep: int):
    """(n qualifying, kept [(doc name, score)]) of one query in one batch."""
    q = score_row >= thres * n_kmers if n_kmers > 0 else score_row > 0
    hits = sorted(((doc_names[d], int(score_row[d])) for d in np.flatnonzero(q)), key=lambda x: (-x[1], x[0]))
    return int(q.sum()), top_n_with_ties(hits, keep, lambda x: x[1])


def match_block(name: str, n_total: int, kept) -> str:
    return f"*{name}\t{n_total}\n" + "".join(f"_{strip_rid(d)}\t{s}\n" for d, s in kept)


def filter_comment(per_batch: list[tuple[str, list]], keep: int) -> str:
    """The 04_filter record's comment: accessions of the global top-n with
    ties over every batch's kept hits, by (-score, batch, accession)."""
    triples = sorted(
        ((b, strip_rid(d), s) for b, kept in per_batch for d, s in kept), key=lambda t: (-t[2], t[0], t[1])
    )
    return ",".join(a for _, a, _ in top_n_with_ties(triples, keep, lambda t: t[2]))
