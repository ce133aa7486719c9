"""Plain reference of the map stage's records, in numpy and plain torch.

Two judgements of a SAM record against the benchmark's own genomes and
queries:
  * ``record_faults``: the record is what it says. SEQ is the query (its
    reverse complement on the reverse strand, cut by hard clips); the CIGAR
    consumes the query; each ``=`` column pairs equal bases and each ``X``
    unequal ones at POS on the named contig; NM counts X, I and D bases; AS
    and ms equal the CIGAR's score under the preset's dual-affine scoring
    (a match +A, a mismatch -B, a gap of l bases -min(O1 + l E1, O2 + l E2));
    de is (X + gap runs) / (= + X + gap runs), as minimap2 prints it.
  * ``local_best``: the best local alignment score of a query against a
    window of a genome (Smith-Waterman with the same dual-affine gaps), a
    row of the dynamic programme at a time over a block of pairs. No
    alignment of the window scores more, so a record's AS at most equals it.
    ``bits8`` runs the same programme with every value saturated to int8:
    the control.

Also ``summary_text`` and ``stats_text``, the aggregate and the stats
worked out again from the 05_map files and the merged queries. Nothing here
imports the program.
"""

from __future__ import annotations

import re

import numpy as np

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def parse_cigar(cigar: str) -> list[tuple[int, str]]:
    ops = [(int(n), op) for n, op in _CIGAR.findall(cigar)]
    if "".join(f"{n}{op}" for n, op in ops) != cigar:
        raise ValueError(f"malformed CIGAR {cigar!r}")
    return ops


def parse_cigar_loose(cigar: str) -> list[tuple[int, str]]:
    return [(int(n), op) for n, op in _CIGAR.findall(cigar)]


def gap_cost(n: int, sc: dict) -> int:
    return min(sc["O1"] + n * sc["E1"], sc["O2"] + n * sc["E2"])


def _de(n_eq: int, n_x: int, n_gapo: int) -> str:
    den = n_eq + n_x + n_gapo
    if den <= 0 or n_x + n_gapo == 0:
        return "0"
    return f"{np.float32((n_x + n_gapo) / den):.4f}"


def record_faults(fields: list[str], query: bytes, contigs: dict[str, bytes], sc: dict) -> list[str]:
    """What is wrong with one mapped record (empty when nothing is)."""
    flag, rname, pos, cigar, seq = int(fields[1]), fields[2], int(fields[3]), fields[5], fields[9].encode()
    tags = dict(t.split(":", 1) for t in fields[11:])
    if flag & ~(16 | 2048):
        return [f"flag {flag}"]
    if rname not in contigs:
        return [f"unknown contig {rname}"]
    try:
        ops = parse_cigar(cigar)
    except ValueError as e:
        return [str(e)]
    q = revcomp(query) if flag & 16 else query
    lead = ops[0][0] if ops and ops[0][1] in "SH" else 0
    qcons = sum(n for n, op in ops if op in "SHI=X")
    faults = []
    if qcons != len(q):
        faults.append(f"CIGAR consumes {qcons} of {len(q)} query bases")
    hard_l = ops[0][0] if ops and ops[0][1] == "H" else 0
    hard_r = ops[-1][0] if ops and ops[-1][1] == "H" else 0
    if seq != q[hard_l : len(q) - hard_r]:
        faults.append("SEQ is not the query")
    ref = contigs[rname]
    qi, ri = lead, pos - 1
    n_eq = n_x = n_i = n_d = gapo = 0
    run = score = 0

    def add(v: int) -> None:
        nonlocal run, score
        run = max(run, 0) + v
        score = max(score, run)
    for n, op in ops:
        if op in "SH":
            continue
        if op in "=X":
            a = np.frombuffer(q[qi : qi + n], np.uint8)
            b = np.frombuffer(ref[ri : ri + n], np.uint8)
            if len(b) != n or ri < 0:
                faults.append("alignment runs off the contig")
                break
            eq = int((a == b).sum())
            if (op == "=" and eq != n) or (op == "X" and eq != 0):
                faults.append(f"{n}{op} at query {qi} does not match the genome")
            if op == "=":
                n_eq += n
                add(n * sc["A"])
            else:
                n_x += n
                add(-n * sc["B"])
            qi += n
            ri += n
        elif op == "I":
            n_i += n
            gapo += 1
            add(-gap_cost(n, sc))
            qi += n
        elif op == "D":
            n_d += n
            gapo += 1
            add(-gap_cost(n, sc))
            ri += n
        else:
            faults.append(f"CIGAR op {op}")
    if ri > len(ref):
        faults.append("alignment runs off the contig")
    if tags.get("NM") != f"i:{n_x + n_i + n_d}":
        faults.append(f"NM {tags.get('NM')} against {n_x + n_i + n_d}")
    for t in ("AS", "ms"):
        if tags.get(t) != f"i:{score}":
            faults.append(f"{t} {tags.get(t)} against {score}")
    if tags.get("de") != f"f:{_de(n_eq, n_x, gapo)}":
        faults.append(f"de {tags.get('de')} against {_de(n_eq, n_x, gapo)}")
    return faults


def record_score(fields: list[str]) -> int:
    for t in fields[11:]:
        if t.startswith("AS:i:"):
            return int(t[5:])
    return 0


def local_best(pairs: list[tuple[bytes, bytes]], sc: dict, device: str = "cpu", bits8: bool = False,
               block_cells: int = 1 << 21) -> list[int]:
    """The best local alignment score of each (query, window) pair."""
    import torch

    out = [0] * len(pairs)
    order = sorted(range(len(pairs)), key=lambda i: len(pairs[i][0]))
    lo = 0
    while lo < len(order):
        hi = lo + 1
        w_max = len(pairs[order[lo]][1])
        while hi < len(order) and (hi - lo + 1) * max(w_max, len(pairs[order[hi]][1])) <= block_cells:
            w_max = max(w_max, len(pairs[order[hi]][1]))
            hi += 1
        blk = [pairs[i] for i in order[lo:hi]]
        for i, v in zip(order[lo:hi], _local_block(blk, sc, device, bits8)):
            out[i] = v
        lo = hi
    return out


def _local_block(blk, sc: dict, device: str, bits8: bool) -> list[int]:
    import torch

    codes = np.zeros(256, np.int8)
    for i, b in enumerate(b"ACGT"):
        codes[b] = i
    b_n = len(blk)
    lq = max(len(q) for q, _ in blk)
    wmax = max(len(r) for _, r in blk)
    q = np.full((b_n, lq), 4, np.int8)
    r = np.full((b_n, wmax), 5, np.int8)
    qlen = np.zeros(b_n, np.int64)
    for i, (qs, rs) in enumerate(blk):
        q[i, : len(qs)] = codes[np.frombuffer(qs, np.uint8)]
        r[i, : len(rs)] = codes[np.frombuffer(rs, np.uint8)]
        qlen[i] = len(qs)
    dev = torch.device(device)
    q_t = torch.from_numpy(q).to(dev)
    r_t = torch.from_numpy(r).to(dev)
    qlen_t = torch.from_numpy(qlen).to(dev)
    # int8 saturation as the control's arithmetic, else exact int32
    lo_v, hi_v = (-128, 127) if bits8 else (-(2**30), 2**30)

    def sat(x):
        return x.clamp_(lo_v, hi_v) if bits8 else x

    neg = torch.full((b_n, wmax + 1), lo_v, dtype=torch.int32, device=dev)
    zero = torch.zeros((b_n, wmax + 1), dtype=torch.int32, device=dev)
    h_prev = zero.clone()
    f1, f2 = neg.clone(), neg.clone()
    best = torch.zeros(b_n, dtype=torch.int32, device=dev)
    j = torch.arange(wmax + 1, dtype=torch.int32, device=dev)
    oe1, oe2 = sc["O1"] + sc["E1"], sc["O2"] + sc["E2"]
    for i in range(lq):
        s = torch.where(q_t[:, i : i + 1] == r_t, sc["A"], -sc["B"]).to(torch.int32)
        s = torch.where(r_t == 5, lo_v, s)
        f1 = sat(torch.maximum(sat(h_prev - oe1), sat(f1 - sc["E1"])))
        f2 = sat(torch.maximum(sat(h_prev - oe2), sat(f2 - sc["E2"])))
        hp = zero.clone()
        hp[:, 1:] = torch.maximum(sat(h_prev[:, :-1] + s), torch.maximum(f1[:, 1:], f2[:, 1:])).clamp_(min=0)
        h = hp
        for e, oe in ((sc["E1"], oe1), (sc["E2"], oe2)):
            run = torch.cummax(hp + e * j, dim=1).values
            g = torch.full_like(hp, lo_v)
            g[:, 1:] = sat(run[:, :-1] - e * j[1:] - (oe - e))
            h = torch.maximum(h, g)
        h[:, 0] = 0
        live = (i < qlen_t).unsqueeze(1)
        h_prev = torch.where(live, h, h_prev)
        best = torch.maximum(best, torch.where(live.squeeze(1), h.max(1).values, best))
    return best.cpu().tolist()


def summary_text(batches: list[str], stem: str, inter: str, map_texts: list[str]) -> str:
    """The decompressed sam_summary: a banner line before each batch's
    05_map text, a blank line between batches."""
    return "".join(
        ("" if i == 0 else "\n") + f"==> {inter}/05_map/{b}____{stem}.sam.gz <==\n" + t
        for i, (b, t) in enumerate(zip(batches, map_texts))
    )


def stats_text(summary: str, queries: list[tuple[str, int]]) -> str:
    """The .stats TSV worked out from a summary and the merged queries
    (name, length)."""
    matched, aligned, pairs, refs, batches = set(), set(), set(), set(), set()
    n_aln = n_non = 0
    batch = None
    for line in summary.split("\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith("=="):
            batch = line[4:-4].rsplit("/", 1)[-1].split("____")[0]
            continue
        f = line.split("\t")
        matched.add(f[0])
        if f[2] == "*":
            n_non += 1
            continue
        acc = f[2].partition(".")[0]
        aligned.add(f[0])
        n_aln += 1
        batches.add(batch)
        refs.add(acc)
        pairs.add((acc, f[0]))
    rows = [
        ("queries", len({n for n, _ in queries})),
        ("cumul_length_bps", sum(n for _, n in queries)),
        ("matched_queries", len(matched)),
        ("aligned_queries", len(aligned)),
        ("aligned_segments", n_aln),
        ("distinct_genome_query_pairs", len(pairs)),
        ("target_genomes", len(refs)),
        ("target_batches", len(batches)),
        ("nonalignments", n_non),
    ]
    return "".join(f"{k}\t{v}\n" for k, v in rows)
