"""The comparison that decides ``correct``: the program's outputs of the
window's jobs against the plain reference, on a sample of queries drawn
from the seed. Each function returns the numbers compared and, with
``control``, under "control" the same numbers of the control's output: the
reference put in the program's place with one guarantee broken (Bloom
rows from 32-bit hashes for the match, int8 dynamic programming for the
map), judged by the same comparison."""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from gpubench.fixtures import rng_for, seq_bytes
from gpubench.reference import align_ref, cobs_ref


def sample(seed: int, sizes: list[int], n: int) -> list[tuple[int, int]]:
    """n (job position, query index) pairs drawn without replacement over
    the queries of the window's jobs (all of them where n is larger)."""
    total = sum(sizes)
    flat = np.sort(rng_for(seed, 9).choice(total, min(n, total), replace=False))
    starts = np.cumsum([0, *sizes])
    jp = np.searchsorted(starts, flat, side="right") - 1
    return [(int(j), int(i - starts[j])) for j, i in zip(jp, flat)]


def _blocks(path: Path, names: set[str]) -> dict[str, str]:
    """The 03_match blocks of the named queries."""
    out: dict[str, list[str]] = {}
    cur = None
    with gzip.open(path, "rt") as f:
        for line in f:
            if line.startswith("*"):
                name = line[1:].split("\t", 1)[0]
                cur = out.setdefault(name, []) if name in names else None
            if cur is not None:
                cur.append(line)
    return {k: "".join(v) for k, v in out.items()}


def _fasta_records(path: Path, names: set[str]) -> dict[str, tuple[str, str]]:
    out, cur = {}, None
    for line in Path(path).read_text().splitlines():
        if line.startswith(">"):
            head = line[1:]
            name, _, com = head.partition(" ")
            cur = name if name in names else None
            if cur is not None:
                out[cur] = (com, "")
        elif cur is not None:
            out[cur] = (out[cur][0], out[cur][1] + line)
    return out


def _blocks_differ(got: dict, want: dict) -> int:
    """How many of the wanted outputs (a query's 03_match block of a batch,
    or its 04_filter record) the given ones miss or give otherwise."""
    return sum(got.get(key) != w for key, w in want.items())


def check_match(pool, runs: list, seed: int, n: int, device: str, control: bool = False) -> dict:
    """runs: (job, workdir, stem) of the window's jobs. Returns
    {"blocks_differ": count} of the sampled queries' 03_match blocks (every
    batch) and 04_filter records that the program's files miss or give
    otherwise than the reference; with ``control`` also
    {"control": {"blocks_differ": ...}}, the control's blocks and records
    counted by the same comparison."""
    import torch

    keep = pool.cfg["config"]["nb_best_hits"]
    thres = pool.cfg["config"]["cobs_kmer_thres"]
    picks = sample(seed, [len(job.names) for job, _, _ in runs], n)
    seqs = [runs[j][0].seqs[i] for j, i in picks]
    hashes = cobs_ref.kmer_hashes(seqs)
    ref_hits: list[list] = [[] for _ in picks]
    ctl_hits: list[list] = [[] for _ in picks]
    want, got, ctl = {}, {}, {}  # (batch or None, job, name) -> text
    for b, batch in enumerate(pool.batches):
        words = torch.from_numpy(pool.words(b).view(np.int32)).to(device)
        variants = [(False, ref_hits)] + ([(True, ctl_hits)] if control else [])
        for bits32, store in variants:
            rows = [cobs_ref.bloom_rows(h, pool.rows, bits32) for h in hashes]
            sc = cobs_ref.scores(words, rows, pool.docs)
            for k, (h, row) in enumerate(zip(hashes, sc)):
                store[k].append(cobs_ref.batch_hits(row, len(h), thres, pool.doc_names[b], keep))
        del words
        for jp, (job, wd, stem) in enumerate(runs):
            mine = [k for k, (j, _) in enumerate(picks) if j == jp]
            if not mine:
                continue
            names = {job.names[picks[k][1]] for k in mine}
            blocks = _blocks(wd / "intermediate" / "03_match" / f"{batch}____{stem}.gz", names)
            for k in mine:
                name = job.names[picks[k][1]]
                want[b, jp, name] = cobs_ref.match_block(name, *ref_hits[k][b])
                if name in blocks:
                    got[b, jp, name] = blocks[name]
                if control:
                    ctl[b, jp, name] = cobs_ref.match_block(name, *ctl_hits[k][b])
    for jp, (job, wd, stem) in enumerate(runs):
        mine = [k for k, (j, _) in enumerate(picks) if j == jp]
        if not mine:
            continue
        names = {job.names[picks[k][1]] for k in mine}
        recs = _fasta_records(wd / "intermediate" / "04_filter" / f"{stem}.fa", names)
        for k in mine:
            name, seq = job.names[picks[k][1]], job.seqs[picks[k][1]].decode()
            key = (None, jp, name)
            want[key] = (cobs_ref.filter_comment(list(zip(pool.batches, [kept for _, kept in ref_hits[k]])), keep), seq)
            if name in recs:
                got[key] = recs[name]
            if control:
                ctl[key] = (cobs_ref.filter_comment(list(zip(pool.batches, [kept for _, kept in ctl_hits[k]])), keep), seq)
    out = {"blocks_differ": _blocks_differ(got, want)}
    if control:
        out["control"] = {"blocks_differ": _blocks_differ(ctl, want)}
    return out


def _map_records(wd: Path, batches: list[str], stem: str) -> tuple[dict, list[str]]:
    """(qname, accession) -> mapped record fields; and each batch's text."""
    recs: dict[tuple[str, str], list[list[str]]] = {}
    texts = []
    for b in batches:
        with gzip.open(wd / "intermediate" / "05_map" / f"{b}____{stem}.sam.gz", "rt") as f:
            text = f.read()
        texts.append(text)
        for line in text.splitlines():
            f = line.split("\t")
            if f[2] != "*":
                recs.setdefault((f[0], f[2].partition(".")[0]), []).append(f)
    return recs, texts


def judge_map(best: list[int], answers: list[tuple[bool, int]]) -> dict:
    """The numbers compared over the sampled pairs, each planted where the
    benchmark knows: ``best`` the reference's best local score in the
    pair's window, ``answers`` (mapped, credited score) of the side judged.
    score_gap: the widest gap of a mapped pair's credit below the best;
    unmapped: the planted pairs left unmapped."""
    gaps = [b - c for b, (m, c) in zip(best, answers) if m]
    return {"score_gap": max(gaps, default=0), "unmapped": sum(not m for m, _ in answers)}


def check_map(pool, runs: list, seed: int, n: int, pad: int, device: str, control: bool = False) -> dict:
    """Returns {"score_gap", "unmapped"} (judge_map) over the sampled
    (query, candidate) pairs: each pair's window is ``pad`` bases about
    where the benchmark planted the query in that candidate (about the
    primary record, for a chimera, which has no one place). A pair is
    mapped where it has a primary record on the candidate; its credited
    score is that record's AS where every record of the pair is what it
    says (align_ref.record_faults) and the job's sam_summary and .stats
    equal the ones worked out again from its 05_map files; else 0, so a
    false record reads as the whole best score. An unmapped chimera is not
    judged. With ``control``, under "control" the same numbers of the
    control: the int8 reference, a pair mapped where its best is positive,
    credited with that best."""
    sc = pool.cfg["scoring"]
    ncand = len(runs[0][0].cands[0]) if runs and runs[0][0].cands else 1
    picks = sample(seed, [len(job.names) * ncand for job, _, _ in runs], n)
    windows, answers = [], []
    text: dict[str, dict[str, bytes]] = {}

    def contigs_of(acc: str) -> dict[str, bytes]:
        if acc not in text:
            text[acc] = {k: seq_bytes(v) for k, v in pool.contigs[acc].items()}
        return text[acc]

    for jp, (job, wd, stem) in enumerate(runs):
        recs, texts = _map_records(wd, pool.batches, stem)
        summary = gzip.open(wd / "output" / f"{stem}.sam_summary.gz", "rt").read()
        want = align_ref.summary_text(pool.batches, stem, "intermediate", texts)
        stats = (wd / "output" / f"{stem}.sam_summary.stats").read_text()
        job_ok = summary == want and stats == align_ref.stats_text(
            want, [(nm, len(s)) for nm, s in zip(job.names, job.seqs)])
        for j2, flat in picks:
            if j2 != jp:
                continue
            qi, ci = divmod(flat, ncand)
            name, seq, acc = job.names[qi], job.seqs[qi], job.cands[qi][ci]
            mine = recs.get((name, acc), [])
            prim = [f for f in mine if int(f[1]) & 2048 == 0]
            tr = job.truth[qi]
            if tr is not None:
                _, _, cname, pos, span, strand = tr
                ctg = contigs_of(acc)[f"{acc}.{cname.partition('.')[2]}"]
            elif prim:
                f = prim[0]
                ctg = contigs_of(acc).get(f[2], b"")
                pos = int(f[3]) - 1
                span = sum(int(x) for x, op in align_ref.parse_cigar_loose(f[5]) if op in "=XD")
                strand = int(f[1]) & 16
            else:
                continue
            ok = bool(prim) and job_ok and len(prim) == 1 and not any(
                align_ref.record_faults(f, seq, contigs_of(acc), sc) for f in mine)
            lo, hi = max(0, pos - pad), min(len(ctg), pos + span + pad)
            q = align_ref.revcomp(seq) if strand else seq
            windows.append((q, ctg[lo:hi]))
            answers.append((bool(prim), align_ref.record_score(prim[0]) if ok else 0))
    best = align_ref.local_best(windows, sc, device) if windows else []
    out = judge_map(best, answers)
    if control:
        ctl = align_ref.local_best(windows, sc, device, bits8=True) if windows else []
        out["control"] = judge_map(best, [(c > 0, c) for c in ctl])
    return out
