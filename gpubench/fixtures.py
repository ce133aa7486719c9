"""The one generator of the benchmark's inputs: a pool made at set-up from
the seed (Bloom-index batches with sequences planted in species groups of
documents, or batches of strain genomes), and each job's query set drawn
from the seed and the job's index. A configuration file gives the pool's
sizes; a traffic file gives the mix of a job. Every array comes from numpy
or torch generators seeded from ``--seed``, so one seed gives the same
pool and the same jobs.
"""

from __future__ import annotations

import io
import json
import tarfile
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from gpubench.reference import cobs_ref
from gpubench.reference.align_ref import revcomp

ACGT = np.frombuffer(b"ACGT", np.uint8)


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *tags])


def seq_bytes(codes: np.ndarray) -> bytes:
    return ACGT[codes].tobytes()


def mutate(codes: np.ndarray, rate: float, rng) -> np.ndarray:
    """A copy with each base substituted by another with probability rate."""
    out = codes.copy()
    at = np.flatnonzero(rng.random(len(out)) < rate)
    out[at] = (out[at] + rng.integers(1, 4, len(at))) % 4
    return out


def gene_pool(q: dict, rng) -> tuple[np.ndarray, np.ndarray]:
    """The gene pool: one set of lengths for every seed (lognormal about
    q['median'] with q['sigma'], cut to q['length'] = [shortest, longest],
    both ends present), in an order drawn from ``rng``; and each gene's
    place in the fixed set, which decides what the traffic does to it. So
    a seed changes the genes' sequences and order, not a job's work."""
    lo, hi = q["length"]
    n = q["count"]
    fixed = rng_for(0, 6)
    ln = np.exp(fixed.normal(np.log(q["median"]), q["sigma"], n)).round().astype(np.int64).clip(lo, hi)
    ln[0], ln[-1] = lo, hi
    order = rng.permutation(n)
    return ln[order], order


@dataclass
class Job:
    """One job's queries: names, sequences and, per query, what the
    benchmark planted it from (None where nothing)."""

    names: list[str]
    seqs: list[bytes]
    truth: list = field(default_factory=list)
    cands: list = field(default_factory=list)  # map jobs: accessions

    @property
    def pairs(self) -> int:
        return sum(len(c) for c in self.cands)

    def head(self, share: float) -> "Job":
        """The first ``share`` of the queries (at least one)."""
        n = max(1, round(len(self.names) * share))
        return Job(self.names[:n], self.seqs[:n], self.truth[:n], self.cands[:n])


def _signed(x: int) -> int:
    return int(np.uint64(x).view(np.int64))


_XP = [_signed(p) for p in (cobs_ref._P1, cobs_ref._P2, cobs_ref._P3, cobs_ref._P4, cobs_ref._P5)]


def _rotl(x, r: int):
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def _shr(x, s: int):
    return (x >> s) & ((1 << (64 - s)) - 1)


def kmer_hashes_device(seqs: list[bytes], device: str) -> list[np.ndarray]:
    """cobs_ref.kmer_hashes worked out with torch on ``device`` (int64 in
    two's complement for XXH64's uint64 arithmetic): the pool's planted
    k-mers, millions of them, in set-up. The same hashes, as the tests hold."""
    import torch

    if not seqs:
        return []
    k, dev = cobs_ref.K, torch.device(device)
    lens = np.array([len(x) for x in seqs], np.int64)
    nk = np.maximum(lens - k + 1, 0)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    c = torch.from_numpy(cobs_ref.codes_of(b"".join(seqs))).to(dev).long()
    n = len(c)
    pos = torch.from_numpy(np.concatenate([np.arange(a, a + m) for a, m in zip(starts, nk)])).to(dev)
    rc = (3 - c).flip(0)
    vf = torch.zeros(len(pos), dtype=torch.int64, device=dev)
    vr = torch.zeros_like(vf)
    rpos = n - k - pos
    for i in range(k):  # 2-bit text of each k-mer and of its reverse complement
        vf = (vf << 2) | c[pos + i]
        vr = (vr << 2) | rc[rpos + i]
    fwd = vf <= vr
    ascii_ = torch.from_numpy(cobs_ref._ASCII.astype(np.int64)).to(dev)
    src = torch.where(fwd, pos, n + rpos)  # offsets into text + rc text
    txt = ascii_[torch.cat([c, rc])]

    def word(at, width):
        out = torch.zeros_like(at)
        for i in range(width):
            out |= txt[at + i] << (8 * i)
        return out

    p1, p2, p3, p4, p5 = _XP
    h = torch.full_like(src, _signed(cobs_ref._P5 + np.uint64(31)))
    for off in (0, 8, 16):
        k1 = _rotl(word(src + off, 8) * p2, 31) * p1
        h = _rotl(h ^ k1, 27) * p1 + p4
    h = _rotl(h ^ (word(src + 24, 4) * p1), 23) * p2 + p3
    for off in (28, 29, 30):
        h = _rotl(h ^ (txt[src + off] * p5), 11) * p1
    h ^= _shr(h, 33)
    h *= p2
    h ^= _shr(h, 29)
    h *= p3
    h ^= _shr(h, 32)
    return np.split(h.cpu().numpy().view(np.uint64), np.cumsum(nk)[:-1])


# --- match: Bloom-index batches -----------------------------------------------


class MatchPool:
    """``index['batches']`` COBS classic batches of ``index['docs']`` docs and
    ``index['rows']`` Bloom rows, written in the program's on-disk device
    cache layout (``words.npy`` uint32 [rows, ceil(docs/32)], ``meta.json``)
    under ``root/cache/<batch>``. Words are random at ``bit_density`` (the
    AND of two random words: 1/4); each species group of ``group_docs``
    consecutive docs then gets the bits of every canonical 31-mer of its
    planted sequences: one random source a group for reads, a genome of
    ``group_source_bp`` = [shortest, longest] bases (the lengths the same
    for every seed), or the genes of the configuration's gene pool, each in
    one group and ``second_batch_share`` of them in a group of a second
    batch too."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, root: Path, device: str):
        import torch

        ix, q = cfg["index"], cfg["queries"]
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.root = Path(root)
        self.rows, self.docs, self.k = ix["rows"], ix["docs"], ix["term_size"]
        self.wp = -(-self.docs // 32)
        self.group = ix["group_docs"]
        nb, per = ix["batches"], self.docs // self.group
        self.batches = [f"gbidx_{b:02d}__01" for b in range(nb)]
        self.groups = [(b, g) for b in range(nb) for g in range(per)]
        rng = rng_for(seed, 1)
        self.doc_names = [
            [f"{int(r):04d}_SAMG{b:02d}{d:05d}" for d, r in enumerate(rng.integers(0, 10000, self.docs))]
            for b in range(nb)
        ]
        planted: list[tuple[bytes, list]] = []  # (sequence, [(batch, group)])
        if q["kind"] == "reads":
            lo, hi = traffic["group_source_bp"]  # lengths fixed for every seed, content by the seed
            lens = rng_for(0, 7).integers(lo, hi + 1, len(self.groups))
            self.sources = [seq_bytes(rng.integers(0, 4, int(n)).astype(np.uint8)) for n in lens]
            planted = [(s, [bg]) for s, bg in zip(self.sources, self.groups)]
            hot = rng.choice(len(self.groups), traffic["hot_groups"], replace=False)
            self.hot = np.sort(hot)
        else:
            lens, fixed_id = gene_pool(q, rng)
            self.genes = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
            self.gene_groups = []
            every = round(1 / traffic["second_batch_share"])
            for fid in fixed_id:
                first = self.groups[int(rng.integers(0, len(self.groups)))]
                where = [first]
                if fid % every == every - 1:
                    b2 = (first[0] + int(rng.integers(1, nb))) % nb
                    where.append((b2, int(rng.integers(0, per))))
                self.gene_groups.append(where)
            planted = [(seq_bytes(g), w) for g, w in zip(self.genes, self.gene_groups)]
        hashes = kmer_hashes_device([s for s, _ in planted], device)
        self.batch_list = self.root / "batches.txt"
        self.root.mkdir(parents=True, exist_ok=True)
        self.batch_list.write_text("".join(b + "\n" for b in self.batches))
        dev = torch.device(device)
        for b, name in enumerate(self.batches):
            gen = torch.Generator(device=dev).manual_seed(int(rng_for(seed, 2, b).integers(0, 2**63)))

            def rand():
                return torch.randint(-(2**31), 2**31, (self.rows, self.wp), dtype=torch.int32, device=dev,
                                     generator=gen)

            w = rand() & rand()
            tail = self.docs - 32 * (self.wp - 1)
            if tail < 32:
                w[:, -1] &= (1 << tail) - 1
            words = w.cpu().numpy().view(np.uint32)
            del w
            keys, masks = [], []
            for h, (_, where) in zip(hashes, planted):
                for bb, g in where:
                    if bb != b:
                        continue
                    d0 = g * self.group
                    keys.append(cobs_ref.bloom_rows(h, self.rows) * self.wp + d0 // 32)
                    masks.append(np.full(len(h), ((1 << self.group) - 1) << (d0 % 32), np.uint32))
            if keys:
                kk, mm = np.concatenate(keys), np.concatenate(masks)
                order = np.argsort(kk, kind="stable")
                kk, mm = kk[order], mm[order]
                first = np.flatnonzero(np.r_[True, kk[1:] != kk[:-1]])
                words.reshape(-1)[kk[first]] |= np.bitwise_or.reduceat(mm, first)
            d = self.cache / name
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / "words.npy", words)
            (d / "meta.json").write_text(json.dumps(
                {"term_size": self.k, "num_hashes": 1, "signature_size": self.rows, "doc_names": self.doc_names[b]}
            ))

    @property
    def cache(self) -> Path:
        return self.root / "cache"

    def words(self, b: int) -> np.ndarray:
        return np.load(self.cache / self.batches[b] / "words.npy")

    def pipeline_config(self) -> dict:
        return {"batches": str(self.batch_list), "decompression_dir": str(self.cache)}

    def job(self, j: int) -> Job:
        t, q = self.traffic, self.cfg["queries"]
        rng = rng_for(self.seed, 3, j)
        names, seqs, truth = [], [], []
        if q["kind"] == "reads":
            n, ln = t["queries_per_job"], q["length"]
            for i in range(n):
                if seqs and int((i + 1) * t["dup_share"]) > int(i * t["dup_share"]):
                    src = int(rng.integers(0, len(seqs)))
                    s = seqs[src] if rng.random() < 0.5 else revcomp(seqs[src])
                    tr = truth[src]
                elif i % t["unplanted_every"] == t["unplanted_every"] - 1:
                    s, tr = seq_bytes(rng.integers(0, 4, ln).astype(np.uint8)), None
                else:
                    gi = (int(self.hot[rng.integers(0, len(self.hot))]) if rng.random() < t["hot_share"]
                          else int(rng.integers(0, len(self.groups))))
                    src_seq = self.sources[gi]
                    p = int(rng.integers(0, len(src_seq) - ln + 1))
                    s = src_seq[p : p + ln]
                    if rng.random() < t["rc_share"]:
                        s = revcomp(s)
                    tr = [self.groups[gi]]
                names.append(f"r{j:04d}_{i:05d}")
                seqs.append(s)
                truth.append(tr)
        else:
            for i, (g, where) in enumerate(zip(self.genes, self.gene_groups)):
                s = seq_bytes(mutate(g, t["sub_rate"], rng))
                if rng.random() < t["rc_share"]:
                    s = revcomp(s)
                names.append(f"g{j:04d}_{i:04d}")
                seqs.append(s)
                truth.append(where)
        return Job(names, seqs, truth)

    def write_inputs(self, job: Job, path: Path) -> None:
        """The job's read set as a lab hands it over: FASTQ for reads
        (qualities 'I'), FASTA for genes."""
        with open(path, "w") as f:
            if self.cfg["queries"]["kind"] == "reads":
                f.write("".join(f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n" for n, s in zip(job.names, job.seqs)))
            else:
                f.write("".join(f">{n}\n{s.decode()}\n" for n, s in zip(job.names, job.seqs)))


# --- map: batches of strain genomes --------------------------------------------


class MapPool:
    """``genomes['batches']`` batches of ``genomes['strains']`` strains each:
    an ancestor whose length and number of contigs are spread over the
    ``length`` and ``contigs`` ranges by the batch's place (the same for
    every seed), cut where the seed says, and each strain the ancestor with substitutions at
    ``strain_snp_rate`` (so the strains share coordinates). Each batch is a
    ``<batch>.tar.xz`` of one FASTA member a strain under ``root/asms``. For
    genes, the configuration's gene pool is a set of loci in the ancestors,
    carried by every strain of that batch."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, root: Path):
        g, q = cfg["genomes"], cfg["queries"]
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.root = Path(root)
        rng = rng_for(seed, 4)
        nb, ns = g["batches"], g["strains"]
        self.batches = [f"gbasm_{b:02d}__01" for b in range(nb)]
        self.accs = [[f"SAMA{b:02d}{s:03d}" for s in range(ns)] for b in range(nb)]
        self.contigs: dict[str, dict[str, np.ndarray]] = {}  # acc -> contig -> codes
        self.cnames: list[list[str]] = []  # per batch, contig suffixes
        (self.root / "asms").mkdir(parents=True, exist_ok=True)
        for b in range(nb):
            # sizes fixed by the batch's place, content by the seed
            total = int(g["length"][0] + (g["length"][1] - g["length"][0]) * (b + 0.5) / nb)
            n_c = g["contigs"][0] + b % (g["contigs"][1] - g["contigs"][0] + 1)
            cuts = np.sort(rng.integers(total // 10, total - total // 10, n_c - 1)) if n_c > 1 else np.zeros(0, np.int64)
            bounds = [0, *cuts.tolist(), total]
            anc = rng.integers(0, 4, total).astype(np.uint8)
            self.cnames.append([f"contig{c:05d}" for c in range(n_c)])
            with tarfile.open(self.root / "asms" / f"{self.batches[b]}.tar.xz", mode="w:xz", preset=0) as tar:
                for acc in self.accs[b]:
                    strain = mutate(anc, g["strain_snp_rate"], rng)
                    ctg = {f"{acc}.{self.cnames[b][c]}": strain[bounds[c] : bounds[c + 1]] for c in range(n_c)}
                    self.contigs[acc] = ctg
                    data = b"".join(b">" + n.encode() + b"\n" + seq_bytes(s) + b"\n" for n, s in ctg.items())
                    info = tarfile.TarInfo(name=f"{acc}.fa")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
        if q["kind"] == "genes":
            lens, fixed_id = gene_pool(q, rng)
            self.loci = []  # (batch, contig, position, length, the gene's place in the fixed set)
            for ln, fid in zip(lens, fixed_id):
                b = int(fid % nb)
                c = int(rng.integers(0, len(self.cnames[b])))
                clen = len(self.contigs[self.accs[b][0]][f"{self.accs[b][0]}.{self.cnames[b][c]}"])
                self.loci.append((b, c, int(rng.integers(0, clen - ln)), int(ln), int(fid)))
        self.batch_list = self.root / "batches.txt"
        self.batch_list.write_text("".join(b + "\n" for b in self.batches))

    def pipeline_config(self) -> dict:
        return {"batches": str(self.batch_list), "download_dir": str(self.root),
                "decompression_dir": str(self.root / "cache")}

    def contig(self, b: int, s: int, c: int) -> tuple[str, np.ndarray]:
        acc = self.accs[b][s]
        name = f"{acc}.{self.cnames[b][c]}"
        return name, self.contigs[acc][name]

    def job(self, j: int) -> Job:
        t, q = self.traffic, self.cfg["queries"]
        rng = rng_for(self.seed, 5, j)
        nb, ns = len(self.batches), len(self.accs[0])
        names, seqs, truth, cands = [], [], [], []

        def take(b, s, c, pos, span, dele_at, dele_bp, i):
            name, ctg = self.contig(b, s, c)
            codes = ctg[pos : pos + span]
            if dele_bp:
                codes = np.concatenate([codes[:dele_at], codes[dele_at + dele_bp :]])
            codes = mutate(codes, t["sub_rate"], rng)
            strand = int(rng.random() < t["rc_share"])
            sq = seq_bytes(codes)
            return (revcomp(sq) if strand else sq), (b, s, name, pos, span, strand)

        if q["kind"] == "reads":
            ln = q["length"]
            for i in range(t["queries_per_job"]):
                b, s = int(rng.integers(0, nb)), int(rng.integers(0, ns))
                c = int(rng.integers(0, len(self.cnames[b])))
                clen = len(self.contig(b, s, c)[1])
                pos = int(rng.integers(0, clen - 2 * ln))
                if i % t["chimera_every"] == t["chimera_every"] - 1:
                    half = ln // 2
                    b2, s2 = (b + 1) % nb, int(rng.integers(0, ns))
                    other = self.contig(b2, s2, 0)[1]
                    p2 = int(rng.integers(0, len(other) - ln))
                    sq = seq_bytes(mutate(np.concatenate([self.contig(b, s, c)[1][pos : pos + half],
                                                          other[p2 : p2 + ln - half]]), t["sub_rate"], rng))
                    tr = None
                else:
                    dele = t["deletion_bp"] if i % t["deletion_every"] == 0 else 0
                    sq, tr = take(b, s, c, pos, ln + dele, ln // 2, dele, i)
                names.append(f"a{j:04d}_{i:05d}")
                seqs.append(sq)
                truth.append(tr)
                cands.append(self.accs[b])
        else:
            for i, (b, c, pos, ln, fid) in enumerate(self.loci):
                s = int(rng.integers(0, ns))
                dele = t["deletion_bp"] if fid % t["deletion_every"] == 0 else 0
                at = int(rng.integers(ln // 4, 3 * ln // 4)) if dele else 0
                sq, tr = take(b, s, c, pos, ln, at, dele, i)
                names.append(f"m{j:04d}_{i:04d}")
                seqs.append(sq)
                truth.append(tr)
                cands.append(self.accs[b])
        return Job(names, seqs, truth, cands)

    def write_inputs(self, job: Job, inter: Path, stem: str) -> None:
        """The merged queries and the 04_filter the map targets start from."""
        (inter / "01_queries_merged").mkdir(parents=True, exist_ok=True)
        (inter / "04_filter").mkdir(parents=True, exist_ok=True)
        with open(inter / "01_queries_merged" / f"{stem}.fa", "w") as f:
            f.write("".join(f">{n}\n{s.decode()}\n" for n, s in zip(job.names, job.seqs)))
        with open(inter / "04_filter" / f"{stem}.fa", "w") as f:
            f.write("".join(f">{n} {','.join(c)}\n{s.decode()}\n" for n, s, c in zip(job.names, job.seqs, job.cands)))
