"""Synthetic golden-test fixture: the network-free `make test` equivalent
(the port's own copy of ``phylign_tpu/testing.py``; the same trees from the
same seeds).

The reference's only test is an end-to-end golden run against 3 real Zenodo
batches, diffing SAM columns 1-3 (its Makefile:40-55). Those artifacts need
the network, so ``make_fixture`` generates a fully synthetic workload with a
*constructively known* answer:

  * 4 query files x 10 reads of 150 bp (reference naming style);
  * N batches x 4 genomes x 2 contigs; selected reads are planted into
    genome contigs forward, reverse-complemented, or with one mismatch;
  * the expected (qname, flag, rname) triples follow from the construction:
    with cobs_kmer_thres=0.7 only planted genomes can pass the k-mer
    threshold (a spurious candidate would need >=84/120 Bloom
    false-positive k-mers), and each planted read aligns to its contig with
    the strand it was planted in.

`run_golden_test` builds the fixture, runs the full pipeline through the
public Pipeline API on a torch device, and compares the aggregated
summary's columns 1-3 against the oracle, mirroring the reference's DIFF
contract.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from phylign_tpu_torch.io import asmtar
from phylign_tpu_torch.io import cobs as cobs_io
from phylign_tpu_torch.ops.chain import ChainResult

READ_LEN = 150
GENOMES_PER_BATCH = 4
CONTIGS_PER_GENOME = 2


def _rand_seq(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))


def _revcomp(seq: bytes) -> bytes:
    from phylign_tpu_torch.kmer import revcomp

    return revcomp(seq)


def make_fixture(
    workdir: Path, n_batches: int = 3, seed: int = 42
) -> list[Path]:
    """Generate input/, data/, cobs/, asms/, config.yaml and the oracle file.

    Returns the list of created top-level paths. The oracle
    (data/fixture_oracle.json) stores the expected (qname, flag, rname)
    triples grouped by batch, in final-output order.
    """
    rng = np.random.default_rng(seed)
    workdir = Path(workdir)
    for d in ("input", "data", "cobs", "asms"):
        (workdir / d).mkdir(parents=True, exist_ok=True)

    # ---- queries: 4 files x 10 reads, names "1A".."4J" ----------------------
    read_names = [f"{i}{chr(ord('A') + j)}" for i in range(1, 5) for j in range(10)]
    reads: dict[str, bytes] = {n: _rand_seq(rng, READ_LEN) for n in read_names}

    batches = [f"synthetic_{chr(ord('a') + b)}__01" for b in range(n_batches)]

    # ---- plant reads into genomes -------------------------------------------
    # expected[batch] = list of (genome, qname, flag, contig) in plant order;
    # record order is reconstructed below.
    plants: dict[str, list[tuple[str, str, int, int]]] = {b: [] for b in batches}
    genomes: dict[str, dict[str, list[bytearray]]] = {}
    for bi, batch in enumerate(batches):
        gdict: dict[str, list[bytearray]] = {}
        for g in range(GENOMES_PER_BATCH):
            acc = f"SAMF{bi:02d}{g:04d}"
            gdict[acc] = [
                bytearray(_rand_seq(rng, int(rng.integers(2500, 5000))))
                for _ in range(CONTIGS_PER_GENOME)
            ]
        genomes[batch] = gdict

    # deterministic planting plan over the first 3*n_batches*4 reads:
    # mode cycles fwd / rc / mismatch; a few reads planted twice (tie case),
    # the last 4 reads stay unplanted (no candidates anywhere).
    plan_reads = read_names[:-4]
    accs_cycle = [
        (b, acc) for b in batches for acc in sorted(genomes[b])
    ]
    used: dict[tuple[str, str, int], list[int]] = {}
    for i, qname in enumerate(plan_reads):
        mode = i % 3  # 0 fwd, 1 rc, 2 mismatch
        targets = [accs_cycle[i % len(accs_cycle)]]
        if i % 7 == 0:  # tie: plant exactly into a second genome too
            targets.append(accs_cycle[(i + 1) % len(accs_cycle)])
            # tie reads must be planted EXACTLY: a mismatch plant scores
            # 89 + Bloom-false-positive noise, which differs per genome and
            # breaks the tie at nb_best_hits=1 (correct pipeline behavior,
            # but then the second record is legitimately filtered out)
            mode = i % 2
        for batch, acc in targets:
            contig_i = int(rng.integers(0, CONTIGS_PER_GENOME))
            contig = genomes[batch][acc][contig_i]
            # non-overlapping placement: planting over an earlier plant would
            # destroy that read's site and break the oracle
            key = (batch, acc, contig_i)
            taken = used.setdefault(key, [])
            for _ in range(100):
                pos = int(rng.integers(0, len(contig) - READ_LEN))
                if all(
                    pos + READ_LEN <= s or pos >= s + READ_LEN for s in taken
                ):
                    break
            else:  # pragma: no cover - contigs are far larger than plants
                raise RuntimeError("could not place read without overlap")
            taken.append(pos)
            read = reads[qname]
            if mode == 1:
                planted = _revcomp(read)
                flag = 16
            else:
                planted = read
                flag = 0
            if mode == 2:
                # genome keeps a 1-base variant: read has one mismatch
                planted = bytearray(planted)
                planted[70] = ord("ACGT"[(planted[70] % 4 + 1) % 4])
                planted = bytes(planted)
            contig[pos : pos + READ_LEN] = planted
            plants[batch].append((acc, qname, flag, contig_i))

    # ---- write queries ------------------------------------------------------
    suffixes = ["fastq", "fq", "fasta", "fa"]
    created = []
    for i in range(4):
        p = workdir / "input" / f"reads_{i + 1}.{suffixes[i]}"
        with open(p, "w") as f:
            for j in range(10):
                name = read_names[i * 10 + j]
                seq = reads[name].decode()
                if suffixes[i] in ("fastq", "fq"):
                    f.write(f"@{name}\n{seq}\n+\n{'I' * READ_LEN}\n")
                else:
                    f.write(f">{name}\n{seq}\n")
        created.append(p)

    # ---- write batches: cobs index + assembly tar ---------------------------
    acc_lists = []
    for bi, batch in enumerate(batches):
        gdict = genomes[batch]
        names = sorted(gdict)
        docs = []
        tar_genomes = []
        for gi, acc in enumerate(names):
            contigs = [
                (f"{acc}.contig{ci + 1:05d}", bytes(c))
                for ci, c in enumerate(gdict[acc])
            ]
            # doc names carry the reference's random sort prefix "rid_"
            rid = f"{int(rng.integers(0, 10000)):04d}"
            docs.append((f"{rid}_{acc}", [bytes(c) for c in gdict[acc]]))
            tar_genomes.append((acc, contigs))
        idx = cobs_io.build_classic_index(docs, term_size=31, fpr=0.1)
        cobs_io.write_classic_index(
            workdir / "cobs" / f"{batch}.cobs_classic.xz", idx
        )
        asmtar.write_batch_tar(workdir / "asms" / f"{batch}.tar.xz", tar_genomes)
        acc_lists.append((batch, ",".join(names)))

    (workdir / "data" / "batches_small.txt").write_text(
        "".join(b + "\n" for b in batches)
    )
    (workdir / "data" / "661k_batches.txt").write_text(
        "".join(f"{b}\t{accs}\n" for b, accs in acc_lists)
    )

    # ---- expected output oracle ---------------------------------------------
    # final-output order: batches in list order; per batch genomes in tar
    # (=sorted accession) order; per genome its planted queries in merged
    # query order (read_names order).
    order = {n: i for i, n in enumerate(read_names)}
    oracle: list[list[str | int]] = []
    for batch in batches:
        oracle.append([batch])  # banner marker
        per_genome: dict[str, list[tuple[str, int, int]]] = {}
        for acc, qname, flag, contig_i in plants[batch]:
            per_genome.setdefault(acc, []).append((qname, flag, contig_i))
        for acc in sorted(per_genome):
            for qname, flag, contig_i in sorted(
                per_genome[acc], key=lambda t: order[t[0]]
            ):
                oracle.append([qname, flag, f"{acc}.contig{contig_i + 1:05d}"])
    (workdir / "data" / "fixture_oracle.json").write_text(json.dumps(oracle))

    # ---- config -------------------------------------------------------------
    (workdir / "config.yaml").write_text(
        "batches: data/batches_small.txt\n"
        "cobs_kmer_thres: 0.7\n"
        "nb_best_hits: 1\n"
        "max_ram_gb: 4\n"
    )
    created += [workdir / "config.yaml", workdir / "data" / "fixture_oracle.json"]
    return created


def run_reference_golden_test(
    workdir: Path,
    golden_xz: str | Path,
    batches_file: str | Path,
    inputs: list[str],
    device: str = "cuda",
) -> bool:
    """The reference's `make test` oracle against REAL data: run the pipeline
    on ``device`` over the given batches (cobs/ + asms/ must be
    pre-downloaded under workdir) with nb_best_hits=1 and diff columns 1-3
    of the output against a golden sam_summary (the reference's
    Makefile:40-55; golden file:
    data/reads_1___reads_2___reads_3___reads_4.sam_summary.xz). Requires the
    Zenodo artifacts, so it cannot run in a network-less environment — the
    synthetic run_golden_test covers CI there."""
    import sys

    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.io.sam import summary_first3
    from phylign_tpu_torch.pipeline.stages import Pipeline

    cfg = Config(batches=str(batches_file), nb_best_hits=1)
    pl = Pipeline(cfg, workdir, device=device)
    out = pl.run_all(inputs)
    # banner lines are compared too (summary_first3 normalizes them to the
    # batch stem; the emitted banner bytes themselves are workdir-relative
    # and byte-identical to the reference's `make test` output)
    got = summary_first3(out)
    want = summary_first3(golden_xz)
    if got != want:
        gs, ws = set(got), set(want)
        sys.stderr.write(
            f"golden mismatch: {len(ws - gs)} missing, {len(gs - ws)} extra, "
            f"{len(got)} vs {len(want)} records\n"
        )
        return False
    return True


def run_golden_test(workdir: Path, device: str = "cuda") -> bool:
    """Build fixture (if absent), run the pipeline on ``device``, diff
    columns 1-3."""
    import difflib
    import sys

    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.io.sam import summary_first3
    from phylign_tpu_torch.pipeline.stages import Pipeline

    workdir = Path(workdir)
    if not (workdir / "data" / "fixture_oracle.json").exists():
        make_fixture(workdir)
    cfg = Config.from_yaml(workdir / "config.yaml")
    pl = Pipeline(cfg, workdir, device=device)
    inputs = sorted(str(p) for p in (workdir / "input").iterdir())
    out = pl.run_all(inputs)

    got = summary_first3(out)
    want_raw = json.loads((workdir / "data" / "fixture_oracle.json").read_text())
    want = [
        (w[0],) if len(w) == 1 else (str(w[0]), str(w[1]), str(w[2]))
        for w in want_raw
    ]
    if got != want:
        a = ["\t".join(t) for t in want]
        b = ["\t".join(t) for t in got]
        sys.stderr.write("\n".join(difflib.unified_diff(a, b, "expected", "got", lineterm="")))
        sys.stderr.write("\n")
        return False
    return True


def write_perf_reads(
    workdir: Path,
    flat: list[tuple[str, bytes]],
    n_reads: int,
    read_seed: int,
    hot_genomes: int = 64,
    hot_frac: float = 0.8,
    dup_frac: float = 0.15,
) -> None:
    """The perf fixture's query file, with realistic read-set structure:

    * ``hot_frac`` of the reads come from ``hot_genomes`` genomes (coverage
      clustering — overlapping reads that share k-mers, the regime the
      match dedup path targets), the rest from the whole collection;
    * ``dup_frac`` exact duplicates (PCR-duplicate analogue; the matcher's
      row-set dedup collapses these);
    * every other read reverse-complemented, 1/64 unplanted (junk).
    """
    read_rng = np.random.default_rng(read_seed)
    from phylign_tpu_torch.kmer import revcomp

    hot = flat[: max(1, min(hot_genomes, len(flat)))]
    seqs: list[bytes] = []
    for i in range(n_reads):
        if dup_frac > 0 and seqs and read_rng.random() < dup_frac:
            seqs.append(seqs[int(read_rng.integers(0, len(seqs)))])
            continue
        if i % 64 == 63:
            seqs.append(_rand_seq(read_rng, READ_LEN))  # unplanted
            continue
        pool = hot if read_rng.random() < hot_frac else flat
        _, gseq = pool[int(read_rng.integers(0, len(pool)))]
        pos = int(read_rng.integers(0, len(gseq) - READ_LEN))
        seq = gseq[pos : pos + READ_LEN]
        seqs.append(revcomp(seq) if i % 2 else seq)
    with open(workdir / "input" / "perf_reads.fq", "w") as f:
        for i, seq in enumerate(seqs):
            f.write(f"@pr{i:05d}\n{seq.decode()}\n+\n{'I' * READ_LEN}\n")


def make_perf_fixture(
    workdir: Path,
    n_batches: int = 2,
    genomes_per_batch: int = 32,
    n_reads: int = 2048,
    seed: int = 100,
    read_seed: int | None = None,
    genome_len: tuple[int, int] = (20_000, 40_000),
    fpr: float = 0.01,
    reads_only: bool = False,
) -> list[tuple[str, bytes]]:
    """A larger synthetic corpus for end-to-end throughput measurement
    (the chip smoke test and the port's pipeline tests): ``n_reads`` 150 bp reads over
    ``n_batches x genomes_per_batch`` genomes with the standard on-disk
    layout and the read-set structure of write_perf_reads.

    ``read_seed`` draws the READS from an independent stream so repeated
    runs can share an identical database (the production shape: the 305
    Zenodo batches are fixed across query workloads) while queries vary —
    that lets a second run exercise the content-hash device index cache
    exactly like a repeated production run would. ``reads_only=True`` skips
    the database build entirely (same ``seed`` => same genomes) and only
    rewrites the query file, so warm and timed runs can share one workdir.
    Returns the flat (accession, genome) list."""
    rng = np.random.default_rng(seed)
    workdir = Path(workdir)
    for d in ("input", "data", "cobs", "asms"):
        (workdir / d).mkdir(parents=True, exist_ok=True)

    batches = [f"perf_{bi:02d}__01" for bi in range(n_batches)]
    genomes: dict[str, dict[str, bytes]] = {}
    flat: list[tuple[str, bytes]] = []
    for bi, batch in enumerate(batches):
        gdict = {}
        for g in range(genomes_per_batch):
            acc = f"SAMP{bi:02d}{g:04d}"
            gdict[acc] = _rand_seq(rng, int(rng.integers(*genome_len)))
            flat.append((acc, gdict[acc]))
        genomes[batch] = gdict

    write_perf_reads(
        workdir, flat, n_reads,
        read_seed=seed if read_seed is None else read_seed,
    )
    if reads_only:
        return flat

    from phylign_tpu_torch.io import asmtar
    from phylign_tpu_torch.io import cobs as cobs_io

    for batch in batches:
        docs = [(acc, [seq]) for acc, seq in sorted(genomes[batch].items())]
        idx = cobs_io.build_classic_index(docs, term_size=31, fpr=fpr)
        cobs_io.write_classic_index(
            workdir / "cobs" / f"{batch}.cobs_classic.xz", idx
        )
        asmtar.write_batch_tar(
            workdir / "asms" / f"{batch}.tar.xz",
            [(acc, [(f"{acc}.c1", seq)]) for acc, seq in sorted(genomes[batch].items())],
        )

    (workdir / "data" / "batches_small.txt").write_text(
        "".join(b + "\n" for b in batches)
    )
    (workdir / "config.yaml").write_text(
        "batches: data/batches_small.txt\n"
        "nb_best_hits: 5\n"
        "cobs_kmer_thres: 0.7\n"
        # the reference's own recommended warm-run setup: cache decompressed
        # indexes on disk across runs (config.yaml:96-110,131-138) — here the
        # cached artifact is the device-format repack, so repeated runs skip
        # the xz decode (~0.3 s/batch on this host)
        "index_load_mode: mem-disk\n"
        "keep_cobs_indexes: true\n"
        "decompression_dir: cobs_device_cache\n"  # survives intermediate/ resets
    )
    return flat


#: ChainResult's fields, in order: the keys of flush_case's chain buckets
CHAIN_FIELDS = ChainResult._fields


def flush_case(rng, p: int, lmax: int = 160, band: int = 128, n_sup: int = 2, n_genomes: int = 4):
    """Synthetic inputs of one fused align flush (``align/fused.select_extend``)
    as numpy arrays made from ``rng``, for holding its kernels to their
    plain versions: ``(chains, inputs, kw)`` with chains a list of three
    anchor buckets' ChainResult fields (dicts, CHAIN_FIELDS, each bucket
    padded to a power of two like the engine's), inputs (cand_map,
    pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen) and the
    keyword arguments of the sr preset.

    Genomes of 1-3 contigs in a 2-bit pool (each 4-aligned); 150 bp reads
    (1 in 11 shorter) planted on either strand with 1% substitutions, 1 in
    13 with a run of 15 in the middle (a z-drop), 1 in 9 with a 4-base
    deletion, and the primary chain on their diagonal. Pair
    kinds in turn: planted reads; no candidate at all; every candidate
    under the thresholds; a read at a contig edge (window over it); a
    chimera with one or two split segments; both strands tied on score;
    a primary off its read's diagonal. Other candidates overlap the
    primary or not, scores come from few values so ties occur, alt scores
    are positive or -1e30; the last 8 pairs are padding."""
    neg = np.float32(-1e30)
    genomes, contigs = [], []
    for _ in range(n_genomes):
        total = int(rng.integers(20_000, 60_000))
        cuts = np.sort(rng.integers(1_000, total - 1_000, int(rng.integers(0, 3))))
        bounds = [0, *cuts.tolist(), total]
        genomes.append(rng.integers(0, 4, total).astype(np.uint8))
        contigs.append([(bounds[c], bounds[c + 1] - bounds[c]) for c in range(len(bounds) - 1)])
    bases, cst_l, clen_l, parts, cur = [], [], [], [], 0
    for g, codes in enumerate(genomes):
        bases.append(cur)
        cst_l += [cur + s for s, _ in contigs[g]]
        clen_l += [n for _, n in contigs[g]]
        pad = (-len(codes)) % 4
        parts.append(np.concatenate([codes, np.zeros(pad, np.uint8)]))
        cur += len(codes) + pad
    pool = np.concatenate(parts)
    a4 = pool.reshape(-1, 4)
    pool_pack = a4[:, 0] | (a4[:, 1] << 2) | (a4[:, 2] << 4) | (a4[:, 3] << 6)
    pool_pack = np.pad(pool_pack, (0, max(1 << 14, 1 << int(np.ceil(np.log2(len(pool_pack))))) - len(pool_pack)))
    nc = max(8, 1 << int(np.ceil(np.log2(len(cst_l)))))
    cst = np.full(nc, np.iinfo(np.int32).max, np.int32)
    cst[: len(cst_l)] = cst_l
    clen = np.zeros(nc, np.int32)
    clen[: len(clen_l)] = clen_l

    sets = []  # (pair, strand, fields of one ChainResult row)
    scores = np.float32([20, 35, 40, 40, 60, 80, 80, 120, 150])
    q_len = np.zeros(p, np.int32)
    qc = np.zeros((p, lmax), np.uint8)
    pair_base = np.zeros(p, np.int32)
    pair_reflen = np.ones(p, np.int32)

    def chain_row(score, count, qs, qe, rs):
        alt = rng.choice(scores) if rng.random() < 0.4 else neg
        aq = int(rng.integers(0, 60))
        row = dict(score=score, count=count, qs=qs, qe=qe, rs=rs, re=rs + (qe - qs),
                   alt_score=alt, alt_qs=aq, alt_qe=aq + int(rng.integers(21, 90)),
                   alt_rs=int(rng.integers(0, 50_000)), alt_re=int(rng.integers(0, 50_000)))
        sup = [[neg, 0, 0, 0, 0, 0] for _ in range(n_sup)]
        return row, sup

    for i in range(p - 8):
        kind = i % 7
        g = int(rng.integers(n_genomes))
        codes = genomes[g]
        pair_base[i], pair_reflen[i] = bases[g], len(codes)
        c0, cn = contigs[g][int(rng.integers(len(contigs[g])))]
        length = 150 if i % 11 else int(rng.integers(60, 150))
        if kind == 3:  # at a contig edge: the window runs over it
            pos = c0 + int(rng.integers(0, 20)) if rng.random() < 0.5 else c0 + cn - length - int(rng.integers(0, 20))
        else:
            pos = c0 + int(rng.integers(0, cn - length - 8))
        seg = codes[pos : pos + length + 4].copy()
        seg = np.concatenate([seg[: length // 2], seg[length // 2 + 4 :]]) if i % 9 == 0 else seg[:length]
        flip = rng.random(len(seg)) < 0.01
        if i % 13 == 7:  # a run of substitutions: a z-drop past 100 on the diagonal
            flip[len(seg) // 2 - 7 : len(seg) // 2 + 8] = True
        seg[flip] = (seg[flip] + 1) % 4
        strand = int(rng.integers(2))
        read = (3 - seg)[::-1] if strand else seg
        q_len[i] = len(read)
        qc[i, : len(read)] = read
        if kind == 1:
            continue  # no candidate on either strand
        qs = int(rng.integers(0, 12))
        qe = len(read) - int(rng.integers(0, 12))
        sc = np.float32(rng.choice(scores[2:]))
        cnt = int(rng.integers(2, 30))
        if kind == 2:  # under the score or the anchor-count threshold
            if rng.random() < 0.5:
                sc, cnt = np.float32(15), 5
            else:
                sc, cnt = np.float32(rng.choice([10, 19.5, 60])), int(rng.integers(0, 2))
        rs = pos + qs + (int(rng.integers(-3, 4)) if kind == 6 else 0)
        own, own_sup = chain_row(sc, cnt, qs, qe, rs)
        other_q = int(rng.integers(0, 80))
        other_sc = sc if kind == 5 else np.float32(rng.choice(scores))
        other, other_sup = chain_row(other_sc, int(rng.integers(1, 20)), other_q,
                                     other_q + int(rng.integers(21, 80)), int(rng.integers(0, len(codes))))
        if kind == 4:  # a chimera: one or two segments beside the primary
            own["qe"] = own["qs"] + 70
            own["re"] = own["rs"] + 70
            for j in range(int(rng.integers(1, n_sup + 1)) if n_sup else 0):
                q0 = 75 + 30 * j
                sup_rs = int(rng.integers(0, len(codes)))
                (own_sup if rng.random() < 0.5 else other_sup)[j] = [
                    np.float32(rng.choice(scores[2:])), int(rng.integers(2, 20)), q0, q0 + 30, sup_rs, sup_rs + 30]
        rows = {strand: (own, own_sup), 1 - strand: (other, other_sup)}
        for s in (0, 1):
            if s == 1 - strand and rng.random() < 0.35:
                continue  # no anchors on the other strand
            sets.append((i, s, rows[s]))

    buckets = [[] for _ in range(3)]
    for item in sets:
        buckets[int(rng.integers(3))].append(item)
    cand_map = np.zeros((p, 2), np.int32)
    chains, offset = [], 0
    pad_cm = []
    for items in buckets:
        pb = max(8, 1 << (len(items) - 1).bit_length())
        f = {name: np.zeros(pb, np.float32 if name.endswith("score") else np.int32) for name in CHAIN_FIELDS[:11]}
        for name in CHAIN_FIELDS[11:]:
            f[name] = np.zeros((pb, n_sup), np.float32 if name == "sup_score" else np.int32)
        # padding rows: what chain_anchors gives an all-padding set
        f["score"][:] = neg
        f["alt_score"][:] = neg
        f["count"][:] = 1
        f["sup_score"][:] = neg
        f["sup_count"][:] = 1
        for r, (i, s, (row, sup)) in enumerate(items):
            for name, v in row.items():
                f[name][r] = v
            for j, vals in enumerate(sup):
                for name, v in zip(CHAIN_FIELDS[11:], vals):
                    f[name][r, j] = v
            cand_map[i, s] = offset + r
            pad_cm.append((i, s))
        chains.append(f)
        offset += pb
    have = np.zeros((p, 2), bool)
    for i, s in pad_cm:
        have[i, s] = True
    cand_map[~have] = offset  # the dummy set: no chain
    q4 = np.concatenate([qc, np.zeros((p, (-lmax) % 4), np.uint8)], axis=1).reshape(p, -1, 4)
    q_pack = q4[:, :, 0] | (q4[:, :, 1] << 2) | (q4[:, :, 2] << 4) | (q4[:, :, 3] << 6)
    kw = dict(lmax=lmax, wlen=lmax + band, half=band // 2, min_cnt=2, min_score=20.0,
              max_segments=n_sup + 1)
    return chains, (cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen), kw


def finish_case(rng, p: int, lmax: int, band: int, match: int, mismatch: int, ends: bool = False,
                qmax: int = 150):
    """Synthetic inputs of the checks after the extension (align/fused.
    _finish_ref, kernel B6c) as numpy arrays: (q_codes, rwin, lohi, head,
    q_len, ext_score, end_d). Each row's window holds its query on the
    diagonal end_d with mismatches where a warp's scans could go wrong:
    consecutive pairs and runs starting at or crossing a 32-column and a
    256-column boundary, a mismatch on lanes 0 and 31 of every 32 columns,
    a run of 15, the first and last column of one 8-column group (a later
    column's peak within a lane), a mismatch near the end of a long row
    after an earlier one (the count carried over tiles), random ones;
    some reads short, some windows cut by the contig, some scores off the
    gapless one or -1e30, head rows of random flag bits. q_len min(qmax,
    lmax). ``ends``: end_d at the window's ends, 0 and band (= wlen -
    lmax), on two rows in three. The pattern count (19) is prime, so every
    pattern meets every other per-row rule."""
    wlen = lmax + band
    patterns = [[], [32, 33], [64, 65, 66], [30, 31, 32, 33], [31, 32], [63, 64], [95, 96, 97],
                list(range(60, 75)), list(range(90, 106)),
                [j for t in range(0, 150, 32) for j in (t, t + 31) if j < 150], [0, 1], [148, 149], [96],
                [40, 47], [40, 46], list(range(248, 264)), [255, 256], [100, "tail"], [120, 127]]
    q = rng.integers(0, 4, (p, lmax)).astype(np.uint8)
    q_len = np.full(p, min(qmax, lmax), np.int32)
    q_len[::7] = rng.integers(1, q_len[0], len(q_len[::7]))
    end_d = rng.integers(0, band, p).astype(np.int32)
    if ends:
        end_d[::3], end_d[1::3] = 0, band
    rwin = rng.integers(0, 4, (p, wlen)).astype(np.uint8)
    lohi = np.tile(np.int32([0, wlen]), (p, 1))
    lohi[5::11] = (40, wlen - 30)
    ext = np.zeros(p, np.float32)
    for i in range(p):
        pat = [int(q_len[i]) - 6 if j == "tail" else j for j in patterns[i % len(patterns)]]
        cols = np.array([j for j in pat if 0 <= j < q_len[i]]
                        + (rng.choice(int(q_len[i]), min(4, int(q_len[i])), replace=False).tolist()
                           if i % 17 == 3 else []), np.int64)
        r = q[i].copy()
        r[cols] = (r[cols] + 1) % 4
        rwin[i, end_d[i] : end_d[i] + lmax] = r
        n = len(set(cols.tolist()))
        ext[i] = match * (q_len[i] - n) - mismatch * n - (8 if i % 9 == 4 else 0)
    ext[::23] = np.float32(-1e30)
    head = np.zeros((p, 4), np.int32)
    head[:, 2] = rng.integers(0, 256, p) & ~6  # F_DIAG and F_FULL are B6c's
    return q, rwin, lohi, head, q_len, ext, end_d


def window_padded(rwin, lohi, end_d, pad: int):
    """(rwin, lohi, end_d) with every window widened by ``pad`` copies of
    its first byte before it and of its last byte after it, and the
    columns shifted to match: the plain version's reading of an end_d up
    to ``pad`` columns outside the window when each column is clamped to
    the window (kernel B6c's reading), as numpy arrays."""
    wide = np.concatenate([np.repeat(rwin[:, :1], pad, 1), rwin, np.repeat(rwin[:, -1:], pad, 1)], axis=1)
    return wide, (lohi + pad).astype(np.int32), (end_d + pad).astype(np.int32)


def cold_case(rng, p: int, kind, n_out: int = 2, cap: int = 512):
    """Synthetic inputs of the cold-row compaction (``align/fused.
    _compact_cold``) as numpy arrays: (hot int32 [P, 4], cold_i int32 [P, 4
    + 6 * n_out + 5], cold_f f32 [P, n_out]); the flag words of ``kind``
    ("none": no row needed, "all": every row, "random", or ("at", k): the
    cap-th needed row on row k >= cap - 1, the rows after it needed at
    random) with random end_d bits above them, the cold rows random."""
    from phylign_tpu_torch.align.fused import F_FULL, F_HAS, F_PROBE, F_SUP0

    hot = np.zeros((p, 4), np.int32)
    hot[:, 0] = rng.integers(-99, 99, p)
    done = F_HAS | F_FULL  # a gapless primary: not needed
    if kind == "none":
        hot[:, 2] = rng.choice([done, 0], p)
    elif kind == "all":
        hot[:, 2] = rng.choice([F_HAS, F_SUP0 | F_FULL | F_HAS, F_PROBE, F_SUP0 << 1], p)
    elif kind == "random":
        hot[:, 2] = rng.choice([F_HAS, done, F_SUP0 | done, F_PROBE, 0], p)
    else:
        k = kind[1]
        hot[:, 2] = done
        hot[np.sort(rng.choice(k, cap - 1, replace=False)), 2] = F_HAS
        hot[k, 2] = F_PROBE
        hot[k + 1 :, 2] = rng.choice([F_HAS, done], p - k - 1)
    hot[:, 2] |= rng.integers(0, 128, p).astype(np.int32) << 8
    cold_i = rng.integers(-9, 9, (p, 4 + 6 * n_out + 5)).astype(np.int32)
    cold_f = rng.random((p, n_out)).astype(np.float32)
    return hot, cold_i, cold_f
