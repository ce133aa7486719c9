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
