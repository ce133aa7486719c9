"""Synthetic fixture for the match path: the port's own copy of
``make_fixture`` from ``phylign_tpu/testing.py``, which gives the same tree
from the same seed.

  * 4 query files x 10 reads of 150 bp (reference naming style);
  * N batches x 4 genomes x 2 contigs; selected reads are planted into
    genome contigs forward, reverse-complemented, or with one mismatch;
  * the expected (qname, flag, rname) triples follow from the construction:
    with cobs_kmer_thres=0.7 only planted genomes can pass the k-mer
    threshold (a spurious candidate would need >=84/120 Bloom
    false-positive k-mers), and each planted read aligns to its contig with
    the strand it was planted in.
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
