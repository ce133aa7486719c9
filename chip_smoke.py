#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path (``match``, then ``map``: the
align stage, aggregation and stats) on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one GPU
    python3 chip_smoke.py --kernels-only --baseline-src OLD.cu
                                   # phase 2 only, with the kernels of an
                                   # older match_popcount.cu timed beside
    python3 chip_smoke.py --profile    # phase 7 aligns once more under
                                   # cProfile + torch.profiler, tables in
                                   # chiprun_out/align_profile.txt

Phases, each printing one JSON line:
  1 environment: versions, the card's name and power limit, and the
    kernels' build from phylign_tpu_torch/csrc/ (nvcc, sm_90a);
  2 kernels B1/B2 against match_scores_ref at the match stage's shapes
    (S = 2,000,000 Bloom rows x 68 words = 2,169 docs, 544 MB), bit-exact
    on every row set, timed with CUDA events over ROTATION row sets in
    turn (so the L2 does not serve one launch the last one's rows), with
    each case's distinct rows, bytes, bound and share of the bound;
  3 the synthetic fixture (three 1-hash batches + one 3-hash batch) end to
    end through ``python -m phylign_tpu_torch.cli match``; every 03_match
    file must equal the numpy oracle's rendering, and both kernels must
    have been launched;
  4 the match stage at full batch geometry: 4 batches of 2,000,000 rows x
    2,169 docs in the mem-disk device-cache layout, 10,240 reads of 150 bp
    (~15% duplicates); every planted read must reach its doc in 04_filter
    and a sample of reads must equal the oracle on the full-size index;
  5 kernels B3 (chain DP scan) and B4 (banded extension scan) against their
    plain versions at the align stage's shapes, bit-exact on every input
    set, timed with CUDA events over ROTATION input sets in turn, with each
    case's bytes, operations, bound and share of the bound;
  6 phase 3's fixture (with an assembly tar for its 3-hash batch) end to end
    through ``python -m phylign_tpu_torch.cli all`` on the card and again
    with ``--device cpu``: 05_map, sam_summary and stats must be identical,
    and B3/B4 must have been launched on the card;
  7 the align stage at full width: 2 batches x 8 genomes of 2-5 Mb in 1-3
    contigs, 16,384 reads of 150 bp with 5 candidates each (81,920 pairs,
    device_pair_chunk 16,384); >= 95% of the non-chimeric reads must map to
    their planted position, and a 2,048-read subset must give the same
    records on the CPU.
Then the kernel table, the card's label, and as the last line
``{"ok": true, "device": {...}}``. Any failure, or no CUDA device, exits
non-zero without that line. All data are made from fixed seeds.
"""

from __future__ import annotations

import gzip
import io
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
S, N_DOCS = 2_000_000, 2169
WP = (N_DOCS + 31) // 32  # 68 words
SOURCE = {
    "match_popcount_b1": "phylign_tpu_torch/csrc/match_popcount.cu",
    "match_popcount_b2": "phylign_tpu_torch/csrc/match_popcount.cu",
    "chain_scan": "phylign_tpu_torch/csrc/chain_scan.cu",
    "extend_scan": "phylign_tpu_torch/csrc/extend_scan.cu",
}
REPLACES = {
    "match_popcount_b1": "phylign_tpu/ops/match.py:276",
    "match_popcount_b2": "phylign_tpu/ops/match.py:403",
    # XLA scans, not Pallas kernels: the lax.scan of each function
    "chain_scan": "phylign_tpu/ops/chain.py:181",
    "extend_scan": "phylign_tpu/ops/extend.py:237",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


#: the H100's memory rate and its non-tensor 32-bit rate (NVIDIA's data
#: sheet, SXM, 700 W): the bounds of the kernel table
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
F32_OPS_PER_S = 67e12
#: row sets each kernel is timed over in rotation, so that the 50 MB L2
#: does not serve one launch the rows of the one before
ROTATION = 6
#: phase 2's cases: (kernel, Q, K, H); real slots 120 per query (a 150 bp
#: read), the rest padding, and the last 8 queries all padding
CASES = {
    # the hash path of a 1-hash index: Q=2048 queries, K=128 slots
    "b2_h1": ("match_popcount_b2", 2048, 128, 1),
    "b1_h1": ("match_popcount_b1", 2048, 128, 1),
    # a 3-hash index: K=96, Q=1000
    "b1_h3": ("match_popcount_b1", 1000, 96, 3),
    # K not a multiple of 32 (B1 only): 120 slots, none of them padding
    "b1_h1_k120": ("match_popcount_b1", 2048, 120, 1),
    # the calls phases 4 and 3 make: 9,216 (bucketed) unique reads on a
    # 1-hash batch; 1,024 reads on a 3-hash batch
    "b2_h1_q9216": ("match_popcount_b2", 9216, 128, 1),
    "b1_h3_q1024": ("match_popcount_b1", 1024, 128, 3),
}
#: the case of each kernel in the kernel table: its main-path call
MAIN_CASE = {"match_popcount_b2": "b2_h1_q9216", "match_popcount_b1": "b1_h3_q1024"}


def cuda_ms(fn, reps: int, n_args: int = 1) -> float:
    """Mean ms per call of fn(i), i cycling over n_args argument sets."""
    import torch

    for i in range(n_args):
        fn(i)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for r in range(reps):
        fn(r % n_args)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def gather_bound(rows, wp: int) -> dict:
    """The least time for one call: each distinct row read once (counted
    from these inputs, the padding row included), the row indices read
    once and the scores written once, at HBM_BYTES_PER_S; the operations,
    one 32-bit AND or add per gathered word, at INT32_OPS_PER_S."""
    import torch

    q, k, h = rows.shape
    distinct = int(torch.unique(rows).numel())
    nbytes = distinct * 4 * wp + rows.numel() * 4 + q * 32 * wp * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = q * k * h * wp / INT32_OPS_PER_S * 1e3
    return dict(distinct_rows=distinct, bytes=nbytes, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def random_words(gen, rows: int):
    """int32 [rows, WP] on the card: ~25% bit density (the AND of two
    random words), zero bits past doc N_DOCS."""
    import torch

    def r():
        return torch.randint(
            -(2**31), 2**31, (rows, WP), dtype=torch.int32, device="cuda",
            generator=gen,
        )

    w = r() & r()
    w[:, WP - 1] &= (1 << (N_DOCS - 32 * (WP - 1))) - 1
    return w


def case_rows(gen, q: int, k: int, h: int):
    import torch

    rows = torch.randint(0, S, (q, k, h), dtype=torch.int32, device="cuda", generator=gen)
    rows[:, 120:] = S
    rows[q - 8 :] = S
    return rows


class Pr2Kernels:
    """Kernels B1/B2 as the parent commit built them (PR 2's design), from a
    copy of its csrc/match_popcount.cu given with --baseline-src: built
    with the same flags, bound with PR 2's interface and launch geometry,
    and timed beside this tree's kernels on the same inputs."""

    def __init__(self, src: Path):
        import ctypes
        import subprocess

        from phylign_tpu_torch.ops import _kernels

        out = ROOT / "build" / "chip_smoke_pr2" / "libpr2_match_popcount.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True, timeout=900)
        self.lib = ctypes.CDLL(str(out))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for fn in (self.lib.phylign_match_popcount_b1, self.lib.phylign_match_popcount_b2):
            fn.restype = i32
            fn.argtypes = [p, i64, i32, p, i32, i32, i32, i32, i32, p, p]

    def __call__(self, name: str, words, rows):
        import torch

        q, k, h = rows.shape
        wp = words.shape[1]
        wt = min(wp, 256)  # PR 2's ops/match.py:launch_geometry
        qt = min(256 // wt, 48 * 1024 // (4 * k * h))
        out = torch.empty((q, 32 * wp), dtype=torch.int32, device=words.device)
        arg6 = h if name.endswith("b1") else max(1, k.bit_length())
        err = getattr(self.lib, f"phylign_{name}")(
            words.data_ptr(), words.shape[0], wp, rows.data_ptr(), q, k, arg6, qt, wt,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise RuntimeError(f"PR 2's {name} failed to launch: cudaError {err}")
        return out


def phase_kernels(label: str, baseline: Pr2Kernels | None) -> dict:
    """B1 and B2 against the plain version at the main path's shapes:
    bit-exact on every row set, then timed over ROTATION row sets in turn
    (and PR 2's design beside them with --baseline-src: PR 2, this tree,
    this tree, PR 2)."""
    import torch

    from phylign_tpu_torch.ops import match as opm

    gen = torch.Generator(device="cuda").manual_seed(2)
    words = torch.cat([random_words(gen, S), torch.zeros((1, WP), dtype=torch.int32, device="cuda")])
    out = {}
    for case, (name, q, k, h) in CASES.items():
        sets = [case_rows(gen, q, k, h) for _ in range(ROTATION)]
        fn = opm.match_scores_b1 if name.endswith("b1") else opm.match_scores_b2
        err = 0
        for rows in sets:
            got = fn(words, rows)
            want = opm.match_scores_ref(words, rows)
            torch.cuda.synchronize()
            err = max(err, int((got - want).abs().max().item()))
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"{case}: kernel {name} differs from match_scores_ref (max |err| {err})")
            if int(got[q - 8 :].abs().sum().item()) != 0:
                raise AssertionError(f"{case}: all-padding queries scored non-zero")
            if baseline is not None and not torch.equal(baseline(name, words, rows), want):
                raise AssertionError(f"{case}: PR 2's {name} differs from match_scores_ref")
        reps = 6 * ROTATION
        times = []
        for who in ("pr2", "new", "new", "pr2") if baseline is not None else ("new",):
            run = (lambda i: baseline(name, words, sets[i])) if who == "pr2" else (lambda i: fn(words, sets[i]))
            times.append((who, cuda_ms(run, reps, ROTATION)))
        ms = min(t for w, t in times if w == "new")
        bounds = [gather_bound(r, WP) for r in sets]
        bound = {
            "distinct_rows": sum(b["distinct_rows"] for b in bounds) / ROTATION,
            "bytes": sum(b["bytes"] for b in bounds) / ROTATION,
            "bound_ms": sum(b["bound_ms"] for b in bounds) / ROTATION,
            "bound_by": bounds[0]["bound_by"],
        }
        plain_ms = cuda_ms(lambda i: opm.match_scores_ref(words, sets[i]), 2, 2)
        out[case] = dict(
            kernel=name, q=q, k=k, h=h, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound, bound_share=bound["bound_ms"] / ms,
            geometry=list(opm.launch_geometry(WP, k, h)),
        )
        if baseline is not None:
            out[case]["times"] = times
            out[case]["pr2_ms"] = min(t for w, t in times if w == "pr2")
        emit("kernels", case=case, S=S, Wp=WP, rotation=ROTATION, card=label, **out[case])
        del sets
    del words
    torch.cuda.empty_cache()
    return out


def add_multi_hash_batch(wd: Path, name: str = "synthetic_h3__01", seed: int = 5) -> None:
    """A 3-hash batch whose genomes carry some of the fixture's reads, with
    its assembly tar (phase 6 aligns against it)."""
    import numpy as np

    from phylign_tpu_torch.io import asmtar
    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.io.fastx import read_fastx_file

    rng = np.random.default_rng(seed)
    reads = [r.seq.encode() for p in sorted((wd / "input").iterdir()) for r in read_fastx_file(p)]
    docs = []
    for g in range(5):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000))
        planted = b"".join(reads[i] for i in range(g, len(reads), 9))
        docs.append((f"{g:04d}_SAMH{g:05d}", [seq[:1500] + planted + seq[1500:]]))
    idx = iocobs.build_classic_index(docs, term_size=31, num_hashes=3, fpr=0.1)
    iocobs.write_classic_index(wd / "cobs" / f"{name}.cobs_classic.xz", idx)
    asmtar.write_batch_tar(
        wd / "asms" / f"{name}.tar.xz",
        [(d.split("_", 1)[1], [(d.split("_", 1)[1] + ".c1", seqs[0])]) for d, seqs in docs],
    )
    with open(wd / "data" / "batches_small.txt", "a") as f:
        f.write(name + "\n")


def oracle_text(didx, records, threshold: float, keep: int) -> str:
    """The 03_match text the numpy oracle gives for ``records``."""
    from phylign_tpu_torch.kmer import encode_seq
    from phylign_tpu_torch.match.oracle import query_index
    from phylign_tpu_torch.match.postprocess import QueryMatches, write_match_file

    ms = []
    for r in records:
        hits = query_index(didx, encode_seq(r.seq.encode()), threshold)
        ms.append(QueryMatches(r.name, len(hits), hits))
    buf = io.StringIO()
    write_match_file(buf, ms, keep)
    return buf.getvalue()


def phase_fixture(work: Path) -> dict:
    from phylign_tpu_torch import testing
    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.io.fastx import read_fastx_file
    from phylign_tpu_torch import cli
    from phylign_tpu_torch.ops import match as opm

    wd = work / "fixture"
    testing.make_fixture(wd, n_batches=3, seed=42)
    add_multi_hash_batch(wd)
    inputs = sorted(str(p) for p in (wd / "input").iterdir())
    opm.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["match", "--workdir", str(wd), "--config", str(wd / "config.yaml"), *inputs])
    seconds = time.perf_counter() - t0
    counts = opm.launch_counts()
    if not all(counts.values()):
        raise AssertionError(f"fixture match did not launch every kernel: {counts}")
    cfg = Config.from_yaml(wd / "config.yaml")
    merged = next((wd / "intermediate" / "01_queries_merged").glob("*.fa"))
    records = list(read_fastx_file(merged))
    batches = (wd / cfg.batches).read_text().split()
    n_hits = 0
    for b in batches:
        didx = iocobs.to_device_index(iocobs.read_classic_index(wd / "cobs" / f"{b}.cobs_classic.xz"))
        want = oracle_text(didx, records, cfg.cobs_kmer_thres, cfg.nb_best_hits)
        got = gzip.open(next((wd / "intermediate" / "03_match").glob(f"{b}____*.gz")), "rt").read()
        if got != want:
            raise AssertionError(f"03_match of {b} differs from the numpy oracle")
        n_hits += sum(ln.startswith("_") for ln in got.splitlines())
    if n_hits == 0:
        raise AssertionError("fixture produced no hits")
    emit("fixture_cli", batches=len(batches), reads=len(records), hit_lines=n_hits,
         seconds=seconds, launches=counts, oracle="equal")
    return counts


def make_full_geometry(wd: Path, n_batches: int, n_reads: int, seed: int):
    """Batches written straight into the mem-disk device-cache layout
    (meta.json + words.npy), and reads planted into known docs."""
    import numpy as np
    import torch

    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq, revcomp

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs, target = [], []  # target: (batch, doc) or None
    for i in range(n_reads):
        if seqs and rng.random() < 0.15:  # duplicate, half reverse-complemented
            j = int(rng.integers(0, len(seqs)))
            seqs.append(seqs[j] if rng.random() < 0.5 else revcomp(seqs[j]))
            target.append(target[j])
            continue
        seqs.append(bytes(rng.choice(acgt, 150)))
        target.append(None if i % 64 == 63 else (int(rng.integers(0, n_batches)), int(rng.integers(0, N_DOCS))))
    hashes = cobs_kmer_hashes_batch([encode_seq(s) for s in seqs], 31, 1)
    names = [f"fg{i:05d}" for i in range(n_reads)]
    (wd / "input").mkdir(parents=True)
    with open(wd / "input" / "reads.fq", "w") as f:
        for n, s in zip(names, seqs):
            f.write(f"@{n}\n{s.decode()}\n+\n{'I' * 150}\n")
    batches = [f"fullgeom_{b:02d}__01" for b in range(n_batches)]
    doc_rng = np.random.default_rng(seed + 1)
    for b, batch in enumerate(batches):
        words = random_words(gen, S).cpu().numpy().view(np.uint32)
        mine = [(h, t[1]) for h, t in zip(hashes, target) if t is not None and t[0] == b]
        rows = np.concatenate([(h[:, 0] % np.uint64(S)).astype(np.int64) for h, _ in mine])
        docs = np.concatenate([np.full(h.shape[0], d, np.int64) for h, d in mine])
        np.bitwise_or.at(words, (rows, docs // 32), (np.uint32(1) << (docs % 32).astype(np.uint32)))
        doc_names = [f"{int(doc_rng.integers(0, 10000)):04d}_SAMG{b:02d}{d:05d}" for d in range(N_DOCS)]
        iocobs.save_device_index(
            wd / "cobs_device_cache" / batch,
            iocobs.DeviceIndex(term_size=31, num_hashes=1, signature_size=S, doc_names=doc_names, words=words),
        )
    (wd / "data").mkdir()
    (wd / "data" / "batches.txt").write_text("".join(b + "\n" for b in batches))
    (wd / "config.yaml").write_text(
        "batches: data/batches.txt\n"
        "cobs_kmer_thres: 0.7\n"
        "nb_best_hits: 100\n"
        "index_load_mode: mem-disk\n"
        "keep_cobs_indexes: true\n"
        "decompression_dir: cobs_device_cache\n"
    )
    return batches, names, target


def phase_full_geometry(work: Path, label: str) -> dict:
    import numpy as np
    import torch

    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.io.fastx import read_fastx_file
    from phylign_tpu_torch.ops import match as opm
    from phylign_tpu_torch.pipeline.stages import Pipeline

    wd = work / "full"
    n_batches, n_reads = 4, 10_240
    t0 = time.perf_counter()
    batches, names, target = make_full_geometry(wd, n_batches, n_reads, seed=7)
    setup_s = time.perf_counter() - t0
    cfg = Config.from_yaml(wd / "config.yaml")
    opm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pl = Pipeline(cfg, wd, device="cuda")
    t0 = time.perf_counter()
    stem = pl.preprocess([str(wd / "input" / "reads.fq")])
    t1 = time.perf_counter()
    pl.match(stem)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pl.filter(stem)
    t3 = time.perf_counter()
    counts = opm.launch_counts()
    if counts["match_popcount_b2"] == 0:
        raise AssertionError(f"full-geometry match did not launch kernel B2: {counts}")
    # every planted read reaches its doc
    cands = {r.name: r.comment.split(",") if r.comment else [] for r in read_fastx_file(pl.filter_path(stem))}
    missed = [
        n for n, t in zip(names, target)
        if t is not None and f"SAMG{t[0]:02d}{t[1]:05d}" not in cands[n]
    ]
    n_planted = sum(t is not None for t in target)
    if missed:
        raise AssertionError(f"{len(missed)} of {n_planted} planted reads missed their doc, e.g. {missed[:3]}")
    # a sample of reads against the numpy oracle on the full-size index
    records = list(read_fastx_file(pl.merged_fa(stem)))
    sample = records[:48]
    didx = iocobs.load_device_index(wd / "cobs_device_cache" / batches[0], mmap=True)
    want = oracle_text(didx, sample, cfg.cobs_kmer_thres, cfg.nb_best_hits)
    got_all = gzip.open(pl.match_path(batches[0], stem), "rt").read()
    got = got_all[: len(want)]
    if got != want:
        raise AssertionError("full-geometry 03_match differs from the numpy oracle on the sample")
    distinct = len({r.seq for r in records})
    res = dict(
        batches=n_batches, S=S, docs=N_DOCS, index_mb=(S + 1) * WP * 4 / 1e6,
        reads=n_reads, distinct_sequences=distinct, planted=n_planted, planted_found=n_planted,
        setup_s=setup_s, preprocess_s=t1 - t0, match_s=t2 - t1, filter_s=t3 - t2,
        read_batch_pairs_per_s=n_reads * n_batches / (t2 - t1),
        peak_device_mb=torch.cuda.max_memory_allocated() / 1e6,
        launches=counts, oracle_sample=len(sample), card=label,
    )
    emit("full_geometry", **res)
    return counts


# --- phase 5: the align stage's kernels B3 and B4 ------------------------------

#: phase 5's B3 cases: (name, P, A, qpos as uint16): the anchor buckets of
#: the align stage (short reads fill A = 32 and 64; 1024 and 4096 are the
#: long-read buckets)
B3_CASES = [
    ("b3_a32", 16384, 32, True),
    ("b3_a64", 8192, 64, True),
    ("b3_a1024", 512, 1024, False),
    ("b3_a4096", 64, 4096, False),
]
#: phase 5's B4 cases: (name, P, L, band, plane, timed): one fused chunk of
#: 150 bp reads (FUSED_MAX_CELLS // 256 pairs, lmax 160), the plane pass,
#: and the widest band at small P (checked, not timed)
B4_CASES = [
    ("b4_score", 8192, 160, 128, False, True),
    ("b4_plane", 4096, 160, 128, True, True),
    ("b4_band512", 64, 160, 512, True, False),
]
#: the case of each align kernel in the kernel table: its main-path call
MAIN_ALIGN_CASE = {"chain_scan": "b3_a32", "extend_scan": "b4_score"}
#: f32 operations per (anchor slot, predecessor) of B3 and per cell of B4
B3_OPS_PER_PAIR = 13
B4_OPS_PER_CELL = 20


def chain_sets(rng, p: int, a: int, q16: bool):
    """[P, A] anchor sets shaped like a read's anchors on one noisy
    diagonal (tests/test_chain_scan.py:_chain_like_set): 150 bp reads at
    sr minimizer density (21-32 anchors) for A <= 64, long reads (half to
    all of A) above; 10% off-diagonal noise; the last 8 rows padding."""
    import numpy as np

    pad = np.int32(2**30)
    rp = np.full((p, a), pad, np.int32)
    qp = np.full((p, a), pad, np.int32)
    qspan = 130 if a <= 64 else 12 * a
    lo = 21 if a <= 64 else a // 2
    for i in range(p - 8):
        n = int(rng.integers(min(lo, a), a + 1))
        q = np.sort(rng.integers(0, qspan, n)).astype(np.int32)
        drift = np.cumsum(rng.choice([-1, 0, 0, 0, 1], n, p=[0.025, 0.95 / 3, 0.95 / 3, 0.95 / 3, 0.025]))
        r = (q + int(rng.integers(0, 5_000_000)) + drift).astype(np.int32)
        noise = rng.random(n) < 0.1
        r = np.where(noise, rng.integers(0, 5_000_000, n), r).astype(np.int32)
        o = np.lexsort((q, r))
        rp[i, :n], qp[i, :n] = r[o], q[o]
    if q16:
        q = np.zeros((p, a), np.uint16)
        np.copyto(q, qp, casting="unsafe", where=qp < pad)
        qp = q.view(np.int16)
    return rp, qp


def b3_bound(rp, qp_bytes: int, p: int, a: int, w: int) -> dict:
    """Bytes: rpos, qpos, f and parent once each; operations: B3_OPS_PER_PAIR
    f32 operations for each valid slot and each predecessor its window
    holds (min(i, W) at slot i), from these inputs."""
    import numpy as np

    valid = rp < 2**30
    n_valid = valid.sum(axis=1)
    # slot i has min(i, w) predecessors; valid slots are a prefix of a row
    preds = sum(int(min(i, w)) * int((n_valid > i).sum()) for i in range(a))
    nbytes = p * a * (4 + qp_bytes + 4 + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = preds * B3_OPS_PER_PAIR
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, operations=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def extend_inputs(rng, p: int, l: int, band: int):
    """150 bp reads (q_len 150 in an L-wide row) placed on their window's
    centre diagonal, as the fused flush builds them: 1% substitutions, every
    17th with a 4-base deletion, contig edges in 1 of 16 windows."""
    import numpy as np

    q = np.zeros((p, l), np.uint8)
    q[:, :150] = rng.integers(0, 4, (p, 150))
    q_len = np.full(p, 150, np.int32)
    r = rng.integers(0, 4, (p, l + band)).astype(np.uint8)
    half = band // 2
    for i in range(p):
        s = q[i, :150].copy()
        if i % 17 == 0:
            s = np.concatenate([s[:75], s[79:]])
        flip = rng.random(len(s)) < 0.01
        s[flip] = (s[flip] + 1) % 4
        r[i, half : half + len(s)] = s
    v = np.ones((p, l + band), bool)
    edge = np.arange(p) % 16 == 5
    v[edge, : half // 2] = False
    return q, q_len, r, v


def b4_bound(q_len, p: int, l: int, band: int, plane: bool) -> dict:
    """Bytes: codes, q_len, window, mask, score, end_d (and the plane) once
    each; operations: B4_OPS_PER_CELL f32 operations for each band cell of
    each row these inputs need (rows < q_len without the plane, all L rows
    with it)."""
    rows = p * l if plane else int(q_len.clip(0, l).sum())
    nbytes = p * l + 4 * p + 2 * p * (l + band) + 8 * p + (4 * p * l * band if plane else 0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = rows * band * B4_OPS_PER_CELL
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, operations=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def max_abs_diff(a, b) -> float:
    """max |a - b| in float64 (0 for empty tensors; NEG against NEG is 0)."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def phase_align_kernels(label: str) -> dict:
    """B3 and B4 against their plain versions at the align stage's shapes:
    bit-exact on every input set, then timed over ROTATION input sets in
    turn (the plain version over 2 calls)."""
    import numpy as np
    import torch

    from phylign_tpu_torch.ops import chain as opc
    from phylign_tpu_torch.ops import extend as ope

    rng = np.random.default_rng(11)
    out = {}
    cost = opc.device_cost_table(21, 100, torch.device("cuda"))
    for name, p, a, q16 in B3_CASES:
        w = min(opc.LOOKBACK, a)
        host = [chain_sets(rng, p, a, q16) for _ in range(ROTATION)]
        sets = [(torch.from_numpy(r).cuda(), torch.from_numpy(q).cuda()) for r, q in host]
        err = 0.0
        for r, q in sets:
            got = opc.chain_dp_cuda(r, q, cost, 21, 100, 100)
            want = opc.chain_dp_ref(r, q, cost, 21, 100, 100)
            torch.cuda.synchronize()
            err = max([err] + [max_abs_diff(g, w) for g, w in zip(got, want)])
            if err != 0 or not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name}: kernel chain_scan differs from chain_dp_ref (max |err| {err})")
        ms = cuda_ms(lambda i: opc.chain_dp_cuda(*sets[i], cost, 21, 100, 100), 4 * ROTATION, ROTATION)
        plain_ms = cuda_ms(lambda i: opc.chain_dp_ref(*sets[i], cost, 21, 100, 100), 2, 2)
        bounds = [b3_bound(r, 2 if q16 else 4, p, a, w) for r, _ in host]
        bound = {k: (sum(b[k] for b in bounds) / ROTATION if k != "bound_by" else bounds[0][k]) for k in bounds[0]}
        out[name] = dict(kernel="chain_scan", P=p, A=a, W=w, qpos="uint16" if q16 else "int32",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, bound_share=bound["bound_ms"] / ms,
                         geometry=[opc.WARPS_PER_BLOCK, (p + opc.WARPS_PER_BLOCK - 1) // opc.WARPS_PER_BLOCK])
        emit("align_kernels", case=name, rotation=ROTATION, card=label, **out[name])
        del sets
    for name, p, l, band, plane, timed in B4_CASES:
        host = [extend_inputs(rng, p, l, band) for _ in range(ROTATION if timed else 1)]
        sets = [[torch.from_numpy(x).cuda() for x in h] for h in host]
        err = 0.0
        for s in sets:
            got = ope.extend_cuda(*s, collect_plane=plane)
            want = ope.extend_ref(*s, collect_plane=plane)
            torch.cuda.synchronize()
            err = max([err] + [max_abs_diff(g, w) for g, w in zip(got, want)])
            if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name}: kernel extend_scan differs from extend_ref (max |err| {err})")
            if int((got.score >= 250).sum()) < p // 2:
                raise AssertionError(f"{name}: planted reads did not score as aligned")
        row = dict(kernel="extend_scan", P=p, L=l, band=band, plane=plane, max_abs_err=err,
                   geometry=[ope.WARPS_PER_BLOCK, (p + ope.WARPS_PER_BLOCK - 1) // ope.WARPS_PER_BLOCK])
        if timed:
            row["ms"] = cuda_ms(lambda i: ope.extend_cuda(*sets[i], collect_plane=plane), 4 * ROTATION, ROTATION)
            row["plain_ms"] = cuda_ms(lambda i: ope.extend_ref(*sets[i], collect_plane=plane), 2, 2)
            bounds = [b4_bound(h[1], p, l, band, plane) for h in host]
            row.update({k: (sum(b[k] for b in bounds) / len(bounds) if k != "bound_by" else bounds[0][k]) for k in bounds[0]})
            row["bound_share"] = row["bound_ms"] / row["ms"]
        out[name] = row
        emit("align_kernels", case=name, card=label, **row)
        del sets
    torch.cuda.empty_cache()
    return out


# --- phase 6: the fixture through the CLI, card against CPU --------------------


def _align_outputs(wd: Path) -> dict:
    """05_map and output files; .gz decompressed (gzip members carry their
    write time)."""
    out = {}
    for d in ("intermediate/05_map", "output"):
        for p in sorted((wd / d).iterdir()):
            out[f"{d}/{p.name}"] = gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes()
    return out


def _align_counts() -> dict:
    from phylign_tpu_torch.ops import chain as opc
    from phylign_tpu_torch.ops import extend as ope
    from phylign_tpu_torch.ops import match as opm

    return {**opm.launch_counts(), **opc.launch_counts(), **ope.launch_counts()}


def _reset_counts() -> None:
    from phylign_tpu_torch.ops import chain as opc
    from phylign_tpu_torch.ops import extend as ope
    from phylign_tpu_torch.ops import match as opm

    opm.reset_launch_counts()
    opc.reset_launch_counts()
    ope.reset_launch_counts()


def phase_fixture_all(work: Path) -> dict:
    from phylign_tpu_torch import cli

    outs, secs, counts = {}, {}, {}
    for dev in ("cuda", "cpu"):
        wd = work / f"fixture_all_{dev}"
        shutil.copytree(work / "fixture", wd,
                        ignore=shutil.ignore_patterns("intermediate", "output", "logs"))
        inputs = sorted(str(p) for p in (wd / "input").iterdir())
        _reset_counts()
        t0 = time.perf_counter()
        cli.main(["all", "--workdir", str(wd), "--config", str(wd / "config.yaml"),
                  "--device", dev, *inputs])
        secs[dev] = time.perf_counter() - t0
        counts[dev] = _align_counts()
        outs[dev] = _align_outputs(wd)
    c = counts["cuda"]
    if not (c["chain_scan"] and c["extend_scan"]):
        raise AssertionError(f"fixture `all` did not launch B3 and B4: {c}")
    if any(counts["cpu"].values()):
        raise AssertionError(f"the CPU run launched kernels: {counts['cpu']}")
    if outs["cuda"] != outs["cpu"]:
        bad = [k for k in outs["cpu"] if outs["cuda"].get(k) != outs["cpu"][k]]
        raise AssertionError(f"fixture `all` differs between cuda and cpu in {bad}")
    n_rec = sum(v.count(b"\n") for k, v in outs["cuda"].items() if "05_map" in k)
    emit("fixture_all", files=len(outs["cuda"]), sam_records=n_rec, seconds=secs,
         launches=c, cpu="identical")
    return c


# --- phase 7: the align stage at full width ------------------------------------

P7_BATCHES, P7_GENOMES, P7_READS, P7_CANDS, P7_SUBSET = 2, 8, 16384, 5, 2048


def make_align_geometry(wd: Path, seed: int):
    """Batch tars of P7_GENOMES genomes of 2-5 Mb in 1-3 contigs, reads of
    150 bp sampled from them (1% substitutions, half reverse-complemented,
    1 in 17 with a 4-base deletion, 1 in 64 chimeric), and each read's
    04_filter candidates: its source genome and 4 others."""
    import numpy as np

    from phylign_tpu_torch.io import asmtar

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = []  # (batch, acc, [(contig name, bytes)])
    for b in range(P7_BATCHES):
        for g in range(P7_GENOMES):
            acc = f"SAMA{b}{g:03d}"
            total = int(rng.integers(2_000_000, 5_000_001))
            cuts = np.sort(rng.integers(100_000, total - 100_000, int(rng.integers(0, 3))))
            bounds = [0, *cuts.tolist(), total]
            seq = acgt[rng.integers(0, 4, total)].tobytes()
            contigs = [(f"{acc}.contig{c:05d}", seq[bounds[c] : bounds[c + 1]]) for c in range(len(bounds) - 1)]
            genomes.append((b, acc, contigs))
    (wd / "asms").mkdir(parents=True)
    (wd / "data").mkdir()
    (wd / "input").mkdir()
    batches = [f"align_{b:02d}__01" for b in range(P7_BATCHES)]
    for b, batch in enumerate(batches):
        asmtar.write_batch_tar(wd / "asms" / f"{batch}.tar.xz",
                               [(acc, cs) for bb, acc, cs in genomes if bb == b])
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads, truth = [], []  # truth: (genome idx, contig name, 1-based pos, strand) or None
    for i in range(P7_READS):
        gi = int(rng.integers(0, len(genomes)))
        _, acc, contigs = genomes[gi]
        ci = int(rng.integers(0, len(contigs)))
        cname, cseq = contigs[ci]
        pos = int(rng.integers(0, len(cseq) - 200))
        if i % 64 == 63:  # chimeric: two halves from two genomes
            _, _, c2 = genomes[(gi + 1) % len(genomes)]
            other = c2[0][1]
            p2 = int(rng.integers(0, len(other) - 100))
            s = bytearray(cseq[pos : pos + 75] + other[p2 : p2 + 75])
            t = None
        else:
            s = bytearray(cseq[pos : pos + (154 if i % 17 == 0 else 150)])
            if i % 17 == 0:
                del s[75:79]
            t = (gi, cname, pos + 1)
        for j in np.flatnonzero(rng.random(150) < 0.01):
            s[j] = acgt[(acgt.tolist().index(s[j]) + int(rng.integers(1, 4))) % 4]
        s = bytes(s)
        strand = i % 2
        if strand:
            s = s.translate(comp)[::-1]
        reads.append(s)
        truth.append(None if t is None else (*t, strand))
    names = [f"ar{i:05d}" for i in range(P7_READS)]
    with open(wd / "input" / "align_reads.fq", "w") as f:
        for n, s in zip(names, reads):
            f.write(f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n")
    cands = []
    for i in range(P7_READS):
        src = truth[i][0] if truth[i] is not None else int(rng.integers(0, len(genomes)))
        others = rng.choice([g for g in range(len(genomes)) if g != src], P7_CANDS - 1, replace=False)
        cands.append([genomes[g][1] for g in [src, *others.tolist()]])
    (wd / "data" / "batches.txt").write_text("".join(b + "\n" for b in batches))
    (wd / "config.yaml").write_text(
        "batches: data/batches.txt\n"
        f"nb_best_hits: {P7_CANDS}\n"
    )
    return batches, names, reads, truth, cands


def _write_filter(pl, stem: str, names, reads, cands, keep) -> None:
    with open(pl.filter_path(stem), "w") as f:
        for i in keep:
            f.write(f">{names[i]} {','.join(cands[i])}\n{reads[i].decode()}\n")


def _align_pipeline(wd: Path, run_wd: Path, device: str, names, reads, cands, keep):
    """A Pipeline in run_wd over wd's inputs, its 04_filter holding the
    records of the reads ``keep``: (pipeline, stem)."""
    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.pipeline.stages import Pipeline

    if run_wd != wd:
        run_wd.mkdir()
        for d in ("asms", "data", "input"):
            (run_wd / d).symlink_to(wd / d)
        shutil.copy(wd / "config.yaml", run_wd / "config.yaml")
    pl = Pipeline(Config.from_yaml(wd / "config.yaml"), run_wd, device=device)
    stem = pl.preprocess([str(wd / "input" / "align_reads.fq")])
    _write_filter(pl, stem, names, reads, cands, keep)
    return pl, stem


def profile_align(pl, stem: str, out: Path) -> dict:
    """One more align run under cProfile (every thread: Python 3.12's
    profiler sees them all) and torch.profiler (device activity): device
    time by kernel, the device's busy share of the run's wall time, and
    the host functions by own time. The full tables go to ``out``."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as tp:
        prof.enable()
        pl.align(stem)
        torch.cuda.synchronize()
        prof.disable()
    wall = time.perf_counter() - t0
    dev = {}
    for e in tp.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            dev[e.key] = (t / 1e3, e.count)
    dev_ms = sum(t for t, _ in dev.values())
    host = sorted(
        ((f"{Path(fn).name}:{line}({name})", st[2], st[1]) for (fn, line, name), st in pstats.Stats(prof).stats.items()),
        key=lambda r: -r[1],
    )
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        f.write(f"align stage under both profilers: {wall:.3f} s wall, {dev_ms:.3f} ms device\n\n")
        f.write("device ms, launches, kernel or copy\n")
        for k, (t, n) in sorted(dev.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{t:10.3f} {n:8d}  {k}\n")
        f.write("\nhost own s, calls, function (all threads)\n")
        for name, tt, nc in host[:60]:
            f.write(f"{tt:10.3f} {nc:8d}  {name}\n")
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(profiled_wall_s=wall, device_ms=dev_ms, device_busy_share=dev_ms / 1e3 / wall,
                device_top=[[k[:80], t, n] for k, (t, n) in top],
                host_top=[[n, tt, nc] for n, tt, nc in host[:15]], tables=str(out.relative_to(ROOT)))


def phase_align_geometry(work: Path, label: str, profile: bool) -> dict:
    import numpy as np
    import torch

    wd = work / "align"
    t0 = time.perf_counter()
    batches, names, reads, truth, cands = make_align_geometry(wd, seed=17)
    setup_s = time.perf_counter() - t0
    pl, stem = _align_pipeline(wd, wd, "cuda", names, reads, cands, range(P7_READS))
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    maps = pl.align(stem)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    counts = _align_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    t1 = time.perf_counter()
    summary = pl.aggregate(stem)
    pl.stats(stem)
    report_s = time.perf_counter() - t1
    if not (counts["chain_scan"] and counts["extend_scan"]):
        raise AssertionError(f"the align stage did not launch B3 and B4: {counts}")
    # every planted (non-chimeric) read at its position, on its strand
    placed = {}
    for line in gzip.open(summary, "rt"):
        f = line.split("\t")
        if len(f) > 5 and f[1] in ("0", "16"):
            placed.setdefault(f[0], set()).add((f[2], int(f[3]), int(f[1]) // 16))
    planted = [i for i in range(P7_READS) if truth[i] is not None]
    hit = sum(1 for i in planted if truth[i][1:] in placed.get(names[i], ()))
    frac = hit / len(planted)
    if frac < 0.95:
        raise AssertionError(f"only {hit} of {len(planted)} planted reads mapped to their position")
    # a fixed subset of reads on the CPU: the same records
    sub = sorted(np.random.default_rng(3).choice(P7_READS, P7_SUBSET, replace=False).tolist())
    keep = {names[i] for i in sub}
    pl_cpu, stem_cpu = _align_pipeline(wd, work / "align_cpu", "cpu", names, reads, cands, sub)
    t2 = time.perf_counter()
    cpu_maps = pl_cpu.align(stem_cpu)
    cpu_s = time.perf_counter() - t2
    for gpu_p, cpu_p in zip(maps, cpu_maps):
        g = [ln for ln in gzip.open(gpu_p, "rt") if ln.split("\t", 1)[0] in keep]
        c = list(gzip.open(cpu_p, "rt"))
        if g != c:
            raise AssertionError(f"{gpu_p.name}: the card's records differ from the CPU run's on the subset")
    pairs = P7_READS * P7_CANDS
    res = dict(
        batches=P7_BATCHES, genomes=P7_BATCHES * P7_GENOMES, reads=P7_READS, pairs=pairs,
        pair_chunk=pl.cfg.device_pair_chunk, setup_s=setup_s, align_s=align_s,
        pairs_per_s=pairs / align_s, reads_per_s=P7_READS / align_s, aggregate_stats_s=report_s,
        peak_device_mb=peak_mb, launches=counts,
        planted=len(planted), placed=hit, placed_frac=frac,
        cpu_subset_reads=P7_SUBSET, cpu_subset_s=cpu_s, cpu_subset="identical",
        reduced=["2 batches of the collection's 305", f"{P7_CANDS} candidates per read, not nb_best_hits=100"],
        card=label,
    )
    emit("align_geometry", **res)
    if profile:
        pl_p, stem_p = _align_pipeline(wd, work / "align_profiled", "cuda", names, reads, cands, range(P7_READS))
        emit("align_profile", card=label, **profile_align(pl_p, stem_p, ROOT / "chiprun_out" / "align_profile.txt"))
    return counts


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-src", type=Path, default=None,
                    help="a copy of the parent commit's csrc/match_popcount.cu: time "
                    "PR 2's kernels beside this tree's in phase 2")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phase 2 only (no kernel table, no ok line)")
    ap.add_argument("--profile", action="store_true",
                    help="phase 7 aligns once more under cProfile and torch.profiler "
                    "(tables in chiprun_out/align_profile.txt)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from phylign_tpu_torch.ops import _kernels
        from phylign_tpu_torch.utils.platform import gpu_label
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 1

    label = gpu_label()
    build_s = _kernels.build_all()
    baseline = Pr2Kernels(args.baseline_src) if args.baseline_src else None
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=label, build_seconds=build_s)

    kern = phase_kernels(label, baseline)
    if args.kernels_only:
        return 0
    akern = phase_align_kernels(label)
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        c3 = phase_fixture(work)
        c4 = phase_full_geometry(work, label)
        c6 = phase_fixture_all(work)
        c7 = phase_align_geometry(work, label, args.profile)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    table = []
    for name, case in MAIN_CASE.items():
        k = kern[case]
        table.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=c3[name] + c4[name] + c6[name], launches_phase3=c3[name],
            launches_phase4=c4[name], launches_phase6=c6[name],
            case=case, max_abs_err=max(v["max_abs_err"] for v in kern.values() if v["kernel"] == name),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            bound_share=k["bound_share"], distinct_rows=k["distinct_rows"], bytes=k["bytes"],
            library_ms=None,
        ))
    for name, case in MAIN_ALIGN_CASE.items():
        k = akern[case]
        table.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=c6[name] + c7[name], launches_phase6=c6[name], launches_phase7=c7[name],
            case=case, max_abs_err=max(v["max_abs_err"] for v in akern.values() if v["kernel"] == name),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            bound_share=k["bound_share"], bytes=k["bytes"], operations=k["operations"],
            library_ms=None,
        ))
    print(json.dumps({"kernels": table}), flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
