#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ``match`` path on one NVIDIA GPU and hold
every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one GPU
    python3 chip_smoke.py --kernels-only --baseline-src OLD.cu
                                   # phase 2 only, with the kernels of an
                                   # older match_popcount.cu timed beside

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
    and a sample of reads must equal the oracle on the full-size index.
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
SOURCE = "phylign_tpu_torch/csrc/match_popcount.cu"
REPLACES = {
    "match_popcount_b1": "phylign_tpu/ops/match.py:276",
    "match_popcount_b2": "phylign_tpu/ops/match.py:403",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


#: the H100's memory rate and its non-tensor 32-bit rate (NVIDIA's data
#: sheet, SXM, 700 W): the bounds of the kernel table
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
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
    """A 3-hash batch whose genomes carry some of the fixture's reads."""
    import numpy as np

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


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-src", type=Path, default=None,
                    help="a copy of the parent commit's csrc/match_popcount.cu: time "
                    "PR 2's kernels beside this tree's in phase 2")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phase 2 only (no kernel table, no ok line)")
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
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        c3 = phase_fixture(work)
        c4 = phase_full_geometry(work, label)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    table = []
    for name, case in MAIN_CASE.items():
        k = kern[case]
        table.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=c3[name] + c4[name], launches_phase3=c3[name], launches_phase4=c4[name],
            case=case, max_abs_err=max(v["max_abs_err"] for v in kern.values() if v["kernel"] == name),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            bound_share=k["bound_share"], distinct_rows=k["distinct_rows"], bytes=k["bytes"],
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
