#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path (``match``, then ``map``: the
align stage, aggregation and stats) and the rest of its CLI on one NVIDIA
GPU, and hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one GPU
    python3 chip_smoke.py --kernels-only --baseline-src OLD.cu
                                   # phase 2 only, with the kernels of an
                                   # older match_popcount.cu (PR 13's C
                                   # interface) timed beside
                                   # (the full run with it also times its
                                   # keep and accumulating instances in
                                   # phases 9 (f) and 10 (a))
    python3 chip_smoke.py --profile    # phase 7 aligns once more under
                                   # cProfile + torch.profiler (device time
                                   # and kernels per flush), tables in
                                   # chiprun_out/align_profile.txt
    python3 chip_smoke.py --align-kernels-only --baseline-align DIR
                                   # phase 5 only (B3, B4, B6), with the B3/B4 kernels
                                   # of DIR/chain_scan.cu and
                                   # DIR/extend_scan.cu (PR 4's design)
                                   # timed beside; the full run takes the
                                   # option too
    python3 chip_smoke.py --align-kernels-only --baseline-extend OLD.cu
                                   # phase 5, and B4's unpacked instances
                                   # held to an older extend_scan.cu's
                                   # SASS (fails if one differs)
    python3 chip_smoke.py --baseline-flush OLD.cu
                                   # phase 5 also times B6a, B6b, B6c
                                   # and the compaction of an older
                                   # flush_epilogue.cu (the same C
                                   # interface) beside this tree's
    python3 chip_smoke.py --ref-index-only
                                   # phase 11 only (ref_sketch, ref_sort
                                   # and one amr-genes.map job)
    python3 chip_smoke.py --baseline-match OLD.cu
                                   # phase 4 also times B5a, B5b, B5c and
                                   # B5d (dense) and phase 8 B5d (sparse)
                                   # of an older match_epilogue.cu (the
                                   # same C interface) beside this tree's

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
    file must equal the numpy oracle's rendering, and B1, B2 and B5's three
    kernels (B5a with H = 3 on the 3-hash batch) must have been launched;
  4 the match stage at full batch geometry: 4 batches of 2,000,000 rows x
    2,169 docs in the mem-disk device-cache layout, 10,240 reads of 150 bp
    (~15% duplicates); every planted read must reach its doc in 04_filter
    and a sample of reads must equal the oracle on the full-size index, and
    B2 and B5 must have been launched; then kernel B5 (the match epilogue:
    B5a Bloom rows, B5b threshold + top-k, B5c flat hit packing) at the
    first batch's call, each kernel bit-exact against its plain version
    there and on three calls built from it (a cut of 0, scores tied at the
    window's edge, total > cap with the dense refetch), B5c also at the
    cap the match stage gives every later batch (the hint cap), timed
    from CUDA graphs over ROTATION input sets beside its bound, with the
    plain versions' times and kernel counts, torch.topk's time, the
    kernels and device time of one _hash_topk_flat call, and each B5
    kernel's registers and local memory (cuobjdump); then B5d, the merge
    of a mesh's doc-shard windows, at dist_topk's cut of 0 over two doc
    shards of the call's scores (every row takes kk from each), bit-exact
    and timed the same way;
  5 kernels B3 (chain DP scan) and B4 (banded extension scan) against their
    plain versions at the align stage's shapes and at every lane count each
    is built for, bit-exact on every input set (B4 also at bands 256 and
    384, on pairs of mixed q_len and on windows outside the contig), timed
    with CUDA events over ROTATION input sets in turn at each lane count,
    with each case's geometry, bytes, operations, bound and share of the
    bound; then kernel B6, the flush epilogue: B6a (chain tail) at every
    anchor bucket on B3's output, and B6b -> B4 -> B6c (+ compaction) on
    flushes of P = 8,192 pairs (lmax 160, band 128: no candidate, both
    strands, contig edges, 0-2 split segments, COLD_CAP overflow; also -A
    200 -B 150, one and no segment, long queries), every output bit-exact
    against the plain versions, timed, with the plain versions' times and
    kernel counts, each kernel's launches per call and the registers and
    local memory of every B6 kernel instance (cuobjdump), and the whole
    epilogue plain against B6 in turns; B4's packed instance (2-bit codes
    and [lo, hi) bounds read in the kernel) at the delegated extension's
    shape (L = 256, band 128, the P of phase 7's delegated chunks: score,
    plane and -A 200 -B 150 passes) and at bands 256, 384 and 512: the
    kernel of each route (the wavefront body, or the row body) bit-exact
    against extend_ref on the unpacked inputs, against the row body at
    every lane count and against the parent's eager unpack + mask + B4,
    the row body timed at every lane count and the route's kernel in turns
    against the row body at its best lanes, from CUDA graphs, and the
    registers and local memory of every B4 instance (an instance no route
    launches fails);
  6 phase 3's fixture (with an assembly tar for its 3-hash batch) end to end
    through ``python -m phylign_tpu_torch.cli all`` on the card and again
    with ``--device cpu``: 05_map, sam_summary and stats must be identical,
    and B3-B6 must have been launched on the card;
  7 the align stage at full width: 2 batches x 8 genomes of 2-5 Mb in 1-3
    contigs, 16,384 reads of 150 bp with 5 candidates each (81,920 pairs,
    device_pair_chunk 16,384); >= 95% of the non-chimeric reads must map to
    their planted position, and a 2,048-read subset must give the same
    records on the CPU; with the needed cold rows of each flush (against
    COLD_CAP), the delegated extension's passes (score and plane, each one
    launch of B4's packed instance: equal counts, or the phase fails) and
    their pair counts, and under --profile each B6 kernel's device time a
    flush;
  8 the device mesh (parallel/) on the one card, every cell on cuda:0:
    (a) B1/B2 on the doc shards of phase 2's geometry as the four-card
    mesh lays them out (68 words over 4, 17 a shard), bit-exact and
    timed; (b) phase 4's batches through Matcher.score_hits_raw on a 2x2
    mesh, hits equal to the 1x1 card run; (c) phase 6's fixture through Pipeline.run_all on a
    2x2 mesh, every output byte equal to phase 6's card run; (d) phase 7's
    align stage on a 1x2 mesh, 05_map and outputs equal to phase 7's; (e) a
    one-rank nccl process group, the mesh's top-k gather through
    all_gather_into_tensor, hits equal to (b)'s. (b), (c) and (e) must have
    launched B5b on the doc shards and B5d, the merge of their windows,
    which is held to its plain version at (b)'s first call and timed
    beside torch.topk over the gathered windows. Phase 5 also runs B4 at
    -A 200 -B 150 (its int32 substitution) and at its per-query-shard
    shapes (B3 P = 8,192, B4 P = 4,096: half of a call on a 1x2 mesh);
  9 the rest of the CLI on the card, over indexes the port builds itself:
    (a) ``build-index`` (k 31, one hash, fpr 0.3) from phase 7's two tars,
    ``inspect-index`` on each; (b) ``download`` of both indexes and tars
    from a loopback http.server into a fresh workdir, then ``preflight``;
    (c) ``all`` there over phase 7's 16,384 reads at the config defaults
    (threshold 0.7, nb_best_hits 100): 03_match equal to the numpy oracle
    on a sample, >= 95% of the planted reads whose oracle score for their
    genome clears the threshold mapped to their position; (d) ``all`` on
    a 2,048-read subset through the console entry point in a subprocess,
    on the card and with ``--device cpu``: every output identical; (e)
    ``test`` on the card, then ``stats``, ``report``, ``index-sizes``,
    ``config``, ``check-cluster`` and ``clean --all``; (f) ``match_step``
    on phase 2's matrix at Q = 2,048, K = 128, H = 1 and 3: one launch of
    the keep instance of B1/B2 a call (the launch counters, and one kernel
    in a CUDA graph of a call), scores equal to match_scores_ref, keep
    equal to the float32 formula and to the plain version, with empty
    queries and scores on the cut; timed from CUDA graphs, also at 4 x Q,
    beside each one's bound (in turns with an older source's keep instance
    under --baseline-src);
 10 an oversized index, row-chunked: (a) the match stage's own call,
    ChunkedMatcher.from_device_index at the default config's chunk budget
    (Pipeline._chunk_budget_mb, 6,656 MB) then score_hits_raw, on an index
    the size of the largest real batch (pseudomonas_aeruginosa__01, 10.6
    GB: 39,000,000 Bloom rows x 68 words, phase 2's matrix tiled, with
    reads planted) with phase 4's 10,240 reads: hits equal to the resident
    Matcher's on the same index on the card, the pass's accumulator equal
    to B2's scores on the whole index; the pass's wall time, its blocks,
    its H2D rate against a pinned copy's, peak device memory against the
    budget; then the accumulating kernel's pass again on the resident
    words, each block bit-exact against its plain version, and from CUDA
    graphs its first block (bit planes stored), a middle one (planes read,
    added, stored), the last (the int32 scores stored) and the whole pass,
    each beside its bound and the pass beside its least work (each block's
    distinct rows, the indices once a block, the scores written once), in
    turns with an older source's int32 instance under --baseline-src; the
    int32 mode (match_scores_acc_) on the first block against its plain
    version, timed in turns with the older source's on the same slots and
    on slots compacted beforehand;
    (b) phase 4's batches through ``cli match`` with device_hbm_gb 1 (a
    chunk budget of 256 MB: about 17 blocks a 544 MB index), every
    03_match byte equal to phase 4's resident run.
 11 a candidate genome's minimizer table (kernels ref_sketch and ref_sort):
    the device route of build_ref_index at the map cell's genome sizes
    (2.75 Mb in one contig, 4.25 Mb in two) and on a repetitive genome,
    byte for byte against the native host path, each kernel against its
    plain version; timed from CUDA graphs beside its bound (the least
    bytes), the plain version's time and torch.sort(stable=True)'s as the
    library's, the route's wall time a genome against the host path's; the
    kernels' registers (local memory fails the phase); then one
    amr-genes.map job with the program's spans on: every genome's table
    built on the card (align.device_ref_genomes == align.genomes).
Then the script's runtime, the kernel table, the card's label, and as the last line
``{"ok": true, "device": {...}}``. Any failure, or no CUDA device, exits
non-zero without that line. All data are made from fixed seeds.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import shutil
import subprocess
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
    "extend_scan_packed": "phylign_tpu_torch/csrc/extend_scan.cu",
    "chain_select": "phylign_tpu_torch/csrc/flush_epilogue.cu",
    "select_window": "phylign_tpu_torch/csrc/flush_epilogue.cu",
    "finish_pack": "phylign_tpu_torch/csrc/flush_epilogue.cu",
    "compact_cold": "phylign_tpu_torch/csrc/flush_epilogue.cu",
    "hash_rows": "phylign_tpu_torch/csrc/match_epilogue.cu",
    "threshold_topk": "phylign_tpu_torch/csrc/match_epilogue.cu",
    "pack_hits": "phylign_tpu_torch/csrc/match_epilogue.cu",
    "match_popcount_acc": "phylign_tpu_torch/csrc/match_popcount.cu",
    "match_popcount_keep": "phylign_tpu_torch/csrc/match_popcount.cu",
    "merge_topk": "phylign_tpu_torch/csrc/match_epilogue.cu",
    "traceback_walk": "phylign_tpu_torch/csrc/traceback_walk.cu",
    "ref_sketch": "phylign_tpu_torch/csrc/ref_index.cu",
    "ref_sort": "phylign_tpu_torch/csrc/ref_index.cu",
}
REPLACES = {
    "match_popcount_b1": "phylign_tpu/ops/match.py:276",
    "match_popcount_b2": "phylign_tpu/ops/match.py:403",
    # XLA scans, not Pallas kernels: the lax.scan of each function
    "chain_scan": "phylign_tpu/ops/chain.py:181",
    "extend_scan": "phylign_tpu/ops/extend.py:237",
    # the jitted programs of the delegated extension around the scan
    # (extend_banded_scores_packed and extend_banded_packed, :118-151)
    "extend_scan_packed": "phylign_tpu/ops/extend.py:118",
    # B6, the jitted flush epilogue (phylign_tpu/align/fused.py:377): the
    # chain tail compiled after the scan, the selection, the checks and
    # packing, the compaction
    "chain_select": "phylign_tpu/ops/chain.py:184",
    "select_window": "phylign_tpu/align/fused.py:104",
    "finish_pack": "phylign_tpu/align/fused.py:277",
    "compact_cold": "phylign_tpu/align/fused.py:347",
    # B5, the jitted match epilogue (phylign_tpu/models/matcher.py:122):
    # the Bloom rows, the threshold + top-k, the flat hit packing
    "hash_rows": "phylign_tpu/models/matcher.py:70",
    "threshold_topk": "phylign_tpu/models/matcher.py:44",
    "pack_hits": "phylign_tpu/models/matcher.py:148",
    # the jitted programs around B2 and B1/B2: the row-chunked pass's
    # accumulation, match_step's keep mask, the mesh's re-top-k
    "match_popcount_acc": "phylign_tpu/models/matcher.py:838",
    "match_popcount_keep": "phylign_tpu/models/matcher.py:252",
    "merge_topk": "phylign_tpu/parallel/dist.py:107",
    # host code, not a device program: the gapped pairs' walk over a
    # fetched plane, reconstruct_planes (:276) + traceback_walk (:310)
    "traceback_walk": "phylign_tpu/ops/extend.py:276",
    # host code: a genome's minimizer table, build_ref_index's native
    # sketch and np.argsort(h, kind="stable")
    "ref_sketch": "phylign_tpu/ops/minimizer.py:237",
    "ref_sort": "phylign_tpu/ops/minimizer.py:237",
}
#: kernel B5's three kernels, launched by every hash-path match call
B5_KERNELS = ("hash_rows", "threshold_topk", "pack_hits")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


#: the bounds of the kernel table: the H100 SXM's memory rate (NVIDIA's
#: data sheet, 700 W) and the issue rates scripts/issue_rates.py measures
#: on the card, times 132 SMs at its top SM clock (nvidia-smi
#: clocks.max.sm: 1,980 MHz). INT32_OPS_PER_S: 64 a clock an SM of the
#: integer ALU's instructions (int32 min/max, compare, logic, byte permute,
#: int-to-f32, and the DPX add-and-max or max of three, each one
#: instruction; measured 63.4-63.75). F32_OPS_PER_S: 128 a clock, f32 add,
#: multiply or fma (measured 126-127), and the most an SM issues of any mix
#: (int32 adds reach 122 split between IADD3 and IMAD)
HBM_BYTES_PER_S = 3.35e12
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9
INT32_OPS_PER_S = SM_COUNT * 64 * SM_CLOCK_HZ
F32_OPS_PER_S = SM_COUNT * 128 * SM_CLOCK_HZ
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


def graph_ms(fn, reps: int, n_args: int = 1) -> float:
    """Mean ms per call of fn(i), i cycling over n_args argument sets, with
    the reps calls captured in one CUDA graph and replayed: device time
    without the gaps of the Python wrapper between launches (a call on a
    few thousand anchor sets is shorter than its wrapper)."""
    import torch

    for i in range(n_args):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fn(r % n_args)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
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


class BaselineMatchKernels:
    """Kernels B1/B2 of an older csrc/match_popcount.cu with PR 13's C
    interface, given with --baseline-src: built with this tree's flags and
    launched at ops/match.launch_geometry's tiles on the same inputs as
    this tree's, to be timed beside them (its store kernels, its int32
    accumulating instance and its keep instance)."""

    def __init__(self, src: Path):
        import ctypes
        import subprocess

        from phylign_tpu_torch.ops import _kernels

        out = ROOT / "build" / "chip_smoke_baseline" / "libbaseline_match_popcount.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True, timeout=900)
        self.lib = ctypes.CDLL(str(out))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for fn in (self.lib.phylign_match_popcount_b1, self.lib.phylign_match_popcount_b2):
            fn.restype = i32
            fn.argtypes = [p, i64, i32, p, *[i32] * 8, p, p]
        self.lib.phylign_match_popcount_acc.restype = i32
        self.lib.phylign_match_popcount_acc.argtypes = [p, i32, i32, i32, p, *[i32] * 8, p, p]
        self.lib.phylign_match_popcount_keep.restype = i32
        self.lib.phylign_match_popcount_keep.argtypes = [p, i64, i32, p, *[i32] * 8, p, ctypes.c_float, p, p, p]

    @staticmethod
    def _check(err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"the baseline's {name} failed to launch: cudaError {err}")

    def __call__(self, name: str, words, rows):
        """The store kernel ``name`` (match_popcount_b1 or _b2)."""
        import torch

        from phylign_tpu_torch.ops import match as opm

        q, k, h = rows.shape
        wp = words.shape[1]
        out = torch.empty((q, 32 * wp), dtype=torch.int32, device=words.device)
        self._check(getattr(self.lib, f"phylign_{name}")(
            words.data_ptr(), words.shape[0], wp, rows.data_ptr(), q, k, h, opm.b2_planes(k),
            *opm.launch_geometry(wp, k, h), out.data_ptr(), torch.cuda.current_stream().cuda_stream), name)
        return out

    def acc_(self, acc, words, rows, r0: int, r1: int):
        """PR 13's accumulating instance: acc += the counts of rows [r0, r1)."""
        import torch

        from phylign_tpu_torch.ops import match as opm

        r3 = rows if rows.dim() == 3 else rows.unsqueeze(-1)
        q, k, h = r3.shape
        wp = words.shape[1]
        self._check(self.lib.phylign_match_popcount_acc(
            words.data_ptr(), r0, r1, wp, r3.data_ptr(), q, k, h, opm.b2_planes(k), *opm.launch_geometry(wp, k, h),
            acc.data_ptr(), torch.cuda.current_stream().cuda_stream), "acc")
        return acc

    def keep(self, words, rows, nk, threshold: float):
        """PR 13's keep instance: (scores, keep)."""
        import numpy as np
        import torch

        from phylign_tpu_torch.ops import match as opm

        q, k, h = rows.shape
        wp = words.shape[1]
        out = torch.empty((q, 32 * wp), dtype=torch.int32, device=words.device)
        keep = torch.empty((q, 32 * wp), dtype=torch.bool, device=words.device)
        self._check(self.lib.phylign_match_popcount_keep(
            words.data_ptr(), words.shape[0], wp, rows.data_ptr(), q, k, h, opm.b2_planes(k),
            *opm.launch_geometry(wp, k, h), nk.data_ptr(), float(np.float32(threshold)), out.data_ptr(),
            keep.data_ptr(), torch.cuda.current_stream().cuda_stream), "keep")
        return out, keep


def phase_kernels(label: str, baseline: BaselineMatchKernels | None) -> dict:
    """B1 and B2 against the plain version at the main path's shapes:
    bit-exact on every row set, then timed over ROTATION row sets in turn
    (and an older source's beside them with --baseline-src: baseline, this
    tree, this tree, baseline)."""
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
                raise AssertionError(f"{case}: the baseline's {name} differs from match_scores_ref")
        reps = 6 * ROTATION
        times = []
        for who in ("baseline", "new", "new", "baseline") if baseline is not None else ("new",):
            run = (lambda i: baseline(name, words, sets[i])) if who == "baseline" else (lambda i: fn(words, sets[i]))
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
            out[case]["baseline_ms"] = min(t for w, t in times if w == "baseline")
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
    from phylign_tpu_torch.models import matcher as tm

    wd = work / "fixture"
    testing.make_fixture(wd, n_batches=3, seed=42)
    add_multi_hash_batch(wd)
    inputs = sorted(str(p) for p in (wd / "input").iterdir())
    hashes_a_kmer = set()  # H of every B5a call
    orig = tm.hash_rows_cuda

    def record(hi, *a):
        hashes_a_kmer.add(hi.shape[2])
        return orig(hi, *a)

    tm.hash_rows_cuda = record
    _reset_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["match", "--workdir", str(wd), "--config", str(wd / "config.yaml"), *inputs])
    finally:
        tm.hash_rows_cuda = orig
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in _kernel_counts().items() if k in ("match_popcount_b1", "match_popcount_b2", *B5_KERNELS)}
    if not all(counts.values()) or hashes_a_kmer != {1, 3}:
        raise AssertionError(f"fixture match did not launch B1, B2 and every B5 kernel, B5a at H = 1 and 3: "
                             f"{counts}, H {sorted(hashes_a_kmer)}")
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
         seconds=seconds, launches=counts, hash_rows_h=sorted(hashes_a_kmer), oracle="equal")
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


def phase_full_geometry(work: Path, label: str, b5_base: BaselineLib | None = None) -> dict:
    import numpy as np
    import torch

    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.io.fastx import read_fastx_file
    from phylign_tpu_torch.models import matcher as tmatcher
    from phylign_tpu_torch.pipeline.stages import Pipeline

    wd = work / "full"
    n_batches, n_reads = 4, 10_240
    t0 = time.perf_counter()
    batches, names, target = make_full_geometry(wd, n_batches, n_reads, seed=7)
    setup_s = time.perf_counter() - t0
    cfg = Config.from_yaml(wd / "config.yaml")
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    pl = Pipeline(cfg, wd, device="cuda")
    t0 = time.perf_counter()
    stem = pl.preprocess([str(wd / "input" / "reads.fq")])
    t1 = time.perf_counter()
    first_call = []  # the first batch's B5 call, timed after the phase's checks
    orig_flat = tmatcher._hash_topk_flat

    def capture(*a, **kw):
        if not first_call:
            first_call.append((a, kw))
        return orig_flat(*a, **kw)

    tmatcher._hash_topk_flat = capture
    try:
        pl.match(stem)
        torch.cuda.synchronize()
    finally:
        tmatcher._hash_topk_flat = orig_flat
    t2 = time.perf_counter()
    pl.filter(stem)
    t3 = time.perf_counter()
    counts = _kernel_counts()
    if not (counts["match_popcount_b2"] and all(counts[k] for k in B5_KERNELS)):
        raise AssertionError(f"full-geometry match did not launch B2 and every B5 kernel: {counts}")
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
    if not first_call:
        raise AssertionError("phase 4 did not reach models/matcher._hash_topk_flat")
    b5 = match_epilogue(*first_call[0], b5_base)
    emit("match_epilogue", card=label, **b5)
    emit("match_warm", card=label, **warm_match(wd, cfg))
    return counts, b5


def warm_match(wd: Path, cfg) -> dict:
    """The match stage once more over phase 4's batches, warm (a fresh
    workdir linked to the same device-cache layout: every index comes from
    the process-wide device cache), under torch.profiler: wall time, the
    device's busy time and idle share, kernels, and B5's and B2's device
    time (by kernel name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from phylign_tpu_torch.pipeline.stages import Pipeline

    warm = wd.parent / "full_warm"
    warm.mkdir()
    for name in ("cobs_device_cache", "data", "input", "config.yaml"):
        (warm / name).symlink_to(wd / name)
    pl = Pipeline(cfg, warm, device="cuda")
    stem = pl.preprocess([str(warm / "input" / "reads.fq")])
    hits0 = pl._index_cache.hits
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pl.match(stem)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if pl._index_cache.hits - hits0 != len(pl.batches()):
        raise AssertionError("the warm match did not take every index from the device cache")
    dev = device_table(prof)
    dev_ms = sum(t for t, _ in dev.values())

    def named(*words):
        return sum(t for k, (t, _) in dev.items() if any(w in k for w in words))

    n = len(pl.batches())
    return dict(batches=n, wall_s=wall, device_ms=dev_ms, idle_share=1 - dev_ms / (wall * 1e3),
                kernels=kernel_count(dev), kernels_per_batch=kernel_count(dev) / n,
                launches={w: sum(c for k, (_, c) in dev.items() if w in k)
                          for w in ("hash_rows", "match_popcount", "threshold_topk", "pack_hits")},
                b5_ms=named("hash_rows", "threshold_topk", "pack_hits"),
                b2_ms=named("match_popcount"), copies_ms=named("Memcpy", "Memset"))


#: operations of B5's functions, counted from their plain versions
#: (_hash_rows_ref, _topk_scores_ref, _pack_hits_ref) as B4's and B6's
#: are, where the data need them: B5a a real hash: three modulos by the
#: call's s (each a multiply-high, a multiply and a subtract, and a compare
#: and a select to correct it), the multiply by 2**32 mod s and the add; a
#: slot: the compare with the k-mer count and the select of the padding row
B5A_ALU_HASH, B5A_OTHER_HASH, B5A_ALU_SLOT = 6, 11, 2
#: B5b a score: the compare with the cut and the select of -1, the add to
#: n_keep; a taken entry: the compare with 0 and the two selects; a row's
#: sort of its m = min(n_keep, kk) qualifying docs, m ceil(log2 m)
#: compares, and past kk one compare a qualifying doc to select the window
B5B_ALU_SCORE, B5B_OTHER_SCORE, B5B_ALU_ENTRY = 2, 1, 3
#: B5c a query: the clamp to kk, the add of the prefix and the subtract of
#: its own take; a taken word below cap: the shift and the or of the pack,
#: the compare with cap, the add of its position
B5C_ALU_QUERY, B5C_OTHER_QUERY, B5C_ALU_WORD, B5C_OTHER_WORD = 1, 2, 3, 1


def b5_bounds(hi, nk, n_keep, d: int, kk: int, cap: int) -> dict:
    """Each B5 kernel's least time from these inputs (n_keep: the call's,
    from the plain top-k): bytes at HBM_BYTES_PER_S (B5a: the hash halves
    of the real slots, nk, the rows out; B5b: the first d scores of every
    row and the cut in, the window and n_keep out; B5c: n_keep and the
    taken entries below cap in, the whole flat buffer out), operations
    (B5A_*, B5B_*, B5C_*) through ``bound``."""
    q, k, h = hi.shape
    real = int(nk.clamp(max=k).sum()) * h
    m = n_keep.clamp(max=kk).tolist()
    sort = sum(x * (x - 1).bit_length() for x in m)  # x ceil(log2 x) compares
    over = int(n_keep[n_keep > kk].sum())
    taken = sum(m)
    words = min(taken, cap)
    return dict(
        hash_rows=bound(16 * real + 4 * q + 4 * q * k * h, B5A_ALU_HASH * real + B5A_ALU_SLOT * q * k * h,
                        B5A_OTHER_HASH * real),
        threshold_topk=bound(4 * q * d + 4 * q + 4 * (2 * q * kk + q),
                             B5B_ALU_SCORE * q * d + B5B_ALU_ENTRY * taken + sort + over,
                             B5B_OTHER_SCORE * q * d),
        pack_hits=bound(4 * q + 8 * words + 4 * (cap + q + 1), B5C_ALU_QUERY * q + B5C_ALU_WORD * words,
                        B5C_OTHER_QUERY * q + B5C_OTHER_WORD * words),
    )


def match_epilogue(args, kw, baseline: BaselineLib | None = None) -> dict:
    """Kernel B5 at phase 4's first _hash_topk_flat call (models/matcher):
    B5a, B5b and B5c each against its plain version on the call's inputs,
    and the whole flat buffer against the plain versions' chain; then B5b
    and B5c on three more calls built from those inputs (a cut of 0: every
    doc qualifies and every query overflows kk; the scores folded onto a
    few values, tied at the window's edge; a cap of a third of the hits:
    total > cap and the dense refetch, _hash_topk), and B5c at the first
    call's hint cap, the cap the match stage gives every later batch
    (``1 << max(12, (4 total + 2048).bit_length())``, stages.py). Each
    kernel timed from CUDA graphs over ROTATION input sets in turn (rows
    rolled), beside its bound; the plain versions from the host with CUDA
    events and their kernel counts (profiler); torch.topk on the masked
    scores (B5b's library call); B5c's time on an empty call (its launch
    alone); kernels and device time per _hash_topk_flat call; each B5
    kernel's registers and local memory; B5d on dist_topk's cut of 0 over
    two doc shards of the call's scores (dense_merge).
    With ``baseline``, its library's B5a, B5b, B5c and B5d are held to the
    plain versions on the same calls and timed beside this tree's in turns
    (baseline, new, new, baseline)."""
    import torch

    from phylign_tpu_torch.models import matcher as tm
    from phylign_tpu_torch.ops import _kernels
    from phylign_tpu_torch.ops import match as opm

    words, hi, lo, nk, cut = args
    s, pad_row, kk, d, cap = (kw[n] for n in ("s", "pad_row", "kk", "d", "cap"))
    err = 0

    def same(what, got, want):
        nonlocal err
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for a, b in zip(got, want):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"B5 {what} differs from its plain version")
            err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)

    rows = tm.hash_rows_cuda(hi, lo, nk, s, pad_row)
    same("hash_rows", rows, tm._hash_rows_ref(hi, lo, nk, s, pad_row))
    if baseline is not None:
        with baseline.active():
            same("the baseline's hash_rows", tm.hash_rows_cuda(hi, lo, nk, s, pad_row), rows)
    scores = opm.match_scores(words, rows)
    q = scores.shape[0]
    tied = scores >> 3  # 0..16 at K = 128: runs of equal scores at the edge
    checked, refs = {}, {}
    calls = {"first": (scores, cut, cap), "threshold_0": (scores, torch.zeros_like(cut), cap),
             "ties": (tied, torch.full_like(cut, 4), cap), "small_cap": (scores, cut, None)}
    for name, (sc, ct, cp) in calls.items():
        win = tm.topk_scores_cuda(sc, ct, kk, d)
        ref = refs[name] = tm._topk_scores_ref(sc, ct, kk, d)
        same(f"threshold_topk ({name})", win, ref)
        if baseline is not None:
            with baseline.active():
                same(f"the baseline's threshold_topk ({name})", tm.topk_scores_cuda(sc, ct, kk, d), ref)
        total = int(torch.clamp(ref[2], max=kk).sum())
        cp = max(1, total // 3) if cp is None else cp
        caps = {name: cp}
        if name == "first":  # and the cap of every later batch
            caps["hint_cap"] = 1 << max(12, (4 * total + 2048).bit_length())
        for case, c in caps.items():
            flat = tm._pack_hits_ref(*ref, kk, c)
            same(f"pack_hits ({case})", tm.pack_hits_cuda(*win, kk, c), flat)
            if baseline is not None:
                with baseline.active():
                    same(f"the baseline's pack_hits ({case})", tm.pack_hits_cuda(*win, kk, c), flat)
            checked[case] = dict(cap=c, total=total, overflow_rows=int((ref[2] > kk).sum()),
                                 max_n_keep=int(ref[2].max()))
    first = refs["first"]
    same("_hash_topk_flat", tm._hash_topk_flat(*args, **kw), tm._pack_hits_ref(*first, kk, cap))
    small = checked["small_cap"]["cap"]
    same("_hash_topk_flat (total > cap)", tm._hash_topk_flat(*args, **{**kw, "cap": small}),
         tm._pack_hits_ref(*first, kk, small))
    dense_kw = {k: v for k, v in kw.items() if k != "cap"}
    same("_hash_topk (the refetch)", tm._hash_topk(*args, **dense_kw), first)
    hint = checked["hint_cap"]["cap"]
    if not (checked["threshold_0"]["overflow_rows"] == q and checked["ties"]["overflow_rows"]
            and checked["small_cap"]["total"] > small and checked["first"]["total"] < hint < cap):
        raise AssertionError(f"B5's extra calls missed their edge: {checked}")

    # ROTATION input sets: the call's rows rolled, so the L2 does not serve
    # one launch the last one's inputs
    shifts = [(1537 * i) % q for i in range(ROTATION)]
    his = [torch.roll(hi, sh, 0) for sh in shifts]
    los = [torch.roll(lo, sh, 0) for sh in shifts]
    nks = [torch.roll(nk, sh, 0) for sh in shifts]
    scs = [torch.roll(scores, sh, 0) for sh in shifts]
    cuts = [torch.roll(cut, sh, 0) for sh in shifts]
    wins = [tm.topk_scores_cuda(scs[i], cuts[i], kk, d) for i in range(ROTATION)]
    masked = [torch.where(scs[i][:, :d] >= cuts[i][:, None], scs[i][:, :d], -1) for i in range(ROTATION)]
    reps = 4 * ROTATION
    kernels = {
        "hash_rows": (lambda i: tm.hash_rows_cuda(his[i], los[i], nks[i], s, pad_row),
                      lambda i: tm._hash_rows_ref(his[i], los[i], nks[i], s, pad_row)),
        "threshold_topk": (lambda i: tm.topk_scores_cuda(scs[i], cuts[i], kk, d),
                           lambda i: tm._topk_scores_ref(scs[i], cuts[i], kk, d)),
        "pack_hits": (lambda i: tm.pack_hits_cuda(*wins[i], kk, cap),
                      lambda i: tm._pack_hits_ref(*wins[i], kk, cap)),
        "pack_hits_hint_cap": (lambda i: tm.pack_hits_cuda(*wins[i], kk, hint),
                               lambda i: tm._pack_hits_ref(*wins[i], kk, hint)),
    }
    bounds = b5_bounds(hi, nk, first[2], d, kk, cap)
    bounds["pack_hits_hint_cap"] = b5_bounds(hi, nk, first[2], d, kk, hint)["pack_hits"]
    res = {}
    for name, (kern, plain) in kernels.items():
        ms = min(graph_ms(kern, reps, ROTATION) for _ in range(2))
        plain_ms = min(cuda_ms(plain, reps, ROTATION) for _ in range(2))
        b = bounds[name]
        res[name] = dict(ms=ms, plain_ms=plain_ms, plain_launches=device_launches(lambda: plain(0)),
                         library_ms=None, bound_share=b["bound_ms"] / ms, max_abs_err=err, **b)
        if baseline is not None:
            res[name].update(in_turns(baseline, kern, reps, ROTATION))
    topk = res["threshold_topk"]
    topk["library_ms"] = min(graph_ms(lambda i: torch.topk(masked[i], kk, dim=1), reps, ROTATION)
                             for _ in range(2))
    # B5c with nothing to do (Q = 0, cap = 0: it writes the total): the
    # launch's own time in the same CUDA graphs
    none = (torch.zeros((0, kk), dtype=torch.int32, device=cut.device),) * 2 + (cut[:0],)
    empty = lambda i: tm.pack_hits_cuda(*none, kk, 0)  # noqa: E731
    res["pack_hits"]["empty_call_ms"] = min(graph_ms(empty, reps) for _ in range(2))
    if baseline is not None:
        res["pack_hits"]["empty_call_turns"] = in_turns(baseline, empty, reps, 1)
    merge_dense = dense_merge(scores, d, kk, baseline)
    whole_ms = min(graph_ms(lambda i: tm._hash_topk_flat(*args, **kw), 12) for _ in range(2))
    b2_ms = min(graph_ms(lambda i: opm.match_scores(words, rows), 12) for _ in range(2))
    per_call = graph_launches(lambda: tm._hash_topk_flat(*args, **kw))
    plain_epi = (lambda: tm._pack_hits_ref(*tm._topk_scores_ref(
        opm.match_scores(words, tm._hash_rows_ref(hi, lo, nk, s, pad_row)), cut, kk, d), kk, cap))
    plain_per_call = device_launches(plain_epi)
    plain_whole_ms = min(graph_ms(lambda i: plain_epi(), 12) for _ in range(2))
    del his, los, nks, scs, cuts, wins, masked, scores, tied, rows
    torch.cuda.empty_cache()
    resources = kernel_resources(_kernels._lib_path("match_epilogue"))
    if baseline is not None:
        resources = dict(new=resources, baseline=kernel_resources(baseline.path))
    return dict(
        Q=q, K=hi.shape[1], H=hi.shape[2], d=d, kk=kk, cap=cap, hint_cap=hint, calls=checked, kernels=res,
        merge_dense=merge_dense, resources=resources,
        kernels_per_call=per_call, plain_kernels_per_call=plain_per_call, whole_ms=whole_ms, b2_ms=b2_ms,
        b5_ms=sum(res[n]["ms"] for n in B5_KERNELS),
        b5_hint_cap_ms=sum(res[n]["ms"] for n in ("hash_rows", "threshold_topk", "pack_hits_hint_cap")),
        b5_whole_less_b2_ms=whole_ms - b2_ms,
        plain_whole_ms=plain_whole_ms, plain_b5_ms=plain_whole_ms - b2_ms, max_abs_err=err,
    )


# --- phase 5: the align stage's kernels B3 and B4 ------------------------------

#: phase 5's B3 cases: (name, P, A, qpos as uint16): the anchor buckets of
#: the align stage (short reads fill A = 32 and 64; 1024 and 4096 are the
#: long-read buckets), and A = 32 at the size of one of phase 7's calls
B3_CASES = [
    ("b3_a32", 16384, 32, True),
    ("b3_a32_shard", 8192, 32, True),
    ("b3_a32_p2048", 2048, 32, True),
    ("b3_a64", 8192, 64, True),
    ("b3_a1024", 512, 1024, False),
    ("b3_a4096", 64, 4096, False),
]
#: phase 5's B4 cases: (name, P, L, band, plane, timed, kind): one fused
#: chunk of 150 bp reads (FUSED_MAX_CELLS // 256 pairs, lmax 160), the plane
#: pass, the wider bands at small P, pairs of mixed q_len side by side in
#: a warp, and windows wholly outside the contig (checked, not timed)
B4_CASES = [
    ("b4_score", 8192, 160, 128, False, True, "reads"),
    ("b4_score_shard", 4096, 160, 128, False, True, "reads"),
    ("b4_plane", 4096, 160, 128, True, True, "reads"),
    ("b4_band256", 256, 160, 256, True, False, "reads"),
    ("b4_band384", 128, 160, 384, True, False, "reads"),
    ("b4_band512", 64, 160, 512, True, False, "reads"),
    ("b4_mixed_qlen", 1024, 160, 128, True, False, "mixed"),
    ("b4_invalid", 256, 160, 128, True, False, "invalid"),
]
#: the case of each align kernel in the kernel table: its main-path call
MAIN_ALIGN_CASE = {"chain_scan": "b3_a32", "extend_scan": "b4_score"}
#: the delegated extension's pairs a pass (engine._extend_items: a chunk
#: of gapped primaries, supplementary segments and MAPQ probes, bucketed to
#: a power of two): of phase 7's 4 score and 4 plane passes at L = 256, 3
#: of each run P = 512 and 1 P = 256 (NVIDIA H100 80GB HBM3, 700.00 W)
DELEGATED_P = 512
#: phase 5's cases of B4's packed instance: (name, P, L, band, plane,
#: scoring): the delegated chunk's shape (150 bp reads in L = 256 rows)
B4P_CASES = [
    ("b4p_score", DELEGATED_P, 256, 128, False, "sr"),
    ("b4p_plane", DELEGATED_P, 256, 128, True, "sr"),
    ("b4p_wide", DELEGATED_P, 256, 128, False, "wide"),
    ("b4p_plane_wide", DELEGATED_P, 256, 128, True, "wide"),
    ("b4p_score_p256", DELEGATED_P // 2, 256, 128, False, "sr"),
    ("b4p_plane_p256", DELEGATED_P // 2, 256, 128, True, "sr"),
    ("b4p_wide_p256", DELEGATED_P // 2, 256, 128, False, "wide"),
    # the long-read presets' band (engine.AlignParams: band 512)
    ("b4p_score_band512", 128, 512, 512, False, "sr"),
    # the other bands -r can set (256, 384): each route's kernel
    ("b4p_score_band256", 256, 256, 256, False, "sr"),
    ("b4p_plane_band256", 256, 256, 256, True, "sr"),
    ("b4p_score_band384", 128, 384, 384, False, "sr"),
]
#: -A 200 -B 150: match and mismatch outside a signed byte (B4's int32
#: substitution)
WIDE_SCORING = (200, 150)
#: f32 operations per (anchor slot, predecessor) of B3 (an estimate, at
#: F32_OPS_PER_S: the SM's issue limit whatever their mix)
B3_OPS_PER_PAIR = 13
#: operations of the functions B4, B6a and B6c compute, counted from their
#: plain versions (extend_ref, _chain_tail_ref, _finish_ref) with a row's or
#: a column's constants hoisted and gathers not counted: ALU ones (min, max,
#: compare, select, logic, int-to-f32, a table lookup; a DPX add-and-max or
#: max of three as one) and others (add, subtract, multiply, which may
#: issue on either pipe). B4 a band cell: the substitution lookup, two gap
#: openings (add-and-max), the max of three, two running maxima of the
#: deletion rows (add-and-max) and two add-and-max into H; adds: H + the
#: substitution and the two opening costs
B4_ALU_CELL, B4_OTHER_CELL = 8, 3


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


def extend_inputs(rng, p: int, l: int, band: int, kind: str = "reads"):
    """150 bp reads (q_len 150 in an L-wide row) placed on their window's
    centre diagonal, as the fused flush builds them: 1% substitutions, every
    17th with a 4-base deletion, contig edges in 1 of 16 windows. ``mixed``:
    q_len anywhere in 0..L, neighbours differing; ``invalid``: every third
    window wholly outside the contig."""
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
    if kind == "mixed":
        q[:, 150:] = rng.integers(0, 4, (p, l - 150))
        q_len = rng.integers(0, l + 1, p).astype(np.int32)
        q_len[:4] = [0, 1, l, 150]
    elif kind == "invalid":
        v[::3] = False
    return q, q_len, r, v


def b4_bound(q_len, p: int, l: int, band: int, plane: bool) -> dict:
    """Bytes: codes, q_len, window, mask, score, end_d (and the plane) once
    each; operations: B4_ALU_CELL + B4_OTHER_CELL for each band cell of
    each row these inputs need (rows < q_len without the plane, all L rows
    with it)."""
    rows = p * l if plane else int(q_len.clip(0, l).sum())
    nbytes = p * l + 4 * p + 2 * p * (l + band) + 8 * p + (4 * p * l * band if plane else 0)
    return bound(nbytes, rows * band * B4_ALU_CELL, rows * band * B4_OTHER_CELL)


def max_abs_diff(a, b) -> float:
    """max |a - b| in float64 (0 for empty tensors; NEG against NEG is 0)."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


class Pr4AlignKernels:
    """Kernels B3/B4 as PR 4 built them (a warp per anchor set, a warp per
    pair, f32), from copies of its csrc/chain_scan.cu and
    csrc/extend_scan.cu in the directory given with --baseline-align: built
    with the same flags, bound with PR 4's interface and 4 warps a block,
    and timed beside this tree's kernels on the same inputs."""

    def __init__(self, src: Path):
        import ctypes
        import subprocess

        from phylign_tpu_torch.ops import _kernels

        out = ROOT / "build" / "chip_smoke_pr4"
        out.mkdir(parents=True, exist_ok=True)
        names = ("chain_scan", "extend_scan")
        procs = [
            subprocess.Popen([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(out / f"libpr4_{n}.so"),
                              str(src / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for n in names
        ]
        for n, pr in zip(names, procs):
            log = pr.communicate(timeout=900)[0]
            if pr.returncode:
                raise RuntimeError(f"PR 4's {n}.cu failed to build:\n{log.decode(errors='replace')}")
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.chain_lib = ctypes.CDLL(str(out / "libpr4_chain_scan.so"))
        self.chain_lib.phylign_chain_scan.restype = i32
        self.chain_lib.phylign_chain_scan.argtypes = [p, p, i32, p, *[i32] * 7, p, p, p]
        self.ext_lib = ctypes.CDLL(str(out / "libpr4_extend_scan.so"))
        self.ext_lib.phylign_extend_scan.restype = i32
        self.ext_lib.phylign_extend_scan.argtypes = [p, p, p, p, i32, i32, i32, *[f32] * 8, i32, i32, p, p, p, p]

    def chain(self, r, q, cost, k: int, gap: int, band: int):
        import torch

        p, a = r.shape
        f = torch.empty((p, a), dtype=torch.float32, device=r.device)
        par = torch.empty((p, a), dtype=torch.int32, device=r.device)
        err = self.chain_lib.phylign_chain_scan(
            r.data_ptr(), q.data_ptr(), int(q.dtype == torch.int16), cost.data_ptr(), p, a,
            min(64, a), k, gap, band, 4, f.data_ptr(), par.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"PR 4's chain_scan failed to launch: cudaError {err}")
        return f, par

    def extend(self, q, q_len, r, v, plane: bool):
        import torch

        from phylign_tpu_torch.ops.extend import SrScoring

        p, l = q.shape
        band = r.shape[1] - l
        s = SrScoring()
        score = torch.empty(p, dtype=torch.float32, device=q.device)
        end_d = torch.empty(p, dtype=torch.int32, device=q.device)
        pl = torch.empty((p, l if plane else 0, band), dtype=torch.float32, device=q.device)
        err = self.ext_lib.phylign_extend_scan(
            q.data_ptr(), q_len.data_ptr(), r.data_ptr(), v.data_ptr(), p, l, band,
            s.match, s.mismatch, s.gap_open1 + s.gap_ext1, s.gap_ext1, s.gap_open2 + s.gap_ext2,
            s.gap_ext2, s.gap_open1, s.gap_open2, int(plane), 4, score.data_ptr(), end_d.data_ptr(),
            pl.data_ptr() if plane else None, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"PR 4's extend_scan failed to launch: cudaError {err}")
        return score, end_d, pl


def timed_in_turns(new, old, reps: int, n_args: int) -> dict:
    """ms of new(i) and, when old is given, of old(i) beside it in turns
    (old, new, new, old), each from a CUDA graph (graph_ms); the best of
    each."""
    order = ("pr4", "new", "new", "pr4") if old is not None else ("new",)
    times = [(who, graph_ms(new if who == "new" else old, reps, n_args)) for who in order]
    out = {"ms": min(t for w, t in times if w == "new")}
    if old is not None:
        out["pr4_ms"] = min(t for w, t in times if w == "pr4")
        out["times"] = times
    return out


def phase_align_kernels(label: str, pr4: Pr4AlignKernels | None, baseline_extend: Path | None = None) -> dict:
    """B3 and B4 against their plain versions at the align stage's shapes:
    bit-exact on every input set at every lane count the kernels are built
    for, then timed over ROTATION input sets in turn at each lane count (the
    dispatch's choice in turns with PR 4's kernels when given), the plain
    version over 2 calls."""
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
            want = opc.chain_dp_ref(r, q, cost, 21, 100, 100)
            runs = {g: opc.chain_dp_cuda(r, q, cost, 21, 100, 100, lanes=g) for g in opc.KERNEL_LANES}
            if pr4 is not None:
                runs["pr4"] = pr4.chain(r, q, cost, 21, 100, 100)
            torch.cuda.synchronize()
            for g, got in runs.items():
                err = max([err] + [max_abs_diff(x, y) for x, y in zip(got, want)])
                if err != 0 or not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{name}: chain_scan ({g} lanes) differs from chain_dp_ref (max |err| {err})")
        g0 = opc.chain_lanes(p)
        lanes_ms = {g: min(graph_ms(lambda i, g=g: opc.chain_dp_cuda(*sets[i], cost, 21, 100, 100, lanes=g),
                                   4 * ROTATION, ROTATION) for _ in range(2)) for g in opc.KERNEL_LANES}
        timing = timed_in_turns(lambda i: opc.chain_dp_cuda(*sets[i], cost, 21, 100, 100),
                                None if pr4 is None else (lambda i: pr4.chain(*sets[i], cost, 21, 100, 100)),
                                4 * ROTATION, ROTATION)
        plain_ms = cuda_ms(lambda i: opc.chain_dp_ref(*sets[i], cost, 21, 100, 100), 2, 2)
        bounds = [b3_bound(r, 2 if q16 else 4, p, a, w) for r, _ in host]
        bound = {k: (sum(b[k] for b in bounds) / ROTATION if k != "bound_by" else bounds[0][k]) for k in bounds[0]}
        out[name] = dict(kernel="chain_scan", P=p, A=a, W=w, qpos="uint16" if q16 else "int32",
                         max_abs_err=err, **timing, plain_ms=plain_ms, **bound,
                         bound_share=bound["bound_ms"] / timing["ms"], lanes=g0, lanes_ms=lanes_ms,
                         sets_per_block=128 // g0, blocks=-(-p // (128 // g0)))
        emit("align_kernels", case=name, rotation=ROTATION, card=label, **out[name])
        del sets
    for name, p, l, band, plane, timed, kind in B4_CASES:
        host = [extend_inputs(rng, p, l, band, kind) for _ in range(ROTATION if timed else 1)]
        sets = [[torch.from_numpy(x).cuda() for x in h] for h in host]
        err = 0.0
        for s in sets:
            want = ope.extend_ref(*s, collect_plane=plane)
            runs = {g: ope.extend_cuda(*s, collect_plane=plane, lanes=g) for g in ope.KERNEL_LANES[band]}
            if pr4 is not None and band == 128:
                runs["pr4"] = pr4.extend(*s, plane)
            torch.cuda.synchronize()
            for g, got in runs.items():
                err = max([err] + [max_abs_diff(x, y) for x, y in zip(got, want)])
                if err != 0 or not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"{name}: extend_scan ({g} lanes) differs from extend_ref (max |err| {err})")
            if kind == "reads" and int((want.score >= 250).sum()) < p // 2:
                raise AssertionError(f"{name}: planted reads did not score as aligned")
            if kind == "invalid" and not bool((want.p_plane[::3] == float(ope.NEG)).any()):
                raise AssertionError(f"{name}: no cell of an invalid window was -1e30")
        g0 = ope.extend_lanes(band, plane)
        row = dict(kernel="extend_scan", P=p, L=l, band=band, plane=plane, inputs=kind, max_abs_err=err,
                   lanes=g0, cells_per_lane=band // g0, pairs_per_block=ope.BLOCK_THREADS // g0,
                   blocks=-(-p // (ope.BLOCK_THREADS // g0)), checked_lanes=list(ope.KERNEL_LANES[band]))
        if timed:
            row["lanes_ms"] = {g: min(graph_ms(lambda i, g=g: ope.extend_cuda(*sets[i], collect_plane=plane, lanes=g),
                                              4 * ROTATION, ROTATION) for _ in range(2)) for g in ope.KERNEL_LANES[band]}
            row.update(timed_in_turns(
                lambda i: ope.extend_cuda(*sets[i], collect_plane=plane),
                None if pr4 is None else (lambda i: pr4.extend(*sets[i], plane)), 4 * ROTATION, ROTATION))
            row["plain_ms"] = cuda_ms(lambda i: ope.extend_ref(*sets[i], collect_plane=plane), 2, 2)
            bounds = [b4_bound(h[1], p, l, band, plane) for h in host]
            row.update({k: (sum(b[k] for b in bounds) / len(bounds) if k != "bound_by" else bounds[0][k]) for k in bounds[0]})
            row["bound_share"] = row["bound_ms"] / row["ms"]
        out[name] = row
        emit("align_kernels", case=name, card=label, **row)
        del sets
    out["b4_wide"] = wide_scoring(rng, label)
    out.update(packed_extension(rng, label, baseline_extend))
    torch.cuda.empty_cache()
    out.update(traceback_kernel(rng, label))
    torch.cuda.empty_cache()
    return out


def wide_scoring(rng, label: str) -> dict:
    """B4 at WIDE_SCORING (its int32 substitution, chosen at launch) against
    the plain version at every lane count, score pass at P = 8,192 and plane
    pass at P = 4,096, bit-exact; then the byte instance (the sr scoring)
    and the wide one (WIDE_SCORING) on the same inputs, timed in turns
    (byte, wide, wide, byte): the launch picks the instance by scoring, and
    the DP's work per cell is the same."""
    import torch

    from phylign_tpu_torch.ops import extend as ope

    wide = ope.SrScoring(match=WIDE_SCORING[0], mismatch=WIDE_SCORING[1])
    p, l, band = 8192, 160, 128
    host = [extend_inputs(rng, p, l, band) for _ in range(ROTATION)]
    sets = [[torch.from_numpy(x).cuda() for x in h] for h in host]
    err = 0.0
    for i, s in enumerate(sets[:2]):
        for plane in (False, True):
            args = [t[: p // 2] for t in s] if plane else s
            want = ope.extend_ref(*args, wide, collect_plane=plane)
            for g in ope.KERNEL_LANES[band]:
                got = ope.extend_cuda(*args, wide, collect_plane=plane, lanes=g)
                torch.cuda.synchronize()
                err = max([err] + [max_abs_diff(x, y) for x, y in zip(got, want)])
                if err != 0 or not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"b4_wide: extend_scan ({g} lanes, plane {plane}) differs from extend_ref")
            if int((want.score >= 125 * WIDE_SCORING[0]).sum()) < len(args[0]) // 2:
                raise AssertionError("b4_wide: planted reads did not score as aligned")
    reps = 4 * ROTATION
    times = []
    scoring = {"byte": ope.SrScoring(), "wide": wide}
    for who in ("byte", "wide", "wide", "byte"):
        times.append((who, graph_ms(lambda i: ope.extend_cuda(*sets[i], scoring[who]), reps, ROTATION)))
    row = dict(kernel="extend_scan", P=p, L=l, band=band, plane=False, match=WIDE_SCORING[0],
               mismatch=WIDE_SCORING[1], max_abs_err=err, checked_lanes=list(ope.KERNEL_LANES[band]),
               ms=min(t for w, t in times if w == "wide"),
               sr_byte_ms=min(t for w, t in times if w == "byte"), times=times)
    emit("align_kernels", case="b4_wide", card=label, **row)
    return row


def packed_inputs(rng, p: int, l: int, band: int):
    """extend_inputs' reads as the delegated extension uploads them: codes
    2-bit packed, the window's contig bounds [lo, hi) (the left edge cut in
    1 of 16 windows, the right in another 1 of 16), the last eighth of the
    rows padding as _extend_dispatch pads a chunk (q_len 0, lo = hi = 0).
    Returns (q, q_len, r, mask, q_pack, r_pack, lo, hi)."""
    import numpy as np

    from phylign_tpu_torch.ops import extend as ope

    wlen = l + band
    q, q_len, r, _ = extend_inputs(rng, p, l, band)
    rows = np.arange(p)
    lo = np.where(rows % 16 == 5, band // 4, 0).astype(np.int32)
    hi = np.where(rows % 16 == 9, wlen - band // 4, wlen).astype(np.int32)
    pad = rows >= p - p // 8
    q[pad], q_len[pad], r[pad], lo[pad], hi[pad] = 0, 0, 0, 0, 0
    v = (np.arange(wlen)[None, :] >= lo[:, None]) & (np.arange(wlen)[None, :] < hi[:, None])
    return q, q_len, r, v, ope.pack2bit(q), ope.pack2bit(r), lo, hi


def b4p_bound(q_len, p: int, l: int, band: int, plane: bool) -> dict:
    """b4_bound's operations; bytes: the packs, q_len, lo, hi, score, end_d
    (and the plane) once each."""
    rows = p * l if plane else int(q_len.clip(0, l).sum())
    nbytes = p * (-(-l // 4) + 4 + -(-(l + band) // 4) + 8 + 8) + (4 * p * l * band if plane else 0)
    return bound(nbytes, rows * band * B4_ALU_CELL, rows * band * B4_OTHER_CELL)


def eager_packed(q_pack, q_len, r_pack, lo, hi, l: int, wlen: int, scoring, plane: bool):
    """The parent's delegated pass: the packs unpacked and the mask built by
    torch ops on the card, then B4's unpacked instance."""
    from phylign_tpu_torch.ops import extend as ope

    q, r = ope._unpack2bit(q_pack, l), ope._unpack2bit(r_pack, wlen)
    return ope.extend_cuda(q, q_len, r, ope._window_mask(lo, hi, wlen), scoring, plane)


def extend_resources() -> dict:
    """Registers, stack and local memory of every B4 instance in the built
    library: the row body by <lanes, cells a lane, wide, packed>, the
    packed instance's wavefront body by <cells a lane, wide, plane>; fails
    when a packed or wavefront instance spills (local memory or a stack),
    or when the instances are not the 14 unpacked ones and those the packed
    routes launch (ope.packed_lanes: the wavefront's routes, the row body
    at 32 lanes at every band; each in both substitutions)."""
    import re

    from phylign_tpu_torch.ops import _kernels
    from phylign_tpu_torch.ops import extend as ope

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-res-usage", str(_kernels.build("extend_scan"))], capture_output=True,
                         text=True, timeout=120)
    out = {}
    for name, kind, reg, stack, local in re.findall(
            r"Function (\S*extend_(scan|wave)_kernel\S*):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
            res.stdout):
        args = ",".join(re.findall(r"L[a-z](\d+)E", name))
        out[f"extend_{kind}<{args}>"] = dict(registers=int(reg), stack_bytes=int(stack), local_bytes=int(local))
    unpacked = {k for k in out if k.startswith("extend_scan<") and k.endswith(",0>")}
    packed_rows = {k for k in out if k.startswith("extend_scan<") and k.endswith(",1>")}
    waves = {k for k in out if k.startswith("extend_wave<")}
    routes = ope.PACKED_ROUTES.items()
    if (len(unpacked) != 14
            or packed_rows != {f"extend_scan<32,{b // 32},{w},1>" for b in ope.KERNEL_LANES for w in (0, 1)}
            or waves != {f"extend_wave<{b // 32},{w},{int(c)}>" for (b, c), g in routes if not g for w in (0, 1)}):
        raise AssertionError(f"cuobjdump listed B4 instances other than the routes': {sorted(out)}\n"
                             f"{res.stdout[-2000:]}")
    for k in (*packed_rows, *waves):
        if out[k]["local_bytes"] or out[k]["stack_bytes"]:
            raise AssertionError(f"B4's instance {k} spills: {out[k]}")
    return out


def unpacked_sass(lib: Path) -> dict:
    """The SASS of each unpacked row-body instance of B4 in a built
    library (cuobjdump -sass), by <lanes, cells a lane, wide>, each
    instruction line without its address."""
    import re

    from phylign_tpu_torch.ops import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    out = {}
    for chunk in res.stdout.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        args = re.findall(r"L[a-z](\d+)E", name)
        if "extend_scan_kernel" in name and args[-1] == "0":
            out[",".join(args[:-1])] = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split() for ln in chunk.splitlines()[1:]
                                       if "/*" in ln and ";" in ln]
    return out


def unpacked_sass_against(old_src: Path) -> dict:
    """--baseline-extend: an older csrc/extend_scan.cu built with the same
    flags; fails unless each of its 14 unpacked instances has this tree's
    SASS, instruction for instruction."""
    from phylign_tpu_torch.ops import _kernels

    out_dir = ROOT / "build" / "chip_smoke_baseline_extend"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libbaseline_extend_scan.so"
    res = subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib), str(old_src)],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"{old_src} failed to build:\n{res.stdout}{res.stderr}")
    old, new = unpacked_sass(lib), unpacked_sass(_kernels.build("extend_scan"))
    if len(new) != 14 or sorted(old) != sorted(new):
        raise AssertionError(f"unpacked B4 instances: {sorted(old)} in {old_src}, {sorted(new)} here")
    differ = sorted(k for k in new if old[k] != new[k])
    if differ:
        raise AssertionError(f"unpacked B4 instances whose SASS differs from {old_src}: {differ}")
    return dict(baseline=str(old_src), instances=sorted(new), instructions={k: len(v) for k, v in new.items()},
                sass="identical")


def packed_extension(rng, label: str, baseline_extend: Path | None = None) -> dict:
    """B4's packed instance at the delegated extension's shape (B4P_CASES):
    the routed kernel (ope.PACKED_ROUTES: the wavefront body, or the row
    body at 32 lanes on the other routes) bit-exact against extend_ref
    on the unpacked inputs, against the row body at 32 lanes (lanes=32,
    the one packed row geometry the library holds) and against the
    parent's eager unpack + mask + B4, one launch a call; then the routed
    kernel against that row body in turns (row, routed, routed, row), each
    from a CUDA graph over ROTATION input sets; the eager path and the
    plain version (the unpack, the mask and extend_ref) beside. With
    ``baseline_extend`` (an older extend_scan.cu), the unpacked instances'
    SASS is held to its."""
    import torch

    from phylign_tpu_torch.ops import extend as ope

    out = {}
    resources = extend_resources()
    emit("align_kernels", case="b4_resources", card=label, instances=resources)
    if baseline_extend is not None:
        emit("align_kernels", case="b4_sass", card=label, **unpacked_sass_against(baseline_extend))
    reps = 4 * ROTATION
    for name, p, l, band, plane, kind in B4P_CASES:
        wlen = l + band
        scoring = ope.SrScoring(*WIDE_SCORING) if kind == "wide" else ope.SrScoring()
        route = ope.PACKED_ROUTES[band, plane]
        host = [packed_inputs(rng, p, l, band) for _ in range(ROTATION)]
        sets = [[torch.from_numpy(x).cuda() for x in h] for h in host]
        packs = [s[4:5] + s[1:2] + s[5:] for s in sets]  # q_pack, q_len, r_pack, lo, hi
        err = 0.0
        for s, pk in zip(sets, packs):
            want = ope.extend_ref(*s[:4], scoring, collect_plane=plane)
            runs = {"routed": ope.extend_cuda_packed(*pk, l, wlen, scoring, plane),
                    32: ope.extend_cuda_packed(*pk, l, wlen, scoring, plane, lanes=32)}
            runs["eager"] = eager_packed(*pk, l, wlen, scoring, plane)
            torch.cuda.synchronize()
            for g, got in runs.items():
                err = max([err] + [max_abs_diff(x, y) for x, y in zip(got, want)])
                if err != 0 or not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"{name}: extend_scan_packed ({g}) differs from extend_ref (max |err| {err})")
            if int((want.score >= 125 * scoring.match).sum()) < p // 2:
                raise AssertionError(f"{name}: planted reads did not score as aligned")

        def routed(i):
            return ope.extend_cuda_packed(*packs[i], l, wlen, scoring, plane)

        def row_body(i):
            return ope.extend_cuda_packed(*packs[i], l, wlen, scoring, plane, lanes=32)

        turns = [(who, graph_ms(routed if who == "routed" else row_body, reps, ROTATION))
                 for who in ("row", "routed", "routed", "row")]
        design = "wavefront, a warp a pair" if route == 0 else f"row body, {route} lanes"
        row = dict(kernel="extend_scan_packed", P=p, L=l, band=band, plane=plane, scoring=kind,
                   max_abs_err=err, design=design, route_lanes=route or 32,
                   ms=min(t for w, t in turns if w == "routed"), row_lanes=32,
                   row_ms=min(t for w, t in turns if w == "row"), turns=turns,
                   parent_eager_ms=graph_ms(lambda i: eager_packed(
                       *packs[i], l, wlen, scoring, plane), reps, ROTATION),
                   kernels_per_call=graph_launches(lambda: routed(0)),
                   parent_eager_kernels_per_call=graph_launches(lambda: eager_packed(
                       *packs[0], l, wlen, scoring, plane)))
        row["speedup_over_row"] = row["row_ms"] / row["ms"]
        if row["kernels_per_call"] != 1:
            raise AssertionError(f"{name}: the packed pass launched {row['kernels_per_call']} kernels, not 1")
        row["plain_ms"] = cuda_ms(lambda i: ope.extend_ref(
            ope._unpack2bit(packs[i][0], l), packs[i][1], ope._unpack2bit(packs[i][2], wlen),
            ope._window_mask(packs[i][3], packs[i][4], wlen), scoring, plane), 2, 2)
        bounds = [b4p_bound(h[1], p, l, band, plane) for h in host]
        row.update({k: (sum(b[k] for b in bounds) / len(bounds) if k != "bound_by" else bounds[0][k]) for k in bounds[0]})
        row["bound_share"] = row["bound_ms"] / row["ms"]
        wide = int(kind == "wide")
        row["resources"] = {k: v for k, v in resources.items() if k == (
            f"extend_wave<{band // 32},{wide},{int(plane)}>" if route == 0 else
            f"extend_scan<{route},{band // route},{wide},1>")}
        out[name] = row
        emit("align_kernels", case=name, rotation=ROTATION, card=label, **row)
        del sets, packs
    return out


#: the traceback walk's cases (csrc/traceback_walk.cu): (name, L, band,
#: gapped pairs): the map cell's row buckets of genes (256 to 3,328 rows,
#: band 128) at about a plane pass's gapped pairs, and the widest band
TB_CASES = [
    ("tb_256", 256, 128, 256),
    ("tb_1024", 1024, 128, 256),
    ("tb_3328", 3328, 128, 128),
    ("tb_1024_band512", 1024, 512, 128),
]
MAIN_TB_CASE = "tb_1024"
#: pairs of each case's first input set also walked on the host, the path
#: the kernel replaces (the plane's copy, reconstruct_planes, traceback_walk)
TB_HOST_PAIRS = 48


def gene_inputs(rng, n: int, l: int, band: int):
    """n gapped pairs at (L, band) as the engine uploads them for the
    plane pass: a gene of L - 8..L bases, 30 bp short of its window at
    offset band/2 (the map cell's deleted genes), 1% substitutions; the
    window's left edge cut at band/4 in 1 of 16 pairs, its right edge just
    past the gene in another 1 of 16 (-1e30 cells at the band's edges).
    Returns (q, q_len, r, lo, hi)."""
    import numpy as np

    wlen, off = l + band, band // 2
    r = rng.integers(0, 4, (n, wlen)).astype(np.uint8)
    q = np.zeros((n, l), np.uint8)
    q_len = np.zeros(n, np.int32)
    for j in range(n):
        qlen = l - int(rng.integers(0, 8))
        a = int(rng.integers(qlen // 4, 3 * qlen // 4))
        s = np.concatenate([r[j, off : off + a], r[j, off + a + 30 :]])[:qlen].copy()
        flip = rng.random(len(s)) < 0.01
        s[flip] = (s[flip] + 1) % 4
        q[j, : len(s)] = s
        q_len[j] = len(s)
    rows = np.arange(n)
    lo = np.where(rows % 16 == 5, band // 4, 0).astype(np.int32)
    hi = np.where(rows % 16 == 9, np.minimum(off + q_len + 35, wlen), wlen).astype(np.int32)
    return q, q_len, r, lo, hi


def tb_bound(q_len, n_ops: int, n: int, l: int, band: int) -> dict:
    """The walk's bytes: the plane's rows below q_len read once, their
    direction bytes written once and read back once, the packs, q_len, lo,
    hi and end_d read and the ops and meta written."""
    rows = int(q_len.clip(0, l).astype("int64").sum())
    nbytes = rows * band * (4 + 1 + 1) + n * (-(-l // 4) + -(-(l + band) // 4) + 16 + 8) + n_ops
    return bound(nbytes, 0)


def traceback_kernel(rng, label: str) -> dict:
    """The traceback walk (traceback_cuda) at the map cell's shapes
    (TB_CASES), over B4's plane pass on the card as the engine leaves it:
    its meta and the ops each pair uses byte for byte against the plain
    version (traceback_ref, on the same tensors) on every input set, and
    its CIGARs and start_d against the host walk (reconstruct_planes +
    traceback_walk) on TB_HOST_PAIRS pairs of the first; then timed from
    CUDA graphs over ROTATION input sets, with the plain version's time a
    call and the host path's a pair beside."""
    import numpy as np
    import torch

    from phylign_tpu_torch.ops import extend as ope

    out = {}
    for name, l, band, n in TB_CASES:
        wlen = l + band
        host = [gene_inputs(rng, n, l, band) for _ in range(ROTATION)]
        sets = []
        for q, q_len, r, lo, hi in host:
            ins = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                   for a in (ope.pack2bit(q), q_len, ope.pack2bit(r), lo, hi)]
            ext = ope.extend_banded_packed(*ins, l, wlen)
            sets.append((ext.p_plane, *ins, ext.end_d, n))
        plain_ms, n_ops = [], []
        for k, args in enumerate(sets):
            tb = ope.traceback_cuda(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = ope.traceback_ref(*args)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            meta, want_meta = tb.meta.cpu(), ref.meta.cpu()
            used = torch.arange(2 * l + band)[None, :] >= (2 * l + band - want_meta[:, :1])
            if not torch.equal(meta, want_meta) or not torch.equal(tb.ops.cpu()[used], ref.ops.cpu()[used]):
                raise AssertionError(f"{name}: traceback_walk differs from traceback_ref on input set {k}")
            if int((want_meta[:, 0] < 0).sum()):
                raise AssertionError(f"{name}: {int((want_meta[:, 0] < 0).sum())} walks failed")
            n_ops.append(int(want_meta[:, 0].sum()))
            if k == 0:
                got = ope.decode_traceback(tb.ops.cpu().numpy()[:TB_HOST_PAIRS], meta.numpy()[:TB_HOST_PAIRS])
        # the host path it replaces, on the first set's first TB_HOST_PAIRS
        q, q_len, r, lo, hi = host[0]
        m = min(n, TB_HOST_PAIRS)
        t0 = time.perf_counter()
        plane = sets[0][0][:m].cpu().numpy()
        end_d = sets[0][6][:m].cpu().numpy()
        planes = ope.reconstruct_planes(plane)
        valid = (np.arange(wlen)[None, :] >= lo[:m, None]) & (np.arange(wlen)[None, :] < hi[:m, None])
        want = [ope.traceback_walk(tuple(x[j] for x in planes), plane[j], q[j], int(q_len[j]), r[j],
                                   int(end_d[j]), rvalid=valid[j]) for j in range(m)]
        host_ms = (time.perf_counter() - t0) * 1e3 / m
        if got != want:
            raise AssertionError(f"{name}: traceback_walk's CIGARs differ from the host walk's")
        gapped = sum(any(op in ("I", "D") for _, op in runs) for runs, _ in want)
        turns = [graph_ms(lambda i: ope.traceback_cuda(*sets[i]), 4 * ROTATION, ROTATION) for _ in range(2)]
        bounds = [tb_bound(h[1], k, n, l, band) for h, k in zip(host, n_ops)]
        row = dict(kernel="traceback_walk", L=l, band=band, pairs=n, max_abs_err=0, checked_sets=len(sets),
                   host_checked_pairs=m, host_gapped_pairs=gapped, ms=min(turns), turns=turns,
                   plain_ms=min(plain_ms), host_ms_per_pair=host_ms,
                   kernels_per_call=graph_launches(lambda: ope.traceback_cuda(*sets[0])),
                   plane_bytes=int(sets[0][0].numel() * 4),
                   ops_bytes=int(n * (2 * l + band) + 8 * n))
        if row["kernels_per_call"] != 1:
            raise AssertionError(f"{name}: traceback_cuda launched {row['kernels_per_call']} kernels, not 1")
        row.update({k: (sum(b[k] for b in bounds) / len(bounds) if k != "bound_by" else bounds[0][k]) for k in bounds[0]})
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out[name] = row
        emit("align_kernels", case=name, rotation=ROTATION, card=label, **row)
        del sets
    return out


# --- phase 5 (B6): the flush epilogue's kernels ---------------------------------

#: B6a's cases: (name, P, A, qpos as uint16): every anchor bucket of the
#: align stage (engine.ANCHOR_BUCKETS) on chain_sets' read-like sets, at
#: phase 5's B3 sizes, A = 32 also at phase 7's calls (P = 2,048), and sets
#: past shared memory (B6a's device workspace; chain_anchors' callers
#: outside the engine's buckets)
B6A_CASES = [
    ("b6a_a32", 16384, 32, True),
    ("b6a_a32_p2048", 2048, 32, True),
    ("b6a_a64", 8192, 64, True),
    ("b6a_a256", 2048, 256, True),
    ("b6a_a1024", 512, 1024, False),
    ("b6a_a4096", 64, 4096, False),
    ("b6a_a16384", 16, 16384, False),
]
#: the flush's cases (testing.flush_case: no candidate, both strands,
#: contig edges, 0-2 split segments, padding): (name, P, lmax, band,
#: n_sup, wide scoring, timed); the main path's flush is the first
B6_FLUSH_CASES = [
    ("b6_flush", 8192, 160, 128, 2, False, True),
    ("b6_flush_wide", 8192, 160, 128, 2, True, False),
    ("b6_flush_nsup1", 8192, 160, 128, 1, False, False),
    ("b6_flush_nsup0", 2048, 160, 128, 0, False, False),
    ("b6_flush_long", 512, 2208, 128, 2, False, False),
]
MAIN_B6_CASE = {"chain_select": "b6a_a32", "select_window": "b6_flush", "finish_pack": "b6_flush",
                "compact_cold": "b6_flush"}
#: B6a's operations (as B4's above): a slot's setup (parent test, root
#: select, count, validity), the primary's argmax, the s2 pass (the
#: overlap test: min, max, clamp, two int-to-f32, min, compare, live; the
#: root compare, two ands, the mask, the argmax) and the blocked bits, and
#: per split segment the mask, the argmax, the overlap test and the four
#: blocked-bit updates; others: the query end, the overlap test's two
#: subtractions and f32 halving, and one add a doubling round
B6A_ALU_SLOT, B6A_OTHER_SLOT, B6A_ALU_SUP, B6A_OTHER_SUP = 19, 4, 14, 3
#: B6c's a column: the q_len and window-bounds tests (5), the mismatch (2),
#: the all-valid reduction, the two masked minima (4), the masked running
#: peak (2), the masked largest drop (2) and the packed bit; others: the
#: column, the count, the running count, step x count, prefv, r_before,
#: sufv (2) and the drop
B6C_ALU_COLUMN, B6C_OTHER_COLUMN = 17, 9
#: 32-bit operations of B6b per pair and per gathered column (ALU)
B6B_OPS_PAIR, B6B_OPS_COLUMN = 300, 6


def device_table(prof) -> dict:
    """{kernel or copy: (device ms, count)} from a torch.profiler run."""
    dev = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            dev[e.key] = (t / 1e3, e.count)
    return dev


def kernel_count(dev: dict) -> int:
    """CUDA kernels in a device_table (copies and memsets not counted)."""
    return sum(n for k, (_, n) in dev.items() if not k.startswith(("Memcpy", "Memset")))


def device_launches(fn, calls: int = 3) -> int:
    """CUDA kernels one call of fn launches (torch.profiler): the count over
    `calls` calls in one profile, divided and rounded (a trace has been
    seen to miss its first kernel). After phase 4's warm profiled match,
    this process's profiles drop most kernels (PERF.md §6):
    graph_launches counts a call that a CUDA graph can capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return round(kernel_count(device_table(prof)) / calls)


def graph_launches(fn) -> int:
    """CUDA kernels one call of fn launches, as a CUDA graph captures them:
    the kernel nodes of a graph of one call (cudaGraphGetNodes and
    cudaGraphNodeGetType, through the CUDA runtime torch loaded); exact
    where the profiler's count is not (device_launches)."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")  # torch's, already loaded
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if rt.cudaGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    kind = ctypes.c_int(0)
    kernels = 0
    for node in nodes:
        if rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cudaGraphNodeGetType failed")
        kernels += kind.value == 0  # cudaGraphNodeTypeKernel
    del graph
    return kernels


def launched_kernel(fn, key: str) -> dict:
    """The kernel whose name holds ``key`` that one call of fn launches, as
    torch.profiler's trace records it: its instance (``name<arguments>``,
    the key of kernel_resources), grid and block (None where the trace
    holds no such kernel or field)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = ROOT / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    trace.unlink()
    types = {"unsigned short": "uint16", "int": "int32", "unsigned char": "uint8", "unsigned int": "uint32",
             "short": "int16", "true": "1", "false": "0"}
    for e in events:
        m = re.search(rf"({key}\w*)_kernel<([^>]*)>", e.get("name", ""))
        if e.get("cat") == "kernel" and m:
            args = ",".join(types.get(x.strip(), x.strip()) for x in m.group(2).split(","))
            grid, block = (e.get("args", {}).get(x) for x in ("grid", "block"))
            return dict(instance=f"{m.group(1)}<{args}>", grid=grid, block=block)
    return dict(instance=None, grid=None, block=None)


def in_turns(baseline, fn, reps: int, n_args: int) -> dict:
    """fn timed from CUDA graphs with the baseline's library and this
    tree's in turns (baseline, new, new, baseline): the turns and the best
    of each."""
    turns = []
    for who in ("baseline", "new", "new", "baseline"):
        with baseline.active() if who == "baseline" else contextlib.nullcontext():
            turns.append((who, graph_ms(fn, reps, n_args)))
    return dict(turns=turns, turns_new_ms=min(t for w, t in turns if w == "new"),
                baseline_ms=min(t for w, t in turns if w == "baseline"))


def bound(nbytes: int, alu: int, other: int = 0) -> dict:
    """The larger of the bytes at HBM_BYTES_PER_S and the operations: alu
    at INT32_OPS_PER_S, and all of them (other: those that may issue on
    either pipe) at the SM's issue limit, F32_OPS_PER_S."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(alu / INT32_OPS_PER_S, (alu + other) / F32_OPS_PER_S) * 1e3
    return dict(bytes=nbytes, operations=alu + other, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def b6_bounds(cand_map, lmax: int, wlen: int, n_sup: int, n_out: int, need: int) -> dict:
    """Each B6 kernel's least time from these inputs: bytes at
    HBM_BYTES_PER_S (B6b: the chain rows of the sets the pairs name, the
    query, a quarter byte per window column, the contig search; out the
    codes, window, mask, hot, scores, cold; B6c: query and lmax window
    columns in, the hot word and the mismatch bits; the compaction: the
    flag words and the first COLD_CAP needed rows in, COLD_CAP rows out),
    operations at
    INT32_OPS_PER_S."""
    from phylign_tpu_torch.align.fused import COLD_CAP

    p = len(cand_map)
    sets = int((cand_map != cand_map.max()).sum())
    ci = 4 + 6 * n_out + 5
    b_in = 20 * p + sets * (11 + 6 * n_sup) * 4 + p * (-(-lmax // 4) + wlen // 4 + 64)
    b_out = p * (lmax + 2 * wlen + 8 + 16 + 8 + 4 * ci + 4 * n_out)
    return dict(
        select_window=bound(b_in + b_out, p * (B6B_OPS_PAIR + B6B_OPS_COLUMN * (lmax + wlen))),
        finish_pack=bound(p * (2 * lmax + 28) + p * (4 + lmax // 8), p * lmax * B6C_ALU_COLUMN,
                          p * lmax * B6C_OTHER_COLUMN),
        compact_cold=bound(4 * p + (min(need, COLD_CAP) + COLD_CAP) * 4 * (ci + n_out), 10 * p),
    )


class BaselineLib:
    """One of this tree's kernel sources (``source``: flush_epilogue for
    --baseline-flush, match_epilogue for --baseline-match) as an older
    copy with the same C interface builds it: built with the same flags
    and swapped in for this tree's library while ``active``, so the
    wrappers launch its kernels on the same inputs."""

    def __init__(self, source: str, src: Path):
        import ctypes
        import hashlib

        from phylign_tpu_torch.ops import _kernels

        out = ROOT / "build" / f"chip_smoke_baseline_{source}"
        out.mkdir(parents=True, exist_ok=True)
        self.source = source
        # one library a source text: the loader would hand a second copy at
        # the same path back as the first
        self.path = out / f"libbaseline_{source}_{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}.so"
        res = subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(self.path), str(src)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            raise RuntimeError(f"{src} failed to build:\n{res.stdout}{res.stderr}")
        self.lib = ctypes.CDLL(str(self.path))
        _kernels._bind(source, self.lib)

    @contextlib.contextmanager
    def active(self):
        from phylign_tpu_torch.ops import _kernels

        mine = _kernels.library(self.source)
        _kernels._libs[self.source] = self.lib
        try:
            yield
        finally:
            _kernels._libs[self.source] = mine


def kernel_resources(lib: Path) -> dict:
    """Registers, stack, shared and local memory of each instance of the B5
    and B6 kernels in a built library (``cuobjdump -res-usage``): B5's
    hash_rows, threshold_topk, pack_hits and merge_topk; B6a's
    chain_select<qpos, index> and chain_select_warp<qpos, slots a lane>, B6b's
    select_window<n_sup, n_out>, B6c's finish_pack<one tile> and the
    compaction's compact_cold<n_out> (an older source's kernels by their
    own names and arguments); {} when cuobjdump is missing or prints no
    such kernel."""
    import re

    from phylign_tpu_torch.ops import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    res = subprocess.run([str(tool), "-res-usage", str(lib)], capture_output=True, text=True, timeout=120)
    types = {"i": "int32", "t": "uint16", "h": "uint8", "j": "uint32"}
    out = {}
    for name, reg, stack, shared, local in re.findall(
            r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", res.stdout):
        m = re.search(r"(select_window|compact_cold|chain_select_warp|chain_select|finish_pack|hash_rows"
                      r"|threshold_topk|pack_hits|merge_topk)_kernel"
                      r"(I(?:L[a-z]\d+E|[a-z])+E)?", name)
        if m:  # template arguments: a type letter, or L, its type's letter, the value, E
            args = ",".join(n or types.get(t, t) for n, t in re.findall(r"L[a-z](\d+)E|([a-z])",
                                                                        (m.group(2) or "")[1:-1]))
            out[f"{m.group(1)}<{args}>" if args else m.group(1)] = dict(
                registers=int(reg), stack_bytes=int(stack), shared_bytes=int(shared), local_bytes=int(local))
    return out


def phase_flush_kernels(label: str, baseline: BaselineLib | None = None) -> dict:
    """Kernel B6 against its plain versions at the align stage's shapes:
    B6a at every anchor bucket on B3's output; B6b -> B4 -> B6c and its
    compaction on testing.flush_case's flushes, every Selection field,
    the whole packed buffer and the full cold rows bit-exact; each kernel
    timed from CUDA graphs over ROTATION input sets, its plain version
    over 2 calls, with the plain version's kernel count per call; at the
    main path's flush also the whole epilogue, the plain path (torch ops
    around B4, as the parent tree runs it) against B6b + B4 + B6c, in
    turns from the host (the plain path's pageable constants cannot be
    captured in a graph), with their kernel counts. Each timed kernel's
    launches per call and, from the built library, every B6 kernel's
    registers and local memory; each B6a row names the instance that ran,
    its grid and block (torch.profiler's trace) and its resources. With ``baseline``, its library's B6a, B6b,
    B6c and compaction are held to the plain versions too and timed beside
    this tree's in turns (baseline, new, new, baseline) at every timed
    case."""
    import numpy as np
    import torch

    from phylign_tpu_torch import testing
    from phylign_tpu_torch.align import fused as fz
    from phylign_tpu_torch.ops import _kernels
    from phylign_tpu_torch.ops import chain as opc
    from phylign_tpu_torch.ops import extend as ope

    rng = np.random.default_rng(13)
    out = {"resources": kernel_resources(_kernels._lib_path("flush_epilogue"))}
    cuda = torch.device("cuda")
    cost = opc.device_cost_table(21, 100, cuda)
    for name, p, a, q16 in B6A_CASES:
        sets = []
        for _ in range(ROTATION):
            r, q = (torch.from_numpy(x).to(cuda) for x in chain_sets(rng, p, a, q16))
            sets.append((*opc.chain_dp_cuda(r, q, cost, 21, 100, 100), r, q))
        err = 0.0
        for s in sets:
            got, want = opc.chain_select_cuda(*s, 21, 2), opc._chain_tail_ref(*s, 21, 2)
            if baseline is not None:
                with baseline.active():
                    old = opc.chain_select_cuda(*s, 21, 2)
            torch.cuda.synchronize()
            for n in want._fields:
                err = max(err, max_abs_diff(getattr(got, n), getattr(want, n)))
                if err != 0 or not torch.equal(getattr(got, n), getattr(want, n)):
                    raise AssertionError(f"{name}: chain_select differs from _chain_tail_ref in {n}")
                if baseline is not None and not torch.equal(getattr(old, n), getattr(want, n)):
                    raise AssertionError(f"{name}: the baseline's chain_select differs from _chain_tail_ref in {n}")

        def b6a(i):
            return opc.chain_select_cuda(*sets[i], 21, 2)

        ms = min(graph_ms(b6a, 4 * ROTATION, ROTATION) for _ in range(2))
        nbytes = p * a * (12 + (2 if q16 else 4)) + p * (11 + 6 * 2) * 4
        alu = p * a * (B6A_ALU_SLOT + 2 * B6A_ALU_SUP)
        other = p * a * (B6A_OTHER_SLOT + opc.doubling_rounds(a) + 2 * B6A_OTHER_SUP)
        ran = launched_kernel(lambda: b6a(0), "chain_select")
        row = dict(kernel="chain_select", P=p, A=a, n_sup=2, qpos="uint16" if q16 else "int32",
                   max_abs_err=err, ms=ms, plain_ms=cuda_ms(lambda i: opc._chain_tail_ref(*sets[i], 21, 2), 2, 2),
                   plain_launches=device_launches(lambda: opc._chain_tail_ref(*sets[0], 21, 2)), **ran,
                   # the threads a set: the block's threads over the sets a block
                   threads=ran["block"][0] // -(-p // ran["grid"][0]) if ran["grid"] and ran["block"] else None,
                   **bound(nbytes, alu, other))
        row.update(bound_share=row["bound_ms"] / ms, resources=out["resources"].get(row["instance"]))
        if baseline is not None:
            row.update(in_turns(baseline, b6a, 4 * ROTATION, ROTATION))
        out[name] = row
        emit("flush_kernels", case=name, rotation=ROTATION, card=label, **row)
        del sets
    for name, p, lmax, band, n_sup, wide, timed in B6_FLUSH_CASES:
        scoring = ope.SrScoring(match=WIDE_SCORING[0], mismatch=WIDE_SCORING[1]) if wide else ope.SrScoring()
        cases = []
        for _ in range(ROTATION if timed else 1):
            ch, ins, kw = testing.flush_case(rng, p, lmax, band, n_sup)
            chains = tuple(opc.ChainResult(*[torch.from_numpy(c[n]).to(cuda) for n in testing.CHAIN_FIELDS])
                           for c in ch)
            cases.append((chains, [torch.from_numpy(x).to(cuda) for x in ins], ins[0]))
        err, cover, sels, exts = 0.0, {}, [], []
        for chains, dev_in, cmap in cases:
            q_len = dev_in[4]
            sel = fz.select_window_cuda(chains, *dev_in, **kw)
            ref = fz._select_ref(fz._flatten_chains(chains), *dev_in, **kw)
            torch.cuda.synchronize()
            # before B6c, which completes the hot rows (sel.head) in place
            for n in ref._fields[:-1]:
                x, y = getattr(sel, n).to(getattr(ref, n).dtype), getattr(ref, n)
                err = max(err, max_abs_diff(x, y))
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: select_window differs from _select_ref in {n}")
            ext = ope.extend_cuda(sel.q_codes, q_len, sel.rwin, sel.rvalid, scoring)
            got = (*fz.finish_pack_cuda(sel, q_len, ext.score, ext.end_d, scoring, 100),
                   *fz.compact_cold_cuda(sel))
            hot, neq = fz._finish_ref(ref, q_len, ext.score, ext.end_d, scoring, 100)
            cc = fz._compact_cold(hot, ref.cold_i, ref.cold_f)
            want = torch.cat([fz._bitcast_u8(x) for x in (hot, ref.flts, neq, *cc)])
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, (hot, neq, *cc))) or not torch.equal(
                    sel.packed, want):
                raise AssertionError(f"{name}: the packed buffer differs from the plain version's")
            err = max(err, max_abs_diff(sel.packed.int(), want.int()))
            fl = (hot[:, 2] & 0xFF).cpu().numpy()
            none = int((cmap == cmap.max()).all(axis=1).sum())
            c = dict(pairs=p, no_candidate=none, has=int((fl & fz.F_HAS != 0).sum()),
                     full=int((fl & fz.F_FULL != 0).sum()), reverse=int((fl & fz.F_STRAND != 0).sum()),
                     sup1=int((fl & fz.F_SUP0 != 0).sum()), sup2=int((fl & (fz.F_SUP0 << 1) != 0).sum()),
                     probe=int((fl & fz.F_PROBE != 0).sum()),
                     contig_edge=int(((ref.lohi[:, 0] > 0) | (ref.lohi[:, 1] < lmax + band)).sum()),
                     cold_needed=int((((fl & fz.F_HAS != 0) & (fl & fz.F_FULL == 0)) | (fl & 0xE0 != 0)).sum()))
            for k, v in c.items():
                cover[k] = cover.get(k, 0) + v
            if not (none and c["has"] and c["full"] and c["reverse"] and c["contig_edge"]
                    and (n_sup < 1 or c["sup1"]) and (n_sup < 2 or c["sup2"])):
                raise AssertionError(f"{name}: the flush lacks a kind of pair: {c}")
            if baseline is not None and timed and not sels:
                with baseline.active():
                    old = fz.select_window_cuda(chains, *dev_in, **kw)
                    torch.cuda.synchronize()
                    same_sel = all(torch.equal(getattr(old, n).to(getattr(ref, n).dtype), getattr(ref, n))
                                   for n in ref._fields[:-1])
                    old_fin = fz.finish_pack_cuda(old, q_len, ext.score, ext.end_d, scoring, 100)
                    old_cc = fz.compact_cold_cuda(sel)
                torch.cuda.synchronize()
                if not same_sel or not all(torch.equal(x, y) for x, y in zip((*old_fin, *old_cc), (hot, neq, *cc))):
                    raise AssertionError(f"{name}: the baseline's B6b, B6c or compaction differs from the plain "
                                         "version")
            sels.append(sel)
            exts.append(ext)
        row = dict(kernel="flush_epilogue", P=p, lmax=lmax, band=band, n_sup=n_sup,
                   scoring=list(WIDE_SCORING) if wide else "sr", max_abs_err=err, inputs=cover,
                   cold_cap=fz.COLD_CAP)
        if timed:
            reps = 4 * ROTATION
            ci = [c[1] for c in cases]

            def b6b(i):
                return fz.select_window_cuda(cases[i][0], *ci[i], **kw)

            def b6c(i):
                fz.finish_pack_cuda(sels[i], ci[i][4], exts[i].score, exts[i].end_d, scoring, 100)

            def plain_sel(i):
                return fz._select_ref(fz._flatten_chains(cases[i][0]), *ci[i], **kw)

            refs = [plain_sel(i) for i in range(ROTATION)]

            def plain_fin(i):
                return fz._finish_ref(refs[i], ci[i][4], exts[i].score, exts[i].end_d, scoring, 100)

            fins = [plain_fin(i) for i in range(ROTATION)]

            def plain_cc(i):
                return fz._compact_cold(fins[i][0], refs[i].cold_i, refs[i].cold_f)

            def flush(i, new):
                if new:
                    return fz.select_extend(cases[i][0], *ci[i], scoring=scoring, pack=True, **kw)
                hot, flts, neq, cold = fz._select_extend_core(fz._flatten_chains(cases[i][0]), *ci[i],
                                                              scoring=scoring, zdrop=100, **kw)
                cc = fz._compact_cold(hot, *cold)
                return torch.cat([fz._bitcast_u8(x) for x in (hot, flts, neq, *cc)])

            need = cover["cold_needed"] // ROTATION
            bnd = b6_bounds(cases[0][2], lmax, lmax + band, n_sup, n_sup, need)
            for kname, fn, pfn in (("select_window", b6b, plain_sel), ("finish_pack", b6c, plain_fin),
                                   ("compact_cold", lambda i: fz.compact_cold_cuda(sels[i]), plain_cc)):
                ms = min(graph_ms(fn, reps, ROTATION) for _ in range(2))
                row[kname] = dict(ms=ms, plain_ms=cuda_ms(pfn, 2, 2),
                                  plain_launches=device_launches(lambda: pfn(0)), **bnd[kname],
                                  bound_share=bnd[kname]["bound_ms"] / ms,
                                  launches_per_call=device_launches(lambda: fn(0)))
                if baseline is not None:
                    row[kname].update(in_turns(baseline, fn, reps, ROTATION))
            times = [(who, cuda_ms(lambda i: flush(i, who == "b6"), 2 * ROTATION, ROTATION))
                     for who in ("plain", "b6", "b6", "plain")]
            row["epilogue"] = dict(
                times=times, b6_ms=min(t for w, t in times if w == "b6"),
                plain_ms=min(t for w, t in times if w == "plain"),
                b6_launches=device_launches(lambda: flush(0, True)),
                plain_launches=device_launches(lambda: flush(0, False)))
        out[name] = row
        emit("flush_kernels", case=name, card=label, **row)
        del cases, sels, exts
    if baseline is not None:
        out["baseline_resources"] = kernel_resources(baseline.path)
    emit("flush_kernels", case="resources", card=label, resources=out["resources"],
         baseline_resources=out.get("baseline_resources"))
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


#: the align stage's kernels every card run of it must launch
ALIGN_KERNELS = ("chain_scan", "extend_scan", "chain_select", "select_window", "finish_pack", "compact_cold")


def _counting_modules() -> tuple:
    """Every module that keeps a LaunchCounts of the port's kernels."""
    from phylign_tpu_torch.align import fused as fz
    from phylign_tpu_torch.models import matcher as tm
    from phylign_tpu_torch.ops import chain as opc
    from phylign_tpu_torch.ops import extend as ope
    from phylign_tpu_torch.ops import match as opm
    from phylign_tpu_torch.ops import minimizer as omz

    return opm, tm, opc, ope, fz, omz


def _kernel_counts() -> dict:
    """Launches by kernel since the last reset, every kernel of SOURCE
    listed (a counter lists some names only once launched)."""
    return {**dict.fromkeys(SOURCE, 0), **{k: v for m in _counting_modules() for k, v in m.launch_counts().items()}}


def _reset_counts() -> None:
    for m in _counting_modules():
        m.reset_launch_counts()


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
        counts[dev] = _kernel_counts()
        outs[dev] = _align_outputs(wd)
    c = counts["cuda"]
    if not all(c[k] for k in (*ALIGN_KERNELS, *B5_KERNELS)):
        raise AssertionError(f"fixture `all` did not launch B3, B4, B5 and B6: {c}")
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


def _align_pipeline(wd: Path, run_wd: Path, device: str, names, reads, cands, keep, mesh_devices=None):
    """A Pipeline in run_wd over wd's inputs, its 04_filter holding the
    records of the reads ``keep``: (pipeline, stem). ``mesh_devices``: a
    1xN mesh over these devices."""
    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.pipeline.stages import Pipeline

    if run_wd != wd:
        run_wd.mkdir()
        for d in ("asms", "data", "input"):
            (run_wd / d).symlink_to(wd / d)
        shutil.copy(wd / "config.yaml", run_wd / "config.yaml")
    cfg = Config.from_yaml(wd / "config.yaml")
    if mesh_devices:
        cfg = cfg.with_overrides(mesh_shape=f"1x{len(mesh_devices)}")
    pl = Pipeline(cfg, run_wd, device=device, mesh_devices=mesh_devices)
    stem = pl.preprocess([str(wd / "input" / "align_reads.fq")])
    _write_filter(pl, stem, names, reads, cands, keep)
    return pl, stem


def profile_align(pl, stem: str, out: Path) -> dict:
    """One more align run under cProfile (every thread: Python 3.12's
    profiler sees them all) and torch.profiler (device activity): device
    time by kernel, the device's busy share of the run's wall time, the
    host functions by own time, and per fused flush (engine._fused_dispatch
    calls) the device time, the CUDA kernels launched (copies and memsets
    not counted) and each B6 kernel's device time. The full tables go to
    ``out``."""
    import cProfile
    import pstats
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from phylign_tpu_torch.align import engine

    flushes = []
    dispatch = engine._fused_dispatch

    def counted(*a, **kw):
        flushes.append(1)
        return dispatch(*a, **kw)

    engine._fused_dispatch = counted
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as tp:
            prof.enable()
            pl.align(stem)
            torch.cuda.synchronize()
            prof.disable()
    finally:
        engine._fused_dispatch = dispatch
    wall = time.perf_counter() - t0
    dev = device_table(tp)
    dev_ms = sum(t for t, _ in dev.values())
    kernels = kernel_count(dev)
    host = sorted(
        ((f"{Path(fn).name}:{line}({name})", st[2], st[1]) for (fn, line, name), st in pstats.Stats(prof).stats.items()),
        key=lambda r: -r[1],
    )
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        f.write(f"align stage under both profilers: {wall:.3f} s wall, {dev_ms:.3f} ms device, "
                f"{len(flushes)} fused flushes, {kernels} kernels\n\n")
        f.write("device ms, launches, kernel or copy\n")
        for k, (t, n) in sorted(dev.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{t:10.3f} {n:8d}  {k}\n")
        f.write("\nhost own s, calls, function (all threads)\n")
        for name, tt, nc in host[:60]:
            f.write(f"{tt:10.3f} {nc:8d}  {name}\n")
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:10]
    n_fl = max(1, len(flushes))
    b6 = {k: sum(t for name, (t, _) in dev.items() if re.search(rf"\b{k}(_warp)?_kernel", name)) / n_fl
          for k in ("chain_select", "select_window", "finish_pack", "compact_cold")}
    return dict(profiled_wall_s=wall, device_ms=dev_ms, device_busy_share=dev_ms / 1e3 / wall,
                flushes=len(flushes), kernels=kernels, kernels_per_flush=kernels / n_fl,
                device_ms_per_flush=dev_ms / n_fl, b6_device_ms_per_flush=b6,
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
    # each flush's pairs and needed cold rows (the compaction's input),
    # summed on the card without a sync and read after the run
    from phylign_tpu_torch.align import fused as fz

    cold_need, compact = [], fz.compact_cold_cuda

    def count_need(sel):
        fl = sel.head[:, 2]
        need = (((fl & fz.F_HAS) != 0) & ((fl & fz.F_FULL) == 0)) | ((fl & 0xE0) != 0)
        cold_need.append((len(fl), need.sum()))
        return compact(sel)

    fz.compact_cold_cuda = count_need
    # the delegated extension's passes (engine._extend_items): (pass, P)
    from phylign_tpu_torch.ops import extend as ope

    delegated, entries = [], (ope.extend_banded_scores_packed, ope.extend_banded_packed)

    def passes(kind, fn):
        def run(q_pack, *a, **kw):
            delegated.append((kind, int(q_pack.shape[0]), int(a[4])))
            return fn(q_pack, *a, **kw)
        return run

    ope.extend_banded_scores_packed = passes("score", entries[0])
    ope.extend_banded_packed = passes("plane", entries[1])
    t0 = time.perf_counter()
    try:
        maps = pl.align(stem)
        torch.cuda.synchronize()
    finally:
        fz.compact_cold_cuda = compact
        ope.extend_banded_scores_packed, ope.extend_banded_packed = entries
    align_s = time.perf_counter() - t0
    cold_rows = [dict(pairs=n, needed=int(c)) for n, c in cold_need]
    counts = _kernel_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    t1 = time.perf_counter()
    summary = pl.aggregate(stem)
    pl.stats(stem)
    report_s = time.perf_counter() - t1
    if not all(counts[k] for k in ALIGN_KERNELS):
        raise AssertionError(f"the align stage did not launch B3, B4 and B6: {counts}")
    if not delegated or counts["extend_scan_packed"] != len(delegated):
        raise AssertionError(f"{len(delegated)} delegated extension passes launched "
                             f"{counts['extend_scan_packed']} packed B4 kernels")
    plane_passes = sum(kind == "plane" for kind, _, _ in delegated)
    if counts["traceback_walk"] != plane_passes:
        raise AssertionError(f"{plane_passes} plane passes launched {counts['traceback_walk']} traceback walks")
    dele = {kind: dict(passes=sum(k == kind for k, _, _ in delegated),
                       passes_by_P_L={f"{pp}x{ll}": sum(x == (kind, pp, ll) for x in delegated)
                                      for pp, ll in sorted({(pp, ll) for k, pp, ll in delegated if k == kind})})
            for kind in ("score", "plane")}
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
        peak_device_mb=peak_mb, launches=counts, cold_rows_per_flush=cold_rows, cold_cap=fz.COLD_CAP,
        delegated=dele, delegated_packed_launches=counts["extend_scan_packed"],
        traceback_launches=counts["traceback_walk"],
        cold_overflows=sum(r["needed"] > fz.COLD_CAP for r in cold_rows),
        planted=len(planted), placed=hit, placed_frac=frac,
        cpu_subset_reads=P7_SUBSET, cpu_subset_s=cpu_s, cpu_subset="identical",
        reduced=["2 batches of the collection's 305", f"{P7_CANDS} candidates per read, not nb_best_hits=100"],
        card=label,
    )
    emit("align_geometry", **res)
    if profile:
        pl_p, stem_p = _align_pipeline(wd, work / "align_profiled", "cuda", names, reads, cands, range(P7_READS))
        emit("align_profile", card=label, **profile_align(pl_p, stem_p, ROOT / "chiprun_out" / "align_profile.txt"))
    return counts, dict(names=names, reads=reads, cands=cands, truth=truth, align_s=align_s)


# --- phase 8: the device mesh on the one card ----------------------------------

#: phase 8 (a)'s doc shards, the four-card cell's (phase 2's 68 words: 17 a
#: shard); phase 8 (b)-(e)'s 2x2 mesh's devices, every cell on the one card
P8_ND = 4
P8_MESH = ["cuda:0"] * 4
#: phase 8 (a)'s cases, phase 2's main-path calls on one doc shard's slice
P8_CASES = {
    "b2_h1_q9216_shard": ("match_popcount_b2", 9216, 128, 1),
    "b1_h3_q1024_shard": ("match_popcount_b1", 1024, 128, 3),
}
#: the per-shard case of each kernel in the kernel table
SHARD_CASE = {
    "match_popcount_b2": "b2_h1_q9216_shard", "match_popcount_b1": "b1_h3_q1024_shard",
    "chain_scan": "b3_a32_shard", "extend_scan": "b4_score_shard",
}


def phase_mesh_kernels(label: str) -> dict:
    """(a) B1 and B2 on doc shards as the mesh lays them out
    (models/matcher.DocShards: phase 2's 68 words over P8_ND shards, 17
    words each and no padding): each shard's [S+1, width] block holds its
    words and zeros past them; bit-exact against the plain version on the
    block for every row set, the shards' words side by side against the
    full width on the first; timed over ROTATION row sets on shard 0."""
    import torch

    from phylign_tpu_torch.models.matcher import DocShards
    from phylign_tpu_torch.ops import match as opm

    gen = torch.Generator(device="cuda").manual_seed(8)
    layout = DocShards.of(WP, P8_ND)
    words = torch.zeros((S + 1, WP), dtype=torch.int32, device="cuda")
    words[:S] = random_words(gen, S)
    w_loc = layout.width
    shards = []
    for c0, n in zip(layout.starts, layout.words):
        sh = torch.zeros((S + 1, w_loc), dtype=torch.int32, device="cuda")
        sh[:, :n] = words[:, c0 : c0 + n]
        shards.append(sh)
    out = {}
    for case, (name, q, k, h) in P8_CASES.items():
        sets = [case_rows(gen, q, k, h) for _ in range(ROTATION)]
        fn = opm.match_scores_b1 if name.endswith("b1") else opm.match_scores_b2
        for i, rows in enumerate(sets):
            parts = [fn(sh, rows) for sh in shards]
            for d, (sh, got) in enumerate(zip(shards, parts)):
                if not torch.equal(got, opm.match_scores_ref(sh, rows)):
                    raise AssertionError(f"{case}: {name} on doc shard {d} differs from match_scores_ref")
            real = torch.cat([p[:, : 32 * n] for p, n in zip(parts, layout.words)], dim=1)
            if i == 0 and not torch.equal(real, opm.match_scores_ref(words, rows)):
                raise AssertionError(f"{case}: the doc shards side by side differ from the full width")
        torch.cuda.synchronize()
        ms = min(cuda_ms(lambda i: fn(shards[0], sets[i]), 6 * ROTATION, ROTATION) for _ in range(2))
        bounds = [gather_bound(r, w_loc) for r in sets]
        bound_ms = sum(b["bound_ms"] for b in bounds) / ROTATION
        out[case] = dict(
            kernel=name, q=q, k=k, h=h, S=S, Wp=WP, doc_shards=P8_ND, shard_words=w_loc,
            padding_words=layout.padding_words,
            max_abs_err=0, ms=ms, plain_ms=cuda_ms(lambda i: opm.match_scores_ref(shards[0], sets[i]), 2, 2),
            bytes=sum(b["bytes"] for b in bounds) / ROTATION, bound_ms=bound_ms,
            bound_by=bounds[0]["bound_by"], bound_share=bound_ms / ms,
            geometry=list(opm.launch_geometry(w_loc, k, h)),
        )
        emit("mesh_kernels", case=case, rotation=ROTATION, card=label, **out[case])
        del sets
    del words, shards
    torch.cuda.empty_cache()
    return out


def _outputs(wd: Path, dirs=("intermediate/03_match", "intermediate/04_filter",
                             "intermediate/05_map", "output")) -> dict:
    out = {}
    for d in dirs:
        for p in sorted((wd / d).iterdir()):
            out[f"{d}/{p.name}"] = gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes()
    return out


def _same_hits(got, want) -> bool:
    """Hit lists equal, in order, and n_keep."""
    return list(got[1]) == list(want[1]) and [list(h) for h in got[0]] == [list(h) for h in want[0]]


#: the mesh's match epilogue: B5b on each doc shard, B5d merging them
MESH_B5 = ("threshold_topk", "merge_topk")
#: operations of B5d's function, counted from its plain version
#: (_merge_topk_ref) where the data need them: an output entry's place in
#: the merge of nd sorted windows, ceil(log2 nd) compares, and the add of
#: its shard's column offset
B5D_ALU_ENTRY_PER_LEVEL, B5D_OTHER_ENTRY = 1, 1


def merge_bytes(windows, lims, w_loc: int, kk: int, out_idx) -> dict:
    """The bytes B5d's function must move on these windows: each shard's
    counts read, the outputs written ([Q, kk] twice and n_keep), and of
    the taken entries only those that reach the output (score and doc)
    plus, for each row and shard that takes more than reach it, the score
    of its first one left out (the compare that ends the merge there).
    ``out_idx`` is the plain version's global doc ids."""
    import torch

    q = out_idx.shape[0]
    reach = int((out_idx >= 0).sum())
    edges = 0
    for e, ((_, _, n), lim) in enumerate(zip(windows, lims)):
        if n is not None:
            used = ((out_idx >= e * w_loc) & (out_idx < (e + 1) * w_loc)).sum(1)
            edges += int((used < torch.clamp(n, 0, lim)).sum())
    counts = sum(w[2] is not None for w in windows)
    return dict(reach=reach, edges=edges, bytes=8 * reach + 4 * edges + 4 * q * counts + 8 * q * kk + 4 * q)


def merge_epilogue(windows, lims, w_loc: int, kk: int, baseline: BaselineLib | None = None) -> dict:
    """Kernel B5d on one merge call (phase 8 (b)'s first merge, one query
    column of the 2x2 mesh: few taken entries; or phase 4's dense call,
    dist_topk's cut of 0 over two doc shards: every row takes kk from
    each): against _merge_topk_ref on the call's windows and on ROTATION
    sets of them with the queries rolled, timed from CUDA graphs over
    those sets beside its bound, the plain version (CUDA events, its
    kernels from a CUDA graph) and torch.topk over the gathered windows
    (the second top-k of the parent's spelling; its library call). With
    ``baseline``, its library's B5d is held to the plain version on every
    set and timed beside this tree's in turns (baseline, new, new,
    baseline)."""
    import torch

    from phylign_tpu_torch.models import matcher as tm

    q = windows[0][0].shape[0]
    nd = len(windows)
    sets = [[tuple(None if t is None else torch.roll(t, (997 * i) % q, 0) for t in w) for w in windows]
            for i in range(ROTATION)]
    for ws in sets:
        want = tm._merge_topk_ref(ws, lims, w_loc, kk)
        for who in ("", "the baseline's ") if baseline is not None else ("",):
            with baseline.active() if who else contextlib.nullcontext():
                got = tm.merge_topk_cuda(ws, lims, w_loc, kk)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{who}B5d merge_topk differs from its plain version")
    reps = 4 * ROTATION
    kern = lambda i: tm.merge_topk_cuda(sets[i], lims, w_loc, kk)  # noqa: E731
    plain = lambda i: tm._merge_topk_ref(sets[i], lims, w_loc, kk)  # noqa: E731
    gathered = []
    for ws in sets:
        parts = []
        for (v, _, n), lim in zip(ws, lims):
            if n is not None:
                ok = torch.arange(lim, device=v.device)[None, :] < torch.clamp(n, 0, lim)[:, None]
                parts.append(torch.where(ok, v[:, :lim], -1))
        gathered.append(torch.cat(parts, dim=1))
    takes = sum(int(torch.clamp(n, 0, lim).sum()) for (_, _, n), lim in zip(windows, lims) if n is not None)
    levels = max(1, (nd - 1).bit_length())
    need = merge_bytes(windows, lims, w_loc, kk, tm._merge_topk_ref(windows, lims, w_loc, kk)[1])
    b = bound(need["bytes"], B5D_ALU_ENTRY_PER_LEVEL * levels * need["reach"] + need["edges"],
              B5D_OTHER_ENTRY * need["reach"])
    ms = min(graph_ms(kern, reps, ROTATION) for _ in range(2))
    res = dict(
        Q=q, shards=nd, w_loc=w_loc, kk=kk, lims=list(lims), taken=takes, reach_output=need["reach"],
        edge_compares=need["edges"], ms=ms,
        plain_ms=min(cuda_ms(plain, reps, ROTATION) for _ in range(2)),
        plain_launches=graph_launches(lambda: plain(0)), max_abs_err=0,
        library_ms=min(graph_ms(lambda i: torch.topk(gathered[i], min(kk, gathered[i].shape[1]), dim=1), reps,
                                ROTATION) for _ in range(2)),
        bound_share=b["bound_ms"] / ms, **b,
    )
    if baseline is not None:
        res.update(in_turns(baseline, kern, reps, ROTATION))
        res["turns_bound_share"] = b["bound_ms"] / res["turns_new_ms"]
        res["baseline_bound_share"] = b["bound_ms"] / res["baseline_ms"]
    return res


def dense_merge(scores, d: int, kk: int, baseline: BaselineLib | None = None) -> dict:
    """B5d at dist_topk's cut of 0 on a call's scores split over two doc
    shards (parallel/dist._shard_windows on a 2x1 mesh of the one card:
    B5b on each shard, every row taking min(kk, w_loc) from each), timed
    by merge_epilogue."""
    from phylign_tpu_torch.parallel import dist
    from phylign_tpu_torch.parallel.mesh import AXIS_DOC, AXIS_QUERY, make_mesh

    mesh = make_mesh(2, 1, devices=["cuda:0"] * 2)
    w_loc = scores.shape[1] // 2
    kk = min(kk, 2 * min(kk, w_loc))
    cells, lims = dist._shard_windows(mesh, dist.global_array(mesh, scores, (AXIS_QUERY, AXIS_DOC)), None, d, kk)
    windows = [cells[(e, 0)] for e in range(2)]
    if not all(int(n.min()) >= lim for (_, _, n), lim in zip(windows, lims)):
        raise AssertionError("the dense merge's rows do not all take kk from each shard")
    return merge_epilogue(windows, lims, w_loc, kk, baseline)


def phase_mesh(work: Path, label: str, p7: dict, b5_base: BaselineLib | None = None) -> dict:
    """(b)-(e): the mesh through the port's entry points, each against the
    1x1 card run; kernel launches counted in each drive."""
    import socket

    import torch
    import torch.distributed as tdist

    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.io.fastx import read_fastx_file
    from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq
    from phylign_tpu_torch.models.matcher import Matcher
    from phylign_tpu_torch.parallel import dist
    from phylign_tpu_torch.parallel.mesh import make_mesh
    from phylign_tpu_torch.pipeline.stages import Pipeline

    counts = {}

    def drive(key, fn):
        _reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[key] = _kernel_counts()
        return res, secs

    # (b) phase 4's batches through score_hits_raw, 2x2 mesh against 1x1
    full = work / "full"
    cfg = Config.from_yaml(full / "config.yaml")
    thr, topn = cfg.cobs_kmer_thres, cfg.nb_best_hits
    seqs = [r.seq.encode() for r in read_fastx_file(full / "input" / "reads.fq")]
    raw = cobs_kmer_hashes_batch([encode_seq(s) for s in seqs], 31, 1)
    mesh = make_mesh(2, 2, devices=P8_MESH)
    one_s = mesh_s = 0.0
    n_hits = 0
    b_counts = {}
    merge_calls = []  # the first B5d call, held to its plain version after (b)
    orig_merge = dist.merge_windows

    def capture_merge(*a):
        if not merge_calls:
            merge_calls.append(a)
        return orig_merge(*a)

    dist.merge_windows = capture_merge
    try:
        for b in (full / "data" / "batches.txt").read_text().split():
            didx = iocobs.load_device_index(full / "cobs_device_cache" / b, mmap=True)
            t0 = time.perf_counter()
            one = Matcher.from_device_index(didx, "cuda").score_hits_raw(raw, thr, topn)
            torch.cuda.synchronize()
            one_s += time.perf_counter() - t0
            got, secs = drive("b", lambda: Matcher.from_device_index(didx, "cuda", mesh=mesh).score_hits_raw(raw, thr, topn))
            mesh_s += secs
            b_counts = {k: b_counts.get(k, 0) + v for k, v in counts["b"].items()}
            if not _same_hits(got, one):
                raise AssertionError(f"mesh score_hits_raw on {b} differs from the 1x1 card run")
            n_hits += sum(len(h) for h in got[0])
    finally:
        dist.merge_windows = orig_merge
    last = got  # the last batch's mesh hits: (e)'s reference
    counts["b"] = b_counts
    if not all(counts["b"][k] for k in ("match_popcount_b2", *MESH_B5)):
        raise AssertionError(f"the 2x2 mesh did not launch B2, B5b and B5d: {counts['b']}")
    emit("mesh_match", mesh="2x2", devices=P8_MESH, batches=4, reads=len(seqs), hits=n_hits,
         one_device_s=one_s, mesh_s=mesh_s, launches=counts["b"], one_device="equal", card=label)
    b5d = merge_epilogue(*merge_calls[0], b5_base)
    emit("mesh_merge", card=label, **b5d)

    # (c) phase 6's fixture through Pipeline.run_all on the 2x2 mesh
    wd = work / "fixture_mesh"
    shutil.copytree(work / "fixture", wd, ignore=shutil.ignore_patterns("intermediate", "output", "logs"))
    pl = Pipeline(Config.from_yaml(wd / "config.yaml").with_overrides(mesh_shape="2x2"), wd,
                  device="cuda", mesh_devices=P8_MESH)
    _, secs = drive("c", lambda: pl.run_all(sorted(str(p) for p in (wd / "input").iterdir())))
    got, want = _outputs(wd), _outputs(work / "fixture_all_cuda")
    if got != want:
        raise AssertionError(f"fixture on the 2x2 mesh differs from phase 6 in {[k for k in want if got.get(k) != want[k]]}")
    # a mesh ships the full cold rows (no compaction) and packs its hits on
    # the host (no B5a, B5c), as the JAX mesh path does; the accumulating
    # and keep instances belong to the chunked pass and match_step; the
    # fixture's reads delegate no extension (none in phase 6 either), and a
    # mesh walks the traceback on the host
    off_path = ("compact_cold", "hash_rows", "pack_hits", "match_popcount_acc", "match_popcount_keep",
                "extend_scan_packed", "traceback_walk")
    if not all(v for k, v in counts["c"].items() if k not in off_path):
        raise AssertionError(f"the fixture on the 2x2 mesh did not launch every kernel: {counts['c']}")
    emit("mesh_fixture", mesh="2x2", files=len(got), seconds=secs, launches=counts["c"],
         one_device="identical", card=label)

    # (d) phase 7's align stage on a 1x2 mesh
    pl, stem = _align_pipeline(work / "align", work / "align_mesh", "cuda", p7["names"], p7["reads"],
                               p7["cands"], range(P7_READS), mesh_devices=P8_MESH[:2])
    _, align_s = drive("d", lambda: pl.align(stem))
    pl.aggregate(stem)
    pl.stats(stem)
    dirs = ("intermediate/05_map", "output")
    if _outputs(work / "align_mesh", dirs) != _outputs(work / "align", dirs):
        raise AssertionError("the align stage on the 1x2 mesh differs from phase 7's 1x1 run")
    if not all(counts["d"][k] for k in ALIGN_KERNELS if k != "compact_cold"):
        raise AssertionError(f"the 1x2 mesh did not launch B3, B4 and B6: {counts['d']}")
    pairs = P7_READS * P7_CANDS
    emit("mesh_align", mesh="1x2", devices=P8_MESH[:2], reads=P7_READS, pairs=pairs, align_s=align_s,
         pairs_per_s=pairs / align_s, one_device_align_s=p7["align_s"],
         one_device_pairs_per_s=pairs / p7["align_s"], launches=counts["d"], one_device="identical",
         card=label)

    # (e) a one-rank nccl group: the top-k gather through all_gather_into_tensor
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        pg_mesh = make_mesh(2, 2, devices=P8_MESH, group=tdist.group.WORLD)
        if pg_mesh.comm_device.type != "cuda":
            raise AssertionError(f"the nccl mesh gathers on {pg_mesh.comm_device}")
        pg, secs = drive("e", lambda: Matcher.from_device_index(didx, "cuda", mesh=pg_mesh).score_hits_raw(raw, thr, topn))
    finally:
        tdist.destroy_process_group()
    if not _same_hits(pg, last):
        raise AssertionError("the one-rank nccl mesh differs from the in-process mesh")
    if not all(counts["e"][k] for k in MESH_B5):
        raise AssertionError(f"the one-rank nccl mesh did not launch B5b and B5d: {counts['e']}")
    emit("mesh_nccl", mesh="2x2", backend="nccl", world_size=1, batch=b, seconds=secs,
         hits=sum(len(h) for h in last[0]), launches=counts["e"], in_process_mesh="equal", card=label)
    return {k: sum(c.get(k, 0) for c in counts.values()) for k in counts["c"]}, b5d



# --- phase 9: the rest of the CLI on the card -----------------------------------

#: phase 9 (f): match_step's calls on phase 2's matrix: (H, threshold). The
#: thresholds put the float32 cut inside each H's score range (about 25% of
#: the slots hit at H = 1, 1.6% at H = 3)
P9_STEP = {1: 0.3, 3: 0.02}
P9_Q, P9_K = 2048, 128


def run_cli(argv: list[str]) -> str:
    """``cli.main(argv)`` in this process, its stdout captured; a
    SystemExit other than 0 fails the phase."""
    from phylign_tpu_torch import cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"cli {argv[0]} exited {e.code!r}:\n{buf.getvalue()[-3000:]}") from e
    return buf.getvalue()


def run_console(argv: list[str], timeout: int = 900) -> str:
    """``python -m phylign_tpu_torch.cli`` (the console entry point,
    ``cli_entry``) in a subprocess: its exit code must be 0, so teardown
    after the card's work is held too."""
    res = subprocess.run([sys.executable, "-m", "phylign_tpu_torch.cli", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"console `{argv[0]}` exited {res.returncode}:\n{res.stderr[-3000:]}")
    return res.stdout


@contextlib.contextmanager
def loopback_server(root: Path):
    """A static file server for ``root`` on 127.0.0.1; yields (base url,
    request paths)."""
    import functools
    import http.server
    import threading

    hits = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            super().do_GET()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Handler, directory=str(root)))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", hits
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


def source_scores(didx, seqs: list[bytes], docs: list[int]):
    """The numpy oracle's score of each read against one doc of a 1-hash
    index (match/oracle.score_query_codes, vectorized over reads): int64
    scores and k-mer counts."""
    import numpy as np

    from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq

    raw = cobs_kmer_hashes_batch([encode_seq(s) for s in seqs], didx.term_size, 1)
    nk = np.array([r.shape[0] for r in raw], np.int64)
    rows = (np.concatenate(raw)[:, 0] % np.uint64(didx.signature_size)).astype(np.int64)
    doc = np.repeat(np.asarray(docs, np.int64), nk)
    bits = (np.asarray(didx.words)[rows, doc // 32] >> (doc % 32).astype(np.uint32)) & 1
    scores = np.add.reduceat(bits.astype(np.int64), np.concatenate([[0], np.cumsum(nk)[:-1]]))
    return np.where(nk > 0, scores, 0), nk


def phase_cli(work: Path, label: str, p7: dict, baseline: BaselineMatchKernels | None = None) -> tuple[dict, dict]:
    """(a) build-index + inspect-index on phase 7's tars; (b) download over
    loopback + preflight; (c) ``cli all`` on the card over the self-built
    indexes with phase 7's reads; (d) its 2,048-read subset through the
    console entry point on the card and with --device cpu; (e) ``cli test``
    and the host subcommands; (f) match_step on phase 2's matrix, timed
    from CUDA graphs (in turns with the baseline's keep instance under
    --baseline-src)."""
    import numpy as np
    import torch

    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.io.fastx import read_fastx_file
    from phylign_tpu_torch.pipeline import download

    counts, res = {}, {}

    def drive(key, fn):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts[key] = _kernel_counts()
        return out

    src = work / "align"
    batches = (src / "data" / "batches.txt").read_text().split()
    serve = work / "p9_serve"
    (serve / "cobs").mkdir(parents=True)
    shutil.copytree(src / "asms", serve / "asms")

    # (a) build-index at the reference's settings (k 31, one hash, fpr 0.3),
    # both tars at once through the console entry point
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "phylign_tpu_torch.cli", "build-index",
                               str(src / "asms" / f"{b}.tar.xz"), str(serve / "cobs" / f"{b}.cobs_classic.xz")],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for b in batches]
    built = []
    for pr in procs:
        out, err = pr.communicate(timeout=900)
        if pr.returncode != 0:
            raise AssertionError(f"build-index exited {pr.returncode}:\n{err[-3000:]}")
        built.append(out.strip())
    build_s = time.perf_counter() - t0
    for b in batches:
        rep = json.loads(run_cli(["inspect-index", str(serve / "cobs" / f"{b}.cobs_classic.xz")]))
        if not (rep["ok"] and rep["num_docs"] == P7_GENOMES and rep["term_size"] == 31 and rep["num_hashes"] == 1):
            raise AssertionError(f"inspect-index of {b}: {rep}")
    res["a"] = dict(build_s=build_s, built=built, index_mb={
        b: (serve / "cobs" / f"{b}.cobs_classic.xz").stat().st_size / 1e6 for b in batches})

    # (b) download into a fresh workdir over loopback, then preflight
    wd = work / "p9"
    (wd / "data").mkdir(parents=True)
    (wd / "input").mkdir()
    shutil.copy(src / "data" / "batches.txt", wd / "data" / "batches.txt")
    shutil.copy(src / "input" / "align_reads.fq", wd / "input" / "align_reads.fq")
    # fixed thread counts: check-cluster (e) accepts only such a config
    (wd / "config.yaml").write_text("batches: data/batches.txt\nthreads: 8\ncobs_threads: 4\n")
    saved = download.cobs_url, download.asms_url
    with loopback_server(serve) as (base, hits):
        download.cobs_url = lambda b: f"{base}/cobs/{b}.cobs_classic.xz"
        download.asms_url = lambda b: f"{base}/asms/{b}.tar.xz"
        try:
            t0 = time.perf_counter()
            got = run_cli(["download", "--workdir", str(wd)])
            download_s = time.perf_counter() - t0
        finally:
            download.cobs_url, download.asms_url = saved
    if got.count("downloaded (cobs+asms)") != len(batches) or len(hits) != 2 * len(batches):
        raise AssertionError(f"download: {got!r}, {len(hits)} requests")
    for b in batches:
        for d, suf in (("cobs", ".cobs_classic.xz"), ("asms", ".tar.xz")):
            if (wd / d / f"{b}{suf}").read_bytes() != (serve / d / f"{b}{suf}").read_bytes():
                raise AssertionError(f"downloaded {d}/{b}{suf} differs from the served file")
    pf = run_cli(["preflight", "--workdir", str(wd)])
    if "preflight PASSED" not in pf or "[FAIL]" in pf:
        raise AssertionError(f"preflight:\n{pf}")
    res["b"] = dict(download_s=download_s, requests=len(hits), preflight="PASSED")

    # (c) cli all on the card at the config defaults
    reads_fq = str(wd / "input" / "align_reads.fq")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = drive("c", lambda: run_cli(["all", "--workdir", str(wd), "--config", str(wd / "config.yaml"), reads_fq]))
    all_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    if not (counts["c"]["match_popcount_b2"] and all(counts["c"][k] for k in (*ALIGN_KERNELS, *B5_KERNELS))):
        raise AssertionError(f"`cli all` on the self-built indexes did not launch B2, B3, B4, B5 and B6: {counts['c']}")
    summary = Path(out.strip().split(": ", 1)[1])
    stem = summary.name.split(".sam_summary")[0]
    thr, keep = 0.7, 100  # Config defaults, which this workdir keeps
    didx = {b: iocobs.to_device_index(iocobs.read_classic_index(wd / "cobs" / f"{b}.cobs_classic.xz"))
            for b in batches}
    records = list(read_fastx_file(wd / "intermediate" / "01_queries_merged" / f"{stem}.fa"))
    for b in batches:
        want = oracle_text(didx[b], records[:64], thr, keep)
        got = gzip.open(wd / "intermediate" / "03_match" / f"{b}____{stem}.gz", "rt").read()
        if got[: len(want)] != want:
            raise AssertionError(f"03_match of {b} differs from the numpy oracle on the first 64 reads")
    names, reads, truth = p7["names"], p7["reads"], p7["truth"]
    genome_of = {}  # accession -> (batch, doc)
    for b in batches:
        for d, n in enumerate(didx[b].doc_names):
            genome_of[n.split("_", 1)[1]] = (b, d)
    planted = [i for i in range(P7_READS) if truth[i] is not None]
    src_acc = {i: truth[i][1].split(".")[0] for i in planted}
    clears = np.zeros(P7_READS, bool)
    for b in batches:
        mine = [i for i in planted if genome_of[src_acc[i]][0] == b]
        sc, nk = source_scores(didx[b], [reads[i] for i in mine], [genome_of[src_acc[i]][1] for i in mine])
        clears[mine] = (nk > 0) & (sc >= thr * nk)
    qualifying = [i for i in planted if clears[i]]
    placed = {}
    for line in gzip.open(summary, "rt"):
        f = line.split("\t")
        if len(f) > 5 and f[1] in ("0", "16"):
            placed.setdefault(f[0], set()).add((f[2], int(f[3]), int(f[1]) // 16))
    hit = sum(1 for i in qualifying if truth[i][1:] in placed.get(names[i], ()))
    frac = hit / len(qualifying)
    if frac < 0.95:
        raise AssertionError(f"only {hit} of {len(qualifying)} qualifying reads mapped to their position")
    filtered = list(read_fastx_file(wd / "intermediate" / "04_filter" / f"{stem}.fa"))
    stages = {}
    for rule in ("fix_query", "match_pipelined", "translate_matches", "match_total", "batch_align_pooled",
                 "aggregate_sams", "final_stats", "map_total"):
        for f in (wd / "logs" / "benchmarks" / rule).glob("*.txt"):
            stages[rule] = float(f.read_text().splitlines()[-1].split("\t")[0])
    res["c"] = dict(
        reads=P7_READS, threshold=thr, nb_best_hits=keep, planted=len(planted),
        clear_threshold=len(qualifying), clear_share=len(qualifying) / len(planted),
        placed=hit, placed_frac=frac, filtered_reads=len(filtered),
        pairs=sum(len(r.comment.split(",")) for r in filtered if r.comment),
        all_s=all_s, match_s=stages.get("match_total"), align_s=stages.get("map_total"),
        stages_s=stages, peak_device_mb=peak_mb, launches=counts["c"],
        oracle_sample=64,
    )

    # (d) a 2,048-read subset through the console entry point: card and CPU
    sub = sorted(np.random.default_rng(3).choice(P7_READS, P7_SUBSET, replace=False).tolist())
    outs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        dwd = work / f"p9_subset_{dev}"
        (dwd / "input").mkdir(parents=True)
        for d in ("cobs", "asms", "data"):
            (dwd / d).symlink_to(wd / d)
        shutil.copy(wd / "config.yaml", dwd / "config.yaml")
        with open(dwd / "input" / "subset.fq", "w") as f:
            for i in sub:
                f.write(f"@{names[i]}\n{reads[i].decode()}\n+\n{'I' * len(reads[i])}\n")
        t0 = time.perf_counter()
        run_console(["all", "--workdir", str(dwd), "--config", str(dwd / "config.yaml"),
                     "--device", dev, str(dwd / "input" / "subset.fq")])
        secs[dev] = time.perf_counter() - t0
        outs[dev] = _outputs(dwd)
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"subset `all` differs between cuda and cpu in "
                             f"{[k for k in outs['cpu'] if outs['cuda'].get(k) != outs['cpu'][k]]}")
    res["d"] = dict(reads=P7_SUBSET, files=len(outs["cuda"]), seconds=secs, cpu="identical")

    # (e) the fixture's golden test on the card, then the host subcommands
    t_out = drive("e", lambda: run_cli(["test", "--workdir", str(work / "p9_test")]))
    if "test PASSED" not in t_out:
        raise AssertionError(f"cli test: {t_out!r}")
    if not (counts["e"]["match_popcount_b2"] and all(counts["e"][k] for k in (*ALIGN_KERNELS, *B5_KERNELS))):
        raise AssertionError(f"`cli test` did not launch B2, B3, B4, B5 and B6: {counts['e']}")
    rest = {
        "stats": ["stats", str(summary), "--queries", str(wd / "intermediate" / "01_queries_merged" / f"{stem}.fa")],
        "report": ["report", "--workdir", str(wd)],
        "index-sizes": ["index-sizes", "--cobs-dir", str(wd / "cobs"), "--out", str(wd / "data" / "sizes.txt")],
        "config": ["config", "--workdir", str(wd)],
        "check-cluster": ["check-cluster", "--workdir", str(wd)],
        "clean": ["clean", "--workdir", str(wd), "--all"],
    }
    for name, argv in rest.items():
        run_cli(argv)
    left = sorted(p.name for p in wd.iterdir())
    if {"cobs", "asms", "intermediate", "output", "logs"} & set(left) or "report.html" not in left:
        raise AssertionError(f"report + clean --all left {left}")
    res["e"] = dict(test="PASSED", launches=counts["e"], host_subcommands=sorted(rest))

    # (f) match_step on phase 2's matrix (regenerated from its seed)
    from phylign_tpu_torch.models.matcher import match_step
    from phylign_tpu_torch.ops import match as opm

    gen = torch.Generator(device="cuda").manual_seed(2)
    words = torch.cat([random_words(gen, S), torch.zeros((1, WP), dtype=torch.int32, device="cuda")])
    step = {}
    counts["f"] = {}
    for h, thr_h in P9_STEP.items():
        rows = case_rows(gen, P9_Q, P9_K, h)
        nk = torch.randint(1, P9_K + 1, (P9_Q,), generator=gen, device="cuda", dtype=torch.int32)
        nk[::16] = 0
        nk[P9_Q - 8 :] = 0
        slot = torch.arange(P9_K, device="cuda")
        rows[(slot[None, :] >= nk[:, None])] = S
        scores, keep = drive(f"f{h}", lambda: match_step(words, rows, nk, thr_h))
        counts["f"] = {k: counts["f"].get(k, 0) + v for k, v in counts[f"f{h}"].items()}
        if {k: v for k, v in counts[f"f{h}"].items() if v} != {"match_popcount_keep": 1}:
            raise AssertionError(f"match_step at H={h} was not one launch of the keep instance: {counts[f'f{h}']}")
        ref = opm.match_scores_ref(words, rows)
        if not torch.equal(scores, ref):
            raise AssertionError(f"match_step at H={h} differs from match_scores_ref")
        plain = opm.match_scores_keep_ref(words, rows, nk, thr_h)
        if not (torch.equal(scores, plain[0]) and torch.equal(keep, plain[1])):
            raise AssertionError(f"match_step at H={h} differs from match_scores_keep_ref")
        sc, nkn = scores.cpu().numpy(), nk.cpu().numpy()
        cut = np.float32(thr_h) * nkn.astype(np.float32)
        want = (sc.astype(np.float32) >= cut[:, None]) & (nkn[:, None] > 0)
        if not np.array_equal(keep.cpu().numpy(), want):
            raise AssertionError(f"match_step's keep at H={h} differs from the float32 formula")
        on_cut = int(((sc == np.ceil(cut)[:, None]) & (nkn[:, None] > 0)).sum())
        if on_cut == 0 or not (nkn == 0).any():
            raise AssertionError(f"match_step at H={h}: no score on the cut ({on_cut}) or no empty query")
        new = lambda i: match_step(words, rows, nk, thr_h)  # noqa: E731
        # the keep instance a query at 4 x Q (over one wave), beside Q's
        g4 = torch.Generator(device="cuda").manual_seed(90 + h)
        rows4 = case_rows(g4, 4 * P9_Q, P9_K, h)
        nk4 = torch.randint(1, P9_K + 1, (4 * P9_Q,), generator=g4, device="cuda", dtype=torch.int32)
        rows4[(slot[None, :] >= nk4[:, None])] = S
        new4 = lambda i: match_step(words, rows4, nk4, thr_h)  # noqa: E731
        if baseline is not None:
            old = lambda i: baseline.keep(words, rows, nk, thr_h)  # noqa: E731
            if not all(torch.equal(a, b) for a, b in zip(old(0), (scores, keep))):
                raise AssertionError(f"the baseline's keep instance at H={h} differs from match_step")
            old4 = lambda i: baseline.keep(words, rows4, nk4, thr_h)  # noqa: E731
            turns = [(who, graph_ms(new if who == "new" else old, 20)) for who in ("baseline", "new", "new", "baseline")]
            turns4 = [(who, graph_ms(new4 if who == "new" else old4, 20)) for who in ("baseline", "new", "new", "baseline")]
        else:
            turns = [("new", graph_ms(new, 20))]
            turns4 = [("new", graph_ms(new4, 20))]
        b4 = gather_bound(rows4, WP)
        b4 = bound(b4["bytes"] + 4 * P9_Q * 32 * WP + 16 * P9_Q, 4 * P9_Q * P9_K * h * WP + 8 * P9_Q * 32 * WP)
        del rows4, nk4
        # bytes: B1/B2's, the keep bytes and n_kmers; operations: an AND or
        # add a gathered word, a convert and a compare a column
        b = gather_bound(rows, WP)
        b = bound(b["bytes"] + P9_Q * 32 * WP + 4 * P9_Q, P9_Q * P9_K * h * WP + 2 * P9_Q * 32 * WP)
        ms = min(t for w, t in turns if w == "new")
        split = opm.keep_split(WP, P9_K, h, P9_Q, opm.resident_threads(words.device))
        step[f"h{h}"] = dict(q=P9_Q, k=P9_K, threshold=thr_h, instance=opm.select_kernel(P9_K, h),
                             split=split, geometry=list(opm.keep_geometry(WP, P9_K, h, split)),
                             empty_queries=int((nkn == 0).sum()), scores_on_cut=on_cut,
                             kept=int(want.sum()), ms=ms,
                             baseline_ms=min((t for w, t in turns if w == "baseline"), default=None),
                             turns=turns, plain_ms=cuda_ms(lambda i: opm.match_scores_keep_ref(words, rows, nk, thr_h), 2),
                             launches_per_call=graph_launches(lambda: match_step(words, rows, nk, thr_h)),
                             profiler_launches_per_call=device_launches(lambda: match_step(words, rows, nk, thr_h)),
                             max_abs_err=0, bound_share=b["bound_ms"] / ms, **b)
        q4_ms = min(t for w, t in turns4 if w == "new")
        step[f"h{h}"].update(q4_turns=turns4, q4_ms=q4_ms,
                             q4_baseline_ms=min((t for w, t in turns4 if w == "baseline"), default=None),
                             q4_split=opm.keep_split(WP, P9_K, h, 4 * P9_Q, opm.resident_threads(words.device)),
                             q4_bound_ms=b4["bound_ms"], q4_bound_by=b4["bound_by"], q4_bytes=b4["bytes"],
                             q4_bound_share=b4["bound_ms"] / q4_ms)
        for who in ("", "baseline_") if baseline is not None else ("",):
            step[f"h{h}"][f"{who}per_query_q_over_4q"] = 4 * step[f"h{h}"][f"{who}ms"] / step[f"h{h}"][f"q4_{who}ms"]
    del words
    torch.cuda.empty_cache()
    if any(step[f"h{h}"]["launches_per_call"] != 1 for h in P9_STEP):
        raise AssertionError(f"match_step's graph is not one kernel: {[step[f'h{h}']['launches_per_call'] for h in P9_STEP]}")
    if counts["f"]["match_popcount_keep"] != len(P9_STEP):
        raise AssertionError(f"match_step did not launch the keep instance once a call: {counts['f']}")
    res["f"] = dict(S=S, Wp=WP, **step, launches=counts["f"])
    total = {k: sum(counts[c].get(k, 0) for c in ("c", "e", "f")) for k in counts["c"]}
    emit("cli", card=label, **res, launches=total)
    return total, step


# --- phase 10: an oversized index, streamed row-chunked -------------------------

#: phase 10 (a): the largest real batch, pseudomonas_aeruginosa__01 (10.59 GB
#: decompressed, SURVEY.md), as Bloom rows of phase 2's 68 words
S10 = 39_000_000
#: host memory phase 10 (a) leaves free beside its index (GiB)
P10_HEADROOM_GB = 16


def mem_available() -> int:
    """MemAvailable of /proc/meminfo in bytes (0 where it cannot be read)."""
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def acc_bound(idx, r0: int, r1: int, wp: int, mode: str) -> dict:
    """The accumulating instance's least time for one block of a pass in
    ``mode``: each distinct row of the window read once and the row
    indices once, then the accumulator: add reads and writes the int32
    counts; first writes bit_length(K) planes a word; middle reads and
    writes the planes of the words of queries with a slot in the window
    (the others add nothing); last reads the planes and writes the int32
    counts (bytes).
    An AND or add a word of each slot in the window and an add a count
    (operations)."""
    import torch

    from phylign_tpu_torch.ops import match as opm

    q, k = idx.shape[:2]
    inside = (idx >= r0) & (idx < r1)
    distinct = int(torch.unique(idx[inside]).numel())
    slots = int(inside.sum())
    counts, planes = 4 * q * 32 * wp, 4 * q * wp * opm.b2_planes(k)
    out = {"add": 2 * counts, "first": planes, "last": planes + counts,
           "middle": 2 * 4 * int(inside.any(dim=1).sum()) * wp * opm.b2_planes(k)}[mode]
    return bound(distinct * 4 * wp + 4 * q * k + out, slots * wp + q * 32 * wp)


def pass_bound(idx, spans, wp: int) -> dict:
    """The least work of a row-chunked pass, whatever carries the counts
    between blocks: each block's distinct rows read once, the row indices
    once a block and the int32 scores written once (bytes); an AND or add
    a word of each slot in the index and an add a count (operations)."""
    import torch

    q, k = idx.shape[:2]
    rows = sum(int(torch.unique(idx[(idx >= a) & (idx < b)]).numel()) for a, b in spans)
    slots = int(((idx >= spans[0][0]) & (idx < spans[-1][1])).sum())
    return bound(rows * 4 * wp + len(spans) * 4 * q * k + 4 * q * 32 * wp, slots * wp + q * 32 * wp)


def copy_rates(host, slot_rows: int) -> dict:
    """GB/s of a pinned slot's copy to the card (CUDA events) and of the
    host's fill of that slot from ``host`` (models/matcher._fill_rows), one
    STAGE_SLOT_BYTES slot, the best of 5."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from phylign_tpu_torch.models import matcher as tm

    ring = torch.empty((slot_rows, host.shape[1]), dtype=torch.int32, pin_memory=True)
    dev = torch.empty_like(ring, device="cuda")
    nbytes = ring.numel() * 4
    h2d, fill = [], []
    with ThreadPoolExecutor(tm.FILL_THREADS) as pool:
        for i in range(5):
            t0 = time.perf_counter()
            tm._fill_rows(pool, ring.numpy().view(np.uint32), host, (i * slot_rows) % (host.shape[0] - slot_rows))
            fill.append(nbytes / (time.perf_counter() - t0) / 1e9)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dev.copy_(ring, non_blocking=True)
            b.record()
            torch.cuda.synchronize()
            h2d.append(nbytes / (a.elapsed_time(b) / 1e3) / 1e9)
    return dict(slot_bytes=nbytes, pinned_h2d_gb_s=max(h2d), host_fill_gb_s=max(fill), fill_threads=tm.FILL_THREADS)


def phase_oversized(work: Path, label: str, baseline: BaselineMatchKernels | None = None) -> tuple[dict, dict]:
    """(a) ChunkedMatcher at the match stage's default chunk budget on a
    pseudomonas-size index against the resident Matcher; the accumulating
    kernel's block modes and pass on the resident words (in turns with the
    baseline's int32 instance with --baseline-src). (b) phase 4's batches
    through ``cli match`` at device_hbm_gb 1, 03_match byte-identical."""
    import numpy as np
    import torch

    from phylign_tpu_torch import cli
    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.io import cobs as iocobs
    from phylign_tpu_torch.io.fastx import read_fastx_file
    from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq
    from phylign_tpu_torch.models import matcher as tm
    from phylign_tpu_torch.ops import match as opm
    from phylign_tpu_torch.pipeline.stages import Pipeline

    counts = {}
    full = work / "full"
    cfg = Config.from_yaml(full / "config.yaml")
    thr, topn = cfg.cobs_kmer_thres, cfg.nb_best_hits

    # (a) the index: phase 2's matrix tiled to S10 rows (cut to what the
    # host's memory holds), every third read planted into a doc
    avail = mem_available()
    fit = (avail - P10_HEADROOM_GB * 2**30) // (4 * WP)
    s10 = S10 if fit >= S10 else max(S, int(fit) // S * S)
    reduced = None if s10 == S10 else f"S cut from {S10:,} to {s10:,} rows: MemAvailable {avail:,} bytes"
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)
    base = random_words(gen, S)
    base_host = base.cpu().numpy().view(np.uint32)
    host = np.empty((s10, WP), np.uint32)
    for a in range(0, s10, S):
        host[a : a + S] = base_host[: min(S, s10 - a)]
    seqs = [r.seq.encode() for r in read_fastx_file(full / "input" / "reads.fq")]
    raw = cobs_kmer_hashes_batch([encode_seq(x) for x in seqs], 31, 1)
    planted = [(i, (7 * i) % N_DOCS) for i in range(0, len(seqs), 3) if raw[i].shape[0]]
    rows_p = np.concatenate([(raw[i][:, 0] % np.uint64(s10)).astype(np.int64) for i, _ in planted])
    docs_p = np.concatenate([np.full(raw[i].shape[0], d, np.int64) for i, d in planted])
    np.bitwise_or.at(host, (rows_p, docs_p // 32), np.uint32(1) << (docs_p % 32).astype(np.uint32))
    didx = iocobs.DeviceIndex(term_size=31, num_hashes=1, signature_size=s10,
                              doc_names=[f"{d:04d}_SAMP{d:05d}" for d in range(N_DOCS)], words=host)
    setup_s = time.perf_counter() - t0

    # the stage's call, at the default config's budget
    budget = Pipeline(Config(), work / "p10_budget", device="cuda")._chunk_budget_mb()
    cm = tm.ChunkedMatcher.from_device_index(didx, hbm_budget_mb=budget, device="cuda")
    blocks = -(-s10 // cm.row_chunk)
    passes = []
    orig_pass = tm.ChunkedMatcher._score_pass

    def timed_pass(self, packed):
        t = time.perf_counter()
        acc = orig_pass(self, packed)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t, packed, acc))
        return acc

    torch.cuda.synchronize()
    before_mb = torch.cuda.memory_allocated() / 1e6
    torch.cuda.reset_peak_memory_stats()
    tm.ChunkedMatcher._score_pass = timed_pass
    _reset_counts()
    try:
        t0 = time.perf_counter()
        got = cm.score_hits_raw(raw, thr, topn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tm.ChunkedMatcher._score_pass = orig_pass
    counts["a"] = _kernel_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6 - before_mb
    if len(passes) != 1 or counts["a"]["match_popcount_acc"] != blocks or not counts["a"]["threshold_topk"]:
        raise AssertionError(f"the chunked pass: {len(passes)} passes, {blocks} blocks, launches {counts['a']}")
    if peak_mb > budget:
        raise AssertionError(f"the chunked pass peaked at {peak_mb:.0f} MB over its {budget} MB budget")
    pass_s, packed, acc = passes[0]
    # the same pass again: the pinned ring and the device buffers now come
    # from torch's caches, so the difference is their first allocation
    t0 = time.perf_counter()
    again = cm._score_pass(packed)
    torch.cuda.synchronize()
    warm_pass_s = time.perf_counter() - t0
    if not torch.equal(again, acc):
        raise AssertionError("a second chunked pass differs from the first")
    del again

    # the resident Matcher on the same index, on the card
    words = torch.empty((s10 + 1, WP), dtype=torch.int32, device="cuda")
    for a in range(0, s10, S):
        words[a : min(a + S, s10)] = base[: min(S, s10 - a)]
    words[s10] = 0
    cells = np.unique(rows_p * WP + docs_p // 32)
    r_u, c_u = torch.from_numpy(cells // WP).cuda(), torch.from_numpy(cells % WP).cuda()
    words[r_u, c_u] = torch.from_numpy(host.reshape(-1)[cells].view(np.int32)).cuda()
    resident = tm.Matcher(term_size=31, num_hashes=1, signature_size=s10, doc_names=didx.doc_names, words=words)
    one = resident.score_hits_raw(raw, thr, topn)
    if not _same_hits(got, one):
        raise AssertionError("the chunked pass's hits differ from the resident Matcher's")
    idx = torch.from_numpy(np.ascontiguousarray(packed.reshape(packed.shape[0], -1))).cuda()
    if not torch.equal(acc, opm.match_scores(words, torch.where(idx == cm.pad_row, s10, idx))):
        raise AssertionError("the chunked pass's scores differ from B2's on the whole index")
    n_hits = sum(len(h) for h in got[0])
    if n_hits < len(planted):
        raise AssertionError(f"{n_hits} hits for {len(planted)} planted reads")

    # the accumulating kernel's pass on the device-resident words, block by
    # block: each block mode bit for bit against its plain version, the
    # pass against B2 on the whole index; then from CUDA graphs the first
    # block, a middle one, the last and the pass's launches, in turns with
    # the baseline's int32 accumulating instance on the same blocks (its
    # pass from a zeroed accumulator, as the parent ran it)
    spans = [(a, min(a + cm.row_chunk, s10)) for a in range(0, s10, cm.row_chunk)]
    nb = len(spans)
    acc_t = torch.full_like(acc, -1)

    def run_block(i: int):
        a, b = spans[i]
        return opm.match_scores_acc_planes_(acc_t, words[a:b], idx, a, b, i == 0, i == nb - 1)

    plain_ms = {}
    for i, (a, b) in enumerate(spans):
        t0 = time.perf_counter()
        want = opm.match_scores_acc_planes_ref_(acc_t.clone(), words[a:b], idx, a, b, i == 0, i == nb - 1)
        torch.cuda.synchronize()
        plain_ms[i] = (time.perf_counter() - t0) * 1e3
        run_block(i)
        if not torch.equal(acc_t, want):
            raise AssertionError(f"the accumulating kernel's block {i} of {nb} differs from match_scores_acc_planes_ref_")
    if not torch.equal(acc_t, acc):
        raise AssertionError("the accumulating kernel's pass on the resident words differs from B2's scores")
    del want
    cases = {"first": [0], "middle": [1] if nb > 2 else [], "last": [nb - 1] if nb > 1 else [],
             "pass": list(range(nb))}
    acc_b = torch.zeros_like(acc)

    def old_run(ids):
        def run(_):
            if len(ids) > 1:
                acc_b.zero_()
            for i in ids:
                baseline.acc_(acc_b, words[spans[i][0] : spans[i][1]], idx, *spans[i])
        return run

    if baseline is not None:
        old_run(cases["pass"])(0)
        if not torch.equal(acc_b, acc):
            raise AssertionError("the baseline's accumulating pass differs from B2's scores")
    kernel = {}
    for name, ids in cases.items():
        if not ids:
            continue
        new = lambda _, ids=ids: [run_block(i) for i in ids]  # noqa: E731
        reps = 10 if name == "pass" else 20
        if baseline is not None:
            turns = [(who, graph_ms(new if who == "new" else old_run(ids), reps))
                     for who in ("baseline", "new", "new", "baseline")]
        else:
            turns = [("new", graph_ms(new, reps))]
        ms = min(t for w, t in turns if w == "new")
        if name == "pass":
            b = pass_bound(idx, spans, WP)
        else:
            b = acc_bound(idx, *spans[ids[0]], WP, name)
        kernel[name] = dict(blocks=[list(spans[i]) for i in ids], ms=ms, turns=turns,
                            baseline_ms=min((t for w, t in turns if w == "baseline"), default=None),
                            plain_ms=sum(plain_ms[i] for i in ids), bound_share=b["bound_ms"] / ms, **b)
    # the int32 mode (match_scores_acc_, the contract of JAX's
    # _acc_chunk_scores) on the first block, from a non-zero accumulator:
    # bit for bit against match_scores_acc_ref_, timed in turns with the
    # baseline's on the same slots and on slots compacted beforehand by
    # torch ops (each query's rows in the block first, K cut to the most
    # such rows rounded up to 8: what compaction alone saves the baseline)
    a0, a1 = spans[0]
    acc_i = torch.full_like(acc, 3)
    t0 = time.perf_counter()
    want = opm.match_scores_acc_ref_(acc_i.clone(), words[a0:a1], idx, a0, a1)
    torch.cuda.synchronize()
    add_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(opm.match_scores_acc_(acc_i, words[a0:a1], idx, a0, a1), want):
        raise AssertionError("the accumulating kernel's int32 mode differs from match_scores_acc_ref_")
    runs = {"new": lambda _: opm.match_scores_acc_(acc_i, words[a0:a1], idx, a0, a1)}
    order, extra = ("new",), {}
    if baseline is not None:
        inside = (idx >= a0) & (idx < a1)
        kc = -(-int(inside.sum(1).max()) // 8) * 8
        keys = torch.sort((~inside).to(torch.uint8), dim=1, stable=True).indices
        compact = torch.gather(idx, 1, keys)[:, :kc].contiguous()
        if not torch.equal(baseline.acc_(torch.full_like(acc, 3), words[a0:a1], compact, a0, a1), want):
            raise AssertionError("the baseline on the host-compacted slots differs from match_scores_acc_ref_")
        runs["baseline"] = lambda _: baseline.acc_(acc_i, words[a0:a1], idx, a0, a1)
        runs["baseline_compacted"] = lambda _: baseline.acc_(acc_i, words[a0:a1], compact, a0, a1)
        order = ("baseline", "baseline_compacted", "new", "new", "baseline_compacted", "baseline")
        extra = dict(compacted_k=kc, slots_in_block_mean=float(inside.sum(1).float().mean()))
    del want
    turns = [(who, graph_ms(runs[who], 20)) for who in order]
    ms = min(t for w, t in turns if w == "new")
    b = acc_bound(idx, a0, a1, WP, "add")
    kernel["add"] = dict(blocks=[list(spans[0])], ms=ms, turns=turns,
                         baseline_ms=min((t for w, t in turns if w == "baseline"), default=None),
                         baseline_compacted_ms=min((t for w, t in turns if w == "baseline_compacted"), default=None),
                         plain_ms=add_plain_ms, bound_share=b["bound_ms"] / ms, **extra, **b)
    kernel = dict(block_rows=spans[0][1], Q=idx.shape[0], K=idx.shape[1], max_abs_err=0, library_ms=None,
                  **kernel["first"], by_mode=kernel)
    del acc_t, acc_b, acc_i, runs
    rates = copy_rates(host, min(tm.STAGE_SLOT_BYTES // (4 * WP), cm.row_chunk))
    index_bytes = s10 * WP * 4
    res_a = dict(
        S=s10, Wp=WP, docs=N_DOCS, index_gb=index_bytes / 1e9, reduced=reduced, reads=len(seqs),
        unique_queries=idx.shape[0], K=idx.shape[1], planted=len(planted), hits=n_hits, budget_mb=budget,
        row_chunk=cm.row_chunk, blocks=blocks, setup_s=setup_s, score_hits_raw_s=wall, pass_s=pass_s,
        h2d_gb_s=index_bytes / pass_s / 1e9, warm_pass_s=warm_pass_s, warm_h2d_gb_s=index_bytes / warm_pass_s / 1e9,
        **rates, peak_device_mb=peak_mb, resident="equal",
        launches=counts["a"], acc_kernel=kernel,
    )
    emit("oversized_index", card=label, **res_a)
    del words, acc, base, passes, r_u, c_u, resident
    del host, didx, cm
    torch.cuda.empty_cache()

    # (b) phase 4's batches through cli match at device_hbm_gb 1
    wd = work / "full_chunked"
    wd.mkdir()
    for name in ("cobs_device_cache", "data", "input"):
        (wd / name).symlink_to(full / name)
    (wd / "config.yaml").write_text((full / "config.yaml").read_text() + "device_hbm_gb: 1\n")
    _reset_counts()
    t0 = time.perf_counter()
    cli.main(["match", "--workdir", str(wd), "--config", str(wd / "config.yaml"), str(wd / "input" / "reads.fq")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts["b"] = _kernel_counts()
    batches = (full / "data" / "batches.txt").read_text().split()
    for bt in batches:
        want = gzip.open(next((full / "intermediate" / "03_match").glob(f"{bt}____*.gz")), "rb").read()
        got_b = gzip.open(next((wd / "intermediate" / "03_match").glob(f"{bt}____*.gz")), "rb").read()
        if got_b != want:
            raise AssertionError(f"03_match of {bt} at device_hbm_gb 1 differs from phase 4's resident run")
    chunk_budget = Pipeline(Config.from_yaml(wd / "config.yaml"), work / "p10_budget_b", device="cuda")._chunk_budget_mb()
    c = counts["b"]
    if not (c["match_popcount_acc"] and c["threshold_topk"]) or c["match_popcount_b2"]:
        raise AssertionError(f"cli match at device_hbm_gb 1 did not stream every batch row-chunked: {c}")
    emit("oversized_cli", card=label, batches=len(batches), device_hbm_gb=1, chunk_budget_mb=chunk_budget,
         blocks_per_batch=c["match_popcount_acc"] / len(batches), seconds=secs, launches=c,
         phase4="byte-identical")
    total = {k: counts["a"].get(k, 0) + c.get(k, 0) for k in c}
    return total, dict(res_a, cli_seconds=secs, cli_blocks_per_batch=c["match_popcount_acc"] / len(batches))


# --- phase 11: the candidate genome's minimizer table on the card ----------------

#: phase 11's genomes: (name, contig lengths, kind): the map cell's sizes
#: (2.75 Mb in one contig, 4.25 Mb in two) and a repetitive genome (tandem
#: repeats and a poly-A run: hundreds of thousands of equal hashes)
RI_CASES = [
    ("ri_2.75mb_1c", (2_750_000,), "random"),
    ("ri_4.25mb_2c", (3_000_000, 1_250_000), "random"),
    ("ri_repeats", (400_000, 200_000, 400_000), "repeats"),
]
MAIN_RI_CASE = "ri_4.25mb_2c"
#: the map cell, its seed and the window of its one traced job
RI_CELL, RI_SEED = "amr-genes.map", 2300000023


def ri_genome(rng, lens, kind: str):
    """(name, contigs) of one phase 11 genome."""
    import numpy as np

    contigs = []
    for i, n in enumerate(lens):
        if kind == "repeats" and i == 0:
            seq = np.tile(rng.integers(0, 4, 37).astype(np.uint8), -(-n // 37))[:n]
        elif kind == "repeats" and i == 1:
            seq = np.zeros(n, np.uint8)
        else:
            seq = rng.integers(0, 4, n).astype(np.uint8)
        contigs.append((f"c{i}", seq))
    return kind, contigs


def ri_resources(lib: Path) -> dict:
    """Registers, stack, shared and local memory of each kernel of
    ref_index.cu's library (cuobjdump -res-usage); {} without cuobjdump."""
    import re

    from phylign_tpu_torch.ops import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    res = subprocess.run([str(tool), "-res-usage", str(lib)], capture_output=True, text=True, timeout=120)
    out = {}
    for name, reg, stack, shared, local in re.findall(
            r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", res.stdout):
        m = re.search(r"(ref_sketch_kernel|ref_sort_hist_kernel|ref_sort_scatter_kernel|ref_scan_kernel)(I(?:Lb[01]E)+E)?", name)
        if m:
            out[m.group(1) + (m.group(2) or "")] = dict(registers=int(reg), stack_bytes=int(stack),
                                                       shared_bytes=int(shared), local_bytes=int(local))
    return out


def phase_ref_index(work: Path, label: str) -> dict:
    """(a) ref_sketch and ref_sort at RI_CASES' genomes: the device route's
    table (build_ref_index on the card) byte for byte against the native
    host path, each kernel's output against its plain version; each timed
    from CUDA graphs beside its bound (the least bytes at HBM_BYTES_PER_S:
    the codes read and the table written; the table read and written), the
    plain version's time and torch.sort(stable=True)'s as library_ms, the
    device route's wall time a genome against the host path's; the kernels'
    registers (a kernel with local memory fails). (b) one RI_CELL job with
    the program's spans on (scripts/program_spans.py): every genome's table
    built on the card (align.device_ref_genomes == align.genomes), with the
    job's align.ref_index, align.anchors and align.wait."""
    import numpy as np
    import torch

    from phylign_tpu_torch.ops import _kernels
    from phylign_tpu_torch.ops import minimizer as omz

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    res = ri_resources(_kernels.build("ref_index"))
    emit("ref_index_resources", card=label, kernels=res)
    if not res:
        raise AssertionError("cuobjdump read no kernel of ref_index.cu")
    spills = {k: v for k, v in res.items() if v["local_bytes"]}
    if spills:
        raise AssertionError(f"ref_index kernels use local memory: {spills}")
    out = {}
    for name, lens, kind in RI_CASES:
        gname, contigs = ri_genome(rng, lens, kind)
        t0 = time.perf_counter()
        want = omz.build_ref_index(gname, contigs, 21, 11)
        host_ms = (time.perf_counter() - t0) * 1e3
        omz.build_ref_index(gname, contigs, 21, 11, device=dev)  # warm: pinned blocks, the library
        route_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = omz.build_ref_index(gname, contigs, 21, 11, device=dev)
            route_ms.append((time.perf_counter() - t0) * 1e3)
        for f in ("codes", "contig_starts", "contig_lens", "sort_hash", "sort_pos", "sort_strand"):
            a, b = getattr(got, f), getattr(want, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"{name}: the device route's {f} differs from the host path's")
        starts, clens, codes_h = omz._assemble(contigs)
        st, ln = torch.tensor(starts), torch.tensor(clens)
        codes = torch.from_numpy(codes_h).to(dev)
        sk = omz.ref_sketch_cuda(codes, st, ln, 21, 11)
        t0 = time.perf_counter()
        sk_ref = omz.ref_sketch_ref(torch.from_numpy(codes_h), st, ln, 21, 11)
        sketch_plain_ms = (time.perf_counter() - t0) * 1e3
        if not all(torch.equal(a.cpu(), b) for a, b in zip(sk, sk_ref)):
            raise AssertionError(f"{name}: ref_sketch differs from ref_sketch_ref")
        srt = omz.ref_sort_cuda(*sk, 42)
        t0 = time.perf_counter()
        srt_ref = omz.ref_sort_ref(*sk_ref, 42)
        sort_plain_ms = (time.perf_counter() - t0) * 1e3
        if not all(torch.equal(a.cpu(), b) for a, b in zip(srt, srt_ref)):
            raise AssertionError(f"{name}: ref_sort differs from ref_sort_ref")
        m = int(sk[0].numel())
        # the sketch's two passes at the known size (no wait between them)
        n_pos = (ln - 20).clamp(min=0)
        first = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(-(-n_pos // omz.SKETCH_TILE), 0)])
        n_tiles = int(first[-1])
        c_start, c_len, first32 = st.to(dev), ln.to(dev), first.to(torch.int32).to(dev)
        cnt = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
        outs = [torch.empty(m, dtype=t, device=dev) for t in (torch.int64, torch.int32, torch.uint8)]
        args = (codes, c_start, c_len, first32, len(starts), n_tiles, omz.SKETCH_TILE, 21, 11)

        def sketch(_):
            _kernels.launch(omz._launches, "ref_sketch_count", "ref_index", "phylign_ref_sketch", *args, 0, cnt,
                            None, None, None)
            _kernels.launch(omz._launches, "ref_sketch", "ref_index", "phylign_ref_sketch", *args, 1, cnt, *outs)

        sketch_ms = min(graph_ms(sketch, 8) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(outs, sk)):
            raise AssertionError(f"{name}: the timed sketch passes differ from ref_sketch_cuda")
        sort_ms = min(graph_ms(lambda _: omz.ref_sort_cuda(*sk, 42), 8) for _ in range(2))
        library_ms = cuda_ms(lambda _: torch.sort(sk[0], stable=True), 8)
        sketch_bytes = int((ln.clamp(min=0)).sum()) + 13 * m
        sort_bytes = 2 * 13 * m
        row = dict(genome_bases=int(ln.sum()), contigs=len(lens), minimizers=m,
                   distinct_hashes=int(np.unique(want.sort_hash).size), host_path_ms=host_ms,
                   device_route_ms=min(route_ms), device_route_turns=route_ms,
                   sketch=dict(ms=sketch_ms, plain_ms=sketch_plain_ms, bytes=sketch_bytes,
                               bound_ms=sketch_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                               kernels_per_call=graph_launches(lambda: sketch(0))),
                   sort=dict(ms=sort_ms, plain_ms=sort_plain_ms, bytes=sort_bytes, library_ms=library_ms,
                             bound_ms=sort_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                             kernels_per_call=graph_launches(lambda: omz.ref_sort_cuda(*sk, 42))))
        for k in ("sketch", "sort"):
            row[k]["bound_share"] = row[k]["bound_ms"] / row[k]["ms"]
        out[name] = row
        emit("ref_index", case=name, card=label, **row)
        del sk, srt, outs, codes
    # (b) one map job with the spans on
    sys.path.insert(0, str(ROOT / "scripts"))
    import program_spans
    from gpubench import run as gb_run

    spec = gb_run.load_cell(RI_CELL)
    wd = work / "ri_job"
    wd.mkdir(parents=True, exist_ok=True)
    res_cell, rep = program_spans.run_with_spans(spec, RI_SEED, 0.01, False, True, "cuda", wd)
    counts = rep["counts"]
    split = {k: rep["split"][k] for k in ("align.ref_index", "align.anchors", "align.wait", "stage.align")
             if k in rep["split"]}
    job = dict(cell=RI_CELL, seed=RI_SEED, correct=res_cell.get("correct"), jobs=rep["units"],
               genomes=counts.get("align.genomes"), device_ref_genomes=counts.get("align.device_ref_genomes"),
               split=split, map_pairs_per_s=res_cell["metrics"].get("map_pairs_per_s", {}).get("value"))
    emit("ref_index_job", card=label, **job)
    if not counts.get("align.genomes") or counts["align.device_ref_genomes"] != counts["align.genomes"]:
        raise AssertionError(f"{RI_CELL}: {counts.get('align.device_ref_genomes')} of {counts.get('align.genomes')} "
                             "genomes' tables built on the card")
    if res_cell.get("correct") is not True:
        raise AssertionError(f"{RI_CELL}: the job's output is not correct: {res_cell}")
    out["job"] = job
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-src", type=Path, default=None,
                    help="an older csrc/match_popcount.cu with PR 13's C interface: time its "
                    "store kernels beside this tree's in phase 2, its keep instance in phase "
                    "9 (f) and its int32 accumulating instance in phase 10 (a)")
    ap.add_argument("--baseline-align", type=Path, default=None,
                    help="a directory holding PR 4's csrc/chain_scan.cu and "
                    "csrc/extend_scan.cu: time them beside this tree's B3/B4 in phase 5")
    ap.add_argument("--baseline-flush", type=Path, default=None,
                    help="an older csrc/flush_epilogue.cu with this tree's C interface: "
                    "time its B6a, B6b, B6c and compaction beside this tree's in phase 5")
    ap.add_argument("--baseline-match", type=Path, default=None,
                    help="an older csrc/match_epilogue.cu with this tree's C interface: "
                    "time its B5a, B5b, B5c and B5d beside this tree's in phases 4 and 8")
    ap.add_argument("--baseline-extend", type=Path, default=None,
                    help="an older csrc/extend_scan.cu: hold this tree's unpacked B4 instances "
                    "to its SASS in phase 5 (fails if one differs)")
    ap.add_argument("--align-kernels-only", action="store_true",
                    help="phase 5 only (no kernel table, no ok line)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phase 2 only (no kernel table, no ok line)")
    ap.add_argument("--ref-index-only", action="store_true",
                    help="phase 11 only (no kernel table, no ok line)")
    ap.add_argument("--profile", action="store_true",
                    help="phase 7 aligns once more under cProfile and torch.profiler "
                    "(tables in chiprun_out/align_profile.txt)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
    baseline = BaselineMatchKernels(args.baseline_src) if args.baseline_src else None
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=label, build_seconds=build_s)

    pr4 = Pr4AlignKernels(args.baseline_align) if args.baseline_align else None
    b6_base = BaselineLib("flush_epilogue", args.baseline_flush) if args.baseline_flush else None
    b5_base = BaselineLib("match_epilogue", args.baseline_match) if args.baseline_match else None
    if args.align_kernels_only:
        phase_align_kernels(label, pr4, args.baseline_extend)
        phase_flush_kernels(label, b6_base)
        return 0
    if args.ref_index_only:
        work = ROOT / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            phase_ref_index(work, label)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    kern = phase_kernels(label, baseline)
    if args.kernels_only:
        return 0
    akern = phase_align_kernels(label, pr4, args.baseline_extend)
    fkern = phase_flush_kernels(label, b6_base)
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        c3 = phase_fixture(work)
        c4, b5 = phase_full_geometry(work, label, b5_base)
        c6 = phase_fixture_all(work)
        c7, p7 = phase_align_geometry(work, label, args.profile)
        mkern = phase_mesh_kernels(label)
        c8, b5d = phase_mesh(work, label, p7, b5_base)
        c9, c9_step = phase_cli(work, label, p7, baseline)
        c10, p10 = phase_oversized(work, label, baseline)
        ri = phase_ref_index(work, label)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def shard(name: str) -> dict:
        k = {**akern, **mkern}[SHARD_CASE[name]]
        return dict(shard_case=SHARD_CASE[name], shard_ms=k["ms"], shard_bound_ms=k["bound_ms"],
                    shard_bound_share=k["bound_share"])

    table = []
    for name, case in MAIN_CASE.items():
        k = kern[case]
        table.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=c3[name] + c4[name] + c6[name] + c8[name] + c9[name] + c10[name], launches_phase3=c3[name],
            launches_phase4=c4[name], launches_phase6=c6[name], launches_phase8=c8[name],
            launches_phase9=c9[name], launches_phase10=c10[name],
            case=case, max_abs_err=max(v["max_abs_err"] for v in [*kern.values(), *mkern.values()]
                                       if v["kernel"] == name),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            bound_share=k["bound_share"], distinct_rows=k["distinct_rows"], bytes=k["bytes"],
            library_ms=None, **shard(name),
        ))
    for name, case in MAIN_ALIGN_CASE.items():
        k = akern[case]
        table.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=c6[name] + c7[name] + c8[name] + c9[name], launches_phase6=c6[name],
            launches_phase7=c7[name], launches_phase8=c8[name], launches_phase9=c9[name],
            case=case, max_abs_err=max(v["max_abs_err"] for v in akern.values() if v["kernel"] == name),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            bound_share=k["bound_share"], bytes=k["bytes"], operations=k["operations"],
            library_ms=None, **shard(name),
        ))
    k = akern["b4p_score"]
    b4p = {n: v for n, v in akern.items() if v["kernel"] == "extend_scan_packed"}
    table.append(dict(
        name="extend_scan_packed", route="cuda", source=SOURCE["extend_scan_packed"],
        replaces=REPLACES["extend_scan_packed"], launches=sum(c["extend_scan_packed"] for c in (c6, c7, c8, c9)),
        launches_phase6=c6["extend_scan_packed"], launches_phase7=c7["extend_scan_packed"],
        launches_phase8=c8["extend_scan_packed"], launches_phase9=c9["extend_scan_packed"],
        case=f"b4p_score: P={k['P']}, L={k['L']}, band {k['band']}, score-only, {k['design']}",
        design=k["design"], max_abs_err=max(v["max_abs_err"] for v in b4p.values()), ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"], bound_share=k["bound_share"],
        bytes=k["bytes"], operations=k["operations"], library_ms=None, row_ms=k["row_ms"],
        row_lanes=k["row_lanes"], parent_eager_ms=k["parent_eager_ms"],
        parent_eager_kernels=k["parent_eager_kernels_per_call"],
        **{f"{n[4:]}_{x}": v[x] for n, v in b4p.items() if n != "b4p_score" for x in (
            "P", "L", "band", "design", "ms", "row_ms", "row_lanes", "plain_ms", "bound_ms",
            "bound_by", "bound_share")},
    ))
    k = akern[MAIN_TB_CASE]
    tbk = {n: v for n, v in akern.items() if v["kernel"] == "traceback_walk"}
    table.append(dict(
        name="traceback_walk", route="cuda", source=SOURCE["traceback_walk"],
        replaces=REPLACES["traceback_walk"], launches=sum(c["traceback_walk"] for c in (c6, c7, c8, c9)),
        launches_phase6=c6["traceback_walk"], launches_phase7=c7["traceback_walk"],
        launches_phase8=c8["traceback_walk"], launches_phase9=c9["traceback_walk"],
        case=f"{MAIN_TB_CASE}: {k['pairs']} gapped pairs, L={k['L']}, band {k['band']}, over B4's plane pass",
        max_abs_err=0, ms=k["ms"], plain_ms=k["plain_ms"], host_ms_per_pair=k["host_ms_per_pair"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], bound_share=k["bound_share"], bytes=k["bytes"],
        operations=k["operations"], library_ms=None,
        **{f"{n}_{x}": v[x] for n, v in tbk.items() if n != MAIN_TB_CASE for x in (
            "L", "band", "pairs", "ms", "plain_ms", "host_ms_per_pair", "bound_ms", "bound_by", "bound_share")},
    ))
    for name, key in (("ref_sketch", "sketch"), ("ref_sort", "sort")):
        k = ri[MAIN_RI_CASE][key]
        table.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=sum(c[name] for c in (c6, c7, c8, c9)), launches_phase6=c6[name],
            launches_phase7=c7[name], launches_phase8=c8[name], launches_phase9=c9[name],
            case=f"{MAIN_RI_CASE}: {ri[MAIN_RI_CASE]['genome_bases']:,} bases in {ri[MAIN_RI_CASE]['contigs']} "
            f"contigs, {ri[MAIN_RI_CASE]['minimizers']:,} minimizers", max_abs_err=0, ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"], bound_share=k["bound_share"],
            bytes=k["bytes"], library_ms=k.get("library_ms"),
            **{f"{n}_{x}": v[key][x] for n, v in ri.items() if n not in (MAIN_RI_CASE, "job")
               for x in ("ms", "bound_ms", "bound_share")},
        ))
    for name, case in MAIN_B6_CASE.items():
        k = fkern[case] if name == "chain_select" else fkern[case][name]
        checked = [v for v in fkern.values() if v.get("kernel") == ("chain_select" if name == "chain_select"
                                                                     else "flush_epilogue")]
        table.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=c6[name] + c7[name] + c8[name] + c9[name], launches_phase6=c6[name],
            launches_phase7=c7[name], launches_phase8=c8[name], launches_phase9=c9[name],
            case=case, max_abs_err=max(v["max_abs_err"] for v in checked),
            ms=k["ms"], plain_ms=k["plain_ms"], plain_launches=k["plain_launches"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], bound_share=k["bound_share"], bytes=k["bytes"],
            operations=k["operations"], library_ms=None,
        ))
    for name in B5_KERNELS:
        k = b5["kernels"][name]
        hint = b5["kernels"]["pack_hits_hint_cap"]
        extra = dict(hint_cap=b5["hint_cap"], hint_ms=hint["ms"], hint_plain_ms=hint["plain_ms"],
                     hint_bound_ms=hint["bound_ms"], hint_bound_by=hint["bound_by"],
                     hint_bound_share=hint["bound_share"]) if name == "pack_hits" else {}
        table.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
            launches=c3[name] + c4[name] + c6[name] + c8[name] + c9[name] + c10[name], launches_phase3=c3[name],
            launches_phase4=c4[name], launches_phase6=c6[name], launches_phase8=c8[name],
            launches_phase9=c9[name], launches_phase10=c10[name], case=f"phase 4's first call: Q={b5['Q']}, K={b5['K']}, d={b5['d']}, "
            f"kk={b5['kk']}, cap={b5['cap']}", max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], plain_launches=k["plain_launches"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], bound_share=k["bound_share"], bytes=k["bytes"],
            operations=k["operations"], library_ms=k["library_ms"], **extra,
        ))
    acc, keep = p10["acc_kernel"], c9_step["h1"]
    modes = {f"{m}_{key}": v[key] for m, v in acc["by_mode"].items() if m != "first"
             for key in ("ms", "baseline_ms", "bound_ms", "bound_share")}
    table.append(dict(
        name="match_popcount_acc", route="cuda", source=SOURCE["match_popcount_acc"],
        replaces=REPLACES["match_popcount_acc"], launches=c10["match_popcount_acc"],
        launches_phase10=c10["match_popcount_acc"],
        case=f"phase 10 (a)'s first block: {acc['block_rows']:,} of {p10['S']:,} rows x {WP} words, "
        f"Q={acc['Q']}, K={acc['K']}", max_abs_err=acc["max_abs_err"], ms=acc["ms"], plain_ms=acc["plain_ms"],
        bound_ms=acc["bound_ms"], bound_by=acc["bound_by"], bound_share=acc["bound_share"], bytes=acc["bytes"],
        operations=acc["operations"], library_ms=None, baseline_ms=acc["baseline_ms"], **modes,
    ))
    table.append(dict(
        name="match_popcount_keep", route="cuda", source=SOURCE["match_popcount_keep"],
        replaces=REPLACES["match_popcount_keep"], launches=c9["match_popcount_keep"],
        launches_phase9=c9["match_popcount_keep"],
        case=f"phase 9 (f): match_step at H=1 ({keep['instance']}), Q={keep['q']}, K={keep['k']}, S={S:,}",
        max_abs_err=keep["max_abs_err"], ms=keep["ms"], plain_ms=keep["plain_ms"], bound_ms=keep["bound_ms"],
        bound_by=keep["bound_by"], bound_share=keep["bound_share"], bytes=keep["bytes"],
        operations=keep["operations"], library_ms=None, baseline_ms=keep["baseline_ms"],
        h3_ms=c9_step["h3"]["ms"], h3_baseline_ms=c9_step["h3"]["baseline_ms"],
        h3_bound_ms=c9_step["h3"]["bound_ms"],
    ))
    table.append(dict(
        name="merge_topk", route="cuda", source=SOURCE["merge_topk"], replaces=REPLACES["merge_topk"],
        launches=c8["merge_topk"], launches_phase8=c8["merge_topk"],
        case=f"phase 8 (b)'s first merge: Q={b5d['Q']}, {b5d['shards']} shards of {b5d['w_loc']} columns, "
        f"kk={b5d['kk']}", max_abs_err=b5d["max_abs_err"], ms=b5d["ms"], plain_ms=b5d["plain_ms"],
        plain_launches=b5d["plain_launches"], bound_ms=b5d["bound_ms"], bound_by=b5d["bound_by"],
        bound_share=b5d["bound_share"], bytes=b5d["bytes"], operations=b5d["operations"],
        library_ms=b5d["library_ms"], baseline_ms=b5d.get("baseline_ms"),
        **{f"dense_{k}": b5["merge_dense"].get(k) for k in (
            "Q", "w_loc", "kk", "taken", "ms", "baseline_ms", "plain_ms", "plain_launches", "bound_ms",
            "bound_by", "bound_share", "library_ms")},
    ))
    emit("runtime", script_s=time.perf_counter() - t_start, card=label)
    print(json.dumps({"kernels": table}), flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
