"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/phylign_tpu_torch/`` (beside the package, named by a hash of the
source and the flags, so an edited source is rebuilt) and loaded with
``ctypes``. Nothing is built or loaded when a module is imported.

Every failure to build, load or launch raises :class:`KernelError`. Callers
on the pipeline's paths re-raise it instead of retrying, and nothing falls
back to the plain PyTorch version on a CUDA tensor. A source is compiled at
most once in a process: a caller that finds its build in flight (the
pipeline's warm-up thread, ``build_all``) waits for it and gets its library
or its error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import Future
from pathlib import Path

# each kernel module counts its launches in one of the program's counters
from phylign_tpu_torch.utils.trace import Counters as LaunchCounts

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "phylign_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: each source's build in this process, in flight or done (its path or
#: error)
_build_lock = threading.Lock()
_builds: dict[str, Future] = {}


class KernelError(RuntimeError):
    """A hand-written CUDA kernel failed to build, load or launch."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.blake2b(
        src + " ".join(NVCC_FLAGS).encode(), digest_size=8
    ).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(name: str) -> Path:
    """Compile ``csrc/{name}.cu`` unless an up-to-date library exists;
    returns the library's path. The first call in a process builds; every
    later or concurrent call returns the same path or raises the same
    error, so no source is compiled twice and a failed build is not
    retried."""
    with _build_lock:
        fut = _builds.get(name)
        owner = fut is None
        if owner:
            fut = _builds[name] = Future()
    if not owner:
        return fut.result()
    try:
        out = _compile(name)
    except BaseException as e:
        fut.set_exception(e)
        raise
    fut.set_result(out)
    return out


def _compile(name: str) -> Path:
    """Run nvcc unless the library exists. Safe against concurrent
    processes: each compiles to a private file and renames it into place."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise KernelError(
                f"nvcc failed ({res.returncode}) for {name}.cu:\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> dict[str, float]:
    """Build every ``csrc/*.cu`` in parallel (one nvcc each); returns the
    seconds each took (0 when it was already built). Every source is
    tried; the first failure (in name order) is raised after all end."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))

    def one(name: str) -> float:
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max(1, len(names))) as pool:
        futs = {n: pool.submit(one, n) for n in names}
    return {n: f.result() for n, f in futs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(build(name)))
            except OSError as e:
                raise KernelError(f"cannot load the {name} library: {e}") from e
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    """Declare every exported function's signature: a pointer or stream
    passed without ``c_void_p`` would be cut to 32 bits."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if name == "match_popcount":
        for fn in (lib.phylign_match_popcount_b1, lib.phylign_match_popcount_b2):
            fn.restype = i32
            # words, n_rows, wp, row_idx, q, k, h, planes, qt, wt, staged,
            # via_smem, out, stream
            fn.argtypes = [p, i64, i32, p, i32, i32, i32, i32, i32, i32, i32, i32, p, p]
        lib.phylign_match_popcount_acc.restype = i32
        # words, r0, r1, wp, row_idx, q, k, h, planes, qt, wt, staged,
        # via_smem, mode, acc, stream
        lib.phylign_match_popcount_acc.argtypes = [p, i32, i32, i32, p, *[i32] * 9, p, p]
        lib.phylign_match_popcount_keep.restype = i32
        # words, n_rows, wp, row_idx, q, k, h, planes, qt, wt, split,
        # staged, via_smem, n_kmers, threshold, out, keep, stream
        lib.phylign_match_popcount_keep.argtypes = [
            p, i64, i32, p, *[i32] * 9, p, ctypes.c_float, p, p, p,
        ]
    elif name == "chain_scan":
        lib.phylign_chain_scan.restype = i32
        # rpos, qpos, q16, cost, p, a, w, lanes, k, max_gap, bandwidth, f,
        # parent, stream
        lib.phylign_chain_scan.argtypes = [p, p, i32, p, i32, i32, i32, i32, i32, i32, i32, p, p, p]
    elif name == "extend_scan":
        lib.phylign_extend_scan.restype = i32
        # q, q_len, rwin, rvalid, p, l, band, lanes, match, mismatch, o1,
        # e1, o2, e2, open1, open2, wide, collect, score, end_d, plane, stream
        lib.phylign_extend_scan.argtypes = [p, p, p, p, *[i32] * 14, p, p, p, p]
        if hasattr(lib, "phylign_extend_scan_packed"):  # absent from older sources
            lib.phylign_extend_scan_packed.restype = i32
            # q_pack, q_len, r_pack, lo, hi, p, l, band, lanes, match,
            # mismatch, o1, e1, o2, e2, open1, open2, wide, collect, score,
            # end_d, plane, stream
            lib.phylign_extend_scan_packed.argtypes = [p, p, p, p, p, *[i32] * 14, p, p, p, p]
    elif name == "traceback_walk":
        lib.phylign_traceback_walk.restype = i32
        # plane, q_pack, q_len, r_pack, lo, hi, end_d, n, l, band, match,
        # mismatch, o1, e1, o2, e2, open1, open2, dirs, ops, meta, stream
        lib.phylign_traceback_walk.argtypes = [*[p] * 7, *[i32] * 3, *[ctypes.c_float] * 8, p, p, p, p]
    elif name == "flush_epilogue":
        f32 = ctypes.c_float
        for fn in (lib.phylign_chain_select, lib.phylign_select_window,
                   lib.phylign_finish_pack, lib.phylign_compact_cold):
            fn.restype = i32
        lib.phylign_chain_select_workspace.restype = i64
        lib.phylign_chain_select_workspace.argtypes = [i32, i32]
        # f, parent, rpos, qpos, q16, p, a, k, n_sup, rounds, ws, out, stream
        lib.phylign_chain_select.argtypes = [p, p, p, p, *[i32] * 6, p, p, p]
        # fields, rows, n_buckets, n_sup, cand_map, pair_base, pair_reflen,
        # q_pack, nqb, q_len, pool, pool_bytes, cst, clen, n_contigs, p,
        # lmax, wlen, half, min_cnt, min_score, n_out, q_codes, rwin, rvalid,
        # lohi, hot, flts, cold_i, cold_f, stream
        lib.phylign_select_window.argtypes = [
            p, p, i32, i32, p, p, p, p, i32, p, p, i64, p, p, *[i32] * 6, f32, i32,
            p, p, p, p, p, p, p, p, p,
        ]
        # q_codes, q_len, rwin, lohi, ext_score, end_d, p, lmax, wlen, match,
        # mismatch, min_dp, zdrop, hot, neq, stream
        lib.phylign_finish_pack.argtypes = [p, p, p, p, p, p, *[i32] * 7, p, p, p]
        # hot, cold_i, cold_f, p, n_out, cap, cc_i, cc_f, stream
        lib.phylign_compact_cold.argtypes = [p, p, p, *[i32] * 3, p, p, p]
    elif name == "match_epilogue":
        for fn in (lib.phylign_hash_rows, lib.phylign_threshold_topk, lib.phylign_pack_hits):
            fn.restype = i32
        lib.phylign_threshold_topk_workspace.restype = i64
        lib.phylign_threshold_topk_workspace.argtypes = [i32, i32]
        # hi, lo, nk, q, k, h, s, pad_row, rows, stream
        lib.phylign_hash_rows.argtypes = [p, p, p, i32, i32, i32, i64, i32, p, p]
        # scores, stride, cut, q, d, kk, ws, vals, idx, n_keep, stream
        lib.phylign_threshold_topk.argtypes = [p, i64, p, i32, i32, i32, p, p, p, p, p]
        # vals, idx, n_keep, q, kk, cap, out, stream
        lib.phylign_pack_hits.argtypes = [p, p, p, i32, i32, i32, p, p]
        if hasattr(lib, "phylign_merge_topk"):  # not in a source older than B5d
            lib.phylign_merge_topk.restype = i32
            # nd, vals[nd], idx[nd], n_keep[nd], stride[nd], lim[nd], w_loc,
            # q, kk, out_vals, out_idx, out_n, stream
            lib.phylign_merge_topk.argtypes = [i32, p, p, p, p, p, i32, i32, i32, p, p, p, p]
    elif name == "ref_index":
        lib.phylign_ref_sketch.restype = i32
        # codes, c_start, c_len, tile_first, n_contigs, n_tiles, tile, k, w,
        # write, tile_cnt, out_hash, out_pos, out_strand, stream
        lib.phylign_ref_sketch.argtypes = [p, p, p, p, *[i32] * 6, p, p, p, p, p]
        lib.phylign_ref_sort_hist_len.restype = i64
        lib.phylign_ref_sort_hist_len.argtypes = [i64]
        lib.phylign_ref_sort.restype = i32
        # hash, pos, strand, m, bits, keys_a, vals_a, keys_b, vals_b, hist,
        # out_hash, out_pos, out_strand, stream
        lib.phylign_ref_sort.argtypes = [p, p, p, i64, i32, *[p] * 9]
    lib.phylign_cuda_error_string.restype = ctypes.c_char_p
    lib.phylign_cuda_error_string.argtypes = [i32]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise KernelError for a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.phylign_cuda_error_string(err).decode(errors="replace")
        raise KernelError(f"{what} launch failed: cudaError {err} ({msg})")


def launch(counts: LaunchCounts, name: str, source: str, fn: str, *args) -> None:
    """Call ``fn`` of ``csrc/{source}.cu``'s library with ``args`` and the
    current stream of the first tensor's device appended (a tensor passes
    its data pointer, None a null pointer, anything else itself); raise
    KernelError if the launch failed, else count one launch of ``name``."""
    import torch

    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = library(source)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    check(lib, err, name)
    counts.add(name)
