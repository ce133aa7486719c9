"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/phylign_tpu_torch/`` (beside the package, named by a hash of the
source and the flags, so an edited source is rebuilt) and loaded with
``ctypes``. Nothing is built or loaded when a module is imported.

Every failure to build, load or launch raises :class:`KernelError`. Callers
on the pipeline's paths re-raise it instead of retrying, and nothing falls
back to the plain PyTorch version on a CUDA tensor.
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
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "phylign_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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
    returns the library's path. Safe against concurrent builders: each
    compiles to a private file and renames it into place."""
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
    seconds each took (0 when it was already built)."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))

    def one(name: str) -> float:
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return dict(zip(names, pool.map(one, names)))


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
    elif name == "chain_scan":
        lib.phylign_chain_scan.restype = i32
        # rpos, qpos, q16, cost, p, a, w, k, max_gap, bandwidth,
        # warps_per_block, f, parent, stream
        lib.phylign_chain_scan.argtypes = [p, p, i32, p, i32, i32, i32, i32, i32, i32, i32, p, p, p]
    elif name == "extend_scan":
        f32 = ctypes.c_float
        lib.phylign_extend_scan.restype = i32
        # q, q_len, rwin, rvalid, p, l, band, match, mismatch, o1, e1, o2,
        # e2, open1, open2, collect, warps_per_block, score, end_d, plane,
        # stream
        lib.phylign_extend_scan.argtypes = [
            p, p, p, p, i32, i32, i32, f32, f32, f32, f32, f32, f32, f32, f32,
            i32, i32, p, p, p, p,
        ]
    lib.phylign_cuda_error_string.restype = ctypes.c_char_p
    lib.phylign_cuda_error_string.argtypes = [i32]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise KernelError for a non-zero cudaError_t returned by a launch."""
    if err != 0:
        msg = lib.phylign_cuda_error_string(err).decode(errors="replace")
        raise KernelError(f"{what} launch failed: cudaError {err} ({msg})")
