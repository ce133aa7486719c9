"""ctypes bindings for the port's native host library (``hostio.cpp``).

The port's own copy of the match path's part of ``phylign_tpu.native``: XXH64
row hashing, the 03_match text parser, the dedup's unique+inverse and the
filter's top-k core. At first use ``hostio.cpp`` is
compiled with ``g++`` into ``build/phylign_tpu_torch/`` beside the package
(named by a hash of the source, the flags and the host's CPU model, so an
edited source is rebuilt; each builder compiles to a private file and renames it into place,
so concurrent processes are safe). Without a compiler every ``native_*``
function returns None and callers take their numpy paths, which give the
same results. ``PHYLIGN_TPU_NO_NATIVE=1`` disables the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("phylign_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "hostio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "phylign_tpu_torch"
#: the flags of phylign_tpu/native/Makefile
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _host_cpu() -> bytes:
    """The CPU model: -march=native code built on one host may not run on
    another, so the library's name carries it."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"model name"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def lib_path() -> Path:
    tag = hashlib.blake2b(
        SRC.read_bytes() + " ".join(CXXFLAGS).encode() + _host_cpu(), digest_size=8
    ).hexdigest()
    return BUILD_DIR / f"libhostio_{tag}.so"


def _build() -> Path | None:
    out = lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        log.debug("no g++: native host library unavailable, using numpy")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [cxx, *CXXFLAGS, "-o", tmp, str(SRC)],
            capture_output=True, text=True, timeout=300,
        )
        if res.returncode != 0:
            log.warning("native host library build failed; using numpy:\n%s", res.stderr)
            return None
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native host library build failed (%s); using numpy", e)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built at first use; None when disabled or when
    it cannot be built (callers then use numpy)."""
    global _lib, _failed
    if os.environ.get("PHYLIGN_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _build()
        if path is None:
            _failed = True
            return None
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
    i32p, i64p = ctypes.POINTER(i32), ctypes.POINTER(i64)
    u8p, u32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)

    lib.cobs_row_indices.restype = i64
    lib.cobs_row_indices.argtypes = [u8p, i64, i32, u64, i32, i64p]
    lib.cobs_row_indices_batch.restype = None
    lib.cobs_row_indices_batch.argtypes = [u8p, i64p, i64p, i64, i32, u64, i32, i64p]
    lib.match_text_stats.restype = i32
    lib.match_text_stats.argtypes = [u8p, i64, i64p, i64p]
    lib.parse_match_text.restype = i64
    lib.parse_match_text.argtypes = [u8p, i64, i64p, i32p, i64p, i64p, u32p, i32p, i64p, i32p]
    lib.unique_inverse_i32.restype = i64
    lib.unique_inverse_i32.argtypes = [i32p, i64, i32p, i32p]
    lib.filter_topk_rows.restype = i64
    lib.filter_topk_rows.argtypes = [i64p, i32p, i32p, i32p, i64, i64, i64, i64p]


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def native_cobs_row_indices(
    codes: np.ndarray, k: int, signature_size: int, num_hashes: int
) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n_pos = max(0, codes.shape[0] - k + 1)
    out = np.empty((n_pos, num_hashes), np.int64)
    if n_pos:
        lib.cobs_row_indices(
            _ptr(codes, ctypes.c_uint8), codes.shape[0], k, signature_size,
            num_hashes, _ptr(out, ctypes.c_int64),
        )
    return out


def native_cobs_row_indices_batch(
    codes_list: list[np.ndarray], k: int, signature_size: int, num_hashes: int
) -> list[np.ndarray] | None:
    """Batched native row hashing: ONE library call for a whole read set.
    Returns per-sequence int64 [n_pos_i, num_hashes] views into one shared
    buffer, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes_list)
    lens = np.fromiter((c.shape[0] for c in codes_list), np.int64, count=n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.maximum(0, lens - k + 1), out=out_off[1:])
    cat = (
        np.ascontiguousarray(np.concatenate(codes_list), np.uint8)
        if n
        else np.zeros(1, np.uint8)
    )
    out = np.empty((int(out_off[-1]), num_hashes), np.int64)
    if n and out.size:
        lib.cobs_row_indices_batch(
            _ptr(cat, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
            _ptr(out_off, ctypes.c_int64), n, k, signature_size, num_hashes,
            _ptr(out, ctypes.c_int64),
        )
    oo = out_off.tolist()
    return [out[oo[i] : oo[i + 1]] for i in range(n)]


class ParsedMatchFile:
    """Array view of one 03_match file (native parse).

    qnames:   list[str]              query names, file order
    totals:   int64 [Q]              header n_total per query
    hit_end:  int64 [Q]              cumulative hit count (query i's hits are
                                     rows hit_end[i-1]:hit_end[i])
    acc_id:   uint32 [H]             interned accession id per hit
    score:    int32 [H]
    accs:     list[str]              id -> accession string
    """

    __slots__ = ("qnames", "totals", "hit_end", "acc_id", "score", "accs")

    def __init__(self, qnames, totals, hit_end, acc_id, score, accs):
        self.qnames = qnames
        self.totals = totals
        self.hit_end = hit_end
        self.acc_id = acc_id
        self.score = score
        self.accs = accs


def native_parse_match_text(data: bytes) -> ParsedMatchFile | None:
    """Parse decompressed match text into arrays (None without the lib)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    nq = ctypes.c_int64()
    nh = ctypes.c_int64()
    if lib.match_text_stats(_ptr(buf, ctypes.c_uint8), len(buf), ctypes.byref(nq), ctypes.byref(nh)):
        raise ValueError("malformed match file")
    nq, nh = nq.value, nh.value
    q_off = np.empty(nq, np.int64)
    q_len = np.empty(nq, np.int32)
    q_tot = np.empty(nq, np.int64)
    q_end = np.empty(nq, np.int64)
    acc_id = np.empty(nh, np.uint32)
    score = np.empty(nh, np.int32)
    a_off = np.empty(nh, np.int64)  # worst case: every hit a new accession
    a_len = np.empty(nh, np.int32)
    nacc = lib.parse_match_text(
        _ptr(buf, ctypes.c_uint8), len(buf),
        _ptr(q_off, ctypes.c_int64), _ptr(q_len, ctypes.c_int32),
        _ptr(q_tot, ctypes.c_int64), _ptr(q_end, ctypes.c_int64),
        _ptr(acc_id, ctypes.c_uint32), _ptr(score, ctypes.c_int32),
        _ptr(a_off, ctypes.c_int64), _ptr(a_len, ctypes.c_int32),
    )
    if nacc < 0:
        raise ValueError("malformed match file")
    qnames = [data[q_off[i] : q_off[i] + q_len[i]].decode() for i in range(nq)]
    accs = [data[a_off[i] : a_off[i] + a_len[i]].decode() for i in range(nacc)]
    return ParsedMatchFile(qnames, q_tot, q_end, acc_id, score, accs)


def native_unique_inverse(x: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Sorted unique values + inverse ranks of a non-negative int32 array
    (np.unique(x, return_inverse=True), radix-sorted in C++). None without
    the lib."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.int32)
    uniq = np.empty(x.size, np.int32)
    inv = np.empty(x.size, np.int32)
    nu = lib.unique_inverse_i32(
        _ptr(x, ctypes.c_int32), x.size, _ptr(uniq, ctypes.c_int32),
        _ptr(inv, ctypes.c_int32),
    )
    return uniq[:nu], inv


def native_filter_topk_rows(q, score, brank, arank, smax, keep):
    """Sort+cut core of the candidate filter (None without the lib, or if
    a packing range is violated: callers fall back to numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.int64)
    score = np.ascontiguousarray(score, np.int32)
    brank = np.ascontiguousarray(brank, np.int32)
    arank = np.ascontiguousarray(arank, np.int32)
    kept = np.empty(q.shape[0], np.int64)
    cnt = lib.filter_topk_rows(
        _ptr(q, ctypes.c_int64), _ptr(score, ctypes.c_int32),
        _ptr(brank, ctypes.c_int32), _ptr(arank, ctypes.c_int32),
        q.shape[0], int(smax), int(keep), _ptr(kept, ctypes.c_int64),
    )
    if cnt < 0:
        return None
    return kept[:cnt]
