"""ctypes bindings for the port's native host library (``hostio.cpp``).

The port's own copy of ``phylign_tpu.native``: XXH64 row hashing, the
03_match text parser, the dedup's unique+inverse and the filter's top-k core
(match stage); minimizer sketching, seed-anchor collection and gapless SAM
line assembly (align stage). At first use ``hostio.cpp`` is
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
    u64p = ctypes.POINTER(u64)

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

    lib.minimizers.restype = i64
    lib.minimizers.argtypes = [u8p, i64, i32, i32, u64p, i32p, u8p]
    lib.minimizers_batch.restype = None
    lib.minimizers_batch.argtypes = [u8p, i64p, i64, i32, i32, u64p, i32p, u8p, i64p, i64p]
    # uh, us, ucnt, n_uniq, sort_strand, qh, qpos, qstrand, qoff, n_queries,
    # max_occ, k, m_lo, m_np, m_nm, gcount, rep_len
    lib.anchors_count2.restype = i64
    lib.anchors_count2.argtypes = [
        u64p, i64p, i64p, i64, u8p, u64p, i64p, u8p, i64p, i64, i64, i32,
        i64p, i32p, i32p, i64p, i64p,
    ]
    # uh, us, ucnt, useg_off, useg_n, sort_strand, sseg_off, qh, qpos,
    # qstrand, qoff, n_queries, max_occ (per query), k, m_lo, m_np, m_nm,
    # gcount, rep_len
    lib.anchors_count2_seg.restype = i64
    lib.anchors_count2_seg.argtypes = [
        u64p, i64p, i64p, i64p, i64p, u8p, i64p, u64p, i64p, u8p, i64p, i64,
        i64p, i32, i64p, i32p, i32p, i64p, i64p,
    ]
    # sort_pos, sort_strand, qpos, qstrand, qoff, qlen, n_queries, k, m_lo,
    # m_np, m_nm, bounds, out_rpos, out_qpos
    lib.anchors_fill.restype = None
    lib.anchors_fill.argtypes = [
        i32p, u8p, i64p, u8p, i64p, i64p, i64, i32, i64p, i32p, i32p, i64p,
        i32p, i32p,
    ]
    # n, qname buf/off, flag, rname buf/off, cid, pos, mapq, mis_cols,
    # mis_off, qlen, seq codes buf/off, dp, cm, s1, s2, rl, de buf/off,
    # out, out_cap, line_off
    lib.assemble_sam_lines.restype = i64
    lib.assemble_sam_lines.argtypes = [
        i64, u8p, i64p, i32p, u8p, i64p, i32p, i32p, i32p, i32p, i64p, i32p,
        u8p, i64p, i32p, i32p, i64p, i64p, i32p, u8p, i64p, u8p, i64, i64p,
    ]


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


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

def native_minimizers(
    codes: np.ndarray, k: int, w: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = max(0, codes.shape[0] - k + 1)
    hashes = np.empty(n, np.uint64)
    pos = np.empty(n, np.int32)
    strand = np.empty(n, np.uint8)
    cnt = 0
    if n:
        cnt = lib.minimizers(
            _u8ptr(codes),
            codes.shape[0],
            k,
            w,
            hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _u8ptr(strand),
        )
    return hashes[:cnt], pos[:cnt], strand[:cnt]


def native_minimizers_batch(
    codes_list: list[np.ndarray], k: int, w: int
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]] | None:
    """Batched native minimizer sketching: ONE threaded library call for a
    whole read set. Returns per-sequence (hashes, positions, strands)
    views, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes_list)
    lens = np.fromiter((c.shape[0] for c in codes_list), np.int64, count=n)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    npos = np.maximum(0, lens - k + 1)
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(npos, out=out_off[1:])
    tot = int(out_off[-1])
    cat = (
        np.ascontiguousarray(np.concatenate(codes_list), np.uint8)
        if n
        else np.zeros(1, np.uint8)
    )
    hashes = np.empty(max(1, tot), np.uint64)
    pos = np.empty(max(1, tot), np.int32)
    strand = np.empty(max(1, tot), np.uint8)
    counts = np.zeros(n, np.int64)
    if n and tot:
        lib.minimizers_batch(
            _u8ptr(cat),
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            k,
            w,
            hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _u8ptr(strand),
            out_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    oo, cc = out_off.tolist(), counts.tolist()
    return [
        (
            hashes[oo[i] : oo[i] + cc[i]],
            pos[oo[i] : oo[i] + cc[i]],
            strand[oo[i] : oo[i] + cc[i]],
        )
        for i in range(n)
    ]



def native_assemble_sam_lines(
    qname_buf: bytes,
    qname_off: np.ndarray,
    flag: np.ndarray,
    rname_buf: bytes,
    rname_off: np.ndarray,
    cid: np.ndarray,
    pos: np.ndarray,
    mapq: np.ndarray,
    mis_cols: np.ndarray,
    mis_off: np.ndarray,
    qlen: np.ndarray,
    seq_codes: np.ndarray,
    seq_off: np.ndarray,
    dp: np.ndarray,
    cm: np.ndarray,
    s1: np.ndarray,
    s2: np.ndarray,
    rl: np.ndarray,
    de_buf: bytes,
    de_off: np.ndarray,
) -> tuple[bytes, np.ndarray] | None:
    """Assemble full gapless-record SAM lines natively.

    Returns (line bytes, int64 offsets [n+1]) or None when the library is
    unavailable (callers fall back to the per-record python assembly).
    Inputs: concatenated-buffer + offset pairs for qnames / contig-name
    table / forward 2-bit seq codes / preformatted de:f strings; int arrays
    for everything else. CIGARs are derived from each record's sorted
    mismatch columns; flag bit 0x10 makes the C side emit the
    reverse-complement SEQ."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(flag)
    qname_off = np.ascontiguousarray(qname_off, np.int64)
    rname_off = np.ascontiguousarray(rname_off, np.int64)
    mis_off = np.ascontiguousarray(mis_off, np.int64)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    de_off = np.ascontiguousarray(de_off, np.int64)
    flag = np.ascontiguousarray(flag, np.int32)
    cid = np.ascontiguousarray(cid, np.int32)
    pos = np.ascontiguousarray(pos, np.int32)
    mapq = np.ascontiguousarray(mapq, np.int32)
    mis_cols = np.ascontiguousarray(mis_cols, np.int32)
    qlen = np.ascontiguousarray(qlen, np.int32)
    seq_codes = np.ascontiguousarray(seq_codes, np.uint8)
    dp = np.ascontiguousarray(dp, np.int32)
    cm = np.ascontiguousarray(cm, np.int32)
    s1 = np.ascontiguousarray(s1, np.int64)
    s2 = np.ascontiguousarray(s2, np.int64)
    rl = np.ascontiguousarray(rl, np.int32)
    max_rname = int(np.diff(rname_off).max()) if len(rname_off) > 1 else 0
    cap = int(
        230 * n
        + len(qname_buf)
        + len(de_buf)
        + int(seq_off[-1])
        + 12 * len(mis_cols)
        + n * max_rname
    )
    out = np.empty(cap, np.uint8)
    line_off = np.empty(n + 1, np.int64)
    qb = np.frombuffer(qname_buf, np.uint8) if qname_buf else np.zeros(1, np.uint8)
    rb = np.frombuffer(rname_buf, np.uint8) if rname_buf else np.zeros(1, np.uint8)
    db = np.frombuffer(de_buf, np.uint8) if de_buf else np.zeros(1, np.uint8)
    total = lib.assemble_sam_lines(
        n,
        _u8ptr(qb),
        qname_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flag.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8ptr(rb),
        rname_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mapq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mis_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mis_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qlen.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8ptr(seq_codes if seq_codes.size else np.zeros(1, np.uint8)),
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        s1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        s2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8ptr(db),
        de_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8ptr(out),
        cap,
        line_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if total < 0:  # pragma: no cover - capacity bound is generous
        return None
    return out[:total].tobytes(), line_off


def _anchors_finish(
    lib, sort_pos, sort_strand, qpos, qstrand, qoff, qlen64, nq, k,
    m_lo, m_np, m_nm, gcount, total,
):
    """Shared tail of the anchor-collection wrappers: prefix the group
    counts into bounds, allocate the flat outputs, and run anchors_fill
    (whose contract is identical for the per-ref and segmented fronts —
    m_lo always carries offsets into the given sort arrays)."""
    bounds = np.zeros(2 * nq + 1, np.int64)
    np.cumsum(gcount, out=bounds[1:])
    out_rpos = np.empty(total, np.int32)
    out_qpos = np.empty(total, np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    if total:
        lib.anchors_fill(
            p(sort_pos, ctypes.c_int32), _u8ptr(sort_strand),
            p(qpos, ctypes.c_int64), _u8ptr(qstrand),
            p(qoff, ctypes.c_int64), p(qlen64, ctypes.c_int64), nq,
            int(k),
            p(m_lo, ctypes.c_int64), p(m_np, ctypes.c_int32),
            p(m_nm, ctypes.c_int32), p(bounds, ctypes.c_int64),
            p(out_rpos, ctypes.c_int32), p(out_qpos, ctypes.c_int32),
        )
    return out_rpos, out_qpos, bounds


def native_collect_anchors(
    uh: np.ndarray,
    us: np.ndarray,
    ucnt: np.ndarray,
    sort_pos: np.ndarray,
    sort_strand: np.ndarray,
    qh: np.ndarray,
    qpos: np.ndarray,
    qstrand: np.ndarray,
    qoff: np.ndarray,
    qlen: np.ndarray,
    max_occ: int,
    k: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """Seed-anchor collection for a query batch against one ref table.

    Returns (rpos i32[T], qpos i32[T], bounds i64[2Q+1], rep_len i64[Q])
    with anchors of group g = 2*query + rel_strand in rows
    bounds[g]:bounds[g+1], sorted by (rpos, qpos) — byte-identical to the
    numpy path in ops.minimizer.collect_anchors_batch. rep_len[q] = query
    bases covered by over-max_occ seeds (minimap2's repeat length, rl:i).
    None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    nq = len(qlen)
    nm = qh.shape[0]
    uh = np.ascontiguousarray(uh, np.uint64)
    us = np.ascontiguousarray(us, np.int64)
    ucnt = np.ascontiguousarray(ucnt, np.int64)
    sort_pos = np.ascontiguousarray(sort_pos, np.int32)
    sort_strand = np.ascontiguousarray(sort_strand, np.uint8)
    qh = np.ascontiguousarray(qh, np.uint64)
    qpos = np.ascontiguousarray(qpos, np.int64)
    qstrand = np.ascontiguousarray(qstrand, np.uint8)
    qoff = np.ascontiguousarray(qoff, np.int64)
    qlen64 = np.ascontiguousarray(qlen, np.int64)

    m_lo = np.empty(nm, np.int64)
    m_np = np.empty(nm, np.int32)
    m_nm = np.empty(nm, np.int32)
    gcount = np.zeros(2 * nq, np.int64)
    rep_len = np.zeros(nq, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    total = lib.anchors_count2(
        p(uh, ctypes.c_uint64), p(us, ctypes.c_int64), p(ucnt, ctypes.c_int64),
        len(uh), _u8ptr(sort_strand),
        p(qh, ctypes.c_uint64), p(qpos, ctypes.c_int64), _u8ptr(qstrand),
        p(qoff, ctypes.c_int64), nq,
        int(max_occ), int(k),
        p(m_lo, ctypes.c_int64), p(m_np, ctypes.c_int32),
        p(m_nm, ctypes.c_int32), p(gcount, ctypes.c_int64),
        p(rep_len, ctypes.c_int64),
    )
    out_rpos, out_qpos, bounds = _anchors_finish(
        lib, sort_pos, sort_strand, qpos, qstrand, qoff, qlen64, nq, k,
        m_lo, m_np, m_nm, gcount, total,
    )
    return out_rpos, out_qpos, bounds, rep_len


def native_collect_anchors_seg(
    uh: np.ndarray,
    us: np.ndarray,
    ucnt: np.ndarray,
    useg_off: np.ndarray,
    useg_n: np.ndarray,
    sort_pos: np.ndarray,
    sort_strand: np.ndarray,
    sseg_off: np.ndarray,
    qh: np.ndarray,
    qpos: np.ndarray,
    qstrand: np.ndarray,
    qoff: np.ndarray,
    qlen: np.ndarray,
    max_occ: np.ndarray,
    k: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """Segmented anchor collection: MANY (ref table, query) groups in one
    native call. Table arrays are the refs' uniq/sort tables concatenated;
    per-query useg_off/useg_n/sseg_off/max_occ select the query's ref
    segment. Output contract identical to native_collect_anchors. None
    without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    nq = len(qlen)
    nm = qh.shape[0]
    uh = np.ascontiguousarray(uh, np.uint64)
    us = np.ascontiguousarray(us, np.int64)
    ucnt = np.ascontiguousarray(ucnt, np.int64)
    useg_off = np.ascontiguousarray(useg_off, np.int64)
    useg_n = np.ascontiguousarray(useg_n, np.int64)
    sort_pos = np.ascontiguousarray(sort_pos, np.int32)
    sort_strand = np.ascontiguousarray(sort_strand, np.uint8)
    sseg_off = np.ascontiguousarray(sseg_off, np.int64)
    qh = np.ascontiguousarray(qh, np.uint64)
    qpos = np.ascontiguousarray(qpos, np.int64)
    qstrand = np.ascontiguousarray(qstrand, np.uint8)
    qoff = np.ascontiguousarray(qoff, np.int64)
    qlen64 = np.ascontiguousarray(qlen, np.int64)
    max_occ = np.ascontiguousarray(max_occ, np.int64)

    m_lo = np.empty(nm, np.int64)
    m_np = np.empty(nm, np.int32)
    m_nm = np.empty(nm, np.int32)
    gcount = np.zeros(2 * nq, np.int64)
    rep_len = np.zeros(nq, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    total = lib.anchors_count2_seg(
        p(uh, ctypes.c_uint64), p(us, ctypes.c_int64), p(ucnt, ctypes.c_int64),
        p(useg_off, ctypes.c_int64), p(useg_n, ctypes.c_int64),
        _u8ptr(sort_strand), p(sseg_off, ctypes.c_int64),
        p(qh, ctypes.c_uint64), p(qpos, ctypes.c_int64), _u8ptr(qstrand),
        p(qoff, ctypes.c_int64), nq,
        p(max_occ, ctypes.c_int64), int(k),
        p(m_lo, ctypes.c_int64), p(m_np, ctypes.c_int32),
        p(m_nm, ctypes.c_int32), p(gcount, ctypes.c_int64),
        p(rep_len, ctypes.c_int64),
    )
    out_rpos, out_qpos, bounds = _anchors_finish(
        lib, sort_pos, sort_strand, qpos, qstrand, qoff, qlen64, nq, k,
        m_lo, m_np, m_nm, gcount, total,
    )
    return out_rpos, out_qpos, bounds, rep_len

