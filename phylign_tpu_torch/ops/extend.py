"""Banded dual-affine-gap alignment extension (batched device DP + host
CIGAR): the counterpart of ``phylign_tpu/ops/extend.py``.

Scoring is minimap2's sr preset (match 2, mismatch 8, gaps
min(12 + 2*len, 32 + 1*len)); CIGARs are --eqx style ('='/'X').

Geometry: each (query, genome) pair aligns the full (strand-adjusted) query
against a ref window centred on the chain diagonal. Query row i maps to
window column i + d for band offset d in [0, band). The alignment is
"glocal": the query aligns end to end, the window has free leading and
trailing overhang (row -1 is all zeros; the result is the best cell of the
last query row). Within a row, deletions are solved with the prefix-max
trick:
    D[d] = max_{d'<d} (P[d'] + d'*E) - O - d*E
where P = max(diag-move H, I). The device emits each pair's last-row score
and band offset, and optionally the per-cell P plane; the host rebuilds the
H/I/D planes and walks the traceback (gaps are rare).

Implementations with identical results (every value is an integer-valued
f32 or -1e30-based, so "identical" is bit for bit):
  * ``extend_ref``   the row scan in plain PyTorch; the CPU path and the
                     version the kernel is held to.
  * ``extend_cuda``  CUDA kernel B4 (csrc/extend_scan.cu): one warp per
                     pair, band/32 cells per lane, rows in registers.
``_extend_impl`` picks by the tensor's device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

BAND = 128  # default band width (sr preset); the band of a call is
# inferred from its window's width, so wider presets pass wider windows
NEG = np.float32(-1e30)

#: bands kernel B4 takes (band/32 cells per lane)
KERNEL_BANDS = (128, 256, 384, 512)


@dataclass(frozen=True)
class SrScoring:
    """minimap2 sr preset scoring (-A2 -B8 -O12,32 -E2,1)."""

    match: int = 2
    mismatch: int = 8
    gap_open1: int = 12
    gap_ext1: int = 2
    gap_open2: int = 32
    gap_ext2: int = 1
    min_dp_score: int = 40  # -s: min score to emit an alignment


class ExtendResult(NamedTuple):
    score: torch.Tensor  # f32 [P] best glocal score at the final query row
    end_d: torch.Tensor  # int32 [P] band offset of the best final cell
    p_plane: torch.Tensor  # f32 [P, L, band] the P = max(diag, I) plane


def pack2bit(a: np.ndarray) -> np.ndarray:
    """[P, N] uint8 codes (0..3) -> [P, ceil(N/4)] uint8, 4 codes per byte
    (code j in bits 2*(j%4)): a quarter of the upload bytes."""
    p, n = a.shape
    npad = (-n) % 4
    if npad:
        a = np.concatenate([a, np.zeros((p, npad), np.uint8)], axis=1)
    a4 = a.reshape(p, -1, 4)
    return (
        a4[:, :, 0]
        | (a4[:, :, 1] << 2)
        | (a4[:, :, 2] << 4)
        | (a4[:, :, 3] << 6)
    )


def _unpack2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Device-side inverse of pack2bit: [P, ceil(n/4)] -> [P, n] uint8."""
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    u = (packed[:, :, None] >> shifts[None, None, :]) & 3
    return u.reshape(packed.shape[0], -1)[:, :n].contiguous()


def _window_mask(lo: torch.Tensor, hi: torch.Tensor, wlen: int) -> torch.Tensor:
    """rvalid from per-pair in-contig bounds: column j valid iff lo<=j<hi."""
    j = torch.arange(wlen, dtype=torch.int32, device=lo.device)[None, :]
    return (j >= lo[:, None]) & (j < hi[:, None])


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=device)


# --- plain PyTorch version ----------------------------------------------------


def extend_ref(
    q_codes: torch.Tensor,  # uint8 [P, L]
    q_len: torch.Tensor,  # int32 [P]
    rwin: torch.Tensor,  # uint8 [P, L + band]
    rwin_valid: torch.Tensor,  # bool or uint8 [P, L + band]
    scoring: SrScoring = SrScoring(),
    collect_plane: bool = False,
) -> ExtendResult:
    """The row scan in plain PyTorch, in the JAX scan's f32 operation order.
    Rows beyond a pair's q_len are computed and ignored."""
    p, l = q_codes.shape
    band = rwin.shape[1] - l
    dev = q_codes.device
    o1 = _f32(scoring.gap_open1 + scoring.gap_ext1, dev)
    e1 = _f32(scoring.gap_ext1, dev)
    o2 = _f32(scoring.gap_open2 + scoring.gap_ext2, dev)
    e2 = _f32(scoring.gap_ext2, dev)
    do1, do2 = _f32(scoring.gap_open1, dev), _f32(scoring.gap_open2, dev)
    match, mis, neg = _f32(scoring.match, dev), _f32(-scoring.mismatch, dev), _f32(NEG, dev)
    d_idx = torch.arange(band, dtype=torch.float32, device=dev)[None, :]
    de1, de2 = d_idx * e1, d_idx * e2
    negcol = torch.full((p, 1), float(NEG), dtype=torch.float32, device=dev)
    rv = rwin_valid.to(torch.bool)
    q_len = q_len.to(torch.int32)

    h = torch.zeros((p, band), dtype=torch.float32, device=dev)  # row -1
    i1 = torch.full((p, band), float(NEG), dtype=torch.float32, device=dev)
    i2 = i1.clone()
    best = torch.full((p,), float(NEG), dtype=torch.float32, device=dev)
    best_d = torch.zeros(p, dtype=torch.int32, device=dev)
    plane = torch.empty((p, l if collect_plane else 0, band), dtype=torch.float32, device=dev)

    def delrow(pmax, o, de):
        cm = torch.cummax(pmax + de, dim=1).values
        return torch.cat([negcol, cm[:, :-1]], dim=1) - o - de

    for i in range(l):
        sub = torch.where(rwin[:, i : i + band] == q_codes[:, i : i + 1], match, mis)
        sub = torch.where(rv[:, i : i + band], sub, neg)
        h_diag = h + sub
        # insertions (query consumed, ref not): from the previous row, d+1
        hs = torch.cat([h[:, 1:], negcol], dim=1)
        i1 = torch.maximum(hs - o1, torch.cat([i1[:, 1:], negcol], dim=1) - e1)
        i2 = torch.maximum(hs - o2, torch.cat([i2[:, 1:], negcol], dim=1) - e2)
        pmax = torch.maximum(h_diag, torch.maximum(i1, i2))
        # gap of length g costs O + g*E: the prefix max uses the bare open
        h = torch.maximum(pmax, torch.maximum(delrow(pmax, do1, de1), delrow(pmax, do2, de2)))
        if collect_plane:
            plane[:, i] = pmax
        is_last = q_len == (i + 1)
        if bool(is_last.any()):
            row_best_d = torch.argmax(h, dim=1)
            row_best = h.gather(1, row_best_d[:, None])[:, 0]
            best = torch.where(is_last, row_best, best)
            best_d = torch.where(is_last, row_best_d.to(torch.int32), best_d)
    return ExtendResult(score=best, end_d=best_d, p_plane=plane)


# --- hand-written CUDA kernel B4 -----------------------------------------------

_launch_lock = threading.Lock()
_launches = {"extend_scan": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


#: pairs (warps) per block of kernel B4
WARPS_PER_BLOCK = 4


def extend_cuda(
    q_codes: torch.Tensor,
    q_len: torch.Tensor,
    rwin: torch.Tensor,
    rwin_valid: torch.Tensor,
    scoring: SrScoring = SrScoring(),
    collect_plane: bool = False,
) -> ExtendResult:
    """Kernel B4 (replaces the ``lax.scan`` of
    ``phylign_tpu/ops/extend.py:_extend_impl``). CUDA tensors only; same
    contract as extend_ref; band in KERNEL_BANDS."""
    from phylign_tpu_torch.ops import _kernels

    dev = q_codes.device
    if dev.type != "cuda" or any(t.device != dev for t in (q_len, rwin, rwin_valid)):
        raise ValueError("extend_scan runs on CUDA tensors on one device")
    if q_codes.dtype != torch.uint8 or rwin.dtype != torch.uint8:
        raise TypeError(f"extend_scan takes uint8 codes; got {q_codes.dtype}, {rwin.dtype}")
    if rwin_valid.dtype not in (torch.bool, torch.uint8) or q_len.dtype != torch.int32:
        raise TypeError("extend_scan takes a bool/uint8 mask and int32 q_len")
    p, l = q_codes.shape
    band = rwin.shape[1] - l
    if band not in KERNEL_BANDS or rwin_valid.shape != rwin.shape or q_len.shape != (p,):
        raise ValueError(
            f"extend_scan: band {band} (must be one of {KERNEL_BANDS}), shapes "
            f"q {tuple(q_codes.shape)}, rwin {tuple(rwin.shape)}, "
            f"mask {tuple(rwin_valid.shape)}, q_len {tuple(q_len.shape)}"
        )
    if not all(t.is_contiguous() for t in (q_codes, q_len, rwin, rwin_valid)):
        raise ValueError("extend_scan takes contiguous tensors")
    score = torch.empty(p, dtype=torch.float32, device=dev)
    end_d = torch.empty(p, dtype=torch.int32, device=dev)
    plane = torch.empty((p, l if collect_plane else 0, band), dtype=torch.float32, device=dev)
    if p == 0:
        return ExtendResult(score, end_d, plane)
    if l == 0:
        return ExtendResult(score.fill_(float(NEG)), end_d.zero_(), plane)
    s = scoring
    lib = _kernels.library("extend_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.phylign_extend_scan(
            q_codes.data_ptr(), q_len.data_ptr(), rwin.data_ptr(), rwin_valid.data_ptr(),
            p, l, band, float(s.match), float(s.mismatch),
            float(s.gap_open1 + s.gap_ext1), float(s.gap_ext1),
            float(s.gap_open2 + s.gap_ext2), float(s.gap_ext2),
            float(s.gap_open1), float(s.gap_open2), int(collect_plane),
            WARPS_PER_BLOCK, score.data_ptr(), end_d.data_ptr(),
            plane.data_ptr() if collect_plane else None, stream,
        )
    _kernels.check(lib, err, "extend_scan")
    with _launch_lock:
        _launches["extend_scan"] += 1
    return ExtendResult(score, end_d, plane)


def _extend_impl(q_codes, q_len, rwin, rwin_valid, scoring, collect_plane) -> ExtendResult:
    """Dispatch by device: the plain version for a CPU tensor, kernel B4
    for a CUDA tensor. Any other device raises."""
    if q_codes.device.type == "cpu":
        return extend_ref(q_codes, q_len, rwin, rwin_valid, scoring, collect_plane)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {q_codes.device}")
    return extend_cuda(q_codes, q_len, rwin, rwin_valid, scoring, collect_plane)


# --- entry points (those of the JAX module) -----------------------------------


def extend_banded(
    q_codes: torch.Tensor,  # uint8 [P, L] strand-adjusted query codes
    q_len: torch.Tensor,  # int32 [P] actual query lengths (<= L)
    rwin: torch.Tensor,  # uint8 [P, L + band] ref window codes
    rwin_valid: torch.Tensor,  # bool [P, L + band] in-contig mask
    scoring: SrScoring = SrScoring(),
) -> ExtendResult:
    return _extend_impl(q_codes, q_len, rwin, rwin_valid, scoring, True)


def extend_banded_scores(
    q_codes: torch.Tensor,
    q_len: torch.Tensor,
    rwin: torch.Tensor,
    rwin_valid: torch.Tensor,
    scoring: SrScoring = SrScoring(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score-only banded extension: (score [P], end_d [P]), no plane. The
    align engine resolves gapless alignments on the end diagonal and runs
    the plane variant only for pairs whose score implies indels."""
    res = _extend_impl(q_codes, q_len, rwin, rwin_valid, scoring, False)
    return res.score, res.end_d


def extend_banded_scores_packed(
    q_pack: torch.Tensor,  # uint8 [P, ceil(l/4)] 2-bit packed query codes
    q_len: torch.Tensor,  # int32 [P]
    r_pack: torch.Tensor,  # uint8 [P, ceil(wlen/4)] 2-bit packed ref window
    lo: torch.Tensor,  # int32 [P] first valid window column
    hi: torch.Tensor,  # int32 [P] one past last valid window column
    l: int,
    wlen: int,
    scoring: SrScoring = SrScoring(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """extend_banded_scores from transfer-compact inputs: codes 2-bit packed
    and the validity mask as [lo, hi) bounds, both expanded on the device."""
    q = _unpack2bit(q_pack, l)
    r = _unpack2bit(r_pack, wlen)
    res = _extend_impl(q, q_len, r, _window_mask(lo, hi, wlen), scoring, False)
    return res.score, res.end_d


def extend_banded_packed(
    q_pack: torch.Tensor,
    q_len: torch.Tensor,
    r_pack: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    l: int,
    wlen: int,
    scoring: SrScoring = SrScoring(),
) -> ExtendResult:
    q = _unpack2bit(q_pack, l)
    r = _unpack2bit(r_pack, wlen)
    return _extend_impl(q, q_len, r, _window_mask(lo, hi, wlen), scoring, True)


# --- host traceback ----------------------------------------------------------

CIG_EQ, CIG_X, CIG_I, CIG_D = "=", "X", "I", "D"


def _reconstruct_batch(pp, o, e):
    """D planes of one gap family, vectorized over pairs AND rows:
    pp [G, L, BAND] -> [G, L, BAND]."""
    band = pp.shape[2]
    d_idx = np.arange(band, dtype=np.float32)
    keyed = pp + d_idx * e
    cm = np.maximum.accumulate(keyed, axis=2)
    out = np.empty_like(pp)
    out[:, :, 0] = NEG
    out[:, :, 1:] = cm[:, :, :-1]
    out -= o + d_idx * e
    return out


def reconstruct_planes(
    p_planes: np.ndarray,  # f32 [G, L, BAND]
    scoring: SrScoring = SrScoring(),
) -> tuple[np.ndarray, ...]:
    """Rebuild the H / D1 / D2 / I1 / I2 planes for a whole batch of gapped
    pairs at once (the round-1 per-pair python row loop was ~10 ms per pair;
    this is a handful of [G, L, BAND] numpy passes + an L-step loop over
    [G, BAND] rows shared by every pair). Rows beyond a pair's qlen are
    garbage — the per-pair walk never reads them."""
    o1, e1 = float(scoring.gap_open1 + scoring.gap_ext1), float(scoring.gap_ext1)
    o2, e2 = float(scoring.gap_open2 + scoring.gap_ext2), float(scoring.gap_ext2)
    g, l, band = p_planes.shape
    d1 = _reconstruct_batch(p_planes, float(scoring.gap_open1), e1)
    d2 = _reconstruct_batch(p_planes, float(scoring.gap_open2), e2)
    h = np.maximum(p_planes, np.maximum(d1, d2))
    i1 = np.full((g, l, band), NEG, np.float32)
    i2 = np.full((g, l, band), NEG, np.float32)
    i1[:, 0, : band - 1] = -o1
    i2[:, 0, : band - 1] = -o2
    for i in range(1, l):  # row recurrence, vectorized over all pairs
        hs = np.concatenate(
            [h[:, i - 1, 1:], np.full((g, 1), NEG, np.float32)], axis=1
        )
        i1s = np.concatenate(
            [i1[:, i - 1, 1:], np.full((g, 1), NEG, np.float32)], axis=1
        )
        i2s = np.concatenate(
            [i2[:, i - 1, 1:], np.full((g, 1), NEG, np.float32)], axis=1
        )
        i1[:, i] = np.maximum(hs - o1, i1s - e1)
        i2[:, i] = np.maximum(hs - o2, i2s - e2)
    return h, d1, d2, i1, i2


def traceback_walk(
    planes: tuple[np.ndarray, ...],  # (h, d1, d2, i1, i2) slices [L, BAND]
    pp: np.ndarray,  # f32 [L, BAND] the P plane of this pair
    q_codes: np.ndarray,  # [L]
    qlen: int,
    rwin: np.ndarray,  # [L + BAND]
    end_d: int,
    scoring: SrScoring = SrScoring(),
    rvalid: np.ndarray | None = None,  # [L + BAND] in-contig mask
) -> tuple[list[tuple[int, str]], int]:
    """Walk the optimal path over prebuilt planes (reconstruct_planes).

    On score ties the diagonal move wins (match preferred over gap, the
    minimap2 convention); this also yields the best locally-trimmable path
    when a free-overhang start makes several glocal optima tie.

    Returns (cigar run-length list [(n, op)], start_d) where start_d is the
    band offset at query row 0 (alignment ref start = window_start + start_d).
    """
    o1, e1 = float(scoring.gap_open1 + scoring.gap_ext1), float(scoring.gap_ext1)
    o2, e2 = float(scoring.gap_open2 + scoring.gap_ext2), float(scoring.gap_ext2)
    h, d1, d2, i1, i2 = planes
    band = pp.shape[1]
    eps = 1e-3
    ops: list[str] = []
    i, d = qlen - 1, int(end_d)
    state = "H"
    while i >= 0:
        if state == "H":
            val = h[i, d]
            if abs(val - pp[i, d]) > eps:
                # came from a deletion family
                state = "D1" if abs(val - d1[i, d]) <= eps else "D2"
                continue
            # P = max(diag, I): disambiguate, diagonal first (ties -> match)
            cell_ok = rvalid is None or rvalid[i + d]
            match = cell_ok and q_codes[i] == rwin[i + d]
            if cell_ok:
                sub = (
                    float(scoring.match) if match else -float(scoring.mismatch)
                )
                h_up = h[i - 1, d] if i > 0 else 0.0
                if abs(pp[i, d] - (h_up + sub)) <= eps:
                    ops.append(CIG_EQ if match else CIG_X)
                    i -= 1
                    state = "H"
                    continue
            if abs(pp[i, d] - i1[i, d]) <= eps:
                state = "I1"
                continue
            if abs(pp[i, d] - i2[i, d]) <= eps:
                state = "I2"
                continue
            # diagonal (reached only without an rvalid mask, by elimination)
            ops.append(CIG_EQ if match else CIG_X)
            i -= 1
            state = "H"
        elif state in ("D1", "D2"):
            o, e, dd = (
                (float(scoring.gap_open1), e1, d1)
                if state == "D1"
                else (float(scoring.gap_open2), e2, d2)
            )
            # find gap start d' < d: dd[i, d] = P[i, d'] - o - (d - d')*e
            target = dd[i, d]
            dprime = None
            for dp in range(d - 1, -1, -1):
                if abs((pp[i, dp] - o - (d - dp) * e) - target) <= eps:
                    dprime = dp
                    break
            assert dprime is not None, "deletion traceback failed"
            ops.extend(CIG_D * (d - dprime))
            d = dprime
            state = "H"
        else:  # I1 / I2
            e, o, ii = (e1, o1, i1) if state == "I1" else (e2, o2, i2)
            val = ii[i, d]
            if i == 0:
                hs = 0.0  # virtual row -1 (free ref-overhang start)
            else:
                hs = h[i - 1, d + 1] if d + 1 < band else NEG
            ops.append(CIG_I)
            if abs(val - (hs - o)) <= eps:
                state = "H"
            # else: gap extension, stay in the same I family
            i -= 1
            d += 1
    assert state == "H"
    start_d = d
    ops.reverse()
    # run-length encode
    rle: list[tuple[int, str]] = []
    for op in ops:
        if rle and rle[-1][1] == op:
            rle[-1] = (rle[-1][0] + 1, op)
        else:
            rle.append((1, op))
    return rle, start_d


def traceback_one(
    p_plane: np.ndarray,  # f32 [L, BAND] (rows beyond qlen ignored)
    q_codes: np.ndarray,
    qlen: int,
    rwin: np.ndarray,
    end_d: int,
    scoring: SrScoring = SrScoring(),
    rvalid: np.ndarray | None = None,
) -> tuple[list[tuple[int, str]], int]:
    """Single-pair convenience: reconstruct planes + walk. Batch callers use
    reconstruct_planes once over all gapped pairs, then traceback_walk each."""
    pp = p_plane[:qlen][None]
    planes = tuple(x[0] for x in reconstruct_planes(pp, scoring))
    return traceback_walk(
        planes, pp[0], q_codes, qlen, rwin, end_d, scoring, rvalid
    )


def align_oracle(q: np.ndarray, r: np.ndarray, scoring: SrScoring = SrScoring()):
    """O(L*R) full (unbanded) dual-affine glocal DP, scalar transliteration,
    for tests: best score of aligning ALL of q within r (free ref overhangs)."""
    lq, lr = len(q), len(r)
    o1, e1 = scoring.gap_open1 + scoring.gap_ext1, scoring.gap_ext1
    o2, e2 = scoring.gap_open2 + scoring.gap_ext2, scoring.gap_ext2
    neg = -1e30
    h_prev = np.zeros(lr + 1)  # row i=0: free leading ref overhang
    i1_prev = np.full(lr + 1, neg)
    i2_prev = np.full(lr + 1, neg)
    for i in range(1, lq + 1):
        h = np.full(lr + 1, neg)
        i1 = np.full(lr + 1, neg)
        i2 = np.full(lr + 1, neg)
        d1 = d2 = neg
        for j in range(lr + 1):
            i1[j] = max(h_prev[j] - o1, i1_prev[j] - e1)
            i2[j] = max(h_prev[j] - o2, i2_prev[j] - e2)
            best = max(i1[j], i2[j])
            if j > 0:
                s = scoring.match if q[i - 1] == r[j - 1] else -scoring.mismatch
                best = max(best, h_prev[j - 1] + s)
                d1 = max(h[j - 1] - o1, d1 - e1)
                d2 = max(h[j - 1] - o2, d2 - e2)
                best = max(best, d1, d2)
            h[j] = best
        h_prev, i1_prev, i2_prev = h, i1, i2
    return float(h_prev.max())
