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
and band offset, and optionally the per-cell P plane. The traceback (gaps
are rare) runs where the plane is: on one card a second kernel rebuilds
H/I/D a row at a time from the plane and walks it, and only the ops come
back (``traceback_cuda``); a plane on the CPU or over a mesh's shards comes
to the host, which rebuilds the planes and walks there
(``reconstruct_planes`` + ``traceback_walk``).

Implementations with identical results (every value is an integer-valued
f32 or -1e30-based, so "identical" is bit for bit):
  * ``extend_ref``   the row scan in plain PyTorch; the CPU path and the
                     version the kernel is held to.
  * ``extend_cuda``  CUDA kernel B4 (csrc/extend_scan.cu): the same DP in
                     int32 on Hopper's DPX instructions, G lanes per pair
                     and band/G cells per lane, rows in registers.
  * ``extend_cuda_packed``  B4's packed instance: the same DP reading
                     2-bit packed codes and [lo, hi) window bounds itself,
                     a warp a pair sweeping the band's anti-diagonals (the
                     wavefront body) on the routes PACKED_ROUTES gives it.
``_extend_impl`` and ``_extend_packed_impl`` pick by the tensor's device.

The traceback's implementations, each with traceback_walk's CIGAR and
start_d for every pair:
  * ``reconstruct_planes`` + ``traceback_walk``  numpy and Python on the
                     host, over a fetched plane.
  * ``traceback_ref``  plain PyTorch: a direction byte a cell from the
                     plane, then a walk over the bytes; the version the
                     kernel is held to.
  * ``traceback_cuda``  the kernel (csrc/traceback_walk.cu): the same, a
                     warp a pair on the card.
The align engine picks by where the plane lives (``engine._walk_on_device``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from phylign_tpu_torch.ops import _kernels

BAND = 128  # default band width (sr preset); the band of a call is
# inferred from its window's width, so wider presets pass wider windows
NEG = np.float32(-1e30)


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

#: "extend_scan_packed" (extend_cuda_packed) is listed from its first launch
_launches = _kernels.LaunchCounts("extend_scan")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return _launches.snapshot()


def reset_launch_counts() -> None:
    _launches.reset()


#: lanes per pair kernel B4 is built for, by band (band / lanes cells per
#: lane)
KERNEL_LANES = {128: (8, 16, 32), 256: (16, 32), 384: (32,), 512: (32,)}
#: the lanes extend_cuda picks by (band, plane): the score pass is
#: instruction-bound and gains from fewer lanes; the plane pass is
#: bytes-bound and keeps more blocks resident with fewer registers a lane
#: (chosen by measurement on an H100, PERF.md)
EXTEND_LANES = {(128, False): 8, (128, True): 16}


def extend_lanes(band: int, collect: bool) -> int:
    """The lanes per pair extend_cuda uses."""
    return EXTEND_LANES.get((band, collect), KERNEL_LANES[band][0])


#: the kernel B4's packed instance launches, by (band, plane), for both
#: substitutions: 0 is the wavefront body (a warp a pair sweeping
#: anti-diagonals), G the row body at G lanes a pair; each the faster on an
#: H100 in turns at the delegated pass's shapes (PERF.md): the wavefront at
#: band 128 and for the score pass at band 256; the row body for the plane
#: at band 256 (the wavefront's ring of 128 rows takes a block's shared
#: memory) and at bands 384 and 512 (its sweep's empty triangles); past
#: the wavefront's shared memory, the row body at 32 lanes (packed_lanes)
PACKED_ROUTES = {
    (128, False): 0, (128, True): 0, (256, False): 0, (256, True): 32,
    (384, False): 32, (384, True): 32, (512, False): 32, (512, True): 32,
}
#: a block's shared memory (the wavefront body takes a block a pair)
WAVE_SHARED_LIMIT = 232448


def packed_lanes(band: int, collect: bool, l: int) -> int:
    """The body B4's packed instance launches for a pass at this band and
    L: PACKED_ROUTES', or the row body at 32 lanes where the wavefront's
    shared memory (the plane's ring of band/2 rows, and tables of 8 bytes
    for each query code, with band/2 of pad at each end, and each window
    column) would exceed a block's: L past 14,400 at band 128 (12,352 with
    the plane), 14,272 at band 256."""
    g = PACKED_ROUTES[band, collect]
    smem = (band * band * 2 if collect else 0) + (2 * l + 2 * band) * 8
    return 32 if g == 0 and smem > WAVE_SHARED_LIMIT else g


#: threads per block of kernel B4 (128 / lanes pairs a block)
BLOCK_THREADS = 128
#: the kernel runs the DP in int32 with -2**28 for -1e30; every real value
#: must stay below 2**24 in magnitude (exact in f32, far from the sentinel)
INT_LIMIT = 2**24


def kernel_scoring(scoring: SrScoring, l: int, band: int) -> tuple[int, ...]:
    """The integer scoring kernel B4 takes: (match, mismatch, o1, e1, o2,
    e2, open1, open2) with o = gap_open + gap_ext. Raises ValueError when a
    value is not a non-negative integer, or when L rows of band cells could
    reach INT_LIMIT."""
    s = scoring
    vals = (s.match, s.mismatch, s.gap_open1, s.gap_ext1, s.gap_open2, s.gap_ext2)
    if not all(float(v).is_integer() and v >= 0 for v in vals):
        raise ValueError(f"extend_scan takes non-negative integer scoring; got {vals}")
    m, x, g1, e1, g2, e2 = (int(v) for v in vals)
    per_row = m + x + max(g1 + e1, g2 + e2) + max(g1, g2) + max(e1, e2)
    if (l + 1) * per_row + band * max(e1, e2) >= INT_LIMIT:
        raise ValueError(
            f"extend_scan: L={l}, band={band} with this scoring could reach "
            f"{INT_LIMIT} (int32 DP limit)"
        )
    return m, x, g1 + e1, e1, g2 + e2, e2, g1, g2


def wide_substitution(match: int, mismatch: int) -> bool:
    """Whether kernel B4 scores substitutions in int32 (its wide instance):
    the byte-permute table holds match and -mismatch as signed bytes only."""
    return match > 127 or mismatch > 128


def _check_lanes(band: int, collect_plane: bool, lanes: int | None) -> int:
    """The lanes per pair of a launch at this band (KERNEL_LANES)."""
    g = extend_lanes(band, collect_plane) if lanes is None else lanes
    if g not in KERNEL_LANES[band]:
        raise ValueError(f"extend_scan: {g} lanes per pair not built for band {band}")
    return g


def _launch_b4(name, fn, inputs, p, l, band, g, scoring, collect_plane, defines=()) -> ExtendResult:
    """Allocate B4's outputs on the inputs' device and launch ``fn`` of
    csrc/extend_scan.cu, counted as ``name`` (no launch when p or l is 0).
    ``defines`` must be empty: a source has one build. The parameter stays
    because the benchmark's B4 probe (gpubench/trace.py B4Shapes) holds this
    entry to its parameter names."""
    if defines:
        raise ValueError(f"extend_scan has one build; got macros {defines}")
    dev = inputs[0].device
    isc = kernel_scoring(scoring, l, band)
    wide = wide_substitution(isc[0], isc[1])
    score = torch.empty(p, dtype=torch.float32, device=dev)
    end_d = torch.empty(p, dtype=torch.int32, device=dev)
    plane = torch.empty((p, l if collect_plane else 0, band), dtype=torch.float32, device=dev)
    if p == 0:
        return ExtendResult(score, end_d, plane)
    if l == 0:
        return ExtendResult(score.fill_(float(NEG)), end_d.zero_(), plane)
    _kernels.launch(
        _launches, name, "extend_scan", fn,
        *inputs, p, l, band, g, *isc, int(wide), int(collect_plane),
        score, end_d, plane if collect_plane else None,
    )
    return ExtendResult(score, end_d, plane)


def extend_cuda(
    q_codes: torch.Tensor,
    q_len: torch.Tensor,
    rwin: torch.Tensor,
    rwin_valid: torch.Tensor,
    scoring: SrScoring = SrScoring(),
    collect_plane: bool = False,
    lanes: int | None = None,
) -> ExtendResult:
    """Kernel B4 (replaces the ``lax.scan`` of
    ``phylign_tpu/ops/extend.py:_extend_impl``). CUDA tensors only; same
    contract as extend_ref for codes 0..3 (the 2-bit alphabet every caller
    passes) and integer scoring (``kernel_scoring``); band in KERNEL_LANES.
    ``lanes`` overrides the lanes per pair (one of KERNEL_LANES[band]). The
    scoring picks the substitution instance (wide_substitution)."""
    dev = q_codes.device
    if dev.type != "cuda" or any(t.device != dev for t in (q_len, rwin, rwin_valid)):
        raise ValueError("extend_scan runs on CUDA tensors on one device")
    if q_codes.dtype != torch.uint8 or rwin.dtype != torch.uint8:
        raise TypeError(f"extend_scan takes uint8 codes; got {q_codes.dtype}, {rwin.dtype}")
    if rwin_valid.dtype not in (torch.bool, torch.uint8) or q_len.dtype != torch.int32:
        raise TypeError("extend_scan takes a bool/uint8 mask and int32 q_len")
    p, l = q_codes.shape
    band = rwin.shape[1] - l
    if band not in KERNEL_LANES or rwin_valid.shape != rwin.shape or q_len.shape != (p,):
        raise ValueError(
            f"extend_scan: band {band} (must be one of {tuple(KERNEL_LANES)}), shapes "
            f"q {tuple(q_codes.shape)}, rwin {tuple(rwin.shape)}, "
            f"mask {tuple(rwin_valid.shape)}, q_len {tuple(q_len.shape)}"
        )
    g = _check_lanes(band, collect_plane, lanes)
    if not all(t.is_contiguous() for t in (q_codes, q_len, rwin, rwin_valid)):
        raise ValueError("extend_scan takes contiguous tensors")
    return _launch_b4("extend_scan", "phylign_extend_scan", (q_codes, q_len, rwin, rwin_valid),
                      p, l, band, g, scoring, collect_plane)


def extend_cuda_packed(
    q_pack: torch.Tensor,
    q_len: torch.Tensor,
    r_pack: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    l: int,
    wlen: int,
    scoring: SrScoring = SrScoring(),
    collect_plane: bool = False,
    lanes: int | None = None,
) -> ExtendResult:
    """Kernel B4's packed instance (replaces the jitted
    ``phylign_tpu/ops/extend.py:extend_banded_scores_packed`` and
    ``extend_banded_packed``): extend_cuda on ``_unpack2bit(q_pack, l)``,
    ``_unpack2bit(r_pack, wlen)`` and ``_window_mask(lo, hi, wlen)``, with
    the codes and the mask read inside the kernel. uint8 packs of
    ceil(l/4) and ceil(wlen/4) bytes a row (``pack2bit``), int32 q_len, lo
    and hi; CUDA tensors only; counted as ``extend_scan_packed``. Launches
    the body ``packed_lanes`` picks; ``lanes=32`` forces the row body at 32
    lanes a pair (at every band; the library holds no other packed row
    geometry, so any other value raises ValueError)."""
    if lanes not in (None, 32):
        raise ValueError(f"extend_scan_packed: the row body is built at 32 lanes a pair, not {lanes}")
    dev = q_pack.device
    if dev.type != "cuda" or any(t.device != dev for t in (q_len, r_pack, lo, hi)):
        raise ValueError("extend_scan_packed runs on CUDA tensors on one device")
    if q_pack.dtype != torch.uint8 or r_pack.dtype != torch.uint8:
        raise TypeError(f"extend_scan_packed takes uint8 packs; got {q_pack.dtype}, {r_pack.dtype}")
    if any(t.dtype != torch.int32 for t in (q_len, lo, hi)):
        raise TypeError("extend_scan_packed takes int32 q_len, lo and hi")
    p = q_pack.shape[0]
    band = wlen - l
    if (
        band not in KERNEL_LANES
        or q_pack.shape != (p, -(-l // 4))
        or r_pack.shape != (p, -(-wlen // 4))
        or any(t.shape != (p,) for t in (q_len, lo, hi))
    ):
        raise ValueError(
            f"extend_scan_packed: band {band} = wlen {wlen} - l {l} (must be one of "
            f"{tuple(KERNEL_LANES)}), shapes q_pack {tuple(q_pack.shape)}, r_pack "
            f"{tuple(r_pack.shape)}, q_len {tuple(q_len.shape)}, lo {tuple(lo.shape)}, hi {tuple(hi.shape)}"
        )
    g = packed_lanes(band, collect_plane, l) if lanes is None else lanes
    if not all(t.is_contiguous() for t in (q_pack, q_len, r_pack, lo, hi)):
        raise ValueError("extend_scan_packed takes contiguous tensors")
    return _launch_b4("extend_scan_packed", "phylign_extend_scan_packed", (q_pack, q_len, r_pack, lo, hi),
                      p, l, band, g, scoring, collect_plane)


def _extend_impl(q_codes, q_len, rwin, rwin_valid, scoring, collect_plane) -> ExtendResult:
    """Dispatch by device: the plain version for a CPU tensor, kernel B4
    for a CUDA tensor. Any other device raises."""
    if q_codes.device.type == "cpu":
        return extend_ref(q_codes, q_len, rwin, rwin_valid, scoring, collect_plane)
    if q_codes.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {q_codes.device}")
    return extend_cuda(q_codes, q_len, rwin, rwin_valid, scoring, collect_plane)


def _extend_packed_impl(q_pack, q_len, r_pack, lo, hi, l, wlen, scoring, collect_plane) -> ExtendResult:
    """Dispatch by device: the plain version on the unpacked codes and the
    mask for a CPU tensor, B4's packed instance for a CUDA tensor (no torch
    op before it). Any other device raises."""
    if q_pack.device.type == "cpu":
        q, r = _unpack2bit(q_pack, l), _unpack2bit(r_pack, wlen)
        return extend_ref(q, q_len, r, _window_mask(lo, hi, wlen), scoring, collect_plane)
    if q_pack.device.type != "cuda":
        raise ValueError(f"no extension kernel for device {q_pack.device}")
    return extend_cuda_packed(q_pack, q_len, r_pack, lo, hi, l, wlen, scoring, collect_plane)


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
    and the validity mask as [lo, hi) bounds, read inside kernel B4 on the
    card (one launch) and expanded by the plain version on the CPU."""
    res = _extend_packed_impl(q_pack, q_len, r_pack, lo, hi, l, wlen, scoring, False)
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
    return _extend_packed_impl(q_pack, q_len, r_pack, lo, hi, l, wlen, scoring, True)


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


# --- the traceback on the card (csrc/traceback_walk.cu) -----------------------

#: a cell's direction byte (traceback_dirs_ref, the kernel's sweep): bits
#: 0-2 the H cell's move (=, X, into I1, I2, D1 or D2), bits 3-4 whether
#: I1 / I2 opens there, bits 5-6 whether the cell holds its row's running
#: maximum of D1's / D2's keyed values P + d*e (a deletion's nearest start)
MV_EQ, MV_X, MV_I1, MV_I2, MV_D1, MV_D2 = range(6)
OPEN1, OPEN2, RUN1, RUN2 = 8, 16, 32, 64
#: the op of each code in a walk's output
TRACE_OPS = (CIG_EQ, CIG_X, CIG_I, CIG_D)


class Traceback(NamedTuple):
    ops: torch.Tensor  # uint8 [n, 2L + band] pair j's op codes (TRACE_OPS), in order in its last meta[j, 0] bytes
    meta: torch.Tensor  # int32 [n, 2] (number of ops, -1 where the walk failed; start_d)


class TracebackError(RuntimeError):
    """A walk found no path through its planes (traceback_walk's failed
    assertion)."""


def traceback_dirs_ref(
    p_plane: torch.Tensor,  # f32 [G, L, band]
    q_codes: torch.Tensor,  # uint8 [G, L]
    rwin: torch.Tensor,  # uint8 [G, L + band]
    rvalid: torch.Tensor,  # bool [G, L + band]
    scoring: SrScoring = SrScoring(),
) -> torch.Tensor:
    """The direction byte of every cell (MV_*, OPEN*, RUN*), uint8 [G, L,
    band], from reconstruct_planes' values in its f32 order and
    traceback_walk's tie rules: H's move is a D family where H != P (D1
    where H = D1), else the diagonal where the cell is valid and P = H(i-1,
    d) + sub (0 on row 0), else I1 where P = I1, I2 where P = I2, else the
    diagonal; an insertion opens where I = H(i-1, d+1) - o (0 on row 0,
    -1e30 past the band)."""
    g, l, band = p_plane.shape
    dev = p_plane.device
    s = scoring
    o1, e1 = float(s.gap_open1 + s.gap_ext1), float(s.gap_ext1)
    o2, e2 = float(s.gap_open2 + s.gap_ext2), float(s.gap_ext2)
    d_idx = torch.arange(band, dtype=torch.float32, device=dev)
    negcol = torch.full((g, l, 1), float(NEG), dtype=torch.float32, device=dev)

    def family(o, e):
        de = d_idx * e
        keyed = p_plane + de
        cm = torch.cummax(keyed, dim=2).values
        return torch.cat([negcol, cm[:, :, :-1]], dim=2) - (o + de), keyed == cm

    d1, run1 = family(float(s.gap_open1), e1)
    d2, run2 = family(float(s.gap_open2), e2)
    h = torch.maximum(p_plane, torch.maximum(d1, d2))
    low = torch.where(h != p_plane, torch.where(h == d1, MV_D1, MV_D2), -1).to(torch.int8)
    rv = rvalid.to(torch.bool)
    neg = torch.full((g, 1), float(NEG), dtype=torch.float32, device=dev)
    hprev = torch.zeros((g, band), dtype=torch.float32, device=dev)  # row -1
    i1p = torch.full((g, band), float(NEG), dtype=torch.float32, device=dev)
    i2p = i1p.clone()
    dirs = torch.empty((g, l, band), dtype=torch.uint8, device=dev)
    for i in range(l):
        hs = torch.cat([hprev[:, 1:], neg], dim=1)
        i1 = torch.maximum(hs - o1, torch.cat([i1p[:, 1:], neg], dim=1) - e1)
        i2 = torch.maximum(hs - o2, torch.cat([i2p[:, 1:], neg], dim=1) - e2)
        hso = torch.zeros_like(hs) if i == 0 else hs
        p = p_plane[:, i]
        ok = rv[:, i : i + band]
        m = ok & (rwin[:, i : i + band] == q_codes[:, i : i + 1])
        sub = torch.where(m, float(s.match), -float(s.mismatch))
        diag_mv = torch.where(m, MV_EQ, MV_X)
        mv = torch.where(
            ok & (p == hprev + sub), diag_mv,
            torch.where(p == i1, MV_I1, torch.where(p == i2, MV_I2, diag_mv)),
        )
        mv = torch.where(low[:, i] >= 0, low[:, i], mv)
        dirs[:, i] = (
            mv
            | torch.where(i1 == hso - o1, OPEN1, 0)
            | torch.where(i2 == hso - o2, OPEN2, 0)
            | torch.where(run1[:, i], RUN1, 0)
            | torch.where(run2[:, i], RUN2, 0)
        ).to(torch.uint8)
        hprev, i1p, i2p = h[:, i], i1, i2
    return dirs


def walk_dirs(dirs: np.ndarray, qlen: int, end_d: int) -> tuple[list[int], int] | None:
    """Follow one pair's direction bytes (uint8 [L, band]) from (qlen - 1,
    end_d) to row 0, as the kernel's walk does: its op codes in order and
    start_d, or None where traceback_walk fails (no gap start, the band
    left, an insertion at the end)."""
    band = dirs.shape[1]
    ops: list[int] = []
    i, d, state = qlen - 1, int(end_d), "H"
    if not 0 <= d < band:
        return None
    while i >= 0:
        b = int(dirs[i, d])
        if state == "H":
            mv = b & 7
            if mv in (MV_EQ, MV_X):
                ops.append(mv)
                i -= 1
            else:
                state = {MV_I1: "I1", MV_I2: "I2", MV_D1: "D1", MV_D2: "D2"}[mv]
        elif state in ("D1", "D2"):
            bit = RUN1 if state == "D1" else RUN2
            dp = d - 1
            while dp >= 0 and not dirs[i, dp] & bit:
                dp -= 1
            if dp < 0:
                return None
            ops.extend([3] * (d - dp))
            d, state = dp, "H"
        else:
            ops.append(2)
            if b & (OPEN1 if state == "I1" else OPEN2):
                state = "H"
            i, d = i - 1, d + 1
            if d >= band and i >= 0:
                return None
    if state != "H":
        return None
    ops.reverse()
    return ops, d


def traceback_ref(
    p_plane: torch.Tensor,  # f32 [>= n, L, band] the plane pass's P plane
    q_pack: torch.Tensor,  # uint8 [>= n, ceil(L/4)]
    q_len: torch.Tensor,  # int32 [>= n]
    r_pack: torch.Tensor,  # uint8 [>= n, ceil((L + band)/4)]
    lo: torch.Tensor,  # int32 [>= n]
    hi: torch.Tensor,  # int32 [>= n]
    end_d: torch.Tensor,  # int32 [>= n] the walk's start offset
    n: int,
    scoring: SrScoring = SrScoring(),
) -> Traceback:
    """The plain version of traceback_cuda (the kernel is held to it, and it
    to reconstruct_planes + traceback_walk): the direction bytes in plain
    PyTorch, then a walk over them for each of the first n pairs."""
    _, l, band = p_plane.shape
    wlen = l + band
    dirs = traceback_dirs_ref(
        p_plane[:n], _unpack2bit(q_pack[:n], l), _unpack2bit(r_pack[:n], wlen),
        _window_mask(lo[:n], hi[:n], wlen), scoring,
    ).cpu().numpy()
    w = 2 * l + band
    ops = np.zeros((n, w), np.uint8)
    meta = np.zeros((n, 2), np.int32)
    q_len_l, end_l = q_len[:n].tolist(), end_d[:n].tolist()
    for j in range(n):
        got = walk_dirs(dirs[j], min(q_len_l[j], l), end_l[j])
        if got is None:
            meta[j] = (-1, 0)
            continue
        codes, start_d = got
        ops[j, w - len(codes):] = codes
        meta[j] = (len(codes), start_d)
    dev = p_plane.device
    return Traceback(torch.from_numpy(ops).to(dev), torch.from_numpy(meta).to(dev))


def traceback_cuda(p_plane, q_pack, q_len, r_pack, lo, hi, end_d, n: int,
                   scoring: SrScoring = SrScoring()) -> Traceback:
    """The traceback kernel (csrc/traceback_walk.cu): traceback_ref's
    output for the first n pairs, from the plane and the packed inputs on
    the card (the plane never leaves it). CUDA tensors on one device, band
    in KERNEL_LANES; counted as ``traceback_walk``."""
    dev = p_plane.device
    ins = (q_pack, q_len, r_pack, lo, hi, end_d)
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError("traceback_walk runs on CUDA tensors on one device")
    if p_plane.dtype != torch.float32 or q_pack.dtype != torch.uint8 or r_pack.dtype != torch.uint8:
        raise TypeError("traceback_walk takes an f32 plane and uint8 packs")
    if any(t.dtype != torch.int32 for t in (q_len, lo, hi, end_d)):
        raise TypeError("traceback_walk takes int32 q_len, lo, hi and end_d")
    p, l, band = p_plane.shape
    if (
        band not in KERNEL_LANES or not 0 <= n <= p
        or q_pack.shape != (p, -(-l // 4)) or r_pack.shape != (p, -(-(l + band) // 4))
        or any(t.shape != (p,) for t in (q_len, lo, hi, end_d))
    ):
        raise ValueError(
            f"traceback_walk: band {band} (must be one of {tuple(KERNEL_LANES)}), n {n}, shapes "
            f"plane {tuple(p_plane.shape)}, q_pack {tuple(q_pack.shape)}, r_pack {tuple(r_pack.shape)}"
        )
    if not all(t.is_contiguous() for t in (p_plane, *ins)) or p_plane.data_ptr() % 16:
        raise ValueError("traceback_walk takes contiguous tensors and a 16-byte aligned plane")
    ops = torch.empty((n, 2 * l + band), dtype=torch.uint8, device=dev)
    meta = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return Traceback(ops, meta)
    dirs = torch.empty((n, l, band), dtype=torch.uint8, device=dev)
    s = scoring
    _kernels.launch(
        _launches, "traceback_walk", "traceback_walk", "phylign_traceback_walk",
        p_plane, q_pack, q_len, r_pack, lo, hi, end_d, n, l, band,
        float(s.match), float(s.mismatch), float(s.gap_open1 + s.gap_ext1), float(s.gap_ext1),
        float(s.gap_open2 + s.gap_ext2), float(s.gap_ext2), float(s.gap_open1), float(s.gap_open2),
        dirs, ops, meta,
    )
    return Traceback(ops, meta)


def decode_traceback(ops: np.ndarray, meta: np.ndarray) -> list[tuple[list[tuple[int, str]], int]]:
    """A Traceback fetched to the host -> traceback_walk's (CIGAR run-length
    list, start_d) for each pair, the runs found with numpy. Raises
    TracebackError where a walk failed."""
    n, w = ops.shape
    n_ops = meta[:, 0].astype(np.int64)
    bad = np.flatnonzero(n_ops < 0)
    if len(bad):
        raise TracebackError(f"deletion traceback failed for pairs {bad[:8].tolist()} of {n}")
    flat = ops[np.arange(w)[None, :] >= (w - n_ops)[:, None]]
    pair = np.repeat(np.arange(n), n_ops)
    brk = np.ones(len(flat), bool)
    brk[1:] = (flat[1:] != flat[:-1]) | (pair[1:] != pair[:-1])
    starts = np.flatnonzero(brk)
    lens = np.diff(np.append(starts, len(flat))).tolist()
    names = [TRACE_OPS[c] for c in flat[starts].tolist()]
    per = np.bincount(pair[starts], minlength=n).tolist()
    out, k = [], 0
    for j, start_d in enumerate(meta[:, 1].tolist()):
        out.append((list(zip(lens[k : k + per[j]], names[k : k + per[j]])), start_d))
        k += per[j]
    return out


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
