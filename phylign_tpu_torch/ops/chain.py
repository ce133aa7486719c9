"""Batched anchor chaining DP (minimap2-style) on the device: the counterpart
of ``phylign_tpu/ops/chain.py``.

All (query, genome) anchor sets of a flush are chained together as one
[P, A] problem: P anchor sets, A padded anchor slots, sorted by
(rpos, qpos). Scoring is minimap2's mm_chain_dp model at its own scale:

    f[i] = max(k, max_{j in window} f[j] + gain(j, i) - cost(dd))
    gain = min(dq, dr, k);   cost(dd) = 0.01 * k * dd + 0.5 * log2(dd + 1)
    with dd = |dr - dq|; a transition needs 0 < dr <= max_gap,
    0 < dq <= max_gap and dd <= bandwidth.

The window is the W = min(LOOKBACK, A) previous slots; on ties the nearest
predecessor wins, and a parent is taken only when strictly better than the
seed weight k (minimap2's ``sc > max_f``).

Implementations with identical results:
  * ``chain_dp_ref``   the scan in plain PyTorch, one step per slot over a
                       shifting [P, W] window; the CPU path and the version
                       the kernel is held to.
  * ``chain_dp_cuda``  CUDA kernel B3 (csrc/chain_scan.cu): G lanes per
                       anchor set, each holding its share of the window in
                       registers, slot i-1 folded in off the critical path.
``chain_dp`` picks by the tensor's device. Everything after the scan
(pointer doubling, the s2 competitor, the split-read segments) is
``chain_tail``: ``_chain_tail_ref`` in plain PyTorch, or CUDA kernel B6a
(csrc/flush_epilogue.cu, ``chain_select_cuda``): a warp per anchor set of
up to 256 slots, its slots in the lanes' registers, one block per longer
set.

Arithmetic is float32 as in the JAX function: positions become f32 (padded
slots 2e9), dr / dq / dd are f32 differences, ``cand = (f + gain) - cost``.
``cost`` comes from a table over the integer dd in [0, bandwidth]
(``cost_table``) shared by both versions, so the card's answer does not
depend on its ``log2f``. The table is XLA-CPU's own evaluation of the JAX
expression, emulated in numpy f32 (``xla_log``: Eigen's log polynomial with
fused multiply-adds; the sum contracted into one fused multiply-add), so
every ``ChainResult`` field equals the JAX function's bit for bit.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from phylign_tpu_torch.ops import _kernels

PAD_POS = np.int32(2**30)

#: predecessor-window width of the scan DP (minimap2's chaining likewise
#: bounds how far back it looks per anchor); exact for anchor sets <= this
LOOKBACK = 64

#: hard ceiling on padded anchor slots per (pair, strand); larger anchor
#: sets are truncated with a log (the align engine counts the overflow)
MAX_ANCHORS = 4096

NEG = np.float32(-1e30)
#: float position of a padded slot: every transition to or from it fails
#: the distance bounds
PAD_F = np.float32(2.0e9)


class ChainResult(NamedTuple):
    # primary chain per pair: best-scoring DP cell
    score: torch.Tensor  # f32 [P]
    count: torch.Tensor  # int32 [P] anchors on the chain
    qs: torch.Tensor  # int32 [P] query start (first anchor kmer start)
    qe: torch.Tensor  # int32 [P] query end (last anchor kmer start + k)
    rs: torch.Tensor  # int32 [P] ref start
    re: torch.Tensor  # int32 [P] ref end
    # best chain overlapping the primary's query interval by >= mask_level
    # (the s2 competitor for mapq); < 0 when none exists, with its coords
    alt_score: torch.Tensor  # f32 [P]
    alt_qs: torch.Tensor  # int32 [P] (garbage when alt_score < 0)
    alt_qe: torch.Tensor  # int32 [P]
    alt_rs: torch.Tensor  # int32 [P]
    alt_re: torch.Tensor  # int32 [P]
    # up to n_sup further chains, each mostly-disjoint from every previously
    # selected chain (split-read segments); score < 0 marks an empty slot
    sup_score: torch.Tensor  # f32 [P, n_sup]
    sup_count: torch.Tensor  # int32 [P, n_sup]
    sup_qs: torch.Tensor  # int32 [P, n_sup]
    sup_qe: torch.Tensor  # int32 [P, n_sup]
    sup_rs: torch.Tensor  # int32 [P, n_sup]
    sup_re: torch.Tensor  # int32 [P, n_sup]


def _fma(a, b, c) -> np.ndarray:
    """f32 fused multiply-add: the f32 product is exact in float64, so one
    float64 add and one rounding to f32 give fma(a, b, c)."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)


#: Cephes' log polynomial, as Eigen's plog_float evaluates it
_LOG_P = tuple(np.float32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))


def xla_log(x: np.ndarray) -> np.ndarray:
    """f32 natural log of positive normal f32 values, equal bit for bit to
    XLA-CPU's ``jnp.log``: Eigen's plog_float (frexp, the shift of the
    mantissa to [sqrt(1/2), sqrt(2)), the Cephes polynomial in Estrin form
    with every multiply-add fused, then the exponent's two-part ln 2)."""
    f32 = np.float32
    m, e = np.frexp(np.asarray(x, f32))
    m, e = m.astype(f32), e.astype(f32)
    small = m < f32(0.707106781186547524)
    e = e - np.where(small, f32(1), f32(0))
    m = (m - f32(1)) + np.where(small, m, f32(0))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y, y1, y2 = _fma(p[0], m, p[1]), _fma(p[3], m, p[4]), _fma(p[6], m, p[7])
    y, y1, y2 = _fma(y, m, p[2]), _fma(y1, m, p[5]), _fma(y2, m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = y + e * f32(-2.12194440e-4)
    m = (m - x2 * f32(0.5)) + y
    return (m + e * f32(0.693359375)).astype(f32)


def xla_log2(x: np.ndarray) -> np.ndarray:
    """XLA-CPU's f32 ``jnp.log2``: ``log(x) * f32(1 / ln 2)``."""
    return (xla_log(x) * np.float32(1.0 / np.log(2.0))).astype(np.float32)


def cost_table(k: int, bandwidth: int) -> np.ndarray:
    """f32 [bandwidth + 1]: cost(dd) = 0.01 * k * dd + 0.5 * log2(dd + 1) for
    the integer dd, bit for bit as XLA-CPU evaluates the JAX scan's
    expression: ``0.01 * k`` rounded to f32, log2 as ``xla_log2``, and the
    sum contracted into one fused multiply-add,
    ``fma(f32(0.01 * k), dd, f32(0.5 * log2(dd + 1)))``."""
    f32 = np.float32
    dd = np.arange(bandwidth + 1, dtype=f32)
    half_lg = f32(0.5) * xla_log2(dd + f32(1))
    return _fma(f32(f32(0.01) * f32(k)), dd, half_lg)


def qpos_i32(qpos: torch.Tensor) -> torch.Tensor:
    """int32 query positions from int32, uint16 or int16 holding uint16
    bits (the compact upload's dtype: torch's uint16 support is partial)."""
    if qpos.dtype == torch.int16:
        return qpos.to(torch.int32) & 0xFFFF
    return qpos.to(torch.int32)


def _positions_f32(rpos: torch.Tensor, qpos: torch.Tensor):
    valid = rpos < int(PAD_POS)
    pad = torch.tensor(PAD_F, device=rpos.device)
    return (
        valid,
        torch.where(valid, rpos.to(torch.float32), pad),
        torch.where(valid, qpos.to(torch.float32), pad),
    )


# --- plain PyTorch version ----------------------------------------------------


def chain_dp_ref(
    rpos: torch.Tensor,  # int32 [P, A], PAD_POS for padding
    qpos: torch.Tensor,  # int32, or uint16 bits as uint16/int16 [P, A]
    cost: torch.Tensor,  # f32 [bandwidth + 1] (cost_table)
    k: int,
    max_gap: int,
    bandwidth: int,
    lookback: int = LOOKBACK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan in plain PyTorch: returns (f f32 [P, A], parent int32
    [P, A]); f of a padded slot is NEG, parent -1 marks a chain start."""
    p, a = rpos.shape
    w = min(lookback, a)
    dev = rpos.device
    valid, rposf, qposf = _positions_f32(rpos, qpos_i32(qpos))
    neg = torch.tensor(NEG, device=dev)
    kf = torch.tensor(np.float32(k), device=dev)
    gapf, bandf = float(max_gap), float(bandwidth)
    fbuf = torch.full((p, w), float(NEG), dtype=torch.float32, device=dev)
    rbuf = torch.full((p, w), float(PAD_F), dtype=torch.float32, device=dev)
    qbuf = torch.full((p, w), float(PAD_F), dtype=torch.float32, device=dev)
    f = torch.empty((p, a), dtype=torch.float32, device=dev)
    parent = torch.empty((p, a), dtype=torch.int32, device=dev)
    for i in range(a):
        ri, qi = rposf[:, i : i + 1], qposf[:, i : i + 1]
        dr = ri - rbuf
        dq = qi - qbuf
        dd = (dr - dq).abs()
        ok = (dr > 0) & (dq > 0) & (dr <= gapf) & (dq <= gapf) & (dd <= bandf)
        gain = torch.minimum(torch.minimum(dq, dr), kf)
        c = cost[dd.clamp(0, bandwidth).to(torch.int64)]
        cand = torch.where(ok, (fbuf + gain) - c, neg)
        # nearest predecessor on ties: first max of the reversed window
        best_w = (w - 1) - torch.argmax(cand.flip(1), dim=1)
        best_v = cand.gather(1, best_w[:, None])[:, 0]
        use = best_v > kf
        fi = torch.maximum(best_v, kf)
        f[:, i] = fi
        parent[:, i] = torch.where(use, best_w + (i - w), -1).to(torch.int32)
        fbuf = torch.cat([fbuf[:, 1:], fi[:, None]], dim=1)
        rbuf = torch.cat([rbuf[:, 1:], ri], dim=1)
        qbuf = torch.cat([qbuf[:, 1:], qi], dim=1)
    return torch.where(valid, f, neg), parent


# --- hand-written CUDA kernel B3 -----------------------------------------------

_launches = _kernels.LaunchCounts("chain_scan", "chain_select")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return _launches.snapshot()


def reset_launch_counts() -> None:
    _launches.reset()


#: lanes per anchor set kernel B3 is built for
KERNEL_LANES = (4, 8, 16, 32)
#: threads that keep an H100 busy on B3 (~16 warps an SM): below it a call
#: is bound by the latency of its A dependent steps, shortest at 32 lanes;
#: above it by instruction issue, least at few lanes (PERF.md)
FILL_THREADS = 65536
#: entries of the cost table kernel B3 holds in shared memory
#: (min(bandwidth, max_gap) + 1 of them: the only ones a transition reads)
MAX_TABLE = 56 * 1024


def chain_lanes(p: int) -> int:
    """The lanes per anchor set chain_dp_cuda uses for P sets: the fewest
    that still fill the card, else a whole warp."""
    return next((g for g in KERNEL_LANES[:-1] if p * g >= FILL_THREADS), KERNEL_LANES[-1])


def chain_dp_cuda(
    rpos: torch.Tensor,
    qpos: torch.Tensor,
    cost: torch.Tensor,
    k: int,
    max_gap: int,
    bandwidth: int,
    lookback: int = LOOKBACK,
    lanes: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3 (replaces the ``lax.scan`` of
    ``phylign_tpu/ops/chain.py:chain_anchors``). CUDA tensors only; same
    contract as chain_dp_ref. qpos may be int32, or uint16 bits as uint16
    or int16. ``lanes`` overrides the lanes per set (one of
    KERNEL_LANES)."""
    if rpos.device.type != "cuda" or qpos.device != rpos.device or cost.device != rpos.device:
        raise ValueError(
            f"chain_scan runs on CUDA tensors on one device; got rpos on "
            f"{rpos.device}, qpos on {qpos.device}, cost on {cost.device}"
        )
    q16 = qpos.dtype in (torch.uint16, torch.int16)
    if rpos.dtype != torch.int32 or not (q16 or qpos.dtype == torch.int32):
        raise TypeError(f"chain_scan takes int32 rpos and int32/uint16 qpos; got {rpos.dtype}, {qpos.dtype}")
    if cost.dtype != torch.float32 or cost.numel() != bandwidth + 1:
        raise ValueError(f"chain_scan: cost must be f32 [{bandwidth + 1}]")
    if min(bandwidth, max_gap) + 1 > MAX_TABLE or min(bandwidth, max_gap) < 0:
        raise ValueError(f"chain_scan: cost table of min(bandwidth, max_gap) + 1 entries must be in 1..{MAX_TABLE}")
    if rpos.dim() != 2 or qpos.shape != rpos.shape:
        raise ValueError(f"chain_scan: rpos and qpos must be [P, A]; got {tuple(rpos.shape)}, {tuple(qpos.shape)}")
    if not (rpos.is_contiguous() and qpos.is_contiguous() and cost.is_contiguous()):
        raise ValueError("chain_scan takes contiguous tensors")
    p, a = rpos.shape
    w = min(lookback, a)
    if not 1 <= w <= 64:
        raise ValueError(f"chain_scan: window {w} outside 1..64")
    g = chain_lanes(p) if lanes is None else lanes
    if g not in KERNEL_LANES:
        raise ValueError(f"chain_scan: {g} lanes per set not built (one of {KERNEL_LANES})")
    f = torch.empty((p, a), dtype=torch.float32, device=rpos.device)
    parent = torch.empty((p, a), dtype=torch.int32, device=rpos.device)
    if p == 0 or a == 0:
        return f, parent
    _kernels.launch(
        _launches, "chain_scan", "chain_scan", "phylign_chain_scan",
        rpos, qpos, int(q16), cost, p, a, w, g, int(k), int(max_gap), int(bandwidth), f, parent,
    )
    return f, parent


def chain_dp(rpos, qpos, cost, k, max_gap, bandwidth, lookback=LOOKBACK):
    """Dispatch by device: the plain version for a CPU tensor, kernel B3
    for a CUDA tensor. Any other device raises."""
    if rpos.device.type == "cpu":
        return chain_dp_ref(rpos, qpos, cost, k, max_gap, bandwidth, lookback)
    if rpos.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {rpos.device}")
    return chain_dp_cuda(rpos, qpos, cost, k, max_gap, bandwidth, lookback)


# --- chain extraction: plain version and kernel B6a ----------------------------

_cost_cache: dict = {}
_cost_lock = threading.Lock()


def device_cost_table(k: int, bandwidth: int, device: torch.device) -> torch.Tensor:
    """cost_table on ``device``, uploaded once per (k, bandwidth, device)."""
    key = (int(k), int(bandwidth), str(device))
    with _cost_lock:
        t = _cost_cache.get(key)
        if t is None:
            t = torch.from_numpy(np.array(cost_table(k, bandwidth))).to(device)
            _cost_cache[key] = t
        return t


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return arr.gather(1, idx[:, None].to(torch.int64))[:, 0]


def _chain_tail_ref(
    f: torch.Tensor,  # f32 [P, A] (chain_dp)
    parent: torch.Tensor,  # int32 [P, A] (chain_dp)
    rpos: torch.Tensor,  # int32 [P, A], PAD_POS for padding
    qpos: torch.Tensor,  # int32, or uint16 bits as uint16/int16 [P, A]
    k: int,
    n_sup: int,
) -> ChainResult:
    """The tail of chain_anchors in plain PyTorch: per set the primary chain,
    its s2 competitor and up to ``n_sup`` split-read segments; the CPU path
    and the version kernel B6a is held to."""
    p, a = rpos.shape
    dev = rpos.device
    qpos = qpos_i32(qpos)
    valid = rpos < int(PAD_POS)
    neg = torch.tensor(NEG, device=dev)

    # pointer doubling: chain start + edge count for EVERY slot in log2(A)
    # parent-jumping rounds
    iota = torch.arange(a, dtype=torch.int64, device=dev)[None, :].expand(p, a)
    par = torch.where(parent >= 0, parent.to(torch.int64), iota)  # roots self-loop
    cnt = (parent >= 0).to(torch.int32)
    for _ in range(doubling_rounds(a)):
        cnt = cnt + cnt.gather(1, par)
        par = par.gather(1, par)
    start_all, cnt_all = par, cnt + 1

    qs_all = qpos.gather(1, start_all)
    qe_all = qpos + k  # the end anchor of slot i is i itself
    rs_all = rpos.gather(1, start_all)

    end = torch.argmax(f, dim=1)
    score1 = _take(f, end)
    qs1, qe1 = _take(qs_all, end), _take(qe_all, end)

    def overlap_frac_ok(sel_qs, sel_qe, sel_live):
        """[P, A] mask: slot interval overlaps (sel_qs, sel_qe) by >= half of
        the shorter span; False everywhere when the selection is not live."""
        ov = torch.clamp(
            torch.minimum(qe_all, sel_qe[:, None]) - torch.maximum(qs_all, sel_qs[:, None]),
            min=0,
        ).to(torch.float32)
        span = torch.minimum(qe_all - qs_all, (sel_qe - sel_qs)[:, None]).to(torch.float32)
        return (ov >= 0.5 * span) & sel_live[:, None]

    live1 = score1 > 0.0
    # s2: best chain overlapping the primary, excluding every cell that
    # shares the primary's chain root
    prim_root = _take(start_all, end)
    on_prim = start_all == prim_root[:, None]
    alt_mask = overlap_frac_ok(qs1, qe1, live1) & valid & ~on_prim
    f_alt = torch.where(alt_mask, f, neg)
    alt_end = torch.argmax(f_alt, dim=1)
    alt_score = _take(f_alt, alt_end)

    # split-read segments: iteratively the best chain mostly-disjoint from
    # every chain selected so far (primary included)
    blocked = overlap_frac_ok(qs1, qe1, live1) | ~valid
    sup = {key: [] for key in ("score", "count", "qs", "qe", "rs", "re")}
    for _ in range(n_sup):
        fn = torch.where(blocked, neg, f)
        end_n = torch.argmax(fn, dim=1)
        score_n = _take(fn, end_n)
        live_n = score_n > 0.0
        qs_n, qe_n = _take(qs_all, end_n), _take(qe_all, end_n)
        sup["score"].append(score_n)
        sup["count"].append(_take(cnt_all, end_n))
        sup["qs"].append(qs_n)
        sup["qe"].append(qe_n)
        sup["rs"].append(_take(rs_all, end_n))
        sup["re"].append(_take(rpos, end_n) + k)
        blocked = blocked | overlap_frac_ok(qs_n, qe_n, live_n) | (
            (iota == end_n[:, None]) & live_n[:, None]
        )

    def stack(key, dtype):
        if sup[key]:
            return torch.stack(sup[key], dim=1)
        return torch.zeros((p, 0), dtype=dtype, device=dev)

    i32 = torch.int32
    return ChainResult(
        score=score1,
        count=_take(cnt_all, end),
        qs=qs1,
        qe=qe1,
        rs=_take(rs_all, end),
        re=_take(rpos, end) + k,
        alt_score=alt_score,
        alt_qs=_take(qs_all, alt_end),
        alt_qe=_take(qe_all, alt_end),
        alt_rs=_take(rs_all, alt_end),
        alt_re=_take(rpos, alt_end) + k,
        sup_score=stack("score", torch.float32),
        sup_count=stack("count", i32),
        sup_qs=stack("qs", i32),
        sup_qe=stack("qe", i32),
        sup_rs=stack("rs", i32),
        sup_re=stack("re", i32),
    )


def doubling_rounds(a: int) -> int:
    """Pointer-doubling rounds of the chain tail for A slots: ceil(log2 A),
    at least 1 (a chain of A slots has fewer than 2**rounds edges)."""
    return max(1, int(np.ceil(np.log2(max(a, 2)))))


def chain_select_cuda(
    f: torch.Tensor,
    parent: torch.Tensor,
    rpos: torch.Tensor,
    qpos: torch.Tensor,
    k: int,
    n_sup: int,
) -> ChainResult:
    """Kernel B6a (replaces the tail of ``phylign_tpu/ops/chain.py:
    chain_anchors`` after its scan). CUDA tensors only; same contract as
    _chain_tail_ref for a parent from chain_dp (-1 or an earlier slot), at
    any A: a set of up to 256 slots takes a warp (8 sets a block), a longer
    one a block, with the set in shared memory up to 8,192 slots and in a
    device workspace past that. Every field is a view of one int32 buffer
    the kernel fills."""
    dev = rpos.device
    if dev.type != "cuda" or any(t.device != dev for t in (f, parent, qpos)):
        raise ValueError(
            f"chain_select runs on CUDA tensors on one device; got f on {f.device}, "
            f"parent on {parent.device}, rpos on {dev}, qpos on {qpos.device}"
        )
    q16 = qpos.dtype in (torch.uint16, torch.int16)
    if (f.dtype, parent.dtype, rpos.dtype) != (torch.float32, torch.int32, torch.int32) or not (
        q16 or qpos.dtype == torch.int32
    ):
        raise TypeError(
            f"chain_select takes f32 f, int32 parent and rpos, int32/uint16 qpos; got "
            f"{f.dtype}, {parent.dtype}, {rpos.dtype}, {qpos.dtype}"
        )
    if rpos.dim() != 2 or any(t.shape != rpos.shape for t in (f, parent, qpos)):
        raise ValueError("chain_select: f, parent, rpos and qpos must be one [P, A] shape")
    if not all(t.is_contiguous() for t in (f, parent, rpos, qpos)):
        raise ValueError("chain_select takes contiguous tensors")
    p, a = rpos.shape
    if a < 1 or n_sup < 0:
        raise ValueError(f"chain_select: A = {a} < 1 or n_sup = {n_sup} < 0")
    buf = torch.empty(p * (11 + 6 * n_sup), dtype=torch.int32, device=dev)
    if p:
        ws_bytes = _kernels.library("flush_epilogue").phylign_chain_select_workspace(p, a)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
        _kernels.launch(
            _launches, "chain_select", "flush_epilogue", "phylign_chain_select",
            f, parent, rpos, qpos, int(q16), p, a, int(k), int(n_sup), doubling_rounds(a), ws, buf,
        )
    rows = buf[: 11 * p].view(11, p)
    sups = buf[11 * p :].view(6, p, n_sup)
    fl = torch.float32
    return ChainResult(
        rows[0].view(fl), *rows[1:6], rows[6].view(fl), *rows[7:11], sups[0].view(fl), *sups[1:],
    )


def chain_tail(f, parent, rpos, qpos, k: int, n_sup: int) -> ChainResult:
    """Dispatch by device: the plain version for a CPU tensor, kernel B6a
    for a CUDA tensor. Any other device raises."""
    if rpos.device.type == "cpu":
        return _chain_tail_ref(f, parent, rpos, qpos, k, n_sup)
    if rpos.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {rpos.device}")
    return chain_select_cuda(f, parent, rpos, qpos, k, n_sup)


def chain_anchors(
    rpos: torch.Tensor,  # int32 [P, A], PAD_POS for padding; sorted (rpos, qpos)
    qpos: torch.Tensor,  # int32 [P, A]
    k: int = 21,
    max_gap: int = 100,
    bandwidth: int = 100,
    n_sup: int = 2,
    lookback: int = LOOKBACK,
) -> ChainResult:
    """Chain every anchor set: the DP (chain_dp), then per set the primary
    chain, its s2 competitor and up to ``n_sup`` split-read segments
    (chain_tail)."""
    cost = device_cost_table(k, bandwidth, rpos.device)
    f, parent = chain_dp(rpos, qpos, cost, k, max_gap, bandwidth, lookback)
    return chain_tail(f, parent, rpos, qpos, k, n_sup)


def chain_anchors_packed(
    rpos: torch.Tensor,  # int32 [P, A]
    qpos_u16: torch.Tensor,  # uint16 bits [P, A] (uint16 or int16 dtype)
    k: int = 21,
    max_gap: int = 100,
    bandwidth: int = 100,
    n_sup: int = 2,
    lookback: int = LOOKBACK,
) -> ChainResult:
    """chain_anchors with qpos as uint16 (half the bytes of the second
    upload; slot validity comes from rpos alone, so padded qpos values are
    free). Real qpos must be < 2**16 (the align engine checks)."""
    return chain_anchors(
        rpos, qpos_u16, k=k, max_gap=max_gap, bandwidth=bandwidth,
        n_sup=n_sup, lookback=lookback,
    )


def chain_oracle(
    rpos: np.ndarray,
    qpos: np.ndarray,
    k=21,
    max_gap=100,
    bandwidth=100,
    lookback: int | None = None,
):
    """Scalar numpy transliteration of the same DP, for tests.

    ``lookback=None`` runs the exact full-predecessor DP (equals the scan
    whenever A <= LOOKBACK); an int bounds the predecessor window exactly
    like the scan's window."""
    a = len(rpos)
    f = np.full(a, float(k))
    parent = np.full(a, -1)
    for i in range(1, a):
        best, bj = float(k), -1  # standalone seed weight (mm2's max_f init)
        j0 = 0 if lookback is None else max(0, i - lookback)
        for j in range(i - 1, j0 - 1, -1):  # nearest first (mm2 loop order)
            dr, dq = rpos[i] - rpos[j], qpos[i] - qpos[j]
            dd = abs(dr - dq)
            if dr <= 0 or dq <= 0 or dr > max_gap or dq > max_gap or dd > bandwidth:
                continue
            sc = min(dq, dr, k) - (0.01 * k * dd + 0.5 * np.log2(dd + 1))
            if f[j] + sc > best:
                best, bj = f[j] + sc, j
        f[i] = best
        parent[i] = bj
    end = int(np.argmax(f))
    cnt, cur = 1, end
    while parent[cur] >= 0:
        cur = parent[cur]
        cnt += 1
    return f[end], cnt, qpos[cur], qpos[end] + k, rpos[cur], rpos[end] + k
