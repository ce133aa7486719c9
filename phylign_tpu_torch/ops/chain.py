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
  * ``chain_dp_cuda``  CUDA kernel B3 (csrc/chain_scan.cu): one warp per
                       anchor set, the window a ring in registers.
``chain_dp`` picks by the tensor's device. Everything after the scan
(pointer doubling, the s2 competitor, the split-read segments) is torch ops
on the same device.

Arithmetic is float32 as in the JAX function: positions become f32 (padded
slots 2e9), dr / dq / dd are f32 differences, ``cand = (f + gain) - cost``.
``cost`` comes from a table over the integer dd in [0, bandwidth]
(``cost_table``) shared by both versions, so the card's answer does not
depend on its ``log2f``. The table rounds log2 correctly; XLA's CPU log is
an approximation that differs from it by one unit in the last place for
some dd (tests/test_torch_chain.py pins this).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

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


def cost_table(k: int, bandwidth: int) -> np.ndarray:
    """f32 [bandwidth + 1]: cost(dd) = 0.01 * k * dd + 0.5 * log2(dd + 1) for
    the integer dd, in the JAX expression's f32 operation order (``0.01 * k``
    rounded to f32 first, then ``* dd``; the two terms added in f32). log2
    is taken in float64 and rounded once to f32."""
    dd = np.arange(bandwidth + 1, dtype=np.float32)
    lin = (np.float32(np.float32(0.01) * np.float32(k)) * dd).astype(np.float32)
    lg = np.log2(dd.astype(np.float64) + 1.0).astype(np.float32)
    return (lin + (np.float32(0.5) * lg).astype(np.float32)).astype(np.float32)


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

_launch_lock = threading.Lock()
_launches = {"chain_scan": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


#: anchor sets (warps) per block of kernel B3
WARPS_PER_BLOCK = 4


def chain_dp_cuda(
    rpos: torch.Tensor,
    qpos: torch.Tensor,
    cost: torch.Tensor,
    k: int,
    max_gap: int,
    bandwidth: int,
    lookback: int = LOOKBACK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3 (replaces the ``lax.scan`` of
    ``phylign_tpu/ops/chain.py:chain_anchors``). CUDA tensors only; same
    contract as chain_dp_ref. qpos may be int32, or uint16 bits as uint16
    or int16."""
    from phylign_tpu_torch.ops import _kernels

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
    if rpos.dim() != 2 or qpos.shape != rpos.shape:
        raise ValueError(f"chain_scan: rpos and qpos must be [P, A]; got {tuple(rpos.shape)}, {tuple(qpos.shape)}")
    if not (rpos.is_contiguous() and qpos.is_contiguous() and cost.is_contiguous()):
        raise ValueError("chain_scan takes contiguous tensors")
    p, a = rpos.shape
    w = min(lookback, a)
    if not 1 <= w <= 64:
        raise ValueError(f"chain_scan: window {w} outside 1..64")
    f = torch.empty((p, a), dtype=torch.float32, device=rpos.device)
    parent = torch.empty((p, a), dtype=torch.int32, device=rpos.device)
    if p == 0 or a == 0:
        return f, parent
    lib = _kernels.library("chain_scan")
    with torch.cuda.device(rpos.device):
        stream = torch.cuda.current_stream(rpos.device).cuda_stream
        err = lib.phylign_chain_scan(
            rpos.data_ptr(), qpos.data_ptr(), int(q16),
            cost.data_ptr(), p, a, w, int(k), int(max_gap), int(bandwidth),
            WARPS_PER_BLOCK, f.data_ptr(), parent.data_ptr(), stream,
        )
    _kernels.check(lib, err, "chain_scan")
    with _launch_lock:
        _launches["chain_scan"] += 1
    return f, parent


def chain_dp(rpos, qpos, cost, k, max_gap, bandwidth, lookback=LOOKBACK):
    """Dispatch by device: the plain version for a CPU tensor, kernel B3
    for a CUDA tensor. Any other device raises."""
    if rpos.device.type == "cpu":
        return chain_dp_ref(rpos, qpos, cost, k, max_gap, bandwidth, lookback)
    if rpos.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {rpos.device}")
    return chain_dp_cuda(rpos, qpos, cost, k, max_gap, bandwidth, lookback)


# --- chain extraction (torch ops on the device) --------------------------------

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
    chain, its s2 competitor and up to ``n_sup`` split-read segments."""
    p, a = rpos.shape
    dev = rpos.device
    cost = device_cost_table(k, bandwidth, dev)
    f, parent = chain_dp(rpos, qpos, cost, k, max_gap, bandwidth, lookback)
    qpos = qpos_i32(qpos)
    valid = rpos < int(PAD_POS)
    neg = torch.tensor(NEG, device=dev)

    # pointer doubling: chain start + edge count for EVERY slot in log2(A)
    # parent-jumping rounds
    iota = torch.arange(a, dtype=torch.int64, device=dev)[None, :].expand(p, a)
    par = torch.where(parent >= 0, parent.to(torch.int64), iota)  # roots self-loop
    cnt = (parent >= 0).to(torch.int32)
    rounds = max(1, int(np.ceil(np.log2(max(a, 2)))))
    for _ in range(rounds):
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
