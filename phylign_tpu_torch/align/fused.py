"""Device-resident align flush: chain -> select -> extend in one program (the
counterpart of ``phylign_tpu/align/fused.py``).

  host:   anchor collection, padded anchor upload, 2-bit ref pool upload
  device: chain DP per anchor bucket (ops.chain, kernel B3) -> per-pair
          candidate selection (primary + split-read segments + s2,
          minimap2's mask_level rules) -> ref window gather from the pooled
          genome buffer -> banded extension score pass (ops.extend, kernel
          B4) -> gapless + full-span checks -> one packed result buffer
  host:   CIGAR/record assembly from the fetched mismatch bitmask; the rare
          gapped / supplementary / trimmed cases go through the engine's
          traceback path (identical records)

Implementations with identical results (every byte of the packed buffer
and of the full cold rows):
  * ``_select_ref`` -> ``_extend_impl`` -> ``_finish_ref`` -> ``_compact_cold``
    in plain PyTorch over the concatenated chain results
    (``_flatten_chains``): the CPU path and the versions the kernels are
    held to.
  * CUDA kernel B6 (csrc/flush_epilogue.cu): ``select_window_cuda`` (B6b,
    a thread's selection per pair reading each bucket's ChainResult
    through cand_map, then a block's 16-byte gathers) -> kernel B4 ->
    ``finish_pack_cuda`` (B6c) -> ``compact_cold_cuda`` (B6c's second
    launch, blocks of 256 rows), each writing straight into its regions of
    the packed buffer; each returns what its plain version returns.
``select_extend`` and ``dist_select_extend`` pick by the tensor's device.
The packed byte buffer has the JAX module's layout byte for byte; only
``_packed_sizes`` and ``_packed_views`` know it (the kernels get region
pointers, engine._fused_finish unpacks through ``_packed_views``).
Selection semantics equal the host path's (engine.flush_pairs_host).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from phylign_tpu_torch.ops import _kernels
from phylign_tpu_torch.ops import extend as ope
from phylign_tpu_torch.ops.extend import SrScoring, _extend_impl, _window_mask

NEG = np.float32(-1e30)

# flag bits in the packed int output (column FLAGS of the ints array)
F_HAS = 1  # a primary candidate passed the chain thresholds
F_DIAG = 2  # extension optimum is realized gaplessly on the end diagonal
F_FULL = 4  # gapless AND untrimmable (full-span Kadane optimum) AND >= -s
F_STRAND = 8  # primary candidate strand (1 = reverse)
F_PRIMTYPE = 16  # primary candidate is a strand-set primary (alt is valid)
F_SUP0 = 32  # supplementary segment s found -> bit (5 + s)
F_PROBE = 128  # s2 > 0: the competitor's coords ride in the cold payload
# for the MAPQ dp_max2 probe extension (mm2 hit.c mm_set_mapq). The flag
# byte caps n_sup at 2 (bits 5-6): flush_pairs_begin routes larger
# max_segments to the host path.

COLD_CAP = 512  # compacted delegation rows shipped with the hot fetch


def pack2bit_flat(a: np.ndarray) -> np.ndarray:
    """[N] uint8 codes (0..3) -> [ceil(N/4)] uint8 (code j in bits 2*(j%4))."""
    npad = (-len(a)) % 4
    if npad:
        a = np.concatenate([a, np.zeros(npad, np.uint8)])
    a4 = a.reshape(-1, 4)
    return a4[:, 0] | (a4[:, 1] << 2) | (a4[:, 2] << 4) | (a4[:, 3] << 6)


def _gather_codes(pool_pack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """2-bit code at flat position idx (any shape) from the packed pool."""
    idxc = idx.clamp(0, pool_pack.shape[0] * 4 - 1)
    byte = pool_pack[(idxc >> 2).to(torch.int64)]
    return (byte >> ((idxc & 3) * 2).to(torch.uint8)) & 3


def _flatten_chains(chains) -> dict[str, torch.Tensor]:
    """Concat per-bucket ChainResults along the set axis + one dummy row
    (index S_tot) whose scores are -inf: candidate gathers for pairs missing
    a strand point there."""

    def cat(field, dummy):
        parts = [getattr(c, field) for c in chains]
        d = torch.full((1,) + tuple(parts[0].shape[1:]), dummy, dtype=parts[0].dtype,
                       device=parts[0].device)
        return torch.cat(parts + [d], dim=0)

    neg = float(NEG)
    return dict(
        score=cat("score", neg),
        count=cat("count", 0),
        qs=cat("qs", 0),
        qe=cat("qe", 0),
        rs=cat("rs", 0),
        re=cat("re", 0),
        alt=cat("alt_score", neg),
        alt_qs=cat("alt_qs", 0),
        alt_qe=cat("alt_qe", 0),
        alt_rs=cat("alt_rs", 0),
        alt_re=cat("alt_re", 0),
        sup_score=cat("sup_score", neg),
        sup_count=cat("sup_count", 0),
        sup_qs=cat("sup_qs", 0),
        sup_qe=cat("sup_qe", 0),
        sup_rs=cat("sup_rs", 0),
        sup_re=cat("sup_re", 0),
    )


def _take_c(arr: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return arr.gather(1, c[:, None].to(torch.int64))[:, 0]


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip with scalar or tensor bounds: min(max(x, lo), hi)."""
    lo = lo if torch.is_tensor(lo) else torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi = hi if torch.is_tensor(hi) else torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


class Selection(NamedTuple):
    """What the selection hands the extension and the packing, per pair."""

    q_codes: torch.Tensor  # uint8 [P, lmax] strand-adjusted query codes
    rwin: torch.Tensor  # uint8 [P, wlen] ref window codes
    rvalid: torch.Tensor  # bool (plain) or uint8 (B6b) [P, wlen] in-contig mask
    lohi: torch.Tensor  # int32 [P, 2] the in-contig window columns [lo, hi)
    head: torch.Tensor  # int32 [P, 4] the hot row before the extension's
    # flag bits (F_DIAG, F_FULL) and end_d; from B6b a view of the packed
    # buffer's hot rows, which finish_pack_cuda completes in place (its
    # returned hot is this view)
    flts: torch.Tensor  # f32 [P, 2] (primary chain score, s2)
    cold_i: torch.Tensor  # int32 [P, 4 + 6*n_out + 5] cold rows
    cold_f: torch.Tensor  # f32 [P, n_out] split-segment scores
    packed: torch.Tensor | None = None  # B6b: the packed buffer head/flts live in


def _select_ref(
    flat: dict[str, torch.Tensor],
    cand_map: torch.Tensor,  # int32 [P, 2] flat set idx (plus, minus); S_tot=none
    pair_base: torch.Tensor,  # int32 [P] pool base offset of the pair's ref
    pair_reflen: torch.Tensor,  # int32 [P] len(ref.codes)
    q_pack: torch.Tensor,  # uint8 [P, ceil(lmax/4)] FORWARD packed queries
    q_len: torch.Tensor,  # int32 [P]
    pool_pack: torch.Tensor,  # uint8 [ceil(pool_len/4)] 2-bit pool codes
    cst: torch.Tensor,  # int32 [C] pool-coord contig starts (sorted, pad=MAX)
    clen: torch.Tensor,  # int32 [C] contig lengths (pad=0)
    *,
    lmax: int,
    wlen: int,
    half: int,
    min_cnt: int,
    min_score: float,
    max_segments: int,
) -> Selection:
    """Candidate selection, window gather and strand-adjusted query in plain
    PyTorch: the CPU path and the version kernel B6b is held to."""
    dev = cand_map.device
    i32 = torch.int32
    p = cand_map.shape[0]
    n_sup = flat["sup_score"].shape[1]
    c_total = 2 * (1 + n_sup)
    neg = torch.tensor(NEG, device=dev)
    zero_f = torch.tensor(0.0, dtype=torch.float32, device=dev)

    # --- candidate tensors [P, C]; order = host insertion order -------------
    # (engine.flush_pairs builds each pair's list as [P+, P-, S+0..,S-0..];
    # its stable sort therefore breaks full-key ties by this order)
    si = cand_map.to(torch.int64)  # [P, 2]

    def gcat(prim_field, sup_field):
        pv = flat[prim_field][si]  # [P, 2]
        sv = flat[sup_field][si]  # [P, 2, n_sup]
        return torch.cat([pv, sv[:, 0], sv[:, 1]], dim=1)  # [P, C]

    c_score = gcat("score", "sup_score")
    c_count = gcat("count", "sup_count")
    c_qs = gcat("qs", "sup_qs")
    c_qe = gcat("qe", "sup_qe")
    c_rs = gcat("rs", "sup_rs")
    c_re = gcat("re", "sup_re")
    # alt (s2 competitor) only exists for strand-set primaries; host clips >=0
    alt2 = torch.maximum(flat["alt"][si], zero_f)  # [P, 2]
    c_alt = torch.cat([alt2, torch.zeros((p, 2 * n_sup), dtype=torch.float32, device=dev)], dim=1)
    strand_row = torch.tensor([0, 1] + [0] * n_sup + [1] * n_sup, dtype=i32, device=dev)
    c_strand = strand_row[None, :].expand(p, c_total)
    c_valid = (c_count >= min_cnt) & (c_score >= torch.tensor(np.float32(min_score), device=dev))

    def lex_select(valid):
        """argmin over candidates of (-score, strand, qs, insertion order):
        iterate ascending c with strict comparisons — first wins ties."""
        has = torch.zeros(p, dtype=torch.bool, device=dev)
        b_sc = torch.full((p,), float(NEG), dtype=torch.float32, device=dev)
        b_st = torch.zeros(p, dtype=i32, device=dev)
        b_qs = torch.zeros(p, dtype=i32, device=dev)
        b_c = torch.zeros(p, dtype=i32, device=dev)
        for c in range(c_total):
            sc, st, qs = c_score[:, c], c_strand[:, c], c_qs[:, c]
            better = valid[:, c] & (
                ~has
                | (sc > b_sc)
                | ((sc == b_sc) & (st < b_st))
                | ((sc == b_sc) & (st == b_st) & (qs < b_qs))
            )
            b_sc = torch.where(better, sc, b_sc)
            b_st = torch.where(better, st, b_st)
            b_qs = torch.where(better, qs, b_qs)
            b_c = torch.where(better, c, b_c)
            has = has | better
        return has, b_c

    has_prim, prim_c = lex_select(c_valid)
    prim_score = _take_c(c_score, prim_c)
    prim_count = _take_c(c_count, prim_c)  # chain anchor count (cm:i)
    prim_strand = _take_c(c_strand, prim_c)
    prim_qs = _take_c(c_qs, prim_c)
    prim_qe = _take_c(c_qe, prim_c)
    prim_rs = _take_c(c_rs, prim_c)
    prim_re = _take_c(c_re, prim_c)
    prim_alt = _take_c(c_alt, prim_c)
    prim_is_primary = prim_c < 2  # strand-set primary (device alt applies)

    def qov_ge_half(aqs, aqe, bqs, bqe):
        """host _qov(a, b) >= 0.5 in exact integer arithmetic."""
        ov = torch.clamp(torch.minimum(aqe, bqe) - torch.maximum(aqs, bqs), min=0)
        span = torch.clamp(torch.minimum(aqe - aqs, bqe - bqs), min=1)
        return 2 * ov >= span

    # s2: best OTHER candidate covering the primary's interval, or the
    # device alt of a strand-set primary (host: max(overlapping rest + alt))
    iota_c = torch.arange(c_total, dtype=i32, device=dev)[None, :]
    others = c_valid & (iota_c != prim_c[:, None])
    ov_ok = qov_ge_half(c_qs, c_qe, prim_qs[:, None], prim_qe[:, None])
    over_sc = torch.where(others & ov_ok, c_score, neg)
    c2 = torch.argmax(over_sc, dim=1)
    s2_cand = _take_c(over_sc, c2)
    alt_term = torch.where(prim_is_primary & has_prim, prim_alt, zero_f)
    s2 = torch.maximum(torch.maximum(s2_cand, alt_term), zero_f)
    s2 = torch.where(has_prim, s2, zero_f)

    # MAPQ dp_max2 probe target: the s2 competitor's region coordinates —
    # the best overlapping candidate, or the chain DP's same-strand alt
    # competitor of the primary's own set; candidate wins ties, matching
    # the host selection rule in engine.flush_pairs_host_grouped
    use_alt = alt_term > torch.maximum(s2_cand, zero_f)
    sidx = prim_c.clamp(0, 1)

    def take_s(arr):
        return _take_c(arr[si], sidx)

    probe_strand = torch.where(use_alt, prim_strand, _take_c(c_strand, c2))
    probe_qs = torch.where(use_alt, take_s(flat["alt_qs"]), _take_c(c_qs, c2))
    probe_qe = torch.where(use_alt, take_s(flat["alt_qe"]), _take_c(c_qe, c2))
    probe_rs = torch.where(use_alt, take_s(flat["alt_rs"]), _take_c(c_rs, c2))
    probe_re = torch.where(use_alt, take_s(flat["alt_re"]), _take_c(c_re, c2))
    has_probe = s2 > 0.0

    # supplementary segments: greedy best candidate mostly-disjoint from
    # every previously picked segment (mask_level 0.5; host loop order)
    taken = iota_c == prim_c[:, None]
    picked = [(prim_qs, prim_qe, has_prim)]
    sup_out = []
    for _s in range(max_segments - 1):
        blocked = torch.zeros((p, c_total), dtype=torch.bool, device=dev)
        for pqs, pqe, plive in picked:
            ov = qov_ge_half(c_qs, c_qe, pqs[:, None], pqe[:, None])
            blocked = blocked | (ov & plive[:, None])
        okc = c_valid & ~taken & ~blocked & has_prim[:, None]
        found, ch = lex_select(okc)
        sup_out.append(
            dict(
                found=found,
                score=_take_c(c_score, ch),
                strand=_take_c(c_strand, ch),
                qs=_take_c(c_qs, ch),
                qe=_take_c(c_qe, ch),
                rs=_take_c(c_rs, ch),
                re=_take_c(c_re, ch),
                count=_take_c(c_count, ch),
            )
        )
        taken = taken | ((iota_c == ch[:, None]) & found[:, None])
        picked.append((_take_c(c_qs, ch), _take_c(c_qe, ch), found))

    # --- primary extension: window gather + banded score pass ---------------
    rs_c = _clip(prim_rs, 0, pair_reflen - 1) + pair_base
    ci = torch.searchsorted(cst, rs_c, right=True, out_int32=True) - 1
    ci_l = ci.to(torch.int64)
    c_start = cst[ci_l]
    c_end = c_start + clen[ci_l]
    w0 = pair_base + prim_rs - prim_qs - half
    lo = _clip(c_start - w0, 0, wlen)
    hi = _clip(c_end - w0, 0, wlen)
    win_idx = w0[:, None] + torch.arange(wlen, dtype=i32, device=dev)[None, :]
    rwin = _gather_codes(pool_pack, win_idx)  # [P, wlen] uint8
    # reverse complement computed on the device from the forward codes
    fwd_q = ope._unpack2bit(q_pack, lmax)
    col_q = torch.arange(lmax, dtype=i32, device=dev)[None, :]
    ridx = _clip(q_len[:, None] - 1 - col_q, 0, lmax - 1)
    rcv = torch.where(
        col_q < q_len[:, None],
        (3 - fwd_q.gather(1, ridx.to(torch.int64))).to(torch.uint8),
        torch.zeros((), dtype=torch.uint8, device=dev),
    )
    q_codes = torch.where((prim_strand == 1)[:, None], rcv, fwd_q).contiguous()

    # --- the selection's share of the packed rows: the hot row without the
    # extension's bits (diag, full, end_d), the scores, the cold payload
    flags = (
        has_prim.to(i32) * F_HAS
        | prim_strand.to(i32) * F_STRAND
        | prim_is_primary.to(i32) * F_PRIMTYPE
    )
    for s, so in enumerate(sup_out):
        flags = flags | so["found"].to(i32) * (F_SUP0 << s)
    flags = flags | has_probe.to(i32) * F_PROBE
    head = torch.stack([(w0 - c_start), ci, flags, prim_count], dim=1).to(i32)
    flts = torch.stack([prim_score, s2], dim=1)
    cold_ints = [prim_qs, prim_qe, prim_rs, prim_re]
    for so in sup_out:
        cold_ints += [so["strand"], so["qs"], so["qe"], so["rs"], so["re"], so["count"]]
    # probe coords last (base column 4 + 6*n_sup, read by _fused_finish)
    cold_ints += [probe_strand, probe_qs, probe_qe, probe_rs, probe_re]
    cold_i = torch.stack(cold_ints, dim=1).to(i32)
    cold_f = (
        torch.stack([so["score"] for so in sup_out], dim=1)
        if sup_out
        else torch.zeros((p, 0), dtype=torch.float32, device=dev)
    )
    return Selection(
        q_codes=q_codes, rwin=rwin.contiguous(), rvalid=_window_mask(lo, hi, wlen),
        lohi=torch.stack([lo, hi], dim=1).to(i32), head=head, flts=flts,
        cold_i=cold_i, cold_f=cold_f,
    )


def _finish_ref(
    sel: Selection,
    q_len: torch.Tensor,  # int32 [P]
    ext_score: torch.Tensor,  # f32 [P] (kernel B4's score pass)
    end_d: torch.Tensor,  # int32 [P]
    scoring: SrScoring,
    zdrop: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gapless, Kadane and z-drop checks after the extension, in plain
    PyTorch: (hot int32 [P, 4], big-endian mismatch bits uint8 [P, lmax /
    8]). The CPU path and the version kernel B6c is held to."""
    q_codes, rwin = sel.q_codes, sel.rwin
    lo, hi = sel.lohi[:, 0], sel.lohi[:, 1]
    p, lmax = q_codes.shape
    dev = q_codes.device
    i32 = torch.int32

    # --- gapless + full-span checks (device twins of engine._extend_finish) -
    cols = end_d[:, None] + torch.arange(lmax, dtype=i32, device=dev)[None, :]
    rseg = rwin.gather(1, cols.to(torch.int64))
    in_q = torch.arange(lmax, dtype=i32, device=dev)[None, :] < q_len[:, None]
    vseg = (cols >= lo[:, None]) & (cols < hi[:, None]) | ~in_q
    neq_mask = (q_codes != rseg) & in_q
    neq = neq_mask.sum(dim=1, dtype=i32)
    m_s, x_s = scoring.match, scoring.mismatch
    best_gapless = m_s * (q_len - neq) - x_s * neq
    ext_i = ext_score.clamp(-1e9, 1e9).to(i32)
    diag_ok = vseg.all(dim=1) & (best_gapless == ext_i)
    full = diag_ok & (best_gapless >= scoring.min_dp_score)
    # the full interval is the unique Kadane optimum iff every proper
    # prefix/suffix scores strictly positive; minima occur at mismatches
    step = m_s + x_s
    cum = torch.cumsum(neq_mask.to(i32), dim=1, dtype=i32)
    col_i = torch.arange(lmax, dtype=i32, device=dev)[None, :]
    prefv = m_s * (col_i + 1) - step * cum
    sufv = m_s * (q_len[:, None] - col_i) - step * (neq[:, None] - cum + 1)
    big = torch.tensor(2**30, dtype=i32, device=dev)
    min_pref = torch.where(neq_mask, prefv, big).amin(dim=1)
    min_suf = torch.where(neq_mask, sufv, big).amin(dim=1)
    full = full & ((neq == 0) | ((min_pref > 0) & (min_suf > 0)))
    # internal z-drop twin (engine._extend_finish): a > zdrop fall from a
    # running peak fails the fast path. Peaks sit just before mismatch
    # columns, valleys just after.
    r_before = m_s * col_i - step * (cum - 1)
    runpeak = torch.cummax(torch.where(neq_mask, r_before, -big), dim=1).values
    dropmax = torch.where(neq_mask, runpeak - prefv, -big).amax(dim=1)
    full = full & (dropmax <= zdrop)

    flags = sel.head[:, 2] | diag_ok.to(i32) * F_DIAG | full.to(i32) * F_FULL
    hot = torch.cat([sel.head[:, :2], (flags | (end_d << 8))[:, None], sel.head[:, 3:]], dim=1).to(i32)
    # mismatch bitmask packed big-endian to match np.unpackbits on the host
    bits = neq_mask.reshape(p, lmax // 8, 8).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=dev)
    neq_pack = (bits * weights[None, None, :]).sum(dim=2).to(torch.uint8)
    return hot, neq_pack


def _select_extend_core(
    flat: dict[str, torch.Tensor],
    cand_map: torch.Tensor,
    pair_base: torch.Tensor,
    pair_reflen: torch.Tensor,
    q_pack: torch.Tensor,
    q_len: torch.Tensor,
    pool_pack: torch.Tensor,
    cst: torch.Tensor,
    clen: torch.Tensor,
    *,
    lmax: int,
    wlen: int,
    half: int,
    scoring: SrScoring,
    min_cnt: int,
    min_score: float,
    max_segments: int,
    zdrop: int,
):
    """The plain flush epilogue around the extension: _select_ref, the score
    pass (_extend_impl) and _finish_ref. Returns (hot, flts, neq_pack,
    (cold_i, cold_f))."""
    sel = _select_ref(
        flat, cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen,
        lmax=lmax, wlen=wlen, half=half, min_cnt=min_cnt, min_score=min_score,
        max_segments=max_segments,
    )
    ext = _extend_impl(sel.q_codes, q_len, sel.rwin, sel.rvalid, scoring, False)
    hot, neq_pack = _finish_ref(sel, q_len, ext.score, ext.end_d, scoring, zdrop)
    return hot, sel.flts, neq_pack, (sel.cold_i, sel.cold_f)


def _compact_cold(hot, cold_i, cold_f):
    """Compact the needed cold rows (gapped primary OR any supplementary or
    probe, read from the hot flag word) into COLD_CAP slots shipped with the
    hot fetch. Overflow (> COLD_CAP needed rows) is detected on the host
    from the flags, which then fetches the full cold arrays."""
    flags = hot[:, 2]
    sup_bits = ~(F_SUP0 - 1)  # any bit >= F_SUP0
    gapped = ((flags & F_HAS) != 0) & ((flags & F_FULL) == 0)
    need = gapped | ((flags & (0xFF & sup_bits)) != 0)
    rank = torch.cumsum(need.to(torch.int32), dim=0, dtype=torch.int32) - 1
    pos = torch.where(need & (rank < COLD_CAP), rank, COLD_CAP).to(torch.int64)
    # row COLD_CAP takes every dropped row and is cut off
    ci = torch.zeros((COLD_CAP + 1, cold_i.shape[1]), dtype=torch.int32, device=hot.device)
    cf = torch.zeros((COLD_CAP + 1, cold_f.shape[1]), dtype=torch.float32, device=hot.device)
    ci.index_copy_(0, pos, cold_i)
    cf.index_copy_(0, pos, cold_f)
    return ci[:COLD_CAP], cf[:COLD_CAP]


def _bitcast_u8(a: torch.Tensor) -> torch.Tensor:
    """Flatten any int32/float32/uint8 tensor to its little-endian bytes."""
    a = a.contiguous()
    if a.dtype == torch.uint8:
        return a.reshape(-1)
    return a.view(torch.uint8).reshape(-1)


def _packed_sizes(p: int, lmax: int, n_out: int) -> tuple[int, ...]:
    """The packed buffer's regions in bytes, in order: hot int32 [P, 4],
    flts f32 [P, 2], mismatch bits u8 [P, lmax / 8], compacted cold int32
    [COLD_CAP, 4 + 6*n_out + 5] and f32 [COLD_CAP, n_out]."""
    ci_cols = 4 + 6 * n_out + 5
    return 16 * p, 8 * p, p * (lmax // 8), 4 * COLD_CAP * ci_cols, 4 * COLD_CAP * n_out


def _packed_views(packed: torch.Tensor, p: int, lmax: int, n_out: int):
    """(hot, flts, neq_pack, cc_i, cc_f) as views of the packed buffer (the
    regions of ``_packed_sizes``): what the kernels write into and
    engine._fused_finish reads."""
    ci_cols = 4 + 6 * n_out + 5
    hot, flts, neq, cc_i, cc_f = torch.split(packed, _packed_sizes(p, lmax, n_out))
    return (
        hot.view(torch.int32).view(p, 4),
        flts.view(torch.float32).view(p, 2),
        neq.view(p, lmax // 8),
        cc_i.view(torch.int32).view(COLD_CAP, ci_cols),
        cc_f.view(torch.float32).view(COLD_CAP, n_out),
    )


# --- hand-written CUDA kernel B6 (csrc/flush_epilogue.cu) ----------------------

_launches = _kernels.LaunchCounts("select_window", "finish_pack", "compact_cold")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return _launches.snapshot()


def reset_launch_counts() -> None:
    _launches.reset()


#: anchor buckets (ChainResults) one B6b launch reads through its table
MAX_BUCKETS = 8
#: split segments B6b takes, per anchor set and per pair: the flag byte has
#: two segment bits (flush_pairs_begin sends larger max_segments to the host)
MAX_SUP = 2


def _need(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(msg)


def select_window_cuda(
    chains,
    cand_map,
    pair_base,
    pair_reflen,
    q_pack,
    q_len,
    pool_pack,
    cst,
    clen,
    *,
    lmax: int,
    wlen: int,
    half: int,
    min_cnt: int,
    min_score: float,
    max_segments: int,
) -> Selection:
    """Kernel B6b (replaces the selection and window gather of
    ``phylign_tpu/align/fused.py:_select_extend_core``). CUDA tensors only;
    the same Selection as _select_ref over ``_flatten_chains(chains)``
    (rvalid as uint8), with head and flts written into a new packed buffer
    (``Selection.packed``). Raises for more than MAX_SUP split segments."""
    chains = tuple(chains)
    dev = cand_map.device
    ins = (cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen)
    _need(dev.type == "cuda" and all(t.device == dev for t in ins),
          f"select_window runs on CUDA tensors on one device; got cand_map on {dev}")
    _need(1 <= len(chains) <= MAX_BUCKETS, f"select_window: {len(chains)} chain buckets (1..{MAX_BUCKETS})")
    p = cand_map.shape[0]
    n_sup = chains[0].sup_score.shape[1]
    n_out = max(0, max_segments - 1)
    _need(n_sup <= MAX_SUP and n_out <= MAX_SUP,
          f"select_window takes at most {MAX_SUP} split segments; got n_sup {n_sup}, "
          f"max_segments {max_segments}")
    _need(cand_map.shape == (p, 2) and pair_base.shape == (p,) and pair_reflen.shape == (p,)
          and q_len.shape == (p,) and q_pack.shape == (p, -(-lmax // 4)) and cst.shape == clen.shape
          and cst.dim() == 1 and cst.numel() >= 1 and pool_pack.dim() == 1 and pool_pack.numel() >= 1,
          "select_window: shapes of cand_map, pair_base, pair_reflen, q_len, q_pack, cst, clen, pool_pack")
    _need(all(t.dtype == torch.int32 for t in (cand_map, pair_base, pair_reflen, q_len, cst, clen))
          and q_pack.dtype == torch.uint8 and pool_pack.dtype == torch.uint8,
          "select_window takes int32 indices and uint8 codes", TypeError)
    _need(all(t.is_contiguous() for t in ins), "select_window takes contiguous tensors")
    fields, rows = [], []
    for c in chains:
        for name, t in zip(c._fields, c):
            _need(t.device == dev and t.is_contiguous() and t.shape[0] == c.score.shape[0]
                  and (t.dim() == 1 if not name.startswith("sup_") else t.shape[1:] == (n_sup,))
                  and t.dtype == (torch.float32 if name.endswith("score") else torch.int32),
                  f"select_window: chain field {name} must be a contiguous "
                  f"{'f32' if name.endswith('score') else 'int32'} tensor on {dev}")
            fields.append(t.data_ptr())
        rows.append(c.score.shape[0])
    u8, i32 = torch.uint8, torch.int32
    ci_cols = 4 + 6 * n_out + 5
    q_codes = torch.empty((p, lmax), dtype=u8, device=dev)
    rwin = torch.empty((p, wlen), dtype=u8, device=dev)
    rvalid = torch.empty((p, wlen), dtype=u8, device=dev)
    lohi = torch.empty((p, 2), dtype=i32, device=dev)
    cold_i = torch.empty((p, ci_cols), dtype=i32, device=dev)
    cold_f = torch.empty((p, n_out), dtype=torch.float32, device=dev)
    packed = torch.empty(sum(_packed_sizes(p, lmax, n_out)), dtype=u8, device=dev)
    hot, flts = _packed_views(packed, p, lmax, n_out)[:2]
    if p:
        _kernels.launch(
            _launches, "select_window", "flush_epilogue", "phylign_select_window",
            (ctypes.c_void_p * len(fields))(*fields), (ctypes.c_int * len(rows))(*rows),
            len(chains), n_sup, cand_map, pair_base, pair_reflen, q_pack, q_pack.shape[1], q_len,
            pool_pack, pool_pack.numel(), cst, clen, cst.numel(), p, lmax, wlen, int(half),
            int(min_cnt), float(np.float32(min_score)), n_out, q_codes, rwin, rvalid, lohi,
            hot, flts, cold_i, cold_f,
        )
    return Selection(q_codes, rwin, rvalid, lohi, hot, flts, cold_i, cold_f, packed)


def finish_pack_cuda(
    sel: Selection, q_len, ext_score, end_d, scoring: SrScoring, zdrop: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6c (replaces the checks and packing of
    ``phylign_tpu/align/fused.py:_select_extend_core`` after its extension):
    (hot, neq_pack) equal to _finish_ref's, as views of ``sel.packed``. It
    ORs F_DIAG, F_FULL and end_d into the hot rows in place (``sel.head``
    is the returned hot) and writes the mismatch bits. CUDA tensors from
    select_window_cuda (q_codes 8-byte aligned); lmax a multiple of 32;
    integer scoring."""
    p, lmax = sel.q_codes.shape
    wlen = sel.rwin.shape[1]
    dev = sel.q_codes.device
    _need(sel.packed is not None and dev.type == "cuda"
          and all(t.device == dev for t in (q_len, ext_score, end_d)),
          "finish_pack runs on a CUDA Selection from select_window_cuda")
    _need(lmax % 32 == 0 and wlen >= lmax, f"finish_pack: lmax {lmax} must be a multiple of 32, wlen >= lmax")
    _need(sel.q_codes.is_contiguous() and sel.q_codes.data_ptr() % 8 == 0,
          "finish_pack reads q_codes rows 8 bytes a lane: contiguous and 8-byte aligned")
    _need(ext_score.dtype == torch.float32 and end_d.dtype == torch.int32 and q_len.dtype == torch.int32
          and ext_score.shape == end_d.shape == q_len.shape == (p,)
          and all(t.is_contiguous() for t in (q_len, ext_score, end_d)),
          "finish_pack takes contiguous f32 ext_score, int32 end_d and q_len [P]")
    vals = (scoring.match, scoring.mismatch, scoring.min_dp_score, zdrop)
    _need(all(float(v).is_integer() and abs(v) < 2**31 for v in vals),
          f"finish_pack takes integer scoring, min_dp_score and zdrop; got {vals}")
    hot, _, neq_pack = _packed_views(sel.packed, p, lmax, sel.cold_f.shape[1])[:3]
    if p:
        _kernels.launch(
            _launches, "finish_pack", "flush_epilogue", "phylign_finish_pack",
            sel.q_codes, q_len, sel.rwin, sel.lohi, ext_score, end_d, p, lmax, wlen,
            *[int(v) for v in vals], hot, neq_pack,
        )
    return hot, neq_pack


def compact_cold_cuda(sel: Selection) -> tuple[torch.Tensor, torch.Tensor]:
    """B6c's second launch (replaces ``phylign_tpu/align/fused.py:
    _compact_cold``): (cc_i, cc_f) equal to _compact_cold of the hot rows,
    written into and returned as views of ``sel.packed``. Runs after
    finish_pack_cuda."""
    p, lmax = sel.q_codes.shape
    n_out = sel.cold_f.shape[1]
    _need(sel.packed is not None and sel.packed.device.type == "cuda",
          "compact_cold runs on a CUDA Selection from select_window_cuda")
    hot, _, _, cc_i, cc_f = _packed_views(sel.packed, p, lmax, n_out)
    if p:
        _kernels.launch(
            _launches, "compact_cold", "flush_epilogue", "phylign_compact_cold",
            hot, sel.cold_i, sel.cold_f, p, n_out, COLD_CAP, cc_i, cc_f,
        )
    return cc_i, cc_f


def _select_extend_cuda(
    chains, cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen,
    *, scoring: SrScoring, zdrop: int, **kw,
):
    """B6b -> B4 -> B6c, the card's twin of _select_extend_core: returns its
    (hot, flts, neq_pack, (cold_i, cold_f)) and the Selection, whose packed
    buffer holds the first three (compact_cold_cuda adds the rest)."""
    sel = select_window_cuda(
        chains, cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen, **kw,
    )
    ext = _extend_impl(sel.q_codes, q_len, sel.rwin, sel.rvalid, scoring, False)
    hot, neq_pack = finish_pack_cuda(sel, q_len, ext.score, ext.end_d, scoring, zdrop)
    return (hot, sel.flts, neq_pack, (sel.cold_i, sel.cold_f)), sel


def select_extend(
    chains,
    cand_map,
    pair_base,
    pair_reflen,
    q_pack,
    q_len,
    pool_pack,
    cst,
    clen,
    *,
    lmax: int,
    wlen: int,
    half: int,
    scoring: SrScoring,
    min_cnt: int,
    min_score: float,
    max_segments: int,
    zdrop: int = 100,
    pack: bool = False,
):
    """Single-device fused selection + extension over per-bucket chain
    results (device tensors from ops.chain, never fetched). Returns
    (hot, flts, neq_pack, cold_compact, cold_full); callers fetch the first
    four together and cold_full only on compaction overflow.

    ``pack=True`` instead returns (packed_u8, cold_full) with hot / flts /
    neq / compacted-cold as ONE 1-D byte buffer (the JAX module's layout):
    one copy to the host per chunk, which engine._fused_finish unpacks by
    fixed offsets. A CPU cand_map runs the plain versions, a CUDA one
    kernel B6 around B4; any other device raises."""
    ins = (cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen)
    kw = dict(lmax=lmax, wlen=wlen, half=half, min_cnt=min_cnt, min_score=min_score,
              max_segments=max_segments)
    if cand_map.device.type == "cuda":
        (hot, flts, neq_pack, cold), sel = _select_extend_cuda(chains, *ins, scoring=scoring,
                                                               zdrop=zdrop, **kw)
        cc = compact_cold_cuda(sel)
        return (sel.packed, cold) if pack else (hot, flts, neq_pack, cc, cold)
    if cand_map.device.type != "cpu":
        raise ValueError(f"no flush kernel for device {cand_map.device}")
    hot, flts, neq_pack, cold = _select_extend_core(
        _flatten_chains(chains), *ins, scoring=scoring, zdrop=zdrop, **kw,
    )
    cc_i, cc_f = _compact_cold(hot, *cold)
    if not pack:
        return hot, flts, neq_pack, (cc_i, cc_f), cold
    packed = torch.cat([_bitcast_u8(a) for a in (hot, flts, neq_pack, cc_i, cc_f)])
    return packed, cold


def dist_select_extend(
    mesh,
    chains,
    cand_map,
    pair_base,
    pair_reflen,
    q_pack,
    q_len,
    pool_pack,
    cst,
    clen,
    *,
    lmax: int,
    wlen: int,
    half: int,
    scoring: SrScoring,
    min_cnt: int,
    min_score: float,
    max_segments: int,
    zdrop: int = 100,
):
    """Mesh twin of select_extend: the pair-axis arrays are split over the
    query axis; the (small) per-set chain outputs, concatenated over the
    query axis by parallel.dist.dist_chain, go whole to every query shard
    so each can gather any pair's candidates; the genome pool and the
    contig table are replicated. Returns (hot, flts, neq_pack, (cold_i,
    cold_f)) concatenated over the query axis on the mesh's home device.
    The cold rows are not compacted: the caller fetches the full cold
    arrays. A shard on a card runs kernel B6 around B4, on the CPU the
    plain versions."""
    from phylign_tpu_torch.parallel.dist import over_q
    from phylign_tpu_torch.parallel.mesh import AXIS_QUERY

    on_dev: dict = {}
    kw = dict(lmax=lmax, wlen=wlen, half=half, min_cnt=min_cnt, min_score=min_score,
              max_segments=max_segments)

    def step(*ins):
        dev = ins[0].device
        if dev.type == "cuda":
            if dev not in on_dev:  # every set's chains on this shard's card
                on_dev[dev] = tuple(type(c)(*[t.to(dev) for t in c]) for c in chains)
            out, _ = _select_extend_cuda(on_dev[dev], *ins, scoring=scoring, zdrop=zdrop, **kw)
        else:
            if dev not in on_dev:  # the gather of every set's chains
                on_dev[dev] = {k: v.to(dev) for k, v in _flatten_chains(chains).items()}
            out = _select_extend_core(on_dev[dev], *ins, scoring=scoring, zdrop=zdrop, **kw)
        hot, flts, neq_pack, (cold_i, cold_f) = out
        return hot, flts, neq_pack, cold_i, cold_f

    pair = (AXIS_QUERY,)
    hot, flts, neq_pack, cold_i, cold_f = over_q(
        mesh, step,
        (cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen),
        (pair, pair, pair, pair, pair, (None,), (None,), (None,)),
    )
    return hot, flts, neq_pack, (cold_i, cold_f)
