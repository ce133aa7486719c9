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

Everything here but the two scans is torch ops on the device. The packed
byte buffer has the JAX module's layout byte for byte: engine._fused_finish
unpacks it by fixed offsets. Selection semantics equal the host path's
(engine.flush_pairs_host).
"""

from __future__ import annotations

import numpy as np
import torch

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


def _select_extend_core(
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
    scoring: SrScoring,
    min_cnt: int,
    min_score: float,
    max_segments: int,
    zdrop: int,
):
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
    ext_res = _extend_impl(
        q_codes, q_len, rwin.contiguous(), _window_mask(lo, hi, wlen), scoring, False
    )
    ext_score, end_d = ext_res.score, ext_res.end_d

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

    # --- pack outputs: a small HOT payload fetched every flush + a COLD
    # payload (delegation coordinates: gapped primaries, supplementary
    # segments) of which the needed rows ride along compacted
    flags = (
        has_prim.to(i32) * F_HAS
        | diag_ok.to(i32) * F_DIAG
        | full.to(i32) * F_FULL
        | prim_strand.to(i32) * F_STRAND
        | prim_is_primary.to(i32) * F_PRIMTYPE
    )
    for s, so in enumerate(sup_out):
        flags = flags | so["found"].to(i32) * (F_SUP0 << s)
    flags = flags | has_probe.to(i32) * F_PROBE
    hot = torch.stack([(w0 - c_start), ci, flags | (end_d << 8), prim_count], dim=1).to(i32)
    flts = torch.stack([prim_score, s2], dim=1)
    # mismatch bitmask packed big-endian to match np.unpackbits on the host
    bits = neq_mask.reshape(p, lmax // 8, 8).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=dev)
    neq_pack = (bits * weights[None, None, :]).sum(dim=2).to(torch.uint8)
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
    return hot, flts, neq_pack, (cold_i, cold_f)


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
    fixed offsets."""
    hot, flts, neq_pack, cold = _select_extend_core(
        _flatten_chains(chains),
        cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack,
        cst, clen,
        lmax=lmax, wlen=wlen, half=half, scoring=scoring,
        min_cnt=min_cnt, min_score=min_score, max_segments=max_segments,
        zdrop=zdrop,
    )
    cc_i, cc_f = _compact_cold(hot, *cold)
    if not pack:
        return hot, flts, neq_pack, (cc_i, cc_f), cold
    packed = torch.cat([_bitcast_u8(a) for a in (hot, flts, neq_pack, cc_i, cc_f)])
    return packed, cold
