"""Kernel B6, the fused flush epilogue (``csrc/flush_epilogue.cu``), on the
CPU: a numpy emulation of each of its four kernels' own algorithm (B6a's
warp a set, 8 sets a block, with pointer doubling by shuffles or through
the warp's shared slice, redux argmaxes and field rows written as runs of
sets, and its block kernel past 256 slots; B6b's blocks of 32 pairs, a
thread's selection read through the chain table and its 16-byte chunks of
window, mask and query; B6c's warp with 8 columns a lane, the window from
aligned words, exclusive lane scans and a loop over each lane's mismatch
bits, tile by tile; and the compaction's blocks, each ranking its rows
after counting every flag before them),
held to the plain PyTorch versions (``ops/chain._chain_tail_ref``,
``align/fused._select_ref`` / ``_finish_ref`` / ``_compact_cold``) on the
inputs of the fused flush of tests/test_torch_fused.py's pool, and to the
JAX package's ``chain_anchors`` / ``select_extend`` on inputs made from a
numpy seed. Tolerance: exact (0 difference; whole byte buffers, padding
rows included)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import PORT, mixed_pool

from phylign_tpu.align import fused as jfz
from phylign_tpu.ops import chain as jchain
from phylign_tpu_torch import testing as T
from phylign_tpu_torch.align import engine as tae
from phylign_tpu_torch.align import fused as tfz
from phylign_tpu_torch.ops import chain as tchain
from phylign_tpu_torch.ops import extend as ope

NEG = np.float32(-1e30)
BIG = 1 << 30


def w(x):
    """int32 with torch's wrap-around."""
    return np.asarray(x, np.int64).astype(np.int32)


def u16(q):
    return q.view(np.uint16) if q.dtype == np.int16 else q


# --- B6a: a warp per anchor set (a block per set past 256 slots) ---------------


def cu_constant(name):
    """A ``constexpr int`` of csrc/flush_epilogue.cu: the emulation takes the
    kernel's geometry from its source."""
    src = (Path(tchain.__file__).resolve().parents[1] / "csrc" / "flush_epilogue.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


WARP_MAX_SLOTS, WARP_SETS = cu_constant("kWarpMaxSlots"), cu_constant("kWarpSets")
INF32 = np.float32(np.inf)


def fkey(x):
    """The kernel's order-preserving int32 key of f32 values (-0 as +0)."""
    b = np.asarray(x, np.float32).view(np.int32).copy()
    b[b == np.int32(-(2**31))] = 0
    return np.where(b >= 0, b, b ^ np.int32(0x7FFFFFFF))


def redux_argmax(keys, slots):
    """redux.sync: the largest of the lanes' keys, then the smallest slot
    among the lanes holding it."""
    top = keys.max()
    return int(np.where(keys == top, slots, 2**31 - 1).min())


def emu_chain_select_warp(f, parent, rpos, qpos, k, n_sup):
    """B6a's warp kernel block by block: 8 sets a block, a warp a set; lane
    l holds slots 32 s + l (s < N, N the power of two >= A / 32) as [N, 32]
    arrays, a slot past A f = -inf and padding. Pointer doubling by
    shuffles at N = 1, else through the warp's shared slice of packed
    (root | count << 16) words, every lane reading before any writes; qs
    by a shuffle or the slice. Each argmax: every lane's first strict
    maximum of its own slots' keys (f's order keys, taken once; -1e30's
    for a masked slot), then redux.sync; the winner's lane stages its own
    values (fields 0-10 at field * 8 + warp, split segment
    n of field x at 88 + (x * 8 + warp) * n_sup + n) and broadcasts what
    the next pass needs. Then the block writes each field row's run of its
    nw <= 8 sets into the int32 [11 + 6 n_sup, P] buffer, which is split
    into fields as chain_select_cuda does."""
    p, a = rpos.shape
    n = 1 << max(0, int(np.ceil(np.log2(-(-a // 32)))))
    lane = np.arange(32)
    slot = 32 * np.arange(n)[:, None] + lane[None, :]
    real = slot < a
    q_all = u16(qpos).astype(np.int64)
    buf = np.zeros((11 + 6 * n_sup) * p, np.int32)
    run = WARP_SETS * n_sup

    def bits(v):
        return int(np.float32(v).view(np.int32))

    for set0 in range(0, p, WARP_SETS):
        stage = np.zeros((11 + 6 * n_sup) * WARP_SETS, np.int32)
        for warp in range(min(WARP_SETS, p - set0)):
            s = set0 + warp
            idx = np.minimum(slot, a - 1)
            fv = np.where(real, f[s][idx], -INF32).astype(np.float32)
            rp = np.where(real, rpos[s][idx].astype(np.int64), int(tchain.PAD_POS))
            qv = np.where(real, q_all[s][idx], 0)
            pa = np.where(real, parent[s][idx].astype(np.int64), -1)
            par = np.where(pa >= 0, np.minimum(pa, a - 1), slot)
            cnt = (pa >= 0).astype(np.int64)
            if n == 1:  # c = shfl(cnt, par); par = shfl(par, par)
                for _ in range(tchain.doubling_rounds(a)):
                    par, cnt = par[0][par], cnt + cnt[0][par]
            else:
                smem = (par | cnt << 16).reshape(-1)
                for _ in range(tchain.doubling_rounds(a)):
                    nx = smem[par]  # every lane reads ...
                    par, cnt = nx & 0xFFFF, cnt + (nx >> 16)
                    smem = (par | cnt << 16).reshape(-1)  # ... then writes its own
            qs = qv.reshape(-1)[par]
            qe = w(qv + k).astype(np.int64)
            rs_root = rp.reshape(-1)[par]

            kf, key_neg = fkey(fv), int(fkey(NEG))  # a slot past A: -inf's key, the least

            def argmax(keys):
                first = keys.argmax(axis=0)  # each lane's first strict maximum
                return redux_argmax(keys[first, lane], slot[first, lane])

            def masked(take):  # a real slot's key: f's where take, else -1e30's
                return np.where(real & ~take, key_neg, kf)

            def ov_ok(sqs, sqe):
                ov = np.maximum(w(np.minimum(qe, sqe) - np.maximum(qs, sqs)), 0)
                span = np.minimum(w(qe - qs), w(sqe - sqs))
                return ov.astype(np.float32) >= np.float32(0.5) * span.astype(np.float32)

            def own(x, e):  # the winner's lane's value of its slot e
                return x[e >> 5, e & 31]

            def fields(e, v):  # score, count, qs, qe, rs, re of slot e
                return [bits(v), int(own(cnt, e)) + 1, own(qs, e), own(qe, e), own(rs_root, e), w(own(rp, e) + k)]

            e1 = argmax(kf)
            score1 = own(fv, e1)
            for x, val in enumerate(fields(e1, score1)):
                stage[x * WARP_SETS + warp] = val
            ov = ov_ok(own(qs, e1), own(qe, e1)) & (score1 > 0)
            valid = rp < int(tchain.PAD_POS)
            alt = ov & valid & (par != own(par, e1))
            blocked = ov | ~valid
            e2 = argmax(masked(alt))
            for x_, val in zip((6, 7, 8, 9, 10), np.delete(fields(e2, own(fv, e2) if own(alt, e2) else NEG), 1)):
                stage[x_ * WARP_SETS + warp] = val
            for j in range(n_sup):
                e = argmax(masked(~blocked))
                v = NEG if own(blocked, e) else own(fv, e)
                o = 11 * WARP_SETS + warp * n_sup + j
                for x_, val in enumerate(fields(e, v)):
                    stage[o + x_ * run] = val
                if v > 0:
                    blocked = blocked | ov_ok(own(qs, e), own(qe, e)) | (slot == e)
        nw = min(WARP_SETS, p - set0)
        for t in range(11 * nw):
            r = t // nw
            buf[r * p + set0 + t - r * nw] = stage[r * WARP_SETS + t - r * nw]
        for t in range(6 * nw * n_sup):
            r = t // (nw * n_sup)
            buf[(11 + r * n_sup) * p + set0 * n_sup + t - r * nw * n_sup] = stage[11 * WARP_SETS + r * run + t
                                                                                    - r * nw * n_sup]
    rows, sups = buf[: 11 * p].reshape(11, p), buf[11 * p :].reshape(6, p, n_sup)
    out = dict(zip(T.CHAIN_FIELDS[:11], rows))
    out.update(zip(T.CHAIN_FIELDS[11:], sups))
    for c in ("score", "alt_score", "sup_score"):
        out[c] = out[c].view(np.float32)
    return out


def emu_chain_select_block(f, parent, rpos, qpos, k, n_sup):
    """B6a's block kernel, one block per anchor set of more than 256 slots:
    pointer doubling (root and count both read from the previous round;
    uint16 in shared memory up to 8,192 slots, int32 in the device
    workspace above), then each pass's threads scanning slots t, t+T, ...
    for their first strict maximum, combined by (larger value, smaller
    index)."""
    p, a = rpos.shape
    nt = 256 if a >= 256 else -(-a // 32) * 32
    it = np.uint16 if a <= 8192 else np.int32
    q_all = u16(qpos).astype(np.int64)
    out = {n: np.zeros(p, np.float32 if n.endswith("score") else np.int32) for n in T.CHAIN_FIELDS[:11]}
    for n in T.CHAIN_FIELDS[11:]:
        out[n] = np.zeros((p, n_sup), np.float32 if n == "sup_score" else np.int32)
    for s in range(p):
        sf, rp, qp, pa = f[s], rpos[s].astype(np.int64), q_all[s], parent[s].astype(np.int64)
        par = np.where(pa >= 0, np.minimum(pa, a - 1), np.arange(a)).astype(it)
        cnt = (pa >= 0).astype(it)
        for _ in range(tchain.doubling_rounds(a)):
            par, cnt = par[par], (cnt + cnt[par]).astype(it)
        root = par.astype(np.int64)
        qs_all, qe_all = qp[root], w(qp + k).astype(np.int64)

        def ov_ok(sqs, sqe):
            ov = np.maximum(w(np.minimum(qe_all, sqe) - np.maximum(qs_all, sqs)), 0)
            span = np.minimum(w(qe_all - qs_all), w(sqe - sqs))
            return ov.astype(np.float32) >= np.float32(0.5) * span.astype(np.float32)

        def block_argmax(vals):
            best = None
            for t in range(min(nt, a)):
                mine = vals[t::nt]
                j = int(np.argmax(mine))  # the thread's first strict maximum
                c = (mine[j], t + j * nt)
                if best is None or c[0] > best[0] or (c[0] == best[0] and c[1] < best[1]):
                    best = c
            return best

        def put(prefix, e, v, col=None):
            vals = dict(score=v, count=int(cnt[e]) + 1, qs=qs_all[e], qe=qe_all[e], rs=rp[root[e]],
                        re=w(rp[e] + k))
            if prefix == "alt_":
                vals.pop("count")
                vals = {"alt_score" if n == "score" else f"alt_{n}": x for n, x in vals.items()}
            for n, x in vals.items():
                n = f"sup_{n}" if prefix == "sup_" else n
                if col is None:
                    out[n][s] = x
                else:
                    out[n][s, col] = x

        score1, end = block_argmax(sf)
        put("", end, score1)
        live1 = score1 > 0
        ov1 = ov_ok(qs_all[end], qe_all[end]) & live1
        valid = rp < int(tchain.PAD_POS)
        v, e = block_argmax(np.where(ov1 & valid & (root != root[end]), sf, NEG))
        put("alt_", e, v)
        blocked = ov1 | ~valid
        for n in range(n_sup):
            v, e = block_argmax(np.where(blocked, NEG, sf))
            put("sup_", e, v, n)
            if v > 0:
                blocked = blocked | ov_ok(qs_all[e], qe_all[e]) | (np.arange(a) == e)
    return out


def emu_chain_select(f, parent, rpos, qpos, k, n_sup):
    """B6a as phylign_chain_select dispatches it: the warp kernel up to 256
    slots a set, the block kernel above."""
    emu = emu_chain_select_warp if rpos.shape[1] <= WARP_MAX_SLOTS else emu_chain_select_block
    return emu(f, parent, rpos, qpos, k, n_sup)


# --- B6b: a block of 32 pairs, a thread a pair, then 16-byte chunks -----------------

SEL_PAIRS = 32
M32 = 0xFFFFFFFF


def expand16(v):
    """16 codes (code i at bits 2i) -> 16 bytes: each byte of v spread by
    two shift-and-mask steps."""
    out = []
    for k in range(4):
        x = (v >> (8 * k)) & 0xFF
        x = (x | (x << 12)) & 0x000F000F
        x = (x | (x << 6)) & 0x03030303
        out += [(x >> (8 * i)) & 0xFF for i in range(4)]
    return out


def codes16(row, pos):
    """The 16 codes from code pos of a byte-packed row: the 4 or 5 bytes
    they span, shifted."""
    b, sh = pos >> 2, (pos & 3) * 2
    u = int(row[b]) | int(row[b + 1]) << 8 | int(row[b + 2]) << 16 | int(row[b + 3]) << 24
    if sh:
        u |= int(row[b + 4]) << 32
    return (u >> sh) & M32


def rev2(v):
    """The 16 2-bit groups of v in reverse order: the reversed word with
    each pair's bits swapped back."""
    x = int(f"{v:032b}"[::-1], 2)
    return ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)


def write_rows(out, base, n, row, chunk, byte):
    """The block's rows [0, n) of a byte output whose first row starts at
    flat offset 0 of ``out``, its address ``base`` mod 16: the bytes before
    the first aligned chunk and after the last one by one, every aligned
    16-byte chunk at once (chunk(r, j) inside a row, byte by byte across
    rows)."""
    length = n * row
    head = min((16 - base % 16) % 16, length)
    n_vec = (length - head) >> 4
    tail0 = head + 16 * n_vec

    def at(f):
        return byte(f // row, f % row)

    for f in [*range(head), *range(tail0, length)]:
        out[f] = at(f)
    for v in range(n_vec):
        f = head + 16 * v
        r, j = divmod(f, row)
        out[f : f + 16] = chunk(r, j) if j + 16 <= row else [at(f + i) for i in range(16)]


def emu_select_window(chains, cand_map, pair_base, pair_reflen, q_pack, q_len, pool_pack, cst, clen,
                      *, lmax, wlen, half, min_cnt, min_score, max_segments, base=0):
    """B6b block by block, as csrc/flush_epilogue.cu runs it (instance n_sup,
    n_out): each pair's thread finds its two sets' buckets once (the dummy
    past the last), lays out the 2 * (1 + n_sup) candidates with their
    strands by position, selects, writes the hot row, scores, bounds and
    split-segment scores, and stages the window origin and the cold row;
    then the block copies its cold rows as one run of words and writes the
    window, mask and query through write_rows: a window chunk from two
    little-endian pool words funnel-shifted when it lies in the pool (else
    code by code, clamped as the plain version clamps), a reverse-strand
    query chunk as the complemented, reversed forward chunk. ``base``: the
    byte outputs' address mod 16. Returns the Selection fields as numpy
    arrays."""
    p = len(cand_map)
    n_sup = chains[0]["sup_score"].shape[1]
    n_out = max(0, max_segments - 1)
    n_cand = 2 * (1 + n_sup)
    kcols = 4 + 6 * n_out + 5
    starts = np.concatenate([[0], np.cumsum([len(c["score"]) for c in chains])])
    n_c = len(cst)
    pool_bytes, pool_codes = len(pool_pack), 4 * len(pool_pack)
    pool32 = np.frombuffer(pool_pack[: pool_bytes // 4 * 4].tobytes(), "<u4")
    out = dict(q_codes=np.zeros((p, lmax), np.uint8), rwin=np.zeros((p, wlen), np.uint8),
               rvalid=np.zeros((p, wlen), bool), lohi=np.zeros((p, 2), np.int32),
               head=np.zeros((p, 4), np.int32), flts=np.zeros((p, 2), np.float32),
               cold_i=np.zeros((p, kcols), np.int32), cold_f=np.zeros((p, n_out), np.float32))
    min_score = np.float32(min_score)

    def strand(x):
        return x if x < 2 else int(x - 2 >= n_sup)

    def load_side(s, side, c):
        if s < 0:
            s += starts[-1] + 1
        b = int(np.searchsorted(starts[1:], s, side="right"))
        dummy = b == len(chains)
        i = 0 if dummy else s - starts[b]

        def get(name, j=None):
            if dummy:
                return NEG if name.endswith("score") else 0
            return chains[b][name][i] if j is None else chains[b][name][i, j]

        c[side] = [get(n) for n in ("score", "count", "qs", "qe", "rs", "re")]
        c["alt"][side] = [get(n) for n in ("alt_score", "alt_qs", "alt_qe", "alt_rs", "alt_re")]
        for j in range(n_sup):
            c[2 + side * n_sup + j] = [get(n, j) for n in T.CHAIN_FIELDS[11:]]

    def lex(c, mask):
        has, bc, bsc, bst, bqs = False, 0, NEG, 0, 0
        for x in range(n_cand):
            sc, st, qs = c[x][0], strand(x), c[x][2]
            if (mask >> x) & 1 and (not has or sc > bsc or (sc == bsc and st < bst)
                                    or (sc == bsc and st == bst and qs < bqs)):
                has, bc, bsc, bst, bqs = True, x, sc, st, qs
        return has, bc

    def qov(aqs, aqe, bqs, bqe):
        ov = max(int(w(min(aqe, bqe) - max(aqs, bqs))), 0)
        span = max(min(int(w(aqe - aqs)), int(w(bqe - bqs))), 1)
        return int(w(2 * ov)) >= span

    def select(pair, crow):
        """One thread's pair; returns what it stages for the gather."""
        c = {"alt": [None, None]}
        load_side(int(cand_map[pair, 0]), 0, c)
        load_side(int(cand_map[pair, 1]), 1, c)
        valid = sum(1 << x for x in range(n_cand) if c[x][1] >= min_cnt and c[x][0] >= min_score)
        has, pc = lex(c, valid)
        psc, pcnt, pqs, pqe, prs, pre = c[pc]
        pst, primary = strand(pc), pc < 2
        prim_alt = np.float32(max(c["alt"][pc][0], 0)) if primary else np.float32(0)
        s2c, c2 = NEG, 0
        for x in range(n_cand):
            sc = c[x][0] if (valid >> x) & 1 and x != pc and qov(c[x][2], c[x][3], pqs, pqe) else NEG
            if x == 0 or sc > s2c:
                s2c, c2 = sc, x
        alt_term = prim_alt if primary and has else np.float32(0)
        s2 = np.float32(max(s2c, alt_term, 0)) if has else np.float32(0)
        use_alt = alt_term > max(s2c, 0)
        ps = 0 if pc == 0 else 1
        taken, picked = 1 << pc, [(pqs, pqe, has)]
        flags = has * tfz.F_HAS | pst * tfz.F_STRAND | primary * tfz.F_PRIMTYPE | (s2 > 0) * tfz.F_PROBE
        for s in range(n_out):
            ok = sum(1 << x for x in range(n_cand)
                     if (valid >> x) & 1 and not (taken >> x) & 1 and has
                     and not any(qov(c[x][2], c[x][3], a, b) and live for a, b, live in picked))
            found, ch = lex(c, ok)
            if found:
                taken |= 1 << ch
                flags |= tfz.F_SUP0 << s
            sc, cnt, qs, qe, rs, re = c[ch]
            picked.append((qs, qe, found))
            crow[4 + 6 * s : 10 + 6 * s] = (strand(ch), qs, qe, rs, re, cnt)
            out["cold_f"][pair, s] = sc
        b0 = int(pair_base[pair])
        rs_c = int(w(min(max(int(prs), 0), int(w(int(pair_reflen[pair]) - 1))) + b0))
        lo_b, hi_b = 0, n_c
        while lo_b < hi_b:
            mid = (lo_b + hi_b) >> 1
            lo_b, hi_b = (mid + 1, hi_b) if cst[mid] <= rs_c else (lo_b, mid)
        ci = lo_b - 1
        c_start = int(cst[ci + n_c if ci < 0 else ci])
        c_end = int(w(c_start + int(clen[ci + n_c if ci < 0 else ci])))
        w0 = int(w(b0 + int(prs) - int(pqs) - half))
        lo = min(max(int(w(c_start - w0)), 0), wlen)
        hi = min(max(int(w(c_end - w0)), 0), wlen)
        out["head"][pair] = (w(w0 - c_start), ci, flags, pcnt)
        out["flts"][pair] = (psc, s2)
        out["lohi"][pair] = (lo, hi)
        crow[:4] = (pqs, pqe, prs, pre)
        crow[4 + 6 * n_out :] = (pst, *c["alt"][ps][1:]) if use_alt else (strand(c2), *c[c2][2:6])
        return w0, lo, hi, int(q_len[pair]), pst

    for p0 in range(0, p, SEL_PAIRS):
        n = min(SEL_PAIRS, p - p0)
        cold = np.zeros(n * kcols, np.int32)
        stage = [select(p0 + t, cold[t * kcols : (t + 1) * kcols]) for t in range(n)]
        out["cold_i"].reshape(-1)[p0 * kcols : (p0 + n) * kcols] = cold

        def win_byte(r, j):
            idx = min(max(int(w(stage[r][0] + j)), 0), pool_codes - 1)
            return (int(pool_pack[idx >> 2]) >> ((idx & 3) * 2)) & 3

        def win_chunk(r, j):
            x = stage[r][0] + j
            k = x >> 4
            if 0 <= x and x + 15 <= 2**31 - 1 and x + 16 <= pool_codes and 4 * (k + 2) <= pool_bytes:
                lo_w, hi_w = int(pool32[k]), int(pool32[k + 1])
                return expand16(((hi_w << 32 | lo_w) >> ((x & 15) * 2)) & M32)
            return [win_byte(r, j + i) for i in range(16)]

        def valid_byte(r, j):
            return int(stage[r][1] <= j < stage[r][2])

        def q_byte(r, j):
            qp = q_pack[p0 + r]
            if stage[r][4] == 1:
                ql = stage[r][3]
                x = min(max(int(w(ql - 1 - j)), 0), lmax - 1)
                return 3 - ((int(qp[x >> 2]) >> ((x & 3) * 2)) & 3) if j < ql else 0
            return (int(qp[j >> 2]) >> ((j & 3) * 2)) & 3

        def q_chunk(r, j):
            qp = q_pack[p0 + r]
            if stage[r][4] != 1:
                return expand16(codes16(qp, j))
            ql = stage[r][3]
            if j >= ql:
                return [0] * 16
            if j + 16 <= ql <= lmax:
                return expand16(rev2(codes16(qp, ql - 16 - j)) ^ M32)
            return [q_byte(r, j + i) for i in range(16)]

        for name, row, chunk, byte in (("rwin", wlen, win_chunk, win_byte),
                                       ("rvalid", wlen, lambda r, j: [valid_byte(r, j + i) for i in range(16)],
                                        valid_byte),
                                       ("q_codes", lmax, q_chunk, q_byte)):
            flat = np.zeros(n * row, np.uint8)
            write_rows(flat, base + p0 * row, n, row, chunk, byte)
            out[name][p0 : p0 + n] = flat.reshape(n, row)
    return out


# --- B6c: one warp per pair, then the compaction's blocks of 256 rows --------------------

LANES = np.arange(32)
LANE_COLS, TILE_COLS = 8, 256


def ballot(bits):
    return int((bits.astype(np.int64) << LANES).sum())


def popc(x):
    return bin(x & 0xFFFFFFFF).count("1")


def shfl_up(x, off, fill=0):
    """__shfl_up_sync over the lanes: lane l gets lane l - off's value; the
    lanes below off keep their own (the caller masks them)."""
    return np.concatenate([x[:off], x[:-off]]) if off else x


def emu_window8(row, col0, wlen, base):
    """A lane's 8 window bytes (columns col0 .. col0 + 7 of a row whose first
    byte sits at address ``base``): when all 8 lie in the row, the aligned
    little-endian words that hold them funnel-shifted by the address's
    residue (the third word read only off a word boundary); else byte by
    byte at the clamped column."""
    if 0 <= col0 <= wlen - LANE_COLS:
        addr = base + col0
        first = addr & ~3
        sh = (addr & 3) * 8
        n_words = 3 if sh else 2

        def byte_at(a):  # bytes of the words outside the row are never kept
            return int(row[a - base]) if 0 <= a - base < wlen else 0xEE

        words = [sum(byte_at(first + 4 * i + b) << (8 * b) for b in range(4)) for i in range(n_words)] + [0]
        lo = ((words[1] << 32 | words[0]) >> sh) & M32
        hi = ((words[2] << 32 | words[1]) >> sh) & M32
    else:
        cols = [min(max(int(w(col0 + i)), 0), wlen - 1) for i in range(LANE_COLS)]
        lo = sum(int(row[c]) << (8 * i) for i, c in enumerate(cols[:4]))
        hi = sum(int(row[c]) << (8 * i) for i, c in enumerate(cols[4:]))
    return lo, hi


def emu_neq_byte(q, win):
    """The big-endian mismatch byte of 8 columns: per-byte compares (0xff /
    0) masked to one bit each, the 4 bytes of a word summed by a multiply."""
    def vcmpne4(a, b):
        return sum(0xFF << (8 * i) for i in range(4) if (a >> (8 * i)) & 0xFF != (b >> (8 * i)) & 0xFF)

    lo = vcmpne4(q[0], win[0]) & 0x10204080
    hi = vcmpne4(q[1], win[1]) & 0x01020408
    return (((lo | hi) * 0x01010101) & M32) >> 24


def emu_finish_pack(sel, q_len, ext_score, end_d, match, mismatch, min_dp, zdrop, base=0):
    """B6c pair by pair as its warp runs: lane l holds columns j0 = 256 t +
    8 l .. j0 + 7 of tile t, the query as one little-endian 8-byte word and
    the window through emu_window8 (``base``: the window buffer's address
    mod 16); its big-endian mismatch byte, cut to the columns before q_len,
    stored as it is. Pass 1 counts the row (a redux add a tile); pass 2 (the
    same registers at one tile) takes each lane's first rank from an
    exclusive shuffle-up scan of the lanes' popcounts after the count
    carried in, its running peak from an exclusive max-scan of the lanes'
    own peaks after the peak carried in, and its minima and largest drop
    by two loops over its mismatch bits (the r-th at column j0 + s: prefv
    = (m j0 - step cum0) + m (s + 1) - step r, r_before and sufv from
    prefv, in the wrapping int32 ring); three redux reductions end the
    row."""
    q_codes, rwin, lohi, head = sel["q_codes"], sel["rwin"], sel["lohi"], sel["head"]
    p, lmax = q_codes.shape
    wlen = rwin.shape[1]
    hot = head.copy()
    bits = np.zeros((p, lmax // 8), np.uint8)
    step = int(w(match + mismatch))
    d_rb = int(w(step - match))
    tiles = -(-lmax // TILE_COLS)
    for pair in range(p):
        e, ql = int(end_d[pair]), int(q_len[pair])
        lo, hi = int(lohi[pair, 0]), int(lohi[pair, 1])
        qrow = q_codes[pair].tobytes()

        def load(t):
            mb, vok = np.zeros(32, np.int64), np.ones(32, bool)
            for ln in LANES:
                j0 = t * TILE_COLS + LANE_COLS * ln
                if j0 >= lmax:
                    continue
                col0 = int(w(e + j0))
                n_in = 0 if ql <= j0 else min(ql - j0, LANE_COLS)
                qw = np.frombuffer(qrow[j0 : j0 + 8], "<u4")
                win = emu_window8(rwin[pair], col0, wlen, base + pair * wlen)
                mb[ln] = emu_neq_byte((int(qw[0]), int(qw[1])), win) & ((0xFF00 >> n_in) & 0xFF)
                if col0 <= 2**31 - 1 - LANE_COLS:  # no wrap: the n_in columns are one run
                    vok[ln] = n_in == 0 or (col0 >= lo and col0 + n_in - 1 < hi)
                else:
                    cols = [int(w(col0 + i)) for i in range(LANE_COLS)]
                    vok[ln] = all((lo <= c < hi) or i >= n_in for i, c in enumerate(cols))
            return mb, vok

        neq_tot, vall, tile = 0, True, None
        for t in range(tiles):
            tile = load(t)
            neq_tot += sum(popc(int(x)) for x in tile[0])
            vall = vall and bool(tile[1].all())
            for ln in LANES:
                j0 = t * TILE_COLS + LANE_COLS * ln
                if j0 < lmax:
                    bits[pair, j0 >> 3] = tile[0][ln]
        k_suf = int(w(int(w(match * ql)) - int(w(step * int(w(neq_tot + 1)))) + match))
        carry, peak = 0, -BIG
        min_pref, min_suf, dropmax = np.full(32, BIG), np.full(32, BIG), np.full(32, -BIG)
        for t in range(tiles):
            mb = (load(t) if tiles > 1 else tile)[0]
            c = np.array([popc(int(x)) for x in mb])
            incl = c.copy()
            for off in (1, 2, 4, 8, 16):
                incl = np.where(LANES >= off, incl + shfl_up(incl, off), incl)
            cum0 = carry + incl - c
            lpeak = np.full(32, -BIG)

            def mismatches(ln):  # (s, r, prefv) of the lane's r-th mismatch, at column j0 + s
                base = int(w(int(w(match * (t * TILE_COLS + LANE_COLS * ln))) - int(w(step * int(cum0[ln])))))
                on = [sb for sb in range(LANE_COLS) if (int(mb[ln]) >> (7 - sb)) & 1]
                return [(sb, r, int(w(base + int(w(int(w(match * (sb + 1))) - int(w(step * r)))))))
                        for r, sb in enumerate(on, 1)]

            for ln in LANES:
                for _, _, pv in mismatches(ln):
                    min_pref[ln] = min(min_pref[ln], pv)
                    min_suf[ln] = min(min_suf[ln], int(w(k_suf - pv)))
                    lpeak[ln] = max(lpeak[ln], int(w(pv + d_rb)))
            pk = lpeak.copy()
            for off in (1, 2, 4, 8, 16):
                pk = np.where(LANES >= off, np.maximum(pk, shfl_up(pk, off)), pk)
            run = np.maximum(np.where(LANES == 0, -BIG, shfl_up(pk, 1)), peak)
            if tiles > 1:  # what the next tile carries in
                carry += int(incl[31])
                peak = max(peak, int(pk[31]))
            for ln in LANES:
                r = int(run[ln])
                for _, _, pv in mismatches(ln):
                    r = max(r, int(w(pv + d_rb)))
                    dropmax[ln] = max(dropmax[ln], int(w(r - pv)))
        min_pref, min_suf, dropmax = int(min_pref.min()), int(min_suf.min()), int(dropmax.max())
        best = int(w(match * (ql - neq_tot) - mismatch * neq_tot))
        ext_i = int(np.float32(min(max(np.float32(ext_score[pair]), np.float32(-1e9)), np.float32(1e9))))
        diag = vall and best == ext_i
        full = (diag and best >= min_dp and (neq_tot == 0 or (min_pref > 0 and min_suf > 0))
                and dropmax <= zdrop)
        hot[pair, 2] = w(int(hot[pair, 2]) | diag * tfz.F_DIAG | full * tfz.F_FULL | (e << 8))
    return hot, bits


COMPACT_THREADS = 256


def emu_compact_cold(hot, cold_i, cold_f, cap=tfz.COLD_CAP):
    """The compaction's blocks of 256 rows, one thread a row: each block's
    threads count the need flags of all rows in strides of 256 (those
    before the block's first row, and all), summed over the warps; the
    block's own rows ranked by ballot + popcount into a list; its ranks
    below cap copied as one run of slots, word w from row list[w // cols];
    the slots past the used ones zeroed in a stride over all blocks."""
    p = len(hot)
    ci, cf = cold_i.shape[1], cold_f.shape[1]
    cc_i = np.full(cap * ci, -7, np.int32)
    cc_f = np.full(cap * cf, -7, np.float32)
    fl = hot[:, 2]
    need = (((fl & tfz.F_HAS) != 0) & ((fl & tfz.F_FULL) == 0)) | ((fl & 0xE0) != 0)
    n_blocks = -(-p // COMPACT_THREADS)
    stride = n_blocks * COMPACT_THREADS
    src_i, src_f = cold_i.reshape(-1), cold_f.reshape(-1)
    for blk in range(n_blocks):
        r0 = blk * COMPACT_THREADS
        t = np.arange(COMPACT_THREADS)
        before = np.zeros(COMPACT_THREADS, np.int64)
        total = np.zeros(COMPACT_THREADS, np.int64)
        for r in range(0, p, COMPACT_THREADS):  # thread t reads row r + t
            rows = r + t
            nd = np.where(rows < p, need[np.minimum(rows, p - 1)], False)
            total += nd
            before += nd & (rows < r0)
        first, used = int(before.sum()), min(int(total.sum()), cap)
        rows = r0 + t
        mine = (rows < p) & need[np.minimum(rows, p - 1)]
        warp_n = [popc(ballot(mine[x : x + 32])) for x in range(0, COMPACT_THREADS, 32)]
        listed = np.zeros(COMPACT_THREADS, np.int64)
        for x in np.flatnonzero(mine):
            b = ballot(mine[x - x % 32 : x - x % 32 + 32])
            listed[sum(warp_n[: x // 32]) + popc(b & ((1 << (x % 32)) - 1))] = rows[x]
        n_copy = max(0, min(sum(warp_n), cap - first))
        for dst, src, cols in ((cc_i, src_i, ci), (cc_f, src_f, cf)):
            for wd in range(n_copy * cols):
                d = wd // cols
                dst[first * cols + wd] = src[listed[d] * cols + wd - d * cols]
        for dst, cols in ((cc_i, ci), (cc_f, cf)):
            for th in t:  # thread th zeroes words used * cols + r0 + th + k * stride
                dst[used * cols + r0 + th : cap * cols : stride] = 0
    return cc_i.reshape(cap, ci), cc_f.reshape(cap, cf)


def emu_flush(chains, ins, kw, scoring, zdrop=100):
    """The whole epilogue as the card runs it: B6b, B4's plain version,
    B6c, the compaction; (packed bytes, cold_i, cold_f, selection)."""
    sel = emu_select_window(chains, *ins, **kw)
    t = {k: torch.from_numpy(v) for k, v in sel.items()}
    ext = ope.extend_ref(t["q_codes"], torch.from_numpy(ins[4]), t["rwin"], t["rvalid"], scoring)
    hot, bits = emu_finish_pack(sel, ins[4], ext.score.numpy(), ext.end_d.numpy(), scoring.match,
                                scoring.mismatch, scoring.min_dp_score, zdrop)
    cc_i, cc_f = emu_compact_cold(hot, sel["cold_i"], sel["cold_f"])
    packed = b"".join(a.tobytes() for a in (hot, sel["flts"], bits, cc_i, cc_f))
    return packed, sel["cold_i"], sel["cold_f"], sel


# --- inputs ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool_calls():
    """The (chain tail, select_extend) calls of the port's fused flush of
    tests/test_torch_fused.py's pool, on the CPU."""
    tasks, params = mixed_pool(PORT, 11)
    tails, flushes = [], []
    orig_tail, orig_sel = tchain.chain_tail, tfz.select_extend

    def tail(*args):
        tails.append(args)
        return orig_tail(*args)

    def sel(*args, **kw):
        flushes.append((args, kw))
        return orig_sel(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tchain, "chain_tail", tail)
    mp.setattr(tfz, "select_extend", sel)
    try:
        tae.flush_pairs_fused(tasks, params, device="cpu")
    finally:
        mp.undo()
    assert tails and flushes
    return tails, flushes


def _np_chains(chains):
    return [{n: getattr(c, n).numpy() for n in T.CHAIN_FIELDS} for c in chains]


def _anchor_sets(rng, p, a, rmax, q16):
    """Sorted random anchor sets, the last two rows all padding."""
    rp = np.full((p, a), tchain.PAD_POS, np.int32)
    qp = np.full((p, a), tchain.PAD_POS, np.int32)
    for i in range(p - 2):
        n = int(rng.integers(1, a + 1))
        r, q = rng.integers(0, rmax, n).astype(np.int32), rng.integers(0, min(rmax, 60000), n).astype(np.int32)
        o = np.lexsort((q, r))
        rp[i, :n], qp[i, :n] = r[o], q[o]
    if q16:
        q = np.zeros((p, a), np.uint16)
        np.copyto(q, qp, casting="unsafe", where=qp < tchain.PAD_POS)
        qp = q.view(np.int16)
    return rp, qp


# --- B6a -----------------------------------------------------------------------------


def test_chain_select_emulation_on_the_pool(pool_calls):
    """Every chain tail of the pool's flush (each anchor bucket)."""
    tails, _ = pool_calls
    for f, parent, rpos, qpos, k, n_sup in tails:
        want = tchain._chain_tail_ref(f, parent, rpos, qpos, k, n_sup)
        got = emu_chain_select(f.numpy(), parent.numpy(), rpos.numpy(), qpos.numpy(), k, n_sup)
        for n in T.CHAIN_FIELDS:
            np.testing.assert_array_equal(got[n], getattr(want, n).numpy(), err_msg=n)


@pytest.mark.parametrize("n_sup", [0, 1, 2, 3])
@pytest.mark.parametrize("p,a,q16,rmax", [(40, 32, True, 300), (12, 64, False, 400), (6, 256, True, 2000),
                                          (3, 1024, False, 6000), (3, 4096, True, 30000),
                                          (3, 16384, False, 80000), (13, 31, True, 300), (11, 33, False, 300),
                                          (9, 65, True, 500), (5, 257, False, 2000)])
def test_chain_select_emulation_equals_plain_and_jax(p, a, q16, rmax, n_sup):
    """Random anchor sets (overlapping chains, all-padding rows): the
    emulation on chain_dp_ref's f / parent equals _chain_tail_ref and the
    JAX package's chain_anchors (which stacks its segments, so n_sup >= 1
    there); an all-padding row holds slot 0's values (the argmax of an all
    -1e30 row), not zeros. The warp kernel's edges: A = 31, 33 and 65 (a
    lane's last slots past A), its largest A (256) and one past (257, the
    block kernel), P off its 8 sets a block."""
    rp, qp = _anchor_sets(np.random.default_rng(a + n_sup), p, a, rmax, q16)
    r, q = torch.from_numpy(rp), torch.from_numpy(qp)
    f, parent = tchain.chain_dp_ref(r, q, tchain.device_cost_table(21, 100, r.device), 21, 100, 100)
    got = emu_chain_select(f.numpy(), parent.numpy(), rp, qp, 21, n_sup)
    want = tchain._chain_tail_ref(f, parent, r, q, 21, n_sup)
    jq = u16(qp).astype(np.int32) if q16 else qp
    jx = jchain.chain_anchors(jnp.asarray(rp), jnp.asarray(jq), n_sup=n_sup) if n_sup else want
    for n in T.CHAIN_FIELDS:
        np.testing.assert_array_equal(got[n], getattr(want, n).numpy(), err_msg=n)
        np.testing.assert_array_equal(got[n], np.asarray(getattr(jx, n)), err_msg=n)
    q0 = int(u16(qp)[-1, 0])
    assert got["score"][-1] == NEG and got["alt_score"][-1] == NEG and got["count"][-1] == 1
    assert (got["qs"][-1], got["qe"][-1], got["re"][-1]) == (q0, q0 + 21, int(rp[-1, 0]) + 21)
    assert (got["sup_score"][-1] == NEG).all() and (got["sup_count"][-1] == 1).all()


# --- B6b, B6c and the compaction --------------------------------------------------------


def test_flush_emulation_on_the_pool(pool_calls):
    """Every select_extend of the pool's flush: the Selection equals
    _select_ref's, the packed buffer and full cold rows equal the plain
    select_extend's byte for byte."""
    _, flushes = pool_calls
    for args, kw in flushes:
        kw = dict(kw)
        scoring, zdrop = kw.pop("scoring"), kw.pop("zdrop")
        kw.pop("pack")
        chains, ins = _np_chains(args[0]), [a.numpy() for a in args[1:]]
        packed, cold_i, cold_f, sel = emu_flush(chains, ins, kw, scoring, zdrop)
        ref = tfz._select_ref(tfz._flatten_chains(args[0]), *args[1:], **kw)
        for n, v in sel.items():
            np.testing.assert_array_equal(v, getattr(ref, n).numpy(), err_msg=n)
        want = tfz.select_extend(*args, scoring=scoring, zdrop=zdrop, pack=True, **kw)
        assert packed == want[0].numpy().tobytes()
        np.testing.assert_array_equal(cold_i, want[1][0].numpy())
        np.testing.assert_array_equal(cold_f, want[1][1].numpy())


@pytest.mark.parametrize("p,lmax,n_sup,wide,zdrop", [
    (256, 160, 2, False, 100), (256, 160, 1, False, 100), (128, 160, 0, False, 100), (700, 160, 2, False, 100),
    (48, 992, 2, False, 100), (128, 160, 2, True, 100), (256, 160, 2, False, 12)])
def test_flush_emulation_equals_plain_and_jax(p, lmax, n_sup, wide, zdrop):
    """testing.flush_case's pairs (no candidate, under the thresholds,
    contig edges, chimeras with 1-2 segments, tied strands, off-diagonal
    primaries, padding; P = 700 overflows COLD_CAP): the emulation's
    packed bytes and cold rows equal the plain select_extend's and the
    JAX package's; -A 200 -B 150 at ``wide``; the z-drop check at 100
    (runs of 15 substitutions) and at 12. Padding pairs hold the dummy
    candidate's values: hot (-half, 0, F_PRIMTYPE, 0), scores (-1e30, 0),
    a zero cold row."""
    chains, ins, kw = T.flush_case(np.random.default_rng(p + n_sup), p, lmax, 128, n_sup)
    scoring = ope.SrScoring(match=200, mismatch=150) if wide else ope.SrScoring()
    packed, cold_i, cold_f, sel = emu_flush(chains, ins, kw, scoring, zdrop)
    tch = tuple(tchain.ChainResult(*[torch.from_numpy(c[n]) for n in T.CHAIN_FIELDS]) for c in chains)
    want = tfz.select_extend(tch, *[torch.from_numpy(x) for x in ins], scoring=scoring, zdrop=zdrop, pack=True,
                             **kw)
    assert packed == want[0].numpy().tobytes()
    np.testing.assert_array_equal(cold_i, want[1][0].numpy())
    np.testing.assert_array_equal(cold_f, want[1][1].numpy())
    jch = tuple(jchain.ChainResult(*[jnp.asarray(c[n]) for n in T.CHAIN_FIELDS]) for c in chains)
    jx = jfz.select_extend(jch, *[jnp.asarray(x) for x in ins], scoring=jfz.SrScoring(**vars(scoring)),
                           zdrop=zdrop, pack=True, **kw)
    assert packed == np.asarray(jx[0]).tobytes()
    np.testing.assert_array_equal(cold_i, np.asarray(jx[1][0]))
    hot = np.frombuffer(packed[: 16 * p], np.int32).reshape(p, 4)
    flts = np.frombuffer(packed[16 * p : 24 * p], np.float32).reshape(p, 2)
    half = kw["half"]
    assert (hot[-8:] == [-half, 0, tfz.F_PRIMTYPE, 0]).all() and (flts[-8:] == [NEG, 0]).all()
    assert (cold_i[-8:] == 0).all()
    none = (ins[0] == ins[0].max()).all(axis=1)[:-8]  # pairs with no candidate
    assert none.any() and ((hot[:-8][none, 2] & 0xFF) == tfz.F_PRIMTYPE).all()
    flags = hot[:, 2] & 0xFF
    assert (flags & tfz.F_FULL).any() and (((flags & tfz.F_HAS) != 0) & ((flags & tfz.F_FULL) == 0)).any()
    assert (flags & tfz.F_STRAND).any() and (flags & tfz.F_PROBE).any()
    assert n_sup == 0 or (flags & tfz.F_SUP0).any()
    assert (sel["lohi"][:, 0] > 0).any() or (sel["lohi"][:, 1] < kw["wlen"]).any()


@pytest.mark.parametrize("zdrop", [10, 12, 100])
@pytest.mark.parametrize("wide", [False, True])
def test_finish_pack_emulation_on_crafted_rows(zdrop, wide):
    """B6c on rows whose mismatches sit where its warp scans could go
    wrong (testing.finish_case): runs at and across lane and 32-column
    boundaries, a lane's first and last column (a later column's peak in
    the lane, which z-drop 10 tells apart), a run of 15 (the z-drop);
    short reads, windows cut by the contig, scores off the gapless one."""
    scoring = ope.SrScoring(match=200, mismatch=150) if wide else ope.SrScoring()
    q, rwin, lohi, head, q_len, ext, end_d = T.finish_case(np.random.default_rng(zdrop + wide), 96, 160, 128,
                                                          scoring.match, scoring.mismatch)
    p = len(q)
    sel = dict(q_codes=q, rwin=rwin, lohi=lohi, head=head)
    hot, bits = emu_finish_pack(sel, q_len, ext, end_d, scoring.match, scoring.mismatch,
                                scoring.min_dp_score, zdrop)
    ref = tfz.Selection(*[torch.from_numpy(x) for x in (q, rwin, rwin, lohi, head, np.zeros((p, 2), np.float32),
                                                       np.zeros((p, 9), np.int32), np.zeros((p, 0), np.float32))])
    want = tfz._finish_ref(ref, torch.from_numpy(q_len), torch.from_numpy(ext), torch.from_numpy(end_d), scoring,
                           zdrop)
    np.testing.assert_array_equal(hot, want[0].numpy())
    np.testing.assert_array_equal(bits, want[1].numpy())
    fl = hot[:, 2]
    assert ((fl & tfz.F_DIAG) != 0).any() and ((fl & tfz.F_FULL) != 0).any()
    assert (((fl & tfz.F_DIAG) != 0) & ((fl & tfz.F_FULL) == 0)).any()


@pytest.mark.parametrize("lmax,base,zdrop", [(32, 0, 100), (160, 1, 100), (160, 2, 100), (2208, 3, 100),
                                            (992, 0, 10), (992, 0, 100)])
def test_finish_pack_emulation_at_the_window_ends(lmax, base, zdrop):
    """B6c with end_d at both ends of the window (0 and wlen - lmax: a
    lane's 8 bytes at the row's first and last columns, each word read
    holding one of them), window rows at every address residue mod 4
    (wlen 160 + 128 = 288 is a multiple of 4, so ``base`` shifts every
    row), queries as long as lmax: 32 (4 lanes a tile), 992 and 2,208 (4
    and 9 tiles: runs across the 256-column tile carry the z-drop's peak,
    a mismatch 6 columns before the end the count into sufv; z-drop 10
    and 100): equal to _finish_ref."""
    sc = ope.SrScoring()
    q, rwin, lohi, head, q_len, ext, end_d = T.finish_case(np.random.default_rng(lmax + base + zdrop), 24, lmax,
                                                          128, sc.match, sc.mismatch, ends=True, qmax=lmax)
    p = len(q)
    hot, bits = emu_finish_pack(dict(q_codes=q, rwin=rwin, lohi=lohi, head=head), q_len, ext, end_d, sc.match,
                                sc.mismatch, sc.min_dp_score, zdrop, base=base)
    ref = tfz.Selection(*[torch.from_numpy(x) for x in (q, rwin, rwin, lohi, head, np.zeros((p, 2), np.float32),
                                                       np.zeros((p, 9), np.int32), np.zeros((p, 0), np.float32))])
    want = tfz._finish_ref(ref, torch.from_numpy(q_len), torch.from_numpy(ext), torch.from_numpy(end_d), sc,
                           zdrop)
    np.testing.assert_array_equal(hot, want[0].numpy())
    np.testing.assert_array_equal(bits, want[1].numpy())
    assert (end_d == 0).any() and (end_d == 128).any()
    assert ((hot[:, 2] & tfz.F_FULL) != 0).any()


def test_finish_pack_emulation_clamps_outside_the_window():
    """An end_d 7 columns before or past the window (the plain version's
    gather would refuse it): the lanes whose 8 bytes leave the row read
    each column clamped to the window, which is _finish_ref on the window
    widened by copies of its end bytes (testing.window_padded); end_d's
    own bits of the hot row stay the given ones."""
    sc = ope.SrScoring()
    q, rwin, lohi, head, q_len, ext, end_d = T.finish_case(np.random.default_rng(5), 30, 160, 128, sc.match,
                                                          sc.mismatch, ends=True, qmax=160)
    end_d = end_d.copy()
    end_d[::3] -= 7
    end_d[1::3] += 7
    p = len(q)
    hot, bits = emu_finish_pack(dict(q_codes=q, rwin=rwin, lohi=lohi, head=head), q_len, ext, end_d, sc.match,
                                sc.mismatch, sc.min_dp_score, 100)
    wide, wlohi, wend = T.window_padded(rwin, lohi, end_d, 8)
    ref = tfz.Selection(*[torch.from_numpy(x) for x in (q, wide, wide, wlohi, head, np.zeros((p, 2), np.float32),
                                                       np.zeros((p, 9), np.int32), np.zeros((p, 0), np.float32))])
    want = [x.numpy() for x in tfz._finish_ref(ref, torch.from_numpy(q_len), torch.from_numpy(ext),
                                                torch.from_numpy(wend), sc, 100)]
    np.testing.assert_array_equal(bits, want[1])
    np.testing.assert_array_equal(hot[:, [0, 1, 3]], want[0][:, [0, 1, 3]])
    np.testing.assert_array_equal(hot[:, 2] & 0xFF, want[0][:, 2] & 0xFF)
    np.testing.assert_array_equal(hot[:, 2] >> 8, end_d)
    assert bits.any() and ((want[0][:, 2] & tfz.F_DIAG) == 0).any()


def test_compaction_emulation_overflow():
    """More needed rows than COLD_CAP over several 1,024-row rounds: the
    first COLD_CAP in order, as _compact_cold (and JAX's dropping scatter)
    keeps them; few needed rows leave the other slots zero."""
    rng = np.random.default_rng(4)
    for p, share in ((3000, 0.4), (2100, 0.05)):
        hot = np.zeros((p, 4), np.int32)
        hot[:, 2] = rng.choice([tfz.F_HAS, tfz.F_HAS | tfz.F_FULL, tfz.F_SUP0 | tfz.F_FULL, tfz.F_PROBE, 0], p,
                               p=[share / 3, 1 - share, share / 3, share / 3, 0])
        hot[:, 2] |= rng.integers(0, 128, p).astype(np.int32) << 8
        cold_i = rng.integers(-9, 9, (p, 19)).astype(np.int32)
        cold_f = rng.random((p, 2)).astype(np.float32)
        got = emu_compact_cold(hot, cold_i, cold_f)
        want = tfz._compact_cold(*[torch.from_numpy(a) for a in (hot, cold_i, cold_f)])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("p,kind", [
    (1, "none"), (1, "all"), (31, "all"), (33, "random"), (256, "all"), (1025, "random"), (1025, "none"),
    (1000, ("at", 767)), (2000, ("at", 1023)), (2000, ("at", 1024)), (8192, "random")])
def test_compaction_emulation_edges(p, kind):
    """The compaction's edges: no needed row, every row needed, P = 1, P
    not a multiple of the 256-row block, the COLD_CAP-th needed row on a
    block's last row (767, 1,023) and first row (1,024), the main path's P:
    equal to _compact_cold, every slot."""
    hot, cold_i, cold_f = T.cold_case(np.random.default_rng(p), p, kind)
    got = emu_compact_cold(hot, cold_i, cold_f)
    want = tfz._compact_cold(*[torch.from_numpy(a) for a in (hot, cold_i, cold_f)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def _select_case(p, lmax, band, n_sup, n_out, seed):
    ch, ins, kw = T.flush_case(np.random.default_rng(seed), p, lmax, band, n_sup)
    kw["max_segments"] = n_out + 1
    tch = tuple(tchain.ChainResult(*[torch.from_numpy(c[n]) for n in T.CHAIN_FIELDS]) for c in ch)
    ref = tfz._select_ref(tfz._flatten_chains(tch), *[torch.from_numpy(x) for x in ins], **kw)
    return ch, ins, kw, ref


@pytest.mark.parametrize("n_out", [0, 1, 2])
@pytest.mark.parametrize("n_sup", [0, 1, 2])
def test_select_window_emulation_every_instance(n_sup, n_out):
    """Every (n_sup, n_out) instance of B6b, at a window of 260 columns (not
    a multiple of 16: chunks across rows, a tail in the last block of 13
    pairs): every Selection field equal to _select_ref's."""
    ch, ins, kw, ref = _select_case(77, 160, 100, n_sup, n_out, 40 + 3 * n_sup + n_out)
    got = emu_select_window(ch, *ins, **kw)
    for n, v in got.items():
        np.testing.assert_array_equal(v, getattr(ref, n).numpy(), err_msg=n)
    assert ((ref.head[:, 2] & tfz.F_STRAND) != 0).any()


@pytest.mark.parametrize("base", [0, 5, 13])
@pytest.mark.parametrize("p,lmax,band", [(1, 160, 128), (33, 150, 100), (300, 150, 100), (300, 160, 128)])
def test_select_window_emulation_alignment(p, lmax, band, base):
    """B6b's 16-byte chunks against the byte outputs' alignment: rows of 150
    and 250 or 260 bytes, outputs starting at every kind of address (a head
    before the first chunk), w0 at every residue mod 16 (P = 300): equal to
    _select_ref's."""
    ch, ins, kw, ref = _select_case(p, lmax, band, 2, 2, 7 * p + lmax + base)
    got = emu_select_window(ch, *ins, **kw, base=base)
    for n, v in got.items():
        np.testing.assert_array_equal(v, getattr(ref, n).numpy(), err_msg=n)
    if p >= 300:
        ci = ref.cold_i.numpy().astype(np.int64)
        w0 = ins[1] + ci[:, 2] - ci[:, 0] - kw["half"]
        has = (ref.head[:, 2].numpy() & tfz.F_HAS) != 0
        assert set((w0[has] % 16).tolist()) == set(range(16))
        strand = (ref.head[:, 2].numpy() & tfz.F_STRAND) != 0
        assert (has & strand).any() and (has & ~strand).any()


# --- dispatch ---------------------------------------------------------------------------


def test_cpu_tensors_launch_no_b6_kernel(pool_calls):
    """On CPU tensors chain_anchors and select_extend take the plain
    versions: every B6 counter stays 0; the CUDA wrappers refuse CPU
    tensors without counting."""
    _, flushes = pool_calls
    tchain.reset_launch_counts()
    tfz.reset_launch_counts()
    rp, qp = _anchor_sets(np.random.default_rng(1), 8, 32, 300, False)
    tchain.chain_anchors(torch.from_numpy(rp), torch.from_numpy(qp))
    args, kw = flushes[0]
    tfz.select_extend(*args, **kw)
    f = torch.zeros((2, 32))
    i = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tchain.chain_select_cuda(f, i, i, i, 21, 2)
    kw = {k: v for k, v in kw.items() if k not in ("scoring", "zdrop", "pack")}
    with pytest.raises(ValueError, match="CUDA"):
        tfz.select_window_cuda(*args, **kw)
    assert tchain.launch_counts() == {"chain_scan": 0, "chain_select": 0}
    assert tfz.launch_counts() == {"select_window": 0, "finish_pack": 0, "compact_cold": 0}
