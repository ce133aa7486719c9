"""B4's packed instance as it runs on the card: a warp a pair sweeping the
band's anti-diagonals (``extend_wave_kernel`` in
``phylign_tpu_torch/csrc/extend_scan.cu``). A numpy emulation of its
per-lane algorithm is held to the plain version ``extend_ref`` and, through
the packed entry points, to the JAX package's ``extend_banded_scores_packed``
and ``extend_banded_packed``; mutants of the emulation must differ.

Tolerance: exact. Every value is an integer-valued f32 or -1e30-based, so
the score, end_d and the P plane are compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from phylign_tpu.ops import extend as je
from phylign_tpu_torch.ops import extend as te
from test_torch_extend import JWIDE, KS, KT, WIDE, _mask, _t, prmt

EDGE = 2**29  # kEdge: what a lane-edge cell subtracts from its own lane's values
INVALID_SEL = 0x5444


def to_f32(v):
    return np.where(v < KT, np.float32(-1e30), np.asarray(v).astype(np.float32))


def code_of(packed, j):
    """Code j of each pair's 2-bit packed row (j in range): [P, len(j)]."""
    j = np.asarray(j)
    return (packed[:, j >> 2].astype(np.int64) >> (2 * (j & 3))) & 3


def emulate_b4_wave(q_pack, q_len, r_pack, lo, hi, l, wlen, sc=te.SrScoring(), collect=False, wide=None,
                    mutant=None):
    """extend_wave_kernel step pair by step pair, vectorized over pairs, by
    lane. The warp's tables first: qtab[S + y] the substitution's terms of
    query code y for y in [-S, l + S) (byte: the lookup table and the
    sentinel bytes; wide: the code and a mask), 0 (wide: code 5) past the
    query's ends; wtab[x] window column x's selector (wide: the code or 4,
    and the mismatch score or KS). Lane k holds cells d = k*CPL + c (CPL =
    band/32); at step pair s its cells 2m and 2m + 1 are on row s -
    k*CPL/2 - m, with query code entry q[m] and window entries w[m] (even)
    and w[m + 1] (odd) from shift registers fed a pair ahead; the even cells
    move at step 2s and the odd ones at 2s + 1 from their neighbours'
    registers. Cell 0 reads lane k-1's top cell (P, X1, X2) by a shuffle up
    and the top cell lane k+1's cell 0 (H, J1, J2) by a shuffle down; lanes
    0 and 31 read their own values, less EDGE on P and H and with EDGE
    added to e. J = I + o, X = D + open + e. A cell of a negative row
    scores 0, so holds H = J = P = X = 0 (row -1). The plane through a ring
    of band/2 rows written out after step 2r + band - 1; the score from the
    H of the two cells on row q_len - 1 at the step pair they reach it,
    then an xor reduction (ties to the lower d). ``mutant``: "parity" moves
    the odd cells before the even ones, "no_up" / "no_down" drop a
    lane-edge exchange (every lane reads KS), "ring" keeps band/2 - 1 rows."""
    p = len(q_len)
    band = wlen - l
    cpl, h2, s_rows = band // 32, band // 64, band // 2
    m_, x_, o1, e1, o2, e2, do1, do2 = te.kernel_scoring(sc, l, band)
    if wide is None:
        wide = te.wide_substitution(m_, x_)
    mis4 = ((-x_) & 0xFF) * 0x01010101
    mxor = (m_ ^ ((-x_) & 0xFF)) & 0xFF
    c1, c2 = do1 + e1, do2 + e2
    lane = np.arange(32)
    hh, d0 = lane * h2, lane * cpl
    ql = np.asarray(q_len, np.int64)
    rows = np.full(p, l) if collect else np.minimum(l, np.maximum(ql, 0))
    qlast = np.where((ql >= 1) & (ql <= rows), ql - 1, -(1 << 30))
    lo64 = np.asarray(lo, np.int64)[:, None]
    vwidth = np.maximum(np.asarray(hi, np.int64), lo64[:, 0])[:, None] - lo64

    # the tables: [P, n, 2]
    qtab = np.zeros((p, l + 2 * s_rows, 2), np.int64)
    qtab[:, :, 0] = 5 if wide else 0
    qc = code_of(q_pack, np.arange(l))
    qtab[:, s_rows : s_rows + l, 0] = qc if wide else mis4 ^ (mxor << (8 * qc))
    qtab[:, s_rows : s_rows + l, 1] = -1 if wide else 0x0000F000
    x = np.arange(wlen)[None, :]
    ok = (x - lo64 >= 0) & (x - lo64 < vwidth)
    rc = code_of(r_pack, np.arange(wlen))
    wtab = np.zeros((p, wlen, 2), np.int64)
    if wide:
        wtab[:, :, 0], wtab[:, :, 1] = np.where(ok, rc, 4), np.where(ok, -x_, KS)
    else:
        wtab[:, :, 0] = np.where(ok, rc * 0x1111 + 0x8880, INVALID_SEL)

    def sub(qe, we):
        if wide:
            return np.where(we[..., 0] == qe[..., 0], m_, we[..., 1] & qe[..., 1])
        return prmt(qe[..., 0], qe[..., 1], we[..., 0])

    shape = (p, 32, cpl)
    h = np.zeros(shape, np.int64)
    j1, j2, pv, x1, x2 = (np.full(shape, KS, np.int64) for _ in range(5))
    # shift registers [P, 32, n, 2]: q[m] = qtab[S + s - hh - m], w[m] =
    # wtab[s + hh + m]
    q = np.stack([qtab[:, s_rows - hh - 1 - m] for m in range(h2)], axis=2)
    w = np.zeros((p, 32, h2 + 1, 2), np.int64)
    for m in range(h2):
        w[:, :, m + 1] = wtab[:, hh + m]
    slots = s_rows - 1 if mutant == "ring" else s_rows
    ring = np.zeros((p, slots, band), np.int64)
    plane = np.zeros((p, l if collect else 0, band), np.float32)
    bv = np.full((p, 32), np.iinfo(np.int32).min, np.int64)
    bd = np.zeros((p, 32), np.int64)
    pidx = np.arange(p)[:, None]
    el = np.where(lane == 0, EDGE, 0)[None, :]
    er = np.where(lane == 31, EDGE, 0)[None, :]

    def cell(c, row, sb, left, right, ke=(e1, e2), kx=(e1, e2)):
        """J = max(J[d+1] - e, H[d+1]), P = max(H + sub, J1 - o1, J2 - o2),
        X = max(X[d-1] - e, P[d-1]), H = max(P, X1 - c1, X2 - c2), each max
        a DPX add-and-max."""
        pl, xl1, xl2 = left
        hr, jr1, jr2 = right
        n1, n2 = np.maximum(jr1 - ke[0], hr), np.maximum(jr2 - ke[1], hr)
        pc = np.maximum(n1 - o1, np.maximum(n2 - o2, h[:, :, c] + sb))
        y1, y2 = np.maximum(xl1 - kx[0], pl), np.maximum(xl2 - kx[1], pl)
        h[:, :, c] = np.maximum(y1 - c1, np.maximum(y2 - c2, pc))
        j1[:, :, c], j2[:, :, c], pv[:, :, c], x1[:, :, c], x2[:, :, c] = n1, n2, pc, y1, y2
        if collect:
            ring[pidx, (row % slots)[None, :], (d0 + c)[None, :]] = pc

    def even(ib):
        """Cell 0 reads lane k-1's top cell by a shuffle up (lane 0 its own)."""
        pl, xl1, xl2 = (np.concatenate([a[:, :1, cpl - 1], a[:, :-1, cpl - 1]], axis=1) for a in (pv, x1, x2))
        if mutant == "no_up":
            pl, xl1, xl2 = (np.full_like(a, KS) for a in (pl, xl1, xl2))
        for m in range(h2):
            c = 2 * m
            sb = sub(q[:, :, m], w[:, :, m])
            if c == 0:
                cell(c, ib, sb, (pl - el, xl1, xl2), [a[:, :, 1] for a in (h, j1, j2)], kx=(e1 + el, e2 + el))
            else:
                cell(c, ib - m, sb, [a[:, :, c - 1] for a in (pv, x1, x2)], [a[:, :, c + 1] for a in (h, j1, j2)])

    def odd(ib):
        """The top cell reads lane k+1's cell 0 by a shuffle down (lane 31
        its own)."""
        hr, jr1, jr2 = (np.concatenate([a[:, 1:, 0], a[:, -1:, 0]], axis=1) for a in (h, j1, j2))
        if mutant == "no_down":
            hr, jr1, jr2 = (np.full_like(a, KS) for a in (hr, jr1, jr2))
        for m in range(h2):
            c = 2 * m + 1
            sb = sub(q[:, :, m], w[:, :, m + 1])
            left = [a[:, :, c - 1] for a in (pv, x1, x2)]
            if c == cpl - 1:
                cell(c, ib - m, sb, left, (hr - er, jr1, jr2), ke=(e1 + er, e2 + er))
            else:
                cell(c, ib - m, sb, left, [a[:, :, c + 1] for a in (h, j1, j2)])

    s_end = int(rows.max(initial=0)) + s_rows - 2
    for s in range(s_end + 1 if rows.max(initial=0) > 0 else 0):
        q[:, :, 1:] = q[:, :, :-1].copy()
        w[:, :, :-1] = w[:, :, 1:].copy()
        q[:, :, 0] = qtab[:, s_rows + s - hh]
        w[:, :, h2] = wtab[:, np.minimum(s + hh + h2, wlen - 1)]  # past wlen only for pairs done
        ib = s - hh
        for step in ((odd, even) if mutant == "parity" else (even, odd)):
            step(ib)
        r = s + 1 - s_rows
        if collect and r >= 0:
            out = r < rows
            plane[out, r] = to_f32(ring[out, r % slots])
        mq = ib[None, :] - qlast[:, None]
        for m in range(h2):
            for c in (2 * m, 2 * m + 1):
                take = (mq == m) & (h[:, :, c] > bv)
                bv, bd = np.where(take, h[:, :, c], bv), np.where(take, d0[None, :] + c, bd)
    off = 16
    while off:
        ov, od = bv[:, lane ^ off], bd[:, lane ^ off]
        take = (ov > bv) | ((ov == bv) & (od < bd))
        bv, bd = np.where(take, ov, bv), np.where(take, od, bd)
        off //= 2
    return to_f32(bv[:, 0]), bd[:, 0].astype(np.int32), plane


# --- cases -----------------------------------------------------------------------


def _wave_case(rng, p, l, band):
    """Reads planted in their windows (substitutions, indels), q_len of 0,
    1, 150 (where L allows) and L among random ones; windows cut at either
    contig edge or both, one with lo > hi, one with lo == hi, one wholly
    valid; the last row padding (codes 0, q_len 0, lo = hi = 0)."""
    wlen = l + band
    q = rng.integers(0, 4, (p, l)).astype(np.uint8)
    ql = rng.integers(0, l + 1, p).astype(np.int32)
    ql[:4] = [0, 1, min(150, l), l]
    r = rng.integers(0, 4, (p, wlen)).astype(np.uint8)
    for i in range(p):
        s = q[i, : max(int(ql[i]), 1)].copy()
        if i % 3 == 0 and len(s) > 8:
            s = np.delete(s, rng.integers(0, len(s), 2))
        elif i % 3 == 1:
            s = np.insert(s, rng.integers(0, len(s), 2), 1)
        flip = rng.random(len(s)) < 0.03
        s[flip] = (s[flip] + 1) % 4
        off = int(rng.integers(0, band // 2))
        n = min(len(s), wlen - off)
        r[i, off : off + n] = s[:n]
    lo = np.where(np.arange(p) % 3 == 0, rng.integers(1, band // 3, p), 0).astype(np.int32)
    hi = np.where(np.arange(p) % 4 == 1, wlen - rng.integers(1, band // 3, p), wlen).astype(np.int32)
    lo[4], hi[4] = wlen - 5, 7  # lo > hi: no column valid
    lo[5], hi[5] = 40, 40
    lo[6], hi[6] = 0, wlen
    q[-1], ql[-1], r[-1], lo[-1], hi[-1] = 0, 0, 0, 0, 0
    return q, ql, r, lo, hi, te.pack2bit(q), te.pack2bit(r)


def _want(q, ql, r, lo, hi, l, band, sc, collect):
    return te.extend_ref(*_t(q, ql, r, _mask(lo, hi, l + band)), sc, collect_plane=collect)


#: the routes the wavefront takes: (band, plane)
WAVE_ROUTES = [(band, plane) for (band, plane), g in te.PACKED_ROUTES.items() if g == 0]


def test_routes():
    """The wavefront takes both passes at band 128 and the score pass at
    band 256; every other route keeps the row body at 32 lanes, a lane
    count that band is built for."""
    assert sorted(WAVE_ROUTES) == [(128, False), (128, True), (256, False)]
    assert set(b for b, _ in te.PACKED_ROUTES) == set(te.KERNEL_LANES)
    for (band, plane), g in te.PACKED_ROUTES.items():
        assert g == 0 or g in te.KERNEL_LANES[band]
        assert te.packed_lanes(band, plane, 256) == g


@pytest.mark.parametrize("band,plane,longest", [(128, False, 14_400), (128, True, 12_352), (256, False, 14_272)])
def test_queries_past_the_wavefronts_shared_memory_take_the_row_body(band, plane, longest):
    """The wavefront holds a block's plane ring and tables in shared memory
    (232,448 bytes): one code longer and the pass takes the row body at 32
    lanes."""
    assert te.packed_lanes(band, plane, longest) == 0
    assert te.packed_lanes(band, plane, longest + 1) == 32


#: every band and pass the wavefront's instances are built for or could be:
#: the emulation holds the algorithm at all of them
EMULATED_ROUTES = [(128, False), (128, True), (256, False), (256, True), (384, False), (512, False)]


@pytest.mark.parametrize("band,collect", EMULATED_ROUTES)
@pytest.mark.parametrize("sc", [te.SrScoring(), WIDE], ids=["sr", "wide"])
def test_wave_emulation_equals_plain_version(band, collect, sc):
    """Every band and pass (the routes the wavefront takes among them), byte
    and wide substitution: score, end_d and plane equal extend_ref on the
    unpacked codes and mask."""
    p, l = 9, 160 if band <= 256 else 72
    q, ql, r, lo, hi, qp, rp = _wave_case(np.random.default_rng(band + collect), p, l, band)
    got = emulate_b4_wave(qp, ql, rp, lo, hi, l, l + band, sc, collect=collect)
    want = _want(q, ql, r, lo, hi, l, band, sc, collect)
    np.testing.assert_array_equal(got[0], want.score.numpy())
    np.testing.assert_array_equal(got[1], want.end_d.numpy())
    np.testing.assert_array_equal(got[2], want.p_plane.numpy())
    assert (want.score.numpy() > 0).sum() >= 3  # planted reads aligned
    assert want.score[0] == np.float32(-1e30) and want.score[-1] == np.float32(-1e30)


@pytest.mark.parametrize("band,collect", [(128, False), (128, True), (256, True), (512, False)])
def test_wave_emulation_equals_jax_packed_entry_points(band, collect):
    """The emulation against JAX's packed entry points on the packs and
    bounds themselves (-A 200 -B 150 at band 128's score pass)."""
    p, l = 8, 150 if band <= 256 else 64
    q, ql, r, lo, hi, qp, rp = _wave_case(np.random.default_rng(5 * band + collect), p, l, band)
    sc, jsc = (WIDE, JWIDE) if (band, collect) == (128, False) else (te.SrScoring(), je.SrScoring())
    got = emulate_b4_wave(qp, ql, rp, lo, hi, l, l + band, sc, collect=collect)
    args = (jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(rp), jnp.asarray(lo), jnp.asarray(hi), l, l + band)
    if collect:
        j = je.extend_banded_packed(*args, scoring=jsc)
        js, jd = j.score, j.end_d
        np.testing.assert_array_equal(got[2], np.asarray(j.p_plane))
    else:
        js, jd = je.extend_banded_scores_packed(*args, scoring=jsc)
    np.testing.assert_array_equal(got[0], np.asarray(js))
    np.testing.assert_array_equal(got[1], np.asarray(jd))


@pytest.mark.parametrize("band", [128, 256, 384, 512])
def test_wave_emulation_at_every_band_with_q_len_edges(band):
    """q_len 0, 1, 150 and L (and one past L: no row) at every band,
    with the windows' edges; score-only, as the score pass runs."""
    p, l = 8, 150
    q, ql, r, lo, hi, qp, rp = _wave_case(np.random.default_rng(band), p, l, band)
    ql[7] = l + 1
    got = emulate_b4_wave(qp, ql, rp, lo, hi, l, l + band)
    want = _want(q, ql, r, lo, hi, l, band, te.SrScoring(), False)
    np.testing.assert_array_equal(got[0], want.score.numpy())
    np.testing.assert_array_equal(got[1], want.end_d.numpy())
    assert got[0][7] == np.float32(-1e30) and got[1][7] == 0


def test_wave_emulation_all_invalid_windows_longer_than_the_band():
    """Windows wholly outside the contig (lo >= hi) at L past the band:
    every substitution the sentinel; the plane's cells too."""
    p, l, band = 8, 200, 128
    q, ql, r, lo, hi, qp, rp = _wave_case(np.random.default_rng(3), p, l, band)
    lo[:], hi[:] = 9, 0
    for collect in (False, True):
        got = emulate_b4_wave(qp, ql, rp, lo, hi, l, l + band, collect=collect)
        want = _want(q, ql, r, lo, hi, l, band, te.SrScoring(), collect)
        np.testing.assert_array_equal(got[0], want.score.numpy())
        np.testing.assert_array_equal(got[1], want.end_d.numpy())
        np.testing.assert_array_equal(got[2], want.p_plane.numpy())


@pytest.mark.parametrize("mutant", ["parity", "no_up", "no_down", "ring"])
def test_wave_emulation_mutants_differ(mutant):
    """Each mutant of the algorithm differs from extend_ref: the parity of
    a lane's cells off by one, a dropped lane-edge exchange, a ring of
    band/2 - 1 rows."""
    p, l, band = 8, 150, 128
    q, ql, r, lo, hi, qp, rp = _wave_case(np.random.default_rng(12), p, l, band)
    collect = True  # every cell's P: a wrong deletion or insertion anywhere shows
    bad = emulate_b4_wave(qp, ql, rp, lo, hi, l, l + band, collect=collect, mutant=mutant)
    want = _want(q, ql, r, lo, hi, l, band, te.SrScoring(), collect)
    good = emulate_b4_wave(qp, ql, rp, lo, hi, l, l + band, collect=collect)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(good, want))
    assert not all(np.array_equal(b, w.numpy()) for b, w in zip(bad, want))


@pytest.mark.parametrize("seed", range(4))
def test_running_deletion_recurrence_equals_keyed_prefix(seed):
    """The kernel's deletions D(d) = max(D(d-1) - e, P(d-1) - (open + e)),
    D(0) = KS, in int32 with KS for -1e30, equal the keyed exclusive prefix
    max of _extend_impl (phylign_tpu/ops/extend.py, delrow: cummax of P +
    d*e, shifted, minus open + d*e) in f32 with -1e30, on random P rows at
    the DP's magnitudes with runs of sentinel-derived cells."""
    rng = np.random.default_rng(seed)
    band, go, e = 128, [12, 32, 4, 0][seed], [2, 1, 2, 3][seed]
    real = rng.integers(-(2**22), 2**22, (64, band))
    sentinel = rng.random((64, band)) < [0.1, 0.5, 0.9, 1.0][seed]
    p_int = np.where(sentinel, KS - rng.integers(0, 2**20, (64, band)), real)
    p_f32 = np.where(sentinel, np.float32(-1e30), real.astype(np.float32)).astype(np.float32)
    rec = np.empty((64, band), np.int64)
    rec[:, 0] = KS
    for d in range(1, band):
        rec[:, d] = np.maximum(rec[:, d - 1] - e, p_int[:, d - 1] - (go + e))
    d_idx = np.arange(band, dtype=np.float32)
    cm = np.maximum.accumulate(p_f32 + d_idx * np.float32(e), axis=1)
    keyed = np.concatenate([np.full((64, 1), np.float32(-1e30)), cm[:, :-1]], axis=1) - np.float32(go) - d_idx * e
    np.testing.assert_array_equal(to_f32(rec), keyed.astype(np.float32))
    if seed < 3:
        assert (keyed > -1e29).any()
