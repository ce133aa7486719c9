"""The port's banded extension (``phylign_tpu_torch.ops.extend``, kernel B4's
plain version and its entry points) held to the JAX package's
``phylign_tpu.ops.extend`` on the CPU, and a numpy emulation of kernel B4's
own per-thread algorithm held to the plain version, with the reads of its
unpacked instances and of its packed one (2-bit codes and [lo, hi) bounds,
the delegated extension's inputs).

Tolerance: exact. Every value is an integer-valued f32 or -1e30-based, so
the score, end_d and the P plane are compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.ops import extend as je
from phylign_tpu_torch.ops import extend as te


def _case(rng, p, l, band, edges=True):
    """Queries planted into their windows with substitutions and indels,
    q_len spanning 0..L, contig edges inside the window."""
    q = rng.integers(0, 4, (p, l)).astype(np.uint8)
    q_len = rng.integers(0, l + 1, p).astype(np.int32)
    q_len[: min(p, 3)] = [0, 1, l][: min(p, 3)]
    r = rng.integers(0, 4, (p, l + band)).astype(np.uint8)
    for i in range(p):
        s = q[i].copy()
        if i % 3 == 0:
            s = np.delete(s, rng.integers(0, l, 2))  # deletions from the read
        elif i % 3 == 1:
            s = np.insert(s, rng.integers(0, l, 2), 1)  # insertions in the ref
        flip = rng.random(len(s)) < 0.03
        s[flip] = (s[flip] + 1) % 4
        off = int(rng.integers(0, band // 2))
        n = min(len(s), l + band - off)
        r[i, off : off + n] = s[:n]
    if edges:
        lo = rng.integers(0, band // 3, p)
        hi = l + band - rng.integers(0, band // 3, p)
    else:
        lo, hi = np.zeros(p, np.int64), np.full(p, l + band)
    return q, q_len, r, lo.astype(np.int32), hi.astype(np.int32)


def _mask(lo, hi, wlen):
    cols = np.arange(wlen)[None, :]
    return (cols >= lo[:, None]) & (cols < hi[:, None])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


SHAPES = [(24, 64, 128), (16, 160, 128), (12, 96, 256), (9, 50, 256)]


@pytest.mark.parametrize("p,l,band", SHAPES)
class TestEntryPointsVsJax:
    def test_extend_banded(self, p, l, band):
        rng = np.random.default_rng(p + l + band)
        q, ql, r, lo, hi = _case(rng, p, l, band)
        v = _mask(lo, hi, l + band)
        j = je.extend_banded(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(v))
        t = te.extend_banded(*_t(q, ql, r, v))
        for name in ("score", "end_d", "p_plane"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)

    def test_extend_banded_scores(self, p, l, band):
        rng = np.random.default_rng(1 + p + l + band)
        q, ql, r, lo, hi = _case(rng, p, l, band)
        v = _mask(lo, hi, l + band)
        js, jd = je.extend_banded_scores(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(v))
        ts, td = te.extend_banded_scores(*_t(q, ql, r, v))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    def test_extend_banded_scores_packed(self, p, l, band):
        rng = np.random.default_rng(2 + p + l + band)
        q, ql, r, lo, hi = _case(rng, p, l, band)
        qp, rp = je.pack2bit(q), je.pack2bit(r)
        np.testing.assert_array_equal(te.pack2bit(q), qp)
        js, jd = je.extend_banded_scores_packed(
            jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(rp), jnp.asarray(lo), jnp.asarray(hi), l, l + band
        )
        ts, td = te.extend_banded_scores_packed(*_t(qp, ql, rp, lo, hi), l, l + band)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    def test_extend_banded_packed(self, p, l, band):
        rng = np.random.default_rng(3 + p + l + band)
        q, ql, r, lo, hi = _case(rng, p, l, band)
        qp, rp = je.pack2bit(q), je.pack2bit(r)
        j = je.extend_banded_packed(
            jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(rp), jnp.asarray(lo), jnp.asarray(hi), l, l + band
        )
        t = te.extend_banded_packed(*_t(qp, ql, rp, lo, hi), l, l + band)
        for name in ("score", "end_d", "p_plane"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)


def test_unpack_and_window_mask_vs_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, (5, 37)).astype(np.uint8)
    packed = te.pack2bit(a)
    np.testing.assert_array_equal(te._unpack2bit(torch.from_numpy(packed), 37).numpy(), a)
    np.testing.assert_array_equal(
        te._unpack2bit(torch.from_numpy(packed), 37).numpy(),
        np.asarray(je._unpack2bit(jnp.asarray(packed), 37)),
    )
    lo = np.array([0, 3, 10, 40, 2], np.int32)
    hi = np.array([40, 3, 20, 40, 39], np.int32)
    np.testing.assert_array_equal(
        te._window_mask(*_t(lo, hi), 40).numpy(), np.asarray(je._window_mask(jnp.asarray(lo), jnp.asarray(hi), 40))
    )


def test_scoring_presets_other_than_sr():
    """map-ont style scoring (smaller mismatch and gap costs) at band 256."""
    sc = te.SrScoring(match=2, mismatch=4, gap_open1=4, gap_ext1=2, gap_open2=24, gap_ext2=1)
    jsc = je.SrScoring(match=2, mismatch=4, gap_open1=4, gap_ext1=2, gap_open2=24, gap_ext2=1)
    rng = np.random.default_rng(9)
    q, ql, r, lo, hi = _case(rng, 10, 80, 256)
    v = _mask(lo, hi, 80 + 256)
    j = je.extend_banded(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(v), scoring=jsc)
    t = te.extend_banded(*_t(q, ql, r, v), scoring=sc)
    for name in ("score", "end_d", "p_plane"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)


def test_all_invalid_window_gives_neg_and_zero():
    q = np.zeros((3, 16), np.uint8)
    ql = np.array([16, 5, 0], np.int32)
    r = np.zeros((3, 16 + 128), np.uint8)
    v = np.zeros((3, 16 + 128), bool)
    t = te.extend_banded(*_t(q, ql, r, v))
    j = je.extend_banded(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(v))
    np.testing.assert_array_equal(t.score.numpy(), np.asarray(j.score))
    assert t.end_d.tolist() == [0, 0, 0]
    assert t.score[2] == np.float32(-1e30)


def test_cpu_dispatch_and_kernel_refuses_cpu():
    rng = np.random.default_rng(4)
    q, ql, r, lo, hi = _case(rng, 4, 32, 128)
    args = _t(q, ql, r, _mask(lo, hi, 160))
    before = te.launch_counts()
    a = te._extend_impl(*args, te.SrScoring(), True)
    b = te.extend_ref(*args, te.SrScoring(), True)
    assert torch.equal(a.p_plane, b.p_plane) and torch.equal(a.score, b.score)
    assert te.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        te.extend_cuda(*args)


# --- numpy emulation of kernel B4's own algorithm ------------------------------

KS, KT = -(2**28), -(2**27)  # the kernel's integer -1e30 and its threshold


def prmt(a, b, sel):
    """PTX prmt.b32 (generic mode), elementwise: byte n of the result is
    byte (nibble n of sel) & 7 of {b:a}, or that byte's sign replicated
    when the nibble has bit 3."""
    src = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    sel = np.asarray(sel, np.uint64)
    out = np.zeros(np.broadcast(src, sel).shape, np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(15)
        byte = (src >> (np.uint64(8) * (nib & np.uint64(7)))) & np.uint64(255)
        sign = np.where(byte & np.uint64(128), np.uint64(255), np.uint64(0))
        byte = np.where(nib & np.uint64(8), sign, byte)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32).view(np.int32).astype(np.int64)


def plain_reader(q, rwin, rvalid):
    """How B4's unpacked instances read their inputs: (query(i) -> the
    pairs' code of row i [P], column(cols) -> the pairs' codes and validity
    of window columns cols [P, n])."""
    return (lambda i: q[:, i]), (lambda cols: (rwin[:, cols], rvalid[:, cols]))


def packed_reader(q_pack, r_pack, lo, hi, shift=0):
    """How B4's packed instance reads its inputs: code j of a row is bits
    2*(j%4) of its byte j/4 (q_pack for the query, r_pack for the window),
    and window column j lies in the contig iff lo <= j < hi. ``shift``
    moves each code's bit offset by that many codes (a mutant)."""
    rows = np.arange(len(lo))[:, None]

    def code(packed, j):
        j = np.asarray(j)
        return (packed[rows, j >> 2] >> (2 * ((j & 3) + shift))) & 3

    def query(i):
        return code(q_pack, np.full((1, 1), i))[:, 0]

    def column(cols):
        cols = np.asarray(cols)[None, :]
        return code(r_pack, cols), (cols >= lo[:, None]) & (cols < hi[:, None])

    return query, column


def b4_reads(g, band, rows):
    """The window columns a group of g lanes reads for a pair of ``rows``
    rows, by lane ([G, n] with -1 for none): lane t's prologue reads its
    cells' columns t*CPL + c; the last lane then loads column band before
    the loop and i + band in row i while i + 1 < rows, each a row ahead of
    its use. And the query rows read: 0 before the loop (rows > 0), i + 1 in
    row i while i + 1 < rows."""
    cpl = band // g
    late = [band] + [i + band for i in range(rows - 1)]
    cols = np.full((g, cpl + len(late)), -1, np.int64)
    cols[:, :cpl] = np.arange(g)[:, None] * cpl + np.arange(cpl)[None, :]
    cols[g - 1, cpl:] = late
    return cols, np.arange(rows)


def emulate_b4_packed(q_pack, q_len, r_pack, lo, hi, l, wlen, sc=te.SrScoring(), collect=False, lanes=8,
                      wide=None, shift=0):
    """_emulate_b4 with the packed instance's reads (packed_reader)."""
    return _emulate_b4(packed_reader(q_pack, r_pack, lo, hi, shift), q_len, l, wlen - l, sc, collect, lanes, wide)


def emulate_b4(q, q_len, rwin, rvalid, sc=te.SrScoring(), collect=False, lanes=8, wide=None):
    """_emulate_b4 with the unpacked instances' reads (plain_reader)."""
    l = q.shape[1]
    return _emulate_b4(plain_reader(q, rwin, rvalid), q_len, l, rwin.shape[1] - l, sc, collect, lanes, wide)


def _emulate_b4(reader, q_len, l, band, sc, collect, lanes, wide):
    """extend_scan.cu step by step, vectorized over pairs: G = lanes lanes
    per pair of CPL = band/G consecutive cells (d = t*CPL + c); the DP in
    integers with KS for -1e30 and values below KT mapped back to -1e30;
    the substitution as a byte permute of a per-row table (or, in the wide
    instance the launch picks for scoring outside a signed byte, the
    selector's code compared with the query's: match, -mismatch, or KS
    for the invalid selector); window selectors
    slid one column a row through a width-G shuffle (the group's last lane
    loads the new column); the d+1 insertion shift through the same
    shuffle; deletions as the lane totals of the keyed values, a width-G
    Hillis-Steele scan of the totals, and a second in-lane pass; the row
    argmax in-lane and then an xor-shuffle reduction with ties to the lower
    d. Each pair runs to its own last row (q_len - 1, or L with the
    plane): the rows of a pair past it are masked. ``reader``: the codes
    and validity as an instance reads them (plain_reader, packed_reader)."""
    query, column = reader
    p = len(q_len)
    g = lanes
    cpl = band // g
    t = np.arange(g)
    m, x, o1, e1, o2, e2, do1, do2 = te.kernel_scoring(sc, l, band)
    if wide is None:
        wide = te.wide_substitution(m, x)
    mis4 = ((-x) & 0xFF) * 0x01010101
    mxor = (m ^ ((-x) & 0xFF)) & 0xFF
    col0 = t[:, None] * cpl + np.arange(cpl)[None, :]  # [G, CPL] = d
    de1, de2 = col0 * e1, col0 * e2

    def column_sel(cols):
        code, ok = column(cols)
        return np.where(ok, (code & 3).astype(np.int64) * 0x1111 + 0x8880, 0x5444)

    def to_f32(v):
        return np.where(v < KT, np.float32(-1e30), v.astype(np.float32))

    def shfl_down1(v):  # width G: the last lane reads its own value
        return v[:, np.minimum(t + 1, g - 1)]

    sel = column_sel(col0.reshape(-1)).reshape(p, g, cpl)
    h = np.zeros((p, g, cpl), np.int64)
    i1 = np.full((p, g, cpl), KS, np.int64)
    i2 = np.full((p, g, cpl), KS, np.int64)
    best = np.full(p, np.float32(-1e30), np.float32)
    best_d = np.zeros(p, np.int64)
    plane = np.zeros((p, l if collect else 0, band), np.float32)
    rows = np.full(p, l) if collect else np.minimum(l, np.maximum(q_len, 0))
    for i in range(int(rows.max(initial=0))):
        live = (i < rows)[:, None, None]
        if i > 0:
            nxt = shfl_down1(sel[:, :, 0])
            nxt[:, g - 1] = column_sel(np.full(1, i - 1 + band))[:, 0]
            sel = np.where(live, np.concatenate([sel[:, :, 1:], nxt[:, :, None]], axis=2), sel)
        qi = query(i).astype(np.int64) & 3
        lut = mis4 ^ (mxor << (8 * qi))
        edge = [shfl_down1(a[:, :, 0]) for a in (h, i1, i2)]
        for e_ in edge:
            e_[:, g - 1] = KS
        hn, i1n, i2n = (np.concatenate([a[:, :, 1:], e_[:, :, None]], axis=2) for a, e_ in zip((h, i1, i2), edge))
        if wide:
            qc = qi[:, None, None]
            sub = np.where(sel == 0x5444, KS, np.where((sel & 3) == qc, m, -x))
        else:
            sub = prmt(lut[:, None, None], 0x0000F000, sel)
        hd = h + sub
        n1 = np.maximum(i1n - e1, hn - o1)  # __viaddmax_s32
        n2 = np.maximum(i2n - e2, hn - o2)
        pm = np.maximum(np.maximum(hd, n1), n2)  # __vimax3_s32
        tot1 = np.maximum.reduce(pm + de1, axis=2, initial=KS)
        tot2 = np.maximum.reduce(pm + de2, axis=2, initial=KS)
        off = 1
        while off < g:
            up1, up2 = tot1[:, np.maximum(t - off, 0)], tot2[:, np.maximum(t - off, 0)]
            tot1 = np.where(t >= off, np.maximum(tot1, up1), tot1)
            tot2 = np.where(t >= off, np.maximum(tot2, up2), tot2)
            off *= 2
        run1, run2 = tot1[:, np.maximum(t - 1, 0)], tot2[:, np.maximum(t - 1, 0)]
        run1[:, 0] = run2[:, 0] = KS
        hnew = np.empty_like(h)
        for c in range(cpl):
            d1 = run1 - (do1 + de1[:, c])
            d2 = run2 - (do2 + de2[:, c])
            run1 = np.maximum(pm[:, :, c] + de1[:, c], run1)
            run2 = np.maximum(pm[:, :, c] + de2[:, c], run2)
            hnew[:, :, c] = np.maximum(np.maximum(pm[:, :, c], d1), d2)
        h = np.where(live, hnew, h)
        i1, i2 = np.where(live, n1, i1), np.where(live, n2, i2)
        if collect:
            plane[:, i] = to_f32(pm.reshape(p, band))
        last = q_len == i + 1
        if last.any():
            bv, bd = h[:, :, 0].copy(), np.broadcast_to(col0[:, 0], (p, g)).copy()
            for c in range(1, cpl):
                take = h[:, :, c] > bv
                bv, bd = np.where(take, h[:, :, c], bv), np.where(take, col0[:, c], bd)
            off = g // 2
            while off:
                ov, od = bv[:, t ^ off], bd[:, t ^ off]
                take = (ov > bv) | ((ov == bv) & (od < bd))
                bv, bd = np.where(take, ov, bv), np.where(take, od, bd)
                off //= 2
            best = np.where(last, to_f32(bv[:, 0]), best)
            best_d = np.where(last, bd[:, 0], best_d)
    return best, best_d.astype(np.int32), plane


EMULATED = [(band, g) for band, gs in te.KERNEL_LANES.items() for g in gs]


@pytest.mark.parametrize("band,lanes", EMULATED)
@pytest.mark.parametrize("collect", [False, True])
def test_kernel_emulation_equals_plain_version(band, lanes, collect):
    """Every (band, lanes) instance kernel B4 is built for; pairs of mixed
    q_len (0, 1, L and random) side by side in a group of pairs."""
    p, l = 10, 40 if band > 256 else 60
    rng = np.random.default_rng(p * l + band + lanes)
    q, ql, r, lo, hi = _case(rng, p, l, band)
    v = _mask(lo, hi, l + band)
    score, end_d, plane = emulate_b4(q, ql, r, v, collect=collect, lanes=lanes)
    want = te.extend_ref(*_t(q, ql, r, v), collect_plane=collect)
    np.testing.assert_array_equal(score, want.score.numpy())
    np.testing.assert_array_equal(end_d, want.end_d.numpy())
    np.testing.assert_array_equal(plane, want.p_plane.numpy())


@pytest.mark.parametrize("lanes", te.KERNEL_LANES[128])
def test_kernel_emulation_all_invalid_and_other_scoring(lanes):
    """An all-invalid window (every substitution the sentinel), a window
    valid in its first half only, and map-ont style scoring."""
    sc = te.SrScoring(match=2, mismatch=4, gap_open1=4, gap_ext1=2, gap_open2=24, gap_ext2=1)
    rng = np.random.default_rng(lanes)
    q, ql, r, lo, hi = _case(rng, 6, 48, 128)
    lo[:2], hi[:2] = 0, 0
    hi[2] = 88
    v = _mask(lo, hi, 48 + 128)
    score, end_d, plane = emulate_b4(q, ql, r, v, sc, collect=True, lanes=lanes)
    want = te.extend_ref(*_t(q, ql, r, v), sc, collect_plane=True)
    np.testing.assert_array_equal(score, want.score.numpy())
    np.testing.assert_array_equal(end_d, want.end_d.numpy())
    np.testing.assert_array_equal(plane, want.p_plane.numpy())
    assert (plane[:2] == np.float32(-1e30)).any()


@pytest.mark.parametrize(
    "scoring,l,match",
    [
        (te.SrScoring(match=2.5), 160, "integer"),
        (te.SrScoring(gap_ext1=-1), 160, "integer"),
        (te.SrScoring(match=200, mismatch=150), 45_000, "int32 DP limit"),
        (te.SrScoring(mismatch=200_000), 160, "int32 DP limit"),
        (te.SrScoring(), 250_000, "int32 DP limit"),
    ],
)
def test_kernel_scoring_refuses(scoring, l, match):
    with pytest.raises(ValueError, match=match):
        te.kernel_scoring(scoring, l, 128)


def test_kernel_scoring_of_the_sr_preset():
    assert te.kernel_scoring(te.SrScoring(), 160, 128) == (2, 8, 14, 2, 33, 1, 12, 32)


def test_lane_choice_by_band_and_pass():
    assert te.extend_lanes(128, False) == 8 and te.extend_lanes(128, True) == 16
    assert [te.extend_lanes(b, c) for b in (256, 384, 512) for c in (False, True)] == [16, 16, 32, 32, 32, 32]
    for (band, _), g in te.EXTEND_LANES.items():
        assert g in te.KERNEL_LANES[band]


WIDE = te.SrScoring(match=200, mismatch=150)  # -A 200 -B 150
JWIDE = je.SrScoring(match=200, mismatch=150)


def test_wide_scoring_is_taken():
    """Match or mismatch outside a signed byte takes B4's int32
    substitution; -A 200 -B 150 fits the int32 DP at L = 160 and at
    40,192 rows, not at 40,448 (417 a row at band 128)."""
    assert te.wide_substitution(200, 150) and te.wide_substitution(2, 129)
    assert not te.wide_substitution(127, 128)
    assert te.kernel_scoring(WIDE, 160, 128)[:2] == (200, 150)
    te.kernel_scoring(WIDE, 40_192, 128)
    with pytest.raises(ValueError, match="int32 DP limit"):
        te.kernel_scoring(WIDE, 40_448, 128)


@pytest.mark.parametrize("lanes", te.KERNEL_LANES[128])
@pytest.mark.parametrize("collect", [False, True])
def test_kernel_emulation_at_wide_scoring_equals_plain_and_jax(lanes, collect):
    """-A 200 -B 150: B4's wide instance, emulated, equals the plain
    version and JAX's f32 scan (score, end_d, plane); the byte instance's
    emulation at the sr preset forced through the wide path agrees too."""
    rng = np.random.default_rng(40 + lanes)
    q, ql, r, lo, hi = _case(rng, 8, 48, 128)
    v = _mask(lo, hi, 48 + 128)
    score, end_d, plane = emulate_b4(q, ql, r, v, WIDE, collect=collect, lanes=lanes)
    want = te.extend_ref(*_t(q, ql, r, v), WIDE, collect_plane=collect)
    np.testing.assert_array_equal(score, want.score.numpy())
    np.testing.assert_array_equal(end_d, want.end_d.numpy())
    np.testing.assert_array_equal(plane, want.p_plane.numpy())
    j = je.extend_banded(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(r), jnp.asarray(v), scoring=JWIDE)
    np.testing.assert_array_equal(score, np.asarray(j.score))
    np.testing.assert_array_equal(end_d, np.asarray(j.end_d))
    if collect:
        np.testing.assert_array_equal(plane, np.asarray(j.p_plane))
    assert (score >= 200 * 20).any()  # aligned reads, wide scores
    forced = emulate_b4(q, ql, r, v, collect=collect, lanes=lanes, wide=True)
    sr = te.extend_ref(*_t(q, ql, r, v), collect_plane=collect)
    np.testing.assert_array_equal(forced[0], sr.score.numpy())
    np.testing.assert_array_equal(forced[2], sr.p_plane.numpy())


def test_align_params_refuse_int32_limit_when_built_for_cuda(tmp_path):
    """A CUDA run checks its scoring against B4's int32 DP at its longest
    read (AlignParams.check_kernel, at the read's length bucket), before
    its match stage: large scoring aligns short reads (sr with -O 12,300
    scores 613 a row, 157,541 at 256 rows), and a read too long for it is
    refused (map-ont at -A 200 -B 150: 41 kb fits, 42 kb does not). A CPU
    run never checks: its plain version takes any scoring."""
    from phylign_tpu_torch.align.engine import AlignParams
    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.pipeline.stages import Pipeline

    for extra in ("-O 12,300", "-A 400 -B 200", "-A 200 -B 150"):
        AlignParams.from_preset("sr", extra).check_kernel(150)
    with pytest.raises(ValueError, match="int32 DP limit"):
        AlignParams.from_preset("sr", "-O 12,300").check_kernel(32_769)
    ont = AlignParams.from_preset("map-ont", "-A 200 -B 150")
    ont.check_kernel(41_000)
    with pytest.raises(ValueError, match="int32 DP limit"):
        ont.check_kernel(42_000)
    cfg = Config(minimap_preset="map-ont", minimap_extra_params="-A 200 -B 150")
    assert Pipeline(cfg, tmp_path, device="cpu").align_params(42_000).scoring.match == 200


# --- B4's packed instance (the delegated extension's two entry points) ---------


def _packed_case(rng, p, l, band):
    """_case's pairs as the delegated extension uploads them: both contig
    edges inside most windows (lo > 0, hi < wlen), one window with lo > hi,
    one wholly valid, and the last two rows padding (codes 0, q_len 0,
    lo = hi = 0). Returns the unpacked arrays, the packs and the bounds."""
    wlen = l + band
    q, ql, r, _, _ = _case(rng, p, l, band)
    lo = rng.integers(1, band // 3, p).astype(np.int32)
    hi = (wlen - rng.integers(1, band // 3, p)).astype(np.int32)
    lo[3], hi[3] = wlen - 5, 7
    lo[4], hi[4] = 0, wlen
    q[-2:], ql[-2:], r[-2:], lo[-2:], hi[-2:] = 0, 0, 0, 0, 0
    return q, ql, r, lo, hi, te.pack2bit(q), te.pack2bit(r)


#: (P, L, band): L and L + band not multiples of 4 (1, 2, 3 codes in a
#: row's last byte)
PACKED_SHAPES = [(12, 45, 128), (10, 130, 128), (9, 99, 256)]


@pytest.mark.parametrize("p,l,band", PACKED_SHAPES)
class TestPackedEntryPointsVsJax:
    """Windows cutting both contig edges, lo > hi and padding rows, at
    widths whose packed rows end in a part-filled byte."""

    def test_extend_banded_scores_packed(self, p, l, band):
        q, ql, r, lo, hi, qp, rp = _packed_case(np.random.default_rng(20 + p + l + band), p, l, band)
        js, jd = je.extend_banded_scores_packed(
            jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(rp), jnp.asarray(lo), jnp.asarray(hi), l, l + band
        )
        ts, td = te.extend_banded_scores_packed(*_t(qp, ql, rp, lo, hi), l, l + band)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert (ts.numpy() > 0).sum() >= p // 2  # planted reads aligned

    def test_extend_banded_packed(self, p, l, band):
        q, ql, r, lo, hi, qp, rp = _packed_case(np.random.default_rng(30 + p + l + band), p, l, band)
        j = je.extend_banded_packed(
            jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(rp), jnp.asarray(lo), jnp.asarray(hi), l, l + band
        )
        t = te.extend_banded_packed(*_t(qp, ql, rp, lo, hi), l, l + band)
        for name in ("score", "end_d", "p_plane"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
        # padding rows: no valid column, so no diagonal move scores
        assert (t.score[-2:] == np.float32(-1e30)).all() and (t.p_plane[-2:] < 0).all()


@pytest.mark.parametrize("band,lanes", EMULATED)
@pytest.mark.parametrize("l", [45, 62])
def test_packed_reads_equal_unpack_and_window_mask(band, lanes, l):
    """Every window column a lane of the group reads (its prologue's cells,
    then the last lane's column a row) and every query code a row reads,
    read from the packs and [lo, hi) as the packed instance reads them,
    equal _unpack2bit and _window_mask there, the port's and JAX's; no read
    reaches column wlen or query code l (the packing's padding codes)."""
    p, wlen = 10, l + band
    q, ql, r, lo, hi, qp, rp = _packed_case(np.random.default_rng(band + lanes + l), p, l, band)
    query, column = packed_reader(qp, rp, lo, hi)
    cols, qrows = b4_reads(lanes, band, l)
    assert cols.max() < wlen and qrows.max() < l
    want_r = te._unpack2bit(torch.from_numpy(rp), wlen).numpy()
    want_v = te._window_mask(*_t(lo, hi), wlen).numpy()
    want_q = te._unpack2bit(torch.from_numpy(qp), l).numpy()
    np.testing.assert_array_equal(want_r, np.asarray(je._unpack2bit(jnp.asarray(rp), wlen)))
    np.testing.assert_array_equal(want_v, np.asarray(je._window_mask(jnp.asarray(lo), jnp.asarray(hi), wlen)))
    np.testing.assert_array_equal(want_q, np.asarray(je._unpack2bit(jnp.asarray(qp), l)))
    np.testing.assert_array_equal(want_r, r)
    for t in range(lanes):
        lane_cols = cols[t][cols[t] >= 0]
        code, ok = column(lane_cols)
        np.testing.assert_array_equal(code, want_r[:, lane_cols], err_msg=f"lane {t}")
        np.testing.assert_array_equal(ok, want_v[:, lane_cols], err_msg=f"lane {t}")
    for i in qrows:
        np.testing.assert_array_equal(query(i), want_q[:, i], err_msg=f"row {i}")
    assert not want_v[3].any() and want_v[4].all() and not want_v[-2:].any()
    assert want_v[:3, 0].sum() == 0 and want_v[:3, -1].sum() == 0  # both edges cut


def test_packed_reads_catch_a_shifted_code():
    """A mutant that reads each code one code off in its byte differs from
    the unpack, in the reads and in the DP's results."""
    p, l, band = 10, 45, 128
    q, ql, r, lo, hi, qp, rp = _packed_case(np.random.default_rng(5), p, l, band)
    query, column = packed_reader(qp, rp, lo, hi, shift=1)
    cols, _ = b4_reads(8, band, l)
    code, _ = column(cols[-1][cols[-1] >= 0])
    assert not np.array_equal(code, r[:, cols[-1][cols[-1] >= 0]])
    assert not np.array_equal(query(1), q[:, 1])
    bad = emulate_b4_packed(qp, ql, rp, lo, hi, l, l + band, shift=1)
    want = te.extend_ref(*_t(q, ql, r, _mask(lo, hi, l + band)))
    assert not np.array_equal(bad[0], want.score.numpy())


@pytest.mark.parametrize("band,lanes", EMULATED)
@pytest.mark.parametrize("collect", [False, True])
def test_packed_kernel_emulation_equals_plain_version(band, lanes, collect):
    """The packed instance's DP, emulated on its own reads, equals the plain
    version on the unpacked codes and mask: score, end_d and plane."""
    p, l = 10, 37 if band > 256 else 61
    q, ql, r, lo, hi, qp, rp = _packed_case(np.random.default_rng(p * l + band + lanes), p, l, band)
    got = emulate_b4_packed(qp, ql, rp, lo, hi, l, l + band, collect=collect, lanes=lanes)
    want = te.extend_ref(*_t(q, ql, r, _mask(lo, hi, l + band)), collect_plane=collect)
    np.testing.assert_array_equal(got[0], want.score.numpy())
    np.testing.assert_array_equal(got[1], want.end_d.numpy())
    np.testing.assert_array_equal(got[2], want.p_plane.numpy())


@pytest.mark.parametrize("collect", [False, True])
def test_packed_kernel_emulation_at_wide_scoring(collect):
    """-A 200 -B 150 (the wide instance) through the packed reads: equal to
    the plain version and to JAX's packed entry point."""
    p, l, band = 10, 45, 128
    q, ql, r, lo, hi, qp, rp = _packed_case(np.random.default_rng(77), p, l, band)
    got = emulate_b4_packed(qp, ql, rp, lo, hi, l, l + band, WIDE, collect=collect)
    want = te.extend_ref(*_t(q, ql, r, _mask(lo, hi, l + band)), WIDE, collect_plane=collect)
    np.testing.assert_array_equal(got[0], want.score.numpy())
    np.testing.assert_array_equal(got[2], want.p_plane.numpy())
    args = (jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(rp), jnp.asarray(lo), jnp.asarray(hi), l, l + band)
    if collect:
        j = je.extend_banded_packed(*args, scoring=JWIDE)
        np.testing.assert_array_equal(got[2], np.asarray(j.p_plane))
    else:
        j = je.extend_banded_scores_packed(*args, scoring=JWIDE)
        np.testing.assert_array_equal(got[1], np.asarray(j[1]))
    np.testing.assert_array_equal(got[0], np.asarray(j[0]))


def test_packed_dispatch_by_device():
    """A CPU tensor takes the plain version (no launch); the packed kernel
    refuses CPU tensors; any other device raises."""
    p, l, band = 6, 33, 128
    q, ql, r, lo, hi, qp, rp = _packed_case(np.random.default_rng(8), p, l, band)
    before = te.launch_counts()
    a = te.extend_banded_packed(*_t(qp, ql, rp, lo, hi), l, l + band)
    b = te.extend_ref(*_t(q, ql, r, _mask(lo, hi, l + band)), collect_plane=True)
    assert torch.equal(a.p_plane, b.p_plane) and torch.equal(a.score, b.score)
    assert te.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        te.extend_cuda_packed(*_t(qp, ql, rp, lo, hi), l, l + band)
    meta = [t.to("meta") for t in _t(qp, ql, rp, lo, hi)]
    with pytest.raises(ValueError, match="no extension kernel"):
        te.extend_banded_scores_packed(*meta, l, l + band)
