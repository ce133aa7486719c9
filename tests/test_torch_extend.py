"""The port's banded extension (``phylign_tpu_torch.ops.extend``, kernel B4's
plain version and its entry points) held to the JAX package's
``phylign_tpu.ops.extend`` on the CPU, and a numpy emulation of kernel B4's
own per-thread algorithm held to the plain version.

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


def emulate_b4(q, q_len, rwin, rvalid, sc=te.SrScoring(), collect=False):
    """extend_scan.cu step by step, vectorized over pairs: 32 lanes of
    CPL = band/32 consecutive cells (d = lane*CPL + c); window codes slid
    one column a row through a shuffle at the lane edge (lane 31 loads the
    new column); the d+1 insertion shift through the same shuffle; the
    deletions' exclusive prefix max as an in-lane scan plus a Hillis-Steele
    shuffle scan of the lane totals; the row argmax in-lane and then an
    xor-shuffle reduction with ties to the lower d. Pairs stop after row
    q_len - 1 unless the plane is collected (rows past it are skipped per
    pair by masking)."""
    f32 = np.float32
    p, l = q.shape
    band = rwin.shape[1] - l
    cpl = band // 32
    lanes = np.arange(32)
    neg = f32(-1e30)
    match, mis = f32(sc.match), f32(sc.mismatch)
    o1, e1 = f32(sc.gap_open1 + sc.gap_ext1), f32(sc.gap_ext1)
    o2, e2 = f32(sc.gap_open2 + sc.gap_ext2), f32(sc.gap_ext2)
    do1, do2 = f32(sc.gap_open1), f32(sc.gap_open2)
    d = (lanes[:, None] * cpl + np.arange(cpl)[None, :]).astype(f32)  # [32, CPL]
    de1, de2 = d * e1, d * e2
    col0 = lanes[:, None] * cpl + np.arange(cpl)[None, :]
    rc = rwin[:, col0].astype(np.int64) | np.where(rvalid[:, col0], 256, 0)
    h = np.zeros((p, 32, cpl), f32)
    i1 = np.full((p, 32, cpl), neg, f32)
    i2 = np.full((p, 32, cpl), neg, f32)
    best = np.full(p, neg, f32)
    best_d = np.zeros(p, np.int64)
    plane = np.zeros((p, l if collect else 0, band), f32)
    rows = l if collect else int(max(q_len.max(initial=0), 0))

    def shfl_down1(x, edge):
        y = x[:, np.minimum(lanes + 1, 31)]
        y[:, 31] = edge
        return y

    def excl_prefix_max(keyed):
        out = np.empty_like(keyed)
        run = np.full((p, 32), neg, f32)
        for c in range(cpl):
            out[:, :, c] = run
            run = np.maximum(run, keyed[:, :, c])
        v = run
        off = 1
        while off < 32:
            t = v[:, np.maximum(lanes - off, 0)]
            v = np.where(lanes >= off, np.maximum(v, t), v)
            off *= 2
        before = v[:, np.maximum(lanes - 1, 0)]
        before[:, 0] = neg
        return np.maximum(before[:, :, None], out)

    for i in range(rows):
        if i > 0:
            newcol = rwin[:, i - 1 + band].astype(np.int64) | np.where(rvalid[:, i - 1 + band], 256, 0)
            nxt = shfl_down1(rc[:, :, 0], newcol)
            rc = np.concatenate([rc[:, :, 1:], nxt[:, :, None]], axis=2)
        qc = q[:, i].astype(np.int64)[:, None, None]
        hn = np.concatenate([h[:, :, 1:], shfl_down1(h[:, :, 0], neg)[:, :, None]], axis=2)
        i1n = np.concatenate([i1[:, :, 1:], shfl_down1(i1[:, :, 0], neg)[:, :, None]], axis=2)
        i2n = np.concatenate([i2[:, :, 1:], shfl_down1(i2[:, :, 0], neg)[:, :, None]], axis=2)
        sub = np.where(rc & 256, np.where((rc & 255) == qc, match, -mis), neg).astype(f32)
        hd = h + sub
        i1 = np.maximum(hn - o1, i1n - e1)
        i2 = np.maximum(hn - o2, i2n - e2)
        pm = np.maximum(hd, np.maximum(i1, i2))
        x1 = excl_prefix_max(pm + de1)
        x2 = excl_prefix_max(pm + de2)
        h = np.maximum(pm, np.maximum((x1 - do1) - de1, (x2 - do2) - de2))
        if collect:
            plane[:, i] = pm.reshape(p, band)
        last = q_len == i + 1
        if last.any():
            bv = h[:, :, 0].copy()
            bd = np.broadcast_to(col0[:, 0], (p, 32)).copy()
            for c in range(1, cpl):
                take = h[:, :, c] > bv
                bv = np.where(take, h[:, :, c], bv)
                bd = np.where(take, col0[:, c], bd)
            for off in (16, 8, 4, 2, 1):
                ov, od = bv[:, lanes ^ off], bd[:, lanes ^ off]
                take = (ov > bv) | ((ov == bv) & (od < bd))
                bv, bd = np.where(take, ov, bv), np.where(take, od, bd)
            best = np.where(last, bv[:, 0], best)
            best_d = np.where(last, bd[:, 0], best_d)
    return best, best_d.astype(np.int32), plane


@pytest.mark.parametrize("p,l,band", [(14, 48, 128), (10, 70, 256), (6, 40, 512)])
@pytest.mark.parametrize("collect", [False, True])
def test_kernel_emulation_equals_plain_version(p, l, band, collect):
    rng = np.random.default_rng(p * l + band)
    q, ql, r, lo, hi = _case(rng, p, l, band)
    v = _mask(lo, hi, l + band)
    score, end_d, plane = emulate_b4(q, ql, r, v, collect=collect)
    want = te.extend_ref(*_t(q, ql, r, v), collect_plane=collect)
    np.testing.assert_array_equal(score, want.score.numpy())
    np.testing.assert_array_equal(end_d, want.end_d.numpy())
    np.testing.assert_array_equal(plane, want.p_plane.numpy())
