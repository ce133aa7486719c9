"""The port's chain DP (``phylign_tpu_torch.ops.chain``, kernel B3's plain
version and the chain extraction around it) held to the JAX package's
``phylign_tpu.ops.chain`` on the CPU, and a numpy emulation of kernel B3's
own per-thread algorithm held to the plain version.

Tolerance: exact everywhere. The port's cost table emulates XLA-CPU's f32
evaluation of the JAX scan's cost expression (its log polynomial and fused
multiply-adds), so every ``ChainResult`` field, the f32 scores included,
equals JAX's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.ops import chain as jc
from phylign_tpu_torch.ops import chain as tc


def jax_cost_table(k: int, bandwidth: int) -> np.ndarray:
    """JAX's cost expression (chain.py:156) evaluated by XLA on the CPU."""
    kf = jnp.float32(k)
    dd = jnp.arange(bandwidth + 1, dtype=jnp.float32)
    return np.array(jax.jit(lambda d: 0.01 * kf * d + 0.5 * jnp.log2(d + 1.0))(dd))


@pytest.fixture
def jax_table(monkeypatch):
    """Run the port on XLA's cost table (to hold the DP itself exact)."""
    monkeypatch.setattr(tc, "cost_table", jax_cost_table)
    tc._cost_cache.clear()
    yield
    tc._cost_cache.clear()


def _sets(rng, p, a, rmax=400, qmax=200, pad_rows=2, fill=None):
    rp = np.full((p, a), jc.PAD_POS, np.int32)
    qp = np.full((p, a), jc.PAD_POS, np.int32)
    for i in range(p - pad_rows):
        n = a if fill == "full" else int(rng.integers(1, a + 1))
        r = rng.integers(0, max(rmax, 2 * n), n).astype(np.int32)
        q = rng.integers(0, max(qmax, n), n).astype(np.int32)
        o = np.lexsort((q, r))
        rp[i, :n], qp[i, :n] = r[o], q[o]
    return rp, qp


def _chain_like(rng, p, a):
    """Anchors mostly on one noisy diagonal (the long-read shape)."""
    rp = np.zeros((p, a), np.int32)
    qp = np.zeros((p, a), np.int32)
    for i in range(p):
        q = np.sort(rng.integers(0, 10_000, a)).astype(np.int32)
        drift = np.cumsum(rng.choice([-1, 0, 0, 0, 1], a))
        r = (q + 5_000 + drift).astype(np.int32)
        r = np.where(rng.random(a) < 0.1, rng.integers(0, 20_000, a), r).astype(np.int32)
        o = np.lexsort((q, r))
        rp[i], qp[i] = r[o], q[o]
    return rp, qp


def _both(rp, qp, **kw):
    j = jc.chain_anchors(jnp.asarray(rp), jnp.asarray(qp), **kw)
    t = tc.chain_anchors(torch.from_numpy(rp), torch.from_numpy(qp), **kw)
    return j, t


def _assert_exact(j, t):
    for name in j._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)


class TestCostTable:
    @pytest.mark.parametrize("k,band", [(21, 100), (15, 500), (19, 500), (21, 20_000)])
    def test_within_one_ulp_of_jax(self, k, band):
        """The port's table equals XLA-CPU's evaluation bit for bit (zero
        ulps), up to bandwidth 20,000."""
        mine, xla = tc.cost_table(k, band), jax_cost_table(k, band)
        assert mine.dtype == np.float32 and mine.shape == (band + 1,)
        np.testing.assert_array_equal(mine.view(np.int32), xla.view(np.int32))
        assert mine[0] == xla[0] == 0.0

    def test_pinned_ulp_miss(self):
        """xla_log / xla_log2 equal jnp.log / jnp.log2 on XLA-CPU for every
        integer in [1, 20001], where a correctly rounded log2 differs at
        thousands of them (first at 12)."""
        x = np.arange(1, 20_002, dtype=np.float32)
        np.testing.assert_array_equal(tc.xla_log(x), np.array(jax.jit(jnp.log)(x)))
        np.testing.assert_array_equal(tc.xla_log2(x), np.array(jax.jit(jnp.log2)(x)))
        rounded = np.log2(x.astype(np.float64)).astype(np.float32)
        assert np.flatnonzero(tc.xla_log2(x) != rounded)[0] == 12 - 1

    def test_op_order(self):
        # 0.01 * k is rounded to f32 first; its product with dd and the log
        # term are summed in one fused multiply-add (a single rounding)
        k, dd = 21, 37
        c = np.float32(np.float32(0.01) * np.float32(k))
        half_lg = np.float32(0.5) * tc.xla_log2(np.float32(dd + 1))
        want = np.float32(np.float64(c) * dd + np.float64(half_lg))
        assert tc.cost_table(k, 40)[dd] == want


class TestChainAnchorsVsJax:
    @pytest.mark.parametrize("a", [32, 64, 256, 1024])
    def test_exact_with_jax_table(self, jax_table, a):
        rng = np.random.default_rng(a)
        rp, qp = _sets(rng, 12, a)
        _assert_exact(*_both(rp, qp))

    def test_chain_like_a1024_exact_with_jax_table(self, jax_table):
        rng = np.random.default_rng(5)
        _assert_exact(*_both(*_chain_like(rng, 3, 1024)))

    @pytest.mark.parametrize("n_sup", [0, 1, 2])
    def test_n_sup(self, jax_table, n_sup):
        """n_sup = 0 (no split-read segments): JAX's function cannot stack
        zero segments, so the port's primary and s2 fields are held to
        JAX's n_sup = 2 run, which computes them the same way."""
        rng = np.random.default_rng(40 + n_sup)
        rp, qp = _sets(rng, 10, 64)
        j = jc.chain_anchors(jnp.asarray(rp), jnp.asarray(qp), n_sup=max(n_sup, 2))
        t = tc.chain_anchors(torch.from_numpy(rp), torch.from_numpy(qp), n_sup=n_sup)
        for name in j._fields:
            want = np.asarray(getattr(j, name))
            if name.startswith("sup_"):
                want = want[:, :n_sup]
            np.testing.assert_array_equal(getattr(t, name).numpy(), want, err_msg=name)
        assert t.sup_score.shape == (10, n_sup)

    def test_all_padding_rows(self, jax_table):
        rp = np.full((8, 32), jc.PAD_POS, np.int32)
        j, t = _both(rp, rp.copy())
        _assert_exact(j, t)
        assert (t.score.numpy() == np.float32(-1e30)).all()

    @pytest.mark.parametrize("a", [32, 64, 1024])
    def test_own_table(self, a):
        """With the port's own table: every field exact, the f32 scores
        (score, alt_score, sup_score) included."""
        rng = np.random.default_rng(100 + a)
        rp, qp = _sets(rng, 12, a)
        _assert_exact(*_both(rp, qp))

    def test_gapless_sets_exact_with_own_table(self):
        """Anchors on one diagonal: every chosen transition has dd = 0, where
        both tables are 0, so every field is exact."""
        q = np.arange(0, 130, 9, dtype=np.int32)
        rp = np.full((4, 32), jc.PAD_POS, np.int32)
        qp = np.full((4, 32), jc.PAD_POS, np.int32)
        rp[:3, : len(q)] = q + 1000
        qp[:3, : len(q)] = q
        _assert_exact(*_both(rp, qp))

    def test_packed_u16_entry(self, jax_table):
        rng = np.random.default_rng(7)
        rp, qp = _sets(rng, 9, 64, qmax=60_000)
        q16 = np.zeros(qp.shape, np.uint16)
        np.copyto(q16, qp, casting="unsafe", where=qp < jc.PAD_POS)
        j = jc.chain_anchors_packed(jnp.asarray(rp), jnp.asarray(q16))
        for qt in (torch.from_numpy(q16.view(np.int16)), torch.from_numpy(q16.astype(np.int32))):
            t = tc.chain_anchors_packed(torch.from_numpy(rp), qt)
            _assert_exact(j, t)

    @pytest.mark.parametrize("a", [48, 100])
    def test_window_not_a_bucket(self, jax_table, a):
        rng = np.random.default_rng(a)
        rp, qp = _sets(rng, 6, a)
        _assert_exact(*_both(rp, qp, lookback=20 if a == 100 else 64))


class TestDpEdgeCases:
    def _dp(self, rp, qp, cost=None, k=21, band=100):
        cost = torch.from_numpy(tc.cost_table(k, band) if cost is None else cost)
        return tc.chain_dp_ref(torch.from_numpy(rp), torch.from_numpy(qp), cost, k, 100, band)

    def test_exact_vs_full_oracle(self):
        # A <= LOOKBACK: the window covers every predecessor
        rng = np.random.default_rng(11)
        rp, qp = _sets(rng, 12, tc.LOOKBACK, pad_rows=0, fill="full")
        res = tc.chain_anchors(torch.from_numpy(rp), torch.from_numpy(qp))
        for i in range(12):
            score, cnt, qs, qe, rs, re = tc.chain_oracle(rp[i], qp[i])
            assert abs(float(res.score[i]) - score) < 1e-3, i
            assert int(res.count[i]) == cnt, i

    def test_parent_is_i_minus_w_plus_best_w(self):
        # A > LOOKBACK: parents index absolute slots through the window
        q = np.arange(0, 100 * 3, 3, dtype=np.int32)
        rp, qp = (q + 50)[None, :].astype(np.int32), q[None, :]
        f, par = self._dp(rp, qp)
        assert (par[0, 1:].numpy() == np.arange(99)).all()
        assert par[0, 0] == -1

    def test_strictly_better_than_seed_weight(self):
        # cost 1 everywhere: one step of dq = dr = 1 gains exactly 0 -> no
        # parent (mm2's `sc > max_f`)
        rp = np.array([[10, 11]], np.int32)
        qp = np.array([[5, 6]], np.int32)
        f, par = self._dp(rp, qp, cost=np.ones(101, np.float32))
        assert par.tolist() == [[-1, -1]] and f.tolist() == [[21.0, 21.0]]
        f, par = self._dp(rp, qp, cost=np.zeros(101, np.float32))
        assert par.tolist() == [[-1, 0]] and f.tolist() == [[21.0, 22.0]]

    def test_ties_go_to_the_nearest_predecessor(self):
        # slots 0 and 1 both reach slot 2 with the same candidate value
        rp = np.array([[100, 100, 110]], np.int32)
        qp = np.array([[0, 0, 10]], np.int32)
        f, par = self._dp(rp, qp)
        assert par[0, 2] == 1

    def test_padding_rows(self):
        rp = np.full((2, 64), tc.PAD_POS, np.int32)
        f, par = self._dp(rp, rp.copy())
        assert (f.numpy() == np.float32(-1e30)).all() and (par.numpy() == -1).all()

    def test_cpu_dispatch(self):
        rng = np.random.default_rng(3)
        rp, qp = _sets(rng, 4, 32)
        cost = torch.from_numpy(tc.cost_table(21, 100))
        args = (torch.from_numpy(rp), torch.from_numpy(qp), cost, 21, 100, 100)
        before = tc.launch_counts()
        a, b = tc.chain_dp(*args), tc.chain_dp_ref(*args)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert tc.launch_counts() == before
        with pytest.raises(ValueError, match="CUDA"):
            tc.chain_dp_cuda(*args)


# --- numpy emulation of kernel B3's own algorithm ------------------------------


def emulate_b3(rpos, qpos, cost, k, max_gap, bandwidth, lookback=tc.LOOKBACK, lanes=8):
    """chain_scan.cu step by step, vectorized over anchor sets: G = lanes
    lanes per set, lane t owning the window slots j with j % G == t as a
    shift register of SPL = (32 or 64)/G entries, newest first. At step i
    each lane scores its entries for slot i+1 over j in [i+1-W, i-1]
    (strict compare newest first: ties keep the larger j), an xor-shuffle
    argmax combines the lanes (ties to the larger j), and slot i itself
    takes the best over j <= i-2 reduced one step before, with j = i-1
    folded in alone (ties to i-1). Slot i then joins lane i % G."""
    f32 = np.float32
    p, a = rpos.shape
    w = min(lookback, a)
    g = lanes
    spl = (32 if w <= 32 else 64) // g
    t = np.arange(g)
    neg, pad, kf = f32(-1e30), f32(2e9), f32(k)
    gapf, bandf = f32(max_gap), f32(bandwidth)
    tab = cost[: min(bandwidth, max_gap) + 1]  # the shared-memory table
    valid = rpos < tc.PAD_POS
    rposf = np.concatenate([np.where(valid, rpos.astype(f32), pad), np.full((p, 2), pad, f32)], axis=1)
    qposf = np.concatenate([np.where(valid, qpos.astype(f32), pad), np.full((p, 2), pad, f32)], axis=1)

    def transition(ri, qi, rj, qj):
        dr, dq = ri - rj, qi - qj
        dd = np.abs(dr - dq)
        ok = (dr > 0) & (dq > 0) & (dr <= gapf) & (dq <= gapf) & (dd <= bandf)
        gain = np.minimum(np.minimum(dq, dr), kf)
        c = np.where(ok, tab[np.where(ok, dd, 0).astype(np.int64)], f32(0))
        return ok, gain, c

    rf = np.full((p, g, spl), neg, f32)
    rr = np.full((p, g, spl), pad, f32)
    rq = np.full((p, g, spl), pad, f32)
    jl = np.broadcast_to(t - g, (p, g)).copy()
    bv, bj = np.full(p, neg, f32), np.full(p, -1, np.int64)
    fprev = np.full(p, neg, f32)
    okp, gp, cp = np.zeros(p, bool), np.zeros(p, f32), np.zeros(p, f32)
    f = np.empty((p, a), f32)
    par = np.empty((p, a), np.int32)
    for i in range(a):
        ri, qi = rposf[:, i], qposf[:, i]
        rn, qn = rposf[:, i + 1, None], qposf[:, i + 1, None]
        nv, nj = np.full((p, g), neg, f32), np.full((p, g), -1, np.int64)
        for m in range(spl):
            j = jl - m * g
            ok, gain, c = transition(rn, qn, rr[:, :, m], rq[:, :, m])
            cand = np.where(ok & (j >= i + 1 - w), (rf[:, :, m] + gain) - c, neg).astype(f32)
            take = cand > nv
            nv, nj = np.where(take, cand, nv), np.where(take, j, nj)
        off = g // 2
        while off:
            ov, oj = nv[:, t ^ off], nj[:, t ^ off]
            take = (ov > nv) | ((ov == nv) & (oj > nj))
            nv, nj = np.where(take, ov, nv), np.where(take, oj, nj)
            off //= 2
        assert (nv == nv[:, :1]).all() and (nj == nj[:, :1]).all()
        cf = np.where(okp, (fprev + gp) - cp, neg).astype(f32)
        take = cf >= bv
        bv, bj = np.where(take, cf, bv), np.where(take, i - 1, bj)
        fi = np.maximum(bv, kf)
        f[:, i] = np.where(valid[:, i], fi, neg)
        par[:, i] = np.where(bv > kf, bj, -1)
        okp, gp, cp = transition(rn[:, 0], qn[:, 0], ri, qi)
        own = i % g
        rf[:, own], rr[:, own], rq[:, own] = (
            np.concatenate([v[:, None], arr[:, own, :-1]], axis=1)
            for v, arr in ((fi, rf), (ri, rr), (qi, rq))
        )
        jl[:, own] = i
        fprev, bv, bj = fi, nv[:, 0], nj[:, 0]
    return f, par


@pytest.mark.parametrize("lanes", tc.KERNEL_LANES)
@pytest.mark.parametrize("p,a,lookback", [(9, 32, 64), (9, 64, 64), (5, 48, 64), (4, 300, 64), (3, 100, 20), (4, 40, 1)])
def test_kernel_emulation_equals_plain_version(p, a, lookback, lanes):
    rng = np.random.default_rng(p * a + lookback)
    rp, qp = _sets(rng, p, a, rmax=3 * a, qmax=2 * a)
    cost = tc.cost_table(21, 100)
    f_e, par_e = emulate_b3(rp, qp, cost, 21, 100, 100, lookback, lanes)
    f_r, par_r = tc.chain_dp_ref(torch.from_numpy(rp), torch.from_numpy(qp), torch.from_numpy(cost), 21, 100, 100, lookback)
    np.testing.assert_array_equal(f_e, f_r.numpy())
    np.testing.assert_array_equal(par_e, par_r.numpy())


@pytest.mark.parametrize("lanes", tc.KERNEL_LANES)
def test_kernel_emulation_chain_like_ties_and_small_gap(lanes):
    """Long noisy diagonals (every window slot live, ties between equal
    anchors), and max_gap below the bandwidth (a table cut to max_gap)."""
    rng = np.random.default_rng(lanes)
    rp, qp = _chain_like(rng, 3, 200)
    rp[:, 50:60] = rp[:, 50:51]
    qp[:, 50:60] = qp[:, 50:51]
    for gap, band in ((5_000, 500), (40, 100)):
        cost = tc.cost_table(21, band)
        f_e, par_e = emulate_b3(rp, qp, cost, 21, gap, band, 64, lanes)
        f_r, par_r = tc.chain_dp_ref(torch.from_numpy(rp), torch.from_numpy(qp), torch.from_numpy(cost), 21, gap, band)
        np.testing.assert_array_equal(f_e, f_r.numpy())
        np.testing.assert_array_equal(par_e, par_r.numpy())
        assert (par_r.numpy() >= 0).mean() > 0.3


def test_lane_choice_fills_the_card_or_takes_a_warp():
    """Kernel B3's lanes per set: the fewest that give FILL_THREADS threads,
    a whole warp for the few sets of the long-read buckets."""
    assert [tc.chain_lanes(p) for p in (65536, 16384, 8192, 4096, 2048, 512, 8)] == [4, 4, 8, 16, 32, 32, 32]
