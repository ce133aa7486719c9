"""The port's chain DP (``phylign_tpu_torch.ops.chain``, kernel B3's plain
version and the chain extraction around it) held to the JAX package's
``phylign_tpu.ops.chain`` on the CPU, and a numpy emulation of kernel B3's
own per-thread algorithm held to the plain version.

Tolerances: exact everywhere, with one pinned exception. The port's cost
table rounds log2 correctly; XLA's CPU log2 is an approximation that is one
unit in the last place (ulp) off for some dd (FIRST_ULP_DD below). Given
JAX's own table, the port equals JAX on every field bit for bit; with its
own table the integer fields are equal and the f32 scores agree to 1e-5
relative (a one-ulp difference in a cost, carried along a chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.ops import chain as jc
from phylign_tpu_torch.ops import chain as tc

#: the first integer dd at which the port's cost table and XLA-CPU's
#: evaluation of JAX's expression differ (by one ulp), at k = 21
FIRST_ULP_DD = 5

INT_FIELDS = ("count", "qs", "qe", "rs", "re", "alt_qs", "alt_qe", "alt_rs",
              "alt_re", "sup_count", "sup_qs", "sup_qe", "sup_rs", "sup_re")
FLOAT_FIELDS = ("score", "alt_score", "sup_score")


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
    @pytest.mark.parametrize("k,band", [(21, 100), (15, 500), (19, 500)])
    def test_within_one_ulp_of_jax(self, k, band):
        mine, xla = tc.cost_table(k, band), jax_cost_table(k, band)
        assert mine.dtype == np.float32 and mine.shape == (band + 1,)
        ulps = np.abs(mine.view(np.int32).astype(np.int64) - xla.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
        assert mine[0] == xla[0] == 0.0

    def test_pinned_ulp_miss(self):
        """Pinned (ROADMAP queue C): the two tables differ by one ulp, first
        at dd = FIRST_ULP_DD for k = 21; the port's value is the correctly
        rounded one."""
        mine, xla = tc.cost_table(21, 100), jax_cost_table(21, 100)
        diff = np.flatnonzero(mine != xla)
        assert diff.size and diff[0] == FIRST_ULP_DD
        exact = np.float32(np.float32(0.21) * np.float32(FIRST_ULP_DD)) + np.float32(
            np.float32(0.5) * np.float32(np.log2(np.float64(FIRST_ULP_DD + 1)))
        )
        assert mine[FIRST_ULP_DD] == exact

    def test_op_order(self):
        # 0.01 * k is rounded to f32 before the product with dd
        k, dd = 21, np.float32(37)
        want = np.float32(np.float32(np.float32(0.01) * np.float32(k)) * dd) + np.float32(
            0.5 * np.float32(np.log2(38.0))
        )
        assert tc.cost_table(k, 40)[37] == want


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
        """With the port's own table: integer fields exact, scores within
        1e-5 relative (the pinned one-ulp cost differences)."""
        rng = np.random.default_rng(100 + a)
        rp, qp = _sets(rng, 12, a)
        j, t = _both(rp, qp)
        for name in INT_FIELDS:
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
        for name in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), rtol=1e-5, err_msg=name)

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


def emulate_b3(rpos, qpos, cost, k, max_gap, bandwidth, lookback=tc.LOOKBACK):
    """chain_scan.cu step by step, vectorized over anchor sets: 32 lanes,
    ring slot s = lane + 32*c (c = 0, 1) holding the slot j with j % W == s,
    each lane's best over its ring slots (ties to the larger j), then the
    5-round xor-shuffle max (ties to the larger j); the owner lane writes
    the ring slot; padding rows at 2e9 in f32."""
    f32 = np.float32
    p, a = rpos.shape
    w = min(lookback, a)
    lanes = np.arange(32)
    neg, pad, kf = f32(-1e30), f32(2e9), f32(k)
    gapf, bandf = f32(max_gap), f32(bandwidth)
    valid = rpos < tc.PAD_POS
    rposf = np.where(valid, rpos.astype(f32), pad)
    qposf = np.where(valid, qpos.astype(f32), pad)
    rf = np.full((p, 2, 32), neg, f32)
    rr = np.full((p, 2, 32), pad, f32)
    rq = np.full((p, 2, 32), pad, f32)
    rj = np.full((p, 2, 32), -1, np.int64)
    has = [lanes + 32 * c < w for c in range(2)]
    f = np.empty((p, a), f32)
    par = np.empty((p, a), np.int32)
    for i in range(a):
        ri, qi = rposf[:, i : i + 1], qposf[:, i : i + 1]
        bv = np.full((p, 32), neg, f32)
        bj = np.full((p, 32), -1, np.int64)
        for c in range(2):
            dr = ri - rr[:, c]
            dq = qi - rq[:, c]
            dd = np.abs(dr - dq)
            ok = (dr > 0) & (dq > 0) & (dr <= gapf) & (dq <= gapf) & (dd <= bandf)
            gain = np.minimum(np.minimum(dq, dr), kf)
            c_dd = cost[np.clip(dd, 0, bandwidth).astype(np.int64)]
            cand = np.where(ok, (rf[:, c] + gain) - c_dd, neg).astype(f32)
            take = has[c] & ((cand > bv) | ((cand == bv) & (rj[:, c] > bj)))
            bv, bj = np.where(take, cand, bv), np.where(take, rj[:, c], bj)
        for off in (16, 8, 4, 2, 1):
            ov, oj = bv[:, lanes ^ off], bj[:, lanes ^ off]
            take = (ov > bv) | ((ov == bv) & (oj > bj))
            bv, bj = np.where(take, ov, bv), np.where(take, oj, bj)
        assert (bv == bv[:, :1]).all() and (bj == bj[:, :1]).all()
        fi = np.maximum(bv[:, 0], kf)
        c, lane = divmod(i % w, 32)
        rf[:, c, lane], rr[:, c, lane], rq[:, c, lane], rj[:, c, lane] = fi, ri[:, 0], qi[:, 0], i
        f[:, i] = np.where(valid[:, i], fi, neg)
        par[:, i] = np.where(bv[:, 0] > kf, bj[:, 0], -1)
    return f, par


@pytest.mark.parametrize("p,a,lookback", [(9, 32, 64), (9, 64, 64), (5, 48, 64), (4, 300, 64), (3, 100, 20)])
def test_kernel_emulation_equals_plain_version(p, a, lookback):
    rng = np.random.default_rng(p * a + lookback)
    rp, qp = _sets(rng, p, a, rmax=3 * a, qmax=2 * a)
    cost = tc.cost_table(21, 100)
    f_e, par_e = emulate_b3(rp, qp, cost, 21, 100, 100, lookback)
    f_r, par_r = tc.chain_dp_ref(torch.from_numpy(rp), torch.from_numpy(qp), torch.from_numpy(cost), 21, 100, 100, lookback)
    np.testing.assert_array_equal(f_e, f_r.numpy())
    np.testing.assert_array_equal(par_e, par_r.numpy())
