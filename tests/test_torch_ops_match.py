"""The port's match scoring (phylign_tpu_torch.ops.match) against the JAX
package's: the plain PyTorch version against ``match_scores_xla`` and both
Pallas kernels in interpret mode, and numpy emulations of the two CUDA
kernels' own per-thread algorithms (launch geometry, shared-memory staging,
per-bit counters for B1, carry-save bit planes for B2) against the plain
version. All values are integers: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.ops import match as jopm
from phylign_tpu_torch.ops import match as opm


def rand_words(rng, s, wp, density=0.5):
    """uint32 [S+1, Wp] with the zero padding row; ``density`` 0.25 is the
    AND of two random words."""
    w = rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    if density == 0.25:
        w &= rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    out = np.zeros((s + 1, wp), np.uint32)
    out[:s] = w
    return out


def rand_rows(rng, s, q, k, h, n_pad_queries=2):
    """int32 [Q, K, H] rows with padding slots and all-padding queries."""
    r = rng.integers(0, s, (q, k, h)).astype(np.int32)
    r[rng.random((q, k)) < 0.1] = s  # padding slots
    r[q - n_pad_queries :] = s  # all-padding queries
    return r


def ref(words: np.ndarray, rows: np.ndarray) -> np.ndarray:
    return opm.match_scores_ref(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows)
    ).numpy()


class TestRefAgainstJax:
    @pytest.mark.parametrize("h", [1, 2, 3])
    @pytest.mark.parametrize("k", [64, 128])
    def test_matches_xla(self, h, k):
        """Q=11 (not a multiple of the TPU's 8-query tile), Wp=3 (96 docs,
        > 32), with padding slots and all-padding queries."""
        rng = np.random.default_rng(100 * h + k)
        words = rand_words(rng, 700, 3)
        rows = rand_rows(rng, 700, 11, k, h)
        want = np.asarray(jopm.match_scores_xla(jnp.asarray(words), jnp.asarray(rows)))
        np.testing.assert_array_equal(ref(words, rows), want)
        assert want[-2:].sum() == 0

    def test_two_dim_rows(self):
        rng = np.random.default_rng(3)
        words = rand_words(rng, 300, 2)
        rows = rand_rows(rng, 300, 5, 64, 1)[..., 0]
        want = np.asarray(jopm.match_scores_xla(jnp.asarray(words), jnp.asarray(rows)))
        np.testing.assert_array_equal(ref(words, rows), want)

    @pytest.mark.parametrize("h,k", [(1, 64), (3, 64), (2, 96)])
    def test_matches_pallas_v1_interpret(self, h, k):
        """As tests/test_ops_match.py runs the Pallas kernel: words padded
        to 128-word lanes, interpret mode. Q=5 pads to one 8-query tile."""
        rng = np.random.default_rng(7 + h)
        words = rand_words(rng, 400, jopm.LANE_WORDS)
        rows = rand_rows(rng, 400, 5, k, h)
        want = np.asarray(
            jopm.match_scores_pallas(
                jnp.asarray(words), jnp.asarray(rows), interpret=True
            )
        )
        np.testing.assert_array_equal(ref(words, rows), want)

    @pytest.mark.parametrize("k", [64, 128])
    def test_matches_pallas_v2_interpret(self, k):
        rng = np.random.default_rng(k)
        words = rand_words(rng, 512, jopm.LANE_WORDS)
        rows = rand_rows(rng, 512, 5, k, 1)[..., 0]
        want = np.asarray(
            jopm.match_scores_pallas_v2(
                jnp.asarray(words), jnp.asarray(rows), interpret=True
            )
        )
        np.testing.assert_array_equal(ref(words, rows), want)

    def test_chunking_is_exact(self, monkeypatch):
        """The Q-chunked loop (tiny chunk budget -> many chunks) changes
        nothing."""
        rng = np.random.default_rng(11)
        words = rand_words(rng, 200, 4)
        rows = rand_rows(rng, 200, 13, 64, 2)
        whole = ref(words, rows)
        monkeypatch.setattr(opm, "_REF_CHUNK_BYTES", 1)
        np.testing.assert_array_equal(ref(words, rows), whole)

    def test_dedup_equals_direct(self):
        """match_scores_dedup over dedup_rows' (uniq, inv) pair equals the
        direct scores (reads sharing most k-mers, padding slots, H=1, 3)."""
        rng = np.random.default_rng(5)
        s = 5000
        words = rand_words(rng, s, 3)
        wt = torch.from_numpy(words.view(np.int32))
        for h in (1, 3):
            pool = rng.integers(0, s, (32, h)).astype(np.int32)
            rows = pool[rng.integers(0, 32, (64, 64))]
            rows[:, 60:] = s
            dd = opm.dedup_rows(rows, s, words.shape[1])
            assert dd is not None
            got = opm.match_scores_dedup(
                wt, torch.from_numpy(dd[0]), torch.from_numpy(dd[1])
            ).numpy()
            np.testing.assert_array_equal(got, ref(words, rows))

    def test_copied_helpers_match_jax(self):
        rng = np.random.default_rng(2)
        w = rng.integers(0, 2**32, (5, 3), dtype=np.uint32)
        for lane in (1, 4, 128):
            np.testing.assert_array_equal(
                opm.pad_device_words(w, lane), jopm.pad_device_words(w, lane)
            )
        per_q = [rng.integers(0, 50, (n, 2)) for n in (0, 3, 7)]
        for a, b in zip(
            opm.pack_row_indices(per_q, 8, 50, 2),
            jopm.pack_row_indices(per_q, 8, 50, 2),
        ):
            np.testing.assert_array_equal(a, b)
        rows = rng.integers(0, 20, (16, 64)).astype(np.int32)
        for a, b in zip(opm.dedup_rows(rows, 99, 2), jopm.dedup_rows(rows, 99, 2)):
            np.testing.assert_array_equal(a, b)
        assert opm.dedup_rows(
            rng.integers(0, 10**6, (16, 64)).astype(np.int32), 10**6, 2
        ) is None


# --- numpy emulations of the CUDA kernels' own algorithms ----------------------


class CountAcc:
    """B1: 32 per-bit counters per thread (vectorized over threads)."""

    def __init__(self, n):
        self.c = np.zeros((32, n), np.uint32)

    def add(self, x):
        for b in range(32):
            self.c[b] += (x >> np.uint32(b)) & np.uint32(1)

    def count(self, b):
        return self.c[b].astype(np.int64)


class PlaneAcc:
    """B2: carry-save counter over ``planes`` bit planes per thread."""

    def __init__(self, n, planes):
        self.p = [np.zeros(n, np.uint32) for _ in range(planes)]

    def add(self, x):
        carry = x.copy()
        for j in range(len(self.p)):
            t = self.p[j] & carry
            self.p[j] ^= carry
            carry = t

    def count(self, b):
        v = np.zeros(self.p[0].shape, np.int64)
        for j, pj in enumerate(self.p):
            v |= ((pj >> np.uint32(b)) & np.uint32(1)).astype(np.int64) << j
        return v


def emulate_kernel(words: np.ndarray, rows: np.ndarray, kernel: str) -> np.ndarray:
    """match_popcount_kernel of csrc/match_popcount.cu, block by block with
    each block's threads vectorized: the same launch geometry, the
    shared-memory row staging with its clamp into [0, S], the per-thread
    word loop w = t%wt, t%wt + wt, ..., the accumulator, and the eight
    4-count stores into out[q, 32w : 32w+32]."""
    q, k, h = rows.shape
    n_rows, wp = words.shape
    qt, wt = opm.launch_geometry(wp, k, h)
    assert qt * wt <= opm.BLOCK_THREADS
    assert qt * k * h * 4 <= opm.SMEM_BYTES
    out = np.full((q, 32 * wp), -1, np.int64)  # every cell must be written
    for blk in range(-(-q // qt)):
        q0 = blk * qt
        nq = min(qt, q - q0)
        rows_s = np.clip(rows[q0 : q0 + nq].reshape(nq, k * h), 0, n_rows - 1)
        t = np.arange(qt * wt)
        ql, wl = t // wt, t % wt
        live = ql < nq
        ql, wl = ql[live], wl[live]
        for it in range(-(-wp // wt)):
            w = wl + it * wt
            act = w < wp
            qa, wa = ql[act], w[act]
            if kernel == "match_popcount_b1":
                acc = CountAcc(len(qa))
            else:
                acc = PlaneAcc(len(qa), opm.b2_planes(k))
            for j in range(k):
                x = words[rows_s[qa, j * h], wa]
                for t2 in range(1, h):
                    x = x & words[rows_s[qa, j * h + t2], wa]
                acc.add(x)
            for i in range(8):
                for c in range(4):
                    out[q0 + qa, 32 * wa + 4 * i + c] = acc.count(4 * i + c)
    return out


class TestKernelEmulation:
    @pytest.mark.parametrize(
        "wp,k,h",
        [(3, 64, 1), (68, 96, 3), (1, 128, 2), (300, 64, 1), (5, 33, 1)],
    )
    def test_b1(self, wp, k, h):
        """B1 at widths that give 1 query per block (Wp=300: two word
        passes per thread), many queries per block (Wp=1) and the main
        path's width (Wp=68)."""
        rng = np.random.default_rng(wp * 1000 + k + h)
        words = rand_words(rng, 150, wp, density=0.25)
        rows = rand_rows(rng, 150, 7, k, h)
        np.testing.assert_array_equal(
            emulate_kernel(words, rows, "match_popcount_b1"), ref(words, rows)
        )

    @pytest.mark.parametrize("k", [32, 64, 128, 512])
    def test_b2(self, k):
        rng = np.random.default_rng(k)
        words = rand_words(rng, 120, 3)
        rows = rand_rows(rng, 120, 6, k, 1)
        np.testing.assert_array_equal(
            emulate_kernel(words, rows, "match_popcount_b2"), ref(words, rows)
        )

    @pytest.mark.parametrize("k", [32, 64, 128, 512])
    def test_b2_planes_hold_the_largest_count(self, k):
        """All-ones rows: every count is exactly K, the largest the
        planes must hold (one fewer plane would wrap to 0)."""
        words = np.full((9, 2), 0xFFFFFFFF, np.uint32)
        words[8] = 0
        rows = np.zeros((3, k, 1), np.int32)
        got = emulate_kernel(words, rows, "match_popcount_b2")
        assert (got == k).all()
        assert k < 2 ** opm.b2_planes(k) and k >= 2 ** (opm.b2_planes(k) - 1)

    def test_out_of_range_rows_read_clamped_rows(self):
        """The kernel clamps a row index into [0, S] (as XLA's gather does)
        instead of reading outside the table: too large -> the zero row."""
        rng = np.random.default_rng(1)
        words = rand_words(rng, 50, 2)
        rows = rand_rows(rng, 50, 4, 64, 1, n_pad_queries=0)
        bad = rows.copy()
        bad[0, :5] = 10**6
        rows[0, :5] = 50
        np.testing.assert_array_equal(
            emulate_kernel(words, bad, "match_popcount_b2"), ref(words, rows)
        )


class TestDispatch:
    def test_kernel_selection(self):
        assert opm.select_kernel(64, 1) == "match_popcount_b2"
        assert opm.select_kernel(128, 1) == "match_popcount_b2"
        assert opm.select_kernel(96, 3) == "match_popcount_b1"
        assert opm.select_kernel(70, 1) == "match_popcount_b1"
        assert opm.select_kernel(2**14, 1) == "match_popcount_b1"

    @pytest.mark.parametrize("k,h", [(1, 1), (64, 1), (96, 3), (512, 2), (4064, 3)])
    def test_launch_geometry_fits(self, k, h):
        for wp in (1, 2, 68, 255, 256, 700):
            qt, wt = opm.launch_geometry(wp, k, h)
            assert 1 <= qt and 1 <= wt <= wp
            assert qt * wt <= opm.BLOCK_THREADS
            assert qt * k * h * 4 <= opm.SMEM_BYTES

    def test_launch_geometry_refuses_oversized_tiles(self):
        with pytest.raises(ValueError, match="shared memory"):
            opm.launch_geometry(68, 8192, 2)
