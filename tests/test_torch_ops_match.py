"""The port's match scoring (phylign_tpu_torch.ops.match) against the JAX
package's: the plain PyTorch version against ``match_scores_xla`` and both
Pallas kernels in interpret mode, and a numpy emulation of the CUDA
kernel's own algorithm (launch geometry, staged indices, skipped padding
slots, carry-save bit planes fed by 8-slot Harley-Seal trees and single
slots, the lane-wise unpack, the counts' way out) for B1 and B2 against
the plain version. All values are integers: every comparison is exact.
"""

import re
from pathlib import Path

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


# --- numpy emulation of the CUDA kernel's own algorithm ------------------------

CUDA_SRC = (Path(opm.__file__).parents[1] / "csrc" / "match_popcount.cu").read_text()


def csa(a, b, c):
    """A carry-save adder over bit-sliced words: (carry, sum)."""
    u = a ^ b
    return (a & b) | (u & c), u ^ c


class Planes:
    """Carry-save bit planes of match_popcount.cu (Planes<P>), vectorized
    over a tile's threads: plane j holds bit j of each column's count."""

    def __init__(self, shape, planes):
        self.p = [np.zeros(shape, np.uint32) for _ in range(planes)]

    def ripple(self, carry, start=0):
        for j in range(start, len(self.p)):
            t = self.p[j] & carry
            self.p[j] ^= carry
            carry = t

    def add8(self, d):
        """Harley-Seal: 8 words through 7 carry-save adders into planes 0
        to 2, the carry of weight 8 rippled above (Planes<P>::add8)."""
        t = []
        for i in range(4):
            hi, self.p[0] = csa(self.p[0], d[2 * i], d[2 * i + 1])
            t.append(hi)
        t0, self.p[1] = csa(self.p[1], t[0], t[1])
        t1, self.p[1] = csa(self.p[1], t[2], t[3])
        t0, self.p[2] = csa(self.p[2], t0, t1)
        self.ripple(t0, 3)

    def unpack(self):
        """[..., 32] counts, through LANE-bit lanes as the kernel does."""
        lane = 8 if len(self.p) <= 8 else 16
        ones = np.uint32(0x01010101 if lane == 8 else 0x00010001)
        out = np.zeros(self.p[0].shape + (32,), np.int64)
        for i in range(lane):
            acc = np.zeros_like(self.p[0])
            for j, pj in enumerate(self.p):
                acc |= ((pj >> np.uint32(i)) & ones) << np.uint32(j)
            for m in range(32 // lane):
                out[..., i + lane * m] = (acc >> np.uint32(lane * m)) & np.uint32((1 << lane) - 1)
        return out


def kernel_planes(k: int) -> int:
    """The Planes<P> instance the C entry picks for K."""
    need = opm.b2_planes(k)
    return 8 if need <= 8 else 12 if need <= 12 else 16


def emulate_kernel(words: np.ndarray, rows: np.ndarray, kernel: str) -> np.ndarray:
    """The wrapper and match_popcount_kernel of csrc/match_popcount.cu: the
    launch geometry (blocks of qt queries x wt threads, every (query, word)
    served exactly once, words w, w + wt, ... per thread); the row indices
    staged clamped into [0, S] (or read and clamped in place); a slot whose
    first row is the zero row S read as 0, the others' H rows ANDed; groups
    of 8 slots through the Harley-Seal tree, the rest rippled in singly; the
    lane-wise unpack; and the counts stored into out[q, 32w : 32w+32], or
    into the block's shared memory at (ql * Wp + w) * 32 and from there to
    the block's contiguous rows. A block's threads run in step, so their
    arithmetic is vectorized over (query, word)."""
    q, k, h = rows.shape
    n_rows, wp = words.shape
    if kernel == "match_popcount_b2":
        assert h == 1 and k % 32 == 0
    qt, wt, staged, via_smem = opm.launch_geometry(wp, k, h)
    assert 1 <= qt * wt <= opm.BLOCK_THREADS and wt <= wp
    assert not staged or qt * k * h * 4 <= opm.STAGE_BYTES
    assert not via_smem or qt * wp * 128 <= opm.OUT_BYTES
    last = n_rows - 1
    grid = -(-q // qt)
    t = np.arange(qt * wt)
    served = np.zeros((q, wp), np.int64)
    out = np.full((q, 32 * wp), -1, np.int64)
    for blk in range(grid):
        q0 = blk * qt
        nq = min(qt, q - q0)
        ri = np.clip(rows[q0 : q0 + nq].reshape(nq, k * h), 0, last)  # staged or not
        smem_out = np.full((nq, 32 * wp), -1, np.int64)
        ql, w0 = t // wt, t % wt
        for step in range(-(-wp // wt)):
            w = w0 + step * wt
            live = (ql < nq) & (w < wp)
            qi, wi = ql[live], w[live]
            np.add.at(served, (q0 + qi, wi), 1)
            r = ri[qi].reshape(-1, k, h)  # [threads, K, H]

            def slot(j):
                x = np.where(r[:, j, 0] == last, np.uint32(0), words[r[:, j, 0], wi])
                for t2 in range(1, h):
                    x = x & words[r[:, j, t2], wi]
                return x

            pl = Planes(qi.shape, kernel_planes(k))
            j = 0
            while j + 8 <= k:
                pl.add8([slot(j + i) for i in range(8)])
                j += 8
            for j in range(j, k):
                pl.ripple(slot(j))
            counts = pl.unpack()  # [threads, 32]
            cols = 32 * wi[:, None] + np.arange(32)
            if via_smem:
                smem_out[qi[:, None], cols] = counts
            else:
                out[q0 + qi[:, None], cols] = counts
        if via_smem:
            # the block's rows of out, contiguous, copied in 16-byte pieces
            flat = out[q0 : q0 + nq].reshape(-1, 4)
            flat[:] = smem_out.reshape(-1, 4)
    assert (served == 1).all() and (out >= 0).all()
    return out


class TestKernelEmulation:
    @pytest.mark.parametrize(
        "wp,k,h",
        [(3, 64, 1), (68, 96, 3), (1, 128, 2), (300, 64, 1), (5, 33, 1),
         (68, 120, 1), (8, 128, 3), (6, 1000, 2), (4, 80, 5), (70, 35, 1)],
    )
    def test_b1(self, wp, k, h):
        """B1 at any width (Wp=300: words looped over; Wp % 4 != 0), K not a
        multiple of the 8-slot group (33, 35, 80, 120, 1000), 12 planes
        (K=1000), and H from 1 to 5 (2 and 5: the runtime-H instance)."""
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

    @pytest.mark.parametrize(
        "threads,stage_bytes,out_bytes,wp,q,k,h",
        [
            # words looped over (Wp=300 > 128 threads), counts stored straight
            (128, 48 * 1024, 1024, 300, 9, 40, 3),
            # 42 queries a block (Wp=3), the last block short (Q=50)
            (128, 48 * 1024, 48 * 1024, 3, 50, 64, 1),
            # indices too many to stage: read from device memory
            (128, 256, 48 * 1024, 68, 7, 96, 3),
            # the main path's width: one query a block, K % 8 != 0, H=2
            (128, 48 * 1024, 48 * 1024, 68, 5, 33, 2),
            # a block of 256 threads: 3 queries at Wp=68
            (256, 48 * 1024, 48 * 1024, 68, 10, 128, 1),
        ],
    )
    def test_geometries(self, monkeypatch, threads, stage_bytes, out_bytes, wp, q, k, h):
        monkeypatch.setattr(opm, "BLOCK_THREADS", threads)
        monkeypatch.setattr(opm, "STAGE_BYTES", stage_bytes)
        monkeypatch.setattr(opm, "OUT_BYTES", out_bytes)
        rng = np.random.default_rng(q + k + h)
        words = rand_words(rng, 200, wp)
        rows = rand_rows(rng, 200, q, k, h)
        np.testing.assert_array_equal(
            emulate_kernel(words, rows, opm.select_kernel(k, h)), ref(words, rows)
        )

    @pytest.mark.parametrize("k", [32, 64, 128, 512])
    def test_b2_planes_hold_the_largest_count(self, k):
        """All-ones rows: every count is exactly K, the largest the planes
        must hold (the lanes of the unpack too)."""
        words = np.full((9, 4), 0xFFFFFFFF, np.uint32)
        words[8] = 0
        rows = np.zeros((3, k, 1), np.int32)
        got = emulate_kernel(words, rows, "match_popcount_b2")
        assert (got == k).all()
        assert k < 2 ** opm.b2_planes(k) and k >= 2 ** (opm.b2_planes(k) - 1)
        assert kernel_planes(k) >= opm.b2_planes(k)

    @pytest.mark.parametrize("k", [255, 4064, 5000])
    def test_planes_hold_the_largest_count(self, k):
        """The same at the top of the 8-, 12- and 16-plane instances, with
        the 16-bit lanes of the unpack (B1: K % 8 != 0 takes single slots
        at the end)."""
        words = np.full((3, 4), 0xFFFFFFFF, np.uint32)
        words[2] = 0
        rows = np.zeros((2, k, 1), np.int32)
        assert (emulate_kernel(words, rows, "match_popcount_b1") == k).all()

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
            qt, wt, staged, via_smem = opm.launch_geometry(wp, k, h)
            assert 1 <= qt and 1 <= wt <= wp
            assert qt * wt <= opm.BLOCK_THREADS
            assert not staged or qt * k * h * 4 <= opm.STAGE_BYTES
            assert not via_smem or qt * wp * 128 <= opm.OUT_BYTES
        # the main path's width: a block of one query, indices staged,
        # counts through shared memory
        assert opm.launch_geometry(68, 128, 1) == (1, 68, 1, 1)

    def test_launch_geometry_refuses_oversized_tiles(self):
        """K beyond 16 planes has no kernel instance; K * H indices beyond
        the staging budget are read from device memory instead."""
        with pytest.raises(ValueError, match="planes"):
            opm.launch_geometry(68, opm.K_MAX + 1, 1)
        assert opm.launch_geometry(68, 8192, 2)[2] == 0

    def test_geometry_constants_match_the_source(self):
        """The wrapper's limits are the kernel's: threads per block, the
        shared memory a block can take, and groups of 8 slots."""
        def const(pattern):
            return int(re.search(pattern, CUDA_SRC).group(1))

        assert const(r"kMaxThreads = (\d+);") >= opm.BLOCK_THREADS
        assert const(r"kMaxSmem = (\d+);") >= opm.STAGE_BYTES + opm.OUT_BYTES
        assert const(r"kGroup = (\d+);") == 8
