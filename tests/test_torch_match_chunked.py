"""The accumulate and keep epilogues of kernels B1/B2
(``csrc/match_popcount.cu``) on the CPU: the row-chunked matcher's pass
and ``match_step``.

- ``match_scores_acc_ref_`` (the plain accumulate, with a row window)
  against the JAX package's ``_acc_chunk_scores`` on the block with its
  zero row and the rows remapped as ``ChunkedMatcher._score_pass`` remaps
  them (``phylign_tpu/models/matcher.py:924-926``), block by block, at
  row-chunk divisors 1, 3 and 7 (a short last block), with padding slots;
- a numpy emulation of the kernel's own per-thread algorithm under each
  epilogue (launch geometry, indices staged raw or clamped, the row-window
  test in wrapping unsigned arithmetic, carry-save planes, counts through
  shared memory or straight, 16-byte pieces of the accumulator loaded,
  added to and stored; the keep bytes from the float32 product), against
  the plain versions, and mutants of it that the comparison must catch;
- ``ChunkedMatcher.score_hits_raw`` and a ``Pipeline`` whose 1-hash
  indexes stream in three blocks, against the JAX package's;
- ``match_step``'s plain version and the keep emulation against JAX's
  ``match_step``, scores exactly on the float32 cut and queries without
  k-mers included.
Tolerance: exact (0 difference)."""

import gzip
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.config import Config as JaxConfig
from phylign_tpu.models import matcher as jm
from phylign_tpu.pipeline.stages import Pipeline as JaxPipeline
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.models import matcher as tm
from phylign_tpu_torch.ops import match as opm
from phylign_tpu_torch.pipeline.stages import Pipeline as TorchPipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_matcher import fixture  # noqa: E402, F401
from test_torch_ops_match import Planes, kernel_planes  # noqa: E402
from test_torch_pipeline_match import base  # noqa: E402, F401

PAD = 1 << 30  # ChunkedMatcher.pad_row


def _words(rng, s, wp, density=0.5):
    w = rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    if density < 0.5:
        w &= rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    return w


def _rows(rng, s, q, k, h=1):
    """Global rows with padding slots (PAD) past each query's k-mers, a
    query of padding only, and rows outside the index."""
    rows = rng.integers(0, s, (q, k, h)).astype(np.int32)
    nk = rng.integers(0, k + 1, q)
    rows[np.arange(k)[None, :] >= nk[:, None]] = PAD
    rows[1] = PAD
    rows[2, :2] = -3
    return rows


# --- the plain accumulate against JAX, block by block ----------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("div", [1, 3, 7])
def test_acc_chunk_scores_equal_jax_block_by_block(seed, div):
    rng = np.random.default_rng(seed)
    s, wp, q, k = 301, 5, 20, 64
    words = _words(rng, s, wp)
    rows = _rows(rng, s, q, k)[..., 0]
    chunk = -(-s // div)
    jacc = jnp.zeros((q, 32 * wp), jnp.int32)
    tacc = torch.zeros((q, 32 * wp), dtype=torch.int32)
    for r0 in range(0, s, chunk):
        r1 = min(r0 + chunk, s)
        block = np.zeros((chunk + 1, wp), np.uint32)
        block[: r1 - r0] = words[r0:r1]
        loc = np.where((rows >= r0) & (rows < r1), rows - r0, chunk).astype(np.int32)
        jacc = jm._acc_chunk_scores(jacc, jnp.asarray(block), jnp.asarray(loc))
        got = tm._acc_chunk_scores(tacc, torch.from_numpy(words[r0:r1].view(np.int32)),
                                   torch.from_numpy(rows), r0, r1)
        assert got is tacc
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert tacc.sum() > 0


# --- numpy emulation of the kernel's epilogues ------------------------------------


def plane_add(p, b, top=None):
    """Planes<P>::add: the vertical numbers p += b, a ripple-carry add over
    the planes below ``top`` (all of them by default)."""
    c = np.zeros_like(p[0])
    for j in range(len(p) if top is None else top):
        u = p[j] ^ b[j]
        p[j], c = u ^ c, (p[j] & b[j]) | (u & c)


def emulate(words, rows, epilogue="store", acc=None, r0=0, r1=None, n_kmers=None, threshold=0.0,
            mode="add", split=1, mutant=None):
    """match_popcount_kernel<P, HC, EP> with its launch geometry
    (ops/match.launch_geometry; keep_geometry under keep). Under acc with
    the indices staged, the warp of each query (query ql: warp ql %
    warps, its lanes) compacts its slots whose H rows all pass the window
    test ((uint32) (g - r0) < r1 - r0: rows before r0 wrap past the
    window) by ballot and popcount prefix, in order, padded to a multiple
    of 8 (at most K) with slots of rows r1; a compacted slot reads its
    rows unless its first row fails the window test (a pad). Unstaged,
    acc tests every row of every slot; otherwise the indices are clamped
    into [0, S] and a slot's first row S is not read. A slot ANDs its H
    rows. Each thread counts its share of the slots (a run of whole groups
    of 8 per thread of a (query, word) under keep's split) in carry-save
    planes, groups of 8 through the Harley-Seal tree and the rest singly;
    a split's threads sum their planes by ripple-carry adds over shuffle
    partners t ^ 1, t ^ 2, and the first of them stores. Counts go into the
    block's shared memory and from there in 16-byte pieces to the block's
    contiguous rows, or straight from each thread. Under acc: mode add
    loads, adds to and stores each 16-byte piece; first stores the
    bit_length(K) planes into the first int32 of out[q, 32w : 32w + 32];
    middle skips a word whose block planes are all zero, else loads the
    planes, adds and stores them; last loads, adds and stores the counts;
    only stores the counts. Under keep each thread writes the 32 keep bytes
    of its word, f32(count) >= f32(threshold) * f32(n_kmers[q]) (one
    rounding) and n_kmers[q] > 0. Returns out (acc under acc, int32) and
    keep."""
    q, k, h = rows.shape
    n_rows, wp = words.shape
    if epilogue == "keep":
        (qt, wt, staged, via_smem), s = opm.keep_geometry(wp, k, h, split), split
    else:
        (qt, wt, staged, via_smem), s = opm.launch_geometry(wp, k, h), 1
    last = n_rows - 1
    planes = opm.b2_planes(k)
    compacted = epilogue == "acc" and staged
    counts_out = epilogue != "acc" or mode in ("add", "last", "only")
    add = epilogue == "acc" and mode == "add"
    out = acc.view(np.uint32).astype(np.int64) if epilogue == "acc" else np.full((q, 32 * wp), -1, np.int64)
    keep = np.full((q, 32 * wp), 7, np.uint8)
    r1 = n_rows if r1 is None else r1
    n_win = np.uint32(r1 - r0)

    def locate(g):
        """(offset in the block, passes the window test)"""
        off = g.astype(np.uint32) - np.uint32(r0)
        ok = off <= n_win if mutant == "window_inclusive" else off < n_win
        if mutant == "clamp_to_block":
            off, ok = np.minimum(off, n_win - np.uint32(1)), np.ones_like(ok)
        return off.astype(np.int64), ok

    threads = qt * wt * s
    t = np.arange(threads)
    tpq = wt * s
    tq, tg, tw = t // tpq, t % s, (t % tpq) // s
    for blk in range(-(-q // qt)):
        q0 = blk * qt
        nq = min(qt, q - q0)
        raw = rows[q0 : q0 + nq]
        if compacted:
            lst = np.empty_like(raw)
            ns = np.zeros(nq, np.int64)
            for i in range(nq):
                nl = min(32, threads - 32 * (i % -(-threads // 32)))
                test = raw[i, :, :1] if mutant == "compact_first_row" else raw[i]
                inside = locate(test)[1].all(axis=1)
                n = 0
                for base in range(0, k, nl):
                    j = np.arange(base, min(base + nl, k))
                    b = inside[j]
                    at = n + np.cumsum(b) - b  # the popcount of the ballot below each lane
                    lst[i, at[b]] = raw[i, j[b]]
                    n += int(b.sum())
                ns[i] = min(-(-n // 8) * 8, k)
                lst[i, n : ns[i]] = r1
        else:
            lst = raw if epilogue == "acc" else np.clip(raw, 0, last)
            ns = np.full(nq, k)
        smem = np.zeros((nq, 32 * wp), np.int64)
        for step in range(-(-wp // wt)):
            w = tw + step * wt
            live = (tq < nq) & (w < wp)
            qi, wi, gi = tq[live], w[live], tg[live]
            share = -(-ns[qi] // (8 * s)) * 8 if s > 1 else ns[qi]
            j0 = np.minimum(ns[qi], gi * share)
            j1 = np.minimum(ns[qi], j0 + share)
            r = lst[qi]
            lane = np.arange(len(qi))

            def word(g, first):
                if epilogue == "acc":
                    off, ok = locate(g)
                    return np.where(ok, words[np.where(ok, off, 0), wi], np.uint32(0))
                if first:
                    return np.where(g == last, np.uint32(0), words[g, wi])
                return words[g, wi]

            def slot(j, on):
                rr = r[lane, np.minimum(j, k - 1)]
                on = on & (j < j1)
                if compacted:  # every row is read but a pad's (its first row fails the test)
                    on = on & locate(rr[:, 0])[1]
                    x = np.full(len(lane), 0xFFFFFFFF, np.uint32)
                    for t2 in range(h):
                        x = x & words[np.where(on, locate(rr[:, t2])[0], 0), wi]
                    return np.where(on, x, np.uint32(0))
                x = word(rr[:, 0], True)
                for t2 in range(1, h):
                    x = x & word(rr[:, t2], False)
                return np.where(on, x, np.uint32(0))

            pl = Planes(qi.shape, kernel_planes(k))
            span = j1 - j0
            full = span // 8 * 8
            for o in range(0, int(full.max(initial=0)), 8):  # a zero group adds nothing
                pl.add8([slot(j0 + o + i, o + 8 <= full) for i in range(8)])
            for o in range(int(span.max(initial=0))):
                pl.ripple(slot(j0 + o, o >= full))
            if s > 1:
                for m in (1, 2)[: s.bit_length() - 1]:  # partners t ^ m, m < s
                    other = [p_[np.arange(len(qi)) ^ m] for p_ in pl.p]
                    if mutant == "split_or":
                        pl.p = [a_ | b_ for a_, b_ in zip(pl.p, other)]
                    else:
                        plane_add(pl.p, other)
                first_of = gi == 0
                qi, wi = qi[first_of], wi[first_of]
                pl.p = [p_[first_of] for p_ in pl.p]
            cols = 32 * wi[:, None] + np.arange(32)
            if epilogue == "acc" and mode in ("first", "middle", "last"):
                at = (q0 + qi[:, None], 32 * wi[:, None] + np.arange(planes))
                if mode == "first":
                    out[at] = np.stack(pl.p[:planes], axis=1)
                    continue
                if mode == "middle":
                    nz = np.bitwise_or.reduce(np.stack(pl.p), axis=0) != 0
                    at = (at[0][nz], at[1][nz])
                    pl.p = [p_[nz] for p_ in pl.p]
                before = list(out[at].astype(np.uint32).T) + [np.zeros_like(pl.p[0])] * (len(pl.p) - planes)
                early = pl.unpack() if mutant == "last_unpacks_before_add" else None
                plane_add(pl.p, before, planes - 1 if mutant == "mid_drops_top_carry" and mode == "middle" else None)
                if mode == "middle":
                    out[at] = np.stack(pl.p[:planes], axis=1)
                    continue
                counts = pl.unpack() if early is None else early
            else:
                counts = pl.unpack()
            if epilogue == "keep":
                n = n_kmers[q0 + qi].astype(np.int64)
                if mutant == "cut_in_f64":
                    cut = np.float64(threshold) * n
                else:
                    cut = np.float32(threshold) * n.astype(np.float32)
                keep[q0 + qi[:, None], cols] = (counts.astype(np.float32) >= cut[:, None]) & (n[:, None] > 0)
            if via_smem:
                smem[qi[:, None], cols] = counts
            else:
                out[q0 + qi[:, None], cols] = counts + (out[q0 + qi[:, None], cols] if add else 0)
        if via_smem and counts_out:
            pieces = out[q0 : q0 + nq].reshape(-1, 4)
            pieces[:] = smem.reshape(-1, 4) + (pieces if add else 0)
    return out.astype(np.uint32).view(np.int32), keep


ACC_CASES = [
    # (S, Wp, Q, K, H, r0, r1): counts through shared memory at the main
    # path's width, straight past it (Wp = 300), many queries a block
    # (Wp = 3), K off the 8-slot group, H = 3 (every row of a slot must lie
    # in the window), a one-row window, the whole index
    (300, 68, 5, 64, 1, 100, 200),
    (300, 300, 3, 40, 1, 0, 150),
    (300, 3, 50, 64, 1, 250, 300),
    (300, 5, 7, 35, 1, 17, 18),
    (200, 6, 6, 48, 3, 0, 120),
    (200, 4, 9, 128, 1, 0, 200),
    # kernel planes P = 12 (K = 300: 9 planes kept between blocks) and 16
    # (K = 4,100: 13 planes, two queries a block); a one-row window at the
    # index's end with K off the 8-slot group
    (300, 4, 6, 300, 1, 50, 250),
    (200, 2, 3, 4100, 1, 20, 180),
    (200, 3, 4, 36, 1, 199, 200),
]


@pytest.mark.parametrize("s,wp,q,k,h,r0,r1", ACC_CASES)
def test_acc_emulation_equals_plain(s, wp, q, k, h, r0, r1):
    rng = np.random.default_rng(s + wp + q + k)
    words = _words(rng, s, wp, density=0.25)
    rows = _rows(rng, s, q, k, h)
    acc = rng.integers(0, 500, (q, 32 * wp)).astype(np.int32)
    want = opm.match_scores_acc_ref_(torch.from_numpy(acc.copy()), torch.from_numpy(words[r0:r1].view(np.int32)),
                                     torch.from_numpy(rows), r0, r1).numpy()
    got, _ = emulate(words[r0:r1], rows, "acc", acc=acc, r0=r0, r1=r1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geometry", [(128, 48 * 1024, 1024), (256, 256, 48 * 1024)])
def test_acc_emulation_other_geometries(monkeypatch, geometry):
    """Counts straight to the accumulator, and indices not staged."""
    for name, v in zip(("BLOCK_THREADS", "STAGE_BYTES", "OUT_BYTES"), geometry):
        monkeypatch.setattr(opm, name, v)
    rng = np.random.default_rng(5)
    words = _words(rng, 400, 68, density=0.25)
    rows = _rows(rng, 400, 6, 96)
    acc = rng.integers(0, 500, (6, 32 * 68)).astype(np.int32)
    want = opm.match_scores_acc_ref_(torch.from_numpy(acc.copy()), torch.from_numpy(words[50:350].view(np.int32)),
                                     torch.from_numpy(rows), 50, 350).numpy()
    np.testing.assert_array_equal(emulate(words[50:350], rows, "acc", acc=acc, r0=50, r1=350)[0], want)


@pytest.mark.parametrize("mutant", ["window_inclusive", "clamp_to_block"])
def test_acc_emulation_mutants_are_caught(mutant):
    rng = np.random.default_rng(9)
    words = _words(rng, 300, 3)
    rows = _rows(rng, 300, 40, 64)
    rows[3, :10] = 200  # the row just past the window
    acc = np.zeros((40, 96), np.int32)
    want = opm.match_scores_acc_ref_(torch.from_numpy(acc.copy()), torch.from_numpy(words[100:200].view(np.int32)),
                                     torch.from_numpy(rows), 100, 200).numpy()
    got, _ = emulate(words[100:201], rows, "acc", acc=acc, r0=100, r1=200, mutant=mutant)
    assert not np.array_equal(got, want)


def _plane_case(s, wp, q, k, h, r0, r1, seed):
    """ACC_CASES' inputs with the last query's real rows all outside the
    window, and an accumulator whose words hold garbage and, in the first
    bit_length(K) int32 of each word's 32, the planes of earlier counts
    small enough that the pass's counts stay below 2**bit_length(K)."""
    rng = np.random.default_rng(seed)
    words = _words(rng, s, wp, density=0.25)
    rows = _rows(rng, s, q, k, h)
    rows[q - 1] = r1 if r1 < s else (r0 - 1 if r0 else PAD)
    planes = opm.b2_planes(k)
    acc = rng.integers(-(2**31), 2**31, (q, 32 * wp)).astype(np.int32)
    before = torch.from_numpy(rng.integers(0, 2**planes - k, (q, 32 * wp)).astype(np.int32))
    acc.reshape(q, wp, 32)[..., :planes] = opm.encode_planes(before, planes).numpy()
    return words, rows, acc


@pytest.mark.parametrize("mode", ["first", "middle", "last", "only"])
@pytest.mark.parametrize("s,wp,q,k,h,r0,r1", ACC_CASES)
def test_acc_plane_modes_emulation_equal_plain(s, wp, q, k, h, r0, r1, mode):
    """Each block mode of a row-chunked pass (the counts kept as bit planes
    between blocks) bit for bit against match_scores_acc_planes_ref_,
    every int32 of the accumulator included."""
    words, rows, acc = _plane_case(s, wp, q, k, h, r0, r1, s + wp + q + k)
    first, last = mode in ("first", "only"), mode in ("last", "only")
    want = opm.match_scores_acc_planes_ref_(torch.from_numpy(acc.copy()), torch.from_numpy(words[r0:r1].view(np.int32)),
                                            torch.from_numpy(rows), r0, r1, first, last).numpy()
    got, _ = emulate(words[r0:r1], rows, "acc", acc=acc, r0=r0, r1=r1, mode=mode)
    np.testing.assert_array_equal(got, want)
    if mode in ("first", "middle"):  # only the planes of each word were written
        untouched = np.ones((q, wp, 32), bool)
        untouched[..., : opm.b2_planes(k)] = False
        np.testing.assert_array_equal(got.reshape(q, wp, 32)[untouched], acc.reshape(q, wp, 32)[untouched])


def _pass(words, rows, chunk, mutant=None):
    """The emulated kernel over every block of a pass, from an
    uninitialised accumulator: first, middle ..., last (only, when one
    block holds the index)."""
    s = words.shape[0]
    starts = range(0, s, chunk)
    acc = np.full((rows.shape[0], 32 * words.shape[1]), -1, np.int32)
    for i, r0 in enumerate(starts):
        r1 = min(r0 + chunk, s)
        mode = "only" if len(starts) == 1 else "first" if i == 0 else "last" if r1 == s else "middle"
        acc, _ = emulate(words[r0:r1], rows, "acc", acc=acc, r0=r0, r1=r1, mode=mode, mutant=mutant)
    return acc


@pytest.mark.parametrize("div", [1, 2, 3, 7])
def test_chunked_pass_through_planes_equals_jax(fixture, div):  # noqa: F811
    """ChunkedMatcher's CPU pass (the plane modes' plain versions, block by
    block) and the emulated kernel over the same blocks give the JAX
    ChunkedMatcher's accumulator, and its hit lists, at 1, 2, 3 and 7
    blocks."""
    didx, tdidx, _, _, raw = fixture
    s = tdidx.signature_size
    kw = dict(term_size=tdidx.term_size, num_hashes=1, signature_size=s, doc_names=tdidx.doc_names,
              words_host=np.asarray(tdidx.words), row_chunk=-(-s // div))
    jc, tc = jm.ChunkedMatcher(**kw), tm.ChunkedMatcher(**kw, device="cpu")
    packed, _ = opm.pack_row_indices([tm.rows_from_hashes(r, s) for r in raw], 128, PAD)
    want = np.asarray(jc._score_pass(packed))
    np.testing.assert_array_equal(tc._score_pass(packed).numpy(), want)
    np.testing.assert_array_equal(_pass(np.asarray(tdidx.words), packed, tc.row_chunk), want)
    assert want.max() > 100
    for thr, topn in ((0.7, 1), (0.3, 2)):
        jh, jn = jc.score_hits_raw(raw, thr, topn)
        th, tn = tc.score_hits_raw(raw, thr, topn)
        np.testing.assert_array_equal(tn, jn)
        assert th == jh


def _mutant_pass_case(k):
    """A pass of 3 blocks over 300 rows whose queries' slots all lie in the
    first two, word 0 bit 0 set in every row: that column counts K, so the
    middle block's add carries into the top plane bit_length(K) - 1."""
    rng = np.random.default_rng(k)
    words = _words(rng, 300, 2)
    words[:, 0] |= np.uint32(1)
    rows = rng.integers(0, 200, (4, k, 1)).astype(np.int32)
    resident = opm.match_scores_ref(torch.from_numpy(np.concatenate([words, np.zeros((1, 2), np.uint32)]).view(np.int32)),
                                    torch.from_numpy(rows)).numpy()
    return words, rows, resident


@pytest.mark.parametrize("mutant", ["compact_first_row", "mid_drops_top_carry", "last_unpacks_before_add",
                                    "split_or"])
def test_plane_and_split_mutants_are_caught(mutant):
    """Mutants of the redesign that the comparisons with the plain versions
    catch (the unmutated emulation passes each on the same inputs): a
    compaction that tests only a slot's first row (H = 3, the others just
    past the window, in the buffer); a middle block whose add loses the
    carry into its top plane; a last block that unpacks the counts before
    adding the stored planes; a split whose threads combine planes by OR."""
    if mutant == "compact_first_row":
        rng = np.random.default_rng(3)
        words = _words(rng, 300, 4)
        rows = rng.integers(100, 200, (6, 64, 3)).astype(np.int32)
        rows[:, :9, 1:] = 205
        acc = np.zeros((6, 128), np.int32)
        want = opm.match_scores_acc_ref_(torch.from_numpy(acc.copy()), torch.from_numpy(words[100:200].view(np.int32)),
                                         torch.from_numpy(rows), 100, 200).numpy()
        run = lambda m: emulate(words[100:220], rows, "acc", acc=acc, r0=100, r1=200, mutant=m)[0]  # noqa: E731
    elif mutant == "split_or":
        words, rows, nk = _step_inputs(1)
        want = opm.match_scores_keep_ref(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows),
                                         torch.from_numpy(nk), 0.3)[0].numpy()
        run = lambda m: emulate(words, rows, "keep", n_kmers=nk, threshold=0.3, split=2, mutant=m)[0]  # noqa: E731
    else:
        words, rows, want = _mutant_pass_case(128)
        run = lambda m: _pass(words, rows, 100, mutant=m)  # noqa: E731
    np.testing.assert_array_equal(run(None), want)
    assert not np.array_equal(run(mutant), want)


@pytest.mark.parametrize("k", [128, 300, 4100])
def test_pass_counts_reach_the_top_plane(k):
    """Counts of K (every slot on a set bit) through first, middle and last
    blocks at kernel planes P = 8, 12 and 16: the emulated pass and the
    plain one equal the resident scores."""
    words, rows, want = _mutant_pass_case(k)
    assert want.max() == k
    np.testing.assert_array_equal(_pass(words, rows, 100), want)
    acc = torch.empty((rows.shape[0], 64), dtype=torch.int32)
    for r0 in (0, 100, 200):
        opm.match_scores_acc_planes_ref_(acc, torch.from_numpy(words[r0 : r0 + 100].view(np.int32)),
                                         torch.from_numpy(rows), r0, r0 + 100, r0 == 0, r0 == 200)
    np.testing.assert_array_equal(acc.numpy(), want)


def test_blocks_add_up_to_the_resident_scores():
    """The plain accumulate over every block of a pass equals B1/B2's plain
    scores on the whole index with its zero row (padding slots and rows
    outside the index read as the zero row)."""
    rng = np.random.default_rng(4)
    s, wp = 500, 7
    words = _words(rng, s, wp)
    rows = _rows(rng, s, 30, 128)
    acc = torch.zeros((30, 32 * wp), dtype=torch.int32)
    for r0 in range(0, s, 123):
        opm.match_scores_acc_ref_(acc, torch.from_numpy(words[r0 : r0 + 123].view(np.int32)),
                                  torch.from_numpy(rows), r0, min(r0 + 123, s))
    padded = np.concatenate([words, np.zeros((1, wp), np.uint32)]).view(np.int32)
    resident = np.where((rows >= 0) & (rows < s), rows, s)
    want = opm.match_scores_ref(torch.from_numpy(padded), torch.from_numpy(resident))
    assert torch.equal(acc, want)


# --- the chunked matcher and the pipeline against JAX -------------------------------


@pytest.mark.parametrize("div", [3, 7])
def test_chunked_score_hits_raw_equal_jax(fixture, div):  # noqa: F811
    """Hit lists in the same order (the window in jax.lax.top_k's order)
    and the same counts, over blocks of a third and a seventh of the
    index."""
    didx, tdidx, _, _, raw = fixture
    kw = dict(term_size=tdidx.term_size, num_hashes=1, signature_size=tdidx.signature_size,
              doc_names=tdidx.doc_names, words_host=np.asarray(tdidx.words),
              row_chunk=-(-tdidx.signature_size // div))
    jc, tc = jm.ChunkedMatcher(**kw), tm.ChunkedMatcher(**kw, device="cpu")
    for thr, topn in ((0.7, 1), (0.0, 3), (0.3, 2)):
        jh, jn = jc.score_hits_raw(raw, thr, topn)
        th, tn = tc.score_hits_raw(raw, thr, topn)
        np.testing.assert_array_equal(tn, jn)
        assert th == jh
    assert sum(map(len, th)) > 0


def _run(base, wd, pipeline_cls, monkeypatch, device=None):  # noqa: F811
    """preprocess -> match with every 1-hash index row-chunked in 3
    blocks; the 03_match bytes (decompressed)."""
    shutil.copytree(base, wd)
    cfg = (JaxConfig if pipeline_cls is JaxPipeline else Config).from_yaml(wd / "config.yaml")
    cfg.device_index_cache_gb = 0.0
    pl = pipeline_cls(cfg, wd, **({} if device is None else {"device": device}))
    pl._chunk_budget_mb = lambda: 0
    mod = jm if pipeline_cls is JaxPipeline else tm
    orig = mod.ChunkedMatcher.from_device_index.__func__

    def thirds(cls, didx, hbm_budget_mb, **kw):
        cm = orig(cls, didx, hbm_budget_mb, **kw)
        cm.row_chunk = -(-didx.signature_size // 3)
        return cm

    monkeypatch.setattr(mod.ChunkedMatcher, "from_device_index", classmethod(thirds))
    stem = pl.preprocess(sorted(str(p) for p in (wd / "input").iterdir()))
    pl.match(stem)
    return {p.name: gzip.open(p, "rb").read() for p in sorted((wd / "intermediate" / "03_match").glob("*.gz"))}


def test_pipeline_in_three_blocks_equals_jax(base, tmp_path, monkeypatch):  # noqa: F811
    passes = []
    orig = tm.ChunkedMatcher._score_pass
    monkeypatch.setattr(tm.ChunkedMatcher, "_score_pass", lambda self, p: passes.append(self.row_chunk)
                        or orig(self, p))
    want = _run(base, tmp_path / "jax", JaxPipeline, monkeypatch)
    got = _run(base, tmp_path / "torch", TorchPipeline, monkeypatch, device="cpu")
    assert len(want) == 4 and got == want
    assert passes and sum(ln.startswith(b"_") for v in want.values() for ln in v.splitlines()) > 0


# --- match_step: the keep epilogue against JAX -------------------------------------


def _step_inputs(h, k=64, s=128, wp=3):
    """A staircase matrix (doc d's bit in row r iff r < d) and slots holding
    rows 0 .. K-1 shuffled: each query scores every value 0 .. K, so the
    thresholds put cuts on scores; n_kmers where the float32 cut and the
    float64 one differ (0.3 x 50, 0.55 x 100), and 0."""
    r = np.arange(s)[:, None]
    d = np.arange(32 * wp)[None, :]
    bits = (r < d).astype(np.uint64).reshape(s, wp, 32)
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    nk = np.array([50, 0, 100, 25, 45, 90, 120, 64], np.int32)
    rng = np.random.default_rng(h)
    rows = np.stack([rng.permutation(k) for _ in nk]).astype(np.int32)
    rows = np.stack([rows + j for j in range(h)], axis=-1).clip(0, s - 1)
    rows[1] = s
    return words, rows, nk


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("thr", [0.3, 0.55, 0.7])
def test_match_step_and_keep_emulation_equal_jax(h, thr):
    words, rows, nk = _step_inputs(h)
    js, jk = jm.match_step(jnp.asarray(words), jnp.asarray(rows), jnp.asarray(nk), thr, use_pallas=False)
    js, jk = np.asarray(js), np.asarray(jk)
    ts, tk = tm.match_step(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows), torch.from_numpy(nk), thr)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tk.numpy(), jk)
    es, ek = emulate(words, rows, "keep", n_kmers=nk, threshold=thr)
    np.testing.assert_array_equal(es, js)
    np.testing.assert_array_equal(ek.astype(bool), jk)
    assert set(np.unique(ek)) <= {0, 1} and not ek[1].any()
    on_cut = js == np.ceil(np.float32(thr) * nk.astype(np.float32))[:, None]
    assert (on_cut & jk).any()
    if thr in (0.3, 0.55):  # the float64 cut is another mask here: caught
        assert not np.array_equal(emulate(words, rows, "keep", n_kmers=nk, threshold=thr,
                                          mutant="cut_in_f64")[1].astype(bool), jk)


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("h,k", [(1, 128), (3, 96), (1, 120), (2, 33)])
def test_keep_split_emulation_equals_plain(split, h, k):
    """The keep instance with a (query, word) split over 1, 2 and 4 threads
    (each a run of whole 8-slot groups, the last share short or empty at K
    off the group), scores and keep bit for bit against
    match_scores_keep_ref."""
    rng = np.random.default_rng(split * 100 + k)
    s, wp, q = 400, 5, 30
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = _words(rng, s, wp, density=0.25)
    rows = rng.integers(0, s, (q, k, h)).astype(np.int32)
    nk = rng.integers(0, k + 1, q).astype(np.int32)
    nk[::7] = 0
    rows[np.arange(k)[None, :] >= nk[:, None]] = s
    thr = 0.3 if h == 1 else 0.02  # about a quarter of a slot's words hit at H = 1, 1.6% at H = 3
    es, ek = emulate(words, rows, "keep", n_kmers=nk, threshold=thr, split=split)
    ws, wk = opm.match_scores_keep_ref(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows),
                                       torch.from_numpy(nk), thr)
    np.testing.assert_array_equal(es, ws.numpy())
    np.testing.assert_array_equal(ek.astype(bool), wk.numpy())
    assert wk.numpy().any() and set(np.unique(ek)) <= {0, 1}


def test_keep_geometry_fills_about_one_wave():
    """On a card that holds 132 x 2,048 threads (an H100), match_step's
    Q = 2,048 at 68 words splits each (query, word) over 2 threads,
    Q = 9,216 over 1, and so does Q = 2,048 on a card of half the threads;
    at 68 words a query may take 256 threads, so never 4;
    the split geometry at 1 is launch_geometry's, a block holds at most
    BLOCK_THREADS threads."""
    h100 = 132 * 2048
    assert opm.keep_split(68, 128, 1, 2048, h100) == 2
    assert opm.keep_split(68, 128, 3, 2048, h100) == 2
    assert opm.keep_split(68, 128, 1, 9216, h100) == 1
    assert opm.keep_split(68, 128, 1, 64, h100) == 2
    assert opm.keep_split(5, 128, 1, 64, h100) == 4
    assert opm.keep_split(68, 128, 1, 2048, h100 // 2) == 1
    assert opm.keep_geometry(68, 128, 1, 1) == opm.launch_geometry(68, 128, 1)
    for wp, split in ((5, 4), (5, 2), (68, 2), (40, 2)):
        qt, wt = opm.keep_geometry(wp, 128, 1, split)[:2]
        assert qt * wt * split <= max(opm.BLOCK_THREADS, wt * split)
    with pytest.raises(ValueError, match="split"):
        opm.keep_geometry(68, 128, 1, 4)


@pytest.mark.parametrize("thr", [0.0, 1.0, 1000.0, -1.0])
def test_keep_emulation_threshold_edges(thr):
    """The keep mask's integer cut at its edges: a threshold of 0 (every
    column of a query with k-mers, count 0 included), 1 (only full
    counts), past every count, and below 0; queries without k-mers never
    kept."""
    words, rows, nk = _step_inputs(1)
    ws, wk = opm.match_scores_keep_ref(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows),
                                       torch.from_numpy(nk), thr)
    for split in (1, 2):
        es, ek = emulate(words, rows, "keep", n_kmers=nk, threshold=thr, split=split)
        np.testing.assert_array_equal(es, ws.numpy())
        np.testing.assert_array_equal(ek.astype(bool), wk.numpy())
    assert wk.numpy().any() == (thr <= 1.0) and not wk.numpy()[1].any()
