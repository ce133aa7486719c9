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


def emulate(words, rows, epilogue="store", acc=None, r0=0, r1=None, n_kmers=None, threshold=0.0,
            mutant=None):
    """match_popcount_kernel<P, HC, EP> with its launch geometry
    (ops/match.launch_geometry). The row indices are staged raw under acc
    and clamped into [0, S] otherwise (or read in place, the same values);
    a slot row is read only when acc's window test passes ((uint32) (g -
    r0) < r1 - r0: rows before r0 wrap past the window) or, otherwise, when
    the first row is not the zero row S; a slot ANDs its H rows. Counts go
    through carry-save planes, then into the block's shared memory and from
    there in 16-byte pieces to the block's contiguous rows, or straight
    from each thread. Under acc each 16-byte piece of the accumulator is
    loaded, added to and stored; under keep each thread writes the 32 keep
    bytes of its word, f32(count) >= f32(threshold) * f32(n_kmers[q]) (one
    rounding) and n_kmers[q] > 0. Returns out (acc under acc) and keep."""
    q, k, h = rows.shape
    n_rows, wp = words.shape
    qt, wt, staged, via_smem = opm.launch_geometry(wp, k, h)
    last = n_rows - 1
    out = acc.astype(np.int64).copy() if epilogue == "acc" else np.full((q, 32 * wp), -1, np.int64)
    keep = np.full((q, 32 * wp), 7, np.uint8)
    n_win = np.uint32((r1 if r1 is not None else n_rows) - r0)
    t = np.arange(qt * wt)
    for blk in range(-(-q // qt)):
        q0 = blk * qt
        nq = min(qt, q - q0)
        ri = rows[q0 : q0 + nq].reshape(nq, k * h)
        if epilogue != "acc":
            ri = np.clip(ri, 0, last)
        smem = np.zeros((nq, 32 * wp), np.int64)
        ql, w0 = t // wt, t % wt
        for step in range(-(-wp // wt)):
            w = w0 + step * wt
            live = (ql < nq) & (w < wp)
            qi, wi = ql[live], w[live]
            r = ri[qi].reshape(-1, k, h)

            def word(g, first):
                if epilogue == "acc":
                    off = g.astype(np.uint32) - np.uint32(r0)
                    ok = off <= n_win if mutant == "window_inclusive" else off < n_win
                    if mutant == "clamp_to_block":
                        off, ok = np.minimum(off, n_win - np.uint32(1)), np.ones_like(ok)
                    return np.where(ok, words[np.where(ok, off, 0).astype(np.int64), wi], np.uint32(0))
                if first:
                    return np.where(g == last, np.uint32(0), words[g, wi])
                return words[g, wi]

            def slot(j):
                x = word(r[:, j, 0], True)
                for t2 in range(1, h):
                    x = x & word(r[:, j, t2], False)
                return x

            pl = Planes(qi.shape, kernel_planes(k))
            j = 0
            while j + 8 <= k:
                pl.add8([slot(j + i) for i in range(8)])
                j += 8
            for j in range(j, k):
                pl.ripple(slot(j))
            counts = pl.unpack()
            cols = 32 * wi[:, None] + np.arange(32)
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
                out[q0 + qi[:, None], cols] = counts + (out[q0 + qi[:, None], cols] if epilogue == "acc" else 0)
        if via_smem:
            pieces = out[q0 : q0 + nq].reshape(-1, 4)
            pieces[:] = smem.reshape(-1, 4) + (pieces if epilogue == "acc" else 0)
    return out, keep


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
