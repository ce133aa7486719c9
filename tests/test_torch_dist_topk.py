"""The mesh's match epilogue on the CPU: ``parallel/dist.dist_topk`` and
``dist_threshold_topk`` (a threshold + top-k per doc shard, kernel B5b on
the card, then the merge of the shards' windows, kernel B5d) against the
JAX package's ``phylign_tpu.parallel.dist`` on conftest's virtual CPU
devices, word for word: ``dist_topk``'s whole window; for
``dist_threshold_topk`` n_keep and each row's first min(n_keep, kk)
entries (values, global doc ids, order), the port's fillers past them
being -1 with doc -1. Meshes of 1, 2 and 4 doc shards and 1 and 2 query
shards, tie runs across the shards' edges, a shard wholly past d, a query
with no qualifying doc, kk > w_loc. Then a numpy emulation of B5d's own
algorithm (a warp per query, each taken entry's rank from binary searches
in the other windows) against its plain version, and mutants of it that
must be caught. Tolerance: exact."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.parallel import dist as jdist
from phylign_tpu_torch.models import matcher as tm
from phylign_tpu_torch.parallel import dist

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_parallel import cpu_mesh, jax_mesh  # noqa: E402

MESHES = [(nd, nq) for nd in (1, 2, 4) for nq in (1, 2)]


def tied_inputs(seed, wp=16, s=200, q=8, k=48):
    """Words [S+1, Wp] (zero last row) whose docs 100-160 share doc 99's
    bits and docs 250-300 doc 249's, so equal scores run across the edges
    of 2 and 4 doc shards (columns 128 and 256, of 512); rows [Q, K, 1]."""
    rng = np.random.default_rng(seed)
    bits = rng.random((s, 32 * wp)) < 0.3
    bits[:, 100:160] = bits[:, 99:100]
    bits[:, 250:300] = bits[:, 249:250]
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = (bits.reshape(s, wp, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    rows = rng.integers(0, s, (q, k, 1)).astype(np.int32)
    return words, rows


@pytest.mark.parametrize("nd,nq", MESHES)
@pytest.mark.parametrize("k_total", [None, 140])
def test_dist_topk_equals_jax(nd, nq, k_total):
    """The whole window, word for word; k_total 140 > w_loc at 4 shards."""
    words, rows = tied_inputs(nd + nq)
    mesh, jm = cpu_mesh(nd, nq), jax_mesh(nd, nq)
    scores = dist.dist_match_scores(mesh, words.view(np.int32), rows)
    got = [dist.fetch(x) for x in dist.dist_topk(mesh, scores, n_best=4, k_total=k_total)]
    jscores = jdist.dist_match_scores(jm, jnp.asarray(words), jnp.asarray(rows))
    want = [np.asarray(x) for x in jdist.dist_topk(jm, jscores, n_best=4, k_total=k_total)]
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    s = dist.fetch(scores)
    assert any(len(set(s[q, 90:170])) < 20 for q in range(len(s)))  # the tie runs are there


@pytest.mark.parametrize("nd,nq", MESHES)
@pytest.mark.parametrize("d,kk", [(300, 32), (150, 160), (512, 8)])
def test_dist_threshold_topk_equals_jax(nd, nq, d, kk):
    """n_keep exactly; the first min(n_keep, kk) entries of each row word
    for word; -1 and doc -1 past them. d = 150 leaves the last shard of 4
    (columns 384-511) and most of the third wholly past d; kk = 160 > w_loc
    = 128 there."""
    words, rows = tied_inputs(10 * nd + nq)
    s = dist.fetch(dist.dist_match_scores(cpu_mesh(1, 1), words.view(np.int32), rows))[:, :d]
    cut = np.array([np.quantile(r, 0.7) for r in s]).astype(np.int32)
    cut[1] = 1 << 30  # nothing qualifies
    cut[2] = 0  # everything qualifies: n_keep = d > kk
    mesh, jm = cpu_mesh(nd, nq), jax_mesh(nd, nq)
    got = [dist.fetch(x) for x in dist.dist_threshold_topk(mesh, words.view(np.int32), rows, cut, d, kk)]
    want = [np.asarray(x) for x in jdist.dist_threshold_topk(
        jm, jnp.asarray(words), jnp.asarray(rows), jnp.asarray(cut), d, kk)]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == want[0].shape
    for q in range(len(cut)):
        m = min(int(got[2][q]), got[0].shape[1])
        np.testing.assert_array_equal(got[0][q, :m], want[0][q, :m])
        np.testing.assert_array_equal(got[1][q, :m], want[1][q, :m])
        assert (got[0][q, m:] == -1).all() and (got[1][q, m:] == -1).all()
        assert (want[0][q, m:] == -1).all()
    assert got[2][1] == 0 and got[2][2] == d
    assert (got[2] > 0).sum() > 2


# --- B5d: numpy emulation of the kernel's algorithm -----------------------------


def emulate_merge(windows, lims, w_loc, kk, mutant=None):
    """merge_topk_kernel: a warp per query; shard e's take = min(n_keep,
    lim), 0 without a count; lane l takes entries l, l + 32, ... of each
    window; an entry's rank is its position plus, in every other window f,
    the entries ahead of it found by a binary search of f's take (f < e:
    scores >= its score; f > e: scores > it), stopping once the rank
    reaches kk; written at its rank with doc + e * w_loc when below kk;
    ranks from the takes' sum to kk get -1, doc -1; n_keep the counts'
    sum."""
    q = windows[0][0].shape[0]
    vals = np.full((q, kk), -7, np.int64)
    idx = np.full((q, kk), -7, np.int64)
    n_keep = np.zeros(q, np.int64)

    def take(e, row):
        n = windows[e][2]
        return 0 if n is None else max(0, min(int(n[row]), lims[e]))

    def ahead(v, n, x, ge):
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) >> 1
            if v[mid] > x or (ge and v[mid] == x):
                lo = mid + 1
            else:
                hi = mid
        return lo

    for row in range(q):
        total = 0
        for e, (v, i, n) in enumerate(windows):
            t = take(e, row)
            for lane in range(32):
                for j in range(lane, t, 32):
                    x = int(v[row, j])
                    rank = j
                    for f in range(len(windows)):
                        if rank >= kk:
                            break
                        if f != e:
                            ge = (f > e) if mutant == "ties_after" else (f < e)
                            rank += ahead(windows[f][0][row], take(f, row), x, ge)
                    if rank < kk:
                        vals[row, rank] = x
                        idx[row, rank] = int(i[row, j]) + (0 if mutant == "local_ids" else e * w_loc)
            total += t
            n_keep[row] += 0 if n is None else int(n[row])
        vals[row, total:] = -1
        idx[row, total:] = -1
    return vals, idx, n_keep


def shard_windows(seed, q, nd, w_loc, kk, tie_vals, empty=()):
    """Each shard's window as B5b leaves it (its plain version) on tie-heavy
    scores, with empty shards."""
    rng = np.random.default_rng(seed)
    lims, wins = [], []
    for e in range(nd):
        lim = 0 if e in empty else min(kk, w_loc)
        lims.append(lim)
        if e in empty:
            wins.append((torch.empty((q, 0), dtype=torch.int32),) * 2 + (None,))
            continue
        sc = torch.from_numpy(rng.integers(0, tie_vals, (q, w_loc)).astype(np.int32))
        cut = torch.from_numpy(rng.integers(0, tie_vals, q).astype(np.int32))
        wins.append(tm._topk_scores_ref(sc, cut, lim, w_loc))
    return wins, lims


MERGE_CASES = [
    # (q, nd, w_loc, kk, tie_vals, empty shards)
    (6, 2, 40, 16, 3, ()),
    (5, 4, 24, 60, 2, (2,)),
    (4, 1, 70, 40, 30, ()),
    (3, 16, 8, 20, 2, (0, 15)),
    (4, 3, 16, 24, 2, (0, 1, 2)),
]


@pytest.mark.parametrize("q,nd,w_loc,kk,tie_vals,empty", MERGE_CASES)
def test_merge_emulation_equals_plain(q, nd, w_loc, kk, tie_vals, empty):
    wins, lims = shard_windows(q + nd, q, nd, w_loc, kk, tie_vals, empty)
    want = [t.numpy() for t in tm._merge_topk(wins, lims, w_loc, kk)]
    got = emulate_merge([tuple(None if t is None else t.numpy() for t in w) for w in wins], lims, w_loc, kk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (want[0] >= 0).sum() > 0 or len(empty) == nd


@pytest.mark.parametrize("mutant", ["ties_after", "local_ids"])
def test_merge_emulation_mutants_are_caught(mutant):
    wins, lims = shard_windows(1, 6, 2, 40, 16, 3)
    want = [t.numpy() for t in tm._merge_topk(wins, lims, 40, 16)]
    got = emulate_merge([tuple(t.numpy() for t in w) for w in wins], lims, 40, 16, mutant=mutant)
    assert not all(np.array_equal(a, b) for a, b in zip(got, want))
