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
algorithm (a warp a row, blocks of R rows; at 2 shards ranks from a row's
heads or by merge-path splits over the windows; at other counts, binary
searches; each row's entries placed in the warp's slice at the row's word
of 16 bytes, the row stored in 16-byte groups with a scalar head and tail,
fillers past the entries, in chunks of output ranks past MERGE_CHUNK)
against its plain version, and mutants of it that must be caught.
Tolerance: exact."""

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


#: B5d's geometry constants (csrc/match_epilogue.cu: kMergeRows,
#: kMergeChunk, kMergeHeads) and the SM count the emulation picks its
#: blocks for (2: blocks of 1 to 8 rows at these sizes)
MERGE_ROWS, MERGE_CHUNK, MERGE_HEADS = 8, 508, 4
EMU_SMS = 2


def merge_geometry(q, kk, n_sm):
    """phylign_merge_topk's launch: rows a block (8, halved while the
    blocks would not give every SM one), output ranks a chunk (kk, at most
    MERGE_CHUNK) and the words of a warp's slice (merge_slot)."""
    rows = MERGE_ROWS
    while rows > 1 and -(-q // rows) < n_sm:
        rows //= 2
    chunk = max(1, min(kk, MERGE_CHUNK))
    return rows, chunk, (chunk + 6) & ~3


def store_row(dst, d0, s, n, nv, m, mutant=None):
    """store_row: n words of a row to dst[d0:], d0 at word m of its 16
    bytes; word k is s[m + k] for k < nv, else -1 (a filler); 16-byte
    groups from dst's first 16-byte boundary on (each group aligned on both
    sides, or the emulation fails), scalars for head and tail. Returns
    whether the row started off a 16-byte boundary."""
    head = min(n, m if mutant == "span_head" else (4 - m) & 3)
    nb = (n - head) >> 2

    def word(k):
        return s[m + k] if k < nv else -1

    for g in range(nb):
        k = head + 4 * g
        assert (d0 + k) % 4 == 0 and (m + k) % 4 == 0, "a 16-byte store off its boundary"
        dst[d0 + k : d0 + k + 4] = [word(k + u) for u in range(4)]
    for k in [*range(head), *range(head + 4 * nb, n)]:
        dst[d0 + k] = word(k)
    return m != 0


def merge_two(a, b, add_b, lo, hi, c0, rv, ri, mutant=None):
    """merge_two: ranks [lo, hi) of the merge of runs a and b (each (values,
    local ids); a first on ties; b's docs plus add_b) to rv, ri at rank -
    c0, lane l from its diagonal's split."""
    (av, ai), (bv, bi) = a, b
    na, nb = len(av), len(bv)
    per = (hi - lo + 31) >> 5
    ahead = (lambda x, y: x > y) if mutant == "merge_ties" else (lambda x, y: x >= y)
    for lane in range(32):
        d = lo + lane * per
        d1 = min(d + per, hi)
        if d >= d1:
            continue
        i, i1 = max(0, d - nb), min(d, na)
        while i < i1:
            mid = (i + i1) >> 1
            if ahead(av[mid], bv[d - 1 - mid]):
                i = mid + 1
            else:
                i1 = mid
        j = d - i
        for d in range(d, d1):
            if j >= nb or (i < na and ahead(av[i], bv[j])):
                rv[d - c0], ri[d - c0] = av[i], ai[i]
                i += 1
            else:
                rv[d - c0], ri[d - c0] = bv[j], bi[j] + add_b
                j += 1


def count_ahead(v, x, ge):
    lo, hi = 0, len(v)
    while lo < hi:
        mid = (lo + hi) >> 1
        if v[mid] > x or (ge and v[mid] == x):
            lo = mid + 1
        else:
            hi = mid
    return lo


def emulate_merge(windows, lims, w_loc, kk, n_sm=EMU_SMS, mutant=None, stats=None):
    """merge_topk_kernel on merge_geometry's launch, a warp a row: lane e
    loads shard e's n_keep (n_keep out: their sum); the row uses min(n_keep,
    lim, kk) entries of shard e; in each chunk of output ranks the ranked
    entries go to the warp's slice at the row's word of 16 bytes m (ranks
    at 2 shards from the heads, each shard's first MERGE_HEADS entries,
    when the row uses no more of either: an entry's place plus the other
    run's entries ahead of it, shard 1's ties counted; else by merge_two;
    at other counts of shards an entry's place plus count_ahead in every
    other run, f < e counting ties; doc + e w_loc), then store_row writes
    the chunk, fillers past the entries. An empty row places nothing.
    Unset words read -9 (shared memory) and -7 (device memory). ``stats``
    gets the rows by path, the chunks of the first row, how many stores
    started off a 16-byte boundary, the block sizes."""
    q = windows[0][0].shape[0]
    nd = len(windows)
    rows, chunk, slot = merge_geometry(q, kk, n_sm)
    vals = np.full(q * kk, -7, np.int64)
    idx = np.full(q * kk, -7, np.int64)
    n_keep = np.full(q, -7, np.int64)
    add = [0 if mutant == "local_ids" else e * w_loc for e in range(nd)]
    st = {"empty": 0, "from_heads": 0, "merge_path": 0, "searched": 0, "chunks": 0, "spans_off": 0,
          "rows": {rows}}
    for row in range(q):
        nk = [0 if ne is None else int(ne[row]) for _, _, ne in windows]
        n_keep[row] = sum(nk)
        cnt = [min(max(n, 0), lim, kk) for n, lim in zip(nk, lims)]
        runs = [(windows[e][0][row, : cnt[e]], windows[e][1][row, : cnt[e]]) for e in range(nd)]
        total = sum(cnt)
        valid = min(total, kk)
        from_heads = nd == 2 and max(cnt) <= MERGE_HEADS
        path = "empty" if total == 0 else "from_heads" if from_heads else "merge_path" if nd == 2 else "searched"
        st[path] += 1
        for c0 in range(0, kk, chunk):
            st["chunks"] += row == 0
            c1 = min(c0 + chunk, kk)
            hi = min(c1, valid)
            m = (row * kk + c0) & 3
            at = 0 if mutant == "span_start" else m  # where rank c0 sits in the slice
            sv, si = np.full(slot, -9, np.int64), np.full(slot, -9, np.int64)
            if hi > c0 and from_heads:
                for e in range(2):  # lane 4 e + k holds entry k of shard e
                    (ve, ie), (vo, _) = runs[e], runs[1 - e]
                    for k, x in enumerate(ve):
                        ahead = (vo > x) if (e == 0) != (mutant == "heads_ties") else (vo >= x)
                        rank = k + int(ahead.sum())
                        if c0 <= rank < hi:
                            sv[at + rank - c0], si[at + rank - c0] = x, ie[k] + add[e]
            elif hi > c0 and nd == 2:
                merge_two(runs[0], runs[1], add[1], c0, hi, c0, sv[at:], si[at:], mutant)
            elif hi > c0:
                for e in range(nd):
                    ve, ie = runs[e]
                    for j in range(min(len(ve), hi)):  # lane j % 32
                        x, rank = int(ve[j]), j
                        for f in range(nd):
                            if rank >= hi:
                                break
                            if f != e:
                                ge = (f > e) if mutant == "ties_after" else (f < e)
                                rank += count_ahead(runs[f][0], x, ge)
                        if c0 <= rank < hi:
                            sv[at + rank - c0], si[at + rank - c0] = x, ie[j] + add[e]
            st["spans_off"] += store_row(vals, row * kk + c0, sv, c1 - c0, hi - c0, m, mutant)
            store_row(idx, row * kk + c0, si, c1 - c0, hi - c0, m, mutant)
    if stats is not None:
        stats.update(st)
    return vals.reshape(q, kk), idx.reshape(q, kk), n_keep


def shard_windows(seed, q, nd, w_loc, kk, tie_vals, empty=(), cut=None):
    """Each shard's window as B5b leaves it (its plain version) on tie-heavy
    scores, with empty shards; ``cut`` (every query's) in place of random
    ones."""
    rng = np.random.default_rng(seed)
    lims, wins = [], []
    for e in range(nd):
        lim = 0 if e in empty else min(kk, w_loc)
        lims.append(lim)
        if e in empty:
            wins.append((torch.empty((q, 0), dtype=torch.int32),) * 2 + (None,))
            continue
        sc = torch.from_numpy(rng.integers(0, tie_vals, (q, w_loc)).astype(np.int32))
        cuts = rng.integers(0, tie_vals, q) if cut is None else np.full(q, cut)
        wins.append(tm._topk_scores_ref(sc, torch.from_numpy(cuts.astype(np.int32)), lim, w_loc))
    return wins, lims


def as_numpy(wins):
    return [tuple(None if t is None else t.numpy() for t in w) for w in wins]


MERGE_CASES = [
    # (q, nd, w_loc, kk, tie_vals, empty shards)
    (6, 2, 40, 16, 3, ()),
    (5, 4, 24, 60, 2, (2,)),
    (4, 1, 70, 40, 30, ()),
    (3, 16, 8, 20, 2, (0, 15)),
    (4, 3, 16, 24, 2, (0, 1, 2)),
    # kk odd: blocks of 1 row, the second row a word past a 16-byte
    # boundary
    (2, 2, 40, 33, 3, ()),
    # Q not a multiple of R (blocks of 8 and 5 rows), kk odd, 3 shards
    (13, 3, 30, 27, 3, ()),
    # 16 x 64 entries a row, each ranked by 15 binary searches
    (10, 16, 64, 64, 2, ()),
    # 16 shards, kk odd, one shard empty
    (9, 16, 12, 45, 3, (4,)),
    # kk past a warp's slice (chunks of 508 ranks, rows off a 16-byte
    # boundary)
    (17, 2, 600, 521, 50, ()),
    # rows using at most 4 of each shard (ranked from their heads) beside
    # rows using more, in one block
    (8, 2, 8, 16, 6, ()),
]


@pytest.mark.parametrize("q,nd,w_loc,kk,tie_vals,empty", MERGE_CASES)
def test_merge_emulation_equals_plain(q, nd, w_loc, kk, tie_vals, empty):
    wins, lims = shard_windows(q + nd, q, nd, w_loc, kk, tie_vals, empty)
    want = [t.numpy() for t in tm._merge_topk(wins, lims, w_loc, kk)]
    got = emulate_merge(as_numpy(wins), lims, w_loc, kk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (want[0] >= 0).sum() > 0 or len(empty) == nd


def test_merge_emulation_reaches_its_edges():
    """MERGE_CASES take every path of the kernel: blocks of 2, 4 and 8
    rows, empty rows, rows ranked from their heads, by merge path and by
    binary searches, a chunked output, stores that start off a 16-byte
    boundary."""
    paths = ("empty", "from_heads", "merge_path", "searched", "spans_off")
    seen = {k: 0 for k in paths} | {"rows": set(), "chunked": 0}
    for q, nd, w_loc, kk, tie_vals, empty in MERGE_CASES:
        wins, lims = shard_windows(q + nd, q, nd, w_loc, kk, tie_vals, empty)
        st = {}
        emulate_merge(as_numpy(wins), lims, w_loc, kk, stats=st)
        for k in paths:
            seen[k] += st[k]
        seen["rows"] |= st["rows"]
        seen["chunked"] += st["chunks"] > 1
    assert all(seen[k] for k in (*paths, "chunked"))
    assert {2, 4, 8} <= seen["rows"]


@pytest.mark.parametrize("nd", [2, 5])
def test_merge_emulation_every_row_empty(nd):
    """A cut above every score: no row takes anything, each is fillers only
    (ranking skipped), n_keep 0."""
    wins, lims = shard_windows(nd, 11, nd, 30, 21, 4, cut=4)
    want = [t.numpy() for t in tm._merge_topk(wins, lims, 30, 21)]
    st = {}
    got = emulate_merge(as_numpy(wins), lims, 30, 21, stats=st)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (want[0] == -1).all() and (want[2] == 0).all()
    assert st["empty"] == 11 and st["from_heads"] == st["merge_path"] == st["searched"] == 0


#: each mutant and a case whose path it breaks: the tie rule of the binary
#: searches (3+ shards), the doc offset, the merge-path tie rule (2 shards,
#: rows using more than their heads), the heads' tie rule, the row's word
#: of 16 bytes in the slice, the head's length (a 16-byte store off its
#: boundary)
MUTANT_CASES = {
    "ties_after": (5, 4, 24, 60, 2, (2,)),
    "local_ids": (6, 2, 40, 16, 3, ()),
    "merge_ties": (6, 2, 60, 40, 3, ()),
    "heads_ties": (8, 2, 8, 16, 6, ()),
    "span_start": (2, 2, 40, 33, 3, ()),
    "span_head": (2, 2, 40, 33, 3, ()),
}


@pytest.mark.parametrize("mutant", sorted(MUTANT_CASES))
def test_merge_emulation_mutants_are_caught(mutant):
    q, nd, w_loc, kk, tie_vals, empty = MUTANT_CASES[mutant]
    wins, lims = shard_windows(1, q, nd, w_loc, kk, tie_vals, empty)
    want = [t.numpy() for t in tm._merge_topk(wins, lims, w_loc, kk)]
    if mutant == "span_head":
        with pytest.raises(AssertionError, match="a 16-byte store off its boundary"):
            emulate_merge(as_numpy(wins), lims, w_loc, kk, mutant=mutant)
        return
    got = emulate_merge(as_numpy(wins), lims, w_loc, kk, mutant=mutant)
    assert not all(np.array_equal(a, b) for a, b in zip(got, want))
