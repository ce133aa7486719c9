"""Kernel B5, the match epilogue (``csrc/match_epilogue.cu``), on the CPU.

The port's plain versions (``models/matcher._topk_scores_ref``,
``_hash_rows_ref``, ``_pack_hits_ref``) against the JAX package's
``_topk_scores``, ``_hash_topk`` and ``_hash_topk_flat`` on inputs made
from a numpy seed: the window in ``jax.lax.top_k``'s order (score
descending, doc ascending) and the whole flat hit buffer, bit for bit.
Then a numpy emulation of each kernel's own algorithm (B5a's thread per
slot in 64-bit unsigned arithmetic, B5b's warp per row with its 16-byte
chunks, stash, radix-select digits and LSD rank rule, B5c's tiles of
n_keep's 16-byte granules, a warp a tile with each word's query found by
a search over the lanes, and its fill of 16-byte stores from the first
aligned word), held to the plain versions, and mutants of the emulations
that the comparison must catch.
Tolerance: exact (0 difference, whole buffers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_matcher import _hash_inputs, _t

from phylign_tpu.models import matcher as jm
from phylign_tpu_torch.models import matcher as tm

NO_KMERS = 1 << 30


# --- cases --------------------------------------------------------------------


def _scores_case(name, seed=0):
    """(scores int32 [Q, W], cut int32 [Q], kk, d) of one named case."""
    rng = np.random.default_rng(seed)
    q, d, w, kk = 48, 300, 320, 64
    if name == "dense_ties":  # 6 values: most rows overflow the window on ties
        s = rng.integers(0, 6, (q, w))
        cut = rng.integers(0, 6, q)
    elif name == "kk_eq_d":
        d = w = kk = 96
        s = rng.integers(0, 10, (q, w))
        cut = rng.integers(0, 10, q)
    elif name == "n_keep_edges":  # n_keep 0, kk - 1, kk, kk + 1 and more
        s = rng.integers(0, 50, (q, w))
        cut = np.full(q, 50)
        for r, n in enumerate([0, 1, kk - 1, kk, kk + 1, 2 * kk, d]):
            docs = rng.choice(d, n, replace=False)
            s[r, docs] = rng.integers(50, 53, n)
            cut[r] = 50
    elif name == "threshold_zero":  # every doc qualifies, every row overflows
        s = rng.integers(0, 129, (q, w))
        cut = np.zeros(q)
    elif name == "no_kmers":  # rows of queries without k-mers: an unreachable cut
        s = rng.integers(0, 20, (q, w))
        cut = np.where(rng.random(q) < 0.5, NO_KMERS, rng.integers(0, 20, q))
    elif name == "segment_scores":  # accumulated segment scores past 512, tied
        s = 50 * rng.integers(8, 60, (q, w))
        cut = rng.integers(400, 2000, q)
    elif name == "ragged_d":  # d not a multiple of 4 or 128, one partial chunk
        d, w, kk = 131, 160, 32
        s = rng.integers(0, 4, (q, w))
        cut = rng.integers(0, 4, q)
    else:
        raise KeyError(name)
    s[:, d:] = 7  # columns past d never count
    return s.astype(np.int32), cut.astype(np.int32), kk, d


SCORE_CASES = ["dense_ties", "kk_eq_d", "n_keep_edges", "threshold_zero", "no_kmers",
               "segment_scores", "ragged_d"]


def _plain_topk(s, cut, kk, d):
    return [a.numpy() for a in tm._topk_scores(torch.from_numpy(s), torch.from_numpy(cut), kk, d)]


# --- the plain versions against the JAX package ---------------------------------


@pytest.mark.parametrize("name", SCORE_CASES)
def test_topk_scores_equals_jax_in_order(name):
    """vals, idx and n_keep equal jax's _topk_scores (its u16 window as
    int32), the order inside the window included."""
    s, cut, kk, d = _scores_case(name)
    want = [np.asarray(a).astype(np.int32)
            for a in jm._topk_scores(jnp.asarray(s), jnp.asarray(cut), kk=kk, d=d)]
    got = _plain_topk(s, cut, kk, d)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    n_keep = got[2]
    if name == "n_keep_edges":
        assert list(n_keep[:7]) == [0, 1, kk - 1, kk, kk + 1, 2 * kk, d]
    if name in ("dense_ties", "threshold_zero"):
        assert (n_keep > kk).sum() > 10
    if name == "no_kmers":
        assert (n_keep == 0).any() and (n_keep > 0).any()
    if name == "segment_scores":
        assert got[0].max() > 512


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("cap_frac", [1.0, 0.3])
def test_flat_buffer_equals_jax(h, cap_frac):
    """The whole [cap | Q n_keep | total] buffer of _hash_topk_flat, viewed
    as uint32, equals JAX's word for word (cap_frac 0.3: total > cap)."""
    words, hi, lo, nk, cut = _hash_inputs(3 + h, h=h, thr=0.45 / h)
    s, kk, d, q = 997, 64, 96, hi.shape[0]
    cap = max(1, int(cap_frac * q * kk))
    want = np.asarray(jm._hash_topk_flat(
        jnp.asarray(words), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(nk), jnp.asarray(cut),
        s=s, pad_row=s, kk=kk, d=d, cap=cap,
    ))
    got = tm._hash_topk_flat(
        _t(words.view(np.int32)), _t(hi.astype(np.int64)), _t(lo.astype(np.int64)), _t(nk), _t(cut),
        s=s, pad_row=s, kk=kk, d=d, cap=cap,
    ).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert (int(want[-1]) > cap) == (cap_frac < 1)


def test_dense_window_equals_jax():
    """_hash_topk's dense [Q, kk] window (the refetch when total > cap)
    equals JAX's, order included."""
    words, hi, lo, nk, cut = _hash_inputs(9, thr=0.4)
    kw = dict(s=997, pad_row=997, kk=64, d=96)
    want = jm._hash_topk(jnp.asarray(words), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(nk),
                         jnp.asarray(cut), **kw)
    got = tm._hash_topk(_t(words.view(np.int32)), _t(hi.astype(np.int64)), _t(lo.astype(np.int64)),
                        _t(nk), _t(cut), **kw)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_).astype(np.int32))
    assert (got[2].numpy() > 64).any()


# --- numpy emulations of the kernels --------------------------------------------


def emu_hash_rows(hi, lo, nk, s, pad_row, mutant=None):
    """B5a: a block per query, a thread per (slot, hash); the 64-bit
    unsigned hash modulo s, the padding row at slot >= nk."""
    q, k, h = hi.shape
    x = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    if mutant == "signed_hash":  # the hash read as int64
        rows = x.view(np.int64) % np.int64(s)
    else:
        rows = x % np.uint64(s)
    slot = np.arange(k * h).reshape(k, h) // h
    return np.where(slot[None] < nk[:, None, None], rows, pad_row).astype(np.int32)


def _warp_excl(x):
    """The warp's exclusive shuffle prefix over 32 lanes, and the total."""
    inc = np.cumsum(x)
    return inc - x, int(inc[-1])


def _chunks(row, d):
    """Each 128-doc chunk as the warp loads it: lane l holds docs j0 + 4l ..
    j0 + 4l + 3 ([32, 4] docs and scores, -1 past d)."""
    for base in range(0, d, 128):
        j = base + 4 * np.arange(32)[:, None] + np.arange(4)[None, :]
        yield j, np.where(j < d, row[np.minimum(j, len(row) - 1)], -1)


def _stash_flagged(fl, x, j, n, kk, sv, sd):
    """Stash the flagged docs at n + the lane's prefix + its earlier flags;
    positions >= kk are dropped."""
    excl, total = _warp_excl(fl.sum(1))
    for lane in range(32):
        pos = n + excl[lane]
        for t in range(4):
            if fl[lane, t]:
                if pos < kk:
                    sv[pos], sd[pos] = x[lane, t], j[lane, t]
                pos += 1
    return total


def _select_bin(hist, rem, mutant):
    """Lane l owns bins 255 - 8l .. 248 - 8l; the bin holding the rem-th
    largest entry, and the entries above it."""
    own = np.array([hist[255 - 8 * lane - np.arange(8)].sum() for lane in range(32)])
    cum0, _ = _warp_excl(own)
    for lane in range(32):
        cum = cum0[lane]
        for i in range(8):
            b = 255 - 8 * lane - i
            if cum < rem <= cum + hist[b]:
                return (b - 1 if mutant == "digit_off_by_one" and b > 0 else b), cum
            cum += hist[b]
    raise AssertionError("no bin holds the rem-th entry")


def emu_threshold_topk(scores, cut, kk, d, mutant=None):
    """B5b, a warp per row: one pass counting and stashing; past kk the
    radix select of t* over 8-bit digits and a compaction pass; then the
    stable LSD radix sort of the stash, one 32-entry chunk at a time (an
    entry's place in its digit's run: the lanes below it with that digit)."""
    q = scores.shape[0]
    vals = np.zeros((q, kk), np.int32)
    idx = np.zeros((q, kk), np.int32)
    n_keep = np.zeros(q, np.int32)
    for r in range(q):
        row, c = scores[r].astype(np.int64), int(cut[r])
        sv, sd = np.zeros(kk, np.int64), np.zeros(kk, np.int64)
        n, mx = 0, 0
        for j, x in _chunks(row, d):
            fl = (x >= 0) & (x >= c)
            mx = max(mx, int(x[fl].max(initial=0)))
            n += _stash_flagged(fl, x, j, n, kk, sv, sd)
        if n > kk and kk > 0:
            rem, prefix = kk, 0
            top = mx.bit_length() - 1 if mx > 0 else 0
            for shift in range(top // 8 * 8, -1, -8):
                hist = np.zeros(256, np.int64)
                hmask = 0 if shift + 8 >= 32 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
                for _, x in _chunks(row, d):
                    sel = (x >= 0) & (x >= c) & ((x & hmask) == prefix)
                    np.add.at(hist, (x[sel] >> shift) & 255, 1)
                b, above = _select_bin(hist, rem, mutant)
                rem -= above
                prefix |= b << shift
            tstar, need_eq, m, eq_seen = prefix, rem, 0, 0
            for j, x in _chunks(row, d):
                eq = x == tstar
                excl, te = _warp_excl(eq.sum(1))
                e = eq_seen + excl[:, None] + np.cumsum(eq, 1) - eq
                lim = need_eq + (mutant == "one_more_tie")
                fl = (x > tstar) | (eq & (e < lim))
                eq_seen += te
                m += _stash_flagged(fl, x, j, m, kk, sv, sd)
        m = min(n, kk)
        passes = (mx.bit_length() + 7) // 8 if m > 1 else 0
        for p in range(passes):
            dig = (sv[:m] >> (8 * p)) & 255
            hist = np.bincount(dig, minlength=256)
            own = np.array([hist[255 - 8 * lane - np.arange(8)].sum() for lane in range(32)])
            start = np.zeros(256, np.int64)
            cum0, _ = _warp_excl(own)
            for lane in range(32):
                cum = cum0[lane]
                for i in range(8):
                    b = 255 - 8 * lane - i
                    start[b], cum = cum, cum + hist[b]
            tv, td = np.zeros(kk, np.int64), np.zeros(kk, np.int64)
            for i0 in range(0, m, 32):
                dg = dig[i0 : i0 + 32]
                for lane, g in enumerate(dg):
                    peers = dg == g
                    ahead = peers[lane + 1 :].sum() if mutant == "tie_later_doc" else peers[:lane].sum()
                    pos = start[g] + ahead
                    tv[pos], td[pos] = sv[i0 + lane], sd[i0 + lane]
                for g in np.unique(dg):
                    start[g] += (dg == g).sum()
            sv, sd = tv, td
        vals[r, :m], idx[r, :m], n_keep[r] = sv[:m], sd[:m], n
    return vals, idx, n_keep


#: B5c's constants (csrc/match_epilogue.cu): threads a block, the most
#: tiles, rounds of 32 hit words a warp loads before it stores them, the
#: 16-byte stores a thread the grid is sized for, the most blocks
PACK_THREADS, PACK_MAX_TILES, PACK_ROUNDS, PACK_FILL_STORES, PACK_MAX_BLOCKS = 256, 8192, 4, 4, 132
PACK_WARPS = PACK_THREADS // 32


def pack_geometry(q, cap, nk_mis, max_tiles=PACK_MAX_TILES, max_blocks=PACK_MAX_BLOCKS):
    """phylign_pack_hits's launch: (chunks of n_keep's 16-byte granules,
    tile shift, tiles, blocks)."""
    nchunks = (q + nk_mis + 3) // 4
    shift = 0
    while -(-nchunks // (32 << shift)) > max_tiles:
        shift += 1
    nt = -(-nchunks // (32 << shift))
    by_fill = -(-((cap + q + 4) // 4) // (PACK_THREADS * PACK_FILL_STORES))
    return nchunks, shift, nt, min(max(nt, by_fill, 1), max_blocks)


def emu_pack_hits(vals, idx, n_keep, kk, cap, nk_mis=0, out_mis=0, max_tiles=PACK_MAX_TILES,
                  max_blocks=PACK_MAX_BLOCKS, mutant=None):
    """B5c. n_keep read as its 16-byte granules (nk_mis: its first word's
    place in its granule; the granule's other words hold junk the takes
    must not count), a tile of 32 << shift chunks. The copy of n_keep at
    [cap, cap + Q), then the tile sums a warp's 32 chunks at a time, the
    total, the zeros [min(total, cap), cap) and the total's word; each
    region from the first word whose address (out_mis: the buffer's first
    word's place in its granule) is 16-byte aligned: the scalar head, the
    16-byte body, the scalar tail. Then a warp a tile over the grid's warps
    (warp * grid + block, striding by every warp), from the sum of the
    tiles before it, 32 chunks a pass, the pass's words below cap by lane
    w % 32: word w's lane by a search of the lanes' first words (steps of
    16, 8, 4, 2, 1), its query and column by that lane's select chain.
    Every word must be written exactly once: a word written twice comes
    back -9, one never written -7."""
    q = len(n_keep)
    nchunks, shift, nt, grid = pack_geometry(q, cap, nk_mis, max_tiles, max_blocks)
    gran = np.full(4 * nchunks + 128, 1 << 20, np.int64)  # junk past the granules too
    gran[nk_mis : nk_mis + q] = n_keep
    e_of = np.arange(len(gran)) - nk_mis
    take = np.where((e_of >= 0) & (e_of < q), np.minimum(gran, kk), 0).reshape(-1, 4)
    out = np.full(cap + q + 1, -7, np.int64)
    writes = np.zeros(cap + q + 1, np.int64)

    def store(p, v):
        out[p] = v
        writes[p] += 1

    def fill(lo, hi, value, below=False):
        """[lo, hi): the head, 16-byte granules from p0, the tail."""
        p0 = lo - (out_mis + lo) % 4 if below else lo + (-(out_mis + lo)) % 4
        pb = p0 + 4 * ((hi - p0) // 4 if p0 < hi else 0)
        assert (out_mis + p0) % 4 == 0
        body = np.arange(p0, pb)
        store(body, value(body))
        for w_ in [*range(lo, min(p0, hi)), *range(pb, hi)]:
            store(w_, value(w_))

    fill(cap, cap + q, lambda w_: n_keep[w_ - cap])
    tile_sum = np.zeros(nt, np.int64)
    for c0 in range(0, nchunks, 32):
        tile_sum[c0 >> (5 + shift)] += take[c0 : c0 + 32].sum()
    total = int(tile_sum.sum())
    fill(min(total, cap), cap, lambda w_: 0 * w_, below=mutant == "body_from_aligned_below")
    store(cap + q, total)
    for blk in range(grid):
        for w_ in range(PACK_WARPS):
            for j in range(w_ * grid + blk, nt, grid * PACK_WARPS):
                base = int(tile_sum[: j + (mutant == "prefix_counts_own_first")].sum())
                for c0 in range(j << (5 + shift), min(nchunks, (j + 1) << (5 + shift)), 32):
                    if base >= cap:
                        break
                    tk = take[c0 : c0 + 32]
                    lane_first, n = _warp_excl(tk.sum(1))
                    lim = n if mutant == "words_past_cap" else min(n, cap - base)
                    for w0 in range(0, lim, 32 * PACK_ROUNDS):  # word w by lane w % 32
                        for w in range(w0, min(lim, w0 + 32 * PACK_ROUNDS)):
                            ln = 0
                            for step in (16, 8, 4, 2, 1):
                                if lane_first[ln + step] <= w:
                                    ln += step
                            k, col = 0, w - lane_first[ln]
                            for y in range(3):
                                if k == y and col >= tk[ln, y]:
                                    col, k = col - tk[ln, y], k + 1
                            e = 4 * (c0 + ln) - nk_mis + k
                            store(base + w, ((int(vals[e, col]) << 16) | int(idx[e, col])) & 0xFFFFFFFF)
                    base += n
    out[writes > 1] = -9
    return out.astype(np.uint32).view(np.int32)


def _plain_pack(vals, idx, n_keep, kk, cap):
    return tm._pack_hits(*[torch.from_numpy(a) for a in (vals, idx, n_keep)], kk, cap).numpy()


@pytest.mark.parametrize("name", SCORE_CASES)
def test_threshold_topk_emulation_equals_plain(name):
    s, cut, kk, d = _scores_case(name, seed=1)
    got = emu_threshold_topk(s, cut, kk, d)
    for g, w_ in zip(got, _plain_topk(s, cut, kk, d)):
        np.testing.assert_array_equal(g, w_)


def test_threshold_topk_emulation_at_every_digit_count():
    """Scores of 1-4 significant bytes (one select digit and one sort pass
    each), ties at the window's edge in each, d past one 512-doc pass of
    the unrolled loads, and kk = 0."""
    rng = np.random.default_rng(5)
    d = 1100
    for top in (200, 60_000, 9_000_000, 2**31 - 1):
        vals = rng.integers(0, top, 12)
        s = vals[rng.integers(0, 12, (6, d))].astype(np.int32)
        cut = np.array([0, 0, int(np.median(vals)), top // 3, NO_KMERS, 1], np.int32)
        for kk in (0, 1, 40, 300):
            got = emu_threshold_topk(s, cut, kk, d)
            for g, w_ in zip(got, _plain_topk(s, cut, kk, d)):
                np.testing.assert_array_equal(g, w_)


def test_hash_rows_emulation_equals_plain():
    """B5a's 64-bit arithmetic against _hash_rows_ref, hashes >= 2**63 and
    the padding past nk included, H = 1 and 3."""
    for h, s in ((1, 2_000_000), (3, 997), (1, 2**31 - 1)):
        _, hi, lo, nk, _ = _hash_inputs(11 + h, q=30, h=h)
        hi64, lo64 = hi.astype(np.int64), lo.astype(np.int64)
        want = tm._hash_rows(_t(hi64), _t(lo64), _t(nk), s, s).numpy()
        np.testing.assert_array_equal(emu_hash_rows(hi64, lo64, nk, s, s), want)


def _pack_case(seed, q, kk, share_empty):
    rng = np.random.default_rng(seed)
    n_keep = rng.integers(0, 2 * kk, q).astype(np.int32)
    n_keep[rng.random(q) < share_empty] = 0
    vals = rng.integers(0, 513, (q, kk)).astype(np.int32)
    idx = rng.integers(0, 65536, (q, kk)).astype(np.int32)
    return vals, idx, n_keep


@pytest.mark.parametrize("q,kk,share_empty,cap", [
    (1, 8, 0.0, 3), (255, 16, 0.5, 4000), (257, 16, 0.5, 4000), (700, 32, 0.9, 2500),
    (700, 32, 0.0, 100), (513, 4, 0.2, 0), (0, 8, 0.0, 5), (1000, 160, 0.95, 10**5),
])
def test_pack_hits_emulation_equals_plain(q, kk, share_empty, cap):
    """One tile and ragged ones, the cap inside a tile's run, cap 0, Q = 0
    and a cap past every take: every word equal."""
    vals, idx, n_keep = _pack_case(q + kk, q, kk, share_empty)
    want = _plain_pack(vals, idx, n_keep, kk, cap)
    np.testing.assert_array_equal(emu_pack_hits(vals, idx, n_keep, kk, cap), want)


def _pack_edge(name):
    """(vals, idx, n_keep, kk, cap, emulation options) of one named B5c
    edge: used_mod{r}_out{m} (min(total, cap) = total at r mod 4, the
    buffer's first word at word m of its granule), cap_mod{r}_{below,above}
    (cap at r mod 4, below or above the total), nk_mis{m} (n_keep from
    word m of its granule), more tiles than one pass of the grid's warps,
    tiles of 256 chunks, the cap inside a pass's first round and in a
    later batch of rounds, and phase 4's first call at its cap and at the
    hint cap."""
    rng = np.random.default_rng(sum(map(ord, name)))
    opts, kk = {}, 16
    if name.startswith("used_mod"):
        r, m = int(name[8]), int(name[-1])
        vals, idx, n_keep = _pack_case(r + 4 * m, 300, kk, 0.6)
        take = np.minimum(n_keep, kk)
        t0 = int(take[0]) + (r - int(take.sum())) % 4
        n_keep[0] = t0 if t0 <= kk else t0 - 4
        cap, opts = 10**4, {"out_mis": m}
    elif name.startswith("cap_mod"):
        vals, idx, n_keep = _pack_case(7, 300, kk, 0.6)
        cap = (4000 if name.endswith("below") else 148) + int(name[7])
    elif name.startswith("nk_mis"):
        vals, idx, n_keep = _pack_case(8, 301, kk, 0.5)
        cap, opts = 3001, {"nk_mis": int(name[-1]), "out_mis": 2}
    elif name == "tiles_past_one_pass":  # 157 tiles, 8 blocks' 64 warps: 3 a warp
        vals, idx, n_keep = _pack_case(9, 20000, 8, 0.7)
        kk, cap, opts = 8, 30001, {"max_blocks": 8}
    elif name == "tiles_of_256_chunks":  # shift 3: 5 tiles of 8 passes each
        vals, idx, n_keep = _pack_case(10, 5000, 8, 0.7)
        kk, cap, opts = 8, 6001, {"max_tiles": 8, "nk_mis": 3}
    elif name == "cap_in_round":  # 2 words a query: the cap splits a query's run
        vals, idx, n_keep = _pack_case(11, 300, kk, 0.0)
        n_keep[:], cap = 2, 301
    elif name == "cap_past_rounds":  # 100 words a query: 50 batches of rounds a pass
        kk = 128
        vals, idx, n_keep = _pack_case(12, 300, kk, 0.0)
        n_keep[:], cap = 100, 12345
    elif name.startswith("phase4"):  # mostly 0 or 1 hit, a few long runs
        kk = 160
        vals, idx, _ = _pack_case(13, 9216, kk, 0.0)
        n_keep = rng.choice([0, 1, 2, 5, 300], 9216, p=[0.8, 0.17, 0.02, 0.008, 0.002]).astype(np.int32)
        total = int(np.minimum(n_keep, kk).sum())
        cap = 968_240 if name.endswith("first_call") else 1 << max(12, (4 * total + 2048).bit_length())
    else:
        raise KeyError(name)
    return vals, idx, n_keep, kk, cap, opts


PACK_EDGES = [
    *(f"used_mod{r}_out{m}" for r in range(4) for m in range(4)),
    *(f"cap_mod{r}_{w}" for r in range(4) for w in ("below", "above")),
    *(f"nk_mis{m}" for m in (1, 2, 3)),
    "tiles_past_one_pass", "tiles_of_256_chunks", "cap_in_round", "cap_past_rounds",
    "phase4_first_call", "phase4_hint_cap",
]


@pytest.mark.parametrize("name", PACK_EDGES)
def test_pack_hits_emulation_at_edges(name):
    """The fill's head, body and tail at every alignment of min(total,
    cap), of cap and of the buffer, n_keep's granules at every offset, the
    grid's tile loop, tiles of several passes, the cap inside a round and
    past several batches of rounds, phase 4's shapes: every word equal,
    each written once."""
    vals, idx, n_keep, kk, cap, opts = _pack_edge(name)
    want = _plain_pack(vals, idx, n_keep, kk, cap)
    np.testing.assert_array_equal(emu_pack_hits(vals, idx, n_keep, kk, cap, **opts), want)
    total, q = int(want[-1]), len(n_keep)
    if name.startswith("used_mod"):
        assert total % 4 == int(name[8]) and total < cap
    elif name.startswith("cap_mod"):
        assert (total > cap) == name.endswith("above")
    elif name.startswith("tiles"):
        _, shift, nt, grid = pack_geometry(q, cap, opts.get("nk_mis", 0), **{
            k: v for k, v in opts.items() if k.startswith("max")})
        assert (nt > grid * PACK_WARPS) if name == "tiles_past_one_pass" else (shift == 3 and nt == 5)
    elif name in ("cap_in_round", "cap_past_rounds"):
        assert total > cap
    elif name == "phase4_hint_cap":
        assert total < cap < 968_240


MUTANTS = [
    ("hash_rows", "signed_hash"),
    ("threshold_topk", "tie_later_doc"),
    ("threshold_topk", "digit_off_by_one"),
    ("threshold_topk", "one_more_tie"),
    ("pack_hits", "prefix_counts_own_first"),
    ("pack_hits", "body_from_aligned_below"),
    ("pack_hits", "words_past_cap"),
]
#: the edge each B5c mutant is held on (None: the 700-query case)
PACK_MUTANT_EDGE = {"prefix_counts_own_first": None, "body_from_aligned_below": "used_mod1_out0",
                    "words_past_cap": "cap_in_round"}


@pytest.mark.parametrize("kernel,mutant", MUTANTS)
def test_emulation_mutants_are_caught(kernel, mutant):
    """Each mutant of an emulation's rule differs from the plain version
    on the inputs the tests above use: the comparison sees the order of
    ties, the select's digits, the tie count at t*, the tile prefix, a
    fill body that starts below min(total, cap), a pass's words past the
    cap, and the unsigned hash."""
    if kernel == "hash_rows":
        _, hi, lo, nk, _ = _hash_inputs(12, q=30)
        hi64, lo64 = hi.astype(np.int64), lo.astype(np.int64)
        want = tm._hash_rows(_t(hi64), _t(lo64), _t(nk), 997, 997).numpy()
        assert not np.array_equal(emu_hash_rows(hi64, lo64, nk, 997, 997, mutant), want)
    elif kernel == "threshold_topk":
        s, cut, kk, d = _scores_case("dense_ties", seed=1)
        got = emu_threshold_topk(s, cut, kk, d, mutant)
        want = _plain_topk(s, cut, kk, d)
        assert not all(np.array_equal(g, w_) for g, w_ in zip(got, want))
    else:
        edge = PACK_MUTANT_EDGE[mutant]
        vals, idx, n_keep, kk, cap, opts = (_pack_case(3, 700, 32, 0.5) + (32, 5000, {}) if edge is None
                                            else _pack_edge(edge))
        want = _plain_pack(vals, idx, n_keep, kk, cap)
        assert not np.array_equal(emu_pack_hits(vals, idx, n_keep, kk, cap, mutant=mutant, **opts), want)


# --- dispatch -------------------------------------------------------------------


def test_cpu_tensors_launch_no_b5_kernel():
    """On CPU tensors _hash_topk_flat takes the plain versions: every B5
    counter stays 0; the CUDA wrappers refuse CPU tensors without
    counting."""
    tm.reset_launch_counts()
    words, hi, lo, nk, cut = _hash_inputs(2)
    tm._hash_topk_flat(_t(words.view(np.int32)), _t(hi.astype(np.int64)), _t(lo.astype(np.int64)),
                       _t(nk), _t(cut), s=997, pad_row=997, kk=64, d=96, cap=500)
    i64 = torch.zeros((2, 4, 1), dtype=torch.int64)
    i32 = torch.zeros((2, 8), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tm.hash_rows_cuda(i64, i64, n, 997, 997)
    with pytest.raises(ValueError, match="CUDA"):
        tm.topk_scores_cuda(i32, n, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tm.pack_hits_cuda(i32, i32, n, 8, 10)
    assert tm.launch_counts() == {"hash_rows": 0, "threshold_topk": 0, "pack_hits": 0, "merge_topk": 0}
