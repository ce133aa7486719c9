"""The port's Matcher (phylign_tpu_torch.models.matcher) against the JAX
package's on the same inputs: the hash -> row mapping (hashes >= 2**63
included), the integer cut, the device hash path with its compacted hit
buffer (cap overflow, tie overflow past the top-k window), and the hit
lists of Matcher / ChunkedMatcher. The JAX state is carried across with
phylign_tpu_torch.convert.

``torch.topk`` puts ties in no promised order, so hit lists are compared
as sorted lists / sets; n_keep and totals are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.io import cobs as iocobs
from phylign_tpu.kmer import cobs_kmer_hashes_batch, encode_seq, rows_from_hashes
from phylign_tpu.models import matcher as jm
from phylign_tpu_torch.convert import matcher_from_jax, query_hashes_from_jax
from phylign_tpu_torch.io import cobs as t_iocobs
from phylign_tpu_torch.models import matcher as tm

CPU = torch.device("cpu")


def _ascii(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))


def canon(hits):
    return [sorted(h, key=lambda t: (-t[1], t[0])) for h in hits]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """70 docs (3 words), reads planted into docs (shared blocks -> ties)
    plus random misses, and duplicate reads. The index file is written
    once; the JAX package and the port each read it into their own
    DeviceIndex (returned as ``didx`` and ``tdidx``)."""
    rng = np.random.default_rng(21)
    docs = []
    shared = _ascii(rng, 400)
    for d in range(70):
        g = _ascii(rng, 3000)
        if d % 7 == 0:
            g = g[:1000] + shared + g[1000:]
        docs.append((f"{d:04d}_doc{d:03d}", [g]))
    path = tmp_path_factory.mktemp("torch_matcher") / "b.cobs_classic.xz"
    iocobs.write_classic_index(path, iocobs.build_classic_index(docs, term_size=31, fpr=0.05))
    didx = iocobs.to_device_index(iocobs.read_classic_index(path))
    tdidx = t_iocobs.to_device_index(t_iocobs.read_classic_index(path))
    reads = []
    for i in range(40):
        if i % 2:
            reads.append(_ascii(rng, 150))
        else:
            g = docs[i % len(docs)][1][0]
            off = int(rng.integers(0, len(g) - 150))
            reads.append(g[off : off + 150])
    reads += [shared[:150], shared[100:250], reads[0], b"ACGT" * 5]
    raw = cobs_kmer_hashes_batch([encode_seq(r) for r in reads], 31, 1)
    return didx, tdidx, docs, reads, raw


class TestRowsFromHashes:
    def test_high_hashes_exact(self):
        rng = np.random.default_rng(0)
        raw = np.concatenate(
            [
                rng.integers(0, 2**64, 500, dtype=np.uint64),
                np.array(
                    [0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1,
                     2**64 - 2, 2**64 - 1],
                    np.uint64,
                ),
            ]
        )
        assert (raw >= np.uint64(2**63)).sum() > 200
        hi = torch.from_numpy((raw >> np.uint64(32)).astype(np.int64))
        lo = torch.from_numpy((raw & np.uint64(0xFFFFFFFF)).astype(np.int64))
        for s in (1, 7, 1000, 65537, 2_000_000, 39_000_000, 2**31 - 1):
            want = rows_from_hashes(raw[:, None], s)[:, 0]
            got = tm._rows_from_hashes(hi, lo, s).numpy()
            np.testing.assert_array_equal(got, want)
            jax_rows = np.asarray(
                jm._rows_from_hashes_dev(
                    jnp.asarray(hi.numpy().astype(np.uint32)),
                    jnp.asarray(lo.numpy().astype(np.uint32)),
                    s,
                )
            )
            np.testing.assert_array_equal(got, jax_rows.astype(np.int64))

    def test_signed_reinterpretation_would_be_wrong(self):
        """The hazard the split form avoids: 2**64-1 read as int64 is -1."""
        raw = np.array([2**64 - 1], np.uint64)
        s = 1000
        wrong = int(raw.view(np.int64)[0]) % s
        assert wrong != int(rows_from_hashes(raw[:, None], s)[0, 0])


class TestIntCut:
    @pytest.mark.parametrize("thr", [0.0, 0.3, 0.5, 0.7, 0.8, 1.0])
    def test_matches_jax(self, thr):
        n = np.arange(0, 600, dtype=np.int32)
        np.testing.assert_array_equal(tm._int_cut(thr, n), jm._int_cut(thr, n))

    def test_exact_threshold_boundary(self):
        """score == threshold * n qualifies, one below does not; no k-mers
        never qualifies."""
        cut = tm._int_cut(0.7, np.array([120, 10, 0], np.int32))
        assert cut[0] == 84 and 84 >= 0.7 * 120 and not 83 >= 0.7 * 120
        assert cut[1] == 7
        assert cut[2] == 1 << 30


def _hash_inputs(seed, q=40, k=64, h=1, s=997, wp=3, thr=0.45):
    rng = np.random.default_rng(seed)
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    raw = rng.integers(0, 2**64, (q, k, h), dtype=np.uint64)
    raw[:5] |= np.uint64(2**63)
    hi = (raw >> np.uint64(32)).astype(np.uint32)
    lo = (raw & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nk = rng.integers(40, k + 1, q).astype(np.int32)
    nk[-3:] = 0
    cut = jm._int_cut(thr, nk)
    return words, hi, lo, nk, cut


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat_hits(out, q, cap, kk):
    n_keep = out[cap : cap + q].astype(np.int64)
    take = np.minimum(n_keep, kk)
    offs = np.cumsum(take) - take
    sets = []
    for i in range(q):
        if offs[i] + take[i] > cap:
            sets.append(None)  # straddles / past the cap: not comparable
        else:
            seg = out[offs[i] : offs[i] + take[i]]
            sets.append(sorted((int(v & 0xFFFF), int(v >> 16)) for v in seg))
    return n_keep, int(out[-1]), sets


class TestHashTopK:
    @pytest.mark.parametrize("h", [1, 2])
    @pytest.mark.parametrize("cap_frac", [1.0, 0.3])
    def test_flat_matches_jax(self, h, cap_frac):
        """Same words, hashes and cuts through both packages' flat hash
        path. kk=64 < 96 docs, so well-hit queries overflow the window;
        cap_frac < 1 overflows the compacted buffer (total > cap)."""
        words, hi, lo, nk, cut = _hash_inputs(3 + h, h=h, thr=0.45 / h)
        s, kk, d, q = 997, 64, 96, hi.shape[0]
        cap = max(1, int(cap_frac * q * kk))
        want = np.asarray(
            jm._hash_topk_flat(
                jnp.asarray(words), jnp.asarray(hi), jnp.asarray(lo),
                jnp.asarray(nk), jnp.asarray(cut),
                s=s, pad_row=s, kk=kk, d=d, cap=cap,
            )
        )
        got = tm._hash_topk_flat(
            _t(words.view(np.int32)), _t(hi.astype(np.int64)),
            _t(lo.astype(np.int64)), _t(nk), _t(cut),
            s=s, pad_row=s, kk=kk, d=d, cap=cap,
        ).numpy().view(np.uint32)
        assert got.shape == want.shape
        nk_w, tot_w, sets_w = _flat_hits(want, q, cap, kk)
        nk_g, tot_g, sets_g = _flat_hits(got, q, cap, kk)
        np.testing.assert_array_equal(nk_g, nk_w)
        assert tot_g == tot_w
        assert (nk_w > kk).any() and (nk_w[:-3] <= kk).any()
        if cap_frac < 1:
            assert tot_w > cap
        for i in range(q):
            if nk_w[i] <= kk and sets_w[i] is not None:
                assert sets_g[i] == sets_w[i], i

    def test_dense_window_matches_jax(self):
        """_hash_topk: the window holds the same score multiset (which of
        several tied docs fills the last slots may differ); for queries
        whose qualifying set fits, the same (doc, score) set."""
        words, hi, lo, nk, cut = _hash_inputs(9, thr=0.4)
        s, kk, d = 997, 64, 96
        jv, ji, jn = (
            np.asarray(a)
            for a in jm._hash_topk(
                jnp.asarray(words), jnp.asarray(hi), jnp.asarray(lo),
                jnp.asarray(nk), jnp.asarray(cut), s=s, pad_row=s, kk=kk, d=d,
            )
        )
        tv, ti, tn = (
            a.numpy()
            for a in tm._hash_topk(
                _t(words.view(np.int32)), _t(hi.astype(np.int64)),
                _t(lo.astype(np.int64)), _t(nk), _t(cut),
                s=s, pad_row=s, kk=kk, d=d,
            )
        )
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(np.sort(tv, 1), np.sort(jv.astype(np.int32), 1))
        for i in range(len(nk)):
            m = min(int(jn[i]), kk)
            if jn[i] <= kk:
                assert sorted(zip(ti[i, :m], tv[i, :m])) == sorted(
                    zip(ji[i, :m].astype(np.int32), jv[i, :m].astype(np.int32))
                )


class TestMatcherAgainstJax:
    @pytest.mark.parametrize("thr,topn", [(0.7, 1), (0.3, 10), (0.0, 5)])
    def test_score_hits_hashes_and_raw(self, fixture, thr, topn):
        """thr=0.0: every doc qualifies for every query -> n_keep = 70 >
        kk, the dense re-score of every query."""
        didx, tdidx, _, _, raw = fixture
        jmat = jm.Matcher.from_device_index(didx)
        tmat = matcher_from_jax(jmat, CPU)
        jdq = jm.DeviceQueryHashes.build(raw)
        tdq = query_hashes_from_jax(jdq, CPU)
        jh, jn = jmat.score_hits_hashes(jdq, thr, topn)
        th, tn = tmat.score_hits_hashes(tdq, thr, topn)
        np.testing.assert_array_equal(tn, jn)
        assert canon(th) == canon(jh)
        jh2, jn2 = jmat.score_hits_raw(raw, thr, topn)
        th2, tn2 = tmat.score_hits_raw(raw, thr, topn)
        np.testing.assert_array_equal(tn2, jn2)
        assert canon(th2) == canon(jh2) == canon(jh)

    def test_from_device_index_and_async_halves(self, fixture):
        """The port's own upload path (not via convert) and the
        begin/end split with a small cap (overflow -> dense fetch)."""
        didx, tdidx, _, _, raw = fixture
        tmat = tm.Matcher.from_device_index(tdidx, CPU)
        assert tmat.words.shape == (tdidx.signature_size + 1, tdidx.num_words)
        assert tmat.words.numel() * 4 == tm.device_index_bytes(tdidx)
        assert int(tmat.words[-1].abs().sum()) == 0
        jmat = jm.Matcher.from_device_index(didx)
        tdq = tm.DeviceQueryHashes.build(raw, CPU)
        want_h, want_n = jmat.score_hits_raw(raw, 0.3, 3)
        for cap in (None, 1):
            ctx = tmat.score_hits_hashes_begin(tdq, 0.3, 3, cap=cap)
            assert ctx is not None
            h, n = tmat.score_hits_hashes_end(ctx)
            np.testing.assert_array_equal(n, want_n)
            assert canon(h) == canon(want_h)

    def test_dedup_segmented_and_multi_hash(self, fixture):
        didx, tdidx, docs, reads, raw = fixture
        jmat = jm.Matcher.from_device_index(didx)
        tmat = matcher_from_jax(jmat, CPU)
        # dedup: the hash path declines, the raw path scores via dedup_rows
        jmat.dedup = tmat.dedup = True
        tdq = tm.DeviceQueryHashes.build(raw, CPU)
        assert tmat.score_hits_hashes_begin(tdq, 0.5, 5) is None
        th, tn = tmat.score_hits_hashes(tdq, 0.5, 5)
        jh, jn = jmat.score_hits_raw(raw, 0.5, 5)
        np.testing.assert_array_equal(tn, jn)
        assert canon(th) == canon(jh)
        # segmented (> k_max k-mers): the full-matrix path
        th, tn = tmat.score_hits_raw(raw, 0.5, 5, k_max=64)
        jh, jn = jmat.score_hits_raw(raw, 0.5, 5, k_max=64)
        np.testing.assert_array_equal(tn, jn)
        assert canon(th) == canon(jh)
        # a 3-hash index (kernel B1's domain on CUDA)
        c3 = iocobs.build_classic_index(docs[:40], term_size=31, num_hashes=3, fpr=0.05)
        idx3 = iocobs.to_device_index(c3)
        tidx3 = t_iocobs.to_device_index(
            t_iocobs.ClassicIndex(**{f: getattr(c3, f) for f in (
                "term_size", "canonicalize", "doc_names", "num_hashes",
                "signature_size", "rows")})
        )
        raw3 = cobs_kmer_hashes_batch([encode_seq(r) for r in reads], 31, 3)
        j3 = jm.Matcher.from_device_index(idx3)
        t3 = tm.Matcher.from_device_index(tidx3, CPU)
        jh, jn = j3.score_hits_hashes(jm.DeviceQueryHashes.build(raw3), 0.7, 2)
        th, tn = t3.score_hits_hashes(tm.DeviceQueryHashes.build(raw3, CPU), 0.7, 2)
        np.testing.assert_array_equal(tn, jn)
        assert canon(th) == canon(jh)
        s_t, k_t, n_t = t3.score(reads, 0.7)
        s_j, k_j, n_j = j3.score(reads, 0.7)
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(k_t, k_j)

    @pytest.mark.parametrize("row_chunk_div", [1, 5])
    def test_chunked_matcher(self, fixture, row_chunk_div):
        didx, tdidx, _, _, raw = fixture
        kw = dict(
            term_size=tdidx.term_size, num_hashes=1,
            signature_size=tdidx.signature_size, doc_names=tdidx.doc_names,
            words_host=np.asarray(tdidx.words),
            row_chunk=-(-tdidx.signature_size // row_chunk_div),
        )
        jc = jm.ChunkedMatcher(**kw)
        tc = tm.ChunkedMatcher(**kw, device=CPU)
        for thr, topn in ((0.7, 1), (0.0, 3)):
            jh, jn = jc.score_hits_raw(raw, thr, topn)
            th, tn = tc.score_hits_raw(raw, thr, topn)
            np.testing.assert_array_equal(tn, jn)
            assert canon(th) == canon(jh)
        with pytest.raises(ValueError, match="num_hashes"):
            tm.ChunkedMatcher(**{**kw, "num_hashes": 2}, device=CPU)

    def test_convert_round_trip(self, fixture):
        didx, tdidx, _, _, raw = fixture
        jmat = jm.Matcher.from_device_index(didx, use_pallas=True)  # 128-word lanes
        tmat = matcher_from_jax(jmat, CPU)
        np.testing.assert_array_equal(
            tmat.words.numpy().view(np.uint32), np.asarray(jmat.words)
        )
        jdq = jm.DeviceQueryHashes.build(raw)
        tdq = query_hashes_from_jax(jdq, CPU)
        np.testing.assert_array_equal(tdq.hi.numpy(), np.asarray(jdq.hi).astype(np.int64))
        np.testing.assert_array_equal(tdq.lo.numpy(), np.asarray(jdq.lo).astype(np.int64))
        assert tdq.q_real == jdq.q_real == len(raw)
        # scoring the lane-padded words gives the exact-width result
        th, tn = tmat.score_hits_hashes(tdq, 0.5, 4)
        jh, jn = jm.Matcher.from_device_index(didx).score_hits_raw(raw, 0.5, 4)
        np.testing.assert_array_equal(tn, jn)
        assert canon(th) == canon(jh)


class TestMatchStep:
    """match_step (the JAX package's flagship forward step) against JAX's
    on the CPU, XLA path and Pallas interpret mode. A staircase matrix
    (doc d's bit set in row r iff r < d) and slots holding rows 0..K-1 give
    each query every score from 0 to K, so each cut below lands on a score; n_kmers and thresholds sit
    on cuts where the float32 test and the pipeline's float64 _int_cut
    disagree by one (0.3 x 50: 15 vs 16; 0.55 x 100: 55 vs 56), plus
    n_kmers = 0."""

    S, WP, K = 128, 3, 64
    NK = np.array([50, 0, 100, 25, 45, 90, 120, 64], np.int32)

    def _inputs(self, h: int, lanes: int = 1, k: int = K):
        from phylign_tpu.ops.match import pad_device_words

        r = np.arange(self.S)[:, None]
        d = np.arange(32 * self.WP)[None, :]
        bits = (r < d).astype(np.uint64).reshape(self.S, self.WP, 32)
        words = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        words = pad_device_words(words, lanes)
        rng = np.random.default_rng(h)
        rows = np.stack([rng.permutation(k) for _ in self.NK]).astype(np.int32)
        rows = np.stack([rows + j for j in range(h)], axis=-1).clip(0, self.S - 1)
        rows[1] = self.S  # the query without k-mers: every slot padding
        return words, rows

    @staticmethod
    def _f32_keep(scores, nk, thr):
        cut = np.float32(thr) * nk.astype(np.float32)
        return (scores.astype(np.float32) >= cut[:, None]) & (nk[:, None] > 0)

    @pytest.mark.parametrize("h", [1, 3])
    @pytest.mark.parametrize("thr", [0.3, 0.55, 0.6, 0.7])
    def test_equals_jax_on_cut_boundaries(self, h, thr):
        words, rows = self._inputs(h)
        js, jk = jm.match_step(jnp.asarray(words), jnp.asarray(rows), jnp.asarray(self.NK), thr,
                               use_pallas=False)
        ts, tk = tm.match_step(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows),
                               torch.from_numpy(self.NK), thr)
        assert ts.dtype == torch.int32 and tk.dtype == torch.bool
        assert ts.shape == tk.shape == (len(self.NK), 32 * words.shape[1])
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tk.numpy(), self._f32_keep(ts.numpy(), self.NK, thr))
        assert not tk[1].any() and ts[1].sum() == 0
        if thr in (0.3, 0.55):  # the f64 integer cut gives another mask here
            f64 = ts.numpy() >= tm._int_cut(thr, self.NK)[:, None]
            assert (f64 != tk.numpy()).any()

    @pytest.mark.parametrize("h", [1, 3])
    def test_scores_equal_pallas_interpret(self, h):
        from phylign_tpu.ops import match as jopm

        words, rows = self._inputs(h, lanes=jopm.LANE_WORDS, k=32)  # interpret mode is slow
        fn = jopm.match_scores_pallas_v2 if h == 1 else jopm.match_scores_pallas
        want = np.asarray(fn(jnp.asarray(words), jnp.asarray(rows if h > 1 else rows[..., 0]),
                             interpret=True))
        ts, _ = tm.match_step(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows),
                              torch.from_numpy(self.NK), 0.55)
        np.testing.assert_array_equal(ts.numpy(), want)


def test_rows_for_queries_and_nbytes_equal_jax(fixture):
    didx, tdidx, _docs, reads, raw = fixture
    jmatch = jm.Matcher.from_device_index(didx, use_pallas=False)
    tmatch = tm.Matcher.from_device_index(tdidx, CPU)
    assert tmatch.pad_row == jmatch.pad_row
    for k_max in (120, 128):
        want = jmatch.rows_for_queries(reads, k_max)
        got = tmatch.rows_for_queries(reads, k_max)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="k_max"):
        tmatch.rows_for_queries(reads, 100)
    dq = tm.DeviceQueryHashes.build(raw, CPU)
    assert dq.nbytes == 2 * 8 * dq.hi.numel() == jm.DeviceQueryHashes.build(raw).nbytes * 2
