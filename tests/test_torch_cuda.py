"""The hand-written CUDA kernels (B1/B2/B5 of the match stage, B3/B4/B6 of
the align stage) and the port's pipeline on an NVIDIA GPU. Every test here needs the card: it is marked ``cuda`` and skips
without one. On a machine with the card (which has no jax, so the repo's
conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import gzip
import shutil

import numpy as np
import pytest
import torch

from phylign_tpu_torch import testing as fixture_mod
from phylign_tpu_torch.align import fused as fz
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.io import cobs as iocobs
from phylign_tpu_torch.io.fastx import read_fastx_file
from phylign_tpu_torch.models import matcher as tm
from phylign_tpu_torch.ops import chain as opc
from phylign_tpu_torch.ops import extend as ope
from phylign_tpu_torch.ops import match as opm
from phylign_tpu_torch.pipeline.stages import Pipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = [
    # (S, Wp, Q, K, H): many queries per block (Wp = 1, 2, 3, 5), words
    # looped over (Wp = 300), the main path's width (Wp = 68), K up to the
    # B2 limit; K % 32 != 0 only on B1
    (100, 1, 5, 32, 1),
    (100, 3, 37, 64, 1),
    (1000, 68, 50, 128, 1),
    (1000, 68, 50, 96, 3),
    (500, 300, 9, 64, 2),
    (500, 300, 9, 512, 1),
    (50, 2, 700, 512, 1),
    (50, 5, 11, 64, 3),
    (2000, 68, 13, 4064, 1),
    # K % 8 != 0; H = 2 with K = 33 (four groups plus a remainder)
    (1000, 68, 50, 120, 1),
    (1000, 68, 97, 33, 2),
    # Q below the SM count
    (3000, 68, 131, 128, 3),
    # Q = 2049: more blocks than the card holds at once
    (3000, 68, 2049, 128, 1),
    # Wp % 4 != 0 at a real width; H = 5 (the runtime-H instance)
    (3000, 70, 1000, 100, 2),
    (200, 8, 40, 300, 5),
    # 16 planes (K >= 4096), indices read from device memory (K*H*4 > 48 KB)
    (100, 4, 6, 5000, 3),
]


@pytest.mark.parametrize("s,wp,q,k,h", SHAPES)
def test_kernels_equal_plain_version(cuda, s, wp, q, k, h):
    g = torch.Generator(device=cuda).manual_seed(s + wp + q + k + h)
    words = torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=g)
    words[s] = 0
    rows = torch.randint(0, s + 1, (q, k, h), dtype=torch.int32, device=cuda, generator=g)
    rows[0] = s
    want = opm.match_scores_ref(words, rows)
    before = opm.launch_counts()
    assert torch.equal(opm.match_scores_b1(words, rows), want)
    if h == 1 and k % 32 == 0:
        assert torch.equal(opm.match_scores_b2(words, rows), want)
    assert torch.equal(opm.match_scores(words, rows), want)
    torch.cuda.synchronize()
    after = opm.launch_counts()
    picked = opm.select_kernel(k, h)
    for name in after:
        launched = (name == "match_popcount_b1") + (
            name == "match_popcount_b2" and h == 1 and k % 32 == 0
        ) + (name == picked)
        assert after[name] - before[name] == launched


@pytest.mark.parametrize(
    "threads,stage_bytes,out_bytes,s,wp,q,k,h",
    [
        # words looped over, counts stored straight to device memory
        (128, 48 * 1024, 1024, 500, 300, 40, 37, 3),
        # indices read from device memory, 3 queries a block
        (256, 256, 48 * 1024, 3000, 68, 300, 128, 1),
        # 42 queries a block, the last one short
        (128, 48 * 1024, 48 * 1024, 3000, 3, 1000, 64, 1),
    ],
)
def test_geometries(cuda, monkeypatch, threads, stage_bytes, out_bytes, s, wp, q, k, h):
    """Other block shapes than the default: words looped over, indices not
    staged, counts stored straight."""
    monkeypatch.setattr(opm, "BLOCK_THREADS", threads)
    monkeypatch.setattr(opm, "STAGE_BYTES", stage_bytes)
    monkeypatch.setattr(opm, "OUT_BYTES", out_bytes)
    g = torch.Generator(device=cuda).manual_seed(q + k)
    words = torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=g)
    words[s] = 0
    rows = torch.randint(0, s + 1, (q, k, h), dtype=torch.int32, device=cuda, generator=g)
    assert torch.equal(opm.match_scores(words, rows), opm.match_scores_ref(words, rows))


def test_misaligned_table_and_clamped_rows(cuda):
    """A word table that does not start on 16 bytes (a view one 12-byte
    row in) is read in place; row indices outside [0, S] read the clamped
    rows, as XLA's gather does."""
    g = torch.Generator(device=cuda).manual_seed(9)
    big = torch.randint(-(2**31), 2**31, (402, 3), dtype=torch.int32, device=cuda, generator=g)
    big[-1] = 0
    words = big[1:]
    assert words.data_ptr() % 16
    rows = torch.randint(0, 401, (20, 64, 1), dtype=torch.int32, device=cuda, generator=g)
    want = opm.match_scores_ref(words, rows)
    assert torch.equal(opm.match_scores_b2(words, rows), want)
    bad = rows.clone()
    bad[0, :5] = 10**6
    bad[1, :5] = -7
    clamped = rows.clone()
    clamped[0, :5] = 400
    clamped[1, :5] = 0
    assert torch.equal(opm.match_scores_b1(words, bad), opm.match_scores_ref(words, clamped))


def _hash_case(seed, q=40, k=64, h=1, s=997, wp=3, thr=0.45):
    """Words, hash halves, k-mer counts and cuts (numpy) of a small batch:
    hashes >= 2**63 in the first rows, the last three queries empty."""
    rng = np.random.default_rng(seed)
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    raw = rng.integers(0, 2**64, (q, k, h), dtype=np.uint64)
    raw[:5] |= np.uint64(2**63)
    nk = rng.integers(40, k + 1, q).astype(np.int32)
    nk[-3:] = 0
    return [
        words.view(np.int32), (raw >> np.uint64(32)).astype(np.int64),
        (raw & np.uint64(0xFFFFFFFF)).astype(np.int64), nk, tm._int_cut(thr, nk),
    ]


@pytest.mark.parametrize("h,kk,cap_frac", [(1, 96, 1.0), (1, 64, 1.0), (1, 64, 0.3), (3, 64, 1.0)])
def test_hash_topk_flat_equals_cpu(cuda, h, kk, cap_frac):
    """The whole flat buffer of _hash_topk_flat on the card equals the CPU
    run word for word (the window's order is defined), through four
    kernels: B5a, B1/B2, B5b, B5c; with cap_frac 0.3 total > cap, and the
    dense refetch (_hash_topk: B5a, B1/B2, B5b) equals the CPU's too."""
    args = _hash_case(h, h=h, thr=0.45 / h)
    q = args[1].shape[0]
    kw = dict(s=997, pad_row=997, kk=kk, d=96, cap=max(1, int(cap_frac * q * kk)))
    want = tm._hash_topk_flat(*[torch.from_numpy(a) for a in args], **kw)
    dev_args = [torch.from_numpy(a).to(cuda) for a in args]
    tm.reset_launch_counts()
    opm.reset_launch_counts()
    got = tm._hash_topk_flat(*dev_args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert tm.launch_counts() == {"hash_rows": 1, "threshold_topk": 1, "pack_hits": 1, "merge_topk": 0}
    assert sum(opm.launch_counts().values()) == 1
    assert (int(want[-1]) > kw["cap"]) == (cap_frac < 1)
    kw.pop("cap")
    for a, b in zip(tm._hash_topk(*dev_args, **kw), tm._hash_topk(*[torch.from_numpy(a) for a in args], **kw)):
        assert torch.equal(a.cpu(), b)


#: B5b's cases: (Q, W, d, kk, kind): small; phase 4's call (9,216 rows of
#: 2,176 columns, d 2,169, kk 160); threshold 0 (every row overflows kk);
#: ties at the window's edge; kk == d past the shared-memory stash (the
#: device workspace), all qualifying and few; kk past 512 with ties;
#: segment scores past 2**16; kk 0 with d not a multiple of 4
B5B_CASES = [
    (37, 96, 96, 64, "hits"),
    (9216, 2176, 2169, 160, "hits"),
    (2048, 2176, 2169, 160, "zero"),
    (2048, 2176, 2169, 160, "ties"),
    (64, 2176, 2169, 2169, "zero"),
    (64, 2176, 2169, 2169, "hits"),
    (300, 2176, 2169, 600, "ties"),
    (500, 512, 301, 96, "wide"),
    (5, 160, 131, 0, "hits"),
]


def _score_rows(gen, q, w, d, kind, dev):
    """int32 scores [Q, W] and cuts [Q] on the card: phase 4's kind (few
    docs at or above a cut of 84, every 7th query without k-mers), a cut of
    0, scores tied around the cut, or scores up to 2**20 in steps of 1,000;
    columns past d hold a large score that must never count."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    s, cut = ints(0, 40, (q, w)), torch.full((q,), 84, dtype=torch.int32, device=dev)
    if kind == "hits":
        hit = torch.rand((q, w), generator=gen, device=dev) < max(0.002, 4 / w)
        s = torch.where(hit, ints(84, 129, (q, w)), s)
        cut[::7] = 1 << 30
    elif kind == "zero":
        cut.zero_()
    elif kind == "ties":
        s, cut = ints(80, 90, (q, w)), ints(80, 90, (q,))
    else:
        s, cut = ints(0, 1 << 10, (q, w)) * 1000, ints(0, 1 << 20, (q,))
    s[:, d:] = 1 << 29
    return s, cut


@pytest.mark.parametrize("q,w,d,kk,kind", B5B_CASES)
def test_threshold_topk_equals_plain_version(cuda, q, w, d, kk, kind):
    """Kernel B5b against _topk_scores_ref (a stable sort on the card):
    vals, idx and n_keep equal, the order inside the window included."""
    g = torch.Generator(device=cuda).manual_seed(q + w + kk)
    s, cut = _score_rows(g, q, w, d, kind, cuda)
    before = tm.launch_counts()["threshold_topk"]
    got = tm.topk_scores_cuda(s, cut, kk, d)
    torch.cuda.synchronize()
    assert tm.launch_counts()["threshold_topk"] == before + 1
    want = tm._topk_scores_ref(s, cut, kk, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n_keep = want[2]
    if kind in ("zero", "ties") and 0 < kk < d:
        assert (n_keep > kk).any()
    if kind == "hits" and kk:
        assert (n_keep > 0).any() and (n_keep == 0).any()


def test_threshold_topk_refuses_unaligned_scores(cuda):
    """Rows the kernel cannot read in 16-byte loads (a view one column in,
    a row stride not a multiple of 4, too few columns) are refused before
    any launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    s, cut = _score_rows(g, 100, 332, 330, "ties", cuda)
    before = tm.launch_counts()
    for bad, d in ((s[:, 1:], 300), (s[:, :331].contiguous(), 300), (s[:, :330], 329)):
        with pytest.raises(ValueError, match="16-byte"):
            tm._topk_scores(bad, cut, 64, d)
    assert tm.launch_counts() == before


@pytest.mark.parametrize("q,k,h,s", [
    (37, 64, 1, 997), (9216, 128, 1, 2_000_000), (1024, 128, 3, 2_000_000),
    (50, 33, 2, 2**31 - 1), (3, 700, 5, 1000),
])
def test_hash_rows_equals_plain_version(cuda, q, k, h, s):
    """Kernel B5a against _hash_rows_ref: hashes >= 2**63, empty and full
    queries, phase 4's and phase 3's shapes (H = 1 and 3)."""
    rng = np.random.default_rng(q + k + h)
    raw = rng.integers(0, 2**64, (q, k, h), dtype=np.uint64)
    raw[:5] |= np.uint64(2**63)
    hi = torch.from_numpy((raw >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((raw & np.uint64(0xFFFFFFFF)).astype(np.int64))
    nk = torch.from_numpy(rng.integers(0, k + 1, q).astype(np.int32))
    nk[0], nk[-1] = k, 0
    before = tm.launch_counts()["hash_rows"]
    got = tm.hash_rows_cuda(hi.to(cuda), lo.to(cuda), nk.to(cuda), s, s)
    torch.cuda.synchronize()
    assert tm.launch_counts()["hash_rows"] == before + 1
    assert torch.equal(got.cpu(), tm._hash_rows_ref(hi, lo, nk, s, s))


def _pack_inputs(q, kk, share_empty, seed, total_mod=None):
    """(vals, idx, n_keep) int32 of a B5c call; total_mod: n_keep[0] moved
    so that the total take is total_mod mod 4."""
    rng = np.random.default_rng(seed)
    n_keep = rng.integers(0, 2 * kk, q).astype(np.int32)
    n_keep[rng.random(q) < share_empty] = 0
    if total_mod is not None:
        take = np.minimum(n_keep, kk)
        t0 = int(take[0]) + (total_mod - int(take.sum())) % 4
        n_keep[0] = t0 if t0 <= kk else t0 - 4
    vals = rng.integers(0, 513, (q, kk)).astype(np.int32)
    idx = rng.integers(0, 65536, (q, kk)).astype(np.int32)
    return [torch.from_numpy(a) for a in (vals, idx, n_keep)]


#: phase 4's first call's total and the cap the match stage gives every
#: later batch from it (stages.py: 1 << max(12, (4 total + 2048).bit_length()))
HINT_CAP = 1 << max(12, (4 * 2081 + 2048).bit_length())


@pytest.mark.parametrize("q,kk,cap,share_empty,total_mod", [
    (37, 64, 500, 0.5, None), (9216, 160, 9216 * 112, 0.9, None), (9216, 160, 3000, 0.5, None),
    (1, 8, 3, 0.0, None), (0, 8, 5, 0.0, None), (700, 32, 0, 0.3, None), (257, 16, 4000, 0.5, None),
    # min(total, cap) = total at each remainder mod 4; cap at each
    # remainder, below and above the total; phase 4's shape at the hint cap
    *((300, 16, 10**4, 0.6, r) for r in range(4)),
    *((300, 16, c + r, 0.6, None) for r in range(4) for c in (4000, 148)),
    (9216, 160, HINT_CAP, 0.997, None),
])
def test_pack_hits_equals_plain_version(cuda, q, kk, cap, share_empty, total_mod):
    """Kernel B5c against _pack_hits_ref, every word: one tile and 72
    (Q = 9,216), the cap inside a run, cap 0, Q = 0, the fill's head and
    body at every alignment of min(total, cap) and of cap, and the hint
    cap at Q = 9,216."""
    host = _pack_inputs(q, kk, share_empty, q + kk + cap, total_mod)
    before = tm.launch_counts()["pack_hits"]
    got = tm.pack_hits_cuda(*[t.to(cuda) for t in host], kk, cap)
    want = tm._pack_hits_ref(*host, kk, cap)
    assert tm.launch_counts()["pack_hits"] == before + 1
    assert torch.equal(got.cpu(), want)
    total = int(want[-1]) if q else 0
    if total_mod is not None:
        assert total % 4 == total_mod and total < cap
    if cap == HINT_CAP:
        assert 0 < total < cap


@pytest.mark.parametrize("out_at,nk_at", [(1, 0), (2, 3), (3, 1), (5, 2)])
def test_pack_hits_into_a_view_at_any_word_offset(cuda, out_at, nk_at):
    """phylign_pack_hits through _kernels.launch into a view of a
    sentinel-filled buffer at a word offset that is not 16-byte aligned,
    n_keep a view at another offset: the view equals _pack_hits_ref
    (every alignment of the fill's head, body and tail), and every word
    before and after it keeps the sentinel."""
    from phylign_tpu_torch.ops import _kernels

    q, kk = 1000, 32
    for cap in (4001, 1002, 10**4 + 3):
        vals, idx, n_keep = _pack_inputs(q, kk, 0.7, cap + out_at)
        n = cap + q + 1
        buf = torch.full((out_at + n + 9,), -5, dtype=torch.int32, device=cuda)
        nk_buf = torch.full((nk_at + q + 5,), 1 << 20, dtype=torch.int32, device=cuda)
        nk_view = nk_buf[nk_at : nk_at + q]
        nk_view.copy_(n_keep)
        _kernels.launch(tm._launches, "pack_hits", "match_epilogue", "phylign_pack_hits",
                        vals.to(cuda), idx.to(cuda), nk_view, q, kk, cap, buf[out_at : out_at + n])
        got = buf.cpu()
        assert torch.equal(got[out_at : out_at + n], tm._pack_hits_ref(vals, idx, n_keep, kk, cap))
        assert (got[:out_at] == -5).all() and (got[out_at + n :] == -5).all()


def test_matcher_top_k_paths_on_card_equal_cpu(cuda):
    """Every caller of the top-k on the card (the hash path, whole and as
    its begin/end halves, score_hits_unique, the chunked matcher) gives
    the CPU run's hit lists, in the same order, through B5."""
    from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq

    didx, seqs = _planted_index()
    raw = cobs_kmer_hashes_batch([encode_seq(x) for x in seqs], 31, 1)
    tm.reset_launch_counts()
    for thr, topn in ((0.7, 5), (0.0, 3)):
        res = {}
        for dev in ("cpu", cuda):
            m = tm.Matcher.from_device_index(didx, dev)
            dq = tm.DeviceQueryHashes.build(raw, dev)
            ch = tm.ChunkedMatcher.from_device_index(didx, 1, device=dev)
            res[str(dev)] = [
                m.score_hits(seqs, thr, topn), m.score_hits_hashes(dq, thr, topn),
                m.score_hits_hashes_end(m.score_hits_hashes_begin(dq, thr, topn, cap=1)),
                ch.score_hits(seqs, thr, topn),
            ]
        for (h_cpu, n_cpu), (h_dev, n_dev) in zip(res["cpu"], res[str(cuda)]):
            assert h_dev == h_cpu
            np.testing.assert_array_equal(n_dev, n_cpu)
    # every B5 kernel but the mesh's merge
    assert all(v for k, v in tm.launch_counts().items() if k != "merge_topk"), tm.launch_counts()


def test_b5_library_failure_raises_kernel_error(cuda, monkeypatch):
    """A CUDA tensor whose kernel library cannot load raises KernelError:
    no plain version runs, no launch is counted."""
    from phylign_tpu_torch.ops import _kernels

    def broken(name):
        raise _kernels.KernelError(f"cannot load the {name} library: test")

    def plain(*a):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(_kernels, "library", broken)
    for name in ("_hash_rows_ref", "_topk_scores_ref", "_pack_hits_ref"):
        monkeypatch.setattr(tm, name, plain)
    before = tm.launch_counts()
    i64 = torch.zeros((4, 8, 1), dtype=torch.int64, device=cuda)
    i32 = torch.zeros((4, 32), dtype=torch.int32, device=cuda)
    n = torch.ones(4, dtype=torch.int32, device=cuda)
    with pytest.raises(_kernels.KernelError):
        tm._hash_rows(i64, i64, n, 997, 997)
    with pytest.raises(_kernels.KernelError):
        tm._topk_scores(i32, n, 8, 32)
    with pytest.raises(_kernels.KernelError):
        tm._pack_hits(i32, i32, n, 32, 10)
    assert tm.launch_counts() == before


def test_pipeline_on_cuda_equals_cpu(cuda, tmp_path):
    """The fixture (three 1-hash batches + one 3-hash batch) through the
    port's pipeline on the card and on the CPU: identical bytes, and both
    kernels launched on the card."""
    base = tmp_path / "base"
    fixture_mod.make_fixture(base, n_batches=3, seed=42)
    rng = np.random.default_rng(5)
    reads = [r.seq.encode() for p in sorted((base / "input").iterdir()) for r in read_fastx_file(p)]
    docs = [
        (f"{g:04d}_SAMH{g:05d}", [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 2000))
                                  + b"".join(reads[g::9])])
        for g in range(5)
    ]
    idx = iocobs.build_classic_index(docs, term_size=31, num_hashes=3, fpr=0.1)
    iocobs.write_classic_index(base / "cobs" / "synthetic_h3__01.cobs_classic.xz", idx)
    with open(base / "data" / "batches_small.txt", "a") as f:
        f.write("synthetic_h3__01\n")
    outs = {}
    for dev in ("cpu", "cuda"):
        wd = tmp_path / dev
        shutil.copytree(base, wd)
        pl = Pipeline(Config.from_yaml(wd / "config.yaml"), wd, device=dev)
        stem = pl.preprocess(sorted(str(p) for p in (wd / "input").iterdir()))
        opm.reset_launch_counts()
        pl.match(stem)
        pl.filter(stem)
        counts = opm.launch_counts()
        if dev == "cuda":  # B1 and B2; the acc and keep instances are not on this path
            assert counts["match_popcount_b1"] and counts["match_popcount_b2"], counts
            assert not counts["match_popcount_acc"] and not counts["match_popcount_keep"], counts
        else:
            assert not any(counts.values()), counts
        outs[dev] = {
            p.name: gzip.open(p, "rb").read()
            for p in (wd / "intermediate" / "03_match").glob("*.gz")
        } | {p.name: p.read_bytes() for p in (wd / "intermediate" / "04_filter").glob("*.fa")}
    assert len(outs["cuda"]) == 5
    assert outs["cuda"] == outs["cpu"]


# --- align stage: kernels B3 (chain scan) and B4 (extension scan) -----------


def _anchor_sets(rng, p, a, rmax, qmax, q16=False):
    """[P, A] sorted anchor sets of random fill, the last two rows all
    padding; qpos < 2**16 when q16."""
    rp = np.full((p, a), opc.PAD_POS, np.int32)
    qp = np.full((p, a), opc.PAD_POS, np.int32)
    for i in range(max(0, p - 2)):
        n = int(rng.integers(1, a + 1))
        r = rng.integers(0, rmax, n).astype(np.int32)
        q = rng.integers(0, qmax, n).astype(np.int32)
        o = np.lexsort((q, r))
        rp[i, :n], qp[i, :n] = r[o], q[o]
    if q16:
        q = np.zeros((p, a), np.uint16)
        np.copyto(q, qp, casting="unsafe", where=qp < opc.PAD_POS)
        return rp, q.view(np.int16)
    return rp, qp


CHAIN_SHAPES = [
    # (P, A, lookback, q16): the bucket shapes (W = 32 at A = 32), a window
    # that is not a power of two, A far above the window, A = 4096, and
    # positions past 2**24 (f32 rounding)
    (70, 32, 64, False, 400),
    (66, 64, 64, True, 400),
    (35, 48, 64, False, 300),
    (17, 100, 20, False, 500),
    (40, 256, 64, True, 2000),
    (9, 1024, 64, False, 6000),
    (3, 4096, 64, True, 20000),
    (12, 64, 64, False, 40_000_000),
]


@pytest.mark.parametrize("lanes", opc.KERNEL_LANES)
@pytest.mark.parametrize("p,a,lookback,q16,rmax", CHAIN_SHAPES)
def test_chain_scan_equals_plain_version(cuda, p, a, lookback, q16, rmax, lanes):
    """Kernel B3 at every lane count against chain_dp_ref on the card, bit
    for bit, and the whole chain_anchors on the card against the CPU."""
    rng = np.random.default_rng(p * a)
    rp, qp = _anchor_sets(rng, p, a, rmax, min(rmax, 60000), q16)
    r, q = torch.from_numpy(rp).to(cuda), torch.from_numpy(qp).to(cuda)
    cost = opc.device_cost_table(21, 100, cuda)
    before = opc.launch_counts()["chain_scan"]
    f, par = opc.chain_dp_cuda(r, q, cost, 21, 100, 100, lookback, lanes=lanes)
    torch.cuda.synchronize()
    assert opc.launch_counts()["chain_scan"] == before + 1
    f_ref, par_ref = opc.chain_dp_ref(r, q, cost, 21, 100, 100, lookback)
    assert torch.equal(f, f_ref)
    assert torch.equal(par, par_ref)
    assert (f[-2:] == float(opc.NEG)).all() and (par[-2:] == -1).all()
    got = opc.chain_anchors(r, q, lookback=lookback)
    want = opc.chain_anchors(torch.from_numpy(rp), torch.from_numpy(qp), lookback=lookback)
    for name in want._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.parametrize("lanes", opc.KERNEL_LANES)
@pytest.mark.parametrize("gap,band,lookback", [(5000, 500, 64), (40, 100, 64), (100, 100, 1), (20_000, 20_000, 64)])
def test_chain_scan_gaps_tables_and_windows(cuda, gap, band, lookback, lanes):
    """A long-read max_gap and bandwidth, max_gap below the bandwidth (the
    shared table cut to it), a window of one slot, and a table past 48 KB
    of shared memory; long noisy diagonals with runs of equal anchors."""
    rng = np.random.default_rng(gap + lookback)
    p, a = 5, 600
    q = np.sort(rng.integers(0, 20_000, (p, a)), axis=1).astype(np.int32)
    r = (q + 7_000 + np.cumsum(rng.choice([-2, 0, 0, 0, 3], (p, a)), axis=1)).astype(np.int32)
    r[:, 100:110] = r[:, 100:101]
    q[:, 100:110] = q[:, 100:101]
    o = np.argsort(r.astype(np.int64) * 2**15 + q, axis=1, kind="stable")  # by (rpos, qpos)
    rp, qp = np.take_along_axis(r, o, 1), np.take_along_axis(q, o, 1)
    rt, qt = torch.from_numpy(rp).to(cuda), torch.from_numpy(qp).to(cuda)
    cost = opc.device_cost_table(21, band, cuda)
    f, par = opc.chain_dp_cuda(rt, qt, cost, 21, gap, band, lookback, lanes=lanes)
    f_ref, par_ref = opc.chain_dp_ref(rt, qt, cost, 21, gap, band, lookback)
    assert torch.equal(f, f_ref) and torch.equal(par, par_ref)
    assert (par_ref >= 0).float().mean() > 0.3 or lookback == 1


EXTEND_SHAPES = [
    # (P, L, band): one fused chunk's width, L not a multiple of 32, every
    # band the kernel takes, more pairs than a block holds
    (37, 160, 128),
    (50, 64, 128),
    (9, 96, 256),
    (5, 200, 384),
    (3, 130, 512),
    (1030, 32, 128),
]


def _extend_case(rng, p, l, band):
    q = rng.integers(0, 4, (p, l)).astype(np.uint8)
    q_len = rng.integers(0, l + 1, p).astype(np.int32)
    q_len[:3] = [0, 1, l]
    r = rng.integers(0, 4, (p, l + band)).astype(np.uint8)
    for i in range(p):
        s = np.delete(q[i], rng.integers(0, l, 3))
        off = int(rng.integers(0, band // 2))
        r[i, off : off + len(s)] = s
    lo = rng.integers(0, band // 4, p)
    hi = l + band - rng.integers(0, band // 4, p)
    cols = np.arange(l + band)[None, :]
    v = (cols >= lo[:, None]) & (cols < hi[:, None])
    return q, q_len, r, v


EXTEND_CASES = [(p, l, band, g) for p, l, band in EXTEND_SHAPES for g in ope.KERNEL_LANES[band]]


@pytest.mark.parametrize("p,l,band,lanes", EXTEND_CASES)
@pytest.mark.parametrize("collect", [False, True])
def test_extend_scan_equals_plain_version(cuda, p, l, band, lanes, collect):
    """Kernel B4 at every lane count of the band against extend_ref on the
    card, bit for bit: score, end_d and the plane; q_len 0, 1, L and random
    side by side in a warp; contig edges in the window; planted reads with
    indels so that the gap families win cells."""
    rng = np.random.default_rng(p + l + band)
    q, q_len, r, v = _extend_case(rng, p, l, band)
    args = [torch.from_numpy(a).to(cuda) for a in (q, q_len, r, v)]
    before = ope.launch_counts()["extend_scan"]
    got = ope.extend_cuda(*args, collect_plane=collect, lanes=lanes)
    torch.cuda.synchronize()
    assert ope.launch_counts()["extend_scan"] == before + 1
    want = ope.extend_ref(*args, collect_plane=collect)
    assert torch.equal(got.score, want.score)
    assert torch.equal(got.end_d, want.end_d)
    assert torch.equal(got.p_plane, want.p_plane)
    assert want.score[0] == float(ope.NEG) and want.end_d[0] == 0
    cpu = ope.extend_ref(*[torch.from_numpy(a) for a in (q, q_len, r, v)], collect_plane=collect)
    assert torch.equal(got.score.cpu(), cpu.score) and torch.equal(got.end_d.cpu(), cpu.end_d)


@pytest.mark.parametrize("lanes", ope.KERNEL_LANES[128])
def test_extend_scan_invalid_windows_and_other_scoring(cuda, lanes):
    """Windows wholly outside the contig (every substitution -1e30) beside
    valid ones, under map-ont style scoring."""
    sc = ope.SrScoring(match=2, mismatch=4, gap_open1=4, gap_ext1=2, gap_open2=24, gap_ext2=1)
    rng = np.random.default_rng(lanes)
    q, q_len, r, v = _extend_case(rng, 40, 96, 128)
    v[::3] = False
    args = [torch.from_numpy(a).to(cuda) for a in (q, q_len, r, v)]
    got = ope.extend_cuda(*args, sc, collect_plane=True, lanes=lanes)
    want = ope.extend_ref(*args, sc, collect_plane=True)
    for name in ("score", "end_d", "p_plane"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (want.p_plane[::3] == float(ope.NEG)).any()


def test_align_kernels_refuse_bad_arguments(cuda):
    r = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    cost = opc.device_cost_table(21, 100, cuda)
    with pytest.raises(ValueError, match="window"):
        opc.chain_dp_cuda(r, r, cost, 21, 100, 100, lookback=128)
    with pytest.raises(ValueError, match="lanes"):
        opc.chain_dp_cuda(r, r, cost, 21, 100, 100, lanes=2)
    q = torch.zeros((4, 32), dtype=torch.uint8, device=cuda)
    w = torch.zeros((4, 32 + 100), dtype=torch.uint8, device=cuda)
    ql = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="band"):
        ope.extend_cuda(q, ql, w, w)
    w = torch.zeros((4, 32 + 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="lanes"):
        ope.extend_cuda(q, ql, w, w, lanes=4)
    for bad in (ope.SrScoring(match=2.5), ope.SrScoring(gap_ext2=0.5), ope.SrScoring(mismatch=3_000_000)):
        with pytest.raises(ValueError, match="integer|int32 DP limit"):
            ope.extend_cuda(q, ql, w, w, bad)


WIDE = ope.SrScoring(match=200, mismatch=150)  # -A 200 -B 150


@pytest.mark.parametrize("p,l,band,lanes", [c for c in EXTEND_CASES if c[2] <= 256])
@pytest.mark.parametrize("collect", [False, True])
def test_extend_scan_wide_scoring_equals_plain_version(cuda, p, l, band, lanes, collect):
    """Match and mismatch outside a signed byte (-A 200 -B 150) take B4's
    int32 substitution: bit for bit the plain version on the card and on
    the CPU."""
    rng = np.random.default_rng(7 * p + l + band)
    q, q_len, r, v = _extend_case(rng, p, l, band)
    args = [torch.from_numpy(a).to(cuda) for a in (q, q_len, r, v)]
    got = ope.extend_cuda(*args, WIDE, collect_plane=collect, lanes=lanes)
    want = ope.extend_ref(*args, WIDE, collect_plane=collect)
    cpu = ope.extend_ref(*[torch.from_numpy(a) for a in (q, q_len, r, v)], WIDE, collect_plane=collect)
    for name in ("score", "end_d", "p_plane"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name).cpu(), getattr(cpu, name)), name
    assert (want.score >= 200 * 16).any()


#: (P, L, band) of B4's packed instance: the delegated chunk's L = 256,
#: widths whose packed rows end in a part-filled byte, every band, more
#: pairs than a block holds
PACKED_SHAPES = [(37, 256, 128), (50, 61, 128), (9, 99, 256), (5, 201, 384), (3, 130, 512), (1030, 33, 128)]
PACKED_CASES = [(p, l, band, g) for p, l, band in PACKED_SHAPES for g in ope.KERNEL_LANES[band]]


def _packed_extend_case(rng, p, l, band):
    """_extend_case's pairs with [lo, hi) bounds cutting both edges of most
    windows, one window with lo > hi, and the last two rows padding as the
    engine pads a chunk (codes 0, q_len 0, lo = hi = 0): (q, q_len, r, lo,
    hi, mask)."""
    wlen = l + band
    q, q_len, r, _ = _extend_case(rng, p, l, band)
    lo = rng.integers(1, band // 4, p).astype(np.int32)
    hi = (wlen - rng.integers(1, band // 4, p)).astype(np.int32)
    lo[min(3, p - 1)], hi[min(3, p - 1)] = wlen - 5, 7
    if p > 5:
        q[-2:], q_len[-2:], r[-2:], lo[-2:], hi[-2:] = 0, 0, 0, 0, 0
    cols = np.arange(wlen)[None, :]
    return q, q_len, r, lo, hi, (cols >= lo[:, None]) & (cols < hi[:, None])


def _packed_inputs(cuda, q, q_len, r, lo, hi):
    return [torch.from_numpy(a).to(cuda) for a in (ope.pack2bit(q), q_len, ope.pack2bit(r), lo, hi)]


def _packed_launches() -> int:
    return ope.launch_counts().get("extend_scan_packed", 0)


@pytest.mark.parametrize("p,l,band,lanes,scoring", [
    *[(*c, ope.SrScoring()) for c in PACKED_CASES], *[(*c, WIDE) for c in PACKED_CASES if c[2] <= 256]])
@pytest.mark.parametrize("collect", [False, True])
def test_extend_scan_packed_equals_plain_version(cuda, p, l, band, lanes, collect, scoring):
    """B4's packed instance (2-bit codes and [lo, hi) read in the kernel)
    against extend_ref on the unpacked codes and mask, bit for bit, at
    every lane count of the band, byte and wide (bands 128 and 256)
    substitution: one launch of extend_scan_packed a call."""
    rng = np.random.default_rng(11 * p + l + band + lanes)
    q, q_len, r, lo, hi, v = _packed_extend_case(rng, p, l, band)
    before = _packed_launches()
    got = ope.extend_cuda_packed(*_packed_inputs(cuda, q, q_len, r, lo, hi), l, l + band, scoring,
                                 collect_plane=collect, lanes=lanes)
    torch.cuda.synchronize()
    assert _packed_launches() == before + 1
    want = ope.extend_ref(*[torch.from_numpy(a).to(cuda) for a in (q, q_len, r, v)], scoring, collect_plane=collect)
    for name in ("score", "end_d", "p_plane"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (want.score > 0).any()


def test_packed_entry_points_launch_one_kernel_and_no_aten_op(cuda):
    """extend_banded_scores_packed and extend_banded_packed on the card:
    one extend_scan_packed launch a call and no aten op but the outputs'
    allocations (no unpack, no mask), results equal to the plain version."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    p, l, band = 256, 256, 128
    q, q_len, r, lo, hi, v = _packed_extend_case(np.random.default_rng(16), p, l, band)
    packs = _packed_inputs(cuda, q, q_len, r, lo, hi)
    plain = [torch.from_numpy(a).to(cuda) for a in (q, q_len, r, v)]
    for fn, collect in ((ope.extend_banded_scores_packed, False), (ope.extend_banded_packed, True)):
        before = (_packed_launches(), ope.launch_counts()["extend_scan"])
        with Ops() as mode:
            got = fn(*packs, l, l + band)
        torch.cuda.synchronize()
        assert (_packed_launches(), ope.launch_counts()["extend_scan"]) == (before[0] + 1, before[1])
        assert mode.ops and {f.overloadpacket for f in mode.ops} <= {torch.ops.aten.empty}, mode.ops
        want = ope.extend_ref(*plain, collect_plane=collect)
        assert torch.equal(got[0], want.score) and torch.equal(got[1], want.end_d)
        if collect:
            assert torch.equal(got.p_plane, want.p_plane)


def test_packed_extension_on_a_mesh_equals_one_device(cuda):
    """dist_extend_scores_packed and dist_extend_packed over a 1x2 mesh on
    the one card: each query shard's row slice through the packed
    instance (one launch a shard), equal to the one-device call."""
    from phylign_tpu_torch.parallel import dist
    from phylign_tpu_torch.parallel.mesh import make_mesh

    p, l, band = 64, 256, 128
    q, q_len, r, lo, hi, _ = _packed_extend_case(np.random.default_rng(17), p, l, band)
    host = (ope.pack2bit(q), q_len, ope.pack2bit(r), lo, hi)
    packs = _packed_inputs(cuda, q, q_len, r, lo, hi)
    mesh = make_mesh(1, 2, devices=["cuda:0"] * 2)
    one = ope.extend_banded_scores_packed(*packs, l, l + band)
    before = _packed_launches()
    got = dist.dist_extend_scores_packed(mesh, *host, l, l + band)
    torch.cuda.synchronize()
    assert _packed_launches() == before + 2
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    one = ope.extend_banded_packed(*packs, l, l + band)
    got = dist.dist_extend_packed(mesh, *host, l, l + band)
    torch.cuda.synchronize()
    assert _packed_launches() == before + 5
    for name in ("score", "end_d", "p_plane"):
        assert torch.equal(getattr(got, name), getattr(one, name)), name


#: B4's packed routes, each with an L: the delegated chunk's 256 at band
#: 128, others shorter
PACKED_ROUTE_CASES = sorted(ope.PACKED_ROUTES)
ROUTE_L = {128: 256, 256: 200, 384: 150, 512: 130}


@pytest.mark.parametrize("p", [1, 3, 256, 512, 1000])
@pytest.mark.parametrize("band,collect", PACKED_ROUTE_CASES)
@pytest.mark.parametrize("scoring", [ope.SrScoring(), WIDE], ids=["sr", "wide"])
def test_extend_wave_equals_plain_version_and_row_body(cuda, p, band, collect, scoring):
    """The packed instance on its route (ope.PACKED_ROUTES: the wavefront
    body at band 128 and for band 256's score pass, the row body elsewhere)
    against extend_ref on the unpacked codes and mask and against the row
    body at 32 lanes (the PACKED_ROWS_BUILD library) on the packs, bit for
    bit: P of 1, 3, 256, 512 and 1,000 (grids under and over the card's
    SMs), every band, both passes, byte and wide substitution; one launch a
    call."""
    l = ROUTE_L[band]
    rng = np.random.default_rng(13 * p + band + collect)
    q, q_len, r, lo, hi, v = _packed_extend_case(rng, max(p, 8), l, band)
    q, q_len, r, lo, hi, v = (a[:p] for a in (q, q_len, r, lo, hi, v))
    packs = _packed_inputs(cuda, q, q_len, r, lo, hi)
    before = _packed_launches()
    got = ope.extend_cuda_packed(*packs, l, l + band, scoring, collect_plane=collect)
    torch.cuda.synchronize()
    assert _packed_launches() == before + 1
    rows = ope.extend_cuda_packed(*packs, l, l + band, scoring, collect_plane=collect, lanes=32)
    want = ope.extend_ref(*[torch.from_numpy(a).to(cuda) for a in (q, q_len, r, v)], scoring, collect_plane=collect)
    for name in ("score", "end_d", "p_plane"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name), getattr(rows, name)), name
    if p >= 8:
        assert (want.score > 0).any()


def test_extend_packed_query_past_the_wavefronts_shared_memory(cuda):
    """A query of 14,401 codes at band 128 (tables past a block's shared
    memory) takes the row body at 32 lanes, equal to extend_ref; 14,400
    takes the wavefront."""
    band = 128
    for l in (14_400, 14_401):
        q, q_len, r, lo, hi, v = _packed_extend_case(np.random.default_rng(l), 4, l, band)
        assert ope.packed_lanes(band, False, l) == (0 if l == 14_400 else 32)
        got = ope.extend_cuda_packed(*_packed_inputs(cuda, q, q_len, r, lo, hi), l, l + band)
        want = ope.extend_ref(*[torch.from_numpy(a).to(cuda) for a in (q, q_len, r, v)])
        assert torch.equal(got.score, want.score) and torch.equal(got.end_d, want.end_d)


def test_extend_wave_instances_use_no_local_memory(cuda):
    """Every instance of the wavefront body and of the packed row body in
    the built library: those the packed routes launch (the row body at 32
    lanes at every band: the other routes and queries past the
    wavefront's shared memory) and no other, with no stack and no local
    memory (cuobjdump -res-usage)."""
    import re
    import subprocess
    from pathlib import Path

    from phylign_tpu_torch.ops import _kernels

    tool = Path(_kernels.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-res-usage", str(_kernels.build("extend_scan"))], capture_output=True,
                         text=True, timeout=120, check=True)
    found = {}
    for name, kind, stack, local in re.findall(
            r"Function (\S*extend_(scan|wave)_kernel\S*):\s*REG:\d+ STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", res.stdout):
        args = tuple(int(a) for a in re.findall(r"L[a-z](\d+)E", name))
        found[kind, args] = (int(stack), int(local))
    routes = ope.PACKED_ROUTES.items()
    waves = {a for k, a in found if k == "wave"}
    assert waves == {(band // 32, w, int(plane)) for (band, plane), g in routes if not g for w in (0, 1)}
    packed_rows = {a for k, a in found if k == "scan" and a[-1] == 1}
    assert packed_rows == {(32, band // 32, w, 1) for band in ope.KERNEL_LANES for w in (0, 1)}
    assert {g for _, g in routes} == {0, 32}
    for key, (stack, local) in found.items():
        if key[0] == "wave" or key[1][-1] == 1:
            assert stack == 0 and local == 0, key


def test_run_all_on_cuda_equals_cpu(cuda, tmp_path):
    """make_fixture through the port's run_all on the card and on the CPU:
    identical 05_map, sam_summary and stats, and B3/B4 launched on the
    card only."""
    base = tmp_path / "base"
    fixture_mod.make_fixture(base, n_batches=3, seed=42)
    outs = {}
    for dev in ("cpu", "cuda"):
        wd = tmp_path / dev
        shutil.copytree(base, wd)
        opc.reset_launch_counts()
        ope.reset_launch_counts()
        pl = Pipeline(Config.from_yaml(wd / "config.yaml"), wd, device=dev)
        pl.run_all(sorted(str(p) for p in (wd / "input").iterdir()))
        n = opc.launch_counts()["chain_scan"] + ope.launch_counts()["extend_scan"]
        if dev == "cuda":
            assert opc.launch_counts()["chain_scan"] and ope.launch_counts()["extend_scan"]
        else:
            assert n == 0
        outs[dev] = {
            p.name: (gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes())
            for d in ("intermediate/05_map", "output") for p in (wd / d).iterdir()
        }
    assert len(outs["cuda"]) == 5
    assert outs["cuda"] == outs["cpu"]


def test_run_all_at_large_gap_open_on_cuda_equals_cpu(cuda, tmp_path):
    """sr with -O 12,300 (613 a row: far inside B4's int32 DP for 150 bp
    reads) runs the whole pipeline on the card, equal to the CPU run; a
    longest read past the limit is refused before matching."""
    base = tmp_path / "base"
    fixture_mod.make_fixture(base, n_batches=2, seed=42)
    outs = {}
    for dev in ("cpu", "cuda"):
        wd = tmp_path / dev
        shutil.copytree(base, wd)
        cfg = Config.from_yaml(wd / "config.yaml").with_overrides(minimap_extra_params="--eqx -O 12,300")
        pl = Pipeline(cfg, wd, device=dev)
        pl.run_all(sorted(str(p) for p in (wd / "input").iterdir()))
        outs[dev] = {
            p.name: (gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes())
            for d in ("intermediate/05_map", "output") for p in (wd / d).iterdir()
        }
        if dev == "cuda":
            with pytest.raises(ValueError, match="int32 DP limit"):
                pl.align_params(40_000)
    assert outs["cuda"] == outs["cpu"]
    assert any(b"\t150=" in v for v in outs["cuda"].values())


# --- the device mesh on the card (parallel/) -----------------------------------

#: a 2x2 mesh on the one card: every cell on cuda:0
MESH_DEVICES = ["cuda:0"] * 4


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("h,k", [(1, 128), (3, 96)])
def test_match_kernels_on_doc_shard_slices(cuda, nd, h, k):
    """B1 and B2 on each doc shard's contiguous column slice of a padded
    word matrix (68 words pad to 80 at nd = 2, 72 at nd = 3): each shard
    equals the plain version on its slice, and the shards side by side
    equal the full-width plain scores. The mesh path gives the same."""
    from phylign_tpu_torch.parallel import dist
    from phylign_tpu_torch.parallel.mesh import make_mesh

    s, wp, q = 3000, 68, 300
    rng = np.random.default_rng(nd + h)
    words = opm.pad_device_words(rng.integers(0, 2**32, (s, wp), dtype=np.uint32), lane_words=8 * nd)
    assert words.shape[1] == {2: 80, 3: 72}[nd]
    rows = rng.integers(0, s + 1, (q, k, h)).astype(np.int32)
    full = torch.from_numpy(words.view(np.int32)).to(cuda)
    rows_d = torch.from_numpy(rows).to(cuda)
    w_loc = words.shape[1] // nd
    before = opm.launch_counts()
    parts = []
    for d in range(nd):
        sl = full[:, d * w_loc : (d + 1) * w_loc].contiguous()
        got = opm.match_scores(sl, rows_d)
        assert torch.equal(got, opm.match_scores_ref(sl, rows_d))
        parts.append(got)
    torch.cuda.synchronize()
    assert opm.launch_counts()[opm.select_kernel(k, h)] == before[opm.select_kernel(k, h)] + nd
    want = opm.match_scores_ref(full, rows_d)
    assert torch.equal(torch.cat(parts, dim=1), want)
    mesh = make_mesh(nd, 2, devices=["cuda:0"] * (2 * nd))
    got = dist.fetch(dist.dist_match_scores(mesh, words.view(np.int32), rows))
    np.testing.assert_array_equal(got, want.cpu().numpy())


def _planted_index(n_docs=70):
    rng = np.random.default_rng(21)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    read = rng.choice(alpha, 150).tobytes()
    docs = []
    for i in range(n_docs):
        seq = rng.choice(alpha, 300).tobytes()
        docs.append((f"d{i:02d}", [read + seq if i % 3 == 0 else seq]))
    didx = iocobs.to_device_index(iocobs.build_classic_index(docs, term_size=31, fpr=0.01))
    seqs = [read, rng.choice(alpha, 150).tobytes(), b"ACG", read[:120] + rng.choice(alpha, 30).tobytes()]
    return didx, seqs


def test_mesh_score_hits_on_card_equals_one_device(cuda):
    """Matcher.score_hits with a 2x2 mesh over the one card (and a 4x1 one)
    equals the one-device card run and the CPU run; B2 ran per doc shard."""
    from phylign_tpu_torch.parallel.mesh import make_mesh

    didx, seqs = _planted_index()
    want = tm.Matcher.from_device_index(didx, "cpu").score_hits(seqs, 0.7, topn=5)
    one = tm.Matcher.from_device_index(didx, cuda).score_hits(seqs, 0.7, topn=5)
    for nd, nq in ((2, 2), (4, 1)):
        mesh = make_mesh(nd, nq, devices=MESH_DEVICES)
        opm.reset_launch_counts()
        got = tm.Matcher.from_device_index(didx, cuda, mesh=mesh).score_hits(seqs, 0.7, topn=5)
        torch.cuda.synchronize()
        assert opm.launch_counts()["match_popcount_b2"] == nd * nq
        for a, b, c in zip(got[0], one[0], want[0]):
            assert sorted(a) == sorted(b) == sorted(c)
        assert list(got[1]) == list(one[1]) == list(want[1])
    assert want[1][0] == 24


def test_mesh_flush_on_card_equals_one_device(cuda):
    """The fused flush on a 1x2 and a 2x4 mesh over the one card: B3/B4 per
    query shard, the same records as the one-device card run and the CPU's
    host path."""
    from phylign_tpu_torch.align import engine as tae
    from phylign_tpu_torch.kmer import decode_seq
    from phylign_tpu_torch.ops import minimizer as tmini
    from phylign_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    params = tae.AlignParams.from_preset("sr")
    base = rng.integers(0, 4, 120_000).astype(np.uint8)
    ref = tmini.build_ref_index("gA", [("c1", base[:70_000]), ("c2", base[60_000:])], params.k, params.w)
    sks = []
    for i in range(90):
        s = int(rng.integers(0, len(base) - 160))
        r = base[s : s + 150].copy()
        flip = rng.random(150) < 0.02
        r[flip] = (r[flip] + 1) % 4
        if i % 11 == 0:
            r = np.concatenate([r[:70], r[74:]])
        if i % 2:
            r = (3 - r)[::-1].copy()
        sks.append(tae.QuerySketch.make(f"r{i}", decode_seq(r).decode(), params))
    tasks = tae.make_pairs_batch(ref, sks, params)
    want = [r.to_line() for r in tae.flush_pairs(tasks, params, fused=False, device="cpu")]
    one = [r.to_line() for r in tae.flush_pairs(tasks, params, fused=True, device=cuda)]
    assert one == want
    for nd, nq in ((1, 2), (2, 4)):
        mesh = make_mesh(nd, nq, devices=["cuda:0"] * (nd * nq))
        opc.reset_launch_counts()
        ope.reset_launch_counts()
        got = [r.to_line() for r in tae.flush_pairs(tasks, params, mesh=mesh, fused=True, device=cuda)]
        torch.cuda.synchronize()
        assert got == want
        assert opc.launch_counts()["chain_scan"] >= nq and ope.launch_counts()["extend_scan"] >= nq


def test_pipeline_mesh_on_cuda_equals_one_device(cuda, tmp_path):
    """make_fixture through run_all with mesh_shape 2x2 over the one card:
    03_match, 04_filter, 05_map, sam_summary and stats equal the 1x1 card
    run byte for byte."""
    base = tmp_path / "base"
    fixture_mod.make_fixture(base, n_batches=3, seed=42)
    outs = {}
    for shape in ("1x1", "2x2"):
        wd = tmp_path / shape
        shutil.copytree(base, wd)
        cfg = Config.from_yaml(wd / "config.yaml").with_overrides(mesh_shape=shape)
        pl = Pipeline(cfg, wd, device=cuda, mesh_devices=MESH_DEVICES)
        pl.run_all(sorted(str(p) for p in (wd / "input").iterdir()))
        outs[shape] = {
            f"{d}/{p.name}": (gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes())
            for d in ("intermediate/03_match", "intermediate/04_filter", "intermediate/05_map", "output")
            for p in sorted((wd / d).iterdir())
        }
    assert len(outs["1x1"]) == 3 + 1 + 3 + 2
    assert outs["2x2"] == outs["1x1"]


def test_nccl_one_rank_gather_equals_in_process_mesh(cuda):
    """A one-rank nccl process group: the mesh's top-k gather runs through
    all_gather_into_tensor on the card, and score_hits equals the
    in-process mesh's."""
    import socket

    import torch.distributed as tdist

    from phylign_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    didx, seqs = _planted_index()
    want = tm.Matcher.from_device_index(didx, cuda, mesh=make_mesh(2, 2, devices=MESH_DEVICES)).score_hits(
        seqs, 0.7, topn=5)
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(2, 2, devices=MESH_DEVICES, group=tdist.group.WORLD)
        assert mesh.comm_device.type == "cuda"
        got = tm.Matcher.from_device_index(didx, cuda, mesh=mesh).score_hits(seqs, 0.7, topn=5)
    finally:
        tdist.destroy_process_group()
    assert [sorted(h) for h in got[0]] == [sorted(h) for h in want[0]]
    assert list(got[1]) == list(want[1])


@pytest.mark.parametrize("h,k,thr", [(1, 128, 0.3), (3, 96, 0.02), (1, 120, 0.55)])
def test_match_step_on_the_card(cuda, h, k, thr):
    """match_step on CUDA tensors: one launch of the keep instance of
    B1/B2; its scores equal match_scores_ref, and keep is the float32 test
    (match_scores_keep_ref's, bit for bit), never true for a query without
    k-mers."""
    gen = torch.Generator(device=cuda).manual_seed(h * 1000 + k)
    s, wp, q = 3000, 68, 300
    words = torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=gen)
    words &= torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=gen)
    words[s] = 0
    rows = torch.randint(0, s, (q, k, h), dtype=torch.int32, device=cuda, generator=gen)
    nk = torch.randint(0, k + 1, (q,), dtype=torch.int32, device=cuda, generator=gen)
    nk[::7] = 0
    rows[torch.arange(k, device=cuda)[None, :] >= nk[:, None]] = s
    before = opm.launch_counts()
    scores, keep = tm.match_step(words, rows, nk, thr)
    after = opm.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {"match_popcount_keep": 1}
    assert torch.equal(scores, opm.match_scores_ref(words, rows))
    ref = opm.match_scores_keep_ref(words, rows, nk, thr)
    assert torch.equal(scores, ref[0]) and torch.equal(keep, ref[1])
    sc, n = scores.cpu().numpy(), nk.cpu().numpy()
    cut = np.float32(thr) * n.astype(np.float32)
    want = (sc.astype(np.float32) >= cut[:, None]) & (n[:, None] > 0)
    np.testing.assert_array_equal(keep.cpu().numpy(), want)
    assert (sc == np.ceil(cut)[:, None]).any() and not want[n == 0].any()


# --- align stage: kernel B6 (the flush epilogue) -------------------------------

B6A_SHAPES = [
    # (P, A, q16, rmax): the anchor buckets, the main path's A = 32 bucket
    # at P = 16,384, A past 48 KB of shared memory (4096, 8192), A past
    # shared memory (the device workspace: 8,193, 16,384), one slot; the
    # warp kernel's edges: A = 31, 33 and 65 (a lane's last slots past A),
    # its largest A (256) and one past it (257, a block a set), at P off
    # its 8 sets a block
    (70, 32, False, 400),
    (13, 31, True, 300),
    (29, 33, False, 300),
    (21, 65, True, 500),
    (17, 256, False, 2000),
    (11, 257, True, 2000),
    (16384, 32, True, 400),
    (66, 64, True, 400),
    (40, 256, True, 2000),
    (9, 1024, False, 6000),
    (5, 4096, True, 20000),
    (3, 8192, False, 40000),
    (3, 8193, True, 40000),
    (3, 16384, False, 80000),
    (4, 1, False, 10),
]


@pytest.mark.parametrize("n_sup", [0, 1, 2, 3])
@pytest.mark.parametrize("p,a,q16,rmax", B6A_SHAPES)
def test_chain_select_equals_plain_version(cuda, p, a, q16, rmax, n_sup):
    """Kernel B6a against _chain_tail_ref on B3's output on the card, every
    ChainResult field bit for bit (all-padding rows included)."""
    rng = np.random.default_rng(p + a)
    rp, qp = _anchor_sets(rng, p, a, rmax, min(rmax, 60000), q16)
    r, q = torch.from_numpy(rp).to(cuda), torch.from_numpy(qp).to(cuda)
    f, par = opc.chain_dp_cuda(r, q, opc.device_cost_table(21, 100, cuda), 21, 100, 100)
    before = opc.launch_counts()["chain_select"]
    got = opc.chain_select_cuda(f, par, r, q, 21, n_sup)
    torch.cuda.synchronize()
    assert opc.launch_counts()["chain_select"] == before + 1
    want = opc._chain_tail_ref(f, par, r, q, 21, n_sup)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if p > 2:
        assert (want.score[-2:] == float(opc.NEG)).all()


def test_chain_anchors_past_shared_memory_equals_cpu(cuda):
    """chain_anchors on the card at A = 16,384 (B3, then B6a on its device
    workspace) equals the CPU run of the plain versions, every field."""
    rp, qp = _anchor_sets(np.random.default_rng(7), 4, 16384, 80000, 60000)
    want = opc.chain_anchors(torch.from_numpy(rp), torch.from_numpy(qp))
    before = opc.launch_counts()["chain_select"]
    got = opc.chain_anchors(torch.from_numpy(rp).to(cuda), torch.from_numpy(qp).to(cuda))
    assert opc.launch_counts()["chain_select"] == before + 1
    for name in want._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


FLUSH_CASES = [
    # (P, lmax, band, n_sup): small, the main path's flush (COLD_CAP
    # overflows), one and no split segment, long queries, a wider band
    (64, 160, 128, 2),
    (8192, 160, 128, 2),
    (256, 160, 128, 1),
    (256, 160, 128, 0),
    (200, 2208, 128, 2),
    (128, 160, 256, 2),
]


def _flush_inputs(cuda, p, lmax, band, n_sup, seed):
    ch, ins, kw = fixture_mod.flush_case(np.random.default_rng(seed), p, lmax, band, n_sup)
    chains = tuple(opc.ChainResult(*[torch.from_numpy(c[n]) for n in fixture_mod.CHAIN_FIELDS]) for c in ch)
    host = [torch.from_numpy(x) for x in ins]
    return chains, host, tuple(type(c)(*[t.to(cuda) for t in c]) for c in chains), [t.to(cuda) for t in host], kw


@pytest.mark.parametrize("scoring", [ope.SrScoring(), WIDE], ids=["sr", "wide"])
@pytest.mark.parametrize("p,lmax,band,n_sup", FLUSH_CASES)
def test_flush_epilogue_equals_plain_version(cuda, p, lmax, band, n_sup, scoring):
    """B6b against _select_ref (every Selection field), then B4, then B6c and
    its compaction against _finish_ref / _compact_cold: the whole packed
    buffer and the full cold rows bit for bit; then select_extend on the
    card against the CPU run."""
    chains, host, dchains, dev_in, kw = _flush_inputs(cuda, p, lmax, band, n_sup, p + lmax + n_sup)
    fz.reset_launch_counts()
    sel = fz.select_window_cuda(dchains, *dev_in, **kw)
    ref = fz._select_ref(fz._flatten_chains(dchains), *dev_in, **kw)
    torch.cuda.synchronize()
    for name in ref._fields[:-1]:
        a, b = getattr(sel, name), getattr(ref, name)
        assert torch.equal(a.to(b.dtype), b), name
    q_len = dev_in[4]
    ext = ope.extend_cuda(sel.q_codes, q_len, sel.rwin, sel.rvalid, scoring)
    got_fin = fz.finish_pack_cuda(sel, q_len, ext.score, ext.end_d, scoring, 100)
    got_cc = fz.compact_cold_cuda(sel)
    hot, neq = fz._finish_ref(ref, q_len, ext.score, ext.end_d, scoring, 100)
    cc = fz._compact_cold(hot, ref.cold_i, ref.cold_f)
    want = torch.cat([fz._bitcast_u8(x) for x in (hot, ref.flts, neq, *cc)])
    torch.cuda.synchronize()
    for a, b in zip((*got_fin, *got_cc), (hot, neq, *cc)):
        assert torch.equal(a, b)
    assert torch.equal(sel.packed, want)
    assert fz.launch_counts() == {"select_window": 1, "finish_pack": 1, "compact_cold": 1}
    flags = hot[:, 2] & 0xFF
    assert bool((flags & fz.F_FULL).any()) and bool(((flags & fz.F_HAS) & ~(flags & fz.F_FULL) != 0).any())
    assert bool((ref.lohi[:, 0] > 0).any() or (ref.lohi[:, 1] < lmax + band).any())
    got = fz.select_extend(dchains, *dev_in, scoring=scoring, pack=True, **kw)
    cpu = fz.select_extend(chains, *host, scoring=scoring, pack=True, **kw)
    assert torch.equal(got[0].cpu(), cpu[0])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got[1], cpu[1]))


@pytest.mark.parametrize("zdrop", [10, 12, 100])
@pytest.mark.parametrize("scoring", [ope.SrScoring(), WIDE], ids=["sr", "wide"])
def test_finish_pack_on_crafted_rows(cuda, scoring, zdrop):
    """B6c against _finish_ref on testing.finish_case's rows (mismatch runs
    at and across 32-column tiles, z-drops, cut windows): hot rows and
    mismatch bits bit for bit."""
    q, rwin, lohi, head, q_len, ext, end_d = fixture_mod.finish_case(
        np.random.default_rng(zdrop), 200, 160, 128, scoring.match, scoring.mismatch)
    p, lmax = q.shape
    t = {k: torch.from_numpy(v).to(cuda) for k, v in dict(q=q, rwin=rwin, lohi=lohi, q_len=q_len, ext=ext,
                                                            end_d=end_d).items()}
    packed = torch.zeros(sum(fz._packed_sizes(p, lmax, 0)), dtype=torch.uint8, device=cuda)
    hot, flts, bits = fz._packed_views(packed, p, lmax, 0)[:3]
    hot.copy_(torch.from_numpy(head))
    empty = torch.zeros((p, 0), dtype=torch.float32, device=cuda)
    sel = fz.Selection(t["q"], t["rwin"], t["rwin"], t["lohi"], hot, flts, empty, empty, packed)
    ref = sel._replace(head=torch.from_numpy(head).to(cuda), packed=None)
    got = fz.finish_pack_cuda(sel, t["q_len"], t["ext"], t["end_d"], scoring, zdrop)
    want = fz._finish_ref(ref, t["q_len"], t["ext"], t["end_d"], scoring, zdrop)
    torch.cuda.synchronize()
    assert torch.equal(hot, want[0]) and torch.equal(bits, want[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(((hot[:, 2] & fz.F_DIAG) != 0).any()) and bool(((hot[:, 2] & fz.F_FULL) != 0).any())


@pytest.mark.parametrize("lmax", [32, 160, 2208])
def test_finish_pack_at_the_window_ends(cuda, lmax):
    """B6c against _finish_ref with end_d at both ends of the window (0 and
    wlen - lmax: a lane's 8 window bytes at the row's first and last
    columns, read through the clamp path where their words would leave the
    row), at lmax 32 (4 lanes of a tile), 160 and 2,208 (9 tiles, the count
    and peak carried): hot rows and mismatch bits bit for bit."""
    q, rwin, lohi, head, q_len, ext, end_d = fixture_mod.finish_case(
        np.random.default_rng(lmax), 120, lmax, 128, 2, 8, ends=True, qmax=lmax)
    p = len(q)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in dict(q=q, rwin=rwin, lohi=lohi, q_len=q_len, ext=ext,
                                                            end_d=end_d).items()}
    packed = torch.zeros(sum(fz._packed_sizes(p, lmax, 0)), dtype=torch.uint8, device=cuda)
    hot, flts, bits = fz._packed_views(packed, p, lmax, 0)[:3]
    hot.copy_(torch.from_numpy(head))
    empty = torch.zeros((p, 0), dtype=torch.float32, device=cuda)
    sel = fz.Selection(t["q"], t["rwin"], t["rwin"], t["lohi"], hot, flts, empty, empty, packed)
    ref = sel._replace(head=torch.from_numpy(head).to(cuda), packed=None)
    fz.reset_launch_counts()
    got = fz.finish_pack_cuda(sel, t["q_len"], t["ext"], t["end_d"], ope.SrScoring(), 100)
    want = fz._finish_ref(ref, t["q_len"], t["ext"], t["end_d"], ope.SrScoring(), 100)
    torch.cuda.synchronize()
    assert fz.launch_counts()["finish_pack"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(((want[0][:, 2] & fz.F_FULL) != 0).any())


def test_finish_pack_clamps_outside_the_window(cuda):
    """B6c with end_d 7 columns before or past the window: the lanes whose
    8 bytes leave the row read each column clamped to the window, which is
    _finish_ref on the window widened by copies of its end bytes
    (testing.window_padded); end_d's own bits of the hot row stay the
    given ones."""
    sc = ope.SrScoring()
    q, rwin, lohi, head, q_len, ext, end_d = fixture_mod.finish_case(
        np.random.default_rng(5), 30, 160, 128, sc.match, sc.mismatch, ends=True, qmax=160)
    end_d = end_d.copy()
    end_d[::3] -= 7
    end_d[1::3] += 7
    p, lmax = q.shape
    wide, wlohi, wend = fixture_mod.window_padded(rwin, lohi, end_d, 8)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in dict(q=q, rwin=rwin, lohi=lohi, q_len=q_len, ext=ext,
                                                            end_d=end_d, wide=wide, wlohi=wlohi,
                                                            wend=wend).items()}
    packed = torch.zeros(sum(fz._packed_sizes(p, lmax, 0)), dtype=torch.uint8, device=cuda)
    hot, flts, bits = fz._packed_views(packed, p, lmax, 0)[:3]
    hot.copy_(torch.from_numpy(head))
    empty = torch.zeros((p, 0), dtype=torch.float32, device=cuda)
    sel = fz.Selection(t["q"], t["rwin"], t["rwin"], t["lohi"], hot, flts, empty, empty, packed)
    ref = fz.Selection(t["q"], t["wide"], t["wide"], t["wlohi"], torch.from_numpy(head).to(cuda), flts, empty,
                       empty, None)
    got = fz.finish_pack_cuda(sel, t["q_len"], t["ext"], t["end_d"], sc, 100)
    want = fz._finish_ref(ref, t["q_len"], t["ext"], t["wend"], sc, 100)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][:, [0, 1, 3]], want[0][:, [0, 1, 3]])
    assert torch.equal(got[0][:, 2] & 0xFF, want[0][:, 2] & 0xFF)
    assert torch.equal(got[0][:, 2] >> 8, t["end_d"])


def test_flush_epilogue_on_a_mesh_equals_one_device(cuda):
    """dist_select_extend over a 1x2 and a 1x4 mesh on the one card: B6 per
    query shard, hot / flts / mismatch bits / full cold rows equal the
    unpacked one-device run."""
    from phylign_tpu_torch.parallel.mesh import make_mesh

    _, _, dchains, dev_in, kw = _flush_inputs(cuda, 512, 160, 128, 2, 5)
    one = fz.select_extend(dchains, *dev_in, scoring=ope.SrScoring(), **kw)
    for nq in (2, 4):
        fz.reset_launch_counts()
        got = fz.dist_select_extend(make_mesh(1, nq, devices=["cuda:0"] * nq), dchains, *dev_in,
                                    scoring=ope.SrScoring(), **kw)
        torch.cuda.synchronize()
        assert fz.launch_counts() == {"select_window": nq, "finish_pack": nq, "compact_cold": 0}
        for a, b in zip((*got[:3], *got[3]), (*one[:3], *one[4])):
            assert torch.equal(a.to(b.device), b)


def test_flush_epilogue_refuses_more_than_two_segments(cuda):
    """The flag byte holds two split-segment bits: max_segments 4, or chain
    results with 3 segments, raise on the card instead of running."""
    _, _, dchains, dev_in, kw = _flush_inputs(cuda, 16, 160, 128, 2, 1)
    fz.reset_launch_counts()
    with pytest.raises(ValueError, match="split segments"):
        fz.select_window_cuda(dchains, *dev_in, **dict(kw, max_segments=4))
    with pytest.raises(ValueError, match="split segments"):
        fz.select_extend(dchains, *dev_in, scoring=ope.SrScoring(), **dict(kw, max_segments=4))
    _, _, dchains3, dev_in3, kw3 = _flush_inputs(cuda, 16, 160, 128, 3, 1)
    with pytest.raises(ValueError, match="split segments"):
        fz.select_window_cuda(dchains3, *dev_in3, **dict(kw3, max_segments=3))
    assert not any(fz.launch_counts().values())


@pytest.mark.parametrize("p,kind", [
    (1, "none"), (1, "all"), (31, "all"), (33, "random"), (1025, "random"), (1025, "none"), (8192, "random"),
    (8192, "all"), (1000, ("at", 767)), (2000, ("at", 1023)), (2000, ("at", 1024))])
def test_compact_cold_edges_equal_plain_version(cuda, p, kind):
    """The compaction's blocks of 256 rows against _compact_cold on
    testing.cold_case's flags: no needed row, every row needed, P = 1, P
    off the block size, the COLD_CAP-th needed row on a block's last row
    (767, 1,023) and first row (1,024); every slot bit for bit, one launch."""
    hot, cold_i, cold_f = (torch.from_numpy(x).to(cuda) for x in fixture_mod.cold_case(np.random.default_rng(p), p,
                                                                                       kind))
    n_out, lmax = cold_f.shape[1], 32
    packed = torch.full((sum(fz._packed_sizes(p, lmax, n_out)),), 0x5A, dtype=torch.uint8, device=cuda)
    fz._packed_views(packed, p, lmax, n_out)[0].copy_(hot)
    none = torch.empty((p, lmax), dtype=torch.uint8, device=cuda)
    sel = fz.Selection(none, none, none, none, hot, hot, cold_i, cold_f, packed)
    fz.reset_launch_counts()
    got = fz.compact_cold_cuda(sel)
    want = fz._compact_cold(hot, cold_i, cold_f)
    torch.cuda.synchronize()
    assert fz.launch_counts()["compact_cold"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("p,lmax,band", [(p, 160, band) for p in (1, 31, 33, 1025, 8192) for band in (100, 128)])
def test_select_window_alignment_equals_plain_version(cuda, p, lmax, band):
    """B6b's 16-byte chunks on windows of 260 and 288 bytes (260: chunks
    across rows, a tail in the last block; the packed buffer's layout keeps
    lmax a multiple of 32), blocks of 32 pairs cut at P = 1, 31, 33, 1,025,
    and w0 at every residue mod 16 on both strands: every Selection field
    bit for bit."""
    _, _, dchains, dev_in, kw = _flush_inputs(cuda, p, lmax, band, 2, 7 * p + lmax)
    sel = fz.select_window_cuda(dchains, *dev_in, **kw)
    ref = fz._select_ref(fz._flatten_chains(dchains), *dev_in, **kw)
    torch.cuda.synchronize()
    for name in ref._fields[:-1]:
        assert torch.equal(getattr(sel, name).to(getattr(ref, name).dtype), getattr(ref, name)), name
    if p >= 1025:
        flags = ref.head[:, 2]
        has = (flags & fz.F_HAS) != 0
        w0 = dev_in[1] + ref.cold_i[:, 2] - ref.cold_i[:, 0] - kw["half"]
        for rev in (False, True):
            on = has & (((flags & fz.F_STRAND) != 0) == rev)
            assert set((w0[on] % 16).tolist()) == set(range(16))


@pytest.mark.parametrize("n_out", [0, 1, 2])
@pytest.mark.parametrize("n_sup", [0, 1, 2])
def test_select_window_every_instance_equals_plain_version(cuda, n_sup, n_out):
    """Each of B6b's nine (n_sup, n_out) template instances against
    _select_ref at P = 1,025: every Selection field bit for bit."""
    _, _, dchains, dev_in, kw = _flush_inputs(cuda, 1025, 160, 100, n_sup, 40 + 3 * n_sup + n_out)
    kw["max_segments"] = n_out + 1
    fz.reset_launch_counts()
    sel = fz.select_window_cuda(dchains, *dev_in, **kw)
    ref = fz._select_ref(fz._flatten_chains(dchains), *dev_in, **kw)
    torch.cuda.synchronize()
    assert fz.launch_counts()["select_window"] == 1
    for name in ref._fields[:-1]:
        assert torch.equal(getattr(sel, name).to(getattr(ref, name).dtype), getattr(ref, name)), name


# --- the match stage's epilogues: accumulate, keep, merge (B1/B2, B5d) ---------

ACC_SHAPES = [
    # (S, Wp, Q, K, H, r0, r1): the chunked pass's B2 instance (K % 32 == 0,
    # H = 1) with windows at the start, middle and end, one row; B1's (K %
    # 32 != 0), H > 1 (a slot counts only when all its rows are in the
    # window), many queries a block (Wp = 3), words looped over (Wp = 300),
    # the main path's width at Q past the SM count
    (1000, 68, 50, 128, 1, 0, 400),
    (1000, 68, 50, 128, 1, 400, 800),
    (1000, 68, 50, 128, 1, 800, 1000),
    (1000, 68, 50, 64, 1, 517, 518),
    (1000, 68, 50, 120, 1, 100, 900),
    (500, 68, 40, 96, 3, 0, 300),
    (100, 3, 370, 64, 1, 30, 70),
    (500, 300, 9, 512, 1, 200, 500),
    (3000, 68, 2049, 128, 1, 1000, 2500),
]


def _acc_case(cuda, s, wp, q, k, h, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    words = torch.randint(-(2**31), 2**31, (s, wp), dtype=torch.int32, device=cuda, generator=g)
    rows = torch.randint(0, s, (q, k, h), dtype=torch.int32, device=cuda, generator=g)
    rows[:, k // 2 :] = 1 << 30  # padding slots (the chunked matcher's pad row)
    rows[0, :3] = -5  # rows outside every window
    acc = torch.randint(0, 1000, (q, 32 * wp), dtype=torch.int32, device=cuda, generator=g)
    return words, rows, acc


@pytest.mark.parametrize("s,wp,q,k,h,r0,r1", ACC_SHAPES)
def test_match_scores_acc_equals_plain_version(cuda, s, wp, q, k, h, r0, r1):
    """The accumulating instance of B1/B2 on a block holding rows [r0, r1)
    (a buffer with more rows than the window, as the chunked pass's last
    block is) adds what match_scores_acc_ref_ adds, bit for bit, in one
    launch; and the blocks of a whole pass add up to B1/B2's scores on the
    whole index."""
    words, rows, acc = _acc_case(cuda, s, wp, q, k, h, s + wp + q + k + r0)
    block = torch.cat([words[r0:r1], torch.full((7, wp), -1, dtype=torch.int32, device=cuda)])
    want = opm.match_scores_acc_ref_(acc.clone(), block, rows, r0, r1)
    before = opm.launch_counts()["match_popcount_acc"]
    got = opm.match_scores_acc_(acc, block, rows, r0, r1)
    torch.cuda.synchronize()
    assert got is acc and torch.equal(acc, want)
    assert opm.launch_counts()["match_popcount_acc"] == before + 1
    if h == 1:  # a slot of H > 1 rows may straddle two blocks
        whole = torch.zeros_like(acc)
        for a in range(0, s, 317):
            opm.match_scores_acc_(whole, words[a : a + 317].contiguous(), rows, a, min(a + 317, s))
        padded = torch.cat([words, torch.zeros((1, wp), dtype=torch.int32, device=cuda)])
        resident = torch.where((rows >= 0) & (rows < s), rows, s)
        assert torch.equal(whole, opm.match_scores_ref(padded, resident))


@pytest.mark.parametrize(
    "threads,stage_bytes,out_bytes",
    [(128, 48 * 1024, 1024), (256, 256, 48 * 1024), (128, 48 * 1024, 48 * 1024)],
)
def test_match_scores_acc_geometries(cuda, monkeypatch, threads, stage_bytes, out_bytes):
    """The accumulating epilogue through shared memory and straight to
    device memory, indices staged and read in place."""
    monkeypatch.setattr(opm, "BLOCK_THREADS", threads)
    monkeypatch.setattr(opm, "STAGE_BYTES", stage_bytes)
    monkeypatch.setattr(opm, "OUT_BYTES", out_bytes)
    for s, wp, q, k, h, r0, r1 in ((500, 300, 40, 37, 3, 50, 450), (3000, 68, 300, 128, 1, 7, 2999),
                                   (3000, 3, 1000, 64, 1, 0, 3000)):
        words, rows, acc = _acc_case(cuda, s, wp, q, k, h, q + k)
        block = words[r0:r1].contiguous()
        want = opm.match_scores_acc_ref_(acc.clone(), block, rows, r0, r1)
        assert torch.equal(opm.match_scores_acc_(acc, block, rows, r0, r1), want)


def test_match_scores_acc_refuses_bad_arguments(cuda):
    """An acc off 16 bytes, of another shape, or a window the block does not
    hold is refused before any launch."""
    words, rows, acc = _acc_case(cuda, 100, 4, 6, 32, 1, 1)
    before = opm.launch_counts()
    flat = torch.zeros(6 * 128 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        opm.match_scores_acc_(flat[1:].view(6, 128), words, rows, 0, 100)
    with pytest.raises(ValueError, match="acc must be"):
        opm.match_scores_acc_(acc[:, :64], words, rows, 0, 100)
    with pytest.raises(ValueError, match="rows"):
        opm.match_scores_acc_(acc, words, rows, 0, 101)
    with pytest.raises(ValueError, match="rows"):
        opm.match_scores_acc_(acc, words, rows, 5, 5)
    assert opm.launch_counts() == before


@pytest.mark.parametrize("mode", ["first", "middle", "last", "only"])
@pytest.mark.parametrize("s,wp,q,k,h,r0,r1", ACC_SHAPES)
def test_match_scores_acc_planes_equal_plain_version(cuda, s, wp, q, k, h, r0, r1, mode):
    """Each block mode of the row-chunked pass (the counts kept as
    bit_length(K) bit planes in the accumulator's words between blocks)
    bit for bit against match_scores_acc_planes_ref_, every int32 of the
    accumulator included, in one launch; a middle block's planes are the
    earlier ones' sum with the block's."""
    words, rows, acc = _acc_case(cuda, s, wp, q, k, h, s + wp + q + k + r0 + 1)
    planes = opm.b2_planes(k)
    before = torch.randint(0, 2**planes - k, acc.shape, dtype=torch.int32, device=cuda)
    acc.view(q, wp, 32)[..., :planes] = opm.encode_planes(before, planes)
    block = torch.cat([words[r0:r1], torch.full((7, wp), -1, dtype=torch.int32, device=cuda)])
    first, last = mode in ("first", "only"), mode in ("last", "only")
    want = opm.match_scores_acc_planes_ref_(acc.clone(), block, rows, r0, r1, first, last)
    n = opm.launch_counts()["match_popcount_acc"]
    got = opm.match_scores_acc_planes_(acc, block, rows, r0, r1, first, last)
    torch.cuda.synchronize()
    assert got is acc and torch.equal(acc, want)
    assert opm.launch_counts()["match_popcount_acc"] == n + 1
    if not first:
        block_counts = opm.match_scores_acc_ref_(torch.zeros_like(acc), block, rows, r0, r1)
        total = opm.decode_planes(acc.view(q, wp, 32)[..., :planes]) if not last else acc
        assert torch.equal(total, before + block_counts)


def test_match_scores_acc_planes_refuses_bad_arguments(cuda):
    """The plane modes refuse what the int32 mode refuses, and K * H = 0."""
    words, rows, acc = _acc_case(cuda, 100, 4, 6, 32, 1, 1)
    before = opm.launch_counts()
    with pytest.raises(ValueError, match="acc must be"):
        opm.match_scores_acc_planes_(acc[:, :64], words, rows, 0, 100, True, False)
    with pytest.raises(ValueError, match="rows"):
        opm.match_scores_acc_planes_(acc, words, rows, 0, 101, False, True)
    with pytest.raises(ValueError, match="K \\* H > 0"):
        opm.match_scores_acc_planes_(acc, words, rows[:, :0], 0, 100, True, True)
    assert opm.launch_counts() == before


def test_stream_blocks_pass_equals_b2_on_the_resident_index(cuda, monkeypatch):
    """A whole _stream_blocks pass (first, middle and last blocks through
    the plane modes, 4 blocks on the double buffer and a ring of 3 slots)
    at the main path's width equals B2 on the whole index with its zero
    row; a one-block pass (only) too."""
    monkeypatch.setattr(tm, "STAGE_SLOT_BYTES", 3001 * 68 * 4)
    monkeypatch.setattr(tm, "STAGE_SLOTS", 3)
    rng = np.random.default_rng(14)
    s, wp, q, k = 40_000, 68, 700, 128
    words = rng.integers(0, 2**32, (s, wp), dtype=np.uint32) & rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    rows = rng.integers(0, s, (q, k, 1)).astype(np.int32)
    rows[:, 120:] = 1 << 30
    # every 9th query's 128 slots in the first two blocks, on rows whose
    # word 0 has bit 0 set: that count reaches 128, plane 7, by a middle
    # block's carry
    rows[::9] = rng.integers(0, 20_000, rows[::9].shape)
    words[:20_000, 0] |= 1
    padded = torch.from_numpy(np.concatenate([words, np.zeros((1, wp), np.uint32)]).view(np.int32)).to(cuda)
    want = opm.match_scores_b2(padded, torch.from_numpy(np.where(rows == 1 << 30, s, rows)).to(cuda))
    for chunk in (10_000, s):
        cm = tm.ChunkedMatcher(term_size=31, num_hashes=1, signature_size=s, doc_names=[str(d) for d in range(32 * wp)],
                               words_host=words, row_chunk=chunk, device=cuda)
        n = opm.launch_counts()["match_popcount_acc"]
        got = cm._score_pass(rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert opm.launch_counts()["match_popcount_acc"] == n + -(-s // chunk)
    assert int(want.max()) == k


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("s,wp,q,k,h,thr", [(3000, 40, 300, 128, 1, 0.3), (3000, 40, 300, 96, 3, 0.02),
                                            (1000, 3, 700, 64, 1, 0.55), (500, 60, 9, 120, 1, 0.0),
                                            (500, 5, 40, 33, 2, 0.05)])
def test_match_scores_keep_split_equals_plain_version(cuda, monkeypatch, s, wp, q, k, h, thr, split):
    """The keep instance with each (query, word) over 1, 2 and 4 threads
    (their planes summed through shuffles; K off the 8-slot group gives a
    short or empty last share): scores and keep bit for bit against
    match_scores_keep_ref, in one launch. Each split is reached by the
    card's thread count keep_split reads: Q's grid split that many times
    is one wave."""
    wt = opm.launch_geometry(wp, k, h)[1]
    monkeypatch.setattr(opm, "resident_threads", lambda device: q * -(-wp // wt) * wt * split)
    assert opm.keep_split(wp, k, h, q, opm.resident_threads(cuda)) == split
    g = torch.Generator(device=cuda).manual_seed(q + k + h + split)
    words = torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=g)
    words &= torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=g)
    words[s] = 0
    rows = torch.randint(0, s, (q, k, h), dtype=torch.int32, device=cuda, generator=g)
    nk = torch.randint(0, k + 1, (q,), dtype=torch.int32, device=cuda, generator=g)
    nk[::5] = 0
    rows[torch.arange(k, device=cuda)[None, :] >= nk[:, None]] = s
    n = opm.launch_counts()["match_popcount_keep"]
    scores, keep = opm.match_scores_keep(words, rows, nk, thr)
    torch.cuda.synchronize()
    assert opm.launch_counts()["match_popcount_keep"] == n + 1
    want = opm.match_scores_keep_ref(words, rows, nk, thr)
    assert torch.equal(scores, want[0]) and torch.equal(keep, want[1])


@pytest.mark.parametrize("s,wp,q,k,h,thr", [(3000, 68, 300, 128, 1, 0.3), (3000, 68, 300, 96, 3, 0.02),
                                            (1000, 3, 700, 64, 1, 0.55), (500, 300, 9, 120, 1, 0.0)])
def test_match_scores_keep_equals_plain_version(cuda, s, wp, q, k, h, thr):
    """The keep instance: scores and keep bit for bit against
    match_scores_keep_ref (scores on the float32 cut, queries without
    k-mers, a threshold of 0)."""
    g = torch.Generator(device=cuda).manual_seed(q + k + h)
    words = torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=g)
    words &= torch.randint(-(2**31), 2**31, (s + 1, wp), dtype=torch.int32, device=cuda, generator=g)
    words[s] = 0
    rows = torch.randint(0, s, (q, k, h), dtype=torch.int32, device=cuda, generator=g)
    nk = torch.randint(0, k + 1, (q,), dtype=torch.int32, device=cuda, generator=g)
    nk[::5] = 0
    rows[torch.arange(k, device=cuda)[None, :] >= nk[:, None]] = s
    scores, keep = opm.match_scores_keep(words, rows, nk, thr)
    want = opm.match_scores_keep_ref(words, rows, nk, thr)
    assert torch.equal(scores, want[0]) and torch.equal(keep, want[1])
    assert keep.any() or thr > 0.1
    with pytest.raises(ValueError, match="n_kmers"):
        opm.match_scores_keep(words, rows, nk[:-1], thr)


def _windows(gen, dev, q, widths, lims, tie_vals, empty=()):
    """Per-shard windows as B5b leaves them: a threshold + top-k of random
    (tie-heavy) scores, by the plain version; shards in ``empty`` have
    none."""
    out = []
    for e, (w, lim) in enumerate(zip(widths, lims)):
        if e in empty:
            out.append((torch.empty((q, 0), dtype=torch.int32, device=dev),) * 2 + (None,))
            continue
        sc = torch.randint(0, tie_vals, (q, max(w, 4)), dtype=torch.int32, device=dev, generator=gen)
        cut = torch.randint(0, tie_vals, (q,), dtype=torch.int32, device=dev, generator=gen)
        v, i, n = tm._topk_scores_ref(sc, cut, lim, w)
        out.append((v.contiguous(), i.contiguous(), n))
    return out


@pytest.mark.parametrize(
    "q,nd,w_loc,kk,tie_vals,empty",
    [(50, 2, 64, 32, 4, ()), (50, 4, 64, 160, 3, (3,)), (9, 1, 300, 64, 50, ()),
     (300, 16, 32, 40, 2, (5, 6)), (9216, 2, 1088, 160, 60, ()), (20, 3, 8, 64, 2, (0, 1, 2)),
     # 16 x 64 entries a row, each ranked by 15 binary searches (blocks of
     # 8 rows: Q >= 8 x 132)
     (1100, 16, 64, 64, 2, ()),
     # kk odd: blocks of one row, rows at every word offset
     (37, 2, 100, 33, 5, ()),
     # Q not a multiple of the block's 8 rows
     (1061, 2, 64, 40, 4, ()),
     # 16 shards, kk odd, blocks of 8 rows
     (1100, 16, 24, 45, 3, (4,)),
     # kk past a warp's slice: chunks of output ranks
     (1100, 2, 600, 521, 50, ()),
     # rows using at most 4 of each shard (ranked from their heads) beside
     # rows using more
     (1100, 2, 16, 32, 10, ())],
)
def test_merge_topk_equals_plain_version(cuda, q, nd, w_loc, kk, tie_vals, empty):
    """B5d against _merge_topk_ref bit for bit: long tie runs across the
    shards, empty shards, a window wider than the takes (kk > w_loc), the
    main path's 2 shards of 1,088 columns at kk = 160; the kernel's edges:
    16 shards, rows off a 16-byte boundary, a last block short of rows, a
    chunked output, rows ranked from their heads."""
    gen = torch.Generator(device=cuda).manual_seed(q + nd)
    lims = [0 if e in empty else min(kk, w_loc) for e in range(nd)]
    wins = _windows(gen, cuda, q, [w_loc] * nd, lims, tie_vals, empty)
    kk_out = min(kk, nd * min(kk, w_loc))
    before = tm.launch_counts()["merge_topk"]
    got = tm.merge_topk_cuda(wins, lims, w_loc, kk_out)
    torch.cuda.synchronize()
    assert tm.launch_counts()["merge_topk"] == before + 1
    want = tm._merge_topk_ref(wins, lims, w_loc, kk_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nd", [2, 5])
def test_merge_topk_every_row_empty(cuda, nd):
    """No row takes anything (a cut above every score): B5d writes fillers
    only and n_keep 0, as _merge_topk_ref does."""
    gen = torch.Generator(device=cuda).manual_seed(nd)
    wins = []
    for _ in range(nd):
        sc = torch.randint(0, 4, (1500, 30), dtype=torch.int32, device=cuda, generator=gen)
        wins.append(tm._topk_scores_ref(sc, torch.full((1500,), 4, dtype=torch.int32, device=cuda), 21, 30))
    got = tm.merge_topk_cuda(wins, [21] * nd, 30, 21)
    want = tm._merge_topk_ref(wins, [21] * nd, 30, 21)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0] == -1).all() and (got[2] == 0).all()


def test_dist_topk_on_card_equals_cpu(cuda):
    """dist_topk and dist_threshold_topk on 2x2 and 4x1 meshes over the one
    card equal the CPU meshes word for word (B5b per shard, B5d per column),
    with a shard wholly past d."""
    from phylign_tpu_torch.parallel import dist
    from phylign_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    s, wp, q, k = 400, 32, 16, 64
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = rng.integers(0, 2**32, (s, wp), dtype=np.uint32) & rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    rows = rng.integers(0, s, (q, k, 1)).astype(np.int32)
    cut = rng.integers(10, 20, q).astype(np.int32)
    cut[3] = 1 << 30
    w32 = words.view(np.int32)
    for nd, nq in ((2, 2), (4, 1)):
        res = {}
        tm.reset_launch_counts()
        for dev in ("cpu", "cuda"):
            mesh = make_mesh(nd, nq, devices=dev if dev == "cpu" else ["cuda:0"] * (nd * nq))
            scores = dist.dist_match_scores(mesh, w32, rows)
            res[dev] = [dist.fetch(x) for x in (*dist.dist_topk(mesh, scores, n_best=4),
                                                *dist.dist_threshold_topk(mesh, w32, rows, cut, 600, 48))]
        for a, b in zip(res["cpu"], res["cuda"]):
            np.testing.assert_array_equal(a, b)
        counts = tm.launch_counts()
        # d = 600: no launch for the last shard at nd = 4 (its columns start
        # at 768), a partial window on the shard holding column 599
        assert counts["threshold_topk"] == nd * nq + (nd - (nd == 4)) * nq
        assert counts["merge_topk"] == 2 * nq


def test_chunked_pass_on_card_equals_cpu(cuda, monkeypatch):
    """ChunkedMatcher on the card with the double buffer: blocks of a
    third of the index through a ring of 3 slots of 37 rows (several
    slots a block, the ring wrapping) give the CPU pass's accumulator and
    hit lists; the accumulating kernel ran once a block."""
    from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq

    monkeypatch.setattr(tm, "STAGE_SLOT_BYTES", 37 * 4 * 3)
    monkeypatch.setattr(tm, "STAGE_SLOTS", 3)
    didx, seqs = _planted_index()
    raw = cobs_kmer_hashes_batch([encode_seq(x) for x in seqs], 31, 1)
    s, w = np.asarray(didx.words).shape
    assert w == 3
    res = {}
    for dev in ("cpu", cuda):
        cm = tm.ChunkedMatcher.from_device_index(didx, 1, device=dev)
        cm.row_chunk = -(-s // 3)
        rows = [tm.rows_from_hashes(r, cm.signature_size) for r in raw]
        packed, _ = opm.pack_row_indices(rows, 128, cm.pad_row)
        opm.reset_launch_counts()
        acc = cm._score_pass(packed).cpu()
        launched = opm.launch_counts()["match_popcount_acc"]
        res[str(dev)] = (acc, cm.score_hits_raw(raw, 0.7, 5), launched)
    assert torch.equal(res["cpu"][0], res[str(cuda)][0])
    assert res["cpu"][1][0] == res[str(cuda)][1][0]
    np.testing.assert_array_equal(res["cpu"][1][1], res[str(cuda)][1][1])
    assert res["cpu"][2] == 0 and res[str(cuda)][2] == 3

