"""The hand-written CUDA kernels (B1/B2 of the match stage, B3/B4 of the
align stage) and the port's pipeline on an NVIDIA GPU. Every test here needs the card: it is marked ``cuda`` and skips
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


def test_hash_topk_flat_equals_cpu(cuda):
    rng = np.random.default_rng(0)
    s, wp, q, k = 997, 3, 40, 64
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    raw = rng.integers(0, 2**64, (q, k, 1), dtype=np.uint64)
    nk = rng.integers(40, k + 1, q).astype(np.int32)
    cut = tm._int_cut(0.45, nk)
    args = [
        words.view(np.int32), (raw >> np.uint64(32)).astype(np.int64),
        (raw & np.uint64(0xFFFFFFFF)).astype(np.int64), nk, cut,
    ]
    kw = dict(s=s, pad_row=s, kk=96, d=96, cap=q * 96)  # kk = d: no ties cut
    out = [
        tm._hash_topk_flat(*[torch.from_numpy(a).to(dev) for a in args], **kw).cpu().numpy()
        for dev in ("cpu", cuda)
    ]
    cap = kw["cap"]
    np.testing.assert_array_equal(out[1][cap:], out[0][cap:])  # n_keep, total
    take = out[0][cap : cap + q]
    offs = np.cumsum(take) - take
    for i in range(q):
        seg = slice(offs[i], offs[i] + take[i])
        assert sorted(out[1][seg]) == sorted(out[0][seg])


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
        if dev == "cuda":
            assert all(counts.values()), counts
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
    for bad in (ope.SrScoring(match=2.5), ope.SrScoring(gap_ext2=0.5), ope.SrScoring(mismatch=300)):
        with pytest.raises(ValueError, match="integer|signed byte"):
            ope.extend_cuda(q, ql, w, w, bad)


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
