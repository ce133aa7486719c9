"""The hand-written CUDA kernels and the port's match stage on an NVIDIA
GPU. Every test here needs the card: it is marked ``cuda`` and skips
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
