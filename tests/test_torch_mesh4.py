"""The match stage on a doc-sharded mesh, the deployment of the benchmark
cell sr-reads.match-4gpu (mesh_shape 4x1): the layout of a batch's word
columns over the doc shards (``models/matcher.DocShards``) gives every
shard documents; the mesh's hash path (``parallel/dist.dist_hash_topk_flat``)
equals the one-device hash path, and the pipelined loop runs it; the mesh's
03_match and 04_filter equal the one-device run's and the plain reference's
(``gpubench/reference/cobs_ref.py``); the mesh's counters. On a machine with
four cards (no jax there, so the repo's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_mesh4.py
"""

import gzip
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phylign_tpu_torch import testing as ttesting
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.io.cobs import DeviceIndex
from phylign_tpu_torch.models.matcher import DeviceQueryHashes, DocShards, Matcher, device_index_bytes
from phylign_tpu_torch.parallel.mesh import Mesh, make_mesh
from phylign_tpu_torch.pipeline.stages import Pipeline
from phylign_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _index(rng, s: int, w: int, d: int) -> DeviceIndex:
    """A 1-hash index of ``d`` documents over ``s`` random Bloom rows of
    ``w`` words (the bits past d clear)."""
    words = rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    if d < 32 * w:
        words[:, -1] &= np.uint32((1 << (d - 32 * (w - 1))) - 1)
    return DeviceIndex(term_size=31, num_hashes=1, signature_size=s,
                       doc_names=[f"{i:04d}_SAMD{i:05d}" for i in range(d)], words=words)


def _widths(nd: int, which: str) -> list[int]:
    return [68] if which == "68" else list(range(nd, 8 * nd))


@pytest.mark.parametrize("which", ["68", "below 8 x nd"])
@pytest.mark.parametrize("nd", [2, 3, 4])
def test_every_shard_holds_documents(nd, which):
    """For each width, the shards' real words are a balanced split of the
    batch's words, each shard holds at least one, the padding is under one
    word a shard, and the uploaded blocks are the batch's columns then
    zeros, as many bytes as device_index_bytes says. The JAX layout (8
    words a shard, W rounded up to 8 x nd) leaves a shard only padding at
    some of these widths."""
    rng = np.random.default_rng(nd)
    mesh = make_mesh(nd, 1, devices=["cpu"] * nd)
    jax_padding_only = 0
    for w in _widths(nd, which):
        sh = DocShards.of(w, nd)
        assert sum(sh.words) == w and min(sh.words) >= 1 and max(sh.words) - min(sh.words) <= 1
        assert sh.width == -(-w // nd) and sh.padding_words == nd * sh.width - w < nd
        assert sh.starts == tuple(int(x) for x in np.cumsum((0,) + sh.words[:-1]))
        jax_padding_only += any(e * 8 * -(-w // (8 * nd)) >= w for e in range(nd))
        d = 32 * w - 5
        didx = _index(rng, 7, w, d)
        trace.reset()
        mat = Matcher.from_device_index(didx, "cpu", mesh=mesh)
        blocks = [mat.words.at(e, 0).numpy().view(np.uint32) for e in range(nd)]
        assert sum(b.nbytes for b in blocks) == device_index_bytes(didx, mesh=mesh)
        for e, (b, s0, n) in enumerate(zip(blocks, sh.starts, sh.words)):
            assert b.shape == (8, sh.width)
            np.testing.assert_array_equal(b[:7, :n], didx.words[:, s0 : s0 + n])
            assert not b[:, n:].any() and not b[7].any()
        counts = trace.snapshot()["counts"]
        assert counts["match.mesh_shards"] == nd
        assert counts["match.mesh_padding_words"] == sh.padding_words
        # the padded matrix's columns of the documents, in order
        bits = np.unpackbits(np.concatenate(blocks, axis=1)[:7].view(np.uint8), axis=1, bitorder="little")
        cols = sh.columns(d)
        got = bits if cols is None else bits[:, cols]
        want = np.unpackbits(didx.words.view(np.uint8), axis=1, bitorder="little")[:, :d]
        np.testing.assert_array_equal(got[:, :d], want)
        assert [n for n in sh.docs(d)] == [min(32 * n, d - 32 * s) for s, n in zip(sh.starts, sh.words)]
    trace.reset()
    if which != "68":
        assert jax_padding_only > 0


def test_no_padding_at_the_cells_width():
    """68 words over four shards: 17 words a card, no zero word uploaded,
    the documents the padded matrix's first columns."""
    didx = _index(np.random.default_rng(0), 5, 68, 2169)
    sh = DocShards.of(68, 4)
    assert sh.width == 17 and sh.words == (17,) * 4 and sh.columns(2169) is None
    assert sh.docs(2169) == [544, 544, 544, 537]
    trace.reset()
    Matcher.from_device_index(didx, "cpu", mesh=make_mesh(4, 1, devices=["cpu"] * 4))
    counts = trace.snapshot()["counts"]
    trace.reset()
    assert counts["match.mesh_padding_words"] == 0 and counts["match.mesh_shards"] == 4
    assert device_index_bytes(didx, mesh=make_mesh(4, 1, devices="cpu")) == 6 * 68 * 4


def _planted(rng, s: int, w: int, d: int, q: int):
    """A random index (1/4 of the bits set) and ``q`` queries of 120 raw
    hashes, each planted whole or in part in a few documents, a few in
    more than the window holds (re-scored on the dense path), one in
    none."""
    words = rng.integers(0, 2**32, (s, w), dtype=np.uint32) & rng.integers(0, 2**32, (s, w), dtype=np.uint32)
    raw = [rng.integers(0, 2**62, (120, 1), dtype=np.int64).astype(np.uint64) for _ in range(q)]
    for i, h in enumerate(raw):
        rows = (h[:, 0] % np.uint64(s)).astype(np.int64)
        n = 0 if i == 5 else min(200, d) if i % 97 == 3 else int(rng.integers(1, min(40, d // 20)))
        for doc in rng.choice(d, n, replace=False):
            part = rows if rng.random() < 0.5 else rows[: int(rng.integers(84, 120))]
            words[part, doc // 32] |= np.uint32(1 << (doc % 32))
    words[:, -1] &= np.uint32((1 << (d - 32 * (w - 1))) - 1)
    didx = DeviceIndex(term_size=31, num_hashes=1, signature_size=s,
                       doc_names=[f"{i:04d}_SAMD{i:05d}" for i in range(d)], words=words)
    return didx, raw


def _hits_equal(mesh_devices, one_device, w: int = 68, d: int = 2169):
    didx, raw = _planted(np.random.default_rng(w), 20_011, w, d, 600)
    want = Matcher.from_device_index(didx, one_device).score_hits_raw(raw, 0.7, topn=100)
    mesh = make_mesh(len(mesh_devices), 1, devices=mesh_devices)
    trace.reset()
    got = Matcher.from_device_index(didx, one_device, mesh=mesh).score_hits_raw(raw, 0.7, topn=100)
    counts = trace.snapshot()["counts"]
    trace.reset()
    assert list(got[1]) == list(want[1])
    for a, b in zip(got[0], want[0]):
        assert sorted(a, key=lambda t: (-t[1], t[0])) == sorted(b, key=lambda t: (-t[1], t[0]))
    assert want[1][5] == 0 and max(want[1]) >= min(200, d) and sum(len(h) for h in want[0]) > 600
    return counts


@pytest.mark.parametrize("nd,w", [(4, 68), (4, 5), (3, 10), (2, 17)])
def test_mesh_hits_equal_one_device(nd, w):
    """score_hits_raw over an nd x 1 mesh of the CPU equals the one-device
    run hit for hit: at the cell's width, and at widths whose balanced
    split is not the contiguous one (the windows' columns mapped back to
    documents)."""
    counts = _hits_equal(["cpu"] * nd, "cpu", w, 32 * w - 3)
    assert counts["match.mesh_gather_bytes"] == 0  # one device: nothing copied


@pytest.mark.cuda
def test_mesh_hits_on_four_cards_equal_one_card():
    """score_hits_raw over a 4x1 mesh of cuda:0-cuda:3 equals the one-card
    run: B2 and B5b on each card, the windows copied to cuda:0 and merged
    there by B5d."""
    from phylign_tpu_torch.models import matcher as tm
    from phylign_tpu_torch.ops import match as opm

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    cards = [f"cuda:{i}" for i in range(4)]
    b2, b5 = opm.launch_counts(), tm.launch_counts()
    counts = _hits_equal(cards, torch.device("cuda:0"))
    for i in range(4):
        torch.cuda.synchronize(i)
    assert opm.launch_counts()["match_popcount_b2"] - b2["match_popcount_b2"] >= 4 + 1
    assert tm.launch_counts()["merge_topk"] - b5["merge_topk"] >= 1
    assert counts["match.mesh_gather_bytes"] > 0


def _hash_hits_equal(mesh_devices, one_device, w: int, d: int, topn: int = 100, cap=None):
    """score_hits_hashes_begin/_end on an nd x 1 mesh of ``mesh_devices``
    against score_hits_hashes on ``one_device``, hit for hit and count for
    count; the query hashes uploaded once to ``one_device``. Returns the
    mesh run's counters."""
    didx, raw = _planted(np.random.default_rng(w), 20_011, w, d, 600)
    dq = DeviceQueryHashes.build(raw, one_device)
    want = Matcher.from_device_index(didx, one_device).score_hits_hashes(dq, 0.7, topn)
    mat = Matcher.from_device_index(didx, one_device, mesh=make_mesh(len(mesh_devices), 1, devices=mesh_devices))
    trace.reset()
    ctx = mat.score_hits_hashes_begin(dq, 0.7, topn, cap=cap)
    assert ctx is not None
    got = mat.score_hits_hashes_end(ctx)
    counts = trace.snapshot()["counts"]
    trace.reset()
    assert list(got[1]) == list(want[1])
    assert len(got[0]) == len(want[0]) == 600
    for a, b in zip(got[0], want[0]):
        assert sorted(a, key=lambda t: (-t[1], t[0])) == sorted(b, key=lambda t: (-t[1], t[0]))
    assert want[1][5] == 0 and sum(len(h) for h in want[0]) > 600
    assert counts["match.mesh_hash_chunks"] == 1
    return counts


@pytest.mark.parametrize(
    "nd,w,case",
    [(4, 68, "widths"), (4, 5, "widths"), (3, 10, "widths"), (2, 17, "widths"),
     (4, 68, "cap overflow"), (3, 10, "window overflow")],
)
def test_mesh_hash_path_equals_one_device(nd, w, case):
    """The hash path on an nd x 1 mesh of the CPU (B5a, B2, B5b on each
    shard, B5d, then B5c on the home device) equals the one-device hash
    path: at the cell's width, at widths whose columns do not map back one
    to one, with a cap the hits overflow (the mesh's dense window), and
    with a window (topn 1: 64 documents) that queries overflow (re-scored
    by score_rows)."""
    topn, cap = (1, None) if case == "window overflow" else (100, 256 if case == "cap overflow" else None)
    counts = _hash_hits_equal(["cpu"] * nd, "cpu", w, 32 * w - 3, topn, cap)
    assert (counts.get("match.cap_overflows", 0) > 0) == (case == "cap overflow")
    if case == "window overflow":
        assert counts["match.redo_queries"] > 0


def test_spanning_mesh_keeps_the_serial_route():
    """A mesh over processes takes no hash dispatch: its ranks gather in
    batch order on match_one_batch's route."""
    didx, raw = _planted(np.random.default_rng(3), 101, 2, 50, 8)
    spanning = Mesh(2, 1, (torch.device("cpu"),), rank=0, world=2, group=object())
    mat = Matcher.from_device_index(didx, "cpu", mesh=spanning)
    assert mat.score_hits_hashes_begin(DeviceQueryHashes.build(raw, "cpu"), 0.7, 100) is None


def test_mesh_pipeline_runs_the_pipelined_loop(tmp_path, monkeypatch):
    """Pipeline.match on a one-process 4x1 mesh of the CPU runs
    _match_pipelined to its end: one mesh hash chunk a batch, no
    match_one_batch, and 03_match as the one-device run's."""
    calls = {"pipelined": 0, "one_batch": 0}
    pipelined, one_batch = Pipeline._match_pipelined, Pipeline.match_one_batch

    def spy_pipelined(self, *a, **k):
        out = pipelined(self, *a, **k)
        calls["pipelined"] += 1
        return out

    def spy_one_batch(self, *a, **k):
        calls["one_batch"] += 1
        return one_batch(self, *a, **k)

    monkeypatch.setattr(Pipeline, "_match_pipelined", spy_pipelined)
    monkeypatch.setattr(Pipeline, "match_one_batch", spy_one_batch)
    base = tmp_path / "base"
    ttesting.make_fixture(base, n_batches=3, seed=11)
    outs = {}
    for shape, devices in (("4x1", ["cpu"] * 4), ("1x1", None)):
        wd = tmp_path / shape
        shutil.copytree(base, wd)
        cfg = Config.from_yaml(wd / "config.yaml").with_overrides(mesh_shape=shape)
        pl = Pipeline(cfg, wd, device="cpu", mesh_devices=devices)
        stem = pl.preprocess(sorted(str(p) for p in (wd / "input").iterdir()))
        trace.reset()
        pl.match(stem)
        counts = trace.snapshot()["counts"]
        trace.reset()
        outs[shape] = {k: v for k, v in _outputs(wd).items() if "03_match" in k}
        if shape == "4x1":
            assert calls == {"pipelined": 1, "one_batch": 0}
            assert counts["match.mesh_hash_chunks"] == counts["match.batches"] == 3
        else:
            assert counts.get("match.mesh_hash_chunks", 0) == 0
    assert len(outs["4x1"]) == 3 and outs["4x1"] == outs["1x1"]


@pytest.mark.cuda
def test_mesh_hash_path_on_four_cards_equals_one_card(monkeypatch):
    """The hash path on a 4x1 mesh of cuda:0-cuda:3 equals the one-card
    hash path: B5a, B2 and B5b launch on each card, B5d and B5c on cuda:0,
    the query hashes copied to each card once."""
    from phylign_tpu_torch.ops import _kernels

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    launched = []
    launch = _kernels.launch

    def spy(counts, name, *args):
        launched.append((name, next(a.device for a in args if isinstance(a, torch.Tensor))))
        return launch(counts, name, *args)

    monkeypatch.setattr(_kernels, "launch", spy)
    cards = [f"cuda:{i}" for i in range(4)]
    counts = _hash_hits_equal(cards, torch.device("cuda:0"), 68, 2169)
    for i in range(4):
        torch.cuda.synchronize(i)
    on = lambda name: {dev.index for n, dev in launched if n == name}  # noqa: E731
    assert on("hash_rows") == on("match_popcount_b2") == on("threshold_topk") == {0, 1, 2, 3}
    assert on("merge_topk") == on("pack_hits") == {0}
    assert counts["match.mesh_gather_bytes"] > 0


def _outputs(wd: Path) -> dict[str, bytes]:
    out = {}
    for d in ("intermediate/03_match", "intermediate/04_filter"):
        for p in sorted((wd / d).iterdir()):
            out[f"{d}/{p.name}"] = gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes()
    return out


def test_make_fixture_on_a_4x1_mesh_equals_one_device(tmp_path):
    """make_fixture (one word of documents a batch, fewer words than
    shards) through preprocess -> match -> filter on a 4x1 mesh of the
    CPU: 03_match and 04_filter equal the 1x1 run's byte for byte."""
    base = tmp_path / "base"
    ttesting.make_fixture(base, n_batches=3, seed=7)
    outs = {}
    for shape, devices in (("1x1", None), ("4x1", ["cpu"] * 4)):
        wd = tmp_path / shape
        shutil.copytree(base, wd)
        cfg = Config.from_yaml(wd / "config.yaml").with_overrides(mesh_shape=shape)
        pl = Pipeline(cfg, wd, device="cpu", mesh_devices=devices)
        stem = pl.preprocess(sorted(str(p) for p in (wd / "input").iterdir()))
        pl.match(stem)
        pl.filter(stem)
        assert (pl.mesh() is None) == (shape == "1x1")
        outs[shape] = _outputs(wd)
    assert len(outs["1x1"]) == 3 + 1
    assert outs["4x1"] == outs["1x1"]


@pytest.mark.parametrize("docs", [2169, 530])
def test_cell_on_the_cpu_equals_one_device_and_reference(docs, tmp_path):
    """The cell sr-reads.match-4gpu at a toy size on the CPU (a 4x1 mesh of
    the one CPU), at its 2,169 documents (17 words a shard, no padding)
    and at 530 (17 words, of which the shards hold 5, 4, 4 and 4): correct
    against the plain reference, and every job's 03_match and 04_filter
    equal the 1x1 run's of the same seed."""
    import importlib.util

    from gpubench import run

    spec_ = importlib.util.spec_from_file_location("gpubench_toy", REPO / "gpubench" / "tests" / "toy.py")
    toy = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(toy)
    outs = {}
    for shape in ("4x1", "1x1"):
        spec = toy.spec("sr-reads.match-4gpu")
        spec["config"]["index"]["docs"] = docs
        spec["config"]["config"]["mesh_shape"] = shape
        spec["config"]["config"]["device_index_cache_gb"] = 0
        work = tmp_path / shape
        res = run.run_cell(spec, 3_000_000_019, 0.01, False, "cpu", work)
        assert res["correct"], res["checks"]
        outs[shape] = {j.name: _outputs(j) for j in sorted((work / "jobs").iterdir())}
    assert len(outs["4x1"]) >= 2 and all(outs["4x1"].values())
    assert outs["4x1"] == outs["1x1"]
