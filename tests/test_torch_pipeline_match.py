"""The port's match stage end to end on the CPU against the JAX package's:
``Pipeline(device="cpu")`` runs preprocess -> match -> filter on the
synthetic fixture (two 1-hash batches plus one 3-hash batch) and every
``03_match`` file (decompressed) and the ``04_filter`` FASTA must be
byte-identical to the JAX ``Pipeline``'s on the same inputs, on the
pipelined path, the job path (match_one_batch), the row-chunked path and
the dedup path. Each side builds its own Config from the same YAML and
reads the same index files. The batches' word widths (1 and 6 words) are
not multiples of 4. A last test permutes every top-k window on the device
and expects the same bytes: nothing downstream depends on the tie order of
``torch.topk``.
"""

import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from phylign_tpu import testing as fixture_mod
from phylign_tpu.config import Config as JaxConfig
from phylign_tpu.io import cobs as iocobs
from phylign_tpu.io.fastx import read_fastx_file
from phylign_tpu.pipeline.stages import Pipeline as JaxPipeline
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.models import matcher as tm
from phylign_tpu_torch.pipeline.stages import Pipeline as TorchPipeline

PATHS = ["pipelined", "job", "chunked", "dedup"]


def add_multi_hash_batch(wd: Path, name: str = "synthetic_h3__01", seed: int = 5):
    """A 3-hash batch whose genomes carry some of the fixture's reads."""
    rng = np.random.default_rng(seed)
    reads = [
        r.seq.encode()
        for p in sorted((wd / "input").iterdir())
        for r in read_fastx_file(p)
    ]
    docs = []
    for g in range(5):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000))
        planted = b"".join(reads[i] for i in range(g, len(reads), 9))
        docs.append((f"{g:04d}_SAMH{g:05d}", [seq[:1500] + planted + seq[1500:]]))
    idx = iocobs.build_classic_index(docs, term_size=31, num_hashes=3, fpr=0.1)
    iocobs.write_classic_index(wd / "cobs" / f"{name}.cobs_classic.xz", idx)
    with open(wd / "data" / "batches_small.txt", "a") as f:
        f.write(name + "\n")


def add_wide_batch(wd: Path, name: str = "synthetic_wide__01", n_docs: int = 170, seed: int = 6):
    """A 1-hash batch of 170 short genomes (Wp = 6 words), some carrying
    fixture reads, so doc columns past the first word are exercised."""
    rng = np.random.default_rng(seed)
    reads = [
        r.seq.encode()
        for p in sorted((wd / "input").iterdir())
        for r in read_fastx_file(p)
    ]
    docs = []
    for g in range(n_docs):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 400))
        if g % 23 == 5:
            seq = seq[:200] + reads[g % len(reads)] + seq[200:]
        docs.append((f"{g:04d}_SAMW{g:05d}", [seq]))
    idx = iocobs.build_classic_index(docs, term_size=31, num_hashes=1, fpr=0.1)
    iocobs.write_classic_index(wd / "cobs" / f"{name}.cobs_classic.xz", idx)
    with open(wd / "data" / "batches_small.txt", "a") as f:
        f.write(name + "\n")


@pytest.fixture(scope="module")
def base(tmp_path_factory) -> Path:
    wd = tmp_path_factory.mktemp("torch_pipe") / "base"
    fixture_mod.make_fixture(wd, n_batches=2, seed=42)
    add_multi_hash_batch(wd)
    add_wide_batch(wd)
    return wd


def run(base: Path, dst: Path, pipeline_cls, path: str, **kw) -> dict:
    """One preprocess -> match -> filter run on a copy of ``base``; returns
    {relative path: bytes} of the 03_match (decompressed) and 04_filter
    outputs. Each package reads the YAML with its own Config."""
    wd = dst
    shutil.copytree(base, wd)
    config_cls = JaxConfig if pipeline_cls is JaxPipeline else Config
    cfg = config_cls.from_yaml(wd / "config.yaml")
    if path == "dedup":
        cfg.match_dedup = True
    if path == "chunked":
        cfg.device_index_cache_gb = 0.0
    pl = pipeline_cls(cfg, wd, **kw)
    if path == "chunked":
        # every 1-hash index is "oversized": row-chunked scoring (the
        # smallest budget a config can set is 256 MB, far above a fixture)
        pl._chunk_budget_mb = lambda: 0
    stem = pl.preprocess(sorted(str(p) for p in (wd / "input").iterdir()))
    if path == "job":
        for b in pl.batches():
            pl.match_one_batch(b, stem)
    else:
        pl.match(stem)
    pl.filter(stem)
    out = {}
    for p in sorted((wd / "intermediate" / "03_match").glob("*.gz")):
        out[f"03_match/{p.name}"] = gzip.open(p, "rb").read()
    for p in sorted((wd / "intermediate" / "04_filter").glob("*.fa")):
        out[f"04_filter/{p.name}"] = p.read_bytes()
    return out


_jax_outputs: dict = {}


def jax_output(base: Path, tmp_path: Path, path: str) -> dict:
    if path not in _jax_outputs:
        _jax_outputs[path] = run(base, tmp_path / f"jax_{path}", JaxPipeline, path)
    return _jax_outputs[path]


@pytest.mark.parametrize("path", PATHS)
def test_match_outputs_byte_identical(base, tmp_path, path, monkeypatch):
    chunked_calls = []
    if path == "chunked":
        orig = tm.ChunkedMatcher._score_pass

        def spy(self, packed):
            chunked_calls.append(packed.shape)
            return orig(self, packed)

        monkeypatch.setattr(tm.ChunkedMatcher, "_score_pass", spy)
    want = jax_output(base, tmp_path, path)
    got = run(base, tmp_path / f"torch_{path}", TorchPipeline, path, device="cpu")
    assert len(want) == 5  # 4 batches' 03_match + the 04_filter FASTA
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    # the fixture's reads do hit: the comparison is not between empty files
    assert sum(ln.startswith("_") for ln in want[next(iter(want))].decode().splitlines()) > 0
    if path == "chunked":
        assert chunked_calls, "the row-chunked path did not run"


def test_window_order_does_not_change_outputs(base, tmp_path, monkeypatch):
    """Permute every query's qualifying window entries (what a different
    tie order of torch.topk would do) on every top-k path: the 03_match
    and 04_filter bytes stay those of the JAX pipeline."""
    orig = tm._topk_scores
    permuted = []

    def reversed_windows(scores, cut, kk, d):
        """Reverse each row's first min(n_keep, kk) entries."""
        vals, idx, n_keep = orig(scores, cut, kk, d)
        take = torch.clamp(n_keep, max=kk).to(torch.int64)[:, None]
        col = torch.arange(kk)[None, :]
        order = torch.where(col < take, take - 1 - col, col)
        permuted.append(int((take >= 2).sum()))
        return vals.gather(1, order), idx.gather(1, order), n_keep

    monkeypatch.setattr(tm, "_topk_scores", reversed_windows)
    want = jax_output(base, tmp_path, "pipelined")
    got = run(base, tmp_path / "torch_perm", TorchPipeline, "pipelined", device="cpu")
    assert sum(permuted) > 0, "no window held two hits to permute"
    assert got == want


def test_cpu_pipeline_refuses_cuda_without_a_card(base):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config.from_yaml(base / "config.yaml")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchPipeline(cfg, base)


def test_second_run_hits_the_device_index_cache(base, tmp_path):
    """A second Pipeline over the same batches (fresh workdir, same index
    content) takes every index from the process-wide device cache: no new
    upload, same bytes."""
    first = run(base, tmp_path / "torch_c1", TorchPipeline, "pipelined", device="cpu")
    wd = tmp_path / "torch_c2"
    shutil.copytree(base, wd)
    pl = TorchPipeline(Config.from_yaml(wd / "config.yaml"), wd, device="cpu")
    hits0, misses0 = pl._index_cache.hits, pl._index_cache.misses
    stem = pl.preprocess(sorted(str(p) for p in (wd / "input").iterdir()))
    pl.match(stem)
    assert pl._index_cache.hits - hits0 == len(pl.batches())
    assert pl._index_cache.misses == misses0
    for p in (wd / "intermediate" / "03_match").glob("*.gz"):
        assert gzip.open(p, "rb").read() == first[f"03_match/{p.name}"]
