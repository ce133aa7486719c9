"""The port's whole pipeline on the CPU against the JAX package's:
``Pipeline(device="cpu").run_all`` (preprocess -> match -> filter -> align
-> aggregate -> stats) on testing.make_fixture and on a small
testing.make_perf_fixture must write ``intermediate/05_map/*.sam.gz``,
``output/*.sam_summary.gz`` and ``output/*.sam_summary.stats``
byte-identical to the JAX ``Pipeline``'s (gzip members carry their write
time, so .gz files are compared decompressed). The port's CLI (``all`` and
``match`` + ``map``) with ``--device cpu`` writes the same bytes again.
Each side builds its own fixture tree from the same seed and its own
Config from the YAML.
"""

import gzip
from pathlib import Path

import pytest

from phylign_tpu import testing as jtesting
from phylign_tpu.config import Config as JaxConfig
from phylign_tpu.pipeline.stages import Pipeline as JaxPipeline
from phylign_tpu_torch import cli
from phylign_tpu_torch import testing as ttesting
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.ops import chain as opc
from phylign_tpu_torch.ops import extend as ope
from phylign_tpu_torch.pipeline.stages import Pipeline as TorchPipeline

FIXTURES = {
    "fixture": lambda mod, wd: mod.make_fixture(wd, n_batches=3, seed=42),
    "perf": lambda mod, wd: mod.make_perf_fixture(
        wd, n_batches=2, genomes_per_batch=6, n_reads=192, seed=100, genome_len=(8_000, 16_000)
    ),
}


def outputs(wd: Path) -> dict[str, bytes]:
    out = {}
    for d in ("intermediate/05_map", "output"):
        for p in sorted((wd / d).iterdir()):
            out[f"{d}/{p.name}"] = gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes()
    return out


def _inputs(wd: Path) -> list[str]:
    return sorted(str(p) for p in (wd / "input").iterdir())


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def jax_run(request, tmp_path_factory):
    name = request.param
    wd = tmp_path_factory.mktemp(f"jax_{name}")
    FIXTURES[name](jtesting, wd)
    JaxPipeline(JaxConfig.from_yaml(wd / "config.yaml"), wd).run_all(_inputs(wd))
    return name, outputs(wd)


def test_run_all_equals_jax(jax_run, tmp_path):
    name, want = jax_run
    FIXTURES[name](ttesting, tmp_path)
    opc.reset_launch_counts()
    ope.reset_launch_counts()
    out = TorchPipeline(Config.from_yaml(tmp_path / "config.yaml"), tmp_path, device="cpu").run_all(
        _inputs(tmp_path)
    )
    got = outputs(tmp_path)
    assert sorted(got) == sorted(want)
    assert len([k for k in got if "05_map" in k]) in (2, 3)
    for key in want:
        assert got[key] == want[key], key
    assert out == tmp_path / "output" / Path(out).name
    assert b"\t150=" in got[next(k for k in got if k.endswith(".sam_summary.gz"))]
    # the CPU path runs the plain versions: no kernel launched
    assert opc.launch_counts()["chain_scan"] == 0 and ope.launch_counts()["extend_scan"] == 0
    assert (tmp_path / "logs" / "benchmarks" / "ram_usage.txt").exists()


def test_cli_all_equals_jax(jax_run, tmp_path):
    name, want = jax_run
    FIXTURES[name](ttesting, tmp_path)
    cli.main(["all", "--workdir", str(tmp_path), "--config", str(tmp_path / "config.yaml"),
              "--device", "cpu", *_inputs(tmp_path)])
    assert outputs(tmp_path) == want


def test_cli_match_then_map(jax_run, tmp_path, capsys):
    """``match`` then ``map`` (the two halves) give the same bytes as
    ``all``; a second ``map`` resumes from the manifest and rewrites the
    summary identically."""
    name, want = jax_run
    FIXTURES[name](ttesting, tmp_path)
    args = ["--workdir", str(tmp_path), "--config", str(tmp_path / "config.yaml"), "--device", "cpu",
            *_inputs(tmp_path)]
    cli.main(["match", *args])
    cli.main(["map", *args])
    assert "map done" in capsys.readouterr().out
    assert outputs(tmp_path) == want
    cli.main(["map", *args])
    assert outputs(tmp_path) == want


def test_align_single_batch_job_path(tmp_path):
    """Pipeline.align one batch at a time and over all batches at once
    (both through the pooled loop): the same 05_map bytes, and each
    one-batch call writes its batch's batch_align log row beside the
    stage's batch_align_pooled row."""
    ttesting.make_fixture(tmp_path / "a", n_batches=3, seed=42)
    ttesting.make_fixture(tmp_path / "b", n_batches=3, seed=42)
    res = {}
    for key in ("a", "b"):
        wd = tmp_path / key
        pl = TorchPipeline(Config.from_yaml(wd / "config.yaml"), wd, device="cpu")
        stem = pl.preprocess(_inputs(wd))
        pl.match(stem)
        pl.filter(stem)
        if key == "a":
            paths = []
            for b in pl.batches():
                paths.append(pl.align(stem, [b])[0])
                rows = (pl.logs / "benchmarks" / "batch_align" / f"{b}____{stem}.txt").read_text()
                assert len(rows.splitlines()) == 2, rows  # header + this batch's row
            pooled = (pl.logs / "benchmarks" / "batch_align_pooled" / f"{stem}.txt").read_text()
            assert len(pooled.splitlines()) == 1 + len(pl.batches())
        else:
            paths = pl.align(stem)
        res[key] = [gzip.open(p, "rb").read() for p in paths]
    assert res["a"] == res["b"]
