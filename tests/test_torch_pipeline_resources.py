"""Resource accounting of the port's pipelined match stage (the watchdog
tests of tests/test_match_pipelined_resources.py, on
phylign_tpu_torch.pipeline.stages with device="cpu").

The pipelined path dispatches several batches before flushing; every
reservation it takes (prefetch RAM, transient index device memory) must be
either releasable by another thread or guarded by a flush-first check — a
blocking acquire while holding work only the same thread can release is a
self-deadlock."""

import threading

from phylign_tpu_torch import testing as fixture_mod
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.pipeline.stages import Pipeline


def _run_with_timeout(fn, timeout_s):
    out: dict = {}

    def run():
        try:
            out["result"] = fn()
        except BaseException as e:  # surfaced to the asserting caller
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), "pipelined match deadlocked (timeout)"
    if "error" in out:
        raise out["error"]
    return out["result"]


def test_tiny_device_pool_flushes_instead_of_deadlocking(tmp_path):
    """Device-memory pool smaller than one dispatch group's transient
    reservations: the flush-before-block guard must drain the group rather
    than block in hbm.acquire while holding it."""
    fixture_mod.make_fixture(tmp_path, n_batches=10, seed=33)
    cfg = Config.from_yaml(tmp_path / "config.yaml").with_overrides(
        device_hbm_gb=0.002,  # ~2 MB pool: a group of ~1 MB indexes exceeds it
        device_index_cache_gb=0.0,  # every batch index is transient
    )
    pl = Pipeline(cfg, tmp_path, device="cpu")
    inputs = sorted(str(p) for p in (tmp_path / "input").iterdir())
    stem = _run_with_timeout(lambda: pl.preprocess(inputs), 120)
    outs = _run_with_timeout(lambda: pl.match(stem, pl.batches()), 300)
    assert len(outs) == 10 and all(p.exists() for p in outs)
    # pools fully restored after the run
    assert pl.sched.hbm.available() == pl.sched.hbm.total
    assert pl.sched.ram.available() == pl.sched.ram.total


def test_tiny_ram_pool_fifo_prefetch(tmp_path):
    """RAM pool near one index's reservation: FIFO-ordered prefetch
    acquisition + dispatch-time release must keep the in-order consumer
    progressing."""
    fixture_mod.make_fixture(tmp_path, n_batches=6, seed=34)
    cfg = Config.from_yaml(tmp_path / "config.yaml").with_overrides(
        max_ram_gb=1,  # RamPool floor; reservations are per-index estimates
        max_io_heavy_threads=4,
    )
    pl = Pipeline(cfg, tmp_path, device="cpu")
    # shrink the pool far below 6 concurrent prefetch reservations
    pl.sched.ram.total = pl.sched.ram.free = 128
    inputs = sorted(str(p) for p in (tmp_path / "input").iterdir())
    stem = _run_with_timeout(lambda: pl.preprocess(inputs), 120)
    outs = _run_with_timeout(lambda: pl.match(stem, pl.batches()), 300)
    assert len(outs) == 6
    assert pl.sched.ram.available() == pl.sched.ram.total


def test_failed_dispatch_releases_reservations(tmp_path, monkeypatch):
    """A device failure in the middle of the pipelined path returns every
    RAM and device-memory reservation before the job path takes over."""
    fixture_mod.make_fixture(tmp_path, n_batches=4, seed=35)
    cfg = Config.from_yaml(tmp_path / "config.yaml").with_overrides(
        device_index_cache_gb=0.0
    )
    pl = Pipeline(cfg, tmp_path, device="cpu")
    inputs = sorted(str(p) for p in (tmp_path / "input").iterdir())
    stem = pl.preprocess(inputs)
    orig = Pipeline._score_batch_begin
    calls = []

    def flaky(self, didx, qs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return orig(self, didx, qs)

    monkeypatch.setattr(Pipeline, "_score_batch_begin", flaky)
    seen = {}

    def job_path(b, s):
        seen[b] = (pl.sched.hbm.available(), pl.sched.ram.available())
        return pl.match_path(b, s)

    monkeypatch.setattr(pl, "match_one_batch", job_path)
    _run_with_timeout(lambda: pl.match(stem, pl.batches()), 300)
    assert len(seen) == 4
    assert pl.sched.hbm.available() == pl.sched.hbm.total


def _warm_state(monkeypatch, tmp_path):
    """A fresh warm-up flag and build registry, and an nvcc that fails and
    records the thread of each call."""
    from phylign_tpu_torch.ops import _kernels
    from phylign_tpu_torch.pipeline import stages

    monkeypatch.setattr(stages, "_warmed", False)
    monkeypatch.setattr(_kernels, "_builds", {})
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kbuild")
    calls = []

    def no_nvcc():
        calls.append(threading.current_thread().name)
        raise _kernels.KernelError("nvcc not found (test)")

    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    return stages, _kernels, calls


def test_warm_up_starts_no_thread_and_no_build_on_the_cpu(tmp_path, monkeypatch):
    stages, kernels, calls = _warm_state(monkeypatch, tmp_path)
    fixture_mod.make_fixture(tmp_path, n_batches=1, seed=3)
    Pipeline(Config.from_yaml(tmp_path / "config.yaml"), tmp_path, device="cpu")
    assert not any(t.name == "device-warmup" for t in threading.enumerate())
    assert stages._warmed is False and kernels._builds == {} and calls == []


def test_failed_warm_build_raises_at_first_launch_without_a_second_build(tmp_path, monkeypatch, caplog):
    """A pretend CUDA pipeline whose nvcc fails: the warm-up thread tries
    each source once and logs a WARNING; library() then raises that
    KernelError instead of compiling again, and nothing is loaded."""
    import logging

    import pytest
    import torch

    stages, kernels, calls = _warm_state(monkeypatch, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    started = []
    warm = stages._warm_device_async
    monkeypatch.setattr(stages, "_warm_device_async", lambda dev: started.append(warm(dev)))
    fixture_mod.make_fixture(tmp_path, n_batches=1, seed=3)
    n_src = len(list(kernels.SRC_DIR.glob("*.cu")))
    with caplog.at_level(logging.WARNING, logger="phylign_tpu_torch.pipeline"):
        Pipeline(Config.from_yaml(tmp_path / "config.yaml"), tmp_path, device="cuda")
        assert len(started) == 1 and started[0] is not None
        started[0].join(timeout=120)
        assert not started[0].is_alive()
    state = {k: f.done() for k, f in kernels._builds.items()}
    assert sorted(state) == sorted(p.stem for p in kernels.SRC_DIR.glob("*.cu")), (state, calls)
    assert all(state.values()), state
    assert "kernel build failed" in caplog.text
    assert len(calls) == n_src and "device-warmup" not in calls  # on the pool's threads
    for name in ("match_popcount", "chain_scan"):
        with pytest.raises(kernels.KernelError, match="nvcc not found"):
            kernels.library(name)
    assert len(calls) == n_src and kernels._libs == {}


def test_query_set_raw_per_record_equals_jax(tmp_path):
    import numpy as np

    from phylign_tpu import testing as jfixture
    from phylign_tpu.config import Config as JaxConfig
    from phylign_tpu.pipeline.stages import Pipeline as JaxPipeline

    per = {}
    for side, mod, cfg_cls, pl_cls, kw in (
        ("jax", jfixture, JaxConfig, JaxPipeline, {}),
        ("torch", fixture_mod, Config, Pipeline, {"device": "cpu"}),
    ):
        wd = tmp_path / side
        mod.make_fixture(wd, n_batches=1, seed=9)
        # duplicates and reverse complements share a unique query
        reads = (wd / "input" / "reads_1.fastq").read_text().splitlines()
        comp = str.maketrans("ACGT", "TGCA")
        (wd / "input" / "dups.fa").write_text(
            f">d1\n{reads[1]}\n>d2\n{reads[1][::-1].translate(comp)}\n>d3\n{reads[5]}\n"
        )
        pl = pl_cls(cfg_cls.from_yaml(wd / "config.yaml"), wd, **kw)
        stem = pl.preprocess(sorted(str(p) for p in (wd / "input").iterdir()))
        qs = pl._query_set(stem, 31, 1)
        per[side] = (qs.rep_of, qs.raw_per_record())
    (jrep, jraw), (trep, traw) = per["jax"], per["torch"]
    np.testing.assert_array_equal(trep, jrep)
    assert len(traw) == len(jraw) == len(trep) > len(set(trep.tolist()))
    for a, b in zip(traw, jraw):
        np.testing.assert_array_equal(a, b)


def test_build_all_tries_every_source_when_one_fails(tmp_path, monkeypatch):
    """One source failing does not cancel the others' builds (a pool's map
    would): build_all raises the first error after every source ran."""
    import pytest

    _, kernels, calls = _warm_state(monkeypatch, tmp_path)
    with pytest.raises(kernels.KernelError, match="nvcc not found"):
        kernels.build_all()
    names = sorted(p.stem for p in kernels.SRC_DIR.glob("*.cu"))
    assert sorted(kernels._builds) == names and len(calls) == len(names)
    assert all(f.done() and f.exception() is not None for f in kernels._builds.values())
