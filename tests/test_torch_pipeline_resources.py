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
