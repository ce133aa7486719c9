"""The port's spans and counters (``phylign_tpu_torch/utils/trace.py``):
off by default and free there, nesting on every thread, counters that add
up across threads, the kernel modules' launch counters unchanged, and a CPU
run of the match and pooled align stages through ``Pipeline`` that records
every span at the layer boundaries with its parent."""

import dataclasses
import sys
import threading
import time

import pytest

from phylign_tpu_torch import testing as ttesting
from phylign_tpu_torch.align import fused as tfz
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.models import matcher as tm
from phylign_tpu_torch.ops import _kernels
from phylign_tpu_torch.ops import chain as tchain
from phylign_tpu_torch.ops import extend as text
from phylign_tpu_torch.ops import match as tmatch
from phylign_tpu_torch.pipeline.stages import Pipeline
from phylign_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _clean():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def self_seconds(rows) -> dict[int, float]:
    """Each span's duration less what its direct children cover, by id."""
    out = {r.id: r.t1 - r.t0 for r in rows}
    for r in rows:
        if r.parent_id is not None:
            out[r.parent_id] -= r.t1 - r.t0
    return out


def by_name(rows, name):
    return [r for r in rows if r.name == name]


def test_off_by_default_records_nothing_and_shares_one_context():
    assert trace.span("a") is trace.span("b") is trace.span("stage.match")
    with trace.span("a"):
        with trace.span("b"):
            pass
    assert trace.snapshot()["spans"] == []


def test_nesting_and_self_time_on_the_main_thread():
    trace.enable(True)
    with trace.span("outer"):
        time.sleep(0.02)
        with trace.span("inner"):
            time.sleep(0.03)
        with trace.span("inner"):
            time.sleep(0.01)
    rows = trace.snapshot()["spans"]
    (outer,) = by_name(rows, "outer")
    inner = by_name(rows, "inner")
    assert outer.parent is None and outer.parent_id is None
    assert [(r.parent, r.parent_id) for r in inner] == [("outer", outer.id)] * 2
    assert all(r.thread == threading.current_thread().name for r in rows)
    assert all(outer.t0 <= r.t0 <= r.t1 <= outer.t1 for r in inner)
    own = self_seconds(rows)
    children = sum(r.t1 - r.t0 for r in inner)
    assert own[outer.id] == pytest.approx(outer.t1 - outer.t0 - children)
    assert 0.02 <= own[outer.id] < outer.t1 - outer.t0
    assert children >= 0.04
    assert all(own[r.id] == r.t1 - r.t0 for r in inner)


def test_nesting_is_per_thread():
    trace.enable(True)

    def work(i):
        with trace.span("worker"):
            with trace.span("worker.child"):
                time.sleep(0.005 * i)

    with trace.span("main"):
        ts = [threading.Thread(target=work, args=(i,), name=f"w{i}") for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    rows = trace.snapshot()["spans"]
    ids = {r.id: r for r in rows}
    workers = by_name(rows, "worker")
    assert sorted(r.thread for r in workers) == ["w0", "w1", "w2", "w3"]
    assert all(r.parent is None for r in workers)  # not main's span
    for c in by_name(rows, "worker.child"):
        parent = ids[c.parent_id]
        assert parent.name == c.parent == "worker" and parent.thread == c.thread
        assert parent.t0 <= c.t0 <= c.t1 <= parent.t1
    own = self_seconds(rows)
    (main,) = by_name(rows, "main")
    assert own[main.id] == main.t1 - main.t0  # other threads' spans are not its children


def test_counters_from_eight_threads_add_up():
    counters = trace.Counters("b")
    start = threading.Barrier(8)

    def work():
        start.wait(timeout=30)
        for _ in range(5000):
            trace.count("a")
            trace.count("c", 3)
            counters.add("b")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    got = trace.snapshot()["counts"]
    assert got["a"] == 40000 and got["c"] == 120000
    assert counters.snapshot() == {"b": 40000}
    trace.reset()
    snap = trace.snapshot()
    assert snap["spans"] == [] and not any(snap["counts"].values())
    assert snap["counts"]["a"] == snap["counts"]["c"] == 0


def test_counters_count_while_spans_are_off():
    trace.count("x", 2)
    trace.count("x")
    assert trace.snapshot()["counts"]["x"] == 3


LAUNCH_NAMES = {
    tmatch: ("match_popcount_b1", "match_popcount_b2", "match_popcount_acc", "match_popcount_keep"),
    tm: ("hash_rows", "threshold_topk", "pack_hits", "merge_topk"),
    tchain: ("chain_scan", "chain_select"),
    text: ("extend_scan",),
    tfz: ("select_window", "finish_pack", "compact_cold"),
}


@pytest.mark.parametrize("mod", list(LAUNCH_NAMES), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_launch_counts_keep_their_names_and_results(mod):
    assert _kernels.LaunchCounts is trace.Counters
    assert isinstance(mod._launches, trace.Counters)
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(LAUNCH_NAMES[mod], 0)
    name = LAUNCH_NAMES[mod][0]
    mod._launches.add(name)
    mod._launches.add(name)
    assert mod.launch_counts()[name] == 2
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(LAUNCH_NAMES[mod], 0)
    # the kernel counters are not the program's: trace.reset leaves them
    mod._launches.add(name)
    trace.reset()
    assert mod.launch_counts()[name] == 1
    mod.reset_launch_counts()


#: every span of the match and align stages, with the parent it names
#: (None: the top of its thread), and the thread it runs on
SPANS = {
    "stage.preprocess": (None, "main"),
    "stage.match": (None, "main"),
    "stage.filter": (None, "main"),
    "stage.align": (None, "main"),
    "stage.aggregate": (None, "main"),
    "stage.stats": (None, "main"),
    "match.load_wait": ("stage.match", "main"),
    "match.upload": ("stage.match", "main"),
    "match.upload.pin": ("match.upload", "main"),
    "match.upload.stage": ("match.upload", "main"),
    "match.dispatch": ("stage.match", "main"),
    "match.fetch": ("stage.match", "main"),
    "match.assemble": ("stage.match", "main"),
    "match.write": ("stage.match", "main"),
    "match.drop": ("stage.match", "main"),
    "match.queries": ("stage.match", "main"),
    "match.load": (None, "idx-prefetch"),
    "align.wait": ("stage.align", "main"),
    "align.finish": ("stage.align", "main"),
    "align.fetch": ("align.finish", "main"),
    "align.extend": ("align.finish", "main"),
    "align.reseed": ("align.finish", "main"),
    "align.write": ("stage.align", "main"),
    "align.assemblies": (None, "align-producer-"),
    "align.ref_index": ("align.assemblies", "align-producer-"),
    "align.anchors": ("align.assemblies", "align-producer-"),
}
#: spans of work that this fixture may not have (no delegated segment):
#: the toy map cell of tests/test_torch_program_spans.py records them
WHERE_THE_WORK_IS = {
    "align.extend.dispatch": ("align.extend", "main"),
    "align.extend.traceback": ("align.extend", "main"),
}


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("traced")
    ttesting.make_fixture(wd, n_batches=3)
    cfg = dataclasses.replace(
        Config.from_yaml(wd / "config.yaml"),
        index_load_mode="mem-disk",  # the disk cache, dropped after each batch
        device_index_cache_gb=0,  # every batch uploads
    )
    inputs = sorted(str(p) for p in (wd / "input").iterdir())
    trace.enable(False)
    trace.reset()
    trace.enable(True)
    try:
        pl = Pipeline(cfg, wd, device="cpu")
        stem = pl.preprocess(inputs)
        pl.match(stem)
        pl.filter(stem)
        pl.align(stem)
        pl.aggregate(stem)
        pl.stats(stem)
        snap = trace.snapshot()
    finally:
        trace.enable(False)
        trace.reset()
    return snap, len(pl.batches())


def test_pipeline_records_every_span_with_its_parent(traced_run):
    snap, _ = traced_run
    rows = snap["spans"]
    main = threading.main_thread().name
    for name, (parent, thread) in {**SPANS, **WHERE_THE_WORK_IS}.items():
        got = by_name(rows, name)
        assert got or name in WHERE_THE_WORK_IS, f"no {name} span"
        for r in got:
            assert r.parent == parent, (name, r.parent)
            on_thread = r.thread == main if thread == "main" else r.thread.startswith(thread)
            assert on_thread, (name, r.thread)
    # align.dispatch: flush_pairs_begin under the stage, and queued fused
    # chunks dispatched while a flush finishes
    assert {r.parent for r in by_name(rows, "align.dispatch")} <= {"stage.align", "align.finish"}
    assert any(r.parent == "stage.align" for r in by_name(rows, "align.dispatch"))
    ids = {r.id: r for r in rows}
    for r in rows:
        if r.parent_id is not None:
            p = ids[r.parent_id]
            assert p.name == r.parent and p.thread == r.thread
            assert p.t0 <= r.t0 <= r.t1 <= p.t1


def test_pipeline_spans_at_stage_and_batch_granularity(traced_run):
    snap, n_batches = traced_run
    rows = snap["spans"]
    assert n_batches == 3
    for stage in ("preprocess", "match", "filter", "align", "aggregate", "stats"):
        assert len(by_name(rows, f"stage.{stage}")) == 1
    for name in ("match.load_wait", "match.upload", "match.dispatch", "match.assemble",
                 "match.write", "match.drop", "match.load", "align.write", "align.assemblies"):
        assert len(by_name(rows, name)) == n_batches, name
    # the stage's own work lies inside its root
    (root,) = by_name(rows, "stage.match")
    inside = sum(r.t1 - r.t0 for r in rows if r.parent == "stage.match")
    assert 0 < inside <= root.t1 - root.t0


def test_pipeline_counters(traced_run):
    snap, n_batches = traced_run
    c = snap["counts"]
    assert c["match.batches"] == n_batches
    assert c["match.queries_scored"] >= n_batches
    assert c["match.upload_bytes"] > 0
    assert c["match.pinned_allocs"] == 0  # the CPU pins nothing
    assert c.get("match.chunked_batches", 0) == 0
    assert c["align.flushes"] >= 1 and c["align.pairs"] > 0
    assert c["align.fused_chunks"] >= c["align.flushes"]
    assert c["align.genomes"] > 0
    assert c["align.segments"] >= n_batches  # each batch's final segment at least
    assert c["align.delegated_items"] >= 0 and c["align.chain_truncations"] == 0
