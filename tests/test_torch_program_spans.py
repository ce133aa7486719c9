"""scripts/program_spans.py, the benchmark cells' runs with the program's
spans on: the device's idle time named after the innermost program span on
the client's thread, with each benchmark span's total unchanged; and CPU
runs of both cells at a toy size (gpubench/tests/toy.py) that read every
layer's host time, with the stage roots inside the benchmark's own spans."""

import importlib.util
import json
from pathlib import Path

import pytest

from gpubench import trace as tr

REPO = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ps = _load("program_spans", REPO / "scripts" / "program_spans.py")


def test_idle_gaps_named_after_the_client_threads_program_spans(tmp_path):
    """The window's gaps: [0, 100), [250, 700) and [750, 1000) us; the
    benchmark's spans hold 450 and 350 us of them, as Trace.breakdown says;
    another thread's spans name nothing."""
    tid = {"pid": 1, "tid": 7}
    ann = {**tid, "ph": "X", "cat": "user_annotation"}
    ev = [
        {**ann, "name": "gb:window", "ts": 0, "dur": 1000},
        {**ann, "name": "gb:match", "ts": 0, "dur": 600},
        {**ann, "name": "gb:filter", "ts": 600, "dur": 400},
        {**ann, "name": "phy:stage.match", "ts": 10, "dur": 580},
        {**ann, "name": "phy:match.load_wait", "ts": 20, "dur": 60},
        {**ann, "name": "phy:match.fetch", "ts": 300, "dur": 100},
        {**ann, "name": "phy:match.assemble", "ts": 400, "dur": 150},
        {**ann, "name": "phy:match.redo", "ts": 500, "dur": 20},
        {**ann, "name": "phy:stage.filter", "ts": 800, "dur": 200},
        {**ann, "tid": 9, "name": "phy:match.load", "ts": 0, "dur": 1000},
        {**ann, "tid": 9, "name": "phy:match.load", "ts": 2000, "dur": 10},
        {**tid, "ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 150},
        {**tid, "ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 700, "dur": 50},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    got = ps.trace_report(p)
    us = 1e-6
    want = {
        "match": 20 * us,  # [0, 10) and [590, 600): no program span open
        "match/stage.match": 120 * us,  # [10, 20) [80, 100) [250, 300) [550, 590)
        "match/match.load_wait": 60 * us,
        "match/match.fetch": 100 * us,
        "match/match.assemble": 130 * us,  # [400, 500) and [520, 550)
        "match/match.redo": 20 * us,
        "filter": 150 * us,  # [600, 700) and [750, 800)
        "filter/stage.filter": 200 * us,
    }
    idle = got["idle_gaps"]
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v, abs=1e-12), k
    before = dict(tr.Trace.load(p, "window").breakdown()["idle_gaps"])
    for bench in ("match", "filter"):
        total = sum(v for k, v in idle.items() if k == bench or k.startswith(bench + "/"))
        assert total == pytest.approx(before[bench], abs=1e-12)
    assert got["named_idle_share"] == pytest.approx(630 / 800)
    # the other thread's span inside the window counts as an event, not as a name
    assert got["trace_events"]["match.load"] == {"n": 1, "threads": 1}


def test_innermost_pieces():
    spans = [("a", 0.0, 10.0), ("b", 2.0, 4.0), ("c", 3.0, 4.0), ("d", 6.0, 7.0), ("e", 12.0, 13.0)]
    assert ps.innermost(spans) == [
        (0.0, 2.0, "a"), (2.0, 3.0, "b"), (3.0, 4.0, "c"), (4.0, 6.0, "a"), (6.0, 7.0, "d"),
        (7.0, 10.0, "a"), (12.0, 13.0, "e"),
    ]


def _toy(cell):
    toy = _load("gpubench_toy", REPO / "gpubench" / "tests" / "toy.py")
    spec = toy.spec(cell)
    spec["config"]["config"]["device_index_cache_gb"] = 0  # every batch uploads
    return spec


@pytest.mark.parametrize("cell,stage", [("sr-reads.match", "match"), ("amr-genes.map", "map"),
                                        ("sr-reads.match-4gpu", "match")])
def test_toy_run_reads_every_layers_host_time(cell, stage, tmp_path):
    res, rep = ps.run_with_spans(_toy(cell), 1234567891011, 0.01, False, True, "cpu", tmp_path)
    assert res["correct"], res["checks"]
    mesh = cell.endswith("4gpu")  # a 4x1 mesh of the one CPU, on the pipelined path as one device
    want = {k for k in ps.METRICS if k.startswith(stage + ".") and (mesh or ".mesh_" not in k)}
    assert set(rep["metrics"]) == want and all(v >= 0 for v in rep["metrics"].values())
    roots = {"match": ("stage.preprocess", "stage.match", "stage.filter"),
             "map": ("stage.align", "stage.aggregate", "stage.stats")}[stage]
    assert set(rep["stage_roots"]) == set(roots)
    for k in roots:  # inside the benchmark's own span around the same call
        r = rep["stage_roots"][k]
        assert 0 < r["program_s"] <= r["benchmark_s"], (k, r)
    jobs = res["attempted"] - res["failed"]
    if stage == "match":
        assert rep["per"] == "batch" and rep["units"] == 2 * jobs
        assert rep["counts"]["match.batches"] == rep["units"]
        assert rep["split"]["match.upload"]["n"] == rep["units"]
        if mesh:  # 70 documents, 3 words: shards of 1 word, the fourth zero
            assert rep["split"]["match.mesh.upload"]["n"] == 4 * rep["units"]
            for name in ("match.mesh.score", "match.mesh.gather", "match.mesh.merge"):
                assert rep["split"][name]["n"] >= rep["units"], name
            assert rep["counts"]["match.mesh_shards"] == 4 * rep["units"]
            assert rep["counts"]["match.mesh_padding_words"] == rep["units"]
            assert rep["counts"]["match.mesh_gather_bytes"] == 0  # one device: nothing copied
            assert rep["counts"]["match.mesh_hash_chunks"] == rep["units"]  # a chunk a batch
    else:
        assert rep["per"] == "job" and rep["units"] == jobs
        assert rep["counts"]["align.flushes"] >= jobs
        # genes with deletions: delegated segments, some with a traceback
        assert rep["counts"]["align.delegated_items"] > 0 and rep["counts"]["align.traceback_pairs"] > 0
        assert rep["counts"]["align.device_traceback_pairs"] == 0  # the CPU walks on the host
        assert rep["counts"]["align.genomes"] > 0 and rep["counts"]["align.device_ref_genomes"] == 0
        assert rep["split"]["align.extend.dispatch"]["n"] >= 1
        assert rep["split"]["align.extend.traceback"]["n"] >= 1


def test_toy_run_with_spans_off_records_none(tmp_path):
    res, rep = ps.run_with_spans(_toy("sr-reads.match"), 7, 0.01, False, False, "cpu", tmp_path)
    assert res["correct"]
    assert rep["split"] == {} and rep["metrics"] == {} and rep["stage_roots"] == {}
    assert rep["counts"]["match.batches"] == rep["units"]  # counters are always on


@pytest.mark.parametrize("stage,got,want", [
    ("map", {"align.flushes": 2, "align.traceback_pairs": 5},
     {"align.device_ref_genomes": 0, "align.device_traceback_pairs": 0, "align.flushes": 2,
      "align.genomes": 0, "align.traceback_pairs": 5}),
    ("map", {"align.traceback_pairs": 5, "align.device_traceback_pairs": 5, "align.reseed_pairs": 0,
             "align.genomes": 16, "align.device_ref_genomes": 16},
     {"align.device_ref_genomes": 16, "align.device_traceback_pairs": 5, "align.genomes": 16,
      "align.traceback_pairs": 5}),
    ("map", {}, {"align.device_ref_genomes": 0, "align.device_traceback_pairs": 0, "align.genomes": 0,
                 "align.traceback_pairs": 0}),
    ("match", {"match.batches": 4, "match.redo_queries": 0}, {"match.batches": 4}),
    ("match", {"match.batches": 4, "match.mesh_shards": 16, "match.mesh_padding_words": 0},
     {"match.batches": 4, "match.mesh_gather_bytes": 0, "match.mesh_hash_chunks": 0, "match.mesh_padding_words": 0,
      "match.mesh_shards": 16}),
])
def test_counts_keep_the_traceback_counters_of_a_map_cell(stage, got, want):
    """A map cell's report lists both traceback counters and both genome
    counters, at 0 too, so that the walks on the card can be held to all the
    gapped pairs' walks and the tables built on the card to all genomes, and a
    match cell on a mesh its four mesh counters; other counters only when
    not 0."""
    assert ps.counts(got, stage) == want
    assert list(ps.counts(got, stage)) == sorted(want)
