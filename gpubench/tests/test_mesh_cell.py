"""The four-card cell sr-reads.match-4gpu: load_cell reads its configuration
(the one-card cell's with a 4x1 mesh), its limits and its metrics (the
one-card cell's match.* metrics and the mesh's own); each mesh metric, and
each match.* metric read from the trace, reads nothing without a trace and
a number from a synthetic trace of four cards."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import run  # noqa: E402
from gpubench import trace as tr  # noqa: E402
from gpubench.fixtures import Job  # noqa: E402

CELL = "sr-reads.match-4gpu"
MESH = ["mesh.merge_ms_per_batch", "mesh.merge_roofline", "mesh.peer_ms_per_batch"]
#: the one-card cell's metrics that the four-card cell reports too
SHARED = ["match.preprocess_s", "match.stage_s_per_batch", "match.filter_s", "match.h2d_ms_per_batch",
          "match.gather_roofline", "match.epilogue_ms_per_batch", "match.device_idle"]
#: of them, those read from the trace
SHARED_TRACED = ["match.h2d_ms_per_batch", "match.gather_roofline", "match.epilogue_ms_per_batch",
                 "match.device_idle"]


def test_load_cell_reads_the_config_limits_and_metrics():
    spec = run.load_cell(CELL)
    one = run.load_cell("sr-reads.match")
    assert spec["cell"]["chips"] == 4 and spec["traffic"] == one["traffic"]
    conf, base = spec["config"], one["config"]
    assert conf["name"] == "sr-reads-4gpu" and conf["config"]["mesh_shape"] == "4x1"
    assert {**conf["config"], "mesh_shape": "1x1"} == base["config"]
    for key in ("index", "genomes", "queries", "scoring", "expect_index_cache_hits"):
        assert conf[key] == base[key], key
    assert set(conf["reduced"]) == set(base["reduced"])
    assert spec["limits"] == one["limits"] == {"blocks_differ": 0}
    assert {m["name"] for m in spec["end_to_end"]} == {"match_pairs_per_s", "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == SHARED + MESH
    for m in spec["per_layer"]:
        assert (spec["metrics_dir"] / f"{m['name']}.py").is_file()
        want = [CELL] if m["name"] in MESH else ["sr-reads.match", CELL]
        assert m["moves"] == "match_pairs_per_s" and m["workloads"] == want
    assert [m["name"] for m in one["per_layer"]] == SHARED


def _run(tmp_path, traced: bool):
    """A window of one job of four reads over four batches; with ``traced``
    a trace in which each of four cards runs an upload, B2 and B5b, card 0
    the merge, and a window crosses from card 2 to card 0."""
    spec = run.load_cell(CELL)
    trd = None
    if traced:
        ev = [{"ph": "X", "cat": "user_annotation", "name": "gb:window", "ts": 0, "dur": 10000, "pid": 0}]
        for card in range(4):
            ev += [
                {"ph": "X", "cat": "kernel", "pid": card, "ts": 1000 + 10 * card, "dur": 200,
                 "name": "void (anonymous namespace)::match_popcount_kernel<8, 1, 0>(unsigned"},
                {"ph": "X", "cat": "gpu_memcpy", "pid": card, "ts": 100, "dur": 500,
                 "name": "Memcpy HtoD (Pinned -> Device)"},
                {"ph": "X", "cat": "kernel", "pid": card, "ts": 1240 + 10 * card, "dur": 5,
                 "name": "void (anonymous namespace)::threshold_topk_kernel<64>(int const*"},
            ]
        ev += [
            {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "ts": 1300, "dur": 20, "name": "Memcpy PtoP (Device -> Device)"},
            {"ph": "X", "cat": "kernel", "pid": 0, "ts": 1400, "dur": 40,
             "name": "(anonymous namespace)::merge_topk_kernel(int, int const* const*"},
        ]
        p = tmp_path / "t.json"
        p.write_text(json.dumps({"traceEvents": ev}))
        trd = tr.Trace.load(p, "window")
    seqs = [b"ACGT" * 40, b"TTGCA" * 30, b"ACGT" * 40, b"GATTACA" * 22]
    pool = SimpleNamespace(cfg=spec["config"], batches=["a", "b", "c", "d"], docs=2169, rows=20011, wp=68)
    job = Job([f"r{i}" for i in range(4)], seqs)
    return run.Run(spans=tr.Spans(False), job_ids=[1], jobs=[(job, tmp_path, "q")], trace=trd, pool=pool,
                   stage="match", b4=None, counted={}, index_cache_hits=0)


@pytest.mark.parametrize("name", MESH + SHARED_TRACED)
def test_mesh_metric_reads_none_without_a_trace_and_a_number_from_one(name, tmp_path):
    path = run.load_cell(CELL)["metrics_dir"] / f"{name}.py"
    assert run.read_metric(path, _run(tmp_path, False)) is None
    v = run.read_metric(path, _run(tmp_path, True))
    # the union over the cards: the uploads, B2, B5b, the copy and the merge
    want = {"mesh.merge_ms_per_batch": 0.040 / 4, "mesh.peer_ms_per_batch": 0.020 / 4,
            "match.h2d_ms_per_batch": 4 * 0.5 / 4, "match.epilogue_ms_per_batch": 4 * 0.005 / 4,
            "match.device_idle": 100 * (1 - (500 + 230 + 4 * 5 + 20 + 40) / 10000)}
    if name in want:
        assert v == pytest.approx(want[name], rel=1e-9)
    else:  # a share of a bound: the three distinct reads, 120 rows each, score once
        assert 0 < v < 100
