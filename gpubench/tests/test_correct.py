"""What decides ``correct``, at a size a CPU test holds: a sound run of
each cell passes; its control (the reference in the program's place with a
guarantee broken: 32-bit Bloom rows, int8 alignment scores), judged by the
same comparison, reads ``correct`` false; and so does a run with an answer
altered where the program produces it, or with half of the batch left
out."""

import time

import pytest

from gpubench import run

from toy import spec

CELLS = ["sr-reads.match", "amr-genes.map"]


def _run(cell, tmp_path, **kw):
    return run.run_cell(spec(cell), 1234567891011, 0.01, False, "cpu", tmp_path, t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_and_control(cell, tmp_path):
    res = _run(cell, tmp_path, control=True)
    assert res["correct"], res["checks"]
    assert not res["control"]["correct"], res["control"]


@pytest.mark.parametrize("fault", run.Fault.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, tmp_path):
    res = _run(cell, tmp_path, fault=fault)
    assert not res["correct"], res["checks"]


def test_dropped_records_read_as_unmapped(tmp_path):
    res = _run("amr-genes.map", tmp_path, fault="drop")
    c = res["checks"]["unmapped"]
    assert c["value"] > c["limit"], c


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_span_metrics(cell, tmp_path):
    res = run.run_cell(spec(cell), 42, 0.01, True, "cpu", tmp_path, t_start=time.perf_counter())
    stage = cell.split(".")[1]
    names = {"match": {"match.preprocess_s", "match.stage_s_per_batch", "match.filter_s"},
             "map": {"map.align_s", "map.report_s"}}[stage]
    assert res["correct"] and set(res["metrics"]) == names  # device metrics: none without a card
