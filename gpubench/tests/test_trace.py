"""Reading a Chrome trace: the window, the device's busy union, the
kernels against the launch counters, and the breakdown."""

import json

import pytest

from gpubench import trace as tr


def _trace(tmp_path, extra=()):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "gb:window", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "gb:match", "ts": 0, "dur": 600},
        {"ph": "X", "cat": "user_annotation", "name": "gb:filter", "ts": 600, "dur": 400},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::match_popcount_kernel<8, 1, 0>(unsigned", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::hash_rows_kernel(long const*", "ts": 150, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 700, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 50},
        *extra,
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return tr.Trace.load(p, "window")


def test_busy_union_and_seconds(tmp_path):
    t = _trace(tmp_path)
    assert abs(t.window_s - 1e-3) < 1e-12
    assert abs(t.busy_s - 200e-6) < 1e-12  # [100, 250) and [700, 750) us
    assert abs(t.seconds(r"\bmatch_popcount_kernel\b") - 100e-6) < 1e-12
    assert abs(t.seconds("Memcpy HtoD", cats=("gpu_memcpy",)) - 50e-6) < 1e-12


def test_cross_check(tmp_path):
    t = _trace(tmp_path)
    assert t.cross_check({"match_popcount_b2": 1, "hash_rows": 1}) == []
    bad = t.cross_check({"match_popcount_b2": 2, "hash_rows": 1})
    assert len(bad) == 1 and bad[0].startswith("match_popcount")


def test_breakdown(tmp_path):
    b = _trace(tmp_path).breakdown()
    assert {k for k, _ in b["device_ops"]} == {"match_popcount_kernel", "hash_rows_kernel", "Memcpy HtoD (Pinned -> Device)"}
    idle = dict(b["idle_gaps"])
    assert abs(idle["match"] - 450e-6) < 1e-12 and abs(idle["filter"] - 350e-6) < 1e-12


def test_b4_probe_fails_loudly_on_another_entry(monkeypatch):
    from phylign_tpu_torch.ops import extend as ope

    probe = tr.B4Shapes()
    probe.install()  # the entry as the program has it
    probe.remove()
    assert ope._launch_b4 is not None and probe._orig is None

    def renamed(name, fn, inputs, p, l, band, lanes, scoring, collect_plane, defines=()):
        return None

    monkeypatch.setattr(ope, "_launch_b4", renamed)
    with pytest.raises(RuntimeError, match="_launch_b4"):
        tr.B4Shapes().install()
    monkeypatch.delattr(ope, "_launch_b4")
    with pytest.raises(RuntimeError, match="_launch_b4"):
        tr.B4Shapes().install()
