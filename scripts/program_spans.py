"""A benchmark cell's run with the program's own spans on: where the host
time of phylign_tpu_torch's stages goes.

    python3 scripts/program_spans.py --workload <cell> --seed <n> --seconds <s> [--trace 0|1] [--spans 0|1]

Runs the cell of BENCHMARK.json as gpubench/run.py does (``run.run_cell``:
set-up, the window, the check against the plain reference) with the spans of
``phylign_tpu_torch/utils/trace.py`` on over the window (``--spans 1``, the
default), and prints the result line that run.py prints, then one line
``{"program": ...}``:

- ``split``: each span's count, total and self seconds (its time less its
  children's), a batch searched in a match cell, a job in a map cell;
- ``metrics``: the stages' host time at their layer boundaries, milliseconds
  a batch searched or seconds a job;
- ``stage_roots``: each stage root's seconds over the window against the
  benchmark's own span around the same call;
- ``counts``: the program's counters over the window (those not 0, in a
  map cell the gapped pairs' walks and the genomes indexed, all and on the
  card, even at 0, and in
  a match cell on a mesh its shards, gathered bytes, padding words and hash
  chunks, even at 0);
- with ``--trace 1`` on a card: ``idle_gaps``, the device's idle seconds by
  the benchmark span that was open, split after the innermost program span
  open on the client's thread as ``<benchmark span>/<program span>`` (what
  no program span covers keeps the benchmark span's name);
  ``named_idle_share``, the share under a program span; ``trace_events``,
  each span's events in the profiler's trace and on how many threads.

``--spans 0`` runs the cell with the spans off, as run.py does: the same
seeds then give the spans' cost. The benchmark's own files are used as they
are; its window is found through ``run.Fault``'s install and remove, which
run_cell calls just before and just after it.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the benchmark span around each stage root's call
STAGE_ROOTS = {f"stage.{s}": s for s in ("preprocess", "match", "filter", "align", "aggregate", "stats")}
#: the host time of the stages' layers: (spans summed, per)
METRICS = {
    "match.load_wait_ms_per_batch": (("match.load_wait",), "batch"),
    "match.upload_host_ms_per_batch": (("match.upload",), "batch"),
    "match.fetch_wait_ms_per_batch": (("match.fetch",), "batch"),
    "match.assemble_ms_per_batch": (("match.assemble",), "batch"),
    "match.write_ms_per_batch": (("match.write",), "batch"),
    "match.mesh_upload_ms_per_batch": (("match.mesh.upload",), "batch"),
    "match.mesh_score_ms_per_batch": (("match.mesh.score",), "batch"),
    "match.mesh_gather_ms_per_batch": (("match.mesh.gather",), "batch"),
    "match.mesh_merge_ms_per_batch": (("match.mesh.merge",), "batch"),
    "map.segment_wait_s": (("align.wait",), "job"),
    "map.seed_thread_s": (("align.ref_index", "align.anchors"), "job"),
    "map.fetch_assemble_s": (("align.fetch",), "job"),
    "map.extend_host_s": (("align.extend",), "job"),
    "map.write_s": (("align.write",), "job"),
}
#: the counters a map cell's report lists even at 0: the gapped pairs'
#: walks, all of them and those on the card (equal on one card, none on the
#: CPU or over a mesh), and the genomes indexed, all of them and those whose
#: minimizer table the card built (equal on a card, none on the CPU)
MAP_COUNTS = ("align.traceback_pairs", "align.device_traceback_pairs",
              "align.genomes", "align.device_ref_genomes")
#: the counters a match cell on a mesh (one that uploaded doc shards) lists
#: even at 0: its shards, the windows' bytes gathered between devices, the
#: zero words uploaded (0 where the words split evenly over the shards) and
#: the query chunks scored on the mesh's hash path (0 where none took it)
MESH_COUNTS = ("match.mesh_shards", "match.mesh_gather_bytes", "match.mesh_padding_words",
               "match.mesh_hash_chunks")


def run_with_spans(spec: dict, seed: int, seconds: float, trace: bool, spans: bool,
                   device: str, work: Path) -> tuple[dict, dict]:
    """run_cell's result, and the program's report (the module docstring)."""
    from gpubench import run
    from gpubench import trace as tr
    from phylign_tpu_torch.utils import trace as ptrace

    got: dict = {}
    install, remove, bench_spans = run.Fault.install, run.Fault.remove, tr.Spans

    def window_opens(self, stage):
        ptrace.reset()
        ptrace.enable(spans)
        install(self, stage)

    def window_closed(self):
        got.setdefault("program", ptrace.snapshot())
        ptrace.enable(False)
        remove(self)

    class KeptSpans(bench_spans):
        def __init__(self, traced):
            super().__init__(traced)
            got["bench"] = self

    run.Fault.install, run.Fault.remove, tr.Spans = window_opens, window_closed, KeptSpans
    try:
        res = run.run_cell(spec, seed, seconds, trace, device, work)
    finally:
        run.Fault.install, run.Fault.remove, tr.Spans = install, remove, bench_spans
        ptrace.enable(False)
    jobs = res["attempted"] - res["failed"]
    per = {"job": jobs, "batch": jobs * spec["config"]["index"]["batches"]}
    report = split(got["program"], got["bench"].rows, per, spec["traffic"]["stage"])
    path = work / "trace.json"
    if trace and path.exists():
        report.update(trace_report(path))
    return res, report


def split(program: dict, bench_rows: list, per: dict, stage: str) -> dict:
    rows = program["spans"]
    dur = {r.id: r.t1 - r.t0 for r in rows}
    children: dict[int, float] = defaultdict(float)
    for r in rows:
        if r.parent_id is not None:
            children[r.parent_id] += dur[r.id]
    total: dict[str, float] = defaultdict(float)
    own: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    for r in rows:
        total[r.name] += dur[r.id]
        own[r.name] += dur[r.id] - children[r.id]
        count[r.name] += 1
    unit = "batch" if stage == "match" else "job"
    n = per[unit] or 1
    bench: dict[str, float] = defaultdict(float)
    for _, name, s in bench_rows:
        bench[name] += s
    metrics = {}
    for name, (names, by) in METRICS.items():
        if name.startswith(stage + ".") and any(k in total for k in names):
            v = sum(total[k] for k in names) / (per[by] or 1)
            metrics[name] = v * 1e3 if name.endswith("_ms_per_batch") else v
    return {
        "per": unit,
        "units": per[unit],
        "split": {k: {"n": count[k], "total_s": total[k] / n, "self_s": own[k] / n}
                  for k in sorted(total, key=lambda k: -total[k])},
        "metrics": metrics,
        "stage_roots": {k: {"program_s": total[k], "benchmark_s": bench[b],
                            "ratio": total[k] / bench[b] if bench[b] else None}
                        for k, b in STAGE_ROOTS.items() if k in total},
        "counts": counts(program["counts"], stage),
    }


def counts(got: dict[str, int], stage: str) -> dict[str, int]:
    """The counters not 0, in a map cell MAP_COUNTS at any value, and in a
    match cell on a mesh MESH_COUNTS at any value."""
    keep = MAP_COUNTS if stage == "map" else MESH_COUNTS if got.get("match.mesh_shards") else ()
    return {k: v for k, v in sorted({**dict.fromkeys(keep, 0), **got}.items()) if v or k in keep}


def innermost(program: list[tuple[str, float, float]]) -> list[tuple[float, float, str]]:
    """One thread's properly nested spans (name, t0, t1) as disjoint
    (t0, t1, name) pieces, each named after the innermost span open there;
    moments under no span are left out."""
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[str, float]] = []  # (name, end), outermost first
    cur = float("-inf")

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][1] <= t:
            name, end = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for name, a, b in sorted(program, key=lambda p: (p[1], -p[2])):
        close_until(a)
        if stack and a > cur:
            out.append((cur, a, stack[-1][0]))
        cur = max(cur, a)
        stack.append((name, b))
    close_until(float("inf"))
    return out


def idle_gaps(trace, program: list[tuple[str, float, float]]) -> dict[str, float]:
    """The device's idle seconds of a gpubench ``trace.Trace`` by the
    benchmark span that was open ('between spans' outside every one), split
    after the innermost of the client thread's ``program`` spans as
    '<benchmark span>/<program span>'. Each benchmark span's entries sum to
    what ``Trace.breakdown`` gives it."""
    gaps, last = [], trace.t0
    for a, b in trace.merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if trace.t1 > last:
        gaps.append((last, trace.t1))
    pieces = innermost(program)
    starts = [p[0] for p in pieces]
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:  # the benchmark's spans are one client's, back to back
        rest = b - a
        for name, s0, s1 in trace.spans:
            x, y = max(a, s0), min(b, s1)
            if y <= x:
                continue
            rest -= y - x
            bare = y - x
            i = max(0, bisect.bisect_right(starts, x) - 1)
            while i < len(pieces) and pieces[i][0] < y:
                p0, p1, prog = pieces[i]
                ov = min(y, p1) - max(x, p0)
                if ov > 0:
                    idle[f"{name}/{prog}"] += ov
                    bare -= ov
                i += 1
            if bare > 1e-9:  # past rounding: the trace counts microseconds
                idle[name] += bare
        if rest > 0:
            idle["between spans"] += rest
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def trace_report(path: Path) -> dict:
    """The idle time of the window in a gpubench Chrome trace named after
    the program's ``phy:`` spans, and those spans' events by thread."""
    from gpubench import trace as tr
    from phylign_tpu_torch.utils.trace import PREFIX

    trd = tr.Trace.load(path, "window")
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    client, spans, tids = None, [], defaultdict(set)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation" or "dur" not in e:
            continue
        name, t0 = str(e.get("name", "")), float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        if name == tr.SPAN_PREFIX + "window":
            client = e.get("tid")
        elif name.startswith(PREFIX) and t1 > trd.t0 and t0 < trd.t1:
            spans.append((name[len(PREFIX):], e.get("tid"), t0, t1))
            tids[spans[-1][0]].add(e.get("tid"))
    idle = idle_gaps(trd, [(n, a, b) for n, tid, a, b in spans if tid == client])
    named = sum(v for k, v in idle.items() if "/" in k)
    return {
        "idle_gaps": idle,
        "named_idle_share": named / sum(idle.values()) if idle else None,
        "trace_events": {k: {"n": sum(1 for s in spans if s[0] == k), "threads": len(v)}
                         for k, v in sorted(tids.items())},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    from gpubench import run

    spec = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("program_spans: no CUDA device", file=sys.stderr)
        return 2
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    tmp = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    work = Path(tempfile.mkdtemp(prefix="program-spans-", dir=tmp))
    try:
        res, report = run_with_spans(spec, args.seed, args.seconds, bool(args.trace), bool(args.spans),
                                     "cuda", work)
    except run.CrossCheckError as e:
        print(f"program_spans: the trace disagrees with the program's launch counters: {e}", file=sys.stderr)
        return 3
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "checks", "breakdown") if k in res}
    out["device"] = {"kind": torch.cuda.get_device_name(0), "memory_peak_bytes": res["memory_peak_bytes"],
                     **res.get("device_extra", {})}
    print(json.dumps(out), flush=True)
    print(json.dumps({"program": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
