"""One run of one benchmark cell of phylign_tpu_torch.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (gpubench/configs/<name>.json:
the deployment, its sizes and the program's Config keys) and a traffic mix
(gpubench/traffic/<name>.json: one job's queries). Set-up makes the pool from
the seed (Bloom-index batches or strain-genome batches, under the TMPDIR),
builds or loads the kernels (build/ inside the checkout) and runs one job.
Then one client runs jobs back to back, each a fresh query set drawn from
the seed and the job's index through a new Pipeline in a fresh directory:
match jobs preprocess -> match -> filter, map jobs align -> aggregate ->
stats on a 04_filter the benchmark writes. The window closes with the first
job that ends after --seconds. The sampled outputs are then compared with
the plain reference (gpubench/check.py) against gpubench/limits/<cell>.json.

The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error. With --trace 1
torch.profiler traces the window and the per-layer metrics are read by
gpubench/metrics/<metric>.py.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded in the process that
#: prints a result (the JAX stack and the JAX package), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "phylign_tpu")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entries of BENCHMARK.json with its configuration, traffic
    and limits files, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    here = root / "gpubench"
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {
        "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((here / "limits" / f"{name}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "metrics_dir": here / "metrics",
    }


class Fault:
    """A fault planted under the timed path (readings and tests only), where
    the program produces its answers: ``answer``, an answer altered (one
    query in 16: its hits' scores, or its records' AS); ``drop``, half of
    the batch left out (every other query's block, or records, not
    written)."""

    KINDS = ("answer", "drop")

    def __init__(self, kind: str | None):
        if kind not in (None, *self.KINDS):
            raise ValueError(f"unknown fault {kind!r}")
        self.kind = kind
        self._undo = []

    def install(self, stage: str) -> None:
        if self.kind is None:
            return
        from phylign_tpu_torch.pipeline import stages

        if stage == "match":
            orig = stages.Pipeline._write_match_unique

            def altered(fp, qs, hits_u, nk_u, names, keep):
                if self.kind == "drop":
                    return orig(_HalfWriter(fp), qs, hits_u, nk_u, names, keep)
                hits_u = [[(d, s + 1) for d, s in h] if i % 16 == 0 else h for i, h in enumerate(hits_u)]
                return orig(fp, qs, hits_u, nk_u, names, keep)

            stages.Pipeline._write_match_unique = staticmethod(altered)
            self._undo.append(lambda: setattr(stages.Pipeline, "_write_match_unique", staticmethod(orig)))
        else:
            orig = stages.write_batch_sam

            def altered(path, records):
                lines = [r.to_line() for r in records]
                if self.kind == "drop":
                    order: dict[str, int] = {}
                    lines = [x for x in lines if order.setdefault(x.split("\t", 1)[0], len(order)) % 2 == 0]
                    return orig(path, [_Line(x) for x in lines])
                out = []
                for i, line in enumerate(lines):
                    if i % 16 == 0 and "\tAS:i:" in line:
                        head, _, rest = line.partition("\tAS:i:")
                        v, _, tail = rest.partition("\t")
                        line = f"{head}\tAS:i:{int(v) + 2}\t{tail}"
                    out.append(line)
                return orig(path, [_Line(x) for x in out])

            stages.write_batch_sam = altered
            self._undo.append(lambda: setattr(stages, "write_batch_sam", orig))

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()


class _HalfWriter:
    """Writes every other 03_match record (a ``*name`` line and its hits)
    of each write."""

    def __init__(self, fp):
        self.fp = fp

    def write(self, text: str) -> None:
        recs = [r for r in re.split(r"(?m)^(?=\*)", text) if r]
        self.fp.write("".join(recs[::2]))


class _Line:
    def __init__(self, line: str):
        self.line = line

    def to_line(self) -> str:
        return self.line


class Run:
    """What a metric reader reads: the window's jobs, spans, trace and
    counts."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_job(self, span: str) -> list[float]:
        vals = self.spans.per_job(span)
        return [vals.get(j, 0.0) for j in self.job_ids]


def read_metric(path: Path, run: Run):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str, work: Path,
             t_start: float = T_START, control: bool = False, fault: str | None = None) -> dict:
    """Set up, run the window, read the metrics and compare the outputs.
    Returns the result's fields (and, with ``control``, under "control"
    the control's numbers judged against the same limits)."""
    import torch

    from gpubench import check, fixtures
    from gpubench import trace as tr
    from phylign_tpu_torch.config import Config
    from phylign_tpu_torch.pipeline import stages
    from phylign_tpu_torch.pipeline.stages import Pipeline

    cfg, traffic = spec["config"], spec["traffic"]
    stage = traffic["stage"]
    pool_dir, stem = work / "pool", "queries"
    if stage == "match":
        pool = fixtures.MatchPool(cfg, traffic, seed, pool_dir, device)
    else:
        pool = fixtures.MapPool(cfg, traffic, seed, pool_dir)
    config = Config.from_dict({**cfg["config"], **pool.pipeline_config()})
    spans = tr.Spans(trace)
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run_job(j: int):
        jd = work / "jobs" / f"{j:04d}"
        jd.mkdir(parents=True)
        if stage == "match":
            with spans.span(j, "client"):  # the lab's read set, drawn and written
                job = pool.job(j)
                if j == 0:  # the warm-up job: its share of a job's queries
                    job = job.head(traffic.get("warmup_share", 1.0))
                pool.write_inputs(job, jd / f"{stem}.fq")
            with spans.span(j, "init"):
                pl = Pipeline(config, jd, device=device)
            with spans.span(j, "preprocess"):
                got = pl.preprocess([str(jd / f"{stem}.fq")])
            with spans.span(j, "match"):
                pl.match(got)
                sync()
            with spans.span(j, "filter"):
                pl.filter(got)
        else:
            with spans.span(j, "init"):
                pl = Pipeline(config, jd, device=device)
            with spans.span(j, "client"):  # the queries and their 04_filter, drawn and written
                job = pool.job(j)
                if j == 0:
                    job = job.head(traffic.get("warmup_share", 1.0))
                pool.write_inputs(job, jd / "intermediate", stem)
            with spans.span(j, "align"):
                pl.align(stem)
                sync()
            with spans.span(j, "aggregate"):
                pl.aggregate(stem)
            with spans.span(j, "stats"):
                pl.stats(stem)
        del pl
        return job, jd, stem

    run_job(0)  # the warm-up job: builds or loads the kernels, fills the disk caches
    sync()
    setup_s = time.perf_counter() - t_start
    spans.rows.clear()
    idx_cache = stages._global_index_cache
    hits0 = idx_cache.hits if idx_cache is not None else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    faults = Fault(fault)
    faults.install(stage)
    b4 = tr.B4Shapes()
    prof = None
    counts0 = tr.launch_counts()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        b4.install()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    runs, failed, attempted = [], 0, 0
    w0 = time.perf_counter()
    try:
        with (torch.profiler.record_function(tr.SPAN_PREFIX + "window") if trace else contextlib.nullcontext()):
            while True:
                attempted += 1
                try:
                    runs.append(run_job(attempted))
                except Exception:  # noqa: BLE001 - a failed job counts, the loop goes on
                    failed += 1
                    traceback.print_exc()
                if time.perf_counter() - w0 >= seconds:
                    break
            sync()
        window_s = time.perf_counter() - w0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        b4.remove()
        faults.remove()
    counted = {k: v - counts0.get(k, 0) for k, v in tr.launch_counts().items()}
    hits = (idx_cache.hits if idx_cache is not None else 0) - hits0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    job_ids = list(range(1, attempted + 1))
    if stage == "match":
        e2e = {"match_pairs_per_s": sum(len(job.names) * len(pool.batches) for job, _, _ in runs) / window_s}
    else:
        e2e = {"map_pairs_per_s": sum(job.pairs for job, _, _ in runs) / window_s}
    for j in job_ids:  # each job's wall time, on a line of its own
        print(json.dumps({"job": j, "seconds": {n: s for jj, n, s in spans.rows if jj == j}}), file=sys.stderr)
    result = {"attempted": attempted, "failed": failed}
    problems = []
    expect_hits = cfg.get("expect_index_cache_hits")
    if expect_hits is not None and hits != expect_hits:
        problems.append(f"{hits} index-cache hits in the window; the cell intends {expect_hits}")
    if trace:
        trace_path = work / "trace.json"
        if cuda:
            prof.export_chrome_trace(str(trace_path))
            trd = tr.Trace.load(trace_path, "window")
            mism = trd.cross_check(counted)
            if mism:
                raise CrossCheckError("; ".join(mism))
        else:
            trd = None
        run = Run(spans=spans, job_ids=job_ids, jobs=runs, trace=trd, pool=pool, stage=stage,
                  b4=b4, counted=counted, index_cache_hits=hits)
        metrics = {}
        for m in spec["per_layer"]:
            v = read_metric(spec["metrics_dir"] / f"{m['name']}.py", run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        b4.release()
        if trd is not None:
            result["breakdown"] = trd.breakdown()
            result["device_extra"] = {"busy_s": trd.busy_s, "window_s": trd.window_s}
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
        result["metrics"] = metrics
    result["memory_peak_bytes"] = peak
    if cuda:  # the reference runs after the program's state is freed
        torch.cuda.empty_cache()
    if stage == "match":
        got = check.check_match(pool, runs, seed, traffic["check_sample"], device, control)
    else:
        got = check.check_map(pool, runs, seed, traffic["check_sample"], traffic["window_pad"], device, control)
    limits = spec["limits"]
    checks, within = judged(got, limits)
    correct = not failed and not problems and bool(runs) and within
    result.update(correct=correct, checks=checks, problems=problems)
    if control:  # the control's output, judged as the program's is
        ctl_checks, ctl_within = judged(got["control"], limits)
        result["control"] = {"checks": ctl_checks, "correct": ctl_within}
    return result


def judged(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Each compared number beside its limit, and whether all are within."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


class CrossCheckError(RuntimeError):
    """The profiler's kernels disagree with the program's launch counters."""


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv: list[str] | None = None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"gpubench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    try:
        import phylign_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"gpubench: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 1
    # kernel caches at fixed places inside the checkout (the program's own
    # nvcc and g++ builds go to build/phylign_tpu_torch there already)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    tmp = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    work = Path(tempfile.mkdtemp(prefix="gpubench-", dir=tmp))
    try:
        res = run_cell(spec, args.seed, args.seconds, bool(args.trace), device, work)
    except CrossCheckError as e:
        print(f"gpubench: the trace disagrees with the program's launch counters: {e}", file=sys.stderr)
        return 3
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = loaded_forbidden()
    if bad:
        print(f"gpubench: modules of the JAX stack are loaded: {bad}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": res.pop("memory_peak_bytes")}
    dev.update(res.pop("device_extra", {}))
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": dev}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    for p in res["problems"]:
        print(f"gpubench: {p}", file=sys.stderr)
    out["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
