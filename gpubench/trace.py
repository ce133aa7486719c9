"""Spans, the device trace and the program's counters of one run.

Spans are the benchmark's own, around its calls into the program's
``Pipeline``: the host clock always, and under ``--trace 1`` also a
``torch.profiler.record_function`` of the same name, so that the trace
holds them beside the device's operations on one clock. The trace is
``torch.profiler`` (CUPTI) over the measured window, written as a Chrome
trace and read back: kernels, copies and sets are the device's operations.
The program's launch counters are read before and after the window, and
the trace's kernels are held to them family by family.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

from gpubench import bounds

SPAN_PREFIX = "gb:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the program's launch counters (names in ``launch_counts()``) against the
#: kernel functions of csrc/*.cu that each launch runs (one a launch)
FAMILIES = {
    "match_popcount": (("match_popcount_b1", "match_popcount_b2", "match_popcount_acc", "match_popcount_keep"),
                       ("match_popcount_kernel",)),
    "hash_rows": (("hash_rows",), ("hash_rows_kernel",)),
    "threshold_topk": (("threshold_topk",), ("threshold_topk_kernel",)),
    "pack_hits": (("pack_hits",), ("pack_hits_kernel",)),
    "merge_topk": (("merge_topk",), ("merge_topk_kernel",)),
    "chain_scan": (("chain_scan",), ("chain_scan_kernel",)),
    "chain_select": (("chain_select",), ("chain_select_kernel", "chain_select_warp_kernel")),
    "extend_scan": (("extend_scan", "extend_scan_packed"), ("extend_scan_kernel", "extend_wave_kernel")),
    "select_window": (("select_window",), ("select_window_kernel",)),
    "finish_pack": (("finish_pack",), ("finish_pack_kernel",)),
    "compact_cold": (("compact_cold",), ("compact_cold_kernel",)),
}
COUNTING_MODULES = (
    "phylign_tpu_torch.ops.match",
    "phylign_tpu_torch.models.matcher",
    "phylign_tpu_torch.ops.chain",
    "phylign_tpu_torch.ops.extend",
    "phylign_tpu_torch.align.fused",
)


class Spans:
    """Host-clock spans of each job: (job, name, seconds)."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.rows: list[tuple[int, str, float]] = []

    @contextlib.contextmanager
    def span(self, job: int, name: str):
        cm = contextlib.nullcontext()
        if self.traced:
            import torch

            cm = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with cm:
            yield
        self.rows.append((job, name, time.perf_counter() - t0))

    def per_job(self, name: str) -> dict[int, float]:
        out: dict[int, float] = {}
        for j, n, s in self.rows:
            if n == name:
                out[j] = out.get(j, 0.0) + s
        return out


def launch_counts() -> dict[str, int]:
    import importlib

    out: dict[str, int] = {}
    for m in COUNTING_MODULES:
        for k, v in importlib.import_module(m).launch_counts().items():
            out[k] = out.get(k, 0) + v
    return out


def idle_percent(trace: "Trace | None") -> float | None:
    """The device's idle share of a traced window (%): 1 - the union of its
    operations (kernels, copies, sets) over the window."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def kernel_base(name: str) -> str:
    """A device operation's short name: a kernel's function without its
    return type, namespace and arguments; a copy's name as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", base, maxsplit=1)[0]
    return base.rsplit("::", 1)[-1].strip() or name[:80]


@dataclass
class Trace:
    """The device operations of the traced window, (name, cat, t0, t1) in
    seconds, and the benchmark's spans in the trace, (name, t0, t1)."""

    ops: list[tuple[str, str, float, float]]
    spans: list[tuple[str, float, float]]
    t0: float
    t1: float
    merged: list[tuple[float, float]] = field(default_factory=list)

    @classmethod
    def load(cls, path: Path, window_span: str) -> "Trace":
        data = json.loads(Path(path).read_text())
        events = data["traceEvents"] if isinstance(data, dict) else data
        ops, spans = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                ops.append((e.get("name", "?"), cat, t0, t1))
            elif cat == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX):
                spans.append((e["name"][len(SPAN_PREFIX):], t0, t1))
        win = [(a, b) for n, a, b in spans if n == window_span]
        if not win:
            raise RuntimeError(f"the trace holds no {SPAN_PREFIX}{window_span} span")
        t0, t1 = win[0]
        ops = [o for o in ops if o[3] > t0 and o[2] < t1]
        tr = cls(ops, [s for s in spans if s[0] != window_span], t0, t1)
        tr.merged = tr._merge()
        return tr

    def _merge(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, _, a, b in sorted(self.ops, key=lambda o: o[2]):
            a, b = max(a, self.t0), min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged)

    def seconds(self, pattern: str, cats=("kernel",)) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, c, a, b in self.ops if c in cats and rx.search(n))

    def count(self, kernel: str) -> int:
        rx = re.compile(rf"\b{kernel}\b")
        return sum(1 for n, c, _, _ in self.ops if c == "kernel" and rx.search(n))

    def cross_check(self, counted: dict[str, int]) -> list[str]:
        """Each family's kernels in the trace against the launches the
        program counted over the window; the mismatches."""
        bad = []
        for fam, (counters, kernels) in FAMILIES.items():
            want = sum(counted.get(c, 0) for c in counters)
            got = sum(self.count(k) for k in kernels)
            if want != got:
                bad.append(f"{fam}: {got} kernels in the trace, {want} launches counted")
        return bad

    def breakdown(self) -> dict:
        """The 10 device operations that took the most time, and the device's
        idle time by the benchmark span that was open (outside every span:
        'between spans'), the 10 largest."""
        by_op: dict[str, float] = {}
        for n, _, a, b in self.ops:
            k = kernel_base(n)
            by_op[k] = by_op.get(k, 0.0) + (b - a)
        gaps, last = [], self.t0
        for a, b in self.merged:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        idle: dict[str, float] = {}
        for a, b in gaps:  # the spans are one client's, back to back
            rest = b - a
            for name, s0, s1 in self.spans:
                ov = min(b, s1) - max(a, s0)
                if ov > 0:
                    idle[name] = idle.get(name, 0.0) + ov
                    rest -= ov
            if rest > 0:
                idle["between spans"] = idle.get("between spans", 0.0) + rest
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gap_top]}


class B4Shapes:
    """Under --trace 1, the shape of every launch of kernel B4 at its one
    entry (ops/extend._launch_b4): name, pairs, rows, band, plane, and its
    q_len tensor, kept as it is (no device work in the window) and read
    after the window for the rows the pass needs. Raises where the entry is
    missing or takes other arguments, so that the yardstick cannot go
    silent."""

    PARAMS = ("name", "fn", "inputs", "p", "l", "band", "g", "scoring", "collect_plane", "defines")

    def __init__(self):
        self.rows: list[tuple] = []
        self._orig = None

    def install(self) -> None:
        import inspect

        from phylign_tpu_torch.ops import extend as ope

        orig = getattr(ope, "_launch_b4", None)
        if orig is None or tuple(inspect.signature(orig).parameters) != self.PARAMS:
            raise RuntimeError("ops/extend._launch_b4 is missing or takes other arguments than "
                               f"{self.PARAMS}: map.extend_roofline cannot count B4's launches")
        self._orig = orig

        def counted(name, fn, inputs, p, l, band, g, scoring, collect_plane, *a, **kw):
            if p and l:
                self.rows.append((name, p, l, band, bool(collect_plane), inputs[1]))
            return orig(name, fn, inputs, p, l, band, g, scoring, collect_plane, *a, **kw)

        ope._launch_b4 = counted

    def remove(self) -> None:
        if self._orig is not None:
            from phylign_tpu_torch.ops import extend as ope

            ope._launch_b4 = self._orig
            self._orig = None

    def bound_s(self) -> float | None:
        if not self.rows:
            return None
        total = 0.0
        for name, p, l, band, plane, q_len in self.rows:
            rows = p * l if plane else int(q_len.clamp(0, l).sum())
            total += bounds.b4_bound_s(rows, p, l, band, plane, packed=name.endswith("packed"))
        return total

    def release(self) -> None:
        self.rows.clear()
