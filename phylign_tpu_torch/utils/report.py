"""HTML run report from benchmark logs + output stats (the port's own copy
of ``phylign_tpu/utils/report.py``; the page is byte-identical to the JAX
package's for the same workdir).

The reference exposes `make report` (Snakemake's HTML report, its
Makefile:109-110). This generates the equivalent from the run's own
artifacts: per-rule benchmark TSVs (utils.bench contract) and the output
stats TSVs.
"""

from __future__ import annotations

import html
import os
from pathlib import Path


def write_report(workdir: str | os.PathLike, out_name: str = "report.html") -> Path:
    root = Path(workdir)
    parts: list[str] = [
        "<html><head><title>phylign-tpu run report</title>",
        "<style>body{font-family:sans-serif;margin:2em}table{border-collapse:"
        "collapse}td,th{border:1px solid #999;padding:4px 8px;font-size:13px}"
        "h2{margin-top:1.5em}</style></head><body>",
        "<h1>phylign-tpu run report</h1>",
    ]

    stats_files = sorted((root / "output").glob("*.stats")) if (root / "output").exists() else []
    if stats_files:
        parts.append("<h2>Output stats</h2>")
        for sf in stats_files:
            parts.append(f"<h3>{html.escape(sf.name)}</h3><table>")
            for line in sf.read_text().splitlines():
                k, _, v = line.partition("\t")
                parts.append(
                    f"<tr><th>{html.escape(k)}</th><td>{html.escape(v)}</td></tr>"
                )
            parts.append("</table>")

    bench_root = root / "logs" / "benchmarks"
    if bench_root.exists():
        parts.append("<h2>Stage benchmarks</h2>")
        for rule_dir in sorted(bench_root.iterdir()):
            if not rule_dir.is_dir():
                continue
            parts.append(f"<h3>{html.escape(rule_dir.name)}</h3><table>")
            header_done = False
            for f in sorted(rule_dir.glob("*.txt")):
                lines = f.read_text().splitlines()
                if not lines:
                    continue
                if not header_done:
                    cols = lines[0].split("\t")
                    parts.append(
                        "<tr><th>unit</th>"
                        + "".join(f"<th>{html.escape(c)}</th>" for c in cols)
                        + "</tr>"
                    )
                    header_done = True
                for row in lines[1:]:
                    cells = row.split("\t")
                    parts.append(
                        f"<tr><td>{html.escape(f.stem)}</td>"
                        + "".join(f"<td>{html.escape(c)}</td>" for c in cells)
                        + "</tr>"
                    )
            parts.append("</table>")

    parts.append("</body></html>")
    out = root / out_name
    out.write_text("\n".join(parts))
    return out
