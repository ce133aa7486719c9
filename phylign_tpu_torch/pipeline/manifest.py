"""Per-(stage, key) completion manifest for checkpoint/resume.

The reference resumes via Snakemake's output-file staleness checks
(ref: Makefile:23 --keep-going --rerun-incomplete; SURVEY.md
section 5 checkpoint/resume). Here each completed unit writes a small JSON
marker after its output file is atomically renamed into place, so a killed
run resumes at (stage, batch) granularity.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any


class Manifest:
    def __init__(self, root: str | os.PathLike):
        self.dir = Path(root) / ".manifest"
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, stage: str, key: str) -> Path:
        safe = key.replace("/", "__")
        return self.dir / f"{stage}@{safe}.json"

    def done(self, stage: str, key: str, outputs: list[str] | None = None) -> bool:
        """True iff the unit is marked complete AND its outputs still exist."""
        p = self._path(stage, key)
        if not p.exists():
            return False
        try:
            meta = json.loads(p.read_text())
        except json.JSONDecodeError:
            return False
        for out in meta.get("outputs", []):
            if not os.path.exists(out):
                return False
        if outputs:
            recorded = set(meta.get("outputs", []))
            if not set(map(str, outputs)) <= recorded:
                return False
        return True

    def mark(self, stage: str, key: str, outputs: list[str], **extra: Any) -> None:
        p = self._path(stage, key)
        # one tmp name per process: ranks of a multi-process run sharing
        # the workdir may mark the same key at once
        tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp")
        tmp.write_text(
            json.dumps(
                {"stage": stage, "key": key, "outputs": list(map(str, outputs)),
                 "time": time.time(), **extra}
            )
        )
        tmp.rename(p)

    def clear(self, stage: str | None = None) -> None:
        for p in self.dir.glob("*.json"):
            if stage is None or p.name.startswith(stage + "@"):
                p.unlink()


def atomic_write_via(path: str | os.PathLike):
    """Return (tmp_path, commit_fn): write to tmp, then rename into place —
    the reference's tmp-then-rename idiom (Snakefile:380-386)."""
    path = Path(path)
    # prefix (not suffix) the tmp marker so compression-by-suffix writers
    # still see the real extension (.gz/.xz); the pid keeps ranks of a
    # multi-process run that write the same output (preprocess) apart
    tmp = path.with_name(f".tmp.{os.getpid()}.{path.name}")

    def commit():
        tmp.rename(path)

    return tmp, commit
