"""Cells of BENCHMARK.json cut to a size a CPU test holds: the same files,
a few Bloom rows and documents, short genomes, few queries."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import run  # noqa: E402

TRAFFIC = {
    "match-reads": {"queries_per_job": 240, "group_source_bp": [400, 600], "hot_groups": 2, "check_sample": 160},
    "match-genes": {"check_sample": 24},
    "map-reads": {"queries_per_job": 80, "check_sample": 320},
    "map-genes": {"check_sample": 120},
}


#: mixes whose generator is kept for cells that BENCHMARK.json does not hold
#: (yet): their configuration and traffic files
UNLISTED = {"sr-reads.map": ("sr-reads", "map-reads"), "amr-genes.match": ("amr-genes", "match-genes")}


def spec(cell: str) -> dict:
    if cell in UNLISTED:
        conf, mix = UNLISTED[cell]
        here = ROOT / "gpubench"
        s = {"cell": {"name": cell, "traffic": mix},
             "config": json.loads((here / "configs" / f"{conf}.json").read_text()),
             "traffic": json.loads((here / "traffic" / f"{mix}.json").read_text())}
    else:
        s = run.load_cell(cell)
    c = s["config"]
    c["index"].update(rows=20_000, docs=70, batches=2)
    c["genomes"].update(length=[60_000, 90_000], batches=2, strains=3, contigs=[1, 2])
    if c["queries"]["kind"] == "genes":
        c["queries"].update(count=40, length=[237, 900], median=400)
    c["expect_index_cache_hits"] = None  # a toy index fits the device cache
    s["traffic"].update(TRAFFIC[s["cell"]["traffic"]])
    return s
