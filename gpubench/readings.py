"""The readings the limits of gpubench/limits/<cell>.json are set from, on
the card at the cell's own size (not run by the benchmark's runs):

    python gpubench/readings.py --workload <cell> --seeds 1,2,3 [--control 3] [--fault answer|drop]

For each seed, in one process: the cell's set-up, a window of --seconds
(0: one job, which holds as many queries as a run compares), and the
comparison. ``--control N`` also reads the control on the first N seeds
(the reference in the program's place with one guarantee broken: Bloom
rows from the hash's low 32 bits, alignment scores held in int8), judged
by the same comparison; ``--fault answer`` alters answers where the
program produces them, ``--fault drop`` leaves half of the batch out. One
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_cell(args.workload)
    tmp = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        work = Path(tempfile.mkdtemp(prefix="gpubench-readings-", dir=tmp))
        try:
            res = run.run_cell(spec, seed, args.seconds, False, "cuda", work, t_start=time.perf_counter(),
                               control=i < args.control, fault=args.fault)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault, "correct": res["correct"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "control": res.get("control"), "attempted": res["attempted"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
