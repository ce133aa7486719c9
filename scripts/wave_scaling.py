"""Time B4's packed instance on its band-128 route (the wavefront body) at
grids from under to over one warp a scheduler and at several read lengths,
to split a pair's sweep into its fixed cost and its cost a step pair, and a
warp's latency from the integer pipe's issue limit.

    python3 scripts/wave_scaling.py [--out FILE]

For P in 132 .. 2,112 pairs (L = 256, band 128; 150 bp reads as
chip_smoke.py's packed_inputs plants them, q_len set to 50, 150 or 250 on
the score pass and 150 with the plane), each time is the best of two CUDA
graphs of 24 calls over 3 input sets. A pair's sweep is rows + band/2 - 1
step pairs (rows = q_len, or L with the plane). Prints the card's name and
power limit, then one JSON line a case and the fitted cost a step pair at
each P. Needs an NVIDIA GPU and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

L, BAND, PS, QLENS = 256, 128, (132, 264, 528, 1056, 2112), (50, 150, 250)


def main(argv: list[str] | None = None) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from phylign_tpu_torch.ops import extend as ope
    from phylign_tpu_torch.utils.platform import gpu_label

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wave_scaling: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    lines = [gpu_label()]
    rng = np.random.default_rng(9)
    base = [cs.packed_inputs(rng, max(PS), L, BAND) for _ in range(3)]
    for plane in (False, True):
        for p in PS:
            pts = []
            for qlen in QLENS if not plane else (150,):
                packs = []
                for h in base:
                    ql = np.full(p, qlen, np.int32)
                    packs.append([torch.from_numpy(np.ascontiguousarray(x)).cuda()
                                  for x in (h[4][:p], ql, h[5][:p], h[6][:p], h[7][:p])])
                ms = min(cs.graph_ms(lambda i: ope.extend_cuda_packed(*packs[i], L, L + BAND, ope.SrScoring(), plane),
                                     24, 3) for _ in range(2))
                pairs = (L if plane else qlen) + BAND // 2 - 1
                pts.append((pairs, ms))
                lines.append(json.dumps(dict(P=p, plane=plane, q_len=qlen, step_pairs=pairs, ms=ms,
                                             route=ope.packed_lanes(BAND, plane, L))))
            if len(pts) > 1:
                (x0, y0), (x1, y1) = pts[0], pts[-1]
                slope = (y1 - y0) / (x1 - x0) * 1e6  # ns a step pair
                lines.append(json.dumps(dict(P=p, plane=plane, ns_per_step_pair=slope,
                                             fixed_us=(y0 * 1e3 - slope * x0 / 1e3),
                                             warps_per_scheduler=p / (cs.SM_COUNT * 4))))
    for line in lines:
        print(line, flush=True)
    if args.out:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
