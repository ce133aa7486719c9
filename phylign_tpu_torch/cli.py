"""Command line of the PyTorch/CUDA port.

    python -m phylign_tpu_torch.cli match [--config config.yaml]
        [--workdir .] [--device cuda|cpu] [queries ...]

``match`` runs k-mer matching + candidate filtering (intermediate/01..04),
with the same arguments as ``phylign-tpu match`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels). ``map``
and ``all`` (the align stage) are not yet ported: they exit non-zero.
Queries default to ``input/*``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from phylign_tpu.cli import _inputs, _load_config, _wait_for_peers
from phylign_tpu.version import __version__

NOT_PORTED = (
    "not yet ported to phylign_tpu_torch: the align stage is ROADMAP "
    "queue A items 5-10 (chain -> extend -> fused -> engine -> stages/CLI "
    "-> aligner); run `python -m phylign_tpu.cli {cmd}` meanwhile"
)


def cmd_match(args) -> None:
    from phylign_tpu.parallel.launch import shard_batches
    from phylign_tpu_torch.pipeline.stages import Pipeline

    if args.distributed is not None:
        sys.exit(
            "--distributed is not yet ported to phylign_tpu_torch "
            "(ROADMAP queue A item 11, parallel/)"
        )
    cfg = _load_config(args)
    pl = Pipeline(cfg, args.workdir, device=args.device)
    stem = pl.preprocess(_inputs(args))
    num = args.num_processes or 1
    pid = args.process_id or 0
    mine = shard_batches(pl.batches(), num, pid)
    pl.match(stem, mine)
    if num > 1:
        if pid != 0:
            print(
                f"process {pid}: matched {len(mine)} batch(es); "
                "rank 0 runs the filter once all ranks finish"
            )
            return
        _wait_for_peers(
            [pl.match_path(b, stem) for b in pl.batches()],
            "match", args.peer_wait_timeout, stall_s=args.peer_stall_timeout,
        )
    out = pl.filter(stem)
    print(f"match done: {out}")


def cmd_not_ported(args) -> None:
    sys.exit(f"{args.cmd}: " + NOT_PORTED.format(cmd=args.cmd))


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.INFO,
        format="[%(asctime)s] (%(levelname)s) %(message)s",
    )
    ap = argparse.ArgumentParser(prog="phylign-tpu-torch", description=__doc__)
    ap.add_argument("--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--config", default="config.yaml")
        p.add_argument("--workdir", default=".")
        p.add_argument("--batches", help="batches list file override")
        p.add_argument("--nb-best-hits", type=int, dest="nb_best_hits")
        p.add_argument("--threshold", type=float, help="cobs_kmer_thres override")
        p.add_argument(
            "--device", default="cuda",
            help="torch device: cuda (the hand-written kernels) or cpu",
        )
        p.add_argument(
            "--num-processes", type=int, default=None,
            help="shard batches across N cooperating processes (shared FS)",
        )
        p.add_argument(
            "--process-id", type=int, default=None, help="this process's rank"
        )
        p.add_argument(
            "--peer-wait-timeout", type=float, default=86400.0,
            metavar="SECONDS",
            help="rank 0's barrier timeout waiting for peer ranks' outputs "
            "(multi-process runs; default 1 day)",
        )
        p.add_argument(
            "--peer-stall-timeout", type=float, default=900.0,
            metavar="SECONDS",
            help="abort the rank-0 barrier after this long with NO peer "
            "progress; 0 disables (default 900)",
        )
        p.add_argument(
            "--distributed", nargs="?", const="auto", default=None,
            metavar="COORD", help="multi-host runs (not yet ported)",
        )
        p.add_argument("queries", nargs="*", help="query fast[aq] files")

    common(sub.add_parser("match", help="k-mer match + filter"))
    common(sub.add_parser("map", help="align + aggregate + stats (not yet ported)"))
    common(sub.add_parser("all", help="match + map (not yet ported)"))

    args = ap.parse_args(argv)
    {"match": cmd_match, "map": cmd_not_ported, "all": cmd_not_ported}[
        args.cmd
    ](args)


if __name__ == "__main__":
    main()
