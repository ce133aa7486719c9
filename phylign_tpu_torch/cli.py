"""Command line of the PyTorch/CUDA port.

    python -m phylign_tpu_torch.cli {match,map,all} [--config config.yaml]
        [--workdir .] [--device cuda|cpu] [queries ...]

``match`` runs k-mer matching + candidate filtering (intermediate/01..04),
``map`` the align stage + aggregation + stats (intermediate/05_map,
output/*.sam_summary.gz and .stats), ``all`` both. The arguments are those
of ``phylign-tpu`` plus ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch versions of the kernels). Queries default to ``input/*``.
``--distributed [COORD]`` forms a ``torch.distributed`` process group
(SLURM / LSF detected, or explicit ranks) and shards batches by rank. A
config's ``mesh_shape`` then spans the processes: every rank takes part in
every batch's scoring (the doc axis may cross processes, and rank 0 writes
03_match), while the align stage shards batches by rank and splits each
rank's pairs over the query columns of its own cells.
"""

from __future__ import annotations

import argparse
import glob
import logging
import sys
from pathlib import Path

from phylign_tpu_torch.config import Config
from phylign_tpu_torch.version import __version__


def _load_config(args) -> Config:
    p = Path(args.config)
    if not p.exists() and not p.is_absolute():
        wd = Path(getattr(args, "workdir", "."))
        if (wd / p).exists():  # default config.yaml lives in the workdir
            p = wd / p
    cfg = Config.from_yaml(p) if p.exists() else Config()
    over = {}
    if getattr(args, "batches", None):
        over["batches"] = args.batches
    if getattr(args, "nb_best_hits", None) is not None:
        over["nb_best_hits"] = args.nb_best_hits
    if getattr(args, "threshold", None) is not None:
        over["cobs_kmer_thres"] = args.threshold
    return cfg.with_overrides(**over)


def _inputs(args) -> list[str]:
    if args.queries:
        return list(args.queries)
    found = []
    for suf in ("fa", "fasta", "fq", "fastq"):
        found += glob.glob(f"input/*.{suf}") + glob.glob(f"input/*.{suf}.gz")
    if not found:
        sys.exit("no query files given and none found under input/")
    return sorted(found)


def _maybe_distributed(args) -> None:
    """--distributed [COORD]: form the process group before any device
    work (``gloo`` for ``--device cpu``, ``nccl`` for cuda) and shard
    batches by rank. With no COORD the scheduler env (SLURM/LSF) is read,
    else the ranks given with --num-processes / --process-id. A group that
    does not form exits non-zero."""
    spec = getattr(args, "distributed", None)
    if spec is None:
        return
    from phylign_tpu_torch.parallel.launch import init_distributed

    try:
        num, pid = init_distributed(
            coordinator=None if spec == "auto" else spec,
            num_processes=args.num_processes, process_id=args.process_id,
            device=args.device,
        )
    except Exception as e:  # noqa: BLE001 - any failure to form the group
        sys.exit(f"--distributed: the process group did not form: {e}")
    if num > 1:
        args.num_processes, args.process_id = num, pid


def _wait_for_peers(
    paths,
    what: str,
    timeout_s: float,
    poll_s: float = 2.0,
    stall_s: float = 900.0,
    rank: int = 0,
):
    """Completion barrier for multi-process runs over a shared filesystem
    (rank 0 waits for its peers' outputs; in ``all`` the other ranks wait
    for rank 0's filter): block until every output exists (writers commit
    atomically via tmp-then-rename, so existence == complete), with
    progress logs and a timeout. Replaces the global barrier Snakemake's DAG gives the reference
    for free (its Snakefile:490-520,566-579).

    Peer-failure detection: beyond the absolute timeout, the barrier tracks
    PROGRESS — outputs appearing, or any pending peer's in-progress tmp/
    bench files advancing — and aborts after ``stall_s`` seconds with no
    movement. A crashed peer rank thus fails rank 0 in minutes with a
    pointed message, not after the 1-day absolute timeout (the reference
    gets this from the cluster scheduler's job-failure reporting,
    Makefile:118-131)."""
    import time

    def activity_stamp(missing):
        """Newest mtime of any in-flight artifact near the missing outputs:
        .tmp siblings (atomic-rename staging) and the per-stage benchmark
        logs peers append to while working."""
        newest = 0.0
        for p in missing:
            for cand in (p.parent,):
                try:
                    for q in cand.iterdir():
                        name = q.name
                        if name.endswith(".tmp") or name.startswith(p.name):
                            try:
                                newest = max(newest, q.stat().st_mtime)
                            except OSError:
                                pass
                except OSError:
                    pass
        return newest

    t0 = time.monotonic()
    last = -1
    last_progress = time.monotonic()
    last_stamp = 0.0
    while True:
        missing = [p for p in paths if not p.exists()]
        if not missing:
            return
        if len(missing) != last:
            print(
                f"rank {rank}: waiting on {len(missing)} {what} file(s) from "
                f"peer processes (next: {missing[0].name})",
                flush=True,
            )
            last = len(missing)
            last_progress = time.monotonic()
        stamp = activity_stamp(missing)
        if stamp > last_stamp:
            last_stamp = stamp
            last_progress = time.monotonic()
        stalled = time.monotonic() - last_progress
        if stall_s > 0 and stalled > stall_s:
            sys.exit(
                f"rank {rank}: no peer progress for {stalled:.0f}s while waiting "
                f"on {len(missing)} {what} file(s) (e.g. {missing[0]}) — a "
                "peer rank likely crashed; check its logs, re-run that rank "
                "(resume skips finished batches), then re-run this rank"
            )
        if time.monotonic() - t0 > timeout_s:
            sys.exit(
                f"rank {rank}: timed out after {timeout_s:.0f}s waiting on "
                f"{len(missing)} {what} file(s) (e.g. {missing[0]}); "
                "re-run this rank to resume once peers finish"
            )
        time.sleep(poll_s)


def cmd_match(args) -> None:
    from phylign_tpu_torch.pipeline.stages import Pipeline

    _maybe_distributed(args)
    cfg = _load_config(args)
    pl = Pipeline(cfg, args.workdir, device=args.device)
    stem = pl.preprocess(_inputs(args))
    num = args.num_processes or 1
    pid = args.process_id or 0
    mine = pl.match_share(num, pid)
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


def cmd_map(args) -> None:
    from phylign_tpu_torch.parallel.launch import shard_batches
    from phylign_tpu_torch.pipeline.stages import Pipeline

    _maybe_distributed(args)
    cfg = _load_config(args)
    pl = Pipeline(cfg, args.workdir, device=args.device)
    stem = pl.preprocess(_inputs(args))
    num = args.num_processes or 1
    pid = args.process_id or 0
    mine = shard_batches(pl.batches(), num, pid)
    pl.align(stem, mine)
    if num > 1:
        if pid != 0:
            print(
                f"process {pid}: aligned {len(mine)} batch(es); "
                "rank 0 aggregates once all ranks finish"
            )
            return
        _wait_for_peers(
            [pl.map_path(b, stem) for b in pl.batches()],
            "map", args.peer_wait_timeout, stall_s=args.peer_stall_timeout,
        )
    out = pl.aggregate(stem)
    pl.stats(stem)
    print(f"map done: {out}")


def cmd_all(args) -> None:
    import functools

    from phylign_tpu_torch.pipeline.stages import Pipeline

    _maybe_distributed(args)
    cfg = _load_config(args)
    pl = Pipeline(cfg, args.workdir, device=args.device)
    pid = args.process_id or 0
    wait = functools.partial(
        _wait_for_peers, timeout_s=args.peer_wait_timeout,
        stall_s=args.peer_stall_timeout, rank=pid,
    )
    out = pl.run_all(_inputs(args), args.num_processes or 1, pid, wait)
    if out is None:
        print(f"process {pid}: its batches are aligned; rank 0 aggregates once all ranks finish")
        return
    print(f"pipeline done: {out}")


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
            metavar="COORD",
            help="form a torch.distributed process group (multi-process / "
            "multi-host): coordinator host[:port], or bare flag to read "
            "SLURM/LSF (or --num-processes / --process-id)",
        )
        p.add_argument("queries", nargs="*", help="query fast[aq] files")

    common(sub.add_parser("match", help="k-mer match + filter"))
    common(sub.add_parser("map", help="align + aggregate + stats"))
    common(sub.add_parser("all", help="match + map"))

    args = ap.parse_args(argv)
    {"match": cmd_match, "map": cmd_map, "all": cmd_all}[args.cmd](args)


if __name__ == "__main__":
    main()
