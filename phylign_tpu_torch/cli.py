"""Command line of the PyTorch/CUDA port (``phylign-tpu-torch``, or
``python -m phylign_tpu_torch.cli``). It mirrors the reference's Make
targets, as ``phylign-tpu`` does:

    phylign-tpu-torch all       match + map
    phylign-tpu-torch download  fetch batch artifacts from Zenodo
    phylign-tpu-torch match     k-mer matching + candidate filtering (01..04)
    phylign-tpu-torch map       alignment + aggregation + stats (05, output/)
    phylign-tpu-torch stats     recompute output stats
    phylign-tpu-torch test      self-contained golden test on a synthetic fixture
    phylign-tpu-torch fixture   generate a synthetic 3-batch fixture + reads
    phylign-tpu-torch clean     remove intermediates (keeps downloads)
    phylign-tpu-torch build-index / inspect-index / preflight / index-sizes
                                / report / config / check-cluster

The arguments, outputs and exit codes are those of ``phylign-tpu``, plus
``--device`` on the subcommands that run the pipeline (``match``, ``map``,
``all``, ``test``, ``preflight``): default ``cuda``, which runs the
hand-written kernels and fails on a host without a card; ``cpu`` runs the
plain PyTorch versions. Queries default to ``input/*``.
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
import shutil
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


def _my_batches(args, pl) -> tuple[list[str], int, int]:
    """Batch subset for this process (cluster-style sharding over a shared
    filesystem, like the reference's one-job-per-batch cluster mode)."""
    from phylign_tpu_torch.parallel.launch import shard_batches

    num = args.num_processes or 1
    pid = args.process_id or 0
    return shard_batches(pl.batches(), num, pid), num, pid


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
    from phylign_tpu_torch.pipeline.stages import Pipeline

    _maybe_distributed(args)
    cfg = _load_config(args)
    pl = Pipeline(cfg, args.workdir, device=args.device)
    stem = pl.preprocess(_inputs(args))
    mine, num, pid = _my_batches(args, pl)
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


def cmd_download(args) -> None:
    from phylign_tpu_torch.pipeline.download import download_batches
    from phylign_tpu_torch.pipeline.stages import Pipeline

    cfg = _load_config(args)
    pl = Pipeline(cfg, args.workdir, device="cpu")  # for its paths only
    status = download_batches(
        pl.batches(),
        Path(args.workdir) / cfg.download_dir,
        cfg.download_retries,
        cfg.download_retry_wait,
        only=args.only,
        max_threads=cfg.max_download_threads,
    )
    for batch, st in status.items():
        print(f"{batch}: {st}")


def cmd_check_cluster(args) -> None:
    """Abort (exit 1) unless the config is valid for a cluster run
    (the reference's check_if_config_is_ok_for_cluster_run.py)."""
    from phylign_tpu_torch.parallel.launch import check_cluster_config

    try:
        check_cluster_config(_load_config(args))
    except ValueError as e:
        sys.exit(f"ERROR: {e}")
    print("config OK for cluster run")


def cmd_stats(args) -> None:
    from phylign_tpu_torch.io.stats import compute_stats

    st = compute_stats(args.summary, args.queries)
    sys.stdout.write(st.to_tsv())


def cmd_clean(args) -> None:
    dirs = ["intermediate", "output", "logs"]
    if args.all:  # `make cleanall`: also drop downloads
        dirs += ["cobs", "asms"]
    for d in dirs:
        p = Path(args.workdir) / d
        if p.exists():
            shutil.rmtree(p)
            print(f"removed {p}")


def cmd_config(args) -> None:
    """Print the resolved configuration (the reference's `make config`,
    its Makefile:102-107)."""
    import dataclasses

    import yaml

    cfg = _load_config(args)
    sys.stdout.write(yaml.safe_dump(dataclasses.asdict(cfg), sort_keys=False))


def cmd_build_index(args) -> None:
    from phylign_tpu_torch.io.cobs import build_index_from_tar, write_classic_index

    idx = build_index_from_tar(
        args.tar, term_size=args.kmer, num_hashes=args.hashes, fpr=args.fpr
    )
    write_classic_index(args.out, idx)
    print(
        f"built {args.out}: {idx.num_docs} docs, k={idx.term_size}, "
        f"{idx.signature_size} Bloom rows, {idx.num_hashes} hash(es)"
    )


def cmd_preflight(args) -> None:
    """First-contact compatibility report for REAL downloaded artifacts:
    once the Zenodo data is reachable, run

        phylign-tpu-torch download --batches data/batches_small.txt
        phylign-tpu-torch preflight [--golden data/...sam_summary.xz]

    and every assumption made offline is probed against a real batch:
    xz integrity, COBS header field order + payload size, the doc-name
    rid_{accession} pattern (postprocess_cobs.py:16-18 strips it), the
    accession allow-list, and tar member naming. With --golden it finishes
    with the reference's own `make test` oracle (cols 1-3 diff) end-to-end,
    run on --device. Exit 0 = compatible."""
    import lzma
    import tarfile

    from phylign_tpu_torch.io.cobs import inspect_classic_index
    from phylign_tpu_torch.pipeline.stages import Pipeline

    cfg = _load_config(args)
    pl = Pipeline(cfg, args.workdir, device=args.device)
    batches = [args.batch] if args.batch else pl.batches()
    wd = Path(args.workdir)
    failures: list[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}" + (f": {detail}" if detail else ""))
        if not ok:
            failures.append(name)

    for batch in batches:
        print(f"batch {batch}:")
        cobs_xz = pl.cobs_path(batch)
        asms_xz = pl.asms_path(batch)
        for p, kind in ((cobs_xz, "cobs index"), (asms_xz, "assembly tar")):
            if not p.exists():
                check(f"{kind} present", False, f"{p} missing (run `phylign-tpu download`)")
                continue
            # format readability (the download stage separately applies the
            # reference's >= 100 kB size heuristic at fetch time)
            try:
                with lzma.open(p) as f:
                    f.read(16)
                check(f"{kind} xz readable", True, f"{p.stat().st_size} B")
            except (lzma.LZMAError, OSError) as e:
                check(f"{kind} xz readable", False, str(e))
        if not cobs_xz.exists():
            continue

        rep = inspect_classic_index(cobs_xz)
        check(
            "COBS header parse + payload size",
            bool(rep.get("ok")),
            rep.get("error", "")
            or f"k={rep.get('term_size')} docs={rep.get('num_docs')} "
            f"rows={rep.get('signature_size')} hashes={rep.get('num_hashes')}",
        )
        if rep.get("ok"):
            check(
                "term size == 31 (canonical 31-mers)",
                rep.get("term_size") == 31,
                str(rep.get("term_size")),
            )
            check(
                "doc names carry the rid_{accession} prefix",
                bool(rep.get("doc_names_rid_prefixed")),
                ", ".join(rep.get("doc_names_head", [])[:2]),
            )
            accs = pl.batch_accessions(batch)
            if accs is not None:
                heads = [
                    n.partition("_")[2] for n in rep.get("doc_names_head", [])
                ]
                check(
                    "doc accessions in the batch allow-list",
                    all(h in accs for h in heads if h),
                    ", ".join(heads[:2]),
                )
            else:
                print("  [SKIP] accession allow-list (no data/661k_batches.txt[.xz])")
        if asms_xz.exists():
            try:
                with tarfile.open(asms_xz, "r|xz") as tf:
                    names = []
                    for m in tf:
                        names.append(m.name)
                        if len(names) >= 3:
                            break
                check(
                    "tar members look like {accession}.fa",
                    all(n.rsplit("/", 1)[-1].endswith(".fa") for n in names),
                    ", ".join(names[:2]),
                )
            except (tarfile.TarError, lzma.LZMAError) as e:
                check("assembly tar readable", False, str(e))

    if args.golden:
        print("golden end-to-end diff (reference `make test` oracle):")
        from phylign_tpu_torch.testing import run_reference_golden_test

        ok = run_reference_golden_test(
            wd, args.golden, cfg.batches, args.queries or None, device=args.device
        )
        check("sam_summary cols 1-3 vs golden", ok)

    if failures:
        sys.exit(f"preflight FAILED: {len(failures)} check(s): {', '.join(failures)}")
    print("preflight PASSED: artifacts are compatible with this build")


def cmd_inspect_index(args) -> None:
    """Header diagnostic for a .cobs_classic[.xz] file: parsed fields +
    sanity/payload checks (the offline format-compatibility probe; see
    docs/cobs_format.md)."""
    import json

    from phylign_tpu_torch.io.cobs import inspect_classic_index

    report = inspect_classic_index(args.index)
    print(json.dumps(report, indent=2))
    if not report.get("ok"):
        sys.exit(1)


def cmd_index_sizes(args) -> None:
    from phylign_tpu_torch.utils.indexsizes import scan_index_sizes

    n = scan_index_sizes(args.cobs_dir, args.out)
    print(f"scanned {n} indexes -> {args.out}")


def cmd_report(args) -> None:
    from phylign_tpu_torch.utils.report import write_report

    out = write_report(args.workdir)
    print(f"report written: {out}")


def cmd_fixture(args) -> None:
    from phylign_tpu_torch.testing import make_fixture

    paths = make_fixture(Path(args.workdir), n_batches=args.n_batches, seed=args.seed)
    print(f"fixture written under {args.workdir}:")
    for p in paths:
        print(f"  {p}")


def cmd_test(args) -> None:
    if args.golden:
        from phylign_tpu_torch.testing import run_reference_golden_test

        ok = run_reference_golden_test(
            Path(args.workdir), args.golden, args.batches or "data/batches_small.txt",
            args.queries or None, device=args.device,
        )
        oracle = "reference golden file"
    else:
        from phylign_tpu_torch.testing import run_golden_test

        ok = run_golden_test(Path(args.workdir), device=args.device)
        oracle = "fixture oracle"
    if ok:
        print(f"test PASSED: sam_summary columns 1-3 match the {oracle}")
    else:
        sys.exit(f"test FAILED: sam_summary differs from the {oracle}")


def cli_entry(argv: list[str] | None = None) -> None:
    """Console entry point (pyproject `phylign-tpu-torch` and `python -m`):
    dispatch, then exit 0, 1 (with the message or traceback on stderr) or
    130 on an interrupt. The JAX package leaves through ``os._exit``
    because its TPU plugin's threads can abort the interpreter's teardown;
    CUDA and NCCL teardown on the H100 showed no such abort (``chip_smoke.py``
    phase 9 runs this entry point in a subprocess), so this one exits
    normally. Programmatic callers (tests, embedding) use main(), which
    returns normally."""
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        if isinstance(e.code, int):
            code = e.code
        elif e.code is not None:
            print(e.code, file=sys.stderr)
            code = 1
    except KeyboardInterrupt:
        code = 130
    except Exception:  # noqa: BLE001 - the process boundary: report and exit 1
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    sys.exit(code)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.INFO,
        format="[%(asctime)s] (%(levelname)s) %(message)s",
    )
    ap = argparse.ArgumentParser(prog="phylign-tpu-torch", description=__doc__)
    ap.add_argument("--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device(p):
        p.add_argument(
            "--device", default="cuda",
            help="torch device: cuda (the hand-written kernels) or cpu",
        )

    def common(p, queries=True, dev=True):
        p.add_argument("--config", default="config.yaml")
        p.add_argument("--workdir", default=".")
        p.add_argument("--batches", help="batches list file override")
        p.add_argument("--nb-best-hits", type=int, dest="nb_best_hits")
        p.add_argument("--threshold", type=float, help="cobs_kmer_thres override")
        if dev:
            device(p)
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
        if queries:
            p.add_argument("queries", nargs="*", help="query fast[aq] files")

    common(sub.add_parser("all", help="match + map"))
    common(sub.add_parser("match", help="k-mer match + filter"))
    common(sub.add_parser("map", help="align + aggregate + stats"))
    p = sub.add_parser("download", help="fetch batches from Zenodo")
    common(p, queries=False, dev=False)
    p.add_argument(
        "--only",
        choices=["all", "cobs", "asms"],
        default="all",
        help="artifact kind (make download_cobs / download_asms)",
    )

    p = sub.add_parser(
        "check-cluster", help="validate the config for a cluster run"
    )
    p.add_argument("--config", default="config.yaml")
    p.add_argument("--workdir", default=".")

    p = sub.add_parser("config", help="print the resolved configuration")
    p.add_argument("--config", default="config.yaml")
    p.add_argument("--workdir", default=".")
    p.add_argument("--batches", help="batches list file override")
    p.add_argument("--nb-best-hits", type=int, dest="nb_best_hits")
    p.add_argument("--threshold", type=float, help="cobs_kmer_thres override")

    p = sub.add_parser("stats", help="recompute stats from a sam_summary")
    p.add_argument("summary")
    p.add_argument("--queries")

    p = sub.add_parser("clean", help="remove intermediates and outputs")
    p.add_argument("--workdir", default=".")
    p.add_argument(
        "--all", action="store_true", help="also remove downloads (make cleanall)"
    )

    p = sub.add_parser("fixture", help="generate a synthetic test fixture")
    p.add_argument("--workdir", default=".")
    p.add_argument("--n-batches", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)

    p = sub.add_parser("test", help="run the golden test (synthetic by default)")
    p.add_argument("--workdir", default=".")
    p.add_argument("--golden", help="real golden sam_summary(.xz) to diff against")
    p.add_argument("--batches", help="batches file for --golden mode")
    device(p)
    p.add_argument("queries", nargs="*", help="query files for --golden mode")

    p = sub.add_parser("build-index", help="build a .cobs_classic from a batch tar.xz")
    p.add_argument("tar")
    p.add_argument("out")
    p.add_argument("--kmer", type=int, default=31)
    p.add_argument("--hashes", type=int, default=1)
    p.add_argument("--fpr", type=float, default=0.3)

    p = sub.add_parser("report", help="HTML run report from logs + stats")
    p.add_argument("--workdir", default=".")

    p = sub.add_parser(
        "inspect-index",
        help="parse + sanity-check a .cobs_classic header (format diagnostic)",
    )
    p.add_argument("index")

    p = sub.add_parser(
        "preflight",
        help="first-contact compatibility report for real downloaded "
        "artifacts (xz, COBS header, doc names, tar; --golden adds the "
        "end-to-end cols-1-3 diff)",
    )
    p.add_argument("--config", default="config.yaml")
    p.add_argument("--workdir", default=".")
    p.add_argument("--batches", help="batches list file override")
    p.add_argument("--batch", help="probe a single batch only")
    p.add_argument("--golden", help="golden sam_summary(.xz) for the e2e diff")
    device(p)
    p.add_argument("queries", nargs="*", help="query files for --golden mode")

    p = sub.add_parser(
        "index-sizes", help="scan cobs/*.xz decompressed sizes (RAM scheduling table)"
    )
    p.add_argument("--cobs-dir", default="cobs")
    p.add_argument("--out", default="data/decompressed_indexes_sizes.txt")

    args = ap.parse_args(argv)
    {
        "all": cmd_all,
        "match": cmd_match,
        "map": cmd_map,
        "download": cmd_download,
        "check-cluster": cmd_check_cluster,
        "config": cmd_config,
        "stats": cmd_stats,
        "clean": cmd_clean,
        "fixture": cmd_fixture,
        "test": cmd_test,
        "build-index": cmd_build_index,
        "inspect-index": cmd_inspect_index,
        "preflight": cmd_preflight,
        "report": cmd_report,
        "index-sizes": cmd_index_sizes,
    }[args.cmd](args)


if __name__ == "__main__":
    cli_entry()
