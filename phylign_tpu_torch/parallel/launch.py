"""Multi-process launching (the counterpart of
``phylign_tpu/parallel/launch.py``).

The reference's multi-node story is cluster submission with a shared
filesystem (its Makefile:118-131, scripts/submit_lsf.sh): every node runs
the same pipeline over a disjoint subset of batches and the filesystem is
the only data plane. The port keeps that outer axis (batch sharding across
processes) and adds ``torch.distributed`` for a device mesh that spans
processes (parallel.mesh, parallel.dist).

Environment autodetection covers SLURM and LSF (the reference's two
backends) plus explicit settings.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch

log = logging.getLogger("phylign_tpu_torch.launch")


def detect_process_env() -> tuple[str | None, int, int]:
    """(coordinator, num_processes, process_id) from scheduler env vars."""
    env = os.environ
    if "SLURM_NTASKS" in env:  # SLURM (ref: Makefile:118-124 cluster_slurm)
        num = int(env["SLURM_NTASKS"])
        pid = int(env.get("SLURM_PROCID", 0))
        nodelist = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_NODELIST", "")
        coord = nodelist.split(",")[0].split("[")[0] or None
        return coord, num, pid
    if "LSB_DJOB_NUMPROC" in env:  # LSF (ref: Makefile:126-131 cluster_lsf)
        num = int(env["LSB_DJOB_NUMPROC"])
        hosts = env.get("LSB_HOSTS", "").split()
        pid = int(env.get("LSF_PM_TASKID", env.get("LS_JOBPID", 0))) % max(1, num)
        return (hosts[0] if hosts else None), num, pid
    return None, 1, 0


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    port: int = 9377,
    device: str | torch.device = "cuda",
    timeout_s: float = 600.0,
) -> tuple[int, int]:
    """Form the ``torch.distributed`` process group of a multi-process run
    (``gloo`` for a CPU run, ``nccl`` for a CUDA one), rendezvous over TCP
    at ``coordinator`` (host or host:port; the local host by default);
    a no-op for one process. Raises when the group does not form within
    ``timeout_s``. Returns (num_processes, process_id)."""
    auto_coord, auto_num, auto_pid = detect_process_env()
    coordinator = coordinator or auto_coord or "127.0.0.1"
    num_processes = num_processes if num_processes is not None else auto_num
    process_id = process_id if process_id is not None else auto_pid
    if num_processes <= 1:
        return 1, 0
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not a rank of {num_processes} processes")
    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    addr = coordinator if ":" in coordinator else f"{coordinator}:{port}"
    log.info(
        "torch.distributed.init_process_group(%s, tcp://%s, world_size=%d, rank=%d)",
        backend, addr, num_processes, process_id,
    )
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    return num_processes, process_id


def check_cluster_config(cfg) -> None:
    """Cluster-mode config precheck (the reference aborts a cluster run when
    resource knobs are auto-scaled, since per-job resources must be fixed at
    submit time: its scripts/check_if_config_is_ok_for_cluster_run.py:1-20).
    Here the analogous auto-scaled knobs are ``threads`` and ``cobs_threads``."""
    problems = []
    for key in ("threads", "cobs_threads"):
        val = getattr(cfg, key)
        try:
            int(val)
        except (TypeError, ValueError):
            problems.append(
                f"{key} must be a fixed int for cluster runs (got {val!r})"
            )
    if problems:
        raise ValueError(
            "config is not valid for a cluster run: " + "; ".join(problems)
        )


def shard_batches(batches: list[str], num_processes: int, process_id: int) -> list[str]:
    """Deterministic round-robin batch assignment (the outer parallel axis;
    mirrors the reference's one-cluster-job-per-batch scheduling)."""
    return [b for i, b in enumerate(batches) if i % num_processes == process_id]
