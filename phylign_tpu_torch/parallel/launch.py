"""Multi-process launching: the batch sharding of ``phylign_tpu/parallel/
launch.py``. Every process runs the same pipeline over a disjoint subset of
batches and a shared filesystem is the only data plane (the reference's
cluster mode, Makefile:118-131). Multi-GPU matching is not ported yet
(ROADMAP queue A item 11).
"""

from __future__ import annotations


def shard_batches(batches: list[str], num_processes: int, process_id: int) -> list[str]:
    """Deterministic round-robin batch assignment (the outer parallel axis;
    mirrors the reference's one-cluster-job-per-batch scheduling)."""
    return [b for i, b in enumerate(batches) if i % num_processes == process_id]
