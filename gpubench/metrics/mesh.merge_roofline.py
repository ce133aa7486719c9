"""The mesh's window merge's share of its byte bound (%): the least time
of the merge (gpubench/bounds.py, the card's memory rate) over the device
time of merge_topk_kernel. For each scored query of a batch the merge reads
the doc shards' qualifying counts and writes the merged window of kk
(value, document) pairs of int32 and its count; the shards' window entries
it reads depend on the scores, so they are left out of the bound (a lower
bound: the share cannot pass 100%). The scored queries are a job's queries
with distinct Bloom-row multisets (duplicates are scored once), counted
with the reference's hashing; kk is the window of top-n with ties that
nb_best_hits asks for (n + 33 rounded up to 32, at most the documents), and
the shards come from the configuration's mesh_shape, so the bound is the
same whatever implements the merge."""

import numpy as np

from gpubench import bounds
from gpubench.reference import cobs_ref


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(r"\bmerge_topk_kernel\b")
    if t <= 0:
        return None
    pool = run.pool
    nd = int(pool.cfg["config"]["mesh_shape"].split("x")[0])
    nb = int(pool.cfg["config"]["nb_best_hits"])
    kk = min(pool.docs, -(-min(nb + 33, pool.docs) // 32) * 32)
    per_query = nd * 4 + kk * 2 * 4 + 4
    need = 0.0
    for job, _, _ in run.jobs:
        hashes = cobs_ref.kmer_hashes(job.seqs)
        scored = len({np.sort(cobs_ref.bloom_rows(h, pool.rows)).tobytes() for h in hashes})
        need += len(pool.batches) * bounds.bound_s(scored * per_query)
    return 100.0 * need / t
