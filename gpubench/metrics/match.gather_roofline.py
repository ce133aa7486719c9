"""The match kernel's share of its roofline (%): the least time of the
gather (each batch's distinct Bloom rows that the job's queries name, at
the row's bytes, at the card's memory rate: gpubench/bounds.py) over the
device time of the match_popcount kernels (csrc/match_popcount.cu). The
rows are counted from the job's own queries with the reference's hashing,
so the bound is the same whatever implements the search."""

import numpy as np

from gpubench import bounds
from gpubench.reference import cobs_ref


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(r"\bmatch_popcount_kernel\b")
    if t <= 0:
        return None
    pool = run.pool
    need = 0.0
    for job, _, _ in run.jobs:
        rows = cobs_ref.bloom_rows(np.concatenate(cobs_ref.kmer_hashes(job.seqs)), pool.rows)
        need += len(pool.batches) * bounds.gather_bound_s(len(np.unique(rows)), pool.wp)
    return 100.0 * need / t
