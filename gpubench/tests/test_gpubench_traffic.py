"""The generator: one seed gives the same pool and the same jobs, and the
planted queries reach their documents and strains."""

import numpy as np
import pytest
import torch

from gpubench import fixtures
from gpubench.reference import align_ref, cobs_ref

from toy import spec


def _match_pool(cell, root, seed=11):
    s = spec(cell)
    return fixtures.MatchPool(s["config"], s["traffic"], seed, root, "cpu")


def _map_pool(cell, root, seed=11):
    s = spec(cell)
    return fixtures.MapPool(s["config"], s["traffic"], seed, root)


@pytest.mark.parametrize("cell", ["sr-reads.match", "amr-genes.match"])
def test_match_pool_repeats(cell, tmp_path):
    a, b = _match_pool(cell, tmp_path / "a"), _match_pool(cell, tmp_path / "b")
    for i in range(len(a.batches)):
        assert np.array_equal(a.words(i), b.words(i))
    ja, jb = a.job(3), b.job(3)
    assert ja.names == jb.names and ja.seqs == jb.seqs
    assert a.job(4).seqs != ja.seqs


@pytest.mark.parametrize("cell", ["sr-reads.match", "amr-genes.match"])
def test_planted_queries_reach_their_documents(cell, tmp_path):
    pool = _match_pool(cell, tmp_path)
    job = pool.job(1)
    planted = [k for k, t in enumerate(job.truth) if t is not None]
    assert planted and len(planted) < len(job.seqs) or cell.startswith("amr")
    hashes = cobs_ref.kmer_hashes([job.seqs[k] for k in planted])
    exact = pool.traffic.get("sub_rate", 0) == 0
    for b in range(len(pool.batches)):
        words = torch.from_numpy(pool.words(b).view(np.int32))
        sc = cobs_ref.scores(words, [cobs_ref.bloom_rows(h, pool.rows) for h in hashes], pool.docs)
        for row, k, h in zip(sc, planted, hashes):
            for bb, g in job.truth[k]:
                if bb != b:
                    continue
                docs = row[g * pool.group : (g + 1) * pool.group]
                if exact:
                    assert (docs == len(h)).all()
                else:  # alleles: every doc of the group above the cut
                    assert (docs >= pool.cfg["config"]["cobs_kmer_thres"] * len(h)).all()


@pytest.mark.parametrize("cell", ["sr-reads.map", "amr-genes.map"])
def test_map_pool_repeats(cell, tmp_path):
    a, b = _map_pool(cell, tmp_path / "a"), _map_pool(cell, tmp_path / "b")
    assert all(np.array_equal(a.contigs[k][c], b.contigs[k][c]) for k in a.contigs for c in a.contigs[k])
    assert (tmp_path / "a" / "asms" / f"{a.batches[0]}.tar.xz").exists()
    ja, jb = a.job(2), b.job(2)
    assert ja.seqs == jb.seqs and ja.cands == jb.cands and ja.truth == jb.truth


@pytest.mark.parametrize("cell", ["sr-reads.map", "amr-genes.map"])
def test_planted_queries_reach_their_strains(cell, tmp_path):
    pool = _map_pool(cell, tmp_path)
    job = pool.job(1)
    sc = pool.cfg["scoring"]
    pairs = []
    for seq, tr, cands in zip(job.seqs, job.truth, job.cands):
        if tr is None:
            continue
        b, s, cname, pos, span, strand = tr
        assert pool.accs[b][s] in cands and len(cands) == len(pool.accs[b])
        ctg = pool.contigs[pool.accs[b][s]][cname]
        q = align_ref.revcomp(seq) if strand else seq
        pairs.append((q, fixtures.seq_bytes(ctg[pos : pos + span])))
    best = align_ref.local_best(pairs, sc)
    # 1% substitutions and at most one deletion: most of each query aligns
    assert all(v >= 0.6 * sc["A"] * len(q) for v, (q, _) in zip(best, pairs))


def test_device_hashes_equal_the_reference():
    rng = np.random.default_rng(5)
    seqs = [fixtures.seq_bytes(rng.integers(0, 4, int(n)).astype(np.uint8)) for n in rng.integers(0, 400, 40)]
    seqs += [b"A" * 31, b"T" * 40, b"ACGT" * 20]
    got, want = fixtures.kmer_hashes_device(seqs, "cpu"), cobs_ref.kmer_hashes(seqs)
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
