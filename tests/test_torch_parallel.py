"""The port's multi-device path (``phylign_tpu_torch.parallel``: mesh,
sharded match + top-k, sharded chain / extend / fused flush, the
Pipeline's ``mesh_shape``) on the CPU, where every shard of a mesh sits on
the one CPU device and runs the kernels' plain versions, held to the JAX
package's ``phylign_tpu.parallel`` on conftest's 8 virtual CPU devices and
to the port's own single-device results. Mirrors tests/test_parallel.py,
tests/test_mesh_scaled.py and tests/test_fused_align.py's mesh case.

Tolerance: exact everywhere. ``torch.topk`` orders equal values freely
(``jax.lax.top_k`` puts the lower index first), so a top-k window is
compared as the set of its (doc, score) pairs; counts and scores exactly.
"""

import gzip
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from phylign_tpu import testing as jtesting
from phylign_tpu.config import Config as JaxConfig
from phylign_tpu.io import cobs as jcobs
from phylign_tpu.models.matcher import Matcher as JaxMatcher
from phylign_tpu.models.matcher import device_index_bytes as jax_index_bytes
from phylign_tpu.parallel import dist as jdist
from phylign_tpu.pipeline.stages import Pipeline as JaxPipeline
from phylign_tpu_torch import testing as ttesting
from phylign_tpu_torch.align import engine as tae
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.io import cobs as tcobs
from phylign_tpu_torch.models.matcher import Matcher, device_index_bytes
from phylign_tpu_torch.ops.extend import BAND, pack2bit
from phylign_tpu_torch.ops.match import match_scores_ref
from phylign_tpu_torch.parallel import dist
from phylign_tpu_torch.parallel.mesh import Mesh, make_mesh, parse_mesh_shape
from phylign_tpu_torch.pipeline.stages import Pipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_fused import PORT, mixed_pool  # noqa: E402

SHAPES = [(4, 2), (2, 2)]


def jax_mesh(nd: int, nq: int) -> JaxMesh:
    return JaxMesh(np.array(jax.devices()[: nd * nq]).reshape(nd, nq), ("d", "q"))


def cpu_mesh(nd: int, nq: int):
    return make_mesh(nd, nq, devices="cpu")


def make_inputs(rng, s=512, wp=8 * 4, q=16, k=32):
    """tests/test_parallel.py:make_inputs: a random [S+1, Wp] matrix whose
    last row is the zero padding row, and [Q, K, 1] rows."""
    words = np.zeros((s + 1, wp), np.uint32)
    words[:s] = rng.integers(0, 2**32, (s, wp), dtype=np.uint32)
    rows = rng.integers(0, s, (q, k, 1)).astype(np.int32)
    return words, rows


def window_set(vals, ids, q):
    return {(int(i), int(v)) for v, i in zip(vals[q], ids[q]) if v >= 0}


@pytest.mark.parametrize("nd,nq", SHAPES)
def test_dist_match_scores(nd, nq):
    words, rows = make_inputs(np.random.default_rng(0))
    got = dist.fetch(dist.dist_match_scores(cpu_mesh(nd, nq), words.view(np.int32), rows))
    want = match_scores_ref(torch.from_numpy(words.view(np.int32)), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    jgot = jdist.dist_match_scores(jax_mesh(nd, nq), jnp.asarray(words), jnp.asarray(rows))
    np.testing.assert_array_equal(got, np.asarray(jgot))


@pytest.mark.parametrize("nd,nq", SHAPES)
def test_dist_topk_and_threshold_topk_equal_jax_as_sets(nd, nq):
    rng = np.random.default_rng(1)
    words, rows = make_inputs(rng)
    mesh, jm = cpu_mesh(nd, nq), jax_mesh(nd, nq)
    w32 = words.view(np.int32)
    scores = dist.dist_match_scores(mesh, w32, rows)
    topv, topi = (dist.fetch(x) for x in dist.dist_topk(mesh, scores, n_best=4))
    jscores = jdist.dist_match_scores(jm, jnp.asarray(words), jnp.asarray(rows))
    jv, ji = (np.asarray(x) for x in jdist.dist_topk(jm, jscores, n_best=4))
    s = dist.fetch(scores)
    assert topv.shape == jv.shape == (16, 4 + dist.TIE_SLACK)
    for q in range(s.shape[0]):
        np.testing.assert_array_equal(topv[q], jv[q])  # sorted values
        np.testing.assert_array_equal(s[q][topi[q]], topv[q])  # ids realize them
        cut = topv[q][-1]  # below the last value the window holds every doc
        assert {(i, v) for i, v in zip(topi[q], topv[q]) if v > cut} == {
            (i, v) for i, v in zip(ji[q], jv[q]) if v > cut
        }
    # threshold + top-k: each query's cut is the lowest score that still
    # leaves no more qualifying docs than kk (the padding columns >= d
    # excluded)
    d, kk = 32 * words.shape[1] - 5, 64
    cut = np.array([min(v for v in np.unique(r) if (r >= v).sum() <= kk) for r in s[:, :d]], np.int32)
    cut[3] = 1 << 30  # a query nothing qualifies for
    got = [dist.fetch(x) for x in dist.dist_threshold_topk(mesh, w32, rows, cut, d, kk)]
    want = [np.asarray(x) for x in jdist.dist_threshold_topk(
        jm, jnp.asarray(words), jnp.asarray(rows), jnp.asarray(cut), d, kk)]
    np.testing.assert_array_equal(got[2], want[2])  # n_keep
    assert got[2][3] == 0 and (got[2] <= kk).all() and got[2].max() >= 20
    for q in range(16):
        assert window_set(got[0], got[1], q) == window_set(want[0], want[1], q)
        assert len(window_set(got[0], got[1], q)) == got[2][q]
        assert (got[0][q][got[2][q]:] == -1).all()


def test_full_step_equals_jax_field_by_field():
    rng = np.random.default_rng(2)
    words, rows = make_inputs(rng, q=16)
    n_kmers = np.full(16, 32, np.int32)
    n_kmers[5] = 0
    p, l = 16, 64
    q_codes = rng.integers(0, 4, (p, l)).astype(np.uint8)
    q_len = np.full(p, l, np.int32)
    rwin = rng.integers(0, 4, (p, l + BAND)).astype(np.uint8)
    rwin[::2, 20 : 20 + l] = q_codes[::2]
    rvalid = np.ones((p, l + BAND), bool)
    anchors_q = np.tile(np.arange(0, 64, 8, np.int32), (p, 1))
    anchors_r = anchors_q + 100
    anchors_r[3, 4:] = 2**30  # padding slots
    args = (n_kmers, q_codes, q_len, rwin, rvalid, anchors_r, anchors_q)
    got = dist.fetch(dist.full_step(cpu_mesh(4, 2), words.view(np.int32), rows, *args))
    want = jdist.full_step(jax_mesh(4, 2), jnp.asarray(words), jnp.asarray(rows),
                           *[jnp.asarray(a) for a in args])
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for key in ("scores", "top_n_keep", "chain_score", "chain_count", "align_score"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert int(got["chain_count"][0]) == 8
    kk = got["top_values"].shape[1]
    assert (got["top_n_keep"] > kk).any() and (got["top_n_keep"] <= kk).any()
    for q in range(16):
        gv, gi, wv, wi = got["top_values"][q], got["top_doc_ids"][q], want["top_values"][q], want["top_doc_ids"][q]
        np.testing.assert_array_equal(gv, wv)  # sorted values
        # a complete window is the same set; an overflowing one (the caller
        # re-scores it) agrees above its last value
        low = -1 if got["top_n_keep"][q] <= kk else gv[-1]
        assert {(i, v) for i, v in zip(gi, gv) if v > low} == {(i, v) for i, v in zip(wi, wv) if v > low}


def test_extend_packed_equals_unpacked_and_jax():
    """The transfer-compact mesh extension (2-bit codes + [lo, hi)) equals
    the uint8 + mask one, field by field, and JAX's packed mesh twin. P = 12
    pairs over 4 query shards: 3 a shard."""
    rng = np.random.default_rng(5)
    p, l = 12, 64
    wlen = l + BAND
    q_codes = rng.integers(0, 4, (p, l)).astype(np.uint8)
    q_len = np.full(p, l, np.int32)
    q_len[2] = 0
    rwin = rng.integers(0, 4, (p, wlen)).astype(np.uint8)
    for i in range(p):
        rwin[i, 10 : 10 + l] = q_codes[i]
    lo = np.zeros(p, np.int32)
    hi = np.full(p, wlen, np.int32)
    lo[3], hi[7] = 12, wlen - 9
    lo[9], hi[9] = 0, 0  # a window wholly outside its contig
    rvalid = (np.arange(wlen)[None, :] >= lo[:, None]) & (np.arange(wlen)[None, :] < hi[:, None])
    mesh = cpu_mesh(2, 4)
    packed = (pack2bit(q_codes), q_len, pack2bit(rwin), lo, hi)
    sc, end = (t.numpy() for t in dist.dist_extend_scores(mesh, q_codes, q_len, rwin, rvalid))
    sc_p, end_p = (t.numpy() for t in dist.dist_extend_scores_packed(mesh, *packed, l, wlen))
    np.testing.assert_array_equal(sc, sc_p)
    np.testing.assert_array_equal(end, end_p)
    full = dist.dist_extend(mesh, q_codes, q_len, rwin, rvalid)
    full_p = dist.dist_extend_packed(mesh, *packed, l, wlen)
    for a, b in zip(full, full_p):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jm = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("d", "q"))
    jp = jdist.dist_extend_packed(jm, *[jnp.asarray(a) for a in packed], l, wlen)
    np.testing.assert_array_equal(full_p.score.numpy(), np.asarray(jp.score))
    np.testing.assert_array_equal(full_p.p_plane.numpy(), np.asarray(jp.p_plane))


@pytest.fixture(scope="module")
def planted_index():
    """tests/test_parallel.py's TestMeshScoreHits index, one DeviceIndex
    made from a seed, read by each package."""
    rng = np.random.default_rng(21)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    read = rng.choice(alpha, 150).tobytes()
    docs = []
    for i in range(70):
        seq = rng.choice(alpha, 300).tobytes()
        if i % 3 == 0:
            seq = read + seq
        docs.append((f"d{i:02d}", [seq]))
    idx = jcobs.build_classic_index(docs, term_size=31, fpr=0.01)
    jd = jcobs.to_device_index(idx)
    td = tcobs.DeviceIndex(term_size=jd.term_size, num_hashes=jd.num_hashes,
                           signature_size=jd.signature_size, doc_names=list(jd.doc_names),
                           words=np.asarray(jd.words))
    seqs = [read, rng.choice(alpha, 150).tobytes(), b"ACG", read[:120] + rng.choice(alpha, 30).tobytes()]
    return jd, td, seqs


@pytest.mark.parametrize("nd,nq", SHAPES)
def test_score_hits_equals_jax_mesh_and_one_device(planted_index, nd, nq):
    jd, td, seqs = planted_index
    mesh = cpu_mesh(nd, nq)
    # the port's doc shards are ceil(W / nd) words wide (JAX's: 8 words,
    # W rounded up to 8 * nd); the footprint is what the shards upload
    mat = Matcher.from_device_index(td, "cpu", mesh=mesh)
    width = -(-td.num_words // nd)
    uploaded = sum(mat.words.at(d, 0).numel() for d in range(nd)) * 4
    assert device_index_bytes(td, mesh=mesh) == uploaded == (td.signature_size + 1) * nd * width * 4
    assert jax_index_bytes(jd, mesh=jax_mesh(nd, nq)) == (td.signature_size + 1) * 8 * nd * 4
    got_hits, got_n = mat.score_hits(seqs, 0.7, topn=5)
    one_hits, one_n = Matcher.from_device_index(td, "cpu").score_hits(seqs, 0.7, topn=5)
    jhits, jn = JaxMatcher.from_device_index(jd, mesh=jax_mesh(nd, nq)).score_hits(seqs, 0.7, topn=5)
    for q in range(len(seqs)):
        assert sorted(got_hits[q]) == sorted(one_hits[q]) == sorted((int(a), int(b)) for a, b in jhits[q]), q
    assert list(got_n) == list(one_n) == [int(x) for x in jn]
    assert got_n[0] == 24  # every planted doc


def test_tie_overflow_equals_one_device():
    """More identical docs at the cutoff than the window holds (n_keep >
    kk, kk < topn + TIE_SLACK + 33): the mesh window overflows and the
    query is re-scored on the dense path, equal to the one-device run."""
    rng = np.random.default_rng(5)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 500).tobytes()
    n_docs = 96
    assert n_docs > 1 + dist.TIE_SLACK + 33
    docs = [(f"r{i}_SAMEA{i:07d}", [base]) for i in range(n_docs)]
    didx = tcobs.to_device_index(tcobs.build_classic_index(docs, term_size=31, fpr=0.05))
    from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq

    reads = [base[i * 40 : i * 40 + 150] for i in range(8)]
    raw = cobs_kmer_hashes_batch([encode_seq(r) for r in reads], 31, didx.num_hashes)
    want = Matcher.from_device_index(didx, "cpu").score_hits_raw(raw, 0.7, topn=1)
    assert all(int(nk) == n_docs for nk in want[1])
    got = Matcher.from_device_index(didx, "cpu", mesh=cpu_mesh(4, 2)).score_hits_raw(raw, 0.7, topn=1)
    assert [sorted(h) for h in got[0]] == [sorted(h) for h in want[0]]
    assert list(got[1]) == list(want[1])


def test_flush_pairs_fused_on_mesh_equals_host_path():
    """tests/test_fused_align.py:97-102: the fused flush on a 2x4 mesh (the
    pairs over 4 query shards, an odd pool) gives the host path's records
    on one device, byte for byte."""
    tasks, params = mixed_pool(PORT, 12, n_reads=90)
    old = tae.flush_pairs(tasks, params, mesh=None, fused=False, device="cpu")
    new = tae.flush_pairs(tasks, params, mesh=cpu_mesh(2, 4), fused=True, device="cpu")
    assert [r.to_line() for r in old] == [r.to_line() for r in new]
    assert sum(1 for r in old if r.flag & 2048) >= 4
    host_mesh = tae.flush_pairs(tasks, params, mesh=cpu_mesh(1, 2), fused=False, device="cpu")
    assert [r.to_line() for r in host_mesh] == [r.to_line() for r in old]


def test_local_part_of_a_mesh_over_processes_aligns_like_one_device():
    """Mesh.local, the align stage's mesh on a mesh that spans processes:
    rank 1 of two on a 2x2 mesh holds doc row 1, a 1x2 mesh of its own;
    rank 3 of four holds one cell, a 1x1 mesh. Both flush like one
    device."""
    cpu = torch.device("cpu")
    two = Mesh(2, 2, (cpu, cpu), rank=1, world=2).local()
    four = Mesh(2, 2, (cpu,), rank=3, world=4).local()
    assert (two.nd, two.nq, two.world, two.devices) == (1, 2, 1, (cpu, cpu))
    assert (four.nd, four.nq, four.world, four.devices) == (1, 1, 1, (cpu,))
    tasks, params = mixed_pool(PORT, 12, n_reads=40)
    want = [r.to_line() for r in tae.flush_pairs(tasks, params, mesh=None, fused=True, device="cpu")]
    for mesh in (two, four):
        assert [r.to_line() for r in tae.flush_pairs(tasks, params, mesh=mesh, fused=True, device="cpu")] == want


def _outputs(wd: Path) -> dict[str, bytes]:
    out = {}
    for d in ("intermediate/03_match", "intermediate/04_filter", "intermediate/05_map", "output"):
        for p in sorted((wd / d).iterdir()):
            out[f"{d}/{p.name}"] = gzip.open(p, "rb").read() if p.suffix == ".gz" else p.read_bytes()
    return out


def _inputs(wd: Path) -> list[str]:
    return sorted(str(p) for p in (wd / "input").iterdir())


def test_pipeline_mesh_2x2_equals_one_device_and_jax(tmp_path):
    """make_fixture through Pipeline(mesh_shape="2x2", device="cpu"):
    03_match, 04_filter, 05_map, sam_summary and stats byte-identical to
    the port's 1x1 run and to the JAX pipeline's."""
    jwd = tmp_path / "jax"
    jtesting.make_fixture(jwd, n_batches=3, seed=42)
    JaxPipeline(JaxConfig.from_yaml(jwd / "config.yaml"), jwd).run_all(_inputs(jwd))
    want = _outputs(jwd)
    for shape in ("1x1", "2x2"):
        wd = tmp_path / shape
        ttesting.make_fixture(wd, n_batches=3, seed=42)
        cfg = Config.from_yaml(wd / "config.yaml").with_overrides(mesh_shape=shape)
        pl = Pipeline(cfg, wd, device="cpu")
        pl.run_all(_inputs(wd))
        assert (pl.mesh() is None) == (shape == "1x1")
        got = _outputs(wd)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key] == want[key], (shape, key)


def test_mesh_shapes_and_refusals(tmp_path):
    assert parse_mesh_shape("4x2") == (4, 2)
    m = cpu_mesh(2, 3)
    assert m.shape == {"d": 2, "q": 3} and m.n_local == 6 and m.home == torch.device("cpu")
    assert m.local_cells()[4] == (1, 1) and m.device(1, 2) == torch.device("cpu")
    assert make_mesh(devices=["cpu", "cpu"]).shape == {"d": 2, "q": 1}
    assert make_mesh(n_query_shards=2, devices=["cpu"] * 4).shape == {"d": 2, "q": 2}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    pl = Pipeline(Config(batches="b.txt", mesh_shape="2x1"), tmp_path, device="cpu", mesh_devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="devices"):
        pl.mesh()
    with pytest.raises(ValueError, match="split evenly"):
        dist.global_array(cpu_mesh(2, 2), np.zeros((3, 4)), ("q",))


def test_global_array_shares_replicated_blocks_and_fetch_round_trips():
    mesh = cpu_mesh(2, 3)
    a = np.arange(6 * 4, dtype=np.int32).reshape(6, 4)
    by_d = dist.global_array(mesh, a, (None, "d"))
    assert by_d.shards[0][0] is by_d.shards[0][2] and by_d.shards[0][0] is not by_d.shards[1][0]
    assert tuple(by_d.at(1, 0).shape) == (6, 2) and by_d.at(1, 0).is_contiguous()
    by_q = dist.global_array(mesh, a, ("q",))
    assert by_q.shards[0][1] is by_q.shards[1][1]
    for x in (by_d, by_q):
        np.testing.assert_array_equal(dist.fetch(x), a)
