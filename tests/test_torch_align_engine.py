"""The port's align engine (``phylign_tpu_torch.align.engine``) and model
step (``models.aligner.align_step``) held to the JAX package's on the CPU:
SAM records on the cases of tests/test_mapq.py, tests/test_reseed.py and
tests/test_seed_occurrence.py, through the fused and the host flush paths,
the MAPQ formula, the preset table, a batch tar through align_batch and
align_batches_pooled, and align_step. Tolerance: exact (record lines and
tensors, align_step's f32 chain scores included)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.align import engine as jae
from phylign_tpu.io import asmtar as jasmtar
from phylign_tpu.kmer import encode_seq as jencode
from phylign_tpu.match.filter import FilteredQuery as JFQ
from phylign_tpu.models import aligner as jal
from phylign_tpu.ops import minimizer as jmini
from phylign_tpu_torch.align import engine as tae
from phylign_tpu_torch.kmer import encode_seq as tencode
from phylign_tpu_torch.match.filter import FilteredQuery as TFQ
from phylign_tpu_torch.models import aligner as tal
from phylign_tpu_torch.ops import minimizer as tmini

JAX = (jae, jmini, jencode)
PORT = (tae, tmini, tencode)


def _mk(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _align(mods, contig: str, reads, params_fn, fused: bool):
    ae, opm, encode = mods
    params = params_fn(ae)
    ref = opm.build_ref_index("g", [("c1", encode(contig.encode()))], params.k, params.w)
    tasks = [ae.make_pair(ref, ae.QuerySketch.make(f"q{i}", r, params), params) for i, r in enumerate(reads)]
    kw = {} if ae is jae else {"device": "cpu"}
    return [r.to_line() for r in ae.flush_pairs(tasks, params, fused=fused, **kw)]


def _sr(ae):
    return ae.AlignParams.from_preset("sr")


def _mapq_cases():
    """The genomes of tests/test_mapq.py: a unique locus, an exact copy, a
    copy lacking one base, a tandem pair, a one-base-deletion second locus."""
    out = []
    rng = np.random.default_rng(11)
    read = _mk(rng, 150)
    out.append(("unique", _mk(rng, 400) + read + _mk(rng, 400), [read]))
    rng = np.random.default_rng(12)
    read = _mk(rng, 150)
    out.append(("copy", _mk(rng, 400) + read + _mk(rng, 300) + read + _mk(rng, 300), [read]))
    rng = np.random.default_rng(13)
    read = _mk(rng, 150)
    sec = read[:75] + read[76:]
    out.append(("deletion_copy", _mk(rng, 400) + read + _mk(rng, 300) + sec + _mk(rng, 300), [read]))
    rng = np.random.default_rng(14)
    read = _mk(rng, 150)
    out.append(("tandem", _mk(rng, 400) + read + read + _mk(rng, 300), [read]))
    rng = np.random.default_rng(15)
    read = _mk(rng, 150)
    sec = read[:40] + read[41:]
    out.append(("ab", _mk(rng, 350) + read + _mk(rng, 280) + sec + _mk(rng, 280), [read]))
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name,contig,reads", _mapq_cases(), ids=[c[0] for c in _mapq_cases()])
def test_mapq_cases(name, contig, reads, fused):
    want = _align(JAX, contig, reads, _sr, fused)
    assert _align(PORT, contig, reads, _sr, fused) == want
    if name == "unique":
        assert "\t60\t150=" in want[0]
    if name == "deletion_copy":
        assert want[0].split("\t")[4] == "48"


def _tandem(copies: int):
    rng = np.random.default_rng(21)
    unit = _mk(rng, 50)
    return _mk(rng, 400) + unit * copies + _mk(rng, 400), unit * 3


def _reseed_params(ae, **kw):
    return dataclasses.replace(ae.AlignParams.from_preset("sr"), **{"mid_occ": 8, "max_occ": 64, **kw})


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize(
    "copies,extra",
    [(20, {}), (20, {"max_occ": 0}), (20, {"max_occ": 8}), (100, {})],
    ids=["reseed", "disabled", "caps_equal", "above_max_occ"],
)
def test_reseed_cases(copies, extra, fused):
    contig, read = _tandem(copies)
    fn = lambda ae: _reseed_params(ae, **extra)  # noqa: E731
    want = _align(JAX, contig, [read], fn, fused)
    assert _align(PORT, contig, [read], fn, fused) == want
    if copies == 20 and not extra:
        assert "\t150=\t" in want[0]


@pytest.mark.parametrize("mid_occ", [1000, 5000, 0])
def test_seed_occurrence_record_stability(mid_occ):
    """tests/test_seed_occurrence.py:TestRecordStability's genome: unique
    sequence plus a 12-fold repeat, reads on both strands and one spanning
    into the repeat; caps 1000 (sr), 5000 (sr max_occ) and derived."""
    rng = np.random.default_rng(23)
    unique = rng.integers(0, 4, 8000).astype(np.uint8)
    rep_unit = rng.integers(0, 4, 400).astype(np.uint8)
    genome = np.concatenate([unique] + [rep_unit] * 12)
    reads = []
    for i in range(6):
        s = int(rng.integers(0, 7500))
        r = unique[s : s + 150].copy()
        if i % 2:
            r = (3 - r)[::-1].copy()
        reads.append(r)
    reads.append(np.concatenate([unique[500:575], rep_unit[:75]]))
    contig = "".join("ACGT"[c] for c in genome)
    fn = lambda ae: dataclasses.replace(ae.AlignParams.from_preset("sr"), mid_occ=mid_occ)  # noqa: E731
    seqs = ["".join("ACGT"[c] for c in r) for r in reads]
    for fused in (True, False):
        assert _align(PORT, contig, seqs, fn, fused) == _align(JAX, contig, seqs, fn, fused)


def test_mm2_mapq_formula():
    cases = [
        (140, 125, 24, 300, 284, 0, 140), (140, 140, 24, 300, 300, 0, 140),
        (140, 25, 24, 300, 80, 0, 140), (133, 0, 18, 300, 0, 0, 133),
        (25, 0, 3, 50, 0, 0, 25), (140, 0, 24, 300, 0, 1400, 140), (0, 0, 0, 0, 0, 0, 0),
    ]
    for preset in ("sr", "map-ont"):
        jp, tp = jae.AlignParams.from_preset(preset), tae.AlignParams.from_preset(preset)
        for c in cases:
            assert tae.mm2_mapq(*c, tp) == jae.mm2_mapq(*c, jp)


@pytest.mark.parametrize(
    "preset,extra",
    [("sr", ""), ("map-ont", ""), ("map-pb", ""), ("asm5", ""), ("asm20", ""),
     ("sr", "-k 19 -w 10 -r 300 -N 3 --eqx --secondary=no"), ("map-ont", "-O6,26 -E2,1 -z 200")],
)
def test_align_params_from_preset(preset, extra):
    a, b = tae.AlignParams.from_preset(preset, extra), jae.AlignParams.from_preset(preset, extra)
    assert {k: v for k, v in vars(a).items() if k != "scoring"} == {
        k: v for k, v in vars(b).items() if k != "scoring"
    }
    assert vars(a.scoring) == vars(b.scoring)
    with pytest.raises(ValueError):
        tae.AlignParams.from_preset("sr", "--secondary=yes")


def _batch_tar(tmp_path):
    """A batch tar of three genomes and filtered queries with candidates
    (one of them outside the batch's accession list)."""
    rng = np.random.default_rng(31)
    genomes = []
    for g in range(3):
        contigs = [(f"SAMB{g}.c{c}", bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000))) for c in range(2)]
        genomes.append((f"SAMB{g}", contigs))
    tar = tmp_path / "b.tar.xz"
    jasmtar.write_batch_tar(tar, genomes)
    queries = []
    for i in range(24):
        g = i % 3
        seq = genomes[g][1][i % 2][1]
        s = int(rng.integers(0, 3800))
        q = seq[s : s + 150].decode()
        cands = [("", f"SAMB{g}", 0), ("", f"SAMB{(g + 1) % 3}", 0)]
        queries.append((f"q{i}", q, cands))
    return tar, queries


@pytest.mark.parametrize("cache", [False, True])
def test_align_batch_and_pooled(tmp_path, cache):
    tar, qs = _batch_tar(tmp_path)
    params_j, params_t = jae.AlignParams.from_preset("sr"), tae.AlignParams.from_preset("sr")
    jq = [JFQ(n, s, c) for n, s, c in qs]
    tq = [TFQ(n, s, c) for n, s, c in qs]
    accs = {"SAMB0", "SAMB1"}
    cdir = (lambda name: str(tmp_path / name)) if cache else (lambda name: None)
    want = [r.to_line() for r in jae.align_batch(str(tar), jq, accs, params_j, pair_chunk=16, asm_cache_dir=cdir("j"))]
    got = [r.to_line() for r in tae.align_batch(
        str(tar), tq, accs, params_t, pair_chunk=16, asm_cache_dir=cdir("t"), device="cpu"
    )]
    assert got == want and len(want) == 32
    specs = [("b", str(tar), accs), ("b2", str(tar), None)]
    want = dict((n, [r.to_line() for r in recs]) for n, recs in jae.align_batches_pooled(specs, jq, params_j, pair_chunk=20))
    got = dict((n, [r.to_line() for r in recs]) for n, recs in tae.align_batches_pooled(
        specs, tq, params_t, pair_chunk=20, device="cpu"
    ))
    assert got == want and set(got) == {"b", "b2"}


def test_align_genome_and_begin_end_grouped():
    rng = np.random.default_rng(41)
    contig = rng.integers(0, 4, 6000).astype(np.uint8)
    reads = ["".join("ACGT"[c] for c in contig[s : s + 150]) for s in (100, 2000, 4000)] + ["ACGT" * 40]
    out = []
    for ae in (jae, tae):
        params = ae.AlignParams.from_preset("sr")
        sks = [ae.QuerySketch.make(f"q{i}", r, params) for i, r in enumerate(reads)]
        kw = {} if ae is jae else {"device": "cpu"}
        recs = ae.align_genome("G", [("G.c1", contig)], sks, params, **kw)
        ref = (jmini if ae is jae else tmini).build_ref_index("G", [("G.c1", contig)], params.k, params.w)
        ff = ae.flush_pairs_begin(ae.make_pairs_batch(ref, sks, params), params, **kw)
        groups = ae.flush_pairs_end_grouped(ff)
        out.append(([r.to_line() for r in recs], [[r.to_line() for r in g] for g in groups]))
    assert out[0] == out[1]
    assert [len(g) for g in out[1][1]] == [1, 1, 1, 1]


def test_align_step():
    rng = np.random.default_rng(51)
    p, a, l, band = 12, 64, 96, 128
    rp = np.full((p, a), tae.opc.PAD_POS, np.int32)
    qp = np.full((p, a), tae.opc.PAD_POS, np.int32)
    for i in range(p - 1):
        n = int(rng.integers(1, a + 1))
        r = rng.integers(0, 300, n).astype(np.int32)
        q = rng.integers(0, 150, n).astype(np.int32)
        o = np.lexsort((q, r))
        rp[i, :n], qp[i, :n] = r[o], q[o]
    qc = rng.integers(0, 4, (p, l)).astype(np.uint8)
    ql = rng.integers(1, l + 1, p).astype(np.int32)
    rw = rng.integers(0, 4, (p, l + band)).astype(np.uint8)
    rw[:, 10 : 10 + l] = qc
    rv = np.ones((p, l + band), bool)
    j = jal.align_step(*[jnp.asarray(x) for x in (rp, qp, qc, ql, rw, rv)])
    t = tal.align_step(*[torch.from_numpy(x) for x in (rp, qp, qc, ql, rw, rv)])
    np.testing.assert_array_equal(t.align_score.numpy(), np.asarray(j.align_score))
    np.testing.assert_array_equal(t.align_end_d.numpy(), np.asarray(j.align_end_d))
    for name in j.chain._fields:
        a_, b_ = getattr(t.chain, name).numpy(), np.asarray(getattr(j.chain, name))
        np.testing.assert_array_equal(a_, b_, err_msg=name)
