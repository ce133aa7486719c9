"""The port's fused align flush (``phylign_tpu_torch.align.fused`` and the
engine's fused path) held to the JAX package's on the CPU: the packed
result bytes of select_extend, its unpacked outputs on identical inputs,
and the SAM records of flush_pairs_fused / flush_pairs_host on a mixed pool
(both strands, mismatches, planted indels, chimeric split reads, a long
query bucket, an unmappable read, two genomes). Tolerance: exact (bytes and
record lines)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylign_tpu.align import engine as jae
from phylign_tpu.align import fused as jfz
from phylign_tpu.kmer import decode_seq as jdecode
from phylign_tpu.ops import minimizer as jmini
from phylign_tpu_torch.align import engine as tae
from phylign_tpu_torch.align import fused as tfz
from phylign_tpu_torch.kmer import decode_seq as tdecode
from phylign_tpu_torch.ops import chain as tchain
from phylign_tpu_torch.ops import minimizer as tmini

JAX = (jae, jmini, jdecode)
PORT = (tae, tmini, tdecode)


def _mutate(rng, r, mut):
    r = r.copy()
    nm = rng.binomial(len(r), mut)
    pos = rng.choice(len(r), nm, replace=False)
    r[pos] = (r[pos] + rng.integers(1, 4, nm)) % 4
    return r


def mixed_pool(mods, seed: int, n_reads: int = 120):
    """The pool of tests/test_fused_align.py:_mixed_pool, rebuilt for either
    package from the same seed: two genomes (multi-contig, a shared segment
    for competing chains), both strands, 2% substitutions, a 4-base gap in
    every 17th read, 16 chimeric reads, 4 long queries (another length
    bucket) and one unmappable read."""
    ae, opm, decode_seq = mods
    rng = np.random.default_rng(seed)
    params = ae.AlignParams.from_preset("sr")
    g = 180_000
    base = rng.integers(0, 4, g).astype(np.uint8)
    contigs = [
        ("c1", base[:110_000]),
        ("c2", np.concatenate([base[40_000:80_000], base[5_000:15_000]])),
    ]
    ref = opm.build_ref_index("gA", contigs, params.k, params.w)
    base2 = rng.integers(0, 4, 70_000).astype(np.uint8)
    ref2 = opm.build_ref_index("gB", [("x1", base2)], params.k, params.w)
    sks = []
    for i in range(n_reads):
        src = base if i % 3 else base2
        length = 150
        s = rng.integers(0, len(src) - length)
        r = _mutate(rng, src[s : s + length], 0.02)
        if i % 17 == 0:
            r = np.concatenate([r[: length // 2], r[length // 2 + 4 :]])
        if i % 2:
            r = (3 - r)[::-1].copy()
        sks.append(ae.QuerySketch.make(f"r{i}", decode_seq(r).decode(), params))
    for i in range(16):
        a = base[rng.integers(0, 30_000) :][:80]
        b = base[rng.integers(60_000, 100_000) :][:80]
        sks.append(ae.QuerySketch.make(f"chi{i}", decode_seq(np.concatenate([a, b])).decode(), params))
    for i in range(4):
        s = rng.integers(0, g - 2200)
        sks.append(ae.QuerySketch.make(f"long{i}", decode_seq(base[s : s + 2200]).decode(), params))
    sks.append(ae.QuerySketch.make("junk", "ACGT" * 40, params))
    tasks = ae.make_pairs_batch(ref, sks, params)
    tasks += ae.make_pairs_batch(ref2, sks[: n_reads // 3], params)
    return tasks, params


@pytest.fixture(scope="module")
def pools():
    return mixed_pool(JAX, 11), mixed_pool(PORT, 11)


def _capture(monkeypatch, mod):
    calls = []
    orig = mod.select_extend

    def wrap(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(mod, "select_extend", wrap)
    return calls


def test_fused_records_equal_jax(pools, monkeypatch):
    (jt, jp), (tt, tp) = pools
    jcalls, tcalls = _capture(monkeypatch, jfz), _capture(monkeypatch, tfz)
    want = jae.flush_pairs_fused(jt, jp)
    got = tae.flush_pairs_fused(tt, tp, device="cpu")
    assert [r.to_line() for r in got] == [r.to_line() for r in want]
    assert sum(1 for r in want if r.flag & 2048) >= 4, "no supplementaries"
    assert sum(1 for r in want if r.flag == 4) >= 1, "no unmapped"
    assert any("I" in r.cigar or "D" in r.cigar for r in want), "no indels"
    # one select_extend(pack=True) per fused chunk, of the same geometry
    assert len(jcalls) == len(tcalls) >= 2
    for (_, jkw, jout), (_, tkw, tout) in zip(jcalls, tcalls):
        assert jkw["pack"] and tkw["pack"]
        assert {k: v for k, v in jkw.items() if k != "scoring"} == {k: v for k, v in tkw.items() if k != "scoring"}
        assert vars(jkw["scoring"]) == vars(tkw["scoring"])
        assert tout[0].dtype == torch.uint8 and tuple(tout[0].shape) == np.asarray(jout[0]).shape


def _to_port_chain(c):
    return tchain.ChainResult(*[torch.from_numpy(np.array(x)) for x in c])


@pytest.mark.parametrize("pack", [True, False])
def test_select_extend_on_identical_inputs(pools, monkeypatch, pack):
    """select_extend of both packages on the inputs JAX's engine built for
    each chunk. pack=True: the one byte buffer engine._fused_finish unpacks
    by offsets is identical byte for byte, and so are the full cold arrays;
    pack=False: hot, flts, neq bitmask, compacted and full cold payloads.
    (Across the two engines the inputs differ in the order of the genome
    pool, which follows object ids, so the bytes are compared here.)"""
    (jt, jp), _ = pools
    jcalls = _capture(monkeypatch, jfz)
    jae.flush_pairs_fused(jt, jp)
    assert jcalls
    for args, kw, _ in list(jcalls):
        kw = dict(kw, pack=pack)
        chains, rest = args[0], args[1:]
        jout = jfz.select_extend(chains, *rest, **kw)
        tkw = dict(kw, scoring=tfz.SrScoring(**vars(kw["scoring"])))
        tout = tfz.select_extend(
            tuple(_to_port_chain(c) for c in chains),
            *[torch.from_numpy(np.array(x)) for x in rest], **tkw,
        )
        if pack:
            assert tout[0].numpy().tobytes() == np.asarray(jout[0]).tobytes()
            names, tflat, jflat = ("cold_i", "cold_f"), tout[1], jout[1]
        else:
            names = ("hot", "flts", "neq", "cc_i", "cc_f", "cold_i", "cold_f")
            jflat = [jout[0], jout[1], jout[2], *jout[3], *jout[4]]
            tflat = [tout[0], tout[1], tout[2], *tout[3], *tout[4]]
        for name, a, b in zip(names, tflat, jflat):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_host_path_records_equal_jax(pools):
    (jt, jp), (tt, tp) = pools
    want = jae.flush_pairs_host(jt, jp)
    got = tae.flush_pairs_host(tt, tp, device="cpu")
    assert [r.to_line() for r in got] == [r.to_line() for r in want]
    fused = tae.flush_pairs(tt, tp, fused=True, device="cpu")
    assert [r.to_line() for r in fused] == [r.to_line() for r in want]


def test_gather_codes_and_pack2bit_flat():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 1001).astype(np.uint8)
    pk = tfz.pack2bit_flat(codes)
    np.testing.assert_array_equal(pk, jfz.pack2bit_flat(codes))
    idx = rng.integers(-5, 1010, (7, 33)).astype(np.int32)
    np.testing.assert_array_equal(
        tfz._gather_codes(torch.from_numpy(pk), torch.from_numpy(idx)).numpy(),
        np.asarray(jfz._gather_codes(jnp.asarray(pk), jnp.asarray(idx))),
    )


def test_compact_cold_overflow_and_bitcast():
    """More rows needing cold data than COLD_CAP: the first COLD_CAP in
    order, as JAX's scatter with mode='drop' keeps them."""
    rng = np.random.default_rng(4)
    p = tfz.COLD_CAP + 77
    hot = np.zeros((p, 4), np.int32)
    hot[:, 2] = rng.choice([tfz.F_HAS, tfz.F_HAS | tfz.F_FULL, tfz.F_SUP0 | tfz.F_FULL, 0], p)
    hot[:, 2] |= rng.integers(0, 128, p).astype(np.int32) << 8
    cold_i = rng.integers(-9, 9, (p, 19)).astype(np.int32)
    cold_f = rng.random((p, 2)).astype(np.float32)
    t = tfz._compact_cold(*[torch.from_numpy(a) for a in (hot, cold_i, cold_f)])
    j = jfz._compact_cold(jnp.asarray(hot), jnp.asarray(cold_i), jnp.asarray(cold_f))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f = np.array([1.5, -2.0], np.float32)
    assert tfz._bitcast_u8(torch.from_numpy(f)).numpy().tobytes() == f.tobytes()
    assert tfz._bitcast_u8(torch.from_numpy(hot)).numpy().tobytes() == np.asarray(jfz._bitcast_u8(jnp.asarray(hot))).tobytes()


def test_empty_and_anchorless_pools():
    params = tae.AlignParams.from_preset("sr")
    assert tae.flush_pairs([], params, fused=True, device="cpu") == []
    rng = np.random.default_rng(13)
    ref = tmini.build_ref_index("g", [("c", rng.integers(0, 4, 5000).astype(np.uint8))], params.k, params.w)
    sks = [tae.QuerySketch.make("a", "ACGT" * 40, params)]
    recs = tae.flush_pairs_fused(tae.make_pairs_batch(ref, sks, params), params, device="cpu")
    assert [r.flag for r in recs] == [4]


def test_mesh_is_not_ported():
    params = tae.AlignParams.from_preset("sr")
    with pytest.raises(NotImplementedError, match="item 11"):
        tae.flush_pairs_fused([], params, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        list(tae.align_batches_pooled([("b", "x.tar.xz", None)], [], params, mesh=object(), device="cpu"))
