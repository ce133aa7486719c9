"""The port's own copies of the JAX package's host modules, held to their
originals on the same seeded inputs: k-mer hashing (the native library and
the numpy path), the COBS classic index, query preprocessing, match-file
text, the candidate filter, the native helpers, the config, the manifest,
the scheduler, the disk budget and the synthetic fixture."""

import gzip
import io
import os
from pathlib import Path

import numpy as np
import pytest

from phylign_tpu import kmer as jkmer
from phylign_tpu import native as jnative
from phylign_tpu import testing as jtesting
from phylign_tpu.config import Config as JaxConfig
from phylign_tpu.io import cobs as jcobs
from phylign_tpu.io import fastx as jfastx
from phylign_tpu.match import filter as jfilter
from phylign_tpu.match import oracle as joracle
from phylign_tpu.match import postprocess as jpost
from phylign_tpu.pipeline import scheduler as jsched
from phylign_tpu.utils import bench as jbench
from phylign_tpu.utils import diskbudget as jdisk
from phylign_tpu_torch import kmer, native, testing
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.io import cobs, fastx
from phylign_tpu_torch.match import filter as tfilter
from phylign_tpu_torch.match import oracle, postprocess
from phylign_tpu_torch.pipeline import manifest, scheduler
from phylign_tpu_torch.utils import bench, diskbudget


def _reads(seed: int, n: int = 60) -> list[bytes]:
    """Random reads of 0-200 bp with lower case and non-ACGT bases; some
    shorter than k = 31."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTACGTacgtNRY", np.uint8)
    return [bytes(rng.choice(alphabet, int(rng.integers(0, 200)))) for _ in range(n)]


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """Run the port's code through its native library or its numpy path
    (the JAX package's side stays as it is)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, "g++ could not build the host library"
    return request.param


class TestKmer:
    def test_xxh64_scalar(self, host_path):
        """kmer.xxh64 and native.native_xxh64 against the JAX package's on
        the vectors of tests/test_kmer.py (known values, lengths across
        every tail case, seeds past 2**32)."""
        assert kmer.xxh64(b"") == 0xEF46DB3751D8E999
        assert kmer.xxh64(b"Nobody inspects the spammish repetition") == 0xFBCEA83C8A378BF1
        rng = np.random.default_rng(0)
        cases = [(b"ACGTACGTACGTACGTACGTACGTACGTACG", s) for s in (0, 1)]
        for length in [0, 1, 3, 4, 7, 8, 12, 15, 31, 32, 33, 40, 63, 64, 77, 100]:
            for seed in [0, 1, 7, 2**32, 2**63]:
                cases.append((bytes(rng.integers(0, 256, length, dtype=np.uint8)), seed))
        for data, seed in cases:
            want = jkmer.xxh64(data, seed)
            assert kmer.xxh64(data, seed) == want, (len(data), seed)
            got = native.native_xxh64(data, seed)
            if host_path == "native":
                assert got == jnative.native_xxh64(data, seed) == want, (len(data), seed)
            else:
                assert got is None
        assert kmer.xxh64(cases[0][0], 0) != kmer.xxh64(cases[0][0], 1)

    def test_encode_normalize_revcomp(self):
        for r in _reads(1):
            np.testing.assert_array_equal(kmer.encode_seq(r), jkmer.encode_seq(r))
            assert kmer.normalize_seq(r) == jkmer.normalize_seq(r)
            assert kmer.revcomp(r) == jkmer.revcomp(r)

    @pytest.mark.parametrize("num_hashes", [1, 3])
    def test_rows_and_hashes(self, host_path, num_hashes):
        reads = _reads(2 + num_hashes)
        codes = [kmer.encode_seq(r) for r in reads]
        for s in (1000, 2_000_000, (1 << 61) - 1):
            for c in codes:
                np.testing.assert_array_equal(
                    kmer.cobs_row_indices(c, 31, s, num_hashes),
                    jkmer.cobs_row_indices(c, 31, s, num_hashes),
                )
        got = kmer.cobs_kmer_hashes_batch(codes, 31, num_hashes)
        want = jkmer.cobs_kmer_hashes_batch(codes, 31, num_hashes)
        assert len(got) == len(want) == len(reads)
        assert any(g.shape[0] == 0 for g in got)  # reads shorter than k
        for g, w in zip(got, want):
            assert g.dtype == np.uint64
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(
                kmer.rows_from_hashes(g, 997), jkmer.rows_from_hashes(w, 997)
            )


def _docs(seed: int, n: int) -> list[tuple[str, list[bytes]]]:
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [
        (f"{d:04d}_SAMX{d:05d}", [bytes(rng.choice(acgt, 300)), bytes(rng.choice(acgt, 20))])
        for d in range(n)
    ]


class TestCobs:
    @pytest.mark.parametrize("num_hashes,n_docs", [(1, 37), (3, 5)])
    def test_build_write_read(self, tmp_path, host_path, num_hashes, n_docs):
        docs = _docs(n_docs, n_docs)
        t = cobs.build_classic_index(docs, term_size=31, num_hashes=num_hashes, fpr=0.1)
        j = jcobs.build_classic_index(docs, term_size=31, num_hashes=num_hashes, fpr=0.1)
        for suffix in ("", ".xz"):
            tp, jp = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
            cobs.write_classic_index(tp, t)
            jcobs.write_classic_index(jp, j)
            assert tp.read_bytes() == jp.read_bytes()
            back = cobs.read_classic_index(jp)
            np.testing.assert_array_equal(back.rows, j.rows)
            assert (back.doc_names, back.signature_size) == (j.doc_names, j.signature_size)
            td, jd = cobs.to_device_index(back), jcobs.to_device_index(jcobs.read_classic_index(tp))
            np.testing.assert_array_equal(td.words, jd.words)
        cobs.save_device_index(tmp_path / "dev", td)
        loaded = jcobs.load_device_index(tmp_path / "dev")
        np.testing.assert_array_equal(np.asarray(loaded.words), td.words)
        again = cobs.load_device_index(tmp_path / "dev")
        assert again.source_sig[1:] == loaded.source_sig[1:]
        # the numpy oracle on both packages' device indexes
        for r in _reads(9, 8) + [docs[0][1][0][40:200]]:
            c = kmer.encode_seq(r)
            assert oracle.query_index(td, c, 0.5) == joracle.query_index(jd, c, 0.5)

    def test_format_errors_and_strip_rid(self, tmp_path):
        (tmp_path / "bad").write_bytes(b"NOT A COBS INDEX" + bytes(40))
        with pytest.raises(cobs.CobsFormatError, match="magic"):
            cobs.read_classic_index(tmp_path / "bad")
        for n in ("0001_SAMEA1", "SAMEA1", "_x", "a_b_c"):
            assert cobs.strip_rid(n) == jcobs.strip_rid(n)

    def test_inspect_classic_index(self, tmp_path):
        """The same report dict as the JAX package's for an index with and
        without xz, one with a short payload, and one with a bad magic."""
        idx = cobs.build_classic_index(_docs(3, 9), term_size=31, fpr=0.2)
        cobs.write_classic_index(tmp_path / "i.cobs_classic", idx)
        cobs.write_classic_index(tmp_path / "i.cobs_classic.xz", idx)
        raw = (tmp_path / "i.cobs_classic").read_bytes()
        (tmp_path / "short.cobs_classic").write_bytes(raw[:-5])
        (tmp_path / "bad.cobs_classic").write_bytes(b"NOT A COBS INDEX" + bytes(40))
        oks = []
        for name in ("i.cobs_classic", "i.cobs_classic.xz", "short.cobs_classic", "bad.cobs_classic"):
            got = cobs.inspect_classic_index(tmp_path / name)
            assert got == jcobs.inspect_classic_index(tmp_path / name), name
            oks.append(got["ok"])
        assert oks == [True, True, False, False]

    @pytest.mark.parametrize("num_hashes,rid,seed", [(1, True, 0), (2, True, 5), (1, False, 0)])
    def test_build_index_from_tar(self, tmp_path, num_hashes, rid, seed):
        """Byte-identical to the JAX build from the same tar: the NNNN_ rid
        prefixes are drawn in tar order from default_rng(seed)."""
        from phylign_tpu_torch.io import asmtar

        rng = np.random.default_rng(7)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        genomes = [
            (f"SAMT{g:05d}", [(f"SAMT{g:05d}.c{c}", bytes(rng.choice(acgt, int(rng.integers(200, 900)))))
                              for c in range(1 + g % 3)])
            for g in (4, 0, 7, 2, 9, 1)  # not sorted: order is the tar's
        ]
        asmtar.write_batch_tar(tmp_path / "b.tar.xz", genomes)
        kw = dict(term_size=31, num_hashes=num_hashes, fpr=0.2, add_rid_prefix=rid, seed=seed)
        t = cobs.build_index_from_tar(tmp_path / "b.tar.xz", **kw)
        j = jcobs.build_index_from_tar(tmp_path / "b.tar.xz", **kw)
        assert t.doc_names == j.doc_names
        assert [n.rpartition("_")[2] if rid else n for n in t.doc_names] == [g for g, _ in genomes]
        cobs.write_classic_index(tmp_path / "t.xz", t)
        jcobs.write_classic_index(tmp_path / "j.xz", j)
        assert (tmp_path / "t.xz").read_bytes() == (tmp_path / "j.xz").read_bytes()


def _write_inputs(d: Path, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    paths = []
    reads = iter(_reads(seed, 24))
    for i, suf in enumerate(["fq", "fa.gz", "fasta", "fastq.gz"]):
        p = d / f"in{3 - i}.{suf}"
        buf = io.StringIO()
        for j in range(6):
            s = next(reads).decode() or "N"
            if "fq" in suf or "fastq" in suf:
                buf.write(f"@r{i}_{j} c{j}\n{s}\n+\n{'I' * len(s)}\n")
            else:
                buf.write(f">r{i}_{j} c{j}\n{s[: len(s) // 2]}\n{s[len(s) // 2 :]}\n")
        data = buf.getvalue().encode()
        p.write_bytes(gzip.compress(data, mtime=0) if suf.endswith(".gz") else data)
        paths.append(str(p))
    rng.shuffle(paths)
    return paths


def test_normalize_and_merge_bytes(tmp_path):
    paths = _write_inputs(tmp_path, 4)
    stem, recs = fastx.normalize_and_merge(paths)
    jstem, jrecs = jfastx.normalize_and_merge(paths)
    assert stem == jstem
    out, jout = io.StringIO(), io.StringIO()
    fastx.write_fasta(out, recs)
    jfastx.write_fasta(jout, jrecs)
    assert out.getvalue() == jout.getvalue()
    dup = tmp_path / "dup.fa"
    dup.write_text(">r0_0\nACGT\n")
    for fn in (fastx.normalize_and_merge, jfastx.normalize_and_merge):
        with pytest.raises(ValueError, match="duplicate"):
            fn([str(dup), *paths])


def _match_texts(seed: int, n_batches: int = 4, n_queries: int = 30):
    """Per-batch 03_match texts over the same queries (some queries
    without hits, ties across batches and accessions)."""
    rng = np.random.default_rng(seed)
    qnames = [f"q{i:03d}" for i in range(n_queries)]
    texts = {}
    for b in range(n_batches):
        ms = []
        for q in qnames:
            n = int(rng.integers(0, 6))
            hits = sorted(
                {(f"SAM{int(rng.integers(0, 40)):03d}", int(rng.integers(80, 121))) for _ in range(n)},
                key=lambda x: (-x[1], x[0]),
            )
            ms.append(postprocess.QueryMatches(q, len(hits) + int(rng.integers(0, 3)), hits))
        buf = io.StringIO()
        postprocess.write_match_file(buf, ms, keep=4)
        jbuf = io.StringIO()
        jpost.write_match_file(
            jbuf, [jpost.QueryMatches(m.qname, m.n_total, m.hits) for m in ms], keep=4
        )
        assert buf.getvalue() == jbuf.getvalue()
        texts[f"batch_{chr(ord('d') - b)}"] = buf.getvalue()
    records = [fastx.FastxRecord(q, "", "ACGT" * 10) for q in qnames]
    return texts, records


@pytest.mark.parametrize("keep", [1, 3, 50])
def test_filter_outputs(host_path, keep):
    texts, records = _match_texts(keep)
    jrecords = [jfastx.FastxRecord(r.name, r.comment, r.seq) for r in records]

    def render(mod, filtered):
        buf = io.StringIO()
        mod.write_filtered_fasta(buf, filtered)
        return buf.getvalue()

    want = render(jfilter, jfilter.filter_queries_streaming(
        jrecords, {b: jpost.read_match_file(io.StringIO(t)) for b, t in texts.items()}, keep,
    ))
    got_stream = render(tfilter, tfilter.filter_queries_streaming(
        records, {b: postprocess.read_match_file(io.StringIO(t)) for b, t in texts.items()}, keep,
    ))
    parsed = {b: native.native_parse_match_text(t.encode()) for b, t in texts.items()}
    if host_path == "native":
        got_arrays = render(tfilter, tfilter.filter_queries_arrays(records, parsed, keep))
        assert got_arrays == want
    else:
        assert all(p is None for p in parsed.values())
    merged = {
        mod: render(mod, mod.filter_queries(recs, {b: post.read_match_file(io.StringIO(t)) for b, t in texts.items()}, keep))
        for mod, recs, post in ((jfilter, jrecords, jpost), (tfilter, records, postprocess))
    }
    assert got_stream == want
    assert merged[tfilter] == merged[jfilter] == want
    assert want.count(",") > 0


def test_filter_queries_tolerates_unknown_names():
    """The in-memory merge keeps a query name no record has, with an empty
    sequence, as the JAX package's filter_queries does."""
    texts, records = _match_texts(5, n_batches=2, n_queries=6)
    extra = "_SAM007\t100\n"
    streams = {
        mod: {b: post.read_match_file(io.StringIO(t + f"*zz_unknown\t1\n{extra}")) for b, t in texts.items()}
        for mod, post in ((jfilter, jpost), (tfilter, postprocess))
    }
    jrecords = [jfastx.FastxRecord(r.name, r.comment, r.seq) for r in records]
    got = tfilter.filter_queries(records, streams[tfilter], 2)
    want = jfilter.filter_queries(jrecords, streams[jfilter], 2)
    assert [(q.qname, q.seq, q.candidates) for q in got] == [(q.qname, q.seq, q.candidates) for q in want]
    assert got[-1].qname == "zz_unknown" and got[-1].seq == ""
    assert got[-1].candidates == [("batch_c", "SAM007", 100), ("batch_d", "SAM007", 100)]


def test_native_helpers_match_the_jax_package():
    assert native.get_lib() is not None and jnative.get_lib() is not None
    rng = np.random.default_rng(7)
    x = rng.integers(0, 5000, 20_000).astype(np.int32)
    (u, inv), (ju, jinv) = native.native_unique_inverse(x), jnative.native_unique_inverse(x)
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(u[inv], x)

    texts, _ = _match_texts(11)
    for t in texts.values():
        a, b = native.native_parse_match_text(t.encode()), jnative.native_parse_match_text(t.encode())
        assert a.qnames == b.qnames and a.accs == b.accs
        for f in ("totals", "hit_end", "acc_id", "score"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="malformed"):
        native.native_parse_match_text(b"_acc\t12\n")

    n = 5000
    args = (
        rng.integers(0, 300, n).astype(np.int64), rng.integers(0, 120, n).astype(np.int32),
        rng.integers(0, 8, n).astype(np.int32), rng.integers(0, 900, n).astype(np.int32),
    )
    for keep in (1, 5):
        np.testing.assert_array_equal(
            native.native_filter_topk_rows(*args, 120, keep),
            jnative.native_filter_topk_rows(*args, 120, keep),
        )
    assert native.native_filter_topk_rows(*args, 1 << 14, 1) is None


def test_native_library_is_built_under_build_dir():
    p = native.lib_path()
    assert p.parent == Path(__file__).resolve().parents[1] / "build" / "phylign_tpu_torch"
    assert p.name.startswith("libhostio_") and p.exists()
    assert "-march=native" in native.CXXFLAGS


def test_make_fixture_trees_are_identical(tmp_path):
    testing.make_fixture(tmp_path / "t", n_batches=2, seed=42)
    jtesting.make_fixture(tmp_path / "j", n_batches=2, seed=42)

    def tree(root: Path) -> dict:
        return {
            str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
        }

    t, j = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert sorted(t) == sorted(j)
    assert len(t) >= 12
    for name in j:
        assert t[name] == j[name], name


def test_config_manifest_scheduler_diskbudget(tmp_path):
    y = tmp_path / "c.yaml"
    y.write_text("batches: data/b.txt\ncobs_kmer_thres: 0.6\nnb_best_hits: 7\nthreads: 3\n")
    t, j = Config.from_yaml(y), JaxConfig.from_yaml(y)
    assert vars(t) == vars(j)
    assert vars(t.with_overrides(nb_best_hits=2)) == vars(j.with_overrides(nb_best_hits=2))
    assert t.effective_threads() == j.effective_threads()
    assert bench.HEADER == jbench.HEADER

    m = manifest.Manifest(tmp_path / "inter")
    f = tmp_path / "out.txt"
    tmp, commit = manifest.atomic_write_via(f)
    Path(tmp).write_text("x")
    commit()
    m.mark("match", "b____s", [str(f)])
    assert manifest.Manifest(tmp_path / "inter").done("match", "b____s", [str(f)])

    s = scheduler.Scheduler(workers=2, max_ram_mb=100, max_io_heavy=1)
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) == 1:
            raise MemoryError("out of memory")
        return 5

    res = s.run([scheduler.Job("a", flaky, mem_mb=10), scheduler.Job("b", lambda: 6)])
    assert res == {"a": 5, "b": 6} and len(tries) == 2
    for exc in (RuntimeError("CUDA out of memory. Tried to allocate"), MemoryError()):
        assert scheduler._is_oom(exc) == jsched._is_oom(exc) is True
    assert scheduler._is_oom(ValueError("bad")) is jsched._is_oom(ValueError("bad")) is False

    for root in ("t", "j"):
        for i in range(4):
            d = tmp_path / root / "cache" / f"e{i}"
            d.mkdir(parents=True)
            (d / "meta.json").write_bytes(bytes(1000))
            os.utime(d / "meta.json", (1000 + i, 1000 + i))
    freed_t = diskbudget.enforce_budget([tmp_path / "t" / "cache"], 2500)
    freed_j = jdisk.enforce_budget([tmp_path / "j" / "cache"], 2500)
    assert freed_t == freed_j
    assert sorted(p.name for p in (tmp_path / "t" / "cache").iterdir()) == sorted(
        p.name for p in (tmp_path / "j" / "cache").iterdir()
    )


# --- the align stage's host copies ---------------------------------------------

from phylign_tpu.io import asmtar as jasmtar  # noqa: E402
from phylign_tpu.io import sam as jsam  # noqa: E402
from phylign_tpu.io import stats as jstats  # noqa: E402
from phylign_tpu.ops import extend as jext  # noqa: E402
from phylign_tpu.ops import minimizer as jmini  # noqa: E402
from phylign_tpu_torch.io import asmtar, sam, stats  # noqa: E402
from phylign_tpu_torch.ops import extend as text  # noqa: E402
from phylign_tpu_torch.ops import minimizer as mini  # noqa: E402


def _genomes(seed: int, n: int = 4):
    """Genomes of 1-3 contigs with a repeated segment (occurrence caps)."""
    rng = np.random.default_rng(seed)
    rep = rng.integers(0, 4, 300).astype(np.uint8)
    out = []
    for g in range(n):
        contigs = []
        for c in range(int(rng.integers(1, 4))):
            body = rng.integers(0, 4, int(rng.integers(2000, 6000))).astype(np.uint8)
            contigs.append((f"g{g}.c{c}", np.concatenate([body, rep, rep, body[:500]])))
        out.append((f"G{g}", contigs))
    return out


def _query_sketches(mod, genomes, seed: int, n: int = 40, hpc=False):
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        _, contigs = genomes[i % len(genomes)]
        seq = contigs[i % len(contigs)][1]
        s = int(rng.integers(0, len(seq) - 150))
        q = seq[s : s + 150].copy()
        if i % 2:
            q = (3 - q)[::-1].copy()
        qs.append(q)
    sk = mod.minimizers_batch(qs, 21, 11, hpc=hpc)
    return qs, sk


def _assert_ref_equal(a, b):
    assert a.name == b.name and a.contig_names == b.contig_names and (a.k, a.w) == (b.k, b.w)
    for f in ("contig_starts", "contig_lens", "codes", "sort_hash", "sort_pos", "sort_strand"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.packed4(), b.packed4())
    for x, y in zip(a.uniq_table(), b.uniq_table()):
        np.testing.assert_array_equal(x, y)
    assert a.mid_occ(2e-4, 10, 1_000_000) == b.mid_occ(2e-4, 10, 1_000_000)


class TestMinimizerCopy:
    @pytest.mark.parametrize("hpc", [False, True])
    def test_minimizers(self, host_path, hpc):
        rng = np.random.default_rng(3)
        seqs = [rng.integers(0, 4, int(rng.integers(0, 400))).astype(np.uint8) for _ in range(30)]
        seqs[0] = np.repeat(seqs[1], 3)  # homopolymer runs
        for s in seqs:
            for x, y in zip(mini.minimizers(s, 21, 11, hpc=hpc), jmini.minimizers(s, 21, 11, hpc=hpc)):
                np.testing.assert_array_equal(x, y)
        for a, b in zip(mini.minimizers_batch(seqs, 15, 10, hpc=hpc), jmini.minimizers_batch(seqs, 15, 10, hpc=hpc)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)

    def test_ref_index_and_anchors(self, host_path):
        genomes = _genomes(5)
        refs = mini.build_ref_index_batch(genomes, 21, 11)
        jrefs = jmini.build_ref_index_batch(genomes, 21, 11)
        for (name, contigs), r, jr in zip(genomes, refs, jrefs):
            _assert_ref_equal(r, jr)
            _assert_ref_equal(mini.build_ref_index(name, contigs, 21, 11), jr)
        qs, sk = _query_sketches(mini, genomes, 6)
        for cap in (1000, 1):
            for r, jr in zip(refs, jrefs):
                for q, (h, p, s) in zip(qs[:10], sk[:10]):
                    a = mini.collect_anchors(r, h, p, s, len(q), cap)
                    b = jmini.collect_anchors(jr, h, p, s, len(q), cap)
                    assert a[2] == b[2]
                    for x, y in zip(a[:2], b[:2]):
                        np.testing.assert_array_equal(x.rpos, y.rpos)
                        np.testing.assert_array_equal(x.qpos, y.qpos)
            args = ([x[0] for x in sk], [x[1] for x in sk], [x[2] for x in sk], [len(q) for q in qs])
            got, rep = mini.collect_anchors_batch(refs[0], *args, max_occ=cap)
            want, jrep = jmini.collect_anchors_batch(jrefs[0], *args, max_occ=cap)
            np.testing.assert_array_equal(rep, jrep)
            for (p1, m1), (p2, m2) in zip(got, want):
                np.testing.assert_array_equal(p1.rpos, p2.rpos)
                np.testing.assert_array_equal(m1.qpos, m2.qpos)
            groups = lambda rs: [(r, *args, cap) for r in rs]
            got, rep = mini.collect_anchors_multi(groups(refs), 21)
            want, jrep = jmini.collect_anchors_multi(groups(jrefs), 21)
            np.testing.assert_array_equal(rep, jrep)
            for (p1, m1), (p2, m2) in zip(got, want):
                for x, y in ((p1, p2), (m1, m2)):
                    np.testing.assert_array_equal(x.rpos, y.rpos)
                    np.testing.assert_array_equal(x.qpos, y.qpos)


def test_native_align_bindings_match_the_jax_package():
    """minimizers(_batch), the anchor collection fronts and the SAM line
    assembler of the port's native library against the JAX package's."""
    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, 4, int(rng.integers(0, 300))).astype(np.uint8) for _ in range(20)]
    for s in seqs:
        for x, y in zip(native.native_minimizers(s, 21, 11), jnative.native_minimizers(s, 21, 11)):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(native.native_minimizers_batch(seqs, 21, 11), jnative.native_minimizers_batch(seqs, 21, 11)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    genomes = _genomes(9, 2)
    ref = mini.build_ref_index(*genomes[0], 21, 11)
    qs, sk = _query_sketches(mini, genomes, 10, n=12)
    uh, us, ucnt = ref.uniq_table()
    qh = np.concatenate([x[0] for x in sk])
    qpos = np.concatenate([x[1] for x in sk]).astype(np.int64)
    qstr = np.concatenate([x[2] for x in sk])
    qoff = np.zeros(len(sk) + 1, np.int64)
    np.cumsum([len(x[0]) for x in sk], out=qoff[1:])
    qlen = np.array([len(q) for q in qs], np.int64)
    common = (ref.sort_pos, ref.sort_strand, qh, qpos, qstr, qoff, qlen)
    for cap in (1000, 2):
        a = native.native_collect_anchors(uh, us, ucnt, *common, cap, 21)
        b = jnative.native_collect_anchors(uh, us, ucnt, *common, cap, 21)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        seg = (np.zeros(len(qs), np.int64), np.full(len(qs), len(uh), np.int64))
        a = native.native_collect_anchors_seg(
            uh, us, ucnt, *seg, ref.sort_pos, ref.sort_strand, np.zeros(len(qs), np.int64),
            qh, qpos, qstr, qoff, qlen, np.full(len(qs), cap, np.int64), 21,
        )
        b = jnative.native_collect_anchors_seg(
            uh, us, ucnt, *seg, ref.sort_pos, ref.sort_strand, np.zeros(len(qs), np.int64),
            qh, qpos, qstr, qoff, qlen, np.full(len(qs), cap, np.int64), 21,
        )
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    n = 6
    codes = [rng.integers(0, 4, 150).astype(np.uint8) for _ in range(n)]
    names = [f"read{i}" for i in range(n)]
    contigs = ["ctgA", "contig_B"]
    mis = [np.sort(rng.choice(150, int(rng.integers(0, 4)), replace=False)) for _ in range(n)]
    mis_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(m) for m in mis], out=mis_off[1:])
    de = ["0", "0.0067", "0.0133", "0", "0.02", "0"]
    args = (
        "".join(names).encode(), np.cumsum([0] + [len(s) for s in names]),
        np.array([0, 16, 0, 16, 0, 0], np.int32),
        "".join(contigs).encode(), np.cumsum([0] + [len(s) for s in contigs]),
        np.array([0, 1, 1, 0, 0, 1], np.int32), rng.integers(1, 5000, n).astype(np.int32),
        rng.integers(0, 61, n).astype(np.int32), np.concatenate(mis).astype(np.int32), mis_off,
        np.full(n, 150, np.int32), np.concatenate(codes), np.arange(n + 1) * 150,
        rng.integers(200, 300, n).astype(np.int32), rng.integers(5, 30, n).astype(np.int32),
        rng.integers(100, 140, n).astype(np.int64), rng.integers(0, 100, n).astype(np.int64),
        np.zeros(n, np.int32), "".join(de).encode(), np.cumsum([0] + [len(s) for s in de]),
    )
    a, b = native.native_assemble_sam_lines(*args), jnative.native_assemble_sam_lines(*args)
    assert a[0] == b[0] and len(a[1]) == n + 1 and a[0].startswith(b"read0\t0\tctgA\t")
    np.testing.assert_array_equal(a[1], b[1])


def _records(mod, n: int = 12):
    rng = np.random.default_rng(12)
    recs = []
    for i in range(n):
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 150))
        if i % 4 == 3:
            recs.append(mod.unmapped_record(f"q{i}", seq))
        else:
            recs.append(mod.SamRecord(
                f"q{i}", 16 if i % 2 else 0, f"ctg{i % 3}", int(rng.integers(1, 9000)), 60,
                "150=", seq, ["NM:i:0", f"ms:i:{300 - i}", "tp:A:P"],
            ))
    return recs


def test_sam_and_stats_copies(tmp_path):
    for mod, d in ((sam, tmp_path / "t"), (jsam, tmp_path / "j")):
        d.mkdir()
        recs = _records(mod)
        assert [r.to_line() for r in recs] == [r.to_line() for r in _records(jsam)]
        mod.write_batch_sam(d / "b1.sam.gz", recs[:7])
        mod.write_batch_sam(d / "b2.sam.gz", recs[7:])
        mod.aggregate_sams(d / "out.sam_summary.gz", [d / "b1.sam.gz", d / "b2.sam.gz"],
                           banners=["intermediate/05_map/b1.sam.gz", "intermediate/05_map/b2.sam.gz"])
    for name in ("b1.sam.gz", "b2.sam.gz", "out.sam_summary.gz"):
        # gzip members carry their write time: compare the contents
        assert gzip.open(tmp_path / "t" / name).read() == gzip.open(tmp_path / "j" / name).read()
    t_lines = list(sam.read_sam_summary(tmp_path / "t" / "out.sam_summary.gz"))
    assert t_lines == list(jsam.read_sam_summary(tmp_path / "j" / "out.sam_summary.gz"))
    assert sam.summary_first3(tmp_path / "t" / "out.sam_summary.gz") == jsam.summary_first3(
        tmp_path / "j" / "out.sam_summary.gz"
    )
    fa = tmp_path / "q.fa"
    fa.write_text("".join(f">q{i}\nACGT\n" for i in range(15)))
    a = stats.compute_stats(tmp_path / "t" / "out.sam_summary.gz", fa)
    b = jstats.compute_stats(tmp_path / "j" / "out.sam_summary.gz", fa)
    assert a.to_tsv() == b.to_tsv()
    raw = sam.RawSamRecord(t_lines[1] + "\n", 0, len(t_lines[1]), "q0", 0)
    jraw = jsam.RawSamRecord(t_lines[1] + "\n", 0, len(t_lines[1]), "q0", 0)
    assert (raw.to_line(), raw.rname, raw.pos, raw.cigar, raw.tags) == (
        jraw.to_line(), jraw.rname, jraw.pos, jraw.cigar, jraw.tags
    )


def test_asmtar_readers(tmp_path):
    genomes = [(f"SAMX{g}", [(f"SAMX{g}.c{c}", bytes(np.random.default_rng(g + c).choice(
        np.frombuffer(b"ACGTN", np.uint8), 500))) for c in range(2)]) for g in range(4)]
    tar = tmp_path / "b.tar.xz"
    asmtar.write_batch_tar(tar, genomes)
    sel = {"SAMX1", "SAMX3"}
    for cache in (None, tmp_path / "tc"):
        jcache = None if cache is None else tmp_path / "jc"
        for s in (None, sel):
            got = list(asmtar.iter_assemblies_cached(tar, s, cache))
            want = list(jasmtar.iter_assemblies_cached(tar, s, jcache))
            assert [g for g, _ in got] == [g for g, _ in want]
            for (_, a), (_, b) in zip(got, want):
                assert [c for c, _ in a] == [c for c, _ in b]
                for (_, x), (_, y) in zip(a, b):
                    np.testing.assert_array_equal(x, y)
    assert [g for g, _ in asmtar.iter_batch_assemblies(tar, sel)] == ["SAMX1", "SAMX3"]
    assert isinstance(asmtar.open_asm_cache(tar, tmp_path / "tc"), asmtar.AsmCache)


def test_traceback_helpers():
    """reconstruct_planes / traceback_walk / traceback_one / align_oracle
    (numpy host code) against the JAX package's, on planes of gapped
    pairs."""
    import torch

    rng = np.random.default_rng(13)
    p, l, band = 6, 60, 128
    q = rng.integers(0, 4, (p, l)).astype(np.uint8)
    r = rng.integers(0, 4, (p, l + band)).astype(np.uint8)
    for i in range(p):
        s = np.delete(q[i], [10 + i, 30]) if i % 2 else np.insert(q[i], 20, [0, 1, 2])
        r[i, 40 : 40 + len(s)] = s
    ql = np.full(p, l, np.int32)
    v = np.ones((p, l + band), bool)
    res = text.extend_banded(*[torch.from_numpy(a) for a in (q, ql, r, v)])
    planes = res.p_plane.numpy()
    for a, b in zip(text.reconstruct_planes(planes), jext.reconstruct_planes(planes)):
        np.testing.assert_array_equal(a, b)
    allp = text.reconstruct_planes(planes)
    for i in range(p):
        end_d = int(res.end_d[i])
        got = text.traceback_walk(tuple(x[i] for x in allp), planes[i], q[i], l, r[i], end_d, rvalid=v[i])
        want = jext.traceback_walk(tuple(x[i] for x in allp), planes[i], q[i], l, r[i], end_d, rvalid=v[i])
        assert got == want
        assert any(op in ("I", "D") for _, op in got[0])
        assert text.traceback_one(planes[i], q[i], l, r[i], end_d) == jext.traceback_one(planes[i], q[i], l, r[i], end_d)
        assert text.align_oracle(q[i], r[i]) == jext.align_oracle(q[i], r[i]) == float(res.score[i])


def test_read_filtered_fasta_and_ram_sampler(tmp_path):
    from phylign_tpu_torch.io.fastx import read_fastx_file

    fa = tmp_path / "f.fa"
    fa.write_text(">q1 A,B\nACGT\n>q2\nGG\n>q3 C\nTT\n")
    a = tfilter.read_filtered_fasta(read_fastx_file(fa))
    b = jfilter.read_filtered_fasta(jfastx.read_fastx_file(fa))
    assert [(x.qname, x.seq, x.candidates) for x in a] == [(x.qname, x.seq, x.candidates) for x in b]
    with bench.RamSampler(interval=0.01) as s:
        _ = bytearray(1 << 20)
    assert s.max_delta_kb >= 0 and isinstance(s, bench.RamSampler)
    assert set(vars(bench.RamSampler())) == set(vars(jbench.RamSampler()))


def test_make_perf_fixture_trees_are_identical(tmp_path):
    kw = dict(n_batches=2, genomes_per_batch=3, n_reads=64, seed=3, genome_len=(2000, 3000))
    testing.make_perf_fixture(tmp_path / "t", **kw)
    jtesting.make_perf_fixture(tmp_path / "j", **kw)
    for sub in ("input/perf_reads.fq", "data/batches_small.txt", "config.yaml"):
        assert (tmp_path / "t" / sub).read_bytes() == (tmp_path / "j" / sub).read_bytes()
    for b in ("perf_00__01", "perf_01__01"):
        got = list(asmtar.iter_batch_assemblies(tmp_path / "t" / "asms" / f"{b}.tar.xz"))
        want = list(jasmtar.iter_batch_assemblies(tmp_path / "j" / "asms" / f"{b}.tar.xz"))
        assert [(g, [(c, s.tobytes()) for c, s in cs]) for g, cs in got] == [
            (g, [(c, s.tobytes()) for c, s in cs]) for g, cs in want
        ]
        assert (tmp_path / "t" / "cobs" / f"{b}.cobs_classic.xz").exists()
