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
    assert got_stream == want
    assert want.count(",") > 0


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
