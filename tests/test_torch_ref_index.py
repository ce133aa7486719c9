"""A candidate genome's minimizer table on the card (``csrc/ref_index.cu``:
``ref_sketch``, ``ref_sort``; ``phylign_tpu_torch.ops.minimizer``) and their
plain versions ``ref_sketch_ref`` and ``ref_sort_ref``, held to the host
path they replace (the native sketch and ``np.argsort(h, kind="stable")``
of ``build_ref_index(_batch)``) and to the JAX package's
``build_ref_index``: the map cell's genomes scaled down (1-3 contigs),
contigs shorter than k and than k + w - 1, repetitive genomes (a tandem
repeat, poly-A: thousands of equal hashes, more than a sort block holds),
an empty genome; the kernels' tile and pass arithmetic emulated in numpy at
small tiles; the wrappers' refusals; the route (the card for a CUDA device,
the native path on the CPU and for hpc) and its counter. Tolerance: exact
(every field of the RefIndex).

The CPU part runs everywhere; the tests that need the card are marked
``cuda`` and skip without one. On the card (no jax there, so the repo's
conftest is left out):

    python -m pytest --noconftest tests/test_torch_ref_index.py
"""

import numpy as np
import pytest
import torch

from phylign_tpu_torch.align import engine as tae
from phylign_tpu_torch.io import asmtar
from phylign_tpu_torch.match.filter import FilteredQuery
from phylign_tpu_torch.ops import minimizer as opm
from phylign_tpu_torch.utils import trace

FIELDS = ("contig_starts", "contig_lens", "codes", "sort_hash", "sort_pos", "sort_strand")


def _genome(seed: int, kind: str):
    """(name, contigs) of one test genome."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    if kind == "cell1":  # 2.75 Mb in one contig, scaled down
        lens = [27_500]
    elif kind == "cell2":  # 4.25 Mb in two
        lens = [30_000, 12_500]
    elif kind == "cell3":
        lens = [15_000, 9_000, 4_000]
    elif kind == "short":  # under k (21), at k, under k + w - 1 (31), at it
        lens = [0, 5, 20, 21, 25, 30, 31, 35, 3_000, 1]
    elif kind == "repeats":
        unit = rand(37)
        return "rep", [("tandem", np.tile(unit, 300)), ("polyA", np.zeros(6_000, np.uint8)),
                       ("dinuc", np.tile(np.array([0, 3], np.uint8), 2_000)), ("plain", rand(2_000))]
    elif kind == "empty":
        return "empty", []
    else:
        raise ValueError(kind)
    return kind, [(f"{kind}.c{i}", rand(n)) for i, n in enumerate(lens)]


KINDS = ("cell1", "cell2", "cell3", "short", "repeats", "empty")
KW = ((21, 11), (15, 10), (19, 19))


def _assert_same(a, b):
    assert (a.name, a.contig_names, a.k, a.w) == (b.name, b.contig_names, b.k, b.w)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _plain_route(monkeypatch):
    """index_on_device true everywhere, so a CPU device takes the device
    route with the plain versions (device_tables on the CPU)."""
    monkeypatch.setattr(opm, "index_on_device", lambda device, hpc, k, w: not hpc)


@pytest.mark.parametrize("k,w", KW, ids=[f"k{k}w{w}" for k, w in KW])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_tables_equal_the_host_path(kind, k, w, monkeypatch):
    """The device route's RefIndex from ref_sketch_ref + ref_sort_ref is
    field-identical to the native build_ref_index_batch and build_ref_index."""
    name, contigs = _genome(3, kind)
    want = opm.build_ref_index_batch([(name, contigs)], k, w)[0]
    _assert_same(opm.build_ref_index(name, contigs, k, w), want)
    _plain_route(monkeypatch)
    _assert_same(opm.build_ref_index_batch([(name, contigs)], k, w, device="cpu")[0], want)
    _assert_same(opm.build_ref_index(name, contigs, k, w, device="cpu"), want)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_tables_equal_jax_package(kind, monkeypatch):
    """... and to the JAX package's build_ref_index."""
    if torch.cuda.is_available():
        pytest.skip("the JAX package is the CPU tier's reference and is not run beside a card")
    jmini = pytest.importorskip("phylign_tpu.ops.minimizer", reason="the JAX package is the CPU tier's reference")
    name, contigs = _genome(4, kind)
    _plain_route(monkeypatch)
    _assert_same(opm.build_ref_index(name, contigs, 21, 11, device="cpu"),
                 jmini.build_ref_index(name, contigs, 21, 11))


def _emulate_sketch(codes, starts, lens, k, w, tile):
    """ref_sketch_kernel's arithmetic, tile by tile: the positions hashed
    [a, e), the windows [a, s_hi] and each position's test against the
    windows covering it, in the write pass's order."""
    inf = torch.iinfo(torch.int64).max
    out = []
    for start, length in zip(starts, lens):
        n = length - k + 1
        if n <= 0:
            continue
        wc = min(w, n)
        nw = n - wc + 1
        for p0 in range(0, n, tile):
            p1 = min(p0 + tile, n)
            a, e, s_hi = max(0, p0 - wc + 1), min(n, p1 + wc - 1), min(nw - 1, p1 - 1)
            seg = torch.from_numpy(codes[start + a : start + e + k - 1].astype(np.int64))
            hn = e - a
            f = torch.zeros(hn, dtype=torch.int64)
            r = torch.zeros(hn, dtype=torch.int64)
            for j in range(k):
                f = (f << 2) | seg[j : j + hn]
                r = r | ((3 - seg[j : j + hn]) << (2 * j))
            st = r < f
            h = torch.where(f == r, inf, opm._hash64_ref(torch.where(st, r, f), (1 << 2 * k) - 1)).tolist()
            wmin = {s: min(h[s - a : s - a + wc]) for s in range(a, s_hi + 1)}
            for p in range(p0, p1):
                hp = h[p - a]
                if hp != inf and any(wmin[s] == hp for s in range(max(0, p - wc + 1), min(p, nw - 1) + 1)):
                    out.append((hp, start + p, int(st[p - a])))
    return out


@pytest.mark.parametrize("tile", [7, 64, opm.SKETCH_TILE])
@pytest.mark.parametrize("kind,k,w", [("cell3", 21, 11), ("short", 21, 11), ("repeats", 15, 10),
                                      ("cell2", 19, 19)])
def test_sketch_tiles_emulated(kind, k, w, tile):
    """The kernel's tiles (at its own size and at small ones, so that
    windows straddle many tile edges) give ref_sketch_ref's sketch."""
    _, contigs = _genome(5, kind)
    starts, lens, codes = opm._assemble(contigs)
    h, p, s = opm.ref_sketch_ref(torch.from_numpy(codes), torch.tensor(starts), torch.tensor(lens), k, w)
    got = _emulate_sketch(codes, starts, lens, k, w, tile)
    assert got == list(zip(h.tolist(), p.tolist(), s.tolist()))


def _emulate_sort(h, pos, strand, bits, tile, threads, warp=32):
    """ref_sort_hist_kernel + ref_scan_kernel + ref_sort_scatter_kernel, pass by
    pass: each block's digit counts (digit-major), their exclusive sum, and
    each round's ranks (a thread's peers in its warp below it, then the
    earlier warps' counts of its digit, over the digit's running offset)."""
    m = len(h)
    nb = -(-m // tile)
    vals = (pos.astype(np.int64) << 1) | strand
    for shift in range(0, bits, 8):
        d = (h >> np.uint64(shift)).astype(np.int64) & 255
        hist = np.zeros((256, nb), np.int64)
        for b in range(nb):
            hist[:, b] = np.bincount(d[b * tile : (b + 1) * tile], minlength=256)
        offs = (np.cumsum(hist.ravel()) - hist.ravel()).reshape(256, nb)
        nh, nv = np.empty_like(h), np.empty_like(vals)
        for b in range(nb):
            run = offs[:, b].copy()
            for r0 in range(b * tile, min((b + 1) * tile, m), threads):
                dd = d[r0 : min(r0 + threads, (b + 1) * tile, m)]
                before = np.zeros(256, np.int64)  # the earlier warps' counts
                for w0 in range(0, len(dd), warp):
                    wd = dd[w0 : w0 + warp]
                    for j, x in enumerate(wd):
                        o = run[x] + before[x] + int((wd[:j] == x).sum())
                        nh[o], nv[o] = h[r0 + w0 + j], vals[r0 + w0 + j]
                    before += np.bincount(wd, minlength=256)
                run += before
        h, vals = nh, nv
    return h, (vals >> 1).astype(np.int32), (vals & 1).astype(np.uint8)


@pytest.mark.parametrize("bits", [2, 10, 42])
def test_sort_passes_emulated(bits):
    """The sort's passes (small blocks and rounds: several of each, a digit
    spread over blocks) order like ref_sort_ref and np.argsort(kind="stable"),
    on hashes with many ties (position order breaks them)."""
    rng = np.random.default_rng(bits)
    m = 1_500
    h = rng.integers(0, 1 << min(bits, 12), m).astype(np.uint64) << np.uint64(max(0, bits - 12))
    h[rng.random(m) < 0.3] = np.uint64((1 << bits) - 1)  # one hash shared by a third
    pos = np.sort(rng.choice(1 << 20, m, replace=False)).astype(np.int32)
    strand = rng.integers(0, 2, m).astype(np.uint8)
    order = np.argsort(h, kind="stable")
    want = (h[order], pos[order], strand[order])
    got = _emulate_sort(h, pos, strand, bits, tile=200, threads=64, warp=16)
    plain = opm.ref_sort_ref(torch.from_numpy(h.view(np.int64)), torch.from_numpy(pos),
                             torch.from_numpy(strand), bits)
    for g, p, x in zip(got, plain, want):
        np.testing.assert_array_equal(g, x)
        np.testing.assert_array_equal(p.numpy().view(x.dtype), x)


def _sketch_args():
    _, contigs = _genome(6, "cell3")
    starts, lens, codes = opm._assemble(contigs)
    return torch.from_numpy(codes), torch.tensor(starts), torch.tensor(lens)


@pytest.mark.parametrize("fn", [opm.ref_sketch_ref, opm.ref_sketch_cuda])
@pytest.mark.parametrize("case", ["dtype", "lens_dtype", "strided", "table_on_card", "shapes", "k", "w",
                                  "outside"])
def test_sketch_wrappers_refuse(fn, case):
    codes, starts, lens = _sketch_args()
    k, w, err = 21, 11, ValueError
    if case == "dtype":
        codes, err = codes.to(torch.int32), TypeError
    elif case == "lens_dtype":
        lens, err = lens.to(torch.int32), TypeError
    elif case == "strided":
        codes = torch.stack([codes, codes], 1)[:, 0]
    elif case == "table_on_card":
        starts = starts.to("meta")
    elif case == "shapes":
        lens = lens[:-1]
    elif case == "k":
        k = 32
    elif case == "w":
        w = 256
    elif case == "outside":
        lens = lens + 10_001
    with pytest.raises(err):
        fn(codes, starts, lens, k, w)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU the kernels' wrappers raise; only the plain versions run."""
    codes, starts, lens = _sketch_args()
    with pytest.raises(ValueError, match="CUDA"):
        opm.ref_sketch_cuda(codes, starts, lens, 21, 11)
    with pytest.raises(ValueError, match="CUDA"):
        opm.ref_sort_cuda(*opm.ref_sketch_ref(codes, starts, lens, 21, 11), 42)


@pytest.mark.parametrize("fn", [opm.ref_sort_ref, opm.ref_sort_cuda])
@pytest.mark.parametrize("case", ["hash_dtype", "pos_dtype", "strand_dtype", "shapes", "strided", "devices",
                                  "bits"])
def test_sort_wrappers_refuse(fn, case):
    h, p, s = opm.ref_sketch_ref(*_sketch_args(), 21, 11)
    bits, err = 42, ValueError
    if case == "hash_dtype":
        h, err = h.to(torch.int32), TypeError
    elif case == "pos_dtype":
        p, err = p.to(torch.int64), TypeError
    elif case == "strand_dtype":
        s, err = s.to(torch.bool), TypeError
    elif case == "shapes":
        s = s[:-1]
    elif case == "strided":
        h = torch.stack([h, h], 1)[:, 0]
    elif case == "devices":
        p = p.to("meta")
    elif case == "bits":
        bits = 65
    with pytest.raises(err):
        fn(h, p, s, bits)


@pytest.mark.parametrize("device,hpc,k,w,want", [
    ("cuda", False, 21, 11, True), ("cuda:1", False, 15, 10, True), ("cuda", True, 19, 19, False),
    ("cpu", False, 21, 11, False), (None, False, 21, 11, False), ("cuda", False, 32, 11, False),
    ("cuda", False, 21, 256, False),
])
def test_index_on_device(device, hpc, k, w, want):
    """The card for a CUDA device and a plain sketch within the kernels' k
    and w; the host for the CPU, no device, an hpc preset."""
    dev = torch.device(device) if device else None
    assert opm.index_on_device(dev, hpc, k, w) is want


@pytest.mark.parametrize("device,hpc", [("cpu", False), ("cpu", True), ("cuda", True)])
def test_host_route_is_unchanged(device, hpc, monkeypatch):
    """On the CPU, and for hpc on a card, build_ref_index(_batch) take the
    native path and never the kernels' route."""
    genomes = [_genome(7, "cell2"), _genome(8, "short")]
    want = [opm.build_ref_index_batch([g], 19, 19, hpc=hpc)[0] for g in genomes]

    def refuse(*a, **kw):
        raise AssertionError("the device route was taken")

    monkeypatch.setattr(opm, "device_tables", refuse)
    dev = torch.device(device)
    for got, w in zip(opm.build_ref_index_batch(genomes, 19, 19, hpc=hpc, device=dev), want):
        _assert_same(got, w)
    for (name, contigs), w in zip(genomes, want):
        _assert_same(opm.build_ref_index(name, contigs, 19, 19, hpc=hpc, device=dev), w)


def _map_inputs(tmp_path):
    """A batch tar of three genomes of 2 contigs and 24 reads with two
    candidates each."""
    rng = np.random.default_rng(31)
    genomes = []
    for g in range(3):
        contigs = [(f"SAMB{g}.c{c}", bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000))) for c in range(2)]
        genomes.append((f"SAMB{g}", contigs))
    tar = tmp_path / "b.tar.xz"
    asmtar.write_batch_tar(tar, genomes)
    queries = []
    for i in range(24):
        g = i % 3
        seq = genomes[g][1][i % 2][1]
        s = int(rng.integers(0, 3800))
        cands = [("", f"SAMB{g}", 0), ("", f"SAMB{(g + 1) % 3}", 0)]
        queries.append(FilteredQuery(f"q{i}", seq[s : s + 150].decode(), cands))
    return str(tar), queries


def _engine_runs(tar, queries, params, device):
    """Records and counters of align_batches_pooled, align_batch and
    align_genome."""
    out = []
    trace.reset()
    pooled = dict((n, [r.to_line() for r in recs]) for n, recs in tae.align_batches_pooled(
        [("b", tar, None)], queries, params, pair_chunk=20, device=device))
    out.append((pooled, trace.snapshot()["counts"]))
    trace.reset()
    one = [r.to_line() for r in tae.align_batch(tar, queries, None, params, pair_chunk=16, device=device)]
    out.append((one, trace.snapshot()["counts"]))
    trace.reset()
    contig = np.random.default_rng(2).integers(0, 4, 5000).astype(np.uint8)
    sks = [tae.QuerySketch.make(q.qname, q.seq, params) for q in queries[:4]]
    gen = [r.to_line() for r in tae.align_genome("G", [("G.c1", contig)], sks, params, device=device)]
    out.append((gen, trace.snapshot()["counts"]))
    return out


def test_engine_routes_every_genome_and_counts_it(tmp_path, monkeypatch):
    """align_batches_pooled's producers, align_batch and align_genome pass
    their device: with the route taken (the plain versions standing in for
    the kernels on the CPU) the records are the host path's, and
    align.device_ref_genomes equals align.genomes; on the host path it is 0."""
    tar, queries = _map_inputs(tmp_path)
    params = tae.AlignParams.from_preset("sr")
    host = _engine_runs(tar, queries, params, "cpu")
    for _, counts in host:
        assert counts["align.genomes"] > 0 and counts.get("align.device_ref_genomes", 0) == 0
    _plain_route(monkeypatch)
    routed = []
    real = opm.device_tables

    def tables(*a, **kw):
        routed.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr(opm, "device_tables", tables)
    dev = _engine_runs(tar, queries, params, "cpu")
    for (want, _), (got, counts) in zip(host, dev):
        assert got == want
        assert counts["align.device_ref_genomes"] == counts["align.genomes"] > 0
    assert len(routed) == sum(c["align.genomes"] for _, c in dev)
    assert {torch.device(d).type for d in routed} == {"cpu"}


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,w", KW, ids=[f"k{k}w{w}" for k, w in KW])
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_equal_plain_versions(cuda, kind, k, w):
    """ref_sketch_cuda and ref_sort_cuda give their plain versions' tensors
    byte for byte, one launch each a call."""
    _, contigs = _genome(9, kind)
    starts, lens, codes = opm._assemble(contigs)
    st, ln = torch.tensor(starts, dtype=torch.int64), torch.tensor(lens, dtype=torch.int64)
    want = opm.ref_sketch_ref(torch.from_numpy(codes), st, ln, k, w)
    before = opm.launch_counts()
    got = opm.ref_sketch_cuda(torch.from_numpy(codes).to(cuda), st, ln, k, w)
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)
    sorted_want = opm.ref_sort_ref(*want, 2 * k)
    sorted_got = opm.ref_sort_cuda(*got, 2 * k)
    for g, x in zip(sorted_got, sorted_want):
        assert torch.equal(g.cpu(), x)
    torch.cuda.synchronize()
    after = opm.launch_counts()
    n = int(want[0].numel() > 0)
    assert after["ref_sketch"] - before["ref_sketch"] == n
    assert after["ref_sort"] - before["ref_sort"] == n


@pytest.mark.cuda
def test_sort_of_equal_hashes_over_many_blocks(cuda):
    """A table of one hash repeated far past a block's items, and of two
    hashes interleaved, keeps its position order."""
    m = 50_000
    pos = torch.arange(m, dtype=torch.int32) * 3
    strand = (torch.arange(m) % 2).to(torch.uint8)
    for h in (torch.full((m,), 12345, dtype=torch.int64), (torch.arange(m) % 2) * (1 << 41)):
        want = opm.ref_sort_ref(h, pos, strand, 42)
        got = opm.ref_sort_cuda(h.to(cuda), pos.to(cuda), strand.to(cuda), 42)
        for g, x in zip(got, want):
            assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
def test_device_route_equals_native_without_a_device_wide_wait(cuda, monkeypatch):
    """build_ref_index_batch on the card is field-identical to the native
    path, waiting on its own stream only (torch.cuda.synchronize is not
    called)."""
    genomes = [_genome(10, kind) for kind in KINDS]
    want = opm.build_ref_index_batch(genomes, 21, 11)

    def refuse(*a, **kw):
        raise AssertionError("torch.cuda.synchronize called on the device route")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    for got, w in zip(opm.build_ref_index_batch(genomes, 21, 11, device=cuda), want):
        _assert_same(got, w)
