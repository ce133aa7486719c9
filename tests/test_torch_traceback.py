"""The delegated extension's traceback on the card (``csrc/traceback_walk.cu``,
``phylign_tpu_torch.ops.extend.traceback_cuda``) and its plain version
``traceback_ref``, held to the host walk (``reconstruct_planes`` +
``traceback_walk``) on gapped pairs: 30 bp deletions, short and long
insertions, an insertion at row 0, deletions down to offset 0, windows cut
by a contig's edges (-1e30 cells at the band's edge), unrelated sequences
(ties everywhere), bands 128-512, rows 96-3,328. Tolerance: exact (the
CIGAR and start_d of every pair, the kernel's bytes against the plain
version's). The CPU tier also holds the port's host walk to the JAX
package's on every case, so the kernel is held to it through that chain.

The CPU part runs everywhere; the tests that need the card are marked
``cuda`` and skip without one. On the card (no jax there, so the repo's
conftest is left out):

    python -m pytest --noconftest tests/test_torch_traceback.py
"""

import numpy as np
import pytest
import torch

from phylign_tpu_torch.align import engine as tae
from phylign_tpu_torch.kmer import encode_seq
from phylign_tpu_torch.ops import extend as te
from phylign_tpu_torch.ops import minimizer as tmini
from phylign_tpu_torch.utils import trace


def _pair(rng, l, band, kind):
    """One gapped pair of a chunk at (L, band): (query codes [L], q_len,
    window codes [L + band], lo, hi)."""
    wlen = l + band
    ref = rng.integers(0, 4, wlen).astype(np.uint8)
    off = 0 if kind == "del_to_0" else band // 2
    qlen = l - int(rng.integers(0, 8))
    a = int(rng.integers(qlen // 4, 3 * qlen // 4))
    src = ref[off:]
    ins = {"ins_short": int(rng.integers(1, 6)), "ins_long": 25}
    if kind in ("del30", "del_to_0", "edge_lo", "edge_hi"):
        q = np.concatenate([src[:a], src[a + 30:]])
    elif kind in ins:
        q = np.concatenate([src[:a], rng.integers(0, 4, ins[kind]).astype(np.uint8), src[a:]])
    elif kind == "ins_row0":  # 4 bases that the window's diagonal does not hold
        q = np.concatenate([(ref[off - 4 : off] + 1 + rng.integers(0, 3, 4)).astype(np.uint8) % 4, src])
    else:  # "random": nothing in common, ties everywhere
        q = rng.integers(0, 4, l).astype(np.uint8)
    q = q[:qlen].copy()
    flip = rng.random(len(q)) < 0.01
    q[flip] = (q[flip] + 1) % 4
    codes = np.zeros(l, np.uint8)
    codes[: len(q)] = q
    lo, hi = 0, wlen
    if kind == "edge_lo":  # the contig starts after the read's first bases
        lo = off + 5
    elif kind == "edge_hi":  # ... or ends before its last ones
        hi = off + qlen + 10
    return codes, len(q), ref, lo, hi


def _chunk(seed, l, band, kinds):
    """A plane pass's chunk: its inputs and extend_ref's plane and end_d."""
    rng = np.random.default_rng(seed)
    ps = [_pair(rng, l, band, k) for k in kinds]
    q = np.stack([p[0] for p in ps])
    q_len = np.array([p[1] for p in ps], np.int32)
    r = np.stack([p[2] for p in ps])
    lo = np.array([p[3] for p in ps], np.int32)
    hi = np.array([p[4] for p in ps], np.int32)
    cols = np.arange(l + band)[None, :]
    mask = (cols >= lo[:, None]) & (cols < hi[:, None])
    res = te.extend_ref(*[torch.from_numpy(x) for x in (q, q_len, r, mask)], collect_plane=True)
    return dict(q=q, q_len=q_len, r=r, lo=lo, hi=hi, mask=mask, plane=res.p_plane,
                end_d=res.end_d, n=len(kinds))


def _host(ch, plane=None):
    """reconstruct_planes + traceback_walk of each pair, None where it fails."""
    pl = (ch["plane"] if plane is None else plane).numpy()
    planes = te.reconstruct_planes(pl)
    out = []
    for j in range(ch["n"]):
        try:
            out.append(te.traceback_walk(
                tuple(x[j] for x in planes), pl[j], ch["q"][j], int(ch["q_len"][j]), ch["r"][j],
                int(ch["end_d"][j]), rvalid=ch["mask"][j]))
        except (AssertionError, IndexError):
            out.append(None)
    return out


def _packed(ch, device, plane=None):
    """traceback_ref's and traceback_cuda's arguments on ``device``."""
    arrays = (te.pack2bit(ch["q"]), ch["q_len"], te.pack2bit(ch["r"]), ch["lo"], ch["hi"])
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
    pl = ch["plane"] if plane is None else plane
    return (pl.to(device), *ins, ch["end_d"].to(device), ch["n"])


def _decoded(tb):
    """Each pair's (runs, start_d), None where its walk failed."""
    ops, meta = tb.ops.cpu().numpy(), tb.meta.cpu().numpy()
    return [None if meta[j, 0] < 0 else te.decode_traceback(ops[j : j + 1], meta[j : j + 1])[0]
            for j in range(len(meta))]


KINDS = ("del30", "del_to_0", "ins_short", "ins_long", "ins_row0", "edge_lo", "edge_hi", "random")
#: (L, band, kinds, pairs of each kind)
CASES = [
    *[(256, band, (k,), 3) for band in (128, 256) for k in KINDS],
    (96, 128, KINDS, 1),
    (3328, 128, ("del30", "ins_long", "edge_hi"), 1),
    (3328, 256, ("del_to_0", "edge_lo"), 1),
]
IDS = [f"{'mixed' if len(k) > 1 else k[0]}-L{l}-band{b}" for l, b, k, _ in CASES]


def _case_chunk(l, band, kinds, reps):
    return _chunk(l * 7 + band + len(kinds), l, band, [k for k in kinds for _ in range(reps)])


def _check_kind(kind, walks, ch, rows):
    """The pairs of a kind (``rows`` of the chunk) exercise what it is
    named for."""
    band = ch["plane"].shape[2]
    longest = {op: [max((n for n, o in runs if o == op), default=0) for runs, _ in walks] for op in "ID"}
    if kind in ("del30", "del_to_0"):
        assert min(longest["D"]) >= 21, walks  # family 2's gap
    if kind == "del_to_0":
        assert all(start_d == 0 for _, start_d in walks)
    if kind == "ins_long":
        assert min(longest["I"]) >= 21, walks
    if kind in ("ins_row0", "edge_lo"):  # an insertion at row 0
        assert any(runs[0][1] == "I" for runs, _ in walks), walks
    if kind == "edge_hi":  # -1e30 cells at the band's edge
        for j in rows:
            assert (ch["plane"][j, : ch["q_len"][j], band - 1] == float(te.NEG)).any()


@pytest.mark.parametrize("l,band,kinds,reps", CASES, ids=IDS)
def test_traceback_ref_equals_host_walk(l, band, kinds, reps):
    """traceback_ref's CIGAR and start_d equal reconstruct_planes +
    traceback_walk's for every pair, bit for bit."""
    ch = _case_chunk(l, band, kinds, reps)
    want = _host(ch)
    got = _decoded(te.traceback_ref(*_packed(ch, "cpu")))
    assert all(w is not None for w in want)
    assert got == want
    for k, kind in enumerate(kinds):
        rows = range(k * reps, (k + 1) * reps)
        _check_kind(kind, [want[j] for j in rows], ch, rows)


@pytest.mark.parametrize("l,band,kinds,reps", CASES, ids=IDS)
def test_host_walk_equals_jax_package(l, band, kinds, reps):
    """The port's host walk, which traceback_ref and the kernel are held
    to, equals the JAX package's (its reconstruct_planes + traceback_walk
    over the same plane) on every case: the contig edges, the -1e30 cells
    at the band's edge, insertions at row 0, family 2's long gaps, band
    256, 3,328 rows."""
    if torch.cuda.is_available():
        pytest.skip("the JAX package is the CPU tier's reference and is not run beside a card")
    jext = pytest.importorskip("phylign_tpu.ops.extend", reason="the JAX package is the CPU tier's reference")
    ch = _case_chunk(l, band, kinds, reps)
    pl = ch["plane"].numpy()
    planes = jext.reconstruct_planes(pl)
    want = [jext.traceback_walk(
        tuple(x[j] for x in planes), pl[j], ch["q"][j], int(ch["q_len"][j]), ch["r"][j],
        int(ch["end_d"][j]), rvalid=ch["mask"][j]) for j in range(ch["n"])]
    assert _host(ch) == want


def test_plane_pass_rows_past_q_len_are_not_read():
    """Rows at and past a pair's q_len (garbage in the plane pass's
    output) change nothing."""
    ch = _case_chunk(96, 128, KINDS, 1)
    plane = ch["plane"].clone()
    for j, n in enumerate(ch["q_len"]):
        plane[j, n:] = float(te.NEG) * 2
    assert _decoded(te.traceback_ref(*_packed(ch, "cpu", plane))) == _host(ch)


def _broken(ch):
    """The chunk with pair 1's walk started at offset 0 of its last row,
    where P is below -1e30: H = D1 != P there and no gap start lies below
    (traceback_walk's "deletion traceback failed")."""
    plane, end_d = ch["plane"].clone(), ch["end_d"].clone()
    plane[1, int(ch["q_len"][1]) - 1, 0] = float(te.NEG) * 2
    end_d[1] = 0
    return {**ch, "plane": plane, "end_d": end_d}


def test_failed_walk_is_flagged_and_raises():
    """Where the host walk fails, the plain version flags the pair (-1 ops)
    and decode_traceback raises; the other pairs are walked."""
    ch = _broken(_case_chunk(256, 128, ("del30",), 3))
    want = _host(ch)
    assert want[1] is None and want[0] is not None and want[2] is not None
    tb = te.traceback_ref(*_packed(ch, "cpu"))
    assert tb.meta[1, 0] == -1
    assert _decoded(tb) == want
    with pytest.raises(te.TracebackError, match="deletion traceback failed for pairs \\[1\\]"):
        te.decode_traceback(tb.ops.numpy(), tb.meta.numpy())


def test_decode_traceback_runs():
    """Op codes at the end of each row -> run-length lists, across pairs
    whose ops touch (a run never crosses two pairs)."""
    w = 8
    ops = np.full((3, w), 9, np.uint8)
    ops[0, 3:] = [0, 0, 1, 0, 0]
    ops[1, 6:] = [0, 0]
    ops[2, :] = [2, 2, 0, 3, 3, 3, 0, 1]
    meta = np.array([[5, 4], [2, 0], [8, 7]], np.int32)
    assert te.decode_traceback(ops, meta) == [
        ([(2, "="), (1, "X"), (2, "=")], 4),
        ([(2, "=")], 0),
        ([(2, "I"), (1, "="), (3, "D"), (1, "="), (1, "X")], 7),
    ]
    assert te.decode_traceback(ops[:0], meta[:0]) == []
    meta[2, 0] = 0
    assert te.decode_traceback(ops, meta)[2] == ([], 7)


def test_dispatch_by_device():
    """The engine walks on the card only for a plane on one CUDA device;
    the kernel's wrapper refuses CPU tensors without counting a launch."""
    assert tae._walk_on_device(torch.device("cuda"), None)
    assert not tae._walk_on_device(torch.device("cuda"), object())
    assert not tae._walk_on_device(torch.device("cpu"), None)
    ch = _case_chunk(96, 128, ("del30",), 2)
    args = _packed(ch, "cpu")
    before = te.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        te.traceback_cuda(*args)
    assert te.launch_counts() == before


def _mk(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _gene_tasks():
    """Genes of 300-1,000 bp planted in a 30 kb contig, with 30 bp deletions,
    an insertion and substitutions: the map cell's gapped pairs."""
    rng = np.random.default_rng(21)
    contig = _mk(rng, 30000)
    params = tae.AlignParams.from_preset("sr")
    genes = []
    for g in range(10):
        n = int(rng.integers(300, 1000))
        s = int(rng.integers(0, 30000 - n - 40))
        seq = contig[s : s + n + 30]
        a = n // 2
        if g % 3 == 0:
            seq = seq[:a] + seq[a + 30:]
        elif g % 3 == 1:
            seq = seq[:a] + _mk(rng, 4) + seq[a : n]
        else:
            seq = seq[:n]
        seq = "".join(("ACGT"[("ACGT".index(c) + 1) % 4] if rng.random() < 0.01 else c) for c in seq)
        genes.append(seq)
    ref = tmini.build_ref_index("g", [("c1", encode_seq(contig.encode()))], params.k, params.w)
    tasks = [tae.make_pair(ref, tae.QuerySketch.make(f"q{i}", s, params), params) for i, s in enumerate(genes)]
    return tasks, params


def _records(tasks, params, fused, device):
    return [r.to_line() for r in tae.flush_pairs(tasks, params, fused=fused, device=device)]


@pytest.mark.parametrize("fused", [False, True])
def test_engine_route_on_device_equals_host_walk(fused, monkeypatch):
    """The engine's route for a plane on one card (the walks fetched, not
    the plane), run with the plain version on the CPU, gives the records of
    the host walk, and counts its pairs as walked on the device."""
    tasks, params = _gene_tasks()
    want = _records(tasks, params, fused, "cpu")
    trace.reset()
    monkeypatch.setattr(tae, "_walk_on_device", lambda device, mesh: mesh is None)
    monkeypatch.setattr(te, "traceback_cuda", te.traceback_ref)
    monkeypatch.setattr(te, "traceback_walk", None)  # the host walk is not taken
    got = _records(tasks, params, fused, "cpu")
    assert got == want
    c = trace.snapshot()["counts"]
    assert c["align.traceback_pairs"] == c["align.device_traceback_pairs"] > 0


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CUDA_CASES = CASES + [(256, band, KINDS, 1) for band in (384, 512)]
CUDA_IDS = IDS + [f"mixed-L256-band{b}" for b in (384, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("l,band,kinds,reps", CUDA_CASES, ids=CUDA_IDS)
def test_kernel_equals_plain_version_and_host_walk(cuda, l, band, kinds, reps):
    """The kernel's ops and meta equal traceback_ref's byte for byte, and
    its CIGARs and start_d the host walk's, on extend_ref's plane and on
    the card's plane pass (B4) of the same chunk."""
    ch = _case_chunk(l, band, kinds, reps)
    want = _host(ch)
    ref = te.traceback_ref(*_packed(ch, "cpu"))
    before = te.launch_counts().get("traceback_walk", 0)
    tb = te.traceback_cuda(*_packed(ch, cuda))
    torch.cuda.synchronize()
    assert te.launch_counts()["traceback_walk"] == before + 1
    assert torch.equal(tb.meta.cpu(), ref.meta)
    n_ops = ref.meta[:, 0].tolist()
    w = tb.ops.shape[1]
    for j, k in enumerate(n_ops):
        assert torch.equal(tb.ops[j, w - k :].cpu(), ref.ops[j, w - k :])
    assert _decoded(tb) == want
    # the plane as the engine's card path has it: B4's plane pass
    g = _packed(ch, cuda)
    b4 = te.extend_banded_packed(*g[1:6], l, l + band)
    assert torch.equal(b4.p_plane.cpu(), ch["plane"]) and torch.equal(b4.end_d.cpu(), ch["end_d"])
    assert _decoded(te.traceback_cuda(b4.p_plane, *g[1:])) == want


@pytest.mark.cuda
def test_kernel_flags_a_failed_walk(cuda):
    ch = _broken(_case_chunk(256, 128, ("del30",), 3))
    tb = te.traceback_cuda(*_packed(ch, cuda))
    assert torch.equal(tb.meta.cpu(), te.traceback_ref(*_packed(ch, "cpu")).meta)
    assert tb.meta[1, 0].item() == -1
    assert _decoded(tb) == _host(ch)


@pytest.mark.cuda
def test_kernel_on_no_pairs_and_a_tail_of_the_chunk(cuda):
    """n = 0 launches nothing; n below the plane's pairs walks the first n
    (the plane pass's padding rows are left alone)."""
    ch = _case_chunk(256, 128, KINDS, 1)
    args = list(_packed(ch, cuda))
    before = dict(te.launch_counts())
    args[-1] = 0
    tb = te.traceback_cuda(*args)
    assert tb.ops.shape == (0, 2 * 256 + 128) and te.launch_counts() == before
    args[-1] = 5
    assert _decoded(te.traceback_cuda(*args)) == _host(ch)[:5]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_engine_on_the_card_equals_the_host_walk(cuda, fused, monkeypatch):
    """flush_pairs on the card gives the CPU's records (CIGAR, POS, NM, AS,
    de: the whole line) without running the host walk, and every gapped
    pair is walked on the card."""
    tasks, params = _gene_tasks()
    want = _records(tasks, params, fused, "cpu")
    trace.reset()
    monkeypatch.setattr(te, "traceback_walk", None)
    monkeypatch.setattr(te, "reconstruct_planes", None)
    got = _records(tasks, params, fused, cuda)
    assert got == want
    c = trace.snapshot()["counts"]
    assert c["align.traceback_pairs"] == c["align.device_traceback_pairs"] > 0
