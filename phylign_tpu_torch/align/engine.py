"""Batched alignment of candidate (query, genome) pairs -> SAM records (the
counterpart of ``phylign_tpu/align/engine.py``, whose host logic it copies).

The replacement for the reference's per-genome minimap2 subprocesses
(ref: scripts/batch_align.py:416-486 map_queries_to_batch):
instead of one OS process per candidate genome, all pairs of a genome are
chained and extended as fixed-shape device batches:

  host:   tar streaming, minimizer sketching (numpy), anchor lookup
  device: chain DP over [P, A] anchor tensors (ops.chain, kernel B3), banded
          dual-affine extension over [P, L, band] (ops.extend, kernel B4),
          the gapped pairs' traceback over B4's plane (ops.extend,
          traceback_cuda) on one card
  host:   the traceback of a plane on the CPU or over a mesh, CIGAR/flag/POS
          emission

Device work runs on ``device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels). Each group of host arrays goes up in one
non-blocking copy from pinned memory (_upload) and each result comes back in
one copy into pinned memory (_HostCopy). With a device mesh
(``parallel.mesh``), chaining, extension and the fused flush run
data-parallel over the mesh's query axis (``parallel.dist``, B3/B4 on each
query shard's pairs), with identical records.

Output order matches the reference: genomes in tar order, and for each
genome its queries in filtered-file order (batch_align.py:448-478 +
minimap2's input-order output). Record shape: primary-only (sr preset sets
--secondary=no), so flags are 0/16 for mapped and 4 for unmapped — exactly
the golden file's flag set.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Iterator, Sequence

import numpy as np
import torch

from phylign_tpu_torch.io.asmtar import iter_assemblies_cached
from phylign_tpu_torch.io.sam import RawSamRecord, SamRecord, unmapped_record
from phylign_tpu_torch.kmer import decode_seq, encode_seq, revcomp_codes
from phylign_tpu_torch.match.filter import FilteredQuery
from phylign_tpu_torch.ops import chain as opc
from phylign_tpu_torch.ops import extend as ope
from phylign_tpu_torch.ops import minimizer as opm
from phylign_tpu_torch.parallel import dist
from phylign_tpu_torch.utils import trace
from phylign_tpu_torch.utils.platform import resolve_device


def _parse_extra_params(extra: str) -> dict:
    """Parse the ``minimap_extra_params`` string into AlignParams overrides.

    The reference forwards these tokens verbatim to the minimap2 CLI
    (ref: config.yaml:36-38, scripts/batch_align.py:268-270);
    this build maps the common flags onto engine knobs and rejects the rest
    loudly. Supported: -k -w -r[,long] -z[,inv] -g -A -B -O[,2] -E[,2]
    -n -m -N --secondary=no --eqx. Both attached (-N10) and detached
    (-N 10) value forms parse, as minimap2's getopt does."""
    toks = extra.split()
    over: dict = {}
    # flag -> (field(s), n-values-used). Comma forms map to the dual-affine
    # pair the way minimap2's main.c does (single value sets both).
    flag_map = {
        "-k": ("k",),
        "-w": ("w",),
        "-g": ("max_gap",),
        "-r": ("bandwidth", None),  # second value (bw_long) ignored: no
        # long-join rescue pass in this engine
        "-z": ("zdrop", None),  # second value (inversion z-drop) ignored:
        # no inversion detection (mm2 -z INT2 only matters with --inv)
        "-A": ("match",),
        "-B": ("mismatch",),
        "-O": ("gap_open1", "gap_open2"),
        "-E": ("gap_ext1", "gap_ext2"),
        "-n": ("min_chain_cnt",),
        "-m": ("min_chain_score",),
        "-N": ("n_secondary",),
    }
    i = 0
    while i < len(toks):
        tok = toks[i]
        i += 1
        if tok == "--eqx":
            continue  # the engine's only output mode already
        if tok.startswith("--secondary"):
            val = tok.split("=", 1)[1] if "=" in tok else None
            if val is None and i < len(toks):
                val, i = toks[i], i + 1
            if val == "no":
                continue  # engine default (the sr preset's setting)
            raise ValueError(
                "minimap_extra_params: --secondary=yes is unsupported — "
                "this engine emits the reference output contract's record "
                "set (primary + supplementary only; the golden summary has "
                "no 256-flag records)"
            )
        flag, attached = tok[:2], tok[2:]
        if flag not in flag_map:
            raise ValueError(
                f"unsupported minimap_extra_params token {tok!r} "
                f"(supported: {' '.join(sorted(flag_map))} "
                "--secondary=no --eqx)"
            )
        if attached:
            val = attached
        elif i < len(toks):
            val, i = toks[i], i + 1
        else:
            raise ValueError(f"minimap_extra_params: {flag} needs a value")
        parts = val.split(",")
        fields = flag_map[flag]
        try:
            nums = [float(p) for p in parts]
        except ValueError:
            raise ValueError(
                f"minimap_extra_params: bad value {val!r} for {flag}"
            ) from None
        if len(parts) > len(fields):
            raise ValueError(
                f"minimap_extra_params: too many values in {flag}{val}"
            )
        for j, f in enumerate(fields):
            if f is None:
                continue
            v = nums[min(j, len(nums) - 1)]  # single value fills the pair
            over[f] = v if f == "min_chain_score" else int(v)
    return over


@dataclass(frozen=True)
class AlignParams:
    """minimap2 preset knobs this engine honors
    (ref: config.yaml:29-38 minimap_preset + minimap_extra_params,
    batch_align.py:268-270). Defaults are the sr preset."""

    k: int = 21
    w: int = 11
    max_gap: int = 100
    bandwidth: int = 100
    min_chain_cnt: int = 2  # sr -n
    min_chain_score: float = 20.0  # sr -m
    band: int = 128  # extension band width (diagonal drift allowance)
    hpc: bool = False  # homopolymer-compressed sketching (map-pb -H)
    scoring: ope.SrScoring = field(default_factory=ope.SrScoring)
    # high-frequency seed filter (minimap2's mid_occ): seeds with more ref
    # occurrences than the cap are dropped from seeding and counted toward
    # the query's repeat length (rl:i). The sr preset pins the cap at 1000;
    # 0 means derive it per genome from the minimizer-frequency quantile
    # (mm_idx_cal_max_occ with mid_occ_frac, clamped to
    # [min_mid_occ, max_mid_occ]) the way minimap2 does for other presets.
    mid_occ: int = 1000
    mid_occ_frac: float = 2e-4
    min_mid_occ: int = 10
    max_mid_occ: int = 1_000_000
    # minimap2's second-chance seed cap (opt->max_occ; 5000 in the sr
    # preset, 0 = disabled elsewhere): a read whose mid_occ pass found no
    # chain but dropped repeat seeds is re-seeded once with this looser cap
    # (map.c mm_map_frag's rechain branch)
    max_occ: int = 5000
    is_sr: bool = True  # selects mm_set_mapq's short-read MAPQ branch
    # emission trimming (align.c mm_align1 / ksw_extz2): extensions beyond
    # the chain stop when the score falls > zdrop (+ gap-slope term) below
    # the running max; a query end whose alignment is within end_bonus of
    # the clipped max is kept full-length (ksw's end_bonus, 10 for sr); an
    # internal z-drop inside the anchor span SPLITS the region in two
    zdrop: int = 100
    end_bonus: int = 10
    max_segments: int = 3  # split-read cap: primary + (max_segments-1) supps
    # -N / --secondary: how many secondary alignments minimap2 would PRINT
    # (mm2 best_n, default 5; sr preset sets --secondary=no so none print).
    # This engine emits the reference contract's record set (primary +
    # supplementary only, golden flags 0/16/4/2048) — the knob is accepted
    # for config compatibility and validated, but cannot add records.
    n_secondary: int = 5

    def occ_cap(self, ref: "opm.RefIndex") -> int:
        """Effective occurrence cap against one genome."""
        if self.mid_occ > 0:
            return self.mid_occ
        return ref.mid_occ(self.mid_occ_frac, self.min_mid_occ, self.max_mid_occ)

    @classmethod
    def from_preset(cls, preset: str, extra_params: str = "") -> "AlignParams":
        """Build params from a minimap2 preset name (config.yaml:29-35 lists
        the supported set). Seeding/scoring constants follow minimap2's
        presets, including homopolymer-compressed sketching for map-pb
        (mm2's -H default for that preset; see ``hpc`` below). '--eqx' in
        extra_params is the default output mode already; other extra flags
        are rejected loudly."""
        table = {
            # preset: k, w, max_gap, match, mismatch, o1, e1, o2, e2, min_cnt, min_chain
            "sr": (21, 11, 100, 2, 8, 12, 2, 32, 1, 2, 20.0),
            "map-ont": (15, 10, 5000, 2, 4, 4, 2, 24, 1, 3, 40.0),
            "map-pb": (19, 19, 5000, 2, 4, 4, 2, 24, 1, 3, 40.0),
            "asm5": (19, 19, 10000, 1, 19, 39, 3, 81, 1, 3, 40.0),
            "asm10": (19, 19, 10000, 1, 9, 16, 2, 41, 1, 3, 40.0),
            "asm20": (19, 19, 10000, 1, 4, 6, 2, 26, 1, 3, 40.0),
        }
        if preset not in table:
            raise ValueError(
                f"unsupported minimap preset {preset!r}; supported: {sorted(table)}"
            )
        over = _parse_extra_params(extra_params)
        k, w, gap, m, x, o1, e1, o2, e2, cnt, chain = table[preset]
        k = over.pop("k", k)
        w = over.pop("w", w)
        gap = over.pop("max_gap", gap)
        m = over.pop("match", m)
        x = over.pop("mismatch", x)
        o1 = over.pop("gap_open1", o1)
        e1 = over.pop("gap_ext1", e1)
        o2 = over.pop("gap_open2", o2)
        e2 = over.pop("gap_ext2", e2)
        cnt = over.pop("min_chain_cnt", cnt)
        chain = over.pop("min_chain_score", chain)
        bw = over.pop("bandwidth", None)
        zd = over.pop("zdrop", None)
        nsec = over.pop("n_secondary", None)
        assert not over, f"unapplied extra-param overrides: {sorted(over)}"
        # long-read / assembly presets tolerate far more diagonal drift
        # (indels accumulate over kb-scale alignments); sr keeps one
        # 128-wide band. Multiples of 128: the bands kernel B4 takes.
        band = 128 if preset == "sr" else 512
        if bw is not None:
            # -r sets both mm2's chaining bandwidth and its alignment band;
            # widen the extension band to cover the requested drift (rounded
            # up to a multiple of 128, capped like long presets)
            band = max(band, min(512, -(-int(bw) // 128) * 128))
        return cls(
            k=k,
            w=w,
            max_gap=gap,
            bandwidth=min(gap, 500) if bw is None else int(bw),
            min_chain_cnt=cnt,
            min_chain_score=chain,
            band=band,
            hpc=(preset == "map-pb"),
            # minimap2 pins mid_occ = 1000 in the sr preset; the others
            # leave it unset and derive it from the index frequency quantile
            mid_occ=1000 if preset == "sr" else 0,
            max_occ=5000 if preset == "sr" else 0,
            is_sr=(preset == "sr"),
            # sr pins zdrop=100/end_bonus=10; long-read presets use mm2's
            # looser 400 (asm 200) and no end bonus
            zdrop=(
                100 if preset == "sr" else (
                    200 if preset.startswith("asm") else 400
                )
            ) if zd is None else int(zd),
            end_bonus=10 if preset == "sr" else 0,
            n_secondary=5 if nsec is None else int(nsec),
            scoring=ope.SrScoring(
                match=m, mismatch=x,
                gap_open1=o1, gap_ext1=e1, gap_open2=o2, gap_ext2=e2,
            ),
        )

    def check_kernel(self, longest: int) -> None:
        """Raise ValueError when kernel B4's int32 DP cannot hold this
        scoring for a read of ``longest`` bases: ops.extend.kernel_scoring
        at the most rows a launch gives such a read (its length bucket) and
        the band. A CUDA run checks its longest read before matching."""
        ope.kernel_scoring(self.scoring, _query_rows(longest), self.band)


@dataclass
class QuerySketch:
    """Per-query precomputed state, shared across all genomes of all batches."""

    name: str
    seq: str
    codes: np.ndarray
    rc_codes: np.ndarray
    mh: np.ndarray  # minimizer hashes
    mp: np.ndarray  # minimizer positions
    ms: np.ndarray  # minimizer strands
    _rc: str | None = None  # lazily cached reverse-complement sequence text

    @classmethod
    def make(cls, name: str, seq: str, params: AlignParams) -> "QuerySketch":
        codes = encode_seq(seq.encode())
        mh, mp, mstr = opm.minimizers(codes, params.k, params.w, hpc=params.hpc)
        return cls(name, seq, codes, revcomp_codes(codes), mh, mp, mstr)

    @classmethod
    def make_batch(
        cls, items: Sequence[tuple[str, str]], params: AlignParams
    ) -> list["QuerySketch"]:
        """Sketch a whole read set with ONE threaded native minimizer call
        (ops.minimizer.minimizers_batch) — per-read make() costs ~1 ms in
        python/ctypes overhead, first-order at 10k+ filtered queries."""
        codes_list = [encode_seq(seq.encode()) for _, seq in items]
        sketches = opm.minimizers_batch(
            codes_list, params.k, params.w, hpc=params.hpc
        )
        return [
            cls(name, seq, codes, revcomp_codes(codes), mh, mp, mstr)
            for (name, seq), codes, (mh, mp, mstr) in zip(
                items, codes_list, sketches
            )
        ]

    def rc_seq(self) -> str:
        """Reverse-complement SEQ text, decoded once per sketch (a sketch is
        reused across every genome it pairs with)."""
        if self._rc is None:
            self._rc = decode_seq(self.rc_codes).decode()
        return self._rc


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _query_rows(n: int) -> int:
    """The extension rows of a read of n bases: its length bucket (the
    fused flush pads a chunk's reads to a multiple of 32, at most this)."""
    return _round_up(max(32, n), 256)


def _bucket_pairs(n: int, q_mult: int = 1) -> int:
    """Pad pair count to a power of two (few distinct shapes per run) and,
    with a mesh, to a multiple of the query axis so the pairs split evenly."""
    p = max(8, 1 << (n - 1).bit_length())
    return _round_up(p, q_mult)


def _mesh_q(mesh) -> int:
    return 1 if mesh is None else mesh.shape["q"]


def _resolve(mesh, device) -> torch.device:
    """The device of a public entry point: the mesh's home device (where
    results gathered over the mesh land) when a mesh is given."""
    if mesh is not None:
        return mesh.home
    return resolve_device(device)


_NP_TO_TORCH = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
}


def _upload(arrays, device: torch.device) -> list[torch.Tensor]:
    """Host numpy arrays -> device tensors in ONE copy: on CUDA they are
    packed at 16-byte aligned offsets into one pinned buffer, copied
    non-blocking on the current stream and split into typed views (the
    caching host allocator keeps the pinned buffer until the copy is done).
    On the CPU the arrays are wrapped without a copy. uint16 arrays travel
    as int16 (the same bits; ops.chain reads them as uint16)."""
    arrays = [
        np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16 else a)
        for a in arrays
    ]
    if device.type != "cuda":
        return [torch.from_numpy(a) for a in arrays]
    offs, tot = [], 0
    for a in arrays:
        offs.append(tot)
        tot += -(-a.nbytes // 16) * 16
    host = torch.empty(max(tot, 16), dtype=torch.uint8, pin_memory=True)
    hn = host.numpy()
    for a, o in zip(arrays, offs):
        hn[o : o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return [
        dev[o : o + a.nbytes].view(_NP_TO_TORCH[a.dtype]).reshape(a.shape)
        for a, o in zip(arrays, offs)
    ]


class _HostCopy:
    """Device tensors on their way to the host: started at construction
    (one device-side concatenation of their bytes and one non-blocking copy
    into pinned memory, with a recorded event), read with ``get``."""

    def __init__(self, tensors):
        self.meta = [(t.dtype, tuple(t.shape)) for t in tensors]
        flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
        self.sizes = [f.numel() for f in flat]
        buf = torch.cat(flat) if flat else torch.zeros(0, dtype=torch.uint8)
        self.event = None
        if buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(buf.device))
            buf = host
        self.buf = buf

    def get(self) -> list[np.ndarray]:
        """Wait for the copy; the tensors as numpy arrays."""
        if self.event is not None:
            self.event.synchronize()
        raw = self.buf.numpy()
        out, o = [], 0
        for (dtype, shape), n in zip(self.meta, self.sizes):
            npt = torch.empty(0, dtype=dtype).numpy().dtype
            out.append(raw[o : o + n].view(npt).reshape(shape))
            o += n
        return out


# padded-anchor-slot buckets: anchor sets are grouped by size so a pool of
# short-read pairs (<= 64 anchors) never pays long-read padding, while a
# 10 kb map-ont read (~2k minimizer anchors) chains without truncation
ANCHOR_BUCKETS = (32, 64, 256, 1024, opc.MAX_ANCHORS)


@dataclass
class ChainHost:
    """Host-side chain results aligned to the input anchor-set order."""

    score: np.ndarray  # f32 [N]
    count: np.ndarray  # int32 [N]
    qs: np.ndarray
    qe: np.ndarray
    rs: np.ndarray
    re: np.ndarray
    alt: np.ndarray  # f32 [N] best overlapping competitor (s2 source)
    alt_qs: np.ndarray  # int32 [N] competitor coords (MAPQ DP probe target)
    alt_qe: np.ndarray
    alt_rs: np.ndarray
    alt_re: np.ndarray
    sup_score: np.ndarray  # f32 [N, n_sup]
    sup_count: np.ndarray
    sup_qs: np.ndarray
    sup_qe: np.ndarray
    sup_rs: np.ndarray
    sup_re: np.ndarray


def _chain_bucket(
    anchor_sets: list[opm.Anchors],
    idxs: list[int],
    a: int,
    params: AlignParams,
    device: torch.device,
    mesh=None,
) -> opc.ChainResult:
    """One padded device chain call over the given anchor-set indices (data
    parallel over the query axis with a mesh)."""
    p = _bucket_pairs(len(idxs), _mesh_q(mesh))
    rpos = np.full((p, a), opc.PAD_POS, np.int32)
    qpos = np.full((p, a), opc.PAD_POS, np.int32)
    # vectorized padded fill: one concatenate + one 2-D scatter instead of a
    # per-set python assignment loop (tens of thousands of sets per flush)
    m = len(idxs)
    r_parts = [anchor_sets[i].rpos[:a] for i in idxs]
    q_parts = [anchor_sets[i].qpos[:a] for i in idxs]
    lens = np.fromiter(map(len, r_parts), np.int64, count=m)
    tot = int(lens.sum())
    if tot:
        rows = np.repeat(np.arange(m), lens)
        cols = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
        qcat = np.concatenate(q_parts)
        rpos[rows, cols] = np.concatenate(r_parts)
        qpos[rows, cols] = qcat
        qmax = int(qcat.max())
    else:
        qmax = 0
    n_sup = max(0, params.max_segments - 1)
    kw = dict(
        k=params.k, max_gap=params.max_gap, bandwidth=params.bandwidth,
        n_sup=n_sup,
    )
    if qmax < 2**16:
        # uint16 qpos on the wire (slot validity comes from rpos alone)
        q16 = np.zeros((p, a), np.uint16)
        np.copyto(q16, qpos, casting="unsafe", where=qpos < opc.PAD_POS)
        if mesh is not None:
            return dist.dist_chain(mesh, rpos, q16.view(np.int16), **kw)
        rj, qj = _upload((rpos, q16), device)
        return opc.chain_anchors_packed(rj, qj, **kw)
    if mesh is not None:
        return dist.dist_chain(mesh, rpos, qpos, **kw)
    rj, qj = _upload((rpos, qpos), device)
    return opc.chain_anchors(rj, qj, **kw)


log = __import__("logging").getLogger("phylign_tpu_torch.align")


def _pack_chain_result(r: "opc.ChainResult"):
    """Device-side packing of the 17 ChainResult arrays into 3 before the
    copy to the host: int fields stack into one [P, 9(+5*n_sup)] int32,
    float fields into one [P, 2] f32, and sup_score stays [P, n_sup] f32."""
    ints = torch.cat(
        [
            torch.stack(
                [
                    r.count, r.qs, r.qe, r.rs, r.re,
                    r.alt_qs, r.alt_qe, r.alt_rs, r.alt_re,
                ],
                dim=1,
            ),
            torch.cat([r.sup_count, r.sup_qs, r.sup_qe, r.sup_rs, r.sup_re], dim=1),
        ],
        dim=1,
    ).to(torch.int32)
    flts = torch.stack([r.score, r.alt_score], dim=1)
    return ints, flts, r.sup_score


def _pack_score_end(sc_dev, end_dev):
    """(score f32, end_d int32) -> one [P, 2] f32 (end_d < band is exact)."""
    return torch.stack([sc_dev, end_dev.to(torch.float32)], dim=1)


def _unpack_chain_result(ints: np.ndarray, flts: np.ndarray, sup_score: np.ndarray):
    """Host-side inverse of _pack_chain_result -> field dict."""
    n_sup = sup_score.shape[1]
    sup = ints[:, 9:].reshape(ints.shape[0], 5, n_sup)
    return dict(
        score=flts[:, 0],
        alt_score=flts[:, 1],
        count=ints[:, 0],
        qs=ints[:, 1],
        qe=ints[:, 2],
        rs=ints[:, 3],
        re=ints[:, 4],
        alt_qs=ints[:, 5],
        alt_qe=ints[:, 6],
        alt_rs=ints[:, 7],
        alt_re=ints[:, 8],
        sup_score=sup_score,
        sup_count=sup[:, 0],
        sup_qs=sup[:, 1],
        sup_qe=sup[:, 2],
        sup_rs=sup[:, 3],
        sup_re=sup[:, 4],
    )


def _chain_pairs(
    anchor_sets: list[opm.Anchors], params: AlignParams, device: torch.device,
    mesh=None,
) -> ChainHost:
    """Chain all anchor sets, bucketed by anchor count (one padded device
    call per occupied size bucket; sharded over the query axis when a mesh
    is given). Returns host arrays in anchor-set order."""
    n = len(anchor_sets)
    counts = [len(a.rpos) for a in anchor_sets]
    over = [c for c in counts if c > opc.MAX_ANCHORS]
    trace.count("align.chain_truncations", len(over))
    if over:
        # no silent caps: truncation beyond the hard ceiling is loud
        log.warning(
            "%d anchor set(s) exceed MAX_ANCHORS=%d (largest %d); "
            "chaining the first %d anchors of each",
            len(over), opc.MAX_ANCHORS, max(over), opc.MAX_ANCHORS,
        )
    by_bucket: dict[int, list[int]] = {}
    for i, c in enumerate(counts):
        a_pad = next(b for b in ANCHOR_BUCKETS if min(c, opc.MAX_ANCHORS) <= b)
        by_bucket.setdefault(a_pad, []).append(i)

    n_sup = max(0, params.max_segments - 1)
    host = ChainHost(
        score=np.full(n, -1.0, np.float32),
        count=np.zeros(n, np.int32),
        qs=np.zeros(n, np.int32),
        qe=np.zeros(n, np.int32),
        rs=np.zeros(n, np.int32),
        re=np.zeros(n, np.int32),
        alt=np.full(n, -1.0, np.float32),
        alt_qs=np.zeros(n, np.int32),
        alt_qe=np.zeros(n, np.int32),
        alt_rs=np.zeros(n, np.int32),
        alt_re=np.zeros(n, np.int32),
        sup_score=np.full((n, n_sup), -1.0, np.float32),
        sup_count=np.zeros((n, n_sup), np.int32),
        sup_qs=np.zeros((n, n_sup), np.int32),
        sup_qe=np.zeros((n, n_sup), np.int32),
        sup_rs=np.zeros((n, n_sup), np.int32),
        sup_re=np.zeros((n, n_sup), np.int32),
    )
    # dispatch every bucket first (async), pack each result to 3 arrays on
    # the device, then fetch ALL buckets in ONE copy
    pending = [
        (
            idxs,
            _pack_chain_result(
                _chain_bucket(anchor_sets, idxs, a_pad, params, device, mesh)
            ),
        )
        for a_pad, idxs in sorted(by_bucket.items())
    ]
    flat = _HostCopy([t for _, res in pending for t in res]).get()
    for j, (idxs, _) in enumerate(pending):
        got = _unpack_chain_result(*flat[3 * j : 3 * j + 3])
        ii = np.asarray(idxs)
        m = len(ii)
        host.score[ii] = got["score"][:m]
        host.count[ii] = got["count"][:m]
        host.qs[ii] = got["qs"][:m]
        host.qe[ii] = got["qe"][:m]
        host.rs[ii] = got["rs"][:m]
        host.re[ii] = got["re"][:m]
        host.alt[ii] = got["alt_score"][:m]
        host.alt_qs[ii] = got["alt_qs"][:m]
        host.alt_qe[ii] = got["alt_qe"][:m]
        host.alt_rs[ii] = got["alt_rs"][:m]
        host.alt_re[ii] = got["alt_re"][:m]
        host.sup_score[ii] = got["sup_score"][:m]
        host.sup_count[ii] = got["sup_count"][:m]
        host.sup_qs[ii] = got["sup_qs"][:m]
        host.sup_qe[ii] = got["sup_qe"][:m]
        host.sup_rs[ii] = got["sup_rs"][:m]
        host.sup_re[ii] = got["sup_re"][:m]
    return host


def _local_trim(
    cig: list[tuple[int, str]], sc: ope.SrScoring
) -> tuple[list[tuple[int, str]], int, float] | None:
    """Trim a glocal alignment path to its max-scoring sub-path (local
    semantics), soft-clipping the trimmed query bases.

    minimap2 extends outward from the chain and stops on z-drop, so garbage
    query ends (adapters, contig overhangs, the other half of a split read)
    are clipped rather than forced into the alignment
    (ref behavior: minimap2 -x sr as invoked at
    scripts/batch_align.py:268-270). The banded DP here
    aligns the full query; taking the best-scoring contiguous sub-path of
    the optimal path reproduces the clipping in the cases that matter (the
    good region's path is shared between both optima).

    Returns (cigar with S ends, ref bases skipped before the alignment,
    local score), or None when no positive-scoring interval exists.
    """
    # Kadane over RUNS: a '=' run scores positive per base and X/I/D runs
    # negative per base, so an optimal interval never starts or ends inside
    # a run — run boundaries suffice, and a cigar has only a handful of runs
    # (a per-base pass costs ~50 us/record; this is ~2 us).
    totals: list[float] = []
    for n, op in cig:
        if op == "=":
            totals.append(float(n * sc.match))
        elif op == "X":
            totals.append(-float(n * sc.mismatch))
        elif op in ("I", "D"):
            totals.append(
                -float(
                    min(
                        sc.gap_open1 + n * sc.gap_ext1,
                        sc.gap_open2 + n * sc.gap_ext2,
                    )
                )
            )
        else:  # pragma: no cover - S never reaches here
            raise ValueError(f"unexpected op {op!r}")
    best = run = 0.0
    best_s = best_e = run_s = 0
    for i, v in enumerate(totals):
        if run <= 0.0:
            run, run_s = v, i
        else:
            run += v
        if run > best:
            best, best_s, best_e = run, run_s, i + 1
    if best_e <= best_s or best <= 0.0:
        return None
    if best_s == 0 and best_e == len(cig):
        return cig, 0, best  # nothing trimmed (the overwhelming sr case)
    lead, mid, tail = cig[:best_s], cig[best_s:best_e], cig[best_e:]
    lead_q = sum(n for n, o in lead if o in "=XI")
    lead_r = sum(n for n, o in lead if o in "=XD")
    tail_q = sum(n for n, o in tail if o in "=XI")
    out: list[tuple[int, str]] = []
    if lead_q:
        out.append((lead_q, "S"))
    out.extend(mid)
    if tail_q:
        out.append((tail_q, "S"))
    return out, lead_r, best


def _cigar_str(cig: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in cig)


# --- mm2 emission trimming: z-drop + end_bonus + region splitting ------------


def _split_runs_at_q(runs, q: int):
    """Split a run list at query offset q -> (left, right); '='/'X'/'I' runs
    may be cut, 'D' runs stay left until q is reached."""
    left: list[tuple[int, str]] = []
    acc = 0
    for idx, (n, op) in enumerate(runs):
        if acc >= q:
            return left, list(runs[idx:])
        qadv = n if op in "=XI" else 0
        if acc + qadv <= q:
            left.append((n, op))
            acc += qadv
        else:
            cut = q - acc
            return left + [(cut, op)], [(n - cut, op)] + list(runs[idx + 1:])
    return left, []


def _run_vals(runs, sc: ope.SrScoring):
    """(score, query-advance, ref-advance) per run."""
    out = []
    for n, op in runs:
        if op == "=":
            out.append((float(n * sc.match), n, n))
        elif op == "X":
            out.append((-float(n * sc.mismatch), n, n))
        else:
            g = -float(
                min(sc.gap_open1 + n * sc.gap_ext1, sc.gap_open2 + n * sc.gap_ext2)
            )
            out.append((g, n, 0) if op == "I" else (g, 0, n))
    return out


def _ext_scan(vals, zdrop: int, end_bonus: int, e: int):
    """One extension zone, scanned outward from the chain (score origin 0).
    Mirrors ksw_extz2: stop when the score falls > zdrop + e*|gap drift|
    below the running max (clip at the max); otherwise keep to the query
    end iff end score + end_bonus > max (mm2's mqe + end_bonus rule).
    Returns (number of runs kept, z_dropped)."""
    r = m = 0.0
    mb = mdq = mdr = dq = dr = 0
    for idx, (v, a, b) in enumerate(vals):
        r += v
        dq += a
        dr += b
        if m - r > zdrop + e * abs((dq - mdq) - (dr - mdr)):
            return mb, True
        if r > m:
            m, mb, mdq, mdr = r, idx + 1, dq, dr
    if r + end_bonus > m:
        return len(vals), False
    return mb, False


def _mid_scan(vals, zdrop: int, e: int):
    """First internal z-drop inside the anchor span -> (peak run index,
    trigger run index), or None. A hit splits the region (mm2 align.c:
    a z-dropped gap fill produces a second region r2)."""
    r = m = 0.0
    mb = mdq = mdr = dq = dr = 0
    for idx, (v, a, b) in enumerate(vals):
        r += v
        dq += a
        dr += b
        if m - r > zdrop + e * abs((dq - mdq) - (dr - mdr)):
            return mb, idx
        if r > m:
            m, mb, mdq, mdr = r, idx + 1, dq, dr
    return None


def _merge_runs(runs):
    out: list[list] = []
    for n, op in runs:
        if n <= 0:
            continue
        if out and out[-1][1] == op:
            out[-1][0] += n
        else:
            out.append([n, op])
    return [(n, op) for n, op in out]


def _zdrop_parts(
    cig: list[tuple[int, str]],
    q_s: int,
    q_e: int,
    params: AlignParams,
) -> list[tuple[list[tuple[int, str]], int, float]]:
    """mm2-style emission trimming of one glocal alignment path.

    Models minimap2's three-part alignment (align.c mm_align1): the chain
    anchor span [q_s, q_e) is aligned globally while the query outside it is
    an extension that (a) stops on z-drop, clipping at the running max, and
    (b) keeps a mildly-negative query end when end score + end_bonus beats
    the max (ksw end_bonus, 10 for sr — a single trailing mismatch stays
    149=1X, not 149=1S). An internal z-drop inside the anchor span SPLITS
    the alignment into two parts, mm2's split-region behavior.

    Returns [(runs incl. soft clips, lead_r, dp_score)] sorted best-first;
    dp_score is mm_update_extra's Kadane-best segment score of the emitted
    part. Parts below min_dp_score are dropped; the list may be empty.
    """
    sc = params.scoring
    e = sc.gap_ext1
    left, rest = _split_runs_at_q(cig, q_s)
    mid, right = _split_runs_at_q(rest, max(0, q_e - q_s))
    rkeep, _ = _ext_scan(_run_vals(right, sc), params.zdrop, params.end_bonus, e)
    right_k = right[:rkeep]
    lvals = _run_vals(left, sc)[::-1]
    lkeep, _ = _ext_scan(lvals, params.zdrop, params.end_bonus, e)
    left_k = left[len(left) - lkeep:]
    drop_l = left[: len(left) - lkeep]
    q_off = sum(n for n, op in drop_l if op in "=XI")
    r_off = sum(n for n, op in drop_l if op in "=XD")

    raw: list[tuple[list, int, int]] = []  # (runs, q_before, r_before)
    cur, cur_q, cur_r = left_k, q_off, r_off
    mid_rem = mid
    while True:
        hit = _mid_scan(_run_vals(mid_rem, sc), params.zdrop, e)
        if hit is None:
            raw.append((cur + mid_rem + right_k, cur_q, cur_r))
            break
        mb, trig = hit
        raw.append((cur + mid_rem[:mb], cur_q, cur_r))
        adv = cur + mid_rem[: trig + 1]
        cur_q += sum(n for n, op in adv if op in "=XI")
        cur_r += sum(n for n, op in adv if op in "=XD")
        cur, mid_rem = [], mid_rem[trig + 1:]

    qlen = sum(n for n, op in cig if op in "=XI")
    out = []
    for runs, pq, pr in raw:
        runs = _merge_runs(runs)
        while runs and runs[0][1] in "ID":  # alignment edges never gap
            n, op = runs.pop(0)
            if op == "I":
                pq += n
            else:
                pr += n
        while runs and runs[-1][1] in "ID":
            runs.pop()
        if not runs:
            continue
        best = _local_trim(runs, sc)  # mm_update_extra Kadane segment score
        if best is None or best[2] < sc.min_dp_score:
            continue
        part_q = sum(n for n, op in runs if op in "=XI")
        tail = qlen - pq - part_q
        full_runs = (
            ([(pq, "S")] if pq else []) + runs + ([(tail, "S")] if tail else [])
        )
        out.append((full_runs, pr, best[2]))
    out.sort(key=lambda t: -t[2])
    return out


@dataclass
class PairTask:
    """One (query, genome) pair awaiting device chaining/extension."""

    sketch: QuerySketch
    ref: opm.RefIndex
    plus: opm.Anchors
    minus: opm.Anchors
    rep_len: int = 0  # query bases under dropped high-occ seeds (rl:i)


def make_pair(ref: opm.RefIndex, sk: QuerySketch, params: AlignParams) -> PairTask:
    plus, minus, rep = opm.collect_anchors(
        ref, sk.mh, sk.mp, sk.ms, len(sk.codes), params.occ_cap(ref)
    )
    return PairTask(sk, ref, plus, minus, rep)


def make_pairs_batch(
    ref: opm.RefIndex, sks: list[QuerySketch], params: AlignParams
) -> list[PairTask]:
    """Vectorized anchor collection for all of one genome's queries."""
    per_q, rep = opm.collect_anchors_batch(
        ref,
        [sk.mh for sk in sks],
        [sk.mp for sk in sks],
        [sk.ms for sk in sks],
        [len(sk.codes) for sk in sks],
        params.occ_cap(ref),
    )
    return [
        PairTask(sk, ref, p, m, int(r))
        for sk, (p, m), r in zip(sks, per_q, rep)
    ]


def make_pairs_multi(
    groups: "list[tuple[opm.RefIndex, list[QuerySketch]]]",
    params: AlignParams,
) -> list[PairTask]:
    """make_pairs_batch over MANY genomes in ONE native anchor-collection
    call (ops.minimizer.collect_anchors_multi): amortizes the per-genome
    call overhead that dominates align seeding when a run touches
    thousands of small candidate genomes."""
    if not groups:
        return []
    native_groups = [
        (
            ref,
            [sk.mh for sk in sks],
            [sk.mp for sk in sks],
            [sk.ms for sk in sks],
            [len(sk.codes) for sk in sks],
            params.occ_cap(ref),
        )
        for ref, sks in groups
    ]
    per_q, rep = opm.collect_anchors_multi(native_groups, params.k)
    tasks: list[PairTask] = []
    i = 0
    for ref, sks in groups:
        for sk in sks:
            p, m = per_q[i]
            tasks.append(PairTask(sk, ref, p, m, int(rep[i])))
            i += 1
    return tasks


MAX_EXT_CELLS = 1 << 20  # bound on P * L at band 128 (plane ~512 MB);
# wider bands shrink the per-call pair count proportionally


def _cigar_from_mismatches(cols: list[int], qlen: int) -> list[tuple[int, str]]:
    """Run-length =/X cigar from sorted mismatch columns — pure-python ints
    over the handful of mismatches, instead of numpy passes over the whole
    row per record (the round-1 per-record hot spot)."""
    runs: list[tuple[int, str]] = []
    prev = 0
    for c in cols:
        if c > prev:
            runs.append((c - prev, "="))
        if runs and runs[-1][1] == "X":
            runs[-1] = (runs[-1][0] + 1, "X")
        else:
            runs.append((1, "X"))
        prev = c + 1
    if qlen > prev:
        runs.append((qlen - prev, "="))
    return runs


@dataclasses.dataclass
class _ExtCtx:
    """In-flight extension chunk: host windows + dispatched device handles.

    Produced by _extend_dispatch, consumed by _extend_finish. Splitting the
    two lets flush_pairs dispatch chunk i+1's device pass before fetching
    chunk i's results, so device compute overlaps the host half (fetch,
    gapless check, the traceback's fetch or walk, record assembly) instead
    of serializing."""

    tasks: list
    items: list
    lmax: int
    params: AlignParams
    device: torch.device
    mesh: object
    n: int
    wlen: int
    q_codes: np.ndarray
    q_len: np.ndarray
    rwin: np.ndarray
    rvalid: np.ndarray
    lo_p: np.ndarray
    hi_p: np.ndarray
    w0_arr: np.ndarray
    c_start_arr: np.ndarray
    contig_ids: np.ndarray
    sc_end: "_HostCopy"  # [P, 2] (score, end_d) on its way to the host


def _extend_dispatch(
    tasks: list[PairTask],
    items: list[tuple[tuple[int, int], tuple]],
    lmax: int,
    params: AlignParams,
    device: torch.device,
    mesh=None,
) -> _ExtCtx:
    """Banded extension for one length-bucketed chunk of chained pairs:
    build the host windows and DISPATCH the score-only device pass (async).
    items: [((task idx, segment idx — 0 primary, >0 supplementary),
    (score, strand, qs, qe, rs, re, s2, cnt))].

    The full chunk runs two device passes: this score-only pass for
    everything, then (in _extend_finish) a traceback-plane pass ONLY for
    pairs whose optimal score cannot be realized gaplessly on the end
    diagonal. Short-read alignments are overwhelmingly gapless, so the
    [P, L, BAND] plane is computed for a small remainder.
    """
    p = _bucket_pairs(len(items), _mesh_q(mesh))
    n = len(items)
    wlen = lmax + params.band
    q_codes = np.zeros((p, lmax), np.uint8)
    q_len = np.zeros(p, np.int32)
    rwin = np.zeros((p, wlen), np.uint8)
    rvalid = np.zeros((p, wlen), bool)
    half = params.band // 2
    # ragged query-code row fills (memcpy each), plus ref grouping; every
    # per-item scalar below is derived in bulk numpy per ref group
    ref_of: list[opm.RefIndex] = []
    rs_arr = np.fromiter(
        (it[1][4] for it in items), np.int64, count=n
    )
    qs_arr = np.fromiter((it[1][2] for it in items), np.int64, count=n)
    by_ref: dict[int, list[int]] = {}
    code_parts: list[np.ndarray] = []
    for i, ((ti, _seg), (sc, strand, qs, qe, rs, re, s2, _cnt)) in enumerate(items):
        t = tasks[ti]
        code_parts.append(t.sketch.rc_codes if strand else t.sketch.codes)
        ref_of.append(t.ref)
        by_ref.setdefault(id(t.ref), []).append(i)
    if n:
        # one concatenate + one 2-D scatter instead of a per-item row memcpy
        lens = np.fromiter(map(len, code_parts), np.int64, count=n)
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(int(lens.sum())) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        q_codes[rows, cols] = np.concatenate(code_parts)
        q_len[:n] = lens
    w0_arr = rs_arr - qs_arr - half
    c_start_arr = np.zeros(n, np.int64)
    c_end_arr = np.zeros(n, np.int64)
    contig_ids = np.zeros(n, np.int64)
    span = np.arange(wlen)
    # per ref group: one searchsorted for contigs + one fancy-indexed window
    # gather ([m, wlen]) instead of per-item python
    for idxs in by_ref.values():
        ii = np.asarray(idxs)
        ref = ref_of[idxs[0]]
        rs_c = np.clip(rs_arr[ii], 0, len(ref.codes) - 1)
        cs = np.searchsorted(ref.contig_starts, rs_c, side="right") - 1
        contig_ids[ii] = cs
        c_start_arr[ii] = ref.contig_starts[cs]
        c_end_arr[ii] = c_start_arr[ii] + ref.contig_lens[cs]
        idx2 = w0_arr[ii, None] + span  # [m, wlen]
        ok = (idx2 >= c_start_arr[ii, None]) & (idx2 < c_end_arr[ii, None])
        vals = ref.codes[np.clip(idx2, 0, len(ref.codes) - 1, out=idx2)]
        vals[~ok] = 0
        rwin[ii] = vals
        rvalid[ii] = ok
    # 2-bit-packed codes + [lo, hi) bounds instead of a bool mask, uploaded
    # in ONE copy
    lo_b = np.clip(c_start_arr - w0_arr, 0, wlen).astype(np.int32)
    hi_b = np.clip(c_end_arr - w0_arr, 0, wlen).astype(np.int32)
    lo_p = np.zeros(p, np.int32)
    hi_p = np.zeros(p, np.int32)
    lo_p[:n], hi_p[:n] = lo_b, hi_b
    host_in = (ope.pack2bit(q_codes), q_len, ope.pack2bit(rwin), lo_p, hi_p)
    if mesh is not None:
        sc_dev, end_dev = dist.dist_extend_scores_packed(
            mesh, *host_in, lmax, wlen, scoring=params.scoring
        )
    else:
        sc_dev, end_dev = ope.extend_banded_scores_packed(
            *_upload(host_in, device), lmax, wlen, scoring=params.scoring
        )
    # (score f32, end_d i32) as ONE [P, 2] f32 array on its way to the host
    sc_end = _HostCopy([_pack_score_end(sc_dev, end_dev)])
    return _ExtCtx(
        tasks=tasks, items=items, lmax=lmax, params=params, device=device,
        mesh=mesh, n=n, wlen=wlen, q_codes=q_codes, q_len=q_len, rwin=rwin,
        rvalid=rvalid, lo_p=lo_p, hi_p=hi_p, w0_arr=w0_arr,
        c_start_arr=c_start_arr, contig_ids=contig_ids,
        sc_end=sc_end,
    )


def _walk_on_device(device: torch.device, mesh) -> bool:
    """Whether the gapped pairs' traceback runs where their plane is: on
    one card (the kernel, ops/extend.traceback_cuda), or, for a plane on
    the CPU or over a mesh's shards, on the host (reconstruct_planes +
    traceback_walk)."""
    return mesh is None and device.type == "cuda"


def _extend_finish(
    ctx: _ExtCtx,
) -> tuple[dict[tuple[int, int], SamRecord], dict[int, int]]:
    """Fetch + post-process a dispatched extension chunk: gapless check,
    traceback-plane pass for the gapped remainder and its walk, SAM record
    assembly. On one card the walk runs on the card over the plane where
    the plane pass left it (ops/extend.traceback_cuda) and only the ops
    come back; a plane on the CPU or over a mesh comes to the host, which
    rebuilds H/I/D (reconstruct_planes) and walks each pair
    (traceback_walk). Both give the same CIGAR and start_d.
    Returns (records, probes): items with seg == PROBE_SEG produce no
    record, only their alignment's Kadane-best DP score (mm2's dp_max2,
    gated at min_dp_score the way mm_filter_regs drops weak regions)."""
    tasks, items, params, device = ctx.tasks, ctx.items, ctx.params, ctx.device
    mesh = ctx.mesh
    lmax, n, wlen = ctx.lmax, ctx.n, ctx.wlen
    q_codes, q_len = ctx.q_codes, ctx.q_len
    rwin, rvalid = ctx.rwin, ctx.rvalid
    lo_p, hi_p = ctx.lo_p, ctx.hi_p
    w0_arr, c_start_arr, contig_ids = ctx.w0_arr, ctx.c_start_arr, ctx.contig_ids
    records: dict[tuple[int, int], SamRecord] = {}
    # one packed [P, 2] array -> one copy (score, end_d)
    (sc_end,) = ctx.sc_end.get()
    scores = sc_end[:, 0]
    end_ds = sc_end[:, 1].astype(np.int32)

    match_s = params.scoring.match
    mis_s = params.scoring.mismatch
    # vectorized gapless check: gather every pair's end-diagonal ref segment
    # in one fancy-indexing call, then compare counts against the DP score
    rows = np.arange(n)[:, None]
    colspan = end_ds[:n, None] + np.arange(lmax)[None, :]
    in_q = np.arange(lmax)[None, :] < q_len[:n, None]
    rseg_all = rwin[rows, colspan]
    vseg_all = rvalid[rows, colspan] | ~in_q
    neq_mask = (q_codes[:n] != rseg_all) & in_q
    neq_all = neq_mask.sum(axis=1)
    diag_ok = vseg_all.all(axis=1) & (
        match_s * (q_len[:n] - neq_all) - mis_s * neq_all == scores[:n].astype(np.int64)
    )
    # dispatch the traceback-plane pass for the gapped remainder FIRST
    # (async), so its device time overlaps all the gapless host work below
    gapped = np.flatnonzero(~diag_ok).tolist()
    ext = None
    on_card = _walk_on_device(device, mesh)
    if gapped:
        gi = np.asarray(gapped)
        gp = _bucket_pairs(len(gapped), _mesh_q(mesh))

        def pad(a):
            out = np.zeros((gp,) + a.shape[1:], a.dtype)
            out[: len(gi)] = a[gi]
            return out

        g_in = (
            ope.pack2bit(pad(q_codes)),
            pad(q_len),
            ope.pack2bit(pad(rwin)),
            pad(lo_p),
            pad(hi_p),
        )
        if mesh is not None:
            g_ext = dist.dist_extend_packed(
                mesh, *g_in, lmax, wlen, scoring=params.scoring
            )
            ext = _HostCopy([g_ext.p_plane])
        else:
            g_dev = _upload(g_in + ((pad(end_ds),) if on_card else ()), device)
            g_ext = ope.extend_banded_packed(
                *g_dev[:5], lmax, wlen, scoring=params.scoring
            )
            if on_card:
                # the walk reads the plane where the plane pass left it,
                # and only the ops come back
                tb = ope.traceback_cuda(
                    g_ext.p_plane, *g_dev, len(gapped), params.scoring
                )
                ext = _HostCopy([tb.meta, tb.ops])
            else:
                ext = _HostCopy([g_ext.p_plane])
    # ALL per-record scalars converted host-side in bulk (a python-int list
    # indexes ~100x faster than per-element numpy scalar conversion)
    q_len_l = q_len[:n].tolist()
    end_l = end_ds[:n].tolist()
    diag_ok_l = diag_ok.tolist()
    # mismatch columns per gapless record, from ONE nonzero pass
    mrow, mcol = np.nonzero(neq_mask & diag_ok[:, None])
    mrow_l, mcol_l = mrow.tolist(), mcol.tolist()
    mis_of: dict[int, list[int]] = {}
    for r_, c_ in zip(mrow_l, mcol_l):
        mis_of.setdefault(r_, []).append(c_)
    cigars: dict[int, tuple[list[tuple[int, str]], int]] = {}
    for i in range(n):
        if diag_ok_l[i]:
            cigars[i] = (
                _cigar_from_mismatches(mis_of.get(i, ()), q_len_l[i]),
                end_l[i],
            )

    w0_l = w0_arr.tolist()
    c_start_l = c_start_arr.tolist()
    # exact full-span check for the gapless records, SPARSE over mismatch
    # columns: the full interval is the unique Kadane optimum iff every
    # proper prefix and every proper suffix has a strictly positive score,
    # and prefix/suffix minima can only occur at a mismatch (score rises
    # between them) — so the check is integer math over the ~1.5
    # mismatches/read instead of [rows, lmax] float prefix-sum passes.
    # Strict (> 0): a zero-sum trimmable end ties the full span, and the
    # dense Kadane picked the FIRST maximal end — i.e. rejected full — so
    # ties still go through the python _local_trim for identical output.
    best = (match_s * (q_len[:n].astype(np.int64) - neq_all) - mis_s * neq_all)
    full = diag_ok & (best >= params.scoring.min_dp_score)
    if len(mrow_l):
        step = match_s + mis_s
        r_start = np.r_[0, np.flatnonzero(np.diff(mrow)) + 1]  # group starts
        g_size = np.diff(np.r_[r_start, len(mrow)])
        rank = np.arange(len(mrow)) - np.repeat(r_start, g_size) + 1
        cnt_of = np.repeat(g_size, g_size)
        qlen_of = q_len[mrow].astype(np.int64)
        prefv = match_s * (mcol + 1) - step * rank  # pref sum after mismatch
        sufv = match_s * (qlen_of - mcol) - step * (cnt_of - rank + 1)
        rows_u = mrow[r_start]
        min_pref = np.minimum.reduceat(prefv, r_start)
        min_suf = np.minimum.reduceat(sufv, r_start)
        bad = ~((min_pref > 0) & (min_suf > 0))
        full[rows_u[bad]] = False
        # internal z-drop: a fall of > zdrop from a running peak sends the
        # row to the trim/split path even when the full span is the Kadane
        # optimum (mm2 would have split the region). Peaks sit just before
        # mismatches, valleys just after; segmented running max via a
        # per-group offset (group spans << offset keeps float64 exact).
        r_before = (match_s * mcol - step * (rank - 1)).astype(np.float64)
        gidx = np.repeat(np.arange(len(r_start)), g_size)
        off = gidx * 1e9
        runpeak = np.maximum.accumulate(r_before + off)
        dropmax = np.maximum.reduceat(runpeak - (prefv + off), r_start)
        full[rows_u[dropmax > params.zdrop]] = False

    if gapped:
        trace.count("align.traceback_pairs", len(gapped))
        with trace.span("align.extend.traceback"):
            if on_card:
                # fetch the walks LAST — every gapless host pass above ran
                # while the device computed them
                meta, ops = ext.get()
                for i, walked in zip(gapped, ope.decode_traceback(ops, meta)):
                    cigars[i] = walked
            else:
                # fetch the plane pass LAST — every gapless host pass above ran
                # while the device computed it
                (p_planes,) = ext.get()
                # batched plane reconstruction (H/D/I for every gapped pair at
                # once), then a cheap scalar walk per pair
                planes_all = ope.reconstruct_planes(
                    p_planes[: len(gapped)], params.scoring
                )
                for gj, i in enumerate(gapped):
                    cig, start_d = ope.traceback_walk(
                        tuple(x[gj] for x in planes_all),
                        p_planes[gj], q_codes[i], q_len_l[i], rwin[i], end_l[i],
                        params.scoring, rvalid=rvalid[i],
                    )
                    cigars[i] = (cig, start_d)
        if on_card:
            trace.count("align.device_traceback_pairs", len(gapped))
    full_l = full.tolist()
    best_l = best.tolist()
    neq_l = neq_all.tolist()
    probes: dict[int, int] = {}
    for i, ((ti, seg), (csc, strand, qs, qe, rs, re, s2, cnt)) in enumerate(items):
        if i not in cigars:
            continue
        if seg == PROBE_SEG:
            # MAPQ DP probe: Kadane-best segment score of the secondary
            # region's alignment, no record emitted
            if full_l[i]:
                dp2 = best_l[i]
            else:
                trimmed = _local_trim(cigars[i][0], params.scoring)
                dp2 = int(trimmed[2]) if trimmed is not None else 0
            # MAX-accumulate: dp_max2 is the max DP score over every
            # probed overlapping secondary region (mm2 hit.c scans all
            # overlapping regions), not the last one extended
            dp2 = dp2 if dp2 >= params.scoring.min_dp_score else 0
            probes[ti] = max(probes.get(ti, 0), dp2)
            continue
        t = tasks[ti]
        sk, ref = t.sketch, t.ref
        cig, start_d = cigars[i]
        if full_l[i]:
            # gapless, untrimmed fast path (the overwhelming sr case): no
            # soft clips, score and op counts come from the mismatch count
            emit = [(cig, 0, best_l[i])]
            fast_counts = (q_len_l[i] - neq_l[i], neq_l[i], 0, 0)
        else:
            # mm2 emission semantics: z-drop clipping in the extension
            # zones, end_bonus retention at the query ends, and region
            # SPLITTING on an internal z-drop (extra parts become
            # flag-2048 records, like mm2's r2 regions)
            emit = _zdrop_parts(cig, qs, qe, params)
            if seg != 0:
                emit = emit[:1]  # supplementary chains keep their best part
            fast_counts = None
        for pk, (pcig, lead_r, dp_score) in enumerate(emit):
            if fast_counts is not None:
                n_eq, n_x, n_i, n_d = fast_counts
                parts = [f"{nn}{op}" for nn, op in pcig]
            else:
                n_eq = n_x = n_i = n_d = 0
                parts = []
                for nn, op in pcig:
                    parts.append(f"{nn}{op}")
                    if op == "=":
                        n_eq += nn
                    elif op == "X":
                        n_x += nn
                    elif op == "I":
                        n_i += nn
                    elif op == "D":
                        n_d += nn
            pos = w0_l[i] + start_d + lead_r - c_start_l[i] + 1
            nm = n_x + n_i + n_d
            n_go = sum(1 for _, op in pcig if op in "ID")
            de = _de_tag(n_eq, n_x, n_go)
            seq = sk.rc_seq() if strand else sk.seq
            key = (ti, seg) if pk == 0 else (ti, SPLIT_SEG0 + pk)
            flag = (16 if strand else 0) | (2048 if key[1] else 0)
            records[key] = SamRecord(
                qname=sk.name,
                flag=flag,
                rname=ref.contig_names[contig_ids[i]],
                pos=pos,
                mapq=0,  # finalized by _group_task_records from mapq_meta
                cigar="".join(parts),
                seq=seq,
                tags=[
                    f"NM:i:{nm}",
                    f"ms:i:{int(dp_score)}",
                    f"AS:i:{int(dp_score)}",
                    "nn:i:0",
                    "tp:A:P",
                    f"cm:i:{int(cnt)}",
                    f"s1:i:{int(csc)}",
                    f"s2:i:{int(s2)}",
                    f"de:f:{de}",
                    f"rl:i:{t.rep_len}",
                ],
                mapq_meta=(float(csc), float(s2), int(cnt), int(dp_score)),
            )
    return records, probes


#: default align flush implementation: the device-resident fused path
#: (align.fused). The host path below remains as the A/B oracle and the
#: fallback (config perf key ``align_fused`` / env PHYLIGN_TPU_ALIGN_FUSED=0).
FUSED_DEFAULT = True


def flush_pairs(
    tasks: list[PairTask],
    params: AlignParams,
    mesh=None,
    fused: bool | None = None,
    device: str | torch.device = "cuda",
) -> list[SamRecord]:
    """Chain + extend a pool of pairs -> one record per pair in pool order.

    Dispatches to the device-resident fused path (chain -> select -> extend
    in one device program, see align.fused) unless disabled; the host
    selection path below produces identical records (tested A/B)."""
    import os

    if fused is None:
        fused = FUSED_DEFAULT and os.environ.get(
            "PHYLIGN_TPU_ALIGN_FUSED", "1"
        ) != "0"
    if fused:
        return flush_pairs_fused(tasks, params, mesh, device=device)
    return flush_pairs_host(tasks, params, mesh, device=device)


def flush_pairs_host(
    tasks: list[PairTask],
    params: AlignParams,
    mesh=None,
    device: str | torch.device = "cuda",
) -> list[SamRecord]:
    """Chain + extend a pool of pairs (possibly spanning many genomes) as
    fixed-shape device batches; emit one record per pair in pool order."""
    return [
        r for g in flush_pairs_host_grouped(tasks, params, mesh, device=device)
        for r in g
    ]


def flush_pairs_host_grouped(
    tasks: list[PairTask],
    params: AlignParams,
    mesh=None,
    device: str | torch.device = "cuda",
) -> list[list[SamRecord]]:
    """flush_pairs_host with one record group per task (pool order)."""
    device = _resolve(mesh, device)
    if not tasks:
        return []
    anchor_sets: list[opm.Anchors] = []
    meta: list[tuple[int, int]] = []  # (pair idx, strand)
    for ti, t in enumerate(tasks):
        for strand, an in ((0, t.plus), (1, t.minus)):
            if len(an.rpos) > 0:
                anchor_sets.append(an)
                meta.append((ti, strand))

    # ti -> [(score, strand, qs, qe, rs, re, count, alt)] candidate chains
    # (device returns primary + up to max_segments-1 mostly-disjoint chains
    # per (pair, strand); alt = best same-strand overlapping competitor)
    cands: dict[int, list[tuple]] = {}
    if anchor_sets:
        ch = _chain_pairs(anchor_sets, params, device, mesh)
        n_sup = ch.sup_score.shape[1]
        min_cnt, min_sc = params.min_chain_cnt, params.min_chain_score
        ti_a = np.fromiter((m[0] for m in meta), np.int64, count=len(meta))
        st_a = np.fromiter((m[1] for m in meta), np.int64, count=len(meta))
        # vectorized threshold filter + C-level tuple building (zip) instead
        # of a python loop over every (set, sup) slot — the loop was a top
        # host cost at full pool size
        keep = np.flatnonzero((ch.count >= min_cnt) & (ch.score >= min_sc))
        rows = zip(
            ti_a[keep].tolist(),
            zip(
                ch.score[keep].tolist(),
                st_a[keep].tolist(),
                ch.qs[keep].tolist(),
                ch.qe[keep].tolist(),
                ch.rs[keep].tolist(),
                ch.re[keep].tolist(),
                ch.count[keep].tolist(),
                np.maximum(ch.alt[keep], 0.0).tolist(),
                ch.alt_qs[keep].tolist(),
                ch.alt_qe[keep].tolist(),
                ch.alt_rs[keep].tolist(),
                ch.alt_re[keep].tolist(),
            ),
        )
        for ti, row in rows:
            cands.setdefault(ti, []).append(row)
        skeep = (ch.sup_count >= min_cnt) & (ch.sup_score >= min_sc)
        for i, s in zip(*(x.tolist() for x in np.nonzero(skeep))):
            cands.setdefault(int(ti_a[i]), []).append(
                (
                    float(ch.sup_score[i, s]), int(st_a[i]),
                    int(ch.sup_qs[i, s]), int(ch.sup_qe[i, s]),
                    int(ch.sup_rs[i, s]), int(ch.sup_re[i, s]),
                    int(ch.sup_count[i, s]), 0.0, 0, 0, 0, 0,
                )
            )

    def _qov(a, b) -> float:
        """Query-interval overlap as a fraction of the shorter interval."""
        ov = max(0, min(a[3], b[3]) - max(a[2], b[2]))
        span = max(1, min(a[3] - a[2], b[3] - b[2]))
        return ov / span

    # primary selection + split-read supplementaries (minimap2 mask_level
    # 0.5: each lower-scoring chain covering a query interval mostly
    # disjoint from EVERY already-selected segment becomes a flag-2048
    # record rather than being dropped); seg index 0 = primary
    # probe items: whenever a primary has a positive s2 competitor, that
    # competitor region is DP-extended too (seg PROBE_SEG, no record) — mm2
    # extends every retained secondary and MAPQ's sr branch reads its DP
    # score (dp_max2). Probe source: best overlapping candidate, or the
    # chain DP's same-strand alt (whose coordinates the chain kernel now
    # returns), whichever chains higher; candidate wins ties.
    chained: list[tuple[tuple[int, int], tuple]] = []

    def add_probe(ti, s2, strand, pqs, pqe, prs, pre):
        chained.append(
            ((ti, PROBE_SEG), (s2, strand, pqs, pqe, prs, pre, 0.0, 0))
        )

    for ti, cl in sorted(cands.items()):
        if len(cl) == 1:
            # one candidate (the common sr case): it is the primary, its
            # only competitor score is the device's same-strand alt
            prim = cl[0]
            chained.append(((ti, 0), prim[:6] + (prim[7], prim[6])))
            if prim[7] > 0:
                add_probe(ti, prim[7], prim[1], *prim[8:12])
            continue
        cl.sort(key=lambda c: (-c[0], c[1], c[2]))
        prim = cl[0]
        rest = cl[1:]
        # s2 for mapq: best competitor covering the primary's interval —
        # from the host candidate set (cross-strand) or the device's
        # same-strand alt score, whichever is larger
        over = [c for c in rest if _qov(c, prim) >= 0.5]
        best_over = max(over, key=lambda c: c[0], default=None)
        s2 = max(
            best_over[0] if best_over is not None else 0.0, prim[7], 0.0
        )
        chained.append(((ti, 0), prim[:6] + (s2, prim[6])))
        # dp_max2 = max DP score over ALL retained overlapping secondary
        # regions (mm2 extends every secondary kept by -N/best_n and
        # mm_set_mapq reads the parent's subsc DP twin) — probe each of
        # them, not just the single best-chaining competitor; the probes
        # dict max-accumulates in _extend_items
        over.sort(key=lambda c: (-c[0], c[1], c[2]))
        probed = over[: max(1, params.n_secondary)]
        for c in probed:
            add_probe(ti, c[0], c[1], *c[2:6])
        if prim[7] > 0 and not any(
            tuple(c[2:6]) == tuple(prim[8:12]) for c in probed
        ):
            # the chain DP's same-strand alt names a region no host
            # candidate covers: probe it too
            add_probe(ti, prim[7], prim[1], *prim[8:12])
        picked = [prim]
        for c in rest:
            if len(picked) >= params.max_segments:
                break
            if all(_qov(c, p) < 0.5 for p in picked):
                chained.append(((ti, len(picked)), c[:6] + (0.0, c[6])))
                picked.append(c)

    records, probes = _extend_items(tasks, chained, params, device, mesh)
    groups = _group_task_records(tasks, records, params, probes)
    _reseed_retry(tasks, groups, set(cands), params, device, mesh)
    return groups


def _group_task_records(
    tasks: list[PairTask],
    records: dict[tuple[int, int], SamRecord],
    params: AlignParams,
    probes: dict[int, int] | None = None,
) -> list[list[SamRecord]]:
    """Per-task record groups from keyed (ti, seg) records: primary first
    (promoting the best supplementary when the primary chain failed
    extension — minimap2 would have selected it the same way), then
    hard-clipped supplementaries; an unmapped record when nothing survived.
    Records carrying deferred mapq_meta get their final MAPQ here, once the
    group (for sum_sc) and the probe dp_max2 (``probes``: ti -> DP score of
    the best overlapping secondary region) are known."""
    probes = probes or {}
    split_of: dict[int, list[SamRecord]] = {}
    for (kti, kseg) in sorted(k for k in records if k[1] >= SPLIT_SEG0):
        split_of.setdefault(kti, []).append(records[(kti, kseg)])
    out: list[list[SamRecord]] = []
    for ti, t in enumerate(tasks):
        rec_p = records.get((ti, 0))
        sups = [
            records[(ti, s)]
            for s in range(1, params.max_segments)
            if (ti, s) in records
        ] + split_of.get(ti, [])
        sups = sups[: params.max_segments - 1]
        if rec_p is None and sups:
            rec_p = dataclasses.replace(sups[0], flag=sups[0].flag & ~2048)
            sups = sups[1:]
        if rec_p is None:
            out.append([unmapped_record(t.sketch.name, t.sketch.seq)])
            continue
        group = [rec_p] + sups
        if any(r.mapq_meta is not None for r in group):
            _finalize_mapq(group, t, params, probes.get(ti, 0))
        out.append([rec_p] + [_hard_clip(r) for r in sups])
    return out


def _extend_items(
    tasks: list[PairTask],
    chained: list[tuple[tuple[int, int], tuple]],
    params: AlignParams,
    device: torch.device,
    mesh=None,
) -> tuple[dict[tuple[int, int], SamRecord], dict[int, int]]:
    """Extend a list of selected chain segments -> ({(ti, seg): record},
    {ti: probe dp_max2}).

    Groups by query-length bucket and bounds P*L so the extension's traceback
    plane ([P, L, BAND] f32) stays within a fixed memory budget — long gene
    queries (e.g. ARGannot, multi-kb) get smaller P per device call. Runs a
    bounded dispatch-ahead pipeline: chunk i+1's device pass (and its host
    window prep) runs while chunk i's results are fetched + post-processed."""
    records: dict[tuple[int, int], SamRecord] = {}
    probes: dict[int, int] = {}
    by_bucket: dict[int, list] = {}
    for item in chained:
        ti = item[0][0]
        lb = _query_rows(len(tasks[ti].sketch.codes))
        by_bucket.setdefault(lb, []).append(item)
    chunks = []
    for lb, items in sorted(by_bucket.items()):
        max_p = max(8, (MAX_EXT_CELLS * 128) // (lb * params.band))
        for off in range(0, len(items), max_p):
            chunks.append((items[off : off + max_p], lb))
    DEPTH = 2
    inflight: list[_ExtCtx] = []

    def drain(ctx):
        rec, prb = _extend_finish(ctx)
        records.update(rec)
        for pti, v in prb.items():  # dp_max2 = max over ALL probed regions
            probes[pti] = max(probes.get(pti, 0), v)

    for ck, lb in chunks:
        with trace.span("align.extend.dispatch"):
            inflight.append(_extend_dispatch(tasks, ck, lb, params, device, mesh))
        if len(inflight) >= DEPTH:
            drain(inflight.pop(0))
    for ctx in inflight:
        drain(ctx)
    return records, probes


# --- device-resident fused flush (align.fused) -------------------------------

# bound on P * lmax per fused chunk: the score-only pass holds no traceback
# plane, so the window buffers ([P, wlen] u8 + the index gather) are the
# memory cost — far lighter than MAX_EXT_CELLS' plane budget
FUSED_MAX_CELLS = 2 << 20


@dataclasses.dataclass
class _FusedCtx:
    """One dispatched fused chunk: device handles + host metadata."""

    tasks: list  # the GLOBAL task list (items reference global ti)
    tis: list[int]  # global task index per chunk pair row
    lmax: int
    params: AlignParams
    device: torch.device
    contig_names: list[str]  # global contig id -> rname
    # the packed u8 buffer on its way to the host; with a mesh, (hot, flts,
    # neq_pack) unpacked (the cold rows are not compacted on a mesh)
    packed: "_HostCopy"
    cold: tuple  # (cold_i, cold_f) full device tensors (compaction overflow)
    p_pad: int = 0  # padded pair rows (packed fetch unpack)
    mesh: object = None


def _fused_dispatch(
    tasks: list[PairTask], tis: list[int], params: AlignParams,
    device: torch.device, mesh=None,
) -> _FusedCtx:
    """Build + upload one fused chunk's inputs and dispatch the whole
    chain -> select -> extend program (async; its result's copy to the host
    starts here and is waited for in _fused_finish). With a mesh every
    stage runs data-parallel over the query axis (fused.dist_select_extend)."""
    from phylign_tpu_torch.align import fused as fz

    n = len(tis)
    qmul = _mesh_q(mesh)
    p = _bucket_pairs(n, qmul)

    # --- anchor sets -> size buckets -> per-bucket chain dispatch -----------
    anchor_sets: list[opm.Anchors] = []
    set_meta: list[tuple[int, int]] = []  # (local pair row, strand)
    for row, ti in enumerate(tis):
        t = tasks[ti]
        for strand, an in ((0, t.plus), (1, t.minus)):
            if len(an.rpos) > 0:
                anchor_sets.append(an)
                set_meta.append((row, strand))
    by_bucket: dict[int, list[int]] = {}
    for i, a in enumerate(anchor_sets):
        c = min(len(a.rpos), opc.MAX_ANCHORS)
        a_pad = next(b for b in ANCHOR_BUCKETS if c <= b)
        by_bucket.setdefault(a_pad, []).append(i)
    over = [len(a.rpos) for a in anchor_sets if len(a.rpos) > opc.MAX_ANCHORS]
    trace.count("align.chain_truncations", len(over))
    if over:
        log.warning(
            "%d anchor set(s) exceed MAX_ANCHORS=%d (largest %d); "
            "chaining the first %d anchors of each",
            len(over), opc.MAX_ANCHORS, max(over), opc.MAX_ANCHORS,
        )
    chains = []
    flat_of = np.full(len(anchor_sets), -1, np.int64)
    offset = 0
    for a_pad, idxs in sorted(by_bucket.items()):
        chains.append(_chain_bucket(anchor_sets, idxs, a_pad, params, device, mesh))
        pb = _bucket_pairs(len(idxs), qmul)
        flat_of[np.asarray(idxs)] = offset + np.arange(len(idxs))
        offset += pb
    s_tot = offset  # dummy slot index (scores -inf)
    if not chains:  # no anchors anywhere: one empty bucket keeps shapes legal
        chains.append(
            _chain_bucket([], [], ANCHOR_BUCKETS[0], params, device, mesh)
        )
        s_tot = _bucket_pairs(0, qmul)

    cand_map = np.full((p, 2), s_tot, np.int32)
    if set_meta:
        sm = np.asarray(set_meta, np.int64)  # [S, 2] (row, strand)
        cand_map[sm[:, 0], sm[:, 1]] = flat_of

    # --- genome pool (2-bit packed, 4-aligned bases) + global contig table --
    pair_base = np.zeros(p, np.int32)
    pair_reflen = np.ones(p, np.int32)
    # unique refs via id() once; per-pair base/reflen filled by inverse index
    ref_ids = np.fromiter((id(tasks[ti].ref) for ti in tis), np.int64, count=n)
    uniq_ids, inv = np.unique(ref_ids, return_inverse=True)
    refs_u = [None] * len(uniq_ids)
    for row, ti in enumerate(tis):
        refs_u[inv[row]] = tasks[ti].ref
    pool_parts: list[np.ndarray] = []
    cst_l: list[int] = []
    clen_l: list[int] = []
    contig_names: list[str] = []
    bases = np.zeros(len(refs_u), np.int64)
    reflens = np.zeros(len(refs_u), np.int64)
    cur = 0
    for u, ref in enumerate(refs_u):
        bases[u] = cur
        reflens[u] = len(ref.codes)
        pk = ref.packed4()
        pool_parts.append(pk)
        cst_l.extend((cur + ref.contig_starts).tolist())
        clen_l.extend(ref.contig_lens.tolist())
        contig_names.extend(ref.contig_names)
        cur += len(pk) * 4
    pair_base[:n] = bases[inv]
    pair_reflen[:n] = reflens[inv]
    assert cur < 2**31, "fused pool exceeds int32 coordinate space"
    pool_pack = (
        np.concatenate(pool_parts) if pool_parts else np.zeros(4, np.uint8)
    )
    # pad pool / contig table to power-of-two buckets: shapes are static
    # few distinct shapes, though every flush has another genome pool size
    plen = max(1 << 14, 1 << int(np.ceil(np.log2(len(pool_pack)))))
    pool_pack = np.pad(pool_pack, (0, plen - len(pool_pack)))
    nc = max(8, 1 << int(np.ceil(np.log2(max(1, len(cst_l))))))
    cst = np.full(nc, np.iinfo(np.int32).max, np.int32)
    cst[: len(cst_l)] = cst_l
    clen = np.zeros(nc, np.int32)
    clen[: len(clen_l)] = clen_l

    # --- queries: FORWARD strand 2-bit packed, one scatter fill (the
    # reverse complement is recomputed on device — half the H2D bytes) ----
    lmax = _round_up(
        max(32, max((len(tasks[ti].sketch.codes) for ti in tis), default=32)),
        32,
    )
    q_len = np.zeros(p, np.int32)
    qc = np.zeros((p, lmax), np.uint8)
    parts = [tasks[ti].sketch.codes for ti in tis]
    q_len[:n] = [len(c) for c in parts]
    if parts:
        flat = np.concatenate(parts)
        if np.all(q_len[:n] == q_len[0]):
            # uniform read length (the sr norm): plain reshape, no scatter
            qc[:n, : int(q_len[0])] = flat.reshape(n, int(q_len[0]))
        else:
            lens = q_len[:n]
            rows2 = np.repeat(np.arange(n), lens)
            cols2 = np.arange(int(lens.sum())) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            qc[rows2, cols2] = flat
    q_pack = ope.pack2bit(qc)

    wlen = lmax + params.band
    kw = dict(
        lmax=lmax, wlen=wlen, half=params.band // 2, scoring=params.scoring,
        min_cnt=params.min_chain_cnt, min_score=params.min_chain_score,
        max_segments=params.max_segments, zdrop=params.zdrop,
    )
    host_in = (cand_map, pair_base, pair_reflen, q_pack, q_len,
               pool_pack, cst, clen)
    if mesh is not None:
        hot, flts, neq_pack, cold = fz.dist_select_extend(mesh, tuple(chains), *host_in, **kw)
        packed = [hot, flts, neq_pack]
    else:
        dev_in = _upload(host_in, device)  # one copy
        # pack=True: hot/flts/neq/compact-cold ride ONE u8 buffer, whose
        # copy to pinned memory starts now (it follows the compute on the
        # stream): by the time _fused_finish reads it, the bytes are
        # host-side
        packed, cold = fz.select_extend(tuple(chains), *dev_in, pack=True, **kw)
        packed = [packed]
    return _FusedCtx(
        tasks=tasks, tis=tis, lmax=lmax, params=params, device=device,
        contig_names=contig_names, packed=_HostCopy(packed), cold=cold,
        p_pad=p, mesh=mesh,
    )


#: de:f tag strings by ratio value — tiny cardinality (nm/qlen pairs),
#: shared across flushes so the native path never re-does float repr work
_DE_STR_CACHE: dict[float, str] = {}


def _de_fmt(ratio: float) -> str:
    """minimap2's de:f rendering (format.c): '0' when exactly zero, else
    the float32-stored divergence with %.4f — the golden file carries both
    forms ('de:f:0', 'de:f:0.0067' for 1 mismatch / 150 bp)."""
    if ratio == 0.0:
        return "0"
    s = _DE_STR_CACHE.get(ratio)
    if s is None:
        s = _DE_STR_CACHE.setdefault(ratio, f"{np.float32(ratio):.4f}")
    return s


def _de_tag(n_eq: int, n_x: int, n_gapo: int) -> str:
    """Gap-compressed per-base divergence, mm2's mm_event_identity: each
    I/D RUN counts as ONE event (the previous approximation charged every
    gap BASE): de = (X + gap_runs) / (= + X + gap_runs)."""
    den = n_eq + n_x + n_gapo
    if den <= 0:
        return "0"
    return _de_fmt((n_x + n_gapo) / den)


def _assemble_fast_native(
    tasks, tis, nat, contig_names, strand_a, ci_a, pos_v, mapq_v, dp_v,
    cm_v, s1_v, s2i_v, de_v, neq_mask, q_len, rep_a,
):
    """Assemble the given FULL non-deferred rows' final SAM lines natively
    (hostio.cpp assemble_sam_lines): CIGAR from mismatch columns, SEQ
    (incl. reverse complement) from the 2-bit codes, full tag block —
    replacing the per-record python f-string loop, the align stage's
    measured host hot spot. Returns {(ti, 0): RawSamRecord} or None when
    the native library is unavailable / names are non-ascii (caller runs
    the python loop instead, which stays as the byte-parity oracle)."""
    from phylign_tpu_torch.native import native_assemble_sam_lines

    nat_l = nat.tolist()
    sks = [tasks[tis[i]].sketch for i in nat_l]
    name_list = [sk.name for sk in sks]
    qjoin = "".join(name_list)
    qname_buf = qjoin.encode()
    rjoin = "".join(contig_names)
    rname_buf = rjoin.encode()
    if len(qname_buf) != len(qjoin) or len(rname_buf) != len(rjoin):
        return None  # non-ascii names: byte offsets would diverge
    qname_off = np.zeros(len(nat_l) + 1, np.int64)
    np.cumsum([len(s) for s in name_list], out=qname_off[1:])
    rname_off = np.zeros(len(contig_names) + 1, np.int64)
    np.cumsum([len(s) for s in contig_names], out=rname_off[1:])
    seq_codes = (
        np.concatenate([sk.codes for sk in sks])
        if sks
        else np.zeros(0, np.uint8)
    )
    seq_off = np.zeros(len(nat_l) + 1, np.int64)
    np.cumsum(q_len[nat], out=seq_off[1:])
    r2, c2 = np.nonzero(neq_mask[nat])
    mis_off = np.zeros(len(nat_l) + 1, np.int64)
    np.cumsum(np.bincount(r2, minlength=len(nat_l)), out=mis_off[1:])
    de_parts = [_de_fmt(v) for v in de_v[nat].tolist()]
    de_buf = "".join(de_parts).encode()
    de_off = np.zeros(len(nat_l) + 1, np.int64)
    np.cumsum([len(s) for s in de_parts], out=de_off[1:])
    flags_nat = (strand_a[nat] * 16).astype(np.int32)
    out = native_assemble_sam_lines(
        qname_buf, qname_off, flags_nat, rname_buf, rname_off, ci_a[nat],
        pos_v[nat], mapq_v[nat], c2, mis_off, q_len[nat], seq_codes,
        seq_off, dp_v[nat], cm_v[nat], s1_v[nat], s2i_v[nat],
        np.asarray(rep_a, np.int64)[nat], de_buf, de_off,
    )
    if out is None:
        return None
    blob, line_off = out
    text = blob.decode("ascii")
    offs = line_off.tolist()
    fl = flags_nat.tolist()
    return {
        (tis[i], 0): RawSamRecord(
            text, offs[j], offs[j + 1], name_list[j], fl[j]
        )
        for j, i in enumerate(nat_l)
    }


def _fused_finish(
    ctx: _FusedCtx,
) -> tuple[dict[tuple[int, int], SamRecord], list, list[int]]:
    """Fetch one fused chunk and assemble its fast-path records.

    Returns (records keyed (global ti, seg), delegated items, tis that had
    any threshold-passing chain) — delegated items (gapped primaries,
    supplementary segments, MAPQ probes) run through the host traceback
    extension path for byte-identical records; the had-chain set feeds the
    re-seed retry condition (mm2 rechains only when NO chain was found)."""
    from phylign_tpu_torch.align import fused as fz

    params, tis, lmax = ctx.params, ctx.tis, ctx.lmax
    tasks = ctx.tasks
    n = len(tis)
    n_sup = max(0, params.max_segments - 1)
    compacted = ctx.mesh is None
    if compacted:
        # ONE packed u8 fetch, unpacked by fixed offsets
        (packed,) = ctx.packed.get()
        hot, flts, neqp, cc_i, cc_f = (
            t.numpy()
            for t in fz._packed_views(torch.from_numpy(packed), ctx.p_pad, lmax, n_sup)
        )
    else:
        hot, flts, neqp = ctx.packed.get()

    meta = hot[:n, 2]
    flags = meta & 0xFF
    end_d = meta >> 8
    has = (flags & fz.F_HAS) != 0
    diag = (flags & fz.F_DIAG) != 0
    full = (flags & fz.F_FULL) != 0
    strand_a = ((flags & fz.F_STRAND) != 0).astype(np.int64)
    rel0 = hot[:n, 0]
    ci_a = hot[:n, 1]
    prim_cnt = hot[:n, 3]
    prim_score = flts[:n, 0]
    s2_a = flts[:n, 1]
    rep_a = [tasks[ti].rep_len for ti in tis]
    q_len = np.fromiter(
        (len(tasks[ti].sketch.codes) for ti in tis), np.int64, count=n
    )
    neq_mask = np.unpackbits(neqp[:n], axis=1)[:, : lmax].astype(bool)

    records: dict[tuple[int, int], SamRecord] = {}
    delegated: list[tuple[tuple[int, int], tuple]] = []

    # delegated work: gapped primaries + supplementary segments. Their
    # coordinates ride in the compacted cold slots of the main fetch
    # (single device), or a full cold fetch (mesh / compaction overflow):
    # the common all-gapless flush pays no extra bytes or copies.
    sup_mask = np.int32(0)
    for s in range(n_sup):
        sup_mask |= np.int32(fz.F_SUP0 << s)
    probe_rows = np.flatnonzero((flags & fz.F_PROBE) != 0)
    # non-FULL primaries split two ways: truly GAPPED rows (no diagonal
    # optimum) need a device traceback and delegate to the host extension
    # path; gapless-but-trimmable rows (F_DIAG set, F_FULL clear) only need
    # the z-drop/end_bonus emission pass (_zdrop_parts) on the mismatch
    # bitmask already fetched here — they are finished INLINE below, no
    # second device round trip. Both read the chain span from the cold
    # payload, so ``need`` covers both.
    need = (has & ~full) | ((flags & (sup_mask | fz.F_PROBE)) != 0)
    need_rows = np.flatnonzero(need)
    gap_rows = np.flatnonzero(has & ~full & ~diag).tolist()
    trim_rows = np.flatnonzero(has & ~full & diag).tolist()
    cold_i = None
    if len(need_rows):
        if compacted and len(need_rows) <= fz.COLD_CAP:
            # compact slot j holds cold data of the j-th needed row
            cold_i = np.zeros((n, cc_i.shape[1]), np.int32)
            cold_f = np.zeros((n, cc_f.shape[1]), np.float32)
            cold_i[need_rows] = cc_i[: len(need_rows)]
            cold_f[need_rows] = cc_f[: len(need_rows)]
        else:
            trace.count("align.cold_full_fetches")
            cold_i, cold_f = _HostCopy(list(ctx.cold)).get()
        for i in gap_rows:
            delegated.append(
                (
                    (tis[i], 0),
                    (
                        float(prim_score[i]), int(strand_a[i]),
                        int(cold_i[i, 0]), int(cold_i[i, 1]),
                        int(cold_i[i, 2]), int(cold_i[i, 3]),
                        float(s2_a[i]), int(prim_cnt[i]),
                    ),
                )
            )
        for s in range(n_sup):
            found = (flags & (fz.F_SUP0 << s)) != 0
            base_c = 4 + 6 * s
            for i in np.flatnonzero(found).tolist():
                delegated.append(
                    (
                        (tis[i], s + 1),
                        (
                            float(cold_f[i, s]), int(cold_i[i, base_c]),
                            int(cold_i[i, base_c + 1]),
                            int(cold_i[i, base_c + 2]),
                            int(cold_i[i, base_c + 3]),
                            int(cold_i[i, base_c + 4]),
                            0.0, int(cold_i[i, base_c + 5]),
                        ),
                    ),
                )
        # MAPQ dp_max2 probes: the s2 competitor's coordinates (cold tail
        # columns) run through the host extension path as no-record items
        pb = 4 + 6 * n_sup
        for i in probe_rows.tolist():
            delegated.append(
                (
                    (tis[i], PROBE_SEG),
                    (
                        float(s2_a[i]), int(cold_i[i, pb]),
                        int(cold_i[i, pb + 1]), int(cold_i[i, pb + 2]),
                        int(cold_i[i, pb + 3]), int(cold_i[i, pb + 4]),
                        0.0, 0,
                    ),
                ),
            )

    # fast path: FULL rows (gapless, untrimmable, no z-drop) — CIGAR
    # straight from the mismatch bitmask. Every per-record scalar that does
    # not depend on the cigar is computed in bulk numpy; the python loop
    # only assembles strings (~8k records per flush makes per-record python
    # a first-order cost). Non-full rows were delegated above.
    fast = np.flatnonzero(has & full)
    m_s, x_s = params.scoring.match, params.scoring.mismatch
    inline_rows = np.flatnonzero(has & (full | diag))
    mrow, mcol = np.nonzero(neq_mask[inline_rows])
    mis_of: dict[int, list[int]] = {}
    inline_l = inline_rows.tolist()
    for r_, c_ in zip(mrow.tolist(), mcol.tolist()):
        mis_of.setdefault(inline_l[r_], []).append(c_)
    fast_l = fast.tolist()
    neq_cnt = neq_mask.sum(axis=1, dtype=np.int64)
    # vectorized twins of the per-record scalars (valid for FULL rows; the
    # trim path recomputes from its trimmed cigar)
    dp_v = m_s * (q_len - neq_cnt) - x_s * neq_cnt
    # gapless rows: gap-compressed divergence == X/(=+X) == neq/qlen;
    # rendering (mm2's '0'-or-%.4f) happens in _de_fmt at string build
    de_v = neq_cnt / np.maximum(1, q_len)
    # float64 throughout so boundary truncations match the python-scalar
    # path bit-for-bit (f32 rounds differently); scores are clipped
    # before int casts — inactive rows carry the -1e30 sentinel
    cm_v = prim_cnt.astype(np.int64)
    rep_v = np.asarray(rep_a, np.float64)
    s1_f64 = np.clip(prim_score.astype(np.float64), -(2.0**62), 2.0**62)
    # vectorized mm_set_mapq chain-score branch (mm2_mapq's else arm) —
    # valid exactly for the rows finalized inline below: s2 == 0 (no
    # secondary DP probe pending, so dp_max2 == 0 and subsc clamps to
    # min_chain_score) and no split segments (sum_sc == s1). Rows with a
    # probe or sups defer to _finalize_mapq via mapq_meta; operation order
    # mirrors mm2_mapq so inline and deferred paths agree bit-for-bit.
    with np.errstate(divide="ignore", invalid="ignore"):
        uniq = s1_f64 / (s1_f64 + rep_v)
        pen = np.minimum(
            np.where(s1_f64 > 100.0, 1.0, 0.01 * s1_f64) * uniq,
            np.where(cm_v > 10, 1.0, 0.1 * cm_v),
        )
        subsc = float(params.min_chain_score)
        mapq_f = (
            pen * MAPQ_Q_COEF * (1.0 - subsc / s1_f64) * np.log(s1_f64)
            + 0.499
        )
        mapq_f = np.where(np.isfinite(mapq_f), mapq_f, 0.0)
    mapq_v = np.clip(mapq_f.astype(np.int64), 0, 60)
    mapq_v[prim_score <= 0] = 0
    # rows whose MAPQ cannot be finalized inline (probe pending / split
    # segments change sum_sc): stash meta, patched by _group_task_records
    defer_v = (s2_a[:n] > 0) | ((flags & (sup_mask | fz.F_PROBE)) != 0)
    s1_v = s1_f64.astype(np.int64)
    s2i_v = s2_a.astype(np.int64)
    pos_v = rel0 + end_d + 1  # full rows: lead_r == 0

    full_l = full.tolist()
    defer_l = defer_v.tolist()
    qlen_l = q_len.tolist()
    end_l = end_d.tolist()
    rel0_l = rel0.tolist()
    ci_l = ci_a.tolist()
    strand_l = strand_a.tolist()
    sc_l = prim_score.tolist()
    s2_l = s2_a.tolist()
    nm_l = neq_cnt.tolist()
    dp_l = dp_v.tolist()
    de_l = de_v.tolist()
    mapq_l = mapq_v.tolist()
    cm_l = cm_v.tolist()
    s1_l = s1_v.tolist()
    s2i_l = s2i_v.tolist()
    pos_l = pos_v.tolist()
    names = ctx.contig_names
    # native line assembly for the non-deferred FULL rows (the overwhelming
    # sr case): MAPQ is final, the group is a single primary, so the whole
    # line can be built now in C++ and never touched again
    if len(fast) and os.environ.get("PHYLIGN_TPU_NATIVE_SAM", "1") != "0":
        nat_mask = np.zeros(n, bool)
        nat_mask[fast] = True
        nat_mask &= ~defer_v
        nat = np.flatnonzero(nat_mask)
        if len(nat):
            nat_recs = _assemble_fast_native(
                tasks, tis, nat, names, strand_a, ci_a, pos_v, mapq_v,
                dp_v, cm_v, s1_v, s2i_v, de_v, neq_mask, q_len, rep_a,
            )
            if nat_recs is not None:
                records.update(nat_recs)
                fast_l = fast[~nat_mask[fast]].tolist()
    perfect_cig: dict[int, str] = {}  # qlen -> "L=" (zero-mismatch cigar)
    for i in fast_l:
        nm = nm_l[i]
        if nm:
            cig = _cigar_from_mismatches(mis_of[i], qlen_l[i])
            cigar = "".join(f"{nn}{op}" for nn, op in cig)
        else:
            cigar = perfect_cig.get(qlen_l[i])
            if cigar is None:
                cigar = perfect_cig.setdefault(
                    qlen_l[i], f"{qlen_l[i]}="
                )
        pos, dp_score, de, mapq = pos_l[i], dp_l[i], _de_fmt(de_l[i]), mapq_l[i]
        cm, s1i, s2i = cm_l[i], s1_l[i], s2i_l[i]
        ti = tis[i]
        sk = tasks[ti].sketch
        strand = strand_l[i]
        if defer_l[i]:
            mapq = 0
            meta = (float(sc_l[i]), float(s2_l[i]), cm_l[i], int(dp_score))
        else:
            meta = None
        records[(ti, 0)] = SamRecord(
            qname=sk.name,
            flag=16 if strand else 0,
            rname=names[ci_l[i]],
            pos=pos,
            mapq=mapq,
            cigar=cigar,
            seq=sk.rc_seq() if strand else sk.seq,
            tags=[
                f"NM:i:{nm}",
                f"ms:i:{dp_score}",
                f"AS:i:{dp_score}",
                "nn:i:0",
                "tp:A:P",
                f"cm:i:{cm}",
                f"s1:i:{s1i}",
                f"s2:i:{s2i}",
                f"de:f:{de}",
                f"rl:i:{rep_a[i]}",
            ],
            mapq_meta=meta,
        )

    # inline trim path: gapless rows that failed the full-span/z-drop check
    # (mismatch within ~5 bp of an end, or an internal z-drop run). Their
    # CIGAR comes from the same mismatch bitmask as the fast path; only the
    # emission trimming (_zdrop_parts) differs. MAPQ always defers to
    # _group_task_records (trim changes dp_score, and s2/probe state rides
    # along) — byte-identical to the former delegate-to-extension path.
    for i in trim_rows:
        ti = tis[i]
        sk = tasks[ti].sketch
        strand = strand_l[i]
        cig = _cigar_from_mismatches(mis_of.get(i, ()), qlen_l[i])
        emit = _zdrop_parts(
            cig, int(cold_i[i, 0]), int(cold_i[i, 1]), params
        )
        for pk, (pcig, lead_r, dp_score) in enumerate(emit):
            n_eq = n_x = n_i = n_d = 0
            parts = []
            for nn, op in pcig:
                parts.append(f"{nn}{op}")
                if op == "=":
                    n_eq += nn
                elif op == "X":
                    n_x += nn
                elif op == "I":
                    n_i += nn
                elif op == "D":
                    n_d += nn
            nm = n_x + n_i + n_d
            n_go = sum(1 for _, op in pcig if op in "ID")
            de = _de_tag(n_eq, n_x, n_go)
            key = (ti, 0) if pk == 0 else (ti, SPLIT_SEG0 + pk)
            records[key] = SamRecord(
                qname=sk.name,
                flag=(16 if strand else 0) | (2048 if key[1] else 0),
                rname=names[ci_l[i]],
                pos=rel0_l[i] + end_l[i] + lead_r + 1,
                mapq=0,  # finalized by _group_task_records from mapq_meta
                cigar="".join(parts),
                seq=sk.rc_seq() if strand else sk.seq,
                tags=[
                    f"NM:i:{nm}",
                    f"ms:i:{int(dp_score)}",
                    f"AS:i:{int(dp_score)}",
                    "nn:i:0",
                    "tp:A:P",
                    f"cm:i:{cm_l[i]}",
                    f"s1:i:{s1_l[i]}",
                    f"s2:i:{s2i_l[i]}",
                    f"de:f:{de}",
                    f"rl:i:{rep_a[i]}",
                ],
                mapq_meta=(
                    float(sc_l[i]), float(s2_l[i]), cm_l[i], int(dp_score)
                ),
            )
    return records, delegated, [tis[i] for i in np.flatnonzero(has).tolist()]


@dataclasses.dataclass
class FusedFlush:
    """An in-flight fused flush: dispatched device chunks + queued chunk
    specs. flush_pairs_begin returns one; flush_pairs_end drains it. The
    split lets callers overlap the device time of flush i with the HOST
    prep (tar streaming, sketching, anchor collection) of flush i+1 in a
    single thread — no GIL contention, records still in pool order."""

    tasks: list
    params: AlignParams
    device: torch.device
    mesh: object
    inflight: list[_FusedCtx]
    queued: list[list[int]]  # chunk tis not yet dispatched
    # host-path fallback result: one record group per task (pool order)
    host_records: list[list[SamRecord]] | None = None


_FUSED_DEPTH = 2  # dispatched-ahead fused chunks per flush


def flush_pairs_begin(
    tasks: list[PairTask],
    params: AlignParams,
    mesh=None,
    fused: bool | None = None,
    device: str | torch.device = "cuda",
) -> FusedFlush:
    """Dispatch a pool's device work (async). Pair with flush_pairs_end."""
    import os

    device = _resolve(mesh, device)
    trace.count("align.flushes")
    trace.count("align.pairs", len(tasks))
    if fused is None:
        fused = FUSED_DEFAULT and os.environ.get(
            "PHYLIGN_TPU_ALIGN_FUSED", "1"
        ) != "0"
    if params.max_segments > 3:
        # the fused flag byte has room for 2 supplementary bits + the probe
        # bit; larger split-read caps take the host path
        fused = False
    if not fused:
        return FusedFlush(
            tasks=tasks, params=params, device=device, mesh=mesh, inflight=[],
            queued=[],
            host_records=flush_pairs_host_grouped(tasks, params, mesh, device=device),
        )
    by_lb: dict[int, list[int]] = {}
    for ti, t in enumerate(tasks):
        lb = _query_rows(len(t.sketch.codes))
        by_lb.setdefault(lb, []).append(ti)
    chunks: list[list[int]] = []
    for lb, tis in sorted(by_lb.items()):
        max_p = max(8, FUSED_MAX_CELLS // lb)
        for off in range(0, len(tis), max_p):
            chunks.append(tis[off : off + max_p])
    trace.count("align.fused_chunks", len(chunks))
    ff = FusedFlush(
        tasks=tasks, params=params, device=device, mesh=mesh, inflight=[],
        queued=chunks,
    )
    while ff.queued and len(ff.inflight) < _FUSED_DEPTH:
        ff.inflight.append(
            _fused_dispatch(tasks, ff.queued.pop(0), params, device, mesh)
        )
    return ff


def flush_pairs_end(ff: FusedFlush) -> list[SamRecord]:
    """Finish a dispatched flush: fetch chunks (dispatching queued ones as
    slots free), run delegated segments through the host traceback path,
    assemble pool-order records."""
    if ff.host_records is not None:
        return ff.host_records
    return [r for g in flush_pairs_end_grouped(ff) for r in g]


def flush_pairs_end_grouped(ff: FusedFlush) -> list[list[SamRecord]]:
    """flush_pairs_end returning one record group PER TASK (pool order):
    lets callers pooling pairs across batches route each pair's records back
    to its source batch."""
    if ff.host_records is not None:
        return ff.host_records
    tasks, params, device, mesh = ff.tasks, ff.params, ff.device, ff.mesh
    records: dict[tuple[int, int], SamRecord] = {}
    delegated: list = []
    had_chain: set[int] = set()
    while ff.inflight:
        with trace.span("align.fetch"):
            rec, dele, had = _fused_finish(ff.inflight.pop(0))
        records.update(rec)
        delegated.extend(dele)
        had_chain.update(had)
        if ff.queued:
            with trace.span("align.dispatch"):
                ff.inflight.append(
                    _fused_dispatch(tasks, ff.queued.pop(0), params, device, mesh)
                )
    trace.count("align.delegated_items", len(delegated))
    probes: dict[int, int] = {}
    with trace.span("align.extend"):
        if delegated:
            rec2, probes = _extend_items(tasks, delegated, params, device, mesh)
            records.update(rec2)
    groups = _group_task_records(tasks, records, params, probes)
    with trace.span("align.reseed"):
        _reseed_retry(tasks, groups, had_chain, params, device, mesh)
    return groups


def flush_pairs_fused(
    tasks: list[PairTask],
    params: AlignParams,
    mesh=None,
    device: str | torch.device = "cuda",
) -> list[SamRecord]:
    """Device-resident flush: dispatch + drain (see flush_pairs_begin/end).
    Record set and order are identical to flush_pairs_host."""
    device = _resolve(mesh, device)
    if not tasks:
        return []
    return flush_pairs_end(flush_pairs_begin(tasks, params, mesh, fused=True, device=device))


def _hard_clip(rec: SamRecord) -> SamRecord:
    """Soft clips -> hard clips + trimmed SEQ for a supplementary record
    (minimap2's default supplementary output; -Y soft clipping not modeled)."""
    import re as _re

    runs = [(int(n), op) for n, op in _re.findall(r"(\d+)([A-Z=])", rec.cigar)]
    lead = runs[0][0] if runs and runs[0][1] == "S" else 0
    tail = runs[-1][0] if len(runs) > 1 and runs[-1][1] == "S" else 0
    if not lead and not tail:
        return rec
    if lead:
        runs[0] = (lead, "H")
    if tail:
        runs[-1] = (tail, "H")
    return dataclasses.replace(
        rec,
        cigar=_cigar_str(runs),
        seq=rec.seq[lead : len(rec.seq) - tail if tail else len(rec.seq)],
    )


def _count_genomes(n: int, params: AlignParams, device) -> None:
    """Count ``n`` genomes indexed, and those whose table the card builds
    (equal on a card, 0 on the CPU and for an hpc preset)."""
    trace.count("align.genomes", n)
    if opm.index_on_device(device, params.hpc, params.k, params.w):
        trace.count("align.device_ref_genomes", n)


def _ref_index(rname: str, contigs, params: AlignParams, device) -> "opm.RefIndex":
    """One genome's RefIndex, on ``device`` where the kernels take it."""
    _count_genomes(1, params, device)
    return opm.build_ref_index(rname, contigs, params.k, params.w, hpc=params.hpc, device=device)


def align_genome(
    rname: str,
    contigs: list[tuple[str, np.ndarray]],
    sketches: Sequence[QuerySketch],
    params: AlignParams,
    mesh=None,
    device: str | torch.device = "cuda",
) -> list[SamRecord]:
    """Align the given queries to one genome; one record per query
    (mapped primary or unmapped), in query order."""
    device = _resolve(mesh, device)
    if not sketches:
        return []
    ref = _ref_index(rname, contigs, params, device)
    return flush_pairs(make_pairs_batch(ref, list(sketches), params), params, mesh, device=device)


MAPQ_Q_COEF = 40.0  # mm2 hit.c q_coef
MAPQ_SR_COEF = 6.02  # BWA-heritage per-score-unit scale of the sr DP branch


def mm2_mapq(
    s1: float,
    s2_chain: float,
    cnt: int,
    dp_max: int,
    dp_max2: int,
    rep_len: int,
    sum_sc: float,
    params: AlignParams,
) -> int:
    """minimap2 2.24 ``mm_set_mapq`` (hit.c) reconstruction.

    Inputs mirror the mm_reg1_t fields: s1 = chain score (r->score),
    s2_chain = best overlapping competitor chain score (r->subsc), cnt =
    chain anchor count (r->cnt), dp_max / dp_max2 = best-segment DP scores
    of the primary / best overlapping secondary alignment (mm_update_extra's
    Kadane maximum; mm_set_parent propagates the secondary's), rep_len =
    repeat length from seeding, sum_sc = sum of parent-region chain scores
    (primary + split segments).

    Branch structure: penalty = min(chain-score penalty x repeat-uniqueness
    ratio sum_sc/(sum_sc+rep_len), chain-count penalty); with a positive
    secondary DP score the sr preset uses the BWA-style score-difference
    form 6.02*(dp_max-dp_max2)/match, otherwise the chain-score log form
    q_coef*(1-subsc/s1)*ln(s1). Verified against the golden file's real
    mm2 col-5 output (tests/test_golden_minimap2_parity.py): the golden
    set exercises the tie (MAPQ 0), near-tie DP (MAPQ 48) and saturated
    (MAPQ 60) regions. The exact rounding (+.499) and the penalty
    composition in the sr DP branch are reconstruction choices the golden
    set cannot distinguish (all its records have pen == 1); documented in
    docs/sam_tags.md.
    """
    import math

    if s1 <= 0:
        return 0
    uniq = float(sum_sc) / (float(sum_sc) + float(rep_len))
    pen_s1 = (1.0 if s1 > 100 else 0.01 * s1) * uniq
    pen_cm = 1.0 if cnt > 10 else 0.1 * cnt
    pen = min(pen_s1, pen_cm)
    if dp_max > 0 and dp_max2 > 0:
        if params.is_sr:
            mapq = int(
                pen * MAPQ_SR_COEF * (dp_max - dp_max2)
                / params.scoring.match + 0.499
            )
        else:
            mapq = int(
                pen * MAPQ_Q_COEF * (1.0 - dp_max2 / dp_max)
                * math.log(s1) + 0.499
            )
    else:
        subsc = max(float(s2_chain), float(params.min_chain_score))
        mapq = int(
            pen * MAPQ_Q_COEF * (1.0 - subsc / s1) * math.log(s1) + 0.499
        )
    return max(0, min(60, mapq))


#: sentinel segment index for MAPQ DP-probe items: the best overlapping
#: secondary region is extended like a real segment but produces no record —
#: only its Kadane-best DP score (mm2's dp_max2)
PROBE_SEG = -1

#: record keys >= this mark extra parts from an internal z-drop split
#: (mm2's r2 regions); _group_task_records appends them as supplementaries
SPLIT_SEG0 = 1000


def _reseed_retry(
    tasks: list[PairTask],
    groups: list[list[SamRecord]],
    had_chain: set[int],
    params: AlignParams,
    device: torch.device,
    mesh=None,
) -> None:
    """minimap2's second-chance re-seed (map.c mm_map_frag rechain branch):
    a read whose mid_occ seeding dropped repeat seeds (rep_len > 0) AND
    found no chain at all retries once with the looser opt->max_occ cap
    (5000 for sr; 0 = disabled for other presets). Reads whose chains
    merely failed extension are NOT retried — mm2 rechains only on
    n_regs0 == 0. Mutates ``groups`` in place with the retry's records
    (rl:i then reflects the second pass's rep_len, as mm2's does)."""
    if params.max_occ <= 0:
        return
    retry = [
        ti
        for ti, t in enumerate(tasks)
        if ti not in had_chain
        and t.rep_len > 0
        and params.max_occ > params.occ_cap(t.ref)
    ]
    if not retry:
        return
    trace.count("align.reseed_pairs", len(retry))
    # occ_cap == max_occ for the retry params, so a second-level retry is
    # structurally impossible (the guard above goes False)
    retry_params = dataclasses.replace(params, mid_occ=params.max_occ)
    retry_tasks = []
    for ti in retry:
        t = tasks[ti]
        plus, minus, rep = opm.collect_anchors(
            t.ref, t.sketch.mh, t.sketch.mp, t.sketch.ms,
            len(t.sketch.codes), params.max_occ,
        )
        retry_tasks.append(PairTask(t.sketch, t.ref, plus, minus, int(rep)))
    log.info("re-seeding %d repeat-dominated pair(s) at max_occ=%d",
             len(retry), params.max_occ)
    for ti, g in zip(
        retry, flush_pairs_host_grouped(retry_tasks, retry_params, mesh, device=device)
    ):
        if g[0].flag != 4:
            groups[ti] = g


def _finalize_mapq(
    group: list[SamRecord],
    task: PairTask,
    params: AlignParams,
    dp2: int,
) -> None:
    """Fill in ``mapq`` for every record in one task's group from the
    deferred meta (s1, s2_chain, cnt, dp_max) + the probe's dp_max2."""
    sum_sc = sum(r.mapq_meta[0] for r in group if r.mapq_meta is not None)
    for seg, rec in enumerate(group):
        if rec.mapq_meta is None:
            continue
        s1, s2c, cnt, dp_max = rec.mapq_meta
        rec.mapq = mm2_mapq(
            s1, s2c, cnt, dp_max,
            dp2 if seg == 0 else 0,  # probes target the primary's interval
            task.rep_len, sum_sc, params,
        )
        rec.mapq_meta = None


def align_batch(
    tar_path: str,
    queries: Sequence[FilteredQuery],
    batch_accessions: set[str] | None,
    params: AlignParams = AlignParams(),
    mesh=None,
    device_lock=None,
    pair_chunk: int = 4096,
    sketch_cache: dict[int, QuerySketch] | None = None,
    asm_cache_dir: str | None = None,
    device: str | torch.device = "cuda",
) -> Iterator[SamRecord]:
    """Align a batch: stream candidate genomes out of the tar and emit SAM
    records (mirrors batch_align.py map_queries_to_batch, device-batched).

    queries: filtered queries (candidate accessions in .candidates).
    batch_accessions: the batch's own accession allow-list
    (ref: Snakefile:543-546), or None to accept all.
    device_lock: optional lock serializing device submissions; held only
    around the pooled flush dispatch/drain, so tar streaming / ref indexing /
    anchor collection of OTHER batches overlaps this batch's device work.
    sketch_cache: optional query-index -> QuerySketch dict SHARED across
    batches of one run (a read with candidates in several batches is then
    sketched once, not once per batch); callers must key it to one stable
    `queries` list. Dict ops are GIL-atomic; a rare duplicate make() under
    concurrent batch jobs is benign.
    """
    import contextlib

    device = _resolve(mesh, device)
    _lk = device_lock if device_lock is not None else contextlib.nullcontext()
    rname_to_q: dict[str, list[int]] = {}
    if sketch_cache is None:
        sketch_cache = {}
    for qi, fq in enumerate(queries):
        for _, acc, _ in fq.candidates:
            if batch_accessions is not None and acc not in batch_accessions:
                continue
            rname_to_q.setdefault(acc, []).append(qi)

    pool: list[PairTask] = []
    # larger pools amortize the fixed per-flush costs (uploads, copies
    # back, launches); the 4096 default stays within
    # MAX_EXT_CELLS for the 256-bucket short-read case so extension still
    # runs as one call (config: device_pair_chunk)
    # every pooled PairTask pins its genome's RefIndex (codes + minimizer
    # table, ~5x genome bytes); a batch where thousands of genomes each
    # contribute a pair or two would otherwise pin tens of GB before the
    # pair count triggers a flush, far past the scheduler's reservation.
    # 256 MB because the one-deep flush pipeline keeps TWO pools alive
    # (the in-flight one plus the one being built).
    pool_ref_budget = 256 << 20
    pool_ref_bytes = 0
    pool_refs: set[int] = set()

    # one-deep flush pipeline WITHOUT a worker thread: flush i's device
    # program is DISPATCHED (flush_pairs_begin, async), the next pool's tar
    # streaming / ref indexing / anchor collection runs while the device
    # computes, then flush i is drained (flush_pairs_end). The previous
    # ThreadPoolExecutor version overlapped host python with host python —
    # pure GIL contention (measured SLOWER than serial at 8k pools).
    pending: FusedFlush | None = None

    def _begin(p):
        with _lk:
            return flush_pairs_begin(p, params, mesh, device=device)

    def _end(ff):
        with _lk:
            return flush_pairs_end(ff)

    for rname, contigs in iter_assemblies_cached(
        tar_path, set(rname_to_q), asm_cache_dir
    ):
        ref = _ref_index(rname, contigs, params, device)
        sks = []
        for qi in rname_to_q[rname]:
            if qi not in sketch_cache:
                fq = queries[qi]
                sketch_cache[qi] = QuerySketch.make(fq.qname, fq.seq, params)
            sks.append(sketch_cache[qi])
        pool.extend(make_pairs_batch(ref, sks, params))
        if id(ref) not in pool_refs:
            pool_refs.add(id(ref))
            pool_ref_bytes += ref.codes.nbytes + ref.sort_hash.nbytes * 2
        # flush pooled pairs (spanning genomes) once the device batch is
        # full OR the pinned-genome bytes exceed the pool budget
        if len(pool) >= pair_chunk or pool_ref_bytes >= pool_ref_budget:
            nxt = _begin(pool)
            if pending is not None:
                yield from _end(pending)
            pending = nxt
            pool = []
            pool_refs.clear()
            pool_ref_bytes = 0
    nxt = _begin(pool)
    if pending is not None:
        yield from _end(pending)
    yield from _end(nxt)


@dataclass
class _PoolSeg:
    """One producer-built segment of align pairs: ``batch`` is the spec
    index, ``final`` marks the batch's last segment (possibly empty)."""

    batch: int
    tasks: list[PairTask]
    final: bool


def align_batches_pooled(
    specs: Sequence[tuple[str, str, set[str] | None]],
    queries: Sequence[FilteredQuery],
    params: AlignParams = AlignParams(),
    mesh=None,
    device_lock=None,
    pair_chunk: int = 16384,
    sketch_cache: dict[int, QuerySketch] | None = None,
    producers: int = 2,
    asm_cache_dir: str | None = None,
    device: str | torch.device = "cuda",
) -> Iterator[tuple[str, list[SamRecord]]]:
    """Align MANY batches with one shared device-flush pipeline, pooling
    (query, genome) pairs ACROSS batch boundaries.

    The reference's unit of work is one minimap2 process per candidate
    genome within one batch (scripts/batch_align.py:416-486);
    per-batch pooling (align_batch) already batches a genome's pairs, but a
    run over hundreds of batches leaves most flushes far below the device
    sweet spot — a 305-batch production run degenerates into hundreds of
    small dispatches whose fixed cost dominates. Batch boundaries are a file
    -layout artifact, not a device constraint: this coordinator keeps ONE
    rolling pool fed by ``producers`` threads streaming tar/anchor host work
    in parallel, flushes at ``pair_chunk`` regardless of which batch the
    pairs came from, and routes each pair's records back to its source batch
    (flush_pairs_end_grouped). Yields (batch_name, records) as batches
    complete (completion order, not spec order); per-batch record order is
    identical to align_batch's (tar order x filtered-query order).
    """
    import contextlib
    import queue as _queue
    import threading

    device = _resolve(mesh, device)
    if not specs:
        return
    _lk = device_lock if device_lock is not None else contextlib.nullcontext()
    if sketch_cache is None:
        sketch_cache = {}
    seg_q: _queue.Queue = _queue.Queue(maxsize=max(4, 2 * producers))
    errors: list[BaseException] = []
    stop = threading.Event()

    # candidate map per batch is built inside the producer (it is cheap
    # relative to tar streaming and parallelizes with it)
    def _produce(bi: int, name: str, tar_path: str, accs: set[str] | None):
        try:
            rname_to_q: dict[str, list[int]] = {}
            for qi, fq in enumerate(queries):
                for _, acc, _ in fq.candidates:
                    if accs is not None and acc not in accs:
                        continue
                    rname_to_q.setdefault(acc, []).append(qi)
            seg: list[PairTask] = []
            seg_ref_bytes = 0
            # per-segment ref pin budget: the coordinator holds at most
            # queue-size + pool segments alive, so each stays modest
            ref_budget = 128 << 20
            # genomes accumulate into batched native calls — ONE ref
            # sketching call (build_ref_index_batch) and ONE segmented
            # anchor-collection call (make_pairs_multi) per ~64 genomes /
            # 512 queries, instead of two native calls per genome: the
            # per-call overhead dominated seeding at 10k-read scale
            pending: list[tuple] = []
            pend_q = 0
            gbuf: list[tuple[str, list]] = []
            gbuf_q = 0

            def flush_gbuf():
                nonlocal pend_q, seg_ref_bytes, gbuf_q
                if not gbuf:
                    return
                _count_genomes(len(gbuf), params, device)
                with trace.span("align.ref_index"):
                    refs = opm.build_ref_index_batch(
                        gbuf, params.k, params.w, hpc=params.hpc, device=device
                    )
                    for (rname2, _), ref in zip(gbuf, refs):
                        sks = []
                        for qi in rname_to_q[rname2]:
                            sk = sketch_cache.get(qi)
                            if sk is None:
                                fq = queries[qi]
                                sk = sketch_cache.setdefault(
                                    qi,
                                    QuerySketch.make(fq.qname, fq.seq, params),
                                )
                            sks.append(sk)
                        pending.append((ref, sks))
                        pend_q += len(sks)
                        seg_ref_bytes += (
                            ref.codes.nbytes + 2 * ref.sort_hash.nbytes
                        )
                gbuf.clear()
                gbuf_q = 0

            def drain_pending():
                nonlocal pend_q
                flush_gbuf()
                if pending:
                    with trace.span("align.anchors"):
                        seg.extend(make_pairs_multi(pending, params))
                    pending.clear()
                    pend_q = 0

            with trace.span("align.assemblies"):
                for rname, contigs in iter_assemblies_cached(
                    tar_path, set(rname_to_q), asm_cache_dir
                ):
                    if stop.is_set():
                        return
                    gbuf.append((rname, contigs))
                    gbuf_q += len(rname_to_q[rname])
                    # small batches: enough to amortize the native call,
                    # small enough that pair segments keep flowing to the
                    # device consumer (64-genome bursts measurably starved
                    # the flush pipeline at e2e scale)
                    if len(gbuf) >= 16 or gbuf_q >= 256:
                        flush_gbuf()
                    if (
                        pend_q >= 256
                        or pend_q + len(seg) >= pair_chunk
                        or seg_ref_bytes >= ref_budget
                    ):
                        drain_pending()
                    if len(seg) >= pair_chunk or seg_ref_bytes >= ref_budget:
                        seg_q.put(_PoolSeg(bi, seg, False))
                        seg, seg_ref_bytes = [], 0
                drain_pending()
            seg_q.put(_PoolSeg(bi, seg, True))
        except BaseException as e:  # surfaced by the coordinator
            errors.append(e)
            seg_q.put(_PoolSeg(bi, [], True))

    threads: list[threading.Thread] = []
    next_spec = 0
    n_final = 0

    def _spawn():
        # keep exactly min(producers, remaining) batches in flight, counted
        # by started-minus-finalized (is_alive() races the final marker)
        nonlocal next_spec
        while next_spec < len(specs) and (next_spec - n_final) < producers:
            bi = next_spec
            next_spec += 1
            t = threading.Thread(
                target=_produce, args=(bi, *specs[bi]), daemon=True,
                name=f"align-producer-{bi}",
            )
            t.start()
            threads.append(t)

    _spawn()

    results: dict[int, list[SamRecord]] = {i: [] for i in range(len(specs))}
    pending_pairs = [0] * len(specs)  # pairs seen but not yet drained
    final_seen = [False] * len(specs)
    emitted = [False] * len(specs)
    pool: list[PairTask] = []
    owners: list[int] = []  # batch index per pool entry
    inflight: tuple[FusedFlush, list[int]] | None = None

    def _drain(fl: tuple[FusedFlush, list[int]]):
        ff, own = fl
        with trace.span("align.finish"), _lk:
            groups = flush_pairs_end_grouped(ff)
        for bi, grp in zip(own, groups):
            results[bi].extend(grp)
            pending_pairs[bi] -= 1

    def _flush_now():
        nonlocal inflight, pool, owners
        with trace.span("align.dispatch"), _lk:
            nxt = flush_pairs_begin(pool, params, mesh, device=device)
        prev, inflight = inflight, (nxt, owners)
        pool, owners = [], []
        if prev is not None:
            _drain(prev)

    def _emit_ready():
        for bi in range(len(specs)):
            if final_seen[bi] and not emitted[bi] and pending_pairs[bi] == 0:
                emitted[bi] = True
                yield specs[bi][0], results.pop(bi)

    try:
        while n_final < len(specs):
            with trace.span("align.wait"):
                seg = seg_q.get()
            trace.count("align.segments")
            if errors:
                raise errors[0]
            if seg.tasks:
                pool.extend(seg.tasks)
                owners.extend([seg.batch] * len(seg.tasks))
                pending_pairs[seg.batch] += len(seg.tasks)
            if seg.final:
                final_seen[seg.batch] = True
                n_final += 1
                _spawn()
            if len(pool) >= pair_chunk:
                _flush_now()
            if seg.final or len(pool) == 0:
                yield from _emit_ready()
        if pool:
            _flush_now()
        if inflight is not None:
            _drain(inflight)
            inflight = None
        if errors:
            raise errors[0]
        yield from _emit_ready()
    finally:
        stop.set()
        # unblock producers that may be parked on a full queue, then join
        for t in threads:
            while t.is_alive():
                try:
                    while True:
                        seg_q.get_nowait()
                except _queue.Empty:
                    pass
                t.join(timeout=0.2)
