"""Minimizer extraction and anchor (seed) generation, minimap2-sr-style (the
port's own copy of ``phylign_tpu/ops/minimizer.py``).

The reference aligns candidate (query, genome) pairs with
``minimap2 -a -x sr --eqx`` (ref: scripts/batch_align.py:268-270,
config.yaml:35,38). The sr preset seeds with (k=21, w=11) minimizers. This
module is the host-side numpy equivalent of minimap2's sketch + seed-lookup:

  * k-mers are 2-bit packed (A=0 C=1 G=2 T=3); the canonical strand is the
    numerically smaller of forward/revcomp packing; strand-symmetric k-mers
    (fwd == rc) are skipped;
  * the packed value is scrambled with the 64-bit invertible finalizer
    minimap2 uses (hash64 masked to 2k bits) before window comparison;
  * position i is a minimizer iff its hash is the minimum of at least one
    w-window covering it (ties kept).

All arrays are numpy; genomes are processed once per batch and the resulting
sorted seed tables feed the device chain/extend kernels
(phylign_tpu_torch.ops.chain / extend). On a CUDA device build_ref_index
and build_ref_index_batch build each genome's table with the kernels
ref_sketch and ref_sort (csrc/ref_index.cu), field-identical to the host
path, which the CPU and the hpc presets keep.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from phylign_tpu_torch.ops import _kernels

_U64 = np.uint64
KMER_SR = 21
WINDOW_SR = 11

#: Gap inserted between concatenated contigs in the global coordinate space.
#: Larger than every chaining distance bound, so chains cannot span contigs.
CONTIG_GUARD = 10_000


def _hash64(x: np.ndarray, mask: np.uint64) -> np.ndarray:
    """Invertible 64-bit mix (Thomas Wang / minimap2 hash64), masked."""
    old = np.seterr(over="ignore")
    try:
        x = (~x + (x << _U64(21))) & mask
        x = x ^ (x >> _U64(24))
        x = (x + (x << _U64(3)) + (x << _U64(8))) & mask
        x = x ^ (x >> _U64(14))
        x = (x + (x << _U64(2)) + (x << _U64(4))) & mask
        x = x ^ (x >> _U64(28))
        x = (x + (x << _U64(31))) & mask
        return x
    finally:
        np.seterr(**old)


def packed_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """2-bit packed forward and revcomp k-mer values: (fwd u64[N], rc u64[N])."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        return np.empty(0, _U64), np.empty(0, _U64)
    win = np.lib.stride_tricks.sliding_window_view(codes, k).astype(_U64)
    pows = (_U64(4) ** np.arange(k - 1, -1, -1, dtype=_U64))
    old = np.seterr(over="ignore")
    try:
        fwd = win @ pows
        rc = (_U64(3) - win[:, ::-1]) @ pows
    finally:
        np.seterr(**old)
    return fwd, rc


def minimizers(
    codes: np.ndarray, k: int = KMER_SR, w: int = WINDOW_SR, hpc: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Minimizer sketch of a code sequence.

    Returns (hashes u64[M], positions int32[M], strand u8[M]) sorted by
    position; strand 0 = canonical k-mer is the forward packing.

    hpc: homopolymer-compress first (minimap2 map-pb preset -H behavior):
    k-mers are taken over run-compressed bases, making the sketch invariant
    to homopolymer length errors; returned positions are RAW coordinates of
    each k-mer's first base (so chaining and extension stay in raw space —
    the minus-strand qpos adjustment is then approximate by up to the run
    lengths inside the k-mer, well within the alignment band).

    Uses the native C++ path (phylign_tpu_torch.native) when available; the numpy
    path below is the portable fallback and test oracle.
    """
    if hpc and codes.shape[0] > 0:
        keep = np.empty(codes.shape[0], bool)
        keep[0] = True
        np.not_equal(codes[1:], codes[:-1], out=keep[1:])
        raw_pos = np.flatnonzero(keep).astype(np.int32)
        h, p, s = minimizers(codes[keep], k, w, hpc=False)
        return h, raw_pos[p], s

    from phylign_tpu_torch import native

    nat = native.native_minimizers(codes, k, w)
    if nat is not None:
        return nat
    return _minimizers_numpy(codes, k, w)


def minimizers_batch(
    codes_list: list[np.ndarray],
    k: int = KMER_SR,
    w: int = WINDOW_SR,
    hpc: bool = False,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``minimizers`` for a whole read set in ONE threaded native call
    (per-read ctypes overhead dominated align-stage sketching at 10k+
    reads). hpc presets and the no-library case fall back per-read."""
    from phylign_tpu_torch import native

    if not hpc:
        nat = native.native_minimizers_batch(codes_list, k, w)
        if nat is not None:
            return nat
    return [minimizers(c, k, w, hpc=hpc) for c in codes_list]


def _minimizers_numpy(
    codes: np.ndarray, k: int, w: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Portable numpy minimizer sketch (fallback + test oracle)."""
    fwd, rc = packed_kmers(codes, k)
    n = fwd.shape[0]
    if n == 0:
        return np.empty(0, _U64), np.empty(0, np.int32), np.empty(0, np.uint8)
    strand = (rc < fwd).astype(np.uint8)  # 1 -> canonical is revcomp
    ambiguous = fwd == rc
    canon = np.where(strand == 1, rc, fwd)
    mask = _U64((1 << (2 * k)) - 1)
    h = _hash64(canon, mask)
    h[ambiguous] = np.iinfo(np.uint64).max  # never selected

    if n < w:
        w = n  # short sequences: one window over everything
    nw = n - w + 1
    hw = np.lib.stride_tricks.sliding_window_view(h, w)
    sw_min = hw.min(axis=1)  # [nw]
    selected = np.zeros(n, dtype=bool)
    for d in range(w):
        idx = np.arange(nw) + d
        selected[idx] |= h[idx] == sw_min
    selected &= ~ambiguous
    pos = np.nonzero(selected)[0].astype(np.int32)
    return h[pos], pos, strand[pos]


@dataclass
class RefIndex:
    """Sorted minimizer table of one genome (all contigs, global coords)."""

    name: str  # genome accession
    contig_names: list[str]
    contig_starts: np.ndarray  # int64 [C] global start of each contig
    contig_lens: np.ndarray  # int64 [C]
    codes: np.ndarray  # uint8 [T] concatenated 2-bit codes with guard gaps
    sort_hash: np.ndarray  # u64 [M] sorted
    sort_pos: np.ndarray  # int32 [M] global positions, by hash
    sort_strand: np.ndarray  # u8 [M]
    k: int
    w: int

    # lazily-built unique-hash table (uniq_table): probing it needs ONE
    # searchsorted per query set instead of the left+right pair over the
    # full sorted table — the two passes were the top anchor-collection cost
    _uniq: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    # lazily-built 2-bit packed codes (4 codes/byte, length padded to a
    # multiple of 4) for the fused align path's device genome pool
    _pack4: np.ndarray | None = None

    # cached derived occurrence caps, keyed by (frac, min_mid, max_mid)
    _mid_occ: dict = field(default_factory=dict)

    def contig_of(self, gpos: int) -> tuple[int, int]:
        """Global position -> (contig_idx, position within contig)."""
        c = int(np.searchsorted(self.contig_starts, gpos, side="right")) - 1
        return c, int(gpos - self.contig_starts[c])

    def packed4(self) -> np.ndarray:
        """2-bit packed codes ([ceil(T/4)] uint8, code j in bits 2*(j%4));
        cached — a genome is pooled into exactly one fused align flush."""
        if self._pack4 is None:
            from phylign_tpu_torch.align.fused import pack2bit_flat

            object.__setattr__(self, "_pack4", pack2bit_flat(self.codes))
        return self._pack4

    def uniq_table(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(unique_hashes, start_offset, count) over sort_hash; cached.

        sort_hash is ALREADY sorted (build_ref_index orders by hash), so
        run boundaries come from one np.diff pass — np.unique would pay a
        redundant argsort per reference, the measured host hot spot of the
        align stage at 10k-read scale (~1.6 ms x thousands of genomes)."""
        if self._uniq is None:
            h = self.sort_hash
            if h.shape[0] == 0:
                empty = np.zeros(0, np.int64)
                object.__setattr__(
                    self, "_uniq", (h, empty, empty)
                )
                return self._uniq
            starts = np.concatenate(
                ([0], np.flatnonzero(h[1:] != h[:-1]) + 1)
            ).astype(np.int64)
            counts = np.diff(np.concatenate((starts, [h.shape[0]])))
            object.__setattr__(self, "_uniq", (h[starts], starts, counts))
        return self._uniq

    def mid_occ(
        self,
        frac: float = 2e-4,
        min_mid: int = 10,
        max_mid: int = 1_000_000,
    ) -> int:
        """Occurrence cap derived from this genome's minimizer-frequency
        distribution (minimap2's mm_idx_cal_max_occ + the min/max clamps of
        mm_mapopt_update): the occurrence count of the (1-frac)-quantile
        distinct minimizer, plus one, clamped to [min_mid, max_mid]. Used
        for presets whose mid_occ is not a fixed preset constant (sr pins
        1000; ref: batch_align.py:268-270 runs `minimap2 -x sr`). Cached
        per (frac, min, max)."""
        key = (frac, min_mid, max_mid)
        if self._mid_occ.get(key) is None:
            _, _, cnt = self.uniq_table()
            if frac <= 0.0 or len(cnt) == 0:
                thres = np.iinfo(np.int32).max
            else:
                kth = min(int((1.0 - frac) * len(cnt)), len(cnt) - 1)
                thres = int(np.partition(cnt, kth)[kth]) + 1
            self._mid_occ[key] = max(min_mid, min(thres, max_mid))
        return self._mid_occ[key]


def _assemble(
    contigs: list[tuple[str, np.ndarray]],
) -> tuple[list[int], list[int], np.ndarray]:
    """(contig starts, contig lengths, concatenated codes): each contig
    followed by CONTIG_GUARD 'A's."""
    starts, lens, parts = [], [], []
    cur = 0
    for _, codes in contigs:
        starts.append(cur)
        lens.append(len(codes))
        parts.append(codes)
        cur += len(codes)
        parts.append(np.zeros(CONTIG_GUARD, dtype=np.uint8))  # 'A' guard
        cur += CONTIG_GUARD
    allcodes = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return starts, lens, allcodes


def _device_ref_index(
    name: str, contigs: list[tuple[str, np.ndarray]], k: int, w: int, device
) -> RefIndex:
    """build_ref_index's RefIndex with its table from the ref_sketch and
    ref_sort kernels (index_on_device)."""
    starts, lens, allcodes = _assemble(contigs)
    h, p, s = device_tables(allcodes, starts, lens, k, w, device)
    return RefIndex(
        name=name,
        contig_names=[c for c, _ in contigs],
        contig_starts=np.asarray(starts, np.int64),
        contig_lens=np.asarray(lens, np.int64),
        codes=allcodes,
        sort_hash=h,
        sort_pos=p,
        sort_strand=s,
        k=k,
        w=w,
    )


def build_ref_index(
    name: str,
    contigs: list[tuple[str, np.ndarray]],
    k: int = KMER_SR,
    w: int = WINDOW_SR,
    hpc: bool = False,
    device=None,
) -> RefIndex:
    """Index a genome: per-contig minimizers in a global guarded coordinate
    space, sorted by hash for binary-search seeding.

    The guard gap (CONTIG_GUARD 'A's) exceeds every chaining distance bound,
    so no chain or alignment band can cross a contig boundary; guard-region
    minimizers are excluded from the table.

    device: where index_on_device says so (a CUDA device), the table is
    built on it by the ref_sketch and ref_sort kernels; else on the host.
    """
    if index_on_device(device, hpc, k, w):
        return _device_ref_index(name, contigs, k, w, device)
    starts, lens, allcodes = _assemble(contigs)

    hs, ps, ss = [], [], []
    for (_, codes), start in zip(contigs, starts):
        h, p, s = minimizers(codes, k, w, hpc=hpc)
        hs.append(h)
        ps.append(p + np.int32(start))
        ss.append(s)
    h = np.concatenate(hs) if hs else np.empty(0, _U64)
    p = np.concatenate(ps) if ps else np.empty(0, np.int32)
    s = np.concatenate(ss) if ss else np.empty(0, np.uint8)
    order = np.argsort(h, kind="stable")
    return RefIndex(
        name=name,
        contig_names=[c for c, _ in contigs],
        contig_starts=np.asarray(starts, np.int64),
        contig_lens=np.asarray(lens, np.int64),
        codes=allcodes,
        sort_hash=h[order],
        sort_pos=p[order],
        sort_strand=s[order],
        k=k,
        w=w,
    )


def build_ref_index_batch(
    genomes: "list[tuple[str, list[tuple[str, np.ndarray]]]]",
    k: int = KMER_SR,
    w: int = WINDOW_SR,
    hpc: bool = False,
    device=None,
) -> "list[RefIndex]":
    """build_ref_index for MANY genomes with ONE threaded native sketching
    call over every contig (minimizers_batch): per-genome sketch-call
    overhead dominates ref indexing when a run streams thousands of small
    candidate genomes. Field-identical to per-genome build_ref_index.

    device: where index_on_device says so, each genome's table is built on
    it (build_ref_index's device route); else the native path above."""
    if index_on_device(device, hpc, k, w):
        return [_device_ref_index(name, contigs, k, w, device) for name, contigs in genomes]
    all_codes: list[np.ndarray] = []
    for _, contigs in genomes:
        for _, codes in contigs:
            all_codes.append(codes)
    sketches = iter(minimizers_batch(all_codes, k, w, hpc=hpc))
    out: list[RefIndex] = []
    for name, contigs in genomes:
        starts, lens, parts = [], [], []
        hs, ps, ss = [], [], []
        cur = 0
        for _, codes in contigs:
            starts.append(cur)
            lens.append(len(codes))
            parts.append(codes)
            h, p, s = next(sketches)
            hs.append(h)
            ps.append(p + np.int32(cur))
            ss.append(s)
            cur += len(codes) + CONTIG_GUARD
            parts.append(np.zeros(CONTIG_GUARD, dtype=np.uint8))
        allcodes = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        h = np.concatenate(hs) if hs else np.empty(0, _U64)
        p = np.concatenate(ps) if ps else np.empty(0, np.int32)
        s = np.concatenate(ss) if ss else np.empty(0, np.uint8)
        order = np.argsort(h, kind="stable")
        out.append(
            RefIndex(
                name=name,
                contig_names=[c for c, _ in contigs],
                contig_starts=np.asarray(starts, np.int64),
                contig_lens=np.asarray(lens, np.int64),
                codes=allcodes,
                sort_hash=h[order],
                sort_pos=p[order],
                sort_strand=s[order],
                k=k,
                w=w,
            )
        )
    return out


# --- the table on the card: kernels ref_sketch and ref_sort ----------------------

#: k-mer positions a block of ref_sketch takes (csrc/ref_index.cu's
#: kSketchTile); the kernels' largest k (2k bits below a u64's top bit) and w
SKETCH_TILE = 1024
MAX_K, MAX_W = 31, 255
#: the bits of a radix pass of ref_sort
SORT_DIGIT_BITS = 8

_launches = _kernels.LaunchCounts("ref_sketch", "ref_sort")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by name: ``ref_sketch_count``
    (the count pass and its scan), ``ref_sketch`` (the write pass: one a
    sketch), ``ref_sort`` (one a sort, its passes inside)."""
    return _launches.snapshot()


def reset_launch_counts() -> None:
    _launches.reset()


def index_on_device(device, hpc: bool, k: int, w: int) -> bool:
    """Whether build_ref_index(_batch) builds the table on ``device`` with
    the kernels: a CUDA device, a plain sketch (the homopolymer-compressed
    one of ``hpc`` stays on the host) and k, w within the kernels' MAX_K,
    MAX_W (minimap2's own limits are k <= 28, w <= 255)."""
    return (
        device is not None
        and torch.device(device).type == "cuda"
        and not hpc
        and 1 <= k <= MAX_K
        and 1 <= w <= MAX_W
    )


def _check_contigs(codes: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, k: int, w: int) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise TypeError("ref_sketch takes a 1-D uint8 codes tensor")
    if starts.dtype != torch.int64 or lens.dtype != torch.int64:
        raise TypeError("ref_sketch takes int64 contig starts and lengths")
    if starts.device.type != "cpu" or lens.device.type != "cpu":
        raise ValueError("ref_sketch takes the contig table (starts, lengths) on the host")
    if starts.dim() != 1 or starts.shape != lens.shape:
        raise ValueError(f"ref_sketch: starts {tuple(starts.shape)} and lengths {tuple(lens.shape)} differ")
    if not all(t.is_contiguous() for t in (codes, starts, lens)):
        raise ValueError("ref_sketch takes contiguous tensors")
    if not (1 <= k <= MAX_K and 1 <= w <= MAX_W):
        raise ValueError(f"ref_sketch: k {k} (1..{MAX_K}) or w {w} (1..{MAX_W}) out of range")
    t = codes.shape[0]
    if t >= 1 << 31 or bool(((starts < 0) | (lens < 0) | (starts + lens > t)).any()):
        raise ValueError(f"ref_sketch: a contig lies outside the {t} codes (or they pass 2**31)")


def _hash64_ref(x: torch.Tensor, mask: int) -> torch.Tensor:
    """mm_hash64 masked to ``mask`` (< 2**62) in int64, every sum and shift
    kept below 2**63 by masking first (the kernel's u64 arithmetic mod
    2**(2k))."""

    def shl(v, n):
        return (v & (mask >> n)) << n

    x = ((mask - x) + shl(x, 21)) & mask
    x = x ^ (x >> 24)
    x = (((x + shl(x, 3)) & mask) + shl(x, 8)) & mask
    x = x ^ (x >> 14)
    x = (((x + shl(x, 2)) & mask) + shl(x, 4)) & mask
    x = x ^ (x >> 28)
    return (x + shl(x, 31)) & mask


def ref_sketch_ref(
    codes: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, k: int, w: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of ref_sketch_cuda (CPU tensors): each contig's
    minimizers (minimizers' rule over codes[start : start + len]) as
    (hash int64 [M], global position int32 [M], strand uint8 [M]) in
    position order."""
    _check_contigs(codes, starts, lens, k, w)
    mask = (1 << (2 * k)) - 1
    inf = torch.iinfo(torch.int64).max  # above every masked hash
    hs, ps, ss = [], [], []
    for start, length in zip(starts.tolist(), lens.tolist()):
        n = length - k + 1
        if n <= 0:
            continue
        c = codes[start : start + length].to(torch.int64)
        fwd = torch.zeros(n, dtype=torch.int64)
        rc = torch.zeros(n, dtype=torch.int64)
        for j in range(k):
            fwd = (fwd << 2) | c[j : j + n]
            rc = rc | ((3 - c[j : j + n]) << (2 * j))
        strand = rc < fwd
        h = torch.where(fwd == rc, inf, _hash64_ref(torch.where(strand, rc, fwd), mask))
        wc = min(w, n)
        nw = n - wc + 1
        wmin = h.unfold(0, wc, 1).amin(1)
        sel = torch.zeros(n, dtype=torch.bool)
        for d in range(wc):
            sel[d : d + nw] |= h[d : d + nw] == wmin
        sel &= h != inf
        pos = torch.nonzero(sel).flatten()
        hs.append(h[pos])
        ps.append((pos + start).to(torch.int32))
        ss.append(strand[pos].to(torch.uint8))
    if not hs:
        return (torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int32),
                torch.zeros(0, dtype=torch.uint8))
    return torch.cat(hs), torch.cat(ps), torch.cat(ss)


def _check_table(hash_: torch.Tensor, pos: torch.Tensor, strand: torch.Tensor, bits: int) -> None:
    if hash_.dtype != torch.int64 or pos.dtype != torch.int32 or strand.dtype != torch.uint8:
        raise TypeError("ref_sort takes int64 hashes, int32 positions and uint8 strands")
    if hash_.dim() != 1 or pos.shape != hash_.shape or strand.shape != hash_.shape:
        raise ValueError(
            f"ref_sort: shapes {tuple(hash_.shape)}, {tuple(pos.shape)}, {tuple(strand.shape)} differ"
        )
    if not (pos.device == hash_.device == strand.device):
        raise ValueError("ref_sort takes its three tensors on one device")
    if not all(t.is_contiguous() for t in (hash_, pos, strand)):
        raise ValueError("ref_sort takes contiguous tensors")
    if not 1 <= bits <= 64:
        raise ValueError(f"ref_sort: bits {bits} outside 1..64")


def ref_sort_ref(
    hash_: torch.Tensor, pos: torch.Tensor, strand: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of ref_sort_cuda (CPU tensors): the kernel's stable
    LSD passes of SORT_DIGIT_BITS over the hash's low ``bits`` bits, each a
    histogram, its exclusive sum and a scatter that keeps each digit's
    items in order; on a position-ordered sketch, np.argsort(h,
    kind="stable")'s order."""
    _check_table(hash_, pos, strand, bits)
    nbins = 1 << SORT_DIGIT_BITS
    for shift in range(0, bits, SORT_DIGIT_BITS):
        d = (hash_ >> shift) & (nbins - 1)  # hashes below 2**63 (k <= 31)
        counts = torch.bincount(d, minlength=nbins)
        first = torch.cumsum(counts, 0) - counts
        dest = torch.empty_like(d)
        for v in torch.nonzero(counts).flatten().tolist():
            idx = torch.nonzero(d == v).flatten()
            dest[idx] = first[v] + torch.arange(idx.numel())
        order = torch.empty_like(d)
        order[dest] = torch.arange(d.numel())
        hash_, pos, strand = hash_[order], pos[order], strand[order]
    return hash_, pos, strand


def ref_sketch_cuda(
    codes: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, k: int, w: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sketch kernel (csrc/ref_index.cu): ref_sketch_ref's output on
    ``codes``' device, codes a CUDA uint8 tensor and the contig table
    (int64 starts and lengths) on the host. Two launches on the current
    stream (the count pass and its scan, counted as ``ref_sketch_count``;
    the write pass, ``ref_sketch``), with one wait on that stream between
    them for the table's size."""
    _check_contigs(codes, starts, lens, k, w)
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError("ref_sketch_cuda runs on a CUDA codes tensor")
    n_pos = (lens - k + 1).clamp(min=0)
    tiles = (n_pos + SKETCH_TILE - 1) // SKETCH_TILE
    tile_first = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(tiles, 0)])
    n_tiles = int(tile_first[-1])
    if n_tiles == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev), torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.uint8, device=dev))
    n_c = starts.shape[0]
    table = torch.cat([starts, lens, tile_first]).pin_memory().to(dev, non_blocking=True)
    c_start, c_len = table[:n_c], table[n_c : 2 * n_c]
    first32 = table[2 * n_c :].to(torch.int32)
    cnt = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    args = (codes, c_start, c_len, first32, n_c, n_tiles, SKETCH_TILE, k, w)
    _kernels.launch(_launches, "ref_sketch_count", "ref_index", "phylign_ref_sketch", *args, 0, cnt,
                    None, None, None)
    m = int(cnt[n_tiles])  # waits on the current stream
    h = torch.empty(m, dtype=torch.int64, device=dev)
    p = torch.empty(m, dtype=torch.int32, device=dev)
    s = torch.empty(m, dtype=torch.uint8, device=dev)
    _kernels.launch(_launches, "ref_sketch", "ref_index", "phylign_ref_sketch", *args, 1, cnt, h, p, s)
    return h, p, s


def ref_sort_cuda(
    hash_: torch.Tensor, pos: torch.Tensor, strand: torch.Tensor, bits: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sort kernel (csrc/ref_index.cu): ref_sort_ref's output for CUDA
    tensors, the hashes below 2**bits; one call of ceil(bits / 8) passes
    on the current stream, counted as ``ref_sort``."""
    _check_table(hash_, pos, strand, bits)
    dev = hash_.device
    if dev.type != "cuda":
        raise ValueError("ref_sort_cuda runs on CUDA tensors")
    m = hash_.shape[0]
    out = (torch.empty_like(hash_), torch.empty_like(pos), torch.empty_like(strand))
    if m == 0:
        return out
    lib = _kernels.library("ref_index")
    keys = torch.empty((2, m), dtype=torch.int64, device=dev)
    vals = torch.empty((2, m), dtype=torch.int32, device=dev)
    hist = torch.empty(int(lib.phylign_ref_sort_hist_len(m)), dtype=torch.int32, device=dev)
    _kernels.launch(_launches, "ref_sort", "ref_index", "phylign_ref_sort", hash_, pos, strand, m, bits,
                    keys[0], vals[0], keys[1], vals[1], hist, *out)
    return out


def ref_sketch(codes, starts, lens, k: int, w: int):
    """ref_sketch_cuda for CUDA codes, ref_sketch_ref for CPU codes."""
    if codes.device.type == "cpu":
        return ref_sketch_ref(codes, starts, lens, k, w)
    return ref_sketch_cuda(codes, starts, lens, k, w)


def ref_sort(hash_, pos, strand, bits: int):
    """ref_sort_cuda for CUDA tensors, ref_sort_ref for CPU tensors."""
    if hash_.device.type == "cpu":
        return ref_sort_ref(hash_, pos, strand, bits)
    return ref_sort_cuda(hash_, pos, strand, bits)


def device_tables(
    allcodes: np.ndarray, starts: list[int], lens: list[int], k: int, w: int, device
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sort_hash u64, sort_pos int32, sort_strand u8) of one assembled
    genome (_assemble's output), by ref_sketch then ref_sort on ``device``
    (a CPU device runs their plain versions). On a card everything runs on
    a stream of the call's own, and only that stream is waited on: once
    for the table's size, once for the table (pinned copies both ways), so
    a producer thread never waits on another thread's work."""
    device = torch.device(device)
    st = torch.tensor(starts, dtype=torch.int64)
    ln = torch.tensor(lens, dtype=torch.int64)
    if device.type == "cpu":
        host = ref_sort(*ref_sketch(torch.from_numpy(allcodes), st, ln, k, w), 2 * k)
    else:
        stream = torch.cuda.Stream(device=device)
        with torch.cuda.stream(stream):
            codes = torch.from_numpy(allcodes).pin_memory().to(device, non_blocking=True)
            table = ref_sort(*ref_sketch(codes, st, ln, k, w), 2 * k)
            host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in table]
            for dst, src in zip(host, table):
                dst.copy_(src, non_blocking=True)
            stream.synchronize()
    return host[0].numpy().view(np.uint64), host[1].numpy(), host[2].numpy()


@dataclass(slots=True)
class Anchors:
    """Seed anchors of one (query, genome) pair, one strand set."""

    rpos: np.ndarray  # int32 [A] global ref pos of k-mer start (fwd ref coords)
    qpos: np.ndarray  # int32 [A] query pos (in strand-adjusted query coords)


def _rep_lens(
    qid: np.ndarray, qp: np.ndarray, flt: np.ndarray, k: int, nq: int
) -> np.ndarray:
    """Per-query repeat length: query bases covered by filtered (over-cap)
    seeds, overlapping spans merged (minimap2's rep_len, the rl:i tag).
    qp must be position-sorted within each query (minimizer order). Since
    all spans have width k and starts ascend, the merged coverage is
    sum(min(k, next_start - start)) with k for the last span per query."""
    idx = np.flatnonzero(flt)
    if len(idx) == 0:
        return np.zeros(nq, np.int64)
    q, st = qid[idx], qp[idx]
    contrib = np.full(len(idx), k, np.int64)
    same = q[1:] == q[:-1]
    contrib[:-1][same] = np.minimum(k, (st[1:] - st[:-1])[same])
    return np.bincount(q, weights=contrib, minlength=nq).astype(np.int64)


def _slice_anchor_groups(
    rp_s: np.ndarray, qp_s: np.ndarray, bounds: np.ndarray, nq: int
) -> list[tuple[Anchors, Anchors]]:
    """Per-query (plus, minus) Anchors as VIEWS into the shared sorted
    arrays (group g = 2q+strand occupies bounds[g]:bounds[g+1])."""
    out: list[tuple[Anchors, Anchors]] = []
    bl = bounds.tolist()
    for q in range(nq):
        sl_p = slice(bl[2 * q], bl[2 * q + 1])
        sl_m = slice(bl[2 * q + 1], bl[2 * q + 2])
        out.append(
            (Anchors(rp_s[sl_p], qp_s[sl_p]), Anchors(rp_s[sl_m], qp_s[sl_m]))
        )
    return out


def collect_anchors_batch(
    ref: RefIndex,
    q_hashes: list[np.ndarray],
    q_poss: list[np.ndarray],
    q_strands: list[np.ndarray],
    q_lens: list[int],
    max_occ: int = 1000,
) -> tuple[list[tuple[Anchors, Anchors]], np.ndarray]:
    """Vectorized anchor collection for MANY queries against one genome.

    One searchsorted over the concatenated minimizer sets + one vectorized
    range expansion replaces the per-minimizer Python loop of
    collect_anchors; semantics identical. Returns (per-query (plus, minus),
    rep_len i64[nq] — query bases covered by over-cap seeds, the rl:i tag)."""
    nq = len(q_hashes)
    sizes = np.array([len(h) for h in q_hashes], np.int64)
    if sizes.sum() == 0 or ref.sort_hash.shape[0] == 0:
        empty = Anchors(np.empty(0, np.int32), np.empty(0, np.int32))
        return [(empty, empty) for _ in range(nq)], np.zeros(nq, np.int64)
    qid = np.repeat(np.arange(nq), sizes)
    h = np.concatenate(q_hashes)
    qp = np.concatenate(q_poss).astype(np.int64)
    qs = np.concatenate(q_strands)
    qlen_arr = np.asarray(q_lens, np.int64)

    uh, us, ucnt = ref.uniq_table()

    from phylign_tpu_torch import native

    nat = native.native_collect_anchors(
        uh, us, ucnt, ref.sort_pos, ref.sort_strand,
        h, qp, qs, np.concatenate(([0], np.cumsum(sizes))), qlen_arr,
        max_occ, ref.k,
    )
    if nat is not None:
        rp_s, qp_s, bounds, rep = nat
        return _slice_anchor_groups(rp_s, qp_s, bounds, nq), rep
    pos = np.minimum(np.searchsorted(uh, h), len(uh) - 1)
    found = uh[pos] == h
    lo = us[pos]
    cnt = np.where(found, ucnt[pos], 0)
    rep = _rep_lens(qid, qp, cnt > max_occ, ref.k, nq)
    keep = (cnt > 0) & (cnt <= max_occ)
    ks = np.flatnonzero(keep)
    reps = cnt[ks]
    tot = int(reps.sum())
    if tot == 0:
        empty = Anchors(np.empty(0, np.int32), np.empty(0, np.int32))
        return [(empty, empty) for _ in range(nq)], rep
    # flat indices into the sorted ref table: starts repeated + running offset
    offs = np.arange(tot) - np.repeat(np.cumsum(reps) - reps, reps)
    rt = np.repeat(lo[ks], reps) + offs
    rp = ref.sort_pos[rt].astype(np.int32)
    rstr = ref.sort_strand[rt]
    a_qid = np.repeat(qid[ks], reps)
    a_qpos = np.repeat(qp[ks], reps)
    a_qstr = np.repeat(qs[ks], reps)
    rel = rstr != a_qstr  # 1 -> read maps to ref minus strand
    qpos_adj = np.where(
        rel, qlen_arr[a_qid] - ref.k - a_qpos, a_qpos
    ).astype(np.int32)
    # group by (query, strand) then sort (rpos, qpos) within groups.
    # Fast path: pack (group 21b | rpos 27b | qpos 16b) into ONE u64 and
    # radix-sort it — a single-key sort of N u64s runs ~3x faster than the
    # 3-key lexsort and the fields decode back for free. Falls back to
    # lexsort when any field exceeds its packed width (multi-hundred-Mb
    # refs or >32kb reads).
    group = a_qid * 2 + rel
    rp64 = rp.astype(np.int64)
    if (
        len(rp) > 0
        and 2 * nq <= 1 << 21
        and int(rp64.max()) < 1 << 27
        and int(qpos_adj.max(initial=0)) < 1 << 16
        and int(qpos_adj.min(initial=0)) >= 0
    ):
        key = (
            (group.astype(np.uint64) << np.uint64(43))
            | (rp64.astype(np.uint64) << np.uint64(16))
            | qpos_adj.astype(np.uint64)
        )
        key.sort()
        group_s = (key >> np.uint64(43)).astype(np.int64)
        rp_s = ((key >> np.uint64(16)) & np.uint64((1 << 27) - 1)).astype(
            np.int32
        )
        qp_s = (key & np.uint64(0xFFFF)).astype(np.int32)
    else:
        order = np.lexsort((qpos_adj, rp, group))
        group_s, rp_s, qp_s = group[order], rp[order], qpos_adj[order]
    bounds = np.searchsorted(group_s, np.arange(2 * nq + 1))
    out = []
    bl = bounds.tolist()
    for q in range(nq):
        sl_p = slice(bl[2 * q], bl[2 * q + 1])
        sl_m = slice(bl[2 * q + 1], bl[2 * q + 2])
        # views into the shared sorted arrays (NOT copies): the parent is a
        # few MB and 2*nq small copies cost more than it saves
        out.append(
            (
                Anchors(rp_s[sl_p], qp_s[sl_p]),
                Anchors(rp_s[sl_m], qp_s[sl_m]),
            )
        )
    return out, rep


def collect_anchors_multi(
    groups: "list[tuple[RefIndex, list, list, list, list, int]]",
    k: int,
) -> tuple[list[tuple[Anchors, Anchors]], np.ndarray]:
    """Anchor collection for MANY (ref, query set) groups in ONE native
    call (hostio.cpp anchors_count2_seg): per-genome python/ctypes call
    overhead dominates align seeding at 10k-read scale, where a run
    touches thousands of small candidate genomes.

    groups: (ref, q_hashes, q_poss, q_strands, q_lens, max_occ) per
    genome. Returns per-query (plus, minus) anchors in group-then-query
    order plus the concatenated rep_len array — identical to running
    collect_anchors_batch per group (the fallback when the native symbol
    is unavailable)."""
    from phylign_tpu_torch import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "anchors_count2_seg"):
        out: list[tuple[Anchors, Anchors]] = []
        reps: list[np.ndarray] = []
        for ref, qh, qp, qs, ql, mo in groups:
            o, r = collect_anchors_batch(ref, qh, qp, qs, ql, mo)
            out.extend(o)
            reps.append(r)
        return out, (
            np.concatenate(reps) if reps else np.zeros(0, np.int64)
        )

    uh_l, us_l, uc_l, sp_l, ss_l = [], [], [], [], []
    useg_off, useg_n, sseg_off, mo_l = [], [], [], []
    qh_l, qp_l, qs_l, ql_l = [], [], [], []
    u_base = s_base = 0
    for ref, qhs, qps, qss, qls, mo in groups:
        uh, us, ucnt = ref.uniq_table()
        uh_l.append(uh)
        us_l.append(us)
        uc_l.append(ucnt)
        sp_l.append(ref.sort_pos)
        ss_l.append(ref.sort_strand)
        nq_g = len(qls)
        useg_off += [u_base] * nq_g
        useg_n += [len(uh)] * nq_g
        sseg_off += [s_base] * nq_g
        mo_l += [int(mo)] * nq_g
        qh_l += list(qhs)
        qp_l += [np.asarray(p, np.int64) for p in qps]
        qs_l += list(qss)
        ql_l += list(qls)
        u_base += len(uh)
        s_base += len(ref.sort_pos)
    nq = len(ql_l)
    if nq == 0:
        return [], np.zeros(0, np.int64)
    sizes = np.array([len(h) for h in qh_l], np.int64)
    qoff = np.concatenate(([0], np.cumsum(sizes)))
    nat = native.native_collect_anchors_seg(
        np.concatenate(uh_l) if uh_l else np.zeros(0, np.uint64),
        np.concatenate(us_l) if us_l else np.zeros(0, np.int64),
        np.concatenate(uc_l) if uc_l else np.zeros(0, np.int64),
        np.asarray(useg_off, np.int64), np.asarray(useg_n, np.int64),
        np.concatenate(sp_l) if sp_l else np.zeros(0, np.int32),
        np.concatenate(ss_l) if ss_l else np.zeros(0, np.uint8),
        np.asarray(sseg_off, np.int64),
        np.concatenate(qh_l) if qh_l else np.zeros(0, np.uint64),
        np.concatenate(qp_l) if qp_l else np.zeros(0, np.int64),
        np.concatenate(qs_l) if qs_l else np.zeros(0, np.uint8),
        qoff, np.asarray(ql_l, np.int64), np.asarray(mo_l, np.int64), k,
    )
    assert nat is not None  # guarded by the hasattr check above
    rp_s, qp_s, bounds, rep = nat
    return _slice_anchor_groups(rp_s, qp_s, bounds, nq), rep


def collect_anchors(
    ref: RefIndex,
    q_hash: np.ndarray,
    q_pos: np.ndarray,
    q_strand: np.ndarray,
    qlen: int,
    max_occ: int = 1000,
) -> tuple[Anchors, Anchors, int]:
    """Look up query minimizers in the ref table -> (plus, minus, rep_len).

    An anchor joins a query minimizer and one ref occurrence of the same
    canonical k-mer. Relative strand = q_strand XOR ref_strand; for minus
    anchors the query coordinate is re-expressed in the reverse-complemented
    query (qlen - k - qpos), so chaining is monotonic in both strands.
    Seeds occurring more than max_occ times in the genome are dropped
    (minimap2's high-frequency seed filter; the sr preset pins the cap at
    1000, other presets derive it — RefIndex.mid_occ); rep_len counts the
    query bases those dropped seeds cover (merged spans, the rl:i tag).
    """
    lo = np.searchsorted(ref.sort_hash, q_hash, side="left")
    hi = np.searchsorted(ref.sort_hash, q_hash, side="right")
    rp_p, qp_p, rp_m, qp_m = [], [], [], []
    k = ref.k
    cnt_all = hi - lo
    rep = int(
        _rep_lens(
            np.zeros(len(q_hash), np.int64),
            q_pos.astype(np.int64),
            cnt_all > max_occ,
            k,
            1,
        )[0]
    )
    for i in range(q_hash.shape[0]):
        cnt = cnt_all[i]
        if cnt == 0 or cnt > max_occ:
            continue
        rp = ref.sort_pos[lo[i] : hi[i]]
        rs = ref.sort_strand[lo[i] : hi[i]]
        rel = rs != q_strand[i]  # 1 -> read maps to ref minus strand
        if (~rel).any():
            rp_p.append(rp[~rel])
            qp_p.append(np.full((~rel).sum(), q_pos[i], np.int32))
        if rel.any():
            rp_m.append(rp[rel])
            qp_m.append(np.full(rel.sum(), qlen - k - q_pos[i], np.int32))
    plus = Anchors(
        np.concatenate(rp_p) if rp_p else np.empty(0, np.int32),
        np.concatenate(qp_p) if qp_p else np.empty(0, np.int32),
    )
    minus = Anchors(
        np.concatenate(rp_m) if rp_m else np.empty(0, np.int32),
        np.concatenate(qp_m) if qp_m else np.empty(0, np.int32),
    )
    for a in (plus, minus):
        order = np.lexsort((a.qpos, a.rpos))
        a.rpos, a.qpos = a.rpos[order], a.qpos[order]
    return plus, minus, rep
