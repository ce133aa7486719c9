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
(phylign_tpu_torch.ops.chain / extend).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

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


def build_ref_index(
    name: str,
    contigs: list[tuple[str, np.ndarray]],
    k: int = KMER_SR,
    w: int = WINDOW_SR,
    hpc: bool = False,
) -> RefIndex:
    """Index a genome: per-contig minimizers in a global guarded coordinate
    space, sorted by hash for binary-search seeding.

    The guard gap (CONTIG_GUARD 'A's) exceeds every chaining distance bound,
    so no chain or alignment band can cross a contig boundary; guard-region
    minimizers are excluded from the table.
    """
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
) -> "list[RefIndex]":
    """build_ref_index for MANY genomes with ONE threaded native sketching
    call over every contig (minimizers_batch): per-genome sketch-call
    overhead dominates ref indexing when a run streams thousands of small
    candidate genomes. Field-identical to per-genome build_ref_index."""
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
