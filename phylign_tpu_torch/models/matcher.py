"""Matcher: the match stage's model (counterpart of
``phylign_tpu/models/matcher.py``).

Holds one batch's packed Bloom bit-matrix on the device and scores query
k-mers against it: hash -> Bloom row, gather + vertical popcount (the
kernels of ``phylign_tpu_torch.ops.match``), integer threshold, top-k and
hit compaction on the device (kernel B5, ``csrc/match_epilogue.cu``, on the
card); only the qualifying hits cross to the host. B5d merges a mesh's
per-shard windows (``parallel/dist.py``).
The text postprocessing stays on the host (``phylign_tpu_torch.match``).

Unsigned data live in signed tensors with the same bits: words and the hit
buffer in int32, each XXH64 hash as two int64 halves below 2**32.
"""

from __future__ import annotations

import contextlib
import ctypes
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from phylign_tpu_torch.io.cobs import DeviceIndex
from phylign_tpu_torch.kmer import cobs_row_indices, encode_seq, rows_from_hashes
from phylign_tpu_torch.ops import _kernels
from phylign_tpu_torch.ops.match import (
    dedup_rows,
    match_scores,
    match_scores_acc_,
    match_scores_acc_planes_,
    match_scores_acc_planes_ref_,
    match_scores_acc_ref_,
    match_scores_dedup,
    match_scores_keep,
    match_scores_keep_ref,
    pack_row_indices,
    round_up,
)
from phylign_tpu_torch.parallel.mesh import AXIS_DOC
from phylign_tpu_torch.utils import trace


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _copy_to_host_async(
    t: torch.Tensor,
) -> tuple[torch.Tensor, "torch.cuda.Event | None"]:
    """Start a device-to-host copy into pinned memory; returns the host
    tensor and the event to wait on before reading it (None on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _compact_scores(
    scores: torch.Tensor, d_pad: int, dtype: torch.dtype
) -> torch.Tensor:
    """Device-side transfer compaction: drop padding doc columns and
    downcast to the smallest dtype that holds the largest possible score
    before the device-to-host copy."""
    return scores[:, :d_pad].to(dtype)


def _topk_scores_ref(
    scores: torch.Tensor, cut: torch.Tensor, kk: int, d: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-side threshold + top-k: returns (vals int32 [Q, kk], idx int32
    [Q, kk], n_keep int32 [Q]).

    ``cut`` is the per-query integer threshold (int32 [Q], computed on the
    host in float64 by _int_cut so boundary hits match the full-matrix path
    exactly). Docs with score >= cut survive; the rest come back as val 0 /
    idx 0, and n_keep bounds the real count. When n_keep[q] > kk the caller
    re-scores that query on the dense path.

    The window's order is defined: (score descending, doc ascending), the
    first kk columns of a stable descending sort, which is the order
    ``jax.lax.top_k`` gives (the lower index first among equal values). So
    the window, and the flat hit buffer packed from it, equal the JAX
    package's bit for bit."""
    s = scores[:, :d]
    ok = s >= cut[:, None]
    masked = torch.where(ok, s, torch.full_like(s, -1))
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :kk], idx[:, :kk]
    n_keep = ok.sum(dim=1, dtype=torch.int32)
    keep = vals >= 0
    zero = torch.zeros_like(vals)
    return (
        torch.where(keep, vals, zero).to(torch.int32),
        torch.where(keep, idx, torch.zeros_like(idx)).to(torch.int32),
        n_keep,
    )


def _rows_from_hashes(
    hi: torch.Tensor, lo: torch.Tensor, s: int
) -> torch.Tensor:
    """Bloom row ``(hi * 2**32 + lo) % s`` elementwise in int64.

    ``hi`` and ``lo`` are the XXH64 hash's halves, int64 values below 2**32.
    Every term of ``((hi % s) * (2**32 % s) + lo % s) % s`` stays below 2**62
    for s < 2**31, so the result is exact for every hash, including those
    >= 2**63 that a reinterpretation of the uint64 as int64 would get wrong
    (the JAX package's ``_rows_from_hashes_dev`` unrolls the same modulo in
    uint32 steps)."""
    return ((hi % s) * ((1 << 32) % s) + lo % s) % s


def _hash_rows_ref(
    hi: torch.Tensor, lo: torch.Tensor, nk: torch.Tensor, s: int, pad_row: int
) -> torch.Tensor:
    """int32 [Q, K, H] Bloom rows; slots at or past a query's k-mer count
    get the padding row."""
    rows = _rows_from_hashes(hi, lo, s)
    col = torch.arange(hi.shape[1], device=hi.device)
    valid = col[None, :, None] < nk[:, None, None]
    return torch.where(valid, rows, torch.full_like(rows, pad_row)).to(torch.int32)


def _pack_hits_ref(
    vals: torch.Tensor, idx: torch.Tensor, n_keep: torch.Tensor, kk: int, cap: int
) -> torch.Tensor:
    """The flat hit buffer int32 [cap hits | Q n_keep | total] from a top-k
    window: each query's take = min(n_keep, kk) (score << 16 | doc) words,
    the queries one after another; total = the sum of the takes.

    Every value fits int32 (score <= K <= 512 < 2**15, doc < 2**16); the
    host views the buffer as uint32. Words at positions >= cap are dropped:
    they are routed to one scratch slot past the returned buffer, inside
    the allocation, so nothing is written out of range and the scatter
    needs no device-to-host sync."""
    q = n_keep.shape[0]
    dev = n_keep.device
    take = torch.clamp(n_keep, max=kk).to(torch.int64)
    off = torch.cumsum(take, 0) - take
    colk = torch.arange(kk, device=dev)
    pos = off[:, None] + colk[None, :]
    valid = (colk[None, :] < take[:, None]) & (pos < cap)
    scratch = cap + q + 1
    out = torch.zeros(scratch + 1, dtype=torch.int32, device=dev)
    packed = (vals << 16) | idx
    out.index_put_((torch.where(valid, pos, scratch).reshape(-1),), packed.reshape(-1))
    out[cap : cap + q] = n_keep
    out[cap + q] = take.sum().to(torch.int32)
    return out[:scratch]


# --- kernel B5, the match epilogue (csrc/match_epilogue.cu) -------------------

_launches = _kernels.LaunchCounts("hash_rows", "threshold_topk", "pack_hits", "merge_topk")


def launch_counts() -> dict[str, int]:
    """B5's kernel launches since the last reset, by kernel name."""
    return _launches.snapshot()


def reset_launch_counts() -> None:
    _launches.reset()


def _on_one_cuda_device(what: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{what} runs on CUDA tensors on one device; got "
            f"{[str(t.device) for t in tensors]}"
        )
    return dev


def hash_rows_cuda(
    hi: torch.Tensor, lo: torch.Tensor, nk: torch.Tensor, s: int, pad_row: int
) -> torch.Tensor:
    """Kernel B5a (replaces ``_rows_from_hashes_dev`` and the padding-row
    mask of ``phylign_tpu/models/matcher.py:_hash_topk``). CUDA tensors
    only; same contract as _hash_rows_ref for hash halves below 2**32."""
    dev = _on_one_cuda_device("hash_rows", hi, lo, nk)
    if (hi.dtype, lo.dtype, nk.dtype) != (torch.int64, torch.int64, torch.int32):
        raise TypeError(f"hash_rows takes int64 hi, lo and int32 nk; got {hi.dtype}, {lo.dtype}, {nk.dtype}")
    if hi.dim() != 3 or lo.shape != hi.shape or nk.shape != hi.shape[:1]:
        raise ValueError(
            f"hash_rows: hi and lo must be [Q, K, H] and nk [Q]; got "
            f"{tuple(hi.shape)}, {tuple(lo.shape)}, {tuple(nk.shape)}"
        )
    if not (hi.is_contiguous() and lo.is_contiguous() and nk.is_contiguous()):
        raise ValueError("hash_rows takes contiguous tensors")
    if not 0 < s < 1 << 31 or not -(1 << 31) <= pad_row < 1 << 31:
        raise ValueError(f"hash_rows: s = {s} outside 1..2**31-1 or pad_row {pad_row} outside int32")
    q, k, h = hi.shape
    rows = torch.empty((q, k, h), dtype=torch.int32, device=dev)
    if rows.numel():
        _kernels.launch(
            _launches, "hash_rows", "match_epilogue", "phylign_hash_rows",
            hi, lo, nk, q, k, h, int(s), int(pad_row), rows,
        )
    return rows


def topk_scores_cuda(
    scores: torch.Tensor, cut: torch.Tensor, kk: int, d: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B5b (replaces ``phylign_tpu/models/matcher.py:_topk_scores``).
    CUDA tensors only; same contract and order as _topk_scores_ref for
    scores >= 0, at any kk <= d (a window past 512 keeps its stash in a
    device workspace). The kernel reads each row in 16-byte loads, so the
    rows must start 16-byte aligned, a multiple of 4 words apart, and hold
    d rounded up to 4 columns: the [Q, 32 Wp] matrices B1/B2 write."""
    dev = _on_one_cuda_device("threshold_topk", scores, cut)
    if (scores.dtype, cut.dtype) != (torch.int32, torch.int32):
        raise TypeError(f"threshold_topk takes int32 scores and cut; got {scores.dtype}, {cut.dtype}")
    if scores.dim() != 2 or cut.shape != scores.shape[:1] or not cut.is_contiguous():
        raise ValueError(
            f"threshold_topk: scores must be [Q, W] and cut a contiguous [Q]; got "
            f"{tuple(scores.shape)}, {tuple(cut.shape)}"
        )
    q, w = scores.shape
    if not 0 <= kk <= d <= w:
        raise ValueError(f"threshold_topk needs 0 <= kk <= d <= W; got kk={kk}, d={d}, W={w}")
    if not (
        scores.stride(1) == 1 and scores.stride(0) % 4 == 0 and w >= round_up(d, 4)
        and scores.data_ptr() % 16 == 0
    ):
        raise ValueError(
            "threshold_topk takes rows that start 16-byte aligned, a multiple of 4 "
            f"words apart, of at least d rounded up to 4 columns; got strides "
            f"{scores.stride()}, W={w}, d={d}"
        )
    vals = torch.empty((q, kk), dtype=torch.int32, device=dev)
    idx = torch.empty((q, kk), dtype=torch.int32, device=dev)
    n_keep = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        ws_bytes = _kernels.library("match_epilogue").phylign_threshold_topk_workspace(q, kk)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
        _kernels.launch(
            _launches, "threshold_topk", "match_epilogue", "phylign_threshold_topk",
            scores, scores.stride(0), cut, q, d, kk, ws, vals, idx, n_keep,
        )
    return vals, idx, n_keep


def pack_hits_cuda(
    vals: torch.Tensor, idx: torch.Tensor, n_keep: torch.Tensor, kk: int, cap: int
) -> torch.Tensor:
    """Kernel B5c (replaces the flat packing of ``phylign_tpu/models/
    matcher.py:_hash_topk_flat``). CUDA tensors only; same contract as
    _pack_hits_ref."""
    dev = _on_one_cuda_device("pack_hits", vals, idx, n_keep)
    if (vals.dtype, idx.dtype, n_keep.dtype) != (torch.int32,) * 3:
        raise TypeError(f"pack_hits takes int32 tensors; got {vals.dtype}, {idx.dtype}, {n_keep.dtype}")
    q = n_keep.shape[0]
    if n_keep.dim() != 1 or vals.shape != (q, kk) or idx.shape != (q, kk):
        raise ValueError(
            f"pack_hits: vals and idx must be [Q, kk] = [{q}, {kk}] and n_keep [Q]; got "
            f"{tuple(vals.shape)}, {tuple(idx.shape)}, {tuple(n_keep.shape)}"
        )
    if not (vals.is_contiguous() and idx.is_contiguous() and n_keep.is_contiguous()):
        raise ValueError("pack_hits takes contiguous tensors")
    if cap < 0:
        raise ValueError(f"pack_hits: cap = {cap} < 0")
    out = torch.empty(cap + q + 1, dtype=torch.int32, device=dev)
    _kernels.launch(
        _launches, "pack_hits", "match_epilogue", "phylign_pack_hits",
        vals, idx, n_keep, q, kk, cap, out,
    )
    return out


def _merge_topk_ref(
    windows: list, lims: list[int], w_loc: int, kk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The global top-kk window of nd doc shards' windows: ``windows[e]``
    = (vals int32 [Q, W_e], idx int32 [Q, W_e], n_keep int32 [Q] or None
    for a shard where nothing qualifies), each row's first min(n_keep,
    lims[e]) entries taken, sorted (score desc, local doc asc) as B5b
    leaves them; shard e's local doc j is global doc j + e * w_loc.

    Returns (vals int32 [Q, kk], global doc ids int32 [Q, kk], n_keep
    int32 [Q], the sum of the shards' counts): the taken entries in the
    order (score desc, global doc asc), a stable descending sort of their
    concatenation in shard order, which is jax.lax.top_k's over the gather;
    -1 and doc -1 past them."""
    v0 = windows[0][0]
    q, dev = v0.shape[0], v0.device
    n_sum = torch.zeros(q, dtype=torch.int32, device=dev)
    vs, ids = [], []
    for e, ((v, i, n), lim) in enumerate(zip(windows, lims)):
        if n is None:
            continue
        n_sum = n_sum + n
        ok = torch.arange(lim, device=dev)[None, :] < torch.clamp(n, 0, lim)[:, None]
        vs.append(torch.where(ok, v[:, :lim], -1))
        ids.append(torch.where(ok, i[:, :lim] + e * w_loc, -1))
    filler = torch.full((q, kk), -1, dtype=torch.int32, device=dev)  # kk columns at least
    vals, order = torch.sort(torch.cat([*vs, filler], dim=1), dim=1, descending=True, stable=True)
    vals = vals[:, :kk]
    idx = torch.cat([*ids, filler], dim=1).gather(1, order[:, :kk])
    return vals.to(torch.int32), torch.where(vals >= 0, idx, -1).to(torch.int32), n_sum


#: the most doc shards kernel B5d merges (its table of windows is a kernel
#: argument)
MERGE_MAX_SHARDS = 16


def merge_topk_cuda(
    windows: list, lims: list[int], w_loc: int, kk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B5d (replaces the second ``jax.lax.top_k`` of
    ``phylign_tpu/parallel/dist.py:dist_topk``). CUDA tensors on one device
    only; same contract as _merge_topk_ref for up to MERGE_MAX_SHARDS
    windows, each a contiguous [Q, W_e] pair. A warp a query row, blocks
    of up to 8 (fewer where Q leaves an SM of the card without a block); at
    2 shards ranks from each row's first entries or by merge path, at more
    by binary searches; each row written in 16-byte stores."""
    nd = len(windows)
    tensors = [t for w in windows for t in w if t is not None]
    dev = _on_one_cuda_device("merge_topk", *tensors)
    if not 1 <= nd <= MERGE_MAX_SHARDS or len(lims) != nd:
        raise ValueError(f"merge_topk takes 1 to {MERGE_MAX_SHARDS} windows with a limit each; got {nd}")
    q = windows[0][0].shape[0]
    for (v, i, n), lim in zip(windows, lims):
        if v.dtype != torch.int32 or i.dtype != torch.int32 or (n is not None and n.dtype != torch.int32):
            raise TypeError("merge_topk takes int32 windows and counts")
        if v.dim() != 2 or v.shape[0] != q or i.shape != v.shape or not 0 <= lim <= v.shape[1]:
            raise ValueError(
                f"merge_topk: a window must be [Q={q}, W >= limit {lim}] twice; got "
                f"{tuple(v.shape)}, {tuple(i.shape)}"
            )
        if not (v.is_contiguous() and i.is_contiguous()) or (n is not None and (n.shape != (q,) or not n.is_contiguous())):
            raise ValueError("merge_topk takes contiguous windows and [Q] counts")
    if not 0 <= kk or not 0 <= w_loc < 1 << 31:
        raise ValueError(f"merge_topk: kk = {kk}, w_loc = {w_loc}")

    def table(ctype, xs):
        return (ctype * nd)(*xs)

    ptr = lambda t: None if t is None or t.numel() == 0 else t.data_ptr()  # noqa: E731
    vals = torch.empty((q, kk), dtype=torch.int32, device=dev)
    idx = torch.empty((q, kk), dtype=torch.int32, device=dev)
    n_keep = torch.empty(q, dtype=torch.int32, device=dev)
    if q:
        _kernels.launch(
            _launches, "merge_topk", "match_epilogue", "phylign_merge_topk",
            nd, table(ctypes.c_void_p, [ptr(w[0]) for w in windows]),
            table(ctypes.c_void_p, [ptr(w[1]) for w in windows]),
            table(ctypes.c_void_p, [ptr(w[2]) for w in windows]),
            table(ctypes.c_int, [w[0].shape[1] for w in windows]), table(ctypes.c_int, lims),
            int(w_loc), q, kk, vals, idx, n_keep,
        )
    return vals, idx, n_keep


def _by_device(t: torch.Tensor, plain, kernel, *args):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor;
    any other device raises."""
    if t.device.type == "cpu":
        return plain(*args)
    if t.device.type != "cuda":
        raise ValueError(f"no match epilogue kernel for device {t.device}")
    return kernel(*args)


def _hash_rows(
    hi: torch.Tensor, lo: torch.Tensor, nk: torch.Tensor, s: int, pad_row: int
) -> torch.Tensor:
    """_hash_rows_ref on a CPU tensor, kernel B5a on a CUDA tensor."""
    return _by_device(hi, _hash_rows_ref, hash_rows_cuda, hi, lo, nk, s, pad_row)


def _topk_scores(
    scores: torch.Tensor, cut: torch.Tensor, kk: int, d: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """_topk_scores_ref on a CPU tensor, kernel B5b on a CUDA tensor: the
    one dispatch point of every threshold + top-k of the matcher."""
    return _by_device(scores, _topk_scores_ref, topk_scores_cuda, scores, cut, kk, d)


def _pack_hits(
    vals: torch.Tensor, idx: torch.Tensor, n_keep: torch.Tensor, kk: int, cap: int
) -> torch.Tensor:
    """_pack_hits_ref on a CPU tensor, kernel B5c on a CUDA tensor."""
    return _by_device(n_keep, _pack_hits_ref, pack_hits_cuda, vals, idx, n_keep, kk, cap)


def _merge_topk(
    windows: list, lims: list[int], w_loc: int, kk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """_merge_topk_ref on CPU tensors, kernel B5d on CUDA tensors."""
    return _by_device(windows[0][0], _merge_topk_ref, merge_topk_cuda, windows, lims, w_loc, kk)


def _hash_topk(
    words: torch.Tensor,
    hi: torch.Tensor,
    lo: torch.Tensor,
    nk: torch.Tensor,
    cut: torch.Tensor,
    *,
    s: int,
    pad_row: int,
    kk: int,
    d: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash -> row (B5a), gather/popcount (B1/B2), threshold + top-k (B5b)
    over device-resident raw query hashes: per batch only the [Q] cut
    vector and the hit window cross the link."""
    rows = _hash_rows(hi, lo, nk, s, pad_row)
    scores = match_scores(words, rows)
    return _topk_scores(scores, cut, kk, d)


def _hash_topk_flat(
    words: torch.Tensor,
    hi: torch.Tensor,
    lo: torch.Tensor,
    nk: torch.Tensor,
    cut: torch.Tensor,
    *,
    s: int,
    pad_row: int,
    kk: int,
    d: int,
    cap: int,
) -> torch.Tensor:
    """_hash_topk with the hit window compacted on the device (B5c):
    qualifying (score << 16 | doc) pairs pack into one flat buffer of the
    queries' take counts (take = min(n_keep, kk)). Returns ONE int32 tensor
    [cap hits | Q n_keep | total] so the fetch is a single copy; total >
    cap signals overflow (the caller refetches the dense window). On the
    card: four kernels, B5a, B1/B2, B5b, B5c."""
    vals, idx, n_keep = _hash_topk(
        words, hi, lo, nk, cut, s=s, pad_row=pad_row, kk=kk, d=d
    )
    return _pack_hits(vals, idx, n_keep, kk, cap)


@dataclass
class DeviceQueryHashes:
    """One query chunk's raw k-mer hashes, resident on the device.

    Uploaded ONCE per read set (kmer.cobs_kmer_hashes output split into
    halves) and reused by every batch's Matcher; the per-batch
    ``% signature_size`` runs on the device inside _hash_topk. ``raw`` keeps
    the host copy for the fallback paths (segmented queries, huge doc
    counts, top-k window overflow re-fetch)."""

    hi: torch.Tensor  # int64 [Q_pad, K, H], values < 2**32
    lo: torch.Tensor  # int64 [Q_pad, K, H], values < 2**32
    n_kmers: np.ndarray  # int32 [Q_pad] host (padding rows = 0)
    raw: list[np.ndarray]  # per-query uint64 [n, H] host (REAL queries only)
    q_real: int = -1  # real query count (<= Q_pad); results slice to this
    # device twins, uploaded once per chunk: nk is constant, and the
    # integer cut vector depends only on (nk, threshold), not on the batch
    _nk_dev: torch.Tensor | None = None
    _cut_dev: dict | None = None
    # the chunk's copies on a mesh's other devices (``on``), by device
    _copies: dict | None = None

    @property
    def device(self) -> torch.device:
        return self.hi.device

    def on(self, device: torch.device) -> "DeviceQueryHashes":
        """This chunk on ``device``: itself there, else its copy, made at
        the first call (the hash halves copied from this device) and kept
        with the chunk, so a mesh's cards receive a job's query hashes once
        and no query bytes a batch."""
        if device == self.device:
            return self
        if self._copies is None:
            self._copies = {}
        twin = self._copies.get(device)
        if twin is None:
            twin = self._copies[device] = DeviceQueryHashes(
                hi=self.hi.to(device), lo=self.lo.to(device), n_kmers=self.n_kmers,
                raw=self.raw, q_real=self.q_real,
            )
        return twin

    def nk_dev(self) -> torch.Tensor:
        if self._nk_dev is None:
            self._nk_dev = _to_device(self.n_kmers, self.device)
        return self._nk_dev

    def cut_dev(self, threshold: float) -> torch.Tensor:
        if self._cut_dev is None:
            self._cut_dev = {}
        hit = self._cut_dev.get(threshold)
        if hit is None:
            hit = _to_device(_int_cut(threshold, self.n_kmers), self.device)
            self._cut_dev[threshold] = hit
        return hit

    @classmethod
    def build(
        cls,
        raw: list[np.ndarray],
        device: str | torch.device = "cuda",
        k_bucket: int = 64,
        q_bucket: int = 1024,
    ) -> "DeviceQueryHashes":
        """``k_bucket`` pads the k-mer axis (a multiple of 32 keeps every
        hash-path call on kernel B2 for 1-hash indexes); ``q_bucket`` pads
        the query axis so read sets of similar size share layouts. Padding
        rows carry nk=0, whose _int_cut is unreachable: they never emit
        hits, and callers slice results back to q_real."""
        q_real = len(raw)
        qp = round_up(max(1, q_real), q_bucket)
        nk = np.zeros(qp, np.int32)
        nk[:q_real] = [r.shape[0] for r in raw]
        h = raw[0].shape[1] if raw else 1
        kp = round_up(int(nk.max(initial=1)), k_bucket)
        hi = np.zeros((qp, kp, h), np.int64)
        lo = np.zeros((qp, kp, h), np.int64)
        if raw:
            # one concatenate + one 2-D scatter (a python loop over tens of
            # thousands of reads costs ~0.3 s per query set)
            cat = np.concatenate(raw)
            lens = nk.astype(np.int64)  # padded rows repeat 0 times
            rows = np.repeat(np.arange(qp), lens)
            cols = np.arange(len(cat)) - np.repeat(np.cumsum(lens) - lens, lens)
            hi[rows, cols] = (cat >> np.uint64(32)).astype(np.int64)
            lo[rows, cols] = (cat & np.uint64(0xFFFFFFFF)).astype(np.int64)
        dev = torch.device(device)
        return cls(
            hi=_to_device(hi, dev), lo=_to_device(lo, dev), n_kmers=nk,
            raw=raw, q_real=q_real,
        )

    @property
    def nbytes(self) -> int:
        """Device bytes of the two hash halves (int64 here; the JAX
        package's uint32 halves take half as many)."""
        return int(self.hi.numel() + self.lo.numel()) * self.hi.element_size()


def _int_cut(threshold: float, n_kmers: np.ndarray) -> np.ndarray:
    """Smallest integer score satisfying ``score >= threshold * n`` in
    float64 (the host/reference comparison), per query. Queries with no
    k-mers get an impossible cut so they can never match."""
    t = np.float64(threshold) * n_kmers.astype(np.float64)
    cut = np.ceil(t).astype(np.int64)
    # ceil gives the right integer except when t is itself integral (ceil
    # keeps it) — i.e. cut >= t by construction; but guard float error:
    cut = np.where(cut.astype(np.float64) < t, cut + 1, cut)
    cut = np.where(n_kmers > 0, np.maximum(cut, 0), np.int64(1 << 30))
    return cut.astype(np.int32)


def match_step(
    words: torch.Tensor,
    row_idx: torch.Tensor,
    n_kmers: torch.Tensor,
    threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One scoring step: scores [Q, 32*Wp] int32 and keep mask [Q, 32*Wp].

    keep[q, d] = score >= threshold * n_kmers[q]  (cobs -t semantics, the
    reference's config.yaml:20), and never for a query without k-mers.
    Callers slice [:, :num_docs]. On a CUDA tensor one launch of the keep
    instance of B1/B2 computes both; on a CPU one match_scores_keep_ref. The
    test is the JAX package's float32 one (``f32(score) >= f32(threshold) *
    f32(n)``), not the pipeline's float64 _int_cut: the two can differ at a
    score on the cut."""
    return _by_device(
        words, match_scores_keep_ref, match_scores_keep, words, row_idx, n_kmers, threshold
    )


@dataclass(frozen=True)
class DocShards:
    """A batch's word columns dealt over a mesh's doc shards: shard e holds
    ``width`` words, the ``words[e]`` real words from word ``starts[e]`` of
    the batch and then zeros. The real counts differ by at most one, so
    every shard holds documents while the batch has a word for each, and
    the padding is under one word a shard (none at 68 words over 2 or 4
    shards, 17 words a card at 4). Kernels B2 and B5b take any width, so
    no lane is kept: the JAX layout's 8-word lanes would leave the fourth
    of four cards only padding at 68 words."""

    width: int
    words: tuple[int, ...]

    @classmethod
    def of(cls, num_words: int, nd: int) -> "DocShards":
        base, extra = divmod(max(num_words, 1), nd)
        return cls(base + (extra > 0), tuple(base + (e < extra) for e in range(nd)))

    @property
    def starts(self) -> tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum((0,) + self.words[:-1]))

    @property
    def padding_words(self) -> int:
        """Zero words a row over all the shards."""
        return len(self.words) * self.width - sum(self.words)

    def docs(self, d: int) -> list[int]:
        """Each shard's documents of the batch's ``d``: its leading columns."""
        return [min(max(d - 32 * s, 0), 32 * n) for s, n in zip(self.starts, self.words)]

    def columns(self, d: int) -> np.ndarray | None:
        """The padded matrix's column of each of the ``d`` documents, or
        None where they are its first d columns."""
        cols = np.concatenate(
            [np.arange(n) + 32 * self.width * e for e, n in enumerate(self.docs(d))]
        )
        return None if np.array_equal(cols, np.arange(d)) else cols


def device_index_bytes(didx: DeviceIndex, mesh=None) -> int:
    """Exact device footprint of the word matrix an index occupies once
    uploaded, summed over a mesh's doc shards: from_device_index keeps the
    exact word width (on a mesh DocShards' width a shard) and adds one zero
    row. The pipeline's HBM accountant admits uploads by it."""
    wp = max(didx.num_words, 1)
    if mesh is not None:
        wp = mesh.nd * DocShards.of(wp, mesh.nd).width
    return (didx.signature_size + 1) * wp * 4


def upload_words(
    words: np.ndarray, device: str | torch.device, cols: tuple[int, int] | None = None,
    width: int | None = None,
) -> torch.Tensor:
    """uint32 [S, W] host words (array or read-only memmap) -> int32
    [S+1, max(W, 1)] on ``device`` with a zero padding row; with ``cols``
    = (c0, c1) only word columns [c0, c1), those past W zero, in a block
    ``width`` words wide (c1 - c0 by default) whose further columns are
    zero (a doc shard's block of a mesh's matrix). For CUDA the words are
    copied once into a pinned host tensor and sent with a non-blocking
    copy; a memmap is only read."""
    dev = torch.device(device)
    s, w = words.shape
    c0, c1 = (0, max(w, 1)) if cols is None else cols
    n = max(0, min(w, c1) - c0)
    pin = dev.type == "cuda"
    with trace.span("match.upload.pin"):
        host = torch.empty((s + 1, c1 - c0 if width is None else width), dtype=torch.int32, pin_memory=pin)
    trace.count("match.pinned_allocs", int(pin))
    trace.count("match.upload_bytes", host.nbytes)
    with trace.span("match.upload.stage"):
        h = host.numpy()
        h[:s, :n] = np.asarray(words)[:, c0 : c0 + n].view(np.int32)
        h[s] = 0
        h[:s, n:] = 0
    return host.to(dev, non_blocking=True) if pin else host


@dataclass
class _HashDispatch:
    """A dispatched hash-path scoring (Matcher.score_hits_hashes_begin):
    the flat hit buffer's pinned host copy in flight, and what assembling
    it needs."""

    dq: DeviceQueryHashes
    host: torch.Tensor
    event: "torch.cuda.Event | None"
    threshold: float
    topn: int
    k_max: int
    kk: int
    cap: int

    def fetch(self) -> np.ndarray:
        """Wait for the copy; the buffer as uint32 [cap + Q + 1]."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().view(np.uint32)


@dataclass
class Matcher:
    """Device-resident match model for one batch index.

    With a mesh the word columns are split over the mesh's doc axis
    (``words`` is then a ``parallel.dist.Sharded``) and scoring runs
    through parallel.dist with zero communication; row indices are split
    over the query axis."""

    term_size: int
    num_hashes: int
    signature_size: int
    doc_names: list[str]
    words: torch.Tensor  # int32 [S+1, Wp] on the device; on a mesh a parallel.dist.Sharded
    #: cross-query k-mer dedup (two-stage gather, ops.match.dedup_rows).
    #: Opt-in (config match_dedup); scores are identical either way.
    dedup: bool = False
    mesh: object | None = None  # parallel.mesh.Mesh or None
    shards: DocShards | None = None  # the word columns' split over the mesh's doc axis

    @property
    def device(self) -> torch.device:
        return self.mesh.home if self.mesh is not None else self.words.device

    def _device_scores(self, packed: np.ndarray) -> torch.Tensor:
        """Score one packed chunk, via the dedup path when enabled+profitable."""
        if self.dedup:
            dd = dedup_rows(packed, self.pad_row, self.words.shape[1])
            if dd is not None:
                return match_scores_dedup(
                    self.words,
                    _to_device(dd[0], self.device),
                    _to_device(dd[1], self.device),
                )
        return match_scores(self.words, _to_device(packed, self.device))

    @classmethod
    def from_device_index(
        cls, didx: DeviceIndex, device: str | torch.device = "cuda", mesh=None
    ) -> "Matcher":
        """Upload ``didx``'s words to ``device``, or with a mesh each doc
        shard's contiguous column slice to its cells (a process of a mesh
        that spans processes uploads only its own shards)."""
        shards = None
        if mesh is None:
            words = upload_words(didx.words, device)
        else:
            from phylign_tpu_torch.parallel.dist import shard_blocks

            shards = DocShards.of(didx.num_words, mesh.nd)

            def upload_shard(sl, dev):
                e = sl[1].start // shards.width
                c0 = shards.starts[e]
                trace.count("match.mesh_shards")
                trace.count("match.mesh_padding_words", shards.width - shards.words[e])
                with trace.span("match.mesh.upload"):
                    return upload_words(didx.words, dev, (c0, c0 + shards.words[e]), shards.width)

            words = shard_blocks(
                mesh, (didx.signature_size + 1, mesh.nd * shards.width), (None, AXIS_DOC), upload_shard
            )
        return cls(
            term_size=didx.term_size,
            num_hashes=didx.num_hashes,
            signature_size=didx.signature_size,
            doc_names=didx.doc_names,
            words=words,
            mesh=mesh,
            shards=shards,
        )

    @property
    def pad_row(self) -> int:
        return self.words.shape[0] - 1

    def rows_for_queries(
        self, seqs: list[bytes], k_max: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side k-mer extraction + hashing for a query batch: int32
        [Q, k_max, H] Bloom rows (the padding row past each query's k-mers)
        and int32 [Q] k-mer counts."""
        per_query = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return pack_row_indices(per_query, k_max, self.pad_row, self.num_hashes)

    def score(
        self, seqs: list[bytes], threshold: float, k_max: int = 512
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Convenience host API: returns (scores[Q, D], keep[Q, D], n_kmers[Q]).

        Queries longer than k_max+term_size-1 are split into k_max-k-mer
        segments scored as separate device rows and summed — exact for any
        query length with fixed device shapes.
        """
        per_query = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return self.score_rows(per_query, threshold, k_max)

    def score_rows(
        self, per_query: list[np.ndarray], threshold: float, k_max: int = 512
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """score() on pre-extracted per-query row-index arrays."""
        n_kmers = np.array([r.shape[0] for r in per_query], np.int32)
        seg_rows: list[np.ndarray] = []
        owner: list[int] = []
        for qi, r in enumerate(per_query):
            if r.shape[0] == 0:
                continue
            for off in range(0, r.shape[0], k_max):
                seg_rows.append(r[off : off + k_max])
                owner.append(qi)
        d = len(self.doc_names)
        scores = np.zeros((len(per_query), d), np.int32)
        if seg_rows:
            n_real = len(seg_rows)
            if self.mesh is not None:
                # the segment count must split over the query axis: pad
                # with empty (all-padding-row) segments
                nq = self.mesh.shape["q"]
                seg_rows += [np.empty((0, self.num_hashes), np.int64)] * ((-n_real) % nq)
            # bucket the packed k-mer axis to multiples of 64
            k_pack = min(k_max, round_up(max(r.shape[0] for r in seg_rows), 64))
            packed, _ = pack_row_indices(
                seg_rows, k_pack, self.pad_row, self.num_hashes
            )
            if self.mesh is not None:
                from phylign_tpu_torch.parallel.dist import dist_match_scores, fetch

                seg_scores = fetch(dist_match_scores(self.mesh, self.words, packed))
                cols = self.shards.columns(d)
                if cols is not None:  # the padded matrix's columns -> documents
                    seg_scores = seg_scores[:, cols]
            else:
                dev_scores = self._device_scores(packed)
                max_score = k_pack  # per-segment count <= valid k-mer slots
                dtype = (
                    torch.uint8
                    if max_score <= 255
                    else torch.int16 if max_score <= 32767 else torch.int32
                )
                d_pad = min(dev_scores.shape[1], round_up(d, 256))
                seg_scores = _compact_scores(dev_scores, d_pad, dtype).cpu().numpy()
            np.add.at(scores, np.asarray(owner), seg_scores[:n_real, :d].astype(np.int32))
        keep = (scores >= threshold * np.maximum(n_kmers, 1)[:, None]) & (
            n_kmers[:, None] > 0
        )
        return scores, keep, n_kmers

    def score_hits(
        self, seqs: list[bytes], threshold: float, topn: int, k_max: int = 512
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Per-query hits [(doc_idx, score)] with score >= threshold*n_kmers,
        plus n_keep [Q] (the full qualifying count).

        Device-side threshold + top-k, fetching only a kk-entry window per
        query; a query re-scores on the full-matrix path when its
        qualifying set overflows the window (n_keep > kk). Queries with
        identical k-mer row multisets (duplicate reads, reverse-complement
        duplicates) are scored once. Segmented (> k_max k-mer) queries use
        the full path."""
        all_rows = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return self._score_hits_rows(all_rows, threshold, topn, k_max)

    def score_hits_raw(
        self,
        raw_hashes: list[np.ndarray],
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """score_hits on precomputed RAW k-mer hashes (kmer.cobs_kmer_hashes):
        a Bloom row is hash % signature_size, so callers scoring the same
        reads against MANY batch indexes hash once and re-mod per batch."""
        all_rows = [rows_from_hashes(r, self.signature_size) for r in raw_hashes]
        return self._score_hits_rows(all_rows, threshold, topn, k_max)

    def _score_hits_rows(
        self,
        all_rows: list[np.ndarray],
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        rep_of, per_query = _dedup_row_sets(all_rows)
        if len(per_query) < len(all_rows):
            hits_u, n_keep_u = self.score_hits_unique(
                per_query, threshold, topn, k_max
            )
            hits = [hits_u[j] for j in rep_of]
            return hits, np.asarray([n_keep_u[j] for j in rep_of], np.int32)
        return self.score_hits_unique(per_query, threshold, topn, k_max)

    def score_hits_unique(
        self,
        per_query: list[np.ndarray],
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """score_hits on pre-extracted per-query row-index arrays."""
        d = len(self.doc_names)
        n_kmers = np.array([r.shape[0] for r in per_query], np.int32)
        segmented = any(r.shape[0] > k_max for r in per_query)
        if d == 0 or d > 65535 or segmented:
            scores, keep, _ = self.score_rows(per_query, threshold, k_max)
            return _hits_from_full(scores, keep), keep.sum(axis=1).astype(np.int32)

        kk = min(d, round_up(min(topn + 33, d), 32))
        k_pack = round_up(max((r.shape[0] for r in per_query), default=1), 64)
        if self.mesh is not None:
            vals, idx, n_keep = self._mesh_topk(
                per_query, n_kmers, threshold, kk, d, k_pack
            )
        else:
            packed, _ = pack_row_indices(
                per_query, max(k_pack, 1), self.pad_row, self.num_hashes
            )
            dev_scores = self._device_scores(packed)
            cut = _to_device(_int_cut(threshold, n_kmers), self.device)
            vals, idx, n_keep = (
                t.cpu().numpy() for t in _topk_scores(dev_scores, cut, kk, d)
            )
        return self._window_hits(
            vals, idx, n_keep, lambda q: per_query[q], threshold, k_max, kk
        )

    def _mesh_topk(
        self,
        per_query: list[np.ndarray],
        n_kmers: np.ndarray,
        threshold: float,
        kk: int,
        d: int,
        k_pack: int,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Mesh path: sharded scoring + threshold + distributed top-k (a
        local top-k per doc shard, a gather over "d", the re-top-k), so
        only the [Q, kk] window leaves the devices; also on meshes that
        span processes. Queries pad to a multiple of the query axis with
        an unreachable cut. The window comes back as _topk_scores gives it
        (fillers 0) for _window_hits."""
        from phylign_tpu_torch.parallel.dist import dist_threshold_topk, fetch

        nq = self.mesh.shape["q"]
        rows = list(per_query)
        pad_q = (-len(rows)) % nq
        rows += [np.empty((0, self.num_hashes), np.int64)] * pad_q
        packed, _ = pack_row_indices(
            rows, max(k_pack, 1), self.pad_row, self.num_hashes
        )
        cut = np.concatenate(
            [_int_cut(threshold, n_kmers), np.full(pad_q, 1 << 30, np.int32)]
        )
        kk_eff = min(kk, 32 * self.words.shape[1])
        window = dist_threshold_topk(
            self.mesh, self.words, packed, cut, self.shards.docs(d), kk_eff
        )
        with trace.span("match.mesh.merge"):  # the merged window's fetch
            vals, ids, n_keep = fetch(window)
        q = len(n_kmers)
        vals, ids = vals[:q, :kk], ids[:q, :kk]
        keep = vals >= 0
        doc_of = self._doc_of(d)
        if doc_of is not None:
            ids = doc_of[np.maximum(ids, 0)].astype(ids.dtype)
        return (
            np.where(keep, vals, 0),
            np.where(keep, ids, 0),
            n_keep[:q],
        )

    def _doc_of(self, d: int) -> np.ndarray | None:
        """On a mesh whose padded matrix does not hold the ``d`` documents
        in its first columns (DocShards.columns), the document of each
        column (uint32, the columns past the documents 0); else None."""
        cols = None if self.shards is None else self.shards.columns(d)
        if cols is None:
            return None
        doc_of = np.zeros(32 * self.words.shape[1], np.uint32)
        doc_of[cols] = np.arange(d)
        return doc_of

    def _window_hits(
        self, vals, idx, n_keep, rows_of, threshold: float, k_max: int,
        kk: int, device_lock=None,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Assemble per-query hit lists from a fetched top-k window; queries
        whose qualifying set may overflow the window (n_keep > kk) re-score
        via the full-matrix path using ``rows_of(q)`` host row indices."""
        n_keep = np.array(n_keep)
        hits: list[list[tuple[int, int]]] = []
        redo: list[int] = []
        for q in range(len(n_keep)):
            m = int(n_keep[q])
            take = min(m, kk)
            if m > kk:
                # the window may have cut a tie run: re-fetch the full row
                redo.append(q)
                hits.append([])
                continue
            hits.append(
                [(int(idx[q, j]), int(vals[q, j])) for j in range(take)]
            )
        self._redo_overflow(
            hits, n_keep, redo, rows_of, threshold, k_max, device_lock
        )
        return hits, n_keep.astype(np.int32)

    def _redo_overflow(
        self, hits, n_keep, redo, rows_of, threshold: float, k_max: int,
        device_lock=None,
    ) -> None:
        """Re-score window-overflow queries via the full-matrix path.

        ``device_lock``: callers that fetch outside the pipeline's device
        lock (score_hits_hashes_end) pass it back in so this rare dense
        re-dispatch is serialized against other device work."""
        if not redo:
            return
        trace.count("match.redo_queries", len(redo))
        lock = device_lock if device_lock is not None else contextlib.nullcontext()
        with lock:
            scores, keep, _ = self.score_rows(
                [rows_of(q) for q in redo], threshold, k_max
            )
        for row, q in enumerate(redo):
            docs = np.nonzero(keep[row])[0]
            hits[q] = [(int(dd), int(scores[row, dd])) for dd in docs]
            hits[q].sort(key=lambda t: (-t[1], t[0]))
            n_keep[q] = len(hits[q])  # keep header count == emitted set

    def _window_hits_flat(
        self, flat, n_keep, rows_of, threshold: float, k_max: int, kk: int,
        device_lock=None, doc_of: np.ndarray | None = None,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """_window_hits over the device-compacted flat uint32 (score|doc)
        buffer (_hash_topk_flat): same hit lists, fewer fetched bytes.
        ``doc_of`` maps a mesh's padded-matrix columns to documents."""
        n_keep = np.array(n_keep)
        take = np.minimum(n_keep, kk)
        offs = np.cumsum(take) - take
        ids = flat & np.uint32(0xFFFF)
        ids = (ids if doc_of is None else doc_of[ids]).tolist()
        vals = (flat >> np.uint32(16)).tolist()
        # most queries have NO hits in a batch: share one empty list and
        # touch only hit rows (no consumer mutates a hit list in place)
        empty: list[tuple[int, int]] = []
        hits: list[list[tuple[int, int]]] = [empty] * len(n_keep)
        redo: list[int] = []
        offs_l, take_l = offs.tolist(), take.tolist()
        for q in np.flatnonzero(n_keep).tolist():
            if n_keep[q] > kk:
                redo.append(q)
                continue
            o, t = offs_l[q], take_l[q]
            hits[q] = list(zip(ids[o : o + t], vals[o : o + t]))
        self._redo_overflow(
            hits, n_keep, redo, rows_of, threshold, k_max, device_lock
        )
        return hits, n_keep.astype(np.int32)

    def score_hits_hashes_begin(
        self, dq: DeviceQueryHashes, threshold: float, topn: int,
        k_max: int = 512, cap: int | None = None,
    ) -> _HashDispatch | None:
        """Async half of score_hits_hashes: DISPATCH the device work and
        start the hit buffer's copy to pinned host memory; returns the
        dispatch (or None when this path does not apply — the caller then
        uses the synchronous score_hits_hashes). The pipeline dispatches
        under the device lock and fetches/assembles outside it.

        ``cap`` bounds the compacted hit buffer; scatter overflow past it
        falls back to the dense window fetch, so a too-small cap costs
        time, never correctness.

        On a mesh of one process the chunk runs on every device of the mesh
        (``DeviceQueryHashes.on``) through parallel.dist.dist_hash_topk_flat,
        and the buffer comes from the home device; a mesh that spans
        processes returns None (its ranks gather in batch order on the
        serial path)."""
        d = len(self.doc_names)
        mesh = self.mesh
        if (
            (mesh is not None and (
                mesh.group is not None
                or len(dq.n_kmers) % mesh.nq
                or 32 * self.words.shape[1] > 1 << 16  # a column id in 16 bits
            ))
            or self.dedup
            or d == 0
            or d > 65535
            or dq.hi.shape[1] > k_max
            or dq.hi.shape[2] != self.num_hashes
            or self.signature_size >= 1 << 31  # int64 row arithmetic bound
        ):
            return None
        kk = min(d, round_up(min(topn + 33, d), 32))
        q_real = dq.q_real if dq.q_real >= 0 else len(dq.n_kmers)
        full = q_real * min(kk, topn + 12)
        cap = full if cap is None else max(256, min(int(cap), full))
        if mesh is None:
            out_dev = _hash_topk_flat(
                self.words, dq.hi, dq.lo, dq.nk_dev(), dq.cut_dev(threshold),
                s=self.signature_size, pad_row=self.pad_row, kk=kk, d=d, cap=cap,
            )
        else:
            from phylign_tpu_torch.parallel.dist import dist_hash_topk_flat

            trace.count("match.mesh_hash_chunks")
            copies = {dev: dq.on(dev) for dev in mesh.devices}
            out_dev = dist_hash_topk_flat(
                mesh, self.words,
                {dev: (c.hi, c.lo, c.nk_dev(), c.cut_dev(threshold)) for dev, c in copies.items()},
                s=self.signature_size, pad_row=self.pad_row, d=self.shards.docs(d), kk=kk, cap=cap,
            )
        host, event = _copy_to_host_async(out_dev)
        return _HashDispatch(dq, host, event, threshold, topn, k_max, kk, cap)

    def score_hits_hashes_end(
        self, ctx: _HashDispatch, device_lock=None, fetched=None
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Fetch + assemble a score_hits_hashes_begin dispatch.

        Runs OUTSIDE the pipeline's device lock by design; the rare
        overflow fallbacks below dispatch device work, so they re-acquire
        ``device_lock`` when the caller provides it. ``fetched``: the
        buffer already fetched by the caller (ctx.fetch())."""
        dq, threshold, k_max, kk, cap = (
            ctx.dq, ctx.threshold, ctx.k_max, ctx.kk, ctx.cap
        )
        out = ctx.fetch() if fetched is None else fetched
        d = len(self.doc_names)
        rows_of = lambda q: rows_from_hashes(  # noqa: E731
            dq.raw[q], self.signature_size
        )
        q_real = dq.q_real if dq.q_real >= 0 else len(dq.n_kmers)
        flat = out[:cap]
        n_keep = out[cap : cap + len(dq.n_kmers)].astype(np.int32)
        total = out[-1]
        if int(total) <= cap:
            hits, nk = self._window_hits_flat(
                flat, n_keep, rows_of, threshold, k_max, kk,
                device_lock=device_lock, doc_of=self._doc_of(d),
            )
            return hits[:q_real], nk[:q_real]
        trace.count("match.cap_overflows")
        lock = device_lock if device_lock is not None else contextlib.nullcontext()
        with lock:
            if self.mesh is not None:  # the mesh's dense window
                per_query = [rows_of(q) for q in range(q_real)]
                k_pack = round_up(max((r.shape[0] for r in per_query), default=1), 64)
                vals, idx, n_keep = self._mesh_topk(
                    per_query, dq.n_kmers[:q_real], threshold, kk, d, k_pack
                )
            else:
                vals, idx, n_keep = (
                    t.cpu().numpy()
                    for t in _hash_topk(
                        self.words, dq.hi, dq.lo, dq.nk_dev(), dq.cut_dev(threshold),
                        s=self.signature_size, pad_row=self.pad_row, kk=kk, d=d,
                    )
                )
        hits, nk = self._window_hits(
            vals, idx, n_keep, rows_of, threshold, k_max, kk,
            device_lock=device_lock,
        )
        return hits[:q_real], nk[:q_real]

    def score_hits_hashes(
        self,
        dq: DeviceQueryHashes,
        threshold: float,
        topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """score_hits over DEVICE-RESIDENT raw hashes: the per-batch row
        computation (% signature_size) runs on the device, so scoring a read
        set against many batches uploads the queries once, not once per
        batch. Identical to score_hits_raw (tested); falls back to it for
        the dedup / segmented / huge-doc-count cases."""
        ctx = self.score_hits_hashes_begin(dq, threshold, topn, k_max)
        if ctx is None:
            return self.score_hits_raw(dq.raw, threshold, topn, k_max)
        return self.score_hits_hashes_end(ctx)


def _acc_chunk_scores(
    acc: torch.Tensor, words: torch.Tensor, row_idx: torch.Tensor, r0: int, r1: int
) -> torch.Tensor:
    """acc += the partial scores of the row block [r0, r1) that ``words``
    holds, in place; ``row_idx`` holds global rows and a row outside the
    block counts as a zero row (the JAX package remaps them to the block's
    zero row). The accumulating instance of B1/B2 on a CUDA tensor,
    match_scores_acc_ref_ on a CPU one."""
    return _by_device(
        acc, match_scores_acc_ref_, match_scores_acc_, acc, words, row_idx, r0, r1
    )


def _acc_chunk_planes(
    acc: torch.Tensor, words: torch.Tensor, row_idx: torch.Tensor, r0: int, r1: int,
    first: bool, last: bool,
) -> torch.Tensor:
    """One block of the row-chunked pass: _acc_chunk_scores with the
    pass's counts kept as bit planes in acc between its first and last
    blocks (match_scores_acc_planes_ref_). The accumulating instance's
    plane modes on a CUDA tensor, their plain version on a CPU one."""
    return _by_device(
        acc, match_scores_acc_planes_ref_, match_scores_acc_planes_,
        acc, words, row_idx, r0, r1, first, last,
    )


#: the row-chunked pass's pinned staging ring: STAGE_SLOTS slots of at most
#: STAGE_SLOT_BYTES, 1 GB of pinned host memory in all, reused by every
#: block (and by later passes, through torch's pinned-memory cache)
STAGE_SLOT_BYTES = 256 << 20
STAGE_SLOTS = 4
#: threads that copy a slot's rows out of ``words_host`` together
FILL_THREADS = 4


@dataclass
class ChunkedMatcher:
    """Row-chunked match model: scores an index LARGER than the device
    budget.

    The signature rows stream through the device in fixed blocks: the
    accumulating instance of the SAME kernels scores each block's rows
    (a query k-mer row outside the block counts as a zero row), and
    per-(query, doc) scores accumulate on the device across blocks, as
    bit planes in the accumulator's own bytes until the last block. On a
    card two device block buffers alternate: block i + 1's upload (through
    a bounded pinned staging ring, on a side stream) overlaps block i's
    kernel. Exact vs Matcher for num_hashes == 1 (the 661k
    database's value) because a 1-hash score is a plain sum over k-mer rows;
    multi-hash indexes need the AND of rows that may straddle blocks and
    must use Matcher.

    The whole index streams once per query super-pass, so
    ``queries_per_pass`` is sized by the [Q, D] score accumulator budget
    (default 256 MB)."""

    term_size: int
    num_hashes: int
    signature_size: int
    doc_names: list[str]
    words_host: np.ndarray  # uint32 [S, W] on HOST (array or memmap)
    row_chunk: int  # signature rows per device block
    acc_budget_bytes: int = 256 << 20
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.num_hashes != 1:
            raise ValueError(
                "ChunkedMatcher requires num_hashes == 1 (a multi-hash "
                "k-mer ANDs rows that may straddle row blocks); "
                f"got {self.num_hashes}. Use Matcher."
            )
        self.device = torch.device(self.device)

    @classmethod
    def from_device_index(
        cls, didx: DeviceIndex, hbm_budget_mb: int,
        device: str | torch.device = "cuda", **kw,
    ) -> "ChunkedMatcher":
        """Size row blocks so block + accumulator + a second block fit the
        given budget."""
        w = max(1, didx.num_words)
        acc = kw.get("acc_budget_bytes", 256 << 20)
        usable = max(64 << 20, hbm_budget_mb * 1_000_000 - acc)
        rows = max(1024, int(usable // 2 // (w * 4)))  # 2 blocks in flight
        return cls(
            term_size=didx.term_size,
            num_hashes=didx.num_hashes,
            signature_size=didx.signature_size,
            doc_names=didx.doc_names,
            words_host=np.asarray(didx.words),
            row_chunk=min(rows, didx.signature_size),
            device=device,
            **kw,
        )

    @property
    def pad_row(self) -> int:
        """GLOBAL padding sentinel: outside every block's [r0, r1) range, so
        padding slots always count as zero rows."""
        return 1 << 30

    def _score_pass(self, packed: np.ndarray) -> torch.Tensor:
        """Accumulated scores [Q, 32*W] for one query super-pass (device).
        The blocks run _acc_chunk_planes in order: the first writes every
        word's bit planes (so acc starts uninitialised), the last the int32
        scores."""
        s, w = self.words_host.shape
        q = packed.shape[0]
        rows = np.ascontiguousarray(packed.reshape(q, -1), np.int32)  # global rows (H == 1)
        if not (q and w and s and rows.shape[1]):
            return torch.zeros((q, 32 * w), dtype=torch.int32, device=self.device)
        acc = torch.empty((q, 32 * w), dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            return self._stream_blocks(acc, rows)
        idx = torch.from_numpy(rows)
        for r0 in range(0, s, self.row_chunk):
            r1 = min(r0 + self.row_chunk, s)
            block = np.ascontiguousarray(self.words_host[r0:r1]).view(np.int32)
            _acc_chunk_planes(acc, torch.from_numpy(block), idx, r0, r1, r0 == 0, r1 == s)
        return acc

    def _stream_blocks(self, acc: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
        """_score_pass on a card. Two device block buffers of row_chunk rows,
        allocated once a pass (the 2 blocks from_device_index sizes for),
        take turns. A block goes up slot by slot through the pinned ring:
        the host copies rows into a slot (after that slot's last copy to the
        device has finished), then a side stream copies the slot into the
        block's buffer (after the kernel that last read that buffer, on the
        current stream, has finished); the current stream waits for the
        block's copies, then launches its accumulating kernel. So block
        i + 1's upload overlaps block i's kernel, and the host's copies
        overlap the link's. The caching allocator stays right with events
        alone: every side-stream use of a buffer is ordered before a
        current-stream kernel, so the buffers' frees at the end follow all
        of their uses (and, should the pass stop early, the current stream
        waits for the side stream); the pinned slots' copies record their
        own events."""
        dev = self.device
        s, w = self.words_host.shape
        starts = range(0, s, self.row_chunk)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        idx = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)
        bufs = [
            torch.empty((min(self.row_chunk, s), w), dtype=torch.int32, device=dev)
            for _ in range(min(2, len(starts)))
        ]
        slot_rows = max(1, min(STAGE_SLOT_BYTES // (4 * w), self.row_chunk, s))
        n_slots = min(STAGE_SLOTS, -(-s // slot_rows))
        ring = torch.empty((n_slots, slot_rows, w), dtype=torch.int32, pin_memory=True)
        ring_u32 = ring.numpy().view(np.uint32)
        copied: list = [None] * n_slots  # each slot's last copy to the device
        read: list = [None] * len(bufs)  # each buffer's last kernel
        n = 0
        try:
            with ThreadPoolExecutor(FILL_THREADS) as pool:
                for i, r0 in enumerate(starts):
                    r1 = min(r0 + self.row_chunk, s)
                    b = i % len(bufs)
                    if read[b] is not None:
                        side.wait_event(read[b])
                    for a in range(r0, r1, slot_rows):
                        e = min(a + slot_rows, r1)
                        j = n % n_slots
                        n += 1
                        if copied[j] is not None:
                            copied[j].synchronize()
                        _fill_rows(pool, ring_u32[j, : e - a], self.words_host, a)
                        with torch.cuda.stream(side):
                            bufs[b][a - r0 : e - r0].copy_(ring[j, : e - a], non_blocking=True)
                        copied[j] = side.record_event()
                    main.wait_event(side.record_event())
                    _acc_chunk_planes(acc, bufs[b], idx, r0, r1, i == 0, r1 == s)
                    read[b] = main.record_event()
        finally:
            # a pass cut short by an error leaves copies in flight: the
            # buffers are freed to the current stream only after them
            main.wait_stream(side)
        return acc

    def score_rows(
        self, per_query: list[np.ndarray], threshold: float, k_max: int = 512
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Matcher.score_rows semantics (full [Q, D] scores on host)."""
        d = len(self.doc_names)
        n_kmers = np.array([r.shape[0] for r in per_query], np.int32)
        kp = round_up(max((r.shape[0] for r in per_query), default=1), 64)
        packed, _ = pack_row_indices(
            per_query, max(kp, 1), self.pad_row, self.num_hashes
        )
        scores = self._score_pass(packed).cpu().numpy()[:, :d].astype(np.int32)
        keep = (scores >= threshold * np.maximum(n_kmers, 1)[:, None]) & (
            n_kmers[:, None] > 0
        )
        return scores, keep, n_kmers

    def score_hits(
        self, seqs: list[bytes], threshold: float, topn: int, k_max: int = 512
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Matcher.score_hits contract (same dedup, same top-k window +
        tie-overflow refetch), with the index streamed in row blocks."""
        all_rows = [
            cobs_row_indices(
                encode_seq(s), self.term_size, self.signature_size, self.num_hashes
            )
            for s in seqs
        ]
        return self._score_hits_rows(all_rows, threshold, topn)

    def score_hits_raw(
        self, raw_hashes: list[np.ndarray], threshold: float, topn: int,
        k_max: int = 512,
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        """Matcher.score_hits_raw twin: precomputed raw k-mer hashes."""
        all_rows = [rows_from_hashes(r, self.signature_size) for r in raw_hashes]
        return self._score_hits_rows(all_rows, threshold, topn)

    def _score_hits_rows(
        self, all_rows: list[np.ndarray], threshold: float, topn: int
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        rep_of, per_query = _dedup_row_sets(all_rows)
        hits_u, n_keep_u = self._score_hits_unique(per_query, threshold, topn)
        if len(per_query) < len(all_rows):
            return (
                [hits_u[j] for j in rep_of],
                np.asarray([n_keep_u[j] for j in rep_of], np.int32),
            )
        return hits_u, n_keep_u

    def _score_hits_unique(
        self, per_query: list[np.ndarray], threshold: float, topn: int
    ) -> tuple[list[list[tuple[int, int]]], np.ndarray]:
        d = len(self.doc_names)
        n_kmers_all = np.array([r.shape[0] for r in per_query], np.int32)
        w = max(1, self.words_host.shape[1])
        q_pass = max(64, int(self.acc_budget_bytes // (32 * w * 4)))
        hits: list[list[tuple[int, int]]] = []
        n_keep_out: list[int] = []
        for off in range(0, len(per_query), q_pass):
            part = per_query[off : off + q_pass]
            n_kmers = n_kmers_all[off : off + q_pass]
            kp = round_up(max((r.shape[0] for r in part), default=1), 64)
            packed, _ = pack_row_indices(
                part, max(kp, 1), self.pad_row, self.num_hashes
            )
            acc = self._score_pass(packed)
            if d == 0 or d > 65535:
                scores = acc.cpu().numpy()[:, :d].astype(np.int32)
                keep = (
                    scores >= threshold * np.maximum(n_kmers, 1)[:, None]
                ) & (n_kmers[:, None] > 0)
                hits.extend(_hits_from_full(scores, keep))
                n_keep_out.extend(keep.sum(axis=1).astype(int).tolist())
                continue
            kk = min(d, round_up(min(topn + 33, d), 32))
            cut = _to_device(_int_cut(threshold, n_kmers), self.device)
            vals, idx, n_keep = (
                t.cpu().numpy() for t in _topk_scores(acc, cut, kk, d)
            )
            scores_full = None
            for qi in range(len(part)):
                m = int(n_keep[qi])
                if m > kk:  # tie overflow: read this query's full row
                    if scores_full is None:
                        scores_full = acc.cpu().numpy()[:, :d]
                    row = scores_full[qi]
                    cut_q = int(_int_cut(threshold, n_kmers[qi : qi + 1])[0])
                    docs = np.nonzero(row >= cut_q)[0]
                    hl = [(int(dd), int(row[dd])) for dd in docs]
                    hl.sort(key=lambda t: (-t[1], t[0]))
                    hits.append(hl)
                    n_keep_out.append(len(hl))
                    continue
                hits.append(
                    [(int(idx[qi, j]), int(vals[qi, j])) for j in range(m)]
                )
                n_keep_out.append(m)
        return hits, np.asarray(n_keep_out, np.int32)


def _fill_rows(pool: ThreadPoolExecutor, dst: np.ndarray, src: np.ndarray, a: int) -> None:
    """dst[:] = src[a : a + len(dst)], in FILL_THREADS parts copied by the
    pool together (numpy copies without the GIL)."""
    n = dst.shape[0]
    step = -(-n // FILL_THREADS)
    parts = [(x, min(x + step, n)) for x in range(0, n, step)]
    list(pool.map(lambda p: np.copyto(dst[p[0] : p[1]], src[a + p[0] : a + p[1]]), parts))


def _dedup_row_sets(
    rows: list[np.ndarray],
) -> tuple[list[int], list[np.ndarray]]:
    """Group queries by identical k-mer row-index arrays.

    Returns (rep_of, unique): rep_of[q] is the index into ``unique`` whose
    row MULTISET equals rows[q]'s. Scores are a sum over k-mer slots, so any
    order-permutation of the same rows yields identical scores for every
    document — which collapses exact duplicate reads AND reverse-complement
    duplicates (canonical k-mers are strand-invariant; RC merely reverses
    their position order)."""
    seen: dict[tuple[int, bytes], int] = {}
    rep_of: list[int] = []
    unique: list[np.ndarray] = []
    for r in rows:
        if r.ndim == 1 or r.shape[-1] == 1:
            # 1 hash (the 661k DB): plain value sort, no lexsort machinery
            canon = np.sort(r.reshape(-1), kind="stable")
        else:  # [n, H]: lexicographic row sort
            canon = r[np.lexsort(r.T[::-1])] if r.shape[0] else r
        key = (r.shape[0], canon.tobytes())
        j = seen.get(key)
        if j is None:
            j = len(unique)
            seen[key] = j
            unique.append(r)
        rep_of.append(j)
    return rep_of, unique


def _hits_from_full(
    scores: np.ndarray, keep: np.ndarray
) -> list[list[tuple[int, int]]]:
    out = []
    for q in range(scores.shape[0]):
        docs = np.nonzero(keep[q])[0]
        row = [(int(d), int(scores[q, d])) for d in docs]
        row.sort(key=lambda t: (-t[1], t[0]))
        out.append(row)
    return out
