"""Device match engine: k-mer containment scoring over a packed Bloom
bit-matrix (the counterpart of ``phylign_tpu/ops/match.py``).

Data model (as in the JAX package; unsigned data are held in int32 tensors
with the same bits, since torch's uint32 support is partial):

  words     int32 [S+1, Wp]   uint32 bits of the packed bit-matrix: doc d at
                              word d//32, bit d%32. Row S is all zero (the
                              padding row). Wp is the exact word count.
  row_idx   int32 [Q, K] or [Q, K, H]
                              per query, K k-mer slots of Bloom rows (S for
                              padding); with H > 1 hashes a k-mer hits a doc
                              only if all H rows have its bit.
  scores    int32 [Q, 32*Wp]  per (query, doc) hit counts, doc d at column d.

Implementations with identical results:
  * ``match_scores_ref``  plain PyTorch, runs anywhere; the CPU path and the
                          reference the kernels are held to.
  * ``match_scores_b1``   CUDA kernel B1 (replaces the Pallas
                          ``match_scores_pallas``): any H, any K.
  * ``match_scores_b2``   CUDA kernel B2 (replaces ``match_scores_pallas_v2``):
                          H == 1, K % 32 == 0.
Both kernels are one CUDA kernel (csrc/match_popcount.cu) that counts in
carry-save bit planes.
``match_scores`` picks by the tensor's device: the plain version for a CPU
tensor, a kernel for a CUDA tensor, never one for the other.

The same kernel has two more epilogues, each with its plain version:
  * ``match_scores_acc_`` (``match_scores_acc_ref_``)  acc += the scores of
        the rows a block of the index holds (the row-chunked matcher), and
    ``match_scores_acc_planes_`` (``match_scores_acc_planes_ref_``)  the
        same over a pass of blocks, the counts kept between blocks as
        bit_length(K) bit planes in the accumulator's own bytes.
  * ``match_scores_keep`` (``match_scores_keep_ref``)  the scores and
        ``match_step``'s float32 keep mask in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from phylign_tpu_torch.ops import _kernels

#: threads per block, at most: one per (query, word), so at Wp = 68 a
#: block holds one query (the fastest tile measured, PERF.md)
BLOCK_THREADS = 128
#: shared memory a block takes, at most, for its staged row indices and,
#: apart, for its counts before they are stored
STAGE_BYTES = 48 * 1024
OUT_BYTES = 48 * 1024
#: bit planes kernel B2 takes (K up to 2**14 - 1)
B2_PLANES = range(6, 15)
#: the largest K (planes = bit_length(K) <= 16)
K_MAX = (1 << 16) - 1


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_device_words(words: np.ndarray, lane_words: int = 1) -> np.ndarray:
    """[S, W] uint32 -> [S+1, Wp] with Wp a multiple of ``lane_words`` and a
    final all-zero padding row. The kernels take any Wp, so the port keeps
    the exact width (lane_words=1); other widths serve held-to-JAX tests."""
    s, w = words.shape
    wp = round_up(max(w, 1), lane_words)
    out = np.zeros((s + 1, wp), dtype=np.uint32)
    out[:s, :w] = words
    return out


def pack_row_indices(
    rows_per_query: list[np.ndarray], k_max: int, pad_row: int, num_hashes: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-query [n_kmers, H] row-index arrays into [Q, K, H] int32 plus
    the per-query valid k-mer counts [Q] int32. Queries with more than k_max
    k-mers are rejected (caller buckets by length)."""
    q = len(rows_per_query)
    out = np.full((q, k_max, num_hashes), pad_row, dtype=np.int32)
    counts = np.zeros(q, dtype=np.int32)
    for i, r in enumerate(rows_per_query):
        n = r.shape[0]
        if n > k_max:
            raise ValueError(f"query {i} has {n} k-mers > k_max={k_max}")
        out[i, :n] = r
        counts[i] = n
    return out, counts


# --- plain PyTorch version ----------------------------------------------------

#: bytes of the [q, K, Wp, 32] bit intermediate per chunk of queries
_REF_CHUNK_BYTES = 256 << 20


def match_scores_ref(words: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """Gather + vertical popcount in plain PyTorch, exact.

    words int32 [S+1, Wp]; row_idx int32 [Q, K] or [Q, K, H]. Returns int32
    [Q, 32*Wp]. The rows of a k-mer's H hashes are ANDed, then bit b of word
    w is summed over K into column 32*w + b. Chunked over Q: unchunked, the
    [Q, K, Wp, 32] intermediate is 2.3 GB at Q=2048, K=128, Wp=68."""
    if row_idx.dim() == 2:
        row_idx = row_idx.unsqueeze(-1)
    q, k, h = row_idx.shape
    wp = words.shape[1]
    out = torch.empty((q, 32 * wp), dtype=torch.int32, device=words.device)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    step = max(1, _REF_CHUNK_BYTES // max(1, k * wp * 32 * 4))
    for q0 in range(0, q, step):
        g = words[row_idx[q0 : q0 + step].long()]  # [q, K, H, Wp]
        a = g[:, :, 0]
        for j in range(1, h):
            a = a & g[:, :, j]
        # (x >> b) & 1 is bit b for negative int32 too (arithmetic shift)
        bits = (a.unsqueeze(-1) >> shifts) & 1  # [q, K, Wp, 32]
        out[q0 : q0 + step] = bits.sum(dim=1, dtype=torch.int32).reshape(
            -1, 32 * wp
        )
    return out


def match_scores_acc_ref_(
    acc: torch.Tensor, words: torch.Tensor, row_idx: torch.Tensor, r0: int, r1: int
) -> torch.Tensor:
    """acc += the scores of the global rows [r0, r1), which ``words``
    holds at row r - r0 (at least r1 - r0 rows); a slot row outside the
    window counts as the zero row. ``row_idx`` holds global rows. In place;
    returns acc."""
    n = r1 - r0
    loc = row_idx.long() - r0
    loc = torch.where((loc >= 0) & (loc < n), loc, n).to(torch.int32)
    block = torch.cat([words[:n], words.new_zeros((1, words.shape[1]))])
    return acc.add_(match_scores_ref(block, loc))


def encode_planes(counts: torch.Tensor, planes: int) -> torch.Tensor:
    """int32 [Q, Wp, planes] bit planes of int32 counts [Q, 32*Wp] (each
    below 2**planes): bit b of plane j of word w is bit j of count 32w + b.
    Built in int64 and wrapped into int32 (torch on the CPU has no ``>>``
    for uint32)."""
    q = counts.shape[0]
    c = counts.reshape(q, -1, 32, 1).to(torch.int64)
    j = torch.arange(planes, device=counts.device)
    b = torch.arange(32, device=counts.device)[:, None]
    p = (((c >> j) & 1) << b).sum(dim=2)  # [Q, Wp, planes], below 2**32
    return torch.where(p >= 1 << 31, p - (1 << 32), p).to(torch.int32)


def decode_planes(planes: torch.Tensor) -> torch.Tensor:
    """int32 counts [Q, 32*Wp] of int32 bit planes [Q, Wp, P]
    (encode_planes' inverse)."""
    q, wp, n = planes.shape
    b = torch.arange(32, dtype=torch.int32, device=planes.device)[:, None]
    j = torch.arange(n, dtype=torch.int32, device=planes.device)
    # (x >> b) & 1 is bit b for negative int32 too (arithmetic shift)
    bits = (planes.unsqueeze(2) >> b) & 1  # [Q, Wp, 32, P]
    return (bits << j).sum(dim=3, dtype=torch.int32).reshape(q, 32 * wp)


def match_scores_acc_planes_ref_(
    acc: torch.Tensor, words: torch.Tensor, row_idx: torch.Tensor, r0: int, r1: int,
    first: bool, last: bool,
) -> torch.Tensor:
    """One block of a row-chunked pass: the counts of the global rows
    [r0, r1) (as match_scores_acc_ref_) added to the pass's counts so far.
    Between blocks acc[q, 32w : 32w + P] holds the bit planes
    (encode_planes) of the counts of word w, P = b2_planes(K), and the rest
    of the row is left as it was; the first block reads nothing, the last
    one leaves the int32 counts. In place; returns acc."""
    q = row_idx.shape[0]
    wp = words.shape[1]
    planes = b2_planes(row_idx.shape[1])
    cnt = match_scores_acc_ref_(torch.zeros_like(acc), words, row_idx, r0, r1)
    view = acc.view(q, wp, 32)
    if not first:
        cnt += decode_planes(view[..., :planes])
    if last:
        return acc.copy_(cnt)
    view[..., :planes] = encode_planes(cnt, planes)
    return acc


def match_scores_keep_ref(
    words: torch.Tensor, row_idx: torch.Tensor, n_kmers: torch.Tensor, threshold: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores int32 [Q, 32*Wp], keep bool [Q, 32*Wp]) with keep = f32(score)
    >= f32(threshold) * f32(n_kmers[q]), and n_kmers[q] > 0: the JAX
    package's float32 test (``phylign_tpu/models/matcher.py:match_step``)."""
    scores = match_scores_ref(words, row_idx)
    # a 0-dim host tensor: the float32 threshold, with no copy to the device
    cut = n_kmers.to(torch.float32) * torch.tensor(threshold, dtype=torch.float32)
    keep = scores.to(torch.float32) >= cut[:, None]
    return scores, torch.logical_and(keep, n_kmers[:, None] > 0)


# --- hand-written CUDA kernels -------------------------------------------------

_launches = _kernels.LaunchCounts(
    "match_popcount_b1", "match_popcount_b2", "match_popcount_acc", "match_popcount_keep"
)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return _launches.snapshot()


def reset_launch_counts() -> None:
    _launches.reset()


def launch_geometry(wp: int, k: int, h: int) -> tuple[int, int, int, int]:
    """(qt, wt, staged, via_smem): a block of qt queries x wt threads, a
    thread per (query, word) of up to BLOCK_THREADS words; whether the
    block stages its qt * K * H row indices in shared memory (when they fit
    STAGE_BYTES, else it reads them from device memory), and whether its
    counts go out through shared memory (when they fit OUT_BYTES)."""
    if k > K_MAX:
        raise ValueError(f"K={k} slots need more than 16 bit planes (K <= {K_MAX})")
    wt = min(max(wp, 1), BLOCK_THREADS)
    qt = max(1, BLOCK_THREADS // wt)
    fit = STAGE_BYTES // (4 * k * h)
    staged = int(fit > 0)
    if staged:
        qt = min(qt, fit)
    return qt, wt, staged, int(qt * wp * 128 <= OUT_BYTES)


#: threads the keep instance may give one (query, word)
SPLITS = (1, 2, 4)


def resident_threads(device: torch.device) -> int:
    """Threads the card holds at once: its SMs x threads an SM."""
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def keep_split(wp: int, k: int, h: int, q: int, resident: int) -> int:
    """The keep instance's threads a (query, word): the one of SPLITS that
    brings the grid's Q x ceil(Wp / wt) x wt x split threads nearest (by
    ratio) to ``resident``, the threads the card holds at once, with
    wt x split <= 256 threads a query. Under one wave each thread would
    walk all K slots in turn; split, it walks a share. Threads, not
    registers, are counted: the card holds fewer of the keep kernel's
    (PERF.md)."""
    wt = launch_geometry(wp, k, h)[1]
    threads = max(q * -(-wp // wt) * wt, 1)
    return min((s for s in SPLITS if wt * s <= 256), key=lambda s: abs(np.log(threads * s / resident)))


def keep_geometry(wp: int, k: int, h: int, split: int) -> tuple[int, int, int, int]:
    """(qt, wt, staged, via_smem) of the keep instance with ``split``
    threads a (query, word), each counting a share of the slots:
    launch_geometry's, with qt x wt x split <= BLOCK_THREADS (one query a
    block past it)."""
    qt, wt, staged, _ = launch_geometry(wp, k, h)
    if split not in SPLITS or wt * split > 256:
        raise ValueError(f"split {split} must be one of {SPLITS} with {wt} x split <= 256 threads")
    qt = max(1, min(qt, BLOCK_THREADS // (wt * split)))
    return qt, wt, staged, int(qt * wp * 128 <= OUT_BYTES)


def b2_planes(k: int) -> int:
    """Bit planes that hold a count up to K: ceil(log2(K + 1)) (both
    kernels count in carry-save planes)."""
    return max(1, int(k).bit_length())


def _check_kernel_args(
    words: torch.Tensor, row_idx: torch.Tensor, what: str
) -> torch.Tensor:
    if words.device.type != "cuda" or row_idx.device != words.device:
        raise ValueError(
            f"{what} runs on CUDA tensors on one device; got words on "
            f"{words.device}, row_idx on {row_idx.device}"
        )
    if words.dtype != torch.int32 or row_idx.dtype != torch.int32:
        raise TypeError(
            f"{what} takes int32 words and row_idx; got {words.dtype}, "
            f"{row_idx.dtype}"
        )
    if words.dim() != 2 or row_idx.dim() not in (2, 3):
        raise ValueError(
            f"{what}: words must be [S+1, Wp] and row_idx [Q, K(, H)]; got "
            f"{tuple(words.shape)}, {tuple(row_idx.shape)}"
        )
    if not (words.is_contiguous() and row_idx.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    if words.shape[0] >= 1 << 31:
        raise ValueError(f"{what}: {words.shape[0]} rows exceed int32 indices")
    return row_idx if row_idx.dim() == 3 else row_idx.unsqueeze(-1)


def _launch(name: str, words, row_idx3) -> torch.Tensor:
    q, k, h = row_idx3.shape
    wp = words.shape[1]
    out = torch.empty((q, 32 * wp), dtype=torch.int32, device=words.device)
    if q == 0:
        return out
    if k * h == 0:
        return out.zero_()
    qt, wt, staged, via_smem = launch_geometry(wp, k, h)
    _kernels.launch(
        _launches, name, "match_popcount", f"phylign_{name}",
        words, words.shape[0], wp, row_idx3, q, k, h, b2_planes(k), qt, wt, staged, via_smem, out,
    )
    return out


def match_scores_b1(words: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """Kernel B1 (replaces ``phylign_tpu/ops/match.py:match_scores_pallas``):
    any H, any K up to K_MAX. CUDA tensors only; same contract as
    match_scores_ref."""
    r3 = _check_kernel_args(words, row_idx, "match_popcount_b1")
    return _launch("match_popcount_b1", words, r3)


def match_scores_b2(words: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """Kernel B2 (replaces ``match_scores_pallas_v2``): H == 1 and K a
    multiple of 32. CUDA tensors only; same contract as match_scores_ref."""
    r3 = _check_kernel_args(words, row_idx, "match_popcount_b2")
    q, k, h = r3.shape
    planes = b2_planes(k)
    if h != 1 or k % 32 or planes not in B2_PLANES:
        raise ValueError(
            f"match_popcount_b2 takes H == 1 and K % 32 == 0 with "
            f"K < 2**{B2_PLANES[-1]}; got K={k}, H={h}"
        )
    return _launch("match_popcount_b2", words, r3)


#: the accumulating instance's modes (csrc/match_popcount.cu AccMode)
ACC_ADD, ACC_FIRST, ACC_MIDDLE, ACC_LAST, ACC_ONLY = range(5)


def match_scores_acc_(
    acc: torch.Tensor, words: torch.Tensor, row_idx: torch.Tensor, r0: int, r1: int
) -> torch.Tensor:
    """The accumulating instance of B1/B2 (replaces the jitted
    ``phylign_tpu/models/matcher.py:_acc_chunk_scores``): same contract as
    match_scores_acc_ref_, in one pass over acc. CUDA tensors only; acc
    int32 [Q, 32*Wp], contiguous and 16-byte aligned."""
    r3 = _check_kernel_args(words, row_idx, "match_popcount_acc")
    _check_acc(acc, words, r3, r0, r1)
    q, k, h = r3.shape
    if q and k * h:
        _launch_acc(acc, words, r3, r0, r1, ACC_ADD)
    return acc


def _check_acc(acc, words, r3, r0: int, r1: int) -> None:
    q, wp = r3.shape[0], words.shape[1]
    if acc.device != words.device or acc.dtype != torch.int32 or acc.shape != (q, 32 * wp):
        raise ValueError(
            f"match_popcount_acc: acc must be int32 [{q}, {32 * wp}] on {words.device}; got "
            f"{acc.dtype} {tuple(acc.shape)} on {acc.device}"
        )
    if not acc.is_contiguous() or acc.data_ptr() % 16:
        raise ValueError("match_popcount_acc takes a contiguous, 16-byte aligned acc")
    if not 0 <= r0 < r1 < 1 << 31 or words.shape[0] < r1 - r0:
        raise ValueError(
            f"match_popcount_acc: rows [{r0}, {r1}) need 0 <= r0 < r1 and "
            f"{r1 - r0} rows of words; got {words.shape[0]}"
        )


def _launch_acc(acc, words, r3, r0: int, r1: int, mode: int) -> None:
    q, k, h = r3.shape
    wp = words.shape[1]
    qt, wt, staged, via_smem = launch_geometry(wp, k, h)
    _kernels.launch(
        _launches, "match_popcount_acc", "match_popcount", "phylign_match_popcount_acc",
        words, int(r0), int(r1), wp, r3, q, k, h, b2_planes(k), qt, wt, staged, via_smem, mode, acc,
    )


def match_scores_acc_planes_(
    acc: torch.Tensor, words: torch.Tensor, row_idx: torch.Tensor, r0: int, r1: int,
    first: bool, last: bool,
) -> torch.Tensor:
    """The accumulating instance over one block of a row-chunked pass: same
    contract as match_scores_acc_planes_ref_ (the counts between blocks as
    bit planes in acc's own bytes; ``first`` reads nothing, so acc may be
    uninitialised), in one launch. CUDA tensors only; acc as
    match_scores_acc_'s; K * H > 0."""
    r3 = _check_kernel_args(words, row_idx, "match_popcount_acc")
    _check_acc(acc, words, r3, r0, r1)
    q, k, h = r3.shape
    if k * h == 0:
        raise ValueError("match_popcount_acc's plane modes take K * H > 0 slots")
    mode = ACC_ONLY if first and last else ACC_FIRST if first else ACC_LAST if last else ACC_MIDDLE
    if q:
        _launch_acc(acc, words, r3, r0, r1, mode)
    return acc


def match_scores_keep(
    words: torch.Tensor, row_idx: torch.Tensor, n_kmers: torch.Tensor, threshold: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The keep instance of B1/B2 (replaces the jitted
    ``phylign_tpu/models/matcher.py:match_step``): same contract as
    match_scores_keep_ref, in one launch, at keep_split's threads a
    (query, word) for this card. CUDA tensors only; n_kmers [Q]."""
    r3 = _check_kernel_args(words, row_idx, "match_popcount_keep")
    q, k, h = r3.shape
    wp = words.shape[1]
    if n_kmers.device != words.device or n_kmers.shape != (q,):
        raise ValueError(
            f"match_popcount_keep: n_kmers must be [{q}] on {words.device}; got "
            f"{tuple(n_kmers.shape)} on {n_kmers.device}"
        )
    if k * h == 0:
        raise ValueError("match_popcount_keep takes K * H > 0 slots")
    nk = n_kmers.to(torch.int32).contiguous()
    out = torch.empty((q, 32 * wp), dtype=torch.int32, device=words.device)
    keep = torch.empty((q, 32 * wp), dtype=torch.bool, device=words.device)
    if q == 0:
        return out, keep
    sp = keep_split(wp, k, h, q, resident_threads(words.device))
    qt, wt, staged, via_smem = keep_geometry(wp, k, h, sp)
    _kernels.launch(
        _launches, "match_popcount_keep", "match_popcount", "phylign_match_popcount_keep",
        words, words.shape[0], wp, r3, q, k, h, b2_planes(k), qt, wt, sp, staged, via_smem, nk,
        float(np.float32(threshold)), out, keep,
    )
    return out, keep


def select_kernel(k: int, h: int) -> str:
    """The kernel for K slots of H hashes: B2 when H == 1 and K % 32 == 0
    (every hash-path call of a 1-hash index: K is bucketed to 64), B1
    otherwise."""
    if h == 1 and k % 32 == 0 and b2_planes(k) in B2_PLANES:
        return "match_popcount_b2"
    return "match_popcount_b1"


def match_scores(words: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: the plain version for a CPU tensor, the kernel
    of select_kernel for a CUDA tensor. Any other device raises."""
    if words.device.type == "cpu":
        return match_scores_ref(words, row_idx)
    if words.device.type != "cuda":
        raise ValueError(f"no match kernel for device {words.device}")
    h = row_idx.shape[2] if row_idx.dim() == 3 else 1
    if select_kernel(row_idx.shape[1], h) == "match_popcount_b2":
        return match_scores_b2(words, row_idx)
    return match_scores_b1(words, row_idx)


# --- cross-query k-mer dedup (two-stage gather) --------------------------------

#: bytes below which the unique-row table is small enough for the dedup to
#: pay (the value the JAX package uses; not yet measured on a GPU)
DEDUP_FAST_BYTES = 40 << 20

#: dedup pays only when stage-1 (U big-gathers) + stage-2 (N small-table
#: gathers) undercuts N big-gathers (the JAX package's breakeven)
DEDUP_MAX_FRAC = 0.55


def dedup_rows(
    row_idx: np.ndarray, pad_row: int, wp: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Host half of the two-stage dedup gather: unique row indices (padded
    to a power-of-two bucket with ``pad_row``) + inverse indices, or None
    when the dedup would not be profitable (low cross-query duplication, or
    a unique table too large)."""
    flat = row_idx.reshape(-1)
    from phylign_tpu_torch import native

    nat = native.native_unique_inverse(flat)
    if nat is not None:
        uniq, inv = nat
    else:
        uniq, inv = np.unique(flat, return_inverse=True)
        inv = inv.astype(np.int32)
    u, n = uniq.size, flat.size
    up = 1 << max(10, int(np.ceil(np.log2(u + 1))))
    if up * wp * 4 > DEDUP_FAST_BYTES or u > DEDUP_MAX_FRAC * n:
        return None
    uniq_pad = np.full(up, pad_row, np.int32)
    uniq_pad[:u] = uniq
    return uniq_pad, inv.reshape(row_idx.shape)


def match_scores_dedup(
    words: torch.Tensor, uniq_pad: torch.Tensor, inv: torch.Tensor
) -> torch.Tensor:
    """Two-stage scoring: gather the chunk's unique Bloom rows into a small
    table, then score against it. Identical to match_scores(words, row_idx)
    for the (uniq, inv) pair of dedup_rows: padding slots index ``pad_row``,
    whose row is all zero in both tables."""
    return match_scores(words[uniq_pad.long()].contiguous(), inv.contiguous())
