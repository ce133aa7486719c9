"""DNA encoding, canonical k-mers, and COBS-compatible XXH64 hashing.

Behavior contract (reference: karel-brinda/Phylign + cobs 0.2.1):
  * The match stage scores a query against a genome document by counting how
    many of the query's canonical 31-mers hit the document's Bloom row
    (the reference's Snakefile:419-427 invokes ``cobs query``).
  * COBS canonicalizes a k-mer by taking the lexicographically smaller of the
    ASCII k-mer and its reverse complement, then hashes the ASCII bytes with
    ``XXH64(bytes, seed=i) % signature_size`` for each of ``num_hashes``
    seeds ``i = 0..num_hashes-1``.
  * Query normalization: uppercase, non-ACGT bases replaced by 'A'
    (the reference's Snakefile:330-332).

The port's own copy of ``phylign_tpu/kmer.py`` (the functions the match path
calls). Everything here is host-side numpy, vectorized over k-mer windows,
with the native library (phylign_tpu_torch.native) as the fast path; the
device kernels consume the resulting row indices (phylign_tpu_torch.ops.match).
"""

from __future__ import annotations

import numpy as np

# --- DNA alphabet ------------------------------------------------------------

#: 2-bit encoding, minimap2 convention: A=0 C=1 G=2 T=3.
CODE_OF_ASCII = np.full(256, 0, dtype=np.uint8)  # non-ACGT -> A (=0)
for _i, _b in enumerate(b"ACGT"):
    CODE_OF_ASCII[_b] = _i
for _i, _b in enumerate(b"acgt"):
    CODE_OF_ASCII[_b] = _i

ASCII_OF_CODE = np.frombuffer(b"ACGT", dtype=np.uint8).copy()

#: Complement in code space: A<->T (0<->3), C<->G (1<->2).
COMP_CODE = np.array([3, 2, 1, 0], dtype=np.uint8)

#: Bases that survive normalization unchanged (upper+lower ACGT).
_ACGT_SET = frozenset(b"ACGTacgt")


def normalize_seq(seq: bytes) -> bytes:
    """Uppercase and map non-ACGT to 'A' (ref: Snakefile:330-332 awk filter)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return ASCII_OF_CODE[CODE_OF_ASCII[arr]].tobytes()


def encode_seq(seq: bytes) -> np.ndarray:
    """ASCII sequence -> uint8 2-bit codes (non-ACGT mapped to A)."""
    return CODE_OF_ASCII[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> bytes:
    return ASCII_OF_CODE[codes].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return COMP_CODE[codes][::-1]


def revcomp(seq: bytes) -> bytes:
    return decode_seq(revcomp_codes(encode_seq(seq)))


# --- XXH64 (vectorized) ------------------------------------------------------

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)

_U64 = np.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r = _U64(r)
    return (x << r) | (x >> (_U64(64) - r))


def _round(acc, lane):
    acc = acc + lane * _P2
    acc = _rotl64(acc, 31)
    return acc * _P1


def _merge_round(acc, val):
    val = _round(_U64(0), val)
    acc = acc ^ val
    return acc * _P1 + _P4


def _avalanche(h):
    h = h ^ (h >> _U64(33))
    h = h * _P2
    h = h ^ (h >> _U64(29))
    h = h * _P3
    h = h ^ (h >> _U64(32))
    return h


def xxh64_batch(rows: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH64 over a batch of equal-length byte rows.

    rows: uint8 array [N, L]. Returns uint64 [N].
    Vectorized across N; the per-row length L is a compile-time constant of
    the call, which is exactly the k-mer use case (L = 31).
    """
    assert rows.ndim == 2 and rows.dtype == np.uint8
    n, length = rows.shape
    seed = _U64(seed)
    old = np.seterr(over="ignore")
    try:
        pos = 0
        if length >= 32:
            v1 = seed + _P1 + _P2
            v2 = seed + _P2
            v3 = seed + _U64(0)
            v4 = seed - _P1
            v1 = np.full(n, v1, _U64)
            v2 = np.full(n, v2, _U64)
            v3 = np.full(n, v3, _U64)
            v4 = np.full(n, v4, _U64)
            nstripes = length // 32
            lanes = (
                rows[:, : nstripes * 32]
                .reshape(n, nstripes, 4, 8)
                .view(np.dtype("<u8"))
                .reshape(n, nstripes, 4)
                .astype(_U64)
            )
            for s in range(nstripes):
                v1 = _round(v1, lanes[:, s, 0])
                v2 = _round(v2, lanes[:, s, 1])
                v3 = _round(v3, lanes[:, s, 2])
                v4 = _round(v4, lanes[:, s, 3])
            h = _rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)
            h = _merge_round(h, v1)
            h = _merge_round(h, v2)
            h = _merge_round(h, v3)
            h = _merge_round(h, v4)
            pos = nstripes * 32
        else:
            h = np.full(n, seed + _P5, _U64)

        h = h + _U64(length)

        while length - pos >= 8:
            lane = (
                rows[:, pos : pos + 8].copy().view(np.dtype("<u8")).reshape(n).astype(_U64)
            )
            h = h ^ _round(_U64(0), lane)
            h = _rotl64(h, 27) * _P1 + _P4
            pos += 8
        if length - pos >= 4:
            lane = (
                rows[:, pos : pos + 4].copy().view(np.dtype("<u4")).reshape(n).astype(_U64)
            )
            h = h ^ (lane * _P1)
            h = _rotl64(h, 23) * _P2 + _P3
            pos += 4
        while pos < length:
            lane = rows[:, pos].astype(_U64)
            h = h ^ (lane * _P5)
            h = _rotl64(h, 11) * _P1
            pos += 1
        return _avalanche(h)
    finally:
        np.seterr(**old)


# --- Canonical k-mers and COBS row indices -----------------------------------


def xxh64(data: bytes, seed: int = 0) -> int:
    """Scalar XXH64 of arbitrary-length bytes (spec-complete, any length)."""
    return int(xxh64_batch(np.frombuffer(data, np.uint8)[None, :], seed)[0])


def kmer_windows(codes: np.ndarray, k: int) -> np.ndarray:
    """All overlapping k-windows of a code sequence: [L-k+1, k] view."""
    if codes.shape[0] < k:
        return np.empty((0, k), dtype=np.uint8)
    return np.lib.stride_tricks.sliding_window_view(codes, k)


def canonical_kmers_ascii(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical (lexicographically-smaller of fwd/revcomp ASCII) k-mers.

    Returns uint8 ASCII array [L-k+1, k]. For odd k a k-mer never equals its
    reverse complement (the middle base would have to self-complement), so
    the comparison always has a first differing byte.
    """
    fwd = kmer_windows(codes, k)
    if fwd.shape[0] == 0:
        return fwd
    # reverse complement of each window, in code space
    rc = COMP_CODE[fwd][:, ::-1]
    fwd_a = ASCII_OF_CODE[fwd]
    rc_a = ASCII_OF_CODE[rc]
    # lexicographic comparison on ASCII bytes
    neq = fwd_a != rc_a
    first = neq.argmax(axis=1)
    rows = np.arange(fwd.shape[0])
    take_rc = fwd_a[rows, first] > rc_a[rows, first]
    return np.where(take_rc[:, None], rc_a, fwd_a)


def cobs_kmer_hashes(
    codes: np.ndarray, k: int, num_hashes: int = 1
) -> np.ndarray:
    """RAW XXH64 values for every canonical k-mer of a sequence: uint64
    [L-k+1, num_hashes], seed = hash index (cobs 0.2.1 term hashing minus
    the per-index ``% signature_size``).

    One hashing pass serves EVERY batch index: a Bloom row index is just
    ``hash % signature_size``, so callers scoring the same reads against
    many batches (the 305-batch production shape) hash once and re-mod per
    batch (Matcher.score_hits_raw) instead of re-hashing 305 times."""
    from phylign_tpu_torch import native

    nat = native.native_cobs_row_indices(codes, k, 0, num_hashes)
    if nat is not None:
        return nat.view(np.uint64)  # raw hashes bit-cast through int64
    kmers = canonical_kmers_ascii(codes, k)
    npos = kmers.shape[0]
    out = np.empty((npos, num_hashes), dtype=np.uint64)
    for h in range(num_hashes):
        out[:, h] = xxh64_batch(np.ascontiguousarray(kmers), h)
    return out


def cobs_kmer_hashes_batch(
    codes_list: list[np.ndarray], k: int, num_hashes: int = 1
) -> list[np.ndarray]:
    """cobs_kmer_hashes for a WHOLE read set in one native call (threaded;
    per-read ctypes overhead dominated host hashing at 10k+ reads). Falls
    back to the per-read path without the library."""
    from phylign_tpu_torch import native

    nat = native.native_cobs_row_indices_batch(codes_list, k, 0, num_hashes)
    if nat is not None:
        return [a.view(np.uint64) for a in nat]
    return [cobs_kmer_hashes(c, k, num_hashes) for c in codes_list]


def rows_from_hashes(raw: np.ndarray, signature_size: int) -> np.ndarray:
    """Bloom row indices from cobs_kmer_hashes output: int64 [npos, H]."""
    return (raw % np.uint64(signature_size)).astype(np.int64)


def cobs_row_indices(
    codes: np.ndarray, k: int, signature_size: int, num_hashes: int = 1
) -> np.ndarray:
    """Bloom row indices for every k-mer position of a sequence.

    Returns int64 array [L-k+1, num_hashes]: for k-mer position p and hash h,
    ``XXH64(canonical_kmer_ascii, seed=h) % signature_size`` — bit-exact with
    cobs 0.2.1 term hashing as driven by ``cobs query``
    (the reference's Snakefile:419-427).

    Uses the native C++ path (phylign_tpu_torch.native) when available; the numpy
    path below is the portable fallback and test oracle.
    """
    from phylign_tpu_torch import native

    nat = native.native_cobs_row_indices(codes, k, signature_size, num_hashes)
    if nat is not None:
        return nat
    kmers = canonical_kmers_ascii(codes, k)
    npos = kmers.shape[0]
    out = np.empty((npos, num_hashes), dtype=np.int64)
    if npos == 0:
        return out
    for h in range(num_hashes):
        out[:, h] = (xxh64_batch(np.ascontiguousarray(kmers), h) % _U64(signature_size)).astype(
            np.int64
        )
    return out
