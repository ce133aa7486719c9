"""COBS *classic* index binary format: read, write, inspect, build, and
device repacking (the port's own copy of ``phylign_tpu/io/cobs.py``).

The reference pipeline downloads one xz-compressed ``.cobs_classic`` index per
batch (the reference's Snakefile:196-201) and queries it with
``cobs query`` (cobs 0.2.1; the reference's envs/cobs.yaml:5 and
Snakefile:419-427). A classic index is a Bloom-filter bit
matrix: ``signature_size`` rows x one bit column per genome document. A
query k-mer selects ``num_hashes`` rows (XXH64(canonical kmer ascii, seed=h)
% signature_size, see phylign_tpu_torch.kmer); a document "contains" the k-mer if
its bit is set in all selected rows.

Serialized layout implemented here (after cobs 0.2.1 ``ClassicIndexHeader``):

    magic            b"COBS:CLASSIC_INDEX"          (18 bytes)
    version          u32 LE                          (=1)
    term_size        u32 LE                          (k, 31 for the 661k DB)
    canonicalize     u8                              (1)
    num_docs         u32 LE
    doc_names        num_docs x (utf-8 + NUL)
    num_hashes       u32 LE                          (1 for the 661k DB)
    signature_size   u64 LE                          (# Bloom rows)
    payload          signature_size rows x ceil(num_docs/8) bytes,
                     row-major, doc d -> byte d//8 bit d%8 (LSB-first)

NOTE ON COMPATIBILITY: the real Zenodo artifacts are not reachable in this
build environment, so header field *order* is asserted centrally here and in
one place only (``_read_header`` / ``_write_header``); if a real cobs 0.2.1
file disagrees, only these two functions change. The bit-matrix payload
convention (row-major, LSB-first) matches cobs' sequential row writes.

Device repacking: rows are reinterpreted as little-endian uint32 words so that
``word[d // 32] >> (d % 32) & 1`` is document d's bit — a pure view change
(no bit shuffling) from the LSB-first byte layout.
"""

from __future__ import annotations

import io
import json
import lzma
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Sequence

import numpy as np

MAGIC = b"COBS:CLASSIC_INDEX"
VERSION = 1
DEFAULT_TERM_SIZE = 31
DEFAULT_FPR = 0.3  # classic-construct default false-positive rate


@dataclass
class ClassicIndex:
    """In-memory COBS classic index."""

    term_size: int
    canonicalize: bool
    doc_names: list[str]
    num_hashes: int
    signature_size: int
    rows: np.ndarray  # uint8 [signature_size, row_bytes]

    @property
    def num_docs(self) -> int:
        return len(self.doc_names)

    @property
    def row_bytes(self) -> int:
        return (self.num_docs + 7) // 8


def _write_header(fp: BinaryIO, idx: ClassicIndex) -> None:
    fp.write(MAGIC)
    fp.write(struct.pack("<I", VERSION))
    fp.write(struct.pack("<I", idx.term_size))
    fp.write(struct.pack("<B", 1 if idx.canonicalize else 0))
    fp.write(struct.pack("<I", idx.num_docs))
    for name in idx.doc_names:
        fp.write(name.encode() + b"\0")
    fp.write(struct.pack("<I", idx.num_hashes))
    fp.write(struct.pack("<Q", idx.signature_size))


class CobsFormatError(ValueError):
    """A .cobs_classic file failed a named header sanity check. Every check
    carries a diagnosis so a field-order mismatch against real cobs-0.2.1
    artifacts produces an actionable error (see docs/cobs_format.md), never
    garbage scores."""


def _check(cond: bool, field: str, value, hint: str) -> None:
    if not cond:
        raise CobsFormatError(
            f"classic-index header field {field}={value!r} fails its sanity "
            f"check ({hint}). This usually means the header field order "
            "assumed here differs from the artifact's cobs version — see "
            "docs/cobs_format.md for the assumed layout and how to verify it."
        )


def _read_names(fp: BinaryIO, num_docs: int) -> list[str]:
    """NUL-terminated doc-name table, chunk-buffered (661k names in the real
    artifacts; byte-at-a-time reads would cost ~20M syscalls)."""
    names: list[str] = []
    buf = b""
    pos = 0
    while len(names) < num_docs:
        nul = buf.find(b"\0", pos)
        if nul < 0:
            chunk = fp.read(1 << 16)
            if not chunk:
                raise CobsFormatError(
                    f"truncated doc-name table: got {len(names)} of "
                    f"{num_docs} names before EOF"
                )
            buf = buf[pos:] + chunk
            pos = 0
            continue
        names.append(buf[pos:nul].decode())
        pos = nul + 1
    # un-read the overshoot past the final NUL
    if pos < len(buf):
        fp.seek(pos - len(buf), io.SEEK_CUR)
    return names


def _read_header(fp: BinaryIO) -> ClassicIndex:
    magic = fp.read(len(MAGIC))
    if magic != MAGIC:
        raise CobsFormatError(
            f"not a COBS classic index: magic bytes {magic!r} != {MAGIC!r}"
        )
    (version,) = struct.unpack("<I", fp.read(4))
    if version != VERSION:
        raise CobsFormatError(f"unsupported classic index version {version}")
    (term_size,) = struct.unpack("<I", fp.read(4))
    _check(1 <= term_size <= 64, "term_size", term_size,
           "k-mer length must be 1..64; the 661k DB uses 31")
    (canonicalize,) = struct.unpack("<B", fp.read(1))
    _check(canonicalize in (0, 1), "canonicalize", canonicalize,
           "must be a 0/1 byte")
    (num_docs,) = struct.unpack("<I", fp.read(4))
    _check(0 < num_docs < 50_000_000, "num_docs", num_docs,
           "documents per batch must be plausible (real batches hold ~2000)")
    names = _read_names(fp, num_docs)
    (num_hashes,) = struct.unpack("<I", fp.read(4))
    _check(1 <= num_hashes <= 16, "num_hashes", num_hashes,
           "Bloom hash count must be 1..16; the 661k DB uses 1")
    (signature_size,) = struct.unpack("<Q", fp.read(8))
    _check(0 < signature_size < (1 << 40), "signature_size", signature_size,
           "Bloom row count must be positive and < 2^40")
    return ClassicIndex(
        term_size=term_size,
        canonicalize=bool(canonicalize),
        doc_names=names,
        num_hashes=num_hashes,
        signature_size=signature_size,
        rows=np.empty((0, 0), dtype=np.uint8),
    )


def write_classic_index(path: str | os.PathLike, idx: ClassicIndex) -> None:
    """Serialize; '.xz' suffix triggers xz compression (like the Zenodo files)."""
    p = str(path)
    raw = io.BytesIO()
    _write_header(raw, idx)
    assert idx.rows.shape == (idx.signature_size, idx.row_bytes)
    raw.write(np.ascontiguousarray(idx.rows).tobytes())
    data = raw.getvalue()
    if p.endswith(".xz"):
        with lzma.open(p, "wb", preset=1) as f:
            f.write(data)
    else:
        with open(p, "wb") as f:
            f.write(data)


def read_classic_index(path: str | os.PathLike) -> ClassicIndex:
    """Load an index; '.xz' decompressed transparently (the reference streams
    via xzcat, scripts/run_cobs_streaming.sh:24-29)."""
    p = str(path)
    if p.endswith(".xz"):
        with lzma.open(p, "rb") as f:
            data = f.read()
        fp: BinaryIO = io.BytesIO(data)
    else:
        fp = open(p, "rb")
    try:
        idx = _read_header(fp)
        want = idx.signature_size * idx.row_bytes
        payload = fp.read(want)
        if len(payload) != want or fp.read(1):
            got = len(payload) + (1 if len(payload) == want else 0)
            raise CobsFormatError(
                f"bit-matrix payload size mismatch: header implies "
                f"{want} bytes ({idx.signature_size} rows x {idx.row_bytes} "
                f"row-bytes) but the file holds "
                f"{'more' if got > want else f'only {got}'}. The header "
                "parsed without tripping a field check, but its layout "
                "still disagrees with this file — see docs/cobs_format.md."
            )
        idx.rows = np.frombuffer(payload, dtype=np.uint8).reshape(
            idx.signature_size, idx.row_bytes
        )
        return idx
    finally:
        fp.close()


def inspect_classic_index(path: str | os.PathLike) -> dict:
    """Parse ONLY the header and report every field plus sanity/payload
    diagnostics — the offline compatibility probe for real Zenodo artifacts
    (run `phylign-tpu-torch inspect-index <file>` on a real download; if all checks
    pass, the format guess documented in docs/cobs_format.md is confirmed)."""
    p = str(path)
    if p.endswith(".xz"):
        with lzma.open(p, "rb") as f:
            data = f.read()
        total = len(data)
        fp: BinaryIO = io.BytesIO(data)
    else:
        total = os.stat(p).st_size
        fp = open(p, "rb")
    report: dict = {"path": p, "total_bytes": total, "ok": False}
    try:
        idx = _read_header(fp)
        header_end = fp.tell()
        want = idx.signature_size * idx.row_bytes
        report.update(
            term_size=idx.term_size,
            canonicalize=idx.canonicalize,
            num_docs=idx.num_docs,
            num_hashes=idx.num_hashes,
            signature_size=idx.signature_size,
            row_bytes=idx.row_bytes,
            header_bytes=header_end,
            payload_bytes_expected=want,
            payload_bytes_actual=total - header_end,
            doc_names_head=idx.doc_names[:3],
            doc_names_rid_prefixed=all(
                "_" in n and n.partition("_")[0].isdigit()
                for n in idx.doc_names[:16]
            ),
        )
        if total - header_end != want:
            report["error"] = (
                "payload size mismatch: header layout likely differs "
                "from this artifact's cobs version"
            )
        else:
            report["ok"] = True
        return report
    except CobsFormatError as e:
        report["error"] = str(e)
        return report
    finally:
        fp.close()


# --- construction (used for synthetic fixtures & index building) -------------


def calc_signature_size(
    num_elements: int, num_hashes: int = 1, fpr: float = DEFAULT_FPR
) -> int:
    """Bloom sizing identical in spirit to cobs classic_construct:
    rows = ceil(-h * n / ln(1 - fpr^(1/h)))."""
    import math

    if num_elements <= 0:
        return 64
    den = math.log(1.0 - fpr ** (1.0 / num_hashes))
    return max(64, int(math.ceil(-num_hashes * num_elements / den)))


def build_classic_index(
    docs: Sequence[tuple[str, list[bytes]]],
    term_size: int = DEFAULT_TERM_SIZE,
    num_hashes: int = 1,
    signature_size: int | None = None,
    fpr: float = DEFAULT_FPR,
) -> ClassicIndex:
    """Build an index from (doc_name, [sequences]) pairs.

    Sizing follows the largest document's distinct canonical-k-mer count
    (approximated by its distinct Bloom-row count at a large modulus), like
    cobs classic-construct sizes by the largest document in the batch.
    Bit insertion is idempotent, so duplicate k-mers need no dedup; hashing
    goes through cobs_row_indices (native C++ when available).
    """
    from phylign_tpu_torch.kmer import cobs_row_indices, encode_seq

    # pass 1: estimate distinct-kmer count of the largest doc for sizing
    if signature_size is None:
        big_mod = (1 << 61) - 1
        max_elems = 1
        for _, seqs in docs:
            rows_d = [
                cobs_row_indices(encode_seq(s), term_size, big_mod, 1)
                for s in seqs
                if len(s) >= term_size
            ]
            if rows_d:
                distinct = np.unique(np.concatenate(rows_d)).shape[0]
                max_elems = max(max_elems, distinct)
        signature_size = calc_signature_size(max_elems, num_hashes, fpr)

    num_docs = len(docs)
    row_bytes = (num_docs + 7) // 8
    rows = np.zeros((signature_size, row_bytes), dtype=np.uint8)
    for d, (_, seqs) in enumerate(docs):
        byte_idx, bit = d // 8, np.uint8(1 << (d % 8))
        for s in seqs:
            if len(s) < term_size:
                continue
            r = cobs_row_indices(
                encode_seq(s), term_size, signature_size, num_hashes
            )
            for h in range(num_hashes):
                rows[r[:, h], byte_idx] |= bit
    return ClassicIndex(
        term_size=term_size,
        canonicalize=True,
        doc_names=[name for name, _ in docs],
        num_hashes=num_hashes,
        signature_size=signature_size,
        rows=rows,
    )


def build_index_from_tar(
    tar_path: str | os.PathLike,
    term_size: int = DEFAULT_TERM_SIZE,
    num_hashes: int = 1,
    fpr: float = DEFAULT_FPR,
    add_rid_prefix: bool = True,
    seed: int = 0,
) -> ClassicIndex:
    """Index construction from a batch assembly tarball: builds the paired
    .cobs_classic artifact for a .tar.xz of genome FASTAs (the artifact pair
    the reference downloads together: its Snakefile:196-207).
    Doc names get the 661k-style random sort prefix 'NNNN_' unless disabled
    (the reference's postprocess_cobs.py:16-18 strips it)."""
    from phylign_tpu_torch.io.asmtar import iter_batch_assemblies
    from phylign_tpu_torch.kmer import decode_seq

    rng = np.random.default_rng(seed)
    docs: list[tuple[str, list[bytes]]] = []
    for rname, contigs in iter_batch_assemblies(tar_path):
        name = (
            f"{int(rng.integers(0, 10000)):04d}_{rname}" if add_rid_prefix else rname
        )
        docs.append((name, [decode_seq(codes) for _, codes in contigs]))
    return build_classic_index(docs, term_size, num_hashes, fpr=fpr)


# --- device repacking --------------------------------------------------------


@dataclass
class DeviceIndex:
    """Device-friendly packed index: uint32 word matrix + metadata.

    words[s, w] bit (d % 32) of word (d // 32) == doc d's bit in Bloom row s.
    The word matrix is what the match kernels gather rows from.
    """

    term_size: int
    num_hashes: int
    signature_size: int
    doc_names: list[str]
    words: np.ndarray  # uint32 [signature_size, ceil(num_docs/32)]
    #: (path, mtime_ns, size) of the on-disk device-format source, set by
    #: load_device_index — lets the pipeline memoize the content hash
    #: instead of re-hashing the word matrix every run
    source_sig: tuple | None = None

    @property
    def num_docs(self) -> int:
        return len(self.doc_names)

    @property
    def num_words(self) -> int:
        return self.words.shape[1]


def to_device_index(idx: ClassicIndex) -> DeviceIndex:
    num_words = (idx.num_docs + 31) // 32
    padded = np.zeros((idx.signature_size, num_words * 4), dtype=np.uint8)
    padded[:, : idx.row_bytes] = idx.rows
    words = padded.view(np.dtype("<u4")).reshape(idx.signature_size, num_words)
    return DeviceIndex(
        term_size=idx.term_size,
        num_hashes=idx.num_hashes,
        signature_size=idx.signature_size,
        doc_names=idx.doc_names,
        words=np.ascontiguousarray(words),
    )


def save_device_index(dirpath: str | os.PathLike, didx: DeviceIndex) -> None:
    """Persist as raw .npy + JSON sidecar; .npy loads back via memmap so a
    10 GB batch never needs a second host copy (the reference analogously
    caches decompressed indexes, config.yaml:131-138)."""
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "words.npy", didx.words)
    meta = {
        "term_size": didx.term_size,
        "num_hashes": didx.num_hashes,
        "signature_size": didx.signature_size,
        "doc_names": didx.doc_names,
    }
    (d / "meta.json").write_text(json.dumps(meta))


def load_device_index(dirpath: str | os.PathLike, mmap: bool = True) -> DeviceIndex:
    d = Path(dirpath)
    meta = json.loads((d / "meta.json").read_text())
    wp = d / "words.npy"
    words = np.load(wp, mmap_mode="r" if mmap else None)
    st = wp.stat()
    return DeviceIndex(
        term_size=meta["term_size"],
        num_hashes=meta["num_hashes"],
        signature_size=meta["signature_size"],
        doc_names=meta["doc_names"],
        words=words,
        source_sig=(str(wp), st.st_mtime_ns, st.st_size),
    )


def strip_rid(doc_name: str) -> str:
    """Strip the random sort prefix embedded in 661k doc names: 'rid_ACC' ->
    'ACC' (the reference's scripts/postprocess_cobs.py:16-18 and
    filter_queries.py cobs_iterator split)."""
    _, sep, rest = doc_name.partition("_")
    return rest if sep else doc_name
