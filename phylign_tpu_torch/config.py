"""Typed configuration mirroring the reference's config.yaml.

Key-for-key compatible with config.yaml:1-139 (the search
section affects results; the performance section does not), plus TPU-native
extensions (device batching, mesh shape). A reference config.yaml loads
unchanged; unknown keys error loudly so typos don't silently change runs.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import yaml

log = logging.getLogger("phylign_tpu_torch.config")

# Keys accepted for reference-config compatibility that have no effect in
# this architecture (ref: config.yaml:89-125). Each maps to
# the one-line reason logged when a config sets it explicitly — silently
# ignoring them would imply the reference semantics apply.
INERT_KEYS = {
    "cobs_threads": "COBS query threading is replaced by the device kernel grid",
    "minimap_threads": "minimap2 threading is replaced by batched device alignment",
    "prefer_pipe": "there are no inter-process pipes in this architecture",
}


@dataclass
class Config:
    # --- search parameters (affect results; config.yaml:1-42) ---
    batches: str = "data/batches_full.txt"
    cobs_kmer_thres: float = 0.7
    nb_best_hits: int = 100
    minimap_preset: str = "sr"
    minimap_extra_params: str = "--eqx"

    # --- performance parameters (config.yaml:44-125) ---
    threads: int | str = "all"
    max_ram_gb: int = 12
    max_download_threads: int = 8
    download_retries: int = 3
    download_retry_wait: int = 10
    download_dir: str = "."
    cobs_threads: int | str = "auto"
    index_load_mode: str = "mem-stream"  # mem-stream | mem-disk | mmap-disk
    max_io_heavy_threads: int = 8
    minimap_threads: int = 1
    prefer_pipe: bool = True

    # --- misc (config.yaml:128-139) ---
    keep_cobs_indexes: bool = False
    decompression_dir: str | None = None

    # --- TPU-native extensions (no reference equivalent) ---
    device_hbm_gb: float = 12.0  # HBM budget for resident batch indexes
    # device-resident index cache (content-hash keyed): repeated runs over
    # the same batches skip the index H2D upload entirely — the dominant
    # per-batch cost through a slow host-device link. Carved out of the HBM
    # budget at pipeline init; 0 disables.
    device_index_cache_gb: float = 4.0
    # queries per match device call. Each call costs fixed dispatch+fetch
    # round trips (30-80 ms each through a slow host link), so bigger chunks
    # amortize them; the [Q, 32*Wp] transient score matrix bounds it above
    # (8192 x 2176 x 4 B = 71 MB at the largest real batch width).
    # "auto" sizes the chunk per batch so the transient [Q, 32*Wp] int32
    # score matrix stays under ~256 MB (=> 8192 queries at the largest real
    # 661k batch width, 32k+ at typical widths — fewer fixed-cost
    # dispatch/fetch round trips per batch); an integer pins it.
    device_query_chunk: int | str = "auto"
    # decoded-genome disk cache for assembly tars: one sequential tar.xz
    # pass per batch writes 2-bit-coded contigs to
    # intermediate/02_asms_decoded/, and later align runs mmap ONLY the
    # candidate genomes' bytes instead of re-streaming the whole archive
    # (the asm analogue of keep_cobs_indexes; costs ~decompressed-genome
    # disk per batch — disable at full 661k scale if disk is tight).
    asm_cache: bool = True
    # combined disk budget (GB) for the two persistent caches above (the
    # device-format index cache and the decoded-asm cache): least-recently
    # -used batch entries are evicted once the total crosses the budget,
    # so a full-661k run cannot grow unboundedly past the reference's
    # documented ~120 GB disk contract (README.md:95-96). <= 0 disables
    # eviction. Enforcement runs after each cache build, so transient
    # overshoot is bounded by the in-flight batches' sizes.
    cache_max_disk_gb: float = 50.0
    # cross-query k-mer dedup in the match kernel (two-stage gather; beats
    # the gather roofline at >= ~45% shared k-mers, bit-identical output).
    # Opt-in: the host-side unique pass only pays off on hosts where it is
    # cheaper than the device time it saves (see docs/performance.md).
    match_dedup: bool = False
    # align pairs pooled per device flush (bigger pools amortize the fixed
    # per-flush dispatch/fetch cost; FUSED_MAX_CELLS still splits oversized
    # chunks on device). Measured sweet spot 16384 (23.7k pairs/s vs 20k at
    # 8192 and 18.7k at 32768 through the relay).
    device_pair_chunk: int = 16384
    mesh_shape: str = "1x1"  # doc-shard x data-parallel mesh (parallel.mesh)
    filter_mode: str = "auto"  # auto (native arrays when available) | streaming
    output_dir: str = "output"
    intermediate_dir: str = "intermediate"
    logs_dir: str = "logs"

    def effective_threads(self) -> int:
        if self.threads == "all":
            return os.cpu_count() or 1
        return int(self.threads)

    @classmethod
    def from_yaml(cls, path: str | os.PathLike) -> "Config":
        data = yaml.safe_load(Path(path).read_text()) or {}
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        for key in sorted(set(data) & set(INERT_KEYS)):
            log.warning(
                "config key %r accepted for compatibility but has no effect: %s",
                key, INERT_KEYS[key],
            )
        cfg = cls(**data)
        if cfg.nb_best_hits < 1:
            # the reference crashes on nb_best_hits=0 deep inside
            # filter_queries.py _housekeeping (IndexError on an empty
            # list); fail loudly at config load instead
            raise ValueError(
                f"nb_best_hits must be >= 1 (got {cfg.nb_best_hits})"
            )
        if not 0.0 <= float(cfg.cobs_kmer_thres) <= 1.0:
            raise ValueError(
                f"cobs_kmer_thres must be in [0, 1] (got {cfg.cobs_kmer_thres})"
            )
        return cfg

    def with_overrides(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **{k: v for k, v in kw.items() if v is not None})
