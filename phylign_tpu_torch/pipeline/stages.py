"""The end-to-end pipeline: preprocess -> match -> filter -> align ->
aggregate -> stats (the counterpart of ``phylign_tpu/pipeline/stages.py``),
over the same on-disk layout, so intermediates are drop-in comparable:

    intermediate/00_queries_preprocessed/{stem}.fa      (rule fix_query)
    intermediate/01_queries_merged/{merged}.fa          (rule concatenate_queries)
    intermediate/03_match/{batch}____{merged}.gz        (rule decompress_and_run_cobs)
    intermediate/04_filter/{merged}.fa                  (rule translate_matches)
    intermediate/05_map/{batch}____{merged}.sam.gz      (rule batch_align_minimap2)
    output/{merged}.sam_summary.gz, .stats              (aggregate_sams, final_stats)

Host-side work (xz decode, index loading, tar streaming, anchor collection)
runs on thread pools; device work serializes through the scheduler's device
lock and flush slots, and all of it is queued on the device's current CUDA
stream. Every unit is benchmark-logged and manifest-checkpointed.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from phylign_tpu_torch.align.engine import AlignParams, align_batches_pooled
from phylign_tpu_torch.config import Config
from phylign_tpu_torch.io import cobs as cobs_io
from phylign_tpu_torch.io.fastx import (
    FastxRecord,
    normalize_and_merge,
    read_fastx_file,
    write_fasta,
    xopen_read,
    xopen_write,
)
from phylign_tpu_torch.io.sam import aggregate_sams, write_batch_sam
from phylign_tpu_torch.io.stats import compute_stats
from phylign_tpu_torch.match.filter import (
    filter_queries_streaming,
    read_filtered_fasta,
    write_filtered_fasta,
)
from phylign_tpu_torch.match.postprocess import read_match_file
from phylign_tpu_torch.pipeline.manifest import Manifest, atomic_write_via
from phylign_tpu_torch.pipeline.scheduler import Job, Scheduler
from phylign_tpu_torch.models.matcher import (
    ChunkedMatcher,
    DeviceQueryHashes,
    Matcher,
    _dedup_row_sets,
    device_index_bytes,
)
from phylign_tpu_torch.ops._kernels import KernelError, build_all
from phylign_tpu_torch.parallel.launch import shard_batches
from phylign_tpu_torch.utils.bench import RamSampler, benchmark
from phylign_tpu_torch.utils import trace
from phylign_tpu_torch.utils.platform import resolve_device

log = logging.getLogger("phylign_tpu_torch.pipeline")


class QuerySet:
    """One merged read set, prepared once and shared across batch match jobs.

    records    parsed merged FASTA records (output order);
    rep_of     int64 [n_records] -> index into the UNIQUE query list
               (duplicate reads / RC duplicates share canonical k-mer
               multisets, so they score identically against every batch);
    uraw       per-unique-query raw XXH64 hashes (uint64 [n, H]);
    device_chunk(off, size, devices) lazily uploads a unique-query slice's
    hashes to the device ONCE (models.matcher.DeviceQueryHashes), and copies
    them to each further device of a mesh once — every batch then mods +
    gathers on the device(s) with no per-batch query upload."""

    def __init__(
        self,
        records: list[FastxRecord],
        rep_of: np.ndarray,
        uraw: list[np.ndarray],
        device: torch.device,
    ):
        self.records = records
        self.rep_of = rep_of
        self.uraw = uraw
        self.device = device
        self._dq: dict = {}
        self._lock = threading.Lock()
        # adaptive fetch-cap hint: max qualifying-hit total any batch has
        # produced for this read set so far (None = no history). Later
        # batches size their compacted device->host hit buffer from it
        # instead of the worst-case topn+ties window.
        self.hit_hint: int | None = None

    def raw_per_record(self) -> list[np.ndarray]:
        return [self.uraw[j] for j in self.rep_of]

    def device_chunk(self, off: int, size: int, devices=()) -> DeviceQueryHashes:
        """The chunk [off, off + size) of the unique queries, with its copy
        on each of ``devices`` (a mesh's)."""
        key = (off, size)
        with self._lock:
            dq = self._dq.get(key)
        if dq is None:
            dq = DeviceQueryHashes.build(self.uraw[off : off + size], self.device)
            with self._lock:
                # bound device residency: keep at most TWO chunk layouts
                # (evicting the least-recent layout keeps device memory at
                # ~2x the query hash set; in-flight users keep their tensors
                # alive via ordinary references)
                sizes = {s for (_, s) in self._dq}
                if size not in sizes and len(sizes) >= 2:
                    drop = next(iter(self._dq))[1]  # oldest layout's size
                    for k in [k for k in self._dq if k[1] == drop]:
                        del self._dq[k]
                dq = self._dq.setdefault(key, dq)
        for dev in devices:
            dq.on(dev)
        return dq


class _IndexCache:
    """Device-resident Matcher cache keyed by index CONTENT hash.

    Repeated runs (or several query files) over the same batches skip the
    index upload. The byte budget is carved out of the pipeline's device
    memory accountant once at init, so cached indexes can never starve
    transient uploads."""

    def __init__(self, budget_mb: int):
        import collections

        self.budget = budget_mb
        self.used = 0
        self.items: "collections.OrderedDict[tuple, tuple]" = (
            collections.OrderedDict()
        )
        self.lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self.lock:
            it = self.items.get(key)
            if it is None:
                self.misses += 1
                trace.count("match.index_cache_misses")
                return None
            self.items.move_to_end(key)
            self.hits += 1
            trace.count("match.index_cache_hits")
            return it[0]

    def put(self, key, matcher, mb: int) -> bool:
        """Insert; True iff the cache now owns the device bytes."""
        if mb > self.budget:
            return False
        with self.lock:
            if key in self.items:
                return False  # already owned; caller keeps its reservation
            while self.used + mb > self.budget and self.items:
                _, (_old, omb) = self.items.popitem(last=False)
                self.used -= omb  # device memory frees when the ref drops
            self.items[key] = (matcher, mb)
            self.used += mb
            return True


#: process-global device index cache: a service keeps hot batch indexes
#: RESIDENT in device memory across query workloads (the device-level
#: analogue of the reference's keep_cobs_indexes cache). Content-hash keys
#: (with the device) make staleness impossible.
_global_index_cache: "_IndexCache | None" = None
_global_index_cache_lock = threading.Lock()


def _shared_index_cache(cache_mb: int) -> "_IndexCache | None":
    global _global_index_cache
    if cache_mb <= 0:
        return None
    with _global_index_cache_lock:
        if _global_index_cache is None:
            _global_index_cache = _IndexCache(cache_mb)
        else:
            # devices are shared process-wide: keep the largest budget
            _global_index_cache.budget = max(
                _global_index_cache.budget, cache_mb
            )
        return _global_index_cache


_warmed = False
_warm_lock = threading.Lock()


def _warm_device_async(device: torch.device) -> threading.Thread | None:
    """On a CUDA device, create the CUDA context and build the kernel
    libraries (``ops/_kernels.build_all``) on a daemon thread at pipeline
    start, so the first match call does not wait for nvcc: the build
    overlaps host preprocessing and index decode. Once per process; on the
    CPU nothing starts. A failed build is logged at WARNING, and the first
    launch then raises its KernelError (``library`` waits for the build in
    flight and never starts a second one). Returns the thread, if any."""
    global _warmed
    with _warm_lock:
        if device.type != "cuda" or _warmed:
            return None
        _warmed = True

    def _touch():
        try:
            torch.zeros(8, device=device).sum().item()
        except Exception as e:  # noqa: BLE001 - the first real use raises it again
            log.warning("device warm-up: no CUDA context: %s", e)
        try:
            build_all()
        except Exception as e:  # noqa: BLE001 - the first launch raises it again
            log.warning("device warm-up: kernel build failed: %s", e)

    t = threading.Thread(target=_touch, daemon=True, name="device-warmup")
    t.start()
    return t


class Pipeline:
    def __init__(
        self,
        config: Config,
        workdir: str | Path = ".",
        device: str | torch.device = "cuda",
        mesh_devices=None,
    ):
        """``mesh_devices``: the devices of cfg.mesh_shape's cells (a list,
        which may repeat a device); default every visible card on cuda, the
        CPU for every cell on cpu."""
        self.device = resolve_device(device)
        _warm_device_async(self.device)
        self.cfg = config
        self._mesh = None  # built lazily from cfg.mesh_shape
        self._mesh_devices = mesh_devices
        self._longest_read: dict[str, int] = {}  # by stem, from preprocess
        self.root = Path(workdir)
        self.inter = self.root / config.intermediate_dir
        self.out = self.root / config.output_dir
        self.logs = self.root / config.logs_dir
        self.manifest = Manifest(self.inter)
        self.sched = Scheduler(
            workers=config.effective_threads(),
            max_ram_mb=config.max_ram_gb * 1024,
            max_io_heavy=config.max_io_heavy_threads,
            hbm_mb=int(config.device_hbm_gb * 1024),
        )
        for d in ("00_queries_preprocessed", "01_queries_merged", "03_match",
                  "04_filter", "05_map"):
            (self.inter / d).mkdir(parents=True, exist_ok=True)
        self.out.mkdir(parents=True, exist_ok=True)
        cache_mb = int(config.device_index_cache_gb * 1024)
        # never let the cache take more than half the device budget
        cache_mb = min(cache_mb, int(config.device_hbm_gb * 1024) // 2)
        self._index_cache = None
        if cache_mb > 0:
            self.sched.hbm.acquire(cache_mb)  # carve the budget out once
            self._index_cache = _shared_index_cache(cache_mb)
        # capacity left for transient (non-cached) index uploads; indexes
        # that cannot fit here with align headroom stream row-chunked
        self._hbm_transient_mb = int(config.device_hbm_gb * 1024) - cache_mb
        # per-stem query cache: parsed records + raw k-mer hashes. A Bloom
        # row is hash % signature_size, so one hashing pass serves every
        # batch. Guarded by a lock — match jobs run on scheduler threads.
        self._query_cache: dict = {}
        self._query_cache_lock = threading.Lock()

    # --- paths ---------------------------------------------------------------

    def batches(self) -> list[str]:
        return [
            ln.strip()
            for ln in Path(self.root / self.cfg.batches).read_text().splitlines()
            if ln.strip()
        ]

    def cobs_path(self, batch: str) -> Path:
        return self.root / self.cfg.download_dir / "cobs" / f"{batch}.cobs_classic.xz"

    def asms_path(self, batch: str) -> Path:
        return self.root / self.cfg.download_dir / "asms" / f"{batch}.tar.xz"

    def merged_fa(self, stem: str) -> Path:
        return self.inter / "01_queries_merged" / f"{stem}.fa"

    def match_path(self, batch: str, stem: str) -> Path:
        return self.inter / "03_match" / f"{batch}____{stem}.gz"

    def filter_path(self, stem: str) -> Path:
        return self.inter / "04_filter" / f"{stem}.fa"

    def map_path(self, batch: str, stem: str) -> Path:
        return self.inter / "05_map" / f"{batch}____{stem}.sam.gz"

    # --- stage 0+1: preprocess & merge --------------------------------------

    @trace.spanned("stage.preprocess")
    def preprocess(self, inputs: Sequence[str]) -> str:
        stem, records = normalize_and_merge(inputs)
        self._longest_read[stem] = max((len(r.seq) for r in records), default=0)
        merged = self.merged_fa(stem)
        if self.manifest.done("merge", stem, [str(merged)]):
            return stem
        with benchmark(self.logs, "fix_query", stem):
            from phylign_tpu_torch.io.fastx import file_stem, normalize_record

            for p in inputs:
                out0 = (
                    self.inter / "00_queries_preprocessed" / f"{file_stem(p)}.fa"
                )
                with open(out0, "w") as f:
                    write_fasta(
                        f, (normalize_record(r) for r in read_fastx_file(p))
                    )
            tmp, commit = atomic_write_via(merged)
            with open(tmp, "w") as f:
                write_fasta(f, records)
            commit()
        self.manifest.mark("merge", stem, [str(merged)])
        return stem

    # --- stage 2+3: match ----------------------------------------------------

    def _query_set(self, stem: str, term_size: int, num_hashes: int) -> QuerySet:
        """The merged read set prepared ONCE per (stem, k, H) and shared by
        every batch's match job: parsed records, raw k-mer hashes (a Bloom
        row is just `hash % signature_size` per batch), the duplicate-read
        dedup, and lazily-uploaded device-resident hash chunks."""
        src = self.merged_fa(stem)
        st = src.stat()  # mtime+size key: a regenerated file invalidates
        key = ("match", stem, term_size, num_hashes, st.st_mtime_ns, st.st_size)
        with self._query_cache_lock:
            hit = self._query_cache.get(key)
        if hit is not None:
            return hit
        from phylign_tpu_torch.kmer import cobs_kmer_hashes_batch, encode_seq

        records = list(read_fastx_file(src))
        raw = cobs_kmer_hashes_batch(
            [encode_seq(r.seq.encode()) for r in records],
            term_size,
            num_hashes,
        )
        rep_of, uraw = _dedup_row_sets(raw)
        qs = QuerySet(records, np.asarray(rep_of, np.int64), uraw, self.device)
        with self._query_cache_lock:
            # one read set live at a time per cache family
            for k in [k for k in self._query_cache if k[0] == "match"]:
                del self._query_cache[k]
            self._query_cache[key] = qs
        return qs

    @trace.spanned("match.write")
    def _commit_match_output(
        self, batch: str, stem: str, qs: QuerySet, hits_u, nk_u, doc_names,
    ) -> Path:
        """Write + atomically commit one batch's 03_match file and mark the
        manifest — the ONE place encoding that contract (shared by the job
        path and the pipelined path, which must stay byte-identical for
        manifest-based fallback/resume)."""
        out = self.match_path(batch, stem)
        tmp, commit = atomic_write_via(out)
        with xopen_write(tmp) as f:
            self._write_match_unique(
                f, qs, hits_u, nk_u, doc_names, keep=self.cfg.nb_best_hits
            )
        commit()
        self.manifest.mark("match", f"{batch}____{stem}", [str(out)])
        return out

    def match_one_batch(self, batch: str, stem: str) -> Path:
        out = self.match_path(batch, stem)
        if self.manifest.done("match", f"{batch}____{stem}", [str(out)]):
            return out
        with benchmark(self.logs, "run_cobs", f"{batch}____{stem}"):
            with trace.span("match.load"):
                didx = self._load_index(batch)
            qs = self._query_set(stem, didx.term_size, didx.num_hashes)
            hits_u, nk_u = self._score_batch(didx, qs)
            if self.mesh() is None or self.mesh().rank == 0:
                self._commit_match_output(
                    batch, stem, qs, hits_u, nk_u, didx.doc_names
                )
        if (
            self.cfg.index_load_mode != "mem-stream"
            and not self.cfg.keep_cobs_indexes
        ):
            # reference semantics: the decompressed index is temp() unless
            # keep_cobs_indexes
            del didx  # release the mmap before unlinking
            self.drop_index_cache(batch)
        return out

    def _decompression_dir(self) -> Path:
        # reference default: intermediate/02_cobs_decompressed
        if self.cfg.decompression_dir:
            return self.root / self.cfg.decompression_dir
        return self.inter / "02_cobs_decompressed"

    def _load_index(self, batch: str) -> cobs_io.DeviceIndex:
        """Honor the reference's index_load_mode semantics:
          mem-stream  decode xz straight into the in-RAM device repack;
          mem-disk    cache the device-format index on disk, load fully;
          mmap-disk   cache on disk, memmap word rows on demand.
        Both disk modes return a read-only memmap; the upload copies it
        once into pinned memory (models.matcher.upload_words)."""
        mode = self.cfg.index_load_mode
        if mode == "mem-stream":
            idx = cobs_io.read_classic_index(self.cobs_path(batch))
            return cobs_io.to_device_index(idx)
        if mode not in ("mem-disk", "mmap-disk"):
            raise ValueError(f"unknown index_load_mode: {mode}")
        cache = self._decompression_dir() / batch
        for _attempt in range(3):
            meta = cache / "meta.json"
            built = not meta.exists()
            if built:
                idx = cobs_io.read_classic_index(self.cobs_path(batch))
                didx = cobs_io.to_device_index(idx)
                cobs_io.save_device_index(cache, didx)
                del idx
            else:
                try:
                    os.utime(meta)  # LRU stamp for utils.diskbudget
                except OSError:
                    pass
            try:
                out = cobs_io.load_device_index(cache, mmap=True)
            except OSError:
                continue  # evicted by a concurrent budget pass; rebuild
            if built:
                # enforce AFTER the memmap opens: POSIX keeps an unlinked
                # file readable through the open map
                self._enforce_cache_budget()
            return out
        # cache dir is being evicted faster than we can rebuild (budget
        # ~0): serve the index straight from the xz decode
        idx = cobs_io.read_classic_index(self.cobs_path(batch))
        return cobs_io.to_device_index(idx)

    def _enforce_cache_budget(self) -> None:
        """LRU-evict the persistent disk caches down to cache_max_disk_gb
        (utils.diskbudget), after each cache-entry build."""
        gb = self.cfg.cache_max_disk_gb
        if not gb or gb <= 0:
            return
        from phylign_tpu_torch.utils.diskbudget import enforce_budget

        dirs = [self._decompression_dir()]
        if self.cfg.asm_cache:
            # the align stage's decoded-assembly cache shares the budget
            ad = self._asm_cache_dir()
            if ad:
                dirs.append(Path(ad))
        enforce_budget(dirs, int(gb * 1e9))

    def _asm_cache_dir(self) -> str | None:
        if not self.cfg.asm_cache:
            return None
        # prefer the persistent decompression dir (the reference's cache
        # location for decompressed artifacts, config.yaml:131-138) so the
        # decode pass survives `intermediate/` cleanup between runs
        if self.cfg.decompression_dir:
            d = self.root / self.cfg.decompression_dir / "asms"
        else:
            d = self.inter / "02_asms_decoded"
        d.mkdir(parents=True, exist_ok=True)
        return str(d)

    @trace.spanned("match.drop")
    def drop_index_cache(self, batch: str | None = None) -> None:
        """Remove cached decompressed indexes (keep_cobs_indexes=False
        semantics)."""
        import shutil

        d = self._decompression_dir()
        if not d.exists():
            return
        targets = [d / batch] if batch else list(d.iterdir())
        for t in targets:
            if t.is_dir():
                shutil.rmtree(t)

    #: device memory held back from transient match-index budgeting for the
    #: align stage's flush buffers (two 640 MB slots + margin)
    ALIGN_RESERVE_MB = 1536

    def mesh(self):
        """The device mesh of cfg.mesh_shape, or None for one device
        ('1x1'). Built lazily. In a torch.distributed group of several
        processes (``--distributed``) the mesh spans them, as JAX's global
        mesh does: its cells are dealt to the ranks in row-major blocks
        (parallel.mesh), each rank's cells on its own devices: the card
        ``init_distributed`` pinned when a rank holds one cell, else every
        visible card (or the CPU for every cell)."""
        if self.cfg.mesh_shape in ("1x1", "", None):
            return None
        if self._mesh is None:
            import torch.distributed as dist

            from phylign_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape

            nd, nq = parse_mesh_shape(self.cfg.mesh_shape)
            spans = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
            world = dist.get_world_size() if spans else 1
            devices = self._mesh_devices
            if devices is None:
                if self.device.type != "cuda":
                    devices = self.device
                elif spans and nd * nq == world:
                    devices = [torch.device("cuda", torch.cuda.current_device())]
                else:
                    have = torch.cuda.device_count()
                    if nd * nq > have * world:
                        raise ValueError(
                            f"mesh_shape {self.cfg.mesh_shape} needs {nd * nq} "
                            f"devices, have {have} x {world} process(es)"
                        )
            self._mesh = make_mesh(nd, nq, devices, group=dist.group.WORLD if spans else None)
            if spans:
                log.info(
                    "mesh %s over %d processes: rank %d holds cells %s",
                    self.cfg.mesh_shape, world, self._mesh.rank, self._mesh.local_cells(),
                )
        return self._mesh

    def _spanning_mesh(self) -> bool:
        mesh = self.mesh()
        return mesh is not None and mesh.world > 1

    def _align_mesh(self):
        """The align stage's mesh. Its work splits over "q" alone, so on a
        mesh that spans processes each rank aligns its own share of the
        batches over the query columns of its own cells (Mesh.local), with
        no collective whose order would depend on its threads."""
        return self.mesh().local() if self._spanning_mesh() else self.mesh()

    def match_share(self, num: int, rank: int) -> list[str]:
        """The batches process ``rank`` of ``num`` matches: its round-robin
        share, or every batch on a mesh that spans the processes (each
        batch's scoring then runs on every rank, and rank 0 writes it)."""
        if self._spanning_mesh():
            return self.batches()
        return shard_batches(self.batches(), num, rank)

    def _chunk_budget_mb(self) -> int:
        """Per-call device budget for row-chunked (oversized-index) scoring
        — THE shared definition; the pipelined guard must estimate with the
        same number _score_batch_begin routes/acquires with."""
        return max(256, self._hbm_transient_mb - self.ALIGN_RESERVE_MB)

    def _score_batch_begin(self, didx: cobs_io.DeviceIndex, qs: QuerySet) -> dict:
        """DISPATCH one batch's scoring; pair with _score_batch_end.

        Only UNIQUE queries are scored (qs.rep_of broadcasts the results to
        duplicates), and on the resident path their hashes are
        device-resident: the per-batch work is one hash -> kernel -> top-k
        -> compaction sequence plus the hit buffer's copy.

        A mesh of one process takes the same hash path on every device of
        the mesh (Matcher.score_hits_hashes_begin); a mesh that spans
        processes, dedup and the raw fallback score synchronously. Paths
        that must fetch internally (empty batch, oversized/chunked index)
        return a {"sync": results} state;
        the async path returns the dispatched slots so the caller can fetch
        many batches together (_match_pipelined). The device memory
        accountant bounds how many transient indexes are resident at once."""
        records = qs.records
        trace.count("match.batches")
        trace.count("match.queries_scored", len(qs.uraw))
        use_device = didx.num_docs > 0 and len(records) > 0
        if not use_device:
            return {"sync": ([[] for _ in qs.uraw], [0] * len(qs.uraw))}
        mesh = self.mesh()
        hbm_mb = max(1, device_index_bytes(didx, mesh=mesh) // 1_000_000)
        # an index too big to sit resident next to the align stage's device
        # buffers streams row-chunked through the device instead (exact for
        # the 661k database's 1-hash indexes)
        chunk_budget = self._chunk_budget_mb()
        if mesh is None and didx.num_hashes == 1 and hbm_mb > chunk_budget:
            return {"sync": self._score_batch_chunked(didx, qs, chunk_budget)}
        key = matcher = None
        if self._index_cache is not None and hbm_mb <= self._index_cache.budget:
            key = (
                self._index_hash(didx),
                str(self.device),
                None if mesh is None else (mesh.nd, mesh.nq, mesh.world, mesh.rank, mesh.devices),
            )
            matcher = self._index_cache.get(key)
        transient = matcher is None
        if transient:
            self.sched.hbm.acquire(hbm_mb)
        try:
            if matcher is None:
                with trace.span("match.upload"):
                    matcher = Matcher.from_device_index(didx, self.device, mesh=mesh)
            matcher.dedup = self.cfg.match_dedup
            chunk = self.cfg.device_query_chunk
            if not isinstance(chunk, int):  # "auto": bound the transient
                # [Q, 32*Wp] int32 score matrix at ~256 MB per call,
                # quantized DOWN to a power of two so batches of different
                # widths share at most a handful of chunk layouts (the
                # QuerySet device-hash cache is keyed by (off, size))
                wp = max(1, int(didx.words.shape[1]))
                chunk = max(1024, min(32768, (256 << 20) // (wp * 128)))
                chunk = 1 << (chunk.bit_length() - 1)
            use_hashes = (
                (mesh is None or mesh.world == 1)
                and not matcher.dedup and didx.num_docs <= 65535
            )
            devices = () if mesh is None else mesh.devices
            thr, topn = self.cfg.cobs_kmer_thres, self.cfg.nb_best_hits
            # adaptive fetch cap from this read set's history: 4x the
            # largest per-batch hit total seen, power-of-two quantized. A
            # too-small cap overflows into the dense-window fallback
            # (correct, slower); the first batch uses the safe worst case.
            cap_hint = None
            if qs.hit_hint is not None:
                cap_hint = 1 << max(12, (4 * qs.hit_hint + 2048).bit_length())
            slots: list = []
            # dispatch under the device lock, fetch + assemble OUTSIDE it;
            # slots keep chunk order even if some chunks take the
            # synchronous paths
            with trace.span("match.dispatch"), self.sched.device_lock:
                for off in range(0, len(qs.uraw), chunk):
                    if use_hashes:
                        dqc = qs.device_chunk(off, chunk, devices)
                        ctx = matcher.score_hits_hashes_begin(
                            dqc, thr, topn, cap=cap_hint
                        )
                        if ctx is not None:
                            slots.append(("pending", ctx))
                        else:
                            slots.append(
                                ("done", matcher.score_hits_hashes(dqc, thr, topn))
                            )
                    else:
                        slots.append(
                            (
                                "done",
                                matcher.score_hits_raw(
                                    qs.uraw[off : off + chunk], thr, topn
                                ),
                            )
                        )
        except BaseException:
            if transient:
                self.sched.hbm.release(hbm_mb)
            raise
        return {
            "matcher": matcher,
            "slots": slots,
            "transient": transient,
            "key": key,
            "hbm_mb": hbm_mb,
        }

    @trace.spanned("match.assemble")
    def _score_batch_end(
        self, st: dict, fetched: dict | None = None, qs: QuerySet | None = None
    ) -> tuple[list[list[tuple[int, int]]], list[int]]:
        """FETCH + assemble a _score_batch_begin dispatch. ``fetched`` maps
        slot index -> already-fetched host buffer (the grouped fetch of
        _match_pipelined); missing slots fetch individually. ``qs`` (when
        given) records the batch's hit total as the adaptive-cap hint for
        later batches."""
        if "sync" in st:
            return st["sync"]
        matcher = st["matcher"]
        hits_u: list[list[tuple[int, int]]] = []
        nk_u: list[int] = []
        try:
            for si, (kind, payload) in enumerate(st["slots"]):
                if kind == "pending":
                    pre = None if fetched is None else fetched.get(si)
                    hl, nk = matcher.score_hits_hashes_end(
                        payload,
                        device_lock=self.sched.device_lock,
                        fetched=pre,
                    )
                else:
                    hl, nk = payload
                hits_u.extend(hl)
                nk_u.extend(int(x) for x in nk)
        finally:
            if st["transient"]:
                st["transient"] = False  # abort paths must not double-release
                if st["key"] is not None:
                    # on success ownership moves to the cache's budget
                    self._index_cache.put(st["key"], matcher, st["hbm_mb"])
                self.sched.hbm.release(st["hbm_mb"])
        if qs is not None:
            emitted = sum(len(h) for h in hits_u)
            qs.hit_hint = max(qs.hit_hint or 0, emitted)
        return hits_u, nk_u

    def _score_batch(
        self, didx: cobs_io.DeviceIndex, qs: QuerySet
    ) -> tuple[list[list[tuple[int, int]]], list[int]]:
        """Score all queries against one batch index, device-chunked.
        Returns UNIQUE-query (hit lists, qualifying counts); qs.rep_of
        broadcasts them to records at write time (_write_match_unique)."""
        return self._score_batch_end(self._score_batch_begin(didx, qs), qs=qs)

    @staticmethod
    def _write_match_unique(
        fp,
        qs: QuerySet,
        hits_u: list[list[tuple[int, int]]],
        nk_u: Sequence[int],
        names: Sequence[str],
        keep: int,
    ) -> None:
        """Emit the 03_match text contract straight from unique-query hit
        lists: resolve + sort by (-score, name) + top-n-cut + render ONCE
        per UNIQUE query, then stream per-record headers + the shared hit
        block in a single write. The sort makes the output independent of
        the order of hits within a device window."""
        from phylign_tpu_torch.io.cobs import strip_rid
        from phylign_tpu_torch.match.postprocess import top_n_with_ties

        text_u: list[str] = []
        for hl in hits_u:
            if not hl:
                text_u.append("")
                continue
            hits = [(names[di], sc) for di, sc in hl]
            hits.sort(key=lambda x: (-x[1], x[0]))
            text_u.append(
                "".join(
                    f"_{strip_rid(n)}\t{s}\n"
                    for n, s in top_n_with_ties(hits, keep)
                )
            )
        nk_l = [int(x) for x in nk_u]
        parts: list[str] = []
        for rec, j in zip(qs.records, qs.rep_of.tolist()):
            parts.append(f"*{rec.name}\t{nk_l[j]}\n")
            parts.append(text_u[j])
        fp.write("".join(parts))

    def _score_batch_chunked(
        self, didx: cobs_io.DeviceIndex, qs: QuerySet, budget_mb: int
    ) -> tuple[list[list[tuple[int, int]]], list[int]]:
        """Score one OVERSIZED batch by streaming signature-row blocks
        (models.matcher.ChunkedMatcher): the index never sits resident. The
        whole index streams once per query super-pass, so every query
        scores in ONE call rather than device_query_chunk slices."""
        log.info(
            "index %s exceeds the transient device budget (%d MB): "
            "row-chunked scoring",
            didx.doc_names[0] if didx.doc_names else "?", budget_mb,
        )
        trace.count("match.chunked_batches")
        cm = ChunkedMatcher.from_device_index(
            didx, hbm_budget_mb=budget_mb, device=self.device
        )
        self.sched.hbm.acquire(budget_mb)
        try:
            with self.sched.device_lock:
                hits_u, nk_u = cm.score_hits_raw(
                    qs.uraw,
                    self.cfg.cobs_kmer_thres,
                    self.cfg.nb_best_hits,
                )
        finally:
            self.sched.hbm.release(budget_mb)
        return hits_u, [int(x) for x in nk_u]

    #: (filename, mtime_ns, size) -> content hash; avoids re-hashing a
    #: memmapped on-disk device index's words every run
    _index_hash_memo: dict = {}

    @staticmethod
    def _index_hash(didx: cobs_io.DeviceIndex) -> str:
        """Content hash of a device index (blake2b over the packed word
        matrix + geometry) — the index-cache key."""
        import hashlib

        memo_key = getattr(didx, "source_sig", None)
        if memo_key is not None:
            hit = Pipeline._index_hash_memo.get(memo_key)
            if hit is not None:
                return hit
        hb = hashlib.blake2b(digest_size=16)
        hb.update(
            f"{didx.signature_size}:{didx.num_docs}:"
            f"{didx.term_size}:{didx.num_hashes}".encode()
        )
        hb.update(memoryview(np.ascontiguousarray(didx.words)))
        digest = hb.hexdigest()
        if memo_key is not None:
            Pipeline._index_hash_memo[memo_key] = digest
        return digest

    @trace.spanned("stage.match")
    def match(self, stem: str, batches: list[str] | None = None) -> list[Path]:
        batches = batches if batches is not None else self.batches()
        if self._spanning_mesh():
            # every rank scores every batch, one at a time in batch order,
            # so each rank's gathers pair with its peers'
            return [self.match_one_batch(b, stem) for b in batches]
        # one device or a mesh of one process
        try:
            return self._match_pipelined(stem, batches)
        except KernelError:
            raise  # the job path runs the same kernels: never retry them
        except Exception:
            # the manifest makes the job path resume where the pipelined
            # path stopped; the job path adds per-batch OOM-escalation
            # retries (scheduler.run_one)
            log.warning(
                "pipelined match failed; falling back to the job "
                "scheduler", exc_info=True,
            )
        jobs = [
            Job(
                name=f"match:{b}",
                fn=lambda b=b: self.match_one_batch(b, stem),
                mem_mb=self._index_mem_mb(b),
                io_heavy=True,
                priority=999,  # reference: Snakefile:413
            )
            for b in batches
        ]
        results = self.sched.run(jobs)
        return [results[f"match:{b}"] for b in batches]

    def _match_pipelined(
        self, stem: str, batches: list[str], group_size: int = 8
    ) -> list[Path]:
        """The match stage as ONE dispatch/fetch pipeline over batches.

        Batches are dispatched in order (their device work queues back to
        back on the stream, each hit buffer's copy to pinned memory started
        with it) and fetched in GROUPS of ``group_size``. Index decode /
        mmap-open prefetches on a thread pool ahead of dispatch. Host
        assembly + the 03_match write happen at group-flush time, off the
        dispatch critical path."""
        from concurrent.futures import ThreadPoolExecutor

        outs: dict[str, Path] = {}
        todo: list[str] = []
        for b in batches:
            out = self.match_path(b, stem)
            if self.manifest.done("match", f"{b}____{stem}", [str(out)]):
                outs[b] = out
            else:
                todo.append(b)
        if not todo:
            return [outs[b] for b in batches]

        drop_cache = (
            self.cfg.index_load_mode != "mem-stream"
            and not self.cfg.keep_cobs_indexes
        )

        # FIFO turnstile for RAM acquisition: prefetch workers reserve in
        # BATCH order, so an out-of-order worker can never hold budget the
        # in-order consumer is waiting on (RamPool wakeups are unordered).
        # A blocked worker at the turnstile holds nothing.
        turn = threading.Condition()
        next_turn = [0]

        def load_one(i: int, b: str):
            mem = self._index_mem_mb(b)
            with turn:
                while i != next_turn[0]:
                    turn.wait()
            try:
                self.sched.ram.acquire(mem)
            finally:
                with turn:  # always pass the turn, even on interrupt
                    next_turn[0] += 1
                    turn.notify_all()
            try:
                with trace.span("match.load"):
                    return self._load_index(b), mem
            except BaseException:
                self.sched.ram.release(mem)
                raise

        group: list[dict] = []

        def abort_item(it: dict) -> None:
            """Release what an unfinished group item still holds (the RAM
            reservation is returned at dispatch time, so only the
            transient device reservation and the bench context remain)."""
            st = it.get("st") or {}
            if st.get("transient"):
                st["transient"] = False
                self.sched.hbm.release(st["hbm_mb"])
            cm = it.get("bench")
            if cm is not None:
                it["bench"] = None
                cm.__exit__(None, None, None)

        def flush_group() -> None:
            if not group:
                return
            gi = 0
            try:
                # wait for every pending hit-buffer copy of the group
                with trace.span("match.fetch"):
                    fetched_all = {
                        (g2, si): payload.fetch()
                        for g2, it in enumerate(group)
                        for si, (kind, payload) in enumerate(
                            it["st"].get("slots", ())
                        )
                        if kind == "pending"
                    }
                for gi, it in enumerate(group):
                    b = it["batch"]
                    fetched = {
                        si: arr
                        for (g2, si), arr in fetched_all.items()
                        if g2 == gi
                    }
                    # _score_batch_end releases the item's transient device
                    # memory in its own finally (marking st["transient"]
                    # False), so the except arm below never double-releases
                    hits_u, nk_u = self._score_batch_end(
                        it["st"], fetched=fetched or None, qs=it["qs"]
                    )
                    outs[b] = self._commit_match_output(
                        b, stem, it["qs"], hits_u, nk_u, it["doc_names"]
                    )
                    cm = it.get("bench")
                    it["bench"] = None  # abort_item must not exit it twice
                    if cm is not None:
                        cm.__exit__(None, None, None)
                    if drop_cache:
                        it.pop("st", None)
                        self.drop_index_cache(b)
            except BaseException:
                for it in group[gi:]:
                    abort_item(it)
                group.clear()
                raise
            group.clear()

        lookahead = max(2 * group_size, 4)
        pf_workers = max(1, min(self.cfg.max_io_heavy_threads, 8))
        with benchmark(self.logs, "match_pipelined", stem), ThreadPoolExecutor(
            pf_workers, thread_name_prefix="idx-prefetch"
        ) as pool:
            futs: dict[str, object] = {}
            try:
                for i, b in enumerate(todo):
                    for j in range(i, min(i + lookahead, len(todo))):
                        nb = todo[j]
                        if nb not in futs:
                            futs[nb] = pool.submit(load_one, j, nb)
                    with trace.span("match.load_wait"):
                        didx, mem = futs.pop(b).result()
                    try:
                        with trace.span("match.queries"):
                            qs = self._query_set(
                                stem, didx.term_size, didx.num_hashes
                            )
                        # never enter a blocking device-memory acquire while
                        # holding dispatched-but-unflushed work only THIS
                        # thread can release: flush first if the pool looks
                        # too tight (advisory check; after a flush the only
                        # remaining holders release independently)
                        if group:
                            need = max(1, device_index_bytes(didx, mesh=self.mesh()) // 1_000_000)
                            if (
                                didx.num_hashes == 1
                                and need > self._chunk_budget_mb()
                            ):
                                # this index will stream row-chunked with a
                                # chunk_budget reservation; multi-hash
                                # indexes have NO chunked fallback and
                                # acquire their full size
                                need = self._chunk_budget_mb()
                            if self.sched.hbm.available() < need:
                                flush_group()
                        bench_cm = benchmark(
                            self.logs, "run_cobs", f"{b}____{stem}"
                        )
                        bench_cm.__enter__()
                        try:
                            st = self._score_batch_begin(didx, qs)
                        except BaseException:
                            bench_cm.__exit__(None, None, None)
                            raise
                    finally:
                        # the upload has consumed the host index bytes;
                        # return the reservation now — holding it across
                        # group flushes is what made the prefetchers
                        # deadlockable
                        self.sched.ram.release(mem)
                    group.append(
                        {
                            "batch": b, "qs": qs, "st": st,
                            "bench": bench_cm,
                            "doc_names": didx.doc_names,
                        }
                    )
                    del didx  # drop the mmap/decoded words reference
                    # flush the FIRST couple of batches early: their hit
                    # totals establish the adaptive fetch-cap hint
                    eff = 2 if qs.hit_hint is None else group_size
                    if len(group) >= eff:
                        flush_group()
                flush_group()
            except BaseException:
                for it in group:
                    abort_item(it)
                group.clear()
                raise
            finally:
                for f in futs.values():  # unconsumed prefetch reservations
                    try:
                        _, mem = f.result()
                        self.sched.ram.release(mem)
                    except BaseException:
                        pass
        return [outs[b] for b in batches]

    def _index_mem_mb(self, batch: str) -> int:
        """Decompressed-size RAM reservation for the scheduler, from
        data/decompressed_indexes_sizes.txt when present, else estimated
        from the xz size."""
        sizes = self._index_sizes()
        if batch in sizes:
            return max(64, int(sizes[batch] / 1e6))
        p = self.cobs_path(batch)
        try:
            # xz ratio on these indexes is ~5-8x; reserve decompressed estimate
            return max(64, int(p.stat().st_size * 8 / 1e6))
        except OSError:
            return 256

    def _index_sizes(self) -> dict[str, int]:
        if not hasattr(self, "_index_sizes_cache"):
            table: dict[str, int] = {}
            p = self.root / "data" / "decompressed_indexes_sizes.txt"
            if p.exists():
                for line in p.read_text().splitlines():
                    parts = line.split()
                    if len(parts) >= 2:
                        name = Path(parts[0]).name.replace(".cobs_classic.xz", "")
                        table[name] = int(parts[1])
            self._index_sizes_cache = table
        return self._index_sizes_cache

    # --- stage 4: filter -----------------------------------------------------

    @trace.spanned("stage.filter")
    def filter(self, stem: str, batches: list[str] | None = None) -> Path:
        batches = batches if batches is not None else self.batches()
        out = self.filter_path(stem)
        if self.manifest.done("filter", stem, [str(out)]):
            return out
        with benchmark(self.logs, "translate_matches", stem):
            parsed = None
            reserved_mb = 0
            if self.cfg.filter_mode != "streaming":
                # RAM-account the in-memory parse: decompressed text ~8x the
                # .gz plus parsed arrays; fall back to the constant-memory
                # streaming path when the estimate exceeds the RAM budget
                est_mb = max(
                    64,
                    int(
                        sum(
                            self.match_path(b, stem).stat().st_size
                            for b in batches
                            if self.match_path(b, stem).exists()
                        )
                        * 12
                        / 1e6
                    ),
                )
                if est_mb > self.sched.ram.total:
                    log.warning(
                        "match files too large for the in-RAM filter "
                        "(~%d MB est > %d MB budget); streaming instead",
                        est_mb, self.sched.ram.total,
                    )
                else:
                    self.sched.ram.acquire(est_mb)
                    reserved_mb = est_mb
                    parsed = self._parse_matches_native(batches, stem)
            handles = []
            try:
                if parsed is not None:
                    # native fast path: array filter over interned accessions
                    from phylign_tpu_torch.match.filter import filter_queries_arrays

                    filtered = filter_queries_arrays(
                        read_fastx_file(self.merged_fa(stem)),
                        parsed,
                        self.cfg.nb_best_hits,
                    )
                else:
                    # streaming lockstep merge: constant memory in #queries
                    handles = [
                        xopen_read(self.match_path(b, stem)) for b in batches
                    ]
                    streams = {
                        b: read_match_file(h) for b, h in zip(batches, handles)
                    }
                    filtered = filter_queries_streaming(
                        read_fastx_file(self.merged_fa(stem)),
                        streams,
                        self.cfg.nb_best_hits,
                    )
                tmp, commit = atomic_write_via(out)
                with open(tmp, "w") as f:
                    write_filtered_fasta(f, filtered)
                commit()
            finally:
                for h in handles:
                    h.close()
                if reserved_mb:
                    self.sched.ram.release(reserved_mb)
        self.manifest.mark("filter", stem, [str(out)])
        return out

    def _parse_matches_native(self, batches: list[str], stem: str):
        """Natively parse all match files into arrays, or None to stream in
        python (native library unavailable, or a file the strict C parser
        rejects)."""
        import gzip
        import lzma
        from concurrent.futures import ThreadPoolExecutor

        from phylign_tpu_torch.native import get_lib, native_parse_match_text

        if get_lib() is None:
            return None

        def load(b):
            p = str(self.match_path(b, stem))
            opener = (
                gzip.open
                if p.endswith(".gz")
                else lzma.open if p.endswith(".xz") else open
            )
            with opener(p, "rb") as f:
                data = f.read()  # zlib releases the GIL; parse is C
            return b, native_parse_match_text(data)

        try:
            with ThreadPoolExecutor(max_workers=4) as ex:
                parsed = dict(ex.map(load, batches))
        except ValueError as e:
            log.warning("native match parse failed (%s); streaming instead", e)
            return None
        return parsed

    # --- stage 5: align ------------------------------------------------------

    def _filtered_query_set(self, stem: str):
        """Parsed filtered queries + a shared sketch cache, loaded ONCE per
        stem and reused by every batch's align job (the reference re-reads
        the 04_filter FASTA and batch_align.py re-builds its query dicts per
        batch, 305x; ref Snakefile:549-555). The sketch dict is shared
        by the align producers, which fill it lazily."""
        src = self.filter_path(stem)
        st = src.stat()  # mtime+size key: a regenerated file invalidates
        key = ("filtered", stem, st.st_mtime_ns, st.st_size)
        with self._query_cache_lock:
            hit = self._query_cache.get(key)
        if hit is not None:
            return hit
        queries = read_filtered_fasta(read_fastx_file(src))
        # pre-sketch every query with candidates in ONE threaded native
        # minimizer pass (align producers otherwise sketch lazily, one
        # ctypes call per read — measured first-order at 10k+ reads)
        from phylign_tpu_torch.align.engine import AlignParams, QuerySketch

        params = AlignParams.from_preset(
            self.cfg.minimap_preset, self.cfg.minimap_extra_params
        )
        with_cands = [
            (qi, q) for qi, q in enumerate(queries) if q.candidates
        ]
        sketches = dict(
            zip(
                (qi for qi, _ in with_cands),
                QuerySketch.make_batch(
                    [(q.qname, q.seq) for _, q in with_cands], params
                ),
            )
        )
        val = (queries, sketches)
        with self._query_cache_lock:
            # one read set live at a time per cache family
            for k in [k for k in self._query_cache if k[0] == "filtered"]:
                del self._query_cache[k]
            self._query_cache[key] = val
        return val

    def batch_accessions(self, batch: str) -> set[str] | None:
        """The batch's accession allow-list from data/661k_batches.txt.xz-style
        metadata (ref: Snakefile:543-546); None when no metadata is present
        (tar membership already restricts to the batch's own genomes)."""
        for name in ("661k_batches.txt.xz", "661k_batches.txt"):
            p = self.root / "data" / name
            if p.exists():
                with xopen_read(p) as f:
                    for line in f:
                        parts = line.rstrip("\n").split("\t")
                        if parts and parts[0] == batch and len(parts) > 1:
                            return set(parts[1].replace(";", ",").split(","))
        return None

    def align_params(self, longest: int | None = None) -> AlignParams:
        """The run's align parameters. On a CUDA device, with ``longest``
        (the longest read to align, in bases) they are checked against
        kernel B4's int32 DP (AlignParams.check_kernel)."""
        params = AlignParams.from_preset(
            self.cfg.minimap_preset, self.cfg.minimap_extra_params
        )
        if longest is not None and self.device.type == "cuda":
            params.check_kernel(longest)
        return params

    @trace.spanned("stage.align")
    def align(self, stem: str, batches: list[str] | None = None) -> list[Path]:
        batches = batches if batches is not None else self.batches()
        outs: dict[str, Path] = {}
        todo: list[str] = []
        for b in batches:
            out = self.map_path(b, stem)
            if self.manifest.done("map", f"{b}____{stem}", [str(out)]):
                outs[b] = out
            else:
                todo.append(b)
        if todo:
            # refuse what kernel B4 cannot run before aligning a batch
            queries, sketches = self._filtered_query_set(stem)
            params = self.align_params(max((len(q.seq) for q in queries), default=0))
            # ONE shared flush pipeline pools pairs across batch boundaries
            # (engine.align_batches_pooled), one batch or many — flush sizes
            # stay at device_pair_chunk even when most batches contribute a
            # handful of pairs, instead of one small dispatch per batch
            # (the reference's unit is one minimap2 process per genome,
            # batch_align.py:416-486). Producer threads replace the
            # scheduler's io_heavy jobs for tar/anchor host work.
            specs = [
                (b, str(self.asms_path(b)), self.batch_accessions(b))
                for b in todo
            ]
            producers = max(1, min(self.cfg.max_io_heavy_threads, 4))
            with benchmark(self.logs, "batch_align_pooled", stem):
                for bname, records in align_batches_pooled(
                    specs,
                    queries,
                    params,
                    mesh=self._align_mesh(),
                    device_lock=self.sched.flush_slot(),
                    pair_chunk=self.cfg.device_pair_chunk,
                    sketch_cache=sketches,
                    producers=producers,
                    asm_cache_dir=self._asm_cache_dir(),
                    device=self.device,
                ):
                    # per-batch rows keep the reference's log-file contract
                    # (logs/benchmarks/batch_align/...); they time the
                    # output write — stage wall is the batch_align_pooled row
                    with benchmark(
                        self.logs, "batch_align", f"{bname}____{stem}"
                    ), trace.span("align.write"):
                        out = self.map_path(bname, stem)
                        tmp, commit = atomic_write_via(out)
                        write_batch_sam(tmp, records)
                        commit()
                    self.manifest.mark("map", f"{bname}____{stem}", [str(out)])
                    outs[bname] = out
                    if self.cfg.asm_cache:
                        self._enforce_cache_budget()
        return [outs[b] for b in batches]

    # --- stage 6: aggregate + stats ------------------------------------------

    @trace.spanned("stage.aggregate")
    def aggregate(self, stem: str, batches: list[str] | None = None) -> Path:
        batches = batches if batches is not None else self.batches()
        out = self.out / f"{stem}.sam_summary.gz"
        with benchmark(self.logs, "aggregate_sams", stem):
            tmp, commit = atomic_write_via(out)
            # banner text is workdir-relative, byte-identical to the
            # reference's `==> intermediate/05_map/... <==` lines
            # (ref: aggregate_sams.sh invoked with relative paths)
            aggregate_sams(
                tmp,
                [self.map_path(b, stem) for b in batches],
                banners=[
                    f"{self.cfg.intermediate_dir}/05_map/{b}____{stem}.sam.gz"
                    for b in batches
                ],
            )
            commit()
        return out

    @trace.spanned("stage.stats")
    def stats(self, stem: str) -> Path:
        out = self.out / f"{stem}.sam_summary.stats"
        with benchmark(self.logs, "final_stats", stem):
            st = compute_stats(
                self.out / f"{stem}.sam_summary.gz", self.merged_fa(stem)
            )
            tmp, commit = atomic_write_via(out)
            tmp.write_text(st.to_tsv())
            commit()
        return out

    # --- full run ------------------------------------------------------------

    def run_all(
        self, inputs: Sequence[str], num: int = 1, rank: int = 0, wait=None
    ) -> Path | None:
        """download'd data assumed present; runs match+map end to end
        (the reference's `make all` minus download: Makefile:35-38).

        ``num`` processes (this one ``rank``) may share a run over a shared
        filesystem: each matches its match_share and aligns its round-robin
        share of the batches; rank 0 filters once every 03_match exists and
        aggregates once every 05_map does, the others wait for its
        04_filter and return None once their batches are aligned.
        ``wait(paths, what)`` blocks until the files exist."""
        batches = self.batches()
        stem = self.preprocess(inputs)
        # refuse what the align stage cannot run before matching
        self.align_params(self._longest_read[stem])
        sampler = RamSampler()
        sampler.__enter__()
        try:
            with benchmark(self.logs, "match_total", stem):
                self.match(stem, self.match_share(num, rank))
                if rank == 0:
                    if num > 1:
                        wait([self.match_path(b, stem) for b in batches], "match")
                    self.filter(stem, batches)
                else:
                    wait([self.filter_path(stem)], "filter")
            with benchmark(self.logs, "map_total", stem):
                self.align(stem, shard_batches(batches, num, rank))
                if rank != 0:
                    return None
                if num > 1:
                    wait([self.map_path(b, stem) for b in batches], "map")
                self.aggregate(stem, batches)
                self.stats(stem)
        finally:
            sampler.__exit__()
        (self.logs / "benchmarks").mkdir(parents=True, exist_ok=True)
        (self.logs / "benchmarks" / "ram_usage.txt").write_text(
            f"max_system_ram_delta_kb\t{sampler.max_delta_kb}\n"
        )
        return self.out / f"{stem}.sam_summary.gz"
