"""Sharded match / top-k / align: the multi-device compute path (the
counterpart of ``phylign_tpu/parallel/dist.py``).

  * The Bloom bit-matrix's word columns are split over the "d" axis.
    Scoring needs no communication: every doc shard gathers k-mer rows of
    its own contiguous column slice and scores its own documents (kernels
    B1/B2 on CUDA, the plain version on the CPU).
  * The filter's global top-k is the one real collective: a local
    threshold + top-K per doc shard (kernel B5b on CUDA), a gather of each
    shard's window and qualifying count over "d", and their merge (kernel
    B5d), in jax.lax.top_k's order. K = nb_best_hits + TIE_SLACK extra
    slots so ties at the cutoff survive; the caller re-scores a query whose
    qualifying count exceeds the window (``Matcher._window_hits``).
  * Chaining and extension are data-parallel over "q" (kernels B3/B4 on
    each query shard's pairs); their results are concatenated over "q" on
    the mesh's home device, the gather every consumer of them needs.

A sharded array is a ``Sharded``: the global shape, which mesh axis each
dimension is split over, and the tensor of every cell this process owns.
Across processes, one ``torch.distributed.all_gather_into_tensor`` of the
local cells' bytes moves what a cell of another process holds.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from phylign_tpu_torch.models.matcher import _hash_rows, _pack_hits, _topk_scores
from phylign_tpu_torch.models.matcher import _merge_topk as merge_windows
from phylign_tpu_torch.ops.chain import ChainResult, chain_anchors, chain_anchors_packed
from phylign_tpu_torch.ops.extend import (
    ExtendResult,
    SrScoring,
    extend_banded,
    extend_banded_packed,
    extend_banded_scores,
    extend_banded_scores_packed,
)
from phylign_tpu_torch.ops.match import match_scores
from phylign_tpu_torch.parallel.mesh import AXIS_DOC, AXIS_QUERY, Mesh
from phylign_tpu_torch.utils import trace

TIE_SLACK = 28

Cell = tuple[int, int]


@dataclass(eq=False)
class Sharded:
    """A global array over a mesh: ``spec[i]`` names the mesh axis that
    splits dimension i (AXIS_DOC, AXIS_QUERY or None: whole on every cell),
    ``shards[d][q]`` is cell (d, q)'s block (None for a cell another
    process owns). Cells holding the same block on the same device share
    one tensor."""

    mesh: Mesh
    spec: tuple
    shape: tuple[int, ...]
    shards: list[list[torch.Tensor | None]]

    def at(self, d: int, q: int) -> torch.Tensor:
        t = self.shards[d][q]
        if t is None:
            raise ValueError(f"cell ({d}, {q}) belongs to another process")
        return t

    def block(self, d: int, q: int) -> tuple[slice, ...]:
        """Cell (d, q)'s slice of the global array."""
        return _block(self.mesh, self.shape, self.spec, d, q)


def _block(mesh: Mesh, shape, spec, d: int, q: int) -> tuple[slice, ...]:
    out = []
    for n, ax in zip(shape, spec):
        parts, i = (mesh.nd, d) if ax == AXIS_DOC else (mesh.nq, q) if ax == AXIS_QUERY else (1, 0)
        if n % parts:
            raise ValueError(f"dimension of {n} does not split evenly over {parts} shards")
        step = n // parts
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def _put(a, device: torch.device) -> torch.Tensor:
    """A host block (numpy or CPU tensor) as a contiguous tensor on
    ``device``; to a card through pinned memory and a non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a.contiguous()
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def shard_blocks(mesh: Mesh, shape, spec, make, cells: list[Cell] | None = None) -> Sharded:
    """A Sharded array of global ``shape`` whose cell blocks
    ``make(slices, device)`` builds: each process builds only its own
    cells' blocks (or only those of ``cells``), each block once per
    device."""
    shape = tuple(shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    shards: list[list[torch.Tensor | None]] = [[None] * mesh.nq for _ in range(mesh.nd)]
    made: dict = {}
    for d, q in mesh.local_cells() if cells is None else cells:
        dev = mesh.device(d, q)
        sl = _block(mesh, shape, spec, d, q)
        key = (tuple((s.start, s.stop) for s in sl), dev)
        if key not in made:
            made[key] = make(sl, dev)
        shards[d][q] = made[key]
    return Sharded(mesh, spec, shape, shards)


def global_array(mesh: Mesh, arr, spec, cells: list[Cell] | None = None) -> Sharded:
    """A Sharded array from a global host array (numpy or a tensor) that
    every process holds (shard_blocks of its slices)."""
    return shard_blocks(mesh, arr.shape, spec, lambda sl, dev: _put(arr[sl], dev), cells)


def _as_sharded(mesh: Mesh, x, spec, cells: list[Cell] | None = None) -> Sharded:
    if isinstance(x, Sharded):
        return x
    return global_array(mesh, x, spec, cells)


def _from_cells(mesh: Mesh, spec, shape, local: dict[Cell, torch.Tensor]) -> Sharded:
    shards: list[list[torch.Tensor | None]] = [[None] * mesh.nq for _ in range(mesh.nd)]
    for (d, q), t in local.items():
        shards[d][q] = t
    return Sharded(mesh, tuple(spec), tuple(shape), shards)


def _all_cells(mesh: Mesh, local: dict[Cell, tuple[torch.Tensor, ...]]) -> dict[Cell, tuple[torch.Tensor, ...]]:
    """Every cell's tuple of tensors (the same shapes and dtypes on every
    cell). Without a process group the local cells are all there is; with
    one, each process packs its cells' bytes in cell order and one
    all_gather_into_tensor hands every process every cell, on the mesh's
    collective device."""
    if mesh.group is None:
        return local
    import torch.distributed as dist

    comm = mesh.comm_device
    cells = mesh.local_cells()
    metas = [(t.dtype, tuple(t.shape)) for t in local[cells[0]]]
    rows = [
        torch.cat([t.to(comm).contiguous().reshape(-1).view(torch.uint8) for t in local[c]])
        for c in cells
    ]
    mine = torch.stack(rows)
    out = torch.empty((mesh.nd * mesh.nq, mine.shape[1]), dtype=torch.uint8, device=comm)
    with warnings.catch_warnings():  # newer torch renames it all_gather_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, mine, group=mesh.group)
    got = {}
    for row, c in zip(out, mesh.cells()):
        parts, o = [], 0
        for dtype, shape in metas:
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
            parts.append(row[o : o + n].clone().view(dtype).reshape(shape))
            o += n
        got[c] = tuple(parts)
    return got


def _column_cell(mesh: Mesh, q: int) -> Cell | None:
    """This process's first cell of query column q, if it owns one."""
    return next(((d, q) for d in range(mesh.nd) if mesh.device(d, q) is not None), None)


def _concat_q(mesh: Mesh, parts: dict[int, tuple[torch.Tensor, ...]]) -> tuple[torch.Tensor, ...]:
    """Per-query-shard results (one tuple per column this process owns a
    cell of) concatenated over "q" on the mesh's home device."""
    if mesh.group is not None:
        local = {c: parts[c[1]] for c in mesh.local_cells()}
        cells = _all_cells(mesh, local)
        parts = {q: cells[(0, q)] for q in range(mesh.nq)}
    n = len(parts[0])
    return tuple(
        torch.cat([parts[q][i].to(mesh.home) for q in range(mesh.nq)]) for i in range(n)
    )


def over_q(mesh: Mesh, fn, arrays, specs) -> tuple[torch.Tensor, ...]:
    """fn on each query shard's slice of ``arrays`` (once per column, on
    its first local cell's device), concatenated over "q"."""
    cols = [c for c in (_column_cell(mesh, q) for q in range(mesh.nq)) if c is not None]
    shs = [_as_sharded(mesh, a, s, cols) for a, s in zip(arrays, specs)]
    parts = {c[1]: tuple(fn(*[s.at(*c) for s in shs])) for c in cols}
    return _concat_q(mesh, parts)


def fetch(x):
    """Host (numpy) value of a Sharded array, a tensor, or a tuple / list
    / dict / NamedTuple of them; a Sharded array over processes is
    gathered so that each process receives the full value."""
    if isinstance(x, Sharded):
        local = {c: (x.at(*c),) for c in x.mesh.local_cells()}
        out, done = None, set()
        for c, (t,) in _all_cells(x.mesh, local).items():
            key = tuple((s.start, s.stop) for s in x.block(*c))
            if key in done:  # a block whole over an axis: fetched once
                continue
            done.add(key)
            if out is None:
                out = np.empty(x.shape, t.cpu().numpy().dtype)
            out[x.block(*c)] = t.cpu().numpy()
        return out
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: fetch(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[fetch(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(fetch(v) for v in x)
    return x


def dist_match_scores(mesh: Mesh, words, row_idx) -> Sharded:
    """Sharded scoring: words [S+1, Wp] split over "d" columns, row_idx
    [Q, K(, H)] over "q". Returns scores [Q, 32*Wp] split (q, d). Zero
    communication."""
    words = _as_sharded(mesh, words, (None, AXIS_DOC))
    rows = _as_sharded(mesh, row_idx, (AXIS_QUERY,))
    local = {c: match_scores(words.at(*c), rows.at(*c)) for c in mesh.local_cells()}
    return _from_cells(mesh, (AXIS_QUERY, AXIS_DOC), (rows.shape[0], 32 * words.shape[1]), local)


def _shard_windows(mesh: Mesh, scores: Sharded, cut, d, kk: int):
    """Each local cell's threshold + top-k over its own columns (B5b on
    CUDA, _topk_scores_ref on the CPU): (vals, local doc ids, qualifying
    count), the window min(kk, d_loc) wide, where d_loc = the cell's
    documents: its columns below ``d``, or with ``d`` a list of each doc
    shard's count, its first d[e] columns. A shard without documents
    takes no launch and gives an empty window and no count. ``cut``: a
    Sharded int32 [Q] split over "q", or None for a cut of 0 (every score
    qualifies). Across processes every window is padded to min(kk, w_loc)
    and every count made, so the gather's cells agree in shape. Returns
    (cells, each shard's limit)."""
    w_loc = scores.shape[1] // mesh.nd
    if np.ndim(d) == 0:
        d_loc = [min(max(d - e * w_loc, 0), w_loc) for e in range(mesh.nd)]
    else:
        d_loc = [int(x) for x in d]
    lims = [min(kk, x) for x in d_loc]
    kl = min(kk, w_loc)
    local = {}
    for c in mesh.local_cells():
        s = scores.at(*c)
        q, dev = s.shape[0], s.device
        lim = lims[c[0]]
        if lim:
            ct = torch.zeros(q, dtype=torch.int32, device=dev) if cut is None else cut.at(*c).to(torch.int32)
            v, i, n = _topk_scores(s, ct, lim, d_loc[c[0]])
        else:
            v = i = torch.empty((q, 0), dtype=torch.int32, device=dev)
            n = None
        if mesh.group is not None:
            pad = (0, kl - lim)
            v, i = torch.nn.functional.pad(v, pad, value=-1), torch.nn.functional.pad(i, pad, value=-1)
            n = torch.zeros(q, dtype=torch.int32, device=dev) if n is None else n
        local[c] = (v, i, n)
    return local, lims


def _merge_topk(mesh: Mesh, local: dict[Cell, tuple], lims: list[int], w_loc: int, kk: int):
    """Gather each cell's window (values, local doc ids, count) over "d"
    and merge the nd windows of each query column (B5d on CUDA,
    _merge_topk_ref on the CPU) on the column's first local cell's device:
    {column: (values [Q, kk], global doc ids [Q, kk], summed counts [Q])}."""
    with trace.span("match.mesh.gather"):
        cells = _all_cells(mesh, local)
        columns, moved = {}, 0
        for q in range(mesh.nq):
            c = _column_cell(mesh, q)
            if c is None:
                continue
            dev = mesh.device(*c)
            columns[q] = [tuple(None if t is None else t.to(dev) for t in cells[(d, q)]) for d in range(mesh.nd)]
            moved += sum(t.nbytes for d in range(mesh.nd) for t in cells[(d, q)]
                         if t is not None and t.device != dev)
        trace.count("match.mesh_gather_bytes", moved)
    with trace.span("match.mesh.merge"):
        return {q: merge_windows(w, lims, w_loc, kk) for q, w in columns.items()}


def _replicated(mesh: Mesh, shape, per_q: dict[int, torch.Tensor]) -> Sharded:
    """A result split over "q" and whole over "d": each column's tensor
    for every local cell of the column."""
    local = {c: per_q[c[1]] for c in mesh.local_cells()}
    return _from_cells(mesh, (AXIS_QUERY,) + (None,) * (len(shape) - 1), shape, local)


def _windows(mesh: Mesh, scores: Sharded, cut, d, kk: int):
    """The doc shards' windows (_shard_windows) with kk cut to nd *
    min(kk, w_loc), the width JAX's re-top-k gives: (cells, limits, w_loc,
    kk)."""
    w_loc = scores.shape[1] // mesh.nd
    kk = min(kk, mesh.nd * min(kk, w_loc))
    return (*_shard_windows(mesh, scores, cut, d, kk), w_loc, kk)


def _top(mesh: Mesh, q_tot: int, local, lims: list[int], w_loc: int, kk: int):
    """The windows gathered and merged: the results split over "q" and
    whole over "d" (values, ids, counts)."""
    merged = _merge_topk(mesh, local, lims, w_loc, kk)
    shapes = ((q_tot, kk), (q_tot, kk), (q_tot,))
    return tuple(
        _replicated(mesh, shape, {q: m[i] for q, m in merged.items()}) for i, shape in enumerate(shapes)
    )


def dist_topk(mesh: Mesh, scores: Sharded, n_best: int, k_total: int | None = None):
    """Global per-query top-K across doc shards: a top-min(K, w_loc) per
    doc shard (B5b at a cut of 0 on CUDA), global doc id = local column +
    d * w_loc, a gather over "d", the merge (B5d). scores [Q, D] split
    (q, d), every score >= 0 (what B1/B2 write). Returns (values [Q, K],
    global doc ids [Q, K]), split over "q" and whole over "d". K = n_best +
    TIE_SLACK, or exactly ``k_total`` when given (at most nd * w_loc). The
    window is the JAX function's word for word: (score desc, global doc
    asc), jax.lax.top_k's order."""
    k = k_total if k_total is not None else n_best + TIE_SLACK
    return _top(mesh, scores.shape[0], *_windows(mesh, scores, None, scores.shape[1], k))[:2]


def dist_threshold_topk(mesh: Mesh, words, row_idx, cut, d, kk: int):
    """Sharded match -> threshold -> top-k: zero-communication scoring
    over doc shards, B5b on each shard (its columns below ``d``, or with
    ``d`` a list of each doc shard's documents its first d[e] columns;
    scores >= the query's integer ``cut``), then ONE gather over "d" of
    each shard's window and qualifying count and their merge, B5d. Returns
    (vals [Q, kk], global doc ids [Q, kk], n_keep [Q]), split over "q" and
    whole over "d"; a global id is a column of the sharded matrix (local
    column + d * w_loc). On every row the first min(n_keep, kk) entries
    equal the JAX function's word for word, in jax.lax.top_k's order
    (score desc, global doc asc). Past them the port writes -1 values with
    doc -1, where JAX writes -1 values with the ids of masked columns. Runs
    on meshes that span processes (the gather is then an
    all_gather_into_tensor)."""
    with trace.span("match.mesh.score"):
        scores = dist_match_scores(mesh, words, row_idx)
        win = _windows(mesh, scores, _as_sharded(mesh, cut, (AXIS_QUERY,)), d, kk)
    return _top(mesh, scores.shape[0], *win)


def dist_hash_topk_flat(mesh: Mesh, words: Sharded, queries, *, s: int, pad_row: int, d, kk: int, cap: int):
    """The mesh twin of ``matcher._hash_topk_flat``, on a mesh of one
    process: on each cell's device B5a maps its query shard's hashes to
    Bloom rows (every doc shard holds the S+1 rows, so the same ``s`` and
    ``pad_row``), B2 scores them over the cell's words, B5b keeps the
    cell's window (``d``: each doc shard's documents, _shard_windows);
    then the windows' gather to each column's first device and the merge
    (B5d), the columns concatenated on the home device, and B5c packs the
    merged window there. ``queries``: {device: (hi, lo, nk, cut)}, the
    chunk's hash halves, k-mer counts and integer cut on each device of
    the mesh, their rows a multiple of the query axis. Returns the one
    int32 buffer [cap hits | Q n_keep | total] of _hash_topk_flat, whose
    doc ids are columns of the sharded matrix (local column + e * w_loc).
    A (device, query shard) maps its rows once, however many cells share
    it."""
    if mesh.group is not None:
        raise ValueError("dist_hash_topk_flat runs on a mesh of one process")
    q_tot = queries[mesh.home][0].shape[0]
    if q_tot % mesh.nq:
        raise ValueError(f"{q_tot} query rows do not split over {mesh.nq} query shards")
    step = q_tot // mesh.nq
    with trace.span("match.mesh.score"):
        rows, scores, cuts = {}, {}, {}
        for c in mesh.local_cells():
            dev, sl = mesh.device(*c), slice(c[1] * step, (c[1] + 1) * step)
            hi, lo, nk, cut = queries[dev]
            if (dev, c[1]) not in rows:
                rows[dev, c[1]] = _hash_rows(hi[sl], lo[sl], nk[sl], s, pad_row)
            scores[c] = match_scores(words.at(*c), rows[dev, c[1]])
            cuts[c] = cut[sl]
        sc = _from_cells(mesh, (AXIS_QUERY, AXIS_DOC), (q_tot, 32 * words.shape[1]), scores)
        local, lims, w_loc, kk = _windows(mesh, sc, _from_cells(mesh, (AXIS_QUERY,), (q_tot,), cuts), d, kk)
    merged = _merge_topk(mesh, local, lims, w_loc, kk)
    vals, ids, n_keep = merged[0] if mesh.nq == 1 else _concat_q(mesh, merged)
    return _pack_hits(vals, ids, n_keep, kk, cap)


def dist_chain(mesh: Mesh, rpos, qpos, **kw) -> ChainResult:
    """Chain DP data-parallel over "q" (the pairs axis): kernel B3 on each
    query shard's sets. qpos of uint16 bits (uint16 / int16) runs
    chain_anchors_packed. Fields concatenated over "q" on the home device."""
    packed = getattr(qpos, "dtype", None) in (np.uint16, np.int16, torch.int16)
    fn = chain_anchors_packed if packed else chain_anchors
    spec = (AXIS_QUERY, None)
    return ChainResult(*over_q(mesh, lambda r, q: fn(r, q, **kw), (rpos, qpos), (spec, spec)))


_EXT_SPECS = ((AXIS_QUERY, None), (AXIS_QUERY,), (AXIS_QUERY, None), (AXIS_QUERY, None))
_EXT_PACKED_SPECS = ((AXIS_QUERY, None), (AXIS_QUERY,), (AXIS_QUERY, None), (AXIS_QUERY,), (AXIS_QUERY,))


def dist_extend(mesh: Mesh, q_codes, q_len, rwin, rvalid, scoring=SrScoring()) -> ExtendResult:
    """Banded extension data-parallel over "q" (kernel B4 per shard)."""
    return ExtendResult(*over_q(
        mesh, lambda *a: extend_banded(*a, scoring=scoring), (q_codes, q_len, rwin, rvalid), _EXT_SPECS
    ))


def dist_extend_scores(mesh: Mesh, q_codes, q_len, rwin, rvalid, scoring=SrScoring()):
    """Score-only banded extension data-parallel over "q": (score, end_d)."""
    return over_q(
        mesh, lambda *a: extend_banded_scores(*a, scoring=scoring), (q_codes, q_len, rwin, rvalid), _EXT_SPECS
    )


def dist_extend_scores_packed(
    mesh: Mesh, q_pack, q_len, r_pack, lo, hi, l: int, wlen: int, scoring=SrScoring()
):
    """Mesh twin of extend_banded_scores_packed: 2-bit packed codes and
    [lo, hi) window bounds, split over "q"."""
    return over_q(
        mesh, lambda *a: extend_banded_scores_packed(*a, l, wlen, scoring=scoring),
        (q_pack, q_len, r_pack, lo, hi), _EXT_PACKED_SPECS,
    )


def dist_extend_packed(
    mesh: Mesh, q_pack, q_len, r_pack, lo, hi, l: int, wlen: int, scoring=SrScoring()
) -> ExtendResult:
    """Traceback-plane mesh twin of extend_banded_packed (data-parallel
    over "q")."""
    return ExtendResult(*over_q(
        mesh, lambda *a: extend_banded_packed(*a, l, wlen, scoring=scoring),
        (q_pack, q_len, r_pack, lo, hi), _EXT_PACKED_SPECS,
    ))


def full_step(
    mesh: Mesh,
    words,
    row_idx,
    n_kmers,
    q_codes,
    q_len,
    rwin,
    rvalid,
    anchors_r,
    anchors_q,
    threshold: float = 0.7,
    n_best: int = 100,
) -> dict:
    """The full sharded compute step: match (split over doc columns) ->
    threshold -> distributed top-k (the gather over "d") -> chain + banded
    extension (data-parallel over "q"). The cut is the JAX function's f32
    ceil(threshold * max(n_kmers, 1))."""
    words = _as_sharded(mesh, words, (None, AXIS_DOC))
    row_idx = _as_sharded(mesh, row_idx, (AXIS_QUERY,))
    scores = dist_match_scores(mesh, words, row_idx)
    d = scores.shape[1]
    nk = np.asarray(n_kmers.cpu() if isinstance(n_kmers, torch.Tensor) else n_kmers)
    cut = np.ceil(np.float32(threshold) * np.maximum(nk, 1).astype(np.float32)).astype(np.int32)
    kk = min(n_best + TIE_SLACK, d)
    topv, topi, n_keep = dist_threshold_topk(mesh, words, row_idx, cut, d, kk)
    chain_res = dist_chain(mesh, anchors_r, anchors_q)
    ext = dist_extend(mesh, q_codes, q_len, rwin, rvalid)
    return {
        "scores": scores,
        "top_values": topv,
        "top_doc_ids": topi,
        "top_n_keep": n_keep,
        "chain_score": chain_res.score,
        "chain_count": chain_res.count,
        "align_score": ext.score,
    }
