"""Device mesh of the match -> filter -> align workflow (the counterpart of
``phylign_tpu/parallel/mesh.py``), with its two axes:

  "d" (doc shards)   genome-document columns of the Bloom bit-matrix are
                     split across devices; the filter's top-k gathers over "d".
  "q" (query shards) queries, and the align stage's pairs, are split across
                     devices (data parallel).

One process drives every device of its part of the mesh: per-shard tensors
live in plain lists indexed ``[d][q]`` (``parallel.dist.Sharded``), and
kernels on different cards overlap because launches are asynchronous. A
mesh may repeat a device (every shard on the one CPU, or ``[cuda:0] * 4``
to run a sharded mesh on one card). ``torch.distributed`` is used only
where the mesh spans processes: its ``nd * nq`` cells are dealt to the
ranks in row-major blocks, so a ``2x2`` mesh over two ranks puts the doc
axis across the process boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

AXIS_DOC = "d"
AXIS_QUERY = "q"


@dataclass(frozen=True, eq=False)
class Mesh:
    """An ``nd x nq`` grid of cells. ``devices`` holds the device of every
    cell this process owns, in row-major cell order; the cells of rank r
    are ``[r * n_local, (r + 1) * n_local)``. ``group`` is the process
    group when ``world > 1``."""

    nd: int
    nq: int
    devices: tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    group: object = None

    def __post_init__(self):
        if self.nd < 1 or self.nq < 1:
            raise ValueError(f"mesh {self.nd}x{self.nq}: both axes need a shard")
        if (self.nd * self.nq) % self.world or len(self.devices) * self.world != self.nd * self.nq:
            raise ValueError(
                f"mesh {self.nd}x{self.nq} over {self.world} process(es) needs "
                f"{self.nd * self.nq // max(1, self.world)} local devices, got {len(self.devices)}"
            )

    @property
    def shape(self) -> dict[str, int]:
        """{"d": nd, "q": nq}, as ``jax.sharding.Mesh.shape``."""
        return {AXIS_DOC: self.nd, AXIS_QUERY: self.nq}

    @property
    def n_local(self) -> int:
        return len(self.devices)

    def cells(self) -> list[tuple[int, int]]:
        """Every (d, q) cell in row-major order."""
        return [(d, q) for d in range(self.nd) for q in range(self.nq)]

    def local_cells(self) -> list[tuple[int, int]]:
        """The cells this process owns, in row-major order."""
        return self.cells()[self.rank * self.n_local : (self.rank + 1) * self.n_local]

    def device(self, d: int, q: int) -> torch.device | None:
        """The device of cell (d, q), or None when another process owns it."""
        i = d * self.nq + q - self.rank * self.n_local
        return self.devices[i] if 0 <= i < self.n_local else None

    def local(self) -> "Mesh":
        """This process's part of the mesh for work split over "q" alone:
        a 1 x n mesh of its own, one cell for each query column it holds a
        cell of, on that cell's device."""
        cols: dict[int, torch.device] = {}
        for d, q in self.local_cells():
            cols.setdefault(q, self.device(d, q))
        return Mesh(1, len(cols), tuple(cols.values()))

    @property
    def home(self) -> torch.device:
        """This process's first device: where results gathered over the
        mesh land."""
        return self.devices[0]

    @property
    def comm_device(self) -> torch.device:
        """Where collectives run: the CPU for gloo, the card for nccl."""
        import torch.distributed as dist

        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.home
        return torch.device("cpu")


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """'4x2' -> (4, 2) doc x query shards (config.mesh_shape)."""
    d, _, q = spec.partition("x")
    return int(d), int(q)


def _visible_devices() -> list[torch.device]:
    """Every visible card, or the one CPU without a card."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    n_doc_shards: int | None = None,
    n_query_shards: int | None = None,
    devices: Sequence[str | torch.device] | str | torch.device | None = None,
    group=None,
) -> Mesh:
    """Mesh over ``devices``, this process's devices for its cells.

    ``devices`` is a list (one device per local cell; it may repeat one),
    one device for every local cell (``"cpu"``), or None: every visible
    card, whose count must then equal the local cells (one CPU device
    serves every cell). Defaults put every device on the doc axis, as the
    JAX mesh does. ``group``: a process group (``torch.distributed``) the
    mesh spans; its ranks share the cells in row-major blocks."""
    import torch.distributed as dist

    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    one = None  # the one device of every local cell
    if devices is None:
        devs = _visible_devices()
        if devs[0].type == "cpu":
            one = devs[0]
    elif isinstance(devices, (str, torch.device)):
        one = torch.device(devices)
    else:
        devs = [torch.device(x) for x in devices]
    if one is not None:
        nd, nq = n_doc_shards or 1, n_query_shards or 1
        return Mesh(nd, nq, (one,) * ((nd * nq) // world), rank, world, group)
    n = len(devs) * world
    if n_doc_shards is None and n_query_shards is None:
        n_doc_shards, n_query_shards = n, 1
    elif n_doc_shards is None:
        n_doc_shards = n // n_query_shards
    elif n_query_shards is None:
        n_query_shards = n // n_doc_shards
    if n_doc_shards * n_query_shards != n:
        raise ValueError(
            f"mesh {n_doc_shards}x{n_query_shards} != {n} devices "
            f"({len(devs)} local x {world} process(es))"
        )
    return Mesh(n_doc_shards, n_query_shards, tuple(devs), rank, world, group)
