"""The shard grid of a domain-decomposed run (`armon_tpu/parallel/mesh.py`,
`armon_tpu/core/solver.py:98-123`).

P = (px, py) shards, each a padded block of (ny_loc + 2g, nx_loc + 2g)
cells, laid out row-major as (py, px), the (rows, cols) order of the
arrays. Where the JAX package runs one program per device under
`shard_map`, the port loops over the shards on the host and launches each
one's kernels on its device. Shards may share a device
(``devices=["cuda:0"] * 4`` runs a 2x2 mesh on one card).

A run over several processes (`parallel/dist.py`) cuts the shards, in
mesh order, into equal contiguous blocks, one a process in rank order
(JAX's verbatim global device order, `armon_tpu/parallel/mesh.py:50-52`).
Each process drives its own block, `Mesh.local`; the others' shards carry
their rank and no device. Every per-shard list the drivers hold (fields,
slabs, States) is indexed by `Shard.slot`, the shard's position among
this process's shards; `Shard.index` is its position in the whole mesh.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.enums import Axis
from ..utils.errors import solver_error


class Shard(NamedTuple):
    index: int                      # position in row-major (py, px) order
    ix: int                         # mesh coordinates
    iy: int
    device: Optional[torch.device]  # None on another process
    global_pos: Tuple[int, int]     # global (x, y) index of the first real cell
    n_real: Tuple[int, int]         # (nx, ny) real cells of this shard
    rank: int = 0                   # the process that drives it
    slot: Optional[int] = None      # position among this process's shards


class Mesh:
    """The (py, px) grid of shards: each one's process, device,
    coordinates, global origin and real extent (the hi-edge shard of an
    uneven split owns `cfg.edge_cells`). `devices` lists this process's
    shards' devices, in mesh order; `rank` of `nprocs` processes."""

    def __init__(self, cfg, devices, rank=0, nprocs=1):
        px, py = cfg.proc_dims
        n = px * py
        if n % nprocs:
            solver_error("config", f"mesh {px}x{py} has {n} shards, not a "
                                   f"multiple of the {nprocs} processes")
        k = n // nprocs
        devices = [torch.device(d) for d in devices]
        if len(devices) != k:
            raise ValueError(f"mesh {px}x{py} needs {k} devices a process, "
                             f"got {len(devices)}")
        nx, ny = cfg.n_local
        ex, ey = cfg.edge_cells
        self.proc_dims = (px, py)
        self.rank, self.nprocs = rank, nprocs
        shards = []
        for i in range(n):
            ix, iy = i % px, i // px
            mine = i // k == rank
            shards.append(Shard(
                i, ix, iy, devices[i - rank * k] if mine else None,
                (ix * nx, iy * ny),
                (ex if ix == px - 1 else nx, ey if iy == py - 1 else ny),
                i // k, i - rank * k if mine else None))
        self.shards = tuple(shards)
        self.local = self.shards[rank * k:(rank + 1) * k]

    @classmethod
    def of(cls, params):
        """The mesh of a run's parameters, this process's shards local."""
        return cls(params.config, params.devices, params.process_index,
                   params.process_count)

    def __len__(self):
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    def is_local(self, shard) -> bool:
        return shard.rank == self.rank

    def neighbour(self, shard, axis, side) -> Optional[Shard]:
        """The shard across `side` (0 low, 1 high) of `shard` along `axis`,
        or None at a global border."""
        px, py = self.proc_dims
        step = 1 if side else -1
        ix, iy = shard.ix, shard.iy
        if Axis(axis) is Axis.X:
            ix += step
        else:
            iy += step
        if not (0 <= ix < px and 0 <= iy < py):
            return None
        return self.shards[iy * px + ix]
