"""The shard grid of a domain-decomposed run (`armon_tpu/parallel/mesh.py`,
`armon_tpu/core/solver.py:98-123`).

P = (px, py) shards, each a padded block of (ny_loc + 2g, nx_loc + 2g)
cells, laid out row-major as (py, px), the (rows, cols) order of the
arrays. One controller process drives every shard: where the JAX package
runs one program per device under `shard_map`, the port loops over the
shards on the host and launches each one's kernels on its device. Shards
may share a device (``devices=["cuda:0"] * 4`` runs a 2x2 mesh on one
card).
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.enums import Axis


class Shard(NamedTuple):
    index: int                      # position in row-major (py, px) order
    ix: int                         # mesh coordinates
    iy: int
    device: torch.device
    global_pos: Tuple[int, int]     # global (x, y) index of the first real cell
    n_real: Tuple[int, int]         # (nx, ny) real cells of this shard


class Mesh:
    """The (py, px) grid of shards: each one's device, coordinates, global
    origin and real extent (the hi-edge shard of an uneven split owns
    `cfg.edge_cells`)."""

    def __init__(self, cfg, devices):
        px, py = cfg.proc_dims
        devices = [torch.device(d) for d in devices]
        if len(devices) != px * py:
            raise ValueError(f"mesh {px}x{py} needs {px * py} devices, got "
                             f"{len(devices)}")
        nx, ny = cfg.n_local
        ex, ey = cfg.edge_cells
        self.proc_dims = (px, py)
        self.shards = tuple(
            Shard(iy * px + ix, ix, iy, devices[iy * px + ix],
                  (ix * nx, iy * ny),
                  (ex if ix == px - 1 else nx, ey if iy == py - 1 else ny))
            for iy in range(py) for ix in range(px))

    def __len__(self):
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    @property
    def devices(self):
        return tuple(s.device for s in self.shards)

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
