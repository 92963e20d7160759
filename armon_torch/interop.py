"""Moving state between numpy and the port.

Arrays come in as numpy (for example ``np.asarray`` of each field of a JAX
`FusedCarry` or `State`), so this package never imports JAX; they go out as
numpy the same way. Fields are converted to the run's dtype on
`params.device`.

A domain-decomposed run (P != (1, 1)) keeps one padded block per shard.
The JAX package holds a mesh state as one "blocked" array per field, the
shards' blocks side by side in a (py * rows, px * cols) array
(`armon_tpu/parallel/mesh.py:9-13`); `shards_from_blocked` cuts such
arrays into the port's per-shard tensors. `gather_state` and
`scatter_state` go between per-shard blocks and the global padded grid
(`armon_tpu/core/solver.py:736-821,1187-1215`). Over several processes a
process holds its own shards only: `gather_state` raises there, and
`scatter_state` returns this process's blocks.
"""

import numpy as np
import torch

from .core.state import State, FusedCarry
from .parallel.mesh import Mesh
from .utils.errors import solver_error


def _field(arrays, name, k):
    if isinstance(arrays, dict):
        return arrays[name]
    if hasattr(arrays, "_fields"):
        return getattr(arrays, name)
    return arrays[k]


def _tensor(params, a):
    a = np.array(a, dtype=params.data_type, order="C", copy=True)
    return torch.from_numpy(a).to(params.device)


def carry_from_numpy(params, arrays) -> FusedCarry:
    """A FusedCarry from rho/u/v/E/p given as a dict, a NamedTuple with
    those fields, or a sequence in that order."""
    return FusedCarry(*(_tensor(params, _field(arrays, n, k))
                        for k, n in enumerate(FusedCarry._fields)))


def state_from_numpy(params, arrays) -> State:
    """A State from its 11 fields, given like `carry_from_numpy`'s input."""
    return State(*(_tensor(params, _field(arrays, n, k))
                   for k, n in enumerate(State._fields)))


def to_numpy(x):
    """numpy copy of a tensor, or of every field of a State/FusedCarry
    (returned as the same NamedTuple type)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_fields"):
        return type(x)(*(to_numpy(a) for a in x))
    raise TypeError(f"to_numpy: unsupported {type(x).__name__}")


def shards_from_blocked(params, arrays, kind=FusedCarry):
    """Per-shard NamedTuples of `kind` (this process's shards in mesh
    order, each on its shard's device) from blocked (py * rows, px * cols)
    arrays of its fields, given like `carry_from_numpy`'s input."""
    cfg = params.config
    rows, cols = cfg.local_shape
    px, py = cfg.proc_dims
    blocks = [np.asarray(_field(arrays, n, k)).reshape(py, rows, px, cols)
              for k, n in enumerate(kind._fields)]
    return [kind(*(_tensor(params, b[s.iy, :, s.ix, :]).to(s.device)
                   for b in blocks))
            for s in Mesh.of(params).local]


def gather_state(params, shards):
    """The global padded grid, a NamedTuple like each shard's, on
    `params.device`, from per-shard blocks (`gather_state`): every shard's
    real cells, and the global ghost bands and corners from the border
    shards, which hold them just past their real cells (so an edge shard's
    slack is skipped). A one-shard mesh's block is the global grid, and
    comes back as it is. Over several processes the other processes'
    shards are out of reach, and it raises (`armon_tpu/core/solver.py:
    746-755`)."""
    if params.process_count > 1:
        solver_error("config",
                     f"gather_state cannot assemble the global state of a "
                     f"run over {params.process_count} processes: each holds "
                     f"only its own shards. Use the per-shard paths: "
                     f"write_output with use_MPI (one file per shard), "
                     f"io.subdomain.shard_coords_iter / "
                     f"compare_sub_domain_with_golden, and per-shard "
                     f"snapshots (io.restart.save_checkpoint)")
    if len(shards) == 1:
        return shards[0]
    cfg = params.config
    g = cfg.nghost
    nx, ny = cfg.n_global
    px, py = cfg.proc_dims
    out = []
    for name in type(shards[0])._fields:
        a0 = getattr(shards[0], name)
        full = torch.zeros((ny + 2 * g, nx + 2 * g), dtype=a0.dtype,
                           device=params.device)
        for s in Mesh.of(params):
            blk = getattr(shards[s.index], name)
            wx, hy = s.n_real
            r_lo, c_lo = (0 if s.iy == 0 else g), (0 if s.ix == 0 else g)
            r_hi = g + hy + (g if s.iy == py - 1 else 0)
            c_hi = g + wx + (g if s.ix == px - 1 else 0)
            r0, c0 = s.global_pos[1], s.global_pos[0]
            full[r0 + r_lo:r0 + r_hi, c0 + c_lo:c0 + c_hi] = \
                blk[r_lo:r_hi, c_lo:c_hi].to(params.device)
        out.append(full)
    return type(shards[0])(*out)


def scatter_state(params, state):
    """Per-shard blocks (this process's shards in mesh order, each on its
    shard's device) of a global padded grid given as a NamedTuple of
    tensors (`host_to_device`). An
    edge shard's slack, which lies past the global grid, repeats the
    grid's last line (its values are dead)."""
    cfg = params.config
    rows, cols = cfg.local_shape
    px, py = cfg.proc_dims
    nxl, nyl = cfg.n_local
    nx, ny = cfg.n_global
    sy, sx = py * nyl - ny, px * nxl - nx
    padded = [torch.nn.functional.pad(a[None, None], (0, sx, 0, sy),
                                      mode="replicate")[0, 0]
              if sx or sy else a for a in state]
    return [type(state)(*(a[s.iy * nyl:s.iy * nyl + rows,
                            s.ix * nxl:s.ix * nxl + cols].to(s.device).clone()
                          for a in padded))
            for s in Mesh.of(params).local]
