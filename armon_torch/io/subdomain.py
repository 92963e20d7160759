"""Per-shard (sub-domain) file I/O with no global gather
(`armon_tpu/io/subdomain.py`).

- One file per shard named `<file>_<cx>×<cy>` (`src/io.jl:46-59`,
  `build_file_path`), written from that shard's cells only;
- the windowed reader that pulls one sub-domain out of a global-domain
  file, so that a mesh run can be checked against the one-device golden
  without the global array (`test/mpi.jl:48-110`,
  `read_sub_domain_from_global_domain_file!`).

The shards are the port's `parallel/mesh.Mesh` blocks: a run's state is a
list of per-shard NamedTuples in the mesh's order, each on its shard's
device, and comes off the device one shard at a time, so host memory stays
O(shard).
"""

import numpy as np

from ..core.state import SAVED_VARS
from ..parallel.mesh import Mesh
from ..utils.errors import solver_error
from .output import host_array, precision_of


def shard_states(params, state):
    """The per-shard NamedTuples (mesh order) of `state`: a list of them
    as the drivers hold it, or one global State (`stats.data`), which is
    cut into blocks (`interop.scatter_state`)."""
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        return list(state)
    if not params.config.spmd:
        return [state]
    from ..interop import scatter_state
    return scatter_state(params, state)


def shard_coords_iter(params, state, vars=SAVED_VARS):
    """Yield ((bx, by), {var: padded (rows, cols) numpy block}) for every
    shard, one at a time."""
    shards = shard_states(params, state)
    for s in Mesh(params.config, params.devices):
        blk = shards[s.index]
        yield (s.ix, s.iy), {v: host_array(getattr(blk, v)) for v in vars}


def shard_real_window(cfg, coords):
    """(rows slice, cols slice, global row0, global col0) of the real cells
    inside a shard's padded block. The hi-edge shard owns only n_edge real
    cells (uneven splits)."""
    g = cfg.nghost
    bx, by = coords
    px, py = cfg.proc_dims
    nxl, nyl = cfg.n_local
    ex, ey = cfg.edge_cells
    wx = ex if bx == px - 1 else nxl
    hy = ey if by == py - 1 else nyl
    return (slice(g, g + hy), slice(g, g + wx), by * nyl, bx * nxl)


def ghost_window(cfg, coords):
    """Like `shard_real_window` but with the ghost bands at global borders
    only (the reference's `global_ghosts`, `src/io.jl:62-66`); row0/col0
    in the ghost-padded global frame."""
    g = cfg.nghost
    bx, by = coords
    px, py = cfg.proc_dims
    rs, cs, gy, gx = shard_real_window(cfg, coords)
    r0 = rs.start - (g if by == 0 else 0)
    r1 = rs.stop + (g if by == py - 1 else 0)
    c0 = cs.start - (g if bx == 0 else 0)
    c1 = cs.stop + (g if bx == px - 1 else 0)
    return (slice(r0, r1), slice(c0, c1),
            gy + (0 if by == 0 else g), gx + (0 if bx == 0 else g))


def sub_domain_file_path(path, coords):
    """`<path>_<cx>×<cy>` (`src/io.jl:53-56`)."""
    return f"{path}_{coords[0]}×{coords[1]}"


def write_sub_domain_files(params, state, path, precision=None,
                           with_ghosts=False):
    """Write one pm3d CSV per shard (`write_sub_domain_file`,
    `src/io.jl:61-75`) with no global gather; off a mesh, one file at
    `path`. Returns the file paths."""
    from .output import write_cells_file
    cfg = params.config
    if precision is None:
        precision = precision_of(cfg)
    win = ghost_window if with_ghosts else shard_real_window
    paths = []
    for coords, blocks in shard_coords_iter(params, state):
        rs, cs, _, _ = win(cfg, coords)
        p = sub_domain_file_path(path, coords) if cfg.spmd else path
        write_cells_file(p, {v: blocks[v][rs, cs] for v in SAVED_VARS},
                         precision)
        paths.append(p)
    return paths


def read_sub_domain_file(cfg, path, coords, with_ghosts=False):
    """Read one per-shard file written by `write_sub_domain_files` back
    into {var: (hy, wx)} arrays (`src/io.jl:169-182,203-219`)."""
    from .output import _read_rows
    rs, cs, _, _ = (ghost_window if with_ghosts else shard_real_window)(
        cfg, coords)
    hy, wx = rs.stop - rs.start, cs.stop - cs.start
    _, data = _read_rows(path, cfg.dtype, hy * wx)
    if data.shape != (hy * wx, len(SAVED_VARS)):
        raise ValueError(f"expected {hy * wx} cells in {path}, got "
                         f"{data.shape[0]}")
    return {v: data[:, k].reshape(hy, wx) for k, v in enumerate(SAVED_VARS)}


def read_global_file_window(cfg, path, coords, skip_header=False,
                            with_ghosts=False):
    """Stream a global-domain pm3d CSV and return only the window of shard
    `coords` (`read_sub_domain_from_global_domain_file!`,
    `test/mpi.jl:48-110`): O(window) host memory. Returns (header,
    {var: (hy, wx) array}), the window covering the shard's real cells
    (and the global-border ghosts with `with_ghosts`)."""
    from . import native
    g = cfg.nghost
    nx, _ = cfg.n_global
    if with_ghosts:
        rs, cs, row0, col0 = ghost_window(cfg, coords)
        gnx = nx + 2 * g
    else:
        rs, cs, row0, col0 = shard_real_window(cfg, coords)
        gnx = nx
    hy, wx = rs.stop - rs.start, cs.stop - cs.start
    header = None
    if skip_header:
        with open(path) as f:
            header = f.readline().strip()
    flat, filled = native.read_window(path, len(SAVED_VARS), gnx, row0, col0,
                                      hy, wx, skip_lines=1 if skip_header else 0)
    if filled != hy * wx:
        solver_error("config",
                     f"global file {path} ended before shard {coords}'s "
                     f"window was filled ({filled}/{hy * wx} cells: a "
                     f"truncated file, or a grid/ghost-layout mismatch?)")
    win = flat.astype(cfg.dtype).reshape(hy, wx, len(SAVED_VARS))
    return header, {v: win[:, :, k] for k, v in enumerate(SAVED_VARS)}


def compare_sub_domain_with_golden(params, state, golden_path, atol, rtol):
    """Compare every shard's real cells against its window of a golden
    global-domain file (header `dt, cycles`), re-streaming the file once
    per shard so host memory stays O(window). Returns (ref_dt, ref_cycles,
    total diff count, max rel diff) (`test/mpi.jl:94-130`)."""
    from .output import count_differences
    cfg = params.config
    total, max_diff = 0, 0.0
    ref_dt = ref_cycles = None
    for coords, blocks in shard_coords_iter(params, state):
        rs, cs, _, _ = shard_real_window(cfg, coords)
        ours = {v: blocks[v][rs, cs] for v in SAVED_VARS}
        header, ref = read_global_file_window(cfg, golden_path, coords,
                                              skip_header=True)
        if ref_dt is None:
            dt_s, cyc_s = header.split(",")
            ref_dt = np.dtype(cfg.dtype).type(dt_s)
            ref_cycles = int(cyc_s)
        cnt, md, _ = count_differences(cfg, ours, ref, atol, rtol)
        total += cnt
        max_diff = max(max_diff, md)
    return ref_dt, ref_cycles, total, max_diff
