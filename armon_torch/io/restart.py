"""Checkpoint / restart (`armon_tpu/io/restart.py`).

Exact binary snapshots (npz) of the full solver carry (the State, t,
cycle, dt, the CFL minimum) and a configuration fingerprint, so that a run
can stop and resume bit for bit:

    save_checkpoint(path, params, state, t, cycles, dt_prev)
    shards, t, cycles, dt_prev, local_min = load_checkpoint(path, params)
    armon(params, restore_from=path)

The format is the JAX package's: the same fingerprint string, the same npz
keys (`__fingerprint`, `__t`, `__cycles`, `__dt_prev`, `__local_min`,
`field_<name>`, and `__geom` in per-shard files), so a snapshot written by
either package loads in the other.

Two layouts:

- **global** (the default off a mesh or without `use_MPI`): one npz with
  the gathered padded global state (`interop.gather_state`); it loads
  onto any mesh through `interop.scatter_state`.
- **per-shard** (a mesh with `use_MPI`): one npz per shard,
  `<path minus .npz>_<cx>×<cy>.npz` (the `src/io.jl:53-56` naming), each
  holding its shard's padded block as it is and the `__geom` record of
  the saving mesh; written one shard at a time, with no global gather. A
  load onto the same layout reads each block back as it was; onto
  another layout (`_reshard_load`) each target block is assembled from
  the windows of the source files that cover it. Over several processes
  each process writes and reads its own shards' files, and a save ends on
  a barrier, so a snapshot written by N processes restores on any number
  of processes and any layout.

Snapshots are neutral to the mesh (the fingerprint pins the numerics
only) and to the path. The kernels never write the sound speed back, so a
snapshot of a kernel run carries a cycle-0 `c` and the carried CFL
minimum (`__local_min`); the op path uses that carry for its first
resumed cycle (`core/step.solver_cycle(lm_override=...)`). An op-path
snapshot stores `__local_min = NaN` ("restore from c"), which the kernels
reseed from the saved `c` as a fresh start does.

Periodic saving: ``checkpoint_step=N`` writes `<output_file>.ckpt.npz`
every N cycles (the per-cycle driver); a mesh with `use_MPI` writes the
per-shard layout.
"""

import os

import numpy as np
import torch

from ..core.state import State
from ..parallel import dist
from ..parallel.mesh import Mesh
from ..utils.errors import solver_error


def _fingerprint(params):
    """Everything that makes two solves a different problem, and nothing
    of the device layout (a snapshot restores onto any mesh): the JAX
    package's string, character for character."""
    cfg = params.config
    return (f"{cfg.n_global}|{cfg.nghost}|{np.dtype(cfg.dtype).name}|"
            f"{cfg.test!r}|{cfg.riemann}|{cfg.limiter}|{cfg.projection}|"
            f"{cfg.splitting}")


def _geom(cfg):
    """The saving mesh's block geometry, recorded in per-shard files so
    that a loader can reassemble them without the saver's params: proc
    dims, padded block shape, per-shard real extents, hi-edge extents."""
    return np.array(list(cfg.proc_dims) + list(cfg.local_shape)
                    + list(cfg.n_local) + list(cfg.edge_cells),
                    dtype=np.int64)


def _shard_ckpt_path(path, coords):
    """`<path>_<cx>×<cy>.npz` (`src/io.jl:53-56`)."""
    path = str(path)
    base = path[:-4] if path.endswith(".npz") else path
    return f"{base}_{coords[0]}×{coords[1]}.npz"


# "Argument not given" for save_checkpoint's local_min: None passed
# explicitly means "no carry" (saved as NaN); omitted, the carry armon()
# recorded for the run the params object just completed is taken.
_UNSET = object()


def _scalars(params, t, cycles, dt_prev, local_min):
    return dict(
        __fingerprint=np.array(_fingerprint(params)),
        __t=np.asarray(t), __cycles=np.int64(cycles),
        __dt_prev=np.asarray(dt_prev),
        __local_min=np.asarray(local_min if local_min is not None else np.nan),
    )


def save_checkpoint(path, params, state, t, cycles, dt_prev,
                    local_min=_UNSET, per_shard=None):
    """Write an exact snapshot of `state`: a list of per-shard States in
    the mesh's order, as the drivers hold it, or the global State
    (`stats.data`). `local_min` is the kernels' carried CFL minimum; when
    omitted it is the one the params object's last run recorded (None =
    no carry: the op path restores it from `state.c`). `per_shard=None`
    picks the per-shard layout for a mesh with `use_MPI`; True/False force
    it."""
    cfg = params.config
    if per_shard is None:
        per_shard = cfg.spmd and params.use_MPI
    if local_min is _UNSET:
        local_min = getattr(params, "_final_local_min", None)
        # Keyed on how the state was produced (`_ran_fused`, recorded by
        # the driver that ran): a kernel run's c is its cycle-0 value, so a
        # resume would reseed dt from it and silently diverge. A params
        # object that never ran cannot say, and is refused too.
        if local_min is None and getattr(params, "_ran_fused",
                                         None) is not False:
            solver_error(
                "config",
                "saving a state without its CFL carry: save through the "
                "params object that RAN the solve (it records the carry "
                "and the state's provenance), or pass local_min= "
                "explicitly. A fused-tier state's sound speed is cycle-0 "
                "stale and cannot reseed the time step bit-exactly; pass "
                "local_min=None to accept a non-bit-exact resume.")
    scalars = _scalars(params, t, cycles, dt_prev, local_min)

    if per_shard and cfg.spmd:
        from .subdomain import shard_coords_iter
        for coords, blocks in shard_coords_iter(params, state,
                                                vars=State._fields):
            np.savez(_shard_ckpt_path(path, coords),
                     **scalars, __geom=_geom(cfg),
                     **{f"field_{v}": blocks[v] for v in State._fields})
        # The save is collective: each process wrote its own shards, and a
        # process that restores right after its return must not read a
        # neighbour's half-written file (`armon_tpu/io/restart.py:154-161`).
        dist.barrier(f"save_checkpoint {os.path.basename(str(path))}",
                     params.device)
        return

    from .output import host_array
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        from ..interop import gather_state
        state = gather_state(params, list(state))
    np.savez(path, **scalars,
             **{f"field_{name}": host_array(a)
                for name, a in zip(State._fields, state)})


def _check_scalars(z, params, path):
    fp = str(z["__fingerprint"])
    if fp != _fingerprint(params):
        solver_error("config",
                     f"checkpoint {path} was written with a different "
                     f"configuration:\n  {fp}\n  != {_fingerprint(params)}")
    lm = float(z["__local_min"])
    return (float(z["__t"]), int(z["__cycles"]), float(z["__dt_prev"]),
            None if np.isnan(lm) else lm)


def _on_device(params, arrays, device):
    """A State of `arrays` ({field: numpy}) on `device` in the run's
    dtype."""
    return State(*(torch.from_numpy(np.ascontiguousarray(
        arrays[v], dtype=params.data_type)).to(device)
        for v in State._fields))


def load_checkpoint(path, params):
    """Read a snapshot back, whichever its layout; only the numerics
    fingerprint must match, the device layout is free. Returns (a list of
    per-shard States in the mesh's order, each on its shard's device, t,
    cycles, dt_prev, local_min or None); over several processes, this
    process's shards, read from the windows that cover them."""
    cfg = params.config
    if os.path.exists(path) and not (
            cfg.spmd and os.path.exists(_shard_ckpt_path(path, (0, 0)))):
        with np.load(path, allow_pickle=False) as z:
            meta = _check_scalars(z, params, path)
            host = {v: z[f"field_{v}"] for v in State._fields}
        state = _on_device(params, host, params.device)
        if cfg.spmd:
            from ..interop import scatter_state
            shards = scatter_state(params, state)
        else:
            shards = [state]
        return (shards,) + meta

    p00 = _shard_ckpt_path(path, (0, 0))
    if not os.path.exists(p00):
        solver_error("config", f"checkpoint {path} not found")
    with np.load(p00, allow_pickle=False) as z:
        saved_geom = z["__geom"] if "__geom" in z.files else None
    if saved_geom is None:
        solver_error("config",
                     f"per-shard checkpoint {p00} predates the geometry "
                     "record and cannot be resharded; load it with the "
                     "mesh layout that wrote it")
    if cfg.spmd and tuple(saved_geom[:4]) == (tuple(cfg.proc_dims)
                                              + tuple(cfg.local_shape)):
        return _load_per_shard(path, params)
    return _reshard_load(path, params, saved_geom)


def _merge_meta(meta, m, spath):
    if meta is not None and m[:3] != meta[:3]:
        solver_error("config", f"checkpoint shard {spath} carries different "
                               f"scalars than the first one: {m} != {meta}")
    return meta if meta is not None else m


def _load_per_shard(path, params):
    """Each shard's block from its own file, as it was saved."""
    meta = None
    shards = []
    for s in Mesh.of(params).local:
        spath = _shard_ckpt_path(path, (s.ix, s.iy))
        if not os.path.exists(spath):
            solver_error("config", f"checkpoint shard file {spath} not found")
        with np.load(spath, allow_pickle=False) as z:
            meta = _merge_meta(meta, _check_scalars(z, params, spath), spath)
            shards.append(_on_device(
                params, {v: z[f"field_{v}"] for v in State._fields}, s.device))
    return (shards,) + meta


def _source_regions(geom, g, nx, ny, coords):
    """The (global padded frame rows, cols, in-block rows, cols) regions
    one source shard contributes to the global padded state: its real
    cells, and for border shards the global ghost bands and corners it
    holds (`gather_state`, per shard)."""
    px, py, lr, lc, nxl, nyl, ex, ey = (int(v) for v in geom)
    bx, by = coords
    hy = ey if by == py - 1 else nyl
    wx = ex if bx == px - 1 else nxl
    r0, c0 = g + by * nyl, g + bx * nxl
    rows = [((r0, r0 + hy), (g, g + hy))]
    if by == 0:
        rows.append(((0, g), (0, g)))
    if by == py - 1:
        rows.append(((g + ny, 2 * g + ny), (g + hy, 2 * g + hy)))
    cols = [((c0, c0 + wx), (g, g + wx))]
    if bx == 0:
        cols.append(((0, g), (0, g)))
    if bx == px - 1:
        cols.append(((g + nx, 2 * g + nx), (g + wx, 2 * g + wx)))
    for (gr, br) in rows:
        for (gc, bc) in cols:
            yield gr, gc, br, bc


def _window_from_shards(path, params, geom, r0, r1, c0, c1, meta_box, zcache):
    """The window [r0:r1, c0:c1) of the global padded frame, assembled
    from the source files that intersect it: host memory O(window + one
    source block). `meta_box` holds the scalars checked across files;
    `zcache` ({path: NpzFile}, closed by the caller) keeps each source file
    open across windows."""
    cfg = params.config
    g = cfg.nghost
    nx, ny = cfg.n_global
    px, py, lr, lc, nxl, nyl, ex, ey = (int(v) for v in geom)
    out = {v: np.zeros((r1 - r0, c1 - c0), cfg.dtype) for v in State._fields}
    by_lo = max(0, (r0 - lr + 1 + nyl) // nyl - 1) if nyl else 0
    bx_lo = max(0, (c0 - lc + 1 + nxl) // nxl - 1) if nxl else 0
    for by in range(by_lo, py):
        if g + by * nyl >= r1 and by > 0:
            break
        for bx in range(bx_lo, px):
            if g + bx * nxl >= c1 and bx > 0:
                break
            regions = [(gr, gc, br, bc)
                       for gr, gc, br, bc in _source_regions(
                           geom, g, nx, ny, (bx, by))
                       if gr[0] < r1 and gr[1] > r0
                       and gc[0] < c1 and gc[1] > c0]
            if not regions:
                continue
            spath = _shard_ckpt_path(path, (bx, by))
            if not os.path.exists(spath):
                solver_error("config",
                             f"checkpoint shard file {spath} not found")
            z = zcache.get(spath)
            if z is None:
                z = zcache[spath] = np.load(spath, allow_pickle=False)
                meta_box[0] = _merge_meta(
                    meta_box[0], _check_scalars(z, params, spath), spath)
            for v in State._fields:
                blk = z[f"field_{v}"]
                for (gr, gc, br, bc) in regions:
                    ir0, ir1 = max(gr[0], r0), min(gr[1], r1)
                    ic0, ic1 = max(gc[0], c0), min(gc[1], c1)
                    out[v][ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = \
                        blk[br[0] + ir0 - gr[0]:br[0] + ir1 - gr[0],
                            bc[0] + ic0 - gc[0]:bc[0] + ic1 - gc[0]]
    return out


def _reshard_load(path, params, geom):
    """Load per-shard files written on another mesh layout: each target
    block is assembled from the source files' windows that cover it, the
    slack past the global frame repeating its last line as
    `interop.scatter_state` does, so the blocks equal those of the global
    state re-cut, with host memory O(target block + one source block)."""
    cfg = params.config
    g = cfg.nghost
    nx, ny = cfg.n_global
    gr_rows, gr_cols = ny + 2 * g, nx + 2 * g
    meta_box = [None]
    zcache = {}

    def target_block(row0, col0, lr_t, lc_t):
        r1 = min(row0 + lr_t, gr_rows)
        c1 = min(col0 + lc_t, gr_cols)
        win = _window_from_shards(path, params, geom, row0, r1, col0, c1,
                                  meta_box, zcache)
        sy, sx = row0 + lr_t - r1, col0 + lc_t - c1
        if sy or sx:
            win = {v: np.pad(a, ((0, sy), (0, sx)), mode="edge")
                   for v, a in win.items()}
        return win

    try:
        lr_t, lc_t = cfg.local_shape
        nxl_t, nyl_t = cfg.n_local
        shards = [_on_device(params, target_block(s.iy * nyl_t, s.ix * nxl_t,
                                                  lr_t, lc_t), s.device)
                  for s in Mesh.of(params).local]
        return (shards,) + meta_box[0]
    finally:
        for z in zcache.values():
            z.close()
