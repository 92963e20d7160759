"""The whole-cycle kernels: plain PyTorch versions and wrappers.

Counterpart of `fused_cycle` and `fused_multicycle`
(`armon_tpu/ops/pallas/sweep.py:1717,2027`). Two hand-written CUDA kernels
(`armon_torch/csrc/cycle.cuh`) replace the TPU's:

- ``cycle`` (K4) replaces `_cycle_kernel` (`sweep.py:1571`): both sweeps
  of one cycle in one launch, both ghost fills in-kernel, the stale p and
  the CFL partials that K3 folds (the cycle's last launch folds them in
  its own tail: `ops/sweep.Finish`). On a mesh sharded along Y its Y ghost
  rows come from the neighbours' slabs (the `slab_y` splice of
  `sweep.py:1592-1620`), and the X mirror applies after the splice;
- ``multicycle`` (K5) replaces `_multicycle_kernel` (`sweep.py:1905`):
  up to K cycles in one cooperative launch, with K3's dt recurrence, the
  CFL fold and the stop predicate in-kernel, on the square windows
  `multi_tile` picks for the grid (every tile on the card at once).

Both write out of place, like K1/K2, and use the device loop scalars of
`ops/sweep.py` (``scal`` = [t, dt_prev, lm, dt_use], ``iscal`` = [cycle,
ok, run, next]). Each wrapper runs its plain version for CPU tensors and
launches its kernel (or raises) for CUDA tensors; it never falls back.
"""

import numpy as np
import torch

from ..utils.enums import Axis
from ..utils.errors import solver_error
from ..core.state import torch_dtype
from . import sweep as S
from .sweep import (LAUNCHES, IS_RUN, IS_CYCLE, SC_DTUSE, HALO, MIRRORED,
                    Fold, fill_ghosts_plain, sweep_plain, cfl_partial_plain,
                    cfl_finish_plain, check_ghosts)

# K4's window (columns, rows) by itemsize, shared with csrc/cycle.cuh
# (`K4Geom`: 32 lanes, each with a run of PX positions along X and PY
# along Y): a block writes the (columns - 2 HALO) x (rows - 2 HALO) tile
# inside it.
CYCLE_WINDOW = {4: (96, 64), 8: (64, 64)}

# K5's square windows, shared with csrc/cycle.cuh (`MultiGeom`): edge W =
# S P (a line per S-lane segment, a run of P positions a lane: 16 x 1 and
# 8 x 4), 256 threads a block, and the blocks per SM its launch bounds ask
# for, by (edge, itemsize). `multi_tile` takes the small windows while their
# tiles fit MULTI_SMS x those blocks co-resident (the cooperative launch
# needs every tile on the card at once), else the large ones.
MULTI_SMALL, MULTI_LARGE = 16, 32
MULTI_MINB = {(16, 4): 3, (16, 8): 2, (32, 4): 2, (32, 8): 1}
MULTI_SMS = 132  # an H100 SXM's SMs (`MULTI_SMS` in cycle.cuh)
MULTI_BAR_COLS = 2  # columns past K5's partials: room for its barrier count
# The per-position tile body's window edge (`BASE_L`), which the cycle
# probe's `base_l32` times.
BASE_TILE = 32


def _itemsize(dtype):
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def cycle_window(dtype):
    """(columns, rows) of K4's window for a numpy or torch dtype."""
    return CYCLE_WINDOW[_itemsize(dtype)]


def multi_tile(shape, dtype) -> int:
    """K5's window edge (16 or 32) on a padded (rows, cols) grid of
    `dtype`: the choice `multi_window` (csrc/cycle.cuh) makes."""
    gx, gy = tile_grid(MULTI_SMALL, shape)
    fits = gx * gy <= MULTI_SMS * MULTI_MINB[(MULTI_SMALL, _itemsize(dtype))]
    return MULTI_SMALL if fits else MULTI_LARGE


def tile_grid(window, shape):
    """(grid_x, grid_y) of a K4 / K5 launch over a padded (rows, cols)
    array, for a (columns, rows) window or a square one's edge."""
    wx, wy = (window, window) if isinstance(window, int) else window
    rows, cols = shape
    return -(-cols // (wx - 2 * HALO)), -(-rows // (wy - 2 * HALO))


def covered_cells(window, x_first=True):
    """Cells the two sweeps of one block run over, per cell of its tile:
    the first sweep runs on every cell of the window, the second on the
    first sweep's kept lines."""
    wx, wy = (window, window) if isinstance(window, int) else window
    rx, ry = wx - 2 * HALO, wy - 2 * HALO
    kept = wy * rx if x_first else wx * ry
    return (wx * wy + kept) / (2 * rx * ry)


def n_partials(shape, device, dtype, window=None) -> int:
    """CFL partial maxima a K4 launch (or K5's, with its `window`) writes:
    one per block on the card, one for the whole array in the plain
    version."""
    if torch.device(device).type != "cuda":
        return 1
    gx, gy = tile_grid(window or cycle_window(dtype), shape)
    return gx * gy


def parity_pairs(pairs):
    """(even-cycle, odd-cycle) (x_first, fx, fy) of a `temporal_pairs`
    schedule, which starts on an even cycle."""
    return pairs[0], pairs[1 % len(pairs)]


# ---------------------------------------------------------- plain versions

def _check_keep(cfg, keep, device):
    if keep and not S.fold_on(cfg, device):
        solver_error("config", "an unscaled density is kept only where the "
                               "cycle folds (`ops/sweep.fold_on`)")


def cycle_plain(cfg, x_first, rho, u, v, E, dtx, dty, y_ghosts=MIRRORED,
                n_real=None, keep=False):
    """One cycle in plain PyTorch: both ghost fills of the pre-cycle state,
    Y from `y_ghosts` (mirror or a neighbour's slab per side) then the X
    mirror over every row, slab rows included; then the two sweeps without
    fills, then the CFL maxima of the `n_real` real cells of the result.
    `dtx`, `dty` are 0-dim tensors. Where the cycle folds
    (`ops/sweep.fold_on`) the second sweep takes the first's cross-sweep
    EOS fold, and `keep` leaves its new density unscaled. Returns (rho, u,
    v, E, p_stale, max |u|+c, max |v|+c)."""
    _check_keep(cfg, keep, rho.device)
    fields = fill_ghosts_plain(
        cfg, Axis.X, fill_ghosts_plain(cfg, Axis.Y, (rho, u, v, E), n_real,
                                       y_ghosts), n_real)
    a1, d1, a2, d2 = ((Axis.X, dtx, Axis.Y, dty) if x_first
                      else (Axis.Y, dty, Axis.X, dtx))
    f1, f2 = (Fold(None, True), Fold(a1, keep)) \
        if S.fold_on(cfg, rho.device) else (None, None)
    out = sweep_plain(cfg, a1, *fields, d1, (None, None), fold=f1)
    out = sweep_plain(cfg, a2, *out[:4], d2, (None, None), fold=f2)
    mx, my = cfl_partial_plain(cfg, out[1], out[2], out[5], n_real)
    return out[:5] + (mx, my)


def _cycle_plain_into(cfg, x_first, fx, fy, src, dst, p, partials, scal,
                      iscal, emit, y_ghosts=MIRRORED, n_real=None, keep=False):
    if not int(iscal[IS_RUN]):
        for s, d in zip(src, dst):
            d.copy_(s)
        return
    T = np.dtype(cfg.dtype).type
    dt = scal[SC_DTUSE]
    out = cycle_plain(cfg, x_first, *src, dt * float(T(fx)),
                      dt * float(T(fy)), y_ghosts, n_real, keep)
    for d, o in zip(dst, out[:4]):
        d.copy_(o)
    if emit:
        p.copy_(out[4])
        partials[0, 0] = out[5]
        partials[1, 0] = out[6]


def multicycle_plain(cfg, pairs, ncycles, src, dst, p, scal, iscal):
    """Plain version of K5: `ncycles` cycles, each K3's step (the fold of
    the previous cycle's maxima, the run predicate, the dt recurrence)
    then `cycle_plain` with the (x_first, fx, fy) of the cycle's parity
    (the second sweep folding as there), or a copy when the cycle does not
    run;
    the fields ping-pong between `src` and `dst`, and a final fold leaves
    lm the CFL minimum of the last state."""
    part = torch.zeros((2, 1), dtype=src[0].dtype, device=src[0].device)
    even_odd = parity_pairs(pairs)
    for k in range(ncycles):
        cfl_finish_plain(cfg, part, 1, scal, iscal, fold=k > 0, step=True)
        a, b = (src, dst) if k % 2 == 0 else (dst, src)
        cyc = int(iscal[IS_CYCLE]) - 1  # the cycle this step started
        xf, fx, fy = even_odd[cyc % 2]
        _cycle_plain_into(cfg, xf, fx, fy, a, b, p, part, scal, iscal, True)
    cfl_finish_plain(cfg, part, 1, scal, iscal, fold=True, step=False)


# ---------------------------------------------------------------- wrappers

def cycle(cfg, x_first, fx, fy, src, dst, p, partials, scal, iscal, emit,
          y_ghosts=MIRRORED, n_real=None, finish=None, cond=None, keep=False):
    """K4: one X/Y pair of sweeps of (rho, u, v, E) `src` into `dst`, X
    first when `x_first`, with dt = scal[dt_use] * fx along X and * fy
    along Y; copied through when iscal[run] is 0. Y ghost rows come from
    `y_ghosts` (mirror, or a (4, g, cols) slab of the neighbour's rows),
    X ghost columns from the mirror. With `emit` (the cycle's last launch)
    it also writes the stale p and the CFL partial maxima of the `n_real`
    real cells (`partials`, `finish`, K3's tail, and `cond`, the WHILE
    condition, as in `ops/sweep.x_sweep`). The second sweep folds as in
    `cycle_plain`, and `keep` leaves its new density unscaled (Strang's
    pair, a K1 follows in the cycle). Replaces `_cycle_kernel` (`sweep.py:1571`), its
    `slab_y` variant included."""
    device = src[0].device
    S._check(cfg, tuple(src) + tuple(dst) + ((p,) if emit else ()),
             src[0].shape, device)
    slab = check_ghosts(cfg, Axis.Y, y_ghosts, src[0].shape, device)
    S.check_finish(finish, emit, cond)
    S.check_cond(cond, device)
    _check_keep(cfg, keep, device)
    if device.type == "cuda":
        from . import _build
        _build.launch_cycle(cfg, x_first, fx, fy, src, dst, p, partials,
                            scal, iscal, emit, y_ghosts, n_real or cfg.n_local,
                            finish, cond, keep)
        LAUNCHES["cycle_slab" if slab else "cycle"] += 1
        if finish is not None:
            S.TAILS["cfl_tail"] += 1
        return
    _cycle_plain_into(cfg, x_first, fx, fy, src, dst, p, partials, scal,
                      iscal, emit, y_ghosts, n_real, keep)
    S.finish_plain(cfg, finish, scal, iscal)
    S.cond_plain(cond)


def multi_partials(shape, device, dtype) -> int:
    """CFL partial maxima K5 writes: one per tile of `multi_tile`'s
    windows on the card, one for the whole array in the plain version."""
    return n_partials(shape, device, dtype, multi_tile(shape, dtype))


def new_multicycle_partials(shape, dtype, device):
    """K5's CFL partials: two cycle parities of (2, n) maxima, n =
    `multi_partials`, each row followed by MULTI_BAR_COLS columns, whose
    last 8 bytes (the last row's) hold K5's grid barrier count: zeroed
    here, then only K5 writes it (`MultiArgs::bar`)."""
    nb = multi_partials(shape, device, dtype)
    return torch.zeros((2, 2, nb + MULTI_BAR_COLS), dtype=torch_dtype(dtype),
                       device=device)


def multicycle(cfg, pairs, src, dst, p, partials, scal, iscal, cond=None):
    """K5: len(pairs) cycles of (rho, u, v, E) in one launch (`pairs` from
    `temporal_pairs`), each with the dt recurrence, both fills, both
    sweeps, the stale p and the CFL fold; a cycle whose (t < maxtime) &
    (cycle < maxcycle) & ok predicate fails changes nothing. The fields
    ping-pong, so the carry ends in `src` for an even count and in `dst`
    for an odd one, whatever number of cycles ran. `partials` is
    `new_multicycle_partials`' scratch. With `cond` (`ops/sweep.Cond`: the
    last launch of a whole-run graph's body) it sets that WHILE condition
    from iscal[next]. Each cycle's second sweep folds as in `cycle_plain`.
    Replaces `_multicycle_kernel` (`sweep.py:1905`)."""
    device = src[0].device
    if not pairs:
        solver_error("config", "multicycle needs at least one cycle")
    S._check(cfg, tuple(src) + tuple(dst) + (p,), src[0].shape, device)
    S.check_cond(cond, device)
    if device.type == "cuda":
        from . import _build
        _build.launch_multicycle(cfg, parity_pairs(pairs), len(pairs), src,
                                 dst, p, partials, scal, iscal, cond)
        LAUNCHES["multicycle"] += 1
        return
    multicycle_plain(cfg, pairs, len(pairs), src, dst, p, scal, iscal)
    S.cond_plain(cond)
