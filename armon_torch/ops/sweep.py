"""The per-sweep kernels: plain PyTorch versions, wrappers, launch counts.

Counterpart of `armon_tpu/ops/pallas/sweep.py`. Three hand-written CUDA
kernels (`armon_torch/csrc/`) replace the TPU's per-sweep kernels:

- ``x_sweep`` (K1) replaces `_x_sweep_kernel` (+ `_bc_x_apply`,
  `_dt_tile_min`);
- ``y_sweep`` (K2) replaces `_y_sweep_kernel` (+ `_halo_cat_bc`,
  `_dt_tile_min`);
- ``cfl_finish`` (K3) replaces the cross-tile half of the CFL reduction
  (`_dt_from_tiles`) and runs the dt recurrence of
  `core/timestep.dt_update_host` on the device, as `_multicycle_kernel`
  does in-kernel.

The cycle's last launch (K1, K2 or K4's, with `finish`, a `Finish`) runs
K3's fold and dt step in its tail: the block that finishes last folds
every block's partials in K3's order, as the TPU's sweep kernel
accumulated its cross-tile maximum in-kernel (`_dt_tile_min`); the loop
launches K3 itself only for the run's first step (`core/step.py`).

Both sweeps share one device body, the port of `_sweep_math`. They read
rho/u/v/E and write the new fields OUT OF PLACE into a second buffer set:
blocks of a GPU grid run concurrently, so the TPU's in-place aliasing
(safe there only because its grid runs in order) would race.

The device holds the loop scalars, so a run needs no host read per cycle:
``scal`` (dtype T) is [t, dt_prev, lm, dt_use] and ``iscal`` (int32) is
[cycle, ok, run, next]. `cfl_finish` folds the previous cycle's CFL
partials into lm, decides whether this cycle runs (``run``), and if so
advances t, cycle, dt_prev and ok; ``next`` is the stop predicate for the
cycle after. A sweep whose cycle does not run copies its inputs to its
outputs, so cycles past the end change nothing.

Each side of the swept axis takes its ghost band from one of three
sources (`ghosts` = (low side, high side)): `MIRROR`, the in-kernel mirror
fill of a global border (`_bc_x_apply`, `_halo_cat_bc`); a stacked
(4, ...) slab of a mesh neighbour's real lines (`parallel/halo.py`), the
splice of `_bc_x_apply_slab` / `_halo_cat_slab` that the TPU kernels
compile for sharded axes; or None, a band filled beforehand. `n_real` is
the shard's (nx, ny) real extent, `cfg.n_local` unless the hi-edge shard
of an uneven split owns fewer cells.

Each wrapper dispatches on the device of its tensors: on the CPU it runs
the plain version below (exact IEEE arithmetic); on a CUDA tensor it
launches its kernel or raises. It never falls back.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..models.cases import Bizarrium
from ..utils.enums import Axis, sides_along
from ..utils.errors import solver_error
from ..core.timestep import dt_update_host
from ..core.state import torch_dtype
from .eos import fold_const, folds, ieee_sqrt, scalar_like
from .fma import fma
from .projection import sign as _sign

# Scalar slots of the device state (see module doc).
SC_T, SC_DTPREV, SC_LM, SC_DTUSE = range(4)
IS_CYCLE, IS_OK, IS_RUN, IS_NEXT = range(4)

# Launch geometry, shared with csrc/sweep.cuh (`XGeom`, `YGeom`). A segment
# of a line reads HALO positions on each side that it does not write. K1:
# a warp sweeps windows of X_WINDOW consecutive columns of a row (a lane a
# run of X_WINDOW // 32), X_WARPS warps a block, up to X_WINDOWS_PER_WARP
# windows a warp. K2: a thread marches down one column of a segment of
# Y_ROWS output rows, Y_THREADS columns a block. On a grid that would give
# fewer than X_MIN_BLOCKS / Y_MIN_BLOCKS blocks, K1 gives a warp fewer
# windows and K2 halves its segments, down to Y_ROWS_MIN rows. Every block
# is on grid_x.
HALO = 4
X_WINDOW, X_WARPS, X_WINDOWS_PER_WARP, X_MIN_BLOCKS = 128, 8, 8, 2048
Y_ROWS, Y_ROWS_MIN, Y_THREADS, Y_MIN_BLOCKS = 128, 32, 128, 512

# Launches made on the card, by kernel (K4/K5's wrappers are in
# `ops/cycle.py`, K6's in `ops/reductions.py`). Counted where the wrapper
# launches, and nowhere else; a launch that splices a neighbour's slab on
# either side counts under the kernel's slab variant.
LAUNCHES = {"x_sweep": 0, "y_sweep": 0, "cfl_finish": 0, "cycle": 0,
            "multicycle": 0, "x_sweep_slab": 0, "y_sweep_slab": 0,
            "cycle_slab": 0, "ff_sum": 0}
# Launches above that carried K3's tail (`Finish`), by the tail's name: a
# tail is not a launch of its own, so it is not in LAUNCHES.
TAILS = {"cfl_tail": 0}

# Ghost sources of a side (see module doc).
MIRROR = "mirror"
MIRRORED = (MIRROR, MIRROR)


class Fold(NamedTuple):
    """The cross-sweep EOS fold (`ops/eos.folds`) of one launch inside a
    cycle's schedule, on a route that takes it (`fold_on`). `prev`: the
    axis of the sweep before the launch's first sweep in the same cycle;
    the launch's rho operand then holds that sweep's unscaled new density
    X, from which the sweep takes rho = X * RN(1/d) (the value that sweep
    would have stored, bit for bit) and p = (X * K) * e (`fold_const`).
    None: the cycle's first launch, scaled rho. `keep`: the launch's last
    sweep stores its new density unscaled, for the next launch of the
    cycle. A K1 or K2 launch without a Fold (None) folds nothing: a sweep
    on its own. K4 and K5 take no Fold: each of their cycles starts its
    cycle, and folds between its own two sweeps wherever `fold_on`."""
    prev: object = None
    keep: bool = False


class Finish:
    """K3's work for the tail of the cycle's last launch: fold columns
    [0, n) of `partials` (2, >= n), the launch's own and, on a one-card
    mesh, the earlier shards', into lm, then one dt step. `ticket` is an
    int32 counter of the launch's finished blocks, 0 between launches
    (`new_ticket`); one per loop. The launcher keeps the kernel's
    arguments on it (`args`), built once for a configuration and a set of
    operands."""
    __slots__ = ("partials", "n", "ticket", "args")

    def __init__(self, partials, n, ticket):
        self.partials, self.n, self.ticket = partials, n, ticket
        self.args = None


class Cond:
    """The WHILE condition of a whole-run graph (`csrc/graph.cu`), which
    the last launch of its body sets in its tail: `handle`, the node's
    condition handle (`_build.while_create`); `count`, an int32 tensor of
    the iterations, which that tail adds one to. Only the body's last
    launch carries one, and only inside the capture of that body
    (`check_cond`): eager and window launches carry none. Its launcher
    keeps the arguments it built on `args`; `launches` counts the
    launches that took it."""
    __slots__ = ("handle", "count", "args", "launches")

    def __init__(self, handle, count):
        self.handle, self.count = handle, count
        self.args = None
        self.launches = 0


def check_cond(cond, device):
    """A launch on `device` may carry the WHILE condition `cond` only
    inside a capture on the card: a graph launched on its own, or an
    eager launch, has no WHILE node for the handle to name. On the CPU
    the plain version counts the iteration (`cond_plain`)."""
    if cond is None:
        return
    if device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        solver_error("config", "a WHILE condition is set only by the last "
                               "launch of a whole-run graph's body, inside "
                               "its capture")
    cond.launches += 1


def cond_plain(cond):
    """Plain version of the condition the tail sets: the iteration
    counted. On the CPU no graph runs and nothing holds a condition:
    `core/graphs.while_plain`, the whole-run graph's plain version, reads
    the predicate itself."""
    if cond is not None:
        cond.count += 1


def new_ticket(device):
    return torch.zeros(1, dtype=torch.int32, device=device)


def reset_launches():
    for counts in (LAUNCHES, TAILS):
        for k in counts:
            counts[k] = 0


def x_windows_per_warp(shape):
    """K1's windows per warp over a padded (rows, cols) array
    (`x_windows_per_warp` in csrc/sweep.cuh)."""
    rows, cols = shape
    windows = rows * -(-cols // (X_WINDOW - 2 * HALO))
    return max(1, min(X_WINDOWS_PER_WARP, windows // (X_WARPS * X_MIN_BLOCKS)))


def y_segment_rows(shape):
    """K2's segment rows over a padded (rows, cols) array
    (`y_segment_rows` in csrc/sweep.cuh)."""
    rows, cols = shape
    h = Y_ROWS
    while h > Y_ROWS_MIN and -(-cols // Y_THREADS) * -(-rows // h) < Y_MIN_BLOCKS:
        h //= 2
    return h


def segments(axis, shape):
    """Segments of a line a sweep kernel writes, each from its own
    segment read with HALO more positions on each side: (segment length,
    segments per line). K1: X_WINDOW - 2 HALO columns of a row; K2:
    `y_segment_rows` rows of a column."""
    rows, cols = shape
    if axis is Axis.X:
        step = X_WINDOW - 2 * HALO
        return step, -(-cols // step)
    step = y_segment_rows(shape)
    return step, -(-rows // step)


def grid_dims(axis, shape):
    """(grid_x, grid_y) of a sweep kernel launch over a padded (rows, cols)
    array (`sweep_blocks` in csrc/sweep.cuh): K1 one block per X_WARPS x
    `x_windows_per_warp` windows, K2 one per Y_THREADS columns of a
    segment; grid_y is 1."""
    rows, cols = shape
    _, segs = segments(axis, shape)
    if axis is Axis.X:
        return -(-rows * segs // (X_WARPS * x_windows_per_warp(shape))), 1
    return -(-cols // Y_THREADS) * segs, 1


def n_partials(axis, shape, device) -> int:
    """CFL partial maxima a sweep writes: one per block on the card, one
    for the whole array in the plain version."""
    if torch.device(device).type != "cuda":
        return 1
    gx, gy = grid_dims(axis, shape)
    return gx * gy


def new_scalars(dtype, device, t=0.0, cycle=0, dt_prev=0.0, lm=0.0):
    """Fresh device loop scalars (scal, iscal), filled by `fill_scalars`."""
    scal = torch.empty(4, dtype=torch_dtype(dtype), device=device)
    iscal = torch.empty(4, dtype=torch.int32, device=device)
    fill_scalars(scal, iscal, t, cycle, dt_prev, lm)
    return scal, iscal


def fill_scalars(scal, iscal, t=0.0, cycle=0, dt_prev=0.0, lm=0.0):
    """The loop scalars of a run's start, written in place (a loop keeps
    its scalars across calls, and its graphs read them where they are):
    t, cycle, dt_prev and lm as given, ok and next 1; ``run`` starts at 0
    so the first `cfl_finish` keeps the seeded lm."""
    scal.copy_(torch.tensor([t, dt_prev, lm, 0.0], dtype=scal.dtype))
    iscal.copy_(torch.tensor([cycle, 1, 0, 1], dtype=torch.int32))


def fast_math_on(cfg, device) -> bool:
    """Approximate-reciprocal divides: f32 on the card with use_fast_math.
    The plain version always divides exactly."""
    return (cfg.fast_math and np.dtype(cfg.dtype).itemsize == 4
            and torch.device(device).type == "cuda")


def fold_on(cfg, device) -> bool:
    """Whether the launches of a cycle take the cross-sweep EOS fold
    (`Fold`): the perfect gas (`ops/eos.folds`) in exact arithmetic. The
    fast-math instances keep their dataflow: they are not bit for bit with
    the plain versions in any case."""
    return folds(cfg) and not fast_math_on(cfg, device)


def check_fold(cfg, fold, device):
    if fold is not None and not fold_on(cfg, device):
        solver_error("config", "the cross-sweep EOS fold is for the perfect "
                               "gas in exact arithmetic (`fold_on`)")


# ---------------------------------------------------------- plain versions

def _limiter(name, r):
    # src/limiters.jl:6-8
    if name == "no_limiter":
        return torch.ones_like(r)
    zero = torch.zeros_like(r)
    if name == "minmod":
        return torch.maximum(zero, torch.minimum(torch.ones_like(r), r))
    return torch.maximum(torch.maximum(zero, torch.minimum(2.0 * r, torch.ones_like(r))),
                         torch.minimum(r, 2.0 * torch.ones_like(r)))


def eos_prc_plain(cfg, rho, u, v, E, xk=None):
    """Exact-IEEE branch of `_eos_prc` (`sweep.py:117-251`): returns
    (p, rho*c, c) of the pre-sweep state. `xk`: X * K of a folded sweep
    (`Fold`), the perfect gas's p = xk * e."""
    T = np.dtype(cfg.dtype).type
    f = float
    if isinstance(cfg.test, Bizarrium):
        rho0 = T(10000.0); K0 = T(1e11); Cv0 = T(1000.0); T0 = T(300.0)
        eps0 = T(0.0); G0 = T(1.5); s = T(1.5)
        q = T(-42080895.0 / 14941154.0); r = T(727668333.0 / 149411540.0)
        x = rho / scalar_like(rho, rho0) - 1
        G = f(G0) * (1 - scalar_like(rho, rho0) / rho)
        den = 1 - f(s) * x
        x2 = x * x
        xp1 = 1 + x
        f0 = (1 + f(s / 3 - 2) * x + f(q) * x2 + f(r) * (x * x2)) / den
        f1 = (f(s / 3 - 2) + f(2 * q) * x + f(3 * r) * x2 + f(s) * f0) / den
        epsk0 = f(eps0) - f(Cv0 * T0) * (1 + G) + f(0.5 * (K0 / rho0)) * x2 * f0
        pk0 = f(-Cv0 * T0 * G0 * rho0) + f(0.5 * K0) * x * (xp1 * xp1) * (2 * f0 + x * f1)
        pk0prime = f(-0.5 * K0) * (xp1 * (xp1 * xp1)) * f(rho0) * (
            2 * (1 + 3 * x) * f0 + 2 * x * (2 + 3 * x) * f1
            + x2 * xp1 * ((f(2 * q) + f(6 * r) * x + f(2 * s) * f1) / den))
        e = fma(fma(u, u, v * v), -0.5, E)
        p = fma(f(G0 * rho0), e - epsk0, pk0)
        sq = ieee_sqrt(fma(f(G0 * rho0), p - pk0, -pk0prime))
        c = sq / rho
        return p, rho * c, c
    gm = T(cfg.gamma)
    e = fma(fma(u, u, v * v), -0.5, E)
    p = f(gm - T(1.0)) * rho * e if xk is None else xk * e
    c = ieee_sqrt(f(gm) * p / rho)
    return p, rho * c, c


def _godunov(rc_l, rc_r, u_i, u_im, p_i, p_im):
    # src/riemann_schemes.jl:21-30 (rc = rho*c acoustic impedances), with
    # the op path's contractions (`ops/riemann.py` `acoustic_godunov`)
    rc_sum = rc_l + rc_r
    ustar = (fma(rc_l, u_im, rc_r * u_i) + (p_im - p_i)) / rc_sum
    pstar = fma(rc_l * rc_r, u_im - u_i, fma(rc_r, p_im, rc_l * p_i)) / rc_sum
    return ustar, pstar


def sweep_math_plain(cfg, sh, dt, dx, rho, uax, uot, E, along_y=False,
                     fold_in=None, keep=False):
    """Line-for-line port of `_sweep_math` (`sweep.py:297-550`) in exact
    IEEE arithmetic with the `slope_shift=True` euler_2nd form, contracting
    the products that the op path contracts (`ops/fma.py`) and
    multiplying by `inv_dx` where it divides by the constant dx. `sh(a,
    k)` reads at offset +k along the sweep axis; `dt` and `dx` are 0-dim
    tensors of dtype T, `inv_dx` is T(1) / T(dx). `along_y`: the axis
    velocity is v (the EOS contracts u*u + v*v as fma(u, u, v*v) whatever
    the axis). `fold_in`: (RN(1/d), K) of the previous sweep of the
    cycle (`Fold`), rho then holding its unscaled new density X; `keep`:
    return the new density unscaled. Returns (rho', uax', uot', E',
    p_stale, c_stale)."""
    T = np.dtype(cfg.dtype).type
    inv_dx = torch.ones_like(dx) / dx
    xk = None
    if fold_in is not None:
        rdx, K = (scalar_like(rho, k) for k in fold_in)
        xk = rho * K
        rho = rho * rdx
    p, rc, c = eos_prc_plain(cfg, rho, *((uot, uax) if along_y else (uax, uot)),
                             E, xk)
    dm = rho * dx

    # the neighbour's rho * c, formed from its rho and c as the kernels
    # form it (the same bits as sh(rc, -1) for a true shift)
    rho_m, c_m = sh(rho, -1), sh(c, -1)
    rc_l = rho_m * c_m
    if cfg.riemann == "Godunov":
        ustar, pstar = _godunov(rc_l, rc, uax, sh(uax, -1), p, sh(p, -1))
    else:  # GAD (src/riemann_schemes.jl:55-104)
        u_m = sh(uax, -1)
        p_m = sh(p, -1)
        us_i, ps_i = _godunov(rc_l, rc, uax, u_m, p, p_m)
        e_u = us_i - u_m
        e_p = ps_i - p_m
        d_u = uax - us_i
        d_p = p - ps_i
        eps = float(T(1e-6))
        r_um = _limiter(cfg.limiter, sh(e_u, 1) / (e_u + eps))
        r_pm = _limiter(cfg.limiter, sh(e_p, 1) / (e_p + eps))
        r_up = _limiter(cfg.limiter, sh(d_u, -1) / (d_u + eps))
        r_pp = _limiter(cfg.limiter, sh(d_p, -1) / (d_p + eps))
        Dm = fma(rho_m, dx, dm) / 2
        theta = float(T(0.5)) * fma(-(fma(rho_m, c_m, rc) / 2), dt / Dm, 1.0)
        ustar = fma(theta, fma(r_up, d_u, -(r_um * e_u)), us_i)
        pstar = fma(theta, fma(r_pp, d_p, -(r_pm * e_p)), ps_i)

    # Lagrangian cell update (src/kernels.jl:58-68)
    us_p = sh(ustar, 1)
    ps_p = sh(pstar, 1)
    dX = fma(dt, us_p - ustar, dx)
    rho1 = dm / dX
    dt_dm = dt / dm
    uax1 = fma(dt_dm, pstar - ps_p, uax)
    E1 = fma(dt_dm, fma(pstar, ustar, -(ps_p * us_p)), E)

    # Advection fluxes (src/projection_schemes.jl:62-124)
    disp = dt * ustar
    up = disp > 0

    def rd(a):  # upwind read: a[k-1] where the flux goes up, else a[k]
        return torch.where(up, sh(a, -1), a)

    fields = (rho1, rho1 * uax1, rho1 * uot, rho1 * E1)
    if cfg.projection == "euler":
        q = [rd(a) for a in fields]
    else:
        dxl = rd(dX)
        dxe = torch.where(up, -fma(-dt, sh(ustar, -1), dx),
                          fma(dt, sh(ustar, 1), dx))
        r_m = (2 * dX) / (dX + sh(dX, -1))
        r_p = (2 * dX) / (dX + sh(dX, 1))
        zero = torch.zeros_like(dX)

        def slope_base(q):
            du_p = r_p * (sh(q, 1) - q)
            du_m = r_m * (q - sh(q, -1))
            sgn = _sign(du_p)
            return sgn * torch.maximum(zero, torch.minimum(torch.abs(du_p), sgn * du_m))

        lf = dxe / (2 * dxl)
        q = [fma(-rd(slope_base(a)), lf, rd(a)) for a in fields]

    # Projection (src/projection_schemes.jl:23-41); the fluxes are disp *
    # q, contracted into their differences as `ops/projection.py`
    # `euler_projection` does: the rho flux of the cell, the others' of
    # the next cell
    d_rho = fma(-disp, q[0], sh(disp * q[0], 1))
    d_ur, d_vr, d_Er = (fma(sh(disp, 1), sh(a, 1), -(disp * a)) for a in q[1:])
    dX_rho = dX * rho1
    den = (dX_rho - d_rho) * inv_dx
    X = fma(dX, rho1, -d_rho)
    return (X if keep else X * inv_dx,
            fma(dX_rho, uax1, -d_ur) * inv_dx / den,
            fma(dX_rho, uot, -d_vr) * inv_dx / den,
            fma(dX_rho, E1, -d_Er) * inv_dx / den, p, c)


def mirror_factors(cfg, axis):
    """((rho, u, v, E) factors of the low side, of the high side) for the
    mirror ghost fill along `axis` (`src/tests.jl:150-161`)."""
    lo, hi = sides_along(axis)
    u_lo, v_lo = cfg.test.boundary_factors(lo)
    u_hi, v_hi = cfg.test.boundary_factors(hi)
    return (1.0, u_lo, v_lo, 1.0), (1.0, u_hi, v_hi, 1.0)


def ghost_mode(side) -> int:
    """0: band left as it is (None), 1: `MIRROR`, 2: a slab tensor."""
    if side is None:
        return 0
    if isinstance(side, str):
        if side != MIRROR:
            solver_error("config", f"unknown ghost source {side!r}")
        return 1
    return 2


def fill_ghosts_plain(cfg, axis, fields, n_real=None, ghosts=MIRRORED):
    """The ghost bands of (rho, u, v, E) along `axis`, low side then high
    side (`armon_tpu/ops/boundary.py`, `parallel/halo.py`): `MIRROR` gives
    ghost cell g-1-i the real cell g+i times the variable's ±1 factor (the
    high band sits after the shard's `n_real` real cells), a slab is copied
    in, None leaves the band. Returns new tensors."""
    g = cfg.nghost
    d = axis.array_axis
    n = (n_real or cfg.n_local)[int(axis)]
    modes = [ghost_mode(s) for s in ghosts]
    out = []
    for k, (a, fl, fh) in enumerate(zip(fields, *mirror_factors(cfg, axis))):
        a = a.clone()
        for side, (mode, src, f, start) in enumerate(
                zip(modes, ghosts, (fl, fh), (0, g + n))):
            if mode == 1:
                ref = torch.flip(a.narrow(d, n if side else g, g), (d,))
                a.narrow(d, start, g).copy_(ref if f == 1.0 else ref * f)
            elif mode == 2:
                a.narrow(d, start, g).copy_(src[k])
        out.append(a)
    return out


def cfl_partial_plain(cfg, u, v, c, n_real=None):
    """(max(|u|+c), max(|v|+c)) over the shard's real cells, floored at 0
    like the TPU's zero-initialised tile block (`_dt_tile_min`); NaN
    propagates."""
    g = cfg.nghost
    nx, ny = n_real or cfg.n_local
    r = (slice(g, g + ny), slice(g, g + nx))
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    mx = torch.maximum(zero, torch.amax(torch.abs(u[r]) + c[r]))
    my = torch.maximum(zero, torch.amax(torch.abs(v[r]) + c[r]))
    return mx, my


def sweep_plain(cfg, axis, rho, u, v, E, dt, ghosts=MIRRORED, n_real=None,
                fold=None):
    """One sweep in plain PyTorch. `dt` is a 0-dim tensor (already scaled
    by the schedule's factor). The ghost bands along the axis are filled
    first from `ghosts` (the in-kernel fills of the TPU's `fused_sweep_ip`:
    mirror or slab splice; None for a band filled already, as `fused_sweep`
    takes them); with a `fold` (`Fold`) whose `prev` is set, the bands,
    and rho, hold X. Returns (rho, u, v, E, p_stale, c_stale)."""
    T = np.dtype(cfg.dtype).type
    if any(ghost_mode(s) for s in ghosts):
        rho, u, v, E = fill_ghosts_plain(cfg, axis, (rho, u, v, E), n_real,
                                         ghosts)
    d = axis.array_axis
    dx = scalar_like(rho, T(cfg.cell_size(axis)))

    def sh(a, k):
        return torch.roll(a, -k, d) if k else a

    fold = fold or Fold()
    kw = dict(fold_in=None if fold.prev is None else fold_const(cfg, fold.prev),
              keep=fold.keep)
    if axis is Axis.X:
        rho2, u2, v2, E2, p, c = sweep_math_plain(cfg, sh, dt, dx, rho, u, v, E,
                                                  **kw)
    else:
        rho2, v2, u2, E2, p, c = sweep_math_plain(cfg, sh, dt, dx, rho, v, u, E,
                                                  along_y=True, **kw)
    return rho2, u2, v2, E2, p, c


def cfl_finish_plain(cfg, partials, nblocks, scal, iscal, fold=True,
                     step=True):
    """Plain version of K3, on the same device scalars (see module doc),
    with numpy scalars of dtype T for the arithmetic: numpy rounds every
    operation to T as the kernel does."""
    T = np.dtype(cfg.dtype).type
    s = scal.cpu().numpy().astype(T)
    i = iscal.cpu().numpy().astype(np.int64)
    if fold and i[IS_RUN]:
        part = partials.cpu().numpy().astype(T)[:, :nblocks]
        mx = np.max(np.concatenate([[T(0.0)], part[0]]))
        my = np.max(np.concatenate([[T(0.0)], part[1]]))
        s[SC_LM] = np.minimum(T(cfg.dx) / mx, T(cfg.dy) / my)
    if step:
        run = bool(s[SC_T] < T(cfg.maxtime) and i[IS_CYCLE] < cfg.maxcycle
                   and i[IS_OK])
        if run:
            dt_use, dt_next, ok = dt_update_host(cfg, s[SC_LM], s[SC_DTPREV],
                                                 int(i[IS_CYCLE]))
            s[SC_DTUSE] = dt_use
            s[SC_T] = s[SC_T] + dt_use
            s[SC_DTPREV] = dt_next
            i[IS_CYCLE] += 1
            i[IS_OK] = ok
        i[IS_RUN] = run
        i[IS_NEXT] = bool(s[SC_T] < T(cfg.maxtime)
                          and i[IS_CYCLE] < cfg.maxcycle and i[IS_OK])
    scal.copy_(torch.from_numpy(s))
    iscal.copy_(torch.from_numpy(i.astype(np.int32)))


# ---------------------------------------------------------------- wrappers

def _check(cfg, tensors, shape, device, what="sweep operand"):
    tdt = torch_dtype(cfg.dtype)
    for t in tensors:
        if t.dtype != tdt or tuple(t.shape) != tuple(shape) \
                or t.device != device or not t.is_contiguous():
            solver_error("config", f"{what} must be a contiguous "
                                   f"{tdt} tensor of shape {tuple(shape)} on "
                                   f"{device}; got {t.dtype} "
                                   f"{tuple(t.shape)} on {t.device}")


def check_ghosts(cfg, axis, ghosts, shape, device) -> bool:
    """Validate the (lo, hi) ghost sources of a launch over a padded
    (rows, cols) block; True when either side is a slab."""
    slabs = [s for s in ghosts if ghost_mode(s) == 2]
    if slabs:
        rows, cols = shape
        g = cfg.nghost
        _check(cfg, slabs, (4, rows, g) if axis is Axis.X else (4, g, cols),
               device, f"{axis.name} ghost slab")
    return bool(slabs)


def check_finish(finish, emit, cond=None):
    if finish is not None and not emit:
        solver_error("config", "only an emitting launch (the cycle's last) "
                               "can carry K3's tail")
    if cond is not None and finish is None:
        solver_error("config", "only a launch that carries K3's tail sets a "
                               "WHILE condition: it sets it from the "
                               "predicate its tail writes")


def finish_plain(cfg, finish, scal, iscal):
    """Plain version of the tail: K3's plain version, fold and step."""
    if finish is not None:
        cfl_finish_plain(cfg, finish.partials, finish.n, scal, iscal)


def _sweep(cfg, axis, src, dst, p, partials, scal, iscal, factor, emit,
           ghosts, n_real, finish, cond, fold):
    rho = src[0]
    device = rho.device
    _check(cfg, tuple(src) + tuple(dst) + ((p,) if emit else ()),
           rho.shape, device)
    slab = check_ghosts(cfg, axis, ghosts, rho.shape, device)
    check_finish(finish, emit, cond)
    check_cond(cond, device)
    check_fold(cfg, fold, device)
    if device.type == "cuda":
        from . import _build
        _build.launch_sweep(cfg, axis, src, dst, p, partials, scal, iscal,
                            factor, emit, ghosts, n_real or cfg.n_local,
                            finish, cond, fold)
        name = "x_sweep" if axis is Axis.X else "y_sweep"
        LAUNCHES[name + "_slab" if slab else name] += 1
        if finish is not None:
            TAILS["cfl_tail"] += 1
        return
    if int(iscal[IS_RUN]):
        T = np.dtype(cfg.dtype).type
        dt = scal[SC_DTUSE] * float(T(factor))
        out = sweep_plain(cfg, axis, *src, dt, ghosts, n_real, fold)
        for d, o in zip(dst, out[:4]):
            d.copy_(o)
        if emit:
            p.copy_(out[4])
            mx, my = cfl_partial_plain(cfg, out[1], out[2], out[5], n_real)
            partials[0, 0] = mx
            partials[1, 0] = my
    else:
        for s, d in zip(src, dst):
            d.copy_(s)
    finish_plain(cfg, finish, scal, iscal)
    cond_plain(cond)


def x_sweep(cfg, src, dst, p, partials, scal, iscal, factor, emit,
            ghosts=MIRRORED, n_real=None, finish=None, cond=None, fold=None):
    """K1: one X sweep of (rho, u, v, E) `src` into `dst` with dt =
    scal[dt_use] * factor, skipped (copied through) when iscal[run] is 0,
    ghost columns from `ghosts` (see module doc). With `emit` (the cycle's
    last sweep) it also writes the stale p and the CFL partial maxima of
    the `n_real` real cells into `partials`, a (2, n) tensor or a column
    slice of a wider one; with `finish` (a `Finish` whose columns hold
    `partials`) it then runs K3's fold and dt step in its tail, and with
    `cond` (a `Cond`: the last launch of a whole-run graph's body) sets
    that WHILE condition from the predicate the tail wrote. `fold` (a
    `Fold`): the launch's place in its cycle's cross-sweep EOS fold.
    Replaces `_x_sweep_kernel` (`sweep.py:978`, with `_dt_tile_min`
    :924), its X slab variant (`_bc_x_apply_slab` :849) included."""
    _sweep(cfg, Axis.X, src, dst, p, partials, scal, iscal, factor, emit,
           ghosts, n_real, finish, cond, fold)


def y_sweep(cfg, src, dst, p, partials, scal, iscal, factor, emit,
            ghosts=MIRRORED, n_real=None, finish=None, cond=None, fold=None):
    """K2: the same along Y. Replaces `_y_sweep_kernel` (`sweep.py:1092`),
    its Y slab variant (`_halo_cat_slab` :590) included."""
    _sweep(cfg, Axis.Y, src, dst, p, partials, scal, iscal, factor, emit,
           ghosts, n_real, finish, cond, fold)


def cfl_finish(cfg, partials, nblocks, scal, iscal, fold=True, step=True):
    """K3: fold the last sweep's `nblocks` CFL partials into lm (when the
    cycle that wrote them ran), then, with `step`, one dt-recurrence step
    (see module doc). Replaces `_dt_from_tiles` (`sweep.py:968`) and the
    in-kernel dt update of `_multicycle_kernel` (`sweep.py:1950-1967`).
    The loop runs it for a run's first step, and after each cycle of a
    mesh across cards; the cycle's last launch runs it in its tail
    otherwise (`Finish`)."""
    if scal.device.type == "cuda":
        from . import _build
        _build.launch_cfl_finish(cfg, partials, nblocks, scal, iscal, fold,
                                 step)
        LAUNCHES["cfl_finish"] += 1
        return
    cfl_finish_plain(cfg, partials, nblocks, scal, iscal, fold, step)


def fused_sweep(cfg, axis, rho, u, v, E, dt, fill=False):
    """One sweep out of place, the counterpart of `fused_sweep`
    (`sweep.py:1469`): the same kernels behind a second wrapper. Ghost bands
    along `axis` must be filled already unless `fill`. Returns
    (rho, u, v, E, p_stale, local_dt_min)."""
    device = rho.device
    shape = rho.shape
    tdt = torch_dtype(cfg.dtype)
    dst = tuple(torch.empty(shape, dtype=tdt, device=device) for _ in range(4))
    p = torch.empty(shape, dtype=tdt, device=device)
    nb = n_partials(axis, shape, device)
    partials = torch.empty((2, nb), dtype=tdt, device=device)
    scal, iscal = new_scalars(cfg.dtype, device)
    scal[SC_DTUSE] = dt
    iscal[IS_RUN] = 1
    src = tuple(a.contiguous() for a in (rho, u, v, E))
    (x_sweep if axis is Axis.X else y_sweep)(
        cfg, src, dst, p, partials, scal, iscal, 1.0, True,
        MIRRORED if fill else (None, None))
    cfl_finish(cfg, partials, nb, scal, iscal, fold=True, step=False)
    return dst + (p, scal[SC_LM])
