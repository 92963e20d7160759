"""Global reductions: CFL time step and conservation variables
(`armon_tpu/ops/reductions.py`, `src/reductions.jl`).

The real domain of a shard is the slice ``[g:g+ny, g:g+nx]`` of its padded
block, (nx, ny) its real extent: `cfg.n_local`, or less on the hi-edge
shard of an uneven split, whose dead slack is left out. Max and min are
exact, so the CFL minimum is the same in any reduction order and over any
split; the conservation sums feed tolerance checks only, and a mesh adds
its shards' sums in f64 on the host (`core/solver.make_conservation`).
"""

import numpy as np
import torch

from .eos import scalar_like


def real_slice(cfg, n_real=None):
    g = cfg.nghost
    nx, ny = n_real or cfg.n_local
    return (slice(g, g + ny), slice(g, g + nx))


def cfl_limit(cfg, mx, my):
    """min(dx/mx, dy/my) with dx, dy rounded to T: the second half of the
    restructured CFL reduction (`ops/pallas/sweep.py:968-975`). NaN in
    either maximum propagates to the result."""
    T = np.dtype(cfg.dtype).type
    return torch.minimum(scalar_like(mx, T(cfg.dx)) / mx,
                         scalar_like(my, T(cfg.dy)) / my)


def cfl_maxima(cfg, u, v, c, n_real=None):
    """(max(|u|+c), max(|v|+c)) over the real cells, NaN propagating."""
    r = real_slice(cfg, n_real)
    c = c[r]
    return torch.amax(torch.abs(u[r]) + c), torch.amax(torch.abs(v[r]) + c)


def dt_cfl_min(cfg, state, n_real=None):
    """Minimum CFL-stable dt over the real cells of a State
    (`src/reductions.jl:14-20`, `armon_tpu/ops/reductions.py:60`) as
    min(dx/max(|u|+c), dy/max(|v|+c)): bitwise the per-cell form, since
    IEEE division is monotone in the denominator. The real cells are a
    slice: on the hi-edge shard of an uneven split, `n_real` leaves its
    dead slack out, bit for bit the JAX package's masked maximum (every
    real |u|+c is >= +0 or NaN, so the mask's zeros never win). Returns a
    0-dim tensor."""
    return cfl_limit(cfg, *cfl_maxima(cfg, state.u, state.v, state.c, n_real))


def pmin_dt(dts, device):
    """The minimum of the shards' CFL dt on `device` (`pmin_dt`,
    `armon_tpu/ops/reductions.py:91`): a NaN is mapped to 0 first, so
    that a diverged shard fails the dt gate instead of losing the
    minimum to the others."""
    d = torch.stack([x.to(device) for x in dts])
    return torch.where(torch.isnan(d), torch.zeros_like(d), d).amin()


def _ff_sum(x):
    """Compensated (Knuth 2Sum) sum of a 2D tensor: a vector 2Sum scan over
    the columns keeps one (hi, lo) pair per row, then a scalar 2Sum scan
    combines the row sums. f64-grade accuracy in pure f32; the (hi, lo)
    pair is combined on the host in f64 (`conservation_scalar`)."""
    def two_sum(hi, lo, b):
        t = hi + b
        bp = t - hi
        err = (hi - (t - bp)) + (b - bp)
        return t, lo + err

    hi = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    lo = torch.zeros_like(hi)
    for i in range(x.shape[1]):
        hi, lo = two_sum(hi, lo, x[:, i])
    # The scalar scan in the same dtype on the host: numpy scalars round
    # every operation to T exactly as the device would.
    T = np.float64 if x.dtype == torch.float64 else np.float32
    h = l = T(0.0)
    for b in hi.cpu().numpy():
        t = h + b
        bp = t - h
        err = (h - (t - bp)) + (b - bp)
        h, l = t, l + err
    return np.array([h, l + T(lo.sum().item())], dtype=T)


def conservation_vars(cfg, rho, E, n_real=None):
    """(total mass, total energy) over real cells
    (`src/reductions.jl:202-216,254-258`). f64: ds-scaled scalars. f32:
    unscaled compensated (hi, lo) pairs; combine with
    `conservation_scalar`."""
    T = np.dtype(cfg.dtype).type
    r = real_slice(cfg, n_real)
    rho = rho[r]
    rhoE = rho * E[r]
    if np.dtype(cfg.dtype).itemsize == 4:
        return _ff_sum(rho), _ff_sum(rhoE)
    ds = float(T(cfg.dx) * T(cfg.dy))
    return torch.sum(rho) * ds, torch.sum(rhoE) * ds


def conservation_scalar(cfg, v) -> float:
    """Host f64 value of a `conservation_vars` output: a compensated
    (hi, lo) pair is combined and scaled by the cell area in f64."""
    a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float64)
    if a.ndim >= 1 and a.shape[-1] == 2:
        return float((a[..., 0] + a[..., 1]).sum() * (cfg.dx * cfg.dy))
    return float(a)
