"""Eulerian projection (remap) of the op path (`armon_tpu/ops/projection.py`,
`src/projection_schemes.jl`).

- conservative remap `euler_projection!`: `src/projection_schemes.jl:23-41`
- 1st-order upwind advection fluxes:      `src/projection_schemes.jl:62-78`
- 2nd-order slope-limited fluxes:         `src/projection_schemes.jl:92-124`
- minmod slope:                           `src/projection_schemes.jl:15-20`

The reference's data-dependent upwind shift (``if disp > 0: i -= s``) is a
`torch.where` between the unshifted and the left-shifted reads. Divisors
are 0-dim tensors of dtype T (`ops/riemann.py`).
"""

import numpy as np
import torch

from ..utils.enums import Axis
from .eos import scalar_like
from .fma import fma
from .limiters import maximum
from .shifts import sh


def sign(x):
    """`jnp.sign`: +-1, and x itself for +-0 and NaN (`torch.sign` maps
    -0 to +0)."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _slope_minmod(u_m, u_i, u_p, r_m, r_p):
    """`src/projection_schemes.jl:15-20`."""
    du_p = r_p * (u_p - u_i)
    du_m = r_m * (u_i - u_m)
    s = sign(du_p)
    return s * maximum(torch.zeros_like(s), torch.minimum(s * du_p, s * du_m))


def _dx(cfg, like, axis):
    return scalar_like(like, np.dtype(cfg.dtype).type(cfg.cell_size(axis)))


def inv_dx(cfg, like, axis):
    """1/dx rounded to T: XLA turns the division by the constant dx into a
    multiply by its reciprocal."""
    T = np.dtype(cfg.dtype).type
    return scalar_like(like, T(1.0) / T(cfg.cell_size(axis)))


def advection_first_order(cfg, state, axis: Axis, dt):
    """Upwind advection fluxes (`src/projection_schemes.jl:62-78`), each
    as its factors (disp, upwind value), whose product is the JAX
    package's flux: `euler_projection` contracts it as XLA's fused remap
    does. Returns the pairs of (rho, urho, vrho, Erho)."""
    disp = dt * state.ustar
    up = disp > 0  # upwind: read the left cell

    def pick(a):
        return torch.where(up, sh(a, -1, axis), a)

    rho = pick(state.rho)
    ru = pick(state.rho * state.u)
    rv = pick(state.rho * state.v)
    rE = pick(state.rho * state.E)
    return tuple((disp, q) for q in (rho, ru, rv, rE))


def advection_second_order(cfg, state, axis: Axis, dt):
    """Slope-limited advection fluxes over the ustar-deformed cells
    (`src/projection_schemes.jl:92-124`), as factor pairs
    (`advection_first_order`)."""
    dx = _dx(cfg, state.rho, axis)
    us = state.ustar
    disp = dt * us
    up = disp > 0

    # Reads at offset `o` from the (possibly shifted) upwind index i'.
    def rd(a, o):
        return torch.where(up, sh(a, o - 1, axis), sh(a, o, axis))

    # src/projection_schemes.jl:100-105
    dxe = torch.where(up, -fma(-dt, sh(us, -1, axis), dx),
                      fma(dt, sh(us, 1, axis), dx))

    dxl_m = fma(dt, rd(us, 0) - rd(us, -1), dx)
    dxl = fma(dt, rd(us, 1) - rd(us, 0), dx)
    dxl_p = fma(dt, rd(us, 2) - rd(us, 1), dx)

    r_m = (2 * dxl) / (dxl + dxl_m)
    r_p = (2 * dxl) / (dxl + dxl_p)

    # The conserved products are formed once and shifted: the upwind
    # select picks the same branch for both factors and a roll is a
    # permutation, so this equals forming them per offset, bit for bit
    # (`projection.py:65-72`).
    ru, rv, rE = state.rho * state.u, state.rho * state.v, state.rho * state.E
    rho_m, rho_i, rho_p = rd(state.rho, -1), rd(state.rho, 0), rd(state.rho, 1)
    ru_m, ru_i, ru_p = rd(ru, -1), rd(ru, 0), rd(ru, 1)
    rv_m, rv_i, rv_p = rd(rv, -1), rd(rv, 0), rd(rv, 1)
    rE_m, rE_i, rE_p = rd(rE, -1), rd(rE, 0), rd(rE, 1)

    sl_rho = _slope_minmod(rho_m, rho_i, rho_p, r_m, r_p)
    sl_ur = _slope_minmod(ru_m, ru_i, ru_p, r_m, r_p)
    sl_vr = _slope_minmod(rv_m, rv_i, rv_p, r_m, r_p)
    sl_Er = _slope_minmod(rE_m, rE_i, rE_p, r_m, r_p)

    length_factor = dxe / (2 * dxl)
    return tuple((disp, fma(-sl, length_factor, q_i)) for sl, q_i in
                 ((sl_rho, rho_i), (sl_ur, ru_i), (sl_vr, rv_i), (sl_Er, rE_i)))


def euler_projection(cfg, state, axis: Axis, dt, fluxes):
    """Conservative remap (`src/projection_schemes.jl:23-41`) from the
    fluxes' (disp, value) factors, each flux contracted into the
    difference of the fluxes as in XLA's fused remap. `/ dx` is a
    multiply by `inv_dx`, and the new rho is contracted where it is a
    result and not where it divides the conserved sums (there dX * rho
    has other uses in XLA's program). Returns (State, X): X = fma(dX, rho, -d_rho) is the new density before
    its scaling, rho = X * inv_dx, which the next sweep of the cycle folds
    into its EOS (`ops/eos.folds`)."""
    dx = _dx(cfg, state.rho, axis)
    rdx = inv_dx(cfg, state.rho, axis)
    us = state.ustar

    def diff(f, shifted_first):
        disp, q = f
        if shifted_first:
            return fma(sh(disp, 1, axis), sh(q, 1, axis), -(disp * q))
        return fma(-disp, q, sh(disp * q, 1, axis))

    # XLA's program stores the rho fluxes and reads them back shifted, so
    # only the flux of the cell is contracted; the other three are formed
    # in place, and the shifted product, the first operand, is contracted.
    d_rho = diff(fluxes[0], False)
    d_ur, d_vr, d_Er = (diff(f, True) for f in fluxes[1:])
    dX = fma(dt, sh(us, 1, axis) - us, dx)
    dX_rho = dX * state.rho

    X = fma(dX, state.rho, -d_rho)
    den = (dX_rho - d_rho) * rdx
    tmp_ur = fma(dX_rho, state.u, -d_ur) * rdx
    tmp_vr = fma(dX_rho, state.v, -d_vr) * rdx
    tmp_Er = fma(dX_rho, state.E, -d_Er) * rdx

    return state._replace(
        rho=X * rdx,
        u=tmp_ur / den,
        v=tmp_vr / den,
        E=tmp_Er / den,
    ), X


def projection_remap(cfg, state, axis: Axis, dt):
    """Advection fluxes, then the conservative remap
    (`src/projection_schemes.jl:148-157`). Returns (State, X) as
    `euler_projection`."""
    if cfg.projection == "euler":
        fluxes = advection_first_order(cfg, state, axis, dt)
    elif cfg.projection == "euler_2nd":
        fluxes = advection_second_order(cfg, state, axis, dt)
    else:
        raise ValueError(f"Unknown projection scheme: {cfg.projection}")
    return euler_projection(cfg, state, axis, dt, fluxes)
