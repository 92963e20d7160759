"""Lagrangian cell update of the op path (`armon_tpu/ops/update.py`,
`src/kernels.jl:58-68,217-230`)."""

import numpy as np

from ..utils.enums import Axis
from .eos import scalar_like
from .fma import fma
from .shifts import sh


def cell_update(cfg, state, axis: Axis, dt):
    """rho, u_axis, E updated from the (ustar, pstar) fluxes. `dt` is a
    0-dim tensor of dtype T, `dx` the cell size along the sweep axis as
    one; the mass `dm` uses the pre-update density (`src/kernels.jl:64-67`)."""
    dx = scalar_like(state.rho, np.dtype(cfg.dtype).type(cfg.cell_size(axis)))

    uax = state.u if axis is Axis.X else state.v
    us, ps = state.ustar, state.pstar
    us_p = sh(us, 1, axis)
    ps_p = sh(ps, 1, axis)

    dm = state.rho * dx
    rho_new = dm / fma(dt, us_p - us, dx)
    dt_dm = dt / dm
    uax_new = fma(dt_dm, ps - ps_p, uax)
    E_new = fma(dt_dm, fma(ps, us, -(ps_p * us_p)), state.E)

    if axis is Axis.X:
        return state._replace(rho=rho_new, u=uax_new, E=E_new)
    return state._replace(rho=rho_new, v=uax_new, E=E_new)
