"""Acoustic Riemann solvers of the op path (`armon_tpu/ops/riemann.py`,
`src/riemann_schemes.jl`).

- two-point acoustic solver `acoustic_Godunov`: `src/riemann_schemes.jl:21-30`
- 1st-order fluxes `acoustic!`:                 `src/riemann_schemes.jl:33-43`
- 2nd-order GAD fluxes `acoustic_GAD!`:         `src/riemann_schemes.jl:55-104`

Every operation runs in the order the JAX package writes it. `dt` and
`dx` are 0-dim tensors of dtype T on the fields' device, and so is every
divisor: PyTorch turns a division by a Python scalar into a multiply by
its reciprocal on the card (`ops/eos.py`).
"""

import numpy as np

from ..utils.enums import Axis
from .eos import scalar_like
from .fma import fma
from .shifts import sh
from .limiters import limiter_from_name


def acoustic_godunov(rho_i, rho_im, c_i, c_im, u_i, u_im, p_i, p_im):
    """Two-point acoustic solver (`src/riemann_schemes.jl:21-30`).
    Returns (ustar, pstar) at the i-1/2 interface."""
    rc_l = rho_im * c_im
    rc_r = rho_i * c_i
    rc_sum = rc_l + rc_r
    ustar = (fma(rc_l, u_im, rc_r * u_i) + (p_im - p_i)) / rc_sum
    pstar = fma(rc_l * rc_r, u_im - u_i, fma(rc_r, p_im, rc_l * p_i)) / rc_sum
    return ustar, pstar


def acoustic(axis: Axis, rho, uax, p, c):
    """1st-order fluxes (`src/riemann_schemes.jl:33-43`)."""
    return acoustic_godunov(
        rho, sh(rho, -1, axis), c, sh(c, -1, axis),
        uax, sh(uax, -1, axis), p, sh(p, -1, axis),
    )


def acoustic_gad(axis: Axis, dt, dx, rho, uax, p, c, limiter_name, dtype):
    """2nd-order GAD fluxes with the limiter's theta-blend
    (`src/riemann_schemes.jl:55-104`)."""
    T = np.dtype(dtype).type
    lim = limiter_from_name(limiter_name)

    rho_m = sh(rho, -1, axis)
    c_m = sh(c, -1, axis)
    u_m = sh(uax, -1, axis)
    p_m = sh(p, -1, axis)

    # The left and right interface solves are the same elementwise map on
    # shifted inputs, and a roll is a permutation, so they are the
    # current interface's solve shifted, bit for bit (`riemann.py:48-55`).
    us_i, ps_i = acoustic_godunov(rho, rho_m, c, c_m, uax, u_m, p, p_m)
    us_im, ps_im = sh(us_i, -1, axis), sh(ps_i, -1, axis)
    us_ip, ps_ip = sh(us_i, 1, axis), sh(ps_i, 1, axis)

    # Slope ratios (src/riemann_schemes.jl:84-87); the +1e-6 guard is part
    # of the reference scheme.
    eps = float(T(1e-6))
    r_um = lim((us_ip - uax) / (us_i - u_m + eps))
    r_pm = lim((ps_ip - p) / (ps_i - p_m + eps))
    r_up = lim((u_m - us_im) / (uax - us_i + eps))
    r_pp = lim((p_m - ps_im) / (p - ps_i + eps))

    # Here XLA's program contracts both products of each sum: rc_l and
    # dm_l have no other use in it (the Godunov solve's rc_l + rc_r above
    # is a separate sum, whose products have).
    two = scalar_like(rho, 2.0)
    Dm = fma(rho_m, dx, rho * dx) / two
    half_rc = fma(rho_m, c_m, rho * c) / two
    theta = float(T(0.5)) * fma(-half_rc, dt / Dm, 1.0)

    ustar = fma(theta, fma(r_up, uax - us_i, -(r_um * (us_i - u_m))), us_i)
    pstar = fma(theta, fma(r_pp, p - ps_i, -(r_pm * (ps_i - p_m))), ps_i)
    return ustar, pstar


def numerical_fluxes(cfg, state, axis: Axis, dt):
    """Scheme dispatch (`src/riemann_schemes.jl:46-52,107-117`). Returns the
    state with new (ustar, pstar)."""
    uax = state.u if axis is Axis.X else state.v
    if cfg.riemann == "Godunov":
        ustar, pstar = acoustic(axis, state.rho, uax, state.p, state.c)
    elif cfg.riemann == "GAD":
        dx = scalar_like(state.rho, np.dtype(cfg.dtype).type(cfg.cell_size(axis)))
        ustar, pstar = acoustic_gad(axis, dt, dx, state.rho, uax, state.p,
                                    state.c, cfg.limiter, cfg.dtype)
    else:
        raise ValueError(f"Unknown Riemann scheme: {cfg.riemann}")
    return state._replace(ustar=ustar, pstar=pstar)
