"""Equations of state (`armon_tpu/ops/eos.py`, `src/kernels.jl:4-55`).

Plain tensor code, used by the cycle-0 EOS of the initial state and by
every sweep of the op path (`update_eos`), with the cross-sweep fold of
a cycle's later sweeps (`folds`). Constants
are rounded to the working dtype T before any arithmetic, and every
operation runs in the order the JAX package writes it, so the two agree
bit for bit. Divisions by a constant go through a tensor of dtype T:
PyTorch turns `tensor / python_scalar` into a multiply by the reciprocal on
the card, and `python_scalar / tensor` into one everywhere.
"""

import numpy as np
import torch

from ..models.cases import Bizarrium
from .fma import fma


def ieee_sqrt(x):
    """Correctly rounded square root. PyTorch's vectorized CPU kernel is
    not (it differs from IEEE by an ulp on ~0.7% of inputs); numpy's is,
    as the card's `torch.sqrt` and the CUDA kernels' `sqrt` are."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def scalar_like(like, value):
    """`value` as a 0-dim tensor of `like`'s dtype and device. A fill,
    not a copy from the host: on the card a copy from pageable host
    memory would wait for the stream."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def perfect_gas_eos(gamma, rho, u, v, E, dtype, fold=None):
    """p = (gamma-1)*rho*e, c = sqrt(gamma*p/rho), g = (1+gamma)/2
    (`src/kernels.jl:4-13`). With `fold` (X, K), a later sweep of a cycle
    (`folds`): p = (X*K)*e, c from the scaled rho. Returns (p, c, g)."""
    T = np.dtype(dtype).type
    gm = T(gamma)
    e = fma(fma(u, u, v * v), -0.5, E)
    if fold is None:
        p = float(gm - T(1.0)) * rho * e
    else:
        X, K = fold
        p = (X * float(K)) * e
    c = ieee_sqrt(float(gm) * p / rho)
    g = torch.full_like(rho, float((T(1.0) + gm) / T(2.0)))
    return p, c, g


def bizarrium_eos(rho, u, v, E, dtype):
    """Stiffened non-convex EOS (`src/kernels.jl:16-55`). Returns (p, c, g)."""
    T = np.dtype(dtype).type
    rho0 = T(10000.0)
    K0 = T(1e11)
    Cv0 = T(1000.0)
    T0 = T(300.0)
    eps0 = T(0.0)
    G0 = T(1.5)
    s = T(1.5)
    # Ratios evaluated in Float64 then converted to T (`src/kernels.jl:33-34`).
    q = T(-42080895.0 / 14941154.0)
    r = T(727668333.0 / 149411540.0)
    f = float

    x = rho / scalar_like(rho, rho0) - 1
    G = f(G0) * (1 - scalar_like(rho, rho0) / rho)
    x2 = x * x
    x3 = x * x2
    xp1 = 1 + x
    den = 1 - f(s) * x

    f0 = (1 + f(s / 3 - 2) * x + f(q) * x2 + f(r) * x3) / den
    f1 = (f(s / 3 - 2) + f(2 * q) * x + f(3 * r) * x2 + f(s) * f0) / den
    f2 = (f(2 * q) + f(6 * r) * x + f(2 * s) * f1) / den
    f3 = (f(6 * r) + f(3 * s) * f2) / den

    epsk0 = f(eps0) - f(Cv0 * T0) * (1 + G) + f(0.5 * (K0 / rho0)) * x2 * f0
    pk0 = f(-Cv0 * T0 * G0 * rho0) + f(0.5 * K0) * x * (xp1 * xp1) * (2 * f0 + x * f1)
    pk0prime = f(-0.5 * K0) * (xp1 * (xp1 * xp1)) * f(rho0) * (
        2 * (1 + 3 * x) * f0 + 2 * x * (2 + 3 * x) * f1 + x2 * xp1 * f2)
    xp12 = xp1 * xp1
    pk0second = f(0.5 * K0) * (xp12 * xp12) * f(rho0 ** 2) * (
        12 * (1 + 2 * x) * f0 + 6 * (1 + 6 * x + 6 * x2) * f1
        + 6 * x * xp1 * (1 + 2 * x) * f2 + x2 * xp12 * f3)

    e = fma(fma(u, u, v * v), -0.5, E)
    p = fma(f(G0 * rho0), e - epsk0, pk0)
    c = ieee_sqrt(fma(f(G0 * rho0), p - pk0, -pk0prime)) / rho
    g = scalar_like(rho, 0.5) / (rho * (rho * rho) * (c * c)) * (
        pk0second + f((G0 * rho0) ** 2) * (p - pk0))
    return p, c, g


def eos(cfg, rho, u, v, E, fold=None):
    """Dispatch by test case (`src/kernels.jl:151-166`) over the whole
    padded array, with the perfect gas's `fold` (`perfect_gas_eos`).
    Returns (p, c, g)."""
    if isinstance(cfg.test, Bizarrium):
        return bizarrium_eos(rho, u, v, E, cfg.dtype)
    return perfect_gas_eos(cfg.gamma, rho, u, v, E, cfg.dtype, fold)


def folds(cfg) -> bool:
    """Whether a later sweep of a cycle takes the cross-sweep EOS fold.

    Across the sweeps of one cycle, XLA folds the previous sweep's
    (X * (1/d)) * (gamma-1), X the unscaled new density fma(dX, rho, -d)
    of the remap (`ops/projection.py`) and d the cell size along that
    sweep's axis, into X * K with one constant K = RN(RN(1/d) *
    RN(gamma-1)) (`fold_const`); the first sweep of a cycle, whose rho
    comes through the loop's carry, is not folded. The port copies it on
    every route: the perfect gas only (the Bizarrium EOS takes its
    scaled rho)."""
    return not isinstance(cfg.test, Bizarrium)


def fold_const(cfg, axis):
    """(RN(1/d), K = RN(RN(1/d) * RN(gamma-1))) in T for a previous sweep
    along `axis`, as numpy scalars of dtype T: the rebuilt density is X *
    RN(1/d), the folded pressure (X * K) * e."""
    T = np.dtype(cfg.dtype).type
    rdx = T(1.0) / T(cfg.cell_size(axis))
    return rdx, rdx * (T(cfg.gamma) - T(1.0))


def update_eos(cfg, state, fold=None):
    """The State with the p, c and g of its rho/u/v/E
    (`armon_tpu/ops/eos.py:70`), ghost cells included: the boundary
    exchange overwrites their values before any stencil reads them, so a
    ghost takes the p of the cell it mirrors. `fold`: (X, K) of the
    previous sweep of this cycle (`folds`), or None."""
    p, c, g = eos(cfg, state.rho, state.u, state.v, state.E, fold)
    return state._replace(p=p, c=c, g=g)
