"""One sweep of the port (the kernels' plain versions, CPU) against the JAX
package's Pallas sweep kernel in interpret mode, on the same state (the
counterpart of `tests/test_pallas.py:48-93`).

Tolerances: the JAX side runs under XLA, which contracts multiply-adds
differently for the two graph shapes, so the fields agree to an ulp or a
few: f64 within 1e-14 of the field's scale on real cells (absolute for
the O(1) Sod fields; Bizarrium's rho ~1e4 and p ~1e10 scale it), f32
within 4 ulp of the field's scale, and the CFL minimum within 8 eps
relative.
"""

import numpy as np
import pytest

import armon_tpu
from armon_tpu.core.solver import make_init, make_cycle
from armon_tpu.ops.eos import update_eos
from armon_tpu.ops.boundary import boundary_conditions
from armon_tpu.ops.pallas.sweep import fused_sweep as jax_fused_sweep
import armon_torch
from armon_torch.interop import to_numpy
from armon_torch.ops import sweep as K

import torch


def _state_after_cycles(opts, cycles=3):
    """The JAX jnp-tier state after `cycles` cycles and the dt of the next."""
    params = armon_tpu.ArmonParameters(**opts)
    cfg = params.config
    state = update_eos(cfg, make_init(params)())
    cyc = make_cycle(params)
    dtp = np.asarray(0.0, cfg.dtype)
    for i in range(cycles):
        state, _, dtp, _ = cyc(state, dtp, np.int32(i))
    return params, state, np.asarray(dtp, cfg.dtype)


def _tensors(a, dtype):
    return torch.from_numpy(np.array(a, dtype, order="C", copy=True))


CASES = [
    ("Sod_circ", "GAD", "minmod", "euler_2nd", np.float64),
    ("Bizarrium", "GAD", "minmod", "euler_2nd", np.float64),
    ("Sod_circ", "GAD", "superbee", "euler_2nd", np.float64),
    ("Sod_circ", "Godunov", "minmod", "euler", np.float64),
    ("Bizarrium", "GAD", "no_limiter", "euler", np.float64),
    ("Sod_circ", "GAD", "minmod", "euler_2nd", np.float32),
    ("Bizarrium", "GAD", "minmod", "euler_2nd", np.float32),
]


@pytest.mark.parametrize(
    "test,scheme,limiter,projection,dtype", CASES,
    ids=["-".join([c[0], c[1], c[2], c[3], np.dtype(c[4]).name]) for c in CASES])
def test_sweep_matches_jax_pallas(test, scheme, limiter, projection, dtype):
    opts = dict(test=test, N=(64, 64), data_type=dtype, scheme=scheme,
                riemann_limiter=limiter, projection=projection)
    jp, state, dt = _state_after_cycles(opts)
    jcfg = jp.config
    tcfg = armon_torch.ArmonParameters(device="cpu", **opts).config
    g = jcfg.nghost
    rs = (slice(g, -g), slice(g, -g))
    f32 = np.dtype(dtype).itemsize == 4
    for axis in (armon_tpu.Axis.X, armon_tpu.Axis.Y):
        filled = boundary_conditions(jcfg, state, axis, ("rho", "u", "v", "E"))
        jout = jax_fused_sweep(jcfg, axis, filled.rho, filled.u, filled.v,
                               filled.E, dt, interpret=True)
        taxis = armon_torch.Axis(int(axis))
        raw = [_tensors(getattr(state, n), dtype) for n in ("rho", "u", "v", "E")]
        pre = [_tensors(getattr(filled, n), dtype) for n in ("rho", "u", "v", "E")]
        # Ghosts filled beforehand (as `fused_sweep` takes them), and the
        # in-kernel fill of the raw state (as the time loop runs it).
        outs = [K.fused_sweep(tcfg, taxis, *pre, float(dt), fill=False),
                K.fused_sweep(tcfg, taxis, *raw, float(dt), fill=True)]
        for tout in outs:
            for k, name in enumerate(("rho", "u", "v", "E", "p")):
                a = np.asarray(jout[k])[rs]
                b = to_numpy(tout[k])[rs]
                scale = max(1.0, float(np.max(np.abs(a))))
                tol = (4 * np.finfo(np.float32).eps if f32 else 1e-14) * scale
                d = float(np.max(np.abs(a - b)))
                assert d <= tol, f"{axis} {name}: {d} > {tol}"
            jmin, tmin = float(jout[5]), float(tout[5])
            eps = np.finfo(dtype).eps
            assert abs(jmin - tmin) <= 8 * eps * abs(jmin), (axis, jmin, tmin)
        # Both fill routes agree exactly on real cells.
        for k in range(5):
            assert torch.equal(outs[0][k][rs], outs[1][k][rs])


def test_sweep_pass_through_when_not_running():
    """A sweep of a cycle past the run's end copies its input unchanged."""
    p = armon_torch.ArmonParameters(device="cpu", test="Sod_circ", N=(16, 16))
    cfg = p.config
    from armon_torch.core.solver import make_init_fused
    [fs], _ = make_init_fused(p)()
    src = (fs.rho, fs.u, fs.v, fs.E)
    dst = tuple(torch.full_like(a, float("nan")) for a in src)
    pp = fs.p.clone()
    partials = torch.zeros((2, 1), dtype=fs.rho.dtype)
    scal, iscal = K.new_scalars(cfg.dtype, "cpu")
    scal[K.SC_DTUSE] = 1e-3
    iscal[K.IS_RUN] = 0
    K.y_sweep(cfg, src, dst, pp, partials, scal, iscal, 1.0, True)
    for a, b in zip(src, dst):
        assert torch.equal(a, b)
    assert torch.equal(pp, fs.p) and torch.equal(partials, torch.zeros_like(partials))


def test_cfl_finish_plain_recurrence():
    """K3's plain version: fold, +5% cap in T, first-cycle seed, stop."""
    p = armon_torch.ArmonParameters(device="cpu", N=(8, 8), cfl=0.5,
                                    maxtime=1.0, data_type="float32")
    cfg = p.config
    T = np.float32
    scal, iscal = K.new_scalars(cfg.dtype, "cpu", lm=0.1)
    partials = torch.tensor([[2.0, 4.0], [8.0, 1.0]], dtype=torch.float32)
    K.cfl_finish(cfg, partials, 2, scal, iscal)       # first cycle: seed lm
    assert scal[K.SC_DTUSE].item() == T(0.5) * T(0.1)
    assert iscal.tolist() == [1, 1, 1, 1]
    K.cfl_finish(cfg, partials, 2, scal, iscal)       # folds, cap binds
    lm = min(T(cfg.dx) / T(4.0), T(cfg.dy) / T(8.0))
    assert scal[K.SC_LM].item() == lm
    assert scal[K.SC_DTUSE].item() == T(0.5) * T(0.1)
    assert scal[K.SC_DTPREV].item() == min(T(0.5) * lm, T(1.05) * (T(0.5) * T(0.1)))
    partials[0, 0] = float("nan")                     # a diverged cell
    K.cfl_finish(cfg, partials, 2, scal, iscal)
    assert np.isnan(scal[K.SC_LM].item()) and iscal[K.IS_OK].item() == 0
    assert iscal[K.IS_NEXT].item() == 0
    before = scal.clone()
    K.cfl_finish(cfg, partials, 2, scal, iscal)       # stopped: no change
    assert torch.allclose(scal[:3], before[:3], rtol=0, atol=0, equal_nan=True)
    assert iscal[K.IS_RUN].item() == 0
