"""The port's whole per-sweep path (`armon_torch.armon`, CPU) against the
Julia goldens and against the JAX package's `armon()` on its per-sweep
Pallas route (interpret mode), plus the device-side stop check."""

import numpy as np
import pytest
import torch

from conftest import reference_params, ref_file, abs_tol, rel_tol

import armon_tpu
from armon_tpu.io.output import read_reference_csv, compare_states
import armon_torch
from armon_torch.interop import to_numpy
from armon_torch.core.solver import make_init_fused
from armon_torch.core.step import make_time_loop_lean


# Pins the port to its per-sweep kernels (K1/K2 + K3) at any grid size.
PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)


def _torch_reference_params(test, dtype, **overrides):
    """The golden-run configuration of `conftest.reference_params`, for the
    port (which runs silent levels >= 2 only), on the per-sweep route."""
    options = dict(data_type=dtype, test=test, scheme="GAD",
                   projection="euler_2nd", riemann_limiter="minmod",
                   nghost=4, N=(100, 100), maxcycle=1000, silent=5,
                   measure_time=False, device="cpu", **PER_SWEEP)
    options.update(overrides)
    return armon_torch.ArmonParameters(**options)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("test", ["Sod", "Sod_y", "Sod_circ"])
def test_golden_zero_diff(test, dtype):
    """Zero differences at the ladder of `tests/test_convergence.py:35-49`."""
    params = _torch_reference_params(test, dtype, return_data=True)
    stats = armon_torch.armon(params)
    jcfg = reference_params(test, dtype).config
    ref_dt, ref_cycles, ref = read_reference_csv(jcfg, ref_file(test, dtype))
    atol, rtol = abs_tol(dtype), rel_tol(dtype)
    assert stats.cycles == ref_cycles
    assert abs(float(ref_dt) - stats.last_dt) <= max(atol, rtol * abs(float(ref_dt)))
    cnt, max_diff, details = compare_states(jcfg, to_numpy(stats.data), ref,
                                            atol=atol, rtol=rtol)
    assert cnt == 0 and max_diff == 0, details



@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_golden_sedov(dtype):
    """Sedov at the golden ladder through the per-sweep route, at the JAX
    package's gates (`tests/test_convergence.py:50-75`): zero differences
    in f64, which the cross-sweep EOS fold gives (`ops/eos.folds`, ROADMAP
    C2); in f32 at most 1500, each under 1e-4."""
    stats = armon_torch.armon(_torch_reference_params("Sedov", dtype,
                                                      return_data=True))
    jcfg = reference_params("Sedov", dtype).config
    ref_dt, ref_cycles, ref = read_reference_csv(jcfg, ref_file("Sedov", dtype))
    atol, rtol = abs_tol(dtype), rel_tol(dtype)
    assert stats.cycles == ref_cycles
    assert abs(float(ref_dt) - stats.last_dt) <= max(atol, rtol * abs(float(ref_dt)))
    cnt, max_diff, details = compare_states(jcfg, to_numpy(stats.data), ref,
                                            atol=atol, rtol=rtol)
    if np.dtype(dtype).itemsize == 8:
        assert cnt == 0 and max_diff == 0, details
    else:
        assert cnt <= 1500 and max_diff < 1e-4, details


RUNS = [
    ("Sod_circ", dict(axis_splitting="Sequential")),
    ("Sod_circ", dict(axis_splitting="Godunov")),
    ("Sod_circ", dict(axis_splitting="Strang")),
    ("Bizarrium", dict()),
    ("Sod", dict(dt_on_even_cycles=True, axis_splitting="Y_only")),
    ("Sod_y", dict(cst_dt=True, Dt=2e-3, axis_splitting="X_only",
                   riemann_limiter="superbee")),
]


@pytest.mark.parametrize("test,extra", RUNS,
                         ids=[f"{t}-{'-'.join(f'{k}={v}' for k, v in e.items())}"
                              for t, e in RUNS])
def test_run_matches_jax_per_sweep(test, extra):
    """10 cycles at 64^2 f64: same cycle count, t and last dt within 4 eps,
    fields within 1e-13 of their scale on real cells (absolute for the O(1)
    Sod fields); XLA's multiply-add contraction is the only difference."""
    opts = dict(test=test, N=(64, 64), data_type=np.float64, maxcycle=10,
                silent=5, measure_time=False, return_data=True, **extra)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(
        kernel_tier="pallas", pair_threshold=0, temporal_blocking=1, **opts))
    ts = armon_torch.armon(armon_torch.ArmonParameters(device="cpu",
                                                       **PER_SWEEP, **opts))
    eps = np.finfo(np.float64).eps
    assert ts.cycles == js.cycles
    assert abs(ts.final_time - js.final_time) <= 4 * eps * abs(js.final_time)
    assert abs(ts.last_dt - js.last_dt) <= 4 * eps * abs(js.last_dt)
    g = 4
    data = to_numpy(ts.data)
    for name in ("rho", "u", "v", "E", "p"):
        a = np.asarray(getattr(js.data, name))[g:-g, g:-g]
        b = getattr(data, name)[g:-g, g:-g]
        scale = max(1.0, float(np.max(np.abs(a))))
        assert np.max(np.abs(a - b)) <= 1e-13 * scale, name


@pytest.mark.parametrize("splitting", ["Sequential", "Strang"])
def test_stop_check_interval_is_bitwise_neutral(splitting):
    """Reading the stop predicate every cycle or every 8 cycles gives the
    same bits: cycles launched past the end pass everything through."""
    params = armon_torch.ArmonParameters(device="cpu", test="Sod_circ",
                                         N=(32, 32),
                                         axis_splitting=splitting, silent=5,
                                         **PER_SWEEP)
    cfg = params.config
    results = []
    for every in (1, 8):
        [fs], seed = make_init_fused(params)()
        results.append(make_time_loop_lean(cfg)(fs, 0.0, 0, 0.0, float(seed),
                                                check_every=every))
    r1, r8 = results
    assert r1.cycles % 8 != 0, "maxtime must end the run mid-batch"
    assert r8.host_reads < r1.host_reads
    assert (r1.t, r1.cycles, r1.dt_last, r1.lm, r1.ok) == \
        (r8.t, r8.cycles, r8.dt_last, r8.lm, r8.ok)
    for a, b in zip(r1.carry, r8.carry):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [(40, 2), (2, 40), (3, 5)],
                         ids=lambda n: f"{n[0]}x{n[1]}")
def test_degenerate_grid_matches_jax_jnp_tier(N):
    """Grids thinner than the ghost band (the high-side mirror then reads
    cells the low-side mirror just filled) against the JAX package's jnp
    tier; its per-sweep Pallas route diverges on the first two (ROADMAP
    queue C)."""
    opts = dict(test="Sod_circ", N=N, data_type=np.float64, maxcycle=10,
                silent=5, measure_time=False, return_data=True)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(kernel_tier="jnp", **opts))
    ts = armon_torch.armon(armon_torch.ArmonParameters(device="cpu", **opts))
    eps = np.finfo(np.float64).eps
    assert ts.cycles == js.cycles
    assert abs(ts.final_time - js.final_time) <= 4 * eps * abs(js.final_time)
    g = 4
    data = to_numpy(ts.data)
    for name in ("rho", "u", "v", "E", "p"):
        a = np.asarray(getattr(js.data, name))[g:-g, g:-g]
        b = getattr(data, name)[g:-g, g:-g]
        assert np.max(np.abs(a - b)) <= 1e-13 * max(1.0, float(np.max(np.abs(a)))), name
