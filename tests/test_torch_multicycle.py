"""The port's multicycle route (K5 `multicycle`, plain version on the CPU)
against the JAX package's temporal blocking (`temporal_blocking=8`,
interpret-mode Pallas `fused_multicycle`), against the port's other routes
bit for bit, on the goldens, and for its stop checks.

Tolerances against the JAX package: those of `tests/test_pallas.py:329-369`
for the fields (1e-12 relative, 1e-13 absolute) and dt (1e-12 relative),
the same cycle count, and t within 4 eps: the JAX side runs under XLA,
which contracts multiply-adds (`test_torch_slice.py`). Within the port,
bit for bit.
"""

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
from armon_torch.ops import routing

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)
G = 4
FIELDS = ("rho", "u", "v", "E", "p")

# The four cases of `tests/test_pallas.py:358-361`.
CASES = [(20, {}),                           # guarded tail (20 % 8)
         (9, dict(dt_on_even_cycles=True)),
         (7, dict(cst_dt=True, Dt=1e-4)),
         (1000, dict(maxtime=0.05))]         # mid-launch maxtime stop


def _opts(maxcycle, **kw):
    opts = dict(test="Sod", N=(64, 64), data_type=np.float64, scheme="GAD",
                projection="euler_2nd", riemann_limiter="minmod", nghost=4,
                maxcycle=maxcycle, silent=5, measure_time=False,
                return_data=True)
    opts.update(kw)
    return opts


@pytest.mark.parametrize("maxcycle,extra", CASES,
                         ids=["tail", "even-dt", "cst-dt", "maxtime"])
def test_multicycle_matches_jax(maxcycle, extra):
    opts = _opts(maxcycle, **extra)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(
        kernel_tier="pallas", temporal_blocking=8, **opts))
    params = armon_torch.ArmonParameters(device="cpu", **opts)
    assert routing.route(params.config) == "multicycle"
    ts = armon_torch.armon(params)
    eps = np.finfo(np.float64).eps
    assert ts.cycles == js.cycles
    assert abs(ts.final_time - js.final_time) <= 4 * eps * abs(js.final_time)
    assert np.isclose(ts.last_dt, js.last_dt, rtol=1e-12, atol=0)
    data = to_numpy(ts.data)
    for name in FIELDS:
        a = np.asarray(getattr(js.data, name))[G:-G, G:-G]
        b = getattr(data, name)[G:-G, G:-G]
        assert np.allclose(b, a, rtol=1e-12, atol=1e-13), name


def _loop(check_every=8, **kw):
    params = armon_torch.ArmonParameters(device="cpu", silent=5, **kw)
    [fs], seed = make_init_fused(params)()
    return routing.route(params.config), make_time_loop_lean(params.config)(
        fs, 0.0, 0, 0.0, float(seed), check_every=check_every)


def _assert_same(a, b):
    assert (a.t, a.cycles, a.dt_last, a.lm, a.ok) == \
        (b.t, b.cycles, b.dt_last, b.lm, b.ok)
    for x, y in zip(a.carry, b.carry):
        assert torch.equal(x[G:-G, G:-G], y[G:-G, G:-G])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("splitting,tb,extra", [
    ("Sequential", 8, {}), ("Godunov", 8, {}), ("Sequential", 3, {}),
    ("Godunov", 3, {}), ("Sequential", 8, dict(maxcycle=13)),
    ("Sequential", 8, dict(dt_on_even_cycles=True)),
    ("Godunov", 8, dict(cst_dt=True, Dt=1e-3))],
    ids=["seq", "godunov", "seq-K3", "godunov-K3", "maxcycle",
         "even-dt", "cst-dt"])
def test_routes_agree_bitwise(splitting, tb, extra, dtype):
    """Per-sweep, pair and multicycle: the same bits on real cells and the
    same t, cycles, dt, lm and ok (odd K leaves the carry in the second
    buffer set; Godunov's K=3 runs as K=2)."""
    kw = dict(test="Sod_circ", N=(40, 36), data_type=dtype,
              axis_splitting=splitting, **{"maxcycle": 21, **extra})
    r0, base = _loop(**kw, **PER_SWEEP)
    r1, pair = _loop(**kw, **PAIR)
    r2, multi = _loop(**kw, temporal_blocking=tb)
    assert (r0, r1, r2) == ("per_sweep", "pair", "multicycle")
    _assert_same(pair, base)
    _assert_same(multi, base)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("test", ["Sod", "Sod_y", "Sod_circ"])
def test_multicycle_route_goldens(test, dtype):
    """Zero differences at the golden ladder through the multicycle route
    (the default route at 100^2)."""
    params = armon_torch.ArmonParameters(
        data_type=dtype, test=test, scheme="GAD", projection="euler_2nd",
        riemann_limiter="minmod", nghost=4, N=(100, 100), maxcycle=1000,
        silent=5, measure_time=False, device="cpu", return_data=True)
    assert routing.route(params.config) == "multicycle"
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
def test_multicycle_route_golden_sedov(dtype):
    """Sedov at the golden ladder through the multicycle route, at the JAX
    package's gates (`tests/test_convergence.py:50-75`): zero differences
    in f64, which the cross-sweep EOS fold gives (`ops/eos.folds`, ROADMAP
    C2); in f32 at most 1500, each under 1e-4."""
    params = armon_torch.ArmonParameters(
        data_type=dtype, test="Sedov", scheme="GAD", projection="euler_2nd",
        riemann_limiter="minmod", nghost=4, N=(100, 100), maxcycle=1000,
        silent=5, measure_time=False, device="cpu", return_data=True)
    assert routing.route(params.config) == "multicycle"
    stats = armon_torch.armon(params)
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


@pytest.mark.parametrize("splitting", ["Sequential", "Godunov"])
def test_multicycle_stop_check_interval_is_bitwise_neutral(splitting):
    """Reading the stop flag after every launch (check_every 1 or 8) or
    every 4 launches (32) gives the same bits: cycles past the end pass
    through."""
    res = [_loop(check_every=every, test="Sod_circ", N=(32, 32),
                 axis_splitting=splitting)[1] for every in (1, 8, 32)]
    assert res[0].cycles % 8 != 0, "maxtime must end the run mid-launch"
    reads = [r.host_reads for r in res]
    assert reads[0] == reads[1] > reads[2]
    for r in res[1:]:
        _assert_same(r, res[0])
        for x, y in zip(r.carry, res[0].carry):
            assert torch.equal(x, y)


def test_multicycle_divergence_aborts():
    """cfl=3 blows the run up; the in-kernel ok gate stops it with the
    time error (`tests/test_pallas.py:372-386`)."""
    params = armon_torch.ArmonParameters(
        device="cpu", **{**_opts(200), "return_data": False}, cfl=3.0)
    assert routing.route(params.config) == "multicycle"
    with pytest.raises(armon_torch.SolverException, match="time"):
        armon_torch.armon(params)
