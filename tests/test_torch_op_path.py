"""The port's op path (``kernel_tier="torch"``, the JAX package's jnp tier in
plain PyTorch ops) on the CPU.

- Each op against its JAX jnp-tier counterpart jitted, as the JAX
  package's loop runs it (XLA contracts multiply-adds and multiplies by
  the reciprocal of a constant divisor, and so does the op path), in f64
  and f32, bit for bit: signed zeros and NaN positions included; the
  Bizarrium EOS within stated ulps (`BIZ_ULPS`).
- Whole runs through `armon_torch.armon(kernel_tier="torch")`: the Julia
  goldens at the JAX package's gates (`GATES`; Sedov f64 at what it
  measures); JAX's `armon(kernel_tier="jnp")`, whose loop is one jitted
  program, within 1e-13 of their scale in f64 and 1e-5 in f32 (see
  `test_run_matches_jax_jnp_tier`); the
  kernels' plain versions, bit for bit, on random states and whole runs;
  the X/Y transpose oracle; the stop-check interval; meshes against one
  device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import ref_file, abs_tol, rel_tol, reference_params

import armon_tpu
from armon_tpu.core import state as jstate_mod
from armon_tpu.core import timestep as jtimestep
from armon_tpu.io.output import read_reference_csv, compare_states
from armon_tpu.ops import (boundary as jboundary, eos as jeos,
                           limiters as jlimiters, projection as jprojection,
                           reductions as jreductions, riemann as jriemann,
                           shifts as jshifts, update as jupdate)
import armon_torch
from armon_torch.core import timestep
from armon_torch.core.solver import make_init
from armon_torch.core.state import State
from armon_torch.core.step import make_time_loop
from armon_torch.interop import to_numpy
from armon_torch.kernel_fuzz import random_fields as _random_fields
from armon_torch.ops import (boundary, eos, limiters, projection, reductions,
                             riemann, shifts, update)
from armon_torch.ops import sweep as K
from armon_torch.parallel.mesh import Mesh
from armon_torch.utils.enums import Axis

DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32],
                                 ids=["f64", "f32"])
AXES = pytest.mark.parametrize("axis", ["X", "Y"])
N = (40, 36)


# ------------------------------------------------------------------ helpers

def _configs(test="Sod_circ", dtype=np.float64, **opts):
    opts = dict(test=test, N=N, data_type=dtype, **opts)
    return (armon_tpu.ArmonParameters(**opts).config,
            armon_torch.ArmonParameters(device="cpu", kernel_tier="torch",
                                        **opts).config)


def _states(cfg, seed):
    f = _random_fields(cfg, seed)
    return (jstate_mod.State(**{k: jnp.asarray(a) for k, a in f.items()}),
            State(**{k: torch.from_numpy(a.copy()) for k, a in f.items()}))


def _same(a, b):
    """Bit for bit (NaN where the other is NaN, any payload)."""
    a = np.asarray(a).reshape(-1)
    b = (b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)).reshape(-1)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == bool:
        return np.array_equal(a, b)
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    ints = np.int64 if a.dtype.itemsize == 8 else np.int32
    return np.array_equal(np.where(nan, 0, a).view(ints),
                          np.where(nan, 0, b).view(ints))


def _same_states(js, ts, names=State._fields):
    for name in names:
        assert _same(getattr(js, name), getattr(ts, name)), name


def _jaxis(axis):
    return armon_tpu.Axis[axis]


def _dt(cfg, value=1e-4):
    return np.dtype(cfg.dtype).type(value)


def _jit(fn, cfg, state, axis, dt):
    """`fn(cfg, state, axis, dt)` as one jitted XLA program, the form in
    which the JAX package's loop runs it: XLA contracts its multiply-adds
    and multiplies by the reciprocal of a constant divisor."""
    return jax.jit(lambda s, d: fn(cfg, s, axis, d))(state, dt)


# ------------------------------------------------------------ ops, one by one

@DTYPES
@AXES
@pytest.mark.parametrize("k", [-2, -1, 1, 2])
def test_sh(axis, k, dtype):
    a = np.random.default_rng(k + 5).standard_normal((12, 17)).astype(dtype)
    assert _same(jshifts.sh(jnp.asarray(a), k, _jaxis(axis)),
                 shifts.sh(torch.from_numpy(a), k, Axis[axis]))


@DTYPES
@pytest.mark.parametrize("name", ["no_limiter", "minmod", "superbee"])
def test_limiter(name, dtype):
    r = np.random.default_rng(1).standard_normal(2000) * 3
    special = [0.0, -0.0, np.nan, np.inf, -np.inf, 0.5, 1.0, 2.0, -1e-30,
               1e-30, -1.0, 3.0]
    r = np.concatenate([r, special]).astype(dtype)
    assert _same(jlimiters.limiter_from_name(name)(jnp.asarray(r)),
                 limiters.limiter_from_name(name)(torch.from_numpy(r)))


@DTYPES
@AXES
def test_acoustic_godunov(axis, dtype):
    jc, tc = _configs(dtype=dtype, scheme="Godunov")
    js, ts = _states(tc, 2)
    a = _jaxis(axis)
    jo = jax.jit(lambda r, u, p, c: jriemann.acoustic(a, r, u, p, c))(
        js.rho, js.u if axis == "X" else js.v, js.p, js.c)
    to = riemann.acoustic(Axis[axis], ts.rho, ts.u if axis == "X" else ts.v,
                          ts.p, ts.c)
    assert all(_same(x, y) for x, y in zip(jo, to))


@DTYPES
@AXES
@pytest.mark.parametrize("limiter", ["no_limiter", "minmod", "superbee"])
def test_acoustic_gad(axis, limiter, dtype):
    jc, tc = _configs(dtype=dtype, riemann_limiter=limiter)
    js, ts = _states(tc, 3)
    dt = _dt(tc)
    jo = _jit(jriemann.numerical_fluxes, jc, js, _jaxis(axis), dt)
    to = riemann.numerical_fluxes(tc, ts, Axis[axis], torch.tensor(dt))
    _same_states(jo, to, ("ustar", "pstar"))


@DTYPES
@AXES
def test_cell_update(axis, dtype):
    jc, tc = _configs(dtype=dtype)
    js, ts = _states(tc, 4)
    dt = _dt(tc)
    _same_states(_jit(jupdate.cell_update, jc, js, _jaxis(axis), dt),
                 update.cell_update(tc, ts, Axis[axis], torch.tensor(dt)))


@DTYPES
@AXES
@pytest.mark.parametrize("order", ["euler", "euler_2nd"])
def test_advection(axis, order, dtype):
    jc, tc = _configs(dtype=dtype, projection=order)
    js, ts = _states(tc, 5)
    dt = _dt(tc, 3e-3)  # upwind both ways: |disp| spans cells' fractions
    jf = (jprojection.advection_first_order if order == "euler"
          else jprojection.advection_second_order)
    tf = (projection.advection_first_order if order == "euler"
          else projection.advection_second_order)
    jo = _jit(jf, jc, js, _jaxis(axis), dt)
    to = tf(tc, ts, Axis[axis], torch.tensor(dt))
    assert all(_same(x, d * q) for x, (d, q) in zip(jo, to))


@DTYPES
@AXES
def test_euler_projection(axis, dtype):
    jc, tc = _configs(dtype=dtype)
    js, ts = _states(tc, 6)
    dt = _dt(tc, 3e-3)
    a = _jaxis(axis)
    jf = _jit(jprojection.advection_second_order, jc, js, a, dt)
    # the fluxes as factor pairs (flux, 1): the differences of given fluxes,
    # which neither side contracts
    tf = tuple((f, torch.ones_like(f))
               for f in (torch.from_numpy(np.asarray(x).copy()) for x in jf))
    _same_states(jax.jit(lambda s, f: jprojection.euler_projection(
                     jc, s, a, dt, f))(js, jf),
                 projection.euler_projection(tc, ts, Axis[axis],
                                             torch.tensor(dt), tf)[0])
    _same_states(_jit(jprojection.projection_remap, jc, js, a, dt),
                 projection.projection_remap(tc, ts, Axis[axis],
                                             torch.tensor(dt))[0])


@AXES
@pytest.mark.parametrize("test", ["Sod", "Sod_y", "Sod_circ", "Bizarrium",
                                  "Sedov"])
def test_boundary_conditions(test, axis):
    """Each case's mirror factors, both sides of each axis."""
    jc, tc = _configs(test)
    js, ts = _states(tc, 7)
    _same_states(jboundary.boundary_conditions(jc, js, _jaxis(axis)),
                 boundary.boundary_conditions(tc, ts, Axis[axis]))
    before = to_numpy(ts)
    for side in ((armon_torch.Side.LEFT, armon_torch.Side.RIGHT) if axis == "X"
                 else (armon_torch.Side.BOTTOM, armon_torch.Side.TOP)):
        jside = armon_tpu.Side(int(side))
        _same_states(jboundary.apply_side_bc(jc, js, jside),
                     boundary.apply_side_bc(tc, ts, side))
        slab = jboundary.mirror_slab(js.u, jside, 4)
        assert _same(slab, boundary.mirror_slab(ts.u, side, 4))
        assert _same(jboundary.set_ghost_slab(js.v, jside, 4, slab),
                     boundary.set_ghost_slab(ts.v, side, 4,
                                             torch.from_numpy(np.array(slab))))
    assert all(np.array_equal(getattr(before, n), getattr(to_numpy(ts), n))
               for n in State._fields), "the input was written"


# The Bizarrium EOS against its jitted JAX counterpart, in ulps: XLA also
# reassociates the constants of its polynomials (`1 + x` of `x = rho/rho0
# - 1` becomes rho * (1/rho0)) and contracts them differently in each
# fusion, which plain tensor operations do not copy (ROADMAP C2; the
# perfect gas's constant fold across a cycle's sweeps is copied,
# `ops/eos.folds`). Measured
# over 32 seeds: p 8 and c 24 ulps of the cell's value, g 141 of the
# field's largest (its sum cancels).
BIZ_ULPS = {"p": (16, None), "c": (48, None), "g": (None, 512)}


@DTYPES
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_update_eos(test, dtype):
    jc, tc = _configs(test, dtype)
    js, ts = _states(tc, 8)
    jo = jax.jit(lambda s: jeos.update_eos(jc, s))(js)
    to = eos.update_eos(tc, ts)
    if test != "Bizarrium":
        _same_states(jo, to, ("p", "c", "g"))
        return
    for name, (cell, field) in BIZ_ULPS.items():
        a = np.asarray(getattr(jo, name))
        err = np.abs(a.astype(np.float64) - getattr(to, name).numpy())
        if cell is not None:
            assert np.all(err <= cell * np.spacing(np.abs(a))), name
        if field is not None:
            assert err.max() <= field * np.spacing(np.abs(a).max()), name


@DTYPES
def test_dt_cfl_min(dtype):
    jc, tc = _configs(dtype=dtype)
    js, ts = _states(tc, 9)
    assert _same(jax.jit(lambda s: jreductions.dt_cfl_min(jc, s))(js),
                 reductions.dt_cfl_min(tc, ts))


DT_OPTS = [dict(), dict(dt_on_even_cycles=True), dict(cst_dt=True, Dt=1e-3)]
DT_IDS = ["plain", "even", "cst"]


@DTYPES
@pytest.mark.parametrize("opts", DT_OPTS, ids=DT_IDS)
def test_dt_update(opts, dtype):
    """Seed (dt_prev = 0), cap bound and not, every cycle parity."""
    jc, tc = _configs(dtype=dtype, **opts)
    T = np.dtype(dtype).type
    for lm in (T(2e-3), T(np.nan), T(0.0)):
        for dt_prev in (T(0.0), T(1.0e-3), T(3.0e-3)):
            for cycle in range(4):
                jo = jtimestep.dt_update(jc, lm, dt_prev, np.int32(cycle))
                to = timestep.dt_update(tc, torch.tensor(lm),
                                        torch.tensor(dt_prev), cycle)
                assert all(_same(x, y) for x, y in zip(jo, to)), \
                    (lm, dt_prev, cycle)


@DTYPES
@pytest.mark.parametrize("opts", DT_OPTS, ids=DT_IDS)
def test_next_time_step(opts, dtype):
    """The reduction and the dt_on_even_cycles skip, with and without the
    host's hint that dt_prev is nonzero."""
    jc, tc = _configs(dtype=dtype, **opts)
    js, ts = _states(tc, 10)
    mesh = Mesh(tc, ["cpu"])
    T = np.dtype(dtype).type
    for dt_prev in (T(0.0), T(1.0e-3)):
        for cycle in range(4):
            jo = jtimestep.next_time_step(jc, js, dt_prev, np.int32(cycle))
            for seeded in {False, bool(dt_prev)}:
                to = timestep.next_time_step(tc, mesh, [ts],
                                             torch.tensor(dt_prev), cycle,
                                             seeded)
                assert all(_same(x, y) for x, y in zip(jo, to)), \
                    (dt_prev, cycle, seeded)


# ----------------------------------------------------------------- whole runs

def _op_params(test, dtype, **overrides):
    """The golden-run configuration of `conftest.reference_params` on the
    op path."""
    options = dict(data_type=dtype, test=test, scheme="GAD",
                   projection="euler_2nd", riemann_limiter="minmod",
                   nghost=4, N=(100, 100), maxcycle=1000, silent=5,
                   measure_time=False, device="cpu", kernel_tier="torch",
                   return_data=True)
    options.update(overrides)
    return armon_torch.ArmonParameters(**options)


# The JAX package's golden gates (`tests/test_convergence.py:50-86`): a
# diff count, a largest difference and a largest non-p difference (None:
# no gate). The op path contracts the multiply-adds that the JAX package's
# jitted program contracts (`ops/fma.py`) and folds the EOS constant
# across the sweeps of a cycle as it does (`ops/eos.folds`), and meets
# every gate, Sedov f64's zero differences included (ROADMAP C2).
GATES = {("Sod", "f64"): (0, 0.0, None), ("Sod", "f32"): (0, 0.0, None),
         ("Sedov", "f64"): (0, 0.0, None),
         ("Sedov", "f32"): (1500, 1e-4, None),
         ("Bizarrium", "f64"): (16000, 1e-5, 1e-12),
         ("Bizarrium", "f32"): (6000, None, 5e-3)}


@DTYPES
@pytest.mark.parametrize("test", ["Sod", "Sod_y", "Sod_circ", "Sedov",
                                  "Bizarrium"])
def test_golden(test, dtype):
    """The goldens at `tests/test_convergence.py`'s ladder and gates
    (`GATES`; the Sod family's zero gate for Sod_y and Sod_circ too)."""
    stats = armon_torch.armon(_op_params(test, dtype))
    jcfg = reference_params(test, dtype).config
    ref_dt, ref_cycles, ref = read_reference_csv(jcfg, ref_file(test, dtype))
    atol, rtol = abs_tol(dtype), rel_tol(dtype)
    assert stats.cycles == ref_cycles
    assert abs(float(ref_dt) - stats.last_dt) <= max(atol, rtol * abs(float(ref_dt)))
    cnt, max_diff, details = compare_states(jcfg, to_numpy(stats.data), ref,
                                            atol=atol, rtol=rtol)
    bits = "f64" if np.dtype(dtype).itemsize == 8 else "f32"
    key = ("Sod" if test.startswith("Sod") else test, bits)
    most, largest, non_p_largest = GATES[key]
    non_p = max((m for v, (c, m) in details.items() if v != "p"), default=0.0)
    assert cnt <= most, details
    if largest == 0.0:
        assert max_diff == 0, details
    else:
        assert largest is None or max_diff < largest, details
    assert non_p_largest is None or non_p < non_p_largest, details


JNP_RUNS = [
    ("Sod_circ", dict(scheme="Godunov", riemann_limiter="no_limiter",
                      projection="euler")),
    ("Sod_circ", dict(axis_splitting="Strang", riemann_limiter="superbee")),
    ("Sod_circ", dict(axis_splitting="Godunov", projection="euler",
                      dt_on_even_cycles=True)),
    ("Sod", dict(riemann_limiter="no_limiter", cst_dt=True, Dt=1e-3)),
    ("Bizarrium", dict(axis_splitting="Godunov")),
    ("Sedov", dict(data_type=np.float32, dt_on_even_cycles=True)),
    ("Sod_circ", dict(data_type=np.float32, axis_splitting="Strang",
                      scheme="Godunov")),
    ("Sod_circ", dict(N=(40, 2))),
    ("Sod_circ", dict(N=(2, 40), axis_splitting="Godunov")),
    ("Sod_circ", dict(N=(3, 5), projection="euler")),
]


# JNP_RUNS whose fields, t and dt the op path gives bit for bit; the rest
# (measured in ulps of the scale: Bizarrium c 19, g 59, t 6.2, dt 5.2;
# the grid thinner than the ghost band, (2, 40), 0.03-3.5; Sedov f32 under
# 0.01, the tiny velocities at its blast front, which XLA flushes to zero
# below the smallest normal) stay within the scale tolerance below.
JNP_EXACT = {0, 1, 2, 3, 6, 7, 9}


@pytest.mark.parametrize(
    "case", range(len(JNP_RUNS)),
    ids=[f"{t}-" + "-".join(f"{k}={getattr(v, '__name__', v)}"
                            for k, v in e.items()) for t, e in JNP_RUNS])
def test_run_matches_jax_jnp_tier(case):
    """12 cycles at 32^2 (or a degenerate grid thinner than the ghost
    band) against JAX's `armon(kernel_tier="jnp")`, one jitted program:
    the same cycle count, and t, dt and every field on real cells bit for
    bit for the runs in `JNP_EXACT`, else within 1e-13 (f64) or 1e-5
    (f32) of their scale, max(1, max|ref|) for a field: XLA also
    reassociates the Bizarrium EOS's constants, fuses the thin grids'
    ghost fills differently and flushes subnormal results (ROADMAP C2)."""
    test, extra = JNP_RUNS[case]
    opts = dict(test=test, N=(32, 32), data_type=np.float64, maxcycle=12,
                silent=5, measure_time=False, return_data=True)
    opts.update(extra)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(kernel_tier="jnp", **opts))
    ts = armon_torch.armon(armon_torch.ArmonParameters(
        device="cpu", kernel_tier="torch", **opts))
    exact = case in JNP_EXACT
    tol = 0.0 if exact else 1e-13 if opts["data_type"] is np.float64 else 1e-5
    assert ts.cycles == js.cycles
    assert abs(ts.final_time - js.final_time) <= tol * abs(js.final_time)
    assert abs(ts.last_dt - js.last_dt) <= tol * abs(js.last_dt)
    g = 4
    data = to_numpy(ts.data)
    for name in ("rho", "u", "v", "E", "p", "c", "g", "ustar", "pstar"):
        a = np.asarray(getattr(js.data, name))[g:-g, g:-g]
        b = getattr(data, name)[g:-g, g:-g]
        if exact:
            assert _same(a, b), name
            continue
        scale = max(1.0, float(np.max(np.abs(a))))
        assert np.max(np.abs(a.astype(np.float64) - b)) <= tol * scale, name


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sweep_matches_kernels_plain(seed):
    """One X and one Y sweep of random states (`tests/test_fuzz.py`'s
    scheme draw) through the op path and through the kernels' plain
    version: within `tests/test_fuzz.py:87`'s tolerance, and in fact bit
    for bit (both round in IEEE arithmetic and contract the same products,
    `ops/fma.py`; the plain version's reordered second-order slopes give
    the same bits)."""
    from armon_torch.core.step import sweep
    rng = np.random.default_rng(seed)
    opts = dict(scheme=str(rng.choice(["Godunov", "GAD"])),
                riemann_limiter=str(rng.choice(["no_limiter", "minmod",
                                                "superbee"])),
                projection=str(rng.choice(["euler", "euler_2nd"])))
    _, cfg = _configs(**opts)
    _, ts = _states(cfg, 20 + seed)
    mesh = Mesh(cfg, ["cpu"])
    dt = torch.tensor(1e-4, dtype=torch.float64)
    g = cfg.nghost
    for axis in (Axis.X, Axis.Y):
        [op], _ = sweep(cfg, mesh, [ts], axis, dt)
        plain = K.sweep_plain(cfg, axis, ts.rho, ts.u, ts.v, ts.E, dt)
        for name, b in zip(("rho", "u", "v", "E"), plain):
            a = getattr(op, name)[g:-g, g:-g]
            assert torch.allclose(a, b[g:-g, g:-g], rtol=1e-12, atol=1e-14), \
                (opts, axis, name)
            assert torch.equal(a, b[g:-g, g:-g]), (opts, axis, name)


@pytest.mark.parametrize("test,dtype,extra", [
    ("Sedov", np.float64, {}),
    ("Bizarrium", np.float32, dict(axis_splitting="Godunov")),
    ("Sod_circ", np.float32, dict(axis_splitting="Strang",
                                  riemann_limiter="superbee")),
], ids=["Sedov-f64", "Bizarrium-f32", "Sod_circ-f32-Strang"])
def test_run_matches_kernels_plain(test, dtype, extra):
    """40 cycles at 48^2: the op path equals the kernels' plain versions
    (the per-sweep route on the CPU, which the card's kernels match bit
    for bit in exact mode) in every field of the real cells, t and dt."""
    opts = dict(N=(48, 48), maxcycle=40, **extra)
    op = armon_torch.armon(_op_params(test, dtype, **opts))
    plain = armon_torch.armon(_op_params(test, dtype, kernel_tier="auto",
                                         pair_threshold=0,
                                         temporal_blocking=1, **opts))
    assert (op.cycles, op.final_time, op.last_dt) == \
        (plain.cycles, plain.final_time, plain.last_dt)
    for name in ("rho", "u", "v", "E", "p"):
        assert torch.equal(getattr(op.data, name)[4:-4, 4:-4],
                           getattr(plain.data, name)[4:-4, 4:-4]), name


@pytest.mark.parametrize("scheme,limiter,projection,dtype", [
    ("Godunov", "no_limiter", "euler", np.float64),
    ("GAD", "minmod", "euler_2nd", np.float64),
    ("GAD", "superbee", "euler_2nd", np.float32),
], ids=["godunov-e1-f64", "gad-minmod-e2-f64", "gad-superbee-e2-f32"])
def test_xy_transpose_symmetry(scheme, limiter, projection, dtype):
    """`tests/test_schemes.py:158`'s oracle: Sod on X sweeps only is the
    exact transpose of Sod_y on Y sweeps only, u and v swapped."""
    def solve(test, split, n):
        st = armon_torch.armon(_op_params(
            test, dtype, N=n, maxcycle=10, scheme=scheme,
            riemann_limiter=limiter, projection=projection,
            axis_splitting=split))
        assert st.cycles == 10
        data = to_numpy(st.data)
        return {v: getattr(data, v)[4:-4, 4:-4]
                for v in ("rho", "u", "v", "E", "p")}, st.last_dt

    a, dt_x = solve("Sod", "X_only", (64, 40))
    b, dt_y = solve("Sod_y", "Y_only", (40, 64))
    assert dt_x == dt_y
    swap = {"u": "v", "v": "u"}
    for var in a:
        assert np.array_equal(a[var], b[swap.get(var, var)].T), var


@pytest.mark.parametrize("splitting", ["Sequential", "Strang"])
def test_stop_check_interval_is_bitwise_neutral(splitting):
    """Reading the stop predicate every cycle or every 8 cycles gives the
    same bits: cycles past the end keep every field and scalar."""
    params = _op_params("Sod_circ", np.float64, N=(32, 32),
                        axis_splitting=splitting)
    cfg = params.config
    results = []
    for every in (1, 8):
        [st] = make_init(params)()
        results.append(make_time_loop(cfg)(st, check_every=every))
    r1, r8 = results
    assert r1.cycles % 8 != 0, "maxtime must end the run mid-batch"
    assert r8.host_reads < r1.host_reads
    assert (r1.t, r1.cycles, r1.dt_last, r1.lm, r1.ok) == \
        (r8.t, r8.cycles, r8.dt_last, r8.lm, r8.ok)
    for name in State._fields:
        assert torch.equal(getattr(r1.carry, name), getattr(r8.carry, name))


@pytest.mark.parametrize("P,n,test", [((2, 2), (32, 32), "Sod_circ"),
                                      ((1, 2), (32, 32), "Bizarrium"),
                                      ((2, 2), (41, 39), "Sod_circ")],
                         ids=["2x2", "1x2", "2x2-uneven"])
def test_mesh_matches_one_device(P, n, test):
    """A mesh of CPU shards on the op path (the seven-field halo exchange,
    the shards' CFL minimum) equals the one-device op path bit for bit on
    every real cell, with t, dt and the final CFL minimum."""
    opts = dict(N=n, maxcycle=20, axis_splitting="Strang")
    one = _op_params(test, np.float64, **opts)
    mesh = _op_params(test, np.float64, P=P, **opts)
    a = armon_torch.armon(one)
    b = armon_torch.armon(mesh)
    assert (a.cycles, a.final_time, a.last_dt) == \
        (b.cycles, b.final_time, b.last_dt)
    assert one._final_local_min == mesh._final_local_min
    for name in State._fields:
        assert torch.equal(getattr(a.data, name)[4:-4, 4:-4],
                           getattr(b.data, name)[4:-4, 4:-4]), name


@pytest.mark.parametrize("P,n", [((2, 2), (32, 32)), ((1, 2), (32, 32)),
                                 ((2, 2), (41, 39))],
                         ids=["2x2", "1x2", "2x2-uneven"])
def test_halo_exchange_state_matches_jax(P, n):
    """The seven-field exchange along X then Y on every shard, against the
    JAX package's `halo_exchange` of `COMM_VARS` under `shard_map` on
    the virtual CPU mesh, bit for bit over whole blocks (the uneven edge
    shards' bands past their own real cells, their slack untouched)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from armon_tpu.core.solver import _mesh_and_specs
    from armon_tpu.parallel import halo as jhalo
    from armon_torch.interop import shards_from_blocked
    from armon_torch.parallel.halo import halo_exchange_state
    jp = reference_params("Sod_circ", np.float64, N=n, P=P)
    tp = armon_torch.ArmonParameters(device="cpu", kernel_tier="torch",
                                     test="Sod_circ", N=n, P=P)
    cfg = tp.config
    rows, cols = cfg.local_shape
    px, py = P
    arrays = _random_fields(cfg, 12, (py * rows, px * cols))
    shards = shards_from_blocked(tp, arrays, kind=State)
    mesh = Mesh(cfg, tp.devices)
    for axis in (Axis.X, Axis.Y):
        shards = halo_exchange_state(cfg, mesh, shards, axis)

    jmesh, state_spec, _ = _mesh_and_specs(jp)
    sharding = NamedSharding(jmesh, PS("py", "px"))
    jstate = jstate_mod.State(**{k: jax.device_put(a, sharding)
                                 for k, a in arrays.items()})

    def exchange(st):
        for axis in (armon_tpu.Axis.X, armon_tpu.Axis.Y):
            st = jhalo.halo_exchange(jp.config, st, axis)
        return st

    jout = jax.jit(jax.shard_map(exchange, mesh=jmesh, in_specs=(state_spec,),
                                 out_specs=state_spec, check_vma=False))(jstate)
    for s in mesh:
        for name in State._fields:
            want = np.asarray(getattr(jout, name)).reshape(
                py, rows, px, cols)[s.iy, :, s.ix, :]
            assert _same(want, getattr(shards[s.index], name)), (s, name)
