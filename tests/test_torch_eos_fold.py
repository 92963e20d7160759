"""The cross-sweep EOS fold (`armon_torch/ops/eos.folds`, ROADMAP C2).

Across the sweeps of one cycle, XLA folds the previous sweep's
(X * (1/d)) * (gamma-1) into X * K in the JAX package's jitted jnp tier, X
the unscaled new density of the remap. The port copies it on every route:
the op path hands X from one sweep to the next, the kernels' plain
versions (and the kernels) keep X in the rho buffer between the launches
of a cycle and rebuild rho = X * (1/d) on load.

Tolerances: none. The op path equals the jnp tier bit for bit on Sedov
f64 at the golden configuration; in f32 XLA also flushes subnormal
results to zero, which the port does not copy, so there u and v are
compared where either is at least 1e-25 in magnitude (the cells it
flushes are all below 2e-30). Every route equals the op path bit for bit.
"""

import numpy as np
import pytest
import torch

from conftest import reference_params

import armon_tpu
import armon_torch
from armon_torch.interop import to_numpy
from armon_torch.ops import eos
from armon_torch.ops import routing
from armon_torch.ops import sweep as K
from armon_torch.ops import cycle as C
from armon_torch.utils.enums import Axis
from armon_torch.utils.errors import SolverException

G = 4
FIELDS = ("rho", "u", "v", "E", "p", "c")
# Below this magnitude XLA's flush of subnormal results may differ in f32.
F32_FLUSH = 1e-25


def _golden_opts(dtype):
    """`conftest.reference_params`'s configuration, as keyword options."""
    cfg = reference_params("Sedov", dtype)
    return dict(data_type=dtype, test="Sedov", scheme="GAD",
                projection="euler_2nd", riemann_limiter="minmod",
                nghost=4, N=(100, 100), maxcycle=cfg.config.maxcycle,
                silent=5, measure_time=False, return_data=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_op_path_equals_jnp_tier_on_sedov(dtype):
    """Sedov at the golden configuration (100^2, 568 cycles) through the op
    path and through `armon_tpu.armon(kernel_tier="jnp")`: the same cycles,
    t and dt, and rho, u, v, E, p and c bit for bit on real cells (f32: u
    and v where either is at least F32_FLUSH)."""
    opts = _golden_opts(dtype)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(kernel_tier="jnp", **opts))
    ts = armon_torch.armon(armon_torch.ArmonParameters(
        device="cpu", kernel_tier="torch", **opts))
    assert ts.cycles == js.cycles == 568
    assert ts.final_time == js.final_time
    assert ts.last_dt == js.last_dt
    data = to_numpy(ts.data)
    for name in FIELDS:
        a = np.asarray(getattr(js.data, name))[G:-G, G:-G]
        b = getattr(data, name)[G:-G, G:-G]
        if dtype is np.float32 and name in ("u", "v"):
            big = (np.abs(a) >= F32_FLUSH) | (np.abs(b) >= F32_FLUSH)
            assert big.sum() > a.size // 2, name
            assert np.array_equal(a[big], b[big]), name
            assert np.max(np.abs(a - b)) < 2e-30, name
        else:
            assert np.array_equal(a, b), name


def _run(**kw):
    """Sedov on 40 x 36 cells: dx != dy, and neither 1/dx nor 1/dy a power
    of two, so that the fold changes bits (at 32^2, 1/d = 16 and X * K is
    (X * 16) * (gamma-1) exactly) and an axis taken for the other shows."""
    opts = dict(test="Sedov", N=(40, 36), data_type=np.float64, maxcycle=16,
                silent=5, measure_time=False, return_data=True, device="cpu")
    opts.update(kw)
    params = armon_torch.ArmonParameters(**opts)
    return params, armon_torch.armon(params)


ROUTES = {"per_sweep": dict(pair_threshold=0, temporal_blocking=1),
          "pair": dict(temporal_blocking=1),
          "multicycle": dict(),
          "mesh_per_sweep": dict(P=(2, 2), pair_threshold=0,
                                 temporal_blocking=1),
          "mesh_pair": dict(P=(1, 2), temporal_blocking=1)}
CASES = [(s, r) for s in ("Strang", "SequentialSym") for r in ROUTES
         if r != "multicycle"] + [("Godunov", r) for r in ROUTES]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("splitting,route", CASES,
                         ids=[f"{s}-{r}" for s, r in CASES])
def test_routes_equal_op_path(splitting, route, dtype):
    """Sedov at 40 x 36 through each kernel route's plain versions
    (per-sweep, pair, multicycle, a 2x2 mesh per-sweep and a 1x2 mesh on
    the pair route) equals the op path bit for bit, in the
    fold's sweep orders: Strang's three sweeps (the middle one reads and
    leaves X), SequentialSym's alternating pairs, Godunov on K5."""
    _, ref = _run(kernel_tier="torch", axis_splitting=splitting,
                  data_type=dtype)
    params, got = _run(axis_splitting=splitting, data_type=dtype,
                       **ROUTES[route])
    want = "multicycle" if route == "multicycle" else \
        route.replace("mesh_", "")
    assert routing.route(params.config) == want
    assert (got.cycles, got.final_time, got.last_dt) == \
        (ref.cycles, ref.final_time, ref.last_dt)
    a, b = to_numpy(ref.data), to_numpy(got.data)
    for name in ("rho", "u", "v", "E", "p"):
        assert np.array_equal(getattr(a, name)[G:-G, G:-G],
                              getattr(b, name)[G:-G, G:-G]), name


@pytest.mark.parametrize("dtype,dx,want", [
    (np.float64, 0.02, 19.999999999999996),
    (np.float32, 0.02, np.float32(50.0) * np.float32(0.39999998))])
def test_fold_constant(dtype, dx, want):
    """K = RN(RN(1/d) * RN(gamma - 1)) in T, 19.999999999999996 at Sedov's
    f64 cell of 0.02 (gamma 1.4)."""
    params = armon_torch.ArmonParameters(test="Sedov", N=(100, 100),
                                         data_type=dtype, device="cpu")
    cfg = params.config
    assert cfg.cell_size(Axis.X) == pytest.approx(dx)
    rdx, k = eos.fold_const(cfg, Axis.X)
    T = np.dtype(dtype).type
    assert rdx == T(1.0) / T(cfg.cell_size(Axis.X))
    assert k == T(want) and type(k) is T


def test_fold_refused_where_not_taken():
    """A fold is for the perfect gas in exact arithmetic: the Bizarrium
    EOS refuses one on a K1 launch, and an unscaled density kept by K4."""
    T = torch.float64
    for launch in ("K1", "K4"):
        params = armon_torch.ArmonParameters(test="Bizarrium", N=(8, 8),
                                             data_type=np.float64,
                                             device="cpu")
        cfg = params.config
        shape = cfg.local_shape
        src = tuple(torch.ones(shape, dtype=T) for _ in range(4))
        dst = tuple(torch.empty(shape, dtype=T) for _ in range(4))
        p = torch.empty(shape, dtype=T)
        part = torch.zeros((2, 1), dtype=T)
        scal, iscal = K.new_scalars(cfg.dtype, "cpu")
        with pytest.raises(SolverException):
            if launch == "K1":
                K.x_sweep(cfg, src, dst, p, part, scal, iscal, 1.0, True,
                          fold=K.Fold(None, True))
            else:
                C.cycle(cfg, True, 1.0, 1.0, src, dst, p, part, scal, iscal,
                        True, keep=True)


@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
def test_folded_cycle_plain_equals_two_folded_sweeps(x_first):
    """K4's plain version, which folds between its sweeps, equals the
    per-sweep route's two launches with their folds, bit for bit on real
    cells: the first leaves X, the second rebuilds rho from it; and it
    differs from two launches without them (the fold is taken)."""
    params, res = _run(pair_threshold=0, temporal_blocking=1, maxcycle=40)
    cfg = params.config
    data = res.data
    src = (data.rho, data.u, data.v, data.E)
    dt = torch.tensor(0.5 * res.last_dt, dtype=torch.float64)
    a1, a2 = (Axis.X, Axis.Y) if x_first else (Axis.Y, Axis.X)
    out = K.sweep_plain(cfg, a1, *src, dt, fold=K.Fold(None, True))
    out = K.sweep_plain(cfg, a2, *out[:4], dt, fold=K.Fold(a1, False))
    ref = C.cycle_plain(cfg, x_first, *src, dt, dt)
    plain = K.sweep_plain(cfg, a1, *src, dt)
    plain = K.sweep_plain(cfg, a2, *plain[:4], dt)
    for a, b in zip(ref[:5], out[:5]):
        assert torch.equal(a[G:-G, G:-G], b[G:-G, G:-G])
    assert not torch.equal(ref[4][G:-G, G:-G], plain[4][G:-G, G:-G])
