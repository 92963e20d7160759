"""The port's routing and its pair route (K4 `cycle`, plain version on the
CPU) against the JAX package: the same options pick the same kernels, the
pair route matches `armon_tpu.armon` on its pair route (interpret-mode
Pallas `fused_cycle`), equals the port's per-sweep route bit for bit, and
keeps the goldens.

Tolerances: within the port, exact IEEE arithmetic on both routes, so bit
for bit. Against the JAX package as in `test_torch_slice.py`: XLA contracts
multiply-adds in its jitted program, so fields agree within 1e-13 of their
scale after 10 cycles and t, dt within 4 eps.
"""

import numpy as np
import pytest
import torch

from conftest import reference_params, ref_file, abs_tol, rel_tol

import armon_tpu
from armon_tpu.core import step as jstep
from armon_tpu.io.output import read_reference_csv, compare_states
import armon_torch
from armon_torch.interop import to_numpy
from armon_torch.kernel_fuzz import pair_folds
from armon_torch.core.solver import make_init_fused, make_mesh
from armon_torch.core.step import make_time_loop_lean
from armon_torch.ops import routing
from armon_torch.ops import sweep as K
from armon_torch.ops import cycle as C
from armon_torch.ops.cycle import cycle_plain
from armon_torch.ops.reductions import real_slice
from armon_torch.parallel.halo import halo_slabs
from armon_torch.utils.enums import Axis

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)
G = 4
FIELDS = ("rho", "u", "v", "E", "p")


def _configs(N, dtype, **opts):
    kw = dict(test="Sod", N=N, data_type=dtype, silent=5, **opts)
    return (armon_tpu.ArmonParameters(kernel_tier="pallas", **kw).config,
            armon_torch.ArmonParameters(device="cpu", **kw).config)


@pytest.mark.parametrize("N,dtype,extra", [
    ((64, 64), np.float64, {}), ((100, 100), np.float32, {}),
    ((2048, 100), np.float32, {}), ((2049, 10), np.float32, {}),
    ((248, 120), np.float32, {}), ((248, 120), np.float64, {}),
    ((40, 2), np.float64, {}), ((3, 5), np.float64, {}),
    ((100, 100), np.float32, dict(maxcycle=1 << 24)),
    ((100, 100), np.float64, dict(nghost=9)),
    ((12, 12), np.float64, dict(nghost=6)),
], ids=["64", "100-f32", "2048x100", "2049x10", "248x120-f32",
        "248x120-f64", "40x2", "3x5", "maxcycle-2^24", "g9", "12-g6"])
def test_routing_matches_jax(N, dtype, extra):
    """`pair_routing_on` and `temporal_pairs` of the port equal the JAX
    package's for every splitting, threshold and K tried."""
    for splitting in ("Sequential", "Godunov", "Strang", "X_only"):
        for threshold in (0, 100, 2048):
            for tb in (0, 1, 3, 8):
                jcfg, tcfg = _configs(N, dtype, axis_splitting=splitting,
                                      pair_threshold=threshold,
                                      temporal_blocking=tb, **extra)
                key = (splitting, threshold, tb)
                assert routing.pair_routing_on(tcfg) == \
                    jstep.pair_routing_on(jcfg), key
                assert routing.temporal_pairs(tcfg) == \
                    jstep.temporal_pairs(jcfg), key


def test_default_routes():
    """With no option set the port routes as the JAX package does: 100^2
    multicycle, 2000^2 pair, 8192^2 per-sweep."""
    for n, want in ((100, "multicycle"), (2000, "pair"), (8192, "per_sweep")):
        cfg = armon_torch.ArmonParameters(device="cpu", N=(n, n),
                                          data_type="float32").config
        assert routing.route(cfg) == want


RUNS = [
    ("Sod_circ", dict(axis_splitting="Sequential")),
    ("Sod_circ", dict(axis_splitting="Godunov")),
    ("Sod_circ", dict(axis_splitting="Strang")),
    ("Bizarrium", dict()),
]


@pytest.mark.parametrize("test,extra", RUNS,
                         ids=["sequential", "godunov", "strang", "bizarrium"])
def test_pair_route_matches_jax(test, extra):
    """10 cycles at 64^2 f64 against `armon_tpu.armon` on its pair route."""
    opts = dict(test=test, N=(64, 64), data_type=np.float64, maxcycle=10,
                silent=5, measure_time=False, return_data=True, **extra)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(
        kernel_tier="pallas", pair_threshold=2048, temporal_blocking=1,
        **opts))
    params = armon_torch.ArmonParameters(device="cpu", **PAIR, **opts)
    assert routing.route(params.config) == "pair"
    ts = armon_torch.armon(params)
    eps = np.finfo(np.float64).eps
    assert ts.cycles == js.cycles
    assert abs(ts.final_time - js.final_time) <= 4 * eps * abs(js.final_time)
    assert abs(ts.last_dt - js.last_dt) <= 4 * eps * abs(js.last_dt)
    data = to_numpy(ts.data)
    for name in FIELDS:
        a = np.asarray(getattr(js.data, name))[G:-G, G:-G]
        b = getattr(data, name)[G:-G, G:-G]
        scale = max(1.0, float(np.max(np.abs(a))))
        assert np.max(np.abs(a - b)) <= 1e-13 * scale, name


@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
@pytest.mark.parametrize("test,N,dtype", [
    ("Sod_circ", (48, 40), "float64"), ("Bizarrium", (48, 40), "float64"),
    ("Sod_circ", (48, 40), "float32"), ("Sod_circ", (40, 3), "float64"),
    ("Sod_circ", (3, 40), "float64")],
    ids=["circ", "biz", "circ-f32", "40x3", "3x40"])
def test_cycle_plain_equals_two_sweeps(test, N, dtype, x_first):
    """K4's plain version (both fills from the pre-cycle state, then two
    sweeps) equals two per-sweep sweeps with their own fills (and the
    cycle's cross-sweep EOS fold, as K4 takes it), bit for bit on real
    cells, also on grids thinner than the ghost band."""
    params = armon_torch.ArmonParameters(device="cpu", test=test, N=N,
                                         data_type=dtype, maxcycle=3,
                                         silent=5, **PER_SWEEP)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg)(fs, 0.0, 0, 0.0, float(seed))
    dt = torch.tensor(0.5 * res.dt_last, dtype=fs.rho.dtype)
    src = tuple(res.carry[:4])
    a1, a2 = (Axis.X, Axis.Y) if x_first else (Axis.Y, Axis.X)
    d1, d2 = (dt * 0.5, dt) if x_first else (dt, dt * 0.5)
    f1, f2 = pair_folds(cfg, "cpu", a1)
    out = K.sweep_plain(cfg, a1, *src, d1, fold=f1)
    out = K.sweep_plain(cfg, a2, *out[:4], d2, fold=f2)
    ref = cycle_plain(cfg, x_first, *src, *((d1, d2) if x_first else (d2, d1)))
    for a, b in zip(ref[:5], out[:5]):
        assert torch.equal(a[G:-G, G:-G], b[G:-G, G:-G])
    mx, my = K.cfl_partial_plain(cfg, out[1], out[2], out[5])
    assert torch.equal(ref[5], mx) and torch.equal(ref[6], my)


def _k4_windows(cfg, x_first, src, dtx, dty, y_ghosts=K.MIRRORED, n_real=None):
    """K4's function cut as its kernel cuts it (`ops/cycle.py`'s window
    and grid): the pre-cycle state with both ghost fills, read at each
    block's window rows and columns (clamped to the array, as the
    kernel's loads are), the two plain sweeps on the window alone without
    refilling (with the cycle's cross-sweep EOS fold), and the tile at
    the window's centre written back. Returns (rho, u, v, E, p); cells no
    tile covers stay NaN."""
    H = K.HALO
    wx, wy = C.cycle_window(cfg.dtype)
    rx, ry = wx - 2 * H, wy - 2 * H
    f = K.fill_ghosts_plain(cfg, Axis.X, K.fill_ghosts_plain(
        cfg, Axis.Y, src, n_real, y_ghosts), n_real)
    rows, cols = f[0].shape
    gx, gy = C.tile_grid((wx, wy), (rows, cols))
    out = [torch.full_like(f[0], float("nan")) for _ in range(5)]
    a1, d1, a2, d2 = ((Axis.X, dtx, Axis.Y, dty) if x_first
                      else (Axis.Y, dty, Axis.X, dtx))
    f1, f2 = pair_folds(cfg, "cpu", a1)
    for by in range(gy):
        for bx in range(gx):
            r0, c0 = by * ry, bx * rx
            ri = (torch.arange(wy) + r0 - H).clamp(0, rows - 1)
            ci = (torch.arange(wx) + c0 - H).clamp(0, cols - 1)
            win = [a[ri][:, ci] for a in f]
            o = K.sweep_plain(cfg, a1, *win, d1, (None, None), fold=f1)
            o = K.sweep_plain(cfg, a2, *o[:4], d2, (None, None), fold=f2)
            h, w = min(ry, rows - r0), min(rx, cols - c0)
            for k in range(5):
                out[k][r0:r0 + h, c0:c0 + w] = o[k][H:H + h, H:H + w]
    return out


K4_WINDOW_CASES = [
    ("ragged", (200, 260), "float32", None),       # 3 x 5 f32 tiles
    ("ragged-f64", (200, 260), "float64", None),   # 4 x 5 f64 tiles
    ("40x2", (40, 2), "float64", None),
    ("2x40", (2, 40), "float32", None),
    ("slab-1x3", (150, 300), "float32", (1, 3)),   # every shard
]


@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
@pytest.mark.parametrize("name,N,dtype,P", K4_WINDOW_CASES,
                         ids=[c[0] for c in K4_WINDOW_CASES])
def test_k4_windows_stitch_to_cycle_plain(name, N, dtype, P, x_first):
    """The tile geometry and halo depth K4 relies on: two sweeps on each
    block's window alone, without refilling, give at the tiles' centres
    what `cycle_plain` gives on the whole array, bit for bit on real
    cells; on several tiles with ragged edges, on grids thinner than the
    ghost band and on every Y-slab shard of a 1x3 mesh."""
    params = armon_torch.ArmonParameters(
        device="cpu", test="Sod_circ", N=N, data_type=dtype, maxcycle=3,
        silent=5, **PER_SWEEP, **({"P": P} if P else {}))
    cfg = params.config
    mesh = make_mesh(params)
    fs, seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg, mesh)(fs, 0.0, 0, 0.0, float(seed))
    cur = [tuple(c[:4]) for c in res.carry]
    ghosts = halo_slabs(cfg, mesh, cur, Axis.Y) if P else [K.MIRRORED]
    dt = torch.tensor(0.5 * res.dt_last, dtype=cur[0][0].dtype)
    dtx, dty = (dt * 0.5, dt) if x_first else (dt, dt * 0.5)
    for s in mesh:
        src = cur[s.index]
        got = _k4_windows(cfg, x_first, src, dtx, dty, ghosts[s.index], s.n_real)
        ref = cycle_plain(cfg, x_first, *src, dtx, dty, ghosts[s.index], s.n_real)
        r = real_slice(cfg, s.n_real)
        for a, b in zip(got, ref[:5]):
            assert torch.equal(a[r], b[r]), (name, s.index)


def _k5_windows(cfg, x_first, src, dtx, dty, window):
    """K5's function cut as its kernel cuts it (`ops/cycle.py` `multi_tile`
    windows and `tile_grid`): the pre-cycle state with both ghost fills,
    read at every tile's `window` x `window` rows and columns (clamped to
    the array, as the kernel's loads are), the two plain sweeps on each
    window alone without refilling (with the cycle's cross-sweep EOS
    fold), and the tile at the window's centre written back. The windows go through each sweep side by side, a
    window's rows (X) or columns (Y) beside the others': a sweep is local
    to its lines. Returns (rho, u, v, E, p, c); cells no tile covers stay
    NaN."""
    H, w = K.HALO, window
    f = K.fill_ghosts_plain(cfg, Axis.X,
                            K.fill_ghosts_plain(cfg, Axis.Y, src))
    rows, cols = f[0].shape
    gx, gy = C.tile_grid(w, (rows, cols))
    r = w - 2 * H
    by, bx = torch.meshgrid(torch.arange(gy), torch.arange(gx), indexing="ij")
    by, bx = by.reshape(-1), bx.reshape(-1)
    ri = (by[:, None] * r + torch.arange(w) - H).clamp(0, rows - 1)
    ci = (bx[:, None] * r + torch.arange(w) - H).clamp(0, cols - 1)
    n = len(by)
    win = [a[ri[:, :, None], ci[:, None, :]] for a in f]  # (n, w, w)

    def sweep(axis, fields, dt, fold):
        if axis is Axis.X:   # n windows' rows, one below the other
            flat = [a.reshape(n * w, w) for a in fields]
        else:                # n windows' columns, side by side
            flat = [a.permute(1, 0, 2).reshape(w, n * w) for a in fields]
        out = K.sweep_plain(cfg, axis, *flat, dt, (None, None), fold=fold)
        if axis is Axis.X:
            return [a.reshape(n, w, w) for a in out]
        return [a.reshape(w, n, w).permute(1, 0, 2) for a in out]

    a1, d1, a2, d2 = ((Axis.X, dtx, Axis.Y, dty) if x_first
                      else (Axis.Y, dty, Axis.X, dtx))
    f1, f2 = pair_folds(cfg, "cpu", a1)
    o = sweep(a2, sweep(a1, win, d1, f1)[:4], d2, f2)
    out = [torch.full_like(f[0], float("nan")) for _ in range(6)]
    for t in range(n):
        r0, c0 = int(by[t]) * r, int(bx[t]) * r
        h, wd = min(r, rows - r0), min(r, cols - c0)
        for k in range(6):
            out[k][r0:r0 + h, c0:c0 + wd] = o[k][t, H:H + h, H:H + wd]
    return out


# (name, N, dtype): ragged edges, the wide strip 12 x 3200 and the thin
# grid 504 x 128 (the largest f32 grids the routing admits), f64.
K5_WINDOW_CASES = [
    ("ragged", (200, 260), "float32"),
    ("wide-12x3200", (3192, 4), "float32"),
    ("thin-504x128", (120, 496), "float32"),
    ("ragged-f64", (90, 130), "float64"),
]


@pytest.mark.parametrize("window", [C.MULTI_SMALL, C.MULTI_LARGE],
                         ids=["w16", "w32"])
@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
@pytest.mark.parametrize("name,N,dtype", K5_WINDOW_CASES,
                         ids=[c[0] for c in K5_WINDOW_CASES])
def test_k5_windows_stitch_to_cycle_plain(name, N, dtype, x_first, window):
    """The tile geometries and halo depth K5 relies on, each window the
    chooser can pick: two sweeps on each tile's window alone, without
    refilling, give at the tiles' centres what `cycle_plain` gives on the
    whole array, bit for bit on real cells (fields, p, and the CFL
    maxima over the tiles' real cells)."""
    params = armon_torch.ArmonParameters(
        device="cpu", test="Sod_circ", N=N, data_type=dtype, maxcycle=3,
        silent=5, **PER_SWEEP)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg)(fs, 0.0, 0, 0.0, float(seed))
    src = tuple(res.carry[:4])
    dt = torch.tensor(0.5 * res.dt_last, dtype=src[0].dtype)
    dtx, dty = (dt * 0.5, dt) if x_first else (dt, dt * 0.5)
    got = _k5_windows(cfg, x_first, src, dtx, dty, window)
    ref = cycle_plain(cfg, x_first, *src, dtx, dty)
    r = real_slice(cfg)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a[r], b[r]), name
    mx, my = K.cfl_partial_plain(cfg, got[1], got[2], got[5])
    assert torch.equal(mx, ref[5]) and torch.equal(my, ref[6])


def _k5_capacity(window, dtype):
    """The tiles of K5's `window` the card holds at once by the design:
    132 SMs x the blocks per SM its launch bounds state."""
    return C.MULTI_SMS * C.MULTI_MINB[(window, np.dtype(dtype).itemsize)]


def _k5_extreme(N, dtype, **extra):
    return armon_torch.ArmonParameters(device="cpu", test="Sod", N=N,
                                       data_type=dtype, silent=5,
                                       **extra).config


# The admitted extremes of `multicycle_geom_ok`: `chip_smoke.py`'s K5
# grids, and the grids with the most tiles of each window the chooser
# takes (`test_multi_tile_worst_case`): the small windows at the card's
# full capacity (352 x 72 padded in f32: 396 tiles of 8 x 8; 192 x 88 in
# f64: 264) and the large ones at their most (8 x 4096 in f32, nghost 2:
# 171 tiles of 24 x 24; 9 x 1920 in f64: 80).
G2 = dict(nghost=2, scheme="Godunov", projection="euler")
K5_EXTREMES = [
    ((100, 100), "float32", {}), ((120, 496), "float32", {}),
    ((240, 240), "float32", {}), ((3192, 4), "float32", {}),
    ((120, 120), "float64", {}), ((120, 240), "float64", {}),
    ((64, 344), "float32", {}), ((80, 184), "float64", {}),
    ((4092, 4), "float32", G2), ((1916, 5), "float64", G2),
]
@pytest.mark.parametrize("N,dtype,extra", K5_EXTREMES,
                         ids=[f"{c[1]}-{c[0][0]}x{c[0][1]}" for c in K5_EXTREMES])
def test_multi_tile_fits_the_card(N, dtype, extra):
    """At every admitted extreme, K5's chosen windows make no more tiles
    than the card holds co-resident (132 SMs x the blocks per SM the
    design states), and the partials K5 writes match that geometry."""
    cfg = _k5_extreme(N, dtype, **extra)
    shape = cfg.local_shape
    assert routing.multicycle_geom_ok(cfg, shape)
    w = C.multi_tile(shape, cfg.dtype)
    gx, gy = C.tile_grid(w, shape)
    assert gx * gy <= _k5_capacity(w, cfg.dtype)
    assert C.multi_partials(shape, "cuda", cfg.dtype) == gx * gy
    assert C.multi_partials(shape, "cpu", cfg.dtype) == 1
    part = C.new_multicycle_partials(shape, cfg.dtype, "cpu")
    assert tuple(part.shape) == (2, 2, 1 + C.MULTI_BAR_COLS)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_multi_tile_worst_case(dtype):
    """Over every padded row count the 256 KiB cap admits, at every
    admitted column count within 128 of its widest (a window's tile count
    grows with the columns, and the chooser moves to the large windows as
    they grow), the chosen windows fit the card; each window's worst case
    is one of K5_EXTREMES."""
    size = np.dtype(dtype).itemsize
    worst = {C.MULTI_SMALL: (0, None), C.MULTI_LARGE: (0, None)}
    for rows in range(8, 256 * 1024 // (size * 128) - 7):
        widest = 256 * 1024 // size // (rows + 8) // 128 * 128
        for cols in range(max(1, widest - 127), widest + 1):
            w = C.multi_tile((rows, cols), dtype)
            gx, gy = C.tile_grid(w, (rows, cols))
            assert gx * gy <= _k5_capacity(w, dtype), (rows, cols)
            worst[w] = max(worst[w], (gx * gy, (rows, cols)))
    assert worst == {4: {16: (396, (352, 72)), 32: (171, (8, 4096))},
                     8: {16: (264, (192, 88)), 32: (80, (9, 1920))}}[size]
    shapes = [_k5_extreme(N, d, **x).local_shape for N, d, x in K5_EXTREMES
              if d == dtype]
    assert all(shape in shapes for _, shape in worst.values())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("splitting", ["Sequential", "Godunov", "Strang"])
def test_pair_route_equals_per_sweep_bitwise(splitting, dtype):
    out = []
    for route in (PER_SWEEP, PAIR):
        params = armon_torch.ArmonParameters(
            device="cpu", test="Bizarrium" if splitting == "Strang" else
            "Sod_circ", N=(48, 40), data_type=dtype, maxcycle=15,
            axis_splitting=splitting, silent=5, **route)
        [fs], seed = make_init_fused(params)()
        out.append(make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0,
                                                      float(seed)))
    a, b = out
    assert (a.t, a.cycles, a.dt_last, a.lm, a.ok) == \
        (b.t, b.cycles, b.dt_last, b.lm, b.ok)
    for x, y in zip(a.carry, b.carry):
        assert torch.equal(x[G:-G, G:-G], y[G:-G, G:-G])


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("test", ["Sod", "Sod_y", "Sod_circ"])
def test_pair_route_goldens(test, dtype):
    """Zero differences at the golden ladder through the pair route."""
    params = armon_torch.ArmonParameters(
        data_type=dtype, test=test, scheme="GAD", projection="euler_2nd",
        riemann_limiter="minmod", nghost=4, N=(100, 100), maxcycle=1000,
        silent=5, measure_time=False, device="cpu", return_data=True, **PAIR)
    assert routing.route(params.config) == "pair"
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
def test_pair_route_golden_sedov(dtype):
    """Sedov at the golden ladder through the pair route, at the JAX
    package's gates (`tests/test_convergence.py:50-75`): zero differences
    in f64, which the cross-sweep EOS fold gives (`ops/eos.folds`, ROADMAP
    C2); in f32 at most 1500, each under 1e-4."""
    params = armon_torch.ArmonParameters(
        data_type=dtype, test="Sedov", scheme="GAD", projection="euler_2nd",
        riemann_limiter="minmod", nghost=4, N=(100, 100), maxcycle=1000,
        silent=5, measure_time=False, device="cpu", return_data=True, **PAIR)
    assert routing.route(params.config) == "pair"
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


def test_pair_route_stop_check_interval_is_bitwise_neutral():
    params = armon_torch.ArmonParameters(device="cpu", test="Sod_circ",
                                         N=(32, 32), axis_splitting="Strang",
                                         silent=5, **PAIR)
    res = []
    for every in (1, 8):
        [fs], seed = make_init_fused(params)()
        res.append(make_time_loop_lean(params.config)(
            fs, 0.0, 0, 0.0, float(seed), check_every=every))
    r1, r8 = res
    assert r1.cycles % 8 != 0 and r8.host_reads < r1.host_reads
    assert r1[1:6] == r8[1:6]
    for a, b in zip(r1.carry, r8.carry):
        assert torch.equal(a, b)


def test_pair_route_divergence_aborts():
    """cfl=3 blows the run up; the ok gate stops it with the time error
    (`tests/test_pallas.py:372-386`)."""
    params = armon_torch.ArmonParameters(
        device="cpu", test="Sod", N=(64, 64), data_type=np.float64,
        scheme="GAD", projection="euler_2nd", riemann_limiter="minmod",
        nghost=4, maxcycle=200, silent=5, measure_time=False, cfl=3.0, **PAIR)
    assert routing.route(params.config) == "pair"
    with pytest.raises(armon_torch.SolverException, match="time"):
        armon_torch.armon(params)
