"""One sweep of the port (the kernels' plain versions, CPU) against the JAX
package's Pallas sweep kernel in interpret mode, on the same state (the
counterpart of `tests/test_pallas.py:48-93`); and the geometry the card's
K1/K2 kernels cut a sweep into (segments with their halos, per-block CFL
partials, grid limits) against the whole-array plain sweep, bit for bit.

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
from armon_torch.core.solver import make_init_fused, make_mesh
from armon_torch.core.step import make_time_loop_lean
from armon_torch.ops import sweep as K
from armon_torch.ops.reductions import real_slice
from armon_torch.parallel.halo import halo_slabs
from armon_torch.utils.enums import Axis

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


# ----------------------------------------------------- K1/K2 thread mapping

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)


def _mid_run(test, N, dtype, P=None):
    """(cfg, mesh, per-shard rho/u/v/E, dt) after 3 per-sweep cycles."""
    params = armon_torch.ArmonParameters(
        device="cpu", test=test, N=N, data_type=dtype, maxcycle=3, silent=5,
        **PER_SWEEP, **({"P": P} if P else {}))
    cfg = params.config
    mesh = make_mesh(params)
    fs, seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg, mesh)(fs, 0.0, 0, 0.0, float(seed))
    cur = [tuple(c[:4]) for c in res.carry]
    return cfg, mesh, cur, torch.tensor(0.5 * res.dt_last, dtype=cur[0][0].dtype)


def _segments_stitched(cfg, axis, src, dt, ghosts, n_real):
    """A sweep cut as K1 / K2 cut it (`K.segments`): the ghost-filled
    array read at each segment with HALO more positions on each side
    (clamped to the array, as the kernels' loads are), `sweep_plain` on
    that alone without refilling, and the segment's own positions written
    back. Returns (rho, u, v, E, p, c); positions no segment covers stay
    NaN."""
    H = K.HALO
    if any(K.ghost_mode(s) for s in ghosts):
        src = K.fill_ghosts_plain(cfg, axis, src, n_real, ghosts)
    d = axis.array_axis
    n = src[0].shape[d]
    step, nseg = K.segments(axis, src[0].shape)
    out = [torch.full_like(src[0], float("nan")) for _ in range(6)]
    for s in range(nseg):
        k0 = s * step
        idx = (torch.arange(step + 2 * H) + k0 - H).clamp(0, n - 1)
        o = K.sweep_plain(cfg, axis, *(a.index_select(d, idx) for a in src), dt,
                          (None, None))
        m = min(step, n - k0)
        for a, b in zip(out, o):
            a.narrow(d, k0, m).copy_(b.narrow(d, H, m))
    return out


STITCH_CASES = [
    ("ragged-f32", (300, 270), "float32", None, None),   # 3 x 3 segments
    ("ragged-f64", (261, 300), "float64", None, None),
    ("40x2", (40, 2), "float64", None, None),           # thinner than the band
    ("2x40", (2, 40), "float32", None, None),
    ("slab-1x3", (150, 300), "float32", (1, 3), None),   # Y slabs, every shard
    ("slab-3x1", (300, 150), "float64", (3, 1), None),   # X slabs, every shard
    ("none-mirror", (130, 140), "float64", None, (None, K.MIRROR)),
]


@pytest.mark.parametrize("axis", [Axis.X, Axis.Y], ids=["x", "y"])
@pytest.mark.parametrize("name,N,dtype,P,ghosts", STITCH_CASES,
                         ids=[c[0] for c in STITCH_CASES])
def test_sweep_segments_stitch_to_sweep_plain(name, N, dtype, P, ghosts, axis):
    """The segment geometry and halo depth K1 and K2 rely on: each
    segment swept alone, with HALO more positions read on each side, gives
    what `sweep_plain` gives on the whole array, bit for bit on real cells
    (c included); on ragged edges, grids thinner than the ghost band, every
    shard of a 1x3 and a 3x1 mesh (slab on the sides facing a neighbour,
    mirror on the others) and a band left as it is."""
    cfg, mesh, cur, dt = _mid_run("Sod_circ", N, dtype, P)
    sharded = mesh.proc_dims[axis] > 1
    sides = halo_slabs(cfg, mesh, cur, axis) if sharded else [ghosts or K.MIRRORED] * len(mesh)
    for s in mesh:
        src = cur[s.index]
        if ghosts and not sharded:  # the band left as it is: fill it first
            src = K.fill_ghosts_plain(cfg, axis, src, s.n_real)
        got = _segments_stitched(cfg, axis, src, dt, sides[s.index], s.n_real)
        ref = K.sweep_plain(cfg, axis, *src, dt, sides[s.index], s.n_real)
        r = real_slice(cfg, s.n_real)
        for a, b in zip(got, ref):
            assert torch.equal(a[r], b[r]), (name, s.index)


def _block_of_cells(axis, shape):
    """The block of a K1 / K2 launch that writes each cell of a padded
    (rows, cols) array (`sweep_blocks` in csrc/sweep.cuh)."""
    rows, cols = shape
    r = torch.arange(rows).view(-1, 1)
    c = torch.arange(cols).view(1, -1)
    step, segs = K.segments(axis, shape)
    if axis is Axis.X:
        return (r * segs + c // step) // (K.X_WARPS * K.x_windows_per_warp(shape))
    return (r // step) * -(-cols // K.Y_THREADS) + c // K.Y_THREADS


@pytest.mark.parametrize("axis", [Axis.X, Axis.Y], ids=["x", "y"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_block_partials_fold_to_single_partial(dtype, axis):
    """One CFL partial pair per K1 / K2 block (each over its real cells,
    from zero), folded by `cfl_finish_plain`, gives the scalars that the
    single whole-array partial gives, bit for bit."""
    cfg, _, (src,), dt = _mid_run("Sod_circ", (300, 270), dtype)
    out = K.sweep_plain(cfg, axis, *src, dt)
    shape = src[0].shape
    nb = K.grid_dims(axis, shape)[0]
    r = real_slice(cfg)
    block = _block_of_cells(axis, shape)[r].reshape(-1)
    assert int(block.max()) + 1 <= nb and len(block.unique()) > 1
    parts = torch.zeros((2, nb), dtype=src[0].dtype)
    for k, vel in enumerate((out[1], out[2])):
        vals = (vel.abs() + out[5])[r].reshape(-1)
        parts[k].scatter_reduce_(0, block, vals, "amax")
    single = torch.stack(K.cfl_partial_plain(cfg, out[1], out[2], out[5])).view(2, 1)
    res = []
    for p, n in ((parts, nb), (single, 1)):
        scal, iscal = K.new_scalars(cfg.dtype, "cpu", lm=1.0)
        iscal[K.IS_RUN] = 1
        K.cfl_finish_plain(cfg, p, n, scal, iscal)
        res.append((scal, iscal))
    assert torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1])


@pytest.mark.parametrize("axis", [Axis.X, Axis.Y], ids=["x", "y"])
def test_sweep_grid_within_cuda_limits(axis):
    """K1 / K2 launches fit CUDA's grid (grid_x < 2^31, grid_y 1) for
    padded shapes up to 2^20 rows and 2^20 columns, and K1 for int32 rows
    (C1: K1 once put every row on grid_y, capped at 65535); the segments
    cover every line; the card's partial count is the block count."""
    sizes = (1, 9, 128, 8200, 65535, 65536, 70008, 2 ** 20)
    shapes = [(r, c) for r in sizes for c in sizes]
    if axis is Axis.X:
        shapes.append((2 ** 31 - 1, 8))
    for shape in shapes:
        gx, gy = K.grid_dims(axis, shape)
        assert 1 <= gx <= 2 ** 31 - 1 and gy == 1, shape
        assert K.n_partials(axis, shape, "cuda") == gx
        assert K.n_partials(axis, shape, "cpu") == 1
        step, nseg = K.segments(axis, shape)
        n = shape[axis.array_axis]
        assert step * nseg >= n > step * (nseg - 1), shape
