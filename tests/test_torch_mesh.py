"""Domain-decomposed runs of the port (P != (1, 1), every shard on the CPU,
the kernels' plain versions) against its own one-device run and against
the JAX package's mesh on the virtual 8-device CPU mesh of conftest.

Tolerances: within the port, exact IEEE arithmetic on every shard, so bit
for bit against the one-device run, uneven and sharded-X splits included.
Against the JAX package as in `test_torch_sweep.py` and
`test_torch_slice.py`: XLA contracts multiply-adds in its jitted programs,
so one sweep agrees within 1e-14 of each field's scale and 20 cycles
within 1e-13. Copies (halo slabs, gather) are exact.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as PS

from conftest import reference_params, ref_file, abs_tol, rel_tol

import armon_tpu
from armon_tpu.core import step as jstep
from armon_tpu.core.solver import (make_init, gather_state as jax_gather,
                                   _mesh_and_specs)
from armon_tpu.io.output import read_reference_csv, compare_states
from armon_tpu.ops.pallas.sweep import fused_sweep_ip, fused_cycle
from armon_tpu.parallel import halo as jhalo
import armon_torch
from armon_torch import SolverException
from armon_torch.core.solver import make_init_fused, make_mesh
from armon_torch.core.state import FusedCarry
from armon_torch.core.step import make_time_loop_lean
from armon_torch.interop import (to_numpy, shards_from_blocked, gather_state,
                                 scatter_state)
from armon_torch.ops import routing
from armon_torch.params import KERNEL_INIT_PEAK_FIELDS, OP_PATH_PEAK_FIELDS
from armon_torch.ops import sweep as K
from armon_torch.ops.cycle import cycle_plain
from armon_torch.ops.reductions import real_slice
from armon_torch.parallel import halo
from armon_torch.parallel.mesh import Mesh
from armon_torch.utils.enums import Axis

G = 4
FIELDS = ("rho", "u", "v", "E", "p")
EXCHANGED = ("rho", "u", "v", "E")


def _jparams(test, **opts):
    return reference_params(test, np.float64, **opts)


def _tparams(P, **opts):
    kw = dict(test="Sod_circ", N=(100, 100), silent=5, device="cpu", P=P)
    kw.update(opts)
    return armon_torch.ArmonParameters(**kw)


# ---------------------------------------------------------------- front-end

@pytest.mark.parametrize("N,P", [((100, 100), (3, 2)), ((100, 99), (3, 2)),
                                 ((64, 48), (1, 4))])
def test_split_matches_jax(N, P):
    jp = armon_tpu.ArmonParameters(test="Sod", N=N, P=P)
    tp = _tparams(P, test="Sod", N=N)
    assert (tp.n_local, tp.n_edge) == (jp.n_local, jp.n_edge)
    jc, tc = jp.config, tp.config
    assert (tc.proc_dims, tc.spmd, tc.edge_cells, tc.local_shape) == \
        (jc.proc_dims, jc.spmd, jc.edge_cells, jc.local_shape)
    for axis in (0, 1):
        assert tc.uneven(axis) == jc.uneven(axis)


@pytest.mark.parametrize("N,P", [((9, 9), (4, 1)), ((20, 10), (1, 3))])
def test_too_small_split_raises_in_both(N, P):
    with pytest.raises(Exception):
        armon_tpu.ArmonParameters(test="Sod", N=N, P=P).config
    with pytest.raises(SolverException, match="too small"):
        _tparams(P, N=N)


def test_device_placement(monkeypatch):
    p = _tparams((2, 2))
    assert p.devices == (torch.device("cpu"),) * 4 and p.device.type == "cpu"
    p = _tparams((2, 1), devices=["cpu", "cpu", "cpu"])
    assert len(p.devices) == 2
    with pytest.raises(SolverException, match="needs 4 devices"):
        _tparams((2, 2), devices=["cpu"] * 3)
    # The multi-process options are taken (without a coordinator, the run
    # is one process, as in the JAX package); `global_comm` has no effect.
    for key, val in (("num_processes", 2), ("process_id", 0),
                     ("global_comm", object())):
        p = _tparams((2, 2), **{key: val})
        assert (p.process_count, p.devices, p.use_MPI) == \
            (1, (torch.device("cpu"),) * 4, False)
    assert _tparams((2, 2), num_processes=2).num_processes == 2
    # The shard count must be a multiple of the process count.
    with pytest.raises(SolverException, match="not a multiple"):
        Mesh(_tparams((2, 2)).config, ["cpu"], 0, 3)
    # Over several processes (a stand-in for two: process 1 of 2), each
    # drives a contiguous block of shards and `use_MPI` is forced.
    from armon_torch.parallel import dist
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    monkeypatch.setattr(dist, "barrier", lambda name, device=None: None)
    p = _tparams((2, 2))
    assert (p.process_count, p.process_index, p.use_MPI) == (2, 1, True)
    assert p.devices == (torch.device("cpu"),) * 2
    mesh = Mesh.of(p)
    assert [s.index for s in mesh.local] == [2, 3]
    assert [(s.rank, s.slot, s.device) for s in mesh] == \
        [(0, None, None)] * 2 + [(1, 0, p.device), (1, 1, p.device)]
    with pytest.raises(SolverException, match="not a multiple"):
        _tparams((3, 1), N=(100, 100))
    with pytest.raises(SolverException, match="needs 2 devices a process"):
        _tparams((2, 2), devices=["cpu"])
    # The CUDA rules, with a stand-in for cards this machine does not have.
    import armon_torch.params as tparams_mod
    monkeypatch.setattr(tparams_mod, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    # Process 1 of 2 puts its 2 shards on the cards after process 0's.
    p = _tparams((2, 2), device="cuda")
    assert p.devices == (torch.device("cuda", 2), torch.device("cuda", 3))
    # Two processes on one card: not over NCCL, over gloo they may.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SolverException, match="gpu_aware=False"):
        _tparams((2, 2), device="cuda")
    with pytest.raises(SolverException, match="gpu_aware=False"):
        _tparams((2, 2), device="cuda", devices=["cuda:0"] * 2)
    p = _tparams((2, 2), device="cuda", gpu_aware=False)
    assert p.devices == (torch.device("cuda", 0),) * 2
    monkeypatch.setattr(dist, "process_count", lambda: 1)
    monkeypatch.setattr(dist, "process_index", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(SolverException, match="needs 4 CUDA cards"):
        _tparams((2, 2), device="cuda")
    p = _tparams((2, 1), device="cuda")
    assert p.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    p = _tparams((2, 2), device="cuda", devices=["cuda"] * 4)
    assert p.devices == (torch.device("cuda", 0),) * 4
    with pytest.raises(SolverException, match="mix"):
        _tparams((2, 2), devices=["cpu", "cuda:0", "cpu", "cpu"])


def test_memory_counts_shards_and_slabs():
    p = _tparams((2, 2), N=(100, 60), data_type="float32")
    mem = p.memory_required()
    rows, cols = 30 + 8, 50 + 8
    field = rows * cols * 4
    slabs = 4 * (rows * 4 + 4 * cols) * 4  # one X and one Y side per shard
    assert mem["per_device_field_bytes"] == field
    assert mem["per_device_loop_bytes"] == 4 * (9 * field + slabs)
    # one CPU device: the kernel path's 4 shards and one (2, 4) CFL
    # partials buffer, which the program cache keeps, beside the last
    # shard's initialisation and the earlier shards' carries; the op
    # path's 4 x 22 fields and one shard's sweep temporaries
    assert mem["fused_total_bytes"] == 4 * (9 * field + slabs) + 2 * 4 * 4 \
        + (5 * 3 + KERNEL_INIT_PEAK_FIELDS) * field
    assert mem["total_bytes"] == (4 * 22 + OP_PATH_PEAK_FIELDS - 22) * field


def test_routing_on_meshes_matches_jax():
    for N in ((100, 100), (2000, 2000), (4096, 1000)):
        for P in ((1, 1), (2, 1), (1, 2), (2, 2), (3, 2), (1, 4)):
            for threshold in (0, 2048):
                for tb in (1, 8):
                    kw = dict(test="Sod", N=N, P=P, pair_threshold=threshold,
                              temporal_blocking=tb)
                    jcfg = armon_tpu.ArmonParameters(kernel_tier="pallas",
                                                     **kw).config
                    tcfg = _tparams(**kw).config
                    key = (N, P, threshold, tb)
                    assert routing.pair_routing_on(tcfg) == \
                        jstep.pair_routing_on(jcfg), key
                    assert routing.temporal_pairs(tcfg) == \
                        jstep.temporal_pairs(jcfg), key


# --------------------------------------------------------------------- halo

def _jax_state(params):
    return make_init(params)()


def _shards_of(tp, jstate, names=FIELDS):
    return shards_from_blocked(tp, {n: np.asarray(getattr(jstate, n))
                                    for n in names})


def test_halo_exchange_debug_indexes():
    """After one exchange on a 2x2 mesh every interior-facing ghost holds
    its neighbour's global linear index (`tests/test_mesh.py:78-140`), and
    the port's exchange equals the JAX package's under `shard_map`."""
    opts = dict(test="DebugIndexes", N=(16, 16), P=(2, 2), maxcycle=0)
    jp = _jparams(**opts)
    tp = _tparams(**opts)
    cfg = tp.config
    lr, lc = cfg.local_shape
    mask = np.ones((lr, lc), bool)
    mask[G:-G, G:-G] = False
    full = np.tile(mask, (2, 2))
    poisoned = {}
    for n in EXCHANGED:
        a = np.asarray(getattr(_jax_state(jp), n)).copy()
        a[full] = -1.0
        poisoned[n] = a
    mesh = make_mesh(tp)
    fields = [tuple(s[:4]) for s in shards_from_blocked(tp, {**poisoned, "p": poisoned["rho"]})]
    for axis in (Axis.X, Axis.Y):
        fields = halo.halo_exchange(cfg, mesh, fields, axis)

    jmesh, state_spec, _ = _mesh_and_specs(jp)
    from jax.sharding import NamedSharding
    sharding = NamedSharding(jmesh, PS("py", "px"))
    jstate = _jax_state(jp)._replace(**{n: jax.device_put(poisoned[n], sharding)
                                        for n in EXCHANGED})

    def ex(s):
        s = jhalo.halo_exchange(jp.config, s, armon_tpu.Axis.X, EXCHANGED)
        return jhalo.halo_exchange(jp.config, s, armon_tpu.Axis.Y, EXCHANGED)

    jout = jax.jit(jax.shard_map(ex, mesh=jmesh, in_specs=(state_spec,),
                                 out_specs=state_spec, check_vma=False))(jstate)
    nx, ny = cfg.n_global
    for s in mesh:
        rho = to_numpy(fields[s.index][0])
        for jj, ii in [(0, lc // 2), (lr - 1, lc // 2), (lr // 2, 0), (lr // 2, lc - 1)]:
            gj, gi = s.global_pos[1] + jj - G, s.global_pos[0] + ii - G
            if 0 <= gj < ny and 0 <= gi < nx:
                assert rho[jj, ii] == gi + gj * nx + 1, (s, jj, ii)
        for k, n in enumerate(EXCHANGED):
            want = np.asarray(getattr(jout, n)).reshape(2, lr, 2, lc)[s.iy, :, s.ix, :]
            assert np.array_equal(to_numpy(fields[s.index][k]), want), (s, n)


@pytest.mark.parametrize("P,N", [((2, 2), (40, 40)), ((3, 2), (50, 49))])
def test_slabs_match_jax(P, N):
    """`ghost_slabs` equals the JAX package's `_ghost_slabs` content on every
    side (mirror at global borders), and `halo_slabs` equals JAX's
    `halo_slabs` on the sides that face a neighbour."""
    opts = dict(test="Sod_circ", N=N, P=P)
    jp = _jparams(**opts)
    tp = _tparams(**opts)
    cfg = tp.config
    jstate = _jax_state(jp)
    mesh = make_mesh(tp)
    fields = [tuple(s[:4]) for s in _shards_of(tp, jstate)]
    jmesh, state_spec, _ = _mesh_and_specs(jp)
    for axis in (Axis.X, Axis.Y):
        jaxis = armon_tpu.Axis(int(axis))

        def slabs(s):
            arrs = [getattr(s, n) for n in EXCHANGED]
            lo, hi, _ = jhalo._ghost_slabs(jp.config, arrs, jaxis, EXCHANGED)
            return lo, hi

        spec = PS(None, "py", "px")
        jlo, jhi = jax.jit(jax.shard_map(slabs, mesh=jmesh, in_specs=(state_spec,),
                                         out_specs=(spec, spec),
                                         check_vma=False))(jstate)
        ours = halo.halo_slabs(cfg, mesh, fields, axis)
        for s in mesh:
            mine = halo.ghost_slabs(cfg, mesh, fields, s, axis)
            for side, j in enumerate((jlo, jhi)):
                j = np.asarray(j)
                h, w = j.shape[1] // P[1], j.shape[2] // P[0]
                want = j[:, s.iy * h:(s.iy + 1) * h, s.ix * w:(s.ix + 1) * w]
                assert np.array_equal(to_numpy(mine[side]), want), (axis, s, side)
                if mesh.neighbour(s, axis, side) is None:
                    assert ours[s.index][side] == K.MIRROR
                else:
                    assert np.array_equal(to_numpy(ours[s.index][side]), want)


# --------------------------------------------------------------- per kernel

def _mid_run(tp, cycles=3):
    """The port's mesh carry after `cycles` cycles and the dt of the next."""
    mesh = make_mesh(tp)
    fs, seed = make_init_fused(tp)()
    res = make_time_loop_lean(tp.config, mesh)(fs, 0.0, 0, 0.0, float(seed))
    return mesh, res, 0.5 * res.dt_last


def _close_to(a, b, rel):
    scale = max(1.0, float(np.max(np.abs(a))))
    d = float(np.max(np.abs(a - b)))
    assert d <= rel * scale, (d, rel * scale)


@pytest.mark.parametrize("P", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_slab_sweeps_match_jax_pallas(P):
    """One shard's X and Y sweeps with slab ghosts (plain versions) against
    `fused_sweep_ip(..., slab=...)` in interpret mode, f64: within 1e-14
    of each field's scale on the shard's real cells. Both the port's mesh
    form (mirror on a global border, slab facing a neighbour) and the JAX
    form (the mirror delivered in the slab) are checked."""
    opts = dict(test="Sod_circ", N=(48, 48), P=P, data_type=np.float64)
    tp = _tparams(**opts)
    jp = armon_tpu.ArmonParameters(**opts)
    cfg, jcfg = tp.config, jp.config
    mesh, res, dt = _mid_run(tp)
    cur = [tuple(c[:4]) for c in res.carry]
    s = mesh.shards[-1]
    r = real_slice(cfg, s.n_real)
    for axis in (Axis.X, Axis.Y):
        if P[int(axis)] == 1:
            continue
        ghosts = halo.halo_slabs(cfg, mesh, cur, axis)[s.index]
        both = halo.ghost_slabs(cfg, mesh, cur, s, axis)
        dt_t = torch.tensor(dt, dtype=torch.float64)
        outs = [K.sweep_plain(cfg, axis, *cur[s.index], dt_t, gh, s.n_real)
                for gh in (ghosts, both)]
        jout = fused_sweep_ip(jcfg, armon_tpu.Axis(int(axis)),
                              *(to_numpy(a) for a in cur[s.index]), dt,
                              n_real=np.asarray(s.n_real, np.int32),
                              interpret=True,
                              slab=tuple(to_numpy(b) for b in both))
        for k in range(5):
            a = np.asarray(jout[k])[r]
            for out in outs:
                _close_to(a, to_numpy(out[k])[r], 1e-14)
        assert torch.equal(outs[0][0][r], outs[1][0][r])


@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
def test_slab_cycle_matches_jax_pallas(x_first):
    """One shard of a 1x2 mesh through the pair kernel's plain version with
    Y slabs (X mirror after the splice) against `fused_cycle(...,
    slab=...)` in interpret mode, f64, within 1e-14 of field scale."""
    opts = dict(test="Sod_circ", N=(48, 48), P=(1, 2), data_type=np.float64)
    tp = _tparams(**opts)
    jp = armon_tpu.ArmonParameters(**opts)
    cfg, jcfg = tp.config, jp.config
    mesh, res, dt = _mid_run(tp)
    cur = [tuple(c[:4]) for c in res.carry]
    for s in mesh:
        r = real_slice(cfg, s.n_real)
        ghosts = halo.halo_slabs(cfg, mesh, cur, Axis.Y)[s.index]
        both = halo.ghost_slabs(cfg, mesh, cur, s, Axis.Y)
        dtx, dty = (0.5 * dt, dt) if x_first else (dt, 0.5 * dt)
        ref = cycle_plain(cfg, x_first, *cur[s.index],
                          torch.tensor(dtx, dtype=torch.float64),
                          torch.tensor(dty, dtype=torch.float64), ghosts, s.n_real)
        jout = fused_cycle(jcfg, x_first, *(to_numpy(a) for a in cur[s.index]),
                           dtx, dty, n_real=np.asarray(s.n_real, np.int32),
                           in_place=True, interpret=True, inline_bc_x=True,
                           slab=tuple(to_numpy(b) for b in both))
        for k in range(5):
            _close_to(np.asarray(jout[k])[r], to_numpy(ref[k])[r], 1e-14)


# ---------------------------------------------------------------- the slice

_SINGLE = {}


def _run(P, **opts):
    kw = dict(maxcycle=20, return_data=True)
    kw.update(opts)
    return armon_torch.armon(_tparams(P, **kw))


def _single(**opts):
    key = tuple(sorted((k, str(v)) for k, v in opts.items()))
    if key not in _SINGLE:
        _SINGLE[key] = _run((1, 1), **opts)
    return _SINGLE[key]


def _assert_bitwise(a, b):
    assert (a.cycles, a.final_time, a.last_dt) == (b.cycles, b.final_time, b.last_dt)
    for name in FIELDS:
        x, y = getattr(a.data, name), getattr(b.data, name)
        assert torch.equal(x[G:-G, G:-G], y[G:-G, G:-G]), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("P,N", [((1, 2), (100, 100)), ((2, 1), (100, 100)),
                                 ((2, 2), (100, 100)), ((4, 1), (100, 100)),
                                 ((3, 2), (100, 100)), ((3, 2), (100, 99))],
                         ids=["1x2", "2x1", "2x2", "4x1", "3x2", "3x2-100x99"])
def test_mesh_equals_single_device(P, N, dtype):
    _assert_bitwise(_run(P, N=N, data_type=dtype),
                    _single(N=N, data_type=dtype))


@pytest.mark.parametrize("test", ["Sedov", "Bizarrium"])
def test_mesh_equals_single_device_sedov_bizarrium(test):
    _assert_bitwise(_run((2, 2), test=test), _single(test=test))


def test_mesh_matches_jax_mesh():
    """The port's 2x2 mesh against the JAX package's 2x2 mesh (its default
    tier on the CPU), 20 cycles of Sod_circ f64."""
    opts = dict(test="Sod_circ", N=(100, 100), P=(2, 2), data_type=np.float64,
                maxcycle=20, silent=5, measure_time=False, return_data=True)
    jp = armon_tpu.ArmonParameters(**opts)
    js = armon_tpu.armon(jp)
    jdata = jax_gather(jp, js.data)
    ts = armon_torch.armon(armon_torch.ArmonParameters(device="cpu", **opts))
    eps = np.finfo(np.float64).eps
    assert ts.cycles == js.cycles
    assert abs(ts.last_dt - js.last_dt) <= 4 * eps * abs(js.last_dt)
    data = to_numpy(ts.data)
    for name in FIELDS:
        a = np.asarray(getattr(jdata, name))[G:-G, G:-G]
        _close_to(a, getattr(data, name)[G:-G, G:-G], 1e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("test", ["Sod", "Sod_y", "Sod_circ"])
def test_mesh_goldens(test, dtype):
    """Zero differences at the golden ladder through a 2x2 mesh."""
    params = _tparams((2, 2), data_type=dtype, test=test, scheme="GAD",
                      projection="euler_2nd", riemann_limiter="minmod",
                      nghost=4, maxcycle=1000, measure_time=False,
                      return_data=True)
    stats = armon_torch.armon(params)
    jcfg = reference_params(test, dtype).config
    ref_dt, ref_cycles, ref = read_reference_csv(jcfg, ref_file(test, dtype))
    atol, rtol = abs_tol(dtype), rel_tol(dtype)
    assert stats.cycles == ref_cycles
    cnt, max_diff, details = compare_states(jcfg, to_numpy(stats.data), ref,
                                            atol=atol, rtol=rtol)
    assert cnt == 0 and max_diff == 0, details


def test_poisoned_ghosts_and_slack_never_reach_real_cells():
    """1e100 in every cell outside each shard's real window (ghost bands,
    corners, an edge shard's slack) changes nothing
    (`tests/test_mesh.py:167-219`)."""
    opts = dict(N=(100, 99), maxcycle=15)
    tp = _tparams((3, 2), **opts)
    cfg = tp.config
    mesh = make_mesh(tp)
    fs, seed = make_init_fused(tp)()
    poisoned = []
    for s, f in zip(mesh, fs):
        r = real_slice(cfg, s.n_real)
        out = []
        for a in f:
            b = torch.full_like(a, 1e100)
            b[r] = a[r]
            out.append(b)
        poisoned.append(FusedCarry(*out))
    res = make_time_loop_lean(cfg, mesh)(poisoned, 0.0, 0, 0.0, float(seed))
    ref = _single(N=(100, 99), maxcycle=15, return_data=True)
    assert res.ok and res.cycles == ref.cycles and res.dt_last == ref.last_dt
    state = gather_state(tp, res.carry)
    for name in ("rho", "u", "v", "E"):
        assert torch.equal(getattr(state, name)[G:-G, G:-G],
                           getattr(ref.data, name)[G:-G, G:-G]), name


def test_nan_in_one_shard_stops_the_run():
    """A NaN in one shard's real cell stops the mesh run at the cycle the
    one-device run stops with the same NaN (`pmin_dt`'s NaN -> 0 gate)."""
    out = []
    for P in ((1, 1), (2, 2)):
        tp = _tparams(P, N=(64, 64), maxcycle=50, pair_threshold=0,
                      temporal_blocking=1)
        mesh = make_mesh(tp)
        fs, seed = make_init_fused(tp)()
        gx, gy = 40, 10  # a cell of the shard at (1, 0) on the mesh
        for s, f in zip(mesh, fs):
            (ox, oy), (nx, ny) = s.global_pos, s.n_real
            if ox <= gx < ox + nx and oy <= gy < oy + ny:
                f.rho[G + gy - oy, G + gx - ox] = float("nan")
        out.append(make_time_loop_lean(tp.config, mesh)(
            fs, 0.0, 0, 0.0, float(seed)))
    assert not out[0].ok and not out[1].ok
    assert out[0].cycles == out[1].cycles


# ------------------------------------------------------------------ interop

@pytest.mark.parametrize("P,N", [((2, 2), (40, 40)), ((3, 2), (50, 49))])
def test_blocked_shards_gather_match_jax(P, N):
    """JAX mesh state (blocked arrays) -> the port's shards -> gathered
    global grid equals the JAX package's `gather_state`; scattering the
    gathered grid back gives every shard's real and ghost window again."""
    opts = dict(test="Sod_circ", N=N, P=P)
    jp = _jparams(**opts)
    tp = _tparams(**opts)
    jstate = _jax_state(jp)
    shards = _shards_of(tp, jstate)
    ours = gather_state(tp, shards)
    want = jax_gather(jp, jstate)
    for name in FIELDS:
        assert np.array_equal(to_numpy(getattr(ours, name)),
                              np.asarray(getattr(want, name))), name
    back = scatter_state(tp, ours)
    cfg = tp.config
    for s, a, b in zip(make_mesh(tp), back, shards):
        r = real_slice(cfg, s.n_real)
        for x, y in zip(a, b):
            assert torch.equal(x[r], y[r])
    again = gather_state(tp, back)
    for x, y in zip(again, ours):
        assert torch.equal(x, y)
