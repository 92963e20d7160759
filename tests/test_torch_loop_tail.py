"""The lean loop's sequencing: K3's fold and dt step in the tail of each
cycle's last launch, against the sequencing it replaced.

The reference below is that earlier sequencing, kept here as a chain of
plain calls: K3 (`cfl_finish_plain`: fold the previous cycle's partials,
one dt step) before every cycle, a stop on iscal[next] every
`check_every` cycles, and a final K3 that only folds. `make_time_loop_lean`
must give the same `LoopResult` and the same fields bit for bit (exact
IEEE arithmetic on both sides: the CPU runs every kernel's plain
version), on the per-sweep and pair routes, with Sequential and Strang
splitting, at every stop condition, and on a mesh."""

import numpy as np
import pytest
import torch

import armon_torch
from armon_torch.core.solver import make_init_fused, make_mesh
from armon_torch.core.splitting import split_schedules
from armon_torch.core.step import (LoopResult, make_time_loop_lean,
                                   run_schedule_fused, _result)
from armon_torch.ops import sweep as K
from armon_torch.ops.routing import route
from armon_torch.parallel.halo import new_slab_buffers
from armon_torch.utils.enums import Axis

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)
N = (24, 20)


def _old_loop(cfg, mesh, shards, t0, cycle0, dt0, local0, check_every):
    """The earlier sequencing on the CPU (every shard's partials one
    column of `partials`)."""
    T = np.dtype(cfg.dtype).type
    even, odd = split_schedules(cfg.splitting)
    pair = route(cfg) == "pair"
    S = len(mesh)
    cur = [tuple(f[:4]) for f in shards]
    nxt = [tuple(torch.empty_like(a) for a in c) for c in cur]
    p = [f.p for f in shards]
    partials = torch.zeros((2, S), dtype=shards[0].rho.dtype)
    parts = {1: [partials[:, k:k + 1] for k in range(S)]}
    scal, iscal = K.new_scalars(cfg.dtype, "cpu", t=float(t0), cycle=int(cycle0),
                                dt_prev=float(dt0), lm=float(local0))
    slabs = {axis: new_slab_buffers(cfg, mesh, cur, axis)
             for axis in (Axis.X, Axis.Y) if mesh.proc_dims[axis] > 1}
    cycle, nb, reads = int(cycle0), 0, 0
    running = T(t0) < T(cfg.maxtime) and cycle < cfg.maxcycle
    while running:
        for _ in range(check_every):
            K.cfl_finish_plain(cfg, partials, nb, scal, iscal, fold=True, step=True)
            sched = even if cycle % 2 == 0 else odd
            cur, nxt, nb = run_schedule_fused(cfg, mesh, cur, nxt, p, parts,
                                              [(scal, iscal)] * S, sched,
                                              pair, slabs)
            nb *= S
            cycle += 1
        running = bool(iscal[K.IS_NEXT].item())
        reads += 1
    K.cfl_finish_plain(cfg, partials, nb, scal, iscal, fold=True, step=False)
    return _result(cur, p, scal, iscal, reads, False)


def _bits(a, b):
    """Equal bits (NaN payloads and signed zeros included)."""
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _same_scalar(x, y):
    return (np.isnan(x) and np.isnan(y)) or np.float64(x).tobytes() == np.float64(y).tobytes()


def _assert_same(got: LoopResult, want: LoopResult):
    assert (got.cycles, got.ok, got.host_reads) == (want.cycles, want.ok, want.host_reads)
    for name in ("t", "dt_last", "lm"):
        assert _same_scalar(getattr(got, name), getattr(want, name)), name
    for g, w in zip(got.carry, want.carry):
        for a, b in zip(g, w):
            assert _bits(a, b)


def _setup(test="Sod_circ", dtype="float64", route_opts=PER_SWEEP, P=(1, 1),
           **opts):
    params = armon_torch.ArmonParameters(
        test=test, N=N, data_type=dtype, use_fast_math=False, silent=5,
        device="cpu", P=P, **route_opts, **{"maxcycle": 11, "maxtime": 1.0, **opts})
    return params, make_mesh(params)


def _both(params, mesh, check_every, poison=None, local=None, start=(0.0, 0),
          remote=()):
    """(new loop, old sequencing) from the same initial state at (t,
    cycle) `start`; `poison` edits each run's fresh shards in place;
    `remote` goes to the new loop."""
    cfg = params.config
    out = []
    for loop in (lambda fs, *a: make_time_loop_lean(cfg, mesh, remote)(
                     fs, *a, check_every),
                 lambda fs, *a: _old_loop(cfg, mesh, fs, *a, check_every)):
        fs, seed = make_init_fused(params)()
        if poison:
            poison(fs)
        res = loop(fs, *start, 0.0, float(seed if local is None else local))
        out.append(res._replace(carry=[tuple(c) for c in (
            res.carry if isinstance(res.carry, list) else [res.carry])]))
    return out


@pytest.mark.parametrize("splitting", ["Sequential", "Strang"])
@pytest.mark.parametrize("route_opts", [PER_SWEEP, PAIR], ids=["per-sweep", "pair"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loop_matches_old_sequencing(dtype, route_opts, splitting):
    params, mesh = _setup(dtype=dtype, route_opts=route_opts,
                          axis_splitting=splitting)
    assert route(params.config) == ("pair" if route_opts is PAIR else "per_sweep")
    got, want = _both(params, mesh, 3)
    assert got.cycles == 11
    _assert_same(got, want)


@pytest.mark.parametrize("route_opts", [PER_SWEEP, PAIR], ids=["per-sweep", "pair"])
@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_stop_check_interval(check_every, route_opts):
    """The run ends by maxcycle inside or at the end of a check block."""
    params, mesh = _setup(route_opts=route_opts, maxcycle=7)
    got, want = _both(params, mesh, check_every)
    assert got.cycles == 7
    _assert_same(got, want)


@pytest.mark.parametrize("route_opts", [PER_SWEEP, PAIR], ids=["per-sweep", "pair"])
def test_stop_by_maxtime_inside_a_block(route_opts):
    params, mesh = _setup(test="Sod", route_opts=route_opts, maxcycle=100,
                          maxtime=0.05)
    got, want = _both(params, mesh, 8)
    assert 0 < got.cycles < 100 and got.cycles % 8 != 0
    assert got.t >= 0.05
    _assert_same(got, want)


@pytest.mark.parametrize("route_opts", [PER_SWEEP, PAIR], ids=["per-sweep", "pair"])
def test_stop_by_failed_dt_gate(route_opts):
    """A NaN in a field reaches the CFL partials: the dt gate fails (ok =
    0) and the run stops early; lm is NaN in both."""
    params, mesh = _setup(route_opts=route_opts, maxcycle=20)
    clean, seed = make_init_fused(params)()
    g = params.config.nghost

    def poison(fs):
        fs[0].u[g + 5, g + 7] = float("nan")

    got, want = _both(params, mesh, 3, poison, local=seed)
    assert not got.ok and got.cycles < 20 and np.isnan(got.lm)
    _assert_same(got, want)


@pytest.mark.parametrize("start", [(0.0, 11), (1.0, 0)],
                         ids=["at-maxcycle", "at-maxtime"])
def test_zero_cycles_keep_the_seed(start):
    params, mesh = _setup()
    got, want = _both(params, mesh, 8, local=0.125, start=start)
    assert got.cycles == start[1] and got.lm == 0.125 and got.host_reads == 2
    _assert_same(got, want)


@pytest.mark.parametrize("route_opts", [PER_SWEEP, PAIR], ids=["per-sweep", "pair"])
def test_mesh_tail_folds_every_shard(route_opts):
    """A 2x2 mesh on one device (pair: 1x2, the pair route's meshes are
    sharded along Y only): the last shard's last launch folds every
    shard's partials; the result equals the one-device run and the old
    sequencing on the same mesh."""
    P = (2, 2) if route_opts is PER_SWEEP else (1, 2)
    params, mesh = _setup(route_opts=route_opts, P=P)
    assert route(params.config) == ("pair" if route_opts is PAIR else "per_sweep")
    got, want = _both(params, mesh, 3)
    _assert_same(got, want)
    one, one_mesh = _setup(route_opts=route_opts)
    single, _ = _both(one, one_mesh, 3)
    assert (got.t, got.cycles, got.dt_last, got.lm, got.ok) == \
        (single.t, single.cycles, single.dt_last, single.lm, single.ok)
    from armon_torch.interop import gather_state
    from armon_torch.core.state import FusedCarry
    whole = gather_state(params, [FusedCarry(*c) for c in got.carry])
    g = params.config.nghost
    r = (slice(g, -g), slice(g, -g))
    for a, b in zip(whole, single.carry[0]):
        assert _bits(a[r].contiguous(), b[r].contiguous())


@pytest.mark.parametrize("route_opts", [PER_SWEEP, PAIR], ids=["per-sweep", "pair"])
def test_mesh_across_cards_sequencing(route_opts):
    """A mesh across cards' sequencing on one device: every shard but the
    first is remote, its partials copied in after each cycle, then K3
    folds and steps (no tail). It equals the old sequencing and the
    one-card tail on the same mesh, bit for bit."""
    P = (2, 2) if route_opts is PER_SWEEP else (1, 2)
    params, mesh = _setup(route_opts=route_opts, P=P)
    got, want = _both(params, mesh, 3, remote=range(1, len(mesh)))
    _assert_same(got, want)
    tail, _ = _both(params, mesh, 3)
    _assert_same(got, tail)


def test_tail_needs_an_emitting_launch():
    params, _ = _setup()
    cfg = params.config
    [fs], _ = make_init_fused(params)()
    src = tuple(fs[:4])
    dst = tuple(torch.empty_like(a) for a in src)
    part = torch.zeros((2, 1), dtype=fs.rho.dtype)
    scal, iscal = K.new_scalars(cfg.dtype, "cpu")
    fin = K.Finish(part, 1, K.new_ticket("cpu"))
    with pytest.raises(armon_torch.SolverException):
        K.x_sweep(cfg, src, dst, fs.p, part, scal, iscal, 1.0, False, finish=fin)


@pytest.mark.parametrize("run", [1, 0], ids=["ran", "stopped"])
def test_tail_plain_is_k3_plain(run):
    """A launch with the tail equals the same launch then K3's plain
    version: fields, partials and every loop scalar; a copied-through
    cycle (iscal[run] 0) still steps."""
    params, _ = _setup(dtype="float32")
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    src = tuple(fs[:4])
    res = []
    for tail in (True, False):
        dst = tuple(torch.empty_like(a) for a in src)
        p = fs.p.clone()
        part = torch.zeros((2, 1), dtype=fs.rho.dtype)
        scal, iscal = K.new_scalars(cfg.dtype, "cpu", t=0.01, cycle=3,
                                    dt_prev=1e-3, lm=float(seed))
        scal[K.SC_DTUSE] = 1e-3
        iscal[K.IS_RUN] = run
        fin = K.Finish(part, 1, K.new_ticket("cpu")) if tail else None
        K.y_sweep(cfg, src, dst, p, part, scal, iscal, 1.0, True, finish=fin)
        if not tail:
            K.cfl_finish_plain(cfg, part, 1, scal, iscal)
        res.append(dst + (p, part, scal, iscal))
    for a, b in zip(*res):
        assert _bits(a, b) if a.is_floating_point() else torch.equal(a, b)
    assert int(res[0][-1][K.IS_CYCLE]) == 4
