"""The hand-written CUDA kernels against their plain PyTorch versions on the
card. Every test here needs a CUDA card and the CUDA toolkit; without
them each one skips (decided inside the test, never at import).

Tolerances: exact mode (f64, and f32 without fast math) is built with
-fmad=false and IEEE divides, like the plain versions, so it must agree
bit for bit on real cells; f32 fast math (approximate reciprocals) within
1e-4 of the field's scale."""

import pytest
import torch

import armon_torch
from armon_torch.core import graphs as G
from armon_torch.core.solver import make_init_fused
from armon_torch.core.step import make_time_loop_lean
from armon_torch.ops import sweep as K
from armon_torch.ops import cycle as C
from armon_torch.ops.routing import temporal_pairs, route as route_of
from armon_torch.ops.reductions import real_slice
from armon_torch.core.solver import make_mesh
from armon_torch.parallel.halo import halo_slabs

pytestmark = pytest.mark.gpu

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _advanced(test, dtype, fast, n=96, cycles=4, N=None, **scheme):
    params = armon_torch.ArmonParameters(test=test, N=N or (n, n), data_type=dtype,
                                         use_fast_math=fast, maxcycle=cycles,
                                         silent=5, device="cuda", **PER_SWEEP,
                                         **scheme)
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))
    return params.config, res


# Grids against K1's 120-column windows and K2's 128-row segments: whole
# windows, odd rows and columns (no 16-byte rows), fewer rows than one
# segment (and a row of one window).
SHAPES = [(96, 96), (131, 77), (300, 40)]
SHAPE_IDS = ["96x96", "131x77", "300x40"]


@pytest.mark.parametrize("N", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_sweeps_match_plain(card, test, dtype, fast, N):
    """K1 and K2 (emitting) against `sweep_plain`, their CFL partials
    folded by K3 against its plain version, and the pass-through copy of a
    launch whose cycle does not run (every cell, ghosts included)."""
    cfg, res = _advanced(test, dtype, fast, N=N)
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    src = tuple(res.carry[:4])
    dt = 0.5 * res.dt_last
    for sweep, axis in ((K.x_sweep, armon_torch.Axis.X),
                        (K.y_sweep, armon_torch.Axis.Y)):
        dst = tuple(torch.empty_like(a) for a in src)
        p = torch.empty_like(src[0])
        nb = K.n_partials(axis, src[0].shape, card)
        partials = torch.zeros((2, nb), dtype=src[0].dtype, device=card)
        scal, iscal = K.new_scalars(cfg.dtype, card)
        scal[K.SC_DTUSE] = dt
        iscal[K.IS_RUN] = 1
        sweep(cfg, src, dst, p, partials, scal, iscal, 1.0, True)
        ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0)
        for a, b in zip(dst + (p,), ref[:5]):
            if fast:
                scale = b[r].abs().max()
                assert (a[r] - b[r]).abs().max() <= 1e-4 * scale
            else:
                assert torch.equal(a[r], b[r])
        mx, my = K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5])
        tol = 1e-4 if fast else 0.0
        assert abs(partials[0].max() - mx) <= tol * mx
        assert abs(partials[1].max() - my) <= tol * my
        s2, i2 = scal.clone(), iscal.clone()
        K.cfl_finish(cfg, partials, nb, scal, iscal)
        K.cfl_finish_plain(cfg, partials, nb, s2, i2)
        assert torch.equal(scal, s2) and torch.equal(iscal, i2)
        iscal[K.IS_RUN] = 0
        dst = tuple(torch.full_like(a, float("nan")) for a in src)
        sweep(cfg, src, dst, p, partials, scal, iscal, 1.0, True)
        for a, b in zip(dst, src):
            assert torch.equal(a, b)


@pytest.mark.parametrize("N", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("scheme", [
    dict(scheme="GAD", riemann_limiter="superbee"),
    dict(scheme="GAD", riemann_limiter="no_limiter", projection="euler"),
    dict(scheme="Godunov", projection="euler"),
    dict(scheme="Godunov", projection="euler_2nd", nghost=3),
], ids=lambda d: "-".join(str(v) for v in d.values()))
def test_scheme_switches_match_plain(card, scheme, N):
    """The runtime scheme switches of the shared device body, f64 exact."""
    cfg, res = _advanced("Sod_circ", "float64", False, N=N, **scheme)
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    src = tuple(res.carry[:4])
    for sweep, axis in ((K.x_sweep, armon_torch.Axis.X),
                        (K.y_sweep, armon_torch.Axis.Y)):
        dst = tuple(torch.empty_like(a) for a in src)
        p = torch.empty_like(src[0])
        nb = K.n_partials(axis, src[0].shape, card)
        partials = torch.zeros((2, nb), dtype=src[0].dtype, device=card)
        scal, iscal = K.new_scalars(cfg.dtype, card)
        scal[K.SC_DTUSE] = 0.5 * res.dt_last
        iscal[K.IS_RUN] = 1
        sweep(cfg, src, dst, p, partials, scal, iscal, 1.0, True)
        ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0)
        for a, b in zip(dst + (p,), ref[:5]):
            assert torch.equal(a[r], b[r])


def test_strip_beyond_65535_rows(card):
    """C1: a 64 x 70000 strip (70008 padded rows, more than CUDA's 65535
    grid_y) through one emitting K1 and K2 launch, bit for bit against
    `sweep_plain` in f32 exact, the CFL partials folded by K3 as the single
    whole-array partial folds; then a few cycles of `armon()` on the strip
    against the CPU run."""
    N = (64, 70000)
    cfg, res = _advanced("Sod_circ", "float32", False, N=N, cycles=3)
    assert res.carry.rho.shape[0] > 65535
    r = real_slice(cfg)
    src = tuple(res.carry[:4])
    for sweep, axis in ((K.x_sweep, armon_torch.Axis.X),
                        (K.y_sweep, armon_torch.Axis.Y)):
        dst = tuple(torch.empty_like(a) for a in src)
        p = torch.empty_like(src[0])
        nb = K.n_partials(axis, src[0].shape, card)
        partials = torch.zeros((2, nb), dtype=src[0].dtype, device=card)
        scal, iscal = K.new_scalars(cfg.dtype, card, lm=1.0)
        scal[K.SC_DTUSE] = 0.5 * res.dt_last
        iscal[K.IS_RUN] = 1
        sweep(cfg, src, dst, p, partials, scal, iscal, 1.0, True)
        ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0)
        for a, b in zip(dst + (p,), ref[:5]):
            assert torch.equal(a[r], b[r])
        single = torch.stack(K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5])).view(2, 1)
        s2, i2 = scal.clone(), iscal.clone()
        K.cfl_finish(cfg, partials, nb, scal, iscal)
        K.cfl_finish_plain(cfg, single, 1, s2, i2)
        assert torch.equal(scal, s2) and torch.equal(iscal, i2)
    opts = dict(test="Sod_circ", N=N, data_type="float32", maxcycle=4,
                use_fast_math=False, silent=5, return_data=True)
    K.reset_launches()
    a = armon_torch.armon(armon_torch.ArmonParameters(device="cuda", **opts))
    assert K.LAUNCHES["x_sweep"] > 0 and K.LAUNCHES["y_sweep"] > 0
    b = armon_torch.armon(armon_torch.ArmonParameters(device="cpu", **opts))
    assert (a.cycles, a.final_time, a.last_dt) == (b.cycles, b.final_time, b.last_dt)
    for name in ("rho", "u", "v", "E", "p"):
        assert torch.equal(getattr(a.data, name).cpu()[r], getattr(b.data, name)[r]), name


@pytest.mark.parametrize("route", [PER_SWEEP, PAIR, {}],
                         ids=["per-sweep", "pair", "multicycle"])
def test_stop_check_interval_on_card(card, route):
    params = armon_torch.ArmonParameters(test="Sod_circ", N=(32, 32),
                                         silent=5, device="cuda", **route)
    out = []
    for every in (1, 8):
        [fs], seed = make_init_fused(params)()
        out.append(make_time_loop_lean(params.config, whole=False)(
            fs, 0.0, 0, 0.0, float(seed), check_every=every))
    assert out[0].cycles % 8 != 0
    assert (out[0].t, out[0].cycles, out[0].lm) == (out[1].t, out[1].cycles, out[1].lm)
    for a, b in zip(out[0].carry, out[1].carry):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,N,route", [
    ("float64", (64, 64), PER_SWEEP), ("float32", (64, 64), PER_SWEEP),
    ("float64", (40, 2), PER_SWEEP), ("float64", (2, 40), PER_SWEEP),
    ("float64", (64, 64), PAIR), ("float32", (64, 64), PAIR),
    ("float64", (40, 2), PAIR), ("float64", (2, 40), PAIR),
    ("float64", (64, 64), {}), ("float32", (64, 64), {})],
    ids=["f64", "f32", "f64-40x2", "f64-2x40", "pair-f64", "pair-f32",
         "pair-f64-40x2", "pair-f64-2x40", "multicycle-f64", "multicycle-f32"])
def test_card_run_matches_cpu_run(card, dtype, N, route):
    """Exact mode on the card reproduces the CPU (plain) run bit for bit,
    also on grids thinner than the ghost band (double mirror fill), on
    each route."""
    opts = dict(test="Sod_circ", N=N, data_type=dtype, maxcycle=20,
                use_fast_math=False, silent=5, return_data=True, **route)
    a = armon_torch.armon(armon_torch.ArmonParameters(device="cuda", **opts))
    b = armon_torch.armon(armon_torch.ArmonParameters(device="cpu", **opts))
    assert (a.cycles, a.final_time, a.last_dt) == (b.cycles, b.final_time, b.last_dt)
    g = 4
    for name in ("rho", "u", "v", "E", "p"):
        x = getattr(a.data, name).cpu()[g:-g, g:-g]
        y = getattr(b.data, name)[g:-g, g:-g]
        assert torch.equal(x, y), name


# Sedov on 40 x 36 cells: 1/dx and 1/dy differ and neither is a power of
# two, so the cross-sweep EOS fold changes bits and an axis mixed up shows.
FOLD_ROUTES = {"per_sweep": PER_SWEEP, "pair": PAIR, "multicycle": {},
               "mesh_per_sweep": dict(P=(2, 2), devices=["cuda:0"] * 4,
                                      **PER_SWEEP),
               "mesh_pair": dict(P=(1, 2), devices=["cuda:0"] * 2, **PAIR)}
FOLD_CASES = [(s, r) for s in ("Strang", "SequentialSym") for r in FOLD_ROUTES
              if r != "multicycle"] + [("Godunov", r) for r in FOLD_ROUTES]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("splitting,route", FOLD_CASES,
                         ids=[f"{s}-{r}" for s, r in FOLD_CASES])
def test_folded_routes_match_cpu_op_path(card, splitting, route, dtype):
    """Sedov through each kernel route on the card, exact mode, with the
    cross-sweep EOS fold between the launches of a cycle (K1 -> K2 and
    Strang's middle sweep, K4's and K5's own sweeps, the slabs of a
    one-card mesh), against the op path on the CPU: bit for bit."""
    opts = dict(test="Sedov", N=(40, 36), data_type=dtype, maxcycle=16,
                use_fast_math=False, silent=5, return_data=True,
                axis_splitting=splitting)
    a = armon_torch.armon(armon_torch.ArmonParameters(
        device="cuda", **opts, **FOLD_ROUTES[route]))
    b = armon_torch.armon(armon_torch.ArmonParameters(
        device="cpu", kernel_tier="torch", **opts))
    assert (a.cycles, a.final_time, a.last_dt) == (b.cycles, b.final_time, b.last_dt)
    g = 4
    shards = a.data if isinstance(a.data, list) else [a.data]
    assert len(shards) == 1, "a mesh run returns the gathered state"
    for name in ("rho", "u", "v", "E", "p"):
        x = getattr(shards[0], name).cpu()[g:-g, g:-g]
        y = getattr(b.data, name)[g:-g, g:-g]
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_folded_launches_match_plain(card, dtype):
    """Every form of the fold a route launches against the plain versions
    with the same folds, bit for bit on real cells: Strang's X (leaves X),
    Y (reads and leaves it), X (reads it, emits), with mirror fills and
    with slabs packed from the launch's input; K4 X first and Y first,
    leaving rho or X."""
    X, Y = armon_torch.Axis.X, armon_torch.Axis.Y
    cfg, res = _advanced("Sedov", dtype, False, N=(131, 77))
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    src = tuple(res.carry[:4])
    dt = 0.5 * res.dt_last
    shape = src[0].shape
    part = torch.zeros((2, max(K.n_partials(a, shape, card) for a in (X, Y))),
                       dtype=src[0].dtype, device=card)
    scal, iscal = K.new_scalars(cfg.dtype, card)
    scal[K.SC_DTUSE] = dt
    iscal[K.IS_RUN] = 1
    seq = ((X, K.Fold(None, True)), (Y, K.Fold(X, True)), (X, K.Fold(Y, False)))
    for slab in (False, True):
        cur = src
        for j, (axis, fold) in enumerate(seq):
            last = j + 1 == len(seq)
            ghosts = K.MIRRORED
            if slab:
                cut = [(slice(None), slice(g, 2 * g)),
                       (slice(None), slice(-2 * g, -g))]
                if axis is Y:
                    cut = [c[::-1] for c in cut]
                ghosts = tuple(torch.stack([a[c] for a in cur]).contiguous()
                               for c in cut)
            dst = tuple(torch.empty_like(a) for a in src)
            p = torch.empty_like(src[0])
            (K.x_sweep if axis is X else K.y_sweep)(
                cfg, cur, dst, p, part, scal, iscal, 1.0, last, ghosts,
                fold=fold)
            ref = K.sweep_plain(cfg, axis, *cur, scal[K.SC_DTUSE] * 1.0,
                                ghosts, fold=fold)
            got = dst + ((p,) if last else ())
            for a, b in zip(got, ref[:len(got)]):
                assert torch.equal(a[r], b[r]), (slab, j)
            cur = dst
    nb = C.n_partials(shape, card, cfg.dtype)
    part4 = torch.zeros((2, nb), dtype=src[0].dtype, device=card)
    for x_first in (True, False):
        for keep in (False, True):
            dst = tuple(torch.empty_like(a) for a in src)
            p = torch.empty_like(src[0])
            C.cycle(cfg, x_first, 1.0, 1.0, src, dst, p, part4, scal, iscal,
                    True, keep=keep)
            d = scal[K.SC_DTUSE]
            ref = C.cycle_plain(cfg, x_first, *src, d, d, keep=keep)
            for a, b in zip(dst + (p,), ref[:5]):
                assert torch.equal(a[r], b[r]), (x_first, keep)


def test_launch_counts(card):
    K.reset_launches()
    G.reset_launches()
    params = armon_torch.ArmonParameters(test="Sod", N=(64, 64), maxcycle=5,
                                         silent=5, device="cuda", **PER_SWEEP)
    stats = armon_torch.armon(params)
    assert stats.cycles == 5
    # The run is one whole-run graph whose body is one cycle here
    # (Sequential per-sweep), so no cycle launches past the end; cycles
    # run in whole bodies, and a cycle past the end passes through. K3
    # runs once, for the first step; every cycle's last launch (K2)
    # carries its tail, and K2's tail sets the WHILE condition once a
    # body.
    assert K.LAUNCHES["x_sweep"] == K.LAUNCHES["y_sweep"] == 5
    assert K.LAUNCHES["cfl_finish"] == 1
    assert K.TAILS["cfl_tail"] == 5
    assert G.LAUNCHES["while_tail"] == 5


@pytest.mark.parametrize("splitting,route,expect", [
    ("Sequential", PAIR, dict(cycle=6, cfl_finish=1, cfl_tail=6,
                              while_tail=3)),
    ("Strang", PAIR, dict(cycle=6, x_sweep=3, y_sweep=3, cfl_finish=1,
                          cfl_tail=6, while_tail=3)),
    ("Sequential", {}, dict(multicycle=1, while_tail=1)),
    ("X_only", {}, dict(x_sweep=6, cfl_finish=1, cfl_tail=6,
                        while_tail=3))],
    ids=["pair", "pair-strang", "multicycle", "x-only"])
def test_route_launch_counts(card, splitting, route, expect):
    """Each route launches its kernels and no other; `cfl_tail` counts
    the launches that carried K3's tail. The run is one whole-run graph
    whose body is two cycles on these routes (one K5 launch of 8 on the
    multicycle route), so 5 cycles launch 6; the body's last launch sets
    the WHILE condition (`while_tail`), once a body."""
    expect = dict(expect)
    tails = {"cfl_tail": expect.pop("cfl_tail", 0)}
    conds = {"while_tail": expect.pop("while_tail")}
    K.reset_launches()
    G.reset_launches()
    params = armon_torch.ArmonParameters(test="Sod", N=(64, 64), maxcycle=5,
                                         axis_splitting=splitting, silent=5,
                                         device="cuda", **route)
    assert armon_torch.armon(params).cycles == 5
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), **expect}
    assert K.TAILS == tails
    assert G.LAUNCHES == conds


# ------------------------------------------------------------ K3's tail

def _bits(a, b):
    """Equal bits (NaN payloads and signed zeros included)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def _same_values(a, b):
    """Equal, NaN where the other is NaN (the plain version's NaN payloads
    are the CPU's)."""
    a, b = a.cpu(), b.cpu()
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _launcher(kind, cfg, src, x_first=True, ghosts=K.MIRRORED, n_real=None):
    """(launch, nb): `launch(dst, p, part, scal, iscal, finish)` runs one
    emitting K1 / K2 / K4 launch on `src`."""
    dev, shape = src[0].device, src[0].shape
    if kind == "cycle":
        def launch(dst, p, part, scal, iscal, finish):
            C.cycle(cfg, x_first, 1.0, 1.0, src, dst, p, part, scal, iscal,
                    True, ghosts, n_real, finish)
        return launch, C.n_partials(shape, dev, cfg.dtype)
    axis = armon_torch.Axis.X if kind == "x_sweep" else armon_torch.Axis.Y
    sweep = K.x_sweep if kind == "x_sweep" else K.y_sweep

    def launch(dst, p, part, scal, iscal, finish):
        sweep(cfg, src, dst, p, part, scal, iscal, 1.0, True, ghosts, n_real,
              finish)
    return launch, K.n_partials(axis, shape, dev)


def _tail_vs_k3(cfg, launches, srcs, sc, runs=(1, 1, 0)):
    """Launches `launches` (one per shard, `_launcher`s over `srcs`), the
    last with K3's tail over every shard's partials, against the same
    launches then K3, and K3 against its plain version: fields, stale p,
    partials and every loop scalar, bit for bit, in rounds back to back
    (iscal[run] set to each of `runs` before its round: a round that does
    not run copies and still steps); the ticket is 0 after each."""
    nb = launches[0][1]
    S = len(launches)
    dev, dtype = srcs[0][0].device, srcs[0][0].dtype
    side = []
    for _ in range(2):
        part = torch.zeros((2, S * nb), dtype=dtype, device=dev)
        scal, iscal = K.new_scalars(cfg.dtype, dev, **sc)
        out = [(tuple(torch.empty_like(a) for a in src), torch.empty_like(src[0]))
               for src in srcs]
        side.append((part, scal, iscal, out))
    ticket = K.new_ticket(dev)
    for run in runs:
        for part, scal, iscal, out in side:
            iscal[K.IS_RUN] = run
        (pa, sa, ia, oa), (pb, sb, ib, ob) = side
        fin = K.Finish(pa, S * nb, ticket)
        for k, (launch, _) in enumerate(launches):
            launch(*oa[k], pa[:, k * nb:(k + 1) * nb], sa, ia,
                   fin if k == S - 1 else None)
            launch(*ob[k], pb[:, k * nb:(k + 1) * nb], sb, ib, None)
        s0, i0 = sb.clone(), ib.clone()
        K.cfl_finish(cfg, pb, S * nb, sb, ib)
        K.cfl_finish_plain(cfg, pb, S * nb, s0, i0)
        torch.cuda.synchronize()
        assert int(ticket) == 0
        for (da, p_a), (db, p_b) in zip(oa, ob):
            assert all(_bits(a, b) for a, b in zip(da + (p_a,), db + (p_b,)))
        assert _bits(pa, pb) and _bits(sa, sb) and _bits(ia, ib)
        assert _same_values(sb, s0) and torch.equal(ib.cpu(), i0.cpu())
    return sa, ia


TAIL_CASES = [("x_sweep", (300, 200)), ("y_sweep", (300, 200)),
              ("cycle", (300, 200)), ("x_sweep", (2000, 2000)),
              ("y_sweep", (2000, 2000)), ("cycle", (2000, 2000)),
              ("y_sweep", (96, 20)), ("cycle", (40, 40))]


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("kind,N", TAIL_CASES,
                         ids=[f"{k}-{n[0]}x{n[1]}" for k, n in TAIL_CASES])
def test_tail_matches_k3(card, kind, N, dtype, fast, nan):
    """K3's tail in K1 / K2 / K4's emitting launch against the same launch
    then K3, and K3 against its plain version, bit for bit: on grids of a
    few hundred blocks, of thousands (K1 2134 at 2008^2), and of one (K2
    at 96 x 20, K4 at 40 x 40); three launches back to back (the ticket
    resets), the last past the run's end; with a NaN in u, which fails
    the dt gate in both."""
    import dataclasses
    cfg, res = _advanced("Sod_circ", dtype, fast, N=N)
    cfg = dataclasses.replace(cfg, maxcycle=1 << 20)
    src = tuple(a.clone() for a in res.carry[:4])
    if nan:
        src[1][cfg.nghost + 3, cfg.nghost + 2] = float("nan")
    launch = _launcher(kind, cfg, src)
    if N in ((96, 20), (40, 40)):
        assert launch[1] == 1
    sc = dict(t=res.t, cycle=res.cycles, dt_prev=res.dt_last, lm=res.lm)
    scal, iscal = _tail_vs_k3(cfg, [launch], [src], sc)
    # Finite: each round steps (the copied one too). NaN: the first round's
    # fold fails the gate; later ones do not run.
    assert bool(iscal[K.IS_OK]) != nan
    assert int(iscal[K.IS_CYCLE]) == res.cycles + (1 if nan else 3)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("P,kind", [((2, 2), "y_sweep"), ((2, 2), "x_sweep"),
                                    ((1, 2), "cycle")],
                         ids=["2x2-y", "2x2-x", "1x2-cycle"])
def test_tail_folds_mesh_on_card(card, P, kind, dtype):
    """On a one-card mesh the last shard's launch folds every shard's
    partials (the earlier shards' launches wrote theirs before it):
    against every shard's launch then K3 over all of them, bit for bit."""
    import dataclasses
    route = PAIR if kind == "cycle" else PER_SWEEP
    cfg, mesh, res = _mesh_state("Sod_circ", dtype, False, P, (263, 301), **route)
    cfg = dataclasses.replace(cfg, maxcycle=1 << 20)
    cur = [tuple(c[:4]) for c in res.carry]
    axis = armon_torch.Axis.X if kind == "x_sweep" else armon_torch.Axis.Y
    ghosts = halo_slabs(cfg, mesh, cur, axis)
    launches = [_launcher(kind, cfg, cur[s.index], ghosts=ghosts[s.index],
                          n_real=s.n_real) for s in mesh]
    assert len({nb for _, nb in launches}) == 1
    sc = dict(t=res.t, cycle=res.cycles, dt_prev=res.dt_last, lm=res.lm)
    _tail_vs_k3(cfg, launches, cur, sc)


def test_tail_refuses_a_slice_outside_its_fold(card):
    cfg, res = _advanced("Sod_circ", "float32", False, N=(64, 64))
    src = tuple(res.carry[:4])
    launch, nb = _launcher("y_sweep", cfg, src)
    part = torch.zeros((2, 2 * nb), dtype=src[0].dtype, device=card)
    scal, iscal = K.new_scalars(cfg.dtype, card)
    fin = K.Finish(part, nb, K.new_ticket(card))
    dst = tuple(torch.empty_like(a) for a in src)
    with pytest.raises(armon_torch.SolverException):
        launch(dst, torch.empty_like(src[0]), part[:, nb:], scal, iscal, fin)


def _close(a, b, fast):
    if fast:
        return bool((a - b).abs().max() <= 1e-4 * b.abs().max())
    return torch.equal(a, b)


@pytest.mark.parametrize("N", [(200, 200), (250, 130), (40, 2), (2, 40)],
                         ids=["200", "250x130", "40x2", "2x40"])
@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_cycle_matches_plain(card, test, dtype, fast, x_first, N):
    """K4 against `cycle_plain` on the same state: bit for bit in exact
    mode (fields, p, CFL maxima and K3's fold), 1e-4 of scale in fast
    math; on several tiles with ragged edges (K4's tiles are 88 x 120 in
    f32, 56 x 56 in f64) and on grids thinner than the ghost band."""
    cfg, res = _advanced(test, dtype, fast, N=N)
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    src = tuple(res.carry[:4])
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = C.n_partials(src[0].shape, card, cfg.dtype)
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=card)
    scal, iscal = K.new_scalars(cfg.dtype, card)
    scal[K.SC_DTUSE] = 0.5 * res.dt_last
    iscal[K.IS_RUN] = 1
    C.cycle(cfg, x_first, 0.5, 1.0, src, dst, p, partials, scal, iscal, True)
    dt = scal[K.SC_DTUSE]
    ref = C.cycle_plain(cfg, x_first, *src, dt * 0.5, dt * 1.0)
    for a, b in zip(dst + (p,), ref[:5]):
        assert _close(a[r], b[r], fast)
    tol = 1e-4 if fast else 0.0
    assert abs(partials[0].max() - ref[5]) <= tol * ref[5]
    assert abs(partials[1].max() - ref[6]) <= tol * ref[6]
    s2, i2 = scal.clone(), iscal.clone()
    K.cfl_finish(cfg, partials, nb, scal, iscal)
    K.cfl_finish_plain(cfg, partials, nb, s2, i2)
    assert torch.equal(scal, s2) and torch.equal(iscal, i2)


MULTI_CASES = [
    ("Sod", dict()),
    ("Sod_circ", dict(axis_splitting="Godunov")),
    ("Sod", dict(maxcycle=13)),                      # stops mid-launch
    ("Sod_circ", dict(dt_on_even_cycles=True)),
    ("Sod", dict(cst_dt=True, Dt=1e-3)),
]


def _k5_launch(kernel, cfg, pairs, src, dst, p, scal, iscal):
    """One launch of the solver's K5 (`ops/cycle.py` `multicycle`) or of
    the cluster probe's (`probes/cluster.py`)."""
    if kernel == "k5":
        C.multicycle(cfg, pairs, src, dst, p, C.new_multicycle_partials(
            src[0].shape, cfg.dtype, src[0].device), scal, iscal)
    else:
        from armon_torch.probes import cluster
        cluster.multicycle(cfg, pairs, src, dst, p, scal, iscal)


def _k5_vs_plain(card, test, dtype, kernel="k5", ncycles=8, **extra):
    """One launch of `ncycles` cycles from the state after 10 per-sweep
    cycles against `multicycle_plain` on copies of the same inputs: fields
    (in the buffer set the cycle count's parity names), p and every loop
    scalar bit for bit. Returns the loop ints after the launch."""
    opts = dict(test=test, data_type=dtype, use_fast_math=False, silent=5,
                device="cuda", **extra)
    opts.setdefault("N", (100, 100))
    opts.setdefault("maxcycle", 100)
    params = armon_torch.ArmonParameters(**opts)
    cfg = params.config
    pairs = temporal_pairs(cfg)
    assert len(pairs) == ncycles
    [fs], seed = make_init_fused(params)()
    warm = armon_torch.ArmonParameters(**{**opts, "maxcycle": 10, **PER_SWEEP})
    res = make_time_loop_lean(warm.config)(fs, 0.0, 0, 0.0, float(seed))
    src = tuple(a.clone() for a in res.carry[:4])
    p = res.carry.p.clone()
    scal, iscal = K.new_scalars(cfg.dtype, card, t=res.t, cycle=res.cycles,
                                dt_prev=res.dt_last, lm=res.lm)
    ins = [tuple(a.clone() for a in src), tuple(torch.empty_like(a) for a in src),
           p.clone(), scal.clone(), iscal.clone()]
    dst = tuple(torch.empty_like(a) for a in src)
    _k5_launch(kernel, cfg, pairs, src, dst, p, scal, iscal)
    C.multicycle_plain(cfg, pairs, len(pairs), *ins)
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    out = (src, dst)[len(pairs) % 2]
    for a, b in zip(out + (p,), ins[len(pairs) % 2] + (ins[2],)):
        assert torch.equal(a[r], b[r])
    assert torch.equal(scal, ins[3]) and torch.equal(iscal, ins[4])
    return iscal


# The same on grids that take K5's large windows (100^2 takes the small
# ones: `ops/cycle.multi_tile`): 248^2 padded in f32, 248 x 128 in f64
# (the routing admits no larger square).
MULTI_LARGE_N = {"float32": (240, 240), "float64": (120, 240)}
MULTI_LARGE_CASES = [(test, dict(extra, large=True)) for test, extra in MULTI_CASES]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("test,extra", MULTI_CASES + MULTI_LARGE_CASES,
                         ids=["sod", "circ-godunov", "maxcycle", "even-dt",
                              "cst-dt", "sod-w32", "circ-godunov-w32",
                              "maxcycle-w32", "even-dt-w32", "cst-dt-w32"])
def test_multicycle_matches_plain(card, test, extra, dtype):
    """One K5 launch of 8 cycles from the state after 10 cycles against
    `multicycle_plain`: fields, p and every loop scalar bit for bit, on
    each of K5's two window geometries."""
    extra = dict(extra)
    large = extra.pop("large", False)
    if large:
        extra["N"] = MULTI_LARGE_N[dtype]
    shape = armon_torch.ArmonParameters(device="cpu", silent=5, N=extra.get(
        "N", (100, 100))).config.local_shape
    assert C.multi_tile(shape, dtype) == (C.MULTI_LARGE if large else C.MULTI_SMALL)
    iscal = _k5_vs_plain(card, test, dtype, **extra)
    if "maxcycle" in extra:
        assert int(iscal[K.IS_CYCLE]) == 13 and not int(iscal[K.IS_NEXT])


@pytest.mark.parametrize("kernel", ["k5", "cluster"])
@pytest.mark.parametrize("test,dtype,extra", [
    ("Sod_circ", "float32", dict(N=(120, 496))),   # thin: 504 x 128 padded
    ("Sod_circ", "float32", dict(N=(240, 240))),   # square: 248 x 248
    ("Sod", "float32", dict(N=(3192, 4))),         # wide: 12 x 3200
    ("Sod_circ", "float64", dict(N=(120, 240))),   # f64 thin: 248 x 128
    ("Sod_circ", "float64", dict(N=(120, 120))),
    ("Bizarrium", "float64", dict()),
    ("Bizarrium", "float32", dict(N=(240, 240))),
    ("Sod_circ", "float64", dict(temporal_blocking=7)),  # odd K: ends in dst
    ("Sod_circ", "float32", dict(temporal_blocking=7, maxcycle=13)),
], ids=["f32-120x496", "f32-240", "f32-3192x4", "f64-120x240", "f64-120",
        "biz-f64", "biz-f32-240", "odd-k-f64", "odd-k-f32-stop"])
def test_multicycle_extremes_match_plain(card, kernel, test, dtype, extra):
    """K5, and the cluster probe's K5, bit for bit against
    `multicycle_plain` at the largest grids the routing admits, on the
    wide strip, on Bizarrium and with an odd K."""
    _k5_vs_plain(card, test, dtype, kernel, extra.get("temporal_blocking", 8),
                 **extra)


# The grids with the most tiles of each K5 window the routing admits
# (`tests/test_torch_cycle.py` `K5_EXTREMES`): the small windows at the
# card's full capacity, the large ones at their most, f32 and f64.
K5_WORST = [
    ("Sod_circ", "float32", dict(N=(64, 344))),    # 352 x 72: 396 8 x 8 tiles
    ("Sod_circ", "float64", dict(N=(80, 184))),    # 192 x 88: 264
    ("Sod", "float32", dict(N=(4092, 4), nghost=2, scheme="Godunov",
                            projection="euler")),  # 8 x 4096: 171 24 x 24 tiles
    ("Sod", "float64", dict(N=(1916, 5), nghost=2, scheme="Godunov",
                            projection="euler")),  # 9 x 1920: 80
]
K5_WORST_IDS = ["f32-w16-396", "f64-w16-264", "f32-w32-171", "f64-w32-80"]


@pytest.mark.parametrize("test,dtype,extra", K5_WORST, ids=K5_WORST_IDS)
def test_multicycle_worst_tiles_match_plain(card, test, dtype, extra):
    """K5 bit for bit against `multicycle_plain` on the grids with the most
    tiles of each window: every tile co-resident, no code -4."""
    _k5_vs_plain(card, test, dtype, **extra)


# `chip_smoke.py`'s K5 grids and K5_WORST: every grid the routing admits
# at its extremes, (nx, ny) and options.
K5_LAUNCH_GRIDS = [
    ("float32", dict(N=(100, 100))), ("float32", dict(N=(120, 496))),
    ("float32", dict(N=(240, 240))), ("float32", dict(N=(3192, 4))),
    ("float64", dict(N=(120, 120))), ("float64", dict(N=(120, 240))),
] + [(dtype, extra) for _, dtype, extra in K5_WORST]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("dtype,extra", K5_LAUNCH_GRIDS,
                         ids=[f"{d}-{e['N'][0]}x{e['N'][1]}" for d, e in K5_LAUNCH_GRIDS])
def test_multicycle_launches_at_every_extreme(card, dtype, extra, fast):
    """K5 launches (a cooperative launch of every tile at once) at every
    admitted extreme, in both window geometries, exact and fast math: no
    code -4, and the card's blocks per SM hold the tiles. Times nothing."""
    from armon_torch.ops import _build
    params = armon_torch.ArmonParameters(test="Sod", data_type=dtype,
                                         use_fast_math=fast, silent=5,
                                         device="cuda", **extra)
    cfg = params.config
    assert route_of(cfg) == "multicycle"
    [fs], seed = make_init_fused(params)()
    src = tuple(a.clone() for a in fs[:4])
    dst = tuple(torch.empty_like(a) for a in src)
    shape = src[0].shape
    occ = _build.multicycle_occupancy(shape, cfg.dtype, fast, False)
    assert occ["window"] == C.multi_tile(shape, cfg.dtype)
    assert occ["tiles"] <= occ["blocks_per_sm"] * torch.cuda.get_device_properties(
        card).multi_processor_count
    assert occ["local_bytes"] == 0
    scal, iscal = K.new_scalars(cfg.dtype, card, lm=float(seed))
    before = K.LAUNCHES["multicycle"]
    C.multicycle(cfg, temporal_pairs(cfg), src, dst, fs.p.clone(),
                 C.new_multicycle_partials(shape, cfg.dtype, card), scal, iscal)
    torch.cuda.synchronize()
    assert K.LAUNCHES["multicycle"] == before + 1
    assert int(iscal[K.IS_CYCLE]) == len(temporal_pairs(cfg))
    assert all(bool(torch.isfinite(a).all()) for a in src)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("test,extra", MULTI_CASES,
                         ids=["sod", "circ-godunov", "maxcycle", "even-dt",
                              "cst-dt"])
def test_cluster_multicycle_matches_plain(card, test, extra, dtype):
    """The cluster probe's K5 on `test_multicycle_matches_plain`'s cases."""
    iscal = _k5_vs_plain(card, test, dtype, "cluster", **extra)
    if "maxcycle" in extra:
        assert int(iscal[K.IS_CYCLE]) == 13 and not int(iscal[K.IS_NEXT])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", [(100, 100), (300, 200)])
def test_routes_agree_on_card(card, dtype, N):
    """Per-sweep, pair and (where admitted) multicycle give the same bits
    on real cells, and the same t, cycles, dt and lm, in exact mode."""
    out = []
    for route in (PER_SWEEP, PAIR, {}):
        params = armon_torch.ArmonParameters(
            test="Sod_circ", N=N, data_type=dtype, use_fast_math=False,
            maxcycle=20, silent=5, device="cuda", **route)
        [fs], seed = make_init_fused(params)()
        out.append(make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0,
                                                      float(seed)))
    g = 4
    for res in out[1:]:
        assert (res.t, res.cycles, res.dt_last, res.lm) == \
            (out[0].t, out[0].cycles, out[0].dt_last, out[0].lm)
        for a, b in zip(res.carry, out[0].carry):
            assert torch.equal(a[g:-g, g:-g], b[g:-g, g:-g])


# ------------------------------------------------- domain-decomposed runs

def _mesh_state(test, dtype, fast, P, N, cycles=4, **route):
    """A mesh of P shards on one card after `cycles` cycles."""
    params = armon_torch.ArmonParameters(
        test=test, N=N, data_type=dtype, use_fast_math=fast, maxcycle=cycles,
        silent=5, P=P, devices=["cuda:0"] * (P[0] * P[1]), **route)
    mesh = make_mesh(params)
    fs, seed = make_init_fused(params)()
    res = make_time_loop_lean(params.config, mesh)(fs, 0.0, 0, 0.0,
                                                   float(seed))
    return params.config, mesh, res


def _close_on_mesh(checks, fast):
    """`checks`: (kernel fields, plain fields, real slice) per shard. Bit
    for bit in exact mode; in fast math within 1e-4 of each field's scale
    over the whole mesh (a shard in a quiet region holds only the rounding
    noise of Bizarrium's cancelling pressure terms)."""
    for k in range(len(checks[0][0])):
        scale = max(float(b[k][r].abs().max()) for _, b, r in checks)
        for a, b, r in checks:
            if fast:
                assert float((a[k][r] - b[k][r]).abs().max()) <= 1e-4 * scale, k
            else:
                assert torch.equal(a[k][r], b[k][r]), k


@pytest.mark.parametrize("P,N", [((3, 3), (100, 98)), ((2, 2), (263, 301))],
                         ids=["3x3", "2x2"])
@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_slab_sweeps_match_plain(card, test, dtype, fast, P, N):
    """K1/K2 with a neighbour's slab on the sides that face one (the
    `slab_x` / `slab_y` variants) against `sweep_plain` with the same
    ghosts, on every shard of an uneven mesh: on 3x3 the middle shard takes
    slabs on both sides, the edge shards a slab and the mirror; on 2x2
    every shard takes one slab side and one mirror side along each axis,
    on several K1 windows and K2 segments with ragged edges."""
    cfg, mesh, res = _mesh_state(test, dtype, fast, P, N, **PER_SWEEP)
    cur = [tuple(c[:4]) for c in res.carry]
    for sweep, axis in ((K.x_sweep, armon_torch.Axis.X),
                        (K.y_sweep, armon_torch.Axis.Y)):
        ghosts = halo_slabs(cfg, mesh, cur, axis)
        checks = []
        for s in mesh:
            src = cur[s.index]
            r = real_slice(cfg, s.n_real)
            dst = tuple(torch.empty_like(a) for a in src)
            p = torch.empty_like(src[0])
            nb = K.n_partials(axis, src[0].shape, card)
            partials = torch.zeros((2, nb), dtype=src[0].dtype, device=card)
            scal, iscal = K.new_scalars(cfg.dtype, card)
            scal[K.SC_DTUSE] = 0.5 * res.dt_last
            iscal[K.IS_RUN] = 1
            sweep(cfg, src, dst, p, partials, scal, iscal, 1.0, True,
                  ghosts[s.index], s.n_real)
            ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0,
                                ghosts[s.index], s.n_real)
            checks.append((dst + (p,), ref[:5], r))
            mx, my = K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5], s.n_real)
            tol = 1e-4 if fast else 0.0
            assert abs(partials[0].max() - mx) <= tol * mx
            assert abs(partials[1].max() - my) <= tol * my
        _close_on_mesh(checks, fast)


@pytest.mark.parametrize("N", [(96, 100), (250, 370)], ids=["96x100", "250x370"])
@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_slab_cycle_matches_plain(card, test, dtype, fast, x_first, N):
    """K4 with Y slabs and the X mirror after the splice (the `slab_y`
    variant of `_cycle_kernel`) against `cycle_plain`, on every shard of a
    1x3 mesh with an uneven Y split. Its first sweep runs on the ghost
    rows, so the corner cells (the X mirror of slab rows) reach real
    cells: this is the case that checks them."""
    cfg, mesh, res = _mesh_state(test, dtype, fast, (1, 3), N, **PAIR)
    assert route_of(cfg) == "pair"
    cur = [tuple(c[:4]) for c in res.carry]
    ghosts = halo_slabs(cfg, mesh, cur, armon_torch.Axis.Y)
    checks = []
    for s in mesh:
        src = cur[s.index]
        r = real_slice(cfg, s.n_real)
        dst = tuple(torch.empty_like(a) for a in src)
        p = torch.empty_like(src[0])
        nb = C.n_partials(src[0].shape, card, cfg.dtype)
        partials = torch.zeros((2, nb), dtype=src[0].dtype, device=card)
        scal, iscal = K.new_scalars(cfg.dtype, card)
        scal[K.SC_DTUSE] = 0.5 * res.dt_last
        iscal[K.IS_RUN] = 1
        C.cycle(cfg, x_first, 0.5, 1.0, src, dst, p, partials, scal, iscal,
                True, ghosts[s.index], s.n_real)
        dt = scal[K.SC_DTUSE]
        ref = C.cycle_plain(cfg, x_first, *src, dt * 0.5, dt * 1.0,
                            ghosts[s.index], s.n_real)
        checks.append((dst + (p,), ref[:5], r))
        tol = 1e-4 if fast else 0.0
        assert abs(partials[0].max() - ref[5]) <= tol * ref[5]
        assert abs(partials[1].max() - ref[6]) <= tol * ref[6]
    _close_on_mesh(checks, fast)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("P,N,route", [
    ((2, 2), (100, 100), {}), ((3, 2), (100, 99), {}),
    ((1, 2), (100, 100), PAIR), ((1, 3), (64, 100), PAIR)],
    ids=["2x2", "3x2-uneven", "1x2-pair", "1x3-pair-uneven"])
def test_mesh_run_matches_single_on_card(card, P, N, route, dtype):
    """A mesh on one card (every shard on cuda:0) equals the one-device
    run bit for bit in exact mode: t, cycles, dt and the real cells."""
    opts = dict(test="Sod_circ", N=N, data_type=dtype, maxcycle=20,
                use_fast_math=False, silent=5, return_data=True, **route)
    K.reset_launches()
    a = armon_torch.armon(armon_torch.ArmonParameters(
        device="cuda", P=P, devices=["cuda:0"] * (P[0] * P[1]), **opts))
    slab = "cycle_slab" if route else "y_sweep_slab"
    assert K.LAUNCHES[slab] > 0
    b = armon_torch.armon(armon_torch.ArmonParameters(device="cuda", **opts))
    assert (a.cycles, a.final_time, a.last_dt) == (b.cycles, b.final_time, b.last_dt)
    g = 4
    for name in ("rho", "u", "v", "E", "p"):
        x = getattr(a.data, name)[g:-g, g:-g]
        y = getattr(b.data, name)[g:-g, g:-g]
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", True)],
                         ids=["f64", "f32-fast"])
@pytest.mark.parametrize("route", [PER_SWEEP, PAIR, {},
                                   dict(P=(2, 2), devices=["cuda:0"] * 4)],
                         ids=["per_sweep", "pair", "multicycle", "mesh-2x2"])
def test_per_cycle_driver_matches_lean_on_card(card, route, dtype, fast):
    """The per-cycle driver (`silent=1`) launches the lean loop's kernels
    in the same order (K4 one cycle at a time where the lean loop runs
    K5): its bits, t, dt and cycles, one host read a cycle."""
    import contextlib
    import io
    opts = dict(test="Sod_circ", N=(100, 100), data_type=dtype, maxcycle=24,
                use_fast_math=fast, return_data=True, device="cuda", **route)
    lean = armon_torch.armon(armon_torch.ArmonParameters(silent=5, **opts))
    K.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        per = armon_torch.armon(armon_torch.ArmonParameters(silent=1, **opts))
    assert K.LAUNCHES["multicycle"] == 0 and K.TAILS["cfl_tail"] == 24
    assert (per.cycles, per.final_time, per.last_dt) == \
        (lean.cycles, lean.final_time, lean.last_dt)
    assert per.host_reads == 2 * per.cycles + 2
    exact = not fast or route != {}
    g = 4
    for name in ("rho", "u", "v", "E", "p"):
        x = getattr(per.data, name)[g:-g, g:-g]
        y = getattr(lean.data, name)[g:-g, g:-g]
        if exact:
            assert torch.equal(x, y), name
        else:  # K4 against K5 in fast math
            assert torch.allclose(x, y, rtol=0, atol=1e-4 * float(y.abs().max()))


@pytest.mark.parametrize("route,cut", [(PER_SWEEP, 7), (PAIR, 7), ({}, 8),
                                       ({}, 9)],
                         ids=["per_sweep", "pair", "multicycle-even",
                              "multicycle-odd"])
def test_resume_on_card(card, tmp_path, route, cut):
    """A snapshot at `cut` cycles resumed to 24, f32 exact: the
    uninterrupted run's bits (K5 at an even cycle, K4 one cycle at a time
    at an odd one)."""
    from armon_torch.io.restart import save_checkpoint
    opts = dict(test="Sod_circ", N=(100, 100), data_type="float32",
                use_fast_math=False, return_data=True, device="cuda",
                silent=5, **route)
    full = armon_torch.armon(armon_torch.ArmonParameters(maxcycle=24, **opts))
    p1 = armon_torch.ArmonParameters(maxcycle=cut, **opts)
    s1 = armon_torch.armon(p1)
    save_checkpoint(tmp_path / "s.npz", p1, s1.data, s1.final_time, s1.cycles,
                    s1.last_dt)
    K.reset_launches()
    s2 = armon_torch.armon(armon_torch.ArmonParameters(maxcycle=24, **opts),
                           restore_from=str(tmp_path / "s.npz"))
    assert (K.LAUNCHES["multicycle"] > 0) == (route == {} and cut % 2 == 0)
    assert (s2.cycles, s2.final_time, s2.last_dt) == \
        (full.cycles, full.final_time, full.last_dt)
    for name in ("rho", "u", "v", "E", "p"):
        assert torch.equal(getattr(s2.data, name), getattr(full.data, name)), name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_card_file_equals_cpu_file(card, tmp_path, dtype):
    """`write_output` of the same exact-mode run on the card and on the
    CPU: the same bytes."""
    opts = dict(test="Sod_circ", N=(100, 100), data_type=dtype, maxcycle=30,
                use_fast_math=False, silent=5, write_output=True,
                output_dir=str(tmp_path))
    for device in ("cuda", "cpu"):
        armon_torch.armon(armon_torch.ArmonParameters(
            device=device, output_file=device, **opts))
    assert (tmp_path / "cuda").read_bytes() == (tmp_path / "cpu").read_bytes()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("P,devices,route", [
    ((2, 2), None, {}), ((1, 4), None, PAIR),
    ((3, 1), ["cuda:0", "cuda:1", "cuda:0"], {})],
    ids=["2x2", "1x4-pair", "3x1-shared"])
def test_mesh_on_four_cards(card, P, devices, route, dtype):
    """Shards on several cards (by default cuda:0..n-1; the last case
    shares a card between two shards) equal the one-device run bit for
    bit: the cross-card slab copies, the partials gathered to the first
    card and the loop scalars copied out to the others."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    opts = dict(test="Sod_circ", N=(200, 120), data_type=dtype, maxcycle=20,
                use_fast_math=False, silent=5, return_data=True, **route)
    place = dict(P=P) if devices is None else dict(P=P, devices=devices)
    a = armon_torch.armon(armon_torch.ArmonParameters(device="cuda", **place,
                                                      **opts))
    b = armon_torch.armon(armon_torch.ArmonParameters(device="cuda", **opts))
    assert (a.cycles, a.final_time, a.last_dt) == (b.cycles, b.final_time, b.last_dt)
    g = 4
    for name in ("rho", "u", "v", "E", "p"):
        x = getattr(a.data, name)[g:-g, g:-g].cpu()
        y = getattr(b.data, name)[g:-g, g:-g].cpu()
        assert torch.equal(x, y), name


@pytest.mark.parametrize("probe", ["flip", "ff", "roofline_io", "roofline",
                                   "cycle_variants", "cluster"])
def test_probe_kernels_match_plain(card, probe):
    """Each probe kernel (`armon_torch/probes/`) against its plain version
    on the card: bit for bit where the arithmetic is exact, within the
    probe's stated gate elsewhere (its `check` raises otherwise)."""
    import importlib
    errs = importlib.import_module(f"armon_torch.probes.{probe}").check("cuda")
    assert errs and all(v == v for v in errs.values())
