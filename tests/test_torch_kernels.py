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


def _advanced(test, dtype, fast, n=96, cycles=4, **scheme):
    params = armon_torch.ArmonParameters(test=test, N=(n, n), data_type=dtype,
                                         use_fast_math=fast, maxcycle=cycles,
                                         silent=5, device="cuda", **PER_SWEEP,
                                         **scheme)
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))
    return params.config, res


@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_sweeps_match_plain(card, test, dtype, fast):
    cfg, res = _advanced(test, dtype, fast)
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


@pytest.mark.parametrize("scheme", [
    dict(scheme="GAD", riemann_limiter="superbee"),
    dict(scheme="GAD", riemann_limiter="no_limiter", projection="euler"),
    dict(scheme="Godunov", projection="euler"),
    dict(scheme="Godunov", projection="euler_2nd", nghost=3),
], ids=lambda d: "-".join(str(v) for v in d.values()))
def test_scheme_switches_match_plain(card, scheme):
    """The runtime scheme switches of the shared device body, f64 exact."""
    cfg, res = _advanced("Sod_circ", "float64", False, **scheme)
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


@pytest.mark.parametrize("route", [PER_SWEEP, PAIR, {}],
                         ids=["per-sweep", "pair", "multicycle"])
def test_stop_check_interval_on_card(card, route):
    params = armon_torch.ArmonParameters(test="Sod_circ", N=(32, 32),
                                         silent=5, device="cuda", **route)
    out = []
    for every in (1, 8):
        [fs], seed = make_init_fused(params)()
        out.append(make_time_loop_lean(params.config)(
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


def test_launch_counts(card):
    K.reset_launches()
    params = armon_torch.ArmonParameters(test="Sod", N=(64, 64), maxcycle=5,
                                         silent=5, device="cuda", **PER_SWEEP)
    stats = armon_torch.armon(params)
    assert stats.cycles == 5
    # Cycles run in batches of the stop-check interval; the ones past the
    # end still launch (and pass through).
    assert K.LAUNCHES["x_sweep"] == K.LAUNCHES["y_sweep"] == 8
    assert K.LAUNCHES["cfl_finish"] == 9


@pytest.mark.parametrize("splitting,route,expect", [
    ("Sequential", PAIR, dict(cycle=8, cfl_finish=9)),
    ("Strang", PAIR, dict(cycle=8, x_sweep=4, y_sweep=4, cfl_finish=9)),
    ("Sequential", {}, dict(multicycle=1)),
    ("X_only", {}, dict(x_sweep=8, cfl_finish=9))],
    ids=["pair", "pair-strang", "multicycle", "x-only"])
def test_route_launch_counts(card, splitting, route, expect):
    """Each route launches its kernels and no other."""
    K.reset_launches()
    params = armon_torch.ArmonParameters(test="Sod", N=(64, 64), maxcycle=5,
                                         axis_splitting=splitting, silent=5,
                                         device="cuda", **route)
    assert armon_torch.armon(params).cycles == 5
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), **expect}


def _close(a, b, fast):
    if fast:
        return bool((a - b).abs().max() <= 1e-4 * b.abs().max())
    return torch.equal(a, b)


@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_cycle_matches_plain(card, test, dtype, fast, x_first):
    """K4 against `cycle_plain` on the same state: bit for bit in exact
    mode (fields, p, CFL maxima and K3's fold), 1e-4 of scale in fast
    math."""
    cfg, res = _advanced(test, dtype, fast, n=200)
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    src = tuple(res.carry[:4])
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = C.n_partials(src[0].shape, card)
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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("test,extra", MULTI_CASES,
                         ids=["sod", "circ-godunov", "maxcycle", "even-dt",
                              "cst-dt"])
def test_multicycle_matches_plain(card, test, extra, dtype):
    """One K5 launch of 8 cycles from the state after 10 cycles against
    `multicycle_plain`: fields, p and every loop scalar bit for bit."""
    opts = dict(test=test, N=(100, 100), data_type=dtype, use_fast_math=False,
                silent=5, device="cuda", **extra)
    opts.setdefault("maxcycle", 100)
    params = armon_torch.ArmonParameters(**opts)
    cfg = params.config
    pairs = temporal_pairs(cfg)
    assert len(pairs) == 8
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
    C.multicycle(cfg, pairs, src, dst, p, C.new_multicycle_partials(
        src[0].shape, cfg.dtype, card), scal, iscal)
    C.multicycle_plain(cfg, pairs, len(pairs), *ins)
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    for a, b in zip(src + (p,), ins[0] + (ins[2],)):
        assert torch.equal(a[r], b[r])
    assert torch.equal(scal, ins[3]) and torch.equal(iscal, ins[4])
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


@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_slab_sweeps_match_plain(card, test, dtype, fast):
    """K1/K2 with a neighbour's slab on the sides that face one (the
    `slab_x` / `slab_y` variants) against `sweep_plain` with the same
    ghosts, on every shard of an uneven 3x3 mesh: the middle shard takes
    slabs on both sides, the edge shards a slab and the mirror."""
    cfg, mesh, res = _mesh_state(test, dtype, fast, (3, 3), (100, 98),
                                 **PER_SWEEP)
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


@pytest.mark.parametrize("x_first", [True, False], ids=["xy", "yx"])
@pytest.mark.parametrize("dtype,fast", [("float64", False), ("float32", False),
                                        ("float32", True)],
                         ids=["f64", "f32-exact", "f32-fast"])
@pytest.mark.parametrize("test", ["Sod_circ", "Bizarrium"])
def test_slab_cycle_matches_plain(card, test, dtype, fast, x_first):
    """K4 with Y slabs and the X mirror after the splice (the `slab_y`
    variant of `_cycle_kernel`) against `cycle_plain`, on every shard of a
    1x3 mesh with an uneven Y split. Its first sweep runs on the ghost
    rows, so the corner cells (the X mirror of slab rows) reach real
    cells: this is the case that checks them."""
    cfg, mesh, res = _mesh_state(test, dtype, fast, (1, 3), (96, 100), **PAIR)
    assert route_of(cfg) == "pair"
    cur = [tuple(c[:4]) for c in res.carry]
    ghosts = halo_slabs(cfg, mesh, cur, armon_torch.Axis.Y)
    checks = []
    for s in mesh:
        src = cur[s.index]
        r = real_slice(cfg, s.n_real)
        dst = tuple(torch.empty_like(a) for a in src)
        p = torch.empty_like(src[0])
        nb = C.n_partials(src[0].shape, card)
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
                                   "cycle_variants"])
def test_probe_kernels_match_plain(card, probe):
    """Each probe kernel (`armon_torch/probes/`) against its plain version
    on the card: bit for bit where the arithmetic is exact, within the
    probe's stated gate elsewhere (its `check` raises otherwise)."""
    import importlib
    errs = importlib.import_module(f"armon_torch.probes.{probe}").check("cuda")
    assert errs and all(v == v for v in errs.values())
