"""The compile-once loop layer (`armon_torch/core/graphs.py`): windows of
the time loop captured as CUDA graphs and replayed.

A capture records a window's launches with the host-side values they were
made with. It is right only if every window with the same key
(`graphs.window_key`: the schedule's parity, the buffer roles, the
window's length) makes the same launches, with the same arguments, and
ends with the buffer roles `graphs.end_roles` predicts. The CPU tests hold
that property without a card: a recorder on the wrappers' dispatch
(`ops/sweep._sweep`, `ops/cycle.cycle`, `ops/cycle.multicycle`) logs each
launch (kernel, every operand's pointer, shape and stride, dt factors,
emit, ghost sources, real extent, the `Finish`) while the eager loop
body runs window after window, on every route, under several
splittings, stop-check intervals and start parities, and on a 2x2 mesh
with slabs. The card tests (marked `gpu`) hold the graphs against the
eager loop bit for bit (f64 and f32 exact), with the same launch counts.
"""

import numpy as np
import pytest
import torch

import armon_torch
from armon_torch.core import graphs as G
from armon_torch.core.solver import make_init_fused, make_mesh
from armon_torch.core.step import (KernelCycles, MultiCycles,
                                   make_time_loop_lean)
from armon_torch.ops import cycle as C
from armon_torch.ops import sweep as K
from armon_torch.ops.routing import route, temporal_pairs
from armon_torch.utils.enums import Axis
from armon_torch.utils.errors import SolverException

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)
ROUTES = {"per_sweep": PER_SWEEP, "pair": PAIR, "multicycle": {}}
WINDOWS = 6


def _sig(x):
    """A launch argument as a hashable record: a tensor by its pointer,
    shape and strides; the keyword arguments by their items; a `Finish`
    and other objects by identity."""
    if isinstance(x, torch.Tensor):
        return "T", x.data_ptr(), tuple(x.shape), x.stride()
    if isinstance(x, (tuple, list)):
        return tuple(_sig(a) for a in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, (str, int, float, Axis)):
        return x
    return type(x).__name__, id(x)


@pytest.fixture
def recorder(monkeypatch):
    """The launches the wrappers dispatch, as records, in order."""
    log = []
    for mod, name in ((K, "_sweep"), (C, "cycle"), (C, "multicycle")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            log.append((_name, _sig(args[1:]), _sig(kw)))
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    return log


def _params(route_opts, splitting="Sequential", P=(1, 1), N=(24, 20),
            dtype="float64", **extra):
    return armon_torch.ArmonParameters(
        test="Sod_circ", N=N, P=P, data_type=dtype, axis_splitting=splitting,
        maxtime=1e30, silent=5, device="cpu", **route_opts, **extra)


def _windows(run, start, n, log):
    """Run WINDOWS windows of `n` steps of `run` from step `start`; returns
    {key: [the launch records of each window with that key]}. Each window
    must end with the roles its key predicts."""
    seen = {}
    for _ in range(WINDOWS):
        key = G.window_key(run, start, n)
        end = G.end_roles(run, key, start)
        log.clear()
        run.window(start, n)
        assert log, "a window made no launch"
        assert run.roles() == end, (key, run.roles())
        seen.setdefault(key, []).append(list(log))
        start += n
    return seen


def _assert_key_decides(seen):
    assert any(len(w) > 1 for w in seen.values()), "no key came twice"
    for key, windows in seen.items():
        for w in windows[1:]:
            assert w == windows[0], key


CASES = [("per_sweep", s) for s in ("Sequential", "SequentialSym", "Strang",
                                    "X_only")] + \
    [("pair", s) for s in ("Sequential", "SequentialSym", "Strang")]


@pytest.mark.parametrize("start", [0, 5], ids=["even", "odd"])
@pytest.mark.parametrize("every", [1, 3, 8])
@pytest.mark.parametrize("kind,splitting", CASES,
                         ids=[f"{r}-{s}" for r, s in CASES])
def test_window_launches_follow_key(recorder, kind, splitting, every, start):
    """Per-sweep and pair, four splittings, `check_every` 1, 3 and 8, from
    an even and an odd cycle (a resume), across the run's end: every two
    windows with the same key make the same launches."""
    params = _params(ROUTES[kind], splitting, maxcycle=start + 2 * every + 1)
    cfg = params.config
    assert route(cfg) == kind
    [fs], seed = make_init_fused(params)()
    run = KernelCycles(cfg, None, fs, 0.0, start, 0.0, float(seed),
                       kind == "pair")
    assert run.graphs is None  # the CPU runs the eager loop body
    run.first_step()
    _assert_key_decides(_windows(run, start, every, recorder))


@pytest.mark.parametrize("every", [1, 3, 8])
@pytest.mark.parametrize("blocking", [8, 3], ids=["K8", "K3"])
def test_multicycle_window_launches_follow_key(recorder, blocking, every):
    """The multicycle route: windows of max(1, check_every // K) K5
    launches; with an odd K each launch swaps the buffer roles."""
    params = _params({}, temporal_blocking=blocking, maxcycle=3 * blocking)
    cfg = params.config
    pairs = temporal_pairs(cfg)
    assert len(pairs) == blocking
    [fs], seed = make_init_fused(params)()
    run = MultiCycles(cfg, pairs, fs, 0.0, 0, 0.0, float(seed))
    assert run.graphs is None
    _assert_key_decides(_windows(run, 0, max(1, every // blocking), recorder))


@pytest.mark.parametrize("kind", ["per_sweep", "pair"])
def test_mesh_window_launches_follow_key(recorder, kind):
    """A 2x2 mesh on the CPU: the slab packs read the key's buffers, and
    every shard's launches repeat with the key (Strang, `check_every` 3,
    from an odd cycle)."""
    params = _params(ROUTES[kind], "Strang", P=(2, 2), N=(40, 36),
                     maxcycle=12)
    cfg = params.config
    fs, seed = make_init_fused(params)()
    run = KernelCycles(cfg, make_mesh(params), fs, 0.0, 1, 0.0, float(seed),
                       kind == "pair")
    assert run.slabs and run.graphs is None
    run.first_step()
    seen = _windows(run, 1, 3, recorder)
    _assert_key_decides(seen)
    slabs = {b.data_ptr() for bufs in run.slabs.values() for sides in bufs
             for b in sides if b is not None}
    assert slabs <= _pointers(seen)


def _pointers(rec):
    """Every tensor pointer in a nest of launch records."""
    if isinstance(rec, dict):
        rec = list(rec.values())
    if isinstance(rec, tuple) and rec[:1] == ("T",):
        return {rec[1]}
    if isinstance(rec, (tuple, list)):
        return set().union(*(_pointers(r) for r in rec)) if rec else set()
    return set()


def test_graphs_true_raises_where_graphs_cannot_run():
    """`graphs=True` raises on the CPU, for a mesh across cards, over
    several processes, on the op path; None there runs the eager loop."""
    params = _params(PER_SWEEP, maxcycle=2)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    with pytest.raises(SolverException, match="CPU"):
        make_time_loop_lean(cfg, graphs=True)(fs, 0.0, 0, 0.0, float(seed))
    with pytest.raises(SolverException, match="CPU"):
        armon_torch.armon(params, graphs=True)
    with pytest.raises(SolverException, match="op path"):
        armon_torch.armon(_params(PER_SWEEP, maxcycle=2, kernel_tier="torch"),
                          graphs=True)
    mesh = _params(PER_SWEEP, P=(2, 1), maxcycle=2)
    with pytest.raises(SolverException, match="CPU"):
        armon_torch.armon(mesh, graphs=True)
    shard = make_mesh(mesh).shards[1]
    for reason, what in ((G.eager_reason("cuda", far=[shard]), "across cards"),
                         (G.eager_reason("cuda:0", nprocs=2), "processes")):
        assert what in reason
        assert G.use_graphs(None, reason) is False
        assert G.use_graphs(False, reason) is False
        with pytest.raises(SolverException, match=what):
            G.use_graphs(True, reason)
    assert G.eager_reason("cuda:0") is None
    assert G.use_graphs(None, None) is True


def test_windowed_loop_matches_jax_jnp_tier():
    """The lean loop's windows (Strang on the pair route, `check_every` 3)
    against the JAX package's jnp tier, 10 cycles at 64^2 f64: the same
    cycles, t within 4 eps, fields within 1e-13 of their scale on real
    cells (XLA contracts multiply-adds)."""
    import armon_tpu  # here: the card's machine has no jax
    opts = dict(test="Sod_circ", N=(64, 64), data_type=np.float64,
                axis_splitting="Strang", maxcycle=10, silent=5,
                measure_time=False, return_data=True)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(kernel_tier="jnp", **opts))
    params = armon_torch.ArmonParameters(device="cpu", **PAIR, **opts)
    assert route(params.config) == "pair"
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed),
                                             check_every=3)
    eps = np.finfo(np.float64).eps
    assert res.cycles == js.cycles == 10
    assert abs(res.t - js.final_time) <= 4 * eps * abs(js.final_time)
    g = 4
    for name, b in zip(("rho", "u", "v", "E"), res.carry):
        a = np.asarray(getattr(js.data, name))[g:-g, g:-g]
        b = b.numpy()[g:-g, g:-g]
        assert np.max(np.abs(a - b)) <= 1e-13 * max(1.0, float(np.max(np.abs(a)))), name


# ----------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _bits(a, b):
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _card_run(params, graphs, restore_from=None):
    """`armon()` on the card with `graphs`, the launch counts and the
    graph statistics of the run."""
    K.reset_launches()
    G.reset_stats()
    st = armon_torch.armon(params, restore_from=restore_from, graphs=graphs)
    torch.cuda.synchronize()
    return st, {**K.LAUNCHES, **K.TAILS}, dict(G.STATS)


def _assert_same_run(a, b):
    assert (a.cycles, a.final_time, a.last_dt) == (b.cycles, b.final_time,
                                                   b.last_dt)
    for name in ("rho", "u", "v", "E", "p"):
        assert _bits(getattr(a.data, name), getattr(b.data, name)), name


CARD_CASES = {
    "per_sweep": dict(test="Sod_circ", N=(200, 200), **PER_SWEEP),
    "pair": dict(test="Sedov", N=(160, 160), **PAIR),
    "multicycle": dict(test="Sod", N=(100, 100)),
    "strang_every3": dict(test="Sod_circ", N=(160, 160),
                          axis_splitting="Strang", **PAIR),
    "strang_per_sweep": dict(test="Sod_circ", N=(96, 96),
                             axis_splitting="Strang", **PER_SWEEP),
    "mesh_2x2": dict(test="Sod_circ", N=(200, 200), P=(2, 2),
                     devices=["cuda:0"] * 4, **PER_SWEEP),
    "mesh_1x2_pair": dict(test="Sedov", N=(160, 160), P=(1, 2),
                          devices=["cuda:0"] * 2, **PAIR),
    "per_cycle_driver": dict(test="Sod_circ", N=(160, 160), silent=1,
                             axis_splitting="SequentialSym", **PAIR),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"], ids=["f64", "f32-exact"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_graphs_match_eager_on_card(case, dtype, capsys):
    """Each case through `armon()` with graphs and without: the same bits
    and graphs launched: the per-cycle driver a one-cycle window a cycle,
    with the same launch counts; the lean loop one whole-run graph and
    one host read (its launch counts are those of the eager loop with
    `check_every` the body's length: `test_torch_whole_graph.py`), no
    kernel launched more often than by the eager loop's windows of 8."""
    _card()
    opts = dict(silent=5, maxcycle=43, data_type=dtype, use_fast_math=False,
                return_data=True, device="cuda")
    opts.update(CARD_CASES[case])
    params = lambda: armon_torch.ArmonParameters(**opts)  # noqa: E731
    eager, n_eager, g_eager = _card_run(params(), False)
    graphed, n_graph, g_graph = _card_run(params(), None)
    capsys.readouterr()
    _assert_same_run(graphed, eager)
    assert g_eager["replays"] == 0 and g_graph["replays"] > 0
    assert 0 < g_graph["graphs"] <= 4
    if case == "per_cycle_driver":
        assert n_graph == n_eager
        assert g_graph["replays"] == graphed.cycles
    else:
        assert (g_graph["runs"], g_graph["replays"]) == (1, 1)
        assert graphed.host_reads == 3
        assert n_graph.keys() == n_eager.keys()
        assert all(n_graph[k] <= n_eager[k] for k in n_eager)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"], ids=["f64", "f32-exact"])
def test_resume_at_odd_cycle_on_card(tmp_path, dtype, capsys):
    """A Strang run saved at cycle 7 (by the per-cycle driver) resumed with
    graphs and without: bit for bit, one whole-run graph, no kernel
    launched more often than by the eager loop's windows."""
    _card()
    opts = dict(test="Sod_circ", N=(128, 128), data_type=dtype,
                use_fast_math=False, axis_splitting="Strang", silent=5,
                device="cuda", output_dir=str(tmp_path), output_file="snap",
                **PAIR)
    armon_torch.armon(armon_torch.ArmonParameters(maxcycle=7,
                                                  checkpoint_step=7, **opts))
    snap = str(tmp_path / "snap.ckpt.npz")
    runs = [_card_run(armon_torch.ArmonParameters(maxcycle=30,
                                                  return_data=True, **opts),
                      graphs, snap) for graphs in (False, None)]
    capsys.readouterr()
    (eager, n_eager, _), (graphed, n_graph, g_graph) = runs
    assert graphed.cycles == 30
    _assert_same_run(graphed, eager)
    assert g_graph["runs"] == 1 and graphed.host_reads == 3
    assert all(n_graph[k] <= n_eager[k] for k in n_eager)


@pytest.mark.gpu
def test_graphs_true_raises_across_processes_or_cards_on_card():
    """On the card, `graphs=True` raises for a mesh across cards (here
    its sequencing on one card, `remote`), and runs on a one-card mesh."""
    _card()
    params = armon_torch.ArmonParameters(test="Sod", N=(64, 64), P=(2, 1),
                                         devices=["cuda:0"] * 2, maxcycle=4,
                                         silent=5, device="cuda", **PER_SWEEP)
    fs, seed = make_init_fused(params)()
    mesh = make_mesh(params)
    with pytest.raises(SolverException, match="across cards"):
        make_time_loop_lean(params.config, mesh, remote=(1,), graphs=True)(
            fs, 0.0, 0, 0.0, float(seed))
    res = make_time_loop_lean(params.config, mesh, graphs=True)(
        fs, 0.0, 0, 0.0, float(seed))
    assert res.cycles == 4
