"""The whole-run graph (`armon_torch/core/graphs.py` `CycleGraphs.run`,
`armon_torch/csrc/graph.cu`): a lean run as one CUDA graph, a conditional
WHILE node whose body is one or two steps' launches, the last of which
sets the node's condition (K1, K2 or K4's tail, or K5), the counterpart of
the JAX package's `lax.while_loop`.

On the CPU, where no graph runs:
- the body plan (`graphs.body_steps`): the fewest steps, 1 or 2, after
  which the schedule's parity and the buffer roles come back, on every
  route, under Sequential, Godunov, Strang and SequentialSym, from even
  and odd starts; bodies run one after another make the same launches (a
  recorder on the wrappers' dispatch, as in `test_torch_graphs.py`), and
  a body one step shorter would not; in a body as the whole-run graph
  records it exactly one launch carries the WHILE condition
  (`ops/sweep.Cond`), the body's last, which carries K3's tail on the
  per-sweep and pair routes, and no eager or window launch carries one;
- the kernels' argument mirrors (`ops/_build`) against the structs the
  CUDA sources declare, field by field, offsets included, and the
  arguments of a launch that sets the condition against those of one
  that does not;
- the WHILE node's plain version (`graphs.while_plain`: bodies run
  eagerly, the predicate read after each) bit for bit against the
  windowed eager loop, and against the JAX package's jnp tier at 24x20 in
  f64 within the tolerance of `test_windowed_loop_matches_jax_jnp_tier`;
- `whole` on the CPU (the eager loop whatever it says), the refusals of
  `graphs=True`, and `armon()`'s choice of `whole` (False for a traced
  run).
On the card (marked `gpu`): the whole-run graph against `graphs=False`
and against window graphs bit for bit (f64 and f32 exact) on every path,
one graph launch and one host read a run, the launch counts of the eager
loop with `check_every` the body's length, as many iterations as the
eager loop's bodies, the condition set once a body, and a run whose dt
gate fails on every route; a condition refused outside a capture.
"""

import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import armon_torch
from armon_torch.core import graphs as G
from armon_torch.core.solver import make_init_fused, make_mesh
from armon_torch.core.step import (KernelCycles, MultiCycles, launch_groups,
                                   make_time_loop_lean)
from armon_torch.ops import _build
from armon_torch.ops import sweep as K
from armon_torch.ops.routing import cycle_route, route, temporal_pairs
from armon_torch.utils.errors import SolverException

from test_torch_graphs import recorder  # noqa: F401 (a fixture)

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)
ROUTES = {"per_sweep": PER_SWEEP, "pair": PAIR}
SPLITTINGS = ("Sequential", "Godunov", "Strang", "SequentialSym")
# A body of one cycle needs one schedule for both parities and an even
# number of launches a cycle: only Sequential per-sweep (K1, K2) has both.
ONE_CYCLE = {("per_sweep", "Sequential")}


def _params(route_opts, splitting="Sequential", N=(24, 20), dtype="float64",
            **extra):
    return armon_torch.ArmonParameters(
        test="Sod_circ", N=N, data_type=dtype, axis_splitting=splitting,
        maxtime=1e30, silent=5, device="cpu", **route_opts, **extra)


def _bodies(run, start, n, log, count=4):
    """`count` bodies of `n` steps of `run` from `start`, eagerly (window
    launches: none carries a WHILE condition); each must end with the
    buffer roles it started with. Returns each body's launch records."""
    out = []
    for _ in range(count):
        roles = run.roles()
        log.clear()
        run.window(start, n)
        assert run.roles() == roles
        assert not any(_carries(r, "Cond") for r in log)
        out.append(list(log))
        start += n
    return out


def _carries(record, kind):
    """Whether a launch record (`test_torch_graphs._sig`) holds an
    object of type `kind` (a `Cond`, a `Finish`)."""
    if isinstance(record, tuple):
        return (len(record) == 2 and record[0] == kind) or \
            any(_carries(r, kind) for r in record)
    return False


def _recorded_body(run, start, n, log):
    """One body of `n` steps of `run` from `start`, made as
    `CycleGraphs.run` records it (`graphs._steps` with a WHILE condition;
    on the CPU the launches run, and the condition's plain version counts
    the iteration): (its launch records, the `Cond`)."""
    cond = K.Cond(1, torch.zeros(1, dtype=torch.int32))
    log.clear()
    G._steps(run, start, n, run.roles(), cond)()
    return list(log), cond


def _assert_last_sets_cond(records, cond, finishing=True):
    """Exactly one launch of a body carried `cond`, once: the body's last,
    which (`finishing`) also carries K3's tail; its plain version counted
    one iteration."""
    sets = [i for i, r in enumerate(records) if _carries(r, "Cond")]
    assert sets == [len(records) - 1], sets
    assert cond.launches == 1 and int(cond.count) == 1
    if finishing:
        fins = [i for i, r in enumerate(records) if _carries(r, "Finish")]
        assert fins and fins[-1] == sets[0]


@pytest.mark.parametrize("start", [0, 5], ids=["even", "odd"])
@pytest.mark.parametrize("splitting", SPLITTINGS)
@pytest.mark.parametrize("kind", list(ROUTES))
def test_body_plan(recorder, kind, splitting, start):
    """The body is 1 cycle only for Sequential per-sweep, 2 otherwise;
    bodies repeat their launches, and where it is 2 one cycle would not
    (another schedule or swapped roles)."""
    params = _params(ROUTES[kind], splitting, maxcycle=start + 20)
    cfg = params.config
    assert route(cfg) == kind
    [fs], seed = make_init_fused(params)()
    run = KernelCycles(cfg, None, fs, 0.0, start, 0.0, float(seed),
                       kind == "pair")
    run.first_step()
    n = G.body_steps(run, start)
    assert n == (1 if (kind, splitting) in ONE_CYCLE else 2)
    bodies = _bodies(run, start, n, recorder)
    assert all(b == bodies[0] for b in bodies[1:])
    if n == 2:
        sched = run.even, run.odd
        swapped = len(launch_groups(sched[start % 2], run.pair)) % 2
        assert swapped or sched[0] != sched[1]
    records, cond = _recorded_body(run, start + 4 * n, n, recorder)
    assert len(records) == len(bodies[0])
    _assert_last_sets_cond(records, cond)


@pytest.mark.parametrize("blocking", [8, 3], ids=["K8", "K3"])
def test_body_plan_multicycle(recorder, blocking):
    """K5: one launch a body where it leaves the buffer roles as they were
    (K even), two where each launch swaps them (K odd)."""
    params = _params({}, temporal_blocking=blocking, maxcycle=8 * blocking)
    pairs = temporal_pairs(params.config)
    assert len(pairs) == blocking
    [fs], seed = make_init_fused(params)()
    run = MultiCycles(params.config, pairs, fs, 0.0, 0, 0.0, float(seed))
    n = G.body_steps(run, 0)
    assert n == (1 if blocking % 2 == 0 else 2)
    bodies = _bodies(run, 0, n, recorder, count=3)
    assert all(b == bodies[0] for b in bodies[1:])
    records, cond = _recorded_body(run, 3 * n, n, recorder)
    assert len(records) == n
    _assert_last_sets_cond(records, cond, finishing=False)


@pytest.mark.parametrize("P", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
@pytest.mark.parametrize("kind", list(ROUTES))
def test_body_plan_mesh_sets_cond_last(recorder, kind, P):
    """A mesh on one device (here the CPU): in a recorded body, the last
    shard's last launch alone carries the WHILE condition, with K3's tail
    over every shard's partials; window launches carry none (Strang from
    an odd cycle: a body of two cycles)."""
    params = _params(ROUTES[kind], "Strang", P=P, N=(40, 36), maxcycle=12)
    cfg = params.config
    fs, seed = make_init_fused(params)()
    mesh = make_mesh(params)
    run = KernelCycles(cfg, mesh, fs, 0.0, 1, 0.0, float(seed),
                       kind == "pair")
    run.first_step()
    n = G.body_steps(run, 1)
    assert n == 2
    bodies = _bodies(run, 1, n, recorder, count=2)
    records, cond = _recorded_body(run, 1 + 2 * n, n, recorder)
    assert len(records) == len(bodies[0])
    _assert_last_sets_cond(records, cond)
    last = records[-1]
    assert _carries(last, "Finish")
    # The carrier is the last shard's launch: its real extent is the last
    # shard's.
    assert mesh.local[-1].n_real in (last[1][-3], last[1][-4])


def test_cond_plain_version_and_refusals():
    """The condition's plain version counts an iteration a launch that
    carries it; a launch without K3's tail refuses one (it would have no
    predicate to set it from); the WHILE node's measurement body
    (`graphs.countdown`) with `while_plain` ends at 0 after as many
    iterations as it started with, and counts one a body where the
    recorded body carries the condition."""
    params = _params(PAIR, maxcycle=4)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    run = KernelCycles(cfg, None, fs, 0.0, 0, 0.0, float(seed), True)
    run.first_step()
    cond = K.Cond(7, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(SolverException, match="K3's tail"):
        K.check_finish(None, True, cond)
    K.check_finish(run.finish[next(iter(run.finish))], True, cond)
    K.check_cond(None, torch.device("cpu"))
    K.check_cond(cond, torch.device("cpu"))
    K.cond_plain(cond)
    K.cond_plain(None)
    assert cond.launches == 1 and int(cond.count) == 1

    class Countdown:
        def __init__(self, n):
            self.iscal = torch.tensor([n], dtype=torch.int32)
            self.cur = self.nxt = [(self.iscal,)]

        def cycle(self, i, cond=None):
            G.countdown(self.iscal, cond)

        def parity(self, i):
            return 0

        def swaps(self, i):
            return 0

        def roles(self):
            return 0
    G.reset_launches()
    body = Countdown(5)
    assert G.while_plain(body, 0, 1, 0) == 5 and int(body.iscal) == 0
    body = Countdown(3)
    cond = K.Cond(7, torch.zeros(1, dtype=torch.int32))
    for i in range(3):
        G._steps(body, i, 1, 0, cond)()
    assert (int(body.iscal), int(cond.count), cond.launches) == (0, 3, 3)
    assert G.MEASURE["countdown"] == 0  # the plain version launches nothing


# ------------------------------------------------ the kernels' arguments

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "armon_torch", "csrc")
# The C types the argument structs use, as ctypes types.
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "double": ctypes.c_double,
           "cudaGraphConditionalHandle": ctypes.c_ulonglong}
MIRRORS = [("DtParams", "common.cuh"), ("FinishArgs", "common.cuh"),
           ("SweepArgs", "sweep.cuh"), ("CycleArgs", "cycle.cuh"),
           ("MultiArgs", "cycle.cuh"), ("CflArgs", "cfl.cu"),
           ("McArgs", "cluster.cuh"), ("FfSumArgs", "reduce.cu"),
           ("ChainArgs", "probe_ff.cu"), ("IoArgs", "probe_stream.cu")]


def _declared(name, source):
    """The fields of `struct name` in csrc/`source`, in order: [(field,
    ctypes type)], from the declaration's text (pointers as c_void_p,
    arrays as ctypes arrays, `K_COUNT` as the EOS constants' count,
    other structs by their mirrors)."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(?:const\s+)?(long long|\w+)\s*(\*?)\s*(.*)$", decl,
                     re.S)
        ctype, pointer, names = m.groups()
        if pointer:
            base = ctypes.c_void_p
        elif ctype in C_TYPES:
            base = C_TYPES[ctype]
        else:
            base = getattr(_build, ctype)
        for item in (n.strip() for n in names.split(",")):
            arr = re.match(r"(\w+)\[(\w+)\]$", item)
            if arr:
                count = len(_build.EOS_KEYS) if arr.group(2) == "K_COUNT" \
                    else int(arr.group(2))
                fields.append((arr.group(1), base * count))
            else:
                fields.append((item, base))
    return fields


@pytest.mark.parametrize("name,source", MIRRORS,
                         ids=[n for n, _ in MIRRORS])
def test_argument_mirror_matches_source(name, source):
    """Each ctypes mirror in `ops/_build` has the fields the CUDA source
    declares, in its order, each at the offset and of the size that the
    declared types give (the same C layout rules), and the same total
    size; `FinishArgs` and `MultiArgs` end with the WHILE condition's
    handle and count."""
    declared = _declared(name, source)
    mirror = getattr(_build, name)
    assert [f for f, _ in declared] == [f for f, _ in mirror._fields_]
    want = type(name, (ctypes.Structure,), {"_fields_": declared})
    for field, _ in declared:
        a, b = getattr(want, field), getattr(mirror, field)
        assert (a.offset, a.size) == (b.offset, b.size), field
    assert ctypes.sizeof(want) == ctypes.sizeof(mirror)
    if name in ("FinishArgs", "MultiArgs"):
        assert [f for f, _ in declared[-2:]] == ["cond", "count"]


def test_finish_args_with_cond():
    """The arguments of the finishing launch that sets the WHILE condition
    (`_build._finish_args` with a `Cond`): the cycle's own, kept on the
    `Finish` for every other launch with handle 0, byte for byte but the
    handle and the count's pointer; the copy kept on the `Cond`. K5's
    arguments take the same two fields (`_cond_fields`)."""
    params = _params(PAIR, maxcycle=4)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    run = KernelCycles(cfg, None, fs, 0.0, 0, 0.0, float(seed), True)
    nb, fin = next(iter(run.finish.items()))
    part = run.parts[nb][0]
    plain = _build._finish_args(cfg, fin, part, nb, run.scal, run.iscal)
    count = torch.zeros(1, dtype=torch.int32)
    cond = K.Cond(0x1234, count)
    carried = _build._finish_args(cfg, fin, part, nb, run.scal, run.iscal,
                                  cond)
    a, b = plain._obj, carried._obj
    assert (a.cond, a.count) == (0, None)
    assert (b.cond, b.count) == (0x1234, count.data_ptr())
    assert cond.args is b and fin.args[2]._obj is a
    off = _build.FinishArgs.cond.offset
    assert bytes(a)[:off] == bytes(b)[:off]
    assert _build._finish_args(cfg, fin, part, nb, run.scal, run.iscal) \
        is plain
    m = _build.MultiArgs()
    _build._cond_fields(m, None, count.device)
    assert (m.cond, m.count) == (0, None)
    _build._cond_fields(m, cond, count.device)
    assert (m.cond, m.count) == (0x1234, count.data_ptr())


def _advanced(params, start, kind=None):
    """The initial carry, run eagerly to cycle `start` (a resume):
    (carry, t, dt, lm)."""
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    if not start:
        return fs, 0.0, 0.0, float(seed)
    res = make_time_loop_lean(dataclasses.replace(cfg, maxcycle=start),
                              kind=kind, graphs=False)(fs, 0.0, 0, 0.0,
                                                       float(seed))
    return res.carry, res.t, res.dt_last, res.lm


def _clone(fs):
    return type(fs)(*(a.clone() for a in fs))


def _same(a, b):
    assert (a.cycles, a.ok) == (b.cycles, b.ok)
    for name in ("t", "dt_last", "lm"):
        x, y = getattr(a, name), getattr(b, name)
        assert np.float64(x).tobytes() == np.float64(y).tobytes(), name
    for x, y in zip(a.carry, b.carry):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))


def _while_plain_run(params, fs, t, start, dt, lm, kind):
    """The lean loop's run with `while_plain` in place of its windows:
    (LoopResult, iterations, body steps)."""
    cfg = params.config
    if kind == "multicycle":
        run = MultiCycles(cfg, temporal_pairs(cfg), fs, t, start, dt, lm)
        start, pred = 0, K.IS_NEXT
    else:
        run = KernelCycles(cfg, None, fs, t, start, dt, lm, kind == "pair")
        run.first_step()
        pred = K.IS_RUN
    n = G.body_steps(run, start)
    iters = G.while_plain(run, start, n, pred)
    return run.result(1), iters, n


PLAIN_CASES = [("per_sweep", "Sequential", 0), ("per_sweep", "Strang", 5),
               ("pair", "SequentialSym", 0), ("pair", "Sequential", 7),
               ("multicycle", "Sequential", 0)]


@pytest.mark.parametrize("kind,splitting,start", PLAIN_CASES,
                         ids=[f"{k}-{s}-{c}" for k, s, c in PLAIN_CASES])
def test_while_plain_matches_windowed_loop(kind, splitting, start):
    """Bodies until the predicate falls, read after each, against the
    windowed eager loop (`check_every` 8) from the same carry: the same
    bits, the same scalars; one read a run plus the result's two; as many
    bodies as cover the cycles run."""
    opts = PER_SWEEP if kind == "per_sweep" else \
        PAIR if kind == "pair" else dict(temporal_blocking=3)
    maxcycle = 19
    params = _params(opts, splitting, maxcycle=maxcycle)
    assert route(params.config) == kind
    fs, t, dt, lm = _advanced(params, start)
    want = make_time_loop_lean(params.config)(_clone(fs), t, start, dt, lm,
                                              check_every=8)
    got, iters, n = _while_plain_run(params, _clone(fs), t, start, dt, lm,
                                     kind)
    _same(got, want)
    assert got.cycles == maxcycle and got.host_reads == 3
    per_step = 3 if kind == "multicycle" else 1
    assert iters == -(-(maxcycle - start) // (n * per_step))


def test_while_plain_stops_on_failed_dt_gate():
    """A NaN in u fails the dt gate: the bodies stop where the windowed
    loop stops, ok false, lm NaN."""
    params = _params(PAIR, "Strang", maxcycle=20)
    fs, t, dt, lm = _advanced(params, 0)
    g = params.config.nghost
    fs.u[g + 5, g + 7] = float("nan")
    want = make_time_loop_lean(params.config)(_clone(fs), t, 0, dt, lm)
    got, _, _ = _while_plain_run(params, _clone(fs), t, 0, dt, lm, "pair")
    assert not got.ok and got.cycles < 20 and np.isnan(got.lm)
    _same(got, want)


def test_while_plain_matches_jax_jnp_tier():
    """The WHILE node's plain version (Strang on the pair route, bodies of
    two cycles) against the JAX package's jnp tier, Sod_circ 24x20 f64 to
    its maxtime (9 cycles: the run stops inside a body): the same cycles,
    t within 4 eps, fields within 1e-13 of their scale on real cells (XLA
    contracts multiply-adds)."""
    import armon_tpu  # here: the card's machine has no jax
    opts = dict(test="Sod_circ", N=(24, 20), data_type=np.float64,
                axis_splitting="Strang", maxcycle=10, silent=5,
                measure_time=False, return_data=True)
    js = armon_tpu.armon(armon_tpu.ArmonParameters(kernel_tier="jnp", **opts))
    params = armon_torch.ArmonParameters(device="cpu", **PAIR, **opts)
    [fs], seed = make_init_fused(params)()
    res, iters, n = _while_plain_run(params, fs, 0.0, 0, 0.0, float(seed),
                                     "pair")
    eps = np.finfo(np.float64).eps
    assert res.cycles == js.cycles and n == 2
    assert iters == -(-res.cycles // 2)
    assert abs(res.t - js.final_time) <= 4 * eps * abs(js.final_time)
    g = 4
    for name, b in zip(("rho", "u", "v", "E"), res.carry):
        a = np.asarray(getattr(js.data, name))[g:-g, g:-g]
        b = b.numpy()[g:-g, g:-g]
        assert np.max(np.abs(a - b)) <= 1e-13 * max(1.0, float(np.max(np.abs(a)))), name


def test_whole_refusals():
    """On the CPU no graph runs: the lean loop runs eagerly with `whole`
    True or False, `graphs` None or False, the same bits and one host
    read a window (3 with the result's two at 2 cycles); `graphs=True`
    raises through the loop builders and `armon()`."""
    params = _params(PER_SWEEP, maxcycle=2)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    runs = []
    for graphs in (None, False):
        for whole in (True, False):
            G.reset_stats()
            runs.append(make_time_loop_lean(cfg, graphs=graphs, whole=whole)(
                _clone(fs), 0.0, 0, 0.0, float(seed)))
            assert G.STATS["graphs"] == G.STATS["runs"] == 0
    for res in runs:
        assert res.cycles == 2 and res.host_reads == 3
        _same(res, runs[0])
    for whole in (True, False):
        with pytest.raises(SolverException, match="CPU"):
            make_time_loop_lean(cfg, graphs=True, whole=whole)(
                _clone(fs), 0.0, 0, 0.0, float(seed))
    with pytest.raises(SolverException, match="CPU"):
        armon_torch.armon(params, graphs=True)


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_traced_run_keeps_window_graphs(tmp_path, monkeypatch, traced):
    """`armon()` asks the lean loop for the whole-run graph (`whole`
    True) unless the run is traced (`profiling=["trace"]`), which keeps
    window graphs (`whole=False`): the trace loses the last cycles'
    kernel records of a whole-run graph on the card."""
    from armon_torch.core import solver
    seen = []

    def spy(*args, _real=solver.make_time_loop_lean):
        seen.append(args[5])
        return _real(*args)
    monkeypatch.setattr(solver, "make_time_loop_lean", spy)
    solver.clear_cache()  # a kept loop would not be built again
    params = armon_torch.ArmonParameters(
        test="Sod", N=(24, 20), maxcycle=3, silent=5, device="cpu",
        output_dir=str(tmp_path), **PER_SWEEP,
        **(dict(profiling=["trace"]) if traced else {}))
    assert armon_torch.armon(params).cycles == 3
    assert seen == [not traced]


# ----------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _card_loop(params, fs, t, start, dt, lm, graphs, whole=True, every=8,
               kind=None, mesh=None):
    """One lean run on the card: (LoopResult, launch counts, graph
    statistics)."""
    K.reset_launches()
    G.reset_launches()
    G.reset_stats()
    carry = [_clone(f) for f in fs] if isinstance(fs, list) else _clone(fs)
    res = make_time_loop_lean(params.config, mesh, kind=kind, graphs=graphs,
                              whole=whole)(carry, t, start, dt, lm,
                                           check_every=every)
    torch.cuda.synchronize()
    return res, {**K.LAUNCHES, **K.TAILS}, {**G.STATS, **G.LAUNCHES}


def _same_card(a, b):
    assert (a.cycles, a.ok) == (b.cycles, b.ok)
    for name in ("t", "dt_last", "lm"):
        x, y = getattr(a, name), getattr(b, name)
        assert np.float64(x).tobytes() == np.float64(y).tobytes(), name
    ca = a.carry if isinstance(a.carry, list) else [a.carry]
    cb = b.carry if isinstance(b.carry, list) else [b.carry]
    for fa, fb in zip(ca, cb):
        for x, y in zip(fa, fb):
            w = torch.int64 if x.dtype == torch.float64 else torch.int32
            assert torch.equal(x.view(w), y.view(w))


WHOLE_CASES = {
    "per_sweep": (dict(test="Sod_circ", N=(200, 200), **PER_SWEEP), 0),
    "per_sweep_sequential_odd": (dict(test="Sod", N=(160, 96),
                                      **PER_SWEEP), 7),
    "pair": (dict(test="Sedov", N=(160, 160), **PAIR), 0),
    "multicycle": (dict(test="Sod", N=(100, 100)), 0),
    "multicycle_K3": (dict(test="Sod", N=(100, 100), temporal_blocking=3), 0),
    "strang_pair_odd": (dict(test="Sod_circ", N=(128, 128),
                             axis_splitting="Strang", **PAIR), 7),
    "mesh_2x2": (dict(test="Sod_circ", N=(200, 200), P=(2, 2),
                      devices=["cuda:0"] * 4, **PER_SWEEP), 0),
    "mesh_1x2_pair": (dict(test="Sedov", N=(160, 160), P=(1, 2),
                           devices=["cuda:0"] * 2, **PAIR), 0),
    # The full-state restore loop's builder call (`kind=cycle_route`) on a
    # grid the lean loop sends to K5, resumed at an odd cycle.
    "restore_loop_odd": (dict(test="Sod", N=(100, 100)), 7),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"], ids=["f64", "f32-exact"])
@pytest.mark.parametrize("case", list(WHOLE_CASES))
def test_whole_run_matches_eager_on_card(case, dtype):
    """Whole-run graph, window graphs and the eager loop:
    the same bits; one graph launch and one host read a whole run; its
    launch counts those of the eager loop with `check_every` the body's
    length, and its iterations that loop's bodies (its host reads but the
    result's two); the condition set by the body's last launch once an
    iteration (`while_tail`), and no condition kernel counted."""
    _card()
    opts, start = WHOLE_CASES[case]
    params = armon_torch.ArmonParameters(
        data_type=dtype, use_fast_math=False, silent=5, device="cuda",
        maxcycle=43, maxtime=1e30, **opts)
    cfg = params.config
    kind = cycle_route(cfg) if case.startswith("restore") else None
    mesh = make_mesh(params) if params.config.spmd else None
    if mesh is not None:
        fs, seed = make_init_fused(params)()
        t, dt, lm = 0.0, 0.0, float(seed)
    else:
        fs, t, dt, lm = _advanced(params, start, kind)
    args = (params, fs, t, start, dt, lm)
    eager, _, _ = _card_loop(*args, False, kind=kind, mesh=mesh)
    windows, _, g_win = _card_loop(*args, None, False, kind=kind, mesh=mesh)
    assert g_win["runs"] == 0 and g_win["replays"] > 0
    multi = (kind or route(cfg)) == "multicycle"
    k = len(temporal_pairs(cfg)) if multi else 1
    res, n_whole, g = _card_loop(*args, None, kind=kind, mesh=mesh)
    _same_card(res, eager)
    _same_card(windows, eager)
    assert (g["runs"], g["replays"], g["graphs"]) == (1, 1, 1)
    assert res.host_reads == 3
    body = G.body_steps(MultiCycles(cfg, temporal_pairs(cfg), fs, t, start,
                                    dt, lm) if multi else
                        KernelCycles(cfg, mesh, fs, t, start, dt, lm,
                                     (kind or route(cfg)) == "pair"),
                        0 if multi else start)
    assert g["body_steps"] == body
    assert g["while_tail"] == g["iterations"] == \
        -(-(res.cycles - start) // (body * k))
    assert "while_cond" not in g
    by_body, n_eager, _ = _card_loop(*args, False, every=body * k, kind=kind,
                                     mesh=mesh)
    assert n_whole == n_eager
    assert g["iterations"] == by_body.host_reads - 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["per_sweep", "pair", "multicycle"])
def test_whole_run_failed_dt_gate_on_card(kind):
    """A NaN in u: the whole-run graph stops at the eager loop's cycle,
    ok false, with its bits: the predicate the body's last launch sets the
    condition from falls through ok (K5's iscal[next] on the multicycle
    route, Sod_circ 100^2, a K5 grid)."""
    _card()
    params = armon_torch.ArmonParameters(
        test="Sod_circ", N=(100, 100) if kind == "multicycle" else (128, 128),
        data_type="float64", silent=5, device="cuda", maxcycle=40,
        **ROUTES.get(kind, {}))
    assert route(params.config) == kind
    fs, t, dt, lm = _advanced(params, 0)
    g = params.config.nghost
    fs.u[g + 5, g + 7] = float("nan")
    eager, _, _ = _card_loop(params, fs, t, 0, dt, lm, False)
    whole, _, stats = _card_loop(params, fs, t, 0, dt, lm, None)
    assert not whole.ok and whole.cycles < 40 and stats["runs"] == 1
    assert stats["while_tail"] == stats["iterations"] >= 1
    _same_card(whole, eager)


@pytest.mark.gpu
def test_cond_refused_outside_capture_on_card():
    """A launch on the card carries a WHILE condition only inside the
    capture of a whole-run graph's body: an eager one raises before it
    launches (the handle would name no running WHILE node)."""
    _card()
    params = armon_torch.ArmonParameters(
        test="Sod", N=(64, 64), data_type="float64", silent=5,
        device="cuda", maxcycle=4, **PAIR)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    run = KernelCycles(cfg, None, fs, 0.0, 0, 0.0, float(seed), True,
                       graphs=False)
    run.first_step()
    cond = K.Cond(1, torch.zeros(1, dtype=torch.int32, device="cuda"))
    K.reset_launches()
    with pytest.raises(SolverException, match="inside its capture"):
        run.cycle(0, cond)
    with pytest.raises(SolverException, match="inside its capture"):
        G.countdown(torch.ones(1, dtype=torch.int32, device="cuda"), cond)
    assert K.LAUNCHES["cycle"] == 0 and int(cond.count.item()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"], ids=["f64", "f32-exact"])
def test_whole_run_restore_through_armon_on_card(tmp_path, dtype, capsys):
    """Through `armon()`: Sod 100^2 (the lean loop's K5 grid) saved at the
    odd cycle 7 resumes through the full-state restore loop, as one
    whole-run graph, bit for bit with `graphs=False`."""
    _card()
    opts = dict(test="Sod", N=(100, 100), data_type=dtype,
                use_fast_math=False, silent=5, device="cuda",
                output_dir=str(tmp_path), output_file="snap")
    armon_torch.armon(armon_torch.ArmonParameters(maxcycle=7,
                                                  checkpoint_step=7, **opts))
    snap = str(tmp_path / "snap.ckpt.npz")
    runs = []
    for graphs in (False, None):
        G.reset_stats()
        st = armon_torch.armon(armon_torch.ArmonParameters(
            maxcycle=40, return_data=True, **opts), restore_from=snap,
            graphs=graphs)
        runs.append((st, dict(G.STATS)))
    capsys.readouterr()
    (eager, _), (whole, stats) = runs
    assert whole.cycles == eager.cycles == 40 and stats["runs"] == 1
    assert whole.host_reads == 3
    for name in ("rho", "u", "v", "E", "p"):
        a, b = getattr(whole.data, name), getattr(eager.data, name)
        w = torch.int64 if a.dtype == torch.float64 else torch.int32
        assert torch.equal(a.view(w), b.view(w)), name
