"""The JAX package's loop entry points and program cache in the port
(`armon_torch/core/solver.py` `_cached`, `make_jit_loop_lean`,
`make_jit_loop`, `make_cycle`; `armon_tpu/core/solver.py:66-93,193-210,
326-345`), and the value semantics of the kernel loops
(`core/step.LeanLoop`, `KernelCycles`, `MultiCycles`).

A kernel loop owns its buffers: a call copies the caller's carry into
them and refills the device scalars in place, so the caller's carry stays
as it was, two calls on one carry give the same bits, and a result's
carry is a copy that a later call does not write. The program cache keeps
a loop (its buffers, scalars and graphs) per configuration, this
process's devices and the loop's form, so that a warm call replays what
an earlier call captured; the JAX package keeps its compiled programs
the same way.

On the CPU the loops run the kernels' plain versions (Sod_circ 24x20 and
64^2, f64): every route and the restore loop against their own first
call; the pair route's two calls against the JAX package's
`make_jit_loop_lean` called twice (its Pallas tier interpreted, x64 on),
and the multicycle route bit for bit against the pair route; the cache's
key, its explicit-devices rule, its LRU bound, its eviction by memory
(a stand-in for the card's free bytes) and its agreement over processes;
`armon()` twice; two gloo processes (this file run as a worker) that hit
together, and `dist.shutdown` emptying the cache. The card tests (marked
`gpu`) hold cold, warm and `graphs=False` calls bit for bit on every
route, with no capture on a warm call and equal launch counts.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # run as a worker, below

import armon_torch
from armon_torch.core import graphs as G
from armon_torch.core import solver
from armon_torch.core.solver import (make_cycle, make_init, make_init_fused,
                                     make_jit_loop, make_jit_loop_lean)
from armon_torch.core.step import layout, make_time_loop_lean
from armon_torch.ops import sweep as K
from armon_torch.ops.eos import update_eos
from armon_torch.ops.routing import route
from armon_torch.utils.errors import SolverException

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)
ROUTES = {"per_sweep": PER_SWEEP, "pair": PAIR, "multicycle": {}}
CYCLES = 7
NPROCS = 2
JOB_TIMEOUT = 120  # seconds


def _params(opts=PAIR, device="cpu", **extra):
    return armon_torch.ArmonParameters(**{
        **dict(test="Sod_circ", N=(24, 20), data_type="float64",
               maxcycle=CYCLES, silent=5, measure_time=False, device=device),
        **opts, **extra})


@pytest.fixture(autouse=True)
def empty_cache():
    """Each test starts from an empty program cache and leaves one."""
    solver.clear_cache()
    yield
    solver.clear_cache()


def _clone(fs):
    return [type(f)(*(a.clone() for a in f)) for f in fs]


def _bits(a, b):
    w = {torch.float64: torch.int64, torch.float32: torch.int32}
    return a.shape == b.shape and torch.equal(a.view(w[a.dtype]),
                                              b.view(w[b.dtype]))


def _same_carry(a, b):
    return all(_bits(x, y) for f, g in zip(a, b) for x, y in zip(f, g))


def _scalars(res):
    return (res.cycles, np.float64(res.t).tobytes(),
            np.float64(res.dt_last).tobytes(), np.float64(res.lm).tobytes(),
            res.ok)


def _carry_list(c):
    return c if isinstance(c, list) else [c]


def _twice(loop, fs, *args):
    """Two calls of `loop` on the carry `fs`: (first result, a copy of its
    carry taken before the second call, second result)."""
    first = loop(fs, *args)
    kept = _clone(_carry_list(first.carry))
    second = loop(fs, *args)
    return first, kept, second


def _value_semantics(fs, before, first, kept, second):
    assert _same_carry(fs, before), "the call wrote into its input carry"
    assert _scalars(first) == _scalars(second)
    assert _same_carry(_carry_list(first.carry), _carry_list(second.carry)), \
        "the second pass differs from the first"
    assert _same_carry(_carry_list(first.carry), kept), \
        "the second call overwrote the first call's result"


# ------------------------------------------------------ value semantics

@pytest.mark.parametrize("kind", list(ROUTES))
def test_lean_loop_keeps_its_input(kind):
    """`make_time_loop_lean(cfg)` called twice on one carry, on each route
    (the fault this repairs: the loop kept the caller's tensors as its
    buffers, so the input changed, the second pass started where the
    first ended, and overwrote the first result): the input stays bit for
    bit, the passes are equal, the first result stays."""
    params = _params(ROUTES[kind])
    assert route(params.config) == kind
    fs, seed = make_init_fused(params)()
    before = _clone(fs)
    loop = make_time_loop_lean(params.config)
    first, kept, second = _twice(loop, fs, 0.0, 0, 0.0, float(seed))
    assert first.cycles == CYCLES
    _value_semantics(fs, before, first, kept, second)


def test_restore_loop_keeps_its_input():
    """The kernels' full-state restore loop (`make_jit_loop(params,
    restore=True)`), from a mid-run State with its carry, twice: the
    input States stay, the passes are equal, the first result stays."""
    params = _params(PAIR, maxcycle=3)
    fs, seed = make_init_fused(params)()
    mid = make_time_loop_lean(params.config)(
        fs, 0.0, 0, 0.0, float(seed), check_every=1)
    states = solver.make_rehydrate(params)(_clone(_carry_list(mid.carry)))
    states = [st._replace(c=torch.zeros_like(st.c)) for st in states]
    before = [type(s)(*(a.clone() for a in s)) for s in states]
    loop = make_jit_loop(_params(PAIR), restore=True)
    first, kept, second = _twice(loop, states, mid.t, mid.cycles,
                                 mid.dt_last, mid.lm)
    assert mid.cycles == 3 and first.cycles == CYCLES
    _value_semantics(states, before, first, kept, second)


def test_full_state_loop_matches_lean_loop():
    """`make_jit_loop(params)` over the kernels from `make_init`'s States
    (the cycle-0 EOS and the CFL seed inside) gives the lean loop's run
    from `make_init_fused`, bit for bit, on the route of one cycle."""
    params = _params(PER_SWEEP)
    states = make_init(params)()
    before = [type(s)(*(a.clone() for a in s)) for s in states]
    res = make_jit_loop(params)(states)
    fs, seed = make_init_fused(params)()
    want = make_jit_loop_lean(params)(fs, 0.0, 0, 0.0, float(seed))
    assert _scalars(res) == _scalars(want)
    assert all(_bits(getattr(s, f), getattr(w, f))
               for s, w in zip(res.carry, want.carry)
               for f in ("rho", "u", "v", "E", "p"))
    assert _same_carry(states, before)


def test_failed_run_leaves_nothing_to_the_next_call():
    """A call whose dt gate fails (a NaN in u: ok false, lm NaN), then a
    call on a clean carry: the second gives what a new loop gives, bit
    for bit, ok true."""
    params = _params(PAIR)
    fs, seed = make_init_fused(params)()
    bad = _clone(fs)
    bad[0].u[9, 11] = float("nan")
    loop = make_time_loop_lean(params.config)
    failed = loop(bad, 0.0, 0, 0.0, float(seed))
    assert not failed.ok and failed.cycles < CYCLES
    got = loop(fs, 0.0, 0, 0.0, float(seed))
    want = make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))
    assert got.ok and _scalars(got) == _scalars(want)
    assert _same_carry(_carry_list(got.carry), _carry_list(want.carry))


def test_carry_of_another_layout_is_refused():
    """A loop's buffers are made in its first carry's layout; a carry laid
    out otherwise is refused, and the loop keeps its body."""
    params = _params(PAIR)
    loop = make_time_loop_lean(params.config)
    fs, seed = make_init_fused(params)()
    loop(fs, 0.0, 0, 0.0, float(seed))
    run = loop.run
    other = [type(f)(*(a[:, :-1].clone() for a in f)) for f in fs]
    assert layout(other) != run.layout
    with pytest.raises(SolverException, match="laid out"):
        loop(other, 0.0, 0, 0.0, float(seed))
    assert loop.run is run


# ------------------------------------------------- against the JAX package

def test_make_jit_loop_lean_matches_jax_over_two_calls():
    """Both packages' `make_jit_loop_lean(params)`, each called twice on
    one carry: Sod_circ 24x20 f64, 7 cycles, the pair route (the JAX
    package's Pallas tier interpreted). Each package's passes are equal
    bit for bit and leave the input as it was; the JAX package's entry point
    gives the same function twice, as the port's does; the port's passes
    against the JAX ones: the same cycles, t within 4 eps, fields within
    1e-13 of their scale on real cells (XLA contracts multiply-adds). The
    port's multicycle route gives its pair route's bits."""
    import armon_tpu  # here: the card's machine has no jax
    from armon_tpu.core import solver as jsolver
    opts = dict(test="Sod_circ", N=(24, 20), data_type=np.float64,
                maxcycle=CYCLES, silent=5, measure_time=False, **PAIR)
    jp = armon_tpu.ArmonParameters(kernel_tier="pallas", **opts)
    jfs, jl0 = jsolver.make_init_fused(jp)()
    jloop = jsolver.make_jit_loop_lean(jp)
    assert jsolver.make_jit_loop_lean(jp) is jloop
    jbefore = [np.asarray(a).copy() for a in jfs]
    T = np.float64
    jruns = [jloop(jfs, T(0.0), np.int32(0), T(0.0), jl0) for _ in range(2)]
    assert all(np.array_equal(np.asarray(a), b)
               for a, b in zip(jfs, jbefore))
    for a, b in zip(jruns[0][0], jruns[1][0]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()

    params = armon_torch.ArmonParameters(device="cpu", **opts)
    assert route(params.config) == "pair"
    fs, seed = make_init_fused(params)()
    before = _clone(fs)
    loop = make_jit_loop_lean(params)
    assert make_jit_loop_lean(params) is loop
    first, kept, second = _twice(loop, fs, 0.0, 0, 0.0, float(seed))
    _value_semantics(fs, before, first, kept, second)

    eps = np.finfo(np.float64).eps
    g = params.nghost
    for res, jres in zip((first, second), jruns):
        _, jt, jcycles = jres[:3]
        assert res.cycles == int(jcycles) == CYCLES
        assert abs(res.t - float(jt)) <= 4 * eps * abs(float(jt))
        for name, b in zip(("rho", "u", "v", "E"), res.carry[0]):
            a = np.asarray(getattr(jres[0], name))[g:-g, g:-g]
            b = b.numpy()[g:-g, g:-g]
            assert np.max(np.abs(a - b)) <= \
                1e-13 * max(1.0, float(np.max(np.abs(a)))), name

    multi = _params({})
    assert route(multi.config) == "multicycle"
    mres = make_jit_loop_lean(multi)(fs, 0.0, 0, 0.0, float(seed))
    assert _scalars(mres)[:3] == _scalars(first)[:3]
    assert _same_carry(mres.carry, first.carry)


# ------------------------------------------------------------- the cache

def test_equal_params_share_a_loop():
    """Equal params (two objects) give the same callable, whose loop
    body, buffers and graphs object stay across calls: the buffers'
    pointers do not move."""
    a, b = _params(), _params()
    loop = make_jit_loop_lean(a)
    assert make_jit_loop_lean(b) is loop
    assert len(solver._FN_CACHE) == 1
    fs, seed = make_init_fused(a)()
    loop(fs, 0.0, 0, 0.0, float(seed))
    run = loop.run
    ptrs = [x.data_ptr() for s in run.sets for c in s for x in c] + \
        [x.data_ptr() for x in run.p] + \
        [run.scal.data_ptr(), run.iscal.data_ptr(), run.partials.data_ptr()]
    loop(fs, 0.0, 0, 0.0, float(seed))
    assert loop.run is run
    assert ptrs == [x.data_ptr() for s in run.sets for c in s for x in c] + \
        [x.data_ptr() for x in run.p] + \
        [run.scal.data_ptr(), run.iscal.data_ptr(), run.partials.data_ptr()]
    assert make_cycle(a) is make_cycle(b)
    assert make_jit_loop(a, restore=True) is make_jit_loop(b, restore=True)
    assert make_cycle(a) is not loop


KEY_CHANGES = {
    "config": lambda p: _params(maxcycle=CYCLES + 1),
    "device": lambda p: _with_devices(p, (torch.device("cpu", 0),)),
    "graphs": lambda p: ("graphs", False),
    "whole": lambda p: ("whole", False),
    "restore": lambda p: ("restore", None),
}


def _with_devices(p, devices):
    q = _params()
    q.devices = devices
    return q


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_key_parts_give_another_loop(change):
    """A different configuration, device, `graphs` or `whole` (and the
    full-state loop beside the lean one) gives another callable; the first
    stays where it was."""
    p = _params()
    loop = make_jit_loop_lean(p)
    other = KEY_CHANGES[change](p)
    if isinstance(other, tuple):
        what, _ = other
        got = make_jit_loop_lean(p, graphs=False) if what == "graphs" else \
            make_jit_loop_lean(p, whole=False) if what == "whole" else \
            make_jit_loop(p, restore=True)
    else:
        got = make_jit_loop_lean(other)
    assert got is not loop
    assert make_jit_loop_lean(p) is loop
    assert len(solver._FN_CACHE) == 2


def test_explicit_devices_keep_no_entry():
    """As the JAX package's `_cached` (`:80-81`): a caller that gave
    `devices` gets a new loop on every call, and the cache stays empty."""
    p = _params(devices=["cpu"])
    assert make_jit_loop_lean(p) is not make_jit_loop_lean(p)
    assert make_cycle(p) is not make_cycle(p)
    assert not solver._FN_CACHE
    q = _params()
    assert not q._devices_given and p._devices_given


def test_lru_holds_its_bound(monkeypatch):
    """With the bound patched to 3: five configurations leave three
    entries, the least recently used gone; a hit moves an entry to the
    end."""
    monkeypatch.setattr(solver, "_FN_CACHE_MAX", 3)
    ps = [_params(maxcycle=c) for c in range(1, 6)]
    loops = [make_jit_loop_lean(p) for p in ps[:3]]
    assert make_jit_loop_lean(ps[0]) is loops[0]  # now the most recent
    make_jit_loop_lean(ps[3])
    make_jit_loop_lean(ps[4])
    assert len(solver._FN_CACHE) == 3
    kept = [k[0].maxcycle for k in solver._FN_CACHE]
    assert kept == [1, 4, 5]
    assert make_jit_loop_lean(ps[0]) is loops[0]
    assert make_jit_loop_lean(ps[1]) is not loops[1]


class _CardParams:
    """The parts of `ArmonParameters` that `_make_room` reads, for a run
    on one card needing `need` bytes."""

    def __init__(self, need, process_count=1):
        self.devices = (torch.device("cuda", 0),)
        self.device = self.devices[0]
        self.process_count = process_count
        self.need = need

    class config:
        op_path = False

    def memory_required(self):
        return {"per_device_fused_total_bytes": self.need}


def _fill(n):
    for i in range(n):
        solver._FN_CACHE[("entry", i)] = object()


def test_eviction_makes_room_on_the_card(monkeypatch):
    """Before an entry is built, the least recently used entries go until
    the run's `memory_required()` fits the card's free bytes (a stand-in:
    10 units less 3 an entry), and no more."""
    monkeypatch.setattr(solver, "_free_bytes",
                        lambda d: 10 - 3 * len(solver._FN_CACHE))
    _fill(3)
    solver._make_room(_CardParams(need=5))
    assert list(solver._FN_CACHE) == [("entry", 2)]
    solver._make_room(_CardParams(need=5))
    assert list(solver._FN_CACHE) == [("entry", 2)]
    solver._make_room(_CardParams(need=100))
    assert not solver._FN_CACHE


def test_eviction_agrees_over_processes(monkeypatch):
    """Over processes every process drops as many entries as the one that
    dropped most (a stand-in gather: the other process dropped 2)."""
    monkeypatch.setattr(solver, "_free_bytes", lambda d: 10)
    seen = []

    def gather(t, device=None):
        seen.append(int(t[0]))
        return torch.stack([t, torch.tensor([2])])
    monkeypatch.setattr(solver.dist, "all_gather_rows", gather)
    _fill(4)
    solver._make_room(_CardParams(need=5, process_count=2))
    assert seen == [0]
    assert list(solver._FN_CACHE) == [("entry", 2), ("entry", 3)]


def test_cpu_runs_evict_by_count_only(monkeypatch):
    """A run on the CPU drops nothing for memory: the LRU bound alone
    holds its entries."""
    monkeypatch.setattr(solver, "_free_bytes", lambda d: 0)
    _fill(2)
    solver._make_room(_params())
    assert len(solver._FN_CACHE) == 2


@pytest.mark.parametrize("driver", ["lean", "per_cycle", "restore", "op"])
def test_armon_twice_is_bit_for_bit(driver, tmp_path, capsys):
    """`armon()` twice with one params object: the second call reuses the
    first's loop (one entry; the per-cycle driver's conservation function
    a second, kind "conservation") and gives the same fields and scalars,
    bit for bit; on the lean loop, the per-cycle driver (`silent=1`), the
    restore loop (a snapshot without its CFL carry) and the op path."""
    extra = dict(silent=1) if driver == "per_cycle" else \
        dict(kernel_tier="torch") if driver == "op" else {}
    restore_from = None
    if driver == "restore":
        from armon_torch.io.restart import save_checkpoint
        snap = str(tmp_path / "snap.npz")
        p = _params()
        st = make_init(p)()
        save_checkpoint(snap, p, [update_eos(p.config, s) for s in st],
                        0.0, 0, 0.0, local_min=None)
        restore_from = snap
    params = _params(return_data=True, **extra)
    runs = [armon_torch.armon(params, restore_from=restore_from)
            for _ in range(2)]
    capsys.readouterr()
    assert len(solver._FN_CACHE) == (2 if driver == "per_cycle" else 1)
    a, b = runs
    assert (a.cycles, a.final_time, a.last_dt) == \
        (b.cycles, b.final_time, b.last_dt)
    for f in ("rho", "u", "v", "E", "p"):
        assert _bits(getattr(a.data, f), getattr(b.data, f)), f


def test_armon_data_is_not_the_loops():
    """`return_data` hands out copies: a later `armon()` call with the same
    params leaves an earlier call's data as it was."""
    params = _params(return_data=True)
    first = armon_torch.armon(params).data
    kept = first.rho.clone()
    armon_torch.armon(_params(return_data=True, maxtime=1e-4))
    armon_torch.armon(params)
    assert _bits(first.rho, kept)


# ----------------------------------------------------------- processes

def _gloo_worker(rank, port, tmp):
    """Two calls of one configuration's loop entry points and of `armon()`
    on each process: the second hits; `dist.shutdown` empties the
    cache."""
    torch.set_num_threads(1)
    from armon_torch.parallel import dist
    opts = dict(P=(2, 1), coordinator_address=f"localhost:{port}",
                num_processes=NPROCS, process_id=rank)
    params = _params(PER_SWEEP, return_data=True, **opts)
    loop = make_jit_loop_lean(params)
    hit = make_jit_loop_lean(_params(PER_SWEEP, return_data=True, **opts)) \
        is loop
    runs = [armon_torch.armon(params) for _ in range(2)]
    same = all(_bits(getattr(x, f), getattr(y, f))
               for x, y in zip(runs[0].data, runs[1].data)
               for f in ("rho", "u", "v", "E", "p"))
    out = {"rank": rank, "hit": hit, "entries": len(solver._FN_CACHE),
           "bitwise": same, "cycles": [r.cycles for r in runs],
           "t": [r.final_time for r in runs]}
    dist.shutdown()
    out["after_shutdown"] = len(solver._FN_CACHE)
    print(dist.result_line(out), flush=True)


def test_two_gloo_processes_hit_together(tmp_path):
    """Two gloo processes on the CPU: both hit on the second call of the
    same params, their two `armon()` calls are equal bit for bit and
    agree across processes, and `shutdown` empties each cache."""
    from armon_torch.parallel.dist import run_workers
    results = run_workers(
        lambda rank, port: [sys.executable, os.path.abspath(__file__),
                            rank, port, str(tmp_path)],
        NPROCS, JOB_TIMEOUT, str(tmp_path),
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert all(r is not None for r in results), results
    for r in results:
        assert r["hit"] and r["bitwise"] and r["entries"] == 1, r
        assert r["cycles"] == [CYCLES, CYCLES] and r["after_shutdown"] == 0, r
    assert len({json.dumps(r["t"]) for r in results}) == 1


# ----------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _card_call(loop, fs, seed):
    K.reset_launches()
    G.reset_launches()
    G.reset_stats()
    res = loop(fs, 0.0, 0, 0.0, float(seed))
    torch.cuda.synchronize()
    return res, {**K.LAUNCHES, **K.TAILS, **G.LAUNCHES}, dict(G.STATS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", list(ROUTES))
def test_warm_calls_replay_on_the_card(kind, dtype):
    """On the card, Sod_circ 64^2 exact: a cold call (captures), a warm
    call (no capture, no WHILE build) and a `graphs=False` call, bit for
    bit; the warm call's launch counts equal the cold call's; the input
    stays; K3's ticket is 0 after a run stopped on its dt gate."""
    _card()
    params = _params(ROUTES[kind], device="cuda", N=(64, 64),
                     data_type=dtype, use_fast_math=False)
    fs, seed = make_init_fused(params)()
    before = _clone(fs)
    loop = make_jit_loop_lean(params)
    cold, n_cold, g_cold = _card_call(loop, fs, seed)
    warm, n_warm, g_warm = _card_call(loop, fs, seed)
    eager, _, _ = _card_call(make_jit_loop_lean(params, graphs=False), fs,
                             seed)
    assert g_cold["graphs"] >= 1 and g_warm["graphs"] == 0
    assert g_warm["form"] == "whole" and n_warm == n_cold
    for res in (warm, eager):
        assert _scalars(res)[:3] == _scalars(cold)[:3]
        assert _same_carry(_carry_list(res.carry), _carry_list(cold.carry))
    assert _same_carry(fs, before)
    bad = _clone(fs)
    bad[0].u[9, 11] = float("nan")
    failed = loop(bad, 0.0, 0, 0.0, float(seed))
    assert not failed.ok
    if kind != "multicycle":
        assert int(loop.run.ticket.item()) == 0
    again, _, g_again = _card_call(loop, fs, seed)
    assert g_again["graphs"] == 0
    assert _same_carry(_carry_list(again.carry), _carry_list(cold.carry))


@pytest.mark.gpu
def test_armon_warm_call_captures_nothing_on_the_card():
    """`armon()` twice on the card: the second call captures no graph and
    gives the same fields."""
    _card()
    params = _params(PER_SWEEP, device="cuda", N=(64, 64),
                     return_data=True)
    first = armon_torch.armon(params)
    G.reset_stats()
    second = armon_torch.armon(params)
    assert G.STATS["graphs"] == 0 and G.STATS["form"] == "whole"
    for f in ("rho", "u", "v", "E", "p"):
        assert _bits(getattr(first.data, f), getattr(second.data, f))


if __name__ == "__main__":
    _gloo_worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)
