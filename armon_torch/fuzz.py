"""The option-space fuzz: random valid configurations and the oracles that
must hold for every one of them (the counterpart of the JAX package's
`tests/test_option_fuzz.py` and `scripts/fuzz_campaign.py`).

    python -m armon_torch.fuzz [START] [COUNT] [--device cuda|cpu]
                               [--geometry small|card] [--oracles a,b,...]

runs each oracle over seeds START.. (COUNT times the oracle's weight, at
least one), prints one line for each (oracle, seed), carries on past a
failure (printing it), ends with a JSON summary line of counts for each
oracle, and exits 1 if anything failed. `--device` defaults to ``cuda``,
which raises without a card; ``cpu`` runs every kernel's plain version.

A seed names its case: `plan(oracle, seed, geometry)` draws it from
``random.Random(SEED_BASE + seed)`` through `sample`, then makes the
oracle's own draws, in the JAX test's order, so that with the "small"
geometry a seed gives the JAX file's combination. The "card" geometry
makes more draws after the small ones: a forced route, fast math, graphs
on or off, and extents that straddle the hand-written kernels' geometry
branches (`branches` names them; `REQUIRED` lists those the card smoke
run must reach).

Bit for bit means equal cycles, t and dt and `torch.equal` on the real
cells. Under fast math (f32 kernels on the card with `use_fast_math`) a
comparison across arithmetic takes the fast-math gate instead: t and dt
within 1e-4 relative, rho, E and p within 1e-4 of the field's largest
magnitude, u and v within 1e-4 of the case's largest wave speed, the
largest of |u|, |v| and c (a velocity left at rounding noise by one side
and at 0 by the other has no scale of its own: on one-column grids, card
seeds 46 and 535 of `routes_agree`, 1.6e-10 and 8.0e-11 in u, ROADMAP
C12).

This module imports neither `jax` nor `armon_tpu`.
"""

import argparse
import json
import math
import os
import random
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

from .ops.sweep import HALO, X_WINDOW

SEED_BASE = 20260818
CONSERVATIVE = {"Sod", "Sod_y", "Sod_circ"}
FIELDS = ("rho", "u", "v", "E")
FAST_TOL = 1e-4
# The two-axis leg of `transpose_symmetry` in exact mode, in ulps of each
# field's scale (see there).
ROTATED_ULPS = 16

# The kernels' geometry: K1 writes windows of 120 padded columns
# (`ops/sweep.py`); K5 takes grids of at most 256 KiB in 128-lane padded
# rows plus 8 (`ops/routing.multicycle_geom_ok`).
K1_WINDOW = X_WINDOW - 2 * HALO
K5_CAP_BYTES = 256 * 1024
# Card extents: the small sampler's, or one straddling a kernel branch.
CARD_EXTENTS = ("small", "small", "k1", "k2", "k5_cap", "narrow")
K2_SIDES = (2048, 2944, 4096)  # padded: K2 segments of 64, 128, 128 rows
# The CPU side of `tiers_agree` runs where it costs a few seconds.
TIERS_CPU_CELL_CYCLES = 400_000
# `output_roundtrip` writes with the plain writer, a Python loop.
OUTPUT_CELLS = 40_000


class Skip(Exception):
    """The case does not apply (printed as a skip, never as a pass)."""


class FuzzFailure(AssertionError):
    """An oracle failed: its message names the oracle, the seed and the
    options."""


# ------------------------------------------------------------------ sampler

def _stencil(scheme, projection):
    """A real cell's dependency depth: the stencil SUM (the `params.py`
    nghost floor)."""
    return (1 if scheme == "Godunov" else 2) + (1 if projection == "euler"
                                                else 2)


def sample(rng, geometry="small"):
    """One random valid configuration: the JAX file's `_sample` draw for
    draw (`tests/test_option_fuzz.py:35-85`), so that a seed gives its
    dict. Tiers map as the port takes them: "pallas" selects the kernels,
    "jnp" the op path. With ``geometry="card"``, `_card_draws` follows."""
    scheme, limiter = rng.choice([
        ("Godunov", "no_limiter"),
        ("GAD", "no_limiter"), ("GAD", "minmod"), ("GAD", "superbee"),
    ])
    projection = rng.choice(["euler", "euler_2nd"])
    stencil = _stencil(scheme, projection)
    opts = dict(
        test=rng.choice(["Sod", "Sod_y", "Sod_circ", "Bizarrium", "Sedov"]),
        scheme=scheme, riemann_limiter=limiter, projection=projection,
        axis_splitting=rng.choice(["Sequential", "SequentialSym", "Godunov",
                                   "Strang", "X_only", "Y_only"]),
        nghost=max(rng.choice([2, 4, 5]), stencil),
        N=(rng.choice([40, 48, 61]), rng.choice([40, 53, 64])),
        data_type=rng.choice([np.float32, np.float64]),
        kernel_tier=rng.choice(["jnp", "pallas"]),
        maxcycle=6, maxtime=1e30,
        silent=5, write_output=False, measure_time=False,
    )
    P = rng.choice([None, (2, 1), (1, 2), (2, 2), (3, 2)])
    if P is not None:
        opts["P"] = P
        if rng.random() < 0.5:
            opts["use_MPI"] = True
    # dt modes: CFL recurrence / constant dt / even-cycle reuse; a constant
    # dt sits under each case's CFL limit.
    mode = rng.random()
    if mode < 0.2:
        stable_dt = {"Bizarrium": 1e-9, "Sedov": 1e-7}.get(opts["test"], 1e-5)
        opts.update(cst_dt=True, Dt=stable_dt)
    elif mode < 0.45:
        opts["dt_on_even_cycles"] = True
    if opts["kernel_tier"] == "pallas":
        opts["pair_threshold"] = rng.choice([0, 2048])
        if rng.random() < 0.4:
            # a TPU tile hint: the port takes it and ignores it
            opts["block_size"] = (9999, int(rng.choice([16, 24, 32, 48])))
    if geometry == "card":
        _card_draws(rng, opts)
    elif geometry != "small":
        raise ValueError(f"unknown geometry {geometry!r}")
    return opts


def _card_draws(rng, opts):
    """The card geometry's draws, after the small ones: a route (per-sweep,
    pair, or the default routing), fast math, graphs, then an extent class
    (`CARD_EXTENTS`). Every class but "small" runs the kernels off a mesh
    at extents that straddle a branch: K1's 120-column windows, K2's
    segment rows (and K1's windows a warp), K5's cap, grids narrower than
    the ghost band. Large grids run fewer cycles."""
    routing = rng.choice(["per_sweep", "pair", "default"])
    fast = rng.random() < 0.5
    graphs = rng.random() < 0.75
    extent = rng.choice(CARD_EXTENTS)
    g = opts["nghost"]
    if extent != "small":
        opts.pop("P", None)
        opts.pop("use_MPI", None)
        opts["kernel_tier"] = "pallas"
    if extent == "k1":
        cols = K1_WINDOW * rng.choice([1, 2, 3, 8]) + rng.choice([-1, 0, 1])
        opts["N"] = (cols - 2 * g, rng.choice([17, 100, 300]))
        routing = "per_sweep"
    elif extent == "k2":
        side = rng.choice(K2_SIDES)
        opts["N"] = (side - 2 * g, side - 2 * g)
        routing = "per_sweep"
    elif extent == "k5_cap":
        itemsize = np.dtype(opts["data_type"]).itemsize
        rows = K5_CAP_BYTES // (128 * itemsize) - 8 + rng.choice([0, 1])
        opts["N"] = (rng.choice([g, 40, 128 - 2 * g]), rows - 2 * g)
        opts["axis_splitting"] = rng.choice(["Sequential", "Godunov"])
        routing = "default"
    elif extent == "narrow":
        opts["N"] = (rng.randint(1, g - 1), rng.choice([17, 64, 300]))
    opts.pop("pair_threshold", None)
    if routing == "per_sweep":
        opts.update(pair_threshold=0, temporal_blocking=1)
    elif routing == "pair":
        opts.update(pair_threshold=2048, temporal_blocking=1)
    opts["use_fast_math"] = fast
    opts["graphs"] = None if graphs else False
    cells = opts["N"][0] * opts["N"][1]
    if cells > 4_000_000:
        opts["maxcycle"] = 2
    elif cells > 250_000:
        opts["maxcycle"] = 3


def rng_for(seed):
    return random.Random(SEED_BASE + seed)


# -------------------------------------------------------------- branches

# What the card smoke run must reach: the kernels' geometry branches, and
# the card geometry's draws.
REQUIRED = (
    "k1_cols_120k-1", "k1_cols_120k", "k1_cols_120k+1",
    "k1_windows_1", "k1_windows_2-7", "k1_windows_8",
    "k2_rows_32", "k2_rows_64", "k2_rows_128",
    "k5_cap_in", "k5_cap_out", "inline_x_off", "pair_off_x_split",
    "k6_tma", "k6_cp_async", "body_steps_1", "body_steps_2",
    "forced_per_sweep", "forced_pair", "default_routing",
    "fast_math_on", "fast_math_off", "graphs_on", "graphs_off",
    "mesh_uneven",
)


def _config(opts):
    """The SolverConfig of `opts` (built for the CPU: it does not depend
    on the device)."""
    from .params import ArmonParameters
    o = dict(opts)
    o.pop("graphs", None)
    return ArmonParameters(device="cpu", **o).config


def _launched(cfg):
    """The kernels a lean run of `cfg` launches, by `ops/sweep.LAUNCHES`
    name (a mesh's slab variants under the plain names)."""
    from .core.splitting import split_schedules
    from .core.step import launch_groups
    from .ops.routing import route
    from .utils.enums import Axis
    r = route(cfg)
    if r == "multicycle":
        return {"multicycle"}
    out = set()
    for sched in split_schedules(cfg.splitting):
        for grp in launch_groups(sched, r == "pair"):
            out.add("cycle" if len(grp) == 2 else
                    "x_sweep" if grp[0][0] is Axis.X else "y_sweep")
    return out


class _Steps:
    """The parity and buffer swaps of a route's steps, as `KernelCycles`
    and `MultiCycles` give them, for `graphs.body_steps`."""

    def __init__(self, cfg, kind):
        from .core.splitting import split_schedules
        from .ops.routing import temporal_pairs
        self.kind = kind
        self.even, self.odd = split_schedules(cfg.splitting)
        self.k = len(temporal_pairs(cfg) or ())

    def parity(self, i):
        if self.kind == "multicycle":
            return 0
        return i % 2 if self.even != self.odd else 0

    def swaps(self, i):
        from .core.step import launch_groups
        if self.kind == "multicycle":
            return self.k % 2
        return len(launch_groups(self.even if i % 2 == 0 else self.odd,
                                 self.kind == "pair"))


def branches(opts, conservation=False):
    """The branches a run of `opts` reaches on the card (computed from its
    configuration; `conservation` for a run whose f32 mass sums are
    K6's)."""
    from .core import graphs as G
    from .ops import sweep as K
    from .ops.routing import (inline_bc_x_ok, pair_routing_on, route,
                              multicycle_geom_ok)
    cfg = _config(opts)
    hits = set()
    if "use_fast_math" in opts:
        hits.add("fast_math_on" if opts["use_fast_math"] else
                 "fast_math_off")
    if "graphs" in opts:
        hits.add("graphs_off" if opts["graphs"] is False else "graphs_on")
    if cfg.spmd and (cfg.uneven(0) or cfg.uneven(1)):
        hits.add("mesh_uneven")
    if cfg.op_path:
        return hits
    routing = {(0, 1): "forced_per_sweep", (2048, 1): "forced_pair",
               (None, None): "default_routing"}.get(
        (opts.get("pair_threshold"), opts.get("temporal_blocking")))
    if routing:
        hits.add(routing)
    shape = rows, cols = cfg.local_shape
    kernels = _launched(cfg)
    if "x_sweep" in kernels:
        hits.add({K1_WINDOW - 1: "k1_cols_120k-1", 0: "k1_cols_120k",
                  1: "k1_cols_120k+1"}.get(cols % K1_WINDOW, "k1_cols"))
        w = K.x_windows_per_warp(shape)
        hits.add("k1_windows_%s" % (w if w in (1, 8) else "2-7"))
    if "y_sweep" in kernels:
        hits.add("k2_rows_%d" % K.y_segment_rows(shape))
    if not inline_bc_x_ok(cfg):
        hits.add("inline_x_off")
    itemsize = np.dtype(cfg.dtype).itemsize

    def under_cap(r):
        return (r + 8) * -(-cols // 128) * 128 * itemsize <= K5_CAP_BYTES
    if cfg.temporal_blocking > 1 and not cfg.spmd and inline_bc_x_ok(cfg) \
            and under_cap(rows) != under_cap(rows + (1 if under_cap(rows)
                                                     else -1)):
        hits.add("k5_cap_in" if multicycle_geom_ok(cfg, shape)
                 else "k5_cap_out")
    if cfg.spmd and cfg.proc_dims[0] > 1 and cfg.pair_threshold > 0 and \
            max(cfg.n_local) <= cfg.pair_threshold and \
            not pair_routing_on(cfg) and "x_sweep" in kernels and \
            "y_sweep" in kernels:
        hits.add("pair_off_x_split")
    if conservation and itemsize == 4:
        hits.add("k6_tma" if cols % 4 == 0 else "k6_cp_async")
    if opts.get("graphs") is not False:
        kind = route(cfg)
        hits.add("body_steps_%d" % G.body_steps(_Steps(cfg, kind), 0))
    return hits


def case_branches(case):
    """The branches every run of a planned case reaches."""
    out = set()
    for opts in case["runs"]:
        out |= branches(opts, case.get("conservation", False))
    return out


# ------------------------------------------------------------ run helpers

def _label(opts):
    return {k: (v.__name__ if isinstance(v, type) else v)
            for k, v in opts.items()}


def _params(opts, device, **kw):
    """ArmonParameters of `opts` on `device`: a mesh on a card puts every
    shard on that one card."""
    from .params import ArmonParameters
    o = {**opts, **kw}
    o.pop("graphs", None)
    n = int(np.prod(o.get("P", (1, 1))))
    if n > 1 and torch.device(device).type == "cuda":
        o["devices"] = [device] * n
    return ArmonParameters(device=device, **o)


def _armon(opts, device, restore_from=None, **kw):
    """`armon()` of `opts` with `return_data`: (params, stats)."""
    from .core.solver import armon
    p = _params(opts, device, return_data=True, **kw)
    with warnings.catch_warnings():
        # f32 runs warn that mass and energy drift (ROADMAP C2)
        warnings.simplefilter("ignore")
        st = armon(p, restore_from=restore_from, graphs=opts.get("graphs"))
    return p, st


def fast_math(params):
    """Whether the run's f32 kernels divide in fast math."""
    cfg = params.config
    return (params.use_fast_math and np.dtype(cfg.dtype).itemsize == 4
            and params.device.type == "cuda" and not cfg.op_path)


def _real(params, state, fields=FIELDS):
    """Real cells of a global State, as tensors on the CPU."""
    g = params.nghost
    return {v: getattr(state, v)[g:-g, g:-g].cpu() for v in fields}


def _fail(case, msg):
    raise FuzzFailure(f"{case['oracle']} seed={case['seed']}: {msg}: "
                      f"{_label(case['opts'])}")


def _expect(case, ok, msg):
    if not ok:
        _fail(case, msg)


def _gate(case, a, b, fast, what, transpose=False, speed=None, tol=None):
    """Fields of `a` against `b` (dicts of real-cell tensors; `b`
    transposed, u and v swapped, with `transpose`): bit for bit, or the
    fast-math gate (`tol`, relative, where given: FAST_TOL), whose
    velocities take `speed`, the case's largest wave speed (`_speed`)."""
    swap = {"u": "v", "v": "u"} if transpose else {}
    for v, x in a.items():
        y = b[swap.get(v, v)]
        if transpose:
            y = y.T
        y = y.to(x.device)
        if fast or tol is not None:
            d = float((x.double() - y.double()).abs().max())
            scale = speed if v in ("u", "v") else \
                float(y.double().abs().max())
            bound = FAST_TOL if fast else tol
            _expect(case, d <= bound * scale,
                    f"{what}: {v} differs by {d} (scale {scale})")
        else:
            _expect(case, torch.equal(x, y),
                    f"{what}: {v} differs by "
                    f"{float((x.double() - y.double()).abs().max())}")


def _speed(params, state):
    """The largest of |u|, |v| and c on the real cells of a global State
    (a kernel run's c is its initial state's: `make_rehydrate`)."""
    return max(float(t.double().abs().max()) for t in
               _real(params, state, ("u", "v", "c")).values())


def _same_scalars(case, a, b, fast, what):
    """cycles, t and dt of two SolverStats or LoopResults."""
    _expect(case, a.cycles == b.cycles,
            f"{what}: cycles {a.cycles} vs {b.cycles}")
    for name in ("final_time", "last_dt") if hasattr(a, "last_dt") else \
            ("t", "dt_last"):
        x, y = float(getattr(a, name)), float(getattr(b, name))
        ok = abs(x - y) <= FAST_TOL * abs(y) if fast else x == y
        _expect(case, ok, f"{what}: {name} {x!r} vs {y!r}")


def _same_stats(case, a, b, fast, what, fields=FIELDS, transpose=False):
    """Two (params, stats): scalars and real-cell fields."""
    _same_scalars(case, a[1], b[1], fast, what)
    _gate(case, _real(a[0], a[1].data, fields), _real(b[0], b[1].data, fields),
          fast, what, transpose, _speed(b[0], b[1].data) if fast else None)


def _valid_layout(opts, P):
    """Whether the mesh P can split opts' grid (`params._init_indexing`)."""
    g = opts["nghost"]
    for n, p in zip(opts["N"], P):
        local = -(-n // p)
        if p > 1 and min(local, n - (p - 1) * local) < g:
            return False
    return True


# ---------------------------------------------------------------- oracles
#
# Each oracle is a plan (the seed's draws, no run) and a check (the runs).
# A plan is a dict: the oracle's name, the seed, its options `opts`, any
# more draws, and `runs`, the options of every run the check makes.

def _plan_invariants(rng, geometry):
    opts = sample(rng, geometry)
    return dict(opts=opts, runs=[opts], conservation=True)


def invariants(case, device, tmp):
    """`tests/test_option_fuzz.py:89-119`: the run completes its cycles
    with a valid dt, every real cell is finite and rho > 0, and mass is
    conserved on the conservative cases (1e-11 in f64, 1e-6 in f32)."""
    from .core.solver import make_conservation
    from .interop import scatter_state
    opts = case["opts"]
    p, st = _armon(opts, device, check_result=True)
    m0 = p.initial_mass
    _expect(case, st.cycles == opts["maxcycle"], f"stopped at {st.cycles}")
    _expect(case, math.isfinite(st.last_dt) and st.last_dt > 0,
            f"invalid dt {st.last_dt}")
    cells = _real(p, st.data, FIELDS + ("p",))
    for v, a in cells.items():
        _expect(case, bool(torch.isfinite(a).all()), f"{v} not finite")
    _expect(case, bool((cells["rho"] > 0).all()), "non-positive density")
    if opts["test"] in CONSERVATIVE:
        m, _ = make_conservation(p)(scatter_state(p, st.data))
        tol = 1e-11 if np.dtype(p.data_type).itemsize == 8 else 1e-6
        _expect(case, abs(m - m0) <= tol * abs(m0), f"mass drift {m - m0}")
    return {"run": (p, st)}


ROUTES = {"per_sweep": dict(kernel_tier="pallas", pair_threshold=0,
                            temporal_blocking=1),
          "pair": dict(kernel_tier="pallas", pair_threshold=2048,
                       temporal_blocking=1),
          "multicycle": dict(kernel_tier="pallas", pair_threshold=2048,
                             temporal_blocking=8),
          "op": dict(kernel_tier="jnp")}


def _plan_routes_agree(rng, geometry):
    opts = sample(rng, geometry)
    opts.pop("P", None)
    opts.pop("use_MPI", None)
    opts.pop("block_size", None)
    if geometry == "small":
        # `:363-398`: grids barely wider than the ghost band, f64
        g = opts["nghost"]
        opts["N"] = (rng.choice([max(2, g - 1), g, g + 1, 2 * g, 17]),
                     rng.choice([max(2, g - 1), g, g + 1, 2 * g, 23]))
        opts["data_type"] = np.float64
        opts["maxcycle"] = 5
    from .ops.routing import route
    routes = {}
    for name, kw in ROUTES.items():
        o = {**opts, **kw}
        got = "op" if name == "op" else route(_config(o))
        routes.setdefault(got, o)
    return dict(opts=opts, routes=routes, runs=list(routes.values()))


def routes_agree(case, device, tmp):
    """`:363-398`'s tier equivalence on the port's routes: per-sweep, pair
    and multicycle (where the grid admits them) and the op path give the
    same bits in f64 and f32 exact; the fast-math gate in fast math."""
    out = {}
    for name, o in case["routes"].items():
        p, st = _armon(o, device)
        _expect(case, st.cycles == o["maxcycle"],
                f"{name}: stopped at {st.cycles}")
        out[name] = (p, st)
    ref = out["op"]
    for name, run in out.items():
        fast = fast_math(run[0])
        _same_stats(case, run, ref, fast, f"{name} vs op path")
    return out


def _plan_graphs_agree(rng, geometry):
    opts = sample(rng, geometry)
    opts.pop("use_MPI", None)
    opts["kernel_tier"] = "pallas"
    opts["graphs"] = None
    return dict(opts=opts, runs=[opts])


def _whole_plain(cfg, mesh, fs, lm, kind):
    """The whole-run graph's plain version (`graphs.while_plain`): bodies
    of `graphs.body_steps` steps until the predicate falls."""
    from .core import graphs as G
    from .core.step import KernelCycles, MultiCycles
    from .ops import sweep as K
    from .ops.routing import temporal_pairs
    if kind == "multicycle":
        run = MultiCycles(cfg, temporal_pairs(cfg), fs, 0.0, 0, 0.0, lm)
        pred = K.IS_NEXT
    else:
        run = KernelCycles(cfg, mesh, fs, 0.0, 0, 0.0, lm, kind == "pair")
        run.first_step()
        pred = K.IS_RUN
    G.while_plain(run, 0, G.body_steps(run, 0), pred)
    return run.result(1)


def _bits(a):
    return a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)


def _counts():
    from .ops import sweep as K
    return {**K.LAUNCHES, **K.TAILS}


def graphs_agree(case, device, tmp):
    """The whole-run graph against the eager loop (`graphs=False`) on the
    lean loop of the configuration's route, from one initial carry: the
    same bits, scalars and, with the eager loop's `check_every` the body's
    length, the same launch totals. On the CPU, where no graph runs, the
    graph's plain version (`graphs.while_plain`) takes its place."""
    from .core import graphs as G
    from .core.solver import make_init_fused, make_mesh
    from .core.step import make_time_loop_lean
    from .ops.routing import route, temporal_pairs
    p = _params(case["opts"], device)
    cfg = p.config
    mesh = make_mesh(p) if cfg.spmd else None
    kind = route(cfg)
    fs, seed = make_init_fused(p)()
    body = G.body_steps(_Steps(cfg, kind), 0)
    every = body * (len(temporal_pairs(cfg)) if kind == "multicycle" else 1)

    def clone():
        return [type(f)(*(a.clone() for a in f)) for f in fs]

    before = _counts()
    eager = make_time_loop_lean(cfg, mesh, graphs=False)(
        clone(), 0.0, 0, 0.0, float(seed), check_every=every)
    n_eager = {k: v - before[k] for k, v in _counts().items()}
    if p.device.type == "cuda":
        G.reset_stats()
        before = _counts()
        whole = make_time_loop_lean(cfg, mesh, graphs=None)(
            clone(), 0.0, 0, 0.0, float(seed))
        torch.cuda.synchronize()
        n_whole = {k: v - before[k] for k, v in _counts().items()}
        _expect(case, (G.STATS["form"], G.STATS["runs"]) == ("whole", 1),
                f"no whole-run graph: {G.STATS}")
        _expect(case, G.STATS["body_steps"] == body,
                f"body of {G.STATS['body_steps']} steps, planned {body}")
        _expect(case, n_whole == n_eager,
                f"launches {n_whole} vs eager {n_eager}")
    else:
        whole = _whole_plain(cfg, mesh, clone(), float(seed), kind)
    _same_scalars(case, whole, eager, False, "whole vs eager")
    _expect(case, whole.ok == eager.ok and np.float64(whole.lm).tobytes()
            == np.float64(eager.lm).tobytes(),
            f"ok, lm {whole.ok, whole.lm} vs {eager.ok, eager.lm}")
    # Every cell, ghosts included, by its bits: a ghost band may hold NaN
    # (card seed 15: a 5-column Sedov grid), which no float compare equals.
    for a, b in zip(whole.carry, eager.carry):
        for v, x, y in zip(type(a)._fields, a, b):
            _expect(case, torch.equal(_bits(x), _bits(y)),
                    f"whole vs eager: {v}")
    return {"whole": whole, "eager": eager}


def _plan_tiers_agree(rng, geometry):
    opts = sample(rng, geometry)
    opts.pop("use_MPI", None)
    nx, ny = opts["N"]
    skip = None
    if nx * ny * opts["maxcycle"] > TIERS_CPU_CELL_CYCLES:
        skip = (f"{nx}x{ny} x {opts['maxcycle']} cycles: the CPU side "
                f"costs more than a few seconds")
    return dict(opts=opts, runs=[opts], skip=skip)


def tiers_agree(case, device, tmp):
    """The run on `device` against the same run on the CPU (the kernels'
    plain versions, or the op path on the CPU): bit for bit in f64 and f32
    exact (the kernels are built with -fmad=false, contract with an
    explicit fma exactly where the plain versions do, `ops/fma.py`, and
    divide and take square roots in IEEE arithmetic; the plain versions
    use `ops/eos.ieee_sqrt`); the
    fast-math gate in fast math. With `device` "cpu" both sides are the
    plain versions: the run repeats bit for bit."""
    if case.get("skip"):
        raise Skip(case["skip"])
    a = _armon(case["opts"], device)
    b = _armon(case["opts"], "cpu")
    _same_stats(case, a, b, fast_math(a[0]), f"{device} vs cpu",
                FIELDS + ("p",))
    return {"device": a, "cpu": b}


def _plan_axis_invariance(rng, geometry):
    opts = sample(rng, geometry)
    case = rng.choice(["Sod", "Sod_y", "Bizarrium"])
    opts["test"] = case
    opts.pop("use_MPI", None)
    if opts.get("cst_dt"):
        opts["Dt"] = 1e-9 if case == "Bizarrium" else 1e-5
    return dict(opts=opts, runs=[opts],
                along_y=case in ("Sod", "Bizarrium"))


def axis_invariance(case, device, tmp):
    """`:536-575`: a problem constant along one axis (Sod and Bizarrium
    along Y, Sod_y along X) stays bit-constant along it."""
    p, st = _armon(case["opts"], device)
    _expect(case, st.cycles == case["opts"]["maxcycle"],
            f"stopped at {st.cycles}")
    along_y = case["along_y"]
    for v, a in _real(p, st.data, FIELDS + ("p",)).items():
        same = a[1:, :] == a[:-1, :] if along_y else a[:, 1:] == a[:, :-1]
        _expect(case, bool(same.all()),
                f"{v} not bit-constant along {'Y' if along_y else 'X'}")
    return {"run": (p, st)}


def _plan_transpose_symmetry(rng, geometry):
    opts = sample(rng, geometry)
    base = rng.choice(["Sod", "Sod_circ", "Sedov"])
    pair = {"Sod": "Sod_y"}.get(base, base)
    opts.pop("use_MPI", None)
    P = opts.pop("P", None)
    if opts.get("cst_dt"):
        opts["Dt"] = {"Sedov": 1e-7}.get(base, 1e-5)
    nx, ny = opts["N"]
    a_kw = dict(opts, test=base, axis_splitting="X_only", N=(nx, ny))
    b_kw = dict(opts, test=pair, axis_splitting="Y_only", N=(ny, nx))
    if P is not None:
        a_kw["P"] = P
        b_kw["P"] = (P[1], P[0])
    # Two-axis leg: the splitting's even cycle from cycle 0 against its
    # odd (transposed) cycle from cycle 1, on the transposed problem.
    split = opts["axis_splitting"]
    split = split if split in ("Godunov", "SequentialSym", "Strang") \
        else "Godunov"
    two = dict(axis_splitting=split, dt_on_even_cycles=False)
    a2, b2 = dict(a_kw, **two), dict(b_kw, **two)
    return dict(opts=opts, a=a_kw, b=b_kw, a2=a2, b2=b2,
                runs=[a_kw, b_kw, a2, b2])


def _from_cycle(opts, device, cycle0):
    """`opts`' run of maxcycle cycles from cycle `cycle0` through
    `make_jit_loop` (the route of one cycle on the kernels): (params,
    LoopResult, its global State)."""
    from .core.solver import make_init, make_jit_loop
    from .interop import gather_state
    o = dict(opts, maxcycle=opts["maxcycle"] + cycle0)
    p = _params(o, device)
    res = make_jit_loop(p, graphs=o.get("graphs"))(
        make_init(p)(), 0.0, cycle0, 0.0)
    return p, res, gather_state(p, res.carry)


def transpose_symmetry(case, device, tmp):
    """`:579-647`: X sweeps only on a problem are the transpose, u and v
    swapped, of Y sweeps only on the problem rotated (K1 against K2, the
    op path's X against its Y), bit for bit or the fast-math gate; and on
    a two-axis splitting, its even cycle from cycle 0 against the rotated
    problem from cycle 1, whose schedule is the transposed one (K4 X
    first against Y first): there both velocities move, and the EOS
    contracts u*u + v*v as fma(u, u, v*v) on either axis, as the JAX
    package's jitted program does (`ops/fma.py`), so the fields agree
    within ROTATED_ULPS ulps of their scale (measured on seeds 0-11 and
    800-815: 3.8 in f32, 3.1 in f64), t and dt within as many ulps."""
    a = _armon(case["a"], device)
    b = _armon(case["b"], device)
    fast = fast_math(a[0])
    _same_stats(case, a, b, fast, "X_only vs Y_only.T", FIELDS + ("p",),
                transpose=True)
    pa, ra, sa = _from_cycle(case["a2"], device, 0)
    pb, rb, sb = _from_cycle(case["b2"], device, 1)
    n = case["a2"]["maxcycle"]
    _expect(case, (ra.cycles, rb.cycles) == (n, n + 1),
            f"two-axis cycles {ra.cycles}, {rb.cycles}")
    rel = ROTATED_ULPS * float(np.finfo(case["opts"]["data_type"]).eps)
    for name in ("t", "dt_last"):
        x, y = float(getattr(ra, name)), float(getattr(rb, name))
        _expect(case, abs(x - y) <= (FAST_TOL if fast else rel) * abs(y),
                f"two-axis {name} {x!r} vs {y!r}")
    _gate(case, _real(pa, sa, FIELDS + ("p",)), _real(pb, sb, FIELDS + ("p",)),
          fast, "two-axis vs transposed", True, _speed(pb, sb), tol=rel)
    return {"a": a, "b": b}


def thin_axes(opts):
    """The swept axes (0: X, 1: Y) along which the grid is unsplit and
    has fewer real cells than the stencil sum: there the mirror fill's far
    ghosts are the opposite band's earlier contents, in both packages
    (ROADMAP C11)."""
    stencil = _stencil(opts["scheme"], opts["projection"])
    swept = {"X_only": (0,), "Y_only": (1,)}.get(opts["axis_splitting"],
                                                 (0, 1))
    P = opts.get("P") or (1, 1)
    return [a for a in swept if P[a] == 1 and opts["N"][a] < stencil]


def _plan_ghost_poison(rng, geometry):
    opts = sample(rng, geometry)
    opts.pop("use_MPI", None)
    thin = thin_axes(opts)
    return dict(opts=opts, runs=[opts], skip=thin and (
        f"thinner than the stencil along axes {thin}: poison in the far "
        f"ghosts reaches the real cells in both packages (ROADMAP C11)"))


def ghost_poison(case, device, tmp):
    """`:651-700`: every non-real cell (ghost bands, corners, an uneven
    split's slack) set to 1e100 (1e30 in f32) at the loop's start leaves
    the real cells, the cycles and dt bit for bit, except on grids
    thinner than the stencil (`thin_axes`, skipped). Kernels: one lean loop
    (the configuration's route, K5 included) called on the clean and the
    poisoned carry; the op path: its loop on poisoned States (rho, u, v,
    E, p, c and g)."""
    from .core.solver import (make_init, make_init_fused, make_jit_loop,
                              make_mesh)
    from .core.step import make_time_loop_lean
    from .interop import gather_state
    from .ops.reductions import real_slice
    if case.get("skip"):
        raise Skip(case["skip"])
    p = _params(case["opts"], device)
    cfg = p.config
    mesh = make_mesh(p)
    big = 1e100 if np.dtype(cfg.dtype).itemsize == 8 else 1e30

    def poison(shards, names):
        out = []
        for s, f in zip(mesh.local, shards):
            r = real_slice(cfg, s.n_real)
            fields = {}
            for name in names:
                a = getattr(f, name)
                b = torch.full_like(a, big)
                b[r] = a[r]
                fields[name] = b
            out.append(f._replace(**fields))
        return out

    if cfg.op_path:
        loop = make_jit_loop(p)
        clean = loop(make_init(p)(), 0.0, 0, 0.0)
        dirty = loop(poison(make_init(p)(), ("rho", "u", "v", "E", "p",
                                             "c", "g")), 0.0, 0, 0.0)
    else:
        loop = make_time_loop_lean(cfg, mesh if cfg.spmd else None,
                                   graphs=case["opts"].get("graphs"))
        fs, seed = make_init_fused(p)()
        clean = loop([type(f)(*(a.clone() for a in f)) for f in fs],
                     0.0, 0, 0.0, float(seed))
        dirty = loop(poison(fs, FIELDS + ("p",)), 0.0, 0, 0.0, float(seed))
    _expect(case, clean.ok and dirty.ok, "poison invalidated the run")
    _same_scalars(case, dirty, clean, False, "poisoned vs clean")
    _gate(case, _real(p, gather_state(p, dirty.carry)),
          _real(p, gather_state(p, clean.carry)), False, "poisoned vs clean")
    return {"clean": clean, "dirty": dirty}


def _plan_resume(rng, geometry):
    opts = sample(rng, geometry)
    opts.update(maxcycle=7)
    return dict(opts=opts, runs=[opts])


def resume(case, device, tmp):
    """`:151-192`: a straight 7-cycle run against 3 cycles, a snapshot
    through the params object that ran, and a resume to 7: bit for
    bit."""
    from .io.restart import save_checkpoint
    opts = case["opts"]
    ref = _armon(opts, device)
    p1, part = _armon(dict(opts, maxcycle=3), device)
    ckpt = os.path.join(tmp, "fuzz.ckpt.npz")
    save_checkpoint(ckpt, p1, part.data, part.final_time, part.cycles,
                    part.last_dt)
    res = _armon(opts, device, restore_from=ckpt)
    _same_stats(case, res, ref, False, "resumed vs straight")
    return {"ref": ref, "res": res}


LAYOUTS = [None, (2, 1), (1, 2), (2, 2), (3, 2)]


def _plan_reshard_resume(rng, geometry):
    opts = sample(rng, geometry)
    opts.update(maxcycle=7)
    opts.pop("block_size", None)
    opts.pop("use_MPI", None)
    src = opts.pop("P", None)
    dst = rng.choice([p for p in LAYOUTS if p != src and
                      (p is None or _valid_layout(opts, p))])
    if src is not None and not _valid_layout(opts, src):
        src = None
    on = lambda P: dict(opts, **({"P": P} if P else {}))  # noqa: E731
    return dict(opts=opts, src=src, dst=dst, runs=[on(src), on(dst)])


def reshard_resume(case, device, tmp):
    """`:195-266`: a snapshot on one layout, resumed on another, against
    an uninterrupted run on the target: bit for bit (the port's
    arithmetic is the same on every layout; the JAX package holds this
    only to an ulp tolerance, since XLA's CPU fusion differs by shard
    shape)."""
    from .io.restart import save_checkpoint
    src, dst = case["runs"]
    ref = _armon(dst, device)
    p1, part = _armon(dict(src, maxcycle=3), device)
    ckpt = os.path.join(tmp, "reshard.ckpt.npz")
    save_checkpoint(ckpt, p1, part.data, part.final_time, part.cycles,
                    part.last_dt, per_shard=case["src"] is not None)
    res = _armon(dst, device, restore_from=ckpt)
    _same_stats(case, res, ref, False, f"{case['src']} -> {case['dst']}")
    return {"ref": ref, "res": res}


def _plan_mesh_matches_single(rng, geometry):
    opts = sample(rng, geometry)
    opts.pop("use_MPI", None)
    P = opts.pop("P", None) or rng.choice(
        [q for q in LAYOUTS[1:] if _valid_layout(opts, q)] or [None])
    return dict(opts=opts, P=P, runs=[opts, dict(opts, P=P)] if P else
                [opts], skip=None if P else "no mesh splits this grid")


def mesh_matches_single(case, device, tmp):
    """`:493-533`: a mesh run (on one card: every shard on it) against the
    one-device run, bit for bit (the JAX package: an ulp tolerance)."""
    if case.get("skip"):
        raise Skip(case["skip"])
    one = _armon(case["opts"], device)
    mesh = _armon(dict(case["opts"], P=case["P"]), device)
    _same_stats(case, mesh, one, False, f"P={case['P']} vs one device")
    return {"one": one, "mesh": mesh}


def _plan_output_roundtrip(rng, geometry):
    opts = sample(rng, geometry)
    opts.pop("P", None)
    opts.update(maxcycle=4)
    prec = rng.choice([3, 6, 9, 12, 17])
    nx, ny = opts["N"]
    skip = None if nx * ny <= OUTPUT_CELLS else \
        f"{nx}x{ny} cells: the plain writer is a Python loop"
    return dict(opts=opts, precision=prec, runs=[opts], skip=skip)


def output_roundtrip(case, device, tmp):
    """`:318-359`: the written state file reads back exactly (the
    default precision is exact), and the native writer (`native/
    armon_io.cc`) gives the plain writer's bytes at a random precision."""
    from .io.output import (SAVED_VARS, read_state_file, saved_vars_arrays,
                            write_cells_plain, write_state_file)
    if case.get("skip"):
        raise Skip(case["skip"])
    p, st = _armon(case["opts"], device)
    cfg = p.config
    path = os.path.join(tmp, "out.csv")
    write_state_file(cfg, st.data, path)
    back = read_state_file(cfg, path)
    arrs = saved_vars_arrays(cfg, st.data)
    for v in SAVED_VARS:
        _expect(case, np.array_equal(back[v], arrs[v]), f"{v} read back")
    prec = case["precision"]
    p_nat, p_py = os.path.join(tmp, "n.csv"), os.path.join(tmp, "p.csv")
    write_state_file(cfg, st.data, p_nat, precision=prec)
    write_cells_plain(p_py, arrs, prec)
    with open(p_nat, "rb") as f, open(p_py, "rb") as h:
        _expect(case, f.read() == h.read(),
                f"native and plain writers differ at precision {prec}")
    return {"run": (p, st), "path": path}


# (plan, check, weight): a campaign of COUNT seeds runs an oracle over
# max(1, COUNT * weight) seeds; heavier oracles get fewer
# (`scripts/fuzz_campaign.py:60-79`).
ORACLES = {
    "invariants": (_plan_invariants, invariants, 1.0),
    "routes_agree": (_plan_routes_agree, routes_agree, 0.5),
    "graphs_agree": (_plan_graphs_agree, graphs_agree, 0.4),
    "tiers_agree": (_plan_tiers_agree, tiers_agree, 0.4),
    "axis_invariance": (_plan_axis_invariance, axis_invariance, 0.5),
    "transpose_symmetry": (_plan_transpose_symmetry, transpose_symmetry,
                           0.4),
    "ghost_poison": (_plan_ghost_poison, ghost_poison, 0.6),
    "resume": (_plan_resume, resume, 0.4),
    "reshard_resume": (_plan_reshard_resume, reshard_resume, 0.3),
    "mesh_matches_single": (_plan_mesh_matches_single, mesh_matches_single,
                            0.4),
    "output_roundtrip": (_plan_output_roundtrip, output_roundtrip, 0.3),
}

# The card smoke run's cases (`chip_smoke.py` phase 18), card geometry:
# eight seeds an oracle, chosen so that together they reach every branch
# of `REQUIRED` (`tests/test_torch_option_fuzz.py` holds it), and the
# seeds where the campaign on the card first failed: routes_agree and
# tiers_agree 46 and 535 (a velocity at rounding noise under fast math)
# and graphs_agree 15 (NaN in a ghost band), the oracles' faults.
CARD_SMOKE = {
    "invariants": (0, 1, 2, 3, 23, 28, 248, 267),
    "routes_agree": tuple(range(8)) + (46, 535),
    "graphs_agree": tuple(range(8)) + (15,),
    "tiers_agree": (0, 1, 2, 4, 5, 6, 7, 8, 46, 535),
    "axis_invariance": tuple(range(8)),
    "transpose_symmetry": (0, 1, 2, 4, 5, 6, 7, 8),
    "ghost_poison": tuple(range(8)),
    "resume": tuple(range(8)),
    "reshard_resume": tuple(range(8)),
    "mesh_matches_single": tuple(range(8)),
    "output_roundtrip": (0, 1, 2, 112, 234, 253, 263, 278),
}


def plan(name, seed, geometry="small"):
    """The case of `oracle` at `seed`: its draws, and no run."""
    case = ORACLES[name][0](rng_for(seed), geometry)
    case.update(oracle=name, seed=seed, geometry=geometry)
    return case


def check(case, device, tmp):
    """Run a planned case's oracle on `device` (`tmp` a directory for its
    files). Raises `FuzzFailure` when it fails, `Skip` when it does not
    apply; returns the runs it compared."""
    return ORACLES[case["oracle"]][1](case, device, str(tmp))


def run(name, seed, device="cuda", geometry="small"):
    """Plan and check one case in a fresh directory."""
    case = plan(name, seed, geometry)
    with tempfile.TemporaryDirectory() as tmp:
        return check(case, device, tmp)


# ------------------------------------------------------------- campaign

def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m armon_torch.fuzz",
        description="The option-space fuzz campaign (module doc).")
    ap.add_argument("start", nargs="?", type=int, default=0)
    ap.add_argument("count", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--geometry", default="small", choices=("small", "card"))
    ap.add_argument("--oracles", default=",".join(ORACLES))
    args = ap.parse_args(argv)
    from .core.solver import clear_cache
    from .params import resolve_device
    device = str(resolve_device(args.device))  # "cuda" without a card raises
    names = [n for n in args.oracles.split(",") if n]
    unknown = [n for n in names if n not in ORACLES]
    if unknown:
        ap.error(f"unknown oracles {unknown}; known: {list(ORACLES)}")
    counts = {n: {"ok": 0, "skip": 0, "fail": 0} for n in names}
    failures = []
    t0 = time.perf_counter()
    for name in names:
        n = max(1, int(args.count * ORACLES[name][2]))
        for seed in range(args.start, args.start + n):
            t = time.perf_counter()
            try:
                run(name, seed, device, args.geometry)
                status = "ok"
            except Skip as e:
                status = f"skip ({e})"
            except Exception:  # a campaign reports every failure and goes on
                status = "FAIL"
                failures.append((name, seed))
                traceback.print_exc()
                sys.stderr.flush()
            finally:
                clear_cache()
            counts[name][status.split(" ")[0].lower()] += 1
            print(f"[{name}] seed={seed}: {status} "
                  f"({time.perf_counter() - t:.2f} s)", flush=True)
    for name, seed in failures:
        print(f"  FAIL {name} seed={seed}")
    print(json.dumps({"fuzz": counts, "runs": sum(
        sum(c.values()) for c in counts.values()), "failures": len(failures),
        "device": device if device == "cpu" else
        torch.cuda.get_device_name(torch.device(device)),
        "geometry": args.geometry, "start": args.start, "count": args.count,
        "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
