"""Solver entry point: `armon(params) -> SolverStats`
(`armon_tpu/core/solver.py:826-1048`, `src/solver.jl:406-516`).

Four drivers, chosen as the JAX package chooses them:
- the lean loop over the hand-written kernels (`core/step.py`
  `make_time_loop_lean`, per-sweep, pair or multicycle route):
  `make_init_fused` (init, the cycle-0 EOS and the CFL seed, returning
  only the five carried fields), the loop, the conservation check over the
  carry, and `make_rehydrate` when something reads the full State; a run
  restored from a snapshot with its CFL carry resumes through the same
  loop (under temporal blocking, only from an even cycle);
- the op path's loop (``kernel_tier="torch"`` or ``"jnp"``, the JAX
  package's jnp tier): `make_init` (the full State), `core/step.
  make_time_loop` (the cycle-0 EOS, or a restored State with the
  snapshot's carry for its first cycle), the check over the final State;
- the full-state restore loop over the kernels: a restored run that the
  lean loop cannot take (no carry in the snapshot, or an odd cycle under
  temporal blocking) runs the lean loop's cycles, one cycle at a time
  (pair or per-sweep, never K5), from the restored States;
- the per-cycle driver (`_cycle_driver`), when something is to be done
  on the host after each cycle: the `silent <= 1` line, animation frames,
  `checkpoint_step` snapshots, and compare mode. One cycle of the kernels
  (`core/step.KernelCycles`, the lean loop's body) or of the op path per
  call, one host read a cycle; compare mode steps through the op path's
  sub-steps with a hook between each (`make_file_checkpoint`).

Every step runs on each shard of the mesh (`parallel/mesh.py`; one shard
holding the whole grid when P = (1, 1)): the carry is a list of
FusedCarry or State, one per shard in the mesh's order, and `return_data`
gathers the global State (`interop.gather_state`). Over several processes
(`parallel/dist.py`) each process runs the same driver on its own shards
(`Mesh.local`): the carry and `return_data` hold those, output and
snapshots are per shard, and every process prints, as the JAX package's
do.

Observability (`armon_tpu/core/solver.py:848-1014`): `armon()` times its
sections `init`, `conservation_vars` and `solver_cycle` (`utils/
profiling.section`, reported in `SolverStats.timer`); `profiling=
["trace"]` profiles `solver_cycle` into `output_dir/profile`;
`log_blocks` runs the per-cycle driver, which logs each cycle's t, dt and
wall time (`utils/solver_log.SolverLog`, `SolverStats.grid_log`), and
after the loop `measure_sections` times a cycle's pieces on copies of
the final state, beside the trace's per-kernel table.
"""

import contextlib
import os
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.enums import Axis
from ..utils.errors import solver_error
from ..utils.profiling import Timer, section, trace, kernel_times
from ..utils.solver_log import SolverLog
from ..params import ArmonParameters
from ..ops import sweep as K
from ..ops.init import init_state
from ..ops.eos import update_eos, scalar_like
from ..ops.projection import projection_remap
from ..ops.reductions import (cfl_maxima, cfl_limit, conservation_vars,
                              conservation_scalar)
from ..ops.riemann import numerical_fluxes
from ..ops.routing import cycle_route, temporal_pairs
from ..ops.update import cell_update
from ..parallel import dist
from ..parallel.dist import gather_shards
from ..parallel.halo import halo_exchange_state, halo_slabs
from ..parallel.mesh import Mesh
from .splitting import split_schedules
from .state import State, FusedCarry, torch_dtype
from .step import (STOP_CHECK_EVERY, LoopResult, make_time_loop_lean,
                   make_time_loop, solver_cycle)
from .timestep import next_time_step, dt_update


@dataclass
class SolverStats:
    """`src/solver.jl:13-23`."""
    final_time: float
    last_dt: float
    cycles: int
    solve_time: float            # seconds
    cell_count: int
    giga_cells_per_sec: float    # cell-cycles per second / 1e9
    data: Optional[State] = None
    timer: Optional[dict] = None
    grid_log: Optional[SolverLog] = None
    host_reads: int = 0          # device-to-host scalar reads in the loop

    def __repr__(self):
        return (f"Solver stats:\n"
                f" - final time:  {self.final_time:.18f}\n"
                f" - last dt:     {self.last_dt:.18f}\n"
                f" - cycles:      {self.cycles}\n"
                f" - performance: {self.giga_cells_per_sec * 1e3:.3f} x10^6 "
                f"cell-cycles/sec ({self.solve_time:.3f} sec, "
                f"{self.cell_count} cells)")


def _sync(params):
    for device in dict.fromkeys(params.devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def make_mesh(params):
    """The shard grid of the run: one shard holding the whole grid off a
    mesh; over several processes, this process's shards are `local`."""
    return Mesh.of(params)


def _initial_state(params, shard):
    """init_test + the cycle-0 EOS (`src/solver.jl:291-295`) of one shard."""
    cfg = params.config
    st = init_state(cfg, shard.device, shard.global_pos)
    return update_eos(cfg, st) if cfg.maxcycle > 0 else st


def make_init(params):
    """() -> the initial State of each shard, in the mesh's order, before
    the cycle-0 EOS (`core/solver.py:125`; the op path's loop runs it)."""
    cfg = params.config

    def init():
        return [init_state(cfg, shard.device, shard.global_pos)
                for shard in make_mesh(params).local]

    return init


def make_init_fused(params):
    """() -> (carry, CFL seed): the initial state, its cycle-0 EOS and the
    seed of the carried CFL minimum (`core/solver.py:149`). x, y, c, g are
    dropped once the shard's maxima are formed. The carry is a list of
    FusedCarry, one per shard in the mesh's order (one off a mesh), each
    shard initialised at its global origin; the seed is `cfl_seed`'s."""

    def init():
        mesh = make_mesh(params)
        carry, maxima = [], []
        for shard in mesh.local:
            st = _initial_state(params, shard)
            carry.append(FusedCarry(st.rho, st.u, st.v, st.E, st.p))
            maxima.append(_shard_maxima(params, shard, st))
        return carry, _seed(params, mesh, maxima, carry[0].rho.dtype)

    return init


def _shard_maxima(params, shard, st):
    """A shard's CFL maxima (max |u|+c, max |v|+c), on the first shard's
    device."""
    if params.config.cst_dt:
        return None
    return torch.stack(cfl_maxima(params.config, st.u, st.v, st.c,
                                  shard.n_real)).to(params.device)


def _seed(params, mesh, maxima, dtype):
    """The CFL seed from the maxima of this process's shards, gathered
    over every shard of the mesh."""
    cfg = params.config
    if cfg.cst_dt:
        return torch.tensor(float(np.finfo(cfg.dtype).max), dtype=dtype,
                            device=params.device)
    m = torch.stack(gather_shards(mesh, maxima))
    return cfl_limit(cfg, m[:, 0].amax(), m[:, 1].amax())


def cfl_seed(params, states):
    """The seed of the carried CFL minimum from every shard's State (its
    u, v and c), on the first shard's device: the minimum of the shards'
    dt (`pmin_dt`, `core/solver.py:173`), bit for bit."""
    mesh = make_mesh(params)
    return _seed(params, mesh, [_shard_maxima(params, shard, st)
                                for shard, st in zip(mesh.local, states)],
                 states[0].rho.dtype)


def make_rehydrate(params):
    """(carry) -> a State per shard: re-runs the deterministic init +
    cycle-0 EOS for the fields the loop never touches (x/y, ustar/pstar =
    0, c/g of the initial fields), as `core/solver.py:213` does."""
    def rehydrate(fs):
        return [_initial_state(params, shard)._replace(
                    rho=f.rho, u=f.u, v=f.v, E=f.E, p=f.p)
                for shard, f in zip(make_mesh(params).local, fs)]

    return rehydrate


def make_conservation(params):
    """(shards) -> (mass, energy) as host floats (`core/solver.py:247,282`)
    for the lean carry or the op path's States, one per shard this process
    drives: rho and E are all it reads; f32 sums are compensated pairs,
    and a mesh's shards (real cells only, the edge shards' slack left out)
    are summed in mesh order, in f64 on the host. Over several processes
    every process gathers every shard's pair and sums them in that order,
    so each gets the one-process run's values, bit for bit."""
    cfg = params.config

    def call(fs):
        mesh = make_mesh(params)
        pairs = []
        for shard, f in zip(mesh.local, fs):
            m, e = conservation_vars(cfg, f.rho, f.E, shard.n_real)
            pairs.append(torch.tensor([conservation_scalar(cfg, m),
                                       conservation_scalar(cfg, e)],
                                      dtype=torch.float64))
        ms, es = zip(*(p.tolist() for p in gather_shards(mesh, pairs)))
        return float(sum(ms)), float(sum(es))

    return call




# ------------------------------------------------------------ program cache
#
# The counterpart of the JAX package's compiled-program cache (`_cached`,
# `armon_tpu/core/solver.py:66-93`): an LRU of `_FN_CACHE_MAX` entries
# keyed on the configuration and the entry point's kind, skipped where the
# caller gave explicit devices. The JAX package keeps programs; the
# port's kernel loops keep their buffers, device scalars and CUDA graphs
# (`core/step.LeanLoop`), so a warm call only copies the carry in,
# refills the scalars, launches and reads. The key adds what the port's
# configuration does not hold: this process's devices, and the entry point's
# `graphs` and `whole` (a traced run takes window graphs).

_FN_CACHE = OrderedDict()
_FN_CACHE_MAX = 64


def _cached(params, kind, build):
    """`build()`, kept under (config, reorder_grid, this process's
    devices, `kind`) and used again by a later call with an equal key;
    built anew on every call where the caller gave `devices`. Before an
    entry is built, the least recently used entries go until the run fits
    the card (`_make_room`). Every process of a run makes the same calls,
    so each hits or misses as the others do, and drops the same
    entries."""
    if params._devices_given:
        return build()
    key = (params.config, params.reorder_grid, params.devices, kind)
    fn = _FN_CACHE.get(key)
    if fn is not None:
        _FN_CACHE.move_to_end(key)
        return fn
    while len(_FN_CACHE) >= _FN_CACHE_MAX:
        _FN_CACHE.popitem(last=False)
    _make_room(params)
    fn = _FN_CACHE[key] = build()
    return fn


def _free_bytes(device):
    """What the card `device` can still give: its free memory and what
    torch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _make_room(params):
    """Drop the least recently used entries until the run's device bytes
    fit on each of this process's cards: `memory_required()`'s
    `per_device_fused_total_bytes` over the kernels (the loop the entry
    keeps, and the rest of the run beside it), `per_device_total_bytes`
    on the op path. Over several processes every process then drops as
    many as the one that dropped most (one gather, on a miss only, when
    every process misses), so that all hold the same entries. On the CPU
    the LRU bound alone holds the cache."""
    cards = {d for d in params.devices if d.type == "cuda"}
    if not cards:
        return
    mem = params.memory_required()
    need = mem["per_device_total_bytes" if params.config.op_path
               else "per_device_fused_total_bytes"]
    dropped = 0
    while _FN_CACHE and min(map(_free_bytes, cards)) < need:
        _FN_CACHE.popitem(last=False)
        dropped += 1
    if params.process_count > 1:
        most = int(dist.all_gather_rows(torch.tensor([dropped]),
                                        params.device).max())
        for _ in range(most - dropped):
            if _FN_CACHE:
                _FN_CACHE.popitem(last=False)


def clear_cache():
    """Empty the program cache: its loops' buffers and graphs go with it
    (where nothing else holds them). For tests, and for `parallel/
    dist.shutdown`, before the process group whose NCCL calls the
    entries' graphs hold is destroyed. Never during a capture."""
    _FN_CACHE.clear()


def make_jit_loop_lean(params, graphs=None, whole=True):
    """The lean loop on the configuration's route (`make_jit_loop_lean`,
    `armon_tpu/core/solver.py:193-210`): `core/step.make_time_loop_lean`
    over this process's mesh, kept across calls (`_cached`).
    (fs, t0, cycle0, dt0, local0, check_every, copy_out) -> LoopResult;
    `graphs` and `whole` as the loop takes them."""
    cfg = params.config
    return _cached(params, ("loop_lean", graphs, whole),
                   lambda: make_time_loop_lean(cfg, make_mesh(params), (),
                                               None, graphs, whole))


def make_jit_loop(params, restore=False, graphs=None, whole=True):
    """The full-state loop (`make_jit_loop`, `armon_tpu/core/solver.py:
    326-341`), kept across calls (`_cached`): (states, t0, cycle0, dt0,
    lm0, check_every) -> LoopResult whose carry is a State per shard. On
    the op path, `core/step.make_time_loop`. Over the kernels, the lean
    loop's cycles on the route of one cycle (never K5) from the States:
    the cycle-0 EOS first unless `restore`, then the CFL seed, `lm0` (a
    snapshot's carry) where given, else from the States' u, v and c; the
    result's States are the given ones with the carried fields replaced
    (copies unless `copy_out` is False, as in `make_time_loop_lean`).
    `graphs` and `whole` as the lean loop takes them."""
    cfg = params.config
    if cfg.op_path:
        return _cached(params, ("loop", restore),
                       lambda: make_time_loop(cfg, make_mesh(params), restore))
    T = np.dtype(cfg.dtype).type

    def build():
        lean = make_time_loop_lean(cfg, make_mesh(params),
                                   kind=cycle_route(cfg), graphs=graphs,
                                   whole=whole)

        def loop(states, t0=0.0, cycle0=0, dt0=0.0, lm0=None,
                 check_every=STOP_CHECK_EVERY, copy_out=True):
            single = isinstance(states, State)
            states = [states] if single else list(states)
            if not restore and cfg.maxcycle > 0:
                states = [update_eos(cfg, st) for st in states]
            local0 = lm0 if lm0 is not None else \
                float(cfl_seed(params, states))
            res = lean(_carry_of(states), T(t0), int(cycle0), T(dt0), local0,
                       check_every, copy_out)
            out = _full_states(params, res.carry, states)
            return res._replace(carry=out[0] if single else out)
        return loop

    return _cached(params, ("loop", restore, graphs, whole), build)


def make_cycle(params, graphs=None):
    """The per-cycle driver's step over the kernels (`make_cycle`,
    `armon_tpu/core/solver.py:344-345`), kept across calls (`_cached`): a
    lean loop on the route of one cycle (`cycle_route`: pair or
    per-sweep, never K5) whose `load(fs, t0, cycle0, dt0, local0)` gives
    its `core/step.KernelCycles`, loaded; one-cycle window graphs where
    graphs run (`graphs` as the lean loop takes it)."""
    cfg = params.config
    return _cached(params, ("cycle", graphs),
                   lambda: make_time_loop_lean(cfg, make_mesh(params),
                                               kind=cycle_route(cfg),
                                               graphs=graphs, whole=False))


def _full_states(params, fs, base=None):
    """The full State of each shard from a kernel run's carry: the
    restored States' other fields when the run was restored (`base`), else
    rehydrated as a fresh run's (`make_rehydrate`)."""
    if base is None:
        return make_rehydrate(params)(fs)
    return [b._replace(rho=f.rho, u=f.u, v=f.v, E=f.E, p=f.p)
            for b, f in zip(base, fs)]


def _carry_of(states):
    return [FusedCarry(st.rho, st.u, st.v, st.E, st.p) for st in states]


# ------------------------------------------------------------------ drivers

def make_step_fns(params):
    """The op path's sub-steps for compare mode (`_make_step_fns`,
    `core/solver.py:555-604`), each over the States of every shard of the
    mesh: the halo exchange and the CFL minimum look across shards, as the
    reference's per-rank `step_checkpoint` does (`src/io.jl:185-227`)."""
    cfg = params.config
    mesh = make_mesh(params)

    fns = {}
    for axis in (Axis.X, Axis.Y):
        fns[("eos", axis)] = lambda states: [update_eos(cfg, st)
                                             for st in states]
        fns[("bc", axis)] = lambda states, a=axis: halo_exchange_state(
            cfg, mesh, states, a)
        for name, op in (("fluxes", numerical_fluxes), ("update", cell_update),
                         ("remap", projection_remap)):
            fns[(name, axis)] = (lambda states, dt, a=axis, op=op:
                                 [op(cfg, st, a, dt.to(s.device))
                                  for s, st in zip(mesh.local, states)])
    fns["dt"] = lambda states, dtp, cyc, seeded: next_time_step(
        cfg, mesh, states, dtp, cyc, seeded)
    fns["dt_resume"] = lambda dtp, cyc, lm: dt_update(cfg, lm, dtp, cyc)
    return fns


def _section_timer(params, reps):
    """fn -> the best of `reps` timed calls of fn(), in seconds, after one
    untimed call: CUDA events on the card when every shard is on one card
    (`_card.time_ms`), else the host clock after waiting for every
    device."""
    devices = set(params.devices)
    if params.device.type == "cuda" and len(devices) == 1:
        from .._card import time_ms

        def timed(fn):
            with torch.cuda.device(params.device):
                return time_ms(lambda i: fn(), params.device, k=1,
                               passes=reps) / 1e3
        return timed

    def timed(fn):
        fn()
        _sync(params)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            _sync(params)
            best = min(best, time.perf_counter() - t0)
        return best
    return timed


def measure_sections(params, states, reps=3):
    """Per-section seconds of one cycle (`measure_sections`, `core/
    solver.py:658-730`): the cycle's pieces run apart, each the best of
    `reps`, on copies of `states` (one FusedCarry or State per shard, mesh
    order), which stay as they are. Kernel tiers: `ghost_exchange_X/Y`
    (`halo_exchange_state` over rho/u/v/E: the neighbours' lines on a
    mesh, the mirror at global borders) and `sweep_X/Y` (one K1 or K2
    launch a shard, writing the stale p and the CFL partials). The op
    path: `eos/bc/fluxes/update/remap` per axis (`make_step_fns`) and
    `time_step`. Indicative shares: the in-loop cycle overlaps and fuses
    what these run apart."""
    cfg = params.config
    T = np.dtype(cfg.dtype).type
    timed = _section_timer(params, reps)
    mesh = make_mesh(params)
    like = states[0].rho
    dt = scalar_like(like, T(1e-6))
    sections = {}
    if not cfg.op_path:
        fields = [(st.rho, st.u, st.v, st.E) for st in states]
        dst = [tuple(torch.empty_like(a) for a in f) for f in fields]
        p = [torch.empty_like(f[0]) for f in fields]
        for axis in (Axis.X, Axis.Y):
            sections[f"ghost_exchange_{axis.name}"] = timed(
                lambda a=axis: halo_exchange_state(
                    cfg, mesh, states, a, FusedCarry._fields[:4]))
            nb = K.n_partials(axis, like.shape, like.device)
            bufs = [(torch.zeros((2, nb), dtype=like.dtype, device=s.device),
                     *K.new_scalars(cfg.dtype, s.device)) for s in mesh.local]
            for _, scal, iscal in bufs:
                scal[K.SC_DTUSE] = float(T(1e-6))
                iscal[K.IS_RUN] = 1
            launch = K.x_sweep if axis is Axis.X else K.y_sweep
            ghosts = halo_slabs(cfg, mesh, fields, axis) \
                if mesh.proc_dims[axis] > 1 else [K.MIRRORED] * len(mesh.local)

            def sweep(launch=launch, bufs=bufs, ghosts=ghosts):
                for s in mesh.local:
                    k = s.slot
                    part, scal, iscal = bufs[k]
                    launch(cfg, fields[k], dst[k], p[k], part, scal, iscal,
                           1.0, True, ghosts[k], s.n_real)
            sections[f"sweep_{axis.name}"] = timed(sweep)
        return sections
    fns = make_step_fns(params)
    for axis in (Axis.X, Axis.Y):
        sections[f"eos_{axis.name}"] = timed(
            lambda a=axis: fns[("eos", a)](states))
        sections[f"bc_{axis.name}"] = timed(
            lambda a=axis: fns[("bc", a)](states))
        for name in ("fluxes", "update", "remap"):
            sections[f"{name}_{axis.name}"] = timed(
                lambda a=axis, n=name: fns[(n, a)](states, dt))
    sections["time_step"] = timed(lambda: fns["dt"](states, dt, 2, True))
    return sections


def _checkpointed_cycle(params, fns, states, dt_prev, cycle_idx, checkpoint,
                        seeded, lm_override=None):
    """`solver_cycle` with a checkpoint hook after every sub-step
    (`src/solver.jl:288-320`, `core/solver.py:606-656`). `lm_override`:
    the snapshot's CFL carry, replacing the states' minimum on the first
    cycle resumed from a kernel run's snapshot (stale `c`). Returns
    (states, dt_use, dt_next, ok, stop)."""
    cfg = params.config
    T = np.dtype(cfg.dtype).type
    if lm_override is not None:
        dt_use, dt_next, ok = fns["dt_resume"](dt_prev, cycle_idx, lm_override)
    else:
        dt_use, dt_next, ok = fns["dt"](states, dt_prev, cycle_idx, seeded)
    even, odd = split_schedules(cfg.splitting)
    # time_step files are tagged X at cycle 0, else with the previous
    # cycle's last sweep axis, the reference's `state.axis` at that point
    # (src/io.jl:193-198), so that compare mode across implementations
    # finds the same file names.
    ts_axis = Axis.X if cycle_idx == 0 else \
        (even if (cycle_idx - 1) % 2 == 0 else odd)[-1][0]
    if checkpoint("time_step", states, ts_axis, float(dt_use), cycle_idx):
        return states, dt_use, dt_next, ok, True
    schedule = even if cycle_idx % 2 == 0 else odd
    seen = {}  # sweeps per axis within this cycle (Strang repeats one)
    for axis, factor in schedule:
        rep = seen[axis] = seen.get(axis, 0) + 1
        # `rep` rides a keyword only for a repeated axis (Strang's third
        # sweep), so that a five-argument hook works on every other
        # schedule.
        rkw = {"rep": rep} if rep > 1 else {}
        dt = dt_use * float(T(factor))
        dtf = float(dt)
        states = fns[("eos", axis)](states)
        if checkpoint("EOS", states, axis, dtf, cycle_idx, **rkw):
            return states, dt_use, dt_next, ok, True
        states = fns[("bc", axis)](states)
        if checkpoint("boundary_conditions", states, axis, dtf, cycle_idx,
                      **rkw):
            return states, dt_use, dt_next, ok, True
        for label, key in (("numerical_fluxes", "fluxes"),
                           ("cell_update", "update"),
                           ("projection_remap", "remap")):
            states = fns[(key, axis)](states, dt)
            if checkpoint(label, states, axis, dtf, cycle_idx, **rkw):
                return states, dt_use, dt_next, ok, True
    return states, dt_use, dt_next, ok, False


def _cycle_driver(params, states, fs, local0, checkpoint, restored,
                  solver_log=None, graphs=None):
    """The per-cycle driver (`_python_cycle_driver`, `core/solver.py:
    403-553`): one cycle per step, then the host's work for it: the
    `solver_log` event (cycle, t, dt used, wall seconds), a
    `checkpoint_step` snapshot, the `silent <= 1` line (after the
    conservation sums), an animation frame.

    Over the kernels (no hook, not the op path) a step is one cycle of
    `KernelCycles`, the lean loop's body, on the route of one cycle
    (`cycle_route`: pair or per-sweep, never K5), and the host reads the
    loop's int scalars once a cycle (whether the next cycle runs, and ok);
    t and dt are read only for a cycle whose log event, snapshot or line
    needs them. A cycle of the kernels is one replay of a one-cycle CUDA
    graph where graphs run (`core/graphs.py`; `graphs` as there), the
    counterpart of `make_cycle`. Otherwise a step is the op path's
    `solver_cycle`, or, with
    a hook, its sub-steps (`_checkpointed_cycle`), and the host reads dt
    and ok once a cycle. Returns (LoopResult, the restored States or
    None)."""
    cfg = params.config
    T = np.dtype(cfg.dtype).type
    mesh = make_mesh(params)
    conservation = make_conservation(params) if params.silent <= 1 else None
    t, cycles, dt_prev, lm = T(0.0), 0, T(0.0), None
    if restored is not None:
        t, cycles, dt_prev, lm = T(restored[0]), int(restored[1]), \
            T(restored[2]), restored[3]
    base = states if restored is not None else None
    kernels = not cfg.op_path and checkpoint is None
    params._ran_fused = kernels
    reads = 0

    def after_cycle(full, carry, t, dt_prev, lm):
        """The host's work after a cycle. `full` makes the full States."""
        if params.checkpoint_step and cycles % params.checkpoint_step == 0:
            from ..io.restart import save_checkpoint
            os.makedirs(params.output_dir, exist_ok=True)
            save_checkpoint(os.path.join(params.output_dir,
                                         params.output_file + ".ckpt.npz"),
                            params, full(), float(t), cycles, float(dt_prev),
                            local_min=lm)
        if conservation is not None:
            m, e = conservation(carry)
            dM = abs(params.initial_mass - m) / params.initial_mass * 100
            dE = abs(params.initial_energy - e) / params.initial_energy * 100
            # Printed after next_cycle!, where current_dt is already the
            # next cycle's dt (src/solver.jl:366-367); '#' keeps trailing
            # zeros as Julia's %#8.6g does.
            print(f"Cycle {cycles:4d}: dt = {float(dt_prev):.18f}, "
                  f"t = {float(t):.18f}, |dM| = {dM:#8.6g}%, "
                  f"|dE| = {dE:#8.6g}%")
        if params.animation_step != 0 and \
                (cycles - 1) % params.animation_step == 0:
            frame = (cycles - 1) // params.animation_step
            anim_dir = os.path.join(params.output_dir, "anim")
            os.makedirs(anim_dir, exist_ok=True)
            _write_state(params, full(),
                         os.path.join(anim_dir,
                                      f"{params.output_file}_{frame:03d}"),
                         per_shard=cfg.spmd and params.use_MPI)

    if kernels:
        if fs is None:  # restored: the carry, or a seed from the saved c
            fs = _carry_of(states)
            local0 = lm if lm is not None else float(cfl_seed(params, states))
        run = make_cycle(params, graphs).load(fs, t, cycles, dt_prev, local0)
        pre = run.scal.clone()
        running = t < T(cfg.maxtime) and cycles < cfg.maxcycle
        if running:
            run.first_step()
        while running:
            cycle_start = time.perf_counter()
            pre.copy_(run.scal)  # t, dt_prev and dt_use after this cycle
            run.window(cycles, 1)
            _, ok, running, _ = run.iscal.tolist()
            reads += 1
            cycles += 1
            if not running and not ok:
                solver_error("time", f"Invalid time step for cycle "
                                     f"{cycles - 1}")
            if solver_log is not None:
                sc = pre.tolist()
                reads += 1
                solver_log.push(cycles, sc[K.SC_T], sc[K.SC_DTUSE],
                                time.perf_counter() - cycle_start)
            if conservation is not None or (params.checkpoint_step and
                                            cycles % params.checkpoint_step == 0):
                tv, dtv, lmv = torch.stack([pre[K.SC_T], pre[K.SC_DTPREV],
                                            run.scal[K.SC_LM]]).tolist()
                reads += 1
            else:
                tv = dtv = lmv = None
            after_cycle(lambda: _full_states(params, run.carry(), base),
                        run.carry(), tv, dtv, lmv)
        # The carry is the loop's own unless the caller gets it back.
        res = run.result(reads, copy_out=params.return_data)
        params._final_local_min = res.lm
        return res, base

    fns = make_step_fns(params) if checkpoint is not None else None
    like = states[0].rho
    if restored is None:
        if checkpoint is not None and \
                checkpoint("init_test", states, Axis.X, 0.0, 0):
            return _op_result(states, t, cycles, dt_prev, reads), base
        if cfg.maxcycle > 0:
            states = [update_eos(cfg, st) for st in states]
            if checkpoint is not None and \
                    checkpoint("EOS_init", states, Axis.X, 0.0, 0):
                return _op_result(states, t, cycles, dt_prev, reads), base
    # A snapshot's carry overrides the first resumed cycle's CFL minimum.
    resume_lm = scalar_like(like, T(lm)) if lm is not None else None
    dt_t = scalar_like(like, dt_prev)
    while t < T(cfg.maxtime) and cycles < cfg.maxcycle:
        cycle_start = time.perf_counter()
        seeded = dt_prev != 0
        if checkpoint is None:
            states, dt_use, dt_next, ok = solver_cycle(
                cfg, mesh, states, dt_t, cycles, seeded, resume_lm)
            stop = False
        else:
            states, dt_use, dt_next, ok, stop = _checkpointed_cycle(
                params, fns, states, dt_t, cycles, checkpoint, seeded,
                resume_lm)
        resume_lm = None
        du, dn, okv = torch.stack([dt_use, dt_next, ok.to(dt_use.dtype)]
                                  ).tolist()
        reads += 1
        if stop:
            return _op_result(states, t, cycles, T(dn), reads), base
        if not okv:
            solver_error("time", f"Invalid time step for cycle {cycles}: {dn}")
        t = T(t + T(du))
        cycles += 1
        dt_prev, dt_t = T(dn), dt_next
        if solver_log is not None:
            solver_log.push(cycles, float(t), float(T(du)),
                            time.perf_counter() - cycle_start)
        after_cycle(lambda: states, states, t, dt_prev, None)
    return _op_result(states, t, cycles, dt_prev, reads), base


def _op_result(states, t, cycles, dt, reads):
    """The op path's per-cycle result: no CFL carry is recorded."""
    return LoopResult(states, float(t), cycles, float(dt), float("nan"),
                      True, reads)


def _restore_loop_kernels(params, states, restored, graphs=None, whole=True):
    """The full-state restore loop over the kernels (`make_time_loop(
    restore=True)`'s fused branch, `armon_tpu/core/step.py:483-598`), kept
    across calls (`make_jit_loop(params, restore=True)`): the lean loop's
    cycles on the route of one cycle (never K5) from the restored States,
    seeded with the snapshot's carry or, without one, from the saved c as
    a fresh start is. The result's carry is a State per shard, the loop's
    own fields unless `return_data` hands them out. `graphs` and `whole`
    as `make_time_loop_lean` takes them."""
    T = np.dtype(params.config.dtype).type
    t, cycles, dt_prev, lm = restored
    return make_jit_loop(params, True, graphs, whole)(
        states, T(t), cycles, T(dt_prev), lm, copy_out=params.return_data)


def _write_state(params, states, path, per_shard, with_ghosts=False,
                 host=None):
    """A state file of the per-shard States: one per shard (`_<cx>×<cy>`,
    no global gather) or one of the gathered global State (`host`, where
    the caller has gathered it already). Returns the files written."""
    if per_shard:
        from ..io.subdomain import write_sub_domain_files
        return write_sub_domain_files(params, states, path,
                                      precision=params.output_precision,
                                      with_ghosts=with_ghosts)
    from ..interop import gather_state
    from ..io.output import write_state_file
    if host is None:
        host = gather_state(params, states)
    write_state_file(params.config, host, path,
                     precision=params.output_precision,
                     with_ghosts=with_ghosts)
    return [path]


def make_file_checkpoint(params):
    """The `step_checkpoint` hook (`src/io.jl:185-227`, `core/solver.py:
    1051-1115`): with `is_ref`, write a file per sub-step; otherwise
    compare against it, and on a difference write the differing state
    beside the reference file as `_diff` (`src/io.jl:220-222`) and stop.
    On a mesh, state files are per shard, `_<cx>×<cy>`, with no global
    gather; the dt file stays global."""
    from ..interop import gather_state
    from ..io.output import write_state_file, read_state_file, compare_states
    cfg = params.config

    def checkpoint(label, states, axis, dt, cycle, rep=1):
        axis_char = "X" if axis is Axis.X else "Y"
        # `rep` tells apart an axis swept twice in one cycle (Strang's
        # (X, Y, X)), whose two half sweeps the reference's naming puts in
        # one file; only a repeat carries the suffix.
        rep_tag = "" if rep == 1 else f"_{rep}"
        name = f"{params.output_file}_{cycle:03d}_{label}_{axis_char}{rep_tag}"
        path = os.path.join(params.output_dir, name)
        if label == "time_step":
            if params.is_ref:
                with open(path, "w") as f:
                    f.write(f"%#{params.output_precision + 7}."
                            f"{params.output_precision}e\n" % dt)
                return False
            with open(path) as f:
                # parsed in the run's dtype, as `parse(T, ...)` does
                # (src/io.jl:198-203)
                ref_dt = float(np.dtype(cfg.dtype).type(f.read().strip()))
            tol = params.comparison_tolerance * max(abs(ref_dt), abs(dt))
            diff = not (abs(ref_dt - dt) <= tol)
            if diff:
                print(f"Time step difference: ref dt = {ref_dt:.18f}, "
                      f"dt = {dt:.18f}, diff = {ref_dt - dt:.18f}")
            return diff

        if cfg.spmd:
            return _spmd_file_checkpoint(params, label, states, path, cycle)
        host = gather_state(params, states)
        if params.is_ref:
            write_state_file(cfg, host, path, precision=params.output_precision,
                             with_ghosts=params.write_ghosts)
            return False
        ref = read_state_file(cfg, path, with_ghosts=params.write_ghosts)
        cnt, max_diff, details = compare_states(
            cfg, host, ref, atol=0.0, rtol=params.comparison_tolerance,
            with_ghosts=params.write_ghosts)
        if cnt:
            print(f"At {label} (cycle {cycle}): {cnt} differences "
                  f"(max rel {max_diff:.3e}): {details}")
            write_state_file(cfg, host, path + "_diff",
                             precision=params.output_precision,
                             with_ghosts=params.write_ghosts)
        return cnt > 0

    return checkpoint


def _spmd_file_checkpoint(params, label, states, path, cycle):
    """Per-shard write-or-compare of one sub-step on a mesh
    (`_spmd_file_checkpoint`, `core/solver.py:1117-1150`)."""
    from ..core.state import SAVED_VARS
    from ..io.output import count_differences, write_cells_file
    from ..io.subdomain import (write_sub_domain_files, read_sub_domain_file,
                                sub_domain_file_path, shard_coords_iter,
                                shard_real_window, ghost_window)
    cfg = params.config
    if params.is_ref:
        write_sub_domain_files(params, states, path,
                               precision=params.output_precision,
                               with_ghosts=params.write_ghosts)
        return False
    win = ghost_window if params.write_ghosts else shard_real_window
    total = 0
    for coords, blocks in shard_coords_iter(params, states):
        rs, cs, _, _ = win(cfg, coords)
        ours = {v: blocks[v][rs, cs] for v in SAVED_VARS}
        spath = sub_domain_file_path(path, coords)
        ref = read_sub_domain_file(cfg, spath, coords,
                                   with_ghosts=params.write_ghosts)
        cnt, max_diff, details = count_differences(
            cfg, ours, ref, atol=0.0, rtol=params.comparison_tolerance)
        if cnt:
            print(f"At {label} (cycle {cycle}, shard {coords}): {cnt} "
                  f"differences (max rel {max_diff:.3e}): {details}")
            write_cells_file(spath + "_diff", ours, params.output_precision)
        total += cnt
    # Every process stops at the same sub-step, or none does.
    return int(dist.all_gather_rows(torch.tensor([total]),
                                    params.device).sum()) > 0


def _isapprox0(x, atol, rtol):
    """Julia `isapprox(x, 0; atol, rtol)` (src/solver.jl:481-482)."""
    return abs(x) <= max(atol, rtol * abs(x))


def armon(params: ArmonParameters, checkpoint=None,
          restore_from=None, graphs=None) -> SolverStats:
    """Main entry point (`src/solver.jl:406-516`). `checkpoint`: a hook
    called after every sub-step (see `make_file_checkpoint`), which runs
    the op path's sub-steps; `restore_from`: a snapshot written by
    `io.restart.save_checkpoint` or the `checkpoint_step` option, from
    which the run resumes bit for bit. `graphs`: whether the kernels'
    loops run as CUDA graphs (`core/graphs.py`): None, where they can (a
    run of one process on one card, where a lean run is one whole-run
    graph, or of NCCL processes on a card each, where it is window
    graphs; the per-cycle driver a graph a cycle), False never (the
    eager loop), True raises where they cannot."""
    cfg = params.config
    # This run's CFL carry and the provenance of its state, recorded for
    # snapshots saved after the run (`io/restart.save_checkpoint`): reset,
    # so that a reused params object never lends a run's carry to another.
    params._final_local_min = None
    params._ran_fused = None
    if params.silent < 3:
        print(params.describe())

    op = cfg.op_path
    hooks = checkpoint is not None or params.compare
    solver_log = SolverLog(cfg.n_global[0] * cfg.n_global[1]) \
        if params.log_blocks else None
    use_python_loop = (params.silent <= 1 or params.animation_step != 0
                       or hooks or params.checkpoint_step != 0
                       or solver_log is not None)
    lean = not use_python_loop and not op
    if graphs and (op or hooks):
        solver_error("config", "graphs=True cannot run here: the op path "
                               "and compare mode run eagerly")
    T = np.dtype(cfg.dtype).type
    timer = Timer() if params.measure_time else None
    restored = states = fs = local0 = None
    with section("init", timer):
        if restore_from is not None:
            from ..io.restart import load_checkpoint
            states, *restored = load_checkpoint(restore_from, params)
            # The lean loop resumes a run as it would have gone on: it
            # needs the snapshot's carry, and under temporal blocking an
            # even cycle, where a K5 launch of an uninterrupted run starts
            # (`core/solver.py:869-895`). Otherwise the full-state restore
            # loop runs.
            lean = lean and restored[3] is not None and (
                temporal_pairs(cfg) is None or restored[1] % 2 == 0)
            if lean:
                fs, local0 = _carry_of(states), restored[3]
                states = None
        elif lean or (use_python_loop and not op and not hooks):
            fs, local0 = make_init_fused(params)()
        else:
            states = make_init(params)()
        # The loop's clock starts on an idle device, so every section here
        # ends on the device's work whatever `time_async` says (the JAX
        # package passes it to this section alone).
        _sync(params)

    if params.check_result or params.silent <= 1:
        with section("conservation_vars", timer):
            m, e = make_conservation(params)(fs if fs is not None else states)
            params.initial_mass, params.initial_energy = m, e

    if params.compare and checkpoint is None:
        checkpoint = make_file_checkpoint(params)
    base = None
    traced = "trace" in params.profiling
    # A traced run replays window graphs, not the whole-run graph: on the
    # card a trace was seen to lack a whole-run graph's kernel records
    # (PERF.md). So a trace observes the window form, not the whole-run
    # graph.
    whole = not traced
    profile_ctx = trace(os.path.join(params.output_dir, "profile"),
                        params.device) if traced \
        else contextlib.nullcontext()
    with profile_ctx as prof, section("solver_cycle", timer):
        solve_start = time.perf_counter()
        if use_python_loop:
            res, base = _cycle_driver(params, states, fs, local0, checkpoint,
                                      restored, solver_log, graphs)
        elif lean:
            r = restored or (0.0, 0, 0.0)
            # The result's carry is the loop's own, read before the loop's
            # next call, unless `return_data` hands it out.
            res = make_jit_loop_lean(params, graphs, whole)(
                fs, T(r[0]), int(r[1]), T(r[2]), local0,
                copy_out=params.return_data)
            params._ran_fused = True
        elif op:
            r = restored or (0.0, 0, 0.0, None)
            res = make_jit_loop(params, bool(restored))(
                states, T(r[0]), int(r[1]), T(r[2]), r[3])
            params._ran_fused = False
        else:
            res = _restore_loop_kernels(params, states, restored, graphs,
                                        whole)
            params._ran_fused = True
        solve_time = time.perf_counter() - solve_start
    # The initial carry was copied into the loop's buffers: let it go
    # before the rebuild and the outputs (`memory_required` counts the
    # loop's buffers and those, not this carry, after the loop).
    fs = None
    if params._ran_fused or not use_python_loop:
        params._final_local_min = res.lm
    if not res.ok:
        solver_error("time", f"Invalid time step at cycle {res.cycles}")

    if solver_log is not None and res.cycles > 0:
        # The cycle's pieces timed apart on copies of the final state, and
        # the trace's per-kernel table (`core/solver.py:967-986`).
        try:
            solver_log.sections = measure_sections(params, res.carry)
        except Exception as e:  # a probe failure must not kill the run
            warnings.warn(f"section probe failed: {type(e).__name__}: {e}")
        if traced:
            try:
                solver_log.trace_sections = kernel_times(prof)
            except Exception as e:
                warnings.warn(f"trace table failed: {type(e).__name__}: {e}")

    final = res.carry  # a FusedCarry or a State per shard
    states = None
    if params.return_data or params.write_output or params.write_slices:
        # A kernel run's full State is made only when something reads it.
        states = _full_states(params, final, base) \
            if isinstance(final[0], FusedCarry) else final

    # Final conservation check (src/solver.jl:467-490)
    if params.check_result and params.test.is_conservative and res.cycles > 0:
        m, e = make_conservation(params)(final)
        dm = abs(m - params.initial_mass) / params.initial_mass
        de = abs(e - params.initial_energy) / params.initial_energy
        rtol = 1e-2 * min(1.0, res.t / params.test.default_max_time)
        if not (_isapprox0(dm, 1e-12, rtol) and _isapprox0(de, 1e-12, rtol)):
            warnings.warn(
                f"Mass and energy are not constant, the solution might not be "
                f"valid!\n|dM|/M = {dm:.6g}\n|dE|/E = {de:.6g}")

    data = None
    if params.return_data:
        # Over several processes, this process's shards (`interop.
        # gather_state` raises there, as the JAX package's does).
        from ..interop import gather_state
        data = states if params.process_count > 1 \
            else gather_state(params, states)
    cell_count = cfg.n_global[0] * cfg.n_global[1]
    grind = solve_time / max(res.cycles, 1) / cell_count
    stats = SolverStats(
        final_time=res.t,
        last_dt=res.dt_last,
        cycles=res.cycles,
        solve_time=solve_time,
        cell_count=cell_count,
        giga_cells_per_sec=1.0 / grind / 1e9 if res.cycles > 0 else 0.0,
        data=data,
        timer=timer.report() if timer is not None else None,
        grid_log=solver_log,
        host_reads=res.host_reads,
    )

    # The final writes come last (`core/solver.py:1017-1043`).
    if params.write_output or params.write_slices:
        os.makedirs(params.output_dir, exist_ok=True)
        path = os.path.join(params.output_dir, params.output_file)
        # Per shard: one `_<cx>×<cy>` file per shard, no global gather
        # (`src/io.jl:46-75`).
        per_shard = cfg.spmd and params.use_MPI
        host = data if params.process_count == 1 else None
        if host is None and (params.write_slices or not per_shard):
            from ..interop import gather_state
            host = gather_state(params, states)
        if params.write_output:
            paths = _write_state(params, states, path, per_shard,
                                 params.write_ghosts, host=host)
            if params.silent < 2:
                print(f"\nWrote to files {paths[0]} .. {paths[-1]}"
                      if per_shard else f"\nWrote to file {path}")
        if params.write_slices:
            from ..io.slices import write_slices_files
            write_slices_files(cfg, host, path,
                               precision=params.output_precision)

    if params.silent < 3 and res.cycles > 0:
        _print_summary(stats, params)
    return stats


def _print_summary(stats, params):
    if params.silent >= 3:
        return
    print()
    print(f"Total time:  {stats.solve_time:.5f} sec")
    grind_us = stats.solve_time / max(stats.cycles, 1) / stats.cell_count * 1e6
    print(f"Grind time:  {grind_us:.5f} us/cell/cycle")
    print(f"Cells/sec:   {stats.giga_cells_per_sec * 1e3:.5f} Mega cells/sec")
    print(f"Cycles:      {stats.cycles}")
    print(f"Last cycle:  {stats.final_time:.18f} sec, dt={stats.last_dt:.18f} sec")


# Reference API parity (`src/Armon.jl:15-16` exports,
# `armon_tpu/core/solver.py:1181-1227`).
def device_to_host(params, shards):
    """The global padded grid as numpy arrays (a NamedTuple like each
    shard's) from per-shard blocks in the mesh's order, or from the one
    State or FusedCarry of a run off a mesh (`device_to_host!`,
    `src/blocking/block_grid.jl:712-737`)."""
    from ..interop import gather_state, to_numpy
    shards = [shards] if hasattr(shards, "_fields") else list(shards)
    return to_numpy(gather_state(params, shards))


def host_to_device(params, host_state):
    """Per-shard blocks, in the mesh's order and each on its shard's
    device, of a global padded grid given as a NamedTuple of numpy arrays
    or tensors: the inverse of `device_to_host` (`host_to_device!`). On an
    uneven split the edge shards' slack repeats the grid's last line."""
    from ..interop import scatter_state
    tdt = torch_dtype(params.data_type)
    return scatter_state(params, type(host_state)(*(
        torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a).to(device=params.device, dtype=tdt)
        for a in host_state)))
