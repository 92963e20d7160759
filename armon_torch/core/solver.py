"""Solver entry point: `armon(params) -> SolverStats`
(`armon_tpu/core/solver.py:826-1048`, `src/solver.jl:406-516`).

Two paths, chosen by `kernel_tier` alone:
- the lean path of the JAX package, over the hand-written kernels:
  `make_init_fused` (init, the cycle-0 EOS and the CFL seed, returning
  only the five carried fields), the lean time loop (`core/step.py`,
  per-sweep, pair or multicycle route as the JAX package routes), the
  conservation check over the carry, and `make_rehydrate` when the caller
  asks for the full State;
- the op path (``kernel_tier="torch"`` or ``"jnp"``), the JAX package's
  non-lean jnp-tier run: `make_init` (the full State), the op path's loop
  (`core/step.make_time_loop`, which runs the cycle-0 EOS), and the
  conservation check over the final State.

Every step runs on each shard of the mesh (`parallel/mesh.py`; one shard
holding the whole grid when P = (1, 1)): the carry is a list of
FusedCarry, one per shard in the mesh's order, and `return_data` gathers
the global State (`interop.gather_state`).
"""

import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.errors import solver_error
from ..params import ArmonParameters
from ..ops.init import init_state
from ..ops.eos import update_eos
from ..ops.reductions import (cfl_maxima, cfl_limit, conservation_vars,
                              conservation_scalar)
from ..parallel.mesh import Mesh
from .state import State, FusedCarry
from .step import make_time_loop_lean, make_time_loop


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
    mesh."""
    return Mesh(params.config, params.devices)


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
                for shard in make_mesh(params)]

    return init


def make_init_fused(params):
    """() -> (carry, CFL seed): the initial state, its cycle-0 EOS and the
    seed of the carried CFL minimum (`core/solver.py:149`). x, y, c, g are
    dropped once the seed is formed. The carry is a list of FusedCarry, one
    per shard in the mesh's order (one off a mesh), each shard initialised
    at its global origin; the seed is formed on the first shard's device
    from every shard's maxima: the minimum of the shards' dt (`pmin_dt`,
    :173), bit for bit."""
    cfg = params.config

    def init():
        carry, mx, my = [], [], []
        for shard in make_mesh(params):
            st = _initial_state(params, shard)
            carry.append(FusedCarry(st.rho, st.u, st.v, st.E, st.p))
            if not cfg.cst_dt:
                a, b = cfl_maxima(cfg, st.u, st.v, st.c, shard.n_real)
                mx.append(a.to(params.device))
                my.append(b.to(params.device))
        if cfg.cst_dt:
            seed = torch.tensor(float(np.finfo(cfg.dtype).max),
                                dtype=carry[0].rho.dtype, device=params.device)
        else:
            seed = cfl_limit(cfg, torch.stack(mx).amax(), torch.stack(my).amax())
        return carry, seed

    return init


def make_rehydrate(params):
    """(carry) -> a State per shard: re-runs the deterministic init +
    cycle-0 EOS for the fields the loop never touches (x/y, ustar/pstar =
    0, c/g of the initial fields), as `core/solver.py:213` does."""
    def rehydrate(fs):
        return [_initial_state(params, shard)._replace(
                    rho=f.rho, u=f.u, v=f.v, E=f.E, p=f.p)
                for shard, f in zip(make_mesh(params), fs)]

    return rehydrate


def make_conservation(params):
    """(shards) -> (mass, energy) as host floats (`core/solver.py:247,282`)
    for the lean carry or the op path's States, one per shard: rho and E
    are all it reads; f32 sums are compensated pairs, and a mesh's shards
    (real cells only, the edge shards' slack left out) are summed, in f64
    on the host."""
    cfg = params.config

    def call(fs):
        ms, es = [], []
        for shard, f in zip(make_mesh(params), fs):
            m, e = conservation_vars(cfg, f.rho, f.E, shard.n_real)
            ms.append(m)
            es.append(e)
        return conservation_scalar(cfg, ms), conservation_scalar(cfg, es)

    return call


def _isapprox0(x, atol, rtol):
    """Julia `isapprox(x, 0; atol, rtol)` (src/solver.jl:481-482)."""
    return abs(x) <= max(atol, rtol * abs(x))


def armon(params: ArmonParameters, checkpoint=None,
          restore_from=None) -> SolverStats:
    """Main entry point (`src/solver.jl:406-516`): the lean path over the
    kernels, or the op path when `kernel_tier` asks for it."""
    if checkpoint is not None or restore_from is not None:
        solver_error("config", "checkpoint hooks and restore_from are not "
                               "available in armon_torch yet: they come with "
                               "ROADMAP queue A item 8 (other drivers + "
                               "restart)")
    cfg = params.config
    if params.silent < 3:
        print(params.describe())

    op = cfg.op_path
    timer = {} if params.measure_time else None
    t_start = time.perf_counter()
    if op:  # per shard: the lean carry, or the op path's full State
        fs = make_init(params)()
    else:
        fs, local0 = make_init_fused(params)()
    _sync(params)
    if timer is not None:
        timer["init"] = time.perf_counter() - t_start

    if params.check_result:
        m, e = make_conservation(params)(fs)
        params.initial_mass, params.initial_energy = m, e

    T = np.dtype(cfg.dtype).type
    solve_start = time.perf_counter()
    if op:
        res = make_time_loop(cfg, make_mesh(params))(fs, T(0.0), 0, T(0.0))
    else:
        res = make_time_loop_lean(cfg, make_mesh(params))(fs, T(0.0), 0,
                                                          T(0.0), local0)
    solve_time = time.perf_counter() - solve_start
    if timer is not None:
        timer["solver_cycle"] = solve_time
    params._final_local_min = res.lm
    fs = res.carry
    if not res.ok:
        solver_error("time", f"Invalid time step at cycle {res.cycles}")

    state = None
    if params.return_data:
        from ..interop import gather_state
        state = gather_state(params, fs if op else make_rehydrate(params)(fs))

    # Final conservation check (src/solver.jl:467-490)
    if params.check_result and params.test.is_conservative and res.cycles > 0:
        m, e = make_conservation(params)(fs)
        dm = abs(m - params.initial_mass) / params.initial_mass
        de = abs(e - params.initial_energy) / params.initial_energy
        rtol = 1e-2 * min(1.0, res.t / params.test.default_max_time)
        if not (_isapprox0(dm, 1e-12, rtol) and _isapprox0(de, 1e-12, rtol)):
            warnings.warn(
                f"Mass and energy are not constant, the solution might not be "
                f"valid!\n|dM|/M = {dm:.6g}\n|dE|/E = {de:.6g}")

    cell_count = cfg.n_global[0] * cfg.n_global[1]
    grind = solve_time / max(res.cycles, 1) / cell_count
    stats = SolverStats(
        final_time=res.t,
        last_dt=res.dt_last,
        cycles=res.cycles,
        solve_time=solve_time,
        cell_count=cell_count,
        giga_cells_per_sec=1.0 / grind / 1e9 if res.cycles > 0 else 0.0,
        data=state,
        timer=timer,
        host_reads=res.host_reads,
    )
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
