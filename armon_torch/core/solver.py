"""Solver entry point: `armon(params) -> SolverStats`
(`armon_tpu/core/solver.py:826-1048`, `src/solver.jl:406-516`).

The lean path of the JAX package: `make_init_fused` (init, the cycle-0 EOS
and the CFL seed, returning only the five carried fields), the lean time
loop (`core/step.py`, per-sweep, pair or multicycle route as the JAX
package routes), the conservation check over the carry,
and `make_rehydrate` when the caller asks for the full State.
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
from ..ops.reductions import dt_cfl_min, conservation_vars, conservation_scalar
from .state import State, FusedCarry
from .step import make_time_loop_lean


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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _initial_state(params):
    """init_test + the cycle-0 EOS (`src/solver.jl:291-295`)."""
    cfg = params.config
    st = init_state(cfg, params.device)
    if cfg.maxcycle > 0:
        p, c, g = update_eos(cfg, st.rho, st.u, st.v, st.E)
        st = st._replace(p=p, c=c, g=g)
    return st


def make_init_fused(params):
    """() -> (FusedCarry, CFL seed): the initial state, its cycle-0 EOS and
    the seed of the carried CFL minimum (`core/solver.py:149`). x, y, c, g
    are dropped once the seed is formed."""
    cfg = params.config
    T = np.dtype(cfg.dtype).type

    def init():
        st = _initial_state(params)
        if cfg.cst_dt:
            seed = torch.tensor(float(np.finfo(cfg.dtype).max),
                                dtype=st.rho.dtype, device=st.rho.device)
        else:
            seed = dt_cfl_min(cfg, st.u, st.v, st.c)
        return FusedCarry(st.rho, st.u, st.v, st.E, st.p), seed

    return init


def make_rehydrate(params):
    """(FusedCarry) -> State: re-runs the deterministic init + cycle-0 EOS
    for the fields the loop never touches (x/y, ustar/pstar = 0, c/g of
    the initial fields), as `core/solver.py:213` does."""
    def rehydrate(fs):
        st = _initial_state(params)
        return st._replace(rho=fs.rho, u=fs.u, v=fs.v, E=fs.E, p=fs.p)

    return rehydrate


def make_conservation_lean(params):
    """(FusedCarry) -> (mass, energy) as host floats (`core/solver.py:247`):
    rho and E are all it reads; f32 sums are compensated pairs combined in
    f64 on the host."""
    cfg = params.config

    def call(fs):
        m, e = conservation_vars(cfg, fs.rho, fs.E)
        return conservation_scalar(cfg, m), conservation_scalar(cfg, e)

    return call


def _isapprox0(x, atol, rtol):
    """Julia `isapprox(x, 0; atol, rtol)` (src/solver.jl:481-482)."""
    return abs(x) <= max(atol, rtol * abs(x))


def armon(params: ArmonParameters, checkpoint=None,
          restore_from=None) -> SolverStats:
    """Main entry point (`src/solver.jl:406-516`), lean path."""
    if checkpoint is not None or restore_from is not None:
        solver_error("config", "checkpoint hooks and restore_from are not "
                               "available in armon_torch yet: they come with "
                               "ROADMAP queue A item 8 (other drivers + "
                               "restart)")
    cfg = params.config
    device = params.device
    if params.silent < 3:
        print(params.describe())

    timer = {} if params.measure_time else None
    t_start = time.perf_counter()
    fs, local0 = make_init_fused(params)()
    _sync(device)
    if timer is not None:
        timer["init"] = time.perf_counter() - t_start

    if params.check_result:
        m, e = make_conservation_lean(params)(fs)
        params.initial_mass, params.initial_energy = m, e

    T = np.dtype(cfg.dtype).type
    solve_start = time.perf_counter()
    res = make_time_loop_lean(cfg)(fs, T(0.0), 0, T(0.0), local0)
    solve_time = time.perf_counter() - solve_start
    if timer is not None:
        timer["solver_cycle"] = solve_time
    params._final_local_min = res.lm
    fs = res.carry
    if not res.ok:
        solver_error("time", f"Invalid time step at cycle {res.cycles}")

    state = make_rehydrate(params)(fs) if params.return_data else None

    # Final conservation check (src/solver.jl:467-490)
    if params.check_result and params.test.is_conservative and res.cycles > 0:
        m, e = make_conservation_lean(params)(fs)
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
