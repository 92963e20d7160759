"""Global time-step recurrence (`armon_tpu/core/timestep.py`,
`src/solver_state.jl:26-166`).

- The dt used by cycle N comes from the state at the start of cycle N-1;
  cycles 0 and 1 both use ``cfl * local_min(initial state)``.
- Growth is capped at +5% per cycle: ``dt_next = min(cfl*local, 1.05*dt)``,
  with the cap arm in pure T like the JAX package (not Julia's f64
  promotion).
- ``cst_dt`` short-circuits everything; ``dt_on_even_cycles`` recomputes on
  even cycles only.

Two forms of the same recurrence:
- `dt_update` and `next_time_step`, the device form the op path runs
  (`core/step.py` `make_time_loop`): 0-dim tensors of dtype T, so the loop
  never reads a scalar back;
- `dt_update_host`, on numpy scalars of dtype T (numpy rounds each
  operation to T as the card does): the plain version of the kernels'
  `cfl_finish` (csrc/cfl.cu), which runs the recurrence on the card.
"""

import numpy as np
import torch

from ..ops.eos import scalar_like
from ..ops.reductions import dt_cfl_min, pmin_dt


def dt_update(cfg, local_min, dt_prev, cycle):
    """The recurrence on a CFL minimum (`armon_tpu/core/timestep.py:36`).
    `local_min` (None with `cst_dt`) and `dt_prev` are 0-dim tensors of
    dtype T, `cycle` an int or a 0-dim integer tensor. Returns (dt_use,
    dt_next, ok), ok a 0-dim bool tensor."""
    T = np.dtype(cfg.dtype).type
    if cfg.cst_dt:
        dt = scalar_like(dt_prev, T(cfg.Dt))
        return dt, dt, torch.ones((), dtype=torch.bool, device=dt.device)
    first = dt_prev == 0
    scaled = float(T(cfg.cfl)) * local_min
    candidate = torch.where(first, scaled,
                            torch.minimum(scaled, float(T(1.05)) * dt_prev))
    if cfg.dt_on_even_cycles:
        recompute = first | (cycle % 2 == 0)
        dt_next = torch.where(recompute, candidate, dt_prev)
    else:
        dt_next = candidate
    dt_use = torch.where(first, dt_next, dt_prev)
    ok = torch.isfinite(dt_next) & (dt_next > 0)
    return dt_use, dt_next, ok


def next_time_step(cfg, mesh, states, dt_prev, cycle, seeded=False):
    """The op path's step (`armon_tpu/core/timestep.py:77`): the CFL
    minimum of the cycle-start states (one per shard of `mesh`; on a mesh
    the minimum over the shards, `pmin_dt`), then `dt_update`.

    Under `dt_on_even_cycles` an odd cycle skips the reduction, as the
    JAX package's `lax.cond` does (`:81-97`), unless it may be the run's
    first (dt_prev == 0). `cycle` is the host's count and `seeded` says
    that dt_prev is known to be nonzero; without it an odd cycle reduces
    all the same. Both branches give the same values, so `seeded` only
    saves the reduction."""
    if cfg.cst_dt:
        return dt_update(cfg, None, dt_prev, cycle)
    if cfg.dt_on_even_cycles and cycle % 2 == 1 and seeded:
        ok = torch.isfinite(dt_prev) & (dt_prev > 0)
        return dt_prev, dt_prev, ok
    dts = [dt_cfl_min(cfg, st, s.n_real) for s, st in zip(mesh, states)]
    local_min = pmin_dt(dts, dt_prev.device) if cfg.spmd else dts[0]
    return dt_update(cfg, local_min, dt_prev, cycle)


def dt_update_host(cfg, local_min, dt_prev, cycle):
    """The recurrence on numpy scalars of dtype T. Returns
    (dt_use, dt_next, ok)."""
    T = np.dtype(cfg.dtype).type
    if cfg.cst_dt:
        return T(cfg.Dt), T(cfg.Dt), True
    local_min, dt_prev = T(local_min), T(dt_prev)
    first = dt_prev == T(0.0)
    candidate = T(cfg.cfl) * local_min
    if not first:
        candidate = np.minimum(candidate, T(1.05) * dt_prev)
    if cfg.dt_on_even_cycles and not (cycle % 2 == 0 or first):
        dt_next = dt_prev
    else:
        dt_next = candidate
    dt_use = dt_next if first else dt_prev
    ok = bool(np.isfinite(dt_next) and dt_next > T(0.0))
    return dt_use, dt_next, ok
