"""Global time-step recurrence (`armon_tpu/core/timestep.py`,
`src/solver_state.jl:26-166`).

- The dt used by cycle N comes from the state at the start of cycle N-1;
  cycles 0 and 1 both use ``cfl * local_min(initial state)``.
- Growth is capped at +5% per cycle: ``dt_next = min(cfl*local, 1.05*dt)``,
  with the cap arm in pure T like the JAX package (not Julia's f64
  promotion).
- ``cst_dt`` short-circuits everything; ``dt_on_even_cycles`` recomputes on
  even cycles only.

On the card this recurrence runs inside the `cfl_finish` kernel
(csrc/cfl.cu), so the loop never reads a scalar back; this is the host
form, on numpy scalars of dtype T (numpy rounds each operation to T as the
kernel does), used by its plain version.
"""

import numpy as np


def dt_update(cfg, local_min, dt_prev, cycle):
    """Apply the dt recurrence to a CFL minimum. Returns
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
