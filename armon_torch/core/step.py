"""The per-sweep lean time loop (`armon_tpu/core/step.py:158,308,353,412`).

One cycle is K3 `cfl_finish` (fold the last cycle's CFL partials, one dt
step) and then one sweep kernel per (axis, factor) of the splitting
schedule; the cycle's last sweep writes the stale p and the CFL partials
for the next cycle. The loop carries only rho/u/v/E/p, plus a second
rho/u/v/E set that the out-of-place sweeps write into (ping-pong).

t, cycle, dt, the CFL minimum and ok never leave the device inside the
loop. The host reads the stop predicate once every `check_every` cycles
(`STOP_CHECK_EVERY` by default); cycles launched past the run's end pass
every field and scalar through unchanged (see `ops/sweep.py`), the same
guarantee the TPU's `_multicycle_kernel` gives (`sweep.py:1951,2004-2014`),
so the result does not depend on `check_every`.

Every grid runs the per-sweep kernels in this package: the whole-cycle and
multi-cycle kernels that `pair_threshold` and `temporal_blocking` route to
in the JAX package are not ported yet (ROADMAP queue B5/B6).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..utils.enums import Axis
from ..ops import sweep as K
from .splitting import split_schedules
from .state import FusedCarry

STOP_CHECK_EVERY = 8


class LoopResult(NamedTuple):
    carry: FusedCarry
    t: float
    cycles: int
    dt_last: float
    lm: float
    ok: bool
    host_reads: int


def run_schedule(cfg, cur, nxt, p, partials, scal, iscal, schedule):
    """The sweeps of one cycle (`run_schedule_fused`): each reads `cur` and
    writes `nxt`, then the two swap. Returns (cur, nxt, partials written
    by the last sweep)."""
    shape = cur[0].shape
    nb = 0
    for i, (axis, factor) in enumerate(schedule):
        last = i == len(schedule) - 1
        sweep = K.x_sweep if axis is Axis.X else K.y_sweep
        sweep(cfg, cur, nxt, p, partials, scal, iscal, factor, emit=last)
        cur, nxt = nxt, cur
        if last:
            nb = K.n_partials(axis, shape, cur[0].device)
    return cur, nxt, nb


def make_time_loop_lean(cfg):
    """The lean loop (`make_time_loop_lean`):
    (fs, t0, cycle0, dt0, local0, check_every) -> LoopResult."""
    T = np.dtype(cfg.dtype).type
    even, odd = split_schedules(cfg.splitting)

    def loop(fs, t0, cycle0, dt0, local0, check_every=STOP_CHECK_EVERY):
        device = fs.rho.device
        shape = fs.rho.shape
        cur = (fs.rho, fs.u, fs.v, fs.E)
        nxt = tuple(torch.empty_like(a) for a in cur)
        p = fs.p
        nb_max = max(K.n_partials(ax, shape, device) for ax in (Axis.X, Axis.Y))
        partials = torch.zeros((2, nb_max), dtype=fs.rho.dtype, device=device)
        scal, iscal = K.new_scalars(cfg.dtype, device, t=float(t0),
                                    cycle=int(cycle0), dt_prev=float(dt0),
                                    lm=float(local0))
        cycle = int(cycle0)
        nb = 0
        reads = 0
        running = T(t0) < T(cfg.maxtime) and cycle < cfg.maxcycle
        while running:
            for _ in range(check_every):
                K.cfl_finish(cfg, partials, nb, scal, iscal, fold=True, step=True)
                sched = even if cycle % 2 == 0 else odd
                cur, nxt, nb = run_schedule(cfg, cur, nxt, p, partials, scal,
                                            iscal, sched)
                cycle += 1
            running = bool(iscal[K.IS_NEXT].item())
            reads += 1
        # Fold the last cycle's partials: lm is the CFL minimum of the
        # final state, the carry a resumed run would start from.
        K.cfl_finish(cfg, partials, nb, scal, iscal, fold=True, step=False)
        s = scal.cpu().numpy()
        i = iscal.cpu().numpy()
        reads += 2
        return LoopResult(FusedCarry(*cur, p), float(s[K.SC_T]),
                          int(i[K.IS_CYCLE]), float(s[K.SC_DTPREV]),
                          float(s[K.SC_LM]), bool(i[K.IS_OK]), reads)

    return loop
