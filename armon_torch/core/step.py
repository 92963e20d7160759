"""The lean time loop (`armon_tpu/core/step.py:212,308,353,412`).

Three routes, chosen as the JAX package chooses them (`ops/routing.py`):

- per-sweep: one cycle is K3 `cfl_finish` (fold the last cycle's CFL
  partials, one dt step) and then one sweep kernel per (axis, factor) of
  the splitting schedule;
- pair (``max(n_local) <= pair_threshold``): the same, but each adjacent
  X/Y pair of the schedule is one K4 `cycle` launch (`run_schedule_fused`'s
  pairing); a leftover sweep (Strang's trailing half) stays K1/K2;
- multicycle (`temporal_pairs` is not None): each K5 `multicycle` launch
  runs K cycles with the dt recurrence, the CFL fold and the stop
  predicate in-kernel; no K3.

The cycle's last launch writes the stale p and the CFL partials for the
next cycle. The loop carries only rho/u/v/E/p, plus a second rho/u/v/E set
that the out-of-place kernels write into (ping-pong).

t, cycle, dt, the CFL minimum and ok never leave the device inside the
loop. The host reads the stop predicate once every `check_every` cycles
(`STOP_CHECK_EVERY` by default; on the multicycle route once every
max(1, check_every // K) launches, so at most once per launch). Cycles
launched past the run's end pass every field and scalar through unchanged
(see `ops/sweep.py`), the guarantee the TPU's `_multicycle_kernel` gives
(`sweep.py:1951,2004-2014`), so the result does not depend on
`check_every`. In exact mode the three routes give the same bits.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..utils.enums import Axis
from ..ops import sweep as K
from ..ops import cycle as C
from ..ops.routing import route, temporal_pairs
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


def run_schedule(cfg, cur, nxt, p, partials, scal, iscal, schedule,
                 pair=False):
    """The launches of one cycle (`run_schedule_fused`): each reads `cur`
    and writes `nxt`, then the two swap. With `pair`, an adjacent X/Y pair
    of sweeps is one K4 launch in the schedule's order. Returns (cur, nxt,
    partials written by the last launch)."""
    shape = cur[0].shape
    device = cur[0].device
    nb = 0
    i = 0
    while i < len(schedule):
        if (pair and i + 1 < len(schedule)
                and {schedule[i][0], schedule[i + 1][0]} == {Axis.X, Axis.Y}):
            (a0, f0), (_, f1) = schedule[i], schedule[i + 1]
            x_first = a0 is Axis.X
            last = i + 2 == len(schedule)
            C.cycle(cfg, x_first, f0 if x_first else f1,
                    f1 if x_first else f0, cur, nxt, p, partials, scal, iscal,
                    emit=last)
            if last:
                nb = C.n_partials(shape, device)
            i += 2
        else:
            axis, factor = schedule[i]
            last = i + 1 == len(schedule)
            sweep = K.x_sweep if axis is Axis.X else K.y_sweep
            sweep(cfg, cur, nxt, p, partials, scal, iscal, factor, emit=last)
            if last:
                nb = K.n_partials(axis, shape, device)
            i += 1
        cur, nxt = nxt, cur
    return cur, nxt, nb


def _result(cur, p, scal, iscal, reads):
    s = scal.cpu().numpy()
    i = iscal.cpu().numpy()
    return LoopResult(FusedCarry(*cur, p), float(s[K.SC_T]),
                      int(i[K.IS_CYCLE]), float(s[K.SC_DTPREV]),
                      float(s[K.SC_LM]), bool(i[K.IS_OK]), reads + 2)


def make_time_loop_lean(cfg):
    """The lean loop (`make_time_loop_lean`):
    (fs, t0, cycle0, dt0, local0, check_every) -> LoopResult."""
    T = np.dtype(cfg.dtype).type
    kind = route(cfg)
    if kind == "multicycle":
        return _multicycle_loop(cfg, temporal_pairs(cfg))
    pair = kind == "pair"
    even, odd = split_schedules(cfg.splitting)

    def loop(fs, t0, cycle0, dt0, local0, check_every=STOP_CHECK_EVERY):
        device = fs.rho.device
        shape = fs.rho.shape
        cur = (fs.rho, fs.u, fs.v, fs.E)
        nxt = tuple(torch.empty_like(a) for a in cur)
        p = fs.p
        nb_max = max(K.n_partials(Axis.X, shape, device),
                     K.n_partials(Axis.Y, shape, device),
                     C.n_partials(shape, device) if pair else 0)
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
                                            iscal, sched, pair)
                cycle += 1
            running = bool(iscal[K.IS_NEXT].item())
            reads += 1
        # Fold the last cycle's partials: lm is the CFL minimum of the
        # final state, the carry a resumed run would start from.
        K.cfl_finish(cfg, partials, nb, scal, iscal, fold=True, step=False)
        return _result(cur, p, scal, iscal, reads)

    return loop


def _multicycle_loop(cfg, pairs):
    """The temporal-blocking branch of the lean loop (`make_time_loop_lean`'s
    `fused_multicycle` loop): K5 launches of len(pairs) cycles each, lm
    kept folded in-kernel."""
    T = np.dtype(cfg.dtype).type
    n = len(pairs)

    def loop(fs, t0, cycle0, dt0, local0, check_every=STOP_CHECK_EVERY):
        device = fs.rho.device
        cur = (fs.rho, fs.u, fs.v, fs.E)
        nxt = tuple(torch.empty_like(a) for a in cur)
        p = fs.p
        partials = C.new_multicycle_partials(fs.rho.shape, cfg.dtype, device)
        scal, iscal = K.new_scalars(cfg.dtype, device, t=float(t0),
                                    cycle=int(cycle0), dt_prev=float(dt0),
                                    lm=float(local0))
        reads = 0
        running = T(t0) < T(cfg.maxtime) and int(cycle0) < cfg.maxcycle
        while running:
            for _ in range(max(1, check_every // n)):
                C.multicycle(cfg, pairs, cur, nxt, p, partials, scal, iscal)
                if n % 2:
                    cur, nxt = nxt, cur
            running = bool(iscal[K.IS_NEXT].item())
            reads += 1
        return _result(cur, p, scal, iscal, reads)

    return loop
