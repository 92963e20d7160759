"""The time loops: the lean loop over the hand-written kernels
(`armon_tpu/core/step.py:212,308,353,412`) and the op path's loop
(`make_time_loop`, at the end of this module).

The lean loop has three routes, chosen as the JAX package chooses them
(`ops/routing.py`):

- per-sweep: one cycle is one sweep kernel per (axis, factor) of the
  splitting schedule, K1 along X and K2 along Y;
- pair (``max(n_local) <= pair_threshold``): the same, but each adjacent
  X/Y pair of the schedule is one K4 `cycle` launch (`run_schedule_fused`'s
  pairing); a leftover sweep (Strang's trailing half) stays K1/K2;
- multicycle (`temporal_pairs` is not None): each K5 `multicycle` launch
  runs K cycles with the dt recurrence, the CFL fold and the stop
  predicate in-kernel; no K3.

The cycle's last launch writes the stale p and the CFL partials, and on
the per-sweep and pair routes runs K3's work in its tail (`ops/sweep.Finish`):
it folds the partials into lm when the cycle ran, and takes one step of
the dt recurrence for the next cycle. So a Sequential cycle is two
launches per-sweep and one on the pair route. The loop carries only
rho/u/v/E/p, plus a second rho/u/v/E set that the out-of-place kernels
write into (ping-pong).

The cross-sweep EOS fold (`ops/eos.folds`; the perfect gas in exact
arithmetic, `ops/sweep.fold_on`). Between two launches of one cycle the
rho buffer holds the earlier launch's unscaled new density X, which the
next launch rebuilds into rho = X * RN(1/d) (the value the earlier one
would have stored) and folds into its pressure, (X * K) * e; the mirror
fills, the slab packs and the exchanges over processes carry X as they
carry rho, and every cycle's last launch stores rho. Each launch's part
is its `ops/sweep.Fold`; K4 and K5 fold between their own sweeps. No X
crosses a cycle's end, so the carry between cycles is as before.

Sequencing. One K3 `cfl_finish` (step, no fold) starts the run: the
first cycle's run predicate and dt. Then cycle k's last launch folds
cycle k's partials (if iscal[run] says cycle k ran) and steps for cycle
k + 1: iscal[run] becomes cycle k + 1's predicate, and the host reads it
every `check_every` cycles. An earlier form ran K3 (fold the previous
cycle's partials, step) before each cycle, stopped on iscal[next], and
ended with a K3 that only folded. Both make the same updates to t, cycle,
dt, lm and ok in the same order: a step's inputs are the state its K3
would have read, one launch earlier, and iscal[run] after cycle k is the
iscal[next] that K3 of cycle k computed, since the state it tests does
not change between them; the old final fold is the last running cycle's
tail, and a cycle that does not run leaves every scalar as it was. The
one difference: iscal[run] ends at 0 (no cycle after the last one runs),
where it ended at 1 after a last cycle that ran. `LoopResult` does not
carry it.

On a mesh (`parallel/mesh.py`; `fused_sweep_step`, `fused_cycle_step`,
`armon_tpu/core/step.py:147-250`) the per-sweep and pair routes run over
every shard: before each launch along a sharded axis, every shard's ghost
slabs are refilled from its neighbours' current fields (`halo_slabs`), then
each shard's kernel runs with its own real extent, slab splice on the sides
that face a neighbour and mirror on global borders, uneven splits
included. One fold covers every shard's CFL partials: x -> dx/x is
monotone under IEEE rounding, so min(dx/max_s mx_s, dy/max_s my_s) is the
JAX package's per-shard dt followed by `pmin_dt`, bit for bit, and a NaN
in any shard fails the dt gate as `pmin_dt`'s NaN -> 0 does. On one card
the last shard's last launch carries the tail, and its fold covers every
shard's columns: the earlier shards' launches wrote theirs before it in
stream order. A mesh across cards copies the remote shards' partials to
the first shard's device after the cycle and then launches K3 (fold,
step): the one case that keeps a K3 per cycle, with a mesh over several
processes, where each process gathers every shard's partials in mesh
order (`dist.all_gather_rows`) and runs the same K3 on the same inputs,
so every process takes the same dt and the same stop decision at the
same host read, with no other collective. The loop scalars live on
the first shard's device; a shard on another device reads a copy made
after each K3. Ordering across devices: PyTorch's copy between two cards
waits for the work queued before it on both cards' current streams, and
the work queued after it waits for the copy, so a slab copy follows the
neighbour's previous sweep and precedes the sweep that reads it. On one
device, the launch order of its stream is the only ordering needed.

t, cycle, dt, the CFL minimum and ok never leave the device inside the
loop. The eager loop reads the stop predicate to the host once every
`check_every` cycles (`STOP_CHECK_EVERY` by default; on the multicycle
route once every max(1, check_every // K) launches, so at most once per
launch). Cycles launched past the run's end pass every field and scalar
through unchanged (see `ops/sweep.py`), the guarantee the TPU's
`_multicycle_kernel` gives (`sweep.py:1951,2004-2014`), so the result
does not depend on `check_every`. In exact mode the three routes give the
same bits.

Graphs. On the card the whole lean run is one CUDA graph (`_Windows.drive`,
`core/graphs.py`): a WHILE node whose body is one or two cycles' launches
(one or two K5 launches), the last of which sets the node's condition
from the predicate it writes, the counterpart of the JAX package's
`lax.while_loop`; the host reads once, at the run's end. With
`whole=False`, and over NCCL processes, a card each (`graphs.whole_reason`),
the loop runs the cycles between two host reads as one window
(`KernelCycles.window`, `MultiCycles.window`) replayed from a
captured graph. Over processes a window's cycles hold their exchanges,
the partials' gather and K3, and every process stops after the same
window: each process's K3 folds the same gathered partials from the
same scalars, so each computes the same t, dt and stop decision, and no
process can leave the loop a window before another, whose collectives
would then wait on it. The collectives take buffers made at the loop's
set-up (`KernelCycles.sends`, `slabs`, `gathers`), so nothing in a step
allocates. `run_schedule_fused` is what a graph records; the eager loop
runs it as it is.

Value semantics. A loop owns its buffers, as the JAX package's loop owns
its program's: both buffer sets of rho/u/v/E and p per shard, the CFL
partials, K3's ticket, the device scalars and, over processes, the
collectives' buffers, made once per loop body (`_Windows._own`). A call
copies the caller's carry into the first set and refills the scalars in
place (`_Windows.load`), never writes a tensor the caller passed, and
returns a copy of its carry that no later call writes (`copy_out`), so a
loop called twice on one carry gives the same bits twice, and its graphs
(which bake in the loop's own buffers) are replayed by its later calls.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..utils.enums import Axis
from ..utils.errors import solver_error
from ..ops import sweep as K
from ..ops import cycle as C
from ..ops.eos import fold_const, folds, update_eos, scalar_like
from ..ops.projection import projection_remap
from ..ops.reductions import dt_cfl_min, pmin_dt
from ..ops.riemann import numerical_fluxes
from ..ops.routing import route, temporal_pairs
from ..ops.update import cell_update
from ..parallel.dist import all_gather_into, backend, gather_shards
from ..parallel.mesh import Mesh
from ..parallel.halo import (halo_slabs, new_send_buffers, new_slab_buffers,
                             halo_exchange_state)
from .graphs import body_steps, eager_reason, loop_graphs, note_form
from .splitting import split_schedules
from .state import FusedCarry, State
from .timestep import next_time_step, dt_update

STOP_CHECK_EVERY = 8


class LoopResult(NamedTuple):
    carry: object                # FusedCarry or State, or a list (one per shard)
    t: float
    cycles: int
    dt_last: float
    lm: float
    ok: bool
    host_reads: int


def run_schedule_fused(cfg, mesh, cur, nxt, p, parts, scalars, schedule,
                       pair=False, slabs=None, finish=None, sends=None,
                       cond=None):
    """The launches of one cycle (`armon_tpu/core/step.py`
    `run_schedule_fused`) on every shard of `mesh` this process drives
    (`mesh.local`; per-shard lists are indexed by `Shard.slot`): each
    launch reads `cur[s]` and writes `nxt[s]`, then the two
    swap. With `pair`, an adjacent X/Y pair of sweeps is one K4 launch in
    the schedule's order. Before a launch along an axis in `slabs` (the
    sharded ones), the shards' slab buffers `slabs[axis]` are refilled from
    their neighbours' `cur` (over processes, the lines sent go through
    the stacks `sends[axis]`, `halo.new_send_buffers`, where given). The
    cycle's last launch, which writes nb CFL
    partials per shard, writes shard s's into `parts[nb][s]`; `scalars[s]`
    are the loop scalars on shard s's device. With `finish` (nb -> a
    `Finish` over every shard's nb columns), the last shard's last launch
    carries K3's tail, and with `cond` (`ops/sweep.Cond`, where the cycle
    ends a whole-run graph's body) the WHILE condition, set from the
    predicate that tail writes. Returns (cur, nxt, nb)."""
    slabs, sends = slabs or {}, sends or {}
    shape = cur[0][0].shape
    device = cur[0][0].device
    ops = next(iter(parts.values()))  # a launch that does not emit ignores them
    nb = 0
    groups = launch_groups(schedule, pair)
    folding = K.fold_on(cfg, device)
    prev = None  # the axis of the cycle's sweep before this launch
    for j, group in enumerate(groups):
        is_pair = len(group) == 2
        last = j + 1 == len(groups)
        axis = Axis.Y if is_pair else group[0][0]
        # The cross-sweep EOS fold: a launch after the cycle's first reads
        # the unscaled density the one before left in the rho buffer (and,
        # through them, the slabs and mirror fills), every launch but the
        # last leaves it so. A pair is a cycle's first launch (K4 folds
        # between its own sweeps) and takes only the last part.
        fold = K.Fold(prev, not last) if folding else None
        prev = group[-1][0]
        if last:
            nb = C.n_partials(shape, device, cfg.dtype) if is_pair \
                else K.n_partials(axis, shape, device)
            ops = parts[nb]
        ghosts = halo_slabs(cfg, mesh, cur, axis, slabs[axis],
                            sends.get(axis)) \
            if axis in slabs else [K.MIRRORED] * len(mesh.local)
        for s in mesh.local:
            k = s.slot
            tail = last and s is mesh.local[-1]
            fin = finish[nb] if tail and finish else None
            c = cond if tail else None
            if is_pair:
                (a0, f0), (_, f1) = group
                x_first = a0 is Axis.X
                C.cycle(cfg, x_first, f0 if x_first else f1,
                        f1 if x_first else f0, cur[k], nxt[k], p[k], ops[k],
                        *scalars[k], last, ghosts[k], s.n_real, fin, c,
                        folding and not last)
            else:
                sweep = K.x_sweep if axis is Axis.X else K.y_sweep
                sweep(cfg, cur[k], nxt[k], p[k], ops[k], *scalars[k],
                      group[0][1], last, ghosts[k], s.n_real, fin, c, fold)
        cur, nxt = nxt, cur
    return cur, nxt, nb


def launch_groups(schedule, pair=False):
    """The launches of one cycle's `schedule`, in order: each a tuple of
    one sweep, or, with `pair`, of an adjacent X/Y pair of sweeps that is
    one K4 launch."""
    groups, i = [], 0
    while i < len(schedule):
        step = 2 if (pair and i + 1 < len(schedule) and
                     {schedule[i][0], schedule[i + 1][0]} == {Axis.X, Axis.Y}) \
            else 1
        groups.append(tuple(schedule[i:i + step]))
        i += step
    return groups


def _shard_list(fs):
    """(the carry as a list of FusedCarry, whether it was one FusedCarry)."""
    single = isinstance(fs, FusedCarry)
    return ([fs] if single else list(fs)), single


def layout(fs):
    """What a loop's buffers are made for: each shard's device, shape and
    dtype, of a carry (a FusedCarry or a list of them)."""
    shards, _ = _shard_list(fs)
    return tuple((f.rho.device, tuple(f.rho.shape), f.rho.dtype)
                 for f in shards)


def _like(a):
    return torch.empty(a.shape, dtype=a.dtype, device=a.device)


def _result(cur, p, scal, iscal, reads, single):
    s = scal.cpu().numpy()
    i = iscal.cpu().numpy()
    carry = [FusedCarry(*c, pp) for c, pp in zip(cur, p)]
    return LoopResult(carry[0] if single else carry, float(s[K.SC_T]),
                      int(i[K.IS_CYCLE]), float(s[K.SC_DTPREV]),
                      float(s[K.SC_LM]), bool(i[K.IS_OK]), reads + 2)


class _Windows:
    """What the loop bodies below share: their buffers, two sets of
    rho/u/v/E and p per shard, made once (`_own`) and kept across calls;
    `load`, a call's start; `drive`, the loop; `window`, steps start ..
    start + n - 1 (`cycle(i)` each), one replay of a CUDA graph where
    `graphs` holds a `CycleGraphs`; the buffer roles its keys hold; the
    result."""

    def _own(self, shards):
        """The buffer sets, shaped as the carry `shards`: never the
        caller's tensors, so that a graph bakes in the loop's own."""
        self.layout = layout(shards)
        self.sets = tuple([tuple(_like(a) for a in f[:4]) for f in shards]
                          for _ in range(2))
        self.cur, self.nxt = self.sets
        self.p = [_like(f.p) for f in shards]
        self.home = self.cur[0][0]

    def load(self, fs, t0, cycle0, dt0, local0):
        """A call's start: the caller's carry `fs` (laid out as the loop's,
        `layout`) copied into the first buffer set, the device scalars
        refilled in place, and what a run leaves behind (the CFL
        partials, K3's ticket) cleared, so that a call computes what a new
        loop would from the same carry."""
        shards, self.single = _shard_list(fs)
        if layout(shards) != self.layout:
            solver_error("config", f"a carry laid out as {layout(shards)} "
                                   f"given to a loop made for {self.layout}")
        self.cur, self.nxt = self.sets
        for dst, p, f in zip(self.cur, self.p, shards):
            for d, a in zip(dst, f[:4]):
                d.copy_(a)
            p.copy_(f.p)
        K.fill_scalars(self.scal, self.iscal, t=float(t0), cycle=int(cycle0),
                       dt_prev=float(dt0), lm=float(local0))
        self._clear()
        note_form(self.graphs)
        return self

    def drive(self, start, every, pred, whole=True):
        """Steps from `start` while the predicate `iscal[pred]` holds after
        them (the caller has checked the first step runs); returns the
        host reads. Where graphs run and `whole` holds, one launch of the
        whole-run graph (`core/graphs.py`; its body's last launch tests
        the same predicate: iscal[run] in K1, K2 or K4's tail, iscal[next]
        in K5) and one read at its end, unless the run is over processes
        (`CycleGraphs.takes_whole`); otherwise windows of `every` steps,
        one read each."""
        if whole and self.graphs is not None and self.graphs.takes_whole():
            self.graphs.run(self, start, body_steps(self, start))
            return 1
        reads = 0
        running = True
        while running:
            self.window(start, every)
            start += every
            running = bool(self.iscal[pred].item())
            reads += 1
        return reads

    def window(self, start, n):
        if self.graphs is not None:
            self.graphs.window(self, start, n)
            return
        for i in range(start, start + n):
            self.cycle(i)

    def roles(self):
        """0 while the fields are in their first buffer set (`home` is
        its first tensor), 1 in the second."""
        return 0 if self.cur[0][0] is self.home else 1

    def result(self, reads, copy_out=True):
        """The run's LoopResult. With `copy_out` its carry is a copy, which
        no later call writes; without, the loop's own buffers, for a
        caller that is done with them before the loop's next call."""
        cur, p = self.cur, self.p
        if copy_out:
            cur = [tuple(a.clone() for a in c) for c in cur]
            p = [a.clone() for a in p]
        return _result(cur, p, self.scal, self.iscal, reads, self.single)


class KernelCycles(_Windows):
    """The lean loop's buffers and device scalars over the kernels, run one
    cycle at a time: the body that the lean loop and the per-cycle driver
    (`core/solver.py`) share, so that the two cannot drift apart; the
    counterpart of `solver_cycle_fused` (`armon_tpu/core/step.py:353`).

    `fs` is a list of FusedCarry, one per shard of `mesh` in its order (or
    one FusedCarry): the loop's buffers are made in its layout, and it is
    loaded as a call's start (`load`, which later calls repeat). Without a
    `mesh`, one shard holds the whole grid on
    the carry's device. With `pair`, adjacent X/Y sweeps are one K4
    launch. A shard on another device than the first shard's is remote:
    its CFL partials go to a buffer of its own, copied in after each
    cycle for K3 to fold. `remote` names shards (by `Shard.index`) to
    treat so on the first shard's device too, which runs a mesh across
    cards' sequencing on one device. Over several processes, `fs` holds
    this process's shards (`mesh.local`); after each cycle every process
    gathers every shard's partials and runs the same K3 on the same
    inputs, so each holds the same t, dt, lm and ok and stops at the same
    host read. The exchanges and the gather run on buffers made here, once (`sends`,
    `slabs`, `gathers`); where graphs run, one exchange a sharded axis and
    one gather run here too, so that NCCL makes its communicators before
    any capture.

    `first_step` runs K3 once (no fold, one step): the first cycle's run
    predicate and dt. Then each `cycle` launches one cycle; its last
    launch folds the cycle's partials into lm and steps for the next
    cycle (see the module doc), so after it `scal` and `iscal` already
    describe the next cycle, and iscal[run] says whether it runs.
    `window` runs several cycles: one replay of a captured CUDA graph of
    their launches where graphs run (`core/graphs.py`; `graphs` as there),
    their `cycle` calls otherwise; `drive` runs the loop."""

    def __init__(self, cfg, mesh, fs, t0, cycle0, dt0, local0, pair,
                 remote=(), graphs=None):
        self.cfg = cfg
        self.pair = pair
        self.even, self.odd = split_schedules(cfg.splitting)
        shards, self.single = _shard_list(fs)
        m = self.mesh = mesh or Mesh(cfg, [shards[0].rho.device])
        # Where each shard's tensors are ("cuda" places them on cuda:0).
        devs = [f.rho.device for f in shards]
        dev0 = devs[0]
        shape = shards[0].rho.shape
        dtype = shards[0].rho.dtype
        self._own(shards)
        nbs = {K.n_partials(Axis.X, shape, dev0),
               K.n_partials(Axis.Y, shape, dev0)}
        if pair:
            nbs.add(C.n_partials(shape, dev0, cfg.dtype))
        # One fold covers every shard's partials: for a last launch writing
        # nb per shard, shard s writes columns [s*nb, (s+1)*nb) of
        # `partials`, or, if far, a buffer of its own copied in after the
        # cycle. Each shard's operand is made once per nb. Over several
        # processes every process gathers every shard's columns after the
        # cycle (`_gather_partials`).
        self.far = [s for s, d in zip(m.local, devs)
                    if d != dev0 or s.index in remote]
        self.partials = torch.zeros((2, len(m) * max(nbs)), dtype=dtype,
                                    device=dev0)
        self.parts = {nb: [torch.zeros((2, nb), dtype=dtype, device=d)
                           if s in self.far
                           else self.partials[:, s.index * nb:(s.index + 1) * nb]
                           for s, d in zip(m.local, devs)]
                      for nb in nbs}
        # On one card the cycle's last launch folds and steps in its tail;
        # across cards or processes K3 does, after the other shards'
        # partials are copied in.
        self.finish = None
        self.ticket = None
        if not self.far and m.nprocs == 1:
            self.ticket = K.new_ticket(dev0)
            self.finish = {nb: K.Finish(self.partials, len(m) * nb,
                                        self.ticket)
                           for nb in nbs}
        self.scal, self.iscal = K.new_scalars(cfg.dtype, dev0)
        self.copies = {d: (self.scal.to(d), self.iscal.to(d))
                       for d in dict.fromkeys(devs) if d != dev0}
        self.scalars = [self.copies.get(d, (self.scal, self.iscal))
                        for d in devs]
        self.slabs = {axis: new_slab_buffers(cfg, m, self.cur, axis)
                      for axis in (Axis.X, Axis.Y) if m.proc_dims[axis] > 1}
        # Over processes, the buffers of the collectives a cycle makes, made
        # once: the stacks of the lines sent to other processes, and per nb
        # the gather's input (this process's columns of `partials`) and
        # its rows, one a process.
        self.sends = {axis: new_send_buffers(cfg, m, self.cur, axis)
                      for axis in self.slabs}
        k = len(m.local)
        self.gathers = {nb: (torch.empty((2, k * nb), dtype=dtype, device=dev0),
                             torch.empty((m.nprocs, 2, k * nb), dtype=dtype,
                                         device=dev0))
                        for nb in nbs} if m.nprocs > 1 else {}
        self.graphs = loop_graphs(
            graphs, eager_reason(dev0, self.far, m.nprocs,
                                 backend() if m.nprocs > 1 else None),
            dev0, m.nprocs)
        self.load(fs, t0, cycle0, dt0, local0)
        if self.graphs is not None and self.gathers:
            # NCCL makes its communicators, and connects two processes, at
            # their first collective; no capture may do that, so one
            # exchange a sharded axis and one gather run here, on the
            # loop's buffers. Nothing reads what they leave: the cycles
            # refill the slabs before each launch, and the gather's rows
            # before each fold.
            for axis in self.slabs:
                halo_slabs(cfg, m, self.cur, axis, self.slabs[axis],
                           self.sends[axis])
            inp, rows = self.gathers[max(nbs)]
            all_gather_into(rows, inp)

    def _clear(self):
        """What a run leaves behind, cleared for the next (`load`): the CFL
        partials, K3's ticket (its tail resets it after every launch, a
        run stopped on its dt gate included; cleared all the same), and
        the scalars' copies on other devices."""
        self.partials.zero_()
        for s in self.far:
            for ops in self.parts.values():
                ops[s.slot].zero_()
        if self.ticket is not None:
            self.ticket.zero_()
        self._share_scalars()

    def _share_scalars(self):
        for sc, isc in self.copies.values():
            sc.copy_(self.scal)
            isc.copy_(self.iscal)

    def _gather_partials(self, nb):
        """Every process's local columns of `partials`, gathered into
        every process's copy in mesh order: the shards of a process are
        contiguous in mesh order, and rank order is mesh order. The
        columns go through the gather's buffers (`gathers[nb]`), so
        nothing is allocated."""
        inp, rows = self.gathers[nb]
        lo = self.mesh.local[0].index * nb
        inp.copy_(self.partials[:, lo:lo + inp.shape[1]])
        all_gather_into(rows, inp)
        self.partials[:, :len(self.mesh) * nb].unflatten(
            1, (self.mesh.nprocs, -1)).copy_(rows.transpose(0, 1))

    def first_step(self):
        """The run's one K3: the first cycle's run predicate and dt."""
        K.cfl_finish(self.cfg, self.partials, 0, self.scal, self.iscal,
                     fold=False, step=True)
        self._share_scalars()

    def cycle(self, cycle, cond=None):
        """One cycle's launches; `cycle` (the host's count) picks the
        schedule's parity. With `cond` (`ops/sweep.Cond`) the cycle ends a
        whole-run graph's body: its last launch sets that WHILE
        condition."""
        sched = self.even if cycle % 2 == 0 else self.odd
        self.cur, self.nxt, nb = run_schedule_fused(
            self.cfg, self.mesh, self.cur, self.nxt, self.p, self.parts,
            self.scalars, sched, self.pair, self.slabs, self.finish,
            self.sends, cond)
        if self.finish is None:
            for s in self.far:
                self.partials[:, s.index * nb:(s.index + 1) * nb].copy_(
                    self.parts[nb][s.slot])
            if self.mesh.nprocs > 1:
                self._gather_partials(nb)
            K.cfl_finish(self.cfg, self.partials, len(self.mesh) * nb,
                         self.scal, self.iscal, fold=True, step=True)
            self._share_scalars()

    def parity(self, cycle):
        """The schedule's parity: 0 where even and odd cycles share one."""
        return cycle % 2 if self.even != self.odd else 0

    def swaps(self, cycle):
        """The buffer swaps of a cycle: one a launch."""
        return len(launch_groups(self.even if cycle % 2 == 0 else self.odd,
                                 self.pair))

    def carry(self):
        """The current fields, a FusedCarry per shard."""
        return [FusedCarry(*c, pp) for c, pp in zip(self.cur, self.p)]



def make_time_loop_lean(cfg, mesh=None, remote=(), kind=None, graphs=None,
                        whole=True):
    """The lean loop (`make_time_loop_lean`), a `LeanLoop`:
    (fs, t0, cycle0, dt0, local0, check_every) -> LoopResult. `fs` is a
    list of FusedCarry, one per shard of `mesh` in its order, and so is the
    result's carry; a caller that passes one FusedCarry gets one back.
    `kind` is the route, `routing.route(cfg)` by default; the full-state
    restore loop passes `routing.cycle_route(cfg)`, which never runs K5.
    See `KernelCycles` for `mesh` and `remote`. Where graphs run
    (`core/graphs.py`: `graphs` None runs them wherever they can, False
    never, True raises where they cannot) the run is one launch of the
    whole-run graph, or with `whole=False` one window graph replay per
    `check_every` cycles.

    The loop keeps the JAX package's value semantics: a call copies `fs`
    in and leaves it as it was, and its result's carry is a copy that no
    later call writes (`copy_out=False` hands out the loop's own
    buffers instead). Its buffers, device scalars and graphs are made at
    its first call, in that carry's layout (`layout`; a later carry laid
    out otherwise is refused), and live as long as the loop: a later
    call copies in, refills the scalars and replays the graphs the first
    call captured, capturing only a window or a body of another key."""
    return LeanLoop(cfg, mesh, remote, kind or route(cfg), graphs, whole)


class LeanLoop:
    """The lean loop of `make_time_loop_lean`, holding its loop body
    (`KernelCycles`, or `MultiCycles` on the multicycle route) from its
    first call on."""

    def __init__(self, cfg, mesh, remote, kind, graphs, whole):
        self.cfg, self.mesh, self.remote = cfg, mesh, remote
        self.kind, self.graphs, self.whole = kind, graphs, whole
        self.pairs = temporal_pairs(cfg) if kind == "multicycle" else None
        self.run = None

    def load(self, fs, t0, cycle0, dt0, local0):
        """The loop body, loaded with a call's start (`_Windows.load`),
        made at the first call in the carry's layout."""
        if self.run is not None:
            return self.run.load(fs, t0, cycle0, dt0, local0)
        if self.pairs is not None:
            self.run = MultiCycles(self.cfg, self.pairs, fs, t0, cycle0, dt0,
                                   local0, self.graphs)
        else:
            self.run = KernelCycles(self.cfg, self.mesh, fs, t0, cycle0, dt0,
                                    local0, self.kind == "pair", self.remote,
                                    self.graphs)
        return self.run

    def __call__(self, fs, t0, cycle0, dt0, local0,
                 check_every=STOP_CHECK_EVERY, copy_out=True):
        T = np.dtype(self.cfg.dtype).type
        run = self.load(fs, t0, cycle0, dt0, local0)
        reads = 0
        if T(t0) < T(self.cfg.maxtime) and int(cycle0) < self.cfg.maxcycle:
            if self.pairs is not None:
                # The temporal-blocking branch (`fused_multicycle`), stopped
                # on iscal[next]: windows of max(1, check_every // K)
                # launches, one host read each, or the whole-run graph.
                reads = run.drive(0, max(1, check_every // len(self.pairs)),
                                  K.IS_NEXT, self.whole)
            else:
                run.first_step()
                # After the last cycle that ran, iscal[run] is 0 and lm the
                # CFL minimum of the final state, the carry a resumed run
                # would start from.
                reads = run.drive(int(cycle0), check_every, K.IS_RUN,
                                  self.whole)
        return run.result(reads, copy_out)


class MultiCycles(_Windows):
    """The multicycle route's buffers and device scalars (one shard: the
    route never runs on a mesh), run one K5 launch of len(pairs) cycles at
    a time (`cycle`), lm kept folded in-kernel. `window` runs several
    launches, as `KernelCycles.window` runs cycles: one graph replay where
    graphs run. `fs` is the carry the buffers are made for and loaded
    with, as in `KernelCycles`."""

    def __init__(self, cfg, pairs, fs, t0, cycle0, dt0, local0, graphs=None):
        (f,), _ = _shard_list(fs)
        self.cfg, self.pairs = cfg, pairs
        device = f.rho.device
        self._own([f])
        self.partials = C.new_multicycle_partials(f.rho.shape, cfg.dtype,
                                                  device)
        self.scal, self.iscal = K.new_scalars(cfg.dtype, device)
        self.graphs = loop_graphs(graphs, eager_reason(device), device)
        self.load(fs, t0, cycle0, dt0, local0)

    def _clear(self):
        self.partials.zero_()

    def cycle(self, launch, cond=None):
        """One K5 launch, whatever its index `launch`: each of its cycles
        takes its schedule from the device's cycle count. With `cond`
        (`ops/sweep.Cond`) the launch ends a whole-run graph's body and
        sets that WHILE condition."""
        C.multicycle(self.cfg, self.pairs, self.cur[0], self.nxt[0],
                     self.p[0], self.partials, self.scal, self.iscal, cond)
        if self.swaps(launch):
            self.cur, self.nxt = self.nxt, self.cur

    def parity(self, launch):
        return 0

    def swaps(self, launch):
        """The fields ping-pong in-kernel: a launch of an odd number of
        cycles leaves them in the other buffer set."""
        return len(self.pairs) % 2


# ------------------------------------------------------------- the op path
#
# The JAX package's jnp tier (`armon_tpu/core/step.py:43-104,483-598`) in
# plain tensor ops: no hand-written kernel, IEEE arithmetic on every
# device, with a fused multiply-add where XLA contracts one (`ops/fma.py`). Each function takes the States of every shard of `mesh` this
# process drives, in its order (one State off a mesh); only the ghost
# exchange and the CFL minimum look across shards (and processes), and a
# process's shards run one after another.

def sweep(cfg, mesh, states, axis: Axis, dt, fold=None):
    """One dimensional sweep (`:52`): EOS, ghost exchange (`ghost_exchange`,
    `:43`, is `halo_exchange_state`: the mirror at the global borders, the
    neighbours' lines between shards), Riemann fluxes, cell update, remap.
    `dt` is the schedule-scaled step, a 0-dim tensor of dtype T. `fold`
    is the cross-sweep EOS fold (`ops/eos.folds`, `eos_fold`): for a later
    sweep of a cycle the previous sweep's (X, K) a shard, None for the
    first. The EOS runs on ghost cells too, before the exchange, so a
    ghost takes the folded p of the cell it mirrors. Returns (States, the
    fold this sweep hands to the next sweep of its cycle, or None).

    Compare mode runs these sub-steps, and `solver_cycle`'s dt choice, a
    second time in `core/solver._checkpointed_cycle` (over
    `make_step_fns`), with a hook after each: a change to the order here
    is made there too."""
    states = halo_exchange_state(cfg, mesh, eos_fold(cfg, states, fold), axis)
    out = []
    for s, st in zip(mesh.local, states):
        d = dt.to(s.device)
        out.append(cell_update(cfg, numerical_fluxes(cfg, st, axis, d), axis, d))
    return remap_fold(cfg, mesh, out, axis, dt)


def eos_fold(cfg, states, fold=None):
    """`update_eos` of every shard, with its part of `fold` (`sweep`)."""
    if fold is None:
        return [update_eos(cfg, st) for st in states]
    return [update_eos(cfg, st, f) for st, f in zip(states, fold)]


def remap_fold(cfg, mesh, states, axis: Axis, dt):
    """The remap of every shard (`projection_remap`): (States, the fold
    the next sweep of the cycle takes, as `sweep` returns it)."""
    out = [projection_remap(cfg, st, axis, dt.to(s.device))
           for s, st in zip(mesh.local, states)]
    K = fold_const(cfg, axis)[1]
    return [st for st, _ in out], \
        ([(x, K) for _, x in out] if folds(cfg) else None)


def run_schedule(cfg, mesh, states, schedule, dt):
    """The sweeps of one cycle (`:62`), each with dt times its factor. Each
    sweep after the first takes the fold of the one before (`sweep`);
    none crosses into the next cycle."""
    T = np.dtype(cfg.dtype).type
    fold = None
    for axis, factor in schedule:
        # state.dt = current_dt * dt_factor (src/solver_state.jl:342)
        states, fold = sweep(cfg, mesh, states, axis, dt * float(T(factor)),
                             fold)
    return states


def solver_cycle(cfg, mesh, states, dt_prev, cycle, seeded=False,
                 lm_override=None):
    """One full cycle (`:70`): the time step from the cycle-start states,
    then the splitting schedule of the cycle's parity. `cycle` is the
    host's count (see `next_time_step` for `seeded`). Returns (states,
    dt_use, dt_next, ok), the scalars 0-dim tensors on the loop's device.

    `lm_override` (a 0-dim tensor of dtype T, or None): a CFL minimum,
    already reduced over the mesh, to use in place of the states'. It is
    for the first cycle resumed from a snapshot of a kernel run, whose
    `c` is stale (the kernels never write c back; the snapshot's carry
    holds the right minimum); from the second cycle on, the sweeps' EOS
    has refreshed c (`armon_tpu/core/step.py:70-98`)."""
    if lm_override is not None:
        dt_use, dt_next, ok = dt_update(cfg, lm_override, dt_prev, cycle)
    else:
        dt_use, dt_next, ok = next_time_step(cfg, mesh, states, dt_prev,
                                             cycle, seeded)
    even, odd = split_schedules(cfg.splitting)
    states = run_schedule(cfg, mesh, states, even if cycle % 2 == 0 else odd,
                          dt_use)
    return states, dt_use, dt_next, ok


def _keep_if(run, new, old):
    """`new` where the 0-dim bool `run` holds, else `old`, field by field,
    written over `new`'s own fields; a field `new` shares with `old` (x
    and y) stays as it is."""
    run = run.to(old.rho.device)
    return type(new)(*(n if n is o else torch.where(run, n, o, out=n)
                       for n, o in zip(new, old)))


def make_time_loop(cfg, mesh=None, restore=False):
    """The op path's loop, the non-fused branches of `make_time_loop`
    (`:483-598`): (states, t0, cycle0, dt0, lm0, check_every) ->
    LoopResult. `states` is a list of States, one per shard of `mesh` in
    its order, and so is the result's carry; a caller that passes one
    State gets one back. Without a `mesh`, one shard holds the whole grid.

    The cycle-0 EOS runs once, before the loop (`:543-545`), unless
    `restore`: a restored run's States come from a snapshot, and `lm0`
    (a float, or None when the snapshot has no carry) overrides the CFL
    minimum of its first cycle (`solver_cycle`). t, the cycle
    count, dt and ok stay 0-dim tensors on the first shard's device
    (`:535-541`); the host reads the stop predicate once every
    `check_every` cycles, and a cycle launched past the run's end keeps
    every field and scalar as it was (each is selected by the cycle's run
    predicate), so the result does not depend on `check_every`. At the
    end, the carried CFL minimum is recomputed from the final states
    (`:584-597`)."""
    T = np.dtype(cfg.dtype).type

    def loop(states, t0=0.0, cycle0=0, dt0=0.0, lm0=None,
             check_every=STOP_CHECK_EVERY):
        single = isinstance(states, State)
        states = [states] if single else list(states)
        m = mesh or Mesh(cfg, [states[0].rho.device])
        like = states[0].rho
        t = scalar_like(like, T(t0))
        dt_prev = scalar_like(like, T(dt0))
        cyc = torch.full((), int(cycle0), dtype=torch.int32, device=like.device)
        ok = torch.ones((), dtype=torch.bool, device=like.device)
        maxtime = float(T(cfg.maxtime))

        def running():
            return (t < maxtime) & (cyc < cfg.maxcycle) & ok

        if cfg.maxcycle > 0 and not restore:
            # Cycle-0 "EOS_init" (src/solver.jl:291-295)
            states = [update_eos(cfg, st) for st in states]
        lmo = scalar_like(like, T(lm0)) if restore and lm0 is not None \
            else None
        cycle = int(cycle0)
        reads = 0
        go = T(t0) < T(cfg.maxtime) and cycle < cfg.maxcycle
        while go:
            for _ in range(check_every):
                run = running()
                new, dt_use, dt_next, ok_next = solver_cycle(
                    cfg, m, states, dt_prev, cycle,
                    seeded=cycle > cycle0 or T(dt0) != 0,
                    lm_override=lmo if cycle == cycle0 else None)
                states = [_keep_if(run, n, o) for n, o in zip(new, states)]
                # next_cycle!: cycle += 1; time += current_dt
                # (src/solver_state.jl:145-147)
                t = torch.where(run, t + dt_use, t)
                cyc = torch.where(run, cyc + 1, cyc)
                dt_prev = torch.where(run, dt_next, dt_prev)
                ok = torch.where(run, ok_next, ok)
                cycle += 1
            go = bool(running().item())
            reads += 1
        if cfg.cst_dt:
            lm = scalar_like(like, np.finfo(cfg.dtype).max)
        else:
            dts = [dt_cfl_min(cfg, st, s.n_real)
                   for s, st in zip(m.local, states)]
            lm = pmin_dt(gather_shards(m, dts), like.device) if cfg.spmd \
                else dts[0]
        tv, dtv, lmv = torch.stack([t, dt_prev, lm]).cpu().tolist()
        cycles, okv = torch.stack([cyc, ok.to(torch.int32)]).cpu().tolist()
        return LoopResult(states[0] if single else states, tv, cycles, dtv,
                          lmv, bool(okv), reads + 2)

    return loop
