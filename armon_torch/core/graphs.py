"""The compile-once loop layer: windows of the time loop captured as CUDA
graphs and replayed (`armon_tpu/core/solver.py:79-94,193,326,344-392`).

The JAX package compiles its time loop once and dispatches it as one
program (`make_jit_loop_lean`, `make_jit_loop`: a `lax.while_loop` of
cycles; `_cached` keeps the programs), and its per-cycle driver calls one
compiled cycle a step (`make_cycle`). The port's counterpart is a CUDA
graph: the launches a window of the loop makes (every wrapper call of its
cycles, the mesh's slab packs included) are recorded once into a
`torch.cuda.CUDAGraph` and replayed with one host call a window. The lean
loop replays a window of `check_every` cycles between its host reads, the
full-state restore loop the same, the per-cycle driver a window of one
cycle, and the multicycle route a window of max(1, check_every // K) K5
launches (a cooperative launch, which CUDA captures: `chip_smoke.py` phase
0 checks it on the card).

What a capture bakes in. A launch's arguments are host values taken when
it is recorded: the buffers' pointers, the schedule's dt factors, the
ghost sources, the `Finish` of the cycle's last launch. What changes from
cycle to cycle (t, dt, the cycle count, the stop predicate) lives in the
device scalars, which every launch reads on the device. So a window's
launches depend on three host-side values, and the key of its graph holds
all three (`window_key`):
- the schedule's parity, `cycle % 2` (`split_schedules` gives even and
  odd cycles different schedules under the symmetric splittings; K5 picks
  each cycle's on the device, so its parity is 0);
- the buffer roles, whether the fields are in the first buffer set or
  in the second (`run_schedule_fused` swaps the pair after every launch,
  so a window of an odd number of launches ends with them swapped);
- the window's length.
No cycle reads to the host, and a cycle launched past the run's end
leaves every field and scalar as it was, so replaying whole windows gives
the eager loop's bits.

A graph holds the pointers of one run's buffers, so graphs live as long
as the run (`KernelCycles`, `MultiCycles`); a new run captures anew.
Nothing in a window allocates, syncs or reads to the host: capture raises
if anything does, and the error comes through.

Launch counts. A wrapper counts a launch where it is called, so a capture
would count launches that have not run, and a replay calls no wrapper.
Capture sets its counts aside and each replay adds them
(`CycleGraphs.replay`), so `ops/sweep.LAUNCHES` and `TAILS` count what
ran on the card, as in the eager loop.

Where graphs run: a run of one process whose shards all sit on one card
(one device, or a mesh placed on one card). A mesh across cards and a run
over several processes keep the eager loop: their cycle ends with K3
after host-driven copies or gathers of the CFL partials (ROADMAP lists
their graphs as later work). The CPU has no graphs; the plain versions
run eagerly there. The layout decides (`eager_reason`), never a caught
failure. The `graphs` argument of `armon()` and of the loops that take
it: None runs graphs wherever they can run, False the eager loop (the
yardstick), True raises where they cannot run.
"""

import gc
import time

import torch

from ..ops import sweep as K
from ..utils.errors import solver_error

# Graphs captured and replayed since the last `reset_stats`, and the host
# milliseconds the captures took (instantiation included).
STATS = {"graphs": 0, "replays": 0, "capture_ms": 0.0}


def reset_stats():
    STATS.update(graphs=0, replays=0, capture_ms=0.0)


def eager_reason(device, far=(), nprocs=1):
    """Why a loop whose scalars sit on `device` runs eagerly, or None where
    it can replay graphs. `far` are the shards whose CFL partials are
    copied in after each cycle (a mesh across cards); `nprocs` the
    processes of the run."""
    if torch.device(device).type != "cuda":
        return "the CPU has no CUDA graphs"
    if nprocs > 1:
        return "a run over several processes keeps the eager loop"
    if far:
        return "a mesh across cards keeps the eager loop"
    return None


def use_graphs(graphs, reason):
    """Whether a loop replays graphs: where it can when `graphs` is None;
    `graphs=True` where it cannot (`reason`) raises."""
    if graphs is None:
        return reason is None
    if graphs and reason is not None:
        solver_error("config", f"graphs=True cannot run here: {reason}")
    return bool(graphs)


def window_key(run, start, n):
    """The key of the window of `n` steps of `run` from step `start`: (the
    schedule's parity, the buffer roles, n)."""
    return run.parity(start), run.roles(), n


def end_roles(run, key, start):
    """The buffer roles after the window of `key` from step `start`: its
    swaps flip them."""
    _, roles, n = key
    return roles ^ (sum(run.swaps(i) for i in range(start, start + n)) & 1)


class CycleGraphs:
    """Captured windows of a loop body by key, in one memory pool on
    `device`. The body (`core/step.KernelCycles`, a cycle a step;
    `core/step.MultiCycles`, a K5 launch a step) holds its graphs, and
    they do not hold it: a reference cycle would leave their destruction
    to Python's cycle collector, which may run during another run's
    capture, where destroying a graph is not permitted and spoils that
    capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)  # capture needs its own
        self.windows = {}

    def window(self, run, start, n):
        """Steps start .. start + n - 1 of `run`, one replay. `run` keeps
        its fields' buffer sets in `cur` and `nxt` and tells its buffer
        roles (`roles()`), a step's schedule parity (`parity(i)`) and the
        buffer swaps a step makes (`swaps(i)`); `run.cycle(i)` makes step
        i's launches. `run.cur` and `run.nxt` follow the replay's swaps."""
        key = window_key(run, start, n)
        end = end_roles(run, key, start)
        bufs = run.cur, run.nxt

        def launches():
            for i in range(start, start + n):
                run.cycle(i)
            if run.roles() != end:
                solver_error("config", f"a window of {n} from step {start} "
                                       f"ended with the buffer roles "
                                       f"{run.roles()}, not {end}")
            run.cur, run.nxt = bufs  # nothing ran yet

        self.replay(key, launches)
        if end != key[1]:
            run.cur, run.nxt = run.nxt, run.cur

    def replay(self, key, launches):
        """Replay the graph of `key`; the first time, `launches()` (the
        window's wrapper calls) is captured into it. Each replay adds the
        launch counts the capture set aside."""
        w = self.windows.get(key)
        if w is None:
            w = self.windows[key] = self._capture(launches)
        graph, counts = w
        graph.replay()
        for total, add in zip((K.LAUNCHES, K.TAILS), counts):
            for name, n in add.items():
                total[name] += n
        STATS["replays"] += 1

    def _capture(self, launches):
        before = dict(K.LAUNCHES), dict(K.TAILS)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # `torch.cuda.graph` would also synchronize the card and empty the
        # allocator's cache before capturing: freeing the last run's cached
        # fields took up to 108 ms on an H100 at Sod 8192^2, over a third
        # of a 100-cycle solve. Nothing in a window allocates, so the
        # capture goes without. The cycle collector stays off during a
        # capture: a graph it destroyed there would spoil the capture (see
        # the class doc).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    launches()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        STATS["capture_ms"] += (time.perf_counter() - t0) * 1e3
        STATS["graphs"] += 1
        counts = []
        for total, was in zip((K.LAUNCHES, K.TAILS), before):
            counts.append({k: total[k] - was[k] for k in total
                           if total[k] != was[k]})
            total.update(was)
        return graph, counts
