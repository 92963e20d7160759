"""The compile-once loop layer: the time loop as CUDA graphs
(`armon_tpu/core/solver.py:79-94,193,326,344-392`).

The JAX package compiles its time loop once and dispatches it as one
program (`make_jit_loop_lean`, `make_jit_loop`: a `lax.while_loop` of
cycles whose `cond` runs on the device; `_cached` keeps the programs),
and its per-cycle driver calls one compiled cycle a step (`make_cycle`).
The port has two counterparts, both CUDA graphs of the launches the loop
body makes (every wrapper call of its steps, the mesh's slab packs
included), recorded once:
- the whole-run graph (`CycleGraphs.run`), the counterpart of the
  `lax.while_loop`: one conditional WHILE node (`csrc/graph.cu`) whose
  body is a few steps' launches and then `while_cond`, which sets the
  condition from the predicate the host would have read. A lean run is
  one launch of it and one host read, at its end (`_Windows.drive` in
  `core/step.py`);
- a window graph (`CycleGraphs.window`): the launches of the steps
  between two host reads, replayed with one host call a window. The
  per-cycle driver replays a one-cycle window a cycle, and a lean loop
  runs windows where it is asked to (`whole=False`): `armon()` asks so
  for a traced run, whose trace on the card was seen to lose kernel
  records of a whole-run graph's first bodies (why is not known).
A step is a cycle (`core/step.KernelCycles`), or on the multicycle route
a K5 launch of K cycles (`MultiCycles`; K5's cooperative launch
captures: `chip_smoke.py` phase 0 checks it on the card).

What a capture bakes in. A launch's arguments are host values taken when
it is recorded: the buffers' pointers, the schedule's dt factors, the
ghost sources, the `Finish` of the cycle's last launch. What changes from
cycle to cycle (t, dt, the cycle count, the stop predicate) lives in the
device scalars, which every launch reads on the device. So a window's
launches depend on three host-side values, and the key of its graph holds
all three (`window_key`):
- the schedule's parity (`split_schedules` gives even and odd cycles
  different schedules under the symmetric splittings; where they are the
  same, and on K5, which picks each cycle's on the device, it is 0);
- the buffer roles, whether the fields are in the first buffer set or
  in the second (`run_schedule_fused` swaps the pair after every launch,
  so a window of an odd number of launches ends with them swapped);
- the window's length.
The whole-run graph's body is replayed from wherever the last one ended,
so it must end with the parity and the roles it starts with: the fewest
steps that do, 1 or 2 (`body_steps`), the JAX package's cond after each
cycle. A longer body would launch more cycles past the run's end, each as
dear as a cycle on a large grid. No cycle reads to the host, and a cycle
launched past the run's end leaves every field and scalar as it was, so
neither the windows' nor the body's length changes the bits.

A graph holds the pointers of its loop's buffers, so graphs live as long
as the loop body that holds them (`KernelCycles`, `MultiCycles`), across
its calls: a loop owns its buffers and device scalars, and a call copies
the caller's carry in and refills the scalars in place
(`core/step._Windows.load`), so a later call replays the windows and
the whole-run graph an earlier call captured (a whole-run graph is kept
by its body's key and predicate, `CycleGraphs.wholes`), and captures
only a key it has not met. The loop bodies that `core/solver.py`'s
program cache (`_cached`) keeps, one per configuration, layout and
form, hold theirs as long as the entry lives; only a configuration's
first call captures. `iters` is zeroed before each whole-run launch.
Nothing in a step allocates, syncs or reads to the host: capture raises
if anything does, and the error comes through, as a build or launch
error of the whole-run graph does (`ops/_build.while_build`).

Launch counts. A wrapper counts a launch where it is called, so a capture
would count launches that have not run, and a replay calls no wrapper.
Capture sets its counts aside; each window replay adds them, and the
whole-run graph adds them times the iterations its body ran, read from
the device with the run's one host read (`while_cond` counts them, in
`LAUNCHES`). So `ops/sweep.LAUNCHES` and `TAILS` count what ran on the
card: those of the eager loop with `check_every` the body's length.

Where graphs run: a run whose shards each sit on their process's one
card: one process (one device, or a mesh placed on one card), or
several processes over NCCL, a card a process. Over NCCL a cycle's
collectives are in its capture: each halo exchange (one
`batch_isend_irecv`) and the CFL partials' gather, then K3, on buffers
the loop made once (`KernelCycles`; NCCL's first calls, which make its
communicators, run at the loop's set-up). Every process folds the same
gathered partials with the same K3, so every process stops after the
same window: no process can leave the loop a window earlier than
another, whose collectives would then wait on it. Over NCCL processes a
lean run takes window graphs, one replay and one host read a
`check_every` window, and never the whole-run graph (`whole_reason`):
NCCL's capture holds event nodes, which a WHILE body refuses, and with
NCCL's graph mixing turned off CUDA still refused the WHILE build (an
H100, torch 2.11, NCCL 2.28.9). The transport decides, the same on every
process.
Gloo processes (every copy staged through host memory), a mesh across
cards in one process (its partials copied between cards after each
cycle) and the CPU keep the eager loop; the CPU runs the plain versions
eagerly there (`while_plain` is the whole-run graph's). The layout and
the transport decide (`eager_reason`, `whole_reason`), never a caught
failure. The `graphs` argument of `armon()` and of the loops that take
it: None runs graphs wherever they can run, False the eager loop (the
yardstick), True raises where they cannot; where graphs run, the lean
loops' `whole` (True by default) picks the whole-run graph, False window
graphs, and with `graphs=True` a whole run where `whole_reason` stands
raises.
"""

import gc
import time

import torch

from ..ops import _build
from ..ops import sweep as K
from ..utils.errors import solver_error

# Since the last `reset_stats`: graphs captured; graph launches (window
# replays and whole runs); whole-run launches, the iterations of their
# bodies and the last body's steps; the host milliseconds the captures
# took (instantiation included); the host milliseconds from each
# whole-run launch to the end of its read (the run on the card inside
# them); the last loop call's form ("eager", "windows" or "whole",
# `note_form` and `CycleGraphs.run`).
STATS = {"graphs": 0, "replays": 0, "runs": 0, "iterations": 0,
         "body_steps": 0, "capture_ms": 0.0, "launch_ms": 0.0, "form": None}

# Launches of `while_cond` (csrc/graph.cu), one an iteration of a
# whole-run graph's body, added when the run's count is read.
LAUNCHES = {"while_cond": 0}


def reset_stats():
    STATS.update(graphs=0, replays=0, runs=0, iterations=0, body_steps=0,
                 capture_ms=0.0, launch_ms=0.0, form=None)


def reset_launches():
    LAUNCHES["while_cond"] = 0


def eager_reason(device, far=(), nprocs=1, backend=None):
    """Why a loop whose scalars sit on `device` runs eagerly, or None where
    it can replay graphs. `far` are the shards whose CFL partials are
    copied in after each cycle (a mesh across cards); `nprocs` the
    processes of the run and `backend` their transport
    (`parallel/dist.backend`)."""
    if torch.device(device).type != "cuda":
        return "the CPU has no CUDA graphs"
    if nprocs > 1 and backend != "nccl":
        return ("a run over several processes keeps the eager loop unless "
                "they talk over NCCL: gloo stages every copy through host "
                "memory, which a CUDA graph cannot hold")
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


def whole_reason(nprocs):
    """Why a lean run whose graphs run takes window graphs where it asks
    for the whole-run graph, or None where it may launch it: over NCCL
    processes (the only processes whose loops run graphs) it may not."""
    if nprocs > 1:
        return ("a run over NCCL processes takes window graphs: NCCL's "
                "capture holds event nodes, which a WHILE body refuses, "
                "and without them CUDA refused the WHILE build")
    return None


def loop_graphs(graphs, reason, device, nprocs=1):
    """A loop's `CycleGraphs` on `device` where graphs run (`use_graphs`),
    else None; records the loop's form in `STATS`: "eager", or "windows"
    until a whole-run graph launches. `nprocs`: the run's processes."""
    if not use_graphs(graphs, reason):
        note_form(None)
        return None
    cg = CycleGraphs(device, strict=graphs is True, nprocs=nprocs)
    note_form(cg)
    return cg


def note_form(graphs):
    """Record in `STATS` the form of a loop call that starts: "eager"
    without graphs, else "windows" until a whole-run graph launches."""
    STATS["form"] = "eager" if graphs is None else "windows"


def body_steps(run, start):
    """The steps of the whole-run graph's body from step `start` of `run`:
    the fewest, 1 or 2, after which the schedule's parity and the buffer
    roles are those of step `start`, so that each replay of the body makes
    the launches its steps would make eagerly."""
    for n in (1, 2):
        if run.parity(start + n) == run.parity(start) and \
                sum(run.swaps(i) for i in range(start, start + n)) % 2 == 0:
            return n
    solver_error("config", f"no body of 1 or 2 steps from step {start} "
                           f"returns to its parity and buffer roles")


def while_plain(run, start, n, pred):
    """The whole-run graph's plain version (`CycleGraphs.run`): bodies of
    `n` steps of `run` from step `start`, launched eagerly, each followed
    by `while_cond`'s work: count the iteration, and go on while
    `run.iscal[pred]` holds (one host read a body). Returns the
    iterations."""
    iters = 0
    while True:
        for i in range(start, start + n):
            run.cycle(i)
        start += n
        iters += 1
        if not int(run.iscal[pred]):
            return iters


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
    """A loop body's graphs, in one memory pool on `device`: captured
    windows by key, and whole-run graphs by their body's key and
    predicate, kept across the body's calls (see the module doc). The body (`core/step.KernelCycles`, a cycle a step;
    `core/step.MultiCycles`, a K5 launch a step) holds its graphs, and
    they do not hold it: a reference cycle would leave their destruction
    to Python's cycle collector, which may run during another run's
    capture, where destroying a graph is not permitted and spoils that
    capture."""

    def __init__(self, device, strict=False, nprocs=1):
        self.device = torch.device(device)
        self.strict, self.nprocs = strict, nprocs
        self.why = whole_reason(nprocs)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)  # capture needs its own
        self.windows = {}
        # whole-run graphs: (window key, predicate) -> (torch graph,
        # _WhileGraph)
        self.wholes = {}
        self.iters = torch.zeros(1, dtype=torch.int32, device=self.device)

    def window(self, run, start, n):
        """Steps start .. start + n - 1 of `run`, one replay. `run` keeps
        its fields' buffer sets in `cur` and `nxt` and tells its buffer
        roles (`roles()`), a step's schedule parity (`parity(i)`) and the
        buffer swaps a step makes (`swaps(i)`); `run.cycle(i)` makes step
        i's launches. `run.cur` and `run.nxt` follow the replay's swaps."""
        key = window_key(run, start, n)
        end = end_roles(run, key, start)
        self.replay(key, _steps(run, start, n, end))
        if end != key[1]:
            run.cur, run.nxt = run.nxt, run.cur

    def takes_whole(self):
        """Whether a lean run that asks for the whole-run graph launches it
        (`whole_reason`); with `strict` (`graphs=True`) where it may not,
        this raises with the reason."""
        if self.why is not None and self.strict:
            solver_error("config", f"graphs=True cannot run the whole-run "
                                   f"graph here: {self.why}")
        return self.why is None

    def run(self, run, start, n, pred):
        """The steps of `run` from `start` until the predicate
        `run.iscal[pred]` falls: one launch of a whole-run graph whose
        WHILE body is the launches of `n` steps (`body_steps`) then
        `while_cond`, and one host read, of the body's iterations, which
        waits for the run's end. The bodies end with the roles they start
        with, so `run.cur` and `run.nxt` stay. The graph of a key met
        before is launched again. Returns the iterations."""
        key = window_key(run, start, n)
        if end_roles(run, key, start) != key[1]:
            solver_error("config", f"a body of {n} steps from step {start} "
                                   f"swaps the buffer roles")
        whole = self.wholes.get((key, pred))
        if whole is None:
            graph, counts = self._capture(_steps(run, start, n, key[1]),
                                          keep=True)
            t0 = time.perf_counter()
            loop = _WhileGraph(graph.raw_cuda_graph(),
                               run.iscal[pred:pred + 1], self.iters)
            STATS["capture_ms"] += (time.perf_counter() - t0) * 1e3
            whole = self.wholes[key, pred] = graph, loop, counts
        _, loop, counts = whole
        t0 = time.perf_counter()
        self.iters.zero_()
        _build.while_launch(loop.exec, self.device)
        iters = int(self.iters.item())
        STATS["launch_ms"] += (time.perf_counter() - t0) * 1e3
        for total, add in zip((K.LAUNCHES, K.TAILS), counts):
            for name, c in add.items():
                total[name] += c * iters
        LAUNCHES["while_cond"] += iters
        STATS["replays"] += 1
        STATS["runs"] += 1
        STATS["iterations"] += iters
        STATS["body_steps"] = n
        STATS["form"] = "whole"
        return iters

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

    def _capture(self, launches, keep=False):
        """`launches()` captured into a CUDA graph (`keep`: not
        instantiated, its raw graph kept for a whole-run graph's body);
        returns it and the launch counts it set aside."""
        before = dict(K.LAUNCHES), dict(K.TAILS)
        graph = torch.cuda.CUDAGraph(keep_graph=True) if keep \
            else torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # `torch.cuda.graph` would also synchronize the card and empty the
        # allocator's cache before capturing: freeing the last run's cached
        # fields took up to 108 ms on an H100 at Sod 8192^2, over a third
        # of a 100-cycle solve. Nothing in a window allocates, so the
        # capture goes without. The cycle collector stays off during a
        # capture: a graph it destroyed there would spoil the capture (see
        # the class doc). Over processes the capture refuses only this
        # thread's unsafe calls: the process group's watchdog thread polls
        # its collectives' events meanwhile.
        mode = "global" if self.nprocs == 1 else "thread_local"
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool, capture_error_mode=mode)
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


def _steps(run, start, n, end):
    """The launches of steps start .. start + n - 1 of `run`, for a
    capture: they must end with the buffer roles `end`; `run.cur` and
    `run.nxt` are put back, since nothing ran yet."""
    def launches():
        bufs = run.cur, run.nxt
        for i in range(start, start + n):
            run.cycle(i)
        if run.roles() != end:
            solver_error("config", f"{n} steps from step {start} ended with "
                                   f"the buffer roles {run.roles()}, not {end}")
        run.cur, run.nxt = bufs
    return launches


class _WhileGraph:
    """An instantiated whole-run graph (`ops/_build.while_build`): WHILE
    (a copy of the CUDA graph `child`, then `while_cond(pred, count)`),
    destroyed with its holder."""

    def __init__(self, child, pred, count):
        self.graph = self.exec = None  # what `__del__` sees if the build raises
        self.graph, self.exec = _build.while_build(child, pred, count)

    def __del__(self):
        if self.graph is not None:
            _build.while_destroy(self.graph, self.exec)
