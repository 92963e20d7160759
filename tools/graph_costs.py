#!/usr/bin/env python3
"""Two costs of the whole-run CUDA graph (`armon_torch/core/graphs.py`) on
one NVIDIA card: the length of its WHILE body, and what a capture's host
time holds.

    python3 tools/graph_costs.py

It prints the card line, then one JSON line each:

- "body": `graphs.body_steps` gives the fewest steps after which the
  schedule's parity and the buffer roles come back (1-2 cycles, or 1-2 K5
  launches). The alternative is as many such bodies as cover a
  `check_every` window of 8 cycles (8 // K K5 launches): it sets the
  condition less often, but launches up to 7 cycles past the run's end.
  On `chip_smoke.py` phase 14 (b)'s cells (f32 fast math, through the
  lean loop), after a warm-up run of each, the two bodies four runs each
  in mirrored order: us a cycle, with and without the capture, the
  iterations, and every run's bits against the first run's.
- "first_launch": in two fresh processes, CUDA's module loading as the
  environment leaves it (lazy by default since CUDA 12.2) and with
  `CUDA_MODULE_LOADING=EAGER`: the host ms of the first three calls (the
  card idle before each, Sod_circ 256^2) of K1 in f64 exact, then of K2
  in f64 exact (another kernel of the same library), then of K1 in f32
  fast math (another library), and the capture ms of two Sedov 256^2 f64
  pair runs with window graphs, the first of which launches K4, of yet
  another library, for the first time in the process; each call also
  with the thread's user and system CPU ms and minor page faults.
- "captures", in this process after a warm-up: 24 captures of an
  8-cycle window graph of Sod_circ 1000^2 per-sweep, a new run each, in
  turn with the card idle and behind a spin kernel queued just before
  (about 50 and 200 ms). For each, the host ms of the capture
  (`graphs.STATS`), split into `capture_begin`, the wrapper calls and
  `capture_end` (instantiation included), the thread's user and system
  CPU ms and minor page faults over it (`getrusage`; the clock may tick
  in steps; a wait on the card spins, and counts as user time, under
  CUDA's default scheduling), and the ms that freeing the last run, its
  graphs with it, took before it. Every other capture first
  synchronizes the card inside the capture's call, just before
  `capture_begin`, timed apart (`sync_ms`).
"""

import argparse
import contextlib
import json
import os
import resource
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BODY_FORMS = ("fewest", "window")
BODY_ORDER = (BODY_FORMS + BODY_FORMS[::-1]) * 2
EVERY = 8  # the cycles of a `check_every` window


@contextlib.contextmanager
def body_of(form):
    """The lean loop's whole-run graph with the body `form`: "fewest" as
    the solver has it; "window" the fewest bodies that cover `EVERY`
    cycles."""
    from armon_torch.core import step
    real = step.body_steps

    def window(run, start):
        n = real(run, start)
        steps = max(1, EVERY // len(run.pairs)) if hasattr(run, "pairs") \
            else EVERY
        return n * -(-steps // n)
    step.body_steps = real if form == "fewest" else window
    try:
        yield
    finally:
        step.body_steps = real


def body(torch):
    import chip_smoke as cs
    out = []
    for name, opts, cycles in cs.GRAPH_CELLS[:-1]:
        lean = cs._Lean({**cs.SMALL_OPTS, "maxcycle": cycles}, **opts)
        for form in BODY_FORMS:
            with body_of(form):
                cs._run_form(torch, lean, "whole")
        runs, ref = [], None
        for form in BODY_ORDER:
            torch.cuda.synchronize()
            with body_of(form):
                t0 = time.perf_counter()
                res, _, st = cs._run_form(torch, lean, "whole")
                secs = time.perf_counter() - t0
            sc, f = cs._outcome(res)
            if ref is None:
                ref = sc, f
            elif not cs._same_scalars(sc[:-1], ref[0][:-1]) or not all(
                    cs._bits_equal(torch, a, b) for a, b in zip(f, ref[1])):
                raise AssertionError(f"{name}, {form}: {sc} against {ref[0]}")
            runs.append({"form": form, "body_steps": st["body_steps"],
                         "iterations": st["iterations"],
                         "cycle_us": secs / sc[0] * 1e6,
                         "cycle_us_without_capture":
                             (secs - st["capture_ms"] / 1e3) / sc[0] * 1e6})
        out.append({"cell": name, "cycles": cycles, "bitwise": True,
                    "cycle_us_without_capture": {
                        form: [r["cycle_us_without_capture"] for r in runs
                               if r["form"] == form] for form in BODY_FORMS},
                    "runs": runs})
    return out


CAPTURES = 24
SPINS = (0, 10 ** 8, 4 * 10 ** 8)  # cycles of `torch.cuda._sleep`


def thread_usage():
    """(user ms, system ms, minor page faults) of this thread so far."""
    r = resource.getrusage(resource.RUSAGE_THREAD)
    return r.ru_utime * 1e3, r.ru_stime * 1e3, r.ru_minflt


def usage_since(u0):
    """{user_ms, sys_ms, minflt} since `thread_usage()` gave `u0`."""
    return dict(zip(("user_ms", "sys_ms", "minflt"),
                    (b - a for a, b in zip(u0, thread_usage()))))


@contextlib.contextmanager
def capture_split(torch, split, sync=False):
    """`torch.cuda.CUDAGraph.capture_begin` and `capture_end` timed into
    `split` (host ms, appended) while the context is open; with `sync`, a
    timed `torch.cuda.synchronize()` before `capture_begin` (not inside
    the capture, where it is not permitted)."""
    cls = torch.cuda.CUDAGraph
    real = cls.capture_begin, cls.capture_end

    def timed(name, fn):
        def call(self, *a, **k):
            if sync and name == "begin_ms":
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                split.setdefault("sync_ms", []).append(
                    (time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                split.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
        return call
    cls.capture_begin = timed("begin_ms", real[0])
    cls.capture_end = timed("end_ms", real[1])
    try:
        yield
    finally:
        cls.capture_begin, cls.capture_end = real


def captures(torch):
    import chip_smoke as cs
    from armon_torch.core import graphs as G
    from armon_torch.core.step import KernelCycles
    lean = cs._Lean(dict(cs.SMALL_OPTS, maxcycle=EVERY), test="Sod_circ",
                    N=(cs.AGREE_N, cs.AGREE_N), **cs.PER_SWEEP)
    cs._run_form(torch, lean, "windows")  # the kernels' first launches
    rows, run = [], None
    for i in range(CAPTURES):
        spin = SPINS[i % len(SPINS)]
        t0 = time.perf_counter()
        run = None  # the last run and its graphs
        freed_ms = (time.perf_counter() - t0) * 1e3
        carry = [type(f)(*(a.clone() for a in f)) for f in lean.fs]
        run = KernelCycles(lean.cfg, lean.mesh, carry, lean.t, 0, lean.dt,
                           lean.lm, False)
        run.first_step()
        torch.cuda.synchronize()
        G.reset_stats()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        if spin:
            torch.cuda._sleep(spin)
        e1.record()
        split = {}
        u0 = thread_usage()
        with capture_split(torch, split, sync=i % 2 == 1):
            run.window(0, EVERY)
        usage = usage_since(u0)
        torch.cuda.synchronize()
        ms = G.STATS["capture_ms"]
        begin, end = split["begin_ms"][0], split["end_ms"][0]
        syncs = split.get("sync_ms", [0.0])
        rows.append({"spin_ms": e0.elapsed_time(e1), "capture_ms": ms,
                     "begin_ms": begin, "end_ms": end,
                     "launches_ms": ms - begin - end - sum(syncs),
                     "sync_ms": syncs, **usage, "freed_ms": freed_ms})
    return rows


def first_calls(torch, sweep, dtype, fast):
    """The host ms of the first three calls of `sweep` (a wrapper of
    `ops/sweep`) on Sod_circ 256^2 in `dtype`, the card idle before
    each."""
    import chip_smoke as cs
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused
    from armon_torch.ops import sweep as K
    params = ArmonParameters(test="Sod_circ", N=(256, 256), data_type=dtype,
                             use_fast_math=fast, silent=5, device="cuda",
                             **cs.PER_SWEEP)
    [fs], _ = make_init_fused(params)()
    src = tuple(fs[:4])
    dst = tuple(torch.empty_like(a) for a in src)
    part = torch.zeros((2, 1), dtype=src[0].dtype, device=src[0].device)
    scal, iscal = K.new_scalars(params.config.dtype, "cuda")
    calls = []
    for _ in range(3):
        torch.cuda.synchronize()
        u0 = thread_usage()
        t0 = time.perf_counter()
        sweep(params.config, src, dst, fs.p, part, scal, iscal, 1.0, False)
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      **usage_since(u0)})
        torch.cuda.synchronize()
    return calls


def first_launch_worker(torch):
    """In a fresh process: the sweeps' first calls, then two pair runs'
    captures."""
    import chip_smoke as cs
    from armon_torch.core import graphs as G
    from armon_torch.ops import _build
    from armon_torch.ops import sweep as K
    _build.load()
    calls = {"k1_f64": first_calls(torch, K.x_sweep, "float64", False),
             "k2_f64": first_calls(torch, K.y_sweep, "float64", False),
             "k1_f32_fast": first_calls(torch, K.x_sweep, "float32", True)}
    lean = cs._Lean(dict(data_type="float64", use_fast_math=False, silent=5,
                         device="cuda", maxcycle=EVERY), whole=False,
                    test="Sedov", N=(256, 256), **cs.PAIR)
    capture_ms = []
    for _ in range(2):
        cs._run_form(torch, lean, "windows")
        capture_ms.append(G.STATS["capture_ms"])
    print(json.dumps({"module_loading": os.environ.get(
        "CUDA_MODULE_LOADING", "unset"), "first_calls_ms": calls,
        "k4_run_capture_ms": capture_ms}), flush=True)


def first_launch():
    out = []
    for loading in (None, "EAGER"):
        env = {k: v for k, v in os.environ.items()
               if k != "CUDA_MODULE_LOADING"}
        if loading:
            env["CUDA_MODULE_LOADING"] = loading
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker"], env=env, capture_output=True,
                           text=True, timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"first-launch worker: {p.stderr[-2000:]}")
        out.append(json.loads(p.stdout.strip().splitlines()[-1]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # a fresh process's first launches
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("graph_costs: no CUDA card available", file=sys.stderr)
        return 2
    if args.worker:
        first_launch_worker(torch)
        return 0
    from armon_torch._card import card_line
    from armon_torch.ops import _build
    _build.load()  # the kernels' build, before the fresh processes use it
    print(card_line(), flush=True)
    print(json.dumps({"first_launch": first_launch(),
                      "captures": captures(torch)}),
          flush=True)
    print(json.dumps({"body": body(torch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
