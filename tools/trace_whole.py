#!/usr/bin/env python3
"""Whether `torch.profiler`'s trace holds every kernel record of the
lean loop, the per-cycle driver's loop and a whole-run CUDA graph
(`armon_torch/core/graphs.py` `CycleGraphs.run`), on one NVIDIA card.

    python3 tools/trace_whole.py --fresh   # in a fresh process
    python3 tools/trace_whole.py --driver  # the per-cycle driver's loop
    python3 tools/trace_whole.py --after-op-profile  # phase 11 (b)'s run
                                           # after phase 9's op profile
    python3 tools/trace_whole.py           # after chip_smoke.py's phases
                                           # 0-4 and 7-10 (~4 min)

A traced run counts each kernel's records in the Chrome trace that
`armon_torch.utils.profiling.trace` writes and holds them against the
wrappers' counts (`ops/sweep.LAUNCHES`; `core/graphs.LAUNCHES` for the
tails that set a whole-run graph's condition). The loops here are traced without the trace's warm-up
launches (`profiling.WARM_LAUNCHES`) unless a case says otherwise;
`armon()` runs with them. `--fresh` traces whole-run graphs of Sod, f32
fast math, per-sweep at 1024^2 (500 cycles), 8192^2 (20) and 256^2
(2000), and on the multicycle route at 100^2 (4000), a few runs each.
`--driver` traces Sod 8192^2 for 20 cycles: the lean loop eagerly, then
three runs each of the per-cycle driver's loop (`KernelCycles`, a host
read a cycle) eagerly and with one-cycle window graphs, and of the
whole-run graph, after 0, 4, 16 and 64 warm-up launches.
`--after-op-profile` traces `chip_smoke.py` phase 11 (b)'s run (the
per-cycle driver through `armon()` with `log_blocks`, Sod 8192^2, 20
cycles), eight runs with the warm-up launches in the profiler's warm-up
step (`profiling.trace`) and eight with 16 of them inside the recorded
step (the trace's form before), alternated, after phase 9's profile of
the op path's launches at 8192^2 (`chip_smoke._launches_per_cycle`,
about 4e5 kernels), and two runs of each form before it. Without any
of these flags the process first runs `chip_smoke.py`'s phases 0-4 and
7-10, as the full smoke does before phase 11, then traces Sod 8192^2
for 20 cycles, three runs each: `armon()` with `profiling=["trace"]` (which replays
window graphs); the lean loop's whole-run graph; its window graphs; the
whole-run graph with a sync and one more op before the trace ends; the
whole-run graph after `torch.cuda.empty_cache()`; then, with a card
sync and a wait of 0, 1, 10 or 100 ms before the trace ends, six runs of
the per-cycle driver's loop eagerly, and three each of it with one-cycle
window graphs and of the whole-run graph. One JSON line per run: the
wrappers' counts, the tails that set the WHILE condition, the trace's
counts of K1, K2 and K5,
where records are missing (`trace_where`) and the device's free memory.
Times are not measured.
"""

import argparse
import collections
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

MAIN = dict(test="Sod", data_type="float32", scheme="GAD",
            projection="euler_2nd", riemann_limiter="minmod", nghost=4,
            axis_splitting="Sequential", use_fast_math=True, silent=5,
            device="cuda", maxtime=1e30)
PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)


def trace_counts(log_dir):
    """{K1, K2, K5: records} in the Chrome trace under `log_dir`."""
    from chip_smoke import _base_kernel
    [path] = glob.glob(os.path.join(log_dir, "trace_*.json"))
    with open(path) as f:
        names = [_base_kernel(e["name"]) for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    c = collections.Counter(names)
    return {k: c.get(n, 0) for k, n in (
        ("x_sweep", "x_sweep_kernel"), ("y_sweep", "y_sweep_finish_kernel"),
        ("multicycle", "multicycle_kernel"))}


def trace_where(log_dir):
    """Where the Chrome trace under `log_dir` lacks device records: the
    host's launch calls (runtime or driver events named *Launch*) that no
    kernel, copy or set record shares a correlation with, each by its
    index among them and its ms from the first and to the last host
    call; K1's records' gaps over 1.5x their median (ms), by index; the
    first and last K1 record against the host calls (ms)."""
    from chip_smoke import _base_kernel
    [path] = glob.glob(os.path.join(log_dir, "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    seen = {e.get("args", {}).get("correlation") for e in dev}
    host = sorted((e for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                  key=lambda e: e["ts"])
    if not host:
        return {"host_calls": 0}
    launches = [e for e in host if "Launch" in e["name"]]
    t0, t1 = host[0]["ts"], max(e["ts"] + e["dur"] for e in host)
    lost = [{"name": e["name"], "i": i, "of": len(launches),
             "from_start_ms": (e["ts"] - t0) / 1e3,
             "to_end_ms": (t1 - e["ts"]) / 1e3}
            for i, e in enumerate(launches)
            if e.get("args", {}).get("correlation") not in seen]
    xs = sorted(e["ts"] for e in dev
                if _base_kernel(e["name"]) == "x_sweep_kernel")
    gaps = [b - a for a, b in zip(xs, xs[1:])]
    med = sorted(gaps)[len(gaps) // 2] if gaps else 0.0
    return {"lost_launch_calls": lost,
            "x_median_gap_ms": med / 1e3,
            "x_long_gaps_ms": [(k, g / 1e3) for k, g in enumerate(gaps)
                               if g > 1.5 * med],
            "x_first_from_start_ms": (xs[0] - t0) / 1e3 if xs else None,
            "x_last_to_end_ms": (t1 - xs[-1]) / 1e3 if xs else None}


def traced(torch, label, run, tmp, i):
    """`run(log_dir)` from zeroed counts; one JSON line."""
    from armon_torch.core import graphs as G
    from armon_torch.ops import sweep as K
    K.reset_launches()
    G.reset_launches()
    d = os.path.join(tmp, f"{len(os.listdir(tmp))}")
    cycles = run(d)
    free, _ = torch.cuda.mem_get_info()
    print(json.dumps({"case": label, "run": i, "cycles": cycles,
                      "wrappers": {k: v for k, v in K.LAUNCHES.items() if v},
                      "while_tail": G.LAUNCHES["while_tail"],
                      "trace": trace_counts(d), "where": trace_where(d),
                      "free_gb": free / 1e9}),
          flush=True)


def fresh(torch, tmp):
    for n, cycles, reps in ((1024, 500, 4), (8192, 20, 6), (256, 2000, 3),
                            (100, 4000, 2)):
        opts = dict(MAIN, N=(n, n), maxcycle=cycles,
                    **({} if n == 100 else PER_SWEEP))
        run = _lean_run(torch, opts, "whole")
        for i in range(reps):
            traced(torch, f"whole-run graph, {n}^2", run, tmp, i)


def _lean_run(torch, opts, form):
    """run(log_dir) of the lean loop in `form` (`chip_smoke._form_args`)
    under the trace; returns the cycles."""
    import chip_smoke as cs
    from armon_torch.utils.profiling import trace
    lean = cs._Lean(opts)
    graphs, whole = cs._form_args(form)

    def run(d, after=None, warm=0):
        with trace(d, "cuda", warm):
            res = lean(graphs, whole)
            if after:
                after()
        return res.cycles
    return run


def _per_cycle_run(torch, opts, graphs):
    """run(log_dir) of the per-cycle driver's loop over the kernels
    (`core/solver._cycle_driver`: a one-cycle window, then a host read)
    under the trace; `graphs` as `KernelCycles` takes it."""
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused, make_mesh
    from armon_torch.core.step import KernelCycles
    from armon_torch.utils.profiling import trace
    params = ArmonParameters(**opts)

    def run(d, after=None, warm=0):
        fs, seed = make_init_fused(params)()
        loop = KernelCycles(params.config, make_mesh(params), fs, 0.0, 0,
                            0.0, float(seed), False, graphs=graphs)
        cycles, running = 0, True
        with trace(d, "cuda", warm):
            loop.first_step()
            while running:
                loop.window(cycles, 1)
                _, _, running, _ = loop.iscal.tolist()
                cycles += 1
            if after:
                after()
        return cycles
    return run


@contextlib.contextmanager
def _trace_in_step(log_dir, device="cpu", warm=16):
    """`profiling.trace` as it was before its warm-up step: the warm-up
    launches inside the recorded step, in a `trace_warm_up` section."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("trace_warm_up"):
            x = torch.zeros(1, device=device)
            for _ in range(warm):
                x.add_(1)
            torch.cuda.synchronize(device)
        yield prof
    prof.export_chrome_trace(os.path.join(
        str(log_dir), f"trace_{os.getpid()}_{time.time_ns()}.json"))


def after_op_profile(torch, tmp, reps=8):
    """Phase 11 (b)'s traced run in both forms of the trace, before and
    after phase 9's op-path profile; one JSON line a run, as `traced`."""
    import armon_torch.core.solver as S
    import chip_smoke as cs
    from armon_torch import ArmonParameters, armon
    from armon_torch.core.solver import clear_cache
    from armon_torch.utils import profiling
    opts = dict(MAIN, N=(cs.MAIN_N, cs.MAIN_N), maxcycle=cs.OBS_CYCLES,
                log_blocks=True, profiling=["trace"])
    forms = (("warm-up step", profiling.trace),
             ("16 launches in the recorded step", _trace_in_step))

    def through_armon(form):
        def run(d):
            S.trace = form
            try:
                st = armon(ArmonParameters(**opts, output_dir=d))
            finally:
                S.trace = profiling.trace
            for f in glob.glob(os.path.join(d, "profile", "trace_*.json")):
                os.replace(f, os.path.join(d, os.path.basename(f)))
            return st.cycles
        return run
    for i in range(2):
        for label, form in forms:
            traced(torch, f"{label}, before the op profile",
                   through_armon(form), tmp, i)
    t = time.perf_counter()
    r = cs._launches_per_cycle(torch, cs.MAIN_N)
    print(json.dumps({"op_profile_kernels_per_cycle":
                      r["cuda_kernels_per_cycle"],
                      "s": time.perf_counter() - t}), flush=True)
    clear_cache()
    for i in range(reps):
        for label, form in forms:
            traced(torch, f"{label}, after the op profile",
                   through_armon(form), tmp, i)


def after_smoke(torch, tmp):
    import armon_torch as a
    import chip_smoke as cs
    cs.phase0(torch)
    cs.phase1(torch)
    cs.phase2(torch)
    kernels = cs.phase3(torch)
    rates = {"main": kernels.pop()}
    rates["small"] = cs.phase4(torch).pop()
    cs.phase7(torch, rates)
    cs.phase8(torch)
    cs.phase9(torch)
    cs.phase10(torch)
    opts = dict(MAIN, N=(cs.MAIN_N, cs.MAIN_N), maxcycle=20)
    a.armon(a.ArmonParameters(**opts))

    def through_armon(d):
        st = a.armon(a.ArmonParameters(**opts, profiling=["trace"],
                                       output_dir=d))
        os.replace(glob.glob(os.path.join(d, "profile", "trace_*.json"))[0],
                   os.path.join(d, "trace_armon.json"))
        return st.cycles

    def sync_and_op():
        torch.cuda.synchronize()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    whole = _lean_run(torch, opts, "whole")
    cases = (("armon(), traced (window graphs)", through_armon),
             ("whole-run graph", whole),
             ("window graphs", _lean_run(torch, opts, "windows")),
             ("whole-run graph, a sync and an op before the trace ends",
              lambda d: whole(d, sync_and_op)))
    for label, run in cases:
        for i in range(3):
            traced(torch, label, run, tmp, i)
    torch.cuda.empty_cache()
    for i in range(3):
        traced(torch, "whole-run graph after empty_cache", whole, tmp, i)
    driver_cases(torch, tmp, opts, whole, (0, 1, 10, 100))


def driver_cases(torch, tmp, opts, whole, waits):
    """The per-cycle driver's loop traced, eager (six runs) and with
    one-cycle window graphs (three), and the whole-run graph `whole`
    (three), with a card sync and each wait (ms) before the trace ends."""
    eager = _per_cycle_run(torch, opts, False)
    windows = _per_cycle_run(torch, opts, None)
    for ms in waits:
        def wait(ms=ms):
            torch.cuda.synchronize()
            time.sleep(ms / 1e3)
        for i in range(6):
            traced(torch, f"per-cycle driver, eager, {ms} ms wait",
                   lambda d: eager(d, wait), tmp, i)
        for i in range(3):
            traced(torch, f"per-cycle driver, window graphs, {ms} ms wait",
                   lambda d: windows(d, wait), tmp, i)
            traced(torch, f"whole-run graph, {ms} ms wait",
                   lambda d: whole(d, wait), tmp, i)


def driver(torch, tmp):
    """At Sod 8192^2, 20 cycles, in a fresh process, after one untraced
    run of each loop: the lean loop eager, then `warmed`."""
    import chip_smoke as cs
    opts = dict(MAIN, N=(cs.MAIN_N, cs.MAIN_N), maxcycle=20)
    whole = _lean_run(torch, opts, "whole")
    whole(os.path.join(tmp, "warm"))
    for graphs in (False, None):
        _per_cycle_run(torch, opts, graphs)(os.path.join(tmp, "warm"))
    for i in range(2):
        traced(torch, "lean loop, eager", _lean_run(torch, opts, "eager"),
               tmp, i)
    warmed(torch, tmp, opts, whole, (0, 4, 16, 64))


def warmed(torch, tmp, opts, whole, warms):
    """The per-cycle driver's loop, eager and with one-cycle window graphs,
    and the whole-run graph `whole`, three runs each under a trace that
    makes each of `warms` small launches before the work starts."""
    runs = (("per-cycle driver, eager", _per_cycle_run(torch, opts, False)),
            ("per-cycle driver, window graphs",
             _per_cycle_run(torch, opts, None)),
            ("whole-run graph", whole))
    for w in warms:
        for label, run in runs:
            for i in range(3):
                traced(torch, f"{label}, {w} warm launches",
                       lambda d: run(d, warm=w), tmp, i)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fresh", action="store_true",
                    help="trace in a fresh process (no smoke phases first)")
    ap.add_argument("--driver", action="store_true",
                    help="only the per-cycle driver's cases, in a fresh "
                         "process")
    ap.add_argument("--after-op-profile", action="store_true",
                    help="phase 11 (b)'s traced run in both forms of the "
                         "trace, before and after phase 9's op profile")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_whole: no CUDA card available", file=sys.stderr)
        return 2
    from armon_torch._card import card_line
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="armon_trace_") as tmp:
        (driver if args.driver else fresh if args.fresh
         else after_op_profile if args.after_op_profile
         else after_smoke)(torch, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
