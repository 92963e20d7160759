#!/usr/bin/env python3
"""Whether `torch.profiler`'s trace holds every kernel of a whole-run CUDA
graph (`armon_torch/core/graphs.py` `CycleGraphs.run`), on one NVIDIA
card.

    python3 tools/trace_whole.py --fresh   # in a fresh process
    python3 tools/trace_whole.py           # after chip_smoke.py's phases
                                           # 0-4 and 7-10 (~4 min)

A traced run counts each kernel's records in the Chrome trace that
`armon_torch.utils.profiling.trace` writes and holds them against the
wrappers' counts (`ops/sweep.LAUNCHES`, `core/graphs.LAUNCHES` for
`while_cond`). `--fresh` traces whole-run graphs of Sod, f32 fast math,
per-sweep at 1024^2 (500 cycles), 8192^2 (20) and 256^2 (2000), and on
the multicycle route at 100^2 (4000), a few runs each. Without it the
process first runs `chip_smoke.py`'s phases 0-4 and 7-10, as the full
smoke does before phase 11, then traces Sod 8192^2 for 20 cycles, three
runs each: `armon()` with `profiling=["trace"]` (which replays window
graphs); the lean loop's whole-run graph; its window graphs; the
whole-run graph with a sync and one more op before the trace ends; the
whole-run graph after `torch.cuda.empty_cache()`. One JSON line per run:
the wrappers' counts, the trace's counts of K1, K2, K5 and `while_cond`,
and the device's free memory. Times are not measured.
"""

import argparse
import collections
import glob
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

MAIN = dict(test="Sod", data_type="float32", scheme="GAD",
            projection="euler_2nd", riemann_limiter="minmod", nghost=4,
            axis_splitting="Sequential", use_fast_math=True, silent=5,
            device="cuda", maxtime=1e30)
PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)


def trace_counts(log_dir):
    """{K1, K2, while_cond: records} in the Chrome trace under `log_dir`."""
    from chip_smoke import _base_kernel
    [path] = glob.glob(os.path.join(log_dir, "trace_*.json"))
    with open(path) as f:
        names = [_base_kernel(e["name"]) for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    c = collections.Counter("while_cond" if "while_cond" in n else n
                            for n in names)
    return {k: c.get(n, 0) for k, n in (
        ("x_sweep", "x_sweep_kernel"), ("y_sweep", "y_sweep_finish_kernel"),
        ("multicycle", "multicycle_kernel"), ("while_cond", "while_cond"))}


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
                      "while_cond": G.LAUNCHES["while_cond"],
                      "trace": trace_counts(d), "free_gb": free / 1e9}),
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

    def run(d, after=None):
        with trace(d, "cuda"):
            res = lean(graphs, whole)
            if after:
                after()
        return res.cycles
    return run


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fresh", action="store_true",
                    help="trace in a fresh process (no smoke phases first)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_whole: no CUDA card available", file=sys.stderr)
        return 2
    from armon_torch._card import card_line
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="armon_trace_") as tmp:
        (fresh if args.fresh else after_smoke)(torch, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
