#!/usr/bin/env python3
"""The eager loop over two NCCL processes, a card each, timed and broken
down for one or more checkouts in alternation, on two NVIDIA cards.

    python3 tools/eager_processes.py ROOT [ROOT ...]

Each ROOT is the root of a checkout that holds `armon_torch/` (its kernels
build into ROOT/build/armon_torch first, in a process of their own). The
roots run in the order given and then in reverse (parent, change, change,
parent for two), each pass a job of two worker processes (this script
with `--worker`), joined over NCCL, one card each. The cell is Sedov
2000^2 over 1x2 (one 2000 x 1000 shard a process, the pair route, K4 with
its slab splice), f32 fast math, GAD/minmod/euler_2nd, nghost 4, maxtime
1e30, through `armon(..., graphs=False)`: the eager loop, whatever the
checkout's default. A pass times, after one warm-up run of 16 cycles,
three runs of 500 cycles: ms a cycle, the slowest process's solve time
(host clock, as `armon()` reports it).

Then, on the last pass of each root, each process breaks one eager run of
200 cycles down twice:
- on the host, with `cProfile`: the functions with the most own time,
  in us a cycle and calls a cycle (`cProfile` slows Python calls, so these
  are shares, not times), and the run's wall ms a cycle under it;
- on the card, with `torch.profiler` (CPU and CUDA activities): each
  device kernel's us a cycle and launches a cycle, the device's busy us a
  cycle (the kernels' sum) against the run's wall us a cycle, and the
  host ops with the most own CPU time.

It prints the card line (`nvidia-smi` name and power limit), one JSON
line per pass and, last, the median per root and each root's breakdown.
"""

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = dict(test="Sedov", N=(2000, 2000), P=(1, 2), data_type="float32",
            scheme="GAD", projection="euler_2nd", riemann_limiter="minmod",
            nghost=4, use_fast_math=True, maxtime=1e30, silent=5,
            device="cuda")
NPROCS = 2
CYCLES, REPS, PROFILED = 500, 3, 200
JOB_TIMEOUT = 400  # seconds a job may take, its workers' start included
TOP = 14


def _host_top(prof, cycles):
    """The functions with the most own time in `prof`: [name, us a cycle,
    calls a cycle]."""
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:TOP]
    out = []
    for (path, line, fn), (_, calls, tottime, _, _) in rows:
        where = f"{os.path.basename(os.path.dirname(path))}/" \
                f"{os.path.basename(path)}:{line}" if line else path
        out.append([f"{fn} ({where})", tottime / cycles * 1e6,
                    calls / cycles])
    return out


def _device_breakdown(torch, run, cycles):
    """One run under `torch.profiler`: the device kernels' us and launches
    a cycle, their sum, the run's wall us a cycle, and the host ops with
    the most own CPU time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    kernels = sorted(((e.key, dev_us(e), e.count) for e in events
                      if dev_us(e) > 0), key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    busy = sum(k[1] for k in kernels)
    return {"wall_us_per_cycle": wall / cycles * 1e6,
            "device_busy_us_per_cycle": busy / cycles if kernels
            else "not measured: the profiler saw no device time",
            "kernels": [[k, us / cycles, n / cycles]
                        for k, us, n in kernels[:TOP]],
            "host_ops": [[k, us / cycles, n / cycles]
                         for k, us, n in host[:TOP]]}


def worker(root, rank, port, breakdown):
    """One process of a pass: its solve seconds a run and, with
    `breakdown`, its two breakdowns; one JSON line."""
    sys.path.insert(0, root)
    import torch
    from armon_torch import ArmonParameters, armon
    from armon_torch.parallel import dist
    procs = dict(coordinator_address=f"localhost:{port}",
                 num_processes=NPROCS, process_id=rank)

    def run(cycles):
        return armon(ArmonParameters(**OPTS, **procs, maxcycle=cycles),
                     graphs=False)
    run(16)
    solves = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        st = run(CYCLES)
        if st.cycles != CYCLES:
            raise RuntimeError(f"{st.cycles} of {CYCLES} cycles")
        solves.append(st.solve_time)
    out = {"rank": rank, "armon_torch": os.path.dirname(
        sys.modules["armon_torch"].__file__), "solve_s": solves}
    if breakdown:
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        run(PROFILED)
        torch.cuda.synchronize()
        prof.disable()
        out["host"] = {"wall_ms_per_cycle_under_cprofile":
                       (time.perf_counter() - t0) / PROFILED * 1e3,
                       "top_own_time": _host_top(prof, PROFILED)}
        out["device"] = _device_breakdown(torch, lambda: run(PROFILED),
                                          PROFILED)
    print(dist.result_line(out), flush=True)
    dist.shutdown()


def build(root):
    """Build `root`'s kernels in a process of its own."""
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from armon_torch.ops import _build; _build.load()",
                    root], check=True)


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "not measured: nvidia-smi did not answer"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--worker", nargs=4, metavar=("ROOT", "RANK", "PORT",
                                                  "BREAKDOWN"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        root, rank, port, bd = args.worker
        worker(root, int(rank), port, bd == "1")
        return 0
    sys.path.insert(0, HERE)
    import torch
    from armon_torch.parallel.dist import run_workers
    if not torch.cuda.is_available() or torch.cuda.device_count() < NPROCS:
        print(f"needs {NPROCS} CUDA cards", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in args.roots]
    for root in roots:
        build(root)
    print(card_line(), flush=True)
    order = roots + roots[::-1]
    last = {root: max(i for i, r in enumerate(order) if r == root)
            for root in roots}
    ms, breakdowns = {r: [] for r in roots}, {}
    tmp = tempfile.mkdtemp(prefix="eager_processes_")
    for i, root in enumerate(order):
        bd = "1" if last[root] == i else "0"
        results = run_workers(
            lambda rank, port: [sys.executable, os.path.abspath(__file__),
                                "--worker", root, rank, port, bd],
            NPROCS, JOB_TIMEOUT, tmp)
        if any(r is None for r in results):
            raise RuntimeError(f"a worker of {root} printed no result")
        runs = [max(r["solve_s"][k] for r in results) / CYCLES * 1e3
                for k in range(REPS)]
        ms[root] += runs
        print(json.dumps({"pass": i, "root": root,
                          "armon_torch": results[0]["armon_torch"],
                          "cycle_ms": runs}), flush=True)
        if bd == "1":
            breakdowns[root] = [{k: r[k] for k in ("rank", "host", "device")}
                                for r in results]
    for root in roots:
        print(json.dumps({"root": root, "cycle_ms_median":
                          statistics.median(ms[root]),
                          "cycle_ms": ms[root]}), flush=True)
    for root in roots:
        for b in breakdowns[root]:
            print(json.dumps({"root": root, **b}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
