#!/usr/bin/env python3
"""Host-bound cells of the PyTorch/CUDA port (`armon_torch`), timed
through `armon()` for one or more checkouts in alternation, on one NVIDIA
card.

    python3 tools/host_path.py ROOT [ROOT ...]

Each ROOT is the root of a checkout that holds `armon_torch/` (its kernels
build into ROOT/build/armon_torch on first use). The roots run in the
order given and then in reverse (parent, change, change, parent for two),
each pass in a process of its own, and that twice (parent, change,
change, parent, parent, change, change, parent for two). A pass times,
after one warm-up run per cell, three runs of each cell:

- Sod 100^2 on the multicycle route (the routing's own choice: K5, 8
  cycles a launch, one stop read per launch), 4000 cycles;
- Sod 100^2 on the pair route (`temporal_blocking=1`), 4000 cycles;
- Sedov 2000^2 on the per-sweep route (`pair_threshold=0`), 1000 cycles;

f32 fast math, GAD/minmod/euler_2nd, nghost 4, maxtime 1e30, the solve
time per cycle (host clock, as `armon()` reports it), and the kernel
launches per cycle of the last run (K3's tail, where the tree has one,
rides on its kernel's launch and does not count). Then, on each cell's
initial state, the launches of its cycle one by one: device ms per
launch (CUDA events over back-to-back launches) and host us per wrapper
call (host clock over 200 calls queued without a sync, fewer than the
launch queue holds), K3 `cfl_finish` among them, and where the tree has
K3's tail, the cycle's last launch with it (`<kernel>+tail`). It prints
the card line, one JSON line per pass and, last, the mean and the median
per root and cell.
"""

import json
import os
import statistics
import subprocess
import sys
import time

CELLS = (("Sod 100^2 multicycle", "Sod", 100, 4000, dict()),
         ("Sod 100^2 pair", "Sod", 100, 4000, dict(temporal_blocking=1)),
         ("Sedov 2000^2 per-sweep", "Sedov", 2000, 1000,
          dict(pair_threshold=0, temporal_blocking=1)))
OPTS = dict(data_type="float32", scheme="GAD", projection="euler_2nd",
            riemann_limiter="minmod", nghost=4, use_fast_math=True,
            maxtime=1e30, silent=5, device="cuda")
REPS = 3
CALLS = 200


def _launch_times(torch, params, route):
    """{launch: [device ms, host us]} of the cell's launches on its initial
    state (a pair cycle's K4, a per-sweep one's K1 and K2, each with K3's
    tail on the cycle's last where the tree has it, and K3 alone; a
    multicycle launch K5 alone; `route` names the cell's)."""
    from armon_torch.core.solver import make_init_fused
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.utils.enums import Axis
    cfg = params.config
    fs, seed = make_init_fused(params)()
    fs = fs[0] if isinstance(fs, list) else fs  # a list of shards, or one
    src = tuple(fs[:4])
    dev = src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    # K1's partials outnumber K2's and K4's (a 248-position strip of one
    # row per block), in every tree this times.
    nb = max(K.n_partials(Axis.X, src[0].shape, dev),
             K.n_partials(Axis.Y, src[0].shape, dev))
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = 1e-6
    iscal[K.IS_RUN] = 1
    s3, i3 = scal.clone(), iscal.clone()
    calls = {"cfl_finish": lambda: K.cfl_finish(cfg, partials, nb, s3, i3)}
    if route == "multicycle":  # from cycle 0, as the loop starts: all run
        from armon_torch.ops.routing import temporal_pairs
        pairs = temporal_pairs(cfg)
        part = C.new_multicycle_partials(src[0].shape, cfg.dtype, dev)
        s5, i5 = K.new_scalars(cfg.dtype, dev, lm=float(seed))
        calls = {"multicycle": lambda: C.multicycle(cfg, pairs, src, dst, p, part,
                                                    s5, i5)}
    elif route == "pair":
        calls["cycle"] = lambda: C.cycle(cfg, True, 1.0, 1.0, src, dst, p,
                                         partials, scal, iscal, True)
    else:
        calls["x_sweep"] = lambda: K.x_sweep(cfg, src, dst, p, partials,
                                             scal, iscal, 1.0, False)
        calls["y_sweep"] = lambda: K.y_sweep(cfg, src, dst, p, partials,
                                             scal, iscal, 1.0, True)
    if route != "multicycle" and hasattr(K, "Finish"):
        # The cycle's last launch with K3's tail, on scalars of its own.
        s4, i4 = scal.clone(), iscal.clone()
        fin = K.Finish(partials, nb, K.new_ticket(dev))
        if route == "pair":
            calls["cycle+tail"] = lambda: C.cycle(
                cfg, True, 1.0, 1.0, src, dst, p, partials, s4, i4, True,
                finish=fin)
        else:
            calls["y_sweep+tail"] = lambda: K.y_sweep(
                cfg, src, dst, p, partials, s4, i4, 1.0, True, finish=fin)
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        host = (time.perf_counter() - t0) / CALLS * 1e6
        torch.cuda.synchronize()
        out[name] = [start.elapsed_time(end) / CALLS, host]
    return out


def worker(root):
    sys.path.insert(0, root)
    import torch
    from armon_torch import ArmonParameters, armon
    from armon_torch.ops import sweep as K
    out = {"root": root}
    for name, test, n, cycles, route in CELLS:
        opts = dict(test=test, N=(n, n), **OPTS, **route)
        armon(ArmonParameters(maxcycle=16, **opts))
        us = []
        for _ in range(REPS):
            K.reset_launches()
            stats = armon(ArmonParameters(maxcycle=cycles, **opts))
            if stats.cycles != cycles:
                raise AssertionError(f"{test} {n}^2: {stats.cycles} cycles")
            us.append(stats.solve_time / stats.cycles * 1e6)
        out[name] = us
        out[name + " launches per cycle"] = sum(K.LAUNCHES.values()) / stats.cycles
        out[name + " launches [device ms, host us]"] = _launch_times(
            torch, ArmonParameters(maxcycle=cycles, **opts), name.split()[-1])
    print(json.dumps(out), flush=True)


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    runs = {}
    for root in 2 * (list(roots) + list(reversed(roots))):
        root = os.path.abspath(root)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"pass over {root} failed: {res.returncode}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        for cell, us in line.items():
            if cell != "root" and "launch" not in cell:
                runs.setdefault(root, {}).setdefault(cell, []).extend(us)
    print(json.dumps({stat: {
        root: {cell: fn(us) for cell, us in cells.items()}
        for root, cells in runs.items()}
        for stat, fn in (("mean_us_per_cycle", statistics.mean),
                         ("median_us_per_cycle", statistics.median))}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
