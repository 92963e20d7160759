"""Weak scaling over processes, one card each: the card counterpart of
`scripts/scaling.py`.

    python -m armon_torch.scaling                      # 1, 2, 4, ... cards
    python -m armon_torch.scaling --n-per-device 1024 --cycles 20
    python -m armon_torch.scaling --eager              # graphs=False
    python -m armon_torch.scaling --device cpu --n-per-device 64 \\
        --max-procs 2 --cycles 4                       # a rehearsal

For each process count p = 1, 2, 4, ... up to the card count it starts p
worker processes (this module with `--worker`), joined over
`torch.distributed` (NCCL; gloo on the CPU), each driving one
`--n-per-device`^2 shard of Sod f32 fast math (the main path's
configuration, `bench.py:77-93`) on its own card, over a px x py mesh
as near square as p allows. Each worker runs
`armon()` once to warm up (and build the kernels), then `--reps` timed
runs of `--cycles` cycles; a run's time is its slowest process's
`solve_time`. The runs take the loop's default form (`core/graphs.py`:
on one card the whole-run graph, over NCCL processes window graphs);
`--eager` runs the eager loop (`graphs=False`), the yardstick. Then, on
the final state, it times apart the exchange of one cycle (`halo_slabs`
along each sharded axis: the local packs and the messages) and the
gather of the CFL partials (`dist.all_gather_rows`), each the best of
`--reps` rounds of 20 behind a barrier.

It prints the card line (`nvidia-smi` name and power limit), then one
JSON line per mesh: the loop's form, cells/s, the cycle's ms, the
exchange's and the gather's ms a cycle, and the efficiency against p
times the one-process rate. On the CPU (`--device cpu`) every time is
"not measured": the run only shows that the path works.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ._card import NOT_MEASURED, card_line
from .parallel import dist
from .parallel.dist import backend_for

PARTIAL_ROUNDS = 20
TIMEOUT = 900  # seconds a mesh's workers may take, their start included


def meshes(max_procs):
    """(px, py) for p = 1, 2, 4, ... <= max_procs, px <= py as near
    square as p allows (`scripts/scaling.py`)."""
    out, p = [], 1
    while p <= max_procs:
        px = int(np.floor(np.sqrt(p)))
        while p % px:
            px -= 1
        out.append((px, p // px))
        p *= 2
    return out


def _options(args, P, nprocs, rank, port):
    n = args.n_per_device
    opts = dict(test="Sod", N=(n * P[0], n * P[1]), P=P,
                data_type="float32" if args.dtype == "f32" else "float64",
                maxtime=1e30, silent=5, measure_time=False,
                device=args.device)
    if nprocs > 1:
        opts.update(coordinator_address=f"localhost:{port}",
                    num_processes=nprocs, process_id=rank)
    return opts


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_rounds(fn, device, reps, rounds=PARTIAL_ROUNDS):
    """The best of `reps` mean times (ms) of `rounds` calls of fn, each
    round started together on every process (a barrier) and ended when
    this process's device is done."""
    best = float("inf")
    for _ in range(reps):
        dist.barrier("scaling round", device)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / rounds * 1e3)
    return best


def worker(args, P, nprocs, rank, port):
    """One process of a mesh: returns its line's numbers (seconds)."""
    from . import ArmonParameters, armon
    from .core import graphs as G
    from .io.subdomain import shard_states
    from .ops import sweep as K
    from .parallel.dist import all_gather_rows
    from .parallel.halo import halo_slabs, new_slab_buffers
    from .parallel.mesh import Mesh
    from .utils.enums import Axis
    opts = _options(args, P, nprocs, rank, port)
    graphs = False if args.eager else None
    armon(ArmonParameters(**opts, maxcycle=args.cycles), graphs=graphs)
    best = float("inf")
    for _ in range(args.reps):
        params = ArmonParameters(**opts, maxcycle=args.cycles,
                                 return_data=True)
        stats = armon(params, graphs=graphs)
        if stats.cycles != args.cycles:
            raise RuntimeError(f"mesh {P}: {stats.cycles} of {args.cycles} "
                               f"cycles")
        best = min(best, stats.solve_time)
    form = G.STATS["form"]
    cfg, dev = params.config, params.device
    mesh = Mesh.of(params)
    cur = [(st.rho, st.u, st.v, st.E)
           for st in shard_states(params, stats.data)]
    axes = [a for a in (Axis.X, Axis.Y) if mesh.proc_dims[a] > 1]
    bufs = {a: new_slab_buffers(cfg, mesh, cur, a) for a in axes}
    exchange_ms = _time_rounds(
        lambda: [halo_slabs(cfg, mesh, cur, a, bufs[a]) for a in axes],
        dev, args.reps) if axes else 0.0
    nb = K.n_partials(Axis.Y, cur[0][0].shape, dev)
    mine = torch.zeros((2, len(mesh.local) * nb), dtype=cur[0][0].dtype,
                       device=dev)
    gather_ms = _time_rounds(lambda: all_gather_rows(mine), dev,
                             args.reps) if nprocs > 1 else 0.0
    return {"solve_s": best, "exchange_ms": exchange_ms,
            "gather_ms": gather_ms, "form": form}


def _line(args, P, results, base):
    p = P[0] * P[1]
    n = args.n_per_device
    cells = n * n * p
    solve = max(r["solve_s"] for r in results)
    rate = cells * args.cycles / solve
    line = {"processes": p, "P": list(P), "N": [n * P[0], n * P[1]],
            "cycles": args.cycles, "dtype": args.dtype,
            "backend": backend_for(args.device, True)
            if p > 1 else None, "form": results[0]["form"]}
    if args.device == "cpu":
        return dict(line, cells_per_s=NOT_MEASURED, cycle_ms=NOT_MEASURED,
                    exchange_ms_per_cycle=NOT_MEASURED,
                    gather_ms_per_cycle=NOT_MEASURED), rate
    return dict(line, cells_per_s=rate, cycle_ms=solve / args.cycles * 1e3,
                exchange_ms_per_cycle=max(r["exchange_ms"] for r in results),
                gather_ms_per_cycle=max(r["gather_ms"] for r in results),
                efficiency=rate / (p * base) if base else 1.0), rate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-per-device", type=int, default=8192)
    ap.add_argument("--cycles", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--eager", action="store_true",
                    help="run the eager loop (graphs=False)")
    ap.add_argument("--max-procs", type=int, default=0,
                    help="default: the card count (4 on the CPU)")
    ap.add_argument("--worker", nargs=5, type=int, metavar=(
        "PX", "PY", "NPROCS", "RANK", "PORT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("armon_torch.scaling: no CUDA card available", file=sys.stderr)
        return 2
    if args.worker:
        px, py, nprocs, rank, port = args.worker
        torch.set_num_threads(1)
        print(dist.result_line(worker(args, (px, py), nprocs, rank, port)),
              flush=True)
        dist.shutdown()
        return 0

    limit = args.max_procs or (torch.cuda.device_count()
                               if args.device == "cuda" else 4)
    print(card_line() if args.device == "cuda" else "cpu, not measured",
          flush=True)
    own = list(argv if argv is not None else sys.argv[1:])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = None
    with tempfile.TemporaryDirectory(prefix="armon_scaling_") as tmp:
        for P in meshes(limit):
            p = P[0] * P[1]
            results = dist.run_workers(
                lambda rank, port: [sys.executable, "-m", "armon_torch.scaling",
                                    *own, "--worker", P[0], P[1], p, rank,
                                    port],
                p, TIMEOUT, tmp, cwd=root)
            line, rate = _line(args, P, results, base)
            base = base or rate
            print(json.dumps({"scaling": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
