"""Driver entry points, the port of the JAX package's `__graft_entry__.py`.

    python -m armon_torch.entry              # entry(): one cycle on the card
    python -m armon_torch.entry 4            # dryrun_multichip(4) on the card
    python -m armon_torch.entry 4 device=cpu # the same on CPU shards

- ``entry()`` returns ``(fn, example_args)``: `fn(state, dt_prev, cycle)`
  runs one solver cycle of the flagship configuration (Sod 256^2 f32,
  GAD + minmod, euler_2nd, nghost 4) on the kernels and returns the new
  State and the next dt.
- ``dryrun_multichip(n)`` runs three cycles over an n-shard mesh and holds
  them to the op path, conservation and a reshard load.

Both run on the CUDA card unless ``device="cpu"`` is given; without a
card they raise.

This module imports neither `jax` nor `armon_tpu`.
"""

import os
import sys
import tempfile

import numpy as np
import torch

from .params import ArmonParameters, resolve_device
from .core.solver import (armon, cfl_seed, make_conservation, make_cycle,
                          make_init, make_jit_loop)
from .core.state import FusedCarry
from .interop import gather_state
from .io.restart import load_checkpoint, save_checkpoint
from .ops import sweep as K
from .ops.eos import update_eos

FLAGSHIP_N = (256, 256)
DRY_CYCLES = 3
FIELDS = ("rho", "u", "v", "E")


def _params(n=FLAGSHIP_N, dtype=np.float32, **kw):
    """`__graft_entry__.py:19-23`'s configuration."""
    return ArmonParameters(
        test="Sod", N=n, data_type=dtype, scheme="GAD",
        projection="euler_2nd", riemann_limiter="minmod", nghost=4, silent=5,
        measure_time=False, **kw)


def entry(device=None):
    """(fn, example_args), `__graft_entry__.py:26-43`: `fn(state, dt_prev,
    cycle)` is one cycle of the per-cycle driver's step (`make_cycle`,
    the kernels on the route of one cycle: K4 at this size) from a full
    State, its CFL minimum seeding the time step as a fresh run's does;
    it returns the new State (rho, u, v, E and the stale p replaced) and
    the next dt, a 0-dim tensor. `example_args` is the initial State with
    its cycle-0 EOS applied, dt_prev 0 and cycle 0. `device` as
    `ArmonParameters` takes it: the card unless "cpu"."""
    params = _params(**({} if device is None else {"device": device}))
    cfg = params.config
    T = np.dtype(cfg.dtype).type
    [state] = make_init(params)()
    state = update_eos(cfg, state)  # the cycle-0 EOS (`:34`)

    def fn(state, dt_prev, cycle):
        local0 = float(cfl_seed(params, [state]))
        run = make_cycle(params).load(
            [FusedCarry(state.rho, state.u, state.v, state.E, state.p)],
            T(0.0), int(cycle), T(dt_prev), local0)
        run.first_step()
        dt_next = run.scal[K.SC_DTPREV].clone()
        run.window(int(cycle), 1)
        [out] = run.result(0).carry
        return state._replace(**out._asdict()), dt_next

    return fn, (state, T(0.0), np.int32(0))


def mesh_of(n):
    """The near-square (px, py) mesh of n shards (`:67-71`)."""
    px = int(np.floor(np.sqrt(n)))
    while n % px:
        px -= 1
    return px, n // px


def placement(n, device=None):
    """(device, devices, what): where `dryrun_multichip` puts n shards.
    On the card, cuda:0..n-1 where the machine has n cards, else every
    shard on cuda:0; on the CPU, n CPU shards (the counterpart of the JAX
    package's virtual host devices)."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu", None, f"{n} shards on the CPU"
    have = torch.cuda.device_count()
    if have >= n:
        return "cuda", None, f"{n} shards on cuda:0-{n - 1}"
    return "cuda", ["cuda:0"] * n, \
        f"{n} shards on cuda:0 (the machine has {have} card(s))"


def dryrun_multichip(n, device=None):
    """Three cycles over an n-shard 2D mesh (`__graft_entry__.py:46-180`),
    checked; returns a summary dict (mesh, N, placement, dt, drift).

    The cut is uneven on both axes (17*px - 1 by 16*py - 1 cells: the
    hi-edge shards own fewer cells, a corner shard fewer along both), the
    splitting Godunov (X then Y on even cycles, Y then X on odd), so the
    three cycles carry the one-cycle-stale dt across both parities over
    the mesh. Gates:

    - the op path (`kernel_tier="torch"`) against the kernels on both
      routes, the pair route (the default here; per-sweep where the mesh
      is split along X) and per-sweep (`pair_threshold=0`): the same dt
      and the same real cells, bit for bit;
    - each run's mass and energy within 1e-12 relative of their start;
    - a per-shard snapshot of the kernels' run reshard-loaded onto
      another layout: the same cycles and t, and the same real cells bit
      for bit.

    The JAX function gates its tiers in f32 within 1e-5 on the TPU, whose
    kernels have no f64. The H100 runs f64 natively, and there the op
    path, the plain versions and the kernels in exact mode agree bit for
    bit (ROADMAP C2), so this gate is f64 and bit for bit on the card as
    on the CPU."""
    px, py = mesh_of(n)
    N = (17 * px - (1 if px > 1 else 0), 16 * py - (1 if py > 1 else 0))
    dev, devices, where = placement(n, device)
    base = dict(n=N, dtype=np.float64, P=(px, py), maxcycle=DRY_CYCLES,
                axis_splitting="Godunov", device=dev,
                **({"devices": devices} if devices else {}))
    g = 4

    def run(tier, **kw):
        params = _params(**base, kernel_tier=tier, **kw)
        if tier != "torch" and params.config.op_path:
            raise AssertionError("the kernel tier fell back to the op path: "
                                 "the tier gate would be vacuous")
        states = make_init(params)()
        m0, e0 = make_conservation(params)(states)
        res = make_jit_loop(params)(states)
        if not res.ok or res.cycles != DRY_CYCLES:
            raise AssertionError(f"{tier} {kw}: ok {res.ok}, "
                                 f"{res.cycles} cycles")
        m, e = make_conservation(params)(res.carry)
        if not (np.isfinite(m) and np.isfinite(e)):
            raise AssertionError(f"{tier} {kw}: mass {m}, energy {e}")
        drift = max(abs(m - m0) / abs(m0), abs(e - e0) / abs(e0))
        if drift > 1e-12:
            raise AssertionError(f"{tier} {kw}: conservation drift {drift}")
        return gather_state(params, res.carry), res.dt_last, drift

    ref, dt_ref, drift = run("torch")
    drifts = [drift]
    for label, kw in (("pair", {}), ("per_sweep", {"pair_threshold": 0})):
        got, dt, drift = run("auto", **kw)
        drifts.append(drift)
        if dt != dt_ref:
            raise AssertionError(f"{label}: dt {dt!r} vs the op path's "
                                 f"{dt_ref!r}")
        for v in FIELDS:
            a = getattr(ref, v)[g:-g, g:-g].cpu()
            b = getattr(got, v)[g:-g, g:-g].cpu()
            if not torch.equal(a, b):
                raise AssertionError(f"tier mismatch on {v} ({label} route):"
                                     f" {float((a - b).abs().max())}")

    dst = None
    if n > 1:
        # The elastic-restart leg (`:151-178`): snapshots are mesh-neutral.
        src = _params(**base, use_MPI=True, return_data=True)
        stats = armon(src)
        dst = (py, px) if (py, px) != (px, py) else (n, 1)
        with tempfile.TemporaryDirectory(prefix="armon_dry_") as tmp:
            ck = os.path.join(tmp, "dry.ckpt.npz")
            save_checkpoint(ck, src, stats.data, stats.final_time,
                            stats.cycles, stats.last_dt)
            to = _params(**{**base, "P": dst}, return_data=True)
            states, t2, c2, _, _ = load_checkpoint(ck, to)
        if (c2, t2) != (stats.cycles, stats.final_time):
            raise AssertionError(f"reshard load: cycle {c2}, t {t2} vs "
                                 f"{stats.cycles}, {stats.final_time}")
        a = gather_state(src, stats.data) if isinstance(stats.data, list) \
            else stats.data
        b = gather_state(to, states)
        for v in FIELDS:
            if not torch.equal(getattr(a, v)[g:-g, g:-g].cpu(),
                               getattr(b, v)[g:-g, g:-g].cpu()):
                raise AssertionError(f"reshard load lost {v} "
                                     f"({(px, py)} -> {dst})")
    return {"shards": n, "mesh": [px, py], "N": list(N),
            "placement": where, "cycles": DRY_CYCLES, "dt": float(dt_ref),
            "max_drift": max(drifts),
            "reshard": list(dst) if dst else None}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = None
    counts = []
    for arg in argv:
        if arg.startswith("device="):
            device = arg.split("=", 1)[1]
        else:
            counts.append(int(arg))
    if counts:
        print(dryrun_multichip(counts[0], device))
        print("dryrun_multichip OK")
    else:
        fn, args = entry(device)
        state, dt = fn(*args)
        if not (torch.isfinite(state.rho).all() and torch.isfinite(dt)):
            raise AssertionError("entry: non-finite result")
        print("entry OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
