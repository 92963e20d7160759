#!/usr/bin/env python3
"""K1 `x_sweep`, K2 `y_sweep`, K4 `cycle`, K5 `multicycle`, K6 `ff_sum` and
the flip probe kernels of two or more checkouts, timed in alternation on
one NVIDIA card.

    python3 tools/kernel_cmp.py ROOT [ROOT ...]
    python3 tools/kernel_cmp.py --only k5 ROOT [ROOT ...]   # K5 alone
    python3 tools/kernel_cmp.py --only tail ROOT [ROOT ...] # K3's tail alone
    python3 tools/kernel_cmp.py --only k6 ROOT [ROOT ...]   # K6 alone

Each ROOT is the root of a checkout that holds `armon_torch/` (its kernels
build into ROOT/build/armon_torch on first use). The roots run in the
order given and then in reverse (parent, change, change, parent for two),
each pass in a process of its own, every one timed by this tree's timer
(`armon_torch/_card.py` `time_ms`). A pass, f32 fast math (GAD, minmod,
euler_2nd, nghost 4):

- builds two states through the per-sweep kernels K1/K2 (the same
  arithmetic in every tree, so every root times the same inputs, as the
  K4-against-K1/K2 difference shows): Sedov 2000^2 after
  1000 cycles and Sod 8192^2 after 10 (2008^2 and 8200^2 padded);
- times one emitting K4 launch on each, X first and Y first (the full dt
  on both sweeps; the shared timer `armon_torch._card.time_ms`), and
  takes the max difference, on real cells, of the X-first launch's
  rho/u/v/E/p from K1 then K2 on the same state, absolute and over each
  field's scale; on the Sedov state it also times K4 X first on the top
  1008 rows, the shape of a shard of Sedov 2000^2 over a 1x2 mesh;
- on each state, times K1 (not emitting) and K2 (emitting), as a
  Sequential cycle launches them, and on the Sod state their slab forms
  on the same 8200^2 array as a middle shard of a mesh (a neighbour's
  slab on both sides of the swept axis, packed from the state's own edge
  lines);
- times `flip_copy`, `flip_mirror` and `Tensor.copy_` on an 8200^2 f32
  array;
- K5 (`--only k5` runs this part alone): one launch of 8 cycles (the
  default `temporal_blocking`, Sequential) from the state after 50
  per-sweep cycles of Sod at 108^2, 168^2 and 248^2 padded, f32 fast
  math, and at 128^2 in f64, the calls back to back, each from the
  state the one before left (every cycle runs); beside each, the floor
  (`<cell>_floor_ms`: the same launch with the run predicate false, so
  every cycle only copies and waits at the grid barrier) and, in f32,
  the per-position tile body alone (`<cell>_body_ms`: one cycle of the
  cycle probe's `base_l32`, 24 x 24 tiles, with no grid barrier);
- the exact instances (`--only exact` runs this part alone): on Sod
  8192^2 after 10 fast-math cycles, Sedov 2000^2 after 1000 and Sod 100^2
  after 50 (8200^2, 2008^2 and 108^2 padded), cast to f32 and f64, K1
  (not emitting) and K2 (emitting, on K1's output) as a Sequential cycle
  launches them, K4 X first and, at 108^2, K5 (8 cycles, each call from
  the state the one before left), each with the cross-sweep EOS fold
  where the tree has it (`ops/sweep.Fold`): `<state>_<dtype>_exact_
  <kernel>_ms`;
- K3's tail (`--only tail` runs this part alone; not in the default
  groups): on the Sedov 2008^2 and Sod 8200^2 states, an emitting K1, K2
  and K4 launch as the cycle's last: with K3's fold and dt step in its
  tail where the tree has one (`ops/sweep.Finish`), else the launch then
  K3 `cfl_finish` (`<state>_<kernel>_last_ms`); the launch alone
  (`<state>_<kernel>_ms`); K3 alone on K2's partials
  (`<state>_cfl_finish_ms`). Every call starts from the same loop
  scalars (an untimed reset), so every call folds and steps;
- K6 `ff_sum` (`--only k6` runs this part alone; not in the default
  groups): at 8192^2, 2000^2 and 100^2 real cells (4 ghosts) of random
  f32 rho and E from one seed, and on one column of as many rows (its
  second stage nearly alone); the four sums' bits, which must be the
  same in every root; then the per-cycle driver of `armon()` at `silent`
  0 and 1 (a K6 launch and read a cycle) and the lean loop, Sod 8192^2
  (20 cycles) and 100^2 (400), us a cycle of a warm run.

It prints the card line, one JSON line per pass and, last, the mean per
root.
"""

import json
import os
import statistics
import subprocess
import sys

TIMER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "armon_torch", "_card.py")

CHILD = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
from armon_torch import ArmonParameters
from armon_torch.core.solver import make_init_fused
from armon_torch.core.step import make_time_loop_lean
from armon_torch.ops import sweep as K
from armon_torch.ops import cycle as C
from armon_torch.probes import flip
from armon_torch.utils.enums import Axis
# Every root is timed by this tree's timer (`armon_torch/_card.py`), so a
# change to the timer cannot pass for a change to a kernel.
import importlib.util
_spec = importlib.util.spec_from_file_location("timer_card", sys.argv[3])
_timer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_timer)
time_ms = _timer.time_ms

OPTS = dict(data_type="float32", scheme="GAD", projection="euler_2nd",
            riemann_limiter="minmod", nghost=4, use_fast_math=True,
            maxtime=1e30, silent=5, device="cuda", pair_threshold=0,
            temporal_blocking=1)
out = {"root": sys.argv[1]}
groups = sys.argv[2].split(",")
for name, test, n, cycles in (("sedov_2008", "Sedov", 2000, 1000),
                              ("sod_8200", "Sod", 8192, 10)):
    if "sweeps" not in groups:
        break
    params = ArmonParameters(test=test, N=(n, n), maxcycle=cycles, **OPTS)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg)(fs, 0.0, 0, 0.0, float(seed))
    T = np.float32
    dt = float(min(T(cfg.cfl) * T(res.lm), T(1.05) * T(res.dt_last)))
    src = tuple(res.carry[:4])
    dev, shape = src[0].device, src[0].shape
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = dt
    iscal[K.IS_RUN] = 1
    part = torch.zeros((2, max(K.n_partials(Axis.X, shape, dev),
                               K.n_partials(Axis.Y, shape, dev),
                               C.n_partials(shape, dev, cfg.dtype))),
                       dtype=src[0].dtype, device=dev)
    mid, ref, got = ([torch.empty_like(a) for a in src] for _ in range(3))
    p, p4 = torch.empty_like(src[0]), torch.empty_like(src[0])
    out[name + "_cycle_yx_ms"] = time_ms(lambda i: C.cycle(
        cfg, False, 1.0, 1.0, src, got, p4, part, scal, iscal, True), k=20)
    out[name + "_cycle_ms"] = time_ms(lambda i: C.cycle(
        cfg, True, 1.0, 1.0, src, got, p4, part, scal, iscal, True), k=20)
    if name == "sedov_2008":
        top = tuple(a[:1008] for a in src)
        out["sedov_1008x2008_cycle_ms"] = time_ms(lambda i: C.cycle(
            cfg, True, 1.0, 1.0, top, tuple(a[:1008] for a in mid),
            p[:1008], part, scal, iscal, True), k=20)
    g = cfg.nghost
    sides = [("", K.MIRRORED, K.MIRRORED)]
    if name == "sod_8200":
        sides.append(("_slab",
                      (torch.stack([a[:, g:2 * g] for a in src]).contiguous(),
                       torch.stack([a[:, -2 * g:-g] for a in src]).contiguous()),
                      (torch.stack([a[g:2 * g] for a in src]).contiguous(),
                       torch.stack([a[-2 * g:-g] for a in src]).contiguous())))
    for tag, gx, gy in sides:
        out[name + "_x_sweep" + tag + "_ms"] = time_ms(lambda i: K.x_sweep(
            cfg, src, mid, p, part, scal, iscal, 1.0, False, gx), k=20)
        out[name + "_y_sweep" + tag + "_ms"] = time_ms(lambda i: K.y_sweep(
            cfg, src, mid, p, part, scal, iscal, 1.0, True, gy), k=20)
    del sides
    K.x_sweep(cfg, src, mid, p, part, scal, iscal, 1.0, False)
    K.y_sweep(cfg, mid, ref, p, part, scal, iscal, 1.0, True)
    torch.cuda.synchronize()
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    err = rel = 0.0
    for a, b in zip(got + [p4], ref + [p]):
        d = float((a[r] - b[r]).abs().max())
        err = max(err, d)
        rel = max(rel, d / max(float(b[r].abs().max()), 1e-30))
    out[name + "_vs_k1_k2_max_abs"] = err
    out[name + "_vs_k1_k2_max_rel"] = rel
    del src, mid, ref, got, p, p4, part, fs, res
if "sweeps" in groups:
    x = torch.rand((8200, 8200), device="cuda")
    o = torch.empty_like(x)
    out["flip_copy_ms"] = time_ms(lambda i: flip.copy(x, o), k=20)
    out["flip_mirror_ms"] = time_ms(lambda i: flip.mirror_fill(x, 4, o), k=20)
    out["copy__ms"] = time_ms(lambda i: o.copy_(x), k=20)
    del x, o

for name, test, n, cycles in (("sedov_2008", "Sedov", 2000, 1000),
                              ("sod_8200", "Sod", 8192, 10)):
    if "tail" not in groups:
        break
    params = ArmonParameters(test=test, N=(n, n), maxcycle=cycles, **OPTS)
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))
    # Every timed call steps: no maxcycle or maxtime ends the run.
    cfg = ArmonParameters(test=test, N=(n, n), maxcycle=1 << 23,
                          **{**OPTS, "maxtime": 1e30}).config
    T = np.float32
    dt = float(min(T(cfg.cfl) * T(res.lm), T(1.05) * T(res.dt_last)))
    src = tuple(res.carry[:4])
    dev, shape = src[0].device, src[0].shape
    s0, i0 = K.new_scalars(cfg.dtype, dev, t=res.t, cycle=res.cycles,
                           dt_prev=res.dt_last, lm=res.lm)
    s0[K.SC_DTUSE] = dt
    i0[K.IS_RUN] = 1
    scal, iscal = s0.clone(), i0.clone()

    def reset():
        scal.copy_(s0)
        iscal.copy_(i0)
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    tail = hasattr(K, "Finish")
    for kind, nb in (("x_sweep", K.n_partials(Axis.X, shape, dev)),
                     ("y_sweep", K.n_partials(Axis.Y, shape, dev)),
                     ("cycle", C.n_partials(shape, dev, cfg.dtype))):
        part = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
        if kind == "cycle":
            def launch(**fin):
                C.cycle(cfg, True, 1.0, 1.0, src, dst, p, part, scal, iscal,
                        True, **fin)
        else:
            sweep = K.x_sweep if kind == "x_sweep" else K.y_sweep

            def launch(**fin):
                sweep(cfg, src, dst, p, part, scal, iscal, 1.0, True, **fin)
        if tail:
            fin = K.Finish(part, nb, K.new_ticket(dev))
            last = lambda i: launch(finish=fin)
        else:
            last = lambda i: (launch(), K.cfl_finish(cfg, part, nb, scal, iscal))
        out[f"{name}_{kind}_ms"] = time_ms(lambda i: launch(), k=20, reset=reset)
        out[f"{name}_{kind}_last_ms"] = time_ms(last, k=20, reset=reset)
        if kind == "y_sweep":
            out[f"{name}_cfl_finish_ms"] = time_ms(
                lambda i: K.cfl_finish(cfg, part, nb, scal, iscal), k=50,
                reset=reset)
    del src, dst, p, part, fs, res

# The exact instances (f64 and f32 without fast math) as the routes launch
# them: where the tree has the cross-sweep EOS fold (`ops/sweep.Fold`), K1
# leaving the unscaled density and K2 reading it (a Sequential cycle), K4
# and K5 folding between their sweeps; else the launches as they are. The
# states come from the fast-math per-sweep kernels, whose arithmetic no
# tree changes, cast to each type, so every root times the same inputs.
FOLDS = hasattr(K, "Fold")
for name, test, n, cycles in (("sod_8200", "Sod", 8192, 10),
                              ("sedov_2008", "Sedov", 2000, 1000),
                              ("sod_108", "Sod", 100, 50)):
    if "exact" not in groups:
        break
    params = ArmonParameters(test=test, N=(n, n), maxcycle=cycles, **OPTS)
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))
    T = np.float32
    dt = float(min(T(params.config.cfl) * T(res.lm), T(1.05) * T(res.dt_last)))
    for dtype in ("float32", "float64"):
        cfg = ArmonParameters(test=test, N=(n, n), maxcycle=1 << 23,
                              **{**OPTS, "data_type": dtype,
                                 "use_fast_math": False}).config
        tdt = getattr(torch, dtype)
        src = tuple(a.to(tdt) for a in res.carry[:4])
        dev, shape = src[0].device, src[0].shape
        scal, iscal = K.new_scalars(cfg.dtype, dev)
        scal[K.SC_DTUSE] = dt
        iscal[K.IS_RUN] = 1
        part = torch.zeros((2, max(K.n_partials(Axis.X, shape, dev),
                                   K.n_partials(Axis.Y, shape, dev),
                                   C.n_partials(shape, dev, cfg.dtype))),
                           dtype=tdt, device=dev)
        mid, got = ([torch.empty_like(a) for a in src] for _ in range(2))
        p = torch.empty_like(src[0])
        f1, f2 = ({"fold": K.Fold(None, True)}, {"fold": K.Fold(Axis.X, False)}) \
            if FOLDS else ({}, {})
        key = f"{name}_{dtype}_exact"
        out[key + "_x_sweep_ms"] = time_ms(lambda i: K.x_sweep(
            cfg, src, mid, p, part, scal, iscal, 1.0, False, **f1), k=20)
        out[key + "_y_sweep_ms"] = time_ms(lambda i: K.y_sweep(
            cfg, mid, got, p, part, scal, iscal, 1.0, True, **f2), k=20)
        out[key + "_cycle_ms"] = time_ms(lambda i: C.cycle(
            cfg, True, 1.0, 1.0, src, got, p, part, scal, iscal, True), k=20)
        if n == 100:
            from armon_torch.ops.routing import temporal_pairs
            mcfg = ArmonParameters(
                test=test, N=(n, n), maxcycle=1 << 23,
                **{**{k: v for k, v in OPTS.items()
                      if k not in ("pair_threshold", "temporal_blocking")},
                   "data_type": dtype, "use_fast_math": False}).config
            cur = tuple(a.clone() for a in src)
            nxt = tuple(torch.empty_like(a) for a in src)
            ms, mi = K.new_scalars(mcfg.dtype, dev, t=res.t, cycle=res.cycles,
                                   dt_prev=res.dt_last, lm=res.lm)
            mpart = C.new_multicycle_partials(shape, mcfg.dtype, dev)
            out[key + "_multicycle_ms"] = time_ms(lambda i: C.multicycle(
                mcfg, temporal_pairs(mcfg), cur, nxt, p, mpart, ms, mi), k=20)
            del cur, nxt, mpart
        del src, mid, got, p, part
    del fs, res

from armon_torch.ops.routing import temporal_pairs
MC = {k: v for k, v in OPTS.items() if k not in ("pair_threshold", "temporal_blocking")}
for name, n, dtype in (("k5_108", 100, "float32"), ("k5_168", 160, "float32"),
                       ("k5_248", 240, "float32"), ("k5_f64_128", 120, "float64")):
    if "k5" not in groups:
        break
    opts = {**MC, "data_type": dtype, "use_fast_math": dtype == "float32"}
    warm = ArmonParameters(test="Sod", N=(n, n), maxcycle=50, **opts,
                           pair_threshold=0, temporal_blocking=1)
    [fs], seed = make_init_fused(warm)()
    res = make_time_loop_lean(warm.config)(fs, 0.0, 0, 0.0, float(seed))
    cfg = ArmonParameters(test="Sod", N=(n, n), maxcycle=1 << 23, **opts).config
    pairs = temporal_pairs(cfg)
    src0, p0 = tuple(res.carry[:4]), res.carry.p
    dev = p0.device
    cur = tuple(a.clone() for a in src0)
    nxt = tuple(torch.empty_like(a) for a in src0)
    p = p0.clone()
    scal, iscal = K.new_scalars(cfg.dtype, dev, t=res.t, cycle=res.cycles,
                                dt_prev=res.dt_last, lm=res.lm)
    part = C.new_multicycle_partials(p0.shape, cfg.dtype, dev)
    out[name + "_ms"] = time_ms(lambda i: C.multicycle(
        cfg, pairs, cur, nxt, p, part, scal, iscal), k=20)
    # The floor: the same launch with the run predicate false (ok = 0), so
    # every cycle copies its tiles and waits at the grid barrier.
    stop = iscal.clone()
    stop[K.IS_OK] = 0
    out[name + "_floor_ms"] = time_ms(lambda i: C.multicycle(
        cfg, pairs, cur, nxt, p, part, scal, stop), k=20)
    if dtype == "float32":
        # The body alone: one cycle of the per-position 24 x 24 tile body
        # (the cycle probe's `base_l32`), no grid barrier and no fold.
        from armon_torch.ops import _build
        nb = C.tile_grid(32, p0.shape)
        bpart = torch.zeros((2, nb[0] * nb[1]), dtype=p0.dtype, device=dev)
        bscal, biscal = K.new_scalars(cfg.dtype, dev)
        bscal[K.SC_DTUSE] = res.dt_last
        biscal[K.IS_RUN] = 1
        out[name + "_body_ms"] = time_ms(lambda i: _build.launch_cycle_variant(
            cfg, 0, 32, True, 1.0, 1.0, src0, nxt, p, bpart, bscal, biscal),
            k=20)
for n in (8192, 2000, 100):
    if "k6" not in groups:
        break
    # K6 on random blocks from one seed (every root sums the same cells),
    # each by this tree's wrapper on a kept scratch (its TMA descriptors
    # too, where the tree keeps them), and on one column of as many rows.
    from armon_torch.ops import _build
    from armon_torch.ops.reductions import FfScratch
    cfg = ArmonParameters(test="Sod", N=(n, n), **OPTS).config
    gen = torch.Generator(device="cuda").manual_seed(18)
    rho, E = (torch.rand((n + 8, n + 8), generator=gen, device="cuda")
              for _ in range(2))
    sc = FfScratch(n, rho.device)
    kw = {"maps": sc.maps} if hasattr(sc, "maps") else {}
    for tag, nx in (("", n), ("_one_column", 1)):
        out[f"k6_{n}{tag}_ms"] = time_ms(lambda i: _build.launch_ff_sum(
            cfg, rho, E, (nx, n), sc.rows, sc.out, sc.ticket, **kw), k=20)
    _build.launch_ff_sum(cfg, rho, E, (n, n), sc.rows, sc.out, sc.ticket, **kw)
    out[f"k6_{n}_bits"] = sc.out.cpu().numpy().view(np.uint32).tolist()
    del rho, E, sc
if "k6" in groups:
    # K6 in its caller: the per-cycle driver of `armon()` at `silent` 0
    # and 1 (one K6 launch and read a cycle) beside the lean loop (5),
    # Sod 8192^2 (20 cycles) and 100^2 (400), us a cycle of the second of
    # two runs.
    import contextlib, io
    from armon_torch import armon
    for n, cycles in ((8192, 20), (100, 400)):
        for silent in (5, 0, 1):
            params = dict(OPTS, test="Sod", N=(n, n), maxcycle=cycles,
                          silent=silent)
            for _ in range(2):
                with contextlib.redirect_stdout(io.StringIO()):
                    st = armon(ArmonParameters(**params))
            out[f"driver_{n}_silent{silent}_us"] = st.solve_time / st.cycles * 1e6
print(json.dumps(out), flush=True)
'''


def main(argv=None):
    args = list(argv or sys.argv[1:])
    groups = "sweeps,k5,exact"
    if args[:1] == ["--only"]:
        groups, args = args[1], args[2:]
    roots = [os.path.abspath(r) for r in args]
    if not roots:
        sys.exit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rows = {r: [] for r in roots}
    for root in roots + roots[::-1]:
        res = subprocess.run([sys.executable, "-c", CHILD, root, groups, TIMER],
                             cwd=root, capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            sys.exit(f"kernel_cmp: the pass in {root} failed")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows[root].append(json.loads(line))
    bits = {json.dumps({k: v for k, v in p.items() if k.endswith("_bits")})
            for passes in rows.values() for p in passes}
    if len(bits) > 1:
        sys.exit(f"kernel_cmp: the roots' K6 sums differ: {sorted(bits)}")
    for root, passes in rows.items():
        keys = [k for k in passes[0] if k != "root" and not k.endswith("_bits")]
        print(json.dumps({"root": root, "mean": {
            k: statistics.mean(p[k] for p in passes) for k in keys}}))


if __name__ == "__main__":
    main()
