#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`armon_torch`) on one NVIDIA card.

    python3 chip_smoke.py                 # phases 0-4 and 6-8, as the check runs it
    python3 chip_smoke.py --phases 0,1    # a subset (build + kernel checks)
    python3 chip_smoke.py --phases 0,5    # the route crossovers only
    python3 chip_smoke.py --phases 0,7    # the domain-decomposed runs only
    python3 chip_smoke.py --phases 0,8    # the probes only

Phases, each printing one JSON line:
  0. the card (nvidia-smi name and power limit), the kernels' build time
     and ptxas's registers and spills per kernel instance;
  1. the per-sweep kernels against their plain PyTorch versions on the
     card, one X and one Y sweep at 1024^2 after a few cycles, on Sod_circ
     and Bizarrium, in f64, f32 exact and f32 fast math, plus the CFL
     minimum via K3;
  2. the Julia goldens (Sod, Sod_y, Sod_circ at 100^2) through the
     per-sweep kernels: zero differences in f64 and f32 exact; the f32
     fast-math count is reported;
  3. the main path: Sod 8192^2 f32 fast math (GAD/minmod/euler_2nd, nghost
     4, Sequential), one warm-up run then 100 timed cycles through
     `armon()`, with launch counts (K4/K5 must stay at 0), kernel times
     from CUDA events, host reads, conservation drift and peak memory; then
     every kernel against its plain version at the main path's shapes;
  4. the small-grid routes: K4 against its plain version at 1024^2 (both
     sweep orders) and K5 at 100^2 (one 8-cycle launch from a mid-run
     state, across maxcycle, dt_on_even_cycles, cst_dt), bit for bit in
     exact mode; per-sweep, pair and multicycle runs bit for bit against
     each other; the goldens through the pair and multicycle routes; timed
     runs through `armon()` of Sedov 2000^2 (pair, then per-sweep) and Sod
     100^2 (multicycle, then pair); K4 and K5 on those runs' final states,
     bit for bit against their plain versions in f32 exact and f64, within
     the fast-math gate in f32 fast math, and timed;
  5. (only when asked for) route crossovers, data for retuning
     `pair_threshold` and `temporal_blocking` on this card: per-sweep
     against pair at 256^2-8192^2, K1/K2/K4 times at 8192^2, pair against
     multicycle on small grids;
  6. the per-kernel summary line (the eight solver kernels and the probe
     kernels; printed last, after phase 8);
  7. domain-decomposed runs (P != (1, 1)), every shard on cuda:0: the slab
     variants of K1/K2 (X/Y slabs, a 3x3 mesh of 1024^2 shards) and of K4
     (Y slabs with the X mirror after the splice, corner cells, a 1x3
     mesh, both sweep orders) against their plain versions on every shard
     of a mid-run state; meshes against the one-device run bit for bit
     (Sod_circ 1000^2 over 2x2, 1x2, 2x1, 4x1 and 3x2, N=(1000, 999) over
     3x2, Sedov 2000^2 over 1x2 on the pair route) in f64 and f32 exact;
     the goldens through a 2x2 mesh; timed runs through `armon()` of Sod
     16384^2 over 2x2 (8192^2 shards, the main path's shape) and Sedov
     2000^2 over 1x2 (pair route), with per-shard kernel times, the slab
     copies' time, launches per cycle, conservation drift and peak memory;
     the slab variants on those runs' final states (the first and the last
     shard), bit for bit against their plain versions in f32 exact and
     f64, within the fast-math gate as timed; and, where the machine has
     four cards, the 2x2 check on cuda:0-3;
  8. the probes (`armon_torch/probes/`, the card counterparts of the TPU
     probes under `scripts/`): each probe's entry point at its default
     sizes (flip at 512x1024 and 8200^2, ff at 1024^2, the I/O ladder at
     8192^2, the rate classes at 8192^2, K4's variants at Sod 4096^2 and
     8192^2), printing its own lines with the card, its launches counted;
     then each probe kernel against its plain version at the shapes it
     was timed at, and a small one (bit for bit where the arithmetic is
     exact, within a stated gate elsewhere).

Every kernel time is the best of 3 passes of back-to-back CUDA-event
timed calls behind a spin kernel (`armon_torch/_card.py`, shared with the
probes), so host launch time does not enter it.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it. Without a CUDA card, or without the `armon_torch` package next
to this file, it exits non-zero at once. It imports nothing of JAX.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_DIR = os.path.join(HERE, "tests", "reference_data")

sys.path.insert(0, HERE)
try:  # the timing, bound and card line every timed row shares
    from armon_torch._card import bound, card_line, emit, time_ms
except ModuleNotFoundError as exc:  # alone, without its package: main exits 2
    if exc.name != "armon_torch":
        raise

# Operations per cell of one sweep (GAD + minmod + euler_2nd, perfect gas;
# a divide or a square root counts as one): the census of the sweep's
# plain version, `python -m armon_torch.probes.roofline` (add 19, sub 34,
# mul 65, div 22, sqrt 1, min 8, max 8, compares 9, selects 18, abs 4,
# negations 4).
SWEEP_OPS_PER_CELL = 192

MAIN_N = 8192
MAIN_CYCLES = 100

# Route pins (`armon_torch/ops/routing.py`).
PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)


def bound_f32(nbytes, nops):
    """`bound` with `nops` f32 operations (the kernels are built with
    -fmad=false, so an operation is one lane instruction)."""
    return bound(nbytes, {"float32": nops})


def compare(torch, a, b, g):
    """(max abs diff, max norm-relative diff, max ulp distance) of two
    fields on their real cells."""
    a = a[g:-g, g:-g]
    b = b[g:-g, g:-g]
    diff = (a - b).abs()
    scale = b.abs().max().clamp_min(torch.finfo(b.dtype).tiny)
    ulp = (_ordered(torch, a) - _ordered(torch, b)).abs().max()
    nan = bool(torch.isnan(a).any() or torch.isnan(b).any())
    return (float(diff.max()), float(diff.max() / scale),
            int(ulp) if not nan else None)


def _ordered(torch, a):
    """Float bits as integers that order like the values (so the integer
    difference counts ulps, and -0 equals +0)."""
    if a.dtype == torch.float64:
        i = a.contiguous().view(torch.int64)
        low = torch.iinfo(torch.int64).min
        return torch.where(i < 0, low - i, i)
    i = a.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(2 ** 31) - i, i)


def _ptxas_summary(log):
    """["<kernel instance>: <registers>, <spills>", ...] from `ptxas -v`'s
    output (mangled names without the namespace prefix)."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
            name = name.replace("_ZN5armon", "")
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            regs = ln.split("Used")[-1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spill}")
            name, spill = None, ""
    return out


def phase0(torch):
    from armon_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = {src: _ptxas_summary(log)
            for src, log in _build.BUILD_INFO["logs"].items()}
    emit({"phase": 0, "card": card_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": regs})


def _state_after(torch, test, n, dtype, fast, cycles):
    """The port's carry after `cycles` cycles (through the per-sweep
    kernels) and the dt of the next cycle."""
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused
    from armon_torch.core.step import make_time_loop_lean
    params = ArmonParameters(test=test, N=(n, n), data_type=dtype,
                             use_fast_math=fast, maxcycle=cycles, silent=5,
                             device="cuda", **PER_SWEEP)
    cfg = params.config
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg)(fs, 0.0, 0, 0.0, float(seed))
    import numpy as np
    T = np.dtype(dtype).type
    dt = T(cfg.cfl) * T(res.lm)
    if res.dt_last:
        dt = min(dt, T(1.05) * T(res.dt_last))
    return params, res.carry, float(dt)


def check_sweeps(torch, params, fs, dt):
    """One X sweep (not emitting) and one Y sweep (emitting p and the CFL
    partials) through the kernels and through the plain version on the
    same inputs, then K3 against its plain version on the kernel's
    partials. Returns per-kernel diffs."""
    from armon_torch.ops import sweep as K
    from armon_torch.utils.enums import Axis
    cfg = params.config
    g = cfg.nghost
    shape = fs.rho.shape
    dev = fs.rho.device
    out = {}
    src = (fs.rho, fs.u, fs.v, fs.E)
    for axis, emit_last in ((Axis.X, False), (Axis.Y, True)):
        dst = tuple(torch.empty_like(a) for a in src)
        p = torch.empty_like(fs.rho)
        nb = K.n_partials(axis, shape, dev)
        partials = torch.zeros((2, nb), dtype=fs.rho.dtype, device=dev)
        scal, iscal = K.new_scalars(cfg.dtype, dev)
        scal[K.SC_DTUSE] = dt
        iscal[K.IS_RUN] = 1
        (K.x_sweep if axis is Axis.X else K.y_sweep)(
            cfg, src, dst, p, partials, scal, iscal, 1.0, emit_last)
        ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0)
        torch.cuda.synchronize()
        names = ("rho", "u", "v", "E") + (("p",) if emit_last else ())
        got = dst + ((p,) if emit_last else ())
        fields = {nm: compare(torch, a, b, g) for nm, a, b in zip(names, got, ref)}
        res = {"fields": fields}
        if emit_last:
            mx, my = K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5])
            kmx = float(partials[0].max())
            kmy = float(partials[1].max())
            res["cfl_max_rel"] = max(abs(kmx - float(mx)) / float(mx),
                                     abs(kmy - float(my)) / float(my))
            # K3 on the kernel's partials against its plain version.
            s1, i1 = K.new_scalars(cfg.dtype, dev, lm=1.0)
            i1[K.IS_RUN] = 1
            s2, i2 = s1.clone(), i1.clone()
            K.cfl_finish(cfg, partials, nb, s1, i1, fold=True, step=True)
            K.cfl_finish_plain(cfg, partials, nb, s2, i2, fold=True, step=True)
            res["k3_equal"] = bool(torch.equal(s1, s2) and torch.equal(i1, i2))
            res["k3_lm"] = float(s1[K.SC_LM])
        out[axis.name] = res
        src = dst  # the Y sweep reads the X sweep's output
    return out


def _gate(fields, dtype, fast):
    """Tolerances: f64 1e-13 relative (bitwise expected: -fmad=false and
    IEEE divides on both sides); f32 exact 4 ulp; f32 fast math 1e-4
    relative (approximate reciprocals against exact divides)."""
    for name, (absd, rel, ulp) in fields.items():
        if dtype == "float64":
            ok = rel <= 1e-13
        elif not fast:
            ok = ulp is not None and ulp <= 4
        else:
            ok = rel <= 1e-4
        if not ok:
            raise AssertionError(f"{dtype} fast={fast} {name}: abs {absd} "
                                 f"rel {rel} ulp {ulp}")


def phase1(torch, n=1024, cycles=3):
    results = []
    for test in ("Sod_circ", "Bizarrium"):
        for dtype, fast in (("float64", False), ("float32", False),
                            ("float32", True)):
            params, fs, dt = _state_after(torch, test, n, dtype, fast, cycles)
            res = check_sweeps(torch, params, fs, dt)
            for ax in ("X", "Y"):
                _gate(res[ax]["fields"], dtype, fast)
            cfl_tol = 1e-13 if dtype == "float64" else (8 * 1.2e-7 if not fast else 1e-4)
            if res["Y"]["cfl_max_rel"] > cfl_tol or not res["Y"]["k3_equal"]:
                raise AssertionError(f"CFL check failed: {test} {dtype} "
                                     f"fast={fast}: {res['Y']}")
            results.append({"test": test, "dtype": dtype, "fast": fast,
                            "n": n, "dt": dt, **res})
    emit({"phase": 1, "checks": results})
    return results


def _read_golden(path, dtype):
    import numpy as np
    with open(path) as f:
        dt_s, cyc_s = f.readline().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1).astype(dtype)
    return np.dtype(dtype).type(dt_s), int(cyc_s), data


def _goldens(torch, route):
    """Sod, Sod_y and Sod_circ at 100^2 through `armon()` on one route:
    zero differences required in f64 and f32 exact; the f32 fast-math
    count is reported."""
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.interop import to_numpy
    rows = []
    for test in ("Sod", "Sod_y", "Sod_circ"):
        for dtype, fast in (("float64", False), ("float32", False),
                            ("float32", True)):
            bits = 64 if dtype == "float64" else 32
            ref_dt, ref_cycles, ref = _read_golden(
                os.path.join(REF_DIR, f"ref_{test}_{bits}bits.csv"), dtype)
            params = ArmonParameters(
                test=test, N=(100, 100), data_type=dtype, scheme="GAD",
                projection="euler_2nd", riemann_limiter="minmod", nghost=4,
                maxcycle=1000, silent=5, measure_time=False,
                return_data=True, use_fast_math=fast, device="cuda",
                **route)
            stats = armon(params)
            st = to_numpy(stats.data)
            g = params.nghost
            ours = np.stack([getattr(st, v)[g:-g, g:-g].reshape(-1)
                             for v in ("x", "y", "rho", "u", "v", "p")], 1)
            atol = 1e-13 if bits == 64 else 1e-5
            rtol = 4 * np.finfo(np.float64).eps if bits == 64 \
                else 20 * np.finfo(np.float32).eps
            err = np.abs(ref - ours)
            tol = np.maximum(atol, rtol * np.maximum(np.abs(ref), np.abs(ours)))
            diffs = int((~(err <= tol)).sum())
            rows.append({"test": test, "dtype": dtype, "fast": fast,
                         "cycles": stats.cycles, "ref_cycles": ref_cycles,
                         "diffs": diffs})
            if not fast and (diffs or stats.cycles != ref_cycles):
                raise AssertionError(f"golden {test} {dtype} {route}: {rows[-1]}")
    return rows


def phase2(torch):
    rows = _goldens(torch, PER_SWEEP)
    emit({"phase": 2, "goldens": rows})
    return rows


def phase3(torch):
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.ops import sweep as K
    from armon_torch.ops.reductions import conservation_vars, conservation_scalar
    from armon_torch.utils.enums import Axis
    from armon_torch.core.state import FusedCarry
    opts = dict(test="Sod", N=(MAIN_N, MAIN_N), data_type="float32",
                scheme="GAD", projection="euler_2nd", riemann_limiter="minmod",
                nghost=4, axis_splitting="Sequential", use_fast_math=True,
                silent=5, device="cuda")
    armon(ArmonParameters(maxcycle=2, **opts))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = ArmonParameters(maxcycle=MAIN_CYCLES, check_result=True,
                             return_data=True, **opts)
    cfg = params.config
    K.reset_launches()
    stats = armon(params)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    st = stats.data
    m, e = conservation_vars(cfg, st.rho, st.E)
    m, e = conservation_scalar(cfg, m), conservation_scalar(cfg, e)
    mass_drift = abs(m - params.initial_mass) / params.initial_mass
    energy_drift = abs(e - params.initial_energy) / params.initial_energy
    if stats.cycles != MAIN_CYCLES or not np.isfinite(st.rho.sum().item()):
        raise AssertionError(f"main path: {stats.cycles} cycles")
    for name in ("x_sweep", "y_sweep", "cfl_finish"):
        if launches[name] == 0:
            raise AssertionError(f"main path never launched {name}")
    if launches["cycle"] or launches["multicycle"]:
        raise AssertionError(f"8192^2 left the per-sweep route: {launches}")
    if mass_drift > 1e-6 or energy_drift > 1e-6:
        raise AssertionError(f"conservation drift {mass_drift} {energy_drift}")
    cells = MAIN_N * MAIN_N
    main = {"phase": 3, "N": MAIN_N, "cycles": stats.cycles,
            "solve_s": stats.solve_time,
            "cells_per_s": cells * stats.cycles / stats.solve_time,
            "grind_ns": stats.solve_time / stats.cycles / cells * 1e9,
            "host_reads": stats.host_reads, "launches": launches,
            "mass_drift": mass_drift, "energy_drift": energy_drift,
            "max_memory_allocated": peak}

    # Kernels at the main path's shapes: times (CUDA events), their plain
    # versions' times, bounds, and the check against the plain versions.
    fs_src = (st.rho, st.u, st.v, st.E)
    shape = st.rho.shape
    dev = st.rho.device
    dst = tuple(torch.empty_like(a) for a in fs_src)
    p = torch.empty_like(st.rho)
    nbx = K.n_partials(Axis.X, shape, dev)
    nby = K.n_partials(Axis.Y, shape, dev)
    partials = torch.zeros((2, max(nbx, nby)), dtype=st.rho.dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = stats.last_dt
    iscal[K.IS_RUN] = 1
    field_bytes = st.rho.numel() * st.rho.element_size()
    ops = SWEEP_OPS_PER_CELL * st.rho.numel()

    saved = dict(K.LAUNCHES)
    x_ms = time_ms(lambda i: K.x_sweep(cfg, fs_src, dst, p, partials, scal,
                                      iscal, 1.0, False), k=20)
    y_ms = time_ms(lambda i: K.y_sweep(cfg, fs_src, dst, p, partials, scal,
                                      iscal, 1.0, True), k=20)
    s2, i2 = scal.clone(), iscal.clone()  # K3 advances its own scalars
    k3_ms = time_ms(lambda i: K.cfl_finish(cfg, partials, nby, s2, i2),
                    k=50)
    dt_t = scal[K.SC_DTUSE] * 1.0
    xp_ms = time_ms(lambda i: K.sweep_plain(cfg, Axis.X, *fs_src, dt_t), k=3)
    yp_ms = time_ms(lambda i: K.sweep_plain(cfg, Axis.Y, *fs_src, dt_t), k=3)
    k3p_ms = time_ms(lambda i: K.cfl_finish_plain(cfg, partials, nby, s2.clone(),
                                                 i2.clone()), k=20)
    amax_ms = time_ms(lambda i: torch.amax(partials[:, :nby], dim=1), k=50)

    # Against the plain version at these shapes (f32 fast math vs exact).
    checks = check_sweeps(torch, params, FusedCarry(st.rho, st.u, st.v, st.E, st.p),
                          stats.last_dt)
    for ax in ("X", "Y"):
        _gate(checks[ax]["fields"], "float32", True)
    if checks["Y"]["cfl_max_rel"] > 1e-4 or not checks["Y"]["k3_equal"]:
        raise AssertionError(f"main-path CFL check failed: {checks['Y']}")
    K.LAUNCHES.update(saved)  # timing and check launches are not main-path ones

    part_bytes = 2 * nby * st.rho.element_size()
    kernels = []
    for name, src_file, replaces, ms, pms, nbytes, nops, lib, diffs in (
            ("x_sweep", "armon_torch/csrc/sweep.cuh",
             "armon_tpu/ops/pallas/sweep.py:978", x_ms, xp_ms,
             8 * field_bytes, ops, None, checks["X"]["fields"]),
            ("y_sweep", "armon_torch/csrc/sweep.cuh",
             "armon_tpu/ops/pallas/sweep.py:1092", y_ms, yp_ms,
             9 * field_bytes + part_bytes, ops, None, checks["Y"]["fields"]),
            ("cfl_finish", "armon_torch/csrc/cfl.cu",
             "armon_tpu/ops/pallas/sweep.py:968", k3_ms, k3p_ms,
             part_bytes + 64, 4 * nby, amax_ms, None)):
        b_ms, b_by = bound_f32(nbytes, nops)
        err = max(d[0] for d in diffs.values()) if diffs else \
            (0.0 if checks["Y"]["k3_equal"] else float("inf"))
        kernels.append({"name": name, "route": "cuda", "source": src_file,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib})
    main["kernel_ms"] = {"x_sweep": x_ms, "y_sweep": y_ms, "cfl_finish": k3_ms}
    main["checks"] = checks
    emit(main)
    return kernels + [{"cells_per_s": main["cells_per_s"],
                       "kernel_ms": main["kernel_ms"]}]


# ------------------------------------------------------- small-grid routes

SMALL_OPTS = dict(data_type="float32", scheme="GAD", projection="euler_2nd",
                  riemann_limiter="minmod", nghost=4, use_fast_math=True,
                  maxtime=1e30, silent=5, device="cuda")
SEDOV_N, SEDOV_CYCLES = 2000, 1000  # BASELINE config 3
SOD_N, SOD_CYCLES = 100, 4000       # BASELINE config 1


def _exact_cfgs(test, N, **extra):
    """(dtype, config) in f32 and f64 exact mode (no fast math), the timed
    runs' other options kept: the configs that hold a kernel bit for bit
    against its plain version on a timed run's final state."""
    from armon_torch import ArmonParameters
    return [(dtype, ArmonParameters(
        test=test, N=N, **{**SMALL_OPTS, "data_type": dtype,
                           "use_fast_math": False, **extra}).config)
            for dtype in ("float32", "float64")]


def _loop_from_init(params):
    from armon_torch.core.solver import make_init_fused
    from armon_torch.core.step import make_time_loop_lean
    [fs], seed = make_init_fused(params)()
    return make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))


def _gate_fields(torch, got, ref, g, fast, what):
    """Real cells of each pair: bit for bit in exact mode, within 1e-4 of
    the field's scale in fast math. Returns the max abs difference."""
    r = (slice(g, -g), slice(g, -g))
    err = 0.0
    for a, b in zip(got, ref):
        d = float((a[r] - b[r]).abs().max())
        err = max(err, d)
        ok = (d <= 1e-4 * float(b[r].abs().max())) if fast \
            else torch.equal(a[r], b[r])
        if not ok:
            raise AssertionError(f"{what}: max abs diff {d}")
    return err


def _k4_vs_plain(torch, cfg, src, dt, x_first, fast, what,
                 factors=(0.5, 1.0)):
    """One emitting K4 launch against `cycle_plain` on the same inputs, and
    K3 on its partials against K3's plain version. `factors` are the dt
    factors of the first and the second sweep (Strang's pair by default).
    Returns the max abs difference of the fields."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    dev = src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = C.n_partials(src[0].shape, dev)
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = dt
    iscal[K.IS_RUN] = 1
    fx, fy = factors if x_first else factors[::-1]
    C.cycle(cfg, x_first, fx, fy, src, dst, p, partials, scal, iscal, True)
    dt_t = scal[K.SC_DTUSE]
    ref = C.cycle_plain(cfg, x_first, *src, dt_t * fx, dt_t * fy)
    torch.cuda.synchronize()
    err = _gate_fields(torch, dst + (p,), ref[:5], cfg.nghost, fast, what)
    for got, want in ((partials[0].max(), ref[5]), (partials[1].max(), ref[6])):
        if abs(float(got) - float(want)) > (1e-4 * float(want) if fast else 0.0):
            raise AssertionError(f"{what}: CFL max {float(got)} vs {float(want)}")
    s2, i2 = scal.clone(), iscal.clone()
    K.cfl_finish(cfg, partials, nb, scal, iscal)
    K.cfl_finish_plain(cfg, partials, nb, s2, i2)
    if not (torch.equal(scal, s2) and torch.equal(iscal, i2)):
        raise AssertionError(f"{what}: K3 on K4's partials")
    return err


def _k5_inputs(torch, cfg, src, p, sc):
    """Fresh copies of K5's operands: [fields, second buffer set, stale p,
    scal, iscal], the loop scalars from `sc` (t, cycle, dt_prev, lm)."""
    from armon_torch.ops import sweep as K
    scal, iscal = K.new_scalars(cfg.dtype, src[0].device, **sc)
    return [tuple(a.clone() for a in src), tuple(torch.empty_like(a) for a in src),
            p.clone(), scal, iscal]


def _k5_check(torch, cfg, pairs, src, p, sc, fast, what):
    """One K5 launch against `multicycle_plain` on copies of the same
    inputs: fields, p and every loop scalar, bit for bit in exact mode.
    Returns (max abs diff, the cycle counter after the launch)."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    a, b = _k5_inputs(torch, cfg, src, p, sc), _k5_inputs(torch, cfg, src, p, sc)
    C.multicycle(cfg, pairs, a[0], a[1], a[2],
                 C.new_multicycle_partials(src[0].shape, cfg.dtype, src[0].device),
                 a[3], a[4])
    C.multicycle_plain(cfg, pairs, len(pairs), *b)
    torch.cuda.synchronize()
    k = len(pairs) % 2  # the buffer set the carry ends in
    err = _gate_fields(torch, a[k] + (a[2],), b[k] + (b[2],), cfg.nghost,
                       fast, what)
    if not torch.equal(a[4], b[4]):
        raise AssertionError(f"{what}: loop ints {a[4].tolist()} vs {b[4].tolist()}")
    if fast:
        rel = float(((a[3] - b[3]).abs() / b[3].abs().clamp_min(1e-30)).max())
        if rel > 1e-4:
            raise AssertionError(f"{what}: loop scalars off by {rel}")
    elif not torch.equal(a[3], b[3]):
        raise AssertionError(f"{what}: loop scalars {a[3].tolist()} vs {b[3].tolist()}")
    return err, int(a[4][K.IS_CYCLE])


def _k5_vs_plain(torch, params, warm, what):
    """One K5 launch from the state after `warm` per-sweep cycles against
    `multicycle_plain` on the same inputs (`_k5_check`). Returns (max abs
    diff, cycles run)."""
    import numpy as np
    from armon_torch import ArmonParameters
    from armon_torch.ops.routing import temporal_pairs
    cfg = params.config
    fast = params.use_fast_math and cfg.dtype == np.float32
    opts = {k: getattr(params, k) for k in ("N", "data_type", "use_fast_math",
                                             "axis_splitting", "cst_dt", "Dt",
                                             "dt_on_even_cycles")}
    res = _loop_from_init(ArmonParameters(
        test=params.test, maxcycle=warm, silent=5, device="cuda", **opts,
        **PER_SWEEP))
    sc = dict(t=res.t, cycle=res.cycles, dt_prev=res.dt_last, lm=res.lm)
    err, cyc = _k5_check(torch, cfg, temporal_pairs(cfg), tuple(res.carry[:4]),
                         res.carry.p, sc, fast, what)
    return err, cyc - res.cycles


def _routes_bitwise(torch, test, n, dtype, routes, cycles=20):
    """The same run on each route: equal bits on real cells and equal t,
    cycles, dt and lm (exact mode)."""
    from armon_torch import ArmonParameters
    from armon_torch.ops.routing import route as route_of
    out, names = [], []
    for route in routes:
        params = ArmonParameters(test=test, N=(n, n), data_type=dtype,
                                 use_fast_math=False, maxcycle=cycles,
                                 silent=5, device="cuda", **route)
        names.append(route_of(params.config))
        out.append(_loop_from_init(params))
    g = 4
    for name, res in zip(names[1:], out[1:]):
        base = out[0]
        same = (res.t, res.cycles, res.dt_last, res.lm) == \
            (base.t, base.cycles, base.dt_last, base.lm) and all(
                torch.equal(a[g:-g, g:-g], b[g:-g, g:-g])
                for a, b in zip(res.carry, base.carry))
        if not same:
            raise AssertionError(f"route {name} differs from {names[0]} at "
                                 f"{test} {n}^2 {dtype}")
    return names


def _timed(torch, test, n, cycles, **route):
    """A warm-up run, then `cycles` timed cycles through `armon()` (f32
    fast math, maxtime=1e30), with the launch counts, host reads, peak
    memory and conservation drift of the timed run. `route` may place a
    mesh (`P`, `devices`)."""
    import numpy as np
    from armon_torch import ArmonParameters, armon
    from armon_torch.ops import sweep as K
    from armon_torch.ops.reductions import conservation_vars, conservation_scalar
    from armon_torch.ops.routing import route as route_of
    opts = dict(test=test, N=(n, n), **SMALL_OPTS, **route)
    armon(ArmonParameters(maxcycle=16, **opts))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = ArmonParameters(maxcycle=cycles, check_result=True,
                             return_data=True, **opts)
    cfg = params.config
    K.reset_launches()
    stats = armon(params)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    st = stats.data
    if stats.cycles != cycles or not np.isfinite(float(st.rho.sum())):
        raise AssertionError(f"{test} {n}^2 {route}: {stats.cycles} cycles")
    m, e = conservation_vars(cfg, st.rho, st.E, cfg.n_global)
    cells = n * n
    return {"test": test, "N": n, "route": route_of(cfg),
            "options": {k: v for k, v in route.items() if k != "devices"},
            "cycles": stats.cycles, "solve_s": stats.solve_time,
            "cells_per_s": cells * stats.cycles / stats.solve_time,
            "grind_ns": stats.solve_time / stats.cycles / cells * 1e9,
            "cycle_ms": stats.solve_time / stats.cycles * 1e3,
            "host_reads": stats.host_reads, "launches": launches,
            "kernel_launches_per_cycle": sum(launches.values()) / stats.cycles,
            "max_memory_allocated": peak,
            "mass_drift": abs(conservation_scalar(cfg, m) - params.initial_mass)
            / params.initial_mass,
            "energy_drift": abs(conservation_scalar(cfg, e) - params.initial_energy)
            / params.initial_energy}, params, stats


def phase4(torch):
    """The small-grid routes: K4/K5 against their plain versions, the
    routes against each other, the goldens, and timed runs of BASELINE
    configs 3 and 1; returns the kernels-line entries of K4 and K5."""
    from armon_torch import ArmonParameters
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.core.state import FusedCarry
    from armon_torch.ops.routing import temporal_pairs
    out = {"phase": 4}
    modes = (("float64", False), ("float32", False), ("float32", True))

    # (a) each kernel against its plain version
    k4 = []
    for test in ("Sod_circ", "Bizarrium"):
        for dtype, fast in modes:
            params, fs, dt = _state_after(torch, test, 1024, dtype, fast, 3)
            for x_first in (True, False):
                err = _k4_vs_plain(torch, params.config, tuple(fs[:4]), dt,
                                   x_first, fast,
                                   f"K4 {test} {dtype} fast={fast} x_first={x_first}")
                k4.append({"test": test, "dtype": dtype, "fast": fast,
                           "x_first": x_first, "max_abs_err": err})
    out["k4_vs_plain"] = k4
    k5 = []
    for test, extra in (("Sod", {}), ("Sod_circ", dict(axis_splitting="Godunov")),
                        ("Sod", dict(maxcycle=13)),
                        ("Sod_circ", dict(dt_on_even_cycles=True)),
                        ("Sod", dict(cst_dt=True, Dt=1e-3))):
        for dtype, fast in modes:
            params = ArmonParameters(test=test, N=(100, 100), data_type=dtype,
                                     use_fast_math=fast, silent=5,
                                     device="cuda", **{"maxcycle": 100, **extra})
            what = f"K5 {test} {extra} {dtype} fast={fast}"
            err, ran = _k5_vs_plain(torch, params, 10, what)
            k5.append({"test": test, "options": extra, "dtype": dtype,
                       "fast": fast, "cycles_run": ran, "max_abs_err": err})
    out["k5_vs_plain"] = k5

    # (b) the routes against each other, exact mode
    out["routes_bitwise"] = [
        {"N": n, "dtype": dtype,
         "routes": _routes_bitwise(torch, "Sod_circ", n, dtype, routes)}
        for n, routes in ((100, (PER_SWEEP, PAIR, {})), (1024, (PER_SWEEP, PAIR)))
        for dtype in ("float64", "float32")]

    # (c) the goldens through the two new routes (per-sweep: phase 2)
    out["goldens"] = {"pair": _goldens(torch, PAIR), "multicycle": _goldens(torch, {})}

    # (d) timed runs through armon()
    runs = []
    sedov, sedov_params, sedov_stats = _timed(torch, "Sedov", SEDOV_N, SEDOV_CYCLES)
    runs.append(sedov)
    runs.append(_timed(torch, "Sedov", SEDOV_N, SEDOV_CYCLES, pair_threshold=0)[0])
    sod, sod_params, sod_stats = _timed(torch, "Sod", SOD_N, SOD_CYCLES)
    runs.append(sod)
    runs.append(_timed(torch, "Sod", SOD_N, SOD_CYCLES, temporal_blocking=1)[0])
    la, lb, lc, ld = (r["launches"] for r in runs)
    if not (la["cycle"] and not la["x_sweep"] and not la["y_sweep"]
            and not la["multicycle"]):
        raise AssertionError(f"Sedov {SEDOV_N}^2 default route: {la}")
    if not (lb["x_sweep"] and lb["y_sweep"] and not lb["cycle"]):
        raise AssertionError(f"Sedov {SEDOV_N}^2 pair_threshold=0: {lb}")
    if not (lc["multicycle"] and not lc["cycle"] and not lc["x_sweep"]):
        raise AssertionError(f"Sod {SOD_N}^2 default route: {lc}")
    if not (ld["cycle"] and ld["cfl_finish"] and not ld["multicycle"]):
        raise AssertionError(f"Sod {SOD_N}^2 temporal_blocking=1: {ld}")
    out["timed"] = runs

    # Kernels at their paths' shapes: checks against the plain versions
    # on each timed run's final state, bit for bit in f32 exact and f64
    # (those max abs differences go to the kernels line) and within the
    # fast-math gate as timed; then times (CUDA events), plain versions'
    # times and bounds. These launches are not counted as the paths'.
    saved = dict(K.LAUNCHES)
    kernels = []

    # K4 at Sedov 2000^2 (Sequential: X then Y, the full dt each).
    cfg = sedov_params.config
    st = sedov_stats.data
    src = (st.rho, st.u, st.v, st.E)
    dev = st.rho.device
    k4_err = 0.0
    for dtype, ecfg in _exact_cfgs("Sedov", (SEDOV_N, SEDOV_N)):
        k4_err = max(k4_err, _k4_vs_plain(
            torch, ecfg, tuple(a.to(getattr(torch, dtype)) for a in src),
            sedov_stats.last_dt, True, False,
            f"K4 at Sedov {SEDOV_N}^2 {dtype} exact", factors=(1.0, 1.0)))
    k4_fast = _k4_vs_plain(torch, cfg, src, sedov_stats.last_dt, True, True,
                           f"K4 at Sedov {SEDOV_N}^2 fast math",
                           factors=(1.0, 1.0))
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(st.rho)
    nb = C.n_partials(st.rho.shape, dev)
    partials = torch.zeros((2, nb), dtype=st.rho.dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = sedov_stats.last_dt
    iscal[K.IS_RUN] = 1
    k4_ms = time_ms(lambda i: C.cycle(cfg, True, 1.0, 1.0, src, dst, p,
                                           partials, scal, iscal, True), k=20)
    dt_t = scal[K.SC_DTUSE]
    k4p_ms = time_ms(lambda i: C.cycle_plain(cfg, True, *src, dt_t, dt_t),
                     k=3)
    fb = st.rho.numel() * st.rho.element_size()
    b_ms, b_by = bound_f32(9 * fb + 2 * nb * st.rho.element_size(),
                          2 * SWEEP_OPS_PER_CELL * st.rho.numel())
    kernels.append({"name": "cycle", "route": "cuda",
                    "source": "armon_torch/csrc/cycle.cuh",
                    "replaces": "armon_tpu/ops/pallas/sweep.py:1571",
                    "launches": la["cycle"], "max_abs_err": k4_err,
                    "ms": k4_ms, "plain_ms": k4p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    # K5 at Sod 100^2, one launch of K cycles from the timed run's final
    # state (maxcycle lifted so every cycle runs).
    params = ArmonParameters(test="Sod", N=(SOD_N, SOD_N), maxcycle=1 << 23,
                             **SMALL_OPTS)
    cfg = params.config
    pairs = temporal_pairs(cfg)
    st = sod_stats.data
    fs = FusedCarry(st.rho, st.u, st.v, st.E, st.p)
    sc = dict(t=sod_stats.final_time, cycle=sod_stats.cycles,
              dt_prev=sod_stats.last_dt, lm=sod_params._final_local_min)
    k5_err = 0.0
    for dtype, ecfg in _exact_cfgs("Sod", (SOD_N, SOD_N), maxcycle=1 << 23):
        tdt = getattr(torch, dtype)
        err, cyc = _k5_check(torch, ecfg, temporal_pairs(ecfg),
                             tuple(a.to(tdt) for a in fs[:4]), fs.p.to(tdt),
                             sc, False, f"K5 at Sod {SOD_N}^2 {dtype} exact")
        if cyc != sod_stats.cycles + len(pairs):
            raise AssertionError(f"K5 {dtype} exact did not run every cycle")
        k5_err = max(k5_err, err)
    k5_fast, cyc = _k5_check(torch, cfg, pairs, tuple(fs[:4]), fs.p, sc, True,
                             f"K5 at Sod {SOD_N}^2 fast math")
    if cyc != sod_stats.cycles + len(pairs):
        raise AssertionError("K5 fast math did not run every cycle")
    a = _k5_inputs(torch, cfg, tuple(fs[:4]), fs.p, sc)
    b = _k5_inputs(torch, cfg, tuple(fs[:4]), fs.p, sc)
    part = C.new_multicycle_partials(st.rho.shape, cfg.dtype, dev)
    k5_ms = time_ms(lambda i: C.multicycle(cfg, pairs, a[0], a[1], a[2],
                                                part, a[3], a[4]), k=20)
    k5p_ms = time_ms(lambda i: C.multicycle_plain(cfg, pairs, len(pairs),
                                                       *b), k=2)
    fb = st.rho.numel() * st.rho.element_size()
    b_ms, b_by = bound_f32(10 * fb, 2 * SWEEP_OPS_PER_CELL * st.rho.numel()
                          * len(pairs))
    kernels.append({"name": "multicycle", "route": "cuda",
                    "source": "armon_torch/csrc/cycle.cuh",
                    "replaces": "armon_tpu/ops/pallas/sweep.py:1905",
                    "launches": lc["multicycle"], "max_abs_err": k5_err,
                    "ms": k5_ms, "plain_ms": k5p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    out["fast_math_max_abs_err"] = {"cycle": k4_fast, "multicycle": k5_fast}
    K.LAUNCHES.update(saved)
    out["kernel_ms"] = {"cycle": k4_ms, "multicycle": k5_ms,
                        "multicycle_per_cycle": k5_ms / len(pairs)}
    emit(out)
    return kernels + [{"sedov_pair_cells_per_s": sedov["cells_per_s"],
                       "sedov_pair_cycle_ms": sedov["solve_s"] / sedov["cycles"] * 1e3,
                       "cycle_ms": k4_ms}]


# ------------------------------------------------------- route crossovers

def _loop_rate(torch, params, loop, cycles):
    """cells/s of `cycles` cycles of a lean loop from the initial state
    (host clock to a host read), after a warm-up on the same shapes."""
    from armon_torch.core.solver import make_init_fused
    [fs], seed = make_init_fused(params)()
    loop(fs, 0.0, 0, 0.0, float(seed))  # warm-up (maxcycle bounds it)
    [fs], seed = make_init_fused(params)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop(fs, 0.0, 0, 0.0, float(seed))
    dt = time.perf_counter() - t0
    n = params.N[0] * params.N[1]
    return n * res.cycles / dt, res.cycles


def _k5_rate(torch, params, pairs):
    """cells/s of K5 launches of len(pairs) cycles from the initial state
    to maxcycle, with one host read of the stop flag per launch as the
    lean loop's multicycle branch makes them, but on any grid whose tiles
    fit co-resident (past the routing's cap); after a warm-up run."""
    from armon_torch.core.solver import make_init_fused
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    cfg = params.config

    def run():
        [fs], seed = make_init_fused(params)()
        cur = tuple(fs[:4])
        nxt = tuple(torch.empty_like(a) for a in cur)
        part = C.new_multicycle_partials(fs.rho.shape, cfg.dtype, fs.rho.device)
        scal, iscal = K.new_scalars(cfg.dtype, fs.rho.device, lm=float(seed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        running = True
        while running:
            C.multicycle(cfg, pairs, cur, nxt, fs.p, part, scal, iscal)
            if len(pairs) % 2:
                cur, nxt = nxt, cur
            running = bool(iscal[K.IS_NEXT].item())
        return time.perf_counter() - t0, int(iscal[K.IS_CYCLE])

    run()
    dt, cycles = run()
    return params.N[0] * params.N[1] * cycles / dt


def phase5(torch):
    """Route crossovers, for retuning `pair_threshold` and
    `temporal_blocking` on this card (no default changes here). Sod f32
    fast math: per-sweep against pair at 256^2-8192^2 (alternating
    per, pair, pair, per), kernel times of K1, K2 and K4 at 8192^2, and
    pair against multicycle (K=8) on small grids, K5 driven past the
    routing's 256 KiB cap up to 360^2, the largest grid whose tiles fit
    co-resident on the H100."""
    from armon_torch import ArmonParameters
    from armon_torch.core.step import make_time_loop_lean
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.utils.enums import Axis
    out = {"phase": 5, "card": card_line()}
    rows = []
    for n in (256, 512, 1024, 2048, 4096, 8192):
        cycles = max(40, min(400, int(4e9 // (n * n))))
        rates = {"per_sweep": [], "pair": []}
        for name in ("per_sweep", "pair", "pair", "per_sweep"):
            route = PER_SWEEP if name == "per_sweep" else \
                dict(pair_threshold=n, temporal_blocking=1)
            params = ArmonParameters(test="Sod", N=(n, n), maxcycle=cycles,
                                     **SMALL_OPTS, **route)
            rates[name].append(_loop_rate(torch, params,
                                          make_time_loop_lean(params.config),
                                          cycles)[0])
        rows.append({"N": n, "cycles": cycles, **rates})
    out["pair_vs_per_sweep"] = rows

    # Kernel times at 8192^2 on one state (CUDA events).
    params = ArmonParameters(test="Sod", N=(8192, 8192), maxcycle=4,
                             **SMALL_OPTS, **PER_SWEEP)
    cfg = params.config
    res = _loop_from_init(params)
    src = tuple(res.carry[:4])
    dev = src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = max(C.n_partials(src[0].shape, dev),
             K.n_partials(Axis.X, src[0].shape, dev),
             K.n_partials(Axis.Y, src[0].shape, dev))
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = res.dt_last
    iscal[K.IS_RUN] = 1
    out["kernel_ms_8192"] = {
        "x_sweep": time_ms(lambda i: K.x_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, False), k=20),
        "y_sweep": time_ms(lambda i: K.y_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, True), k=20),
        "cycle": time_ms(lambda i: C.cycle(
            cfg, True, 1.0, 1.0, src, dst, p, partials, scal, iscal, True),
            k=20)}

    rows = []
    pairs = ((True, 1.0, 1.0),) * 8  # Sequential, K = 8
    for n in (64, 128, 240, 256, 360):
        cycles = 400
        params = ArmonParameters(test="Sod", N=(n, n), maxcycle=cycles,
                                 **SMALL_OPTS, temporal_blocking=1)
        row = {"N": n, "cycles": cycles, "pair": [], "multicycle": []}
        for name in ("pair", "multicycle", "multicycle", "pair"):
            row[name].append(
                _loop_rate(torch, params, make_time_loop_lean(params.config),
                           cycles)[0] if name == "pair"
                else _k5_rate(torch, params, pairs))
        rows.append(row)
    out["multicycle_vs_pair"] = rows
    emit(out)


# ------------------------------------------------- domain-decomposed runs

MESH_N, MESH_P, MESH_CYCLES = 16384, (2, 2), 100  # 8192^2 shards
SEDOV_P = (1, 2)
CHECK_SHARD = 1024   # the slab checks' shard edge
AGREE_N, AGREE_CYCLES, SEDOV_AGREE_CYCLES = 1000, 20, 50


def _one_card(P):
    """Options that place every shard of a P mesh on cuda:0."""
    return dict(P=P, devices=["cuda:0"] * (P[0] * P[1]))


def _mesh_mid_state(torch, test, N, P, dtype, fast, cycles=3, **route):
    """A one-card mesh after `cycles` cycles: (cfg, mesh, result, the dt
    of the next cycle)."""
    import numpy as np
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused, make_mesh
    from armon_torch.core.step import make_time_loop_lean
    params = ArmonParameters(test=test, N=N, data_type=dtype,
                             use_fast_math=fast, maxcycle=cycles, silent=5,
                             **_one_card(P), **route)
    cfg = params.config
    mesh = make_mesh(params)
    fs, seed = make_init_fused(params)()
    res = make_time_loop_lean(cfg, mesh)(fs, 0.0, 0, 0.0, float(seed))
    T = np.dtype(dtype).type
    dt = min(T(cfg.cfl) * T(res.lm), T(1.05) * T(res.dt_last))
    return cfg, mesh, res, float(dt)


def _gate_mesh(torch, got, want, real, fast, what):
    """Per field, every shard's real cells: bit for bit in exact mode,
    within 1e-4 of the field's scale over the whole mesh in fast math.
    Returns the max abs difference."""
    err = 0.0
    for k in range(len(got[0])):
        scale = max(float(b[k][r].abs().max()) for b, r in zip(want, real))
        for a, b, r in zip(got, want, real):
            d = float((a[k][r] - b[k][r]).abs().max())
            err = max(err, d)
            ok = d <= 1e-4 * scale if fast else torch.equal(a[k][r], b[k][r])
            if not ok:
                raise AssertionError(f"{what}: field {k} max abs diff {d}")
    return err


def _cfl_gate(part, want, fast, what):
    got = float(part.max())
    if abs(got - float(want)) > (1e-4 * float(want) if fast else 0.0):
        raise AssertionError(f"{what}: CFL max {got} vs {float(want)}")


def _slab_sweep_checks(torch, cfg, mesh, cur, dt, fast, what, shards=None):
    """K1 with X slabs and K2 with Y slabs (the neighbours' real lines on
    the sides that face one, the mirror on global borders) on each of
    `shards` (every shard of `mesh` by default), against `sweep_plain`
    with the same ghosts: fields, p and the CFL partial maxima. `cur[s]`
    is shard s's (rho, u, v, E). Returns the max abs difference per axis
    name."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops.reductions import real_slice
    from armon_torch.parallel.halo import halo_slabs
    from armon_torch.utils.enums import Axis
    err = {}
    for axis, sweep in ((Axis.X, K.x_sweep), (Axis.Y, K.y_sweep)):
        ghosts = halo_slabs(cfg, mesh, cur, axis)
        got, want, real = [], [], []
        for s in shards or mesh:
            src = cur[s.index]
            dev = src[0].device
            dst = tuple(torch.empty_like(a) for a in src)
            p = torch.empty_like(src[0])
            nb = K.n_partials(axis, src[0].shape, dev)
            partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
            scal, iscal = K.new_scalars(cfg.dtype, dev)
            scal[K.SC_DTUSE] = dt
            iscal[K.IS_RUN] = 1
            sweep(cfg, src, dst, p, partials, scal, iscal, 1.0, True,
                  ghosts[s.index], s.n_real)
            ref = K.sweep_plain(cfg, axis, *src, scal[K.SC_DTUSE] * 1.0,
                                ghosts[s.index], s.n_real)
            mx, my = K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5], s.n_real)
            torch.cuda.synchronize()
            _cfl_gate(partials[0], mx, fast, f"{what} {axis.name} {s}")
            _cfl_gate(partials[1], my, fast, f"{what} {axis.name} {s}")
            got.append(dst + (p,))
            want.append(ref[:5])
            real.append(real_slice(cfg, s.n_real))
        err[axis.name] = _gate_mesh(torch, got, want, real, fast,
                                    f"{what} {axis.name}")
    return err


def _slab_cycle_checks(torch, cfg, mesh, cur, dt, fast, what, shards=None,
                       factors=(0.5, 1.0)):
    """K4 with Y slabs and the X mirror after the splice, both sweep
    orders (`factors`: the dt factors of the first and the second sweep,
    Strang's by default), on each of `shards` (every shard by default)
    against `cycle_plain` with the same ghosts. Its first sweep runs on the
    ghost rows, so the corner cells (f_x times a neighbour's value) reach
    real cells here. Returns the max abs difference."""
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.ops.reductions import real_slice
    from armon_torch.parallel.halo import halo_slabs
    from armon_torch.utils.enums import Axis
    ghosts = halo_slabs(cfg, mesh, cur, Axis.Y)
    err = 0.0
    for x_first in (True, False):
        fx, fy = factors if x_first else factors[::-1]
        got, want, real = [], [], []
        for s in shards or mesh:
            src = cur[s.index]
            dev = src[0].device
            dst = tuple(torch.empty_like(a) for a in src)
            p = torch.empty_like(src[0])
            nb = C.n_partials(src[0].shape, dev)
            partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
            scal, iscal = K.new_scalars(cfg.dtype, dev)
            scal[K.SC_DTUSE] = dt
            iscal[K.IS_RUN] = 1
            C.cycle(cfg, x_first, fx, fy, src, dst, p, partials, scal, iscal,
                    True, ghosts[s.index], s.n_real)
            dt_t = scal[K.SC_DTUSE]
            ref = C.cycle_plain(cfg, x_first, *src, dt_t * fx, dt_t * fy,
                                ghosts[s.index], s.n_real)
            torch.cuda.synchronize()
            _cfl_gate(partials[0], ref[5], fast, f"{what} {s}")
            _cfl_gate(partials[1], ref[6], fast, f"{what} {s}")
            got.append(dst + (p,))
            want.append(ref[:5])
            real.append(real_slice(cfg, s.n_real))
        err = max(err, _gate_mesh(torch, got, want, real, fast,
                                  f"{what} x_first={x_first}"))
    return err


def _mesh_vs_single(torch, test, N, P, dtype, cycles, single, devices=None,
                    **route):
    """`armon()` on a mesh (one card unless `devices`) against the
    one-device run `single` (a SolverStats with data): dt, t, cycles and
    rho/u/v/E/p on real cells, bit for bit."""
    from armon_torch import ArmonParameters, armon
    place = _one_card(P) if devices is None else dict(P=P, devices=devices)
    stats = armon(ArmonParameters(
        test=test, N=N, data_type=dtype, use_fast_math=False,
        maxcycle=cycles, silent=5, return_data=True, **place, **route))
    same = (stats.cycles, stats.final_time, stats.last_dt) == \
        (single.cycles, single.final_time, single.last_dt)
    g = 4
    for name in ("rho", "u", "v", "E", "p"):
        a = getattr(stats.data, name)[g:-g, g:-g]
        b = getattr(single.data, name)[g:-g, g:-g].to(a.device)
        same = same and torch.equal(a, b)
    if not same:
        raise AssertionError(f"mesh {P} {test} {N} {dtype} {route} differs "
                             f"from one device: {stats.cycles} cycles, dt "
                             f"{stats.last_dt} vs {single.last_dt}")
    return {"test": test, "N": list(N), "P": list(P), "dtype": dtype,
            "cycles": stats.cycles, "dt": stats.last_dt, **route}


def _single(torch, test, N, dtype, cycles, **route):
    from armon_torch import ArmonParameters, armon
    return armon(ArmonParameters(test=test, N=N, data_type=dtype,
                                 use_fast_math=False, maxcycle=cycles,
                                 silent=5, return_data=True, device="cuda",
                                 **route))


def _slab_pack_count(mesh, axis):
    """Slab buffers refilled per sweep along `axis` (one per side that
    faces a neighbour)."""
    return sum(mesh.neighbour(s, axis, side) is not None
               for s in mesh for side in (0, 1))


def phase7(torch, rates):
    """Domain-decomposed runs on one card (see the module doc); returns
    the kernels-line entries of the three slab variants."""
    from armon_torch.core.state import FusedCarry
    from armon_torch.core.solver import make_mesh
    from armon_torch.interop import scatter_state
    from armon_torch.ops import sweep as K
    from armon_torch.ops import cycle as C
    from armon_torch.ops.routing import route as route_of
    from armon_torch.parallel.halo import halo_slabs, new_slab_buffers
    from armon_torch.utils.enums import Axis
    out = {"phase": 7, "card": card_line()}
    modes = (("float64", False), ("float32", False), ("float32", True))

    # (1) the slab variants against their plain versions, 1024^2 shards
    checks = []
    for test in ("Sod_circ", "Bizarrium"):
        for dtype, fast in modes:
            n = 3 * CHECK_SHARD
            cfg, mesh, res, dt = _mesh_mid_state(torch, test, (n, n),
                                                 (3, 3), dtype, fast)
            e1 = _slab_sweep_checks(torch, cfg, mesh,
                                    [tuple(c[:4]) for c in res.carry], dt,
                                    fast, f"K1/K2 slab {test} {dtype} fast={fast}")
            cfg, mesh, res, dt = _mesh_mid_state(torch, test, (CHECK_SHARD, n),
                                                 (1, 3), dtype, fast,
                                                 temporal_blocking=1)
            if route_of(cfg) != "pair":
                raise AssertionError("the 1x3 mesh left the pair route")
            e4 = _slab_cycle_checks(torch, cfg, mesh,
                                    [tuple(c[:4]) for c in res.carry], dt,
                                    fast, f"K4 slab {test} {dtype} fast={fast}")
            checks.append({"test": test, "dtype": dtype, "fast": fast,
                           "sweeps_max_abs_err": e1, "cycle_max_abs_err": e4})
    out["slab_vs_plain"] = checks
    emit(out)

    # (2) meshes against the one-device run, bit for bit, exact mode
    agree = []
    for dtype in ("float64", "float32"):
        n = AGREE_N
        for N, meshes in (((n, n), ((2, 2), (1, 2), (2, 1), (4, 1), (3, 2))),
                          ((n, n - 1), ((3, 2),))):
            single = _single(torch, "Sod_circ", N, dtype, AGREE_CYCLES)
            for P in meshes:
                agree.append(_mesh_vs_single(torch, "Sod_circ", N, P, dtype,
                                             AGREE_CYCLES, single))
        N = (SEDOV_N, SEDOV_N)
        single = _single(torch, "Sedov", N, dtype, SEDOV_AGREE_CYCLES)
        agree.append(_mesh_vs_single(torch, "Sedov", N, SEDOV_P, dtype,
                                     SEDOV_AGREE_CYCLES, single))
    out = {"phase": 7, "mesh_vs_single": agree}

    # (3) the goldens through a 2x2 mesh
    out["goldens_2x2"] = _goldens(torch, _one_card((2, 2)))
    emit(out)

    # (4) timed runs. On each one's final state, at the timed shapes, every
    # slab kernel against its plain version on the first shard (slabs on
    # its high sides) and the last (slabs on its low sides): bit for bit in
    # f32 exact and f64 (those max abs differences go to the kernels line),
    # within the fast-math gate as timed. These launches, and the timing
    # ones, are not counted as the path's.
    sod, params, stats = _timed(torch, "Sod", MESH_N, MESH_CYCLES,
                                **_one_card(MESH_P))
    for name in ("x_sweep_slab", "y_sweep_slab", "cfl_finish"):
        if not sod["launches"][name]:
            raise AssertionError(f"the 2x2 mesh never launched {name}")
    cfg = params.config
    mesh = make_mesh(params)
    st = stats.data
    cur = [tuple(c[:4]) for c in
           scatter_state(params, FusedCarry(st.rho, st.u, st.v, st.E, st.p))]
    last_dt = stats.last_dt
    del st, stats
    ends = (mesh.shards[0], mesh.shards[-1])
    s0 = mesh.shards[0]  # a slab on its high sides, the mirror on its low ones
    src = cur[0]
    shape, dev = src[0].shape, src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nbx, nby = K.n_partials(Axis.X, shape, dev), K.n_partials(Axis.Y, shape, dev)
    partials = torch.zeros((2, len(mesh) * max(nbx, nby)), dtype=src[0].dtype,
                           device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = last_dt
    iscal[K.IS_RUN] = 1
    bufs = {a: new_slab_buffers(cfg, mesh, cur, a) for a in (Axis.X, Axis.Y)}
    gx = halo_slabs(cfg, mesh, cur, Axis.X, bufs[Axis.X])[0]
    gy = halo_slabs(cfg, mesh, cur, Axis.Y, bufs[Axis.Y])[0]
    saved = dict(K.LAUNCHES)
    ms = {
        "x_sweep_slab": time_ms(lambda i: K.x_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, False, gx, s0.n_real),
            k=20),
        "y_sweep_slab": time_ms(lambda i: K.y_sweep(
            cfg, src, dst, p, partials, scal, iscal, 1.0, True, gy, s0.n_real),
            k=20)}
    s2, i2 = scal.clone(), iscal.clone()
    ms["cfl_finish_4_shards"] = time_ms(lambda i: K.cfl_finish(
        cfg, partials, len(mesh) * nby, s2, i2), k=50)
    ms["slab_copies_per_cycle"] = time_ms(lambda i: (
        halo_slabs(cfg, mesh, cur, Axis.X, bufs[Axis.X]),
        halo_slabs(cfg, mesh, cur, Axis.Y, bufs[Axis.Y])), k=20)
    dt_t = scal[K.SC_DTUSE] * 1.0
    plain = {"x_sweep_slab": time_ms(lambda i: K.sweep_plain(
                 cfg, Axis.X, *src, dt_t, gx, s0.n_real), k=3),
             "y_sweep_slab": time_ms(lambda i: K.sweep_plain(
                 cfg, Axis.Y, *src, dt_t, gy, s0.n_real), k=3)}
    del dst, p, partials, bufs, gx, gy
    sweep_err = {"X": 0.0, "Y": 0.0}
    for dtype, ecfg in _exact_cfgs("Sod", (MESH_N, MESH_N), **_one_card(MESH_P)):
        tdt = getattr(torch, dtype)
        e = _slab_sweep_checks(
            torch, ecfg, mesh, [tuple(a.to(tdt) for a in c) for c in cur],
            last_dt, False, f"K1/K2 slab at Sod {MESH_N}^2 {dtype} exact", ends)
        sweep_err = {k: max(sweep_err[k], e[k]) for k in e}
    sod["slab_vs_plain"] = {
        "shards": [s.index for s in ends], "exact_max_abs_err": sweep_err,
        "fast_math_max_abs_err": _slab_sweep_checks(
            torch, cfg, mesh, cur, last_dt, True,
            f"K1/K2 slab at Sod {MESH_N}^2 fast math", ends)}
    K.LAUNCHES.update(saved)
    sod["kernel_ms_per_shard"] = ms
    sod["slab_packs_per_cycle"] = sum(_slab_pack_count(mesh, a)
                                      for a in (Axis.X, Axis.Y))
    sod["single_device_8192_cells_per_s"] = rates.get("main", {}).get("cells_per_s")
    fb = src[0].numel() * src[0].element_size()
    rows, cols = shape
    g = cfg.nghost
    isz = src[0].element_size()
    ops = SWEEP_OPS_PER_CELL * src[0].numel()
    kernels = []
    for name, replaces, nbytes, err in (
            ("x_sweep_slab", "armon_tpu/ops/pallas/sweep.py:1008", 8 * fb
             + 4 * rows * g * isz, sweep_err["X"]),
            ("y_sweep_slab", "armon_tpu/ops/pallas/sweep.py:1118", 9 * fb
             + 4 * g * cols * isz + 2 * nby * isz, sweep_err["Y"])):
        b_ms, b_by = bound_f32(nbytes, ops)
        kernels.append({"name": name, "route": "cuda",
                        "source": "armon_torch/csrc/sweep.cuh",
                        "replaces": replaces, "launches": sod["launches"][name],
                        "max_abs_err": err, "ms": ms[name],
                        "plain_ms": plain[name], "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    del cur, src
    emit({"phase": 7, "timed_main_mesh": sod})

    sedov, params, stats = _timed(torch, "Sedov", SEDOV_N, SEDOV_CYCLES,
                                  **_one_card(SEDOV_P))
    if sedov["route"] != "pair" or not sedov["launches"]["cycle_slab"]:
        raise AssertionError(f"Sedov over {SEDOV_P}: {sedov['launches']}")
    cfg = params.config
    mesh = make_mesh(params)
    st = stats.data
    cur = [tuple(c[:4]) for c in
           scatter_state(params, FusedCarry(st.rho, st.u, st.v, st.E, st.p))]
    src = cur[0]
    dev = src[0].device
    ghosts = halo_slabs(cfg, mesh, cur, Axis.Y)[0]
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = C.n_partials(src[0].shape, dev)
    partials = torch.zeros((2, nb), dtype=src[0].dtype, device=dev)
    scal, iscal = K.new_scalars(cfg.dtype, dev)
    scal[K.SC_DTUSE] = stats.last_dt
    iscal[K.IS_RUN] = 1
    saved = dict(K.LAUNCHES)
    k4_ms = time_ms(lambda i: C.cycle(cfg, True, 1.0, 1.0, src, dst, p,
                                           partials, scal, iscal, True,
                                           ghosts, mesh.shards[0].n_real),
                    k=20)
    dt_t = scal[K.SC_DTUSE]
    k4p_ms = time_ms(lambda i: C.cycle_plain(cfg, True, *src, dt_t, dt_t,
                                                  ghosts, mesh.shards[0].n_real),
                     k=3)
    ends = (mesh.shards[0], mesh.shards[-1])  # Y slabs above, below
    cycle_err = 0.0
    for dtype, ecfg in _exact_cfgs("Sedov", (SEDOV_N, SEDOV_N), **_one_card(SEDOV_P)):
        tdt = getattr(torch, dtype)
        cycle_err = max(cycle_err, _slab_cycle_checks(
            torch, ecfg, mesh, [tuple(a.to(tdt) for a in c) for c in cur],
            stats.last_dt, False, f"K4 slab at Sedov {SEDOV_N}^2 {dtype} exact",
            ends, factors=(1.0, 1.0)))
    sedov["slab_vs_plain"] = {
        "shards": [s.index for s in ends], "exact_max_abs_err": cycle_err,
        "fast_math_max_abs_err": _slab_cycle_checks(
            torch, cfg, mesh, cur, stats.last_dt, True,
            f"K4 slab at Sedov {SEDOV_N}^2 fast math", ends, factors=(1.0, 1.0))}
    K.LAUNCHES.update(saved)
    sedov["kernel_ms_per_shard"] = {"cycle_slab": k4_ms}
    sedov["slab_packs_per_cycle"] = _slab_pack_count(mesh, Axis.Y)
    sedov["single_device"] = rates.get("small")
    emit({"phase": 7, "timed_sedov_mesh": sedov})
    fb = src[0].numel() * src[0].element_size()
    b_ms, b_by = bound_f32(9 * fb + 4 * cfg.nghost * src[0].shape[1]
                          * src[0].element_size() + 2 * nb * src[0].element_size(),
                          2 * SWEEP_OPS_PER_CELL * src[0].numel())
    kernels.append({"name": "cycle_slab", "route": "cuda",
                    "source": "armon_torch/csrc/cycle.cuh",
                    "replaces": "armon_tpu/ops/pallas/sweep.py:1592",
                    "launches": sedov["launches"]["cycle_slab"],
                    "max_abs_err": cycle_err, "ms": k4_ms, "plain_ms": k4p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "corner_cells_checked": "both shards of the timed 1x2 "
                                            "mesh and a 1x3 mesh of 1024^2 "
                                            "shards: Y slabs, X mirror after "
                                            "the splice, both sweep orders"})

    # (5) four cards, where the machine has them
    if torch.cuda.device_count() >= 4:
        four = []
        N = (AGREE_N, AGREE_N)
        for dtype in ("float64", "float32"):
            single = _single(torch, "Sod_circ", N, dtype, AGREE_CYCLES)
            four.append(_mesh_vs_single(
                torch, "Sod_circ", N, (2, 2), dtype, AGREE_CYCLES, single,
                devices=[f"cuda:{i}" for i in range(4)]))
        emit({"phase": 7, "four_cards": four})
    else:
        emit({"phase": 7, "four_cards": "not run: the machine has "
                                        f"{torch.cuda.device_count()} card(s)"})
    return kernels


# --------------------------------------------------------------- probes

def phase8(torch):
    """The probes (see the module doc); returns their kernels-line
    entries. Each probe's counts are set to 0 just before its entry point
    runs and read just after; its checks against the plain versions do
    not count."""
    from armon_torch import probes
    from armon_torch.probes import flip, ff, roofline_io, roofline, cycle_variants
    kernels, launches = [], {}
    for mod in (flip, ff, roofline_io, roofline, cycle_variants):
        probes.reset_launches()
        res = mod.run("cuda")
        torch.cuda.synchronize()
        counted = dict(probes.LAUNCHES)
        errs = mod.check("cuda")
        probes.reset_launches()
        probes.LAUNCHES.update(counted)
        entries = mod.entries(res, errs)
        for e in entries:
            if not e["launches"]:
                raise AssertionError(f"probe {mod.__name__} never launched {e['name']}")
        kernels += entries
        launches.update(counted)
    emit({"phase": 8, "card": card_line(), "launches": launches,
          "max_abs_err": {e["name"]: e["max_abs_err"] for e in kernels}})
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4,6,7,8",
                    help="comma-separated phases to run (default: all but "
                         "the crossovers, 5)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}

    if not os.path.isdir(os.path.join(HERE, "armon_torch")):
        print("chip_smoke: the armon_torch package is not next to this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if 0 in phases:
        phase0(torch)
    if 1 in phases:
        phase1(torch)
    if 2 in phases:
        phase2(torch)
    kernels = phase3(torch) if 3 in phases else []
    rates = {"main": kernels.pop()} if kernels else {}
    if 4 in phases:
        k4 = phase4(torch)
        rates["small"] = k4.pop()
        kernels += k4
    if 5 in phases:
        phase5(torch)
    if 7 in phases:
        kernels += phase7(torch, rates)
    if 8 in phases:
        kernels += phase8(torch)
    if 6 in phases and kernels:
        print(card_line())
        emit({"kernels": kernels})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
