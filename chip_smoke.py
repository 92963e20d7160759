#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`armon_torch`) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases 0,1    # a subset (build + kernel checks)

Phases, each printing one JSON line:
  0. the card (nvidia-smi name and power limit) and the kernels' build time;
  1. each kernel against its plain PyTorch version on the card, one X and
     one Y sweep at 1024^2 after a few cycles, on Sod_circ and Bizarrium,
     in f64, f32 exact and f32 fast math, plus the CFL minimum via K3;
  2. the Julia goldens (Sod, Sod_y, Sod_circ at 100^2) through the kernels:
     zero differences in f64 and f32 exact; the f32 fast-math count is
     reported;
  3. the main path: Sod 8192^2 f32 fast math (GAD/minmod/euler_2nd, nghost
     4, Sequential), one warm-up run then 100 timed cycles through
     `armon()`, with launch counts, kernel times from CUDA events, host
     reads, conservation drift and peak memory; then every kernel against
     its plain version at the main path's shapes;
  4. the per-kernel summary line.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it. Without a CUDA card, or without the `armon_torch` package next
to this file, it exits non-zero at once. It imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_DIR = os.path.join(HERE, "tests", "reference_data")

# H100 SXM data-sheet peaks (dense, no sparsity), for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Floating-point operations per cell of one sweep, counted from the device
# body in csrc/sweep.cuh (GAD + minmod + euler_2nd, perfect gas; a divide
# or a square root counts as one): EOS 12, Riemann solve and theta 26,
# limiter blend 26, Lagrangian update 19, slopes 46, advection 14,
# projection 19.
SWEEP_FLOPS_PER_CELL = 162

MAIN_N = 8192
MAIN_CYCLES = 100


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10):
    """CUDA-event time of `fn` per call over `reps` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase0(torch):
    from armon_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = {src: [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln][:8]
            for src, log in _build.BUILD_INFO["logs"].items()}
    emit({"phase": 0, "card": card_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": regs})


def _state_after(torch, test, n, dtype, fast, cycles):
    """The port's carry after `cycles` cycles (through the kernels) and the
    dt of the next cycle."""
    from armon_torch import ArmonParameters
    from armon_torch.core.solver import make_init_fused
    from armon_torch.core.step import make_time_loop_lean
    params = ArmonParameters(test=test, N=(n, n), data_type=dtype,
                             use_fast_math=fast, maxcycle=cycles, silent=5,
                             device="cuda")
    cfg = params.config
    fs, seed = make_init_fused(params)()
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


def phase2(torch):
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
                return_data=True, use_fast_math=fast, device="cuda")
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
                raise AssertionError(f"golden {test} {dtype}: {rows[-1]}")
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
    flops = SWEEP_FLOPS_PER_CELL * st.rho.numel()
    peak_flops = PEAK_FLOPS["float32"]

    def bound(nbytes, nflops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = nflops / peak_flops * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    saved = dict(K.LAUNCHES)
    x_ms = time_ms(torch, lambda: K.x_sweep(cfg, fs_src, dst, p, partials, scal,
                                      iscal, 1.0, False), reps=20)
    y_ms = time_ms(torch, lambda: K.y_sweep(cfg, fs_src, dst, p, partials, scal,
                                      iscal, 1.0, True), reps=20)
    s2, i2 = scal.clone(), iscal.clone()  # K3 advances its own scalars
    k3_ms = time_ms(torch, lambda: K.cfl_finish(cfg, partials, nby, s2, i2),
                    reps=50)
    dt_t = scal[K.SC_DTUSE] * 1.0
    xp_ms = time_ms(torch, lambda: K.sweep_plain(cfg, Axis.X, *fs_src, dt_t), reps=3)
    yp_ms = time_ms(torch, lambda: K.sweep_plain(cfg, Axis.Y, *fs_src, dt_t), reps=3)
    k3p_ms = time_ms(torch, lambda: K.cfl_finish_plain(cfg, partials, nby, s2.clone(),
                                                 i2.clone()), reps=20)
    amax_ms = time_ms(torch, lambda: torch.amax(partials[:, :nby], dim=1), reps=50)

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
    for name, src_file, replaces, ms, pms, nbytes, nflops, lib, diffs in (
            ("x_sweep", "armon_torch/csrc/sweep.cuh",
             "armon_tpu/ops/pallas/sweep.py:978", x_ms, xp_ms,
             8 * field_bytes, flops, None, checks["X"]["fields"]),
            ("y_sweep", "armon_torch/csrc/sweep.cuh",
             "armon_tpu/ops/pallas/sweep.py:1092", y_ms, yp_ms,
             9 * field_bytes + part_bytes, flops, None, checks["Y"]["fields"]),
            ("cfl_finish", "armon_torch/csrc/cfl.cu",
             "armon_tpu/ops/pallas/sweep.py:968", k3_ms, k3p_ms,
             part_bytes + 64, 4 * nby, amax_ms, None)):
        b_ms, b_by = bound(nbytes, nflops)
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
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma-separated phases to run (default: all)")
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
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    if 0 in phases:
        phase0(torch)
    if 1 in phases:
        phase1(torch)
    if 2 in phases:
        phase2(torch)
    kernels = phase3(torch) if 3 in phases else None
    if 4 in phases and kernels is not None:
        print(card_line())
        emit({"kernels": kernels})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
