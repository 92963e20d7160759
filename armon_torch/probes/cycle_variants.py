"""The K4 attribution probe, counterpart of `scripts/perf_probe.py`.

    python -m armon_torch.probes.cycle_variants            # on the card
    python -m armon_torch.probes.cycle_variants --device cpu --sizes 32

K4 (`cycle`, csrc/cycle.cuh) with parts taken out, each variant the same
template with one compile-time switch (csrc/probe_cycle.cu), timed at
Sod 4096^2 and 8192^2 f32 as the script times its variants (:203):

    base         K4 as the solver runs it
    no_p         the stale p not written
    no_dt        no CFL partials (and no sound speed formed for them)
    no_p_dt      both
    no_roll      every shifted read replaced by a * (1 + 1e-7 k), no
                 shuffle and no shared-memory exchange: wrong numerics by
                 design
    stream       K4's loads, windows, passes and stores, trivial math
    first_order  base with Godunov + euler (runtime arguments)
    base_w128    base on 96 x 128 windows (88 x 120 tiles, 1.115x the
                 cells covered against base's 1.195x) at one block of 16
                 warps per SM against base's two: recompute against
                 resident warps
    base_l32     K5's tile body (`cycle_tile`, one thread per position,
                 shared-memory shifts) on 32 x 32 windows (24 x 24
                 tiles), run as a one-cycle kernel: K4's redesigned body
                 has no 32-wide form, so this is the old body and its
                 halo recompute, in place of the script's chunk=K

Each prints ms, cells/s, effective GB/s at 36 B/cell (32 without p) and
its share of `base`. Inputs are the script's random fields (:218-221),
dt = 1e-5 on both sweeps, X first.
"""

import argparse

import numpy as np
import torch

from . import LAUNCHES, count
from .._card import (bound, card_line, device_of, emit, kernel_entry, shown,
                     time_ms)
from ..ops.sweep import (fill_ghosts_plain, fold_on, sweep_math_plain,
                         sweep_plain, cfl_partial_plain, new_scalars, SC_DTUSE,
                         IS_RUN)
from ..ops.cycle import cycle_plain, tile_grid, CYCLE_WINDOW, BASE_TILE
from ..ops.eos import fold_const, scalar_like
from ..ops.reductions import real_slice
from ..utils.enums import Axis

# name: (CycleVariant code, window: K4's f32 (columns, rows), or the edge
# of the per-position tile body's square one); first_order is base with
# its own config.
K4_WINDOW = CYCLE_WINDOW[4]
VARIANTS = {"base": (0, K4_WINDOW), "no_p": (1, K4_WINDOW),
            "no_dt": (2, K4_WINDOW), "no_p_dt": (3, K4_WINDOW),
            "no_roll": (4, K4_WINDOW), "stream": (5, K4_WINDOW),
            "first_order": (0, K4_WINDOW), "base_w128": (0, (96, 128)),
            "base_l32": (0, BASE_TILE)}
WRITES_P = {n: n not in ("no_p", "no_p_dt") for n in VARIANTS}
EMITS_DT = {n: n not in ("no_dt", "no_p_dt", "stream") for n in VARIANTS}
SOURCE = "armon_torch/csrc/probe_cycle.cu"
REPLACES = "scripts/perf_probe.py:158"
DT = 1e-5  # perf_probe.py:174
# Exact-mode gate of no_roll: the kernel's k-1 flux reads dt * (ustar *
# f) where the plain version scales disp = dt * ustar, a rounding apart.
NO_ROLL_REL = 1e-5
FAST_REL = 1e-4  # approximate reciprocals against exact divides


def configs(n, fast, device):
    """(GAD + minmod + euler_2nd config, Godunov + euler config), Sod f32."""
    from .. import ArmonParameters
    common = dict(test="Sod", N=(n, n), data_type="float32", nghost=4,
                  use_fast_math=fast, maxcycle=1, silent=5,
                  measure_time=False, device=str(device))
    return (ArmonParameters(scheme="GAD", projection="euler_2nd",
                            riemann_limiter="minmod", **common).config,
            ArmonParameters(scheme="Godunov", projection="euler", **common).config)


def random_fields(cfg, seed, device):
    """The script's fields over the padded block: rho in [0.5, 2), u and
    v in [-0.1, 0.1), E in [1, 3), f32."""
    rng = np.random.default_rng(seed)
    shape = cfg.local_shape
    return tuple(torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
                 .to(device) for lo, hi in ((0.5, 2.0), (-0.1, 0.1),
                                            (-0.1, 0.1), (1.0, 3.0)))


def variant_plain(name, cfg, src, dt):
    """The variant's function in plain PyTorch (X first, dt on both
    sweeps): (rho, u, v, E, p or None, (max |u|+c, max |v|+c) or None).
    K4's variants take the cross-sweep EOS fold between their sweeps
    where the mode does (`ops/sweep.fold_on`); the per-position tile body
    (`base_l32`) takes none."""
    fold = fold_on(cfg, src[0].device)
    if name in ("no_roll", "stream", "base_l32"):
        f = fill_ghosts_plain(cfg, Axis.X, fill_ghosts_plain(cfg, Axis.Y, src))
        if name == "base_l32":
            o = sweep_plain(cfg, Axis.X, *f, dt, (None, None))
            o = sweep_plain(cfg, Axis.Y, *o[:4], dt, (None, None))
            return o[:5] + (cfl_partial_plain(cfg, o[1], o[2], o[5]),)
        if name == "stream":
            return tuple(f) + (((f[0] + f[1]) + f[2]) + f[3], None)
        T = np.float32

        def sh(a, k):
            return a * (1 + 1e-7 * k) if k else a

        r1, u1, v1, E1, _, _ = sweep_math_plain(
            cfg, sh, dt, scalar_like(src[0], T(cfg.dx)), *f, keep=fold)
        r2, v2, u2, E2, p, c = sweep_math_plain(
            cfg, sh, dt, scalar_like(src[0], T(cfg.dy)), r1, v1, u1, E1,
            along_y=True, fold_in=fold_const(cfg, Axis.X) if fold else None)
        return r2, u2, v2, E2, p, cfl_partial_plain(cfg, u2, v2, c)
    out = cycle_plain(cfg, True, *src, dt, dt)
    return out[:4] + (out[4] if WRITES_P[name] else None,
                      out[5:] if EMITS_DT[name] else None)


def new_partials(name, shape, device):
    gx, gy = tile_grid(VARIANTS[name][1], shape)
    return torch.zeros((2, gx * gy), dtype=torch.float32, device=device)


def cycle_variant(name, cfg, src, dst, p, partials, scal, iscal):
    """One launch of variant `name` (`cfg` carries its scheme): `src` into
    `dst`, p and the CFL partials as the variant writes them, dt =
    scal[dt_use] on both sweeps, X first. The plain version on the
    CPU."""
    if src[0].device.type == "cpu":
        out = variant_plain(name, cfg, src, scal[SC_DTUSE])
        for d, o in zip(dst, out[:4]):
            d.copy_(o)
        if out[4] is not None:
            p.copy_(out[4])
        if out[5] is not None:
            partials[0, 0], partials[1, 0] = out[5]
        return
    from ..ops import _build
    from ..ops.sweep import _check
    _check(cfg, tuple(src) + tuple(dst) + (p,), src[0].shape, src[0].device)
    code, tile = VARIANTS[name]
    _build.launch_cycle_variant(cfg, code, tile, True, 1.0, 1.0, src, dst, p,
                                partials, scal, iscal)
    count(f"cycle_{name}")


def _operands(cfg, src, name):
    dev = src[0].device
    scal, iscal = new_scalars(cfg.dtype, dev)
    scal[SC_DTUSE] = DT
    iscal[IS_RUN] = 1
    return (tuple(torch.empty_like(a) for a in src), torch.empty_like(src[0]),
            new_partials(name, src[0].shape, dev), scal, iscal)


def run(device="cuda", sizes=(4096, 8192), fast=True, seed=0, k=20):
    """Time every variant at each size; prints and returns one row per
    size."""
    dev = device_of(device)
    rows = []
    for n in sizes:
        cfg, cfg_god = configs(n, fast, dev)
        src = random_fields(cfg, seed, dev)
        cells = src[0].numel()
        row = {"probe": "cycle_variants", "n": n, "fast_math": fast, "ms": {},
               "plain_ms": {}, "cells_per_s": {}, "gb_per_s": {}, "share": {},
               "bound_ms": {}, "bound_by": {}}
        for name in VARIANTS:
            c = cfg_god if name == "first_order" else cfg
            dst, p, part, scal, iscal = _operands(c, src, name)
            ms = time_ms(lambda i: cycle_variant(name, c, src, dst, p, part,
                                                 scal, iscal), dev, k)
            dt = scal[SC_DTUSE]
            row["plain_ms"][name] = shown(time_ms(
                lambda i: variant_plain(name, c, src, dt), dev, 1))
            nbytes = (36 if WRITES_P[name] else 32) * cells
            row["ms"][name] = shown(ms)
            row["cells_per_s"][name] = shown(None if ms is None else n * n / ms * 1e3)
            row["gb_per_s"][name] = shown(None if ms is None else nbytes / ms / 1e6)
            row["bound_ms"][name], row["bound_by"][name] = bound(nbytes)
        if dev.type == "cuda":
            base = row["ms"]["base"]
            row["share"] = {nm: v / base for nm, v in row["ms"].items()}
            from ..ops import cycle as C
            dst, p, part, scal, iscal = _operands(cfg, src, "base")
            row["k4_production_ms"] = time_ms(lambda i: C.cycle(
                cfg, True, 1.0, 1.0, src, dst, p, part, scal, iscal, True), dev, k)
            row["card"] = card_line()
        emit(row)
        rows.append(row)
        del src
    return rows


def check(device="cuda", sizes=(4096, 8192, 1024), seed=2):
    """Every variant against its plain version on the same inputs, on real
    cells (fields, p and CFL maxima where written), at the timed sizes
    and a small one: bit for bit in exact mode (no_roll within
    NO_ROLL_REL of each field's scale), within FAST_REL in fast math.
    Returns the exact mode's max abs difference by kernel."""
    dev = device_of(device)
    errs = {}
    for n in sizes:
        for fast in (False, True):
            cfg, cfg_god = configs(n, fast, dev)
            src = random_fields(cfg, seed, dev)
            r = real_slice(cfg)
            for name in VARIANTS:
                c = cfg_god if name == "first_order" else cfg
                err = _check_variant(name, c, src, r, fast)
                if not fast:
                    errs[f"cycle_{name}"] = max(errs.get(f"cycle_{name}", 0.0), err)
            del src
    return errs


def _check_variant(name, c, src, r, fast):
    dst, p, part, scal, iscal = _operands(c, src, name)
    cycle_variant(name, c, src, dst, p, part, scal, iscal)
    ref = variant_plain(name, c, src, scal[SC_DTUSE])
    got = list(dst) + ([p] if ref[4] is not None else [])
    want = list(ref[:4]) + ([ref[4]] if ref[4] is not None else [])
    rel = FAST_REL if fast else (NO_ROLL_REL if name == "no_roll" else 0.0)
    n = c.local_shape[0] - 2 * c.nghost
    err = 0.0
    for a, b in zip(got, want):
        d = float((a[r] - b[r]).abs().max())
        err = max(err, d)
        ok = d <= rel * float(b[r].abs().max()) if rel else torch.equal(a[r], b[r])
        if not ok:
            raise AssertionError(f"cycle variant {name} at {n}^2 fast={fast}: "
                                 f"max abs diff {d}")
    if ref[5] is not None:
        for got_m, want_m in zip(part.max(dim=1).values, ref[5]):
            if abs(float(got_m) - float(want_m)) > rel * float(want_m):
                raise AssertionError(f"cycle variant {name} at {n}^2 fast={fast}: "
                                     f"CFL max {float(got_m)} vs {float(want_m)}")
    return err


def entries(rows, errs):
    """Kernels-line entries at 8192^2 (the last row)."""
    r = rows[-1]
    return [kernel_entry(f"cycle_{nm}", SOURCE, REPLACES,
                         LAUNCHES.get(f"cycle_{nm}", 0), errs[f"cycle_{nm}"],
                         r["ms"][nm], r["plain_ms"][nm],
                         (r["bound_ms"][nm], r["bound_by"][nm]))
            for nm in VARIANTS]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="4096,8192")
    ap.add_argument("--exact", action="store_true",
                    help="exact divides (default: fast math, the main path's)")
    args = ap.parse_args(argv)
    return run(args.device, [int(s) for s in args.sizes.split(",")],
               fast=not args.exact)


if __name__ == "__main__":
    main()
