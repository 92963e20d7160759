"""K5 as one thread-block cluster, measured against the solver's K5.

    python -m armon_torch.probes.cluster                  # on the card
    python -m armon_torch.probes.cluster --device cpu --sizes 24 --f64 24

The solver's K5 (`ops/cycle.py` `multicycle`, csrc/cycle.cuh) runs K
cycles in one cooperative launch of 32 x 32 windows (24 x 24 tiles), a
block of 8 warps each, with a grid barrier and a round trip through L2 a
cycle. This probe's kernel (csrc/cluster.cuh) computes the same function
as one cluster of CLUSTER CTAs that holds the whole grid in its shared
memory for all K cycles: whole-line sweeps with `run_body`'s lane runs,
a transposing store through distributed shared memory between the
sweeps, two cluster barriers a cycle, device memory read once and
written once. It answers one question: can one cluster beat the tiled
kernel on the grids the routing sends to K5 (`multicycle_geom_ok`'s
256 KiB cap)? On the H100 it does not (PERF.md, Findings), so it stays a
probe and the solver keeps the tiled kernel.

`run` times one launch of 8 cycles (Sod, Sequential, the default
`temporal_blocking`) of both kernels from the same state (after 50
per-sweep cycles), back to back, each call from the state the one before
left, at 108^2, 168^2 and 248^2 padded in f32 fast math and 128^2 in f64,
with the plain version's time, the bound and the cluster's plan. `check`
holds the probe against `multicycle_plain` on the same inputs: bit for
bit (fields, p and every loop scalar) in exact mode at 100^2, at the
largest grids the routing admits, on Bizarrium and with an odd K, and
within FAST_REL of each field's scale in fast math at the timed sizes.
"""

import argparse

import numpy as np
import torch

from . import LAUNCHES, count
from .._card import bound, card_line, device_of, emit, kernel_entry, shown, time_ms
from ..ops.cycle import multicycle_plain, parity_pairs
from ..ops.sweep import HALO, IS_CYCLE, new_scalars
from ..utils.errors import solver_error

# csrc/cluster.cuh (`McGeom`, `check_plan`): the CTAs of the cluster (16,
# the non-portable limit: the most SMs one cluster takes and the largest
# grid it holds); threads a CTA and a lane's run of positions by
# itemsize; the bytes of shared memory before the planes (every warp's
# CFL maxima), the planes (two rho/u/v/E sets and p) and the most shared
# memory a CTA may use.
CLUSTER = 16
THREADS = {4: 512, 8: 256}
RUN = {4: 2, 8: 4}
HEAD = 2048  # 16 CTAs x (16 f32 / 8 f64 warps) x 2 maxima
PLANES, SMEM_MAX = 9, 232448

SOURCE = "armon_torch/csrc/cluster.cuh"
REPLACES = "armon_tpu/ops/pallas/sweep.py:1905"
NAME = "cluster_multicycle"
FAST_REL = 1e-4  # approximate reciprocals against exact divides
SWEEP_OPS = 192  # operations per cell per sweep (`roofline.census()`)
# Exact-mode cases of `check` beyond the timed sizes: (test, dtype,
# options); the largest grids the routing admits (thin, square and the
# wide strip in f32, thin and square in f64), Bizarrium, an odd K.
EXTREMES = (("Sod_circ", "float32", dict(N=(120, 496))),
            ("Sod_circ", "float32", dict(N=(240, 240))),
            ("Sod", "float32", dict(N=(3192, 4))),
            ("Sod_circ", "float64", dict(N=(120, 240))),
            ("Sod_circ", "float64", dict(N=(120, 120))),
            ("Bizarrium", "float32", dict(N=(240, 240))),
            ("Sod_circ", "float64", dict(N=(100, 100), axis_splitting="Godunov")),
            ("Sod_circ", "float32", dict(N=(100, 100), temporal_blocking=7)))


def plan(n_real, dtype):
    """The cluster plan for a grid of `n_real` = (nx, ny) real cells:
    {"cluster", "band_r", "band_c", "pitch_r", "pitch_c", "plane", "smem",
    "threads"}. Laid out by rows, CTA r holds the real rows [r band_r,
    r band_r + band_r), its part of a column contiguous and `pitch_r`
    (odd) elements from the next column's; by columns, the real columns
    [r band_c, ...), its part of a row `pitch_c` from the next row's. A
    plane holds either layout; `smem` bytes hold PLANES planes. None when
    they do not fit a CTA's shared memory."""
    size = np.dtype(dtype).itemsize
    nx, ny = n_real
    band_r, band_c = -(-ny // CLUSTER), -(-nx // CLUSTER)
    pitch_r, pitch_c = band_r | 1, band_c | 1
    plane = max(nx * pitch_r, ny * pitch_c)
    smem = HEAD + PLANES * plane * size
    if smem > SMEM_MAX:
        return None
    return {"cluster": CLUSTER, "band_r": band_r, "band_c": band_c,
            "pitch_r": pitch_r, "pitch_c": pitch_c, "plane": plane,
            "smem": smem, "threads": THREADS[size]}


def positions(n_real, dtype):
    """Positions the two sweeps of one cycle run over on a grid of
    `n_real` = (nx, ny) real cells: every real line along each axis whole,
    in pieces of at most 32 runs of RUN[itemsize] positions, 2 HALO
    fewer written."""
    run = RUN[np.dtype(dtype).itemsize]

    def swept(n, lines):
        lanes = min(32, -(-(min(n, 32 * run - 2 * HALO) + 2 * HALO) // run))
        return lines * -(-n // (run * lanes - 2 * HALO)) * run * lanes

    nx, ny = n_real
    return swept(nx, ny) + swept(ny, nx)


def _n_real(cfg, src):
    rows, cols = src[0].shape
    return cols - 2 * cfg.nghost, rows - 2 * cfg.nghost


def multicycle(cfg, pairs, src, dst, p, scal, iscal):
    """The probe's K5: len(pairs) cycles in one launch of one cluster,
    with the contract of `ops.cycle.multicycle` (the carry in `src` for an
    even count, in `dst` for an odd one; every loop scalar updated) but
    no partials scratch. The plain version on the CPU."""
    if not pairs:
        solver_error("config", "multicycle needs at least one cycle")
    if src[0].device.type != "cuda":
        multicycle_plain(cfg, pairs, len(pairs), src, dst, p, scal, iscal)
        return
    the_plan = plan(_n_real(cfg, src), cfg.dtype)
    if the_plan is None:
        solver_error("config", f"a grid of {_n_real(cfg, src)} real cells does "
                               f"not fit one cluster's shared memory")
    from ..ops import _build
    _build.launch_cluster(cfg, the_plan, parity_pairs(pairs), len(pairs), src,
                          dst, p, scal, iscal)
    count(NAME)


def occupancy(cfg, src):
    """The plan on `src`'s grid and what the card makes of it: the plan's
    keys and "max_active_clusters", "registers", "local_bytes"."""
    from ..ops import _build
    the_plan = plan(_n_real(cfg, src), cfg.dtype)
    return {**the_plan, **_build.cluster_occupancy(cfg, the_plan, src)}


def _state(test, dtype, device, warm, **opts):
    """(config, pairs, fields, stale p, loop scalars) after `warm`
    per-sweep cycles from the initial state; the config runs every cycle
    of a launch unless `opts` set maxcycle."""
    from .. import ArmonParameters
    from ..core.solver import make_init_fused
    from ..core.step import make_time_loop_lean
    from ..ops.routing import temporal_pairs
    opts = {"maxcycle": 1 << 23, "maxtime": 1e30, **opts}
    params = ArmonParameters(test=test, data_type=dtype, silent=5,
                             device=str(device), **opts)
    cfg = params.config
    warm_p = ArmonParameters(test=test, data_type=dtype, silent=5,
                             device=str(device),
                             **{**opts, "maxcycle": warm, "pair_threshold": 0,
                                "temporal_blocking": 1})
    [fs], seed = make_init_fused(warm_p)()
    res = make_time_loop_lean(warm_p.config)(fs, 0.0, 0, 0.0, float(seed))
    sc = dict(t=res.t, cycle=res.cycles, dt_prev=res.dt_last, lm=res.lm)
    return cfg, temporal_pairs(cfg), tuple(res.carry[:4]), res.carry.p, sc


def _operands(cfg, src, p, sc):
    """Fresh copies: [fields, second buffer set, p, scal, iscal]."""
    scal, iscal = new_scalars(cfg.dtype, src[0].device, **sc)
    return [tuple(a.clone() for a in src), tuple(torch.empty_like(a) for a in src),
            p.clone(), scal, iscal]


def _case_bound(cfg, src, cycles):
    """Bytes: rho/u/v/E of the real cells read once, the padded carry and p
    written once; operations: both sweeps of every real cell, each cycle."""
    nx, ny = _n_real(cfg, src)
    size, real = src[0].element_size(), nx * ny
    dtype = "float32" if size == 4 else "float64"
    return bound((4 * real + 5 * src[0].numel()) * size,
                 {dtype: 2 * SWEEP_OPS * real * cycles})


def run(device="cuda", sizes=(100, 160, 240), f64_sizes=(120,), k=20):
    """Time the probe, the solver's K5 and the plain version at each size
    (real cells a side: 108^2, 168^2, 248^2 padded in f32 fast math, 128^2
    in f64); prints and returns one row per size."""
    from ..ops import cycle as C
    dev = device_of(device)
    rows = []
    for dtype, n in [("float32", n) for n in sizes] + [("float64", n) for n in f64_sizes]:
        fast = dtype == "float32"
        cfg, pairs, src, p, sc = _state("Sod", dtype, dev, 50, N=(n, n),
                                        use_fast_math=fast)
        a, b, c = (_operands(cfg, src, p, sc) for _ in range(3))
        part = C.new_multicycle_partials(src[0].shape, cfg.dtype, dev)
        ms = time_ms(lambda i: multicycle(cfg, pairs, *a), dev, k)
        k5_ms = time_ms(lambda i: C.multicycle(cfg, pairs, b[0], b[1], b[2], part,
                                               b[3], b[4]), dev, k)
        plain_ms = time_ms(lambda i: multicycle_plain(cfg, pairs, len(pairs), *c),
                           dev, 1)
        for t in a[0] + b[0]:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"cluster probe {n}^2 {dtype}: non-finite fields")
        bnd = _case_bound(cfg, src, len(pairs))
        row = {"probe": "cluster", "dtype": dtype, "fast_math": fast,
               "padded": list(src[0].shape), "cycles": len(pairs),
               "ms": shown(ms), "k5_ms": shown(k5_ms), "plain_ms": shown(plain_ms),
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "positions_per_cycle": positions(_n_real(cfg, src), dtype)}
        if dev.type == "cuda":
            row["ratio_to_k5"] = ms / k5_ms
            row["plan"] = occupancy(cfg, src)
            row["card"] = card_line()
        emit(row)
        rows.append(row)
    return rows


def _check_case(cfg, pairs, src, p, sc, fast, what):
    """The probe against `multicycle_plain` on copies of the same inputs
    (the buffer set the carry ends in, p, the loop scalars). Returns the
    max abs difference of the fields and p."""
    a, b = _operands(cfg, src, p, sc), _operands(cfg, src, p, sc)
    multicycle(cfg, pairs, *a)
    multicycle_plain(cfg, pairs, len(pairs), *b)
    k = len(pairs) % 2
    g = cfg.nghost
    r = (slice(g, -g), slice(g, -g))
    err = 0.0
    for x, y in zip(a[k] + (a[2],), b[k] + (b[2],)):
        d = float((x[r] - y[r]).abs().max())
        err = max(err, d)
        ok = d <= FAST_REL * float(y[r].abs().max()) if fast else torch.equal(x[r], y[r])
        if not ok:
            raise AssertionError(f"{what}: max abs diff {d}")
    if not torch.equal(a[4], b[4]):
        raise AssertionError(f"{what}: loop ints {a[4].tolist()} vs {b[4].tolist()}")
    if fast:
        rel = float(((a[3] - b[3]).abs() / b[3].abs().clamp_min(1e-30)).max())
        if rel > FAST_REL:
            raise AssertionError(f"{what}: loop scalars off by {rel}")
    elif not torch.equal(a[3], b[3]):
        raise AssertionError(f"{what}: loop scalars {a[3].tolist()} vs {b[3].tolist()}")
    if int(a[4][IS_CYCLE]) != sc["cycle"] + len(pairs):
        raise AssertionError(f"{what}: not every cycle ran")
    return err


def check(device="cuda", sizes=(100, 160, 240), f64_sizes=(120,),
          extremes=EXTREMES):
    """The probe against `multicycle_plain` (`_check_case`) at the timed
    sizes in exact mode and fast math, and on the `extremes` in exact
    mode. Returns the exact mode's max abs difference by kernel name."""
    dev = device_of(device)
    cases = [("Sod", "float32", dict(N=(n, n)), fast)
             for n in sizes for fast in (False, True)]
    cases += [("Sod", "float64", dict(N=(n, n)), False) for n in f64_sizes]
    cases += [(test, dtype, opts, False) for test, dtype, opts in extremes]
    err = 0.0
    for test, dtype, opts, fast in cases:
        cfg, pairs, src, p, sc = _state(test, dtype, dev, 10, use_fast_math=fast,
                                        **opts)
        e = _check_case(cfg, pairs, src, p, sc, fast,
                        f"cluster probe {test} {dtype} {opts} fast={fast}")
        if not fast:
            err = max(err, e)
    return {NAME: err}


def entries(rows, errs):
    """The kernels-line entry at 108^2 f32 fast math (the first row)."""
    r = rows[0]
    return [kernel_entry(NAME, SOURCE, REPLACES, LAUNCHES.get(NAME, 0), errs[NAME],
                         r["ms"], r["plain_ms"], (r["bound_ms"], r["bound_by"]))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="100,160,240",
                    help="real cells a side, f32 fast math")
    ap.add_argument("--f64", default="120", help="real cells a side, f64")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    return run(args.device, ints(args.sizes), ints(args.f64))


if __name__ == "__main__":
    main()
