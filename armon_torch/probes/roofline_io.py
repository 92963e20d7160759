"""The I/O-shape roofline probe, counterpart of `scripts/roofline_io.py`.

    python -m armon_torch.probes.roofline_io               # on the card
    python -m armon_torch.probes.roofline_io --device cpu --n 64 --reps 2

One kernel template over a math level (csrc/probe_stream.cu) with the
sweep's own I/O shape: read rho/u/v/E, write them back in place and a
fifth field p. Levels (the script's :48-85): ``io`` (x + 1: the floor of
this access pattern), ``light`` (~25 elementwise operations and a sqrt),
``half`` (EOS, one Godunov solve and the Lagrangian update, five
neighbour reads) and ``sweep`` (the whole X-sweep chain of
`probes/ff.chain_plain`, as the script imports it). The ladder tells
"traffic not hidden" from "math beyond the traffic": the gap between
``io`` and ``sweep`` is the math that the memory system does not cover.

The inputs are physical fields (the ranges of `scripts/perf_probe.py:
218-221`): the script draws all four in [1, 1.1], where e = E - (u^2 +
v^2)/2 < 0 and the sqrt of three levels is NaN. Every timed launch
starts from the same fields, and each level's output is checked finite.
"""

import argparse

import numpy as np
import torch

from . import LAUNCHES, count
from .._card import (bound, card_line, device_of, emit, kernel_entry, shown,
                     time_ms)
from ..ops.eos import ieee_sqrt
from .ff import chain_plain, roll_sh

LEVELS = ("io", "light", "half", "sweep")
SOURCE = "armon_torch/csrc/probe_stream.cu"
REPLACES = "scripts/roofline_io.py:92"
N = 8192  # the script's default (:115)


def physical_fields(shape, seed, device):
    """rho in [0.5, 2), u and v in [-0.1, 0.1), E in [1, 3), f32."""
    rng = np.random.default_rng(seed)
    lo_hi = ((0.5, 2.0), (-0.1, 0.1), (-0.1, 0.1), (1.0, 3.0))
    return tuple(torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
                 .to(device) for lo, hi in lo_hi)


def level_plain(level, rr, uu, vv, EE):
    """One launch's math in plain PyTorch: (rho, u, v, E, p) out."""
    if level == "io":
        return rr + 1.0, uu + 1.0, vv + 1.0, EE + 1.0, rr - 1.0
    e = EE - 0.5 * (uu * uu + vv * vv)
    p = 0.4 * rr * e
    if level == "light":
        c = ieee_sqrt(1.4 * p * rr)
        q = p * c + e
        return (rr + 1e-7 * q, uu + 1e-7 * (p - c), vv + 1e-7 * (p + c),
                EE + 1e-7 * (q - p), p)
    if level == "half":
        c = ieee_sqrt(1.4 * p * rr)
        rc = rr * c
        rc_l, u_m, p_m = roll_sh(rc, -1), roll_sh(uu, -1), roll_sh(p, -1)
        rc_sum = rc_l + rc
        us = (rc_l * u_m + rc * uu + (p_m - p)) / rc_sum
        ps = (rc * p_m + rc_l * p + rc_l * rc * (u_m - uu)) / rc_sum
        us_p, ps_p = roll_sh(us, 1), roll_sh(ps, 1)
        dx = torch.tensor(float(np.float32(1.0 / 8192.0)), device=rr.device)
        dt = torch.tensor(float(np.float32(1e-4)), device=rr.device)
        dm = rr * dx
        dX = dx + dt * (us_p - us)
        dt_dm = dt / dm
        return (dm / dX, uu + dt_dm * (ps - ps_p), vv.clone(),
                EE + dt_dm * (ps * us - ps_p * us_p), p)
    r2, u2, v2, E2 = chain_plain(rr, uu, vv, EE, roll_sh)
    return r2, u2, v2, E2, 0.4 * r2 * (E2 - 0.5 * (u2 * u2 + v2 * v2))


def ladder(level, fields, p):
    """One launch of `level`: rho/u/v/E (`fields`) updated in place, p
    written. The kernel on the card, the plain version on the CPU."""
    if fields[0].device.type == "cpu":
        out = level_plain(level, *fields)
        for d, o in zip(tuple(fields) + (p,), out):
            d.copy_(o)
        return
    from ..ops import _build
    import ctypes
    for t in tuple(fields) + (p,):
        if t.dtype != torch.float32 or t.shape != fields[0].shape \
                or t.dim() != 2 or not t.is_contiguous():
            raise ValueError("the I/O ladder takes five contiguous 2-D float32 "
                             "tensors of one shape")
    a = _build.IoArgs()
    a.f[:] = [t.data_ptr() for t in fields]
    a.p = p.data_ptr()
    a.rows, a.cols = fields[0].shape
    _build.launch_probe("probe_stream", "armon_io_ladder", p.device,
                        LEVELS.index(level), ctypes.byref(a))
    count(f"io_{level}")


def ops_per_cell():
    """Lane operations per cell of each level, counted from the plain
    versions (`roofline.count_ops`; a divide or a sqrt counts as one)."""
    from .roofline import count_ops
    like = torch.empty((2, 8), device="meta")
    return {lv: sum(count_ops(lambda: level_plain(lv, like, like, like, like))
                    .values()) for lv in LEVELS}


def _finite(level, tensors, what):
    for name, t in zip(("rho", "u", "v", "E", "p"), tensors):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"I/O ladder {level}: {name} not finite {what}")


def run(device="cuda", n=N, reps=30, seed=3):
    """Time each level at n^2 (best of 3 passes of `reps` launches); every
    launch updates the same physical fields in place, reset from a kept
    copy before it (untimed): `half` repeated in place leaves them by its
    fourth launch, and an `io` launch adds 1 to u, v and E. Prints and
    returns one row."""
    dev = device_of(device)
    keep = physical_fields((n, n), seed, dev)
    fields = tuple(torch.empty_like(t) for t in keep)
    p = torch.empty_like(keep[0])

    def reset():
        for d, s in zip(fields, keep):
            d.copy_(s)

    ops = ops_per_cell()
    nbytes = 9 * n * n * 4
    row = {"probe": "roofline_io", "n": n, "reps": reps, "ms": {},
           "plain_ms": {}, "gb_per_s": {}, "ns_per_cell": {}, "bound_ms": {},
           "bound_by": {}, "ops_per_cell": ops}
    for lv in LEVELS:
        ms = time_ms(lambda i: ladder(lv, fields, p), dev, reps, reset=reset)
        reset()
        ladder(lv, fields, p)
        _finite(lv, fields + (p,), "after a launch")
        row["ms"][lv] = shown(ms)
        row["plain_ms"][lv] = shown(time_ms(lambda i: level_plain(lv, *keep),
                                            dev, 2))
        row["gb_per_s"][lv] = shown(None if ms is None else nbytes / ms / 1e6)
        row["ns_per_cell"][lv] = shown(None if ms is None else ms * 1e6 / (n * n))
        row["bound_ms"][lv], row["bound_by"][lv] = bound(
            nbytes, {"float32": ops[lv] * n * n})
    if dev.type == "cuda":
        row["io_share_of_hbm"] = row["bound_ms"]["io"] / row["ms"]["io"]
        row["card"] = card_line()
    emit(row)
    return row


def check(device="cuda", shapes=((N, N), (48, 1000), (16, 200)), seed=5):
    """Each level's kernel against its plain version on the same physical
    inputs, bit for bit (exact arithmetic on both sides), and finite: at
    the timed shape, and at two small ones (several segments per row with
    the wrap-around, and one); returns the max abs difference by
    kernel."""
    dev = device_of(device)
    errs = {}
    for lv in LEVELS:
        err = 0.0
        for shape in shapes:
            fields = physical_fields(shape, seed, dev)
            ref = level_plain(lv, *fields)
            p = torch.empty_like(fields[0])
            ladder(lv, fields, p)
            got = tuple(fields) + (p,)
            _finite(lv, got, f"at {shape}")
            err = max(err, max(float((a - b).abs().max()) for a, b in zip(got, ref)))
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"I/O ladder {lv} at {shape}: max abs "
                                     f"diff {err} against its plain version")
            del fields, ref, p, got
        errs[f"io_{lv}"] = err
    return errs


def entries(row, errs):
    return [kernel_entry(f"io_{lv}", SOURCE, REPLACES,
                         LAUNCHES.get(f"io_{lv}", 0), errs[f"io_{lv}"],
                         row["ms"][lv], row["plain_ms"][lv],
                         (row["bound_ms"][lv], row["bound_by"][lv]))
            for lv in LEVELS]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    return run(args.device, args.n, args.reps)


if __name__ == "__main__":
    main()
