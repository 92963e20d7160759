"""The compute-roofline probe, counterpart of `scripts/roofline.py`.

    python -m armon_torch.probes.roofline                  # on the card
    python -m armon_torch.probes.roofline --device cpu --n 256 --reps 2

Three parts, as the script's:

A. **Census** (any device): the operations of one sweep of the port's
   plain version (`ops/sweep.sweep_math_plain`, the arithmetic every
   sweep kernel runs) at the script's scheme (GAD + minmod + euler_2nd,
   f32, :72-75), counted by a `TorchFunctionMode` on meta tensors (the
   script's `make_jaxpr` + `walk`), in the script's classes, and the
   shifts by offset.
B. **Rates** (the card): per-class chains (csrc/probe_rates.cu) on an
   n^2 f32 array, each timed at two repetition counts; the difference is
   the chains' time alone, per element and operation. The shift classes
   are the card's two neighbour reads (shared memory behind a barrier, as
   `sweep_body` does; `__shfl_sync`), net of the add they carry, as the
   script nets its rolls (:211-221). Where `cuobjdump` is on the machine,
   each class's SASS instructions per step are counted.
C. **Floor**: census x rates, the operation floor of one X sweep (K1),
   one Y sweep (K2), one K4 cycle (two sweeps x 1.22 for its recomputed
   halo) and one K5 launch of 8 cycles, beside each one's byte bound
   (`report_floor` :225-251). The sum treats the classes as serial; the
   card overlaps its pipes, so it is a model, not a floor, where it lands
   above a measured time. Beside it, where `cuobjdump` is on the
   machine, the issue time of the production kernels' static SASS
   (`static_issue`).
"""

import argparse
import os
import re
import shutil
import subprocess
from collections import Counter

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import LAUNCHES, count
from .._card import (HBM_BYTES_PER_S, LANE_OPS_PER_S, card_line,
                     device_of, emit, kernel_entry, shown, time_ms)
from ..ops.eos import ieee_sqrt
from ..utils.enums import Axis

SOURCE = "armon_torch/csrc/probe_rates.cu"
REPLACES = "scripts/roofline.py:151"

# ------------------------------------------------------------------ census

# Torch functions by the script's primitive classes (jaxpr names).
_CLASS_OF = {}
for _cls, _names in (("add", ("__add__", "__radd__", "__iadd__", "add")),
                     ("sub", ("__sub__", "__rsub__", "sub", "rsub")),
                     ("mul", ("__mul__", "__rmul__", "mul")),
                     ("div", ("__truediv__", "__rtruediv__", "div")),
                     ("sqrt", ("sqrt",)), ("max", ("maximum",)),
                     ("min", ("minimum",)), ("select_n", ("where",)),
                     ("abs", ("abs", "__abs__")), ("neg", ("__neg__", "neg")),
                     ("gt", ("__gt__", "gt")), ("lt", ("__lt__", "lt")),
                     ("ge", ("__ge__", "ge")), ("le", ("__le__", "le")),
                     ("fma", ("addcmul",))):
    for _n in _names:
        _CLASS_OF[_n] = _cls


class _Census(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        cls = _CLASS_OF.get(getattr(func, "__name__", ""))
        if cls:
            self.counts[cls] += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn):
    """Counter of the arithmetic operations (the script's classes) that
    `fn()` runs; best run on meta tensors, which compute nothing."""
    with _Census() as mode:
        fn()
    return mode.counts


def census(n=256):
    """(operation classes, shifts by offset) of one sweep of
    `sweep_math_plain` at GAD + minmod + euler_2nd, f32, perfect gas."""
    from .. import ArmonParameters
    from ..ops.sweep import sweep_math_plain
    cfg = ArmonParameters(test="Sod", N=(n, n), data_type="float32",
                          scheme="GAD", projection="euler_2nd",
                          riemann_limiter="minmod", nghost=4, maxcycle=1,
                          silent=5, measure_time=False, device="cpu").config
    shifts = Counter()

    def sh(a, k):
        shifts[k] += 1
        return torch.roll(a, -k, 0) if k else a

    like = torch.empty((n, 128), device="meta")
    dt = torch.tensor(1e-5, device="meta")
    dx = torch.tensor(float(np.float32(cfg.dx)), device="meta")
    ops = count_ops(lambda: sweep_math_plain(cfg, sh, dt, dx, like, like,
                                             like, like))
    return ops, Counter({k: v for k, v in shifts.items() if k})


# ------------------------------------------------------------------- rates

# The rate kernel's classes, in the order of `RateClass` (probe_rates.cu).
CLASSES = ("none", "add", "mul", "fma", "mul_add", "min", "select", "abs_add",
           "sqrt", "div", "rcp", "smem", "shfl")
ILP, W0 = 16, 128
# Classes whose kernel is not bit-comparable with its plain version:
# `rcp` is approximate; the plain fma rounds twice (f64 product and sum,
# then f32), the card once.
INEXACT = {"rcp": 1e-5, "fma": 1e-6}


def _group_roll(a, s, width):
    shape = a.shape
    return torch.roll(a.reshape(-1, width), s, 1).reshape(shape)


def _step(cls, a, x, i, nbr):
    if cls == "add":
        return a + x
    if cls == "mul":
        return a * 1.0000001
    if cls == "fma":
        return (a.double() * float(np.float32(1.0000001)) + x.double()).float()
    if cls == "mul_add":
        return a * 1.0000001 + x
    if cls == "min":
        return torch.minimum(a, x * (1.0 + i))
    if cls == "select":
        return torch.where(a > x * (0.5 + 0.01 * i), a * 0.9999, a)
    if cls == "abs_add":
        return torch.abs(a) + x
    if cls == "sqrt":
        return ieee_sqrt(a) + x
    if cls == "div":
        return x / a
    if cls == "rcp":
        return torch.reciprocal(a) + x
    if cls in ("smem", "shfl"):
        return a + nbr
    return a


def rate_plain(cls, x, w0=W0, reps=1):
    """The rate kernel's function in plain PyTorch: 16 chains per element,
    `w0` steps per repetition (step i of chain j at position i*16 + j),
    then their sum. The shift classes read the accumulator rolled by
    s = 1 + position mod 3 within groups of 256 (smem) or 32 (shfl)
    elements, the card's block and warp."""
    accs = [x * (1.0 + 0.25 * j) for j in range(ILP)]
    width = {"smem": 256, "shfl": 32}.get(cls)
    for _ in range(reps):
        for i in range(w0 // ILP):
            for j in range(ILP):
                idx = i * ILP + j
                nbr = _group_roll(accs[j], 1 + idx % 3, width) if width else None
                accs[j] = _step(cls, accs[j], x, idx, nbr)
    out = accs[0]
    for j in range(1, ILP):
        out = out + accs[j]
    return out


def rate(cls, x, reps, out=None):
    """The rate kernel of class `cls` over `x` (f32, a multiple of 256
    elements) with `reps` repetitions of W0 steps; the plain version on
    the CPU."""
    if x.device.type == "cpu":
        return rate_plain(cls, x, W0, reps)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % 256:
        raise ValueError("the rate kernel takes a contiguous float32 tensor "
                         "of a multiple of 256 elements")
    from ..ops import _build
    out = torch.empty_like(x) if out is None else out
    _build.launch_probe("probe_rates", "armon_rate", x.device, CLASSES.index(cls),
                        x.data_ptr(), out.data_ptr(), x.numel(), int(reps))
    count(f"rate_{cls}")
    return out


def sass_opcodes(stem, pattern):
    """{match of `pattern` (a regex on the mangled name, one group): SASS
    opcodes of that kernel} in the library of source `stem`, from
    cuobjdump; None where cuobjdump is missing."""
    from ..ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", _build._lib_path(f"{stem}.cu")],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        m = re.match(r"\S*" + pattern, block)
        if m:
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                             block)
            out[m.group(1)] = [o for o in ops if o not in ("NOP", "BRA", "EXIT")]
    return out


# SASS opcodes by the narrow pipe they issue to (`_card.LANE_OPS_PER_S`):
# the special-function unit, and shared memory and shuffles.
PIPES = {"mufu": ("MUFU",), "lsu": ("LDS", "STS", "SHFL")}


def _pipe_counts(ops):
    """(all instructions, then one count per `PIPES` entry) of `ops`."""
    return (len(ops),) + tuple(sum(o.startswith(pre) for o in ops)
                               for pre in PIPES.values())


def sass_counts():
    """{class: (instructions, MUFU instructions, shared-memory and shuffle
    instructions) per step} from the rate kernels' SASS, net of the
    `none` class; None without cuobjdump."""
    per = sass_opcodes("probe_rates", r"rate_kernelILi(\d+)E")
    if not per or "0" not in per:
        return None
    base = _pipe_counts(per["0"])
    return {CLASSES[int(c)]: tuple((n - b) / W0 for n, b in zip(_pipe_counts(ops), base))
            for c, ops in per.items()}


# Instructions per step where no SASS was read: (all, MUFU, shared memory
# and shuffles) by the forms above (an IEEE divide or sqrt is a MUFU seed
# and its Newton steps; a shift stores the accumulator and loads or
# shuffles the neighbour's).
NOMINAL_INSTR = {"none": (0, 0, 0), "add": (1, 0, 0), "mul": (1, 0, 0),
                 "fma": (1, 0, 0), "mul_add": (2, 0, 0), "min": (4, 0, 0),
                 "select": (4, 0, 0), "abs_add": (1, 0, 0), "sqrt": (8, 1, 0),
                 "div": (10, 1, 0), "rcp": (2, 1, 0), "smem": (3, 0, 2),
                 "shfl": (3, 0, 1)}


def pipe_bound(nbytes, steps, instr):
    """(least ms, "bytes" or "operations", the limiting pipe) of `steps`
    lane-steps of a class with `instr` = (all, MUFU, shared memory and
    shuffles) SASS per step: the larger of the bytes over the HBM rate and
    the slowest pipe, each pipe's instructions over its lane rate (every
    instruction over the issue rate, MUFU over 1/8 of it, shared memory and
    shuffles over 1/4), since the pipes run side by side. A class with a
    MUFU instruction (sqrt, divide, reciprocal) has slow paths in its
    static SASS (subnormals, special values) that these inputs never
    take: its issue count is an overcount, so only its pipes bound it."""
    times = {} if instr[1] else {"issue": steps * instr[0] / LANE_OPS_PER_S["float32"]}
    for key, n in zip(PIPES, instr[1:]):
        times[key] = steps * n / LANE_OPS_PER_S[key]
    pipe = max(times, key=times.get)
    tb = nbytes / HBM_BYTES_PER_S
    if tb >= times[pipe]:
        return tb * 1e3, "bytes", "hbm"
    return times[pipe] * 1e3, "operations", pipe


def run_rates(device="cuda", n=8192, reps=5, k=5):
    """Each class at reps = 1 and `reps` on an n^2 f32 array (the script's
    1.0001); returns one row with ms, net ps per element-op, Gops/s and
    the bound of the `reps` launch."""
    dev = device_of(device)
    x = torch.full((n, n), 1.0001, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    sass = sass_counts() if dev.type == "cuda" else None
    instr = sass or NOMINAL_INSTR
    elems = x.numel()
    row = {"probe": "roofline_rates", "n": n, "reps": reps, "w0": W0,
           "sass_per_step": shown(sass),
           "bound_instr": "SASS" if sass else "nominal (no cuobjdump)",
           "ms": {}, "plain_ms": {}, "net_ps_per_op": {}, "gops_per_s": {},
           "instr_per_step": instr, "bound_ms": {}, "bound_by": {},
           "bound_pipe": {}}
    for cls in CLASSES:
        t1 = time_ms(lambda i: rate(cls, x, 1, out), dev, k)
        tr = time_ms(lambda i: rate(cls, x, reps, out), dev, k)
        row["ms"][cls] = shown(tr)
        row["plain_ms"][cls] = shown(time_ms(lambda i: rate_plain(cls, x, W0, 1),
                                             dev, 1))
        if tr is not None:
            net = (tr - t1) * 1e-3 / (elems * W0 * (reps - 1))
            row["net_ps_per_op"][cls] = net * 1e12
            row["gops_per_s"][cls] = 1 / net / 1e9 if net > 0 else None
        (row["bound_ms"][cls], row["bound_by"][cls],
         row["bound_pipe"][cls]) = pipe_bound(2 * elems * 4, elems * W0 * reps,
                                              instr[cls])
    if dev.type == "cuda":
        row["card"] = card_line()
    emit(row)
    return row


# ------------------------------------------------------------------- floor

def _net(rates):
    """Seconds per element-op of each census class, over the whole card,
    from the classes' measured net times (ps per element-op); the
    composite classes shed the operations they carry."""
    r = {k: v * 1e-12 for k, v in rates.items() if v is not None}
    t = {"add": r["add"], "sub": r["add"], "mul": r["mul"],
         "min": max(r["min"] - r["mul"], 0.0), "select_n": max(r["select"] - 2 * r["mul"], 0.0),
         "abs": max(r["abs_add"] - r["add"], 0.0), "sqrt": max(r["sqrt"] - r["add"], 0.0),
         "div": r["div"], "fma": r["fma"], "neg": 0.0}
    t["max"] = t["min"]
    for c in ("gt", "lt", "ge", "le"):
        t[c] = r["add"]
    t["fast_div"] = max(r["rcp"] - r["add"], 0.0) + 3 * r["mul"] + r["add"]
    t["shift"] = max(r["smem"] - r["add"], 0.0)
    return t


def floors(ops, shifts, rates):
    """Operation floors (ms) beside byte bounds of K1, K2, K4 and K5 at
    their paths' shapes, with exact and with fast-math divides."""
    t = _net(rates)
    n_shift = sum(shifts.values())
    per_exact = sum(c * t[k] for k, c in ops.items()) + n_shift * t["shift"]
    per_fast = per_exact - ops.get("div", 0) * (t["div"] - t["fast_div"])
    from ..ops.cycle import covered_cells, multi_tile, CYCLE_WINDOW
    k4 = covered_cells(CYCLE_WINDOW[4])
    k5 = covered_cells(multi_tile((108, 108), np.float32))
    rows = {}
    for name, cells, sweeps, nbytes in (
            ("x_sweep", 8200 ** 2, 1, 8 * 8200 ** 2 * 4),
            ("y_sweep", 8200 ** 2, 1, 9 * 8200 ** 2 * 4),
            ("cycle_8200", 8200 ** 2, 2 * k4, 9 * 8200 ** 2 * 4),
            ("cycle_2008", 2008 ** 2, 2 * k4, 9 * 2008 ** 2 * 4),
            ("multicycle_108_8cycles", 108 ** 2, 16 * k5, 10 * 108 ** 2 * 4)):
        rows[name] = {"floor_ms_exact": cells * sweeps * per_exact * 1e3,
                      "floor_ms_fast": cells * sweeps * per_fast * 1e3,
                      "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return rows


def static_issue():
    """Issue time (ms) of the production kernels' static SASS on the main
    paths' shapes, over the card's 33.5e12 lane instructions per second (4
    warp instructions per SM and clock): K1 and K2 (f32, fast math,
    perfect gas) charged their instructions per position times the
    positions they sweep. K1's function sweeps one window per pass of its
    loop, a lane's run of X_WINDOW / 32 positions; K2's one row of its
    column per pass. K4 and K5 sweep every position their windows cover (X
    first); they are charged the mean of K1's and K2's count per position.
    An estimate, not a floor: the static count holds every branch, the
    untaken ones too (the pass-through copy, the border windows' ghost
    fill, slow paths of the IEEE sqrt, the CFL reduction of non-emitting
    launches), and K2's set-up once per row. None without cuobjdump."""
    from ..ops.sweep import segments, HALO, X_WINDOW, Y_ROWS, Y_THREADS
    from ..ops.cycle import tile_grid, multi_tile, CYCLE_WINDOW
    per = sass_opcodes("sweep_f32", r"([xy])_sweep_kernelIfLb1ELb0E")
    if not per or set(per) != {"x", "y"}:
        return None
    ix, iy = len(per["x"]) / (X_WINDOW // 32), len(per["y"])
    rate = LANE_OPS_PER_S["float32"]

    def positions(window, n, cycles=1):
        wx, wy = (window, window) if isinstance(window, int) else window
        gx, gy = tile_grid(window, (n, n))
        return gx * gy * (wx * wy + wy * (wx - 8)) * cycles

    shape = (8200, 8200)
    tx = shape[0] * segments(Axis.X, shape)[1] * X_WINDOW
    ty = -(-shape[1] // Y_THREADS) * Y_THREADS * segments(Axis.Y, shape)[1] \
        * (Y_ROWS + 2 * HALO)
    mean = (ix + iy) / 2
    return {"instructions_per_position": {"x_sweep": ix, "y_sweep": iy},
            "x_sweep": ix * tx / rate * 1e3, "y_sweep": iy * ty / rate * 1e3,
            "cycle_8200": mean * positions(CYCLE_WINDOW[4], 8200) / rate * 1e3,
            "cycle_2008": mean * positions(CYCLE_WINDOW[4], 2008) / rate * 1e3,
            "multicycle_108_8cycles": mean * positions(
                multi_tile((108, 108), np.float32), 108, 8)
            / rate * 1e3}


def run(device="cuda", n=8192, reps=5):
    """Census, rates and floors; prints and returns the rows."""
    dev = device_of(device)
    ops, shifts = census()
    crow = {"probe": "roofline_census", "ops": dict(ops),
            "shifts": {str(k): v for k, v in sorted(shifts.items())},
            "total_ops": sum(ops.values()), "total_shifts": sum(shifts.values())}
    emit(crow)
    rrow = run_rates(dev, n, reps)
    out = {"census": crow, "rates": rrow}
    if dev.type == "cuda":
        frow = {"probe": "roofline_floor", "card": rrow["card"],
                "floors": floors(ops, shifts, rrow["net_ps_per_op"]),
                "static_issue_ms": shown(static_issue())}
        emit(frow)
        out["floor"] = frow
    return out


def check(device="cuda", cases=(((8192, 8192), 1), ((8192, 8192), 5),
                                 ((64, 1024), 2))):
    """Each class's kernel against its plain version on the same input,
    bit for bit except `INEXACT`'s classes (relative gate), at the timed
    shape and repetition counts and a small case; returns the max abs
    difference by kernel."""
    dev = device_of(device)
    errs = {}
    for shape, reps in cases:
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32)).to(dev)
        for cls in CLASSES:
            got, ref = rate(cls, x, reps), rate_plain(cls, x, W0, reps)
            err = float((got - ref).abs().max())
            ok = (err <= INEXACT[cls] * float(ref.abs().max())) if cls in INEXACT \
                else torch.equal(got, ref)
            if not ok:
                raise AssertionError(f"rate {cls} at {shape}, {reps} reps: max "
                                     f"abs diff {err} against its plain version")
            errs[f"rate_{cls}"] = max(errs.get(f"rate_{cls}", 0.0), err)
            del got, ref
    return errs


def entries(out, errs):
    """Kernels-line entries of the rate kernels, from `run`'s output."""
    rrow = out["rates"]
    return [kernel_entry(f"rate_{c}", SOURCE, REPLACES,
                         LAUNCHES.get(f"rate_{c}", 0), errs[f"rate_{c}"],
                         rrow["ms"][c], rrow["plain_ms"][c],
                         (rrow["bound_ms"][c], rrow["bound_by"][c]))
            for c in CLASSES]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    return run(args.device, args.n, args.reps)


if __name__ == "__main__":
    main()
