"""The float-float probe, counterpart of `scripts/ff_probe.py`.

    python -m armon_torch.probes.ff                  # on the card
    python -m armon_torch.probes.ff --device cpu --n 64 --iters 2

The GAD + minmod + euler_2nd X-sweep chain of the script (`chain_plain`
:264, `chain_ff` :181) in three number types: f32, f64 and float-float
(an unevaluated (hi, lo) pair of f32 values, ~48 significant bits). On
the TPU f64 was emulated, so float-float was its only fast f64-class
tier; on this card f64 is native at half the f32 rate, and the question
is whether float-float beats it. One kernel template over the number type
(csrc/chain.cuh, csrc/probe_ff.cu) runs all three. The run times `iters`
chained sweeps of each at n^2 (the script's 1024^2, 60 iterations) and
measures the accuracy leg: ff and f32 after K = 12 chained sweeps against
f64, in the script's norms (:505-517).

The plain versions below follow the script operation by operation; f32
square roots go through `ops/eos.ieee_sqrt` (PyTorch's CPU sqrt is not
correctly rounded).
"""

import argparse
import ctypes

import numpy as np
import torch

from . import LAUNCHES, count
from .._card import (bound, card_line, device_of, emit, kernel_entry, shown,
                     time_ms)
from ..ops.eos import ieee_sqrt
from ..ops.sweep import _sign

GAMMA = 1.4
DX = 1.0 / 1024.0
DT = 1e-4
EPS = 1e-6
SPLIT = 4097.0  # 2^12 + 1, Dekker's split of f32's 24-bit significand

KINDS = {"f32": 0, "f64": 1, "ff": 2}
SOURCE = "armon_torch/csrc/probe_ff.cu"
REPLACES = {"chain_f32": "scripts/ff_probe.py:404",
            "chain_ff": "scripts/ff_probe.py:380",
            "chain_f64": "scripts/ff_probe.py:412 (jnp f64, no TPU kernel)"}

# Calls of `two_prod` (the census of `chain_ff` reads it: the card forms
# the error term with one fma where the script splits).
TWO_PROD_CALLS = [0]


# ------------------------------------------------------------ float-float

def two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):  # |a| >= |b|
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    TWO_PROD_CALLS[0] += 1
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


class FF:
    """An unevaluated (hi, lo) pair of f32 tensors, with the script's
    double-single operators."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=None):
        self.hi = hi
        self.lo = torch.zeros_like(hi) if lo is None else lo

    def __add__(self, o):
        o = _ff(o, self.hi)
        s, e = two_sum(self.hi, o.hi)
        return FF(*quick_two_sum(s, e + self.lo + o.lo))

    def __sub__(self, o):
        o = _ff(o, self.hi)
        s, e = two_sum(self.hi, -o.hi)
        return FF(*quick_two_sum(s, e + self.lo - o.lo))

    def __rsub__(self, o):
        return _ff(o, self.hi) - self

    __radd__ = __add__

    def __neg__(self):
        return FF(-self.hi, -self.lo)

    def __mul__(self, o):
        o = _ff(o, self.hi)
        p, e = two_prod(self.hi, o.hi)
        return FF(*quick_two_sum(p, e + self.hi * o.lo + self.lo * o.hi))

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = _ff(o, self.hi)
        q1 = self.hi / o.hi
        p, e = two_prod(q1, o.hi)
        r = self - FF(p, e + q1 * o.lo)
        q2 = (r.hi + r.lo) / o.hi
        return FF(*quick_two_sum(q1, q2))


def _ff(x, like):
    return x if isinstance(x, FF) else FF(torch.full_like(like, x))


def ff_sqrt(x):
    s = ieee_sqrt(x.hi)
    p, e = two_prod(s, s)
    r = x - FF(p, e)
    corr = (r.hi + r.lo) / (2.0 * s)
    return FF(*quick_two_sum(s, corr))


def ff_where(m, a, b):
    return FF(torch.where(m, a.hi, b.hi), torch.where(m, a.lo, b.lo))


def _ff_lt(a, b):
    return (a - b).hi < 0


def ff_min(a, b):
    return ff_where(_ff_lt(a, b), a, b)


def ff_max(a, b):
    return ff_where(_ff_lt(b, a), a, b)


def ff_from_f64(a):
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def ff_to_f64(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


# ------------------------------------------------------- the sweep chain

def chain_ff(rho, uax, uot, E, sh):
    """`chain_ff` of the script on FF values; `sh(x, k)` reads at +k."""
    one, half = _ff(1.0, rho.hi), _ff(0.5, rho.hi)
    dx, dt = _ff(DX, rho.hi), _ff(DT, rho.hi)

    e = E - half * (uax * uax + uot * uot)
    p = _ff(GAMMA - 1.0, rho.hi) * rho * e
    c = ff_sqrt(_ff(GAMMA, rho.hi) * p / rho)
    rc = rho * c

    dm = rho * dx
    rc_l, u_m, p_m = sh(rc, -1), sh(uax, -1), sh(p, -1)
    rc_sum = rc_l + rc
    us_i = (rc_l * u_m + rc * uax + (p_m - p)) / rc_sum
    ps_i = (rc * p_m + rc_l * p + rc_l * rc * (u_m - uax)) / rc_sum

    e_u, e_p = us_i - u_m, ps_i - p_m
    d_u, d_p = uax - us_i, p - ps_i

    def limiter(r):  # minmod
        return ff_max(_ff(0.0, r.hi), ff_min(one, r))

    r_um = limiter(sh(e_u, 1) / (e_u + _ff(EPS, e_u.hi)))
    r_pm = limiter(sh(e_p, 1) / (e_p + _ff(EPS, e_p.hi)))
    r_up = limiter(sh(d_u, -1) / (d_u + _ff(EPS, d_u.hi)))
    r_pp = limiter(sh(d_p, -1) / (d_p + _ff(EPS, d_p.hi)))

    Dm = (sh(dm, -1) + dm) * half
    theta = half * (one - rc_sum * half * (dt / Dm))
    ustar = us_i + theta * (r_up * d_u - r_um * e_u)
    pstar = ps_i + theta * (r_pp * d_p - r_pm * e_p)

    us_p, ps_p = sh(ustar, 1), sh(pstar, 1)
    dX = dx + dt * (us_p - ustar)
    rho1 = dm / dX
    dt_dm = dt / dm
    uax1 = uax + dt_dm * (pstar - ps_p)
    E1 = E + dt_dm * (pstar * ustar - ps_p * us_p)

    disp = dt * ustar
    up = disp.hi > 0

    def rd(a):
        return ff_where(up, sh(a, -1), a)

    ru1, rv1, rE1 = rho1 * uax1, rho1 * uot, rho1 * E1
    dxl = rd(dX)
    dxe = ff_where(up, sh(disp, -1) - dx, dx + sh(disp, 1))
    two = _ff(2.0, rho.hi)
    r_m = (two * dX) / (dX + sh(dX, -1))
    r_p = (two * dX) / (dX + sh(dX, 1))

    def slope_base(q):
        du_p = r_p * (sh(q, 1) - q)
        du_m = r_m * (q - sh(q, -1))
        sgn = ff_where(du_p.hi >= 0, one, -one)
        return sgn * ff_max(_ff(0.0, q.hi), ff_min(sgn * du_p, sgn * du_m))

    lf = dxe / (two * dxl)
    adv = [disp * (rd(q) - rd(slope_base(q)) * lf) for q in (rho1, ru1, rv1, rE1)]
    tmp_rho = (dX * rho1 - (sh(adv[0], 1) - adv[0])) / dx
    tmp_ur = (dX * rho1 * uax1 - (sh(adv[1], 1) - adv[1])) / dx
    tmp_vr = (dX * rho1 * uot - (sh(adv[2], 1) - adv[2])) / dx
    tmp_Er = (dX * rho1 * E1 - (sh(adv[3], 1) - adv[3])) / dx
    return tmp_rho, tmp_ur / tmp_rho, tmp_vr / tmp_rho, tmp_Er / tmp_rho


def chain_plain(rho, uax, uot, E, sh):
    """`chain_plain` of the script in the tensors' dtype (f32 or f64).
    Scalars that divide or are divided are 0-dim tensors: PyTorch turns a
    division by (or of) a Python number into a multiply by a
    reciprocal."""
    T = np.float32 if rho.dtype == torch.float32 else np.float64

    def cst(v):
        return torch.tensor(float(T(v)), dtype=rho.dtype, device=rho.device)

    dx, dt, zero, one = cst(DX), cst(DT), cst(0.0), cst(1.0)
    e = E - 0.5 * (uax * uax + uot * uot)
    p = float(T(GAMMA - 1.0)) * rho * e
    c = ieee_sqrt(float(T(GAMMA)) * p / rho)
    rc = rho * c

    dm = rho * dx
    rc_l, u_m, p_m = sh(rc, -1), sh(uax, -1), sh(p, -1)
    rc_sum = rc_l + rc
    us_i = (rc_l * u_m + rc * uax + (p_m - p)) / rc_sum
    ps_i = (rc * p_m + rc_l * p + rc_l * rc * (u_m - uax)) / rc_sum

    e_u, e_p = us_i - u_m, ps_i - p_m
    d_u, d_p = uax - us_i, p - ps_i

    def limiter(r):
        return torch.maximum(zero, torch.minimum(one, r))

    eps = float(T(EPS))
    r_um = limiter(sh(e_u, 1) / (e_u + eps))
    r_pm = limiter(sh(e_p, 1) / (e_p + eps))
    r_up = limiter(sh(d_u, -1) / (d_u + eps))
    r_pp = limiter(sh(d_p, -1) / (d_p + eps))

    Dm = (sh(dm, -1) + dm) * 0.5
    theta = 0.5 * (1 - rc_sum * 0.5 * (dt / Dm))
    ustar = us_i + theta * (r_up * d_u - r_um * e_u)
    pstar = ps_i + theta * (r_pp * d_p - r_pm * e_p)

    us_p, ps_p = sh(ustar, 1), sh(pstar, 1)
    dX = dx + dt * (us_p - ustar)
    rho1 = dm / dX
    dt_dm = dt / dm
    uax1 = uax + dt_dm * (pstar - ps_p)
    E1 = E + dt_dm * (pstar * ustar - ps_p * us_p)

    disp = dt * ustar
    up = disp > 0

    def rd(a):
        return torch.where(up, sh(a, -1), a)

    ru1, rv1, rE1 = rho1 * uax1, rho1 * uot, rho1 * E1
    dxl = rd(dX)
    dxe = torch.where(up, sh(disp, -1) - dx, dx + sh(disp, 1))
    r_m = (2 * dX) / (dX + sh(dX, -1))
    r_p = (2 * dX) / (dX + sh(dX, 1))

    def slope_base(q):
        du_p = r_p * (sh(q, 1) - q)
        du_m = r_m * (q - sh(q, -1))
        sgn = _sign(du_p)
        return sgn * torch.maximum(zero, torch.minimum(sgn * du_p, sgn * du_m))

    lf = dxe / (2 * dxl)
    adv = [disp * (rd(q) - rd(slope_base(q)) * lf) for q in (rho1, ru1, rv1, rE1)]
    tmp_rho = (dX * rho1 - (sh(adv[0], 1) - adv[0])) / dx
    tmp_ur = (dX * rho1 * uax1 - (sh(adv[1], 1) - adv[1])) / dx
    tmp_vr = (dX * rho1 * uot - (sh(adv[2], 1) - adv[2])) / dx
    tmp_Er = (dX * rho1 * E1 - (sh(adv[3], 1) - adv[3])) / dx
    return tmp_rho, tmp_ur / tmp_rho, tmp_vr / tmp_rho, tmp_Er / tmp_rho


def roll_sh(a, k):
    """Read at +k along the row, wrapping (the script's jnp.roll)."""
    if isinstance(a, FF):
        return FF(roll_sh(a.hi, k), roll_sh(a.lo, k))
    return torch.roll(a, -k, -1) if k else a


def step_plain(kind, src):
    """One sweep of the chain in plain PyTorch: `src` holds (rho, u, v, E),
    or for "ff" their (hi, lo) pairs flattened, as the kernel takes
    them. Returns the same layout."""
    if kind == "ff":
        vals = [FF(src[2 * i], src[2 * i + 1]) for i in range(4)]
        out = chain_ff(*vals, roll_sh)
        return tuple(t for o in out for t in (o.hi, o.lo))
    return chain_plain(*src, roll_sh)


def step(kind, src, dst):
    """One sweep of `src` into `dst` (the layout of `step_plain`): the
    kernel on the card, the plain version on the CPU."""
    if src[0].device.type == "cpu":
        for d, o in zip(dst, step_plain(kind, src)):
            d.copy_(o)
        return
    from ..ops import _build
    tdt = torch.float64 if kind == "f64" else torch.float32
    n = 8 if kind == "ff" else 4
    for t in tuple(src) + tuple(dst):
        if t.dtype != tdt or t.shape != src[0].shape or not t.is_contiguous() \
                or t.dim() != 2:
            raise ValueError(f"chain {kind} takes {n} + {n} contiguous 2-D "
                             f"{tdt} tensors of one shape")
    if len(src) != n or len(dst) != n:
        raise ValueError(f"chain {kind} takes {n} + {n} tensors")
    a = _build.ChainArgs()
    a.src[:n] = [t.data_ptr() for t in src]
    a.dst[:n] = [t.data_ptr() for t in dst]
    a.rows, a.cols = src[0].shape
    _build.launch_probe("probe_ff", "armon_chain", src[0].device, KINDS[kind],
                        ctypes.byref(a))
    count(f"chain_{kind}")


# ---------------------------------------------------------------- harness

def init_arrays(n, rng):
    """Smooth positive fields of a shock tube's magnitudes (the script's
    `init_arrays` :345), f64 numpy."""
    x = np.linspace(0, 1, n, dtype=np.float64)[None, :] + 0 * \
        np.linspace(0, 1, n, dtype=np.float64)[:, None]
    rho = 1.0 + 0.5 * np.sin(2 * np.pi * x) ** 2 + 0.01 * rng.random((n, n))
    u = 0.1 * np.sin(4 * np.pi * x) + 0.01 * rng.random((n, n))
    v = 0.05 * np.cos(2 * np.pi * x)
    E = 2.0 + 0.2 * np.sin(6 * np.pi * x) ** 2 + 0.01 * rng.random((n, n))
    return rho, u, v, E


def inputs(kind, fields, device):
    """The kernel layout of `kind` from f64 numpy fields."""
    if kind == "ff":
        arrs = [a for f in fields for a in ff_from_f64(f)]
    else:
        arrs = [f.astype(np.float32 if kind == "f32" else np.float64) for f in fields]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrs)


def as_f64(kind, out):
    """(rho, u, v, E) as f64 numpy from the kernel layout."""
    arrs = [t.cpu().numpy() for t in out]
    if kind == "ff":
        return [ff_to_f64(arrs[2 * i], arrs[2 * i + 1]) for i in range(4)]
    return [a.astype(np.float64) for a in arrs]


def chained(kind, fields, device, k):
    """`k` chained sweeps from the f64 numpy `fields`; returns the last
    output in the kernel layout."""
    cur = inputs(kind, fields, device)
    nxt = tuple(torch.empty_like(t) for t in cur)
    for _ in range(k):
        step(kind, cur, nxt)
        cur, nxt = nxt, cur
    return cur


def accuracy(fields, device, k=12):
    """ff and f32 after `k` chained sweeps against f64: per field, the
    max abs error over max |ref| and the max pointwise relative error."""
    ref = as_f64("f64", chained("f64", fields, device, k))
    out = {}
    for kind in ("ff", "f32"):
        got = as_f64(kind, chained(kind, fields, device, k))
        for name, g, r in zip(("rho", "u", "v", "E"), got, ref):
            d = np.abs(g - r)
            out.setdefault(kind, {})[name] = {
                "norm": float(d.max() / np.abs(r).max()),
                "rel": float((d / np.maximum(np.abs(r), 1e-30)).max())}
    return out


def ops_per_cell():
    """Lane operations per cell of one sweep, counted from the plain
    chains (`roofline.count_ops`): f32/f64 as written; ff with each
    Dekker product counted as the card's two (a multiply and an fma)."""
    from .roofline import count_ops
    like = torch.empty((2, 8), device="meta")
    f32 = sum(count_ops(lambda: chain_plain(like, like, like, like, roll_sh)).values())
    TWO_PROD_CALLS[0] = 0
    ff = sum(count_ops(lambda: chain_ff(*(FF(like, like) for _ in range(4)),
                                        roll_sh)).values())
    calls = TWO_PROD_CALLS[0]
    per = sum(count_ops(lambda: two_prod(like, like)).values())
    return {"f32": f32, "f64": f32, "ff": ff - calls * (per - 2)}


def run(device="cuda", n=1024, iters=60, seed=7, acc_k=12):
    """Time `iters` chained sweeps of f32, ff and f64 at n^2 (best of 3
    passes), and the accuracy leg; prints and returns one row."""
    dev = device_of(device)
    fields = init_arrays(n, np.random.default_rng(seed))
    ops = ops_per_cell()
    row = {"probe": "ff", "n": n, "iters": iters, "ms_per_sweep": {},
           "plain_ms": {}, "cells_per_s": {}, "bound_ms": {}, "bound_by": {}}
    for kind in ("f32", "ff", "f64"):
        bufs = (inputs(kind, fields, dev),)
        bufs += (tuple(torch.empty_like(t) for t in bufs[0]),)
        ms = time_ms(lambda i: step(kind, bufs[i % 2], bufs[(i + 1) % 2]), dev,
                     iters)
        row["ms_per_sweep"][kind] = shown(ms)
        row["plain_ms"][kind] = shown(time_ms(
            lambda i: step_plain(kind, bufs[0]), dev, 2))
        row["cells_per_s"][kind] = shown(None if ms is None else n * n / ms * 1e3)
        nbytes = 2 * len(bufs[0]) * n * n * bufs[0][0].element_size()
        b = bound(nbytes, {"float64" if kind == "f64" else "float32": ops[kind] * n * n})
        row["bound_ms"][kind], row["bound_by"][kind] = b
    row["ops_per_cell"] = ops
    if dev.type == "cuda":
        t = row["ms_per_sweep"]
        row["ff_vs_f32"] = t["f32"] / t["ff"]    # cells/s ratio, as the script's
        row["ff_vs_f64"] = t["f64"] / t["ff"]
        row["card"] = card_line()
    row["accuracy"] = accuracy(fields, dev, acc_k)
    emit(row)
    return row


def check(device="cuda", sizes=(1024, 256), seed=3):
    """Each kernel against its plain version on the same inputs, bit for
    bit (exact arithmetic on both sides), at the timed size and a small
    one; returns the max abs difference by kernel."""
    dev = device_of(device)
    errs = {}
    for n in sizes:
        fields = init_arrays(n, np.random.default_rng(seed))
        for kind in ("f32", "ff", "f64"):
            src = inputs(kind, fields, dev)
            dst = tuple(torch.empty_like(t) for t in src)
            step(kind, src, dst)
            ref = step_plain(kind, src)
            err = max(float((a - b).abs().max()) for a, b in zip(dst, ref))
            if not all(torch.equal(a, b) for a, b in zip(dst, ref)):
                raise AssertionError(f"chain {kind} at {n}^2: max abs diff "
                                     f"{err} against its plain version")
            errs[f"chain_{kind}"] = max(errs.get(f"chain_{kind}", 0.0), err)
    return errs


def entries(row, errs):
    return [kernel_entry(f"chain_{k}", SOURCE, REPLACES[f"chain_{k}"],
                         LAUNCHES.get(f"chain_{k}", 0), errs[f"chain_{k}"],
                         row["ms_per_sweep"][k], row["plain_ms"][k],
                         (row["bound_ms"][k], row["bound_by"][k]))
            for k in ("f32", "ff", "f64")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args(argv)
    return run(args.device, args.n, args.iters)


if __name__ == "__main__":
    main()
