"""The kernel-math fuzz: random smooth states through one sweep, one cycle,
K cycles and the ghost fills (the counterpart of the JAX package's
`tests/test_fuzz.py`).

The draws are the JAX file's, draw for draw, so that a seed gives its
case:

- `sweep_draw(seed)`: `tests/test_fuzz.py:28-60`: scheme, limiter,
  projection, N in 40-140 and the block size (which the port takes and
  ignores: its kernels have no VMEM tiles), then rho, u, v and E, each
  uniform noise smoothed by two box-blur passes, over the padded shard
  of Sod_circ in f64; `scale` multiplies N, leaving the other draws as
  they were (the card's larger grids);
- `pair_draw(seed)`: `:170-178`, Sod_circ at N = (40, 48), rho, u, v, E
  uniform and not smoothed; `:206-214` makes the same draws at seed 7
  for the ghost-fill commutation;
- `random_fields(cfg, seed)`: every State field, smooth and physical,
  Bizarrium's near its initial states (the op path's tests draw these).

On these states the checks below hold each hand-written kernel against
its plain version, launched by the same wrapper (`ops/sweep.py`,
`ops/cycle.py`): K1 and K2 (one emitting sweep each), K4 (both sweep
orders), K5 (eight cycles from the state, where the grid fits its cap),
K4 against K1 then K2, and the commutation of the X sweep with the
orthogonal Y ghost fill, bit for bit in exact mode (f64, and f32 without
fast math); f32 fast math against the f64 plain version within the
option fuzz's fast-math gate (`FAST_TOL` of each field's largest
magnitude, u and v of the largest wave speed; ROADMAP C12). A check
raises `KernelMismatch` on the first difference, and otherwise returns
the largest difference it saw (0 where it holds bit for bit).
On CPU tensors every wrapper runs its plain version, so the checks run
the same control flow on the CPU, comparing the plain version with
itself.

`card_checks()` lists the card's checks, at the JAX file's N and at 8
times it (`tests/test_torch_kernel_fuzz.py`'s `gpu` tests and
`chip_smoke.py` phase 19 (a) run them).

This module imports neither `jax` nor `armon_tpu`.
"""

import numpy as np
import torch

from .params import ArmonParameters
from .utils.enums import Axis
from .ops import sweep as K
from .ops import cycle as C
from .ops.reductions import cfl_limit
from .ops.routing import multicycle_geom_ok, temporal_pairs
from .fuzz import FAST_TOL

FIELDS = ("rho", "u", "v", "E")
DT = 1e-4                                # `tests/test_fuzz.py:61`
SWEEP_SEEDS = (0, 1, 2, 3, 12, 13)       # `:26`
PAIR_SEEDS = (0, 1)                      # `:157`
PAIR_N = (40, 48)                        # `:171`
COMMUTE_SEED = 7                         # `:207`
CARD_SCALES = (1, 8)                     # N as drawn, and 8 times it
EXACT = ("float64", "float32")


class KernelMismatch(AssertionError):
    """A kernel and its plain version disagree on a draw."""


def smooth(rng, lo, hi, shape):
    """`tests/test_fuzz.py:53-58`: uniform noise, two box-blur passes."""
    a = rng.uniform(lo, hi, shape)
    for _ in range(2):
        a = 0.25 * (np.roll(a, 1, 0) + np.roll(a, -1, 0)
                    + np.roll(a, 1, 1) + np.roll(a, -1, 1))
    return a


def random_fields(cfg, seed, shape=None):
    """Every State field, smooth and physical; Bizarrium's near its
    initial states. `shape` defaults to one shard's."""
    rng = np.random.default_rng(seed)
    shape = shape or cfg.local_shape
    biz = type(cfg.test).__name__ == "Bizarrium"
    f = dict(
        x=smooth(rng, 0.0, 1.0, shape), y=smooth(rng, 0.0, 1.0, shape),
        rho=smooth(rng, 1.0e4, 1.43e4, shape) if biz
        else smooth(rng, 0.5, 2.0, shape),
        u=smooth(rng, -0.3, 0.3, shape), v=smooth(rng, -0.3, 0.3, shape),
        E=smooth(rng, 3.2e4, 4.5e6, shape) if biz
        else smooth(rng, 1.5, 3.0, shape),
        p=smooth(rng, 0.5, 1.5, shape), c=smooth(rng, 1.0, 1.5, shape),
        g=smooth(rng, 1.0, 1.5, shape),
        ustar=smooth(rng, -0.3, 0.3, shape),
        pstar=smooth(rng, 0.5, 1.5, shape))
    return {k: a.astype(cfg.dtype) for k, a in f.items()}


def params(test="Sod_circ", dtype="float64", fast=False, **opts):
    """The golden-run configuration of `tests/conftest.py:31-44` on the
    port (GAD, minmod, euler_2nd, nghost 4, N 100^2). Its config does not
    depend on the device, so it is built for the CPU; the checks put
    their tensors on theirs."""
    base = dict(test=test, data_type=dtype, scheme="GAD",
                projection="euler_2nd", riemann_limiter="minmod", nghost=4,
                N=(100, 100), maxcycle=1000, silent=5, write_output=False,
                measure_time=False, use_fast_math=fast, device="cpu")
    return ArmonParameters(**{**base, **opts})


def _scheme_draws(rng, scale):
    """The scheme, limiter, projection, N and block size draws of
    `tests/test_fuzz.py:28-40`, N times `scale`."""
    opts = dict(scheme=str(rng.choice(["Godunov", "GAD"])),
                riemann_limiter=str(rng.choice(["no_limiter", "minmod",
                                                "superbee"])),
                projection=str(rng.choice(["euler", "euler_2nd"])))
    opts["N"] = (int(rng.integers(40, 140)) * scale,
                 int(rng.integers(40, 140)) * scale)
    if rng.random() < 0.75:
        opts["block_size"] = (9999, int(rng.choice([16, 24, 32, 48])))
    return opts


def sweep_draw(seed, scale=1, dtype="float64", fast=False):
    """(params, fields): the draws of `tests/test_fuzz.py:28-60` for
    `seed`, N times `scale`; `fields` holds numpy f64 arrays in the JAX
    file's order of draws."""
    rng = np.random.default_rng(seed)
    p = params(dtype=dtype, fast=fast, **_scheme_draws(rng, scale))
    shape = p.config.local_shape
    fields = {}
    for name, lo, hi in (("rho", 0.5, 2.0), ("u", -0.3, 0.3),
                         ("v", -0.3, 0.3), ("E", 1.5, 3.0)):
        fields[name] = smooth(rng, lo, hi, shape)
    return p, fields


def pair_draw(seed, dtype="float64", fast=False):
    """(params, fields): `tests/test_fuzz.py:170-178`'s draws (also
    `:206-214`'s at seed 7): uniform rho, u, v, E on Sod_circ (40, 48)."""
    rng = np.random.default_rng(seed)
    p = params(N=PAIR_N, dtype=dtype, fast=fast)
    shape = p.config.local_shape
    fields = {}
    for name, lo, hi in (("rho", 0.5, 2.0), ("u", -0.3, 0.3),
                         ("v", -0.3, 0.3), ("E", 1.5, 3.0)):
        fields[name] = rng.uniform(lo, hi, shape)
    return p, fields


def biz_draw(seed, scale=1, dtype="float32", fast=True):
    """(params, fields): Bizarrium at `sweep_draw`'s scheme and N for
    `seed`, on `random_fields`' states."""
    opts = _scheme_draws(np.random.default_rng(seed), scale)
    p = params(test="Bizarrium", dtype=dtype, fast=fast, **opts)
    f = random_fields(params(test="Bizarrium", **opts).config, seed)
    return p, {k: f[k] for k in FIELDS}


def tensors(fields, dtype, device):
    """(rho, u, v, E) as contiguous tensors of `dtype` on `device`."""
    tdt = getattr(torch, dtype)
    return tuple(torch.from_numpy(np.ascontiguousarray(fields[k])).to(
        device=device, dtype=tdt) for k in FIELDS)


def dt_of(cfg, src, dt=DT):
    """The JAX file's dt, or half the state's CFL limit where that is
    smaller (Bizarrium's sound speed is thousands)."""
    _, _, c = K.eos_prc_plain(cfg, *src)
    mx, my = K.cfl_partial_plain(cfg, src[1], src[2], c)
    return min(dt, 0.5 * float(cfl_limit(cfg, mx, my)))


def _real(cfg):
    g = cfg.nghost
    return (slice(g, -g), slice(g, -g))


def _diff(a, b):
    return float((a.double() - b.double()).abs().max())


def _equal(what, a, b):
    """Bit for bit; raises with the largest difference otherwise."""
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    if not torch.equal(a.contiguous().view(view), b.contiguous().view(view)):
        raise KernelMismatch(f"{what}: differs by {_diff(a, b)}")


def _gated(what, out, ref, speed):
    """The fast-math gate: `out` (f32) against `ref` (f64) on real cells,
    u and v against the largest wave speed `speed`."""
    worst = 0.0
    for name, a, b in zip(FIELDS + ("p",), out, ref):
        d = _diff(a, b)
        scale = speed if name in ("u", "v") else float(b.abs().max())
        if not d <= FAST_TOL * scale:
            raise KernelMismatch(f"{what}: {name} differs by {d} "
                                 f"(scale {scale})")
        worst = max(worst, d / scale)
    return worst


def _scalars(cfg, device, dt):
    scal, iscal = K.new_scalars(cfg.dtype, device)
    scal[K.SC_DTUSE] = dt
    iscal[K.IS_RUN] = 1
    return scal, iscal


def launch_sweep(cfg, axis, src, dt, ghosts=K.MIRRORED):
    """One emitting K1 / K2 launch on `src` (the plain version on the
    CPU): (rho, u, v, E, p, partials)."""
    device = src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = K.n_partials(axis, src[0].shape, device)
    part = torch.zeros((2, nb), dtype=src[0].dtype, device=device)
    scal, iscal = _scalars(cfg, device, dt)
    (K.x_sweep if axis is Axis.X else K.y_sweep)(
        cfg, src, dst, p, part, scal, iscal, 1.0, True, ghosts)
    return dst + (p, part[:, :nb])


def launch_cycle(cfg, x_first, src, dt):
    """One emitting K4 launch on `src`: (rho, u, v, E, p, partials)."""
    device = src[0].device
    dst = tuple(torch.empty_like(a) for a in src)
    p = torch.empty_like(src[0])
    nb = C.n_partials(src[0].shape, device, cfg.dtype)
    part = torch.zeros((2, nb), dtype=src[0].dtype, device=device)
    scal, iscal = _scalars(cfg, device, dt)
    C.cycle(cfg, x_first, 1.0, 1.0, src, dst, p, part, scal, iscal, True)
    return dst + (p, part[:, :nb])


def _maxima(part):
    return part[0].amax(), part[1].amax()


def _scalar(like, value):
    return torch.full((), value, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------- the checks

def check_sweeps(device, seed, scale, dtype):
    """K1 and K2 against `sweep_plain` (fields, stale p, the CFL maxima)."""
    p, f = sweep_draw(seed, scale, dtype)
    cfg, r = p.config, _real(p.config)
    src = tensors(f, dtype, device)
    dt = dt_of(cfg, src)
    for axis in (Axis.X, Axis.Y):
        out = launch_sweep(cfg, axis, src, dt)
        ref = K.sweep_plain(cfg, axis, *src, _scalar(src[0], dt))
        for name, a, b in zip(FIELDS + ("p",), out, ref):
            _equal(f"{axis.name} {name}", a[r], b[r])
        mx, my = K.cfl_partial_plain(cfg, ref[1], ref[2], ref[5])
        for name, a, b in zip(("max|u|+c", "max|v|+c"), _maxima(out[5]),
                              (mx, my)):
            _equal(f"{axis.name} {name}", a, b)
    return 0.0


def check_cycle(device, seed, scale, dtype):
    """K4, X first and Y first, against `cycle_plain`."""
    p, f = sweep_draw(seed, scale, dtype)
    cfg, r = p.config, _real(p.config)
    src = tensors(f, dtype, device)
    dt = dt_of(cfg, src)
    for x_first in (True, False):
        out = launch_cycle(cfg, x_first, src, dt)
        d = _scalar(src[0], dt)
        ref = C.cycle_plain(cfg, x_first, *src, d, d)
        order = "xy" if x_first else "yx"
        for name, a, b in zip(FIELDS + ("p",), out, ref):
            _equal(f"{order} {name}", a[r], b[r])
        for name, a, b in zip(("max|u|+c", "max|v|+c"), _maxima(out[5]),
                              ref[5:]):
            _equal(f"{order} {name}", a, b)
    return 0.0


def k5_fits(seed, dtype):
    """Whether `sweep_draw(seed)`'s grid fits K5 (the multicycle route's
    cap)."""
    cfg = params(dtype=dtype, **_scheme_draws(np.random.default_rng(seed),
                                              1)).config
    return multicycle_geom_ok(cfg, cfg.local_shape)


def check_multicycle(device, seed, dtype):
    """One K5 launch of eight cycles from the draw's state, the CFL seed
    its own, against `multicycle_plain` on copies of the same inputs:
    fields, p and every loop scalar."""
    p, f = sweep_draw(seed, 1, dtype)
    cfg, r = p.config, _real(p.config)
    pairs = temporal_pairs(cfg)
    src = tensors(f, dtype, device)
    _, _, c = K.eos_prc_plain(cfg, *src)
    mx, my = K.cfl_partial_plain(cfg, src[1], src[2], c)
    lm = float(cfl_limit(cfg, mx, my))
    scal, iscal = K.new_scalars(cfg.dtype, device, lm=lm)
    p0 = torch.zeros_like(src[0])
    ins = [tuple(a.clone() for a in src), tuple(torch.empty_like(a) for a in src),
           p0.clone(), scal.clone(), iscal.clone()]
    dst = tuple(torch.empty_like(a) for a in src)
    C.multicycle(cfg, pairs, src, dst, p0, C.new_multicycle_partials(
        src[0].shape, cfg.dtype, device), scal, iscal)
    C.multicycle_plain(cfg, pairs, len(pairs), *ins)
    k = len(pairs) % 2
    for name, a, b in zip(FIELDS + ("p",), (src, dst)[k] + (p0,),
                          ins[k] + (ins[2],)):
        _equal(name, a[r], b[r])
    _equal("scal", scal, ins[3])
    if not torch.equal(iscal, ins[4]):
        raise KernelMismatch(f"iscal {iscal.tolist()} vs {ins[4].tolist()}")
    if int(iscal[K.IS_CYCLE]) != len(pairs):
        raise KernelMismatch(f"ran {int(iscal[K.IS_CYCLE])} cycles of "
                             f"{len(pairs)}")
    return 0.0


def check_pair(device, seed):
    """`tests/test_fuzz.py:158`'s case on the kernels: K4 (X first) against
    K1 then K2, and both against the plain versions."""
    p, f = pair_draw(seed)
    cfg, r = p.config, _real(p.config)
    src = tensors(f, "float64", device)
    x = launch_sweep(cfg, Axis.X, src, DT)
    y = launch_sweep(cfg, Axis.Y, x[:4], DT)
    pair = launch_cycle(cfg, True, src, DT)
    d = _scalar(src[0], DT)
    ref = C.cycle_plain(cfg, True, *src, d, d)
    for name, a, b, c in zip(FIELDS + ("p",), pair, y, ref):
        _equal(f"pair/per-sweep {name}", a[r], b[r])
        _equal(f"pair/plain {name}", a[r], c[r])
    for name, a, b, c in zip(("max|u|+c", "max|v|+c"), _maxima(pair[5]),
                             _maxima(y[5]), ref[5:]):
        _equal(f"pair/per-sweep {name}", a, b)
        _equal(f"pair/plain {name}", a, c)
    return 0.0


def commute_orders(cfg, src, xsweep):
    """`tests/test_fuzz.py:222-226`: order A fills the X ghosts, sweeps X,
    then fills the Y ghosts; order B fills the X ghosts, then the Y
    ghosts, then sweeps X. Returns (A, B), each (rho, u, v, E)."""
    a = K.fill_ghosts_plain(cfg, Axis.X, src)
    A = K.fill_ghosts_plain(cfg, Axis.Y, xsweep(a))
    B = xsweep(K.fill_ghosts_plain(cfg, Axis.Y, a))
    return A, B


def commute_cells(cfg):
    """What both orders define: the real columns over every row, the Y
    ghost rows included (the X ghost columns are dead after a sweep)."""
    g = cfg.nghost
    return (slice(None), slice(g, g + cfg.n_local[0]))


def check_commute(device, dtype):
    """The X sweep (K1, its ghost columns mirrored in-kernel) commutes
    with the orthogonal Y ghost fill, bit for bit, and both orders equal
    the plain version's."""
    p, f = pair_draw(COMMUTE_SEED, dtype)
    cfg = p.config
    src = tensors(f, dtype, device)
    d = _scalar(src[0], DT)
    A, B = commute_orders(cfg, src,
                          lambda s: launch_sweep(cfg, Axis.X, s, DT)[:4])
    pA, pB = commute_orders(
        cfg, src, lambda s: K.sweep_plain(cfg, Axis.X, *s, d, (None, None))[:4])
    w = commute_cells(cfg)
    for name, a, b, c, e in zip(FIELDS, A, B, pA, pB):
        _equal(f"A/B {name}", a[w], b[w])
        _equal(f"A/plain {name}", a[w], c[w])
        _equal(f"plain A/B {name}", c[w], e[w])
    return 0.0


def check_fast(device, test, seed, scale):
    """f32 fast math (K1, K2, K4 X first) against the f64 plain version on
    the same f32 inputs, within the fast-math gate, whose wave speed is
    the largest of the reference's |u| and |v| and the input's c; returns
    the largest difference relative to its field's scale."""
    draw = biz_draw if test == "Bizarrium" else sweep_draw
    p32, f = draw(seed, scale, "float32", True)
    p64, _ = draw(seed, scale, "float64", False)
    c32, c64, r = p32.config, p64.config, _real(p32.config)
    src = tensors(f, "float32", device)
    wide = tuple(a.double() for a in src)
    dt = dt_of(c64, wide)
    d = _scalar(wide[0], dt)
    c = float(K.eos_prc_plain(c64, *wide)[2][r].abs().max())
    worst = 0.0
    for what, out, ref in (
            ("X", launch_sweep(c32, Axis.X, src, dt),
             K.sweep_plain(c64, Axis.X, *wide, d)),
            ("Y", launch_sweep(c32, Axis.Y, src, dt),
             K.sweep_plain(c64, Axis.Y, *wide, d)),
            ("cycle", launch_cycle(c32, True, src, dt),
             C.cycle_plain(c64, True, *wide, d, d))):
        speed = max(c, *(float(ref[k][r].abs().max()) for k in (1, 2)))
        worst = max(worst, _gated(f"{test} {what}", [a[r] for a in out[:5]],
                                  [b[r] for b in ref[:5]], speed))
    return worst


def card_checks():
    """The card's checks: (name, draws, fn) with fn(device) -> the largest
    difference over its draws (0 where bit for bit)."""
    checks = []
    for dtype in EXACT:
        for scale in CARD_SCALES:
            draws = [(s, scale, dtype) for s in SWEEP_SEEDS]
            checks.append((f"k1_k2 {dtype} x{scale}", draws, check_sweeps))
            checks.append((f"k4 {dtype} x{scale}", draws, check_cycle))
        checks.append((f"k5 {dtype}", [(s, dtype) for s in SWEEP_SEEDS
                                       if k5_fits(s, dtype)],
                       check_multicycle))
        checks.append((f"commute {dtype}", [(dtype,)], check_commute))
    checks.append(("pair float64", [(s,) for s in PAIR_SEEDS], check_pair))
    for test in ("Sod_circ", "Bizarrium"):
        for scale in CARD_SCALES:
            checks.append((f"fast {test} x{scale}",
                           [(test, s, scale) for s in SWEEP_SEEDS],
                           check_fast))
    return [(name, draws, _over(fn, draws)) for name, draws, fn in checks]


def _over(fn, draws):
    def run(device):
        worst = 0.0
        for draw in draws:
            try:
                worst = max(worst, fn(device, *draw))
            except KernelMismatch as e:
                raise KernelMismatch(f"{fn.__name__}{draw}: {e}") from None
        return worst
    return run
