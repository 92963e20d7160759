"""`armon_torch.ops.fma`: the exactly rounded fused multiply-add that the op
path and the kernels' plain versions take where the JAX package's XLA
program contracts a product into a sum.

Both forms, the tensor-operation construction (`emulated_fma`, what a CUDA
tensor takes) and the native `std::fma` that CPU tensors take, against
RN(a * b + c) computed in exact rational arithmetic (`fractions`): 10^5
seeded draws per dtype (ordinary values, cancellation, exponents across the
whole range, products on a rounding midpoint with a tiny c, subnormal
results, products near overflow) and every combination of twenty edge
values (signed zeros, infinities, NaN, subnormals, the largest finite,
values whose product overflows or underflows), bit for bit, signed zeros
included. And `jax.jit(lambda a, b, c: a * b + c)` on the CPU, the
contraction the JAX package's loop makes, gives the same bits.
"""

import functools
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax

from armon_torch.ops.fma import emulated_fma, fma

DRAWS = 100_000
KINDS = ("normal", "cancel", "wide", "ties", "subnormal", "overflow")


def _draws(dtype, seed):
    """(a, b, c) arrays of DRAWS values of `dtype`, an equal share of each
    kind in KINDS."""
    rng = np.random.default_rng(seed)
    f = np.finfo(dtype)
    n = DRAWS // len(KINDS) + 1
    mant = f.nmant + 1
    out = []
    for kind in KINDS:
        sgn = rng.choice([-1.0, 1.0], (3, n))
        if kind == "normal":
            a, b, c = rng.standard_normal((3, n))
        elif kind == "cancel":  # c within a few ulps of -a*b
            a, b = rng.standard_normal((2, n))
            c = -(a * b) * (1 + rng.integers(-4, 5, n) * 2.0 ** -mant)
        elif kind == "wide":
            a, b, c = np.ldexp(rng.uniform(1, 2, (3, n)) * sgn,
                               rng.integers(f.minexp - mant, f.maxexp, (3, n)))
        elif kind == "ties":  # a*b on a rounding midpoint, c tiny or 0
            h = mant // 2 + 1
            a = (rng.integers(2 ** (h - 1), 2 ** h, n) * 2 + 1).astype(float)
            b = np.full(n, 2.0 ** (mant - h) + 1)
            c = np.ldexp(rng.choice([-1.0, 0.0, 1.0], n),
                         rng.integers(f.minexp - mant, -mant, n))
        elif kind == "subnormal":  # |a*b + c| around the smallest normals
            ea = rng.integers(f.minexp // 2 - 20, f.minexp // 2 + 20, n)
            a = np.ldexp(rng.uniform(1, 2, n) * sgn[0], ea)
            b = np.ldexp(rng.uniform(1, 2, n), f.minexp - ea - rng.integers(-3, 8, n))
            c = np.where(rng.random(n) < 0.5,
                         -(a * b).astype(dtype).astype(float)
                         * (1 + rng.integers(-3, 4, n) * 2.0 ** -mant),
                         np.ldexp(rng.uniform(-2, 2, n), f.minexp - rng.integers(0, mant, n)))
        else:  # a*b beyond the largest finite, c bringing it back or not
            a = np.ldexp(rng.uniform(1, 2, n), f.maxexp - rng.integers(1, 8, n))
            b = np.ldexp(rng.uniform(1, 2, n) * sgn[1], rng.integers(0, 8, n))
            c = -np.sign(b) * np.ldexp(rng.uniform(1, 2, n), f.maxexp - 1) \
                * rng.choice([0.5, 1.0, -1.0], n)
        with np.errstate(over="ignore", under="ignore", invalid="ignore"):
            out.append([np.asarray(x, dtype=float).astype(dtype) for x in (a, b, c)])
    return [np.concatenate(v)[:DRAWS] for v in zip(*out)]


EDGES = [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 3.0, 0.1, -7.5,
         "tiny", "-tiny", "sub", "-sub", "max", "-max", "big", "-big",
         "small", "sqrt_max"]


def _edges(dtype):
    f = np.finfo(dtype)
    named = {"tiny": f.smallest_normal, "sub": f.smallest_subnormal * 3,
             "max": f.max, "big": np.sqrt(f.max) * 4, "small": np.sqrt(f.smallest_normal) / 4,
             "sqrt_max": np.sqrt(f.max)}
    vals = []
    for v in EDGES:
        if isinstance(v, str):
            neg = v.startswith("-")
            v = named[v.lstrip("-")] * (-1 if neg else 1)
        vals.append(v)
    vals = np.array(vals, dtype=dtype)
    a, b, c = np.meshgrid(vals, vals, vals, indexing="ij")
    return a.ravel(), b.ravel(), c.ravel()


def _round(e, dtype):
    """The exact rational `e` rounded to nearest-even in `dtype` (nonzero;
    overflow to a signed infinity)."""
    f = np.finfo(dtype)
    try:
        x = e.numerator / e.denominator  # correctly rounded to f64
    except OverflowError:
        return dtype(np.inf if e > 0 else -np.inf)
    if dtype == np.float64:
        return np.float64(x) if x != 0 else np.float64(np.copysign(0.0, float(e)))
    with np.errstate(over="ignore"):
        y = np.float32(x)
    cands = {y, np.nextafter(y, np.float32(np.inf)), np.nextafter(y, np.float32(-np.inf))}
    finite = [v for v in cands if np.isfinite(v)]
    best = min(finite, key=lambda v: (abs(Fraction(float(v)) - e),
                                      int(np.array(v).view(np.int32)) & 1))
    # past the last finite value's rounding boundary the result is infinite
    edge = Fraction(float(f.max)) + Fraction(2) ** (f.maxexp - 2 - f.nmant)
    if abs(e) >= edge:
        return np.float32(np.inf if e > 0 else -np.inf)
    if best == 0:
        return np.float32(np.copysign(0.0, float(e)))
    return best


def _reference(a, b, c, dtype):
    out = np.empty(len(a), dtype=dtype)
    for i, (x, y, z) in enumerate(zip(a.tolist(), b.tolist(), c.tolist())):
        if not (np.isfinite(x) and np.isfinite(y) and np.isfinite(z)):
            # the product of finite factors is exact: an infinite c wins
            with np.errstate(invalid="ignore", over="ignore"):
                out[i] = z if np.isfinite(x) and np.isfinite(y) else \
                    dtype(x) * dtype(y) + dtype(z)
            continue
        e = Fraction(x) * Fraction(y) + Fraction(z)
        if e == 0:  # IEEE: -0 only when both addends are -0
            p = dtype(x) * dtype(y)
            both = np.signbit(p) and np.signbit(z) if x == 0 or y == 0 else False
            out[i] = dtype(-0.0) if both else dtype(0.0)
            continue
        out[i] = _round(e, dtype)
    return out


@functools.lru_cache(maxsize=None)
def _drawn(dtype):
    """The draws and their exact results, made once per dtype for both
    forms."""
    a, b, c = _draws(dtype, 20260923)
    return a, b, c, _reference(a, b, c, dtype)


def _same(x, y):
    x, y = np.asarray(x), np.asarray(y)
    ints = np.int64 if x.dtype == np.float64 else np.int32
    nan = np.isnan(x) & np.isnan(y)
    return nan | (x.view(ints) == y.view(ints))


DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32],
                                 ids=["f64", "f32"])


@DTYPES
@pytest.mark.parametrize("form", ["emulated", "native"])
def test_fma_is_exactly_rounded(form, dtype):
    a, b, c, ref = _drawn(np.dtype(dtype).type)
    fn = emulated_fma if form == "emulated" else fma
    got = fn(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    ok = _same(got, ref)
    assert ok.all(), [(a[i], b[i], c[i], got[i]) for i in np.where(~ok)[0][:5]]


@DTYPES
@pytest.mark.parametrize("form", ["emulated", "native"])
def test_fma_edge_values(form, dtype):
    a, b, c = _edges(dtype)
    fn = emulated_fma if form == "emulated" else fma
    with np.errstate(all="ignore"):
        ref = _reference(a, b, c, dtype)
    got = fn(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    ok = _same(got, ref)
    assert ok.all(), [(a[i], b[i], c[i], got[i], ref[i]) for i in np.where(~ok)[0][:5]]


@DTYPES
def test_fma_matches_xla_contraction(dtype):
    """The contraction the JAX package's jitted jnp tier makes on the CPU,
    and the broadcast of a Python number in the dtype of the tensors."""
    rng = np.random.default_rng(7)
    a, b, c = rng.standard_normal((3, 20_000)).astype(dtype)
    xla = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    assert _same(fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy(), xla).all()
    half = np.asarray(jax.jit(lambda x, z: z - x * dtype(0.5))(a, c))
    assert _same(fma(torch.from_numpy(a), -0.5, torch.from_numpy(c)).numpy(), half).all()


@DTYPES
def test_emulated_fma_in_chunks(dtype, monkeypatch):
    """A call larger than `CHUNK` elements, broadcast operands included,
    gives the bits of one pass."""
    from armon_torch.ops import fma as F
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(rng.standard_normal((37, 129)).astype(dtype))
            for _ in range(2))
    c = torch.from_numpy(rng.standard_normal((1, 129)).astype(dtype))
    whole = F.emulated_fma(a, b, c)
    monkeypatch.setattr(F, "CHUNK", 1000)
    assert torch.equal(F.emulated_fma(a, b, c), whole)
    assert torch.equal(F.emulated_fma(a, -0.5, c), F.fma(a, -0.5, c))
