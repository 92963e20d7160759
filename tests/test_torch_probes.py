"""The port's probes (`armon_torch/probes/`) against the TPU probes under
`scripts/`: each probe's plain version (CPU) on the same numpy inputs as
the script's own Pallas kernel, run in interpret mode
(`pltpu.force_tpu_interpret_mode`), or as its pure jnp function. The
scripts are imported as they are.

Tolerances, in units of f32 eps times the field's max |value| ("ulp of
scale"), each with its reason:
- bit for bit where XLA has nothing to rewrite: the mirror fill and its
  copy, the `io` and `light` levels, the min, abs+add, sqrt and divide
  chains;
- 2 ulp where XLA's algebraic simplifier folds constant multiplies and
  sums of the rate chains (add, mul, mul+add, select, the shift chains
  and the sum of the 16 chains itself);
- 4 ulp where XLA contracts multiply-adds in a sweep's chain (ROADMAP C):
  the f32 chain, the `sweep` level, the K4 variants against
  `run_variant`;
- 16 ulp for the `half` level: its Lagrangian length dX = dx + dt (us_p
  - us) runs at dt/dx = 0.82 and nears zero in places, where rho = dm /
  dX magnifies the contracted rounding;
- the float-float chain within 1e-8 of scale: XLA's rewrites break the
  script's error-free transformations (the port's pairs, held against
  f64 below, come within 2e-10 to 3e-8 of it after 12 sweeps);
- f64 within 1e-14 of scale (contractions at f64 rounding);
- the approximate reciprocal: the interpret mode's `pl.reciprocal(approx)`
  is ~1e-3 off an exact one, so it is held within 2e-3 of scale, and the
  port's chain (an exact reciprocal on the CPU) within 2 ulp of the same
  kernel with an exact one.
"""

import functools
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# The card's machine has no jax: there this file skips whole, and the
# probes' kernels are checked by tests/test_torch_kernels.py.
jax = pytest.importorskip("jax")
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import armon_tpu
from armon_tpu.parallel.blocking import cycle_chunk_rows
from armon_torch.probes import flip, ff, roofline, roofline_io, cycle_variants as cv
from armon_torch.ops.sweep import fill_ghosts_plain
from armon_torch.ops.reductions import real_slice
from armon_torch.utils.enums import Axis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
PROBES = {"flip": flip, "ff": ff, "roofline_io": roofline_io,
          "roofline": roofline, "cycle_variants": cv}


@pytest.fixture(scope="module")
def scripts():
    """The TPU probe scripts. Importing them points JAX's compilation
    cache at /tmp/jax_cache; the setting is put back."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    before = jax.config.jax_compilation_cache_dir
    from scripts import probe_flip, roofline_io as s_io, ff_probe, perf_probe
    from scripts import roofline as s_roof
    jax.config.update("jax_compilation_cache_dir", before)
    return SimpleNamespace(flip=probe_flip, io=s_io, roof=s_roof, ff=ff_probe,
                           perf=perf_probe)


def _ulps(got, want, mask=slice(None)):
    """Max abs difference in f32 eps times max |want| (on `mask`)."""
    got = np.asarray(got, np.float64)[mask]
    want = np.asarray(want, np.float64)[mask]
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) * EPS32))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------- flip

def test_flip_matches_script_kernels(scripts):
    x = np.random.default_rng(0).random((16, 256), dtype=np.float32)
    shape = jax.ShapeDtypeStruct(x.shape, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        mirror = pl.pallas_call(functools.partial(scripts.flip.kernel_mirror, 4, 256),
                                out_shape=shape)(x)
        copy = pl.pallas_call(scripts.flip.kernel_copy, out_shape=shape)(x)
    xt = torch.from_numpy(x)
    assert np.array_equal(np.asarray(mirror), flip.mirror_fill(xt).numpy())
    assert np.array_equal(np.asarray(copy), flip.copy(xt).numpy())


def _flip_pass_model(x, g, mirror, head, blocks, ft, unroll=8):
    """A numpy model of `flip_kernel`'s index logic (csrc/probe_stream.cu):
    `blocks` blocks of `ft` threads stride over the 16-byte vectors that
    start at flat index `head`, a block's `unroll` x `ft` vectors of one
    step contiguous, every vector tracking the column of its first element
    by adds; a vector that touches a row's first or last g columns gathers
    those elements from their source columns; the scalar head and tail
    take the rest."""
    rows, cols = x.shape
    xf = x.reshape(-1)
    n = xf.size
    nv = (n - head) // 4
    o = np.full(n, np.nan, np.float32)

    def src(c):
        return 2 * g - 1 - c if c < g else (cols - 2 * g + cols - 1 - c
                                            if c >= cols - g else c)

    step = (4 * unroll * blocks * ft) % cols
    for tid in range(blocks * ft):
        v0 = (tid // ft) * unroll * ft + tid % ft
        col = [(head + 4 * (v0 + k * ft)) % cols for k in range(unroll)]
        for v in range(v0, nv, unroll * blocks * ft):
            vks = [v + k * ft for k in range(unroll)]
            a = [xf[head + 4 * vk:head + 4 * vk + 4].copy() if vk < nv else None
                 for vk in vks]
            for k, vk in enumerate(vks):
                if mirror and vk < nv and (col[k] < g or col[k] + 3 >= cols - g):
                    e0 = head + 4 * vk
                    for i in range(4):
                        c, rs = col[k] + i, e0 - col[k]
                        if c >= cols:
                            c, rs = c - cols, rs + cols
                        if c < g or c >= cols - g:
                            a[k][i] = xf[rs + src(c)]
                col[k] = col[k] + step - (cols if col[k] + step >= cols else 0)
            for k, vk in enumerate(vks):
                if vk < nv:
                    o[head + 4 * vk:head + 4 * vk + 4] = a[k]
    for s in range(n - 4 * nv):
        e = s if s < head else s + 4 * nv
        c = e % cols
        o[e] = xf[e - c + src(c)] if mirror else xf[e]
    return o.reshape(rows, cols)


@pytest.mark.parametrize("cols", [16, 9, 10, 11, 8], ids=lambda c: f"cols{c}")
def test_flip_vector_pass_model(cols):
    """The flat float4 pass with its column fix-up equals the plain
    mirror fill (and the copy) bit for bit for cols % 4 in {0, 1, 2, 3}
    and at cols = 2 g, g = 4, from every 16-byte offset of the base and
    for grids whose steps wrap a vector's column past a row or more."""
    x = np.random.default_rng(cols).random((7, cols), dtype=np.float32)
    want = flip.mirror_plain(torch.from_numpy(x)).numpy()
    for head in (0, 1, 2, 3):
        for blocks, ft in ((1, 1), (2, 1), (1, 3), (3, 2)):
            assert np.array_equal(_flip_pass_model(x, 4, True, head, blocks, ft), want)
            assert np.array_equal(_flip_pass_model(x, 4, False, head, blocks, ft), x)


# ------------------------------------------------------ I/O-shape ladder

IO_ULPS = {"io": 0.0, "light": 0.0, "half": 16.0, "sweep": 4.0}


@pytest.mark.parametrize("level", roofline_io.LEVELS)
def test_roofline_io_level_matches_script(scripts, level):
    fields = roofline_io.physical_fields((128, 128), 3, "cpu")
    with pltpu.force_tpu_interpret_mode():
        out = scripts.io.make_kernel(128, 8, level)(
            tuple(jnp.asarray(f.numpy()) for f in fields), 1)
    ref = roofline_io.level_plain(level, *fields)
    for name, a, b in zip(("rho", "u", "v", "E"), out, ref):
        assert np.all(np.isfinite(b.numpy())), f"{level} {name}: not finite"
        d = _ulps(a, b.numpy())
        assert d <= IO_ULPS[level], f"{level} {name}: {d} ulp of scale"
    # The in-place wrapper takes the plain version on the CPU.
    p = torch.empty_like(fields[0])
    cur = tuple(f.clone() for f in fields)
    roofline_io.ladder(level, cur, p)
    for a, b in zip(cur + (p,), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("level", roofline_io.LEVELS)
def test_roofline_io_guards_against_nan(level):
    """A launch on the physical fields is finite. On the script's draws
    (all four fields in [1, 1.1], `scripts/roofline_io.py:121-122`) every
    level but `io` gives NaN, and the run's finiteness check refuses it."""
    fields = roofline_io.physical_fields((16, 64), 3, "cpu")
    p = torch.empty_like(fields[0])
    roofline_io.ladder(level, fields, p)
    roofline_io._finite(level, fields + (p,), "on physical fields")
    rng = np.random.default_rng(0)
    bad = tuple(torch.from_numpy(1.0 + 0.1 * rng.random((16, 64), dtype=np.float32))
                for _ in range(4))
    roofline_io.ladder(level, bad, p)
    if level == "io":
        roofline_io._finite(level, bad + (p,), "on the script's draws")
    else:
        with pytest.raises(AssertionError, match="not finite"):
            roofline_io._finite(level, bad + (p,), "on the script's draws")


# ---------------------------------------------------------------- rates

def _script_body(cls):
    roll = {"smem": 256, "shfl": 32}.get(cls)
    if roll:
        return lambda a, x, i: a + jnp.roll(a.reshape(-1, roll), 1 + i % 3,
                                            1).reshape(a.shape)
    return {"none": lambda a, x, i: a, "add": lambda a, x, i: a + x,
            "mul": lambda a, x, i: a * 1.0000001,
            # the script's "mul+add (fma)"; the card's fma rounds once
            "fma": lambda a, x, i: a * 1.0000001 + x,
            "mul_add": lambda a, x, i: a * 1.0000001 + x,
            "min": lambda a, x, i: jnp.minimum(a, x * (1.0 + i)),
            "select": lambda a, x, i: jnp.where(a > x * (0.5 + 0.01 * i),
                                                a * 0.9999, a),
            "abs_add": lambda a, x, i: jnp.abs(a) + x,
            "sqrt": lambda a, x, i: jnp.sqrt(a) + x,
            "div": lambda a, x, i: x / a,
            "rcp": lambda a, x, i: pl.reciprocal(a, approx=True) + x}[cls]


RATE_ULPS = {"min": 0.0, "abs_add": 0.0, "sqrt": 0.0, "div": 0.0, "rcp": 2e-3 / EPS32}


@pytest.mark.parametrize("cls", roofline.CLASSES)
def test_rate_class_matches_script(scripts, cls):
    x = np.random.default_rng(11).uniform(0.5, 1.5, (16, 128)).astype(np.float32)
    w = 16

    def run(body):
        with pltpu.force_tpu_interpret_mode():
            return pl.pallas_call(functools.partial(scripts.roof._rate_kernel, body, w),
                                  out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(x)

    got = roofline.rate_plain(cls, torch.from_numpy(x), w, 1).numpy()
    d = _ulps(got, run(_script_body(cls)))
    assert d <= RATE_ULPS.get(cls, 2.0), f"{cls}: {d} ulp of scale"
    if cls == "rcp":
        d = _ulps(got, run(lambda a, x_, i: 1.0 / a + x_))
        assert d <= 2.0, f"rcp with an exact reciprocal: {d} ulp of scale"


def test_census_matches_script(scripts):
    """The port's sweep against the script's: the same square root; 22
    divides there, 19 here (the remap's four `/ dx` are multiplies by
    the reciprocal, as XLA compiles the script's division by a constant,
    and the reciprocal is one 0-dim divide); the same shifts, but three
    more at +1 (the u, v and E flux differences contract the next cell's
    disp * Q, so disp and Q shift apart, `ops/fma.py`); the fused
    multiply-adds counted as one class."""
    ops, shifts = roofline.census()
    sops, srolls = scripts.roof.census()
    print("port  ", dict(ops), dict(shifts))
    print("script", dict(sops), dict(srolls))
    assert sops["div"] == 22 and ops["div"] == 19
    assert ops["sqrt"] == sops["sqrt"] == 1
    assert ops["fma"] == 30
    srolls = {k: v for k, v in srolls.items() if k}
    assert dict(shifts) == {**srolls, 1: srolls[1] + 3}


# --------------------------------------------------------- float-float

def test_ff_chains_match_script(scripts):
    n = 64
    fields = ff.init_arrays(n, np.random.default_rng(7))
    with pltpu.force_tpu_interpret_mode():
        o32 = scripts.ff.make_pallas_f32(n, 16)(
            tuple(jnp.asarray(a, jnp.float32) for a in fields))
        off = scripts.ff.make_pallas_ff(n, 16)(
            tuple(jnp.asarray(a) for f in fields for a in scripts.ff.ff_from_f64(f)))
    j32 = jax.jit(lambda *a: scripts.ff.chain_plain(*a, scripts.ff._sh, np.float32))(
        *(jnp.asarray(a, jnp.float32) for a in fields))
    p32 = ff.step_plain("f32", ff.inputs("f32", fields, "cpu"))
    pff = ff.step_plain("ff", ff.inputs("ff", fields, "cpu"))
    for name, a, b, c in zip(("rho", "u", "v", "E"), o32, j32, p32):
        assert _ulps(c, a) <= 4 and _ulps(c, b) <= 4, name
    got = ff.as_f64("ff", pff)
    want = ff.as_f64("ff", [torch.from_numpy(np.array(a)) for a in off])
    for name, a, b in zip(("rho", "u", "v", "E"), got, want):
        assert np.max(np.abs(a - b)) <= 1e-8 * np.max(np.abs(b)), name


def test_ff_f64_chain_matches_script(scripts):
    n = 64
    fields = ff.init_arrays(n, np.random.default_rng(7))
    with jax.enable_x64(True):
        want = jax.jit(lambda *a: scripts.ff.chain_plain(*a, scripts.ff._sh,
                                                         np.float64))(
            *(jnp.asarray(a, jnp.float64) for a in fields))
        want = [np.asarray(w) for w in want]
    got = ff.step_plain("f64", ff.inputs("f64", fields, "cpu"))
    for name, a, b in zip(("rho", "u", "v", "E"), got, want):
        assert np.max(np.abs(a.numpy() - b)) <= 1e-14 * np.max(np.abs(b)), name


def test_ff_accuracy_leg():
    """After 12 chained sweeps, float-float stays within 1e-7 of f64 (in
    the script's norm) and f32 is off by more than 100x that. Float-float
    does not reach f64's rounding: the script's constants (dt, eps,
    gamma) are f32 values with a zero low word."""
    fields = ff.init_arrays(32, np.random.default_rng(7))
    acc = ff.accuracy(fields, "cpu", 12)
    for name in ("rho", "u", "v", "E"):
        assert acc["ff"][name]["norm"] < 1e-7, (name, acc)
        assert acc["f32"][name]["norm"] > 100 * acc["ff"][name]["norm"], (name, acc)


# ------------------------------------------------------ cycle variants

SCRIPT_KW = {"base": {}, "no_p": dict(write_p=False),
             "no_dt": dict(do_dtmin=False),
             "no_p_dt": dict(write_p=False, do_dtmin=False),
             "no_roll": dict(no_roll=True), "stream": dict(stream_only=True),
             "first_order": {}, "base_w128": {}, "base_l32": {}}


def _script_stream(fields, chunk):
    """The script's `stream` output (:62-70): the chunk's sum of the four
    fields plus the first row of each halo block it touches, in its
    order."""
    rows = fields[0].shape[0]
    blocks = max(-(-rows // 8), 1)
    out = np.empty_like(fields[0])
    for i in range(-(-rows // chunk)):
        lo, hi = i * chunk, min((i + 1) * chunk, rows)
        above = 8 * max(i * (chunk // 8) - 1, 0)
        below = 8 * min((i + 1) * (chunk // 8), blocks - 1)
        s = fields[0][lo:hi] + fields[1][lo:hi] + fields[2][lo:hi] + fields[3][lo:hi]
        for f in fields:
            s = s + f[above] + f[below]
        out[lo:hi] = s
    return out


@pytest.mark.parametrize("name", list(cv.VARIANTS))
def test_cycle_variant_matches_script(scripts, name):
    """The variant's plain version against `run_variant` on Sod 48^2
    (56^2 padded) with the ghosts filled by mirror first (the script's
    kernel fills none), real cells only."""
    n = 48
    cfg, cfg_god = cv.configs(n, False, "cpu")
    c = cfg_god if name == "first_order" else cfg
    src = cv.random_fields(cfg, 0, "cpu")
    filled = fill_ghosts_plain(cfg, Axis.X, fill_ghosts_plain(cfg, Axis.Y, src))
    scheme = (dict(scheme="Godunov", projection="euler") if name == "first_order"
              else dict(scheme="GAD", projection="euler_2nd", riemann_limiter="minmod"))
    jcfg = armon_tpu.ArmonParameters(
        test="Sod", N=(n, n), data_type=np.float32, nghost=4, maxcycle=1,
        silent=5, measure_time=False, use_fast_math=False, **scheme).config
    rows, cols = jcfg.local_shape
    chunk = cycle_chunk_rows(rows, cols, 4)
    kw = dict(write_p=True, do_dtmin=True, stream_only=False, no_roll=False)
    kw.update(SCRIPT_KW[name])
    dt = np.float32(cv.DT)
    with pltpu.force_tpu_interpret_mode():
        out = scripts.perf.run_variant(jcfg, chunk, kw["write_p"], kw["do_dtmin"],
                                       kw["stream_only"], kw["no_roll"],
                                       *(jnp.asarray(f.numpy()) for f in filled),
                                       dt, dt)
    ref = cv.variant_plain(name, c, src, torch.tensor(dt))
    r = real_slice(cfg)
    if name == "stream":
        # The script writes its sum, halo touches included, to every
        # output; the port's p is the sum of the four fields alone, its
        # fields are copies.
        want = _script_stream([f.numpy() for f in filled], chunk)
        for k in range(5):
            assert _ulps(want, _np(out[k]), r) <= 2, f"stream output {k}"
        assert torch.equal(ref[4], ((filled[0] + filled[1]) + filled[2]) + filled[3])
        for a, b in zip(ref[:4], filled):
            assert torch.equal(a[r], b[r])
        return
    for k in range(4):
        d = _ulps(ref[k].numpy(), _np(out[k]), r)
        assert d <= 4, f"{name} field {k}: {d} ulp of scale"
    if ref[4] is not None and kw["write_p"]:
        assert _ulps(ref[4].numpy(), _np(out[4]), r) <= 4


# ------------------------------------------------------ the slice

SMALL = {"flip": ["--shapes", "16x256,8x264"], "ff": ["--n", "32", "--iters", "2"],
         "roofline_io": ["--n", "64", "--reps", "2"],
         "roofline": ["--n", "64", "--reps", "2"],
         "cycle_variants": ["--sizes", "24,40"]}


@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_entry_point_on_cpu(probe, capsys):
    """Each probe's `main` at a tiny size with --device cpu: the plain
    versions run, every time reads "not measured", nothing is NaN."""
    out = PROBES[probe].main(["--device", "cpu"] + SMALL[probe])
    text = capsys.readouterr().out
    assert '"not measured"' in text and "NaN" not in text
    assert out


@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_refuses_cuda_without_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run")
    with pytest.raises(RuntimeError, match="CUDA card"):
        PROBES[probe].run("cuda")


SMALL_CHECK = {"flip": dict(shapes=((16, 256), (8, 264))),
               "ff": dict(sizes=(32,)),
               "roofline_io": dict(shapes=((48, 1000), (16, 200))),
               "roofline": dict(cases=(((16, 256), 2),)),
               "cycle_variants": dict(sizes=(24,))}
ENTRY_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.mark.parametrize("probe", list(PROBES))
def test_probe_kernels_line_entries(probe, capsys):
    """Each probe's kernels-line entries, from its run and its check at a
    tiny size on the CPU, have every key; only the copy has a library
    call (`Tensor.copy_`), whose time on the CPU is "not measured"."""
    mod = PROBES[probe]
    res = mod.main(["--device", "cpu"] + SMALL[probe])
    errs = mod.check("cpu", **SMALL_CHECK[probe])
    capsys.readouterr()
    entries = mod.entries(res, errs)
    assert entries
    for e in entries:
        assert set(e) == ENTRY_KEYS, e["name"]
        assert e["max_abs_err"] == 0.0, e["name"]
        assert e["library_ms"] == ("not measured" if e["name"] == "flip_copy"
                                   else None), e["name"]
