"""The f32 conservation sums (K6 `ff_sum`, `armon_torch/csrc/reduce.cu`)
and their plain version `ops/reductions._ff_sum`, on the CPU, against an
independent scalar implementation of the order the kernel holds to and
against the JAX package's `conservation_vars`.

The order: per real row, a 2Sum over the columns from (0, 0); then a 2Sum
over the row sums in row order, and the rows' lo terms summed in row
order, sequentially in f32 from 0, added to the low word. Within the port
that is exact IEEE arithmetic, so bit for bit (a NaN equal to any NaN:
the card's NaN payload is not the CPU's). Against the JAX package, whose
scan runs in one XLA program on the CPU: the mass pair's high word bit for
bit (the same 2Sum order), the energy pair's within `ENERGY_HI_ULPS`
(measured 0 here: XLA's CPU program keeps the product rounded), the low
words differ (the JAX package adds the rows' lo terms with `jnp.sum`, in
XLA's order), and the combined f64 values agree within 1e-13 relative.

The card test (marked `gpu`, skipped without a card) holds the kernel
against the plain version bit for bit; it imports no JAX, so it runs on
the card as `python -m pytest --noconftest -m gpu
tests/test_torch_conservation.py`. The JAX package is imported inside the
tests that compare with it.
"""

import types

import numpy as np
import pytest
import torch

import armon_torch
from armon_torch.core import solver
from armon_torch.core.solver import make_conservation, make_init_fused
from armon_torch.core.step import make_time_loop_lean
from armon_torch.ops import sweep as K
from armon_torch.ops.reductions import (
    FF_MAPS_KEPT, FfScratch, _ff_sum, conservation_scalar, conservation_vars,
    ff_load_path, ff_map_key, ff_sum, ff_sum_plain, real_slice)

ENERGY_HI_ULPS = 0
SHAPES = [(1, 1), (1, 9), (7, 1), (37, 129), (100, 100)]
SHAPE_IDS = ["1x1", "1x9", "7x1", "37x129", "100x100"]
KINDS = ["positive", "mixed", "inf_nan"]


def _two_sum(hi, lo, b):
    t = np.float32(hi + b)
    bp = np.float32(t - hi)
    err = np.float32(np.float32(hi - np.float32(t - bp)) + np.float32(b - bp))
    return t, np.float32(lo + err)


def _scalar_ff_sum(x):
    """The stated order, one f32 scalar at a time: a row's columns, then
    the rows."""
    x = np.asarray(x, np.float32)
    his, los = [], []
    for row in x:
        hi = lo = np.float32(0.0)
        for b in row:
            hi, lo = _two_sum(hi, lo, b)
        his.append(hi)
        los.append(lo)
    h = l = L = np.float32(0.0)
    for b, c in zip(his, los):
        h, l = _two_sum(h, l, b)
        L = np.float32(L + c)
    return np.array([h, np.float32(l + L)], np.float32)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return a.shape == b.shape and np.array_equal(nan, np.isnan(b)) and \
        np.array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32))


def _data(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 10.0 ** rng.integers(-3, 4, shape)
    if kind != "positive":
        x *= rng.choice([-1.0, 1.0], shape)
    x = x.astype(np.float32)
    if kind == "inf_nan":
        x.flat[rng.integers(x.size)] = np.inf
        x.flat[rng.integers(x.size)] = np.nan
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_ff_sum_plain_is_the_stated_order(shape, kind):
    """`_ff_sum` bit for bit against the scalar loop of the stated order,
    signed zeros, infinities and NaN included."""
    x = _data(shape, kind)
    assert _same_bits(_ff_sum(torch.from_numpy(x)), _scalar_ff_sum(x))


@pytest.mark.parametrize("test", ["Sod", "Sod_circ", "Sedov", "Bizarrium"])
def test_conservation_vars_against_jax(test):
    """A mid-run f32 state (five cycles of the port on the CPU) through the
    port's `conservation_vars` and the JAX package's."""
    import armon_tpu
    from armon_tpu.ops.reductions import (conservation_vars as jax_cons,
                                          conservation_scalar as jax_scalar)
    import jax.numpy as jnp
    opts = dict(test=test, N=(48, 40), data_type="float32", maxcycle=5)
    tp = armon_torch.ArmonParameters(device="cpu", silent=5, **opts)
    jp = armon_tpu.ArmonParameters(**opts)
    [fs], seed = make_init_fused(tp)()
    fs = make_time_loop_lean(tp.config)(fs, 0.0, 0, 0.0, float(seed)).carry
    m, e = conservation_vars(tp.config, fs.rho, fs.E)

    class State:
        rho = jnp.asarray(fs.rho.numpy())
        E = jnp.asarray(fs.E.numpy())
    jm, je = (np.asarray(v) for v in jax_cons(jp.config, State))
    assert _same_bits(m[0], jm[0])
    ulps = abs(int(e[0].view(np.int32)) - int(je[0].view(np.int32)))
    assert ulps <= ENERGY_HI_ULPS
    for ours, theirs in ((m, jm), (e, je)):
        a = conservation_scalar(tp.config, ours)
        b = jax_scalar(jp.config, theirs)
        assert abs(a - b) <= 1e-13 * abs(b)


@pytest.mark.parametrize("P,N", [((3, 1), (100, 100)), ((2, 2), (37, 29)),
                                 ((1, 3), (40, 50))],
                         ids=["3x1", "2x2-odd", "1x3"])
def test_uneven_split_sums_to_one_device(P, N):
    """An uneven split's shard sums, added in f64 in mesh order, against
    the one-device run's within 1e-13 (each shard's pair is the compensated
    sum of its own real cells, edge slack left out)."""
    opts = dict(test="Sod_circ", N=N, data_type="float32", device="cpu",
                silent=5)
    one = armon_torch.ArmonParameters(**opts)
    mesh = armon_torch.ArmonParameters(P=P, **opts)
    want = make_conservation(one)(make_init_fused(one)()[0])
    got = make_conservation(mesh)(make_init_fused(mesh)()[0])
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-13 * abs(b)


def test_cpu_sums_count_no_launch(capsys):
    """CPU tensors take the plain version: no `ff_sum` launch is counted,
    by a direct call or by the per-cycle driver's line a cycle."""
    K.reset_launches()
    params = armon_torch.ArmonParameters(test="Sod", N=(24, 24), maxcycle=3,
                                         data_type="float32", device="cpu",
                                         silent=1, check_result=True)
    [fs], _ = make_init_fused(params)()
    v = ff_sum(params.config, fs.rho, fs.E)
    assert v.dtype == np.float32 and v.shape == (4,)
    assert armon_torch.armon(params).cycles == 3
    capsys.readouterr()
    assert K.LAUNCHES["ff_sum"] == 0


def test_conservation_is_kept_across_calls():
    """The conservation function sits in the program cache under kind
    "conservation": equal params share it, `clear_cache` drops it, and
    the CPU keeps no scratch (`per_device_conservation_bytes` 0)."""
    solver.clear_cache()
    opts = dict(test="Sod", N=(24, 24), data_type="float32", device="cpu")
    a = armon_torch.ArmonParameters(**opts)
    fn = make_conservation(a)
    assert make_conservation(armon_torch.ArmonParameters(**opts)) is fn
    assert [k[-1] for k in solver._FN_CACHE] == ["conservation"]
    assert a.memory_required()["per_device_conservation_bytes"] == 0
    solver.clear_cache()
    assert not solver._FN_CACHE


# ------------------------------------------------- K6's load paths (host)

@pytest.mark.parametrize("cols,rho_off,E_off,path", [
    (108, 0, 0, "tma"), (1008, 256, 512, "tma"), (80, 16, 16, "tma"),
    (137, 0, 0, "cp_async"), (134, 0, 0, "cp_async"), (111, 0, 0, "cp_async"),
    (108, 4, 0, "cp_async"), (108, 0, 8, "cp_async"), (108, 12, 12, "cp_async")],
    ids=["cols%4=0", "cols%4=0-offsets", "cols%4=0-g5", "cols%4=1",
         "cols%4=2", "cols%4=3", "rho+4", "E+8", "both+12"])
def test_ff_load_path(cols, rho_off, E_off, path):
    """K6's load path is a pure function of the row stride and the two
    base addresses: TMA where all three are 16-byte aligned, else the
    4-byte copy path."""
    base = 1 << 20
    assert ff_load_path(cols, base + rho_off, base + (1 << 16) + E_off) == path


def test_ff_map_key():
    """The descriptors' key is both addresses and the block's shape: a
    view of other rows, or another field, is another key."""
    a, b = torch.zeros((12, 16)), torch.zeros((12, 16))
    assert ff_map_key(a, b) == (a.data_ptr(), b.data_ptr(), 12, 16)
    assert ff_map_key(a, b) == ff_map_key(a.view(12, 16), b)
    assert ff_map_key(a[:8], b[:8]) != ff_map_key(a, b)
    assert ff_map_key(b, a) != ff_map_key(a, b)


def test_ff_maps_cache():
    """A scratch's `FfMaps` encodes a key once while it is kept: a loop's
    two buffer sets alternate without encoding, a fifth key drops the
    least recently used one, which then encodes again."""
    calls = []

    def encoder(key):
        return lambda: calls.append(key) or f"maps {key}"
    maps = FfScratch(5, torch.device("cpu")).maps
    for _ in range(3):
        for key in ("even", "odd"):
            assert maps.get(key, encoder(key)) == f"maps {key}"
    assert calls == ["even", "odd"]
    for key in ("k3", "k4", "even", "k5"):
        maps.get(key, encoder(key))
    assert calls == ["even", "odd", "k3", "k4", "k5"]
    assert len(maps.kept) == FF_MAPS_KEPT
    maps.get("odd", encoder("odd"))  # dropped by k5: the oldest then
    maps.get("even", encoder("even"))  # kept: used again before k5
    assert calls == ["even", "odd", "k3", "k4", "k5", "odd"]


# The card's cases: (block (nx, ny) inside the ghosts, real (nx, ny), ghost
# width, base offset in floats): every row stride modulo 4, ghost widths
# 2, 4 and 5, real rows that are not a multiple of K6's 16, one-row and
# one-column blocks, an unaligned base (TMA's stride but not its base).
ODD = [((1, 1), (1, 1), 4, 0), ((1, 70), (1, 70), 4, 0),
       ((53, 1), (53, 1), 4, 0), ((129, 37), (129, 37), 4, 0),
       ((1000, 334), (1000, 333), 4, 0), ((100, 100), (100, 100), 4, 0),
       ((64, 64), (64, 64), 4, 0), ((130, 45), (130, 45), 2, 0),
       ((101, 33), (101, 33), 5, 0), ((70, 17), (70, 17), 5, 0),
       ((200, 16), (197, 15), 2, 0), ((1000, 1), (1000, 1), 2, 0),
       ((4, 300), (1, 300), 2, 0), ((1, 300), (1, 300), 5, 0),
       ((100, 100), (100, 100), 4, 1), ((1000, 1), (999, 1), 2, 3)]
ODD_IDS = [f"{b[0]}x{b[1]}-real{r[0]}x{r[1]}-g{g}" + (f"-off{o}" if o else "")
           for b, r, g, o in ODD]


def _odd_path(block, g, off):
    cols = block[0] + 2 * g
    return ff_load_path(cols, 4 * off, 4 * off)


def test_odd_cases_take_every_path():
    """The card test's cases reach both load paths, every row stride
    modulo 4 on the copy path, TMA at ghost widths 2, 4 and 5 and from an
    unaligned base, real rows off K6's 16, one-row and one-column blocks
    on both paths."""
    paths = [_odd_path(b, g, o) for b, _, g, o in ODD]
    cols = {(b[0] + 2 * g) % 4 for b, _, g, o in ODD}
    assert cols == {0, 1, 2, 3}
    assert {g for (b, _, g, o), p in zip(ODD, paths) if p == "tma"} == {2, 4, 5}
    assert {p for (b, _, g, o), p in zip(ODD, paths)
            if o and (b[0] + 2 * g) % 4 == 0} == {"cp_async"}
    for path in ("tma", "cp_async"):
        mine = [c for c, p in zip(ODD, paths) if p == path]
        assert any(r[1] % 16 for _, r, _, _ in mine)
        assert any(r[1] == 1 for _, r, _, _ in mine)
        assert any(r[0] == 1 for _, r, _, _ in mine)


def _odd_inputs(block, real, g, kind):
    shape = (block[1] + 2 * g, block[0] + 2 * g)
    cfg = types.SimpleNamespace(nghost=g, n_local=real)
    return cfg, _data(shape, kind, 1), _data(shape, "positive", 2)


@pytest.mark.parametrize("block,real,g,off", ODD, ids=ODD_IDS)
def test_ff_sum_plain_on_odd_blocks(block, real, g, off):
    """The plain version on the card test's blocks and ghost widths, over
    their real cells only (ghosts and slack poisoned with NaN), bit for
    bit against the scalar loop of the stated order."""
    cfg, rho, E = _odd_inputs(block, real, g, "mixed")
    rs = real_slice(cfg, real)
    keep = np.zeros(rho.shape, bool)
    keep[rs] = True
    rho[~keep] = np.nan
    E[~keep] = np.nan
    want = np.concatenate([_scalar_ff_sum(rho[rs]),
                           _scalar_ff_sum(rho[rs] * E[rs])])
    got = ff_sum_plain(cfg, torch.from_numpy(rho), torch.from_numpy(E), real)
    assert _same_bits(got, want)


# ------------------------------------------------------------------ the card

def _on_card(t, off):
    """A CUDA copy of `t` whose base sits `off` floats past an allocation's
    (a contiguous view: the kernel sees the same strides)."""
    if not off:
        return t.cuda()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device="cuda")
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("block,real,g,off", ODD, ids=ODD_IDS)
def test_kernel_matches_plain_on_the_card(block, real, g, off):
    """K6 on a padded block (`g` ghosts, `real` = (nx, ny) cells of it, the
    rest slack as on an uneven split's edge shard), on the load path the
    host picks, against its plain version on CPU copies, bit for bit;
    twice on one scratch (the ticket resets), with an inf and a NaN, one
    launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    scratch = FfScratch(real[1], torch.device("cuda", 0))
    for kind in KINDS:
        cfg, rho, E = _odd_inputs(block, real, g, kind)
        rho, E = torch.from_numpy(rho), torch.from_numpy(E)
        want = ff_sum_plain(cfg, rho, E, real)
        rc, Ec = _on_card(rho, off), _on_card(E, off)
        assert ff_load_path(rc.shape[1], rc.data_ptr(), Ec.data_ptr()) == \
            _odd_path(block, g, off)
        for _ in range(2):
            K.reset_launches()
            got = ff_sum(cfg, rc, Ec, real, scratch)
            assert K.LAUNCHES["ff_sum"] == 1
            assert _same_bits(got, want), (kind, got, want)
            assert int(scratch.ticket.item()) == 0
