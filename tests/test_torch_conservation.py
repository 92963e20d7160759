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

import numpy as np
import pytest
import torch

import armon_torch
from armon_torch.core import solver
from armon_torch.core.solver import make_conservation, make_init_fused
from armon_torch.core.step import make_time_loop_lean
from armon_torch.ops import sweep as K
from armon_torch.ops.reductions import (
    FfScratch, _ff_sum, conservation_scalar, conservation_vars, ff_sum,
    ff_sum_plain)

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


# ------------------------------------------------------------------ the card

ODD = [((1, 1), (1, 1)), ((1, 70), (1, 70)), ((53, 1), (53, 1)),
       ((129, 37), (129, 37)), ((1000, 334), (1000, 333)),
       ((100, 100), (100, 100))]


@pytest.mark.gpu
@pytest.mark.parametrize("block,real", ODD,
                         ids=[f"{b[0]}x{b[1]}" for b, _ in ODD])
def test_kernel_matches_plain_on_the_card(block, real):
    """K6 on a padded block (4 ghosts, `real` = (nx, ny) cells of it, the
    rest slack as on an uneven split's edge shard) against its plain
    version on CPU copies, bit for bit; twice on one scratch (the ticket
    resets), with an inf and a NaN, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    nx, ny = block
    cfg = armon_torch.ArmonParameters(test="Sod", N=(64, 64), nghost=4,
                                      data_type="float32",
                                      device="cuda").config
    shape = (ny + 8, nx + 8)
    scratch = FfScratch(real[1], torch.device("cuda", 0))
    for kind in KINDS:
        rho = torch.from_numpy(_data(shape, kind, 1))
        E = torch.from_numpy(_data(shape, "positive", 2))
        want = ff_sum_plain(cfg, rho, E, real)
        for _ in range(2):
            K.reset_launches()
            got = ff_sum(cfg, rho.cuda(), E.cuda(), real, scratch)
            assert K.LAUNCHES["ff_sum"] == 1
            assert _same_bits(got, want), (kind, got, want)
            assert int(scratch.ticket.item()) == 0
