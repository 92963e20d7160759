"""The kernel-math fuzz (`armon_torch/kernel_fuzz.py`), the port of the JAX
package's `tests/test_fuzz.py`: random smooth states and random scheme
combinations through one sweep, one cycle and the ghost fills.

On the CPU each case is held against the JAX package on the same draws:
the kernels' plain versions (`ops/sweep.sweep_plain`, `ops/cycle.
cycle_plain`) against `fused_sweep` in interpret mode, the jnp tier and
`fused_cycle_step`, and against each other bit for bit. The `gpu` tests
hold the hand-written kernels to their plain versions on the same draws
(`kernel_fuzz.card_checks`); they skip without a card.

Not ported (ROADMAP A14): `test_short_tail_chunk_strips` (`:95`, the TPU's
halo strips, A11), `test_slope_formulations_bitwise` (`:240`, the port
has only the `slope_shift` form) and `test_bizarrium_fast_eos_algebra`
(`:282`), whose card counterpart is the fast-math check here (the plain
versions divide in IEEE arithmetic, so the port has no CPU form of it);
the trace smoke test (`:270`) is `tests/test_torch_observability.py`'s.
"""

import numpy as np
import pytest
import torch

from armon_torch import kernel_fuzz as KF
from armon_torch.ops import cycle as C
from armon_torch.ops import sweep as K
from armon_torch.utils.enums import Axis

# `tests/test_fuzz.py:87`'s tolerance (jnp against the fused kernel)
RTOL, ATOL = 1e-12, 1e-14
# Two seeds in tier-1; the JAX file's others are slow, as that whole file is.
SLOW_SEEDS = (2, 3, 12, 13)


def _jax_state(params, fields):
    """The JAX package's State of the same draws, on the JAX file's
    `reference_params` (`tests/test_fuzz.py:42-60`)."""
    import jax.numpy as jnp
    from conftest import reference_params
    from armon_tpu.core.solver import make_init
    opts = {k: getattr(params, k) for k in ("scheme", "riemann_limiter",
                                             "projection")}
    if params.block_size is not None:
        opts["block_size"] = params.block_size
    jp = reference_params("Sod_circ", np.float64, N=params.N, **opts)
    state = make_init(jp)()
    return jp.config, state._replace(
        **{k: jnp.asarray(a) for k, a in fields.items()})


def _t(fields):
    return KF.tensors(fields, "float64", "cpu")


@pytest.mark.parametrize("seed", [
    s if s not in SLOW_SEEDS else pytest.param(s, marks=pytest.mark.slow)
    for s in KF.SWEEP_SEEDS])
def test_random_state_sweep_matches_jax(seed):
    """`tests/test_fuzz.py:26-93`: one X and one Y sweep of the seed's
    random state through `sweep_plain`, against `fused_sweep` in
    interpret mode and the jnp tier (EOS, mirror fill, fluxes, update,
    remap) on the same state, within the JAX file's rtol 1e-12, atol
    1e-14 on real cells; the jnp tier, run op by op, gives the same bits
    (no multiply-add is contracted)."""
    from armon_tpu import Axis as JAxis
    from armon_tpu.ops.boundary import boundary_conditions
    from armon_tpu.ops.eos import update_eos
    from armon_tpu.ops.pallas.sweep import fused_sweep
    from armon_tpu.ops.projection import projection_remap
    from armon_tpu.ops.riemann import numerical_fluxes
    from armon_tpu.ops.update import cell_update

    params, fields = KF.sweep_draw(seed)
    cfg = params.config
    jcfg, state = _jax_state(params, fields)
    dt = np.float64(KF.DT)
    r = (slice(4, -4), slice(4, -4))
    for axis in (Axis.X, Axis.Y):
        ja = JAxis[axis.name]
        s1 = boundary_conditions(jcfg, update_eos(jcfg, state), ja)
        s2 = numerical_fluxes(jcfg, s1, ja, dt)
        s2 = cell_update(jcfg, s2, ja, dt)
        s2 = projection_remap(jcfg, s2, ja, dt)
        sbc = boundary_conditions(jcfg, state, ja, KF.FIELDS)
        fused = fused_sweep(jcfg, ja, sbc.rho, sbc.u, sbc.v, sbc.E, dt,
                            interpret=True)
        plain = K.sweep_plain(cfg, axis, *_t(fields),
                              torch.tensor(KF.DT, dtype=torch.float64))
        for k, name in enumerate(KF.FIELDS):
            ours = plain[k][r].numpy()
            jnp_tier = np.asarray(getattr(s2, name))[r]
            assert np.allclose(ours, np.asarray(fused[k])[r], rtol=RTOL,
                               atol=ATOL), (seed, axis, name)
            assert np.allclose(ours, jnp_tier, rtol=RTOL, atol=ATOL), \
                (seed, axis, name)
            assert np.array_equal(ours, jnp_tier), (seed, axis, name)


@pytest.mark.parametrize("seed", KF.PAIR_SEEDS)
def test_pair_cycle_matches_per_sweep(seed):
    """`tests/test_fuzz.py:158-197`: one cycle of the pair route's plain
    version (`cycle_plain`: both ghost bands filled from the pre-cycle
    state, then both sweeps) against the per-sweep route's (an X then a Y
    `sweep_plain`, each filling its own band) on uniform random states:
    bit for bit on real cells, the CFL maxima too. The JAX file's 1e-12
    exists only for XLA's contractions (its docstring); the port's
    result is held within it against the JAX package's
    `fused_cycle_step`."""
    from armon_tpu import Axis as JAxis
    from armon_tpu.core.step import fused_cycle_step

    params, fields = KF.pair_draw(seed)
    cfg = params.config
    dt = torch.tensor(KF.DT, dtype=torch.float64)
    x = K.sweep_plain(cfg, Axis.X, *_t(fields), dt)
    y = K.sweep_plain(cfg, Axis.Y, *x[:4], dt)
    mx, my = K.cfl_partial_plain(cfg, y[1], y[2], y[5])
    pair = C.cycle_plain(cfg, True, *_t(fields), dt, dt)
    r = (slice(4, -4), slice(4, -4))
    for name, a, b in zip(KF.FIELDS + ("p",), pair, y):
        assert torch.equal(a[r], b[r]), name
    assert torch.equal(pair[5], mx) and torch.equal(pair[6], my)

    jcfg, state = _jax_state(params, fields)
    s2, lm2, _ = fused_cycle_step(jcfg, state, ((JAxis.X, 1.0),
                                                (JAxis.Y, 1.0)),
                                  np.float64(KF.DT))
    for k, name in enumerate(KF.FIELDS + ("p",)):
        assert np.allclose(pair[k][r].numpy(),
                           np.asarray(getattr(s2, name))[r],
                           rtol=RTOL, atol=ATOL), name
    lm = float(KF.cfl_limit(cfg, pair[5], pair[6]))
    assert abs(lm - float(lm2)) <= 1e-12 * abs(float(lm2))


def test_sweep_commutes_with_orthogonal_ghost_fill_bitwise():
    """`tests/test_fuzz.py:200-236`, the pair route's validity argument:
    X-fill, X-sweep, Y-fill (order A) equals X-fill, Y-fill, X-sweep
    (order B) bit for bit on every cell both define (the real columns
    over every row, the Y ghost rows included): the Y mirror flips v,
    which the X sweep maps oddly and exactly, and keeps u, which it maps
    as it is. A Y mirror with its u and v factors swapped breaks it."""
    params, fields = KF.pair_draw(KF.COMMUTE_SEED)
    cfg = params.config
    dt = torch.tensor(KF.DT, dtype=torch.float64)
    A, B = KF.commute_orders(cfg, _t(fields), lambda s: K.sweep_plain(
        cfg, Axis.X, *s, dt, (None, None))[:4])
    w = KF.commute_cells(cfg)
    assert w[1].stop - w[1].start == cfg.n_local[0]
    for name, a, b in zip(KF.FIELDS, A, B):
        assert torch.equal(a[w], b[w]), name
    # Not vacuous: the Y ghost rows mirror the swept rows, v negated.
    g = cfg.nghost
    assert torch.equal(A[2][g - 1, w[1]], -A[2][g, w[1]])
    assert torch.equal(A[1][g - 1, w[1]], A[1][g, w[1]])


@pytest.mark.parametrize("name", [n for n, _, _ in KF.card_checks()
                                  if "x8" not in n])
def test_card_checks_run_on_cpu(name):
    """Each card check's control flow on CPU tensors, at the JAX file's N
    only (the 8x grids are the card's), where every wrapper runs its
    plain version (a plain version against itself: the check's code, not
    the kernels)."""
    [(_, draws, run)] = [c for c in KF.card_checks() if c[0] == name]
    assert draws
    assert run("cpu") <= KF.FAST_TOL


# ------------------------------------------------------------------ the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n, _, _ in KF.card_checks()])
def test_kernels_on_card(card, name):
    """The `gpu` twin of the tests above: each check of `card_checks` on
    the card, K1/K2/K4/K5 and the commutation bit for bit against the
    plain versions in exact mode, f32 fast math (Sod_circ and Bizarrium)
    within the fast-math gate of the f64 plain version; and every kernel
    the check names launched."""
    [(_, draws, run)] = [c for c in KF.card_checks() if c[0] == name]
    before = dict(K.LAUNCHES)
    assert run(card) <= KF.FAST_TOL
    kernel = {"k1_k2": "x_sweep", "k4": "cycle", "k5": "multicycle",
              "commute": "x_sweep", "pair": "cycle", "fast": "cycle"}
    assert K.LAUNCHES[kernel[name.split()[0]]] > before[kernel[name.split()[0]]]
