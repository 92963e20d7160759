"""The port's driver entry points (`armon_torch/entry.py`) on the CPU, the
counterparts of the JAX package's `__graft_entry__.py:26` (`entry`) and
`:46` (`dryrun_multichip`)."""

import numpy as np
import pytest
import torch

from armon_torch import entry as E
from armon_torch.core.solver import make_init_fused
from armon_torch.core.step import make_time_loop_lean
from armon_torch.utils.errors import SolverException

FIELDS = ("rho", "u", "v", "E", "p")


def test_entry_cycle_matches_lean_loop():
    """`entry()`'s fn from its example args is one cycle of the lean loop
    (`make_time_loop_lean`) of the same configuration, bit for bit: the
    fields, the stale p and the next dt."""
    fn, (state, dt0, cycle) = E.entry("cpu")
    new, dt_next = fn(state, dt0, cycle)
    params = E._params(device="cpu", maxcycle=1)
    [fs], seed = make_init_fused(params)()
    res = make_time_loop_lean(params.config)(fs, 0.0, 0, 0.0, float(seed))
    assert res.cycles == 1 and res.ok
    for name in FIELDS:
        assert torch.equal(getattr(new, name), getattr(res.carry, name)), name
    assert float(dt_next) == res.dt_last
    # the input State is left as it was
    assert not torch.equal(new.rho, state.rho)
    assert torch.equal(state.rho, E.entry("cpu")[1][0].rho)


def test_entry_matches_jax_entry():
    """The same cycle as the JAX package's `entry()` (jitted): dt within
    1e-5 relative and the real cells within 1e-5 of max(1, |field|), the
    op path's f32 gate against the JAX package (XLA contracts
    multiply-adds; measured: an ulp)."""
    import jax
    import __graft_entry__ as jax_entry
    jfn, jargs = jax_entry.entry()
    jout, jdt = jax.jit(jfn)(*jargs)
    fn, args = E.entry("cpu")
    new, dt = fn(*args)
    assert abs(float(dt) - float(jdt)) <= 1e-5 * abs(float(jdt))
    r = (slice(4, -4), slice(4, -4))
    for name in FIELDS:
        a = np.asarray(getattr(jout, name))[r].astype(np.float64)
        b = getattr(new, name)[r].double().numpy()
        assert np.max(np.abs(a - b)) <= 1e-5 * max(1.0, np.max(np.abs(a))), \
            name


@pytest.mark.parametrize("n", [1, 2, 4, 6])
def test_dryrun_multichip(n):
    """`dryrun_multichip(n)` on n CPU shards: the mesh, the uneven cut and
    its gates (op path against both kernel routes bit for bit, drift
    within 1e-12, the reshard load)."""
    out = E.dryrun_multichip(n, "cpu")
    px, py = out["mesh"]
    assert px * py == n and px <= py
    assert out["N"] == [17 * px - (px > 1), 16 * py - (py > 1)]
    assert out["max_drift"] <= 1e-12 and out["dt"] > 0
    assert (out["reshard"] is None) == (n == 1)
    assert out["placement"] == f"{n} shards on the CPU"


def test_main(capsys):
    """`python -m armon_torch.entry [n] device=cpu`."""
    assert E.main(["device=cpu"]) == 0
    assert E.main(["2", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry OK" in out and "dryrun_multichip OK" in out


def test_refuses_without_card():
    """On the card by default: without one they raise, never falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SolverException, match="no CUDA card"):
        E.entry()
    with pytest.raises(SolverException, match="no CUDA card"):
        E.dryrun_multichip(2)
