"""The port's option-space fuzz (`armon_torch/fuzz.py`) on the CPU, held
against the JAX package's (`tests/test_option_fuzz.py`):

- `fuzz.sample` gives `_sample`'s dict, and leaves the generator where
  `_sample` does, for the seeds of every range that file parametrises, so
  that a seed names the same case in both;
- the random combination (`:89`) and the tiny grids (`:363`, on every
  route) against the JAX package's jnp tier, within the tolerance stated
  at `_close`;
- every oracle of the port at the JAX file's seeds (the port's own, on
  the kernels' plain versions or the op path as the seed draws), the
  output round trip also byte for byte against the JAX package's writer;
- the campaign's command line, and the card geometry: its first 50
  seeds, and the card smoke run's cases (`fuzz.CARD_SMOKE`, `chip_smoke.py`
  phase 18), reach every branch of `fuzz.REQUIRED`; those of its cases
  that are small run here.

Each case is a test of its own. Tier-1 runs the first seeds of each
range; the rest are marked `slow`, as the JAX file is.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import armon_tpu
from armon_tpu.core.solver import gather_state as jax_gather
from armon_tpu.io.output import write_state_file as jax_write_state_file
import test_option_fuzz as jax_fuzz

from armon_torch import fuzz
from armon_torch.interop import to_numpy
from armon_torch.utils.errors import SolverException

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX file's parametrised ranges, by its test's name.
JAX_RANGES = {
    "combination": range(14), "resume": range(100, 106),
    "compare": range(200, 205), "output": range(300, 305),
    "tiny_grid": range(400, 408), "reshard": range(500, 504),
    "sharded": range(600, 607), "ghost_poison": range(700, 707),
    "transpose": range(800, 808), "axis": range(900, 908),
}


def _slow_after(params, tier1):
    """`params` (tuples) as pytest parameters, those past the first
    `tier1` marked slow."""
    return [pytest.param(*p, marks=[pytest.mark.slow] if i >= tier1 else [])
            for i, p in enumerate(params)]


def _seeds(seeds, tier1):
    return _slow_after([(s,) for s in seeds], tier1)


@pytest.mark.parametrize("name", list(JAX_RANGES))
def test_sample_is_the_jax_sample(name):
    """The same dict and the same generator state after it, seed by seed."""
    for seed in JAX_RANGES[name]:
        a, b = fuzz.rng_for(seed), random.Random(fuzz.SEED_BASE + seed)
        assert fuzz.sample(a) == jax_fuzz._sample(b), seed
        assert a.getstate() == b.getstate(), seed


def _jax_run(opts):
    """The JAX package's jnp tier on `opts`: (stats, global host State)."""
    p = armon_tpu.ArmonParameters(**{**opts, "kernel_tier": "jnp",
                                     "return_data": True})
    js = armon_tpu.armon(p)
    return js, jax_gather(p, js.data)


def _close(port, jax, opts, fields=("rho", "u", "v", "E", "p")):
    """The port's run (params, stats) against the JAX package's jnp tier
    (stats, host State): equal cycles; t and dt within `tol` relative and
    every field's real cells within `tol` of max(|field|, 1), tol 1e-14 in
    f64 and 5e-6 in f32. Measured on seeds 0-31 (and the tiny grids'
    400-415), with the port contracting the multiply-adds XLA contracts:
    1.7e-15 of the scale in f64 and 5.6e-7 in f32, t and dt within
    2.4e-15 and 5.9e-7 relative; what is left comes from what else XLA
    does to the jitted program (ROADMAP C2). A field the JAX
    run leaves at rounding noise (Sod_y's u, 7.6e-8, where the port gives
    0) is why the scale is at least 1."""
    (p, st), (js, host) = port, jax
    tol = 1e-14 if np.dtype(opts["data_type"]).itemsize == 8 else 5e-6
    assert st.cycles == js.cycles
    for a, b in ((st.final_time, js.final_time), (st.last_dt, js.last_dt)):
        assert abs(a - b) <= tol * abs(b), (a, b)
    g = p.nghost
    data = to_numpy(st.data)
    for v in fields:
        a = np.asarray(getattr(host, v), np.float64)[g:-g, g:-g]
        b = np.asarray(getattr(data, v), np.float64)[g:-g, g:-g]
        scale = max(float(np.abs(a).max()), 1.0)
        assert float(np.abs(a - b).max()) <= tol * scale, v


@pytest.mark.parametrize("seed", _seeds(JAX_RANGES["combination"], 6))
def test_random_combination_against_jax(seed, tmp_path):
    """`:89`: the port's invariants oracle, and the run against the JAX
    package's jnp tier on the same options."""
    case = fuzz.plan("invariants", seed)
    out = fuzz.check(case, "cpu", tmp_path)
    _close(out["run"], _jax_run(case["opts"]), case["opts"])


@pytest.mark.parametrize("seed", _seeds(JAX_RANGES["tiny_grid"], 3))
def test_tiny_grid_against_jax(seed, tmp_path):
    """`:363`: grids barely wider than the ghost band; the port's routes
    (per-sweep, pair and multicycle where admitted, the op path) agree
    bit for bit (`routes_agree`), and each against the JAX package's jnp
    tier."""
    case = fuzz.plan("routes_agree", seed)
    out = fuzz.check(case, "cpu", tmp_path)
    assert "per_sweep" in out and "op" in out
    ref = _jax_run(case["opts"])
    for name, run in out.items():
        _close(run, ref, case["opts"], ("rho", "u", "v", "E"))


PORT_ORACLES = [
    ("axis_invariance", JAX_RANGES["axis"], 3),
    ("transpose_symmetry", JAX_RANGES["transpose"], 3),
    ("ghost_poison", JAX_RANGES["ghost_poison"], 3),
    ("resume", JAX_RANGES["resume"], 3),
    ("reshard_resume", JAX_RANGES["reshard"], 2),
    ("mesh_matches_single", JAX_RANGES["sharded"], 3),
    # no JAX counterpart: seeds of the random combination's range
    ("graphs_agree", range(8), 4),
    ("tiers_agree", range(4), 2),
]


@pytest.mark.parametrize("name,seed", [
    p for n, seeds, k in PORT_ORACLES
    for p in _slow_after([(n, s) for s in seeds], k)])
def test_port_oracle(name, seed, tmp_path):
    """The port's oracle at the JAX file's seeds (see `fuzz.py`)."""
    fuzz.check(fuzz.plan(name, seed), "cpu", tmp_path)


@pytest.mark.parametrize("seed", _seeds(JAX_RANGES["output"], 2))
def test_output_roundtrip(seed, tmp_path):
    """`:318`: the port's oracle, and its file byte for byte the JAX
    package's writer's on the same numpy state (ROADMAP A6's gate)."""
    case = fuzz.plan("output_roundtrip", seed)
    out = fuzz.check(case, "cpu", tmp_path)
    p, st = out["run"]
    jcfg = armon_tpu.ArmonParameters(**case["opts"]).config
    path = str(tmp_path / "jax.csv")
    jax_write_state_file(jcfg, to_numpy(st.data), path)
    with open(out["path"], "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("seed", _seeds((105, 21, 69), 1))
def test_thin_grid_poison_as_in_jax(seed):
    """ROADMAP C11, found by the card campaign: on a grid thinner than the
    stencil (card seeds 21, 46, 69, 72, 80, 88, 105, 107 of
    `ghost_poison`, which skips them) poison in the ghosts reaches the
    real cells, in the JAX package as in the port: both poisoned runs
    stop at the same cycle with an invalid dt; both clean runs complete."""
    import jax
    from armon_tpu.core.solver import make_init, make_jit_loop
    from armon_torch.core.solver import make_init_fused
    from armon_torch.core.step import make_time_loop_lean
    case = fuzz.plan("ghost_poison", seed, "card")
    assert case["skip"] and fuzz.thin_axes(case["opts"]) == [0]
    opts = {k: v for k, v in case["opts"].items() if k != "graphs"}
    jp = armon_tpu.ArmonParameters(**dict(opts, kernel_tier="jnp"))
    cfg = jp.config
    g, (nx, ny) = cfg.nghost, cfg.n_local
    big = 1e100 if np.dtype(cfg.dtype).itemsize == 8 else 1e30
    ghost = np.ones(cfg.local_shape, bool)
    ghost[g:g + ny, g:g + nx] = False
    results = []
    for poison in (False, True):
        st = make_init(jp)()
        if poison:
            st = st._replace(**{v: jax.numpy.asarray(np.where(
                ghost, big, np.asarray(getattr(st, v))))
                for v in ("rho", "u", "v", "E", "p", "c", "g")})
        r = make_jit_loop(jp)(st)
        want = (int(r[2]), bool(r[5]))
        tp = fuzz._params(opts, "cpu")
        [fs], seed0 = make_init_fused(tp)()
        if poison:
            fs = fs._replace(**{v: torch.where(
                torch.from_numpy(ghost), big, getattr(fs, v))
                for v in fs._fields})
        res = make_time_loop_lean(tp.config)([fs], 0.0, 0, 0.0, float(seed0))
        assert (res.cycles, res.ok) == want, (poison, want)
        results.append(want)
    assert results[0] == (opts["maxcycle"], True) and not results[1][1]


def test_fast_math_gate_scales_velocities_by_the_wave_speed():
    """ROADMAP C12: under fast math, a velocity one side leaves at 0 and
    the other at rounding noise (card seeds 46 and 535 of `routes_agree`:
    u 1.6e-10 and 8.0e-11 on one-column grids) passes against the case's
    wave speed; an error of 1e-3 of it fails, as does any difference in
    exact mode."""
    case = fuzz.plan("routes_agree", 535, "card")
    one = torch.ones(3, 3)
    ref = {"rho": one, "u": torch.zeros(3, 3), "v": 0.5 * one, "E": one}
    noise = dict(ref, u=torch.full((3, 3), 8e-11))
    fuzz._gate(case, noise, ref, True, "noise", speed=1.2)
    for got, fast in ((dict(ref, u=torch.full((3, 3), 1.2e-3)), True),
                      (noise, False)):
        with pytest.raises(fuzz.FuzzFailure, match="u differs"):
            fuzz._gate(case, got, ref, fast, "error", speed=1.2)


def test_campaign_command_line():
    """`python -m armon_torch.fuzz 0 2 --device cpu` runs every oracle,
    prints a line a case and the summary, and exits 0; `cuda` without a
    card raises before any case runs."""
    out = subprocess.run(
        [sys.executable, "-m", "armon_torch.fuzz", "0", "2", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    summary = json.loads(lines[-1])
    assert summary["failures"] == 0 and summary["device"] == "cpu"
    assert set(summary["fuzz"]) == set(fuzz.ORACLES)
    assert all(c["ok"] >= 1 and c["fail"] == 0
               for c in summary["fuzz"].values())
    assert sum(ln.startswith("[") for ln in lines) == summary["runs"]
    if not torch.cuda.is_available():
        with pytest.raises(SolverException, match="cuda"):
            fuzz.main(["0", "1", "--device", "cuda"])


def test_card_geometry_reaches_every_branch_in_50_seeds():
    """The card geometry's first 50 seeds reach every branch of
    `fuzz.REQUIRED` (the runs planned here, on no card)."""
    hits = set()
    for seed in range(50):
        hits |= fuzz.branches(fuzz.sample(fuzz.rng_for(seed), "card"),
                              conservation=True)
    assert set(fuzz.REQUIRED) <= hits, set(fuzz.REQUIRED) - hits


def test_card_smoke_cases_reach_every_branch():
    """Phase 18's cases: at least 8 seeds an oracle, none of them a skip,
    every branch of `fuzz.REQUIRED` reached."""
    hits = set()
    for name in fuzz.ORACLES:
        seeds = fuzz.CARD_SMOKE[name]
        assert len(set(seeds)) >= 8, name
        for seed in seeds:
            case = fuzz.plan(name, seed, "card")
            assert not case.get("skip"), (name, seed)
            hits |= fuzz.case_branches(case)
    assert set(fuzz.REQUIRED) <= hits, set(fuzz.REQUIRED) - hits


@pytest.mark.parametrize("name", list(fuzz.ORACLES))
def test_card_smoke_cases_hold_here(name, tmp_path):
    """Phase 18's cases of 20,000 cells or fewer on the CPU (the kernels'
    plain versions): every oracle holds."""
    ran = 0
    for seed in fuzz.CARD_SMOKE[name]:
        case = fuzz.plan(name, seed, "card")
        if max(o["N"][0] * o["N"][1] for o in case["runs"]) <= 20_000:
            (tmp_path / str(seed)).mkdir()
            fuzz.check(case, "cpu", tmp_path / str(seed))
            ran += 1
    assert ran >= 3
