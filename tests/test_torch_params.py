"""The port's front-end (`armon_torch.params`) against the JAX package's:
same options, same derived configuration; same errors; no JAX inside."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import armon_tpu
import armon_torch
from armon_torch import SolverException
from armon_torch.core.splitting import split_schedules as torch_schedules
from armon_tpu.core.splitting import split_schedules as jax_schedules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPTION_SETS = [
    dict(test="Sod", N=(100, 100)),
    dict(test="Sod_y", N=(64, 48), data_type="float32"),
    dict(test="Sod_circ", N=(30, 70), cfl=0.5, maxtime=0.1,
         axis_splitting="Strang"),
    dict(test="Bizarrium", N=(40, 40), scheme="Godunov", projection="euler",
         nghost=2, axis_splitting="Godunov"),
    dict(test="Sedov", N=(50, 50), data_type=np.float32,
         riemann_limiter="superbee", dt_on_even_cycles=True),
    dict(test="Sedov", N=(33, 65), domain_size=(1.0, 2.0), origin=(0.5, 0.0)),
    dict(test="Sod", N=(16, 16), cst_dt=True, Dt=1e-3, maxcycle=7,
         axis_splitting="X_only", kernel_tier="pallas", pair_threshold=0,
         temporal_blocking=1, use_fast_math=False),
    dict(test="Sod_circ", N=(24, 40), kernel_tier="jnp",
         axis_splitting="Godunov"),
]


@pytest.mark.parametrize("opts", OPTION_SETS, ids=lambda o: o["test"] + "-" + "x".join(map(str, o["N"])))
def test_derived_config_matches_jax(opts):
    jp = armon_tpu.ArmonParameters(**opts)
    tp = armon_torch.ArmonParameters(device="cpu", **opts)
    jc, tc = jp.config, tp.config
    for field in ("dtype", "nghost", "n_global", "n_local", "domain_size",
                  "origin", "riemann", "limiter", "projection", "splitting",
                  "cfl", "maxtime", "maxcycle", "Dt", "cst_dt",
                  "dt_on_even_cycles", "pair_threshold",
                  "temporal_blocking", "fast_math", "kernel_tier"):
        assert getattr(jc, field) == getattr(tc, field), field
    for prop in ("dx", "dy", "local_shape", "gamma"):
        assert getattr(jc, prop) == getattr(tc, prop), prop
    assert repr(jc.test) == repr(tc.test)
    if opts["test"] == "Sedov":
        assert jc.test.r == tc.test.r and jc.test.r.dtype == tc.test.r.dtype
        assert dataclasses.astuple(jc.test.init_params()) == \
            dataclasses.astuple(tc.test.init_params())
    assert [[(int(a), f) for a, f in s] for s in jax_schedules(jc.splitting)] == \
        [[(int(a), f) for a, f in s] for s in torch_schedules(tc.splitting)]
    for side in armon_torch.Side:
        assert jc.test.boundary_factors(armon_tpu.Side(int(side))) == \
            tc.test.boundary_factors(side)


def test_unknown_options_raise():
    with pytest.raises(TypeError, match="unconsumed"):
        armon_torch.ArmonParameters(device="cpu", not_an_option=1)
    with pytest.raises(SolverException):
        armon_torch.ArmonParameters(device="cpu", test="Nope")
    with pytest.raises(SolverException):
        armon_torch.ArmonParameters(device="cpu", scheme="Roe")


@pytest.mark.parametrize("scheme,projection,floor", [
    ("GAD", "euler_2nd", 4), ("GAD", "euler", 3),
    ("Godunov", "euler_2nd", 3), ("Godunov", "euler", 2)])
def test_nghost_floor_is_stencil_sum(scheme, projection, floor):
    armon_torch.ArmonParameters(device="cpu", scheme=scheme,
                                projection=projection, nghost=floor)
    with pytest.raises(SolverException, match="ghost"):
        armon_torch.ArmonParameters(device="cpu", scheme=scheme,
                                    projection=projection, nghost=floor - 1)


@pytest.mark.parametrize("opt", [
    dict(P=(2, 1), num_processes=2),
    dict(coordinator_address="localhost:1234"),
], ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values()))))
def test_out_of_slice_options_raise(opt):
    """Multi-process runs (ROADMAP A10b) are the one route not ported: its
    options raise. `log_blocks`, `profiling` and `block_size` are accepted
    (`tests/test_torch_observability.py`)."""
    with pytest.raises(SolverException, match="ROADMAP queue A item 10b"):
        armon_torch.ArmonParameters(device="cpu", **opt)


@pytest.mark.parametrize("opt", [
    dict(write_output=True), dict(write_slices=True), dict(compare=True),
    dict(checkpoint_step=5), dict(animation_step=2), dict(silent=1),
    dict(silent=0),
], ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values()))))
def test_ported_options_accepted(opt):
    """The I/O and per-cycle driver options are accepted and kept as the
    JAX package keeps them."""
    ours = armon_torch.ArmonParameters(device="cpu", **opt)
    theirs = armon_tpu.ArmonParameters(**opt)
    key, value = next(iter(opt.items()))
    assert getattr(ours, key) == getattr(theirs, key) == value


def test_output_defaults_match_jax():
    """`silent` defaults to 0, as in the JAX package, and so does every
    other output option."""
    ours = armon_torch.ArmonParameters(device="cpu")
    theirs = armon_tpu.ArmonParameters()
    assert ours.silent == 0
    for key in ("silent", "output_dir", "output_file", "write_output",
                "write_ghosts", "write_slices", "output_precision",
                "animation_step", "checkpoint_step", "compare", "is_ref",
                "comparison_tolerance", "check_result", "return_data"):
        assert getattr(ours, key) == getattr(theirs, key), key


@pytest.mark.parametrize("tier,op_path", [
    ("torch", True), ("jnp", True), ("auto", False), ("cuda", False),
    ("pallas", False)])
def test_kernel_tier_selects_path(tier, op_path, monkeypatch):
    """"torch" and "jnp" run the op path's loop, every other tier the
    kernels' lean loop; nothing else chooses between them."""
    from armon_torch.core import solver
    called = []
    for name in ("make_time_loop", "make_time_loop_lean"):
        def spy(*args, _real=getattr(solver, name), _name=name):
            called.append(_name)
            return _real(*args)
        monkeypatch.setattr(solver, name, spy)
    p = armon_torch.ArmonParameters(device="cpu", N=(16, 16), maxcycle=2,
                                    kernel_tier=tier, silent=3)
    assert p.config.op_path is op_path
    assert ("op path" in p.describe()) is op_path
    assert armon_torch.armon(p).cycles == 2
    assert called == ["make_time_loop" if op_path else "make_time_loop_lean"]
    with pytest.raises(SolverException, match="kernel_tier"):
        armon_torch.ArmonParameters(device="cpu", kernel_tier="numpy")


def test_restore_and_checkpoint_hooks_raise(tmp_path):
    """`restore_from` and `checkpoint` run (ROADMAP A8): a missing snapshot
    raises, a hook's own error comes through, and a hook that finds
    nothing lets the run end."""
    p = armon_torch.ArmonParameters(device="cpu", N=(8, 8), maxcycle=1,
                                    silent=5)
    with pytest.raises(SolverException, match="not found"):
        armon_torch.armon(p, restore_from=str(tmp_path / "snapshot.npz"))

    def hook(label, *args, **kw):
        raise RuntimeError(label)
    with pytest.raises(RuntimeError, match="init_test"):
        armon_torch.armon(p, checkpoint=hook)
    assert armon_torch.armon(p, checkpoint=lambda *a, **k: False).cycles == 1


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        assert armon_torch.ArmonParameters(N=(8, 8)).device.type == "cuda"
    else:
        with pytest.raises(SolverException, match="no CUDA card"):
            armon_torch.ArmonParameters(N=(8, 8))
    assert armon_torch.ArmonParameters(device="cpu").device.type == "cpu"
    with pytest.raises(SolverException):
        armon_torch.ArmonParameters(device="tpu")


def test_memory_required_counts_loop_buffers():
    p = armon_torch.ArmonParameters(device="cpu", N=(100, 60), nghost=4,
                                    data_type="float32")
    mem = p.memory_required()
    field = 68 * 108 * 4
    assert mem["per_device_field_bytes"] == field
    assert mem["per_device_loop_bytes"] == 9 * field
    assert mem["per_device_state_bytes"] == 11 * field
    assert armon_torch.memory_required(p) == mem


def test_import_is_jax_free():
    code = ("import sys; import armon_torch, armon_torch.interop, "
            "armon_torch.ops.sweep, armon_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('armon_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

    pattern = re.compile(r"^\s*(import|from)\s+(jax|armon_tpu)\b|"
                         r"import_module\(\s*['\"](jax|armon_tpu)", re.M)
    pkg = os.path.join(REPO, "armon_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    assert not pattern.search(f.read()), name
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not pattern.search(f.read())
