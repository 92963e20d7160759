"""The port's example scripts (`examples/torch_*.py`) on the CPU at a small
N, against the JAX package's `armon()` on the same options (the JAX
scripts `examples/sod_profile.py:14-16`, `examples/sedov_animation.py:
14-16`, `examples/multichip.py:19-31`).

Each script's `main(argv)` takes `key=value` overrides of its defaults.
The files it writes have the names and count of the JAX package's, and
their values agree within the op path's bounds of the JAX package's
(`tests/test_torch_op_path.py::test_run_matches_jax_jnp_tier`: 1e-13 of
max(1, |column|) in f64, 1e-5 in f32, the scripts' own dtype; XLA
contracts multiply-adds in the JAX package's loop)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import armon_torch
from armon_torch.utils.errors import SolverException

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
DTYPES = pytest.mark.parametrize("dtype", ["float32", "float64"])
TOL = {"float32": 1e-5, "float64": 1e-13}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _argv(**opts):
    return [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in opts.items()]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _table(path):
    """A written file's numbers, a row a line (comma- or blank-separated)."""
    with open(path) as f:
        rows = [line.replace(",", " ").split() for line in f if line.strip()]
    return np.array(rows, dtype=np.float64)


def _same_files(tmp_path, example, dtype, **over):
    """Runs `example` through its `main` into tmp/p and the JAX package's
    `armon()` on the same options into tmp/j; returns the file names
    after holding every file's columns to each other."""
    import armon_tpu
    module = _load(example)
    ours, theirs = tmp_path / "p", tmp_path / "j"
    stats = module.main(["device=cpu"] + _argv(
        data_type=dtype, output_dir=str(ours), **over))
    js = armon_tpu.armon(armon_tpu.ArmonParameters(**{
        **module.DEFAULTS, **over, "data_type": dtype,
        "output_dir": str(theirs), "kernel_tier": "jnp"}))
    assert stats.cycles == js.cycles
    names = _files(ours)
    assert names == _files(theirs)
    for name in names:
        a, b = _table(theirs / name), _table(ours / name)
        assert a.shape == b.shape, name
        scale = np.maximum(1.0, np.abs(a).max(axis=0))
        assert np.all(np.abs(a - b) <= TOL[dtype] * scale), name
    return names


@DTYPES
def test_sod_profile_matches_jax(tmp_path, dtype):
    """Sod 48^2 to t=0.2 with `write_slices` and `check_result`: the three
    slices."""
    names = _same_files(tmp_path, "torch_sod_profile", dtype, N=(48, 48))
    assert names == ["sod_D_slice", "sod_X_slice", "sod_Y_slice"]


@DTYPES
def test_sedov_animation_matches_jax(tmp_path, dtype):
    """Sedov 48^2, 30 cycles, a frame every 10 and the final state."""
    names = _same_files(tmp_path, "torch_sedov_animation", dtype,
                        N=(48, 48), maxcycle=30, animation_step=10)
    assert names == ["anim/sedov_000", "anim/sedov_001", "anim/sedov_002",
                     "sedov"]


def test_multichip_matches_one_shard(tmp_path):
    """Sod_circ over 4 CPU shards (a 2x2 mesh of 24^2 shards) to t=0.2
    (20 cycles; `maxcycle` 40), `check_result`: it writes no file, its
    gathered result equals the one-shard run bit for bit, and the JAX
    package's 2x2 mesh within the f32 bound."""
    import armon_tpu
    from armon_tpu.core.solver import gather_state
    module = _load("torch_multichip")
    over = dict(maxcycle=40, return_data=True, output_dir=str(tmp_path))
    stats = module.main(["device=cpu", "shards=4", "per_shard=24"]
                        + _argv(**over))
    assert _files(tmp_path) == []
    one = armon_torch.armon(armon_torch.ArmonParameters(**{
        **module.DEFAULTS, **over, "N": (48, 48), "device": "cpu"}))
    assert (stats.cycles, stats.final_time, stats.last_dt) == \
        (one.cycles, one.final_time, one.last_dt) and stats.cycles > 10
    jp = armon_tpu.ArmonParameters(**{
        **module.DEFAULTS, **over, "N": (48, 48), "P": (2, 2),
        "kernel_tier": "jnp"})
    js = armon_tpu.armon(jp)
    assert js.cycles == stats.cycles
    jdata = gather_state(jp, js.data)
    r = (slice(4, -4), slice(4, -4))
    for v in ("rho", "u", "v", "E", "p"):
        got = getattr(stats.data, v)[r]
        assert torch.equal(got, getattr(one.data, v)[r]), v
        a = np.asarray(getattr(jdata, v))[r].astype(np.float64)
        assert np.max(np.abs(a - got.double().numpy())) <= \
            1e-5 * max(1.0, np.max(np.abs(a))), v


def test_multichip_mesh_choice(capsys):
    """The near-square mesh of the shard count (`examples/multichip.py:
    22-25`), printed; 6 shards of 8^2, 2 cycles."""
    module = _load("torch_multichip")
    stats = module.main(["device=cpu", "shards=6", "per_shard=8",
                         "maxcycle=2", "silent=5", "check_result=false"])
    assert "devices: 6 -> mesh 2x3" in capsys.readouterr().out
    assert stats.cycles == 2


@pytest.mark.parametrize("example", ["torch_sod_profile",
                                     "torch_sedov_animation",
                                     "torch_multichip"])
def test_examples_refuse_without_card(example):
    """On the card by default: without one they raise, never falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SolverException, match="no CUDA card"):
        _load(example).main([])
