"""The port's command line (`python -m armon_torch`, `tests/test_cli.py`)
and public API (`armon_torch/__init__.py` against `armon_tpu.__all__`,
`tests/test_quality.py:25-30`), with the host/device round trip of a
mesh (`tests/test_mesh.py:251-279`), on the CPU."""

import numpy as np
import pytest
import torch

import armon_tpu
from armon_tpu.__main__ import _parse as jax_parse
import armon_torch
from armon_torch.__main__ import main, _parse
from armon_torch.core.solver import make_init, make_mesh
from armon_torch.interop import to_numpy

SPELLINGS = ["true", "False", "TRUE", "100,100", "(50,50)", "[50, 50]", "0.5",
             "1e-4", "100", "-3", "Sod", "Sod_circ", "float32", "trace",
             "a,b", "(1,x)", "None", "'quoted'"]


@pytest.mark.parametrize("value", SPELLINGS)
def test_parse_matches_jax(value):
    ours, theirs = _parse(value), jax_parse(value)
    assert ours == theirs and type(ours) is type(theirs)


def test_cli_run(tmp_path, capsys):
    rc = main(["test=Sod", "N=20,20", "maxcycle=2", "silent=4", "device=cpu",
               f"output_dir={tmp_path}", "write_output=true",
               "output_file=o.csv"])
    assert rc == 0
    assert (tmp_path / "o.csv").exists()
    assert "cycles:      2" in capsys.readouterr().out


def test_cli_bad_arg(capsys):
    assert main(["whoops"]) == 2
    assert "expected key=value" in capsys.readouterr().err


def test_public_api_matches_jax():
    """Every name `armon_tpu` exports resolves on `armon_torch`, and so
    does the port's own `FusedCarry`."""
    for name in armon_tpu.__all__ + ["FusedCarry"]:
        assert hasattr(armon_torch, name), name
        assert name in armon_torch.__all__, name
    for name in ("MAIN_VARS", "SAVED_VARS", "COMM_VARS"):
        assert getattr(armon_torch, name) == getattr(armon_tpu, name), name


@pytest.mark.parametrize("P,N", [((1, 1), (40, 40)), ((2, 2), (40, 40)),
                                 ((3, 2), (50, 50))])
def test_host_device_roundtrip(P, N):
    """`host_to_device(device_to_host(s))` gives back each shard's real
    cells and ghost bands bit for bit, and the whole shard on an even
    split (an uneven split's edge shards hold dead slack, which the
    scatter fills with the grid's last line); the gathered grid survives
    gather -> scatter -> gather on every split."""
    params = armon_torch.ArmonParameters(test="Sod_circ", N=N, P=P,
                                         device="cpu")
    shards = make_init(params)()
    host = armon_torch.device_to_host(params, shards)
    assert all(isinstance(a, np.ndarray) for a in host)
    gathered = armon_torch.gather_state(params, shards)
    for a, b in zip(host, to_numpy(gathered)):
        assert np.array_equal(a, b)
    back = armon_torch.host_to_device(params, host)
    assert len(back) == P[0] * P[1]
    again = armon_torch.device_to_host(params, back)
    for a, b in zip(host, again):
        assert np.array_equal(a, b)
    g = params.nghost
    for shard, s, b in zip(make_mesh(params), shards, back):
        wx, hy = shard.n_real  # the live window: real cells and ghosts
        for x, y in zip(s, b):
            assert torch.equal(x[:2 * g + hy, :2 * g + wx],
                               y[:2 * g + hy, :2 * g + wx])
            if N[0] % P[0] == 0 and N[1] % P[1] == 0:
                assert torch.equal(x, y)
    # tensors go in as numpy arrays do
    from_tensors = armon_torch.host_to_device(params, gathered)
    for s, b in zip(back, from_tensors):
        for x, y in zip(s, b):
            assert torch.equal(x, y)
