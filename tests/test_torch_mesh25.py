"""The reference's largest process grids, (5,2), (2,5) and (5,5)
(`test/mpi.jl:464-475`), on the port in one process with every shard on
the CPU: the counterpart of `tests/test_mesh25.py` (which needs 25 virtual
JAX devices and a subprocess; the port's shards need none).

Each mesh, at N=100 and with both axes uneven at N=(99, 97) (the corner
shard short in both), runs Sod_circ f64 for 12 cycles bit for bit against
one device: exact IEEE arithmetic on every shard, and copies for the
ghosts. The (5,5) Sod golden run gives 0 differences through the
no-gather windowed comparator (`compare_sub_domain_with_golden`).
"""

import numpy as np
import pytest
import torch

import armon_torch
from armon_torch.io.subdomain import compare_sub_domain_with_golden

from conftest import ref_file, abs_tol, rel_tol

G = 4
FIELDS = ("rho", "u", "v", "E", "p")
MESHES = [(5, 2), (2, 5), (5, 5)]


def _params(P, N, test="Sod_circ", maxcycle=12):
    return armon_torch.ArmonParameters(
        test=test, N=N, P=P, data_type="float64", scheme="GAD",
        projection="euler_2nd", riemann_limiter="minmod", nghost=G,
        maxcycle=maxcycle, silent=5, device="cpu", return_data=True)


@pytest.mark.parametrize("N", [(100, 100), (99, 97)], ids=["even", "uneven"])
@pytest.mark.parametrize("P", MESHES, ids=lambda p: f"{p[0]}x{p[1]}")
def test_mesh25_equals_one_device(P, N):
    params = _params(P, N)
    cfg = params.config
    if N == (99, 97):
        assert cfg.uneven(0) and cfg.uneven(1), (N, P)
    mesh = armon_torch.armon(params)
    one = armon_torch.armon(_params((1, 1), N))
    assert (mesh.cycles, mesh.final_time, mesh.last_dt) == \
        (one.cycles, one.final_time, one.last_dt) and one.cycles == 12
    for name in FIELDS:
        a = getattr(mesh.data, name)[G:-G, G:-G]
        b = getattr(one.data, name)[G:-G, G:-G]
        assert torch.equal(a, b), f"{name} differs at N={N} P={P}"


def test_mesh25_golden_zero_diff():
    params = _params((5, 5), (100, 100), test="Sod", maxcycle=1000)
    stats = armon_torch.armon(params)
    _, ref_cycles, cnt, max_diff = compare_sub_domain_with_golden(
        params, stats.data, ref_file("Sod", np.float64),
        atol=abs_tol(np.float64), rtol=rel_tol(np.float64))
    assert stats.cycles == ref_cycles
    assert cnt == 0 and max_diff == 0, (cnt, max_diff)
