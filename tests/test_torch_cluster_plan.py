"""The cluster probe's plan (`armon_torch.probes.cluster.plan`, the function
its launch takes its row and column bands from; K5 as one thread-block
cluster) on the grids the routing sends to K5, at the edges of `multicycle_geom_ok`: f32 and f64, thin
(one 128-lane column block, as many rows as the cap allows), square and
wide (the fewest rows, as many columns as the cap allows), for the
smallest, the default and the largest ghost band. Exact integer checks:
every real line of the band axis (the longer one) lies in exactly one
CTA's band, a CTA's shared memory is at most 227 KB (232448 bytes), and
the cluster has at most 16 CTAs."""

import numpy as np
import pytest

import armon_torch
from armon_torch.probes import cluster as P
from armon_torch.ops.routing import multicycle_geom_ok, route

SMEM_MAX = 232448


def _cfg(N, dtype, g):
    return armon_torch.ArmonParameters(
        test="Sod", N=N, data_type=dtype, nghost=g, scheme="Godunov",
        projection="euler", silent=5, device="cpu").config


def _admitted(cfg, nx, ny):
    g = cfg.nghost
    return multicycle_geom_ok(cfg, (ny + 2 * g, nx + 2 * g))


def _largest(ok, lo):
    """The largest n >= lo with ok(n), ok being true up to a point."""
    hi = lo
    while ok(hi * 2):
        hi *= 2
    hi *= 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return lo


def _edge(kind, dtype, g):
    """(nx, ny) of the admitted grid at the edge `kind`, and the grid one
    cell past it, which the routing refuses."""
    probe = _cfg((g, g), dtype, g)
    ny_min = max(g, 8 - 2 * g)
    if kind == "thin":
        nx = 128 - 2 * g
        ny = _largest(lambda n: _admitted(probe, nx, n), ny_min)
        return (nx, ny), (nx, ny + 1)
    if kind == "square":
        n = _largest(lambda n: _admitted(probe, n, n), max(g, ny_min))
        return (n, n), (n + 1, n + 1)
    if kind == "wide":
        nx = _largest(lambda n: _admitted(probe, n, ny_min), g)
        return (nx, ny_min), (nx + 1, ny_min)
    return (g, ny_min), None  # the smallest grid


@pytest.mark.parametrize("kind", ["thin", "square", "wide", "smallest"])
@pytest.mark.parametrize("g", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plan_covers_admitted_extremes(dtype, g, kind):
    (nx, ny), past = _edge(kind, dtype, g)
    cfg = _cfg((nx, ny), dtype, g)
    assert route(cfg) == "multicycle"
    if past is not None:
        assert not _admitted(cfg, *past)
    plan = P.plan((nx, ny), dtype)
    assert plan is not None
    c = plan["cluster"]
    assert c == P.CLUSTER <= 16
    # Every real row in exactly one CTA's rows, every real column in
    # exactly one CTA's columns, each layout within a plane.
    for n, band, pitch, other in ((ny, plan["band_r"], plan["pitch_r"], nx),
                                  (nx, plan["band_c"], plan["pitch_c"], ny)):
        owned = np.zeros(n, dtype=int)
        for r in range(c):
            owned[r * band:min((r + 1) * band, n)] += 1
        assert (owned == 1).all()
        assert pitch >= band and pitch % 2 == 1
        assert other * pitch <= plan["plane"]
    size = np.dtype(dtype).itemsize
    assert plan["smem"] == P.HEAD + P.PLANES * plan["plane"] * size
    assert plan["smem"] <= SMEM_MAX
    assert plan["threads"] <= 1024


@pytest.mark.parametrize("dtype,n_real", [
    ("float32", (100, 100)), ("float32", (240, 240)), ("float32", (120, 496)),
    ("float64", (120, 120)), ("float64", (120, 240)), ("float32", (3192, 4))],
    ids=["f32-100", "f32-240", "f32-120x496", "f64-120", "f64-120x240",
         "f32-3192x4"])
def test_plan_cluster_sizes(dtype, n_real):
    """16 CTAs (the most SMs one cluster takes), each band a sixteenth of
    its axis rounded up."""
    plan = P.plan(n_real, dtype)
    assert plan["cluster"] == 16
    assert plan["band_r"] == -(-n_real[1] // 16)
    assert plan["band_c"] == -(-n_real[0] // 16)


def test_plan_refuses_what_no_cluster_holds():
    assert P.plan((400, 400), "float32") is None


@pytest.mark.parametrize("n_real,dtype,want", [
    ((100, 100), "float32", 2 * 100 * 2 * 64),
    ((100, 100), "float64", 2 * 100 * 108),
    ((120, 496), "float32", 496 * 3 * 64 + 120 * 9 * 64),
    ((3192, 4), "float32", 4 * 57 * 64 + 3192 * 12)],
    ids=["100-f32", "100-f64", "120x496", "3192x4"])
def test_multicycle_positions(n_real, dtype, want):
    """Every real line whole: in f32 pieces of 32 lanes with runs of 2
    (64 positions, 56 written), in f64 runs of 4 (27 lanes for 108
    positions); a line of 4 cells in 6 lanes of 2."""
    assert P.positions(n_real, dtype) == want


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_probe_runs_its_plain_version_on_cpu(f64):
    """On the CPU the probe runs `multicycle_plain`: its rows say "not
    measured", its check finds the plain version equal to itself on the
    timed shapes and a thin, an odd-K and a Bizarrium case, and its
    kernels-line entry has every key."""
    sizes, f64_sizes = ((), (24,)) if f64 else ((24,), ())
    rows = P.run("cpu", sizes, f64_sizes)
    assert len(rows) == 1 and rows[0]["ms"] == "not measured"
    assert rows[0]["positions_per_cycle"] == P.positions((24, 24), rows[0]["dtype"])
    errs = P.check("cpu", sizes, f64_sizes, extremes=(
        ("Sod_circ", "float32", dict(N=(20, 36))),
        ("Sod_circ", "float64", dict(N=(24, 24), temporal_blocking=7)),
        ("Bizarrium", "float32", dict(N=(24, 24)))))
    assert errs == {P.NAME: 0.0}
    (entry,) = P.entries(rows, errs)
    assert set(entry) == {"name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms"}
    assert entry["source"] == P.SOURCE and entry["launches"] == 0
