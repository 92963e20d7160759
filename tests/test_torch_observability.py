"""The port's observability layer (`armon_torch/utils/profiling.py`,
`solver_log.py`, `domain_ranges.py`, `core/solver.measure_sections`) and
the front-end options that reach it, on the CPU against the JAX package
(`tests/test_observability.py`, `tests/test_fuzz.py:270`).

- The section timer: the JAX package's keys and call counts on both
  tiers, at `silent` 5 and 1.
- The solver log: each cycle's (cycle, t, dt) equal to the JAX package's,
  bit for bit on Sod through the kernels' plain versions, within rtol
  1e-15 elsewhere (measured: an ulp, from what XLA does to the jitted
  program beyond the multiply-adds the port contracts, ROADMAP C2);
  `analyse()`'s
  keys and the section probes' keys per tier; a 2x2 mesh.
- The trace: `profiling=["trace"]` writes a Chrome trace, and with
  `log_blocks` its per-op table replaces the probes as `sections`.
- `log_blocks`, `profiling` and `block_size` are accepted as the JAX
  package accepts them; `block_size` changes nothing; `memory_required`
  has the JAX package's keys.

Grids are 40^2, f64, 3-5 cycles; the JAX runs are shared through a cache.
"""

import functools

import numpy as np
import pytest

import armon_tpu
from armon_tpu.utils import domain_ranges as jranges
from armon_tpu.utils.enums import Axis as JAxis
from armon_tpu.utils.solver_log import SolverLog as JSolverLog
import armon_torch
from armon_torch.interop import to_numpy
from armon_torch.params import (OP_PATH_PEAK_FIELDS, KERNEL_INIT_PEAK_FIELDS,
                                REHYDRATE_PEAK_FIELDS)
from armon_torch.utils import domain_ranges as tranges
from armon_torch.utils.enums import Axis as TAxis
from armon_torch.utils.solver_log import SolverLog, _COLLECTIVE_MARKERS

PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
BASE = dict(test="Sod", N=(40, 40), data_type=np.float64, maxcycle=5,
            silent=5)


@functools.lru_cache(maxsize=None)
def _jax_run(**opts):
    return armon_tpu.armon(armon_tpu.ArmonParameters(**opts))


def _jax(**opts):
    """A JAX package run, shared between the tests of this file."""
    return _jax_run(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in opts.items()})


def _port(**opts):
    return armon_torch.armon(armon_torch.ArmonParameters(device="cpu",
                                                         **opts))


# The JAX runs: the kernels' tier (per-sweep Pallas in interpret mode) and
# the jnp tier, one device and a 2x2 mesh.
J_KERNELS = dict(BASE, log_blocks=True, kernel_tier="pallas", **PER_SWEEP)
J_JNP = dict(BASE, test="Sod_circ", log_blocks=True, kernel_tier="jnp")
J_MESH = dict(J_JNP, P=(2, 2))


@pytest.mark.parametrize("silent", [5, 1])
@pytest.mark.parametrize("tier", ["auto", "torch"])
def test_timer_matches_jax(tier, silent, capsys):
    """`stats.timer`: the JAX package's sections and call counts,
    `conservation_vars` only where the run checks conservation."""
    opts = dict(BASE, maxcycle=3, silent=silent)
    theirs = _jax(**opts, kernel_tier="jnp").timer
    ours = _port(**opts, kernel_tier=tier).timer
    assert list(ours) == list(theirs)
    assert {k: v["calls"] for k, v in ours.items()} == \
        {k: v["calls"] for k, v in theirs.items()}
    assert all(v["seconds"] > 0 for v in ours.values())
    assert ("conservation_vars" in ours) is (silent <= 1)
    assert _port(**opts, measure_time=False).timer is None


def _events(stats):
    return [(e.cycle, e.t, e.dt) for e in stats.grid_log.events]


LOG_CASES = [
    # (port options, the JAX run, bit for bit)
    ("sod-kernels", dict(BASE, **PER_SWEEP), J_KERNELS, True),
    ("sod-pair", dict(BASE, temporal_blocking=1), J_KERNELS, True),
    ("sod_circ-op-path", dict(J_JNP, kernel_tier="torch"), J_JNP, False),
    ("sod_circ-2x2-op-path", dict(J_MESH, kernel_tier="torch"), J_MESH, False),
    ("sod_circ-2x2-kernels", dict(J_MESH, kernel_tier="auto"), J_MESH, False),
]


@pytest.mark.parametrize("opts,jopts,bitwise",
                         [c[1:] for c in LOG_CASES],
                         ids=[c[0] for c in LOG_CASES])
def test_solver_log_matches_jax(opts, jopts, bitwise):
    """`log_blocks`: one event a cycle with the JAX package's cycle, t and
    dt; `analyse()` with its keys; the section probes with its keys for
    the same tier, each > 0, their shares summing to 1."""
    theirs = _jax(**jopts)
    ours = _port(**dict(opts, log_blocks=True))
    a, b = _events(ours), _events(theirs)
    assert [e[0] for e in a] == [e[0] for e in b] == list(range(1, 6))
    if bitwise:
        assert a == b
    else:
        np.testing.assert_allclose([e[1:] for e in a], [e[1:] for e in b],
                                   rtol=1e-15, atol=0)
    ana, jana = ours.grid_log.analyse(), theirs.grid_log.analyse()
    assert set(ana) == set(jana)
    assert ana["sections_source"] == "probe"
    op = opts.get("kernel_tier") == "torch"
    jkeys = set(_jax(**(J_JNP if op else J_KERNELS)).grid_log.sections)
    assert set(ana["sections"]) == jkeys
    assert all(v > 0 for v in ana["sections"].values())
    assert abs(sum(ana["section_shares"].values()) - 1.0) < 1e-9
    assert "ms/cycle" in repr(ours.grid_log)
    # one more host read a cycle: the logged t and dt on the kernels
    assert ours.host_reads == (2 * 5 + 2 if not op else 5)


def test_solver_log_probes_leave_the_run_as_it_was():
    """The section probes run on copies: the final state and the CFL
    carry equal those of the same run without `log_blocks`, bit for bit."""
    opts = dict(BASE, return_data=True, silent=2, **PER_SWEEP)
    plain_params = armon_torch.ArmonParameters(device="cpu", **opts)
    plain = armon_torch.armon(plain_params)
    logged_params = armon_torch.ArmonParameters(device="cpu", log_blocks=True,
                                                **opts)
    logged = armon_torch.armon(logged_params)
    assert logged.grid_log.sections
    assert plain_params._final_local_min == logged_params._final_local_min
    for a, b in zip(to_numpy(plain.data), to_numpy(logged.data)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("log_blocks", [False, True])
def test_trace_writes_profile(tmp_path, log_blocks):
    """`profiling=["trace"]` writes a Chrome trace under
    `output_dir/profile` (`tests/test_fuzz.py:270`); with `log_blocks` its
    per-op table is `analyse()`'s `sections`, each op's calls counted, and
    the probes stay under `probe_sections`
    (`tests/test_observability.py:56-79`)."""
    stats = _port(**dict(BASE, profiling=["trace"], log_blocks=log_blocks,
                         output_dir=str(tmp_path)))
    prof = tmp_path / "profile"
    files = list(prof.glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    if not log_blocks:
        assert stats.grid_log is None
        return
    a = stats.grid_log.analyse()
    assert a["sections_source"] == "trace"
    assert a["sections"] and sum(a["sections"].values()) > 0
    assert all(v >= 0 for v in a["sections"].values())
    assert max(v["calls"] for v in a["trace_kernels"].values()) >= 5
    assert abs(sum(a["section_shares"].values()) - 1.0) < 1e-9
    assert a["probe_sections"]["sweep_X"] > 0
    assert "probe_section_shares" in a
    assert a["collective_seconds"] == 0.0  # no slab copy on one device


@pytest.mark.parametrize("profiling", [["nvtx"], "nvtx", ["trace", "x", "y"]])
def test_unknown_profiler_rejected(profiling):
    messages = []
    for pkg, extra in ((armon_tpu, {}), (armon_torch, dict(device="cpu"))):
        with pytest.raises(pkg.SolverException, match="Unknown profiler") as e:
            pkg.ArmonParameters(test="Sod", profiling=profiling, **extra)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _synthetic(cls, collective_names):
    log = cls(cell_count=100)
    for i, w in enumerate([0.010, 0.011, 0.020, 0.021]):
        log.push(i + 1, 0.1 * (i + 1), 1e-3, w)
    log.sections = {"sweep_X": 0.004, "sweep_Y": 0.005}
    log.trace_sections = {
        "void armon::x_sweep_kernel<float, true, false>": {"seconds": 0.06,
                                                           "calls": 4},
        collective_names[0]: {"seconds": 0.03, "calls": 8},
        collective_names[1]: {"seconds": 0.01, "calls": 4},
    }
    return log.analyse()


def test_solver_log_arithmetic_matches_jax():
    """`analyse()` on the synthetic events of `tests/test_observability.py:
    144-166`: every key equal to the JAX package's but the collective
    share, which each package takes from its own names (the port's: the
    slab copies' kernels, `_COLLECTIVE_MARKERS`)."""
    ours = _synthetic(SolverLog, ("void at::native::(anonymous namespace)::"
                                  "CatArrayBatchedCopy_contig<float>",
                                  "Memcpy PtoP (Device -> Device)"))
    theirs = _synthetic(JSolverLog, ("collective-permute.12", "all-reduce.7"))
    assert set(ours) == set(theirs)
    for key in ours:
        if key == "trace_kernels" or key.startswith(("sections",
                                                     "section_shares")):
            continue
        assert ours[key] == theirs[key], key
    assert list(ours["sections"].values()) == list(theirs["sections"].values())
    assert abs(ours["collective_seconds"] - 0.04) < 1e-12
    assert abs(ours["collective_wait_share"] - 0.4) < 1e-12
    assert all(m == m.lower() for m in _COLLECTIVE_MARKERS)
    assert _synthetic(SolverLog, ("all-reduce.7", "collective-permute.1")
                      )["collective_seconds"] == 0.0


@pytest.mark.parametrize("nghost", [2, 3, 4, 5])
@pytest.mark.parametrize("projection", ["euler", "euler_2nd"])
@pytest.mark.parametrize("axis", ["X", "Y"])
def test_steps_ranges_match_jax(axis, projection, nghost):
    n = (37, 23)
    ours = tranges.compute_steps_ranges(TAxis[axis], n, nghost, projection)
    theirs = jranges.compute_steps_ranges(JAxis[axis], n, nghost, projection)
    assert int(ours.axis) == int(theirs.axis)
    for name in ("real_domain", "full_domain", "eos", "fluxes",
                 "cell_update", "advection", "projection"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a.x, a.y, a.shape, a.size) == (b.x, b.y, b.shape, b.size), name
        assert a.array_slices(nghost) == b.array_slices(nghost), name


def test_domain_range_algebra_matches_jax():
    """The slice algebra of `tests/test_observability.py:94-118`."""
    for r, j in ((tranges.DomainRange((0, 10), (0, 8)),
                  jranges.DomainRange((0, 10), (0, 8))),
                 (tranges.DomainRange((-3, 5), (2, 2)),
                  jranges.DomainRange((-3, 5), (2, 2)))):
        for f in (lambda d, A: d.expand(A.X, 2, 3),
                  lambda d, A: d.expand(A.Y, 1, 0),
                  lambda d, A: d.shift(A.Y, 4), lambda d, A: d.shift(A.X, -1),
                  lambda d, A: d.inflate(4),
                  lambda d, A: d.intersect(type(d)((1, 4), (-1, 3)))):
            a, b = f(r, TAxis), f(j, JAxis)
            assert (a.x, a.y, a.shape, a.size) == (b.x, b.y, b.shape, b.size)
        assert r.array_slices(4) == j.array_slices(4)


OPTION_CASES = [dict(log_blocks=True), dict(profiling="trace"),
                dict(block_size=(8, 128))]


@pytest.mark.parametrize("opt", OPTION_CASES,
                         ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values()))))
def test_observability_options_accepted(opt, tmp_path):
    """The options that raised until the observability slice: accepted
    and kept as the JAX package keeps them, and the run equals the JAX
    package's (its per-sweep Pallas kernels in interpret mode)."""
    ours = armon_torch.ArmonParameters(device="cpu", **opt)
    theirs = armon_tpu.ArmonParameters(**opt)
    key, value = next(iter(opt.items()))
    assert getattr(ours, key) == getattr(theirs, key)
    stats = _port(**dict(BASE, **PER_SWEEP, **opt, return_data=True,
                         output_dir=str(tmp_path)))
    ref = _jax(**dict(J_KERNELS, return_data=True))
    eps = np.finfo(np.float64).eps
    assert stats.cycles == ref.cycles
    assert abs(stats.final_time - ref.final_time) <= 4 * eps * ref.final_time
    assert abs(stats.last_dt - ref.last_dt) <= 4 * eps * ref.last_dt
    g = 4
    for name in ("rho", "u", "v", "E", "p"):
        a = np.asarray(getattr(ref.data, name))[g:-g, g:-g]
        b = to_numpy(getattr(stats.data, name))[g:-g, g:-g]
        assert np.max(np.abs(a - b)) <= 1e-13 * max(1.0, np.abs(a).max()), name


def test_block_size_changes_nothing():
    """C7: a run with `block_size=(256, 32)` equals one without, bit for
    bit (`tests/test_observability.py:129-141`), and the launch shapes do
    not see it."""
    opts = dict(BASE, return_data=True, **PER_SWEEP)
    base = _port(**opts)
    alt_params = armon_torch.ArmonParameters(device="cpu", block_size=(256, 32),
                                             **opts)
    assert alt_params.block_size == (256, 32)
    alt = armon_torch.armon(alt_params)
    assert (alt.cycles, alt.final_time, alt.last_dt) == \
        (base.cycles, base.final_time, base.last_dt)
    for a, b in zip(to_numpy(base.data), to_numpy(alt.data)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("return_data", [False, True])
@pytest.mark.parametrize("P", [(1, 1), (2, 2)])
def test_memory_required_keys_and_counts(P, return_data):
    """C8: the JAX package's keys; the kernel path's figure is its loop
    (9 fields a shard, the slabs and the CFL partials, which the program
    cache keeps) beside the largest of a shard's initialisation with the
    earlier shards' carries and, with `return_data`, the rebuilt States
    and the gathered global one; the op
    path's is 22 fields a shard plus the measured temporaries,
    `OP_PATH_PEAK_FIELDS` fields in all for one shard."""
    opts = dict(test="Sod", N=(100, 60), P=P, nghost=4, data_type="float32",
                return_data=return_data)
    ours = armon_torch.ArmonParameters(device="cpu", **opts).memory_required()
    theirs = armon_tpu.ArmonParameters(**opts).memory_required()
    assert set(theirs) <= set(ours)
    px, py = P
    rows, cols = -(-60 // py) + 8, -(-100 // px) + 8
    field = rows * cols * 4
    shards = px * py
    slabs = sum(((ix > 0) + (ix < px - 1)) * rows * 4
                + ((iy > 0) + (iy < py - 1)) * 4 * cols
                for iy in range(py) for ix in range(px)) * 4 * 4
    partials = 2 * shards * 1 * 4  # one CFL partial a shard on the CPU
    rest = (5 * (shards - 1) + KERNEL_INIT_PEAK_FIELDS) * field
    if return_data:
        rest = max(rest, (10 * (shards - 1) + REHYDRATE_PEAK_FIELDS) * field)
        if shards > 1:
            rest = max(rest, 11 * shards * field + 11 * 68 * 108 * 4)
    fused = 9 * shards * field + slabs + partials + rest
    assert ours["per_device_halo_bytes"] == slabs
    assert ours["per_device_fused_total_bytes"] == fused
    assert ours["fused_total_bytes"] == fused
    assert ours["per_device_loop_bytes"] == 9 * shards * field + slabs
    assert ours["per_device_state_bytes"] == 11 * shards * field
    assert ours["per_device_transient_bytes"] == \
        (11 * shards + OP_PATH_PEAK_FIELDS - 22) * field
    assert ours["per_device_total_bytes"] == \
        ours["per_device_state_bytes"] + ours["per_device_transient_bytes"]
    assert ours["total_bytes"] == ours["per_device_total_bytes"]
    op = armon_torch.ArmonParameters(device="cpu", kernel_tier="torch", **opts)
    assert op.memory_required()["per_device_total_bytes"] == \
        ours["per_device_total_bytes"]
    assert f"{ours['per_device_total_bytes'] / 1e6:.1f} MB" in op.describe()
    kern = armon_torch.ArmonParameters(device="cpu", **opts).describe()
    assert f"{ours['per_device_fused_total_bytes'] / 1e6:.1f} MB" in kern
