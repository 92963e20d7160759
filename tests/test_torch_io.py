"""The port's file I/O, compare mode and per-cycle driver (`armon_torch/io/`,
`armon_torch/core/solver.py`) on the CPU, against the JAX package.

- Files byte for byte: the native library (built with the host C++
  compiler) against the numpy writer and reader, its plain versions; the
  port's state, slice and per-shard files against the JAX package's
  writers on the same numpy State; the window reader against the full
  read; the goldens through written files.
- Compare mode across the two packages: either writes the `is_ref` step
  files, the other compares against them and runs to the end; a perturbed
  run stops at cycle 0; a corrupted file makes a `_diff` file; Strang's
  repeated axis takes the `_2` suffix.
- The per-cycle driver (`silent <= 1`, `animation_step`,
  `checkpoint_step`): bit for bit against the lean loop on the kernels'
  plain versions, its `silent=1` line in the JAX package's format, and its
  animation frames under the JAX package's names, their numbers within
  the bounds of `tests/test_torch_op_path.py` (1e-13 of a field's scale in
  f64, 1e-5 in f32).
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from conftest import ref_file, abs_tol, rel_tol

import armon_tpu
from armon_tpu.core.solver import host_to_device
from armon_tpu.io import output as joutput
from armon_tpu.io import slices as jslices
from armon_tpu.io import subdomain as jsubdomain
import armon_torch
from armon_torch.core.state import State, SAVED_VARS
from armon_torch.io import native, output, slices, subdomain
from armon_torch.parallel.mesh import Mesh

DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32],
                                 ids=["f64", "f32"])
BASE = dict(test="Sod_circ", N=(24, 20), maxtime=1e30, measure_time=False)


def _params(pkg, **opts):
    o = dict(BASE, silent=5)
    o.update(opts)
    if pkg is armon_torch:
        o.setdefault("device", "cpu")
    return pkg.ArmonParameters(**o)


def _random_state(cfg, seed, shape=None):
    """A State of numpy fields over the global padded grid whose values
    span many decades and both signs, with exact and negative zeros, so
    that every formatting path is exercised."""
    rng = np.random.default_rng(seed)
    g = cfg.nghost
    nx, ny = cfg.n_global
    shape = shape or (ny + 2 * g, nx + 2 * g)

    def field():
        a = rng.standard_normal(shape) * 10.0 ** rng.integers(-30, 30, shape)
        a.flat[::17] = 0.0
        a.flat[5::23] = -0.0
        return a.astype(cfg.dtype)
    return State(*(field() for _ in State._fields))


def _torch_state(st):
    return State(*(torch.from_numpy(np.ascontiguousarray(a)) for a in st))


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ------------------------------------------------------------ files, bytes

@DTYPES
@pytest.mark.parametrize("form", ["pm3d", "flat_header"])
def test_native_writer_matches_plain(tmp_path, dtype, form):
    """The native writer and the numpy writer give the same bytes."""
    cfg = _params(armon_torch, data_type=dtype).config
    arrs = output.saved_vars_arrays(cfg, _random_state(cfg, 1))
    kw = dict(for_3d=form == "pm3d",
              extra_header="0.1, 7" if form == "flat_header" else None)
    prec = output.precision_of(cfg)
    output.write_cells_file(tmp_path / "native", arrs, prec, **kw)
    output.write_cells_plain(tmp_path / "plain", arrs, prec, **kw)
    assert _same_bytes(tmp_path / "native", tmp_path / "plain")


@DTYPES
def test_native_reader_matches_plain(tmp_path, dtype):
    """The native reader and numpy's parse the same values, bit for bit."""
    cfg = _params(armon_torch, data_type=dtype).config
    path = tmp_path / "state"
    output.write_state_file(cfg, _torch_state(_random_state(cfg, 2)), path)
    _, ours = output._read_rows(path, cfg.dtype, 24 * 20)
    _, plain = output.read_rows_plain(path, cfg.dtype)
    assert ours.dtype == plain.dtype
    assert np.array_equal(ours.view(np.uint8), plain.view(np.uint8))


@DTYPES
@pytest.mark.parametrize("ghosts", [False, True], ids=["real", "ghosts"])
def test_state_file_matches_jax(tmp_path, dtype, ghosts):
    """`write_state_file` of the same State: the same bytes as the JAX
    package's, and read back to the same values by both packages."""
    cfg = _params(armon_torch, data_type=dtype).config
    jcfg = _params(armon_tpu, data_type=dtype).config
    st = _random_state(cfg, 3)
    output.write_state_file(cfg, _torch_state(st), tmp_path / "port",
                            with_ghosts=ghosts)
    joutput.write_state_file(jcfg, st, tmp_path / "jax", with_ghosts=ghosts)
    assert _same_bytes(tmp_path / "port", tmp_path / "jax")
    ours = output.read_state_file(cfg, tmp_path / "port", with_ghosts=ghosts)
    theirs = joutput.read_state_file(jcfg, tmp_path / "jax", with_ghosts=ghosts)
    for v in SAVED_VARS:
        assert np.array_equal(ours[v], theirs[v], equal_nan=True), v


@DTYPES
def test_slices_match_jax(tmp_path, dtype):
    cfg = _params(armon_torch, data_type=dtype).config
    jcfg = _params(armon_tpu, data_type=dtype).config
    st = _random_state(cfg, 4)
    ours = slices.write_slices_files(cfg, _torch_state(st), str(tmp_path / "p"))
    theirs = jslices.write_slices_files(jcfg, st, str(tmp_path / "j"))
    assert [os.path.basename(p)[1:] for p in ours] == \
        [os.path.basename(p)[1:] for p in theirs]
    for a, b in zip(ours, theirs):
        assert _same_bytes(a, b)


@pytest.mark.parametrize("P,N,ghosts", [
    ((2, 2), (24, 20), False), ((2, 2), (24, 20), True),
    ((3, 2), (25, 19), False)], ids=["2x2", "2x2-ghosts", "3x2-uneven"])
def test_sub_domain_files_match_jax(tmp_path, P, N, ghosts):
    """Per-shard files of the same global State, cut into the port's shard
    blocks and into the JAX package's sharded arrays: the same names, the
    same bytes."""
    tp = _params(armon_torch, P=P, N=N)
    jp = _params(armon_tpu, P=P, N=N)
    st = _random_state(tp.config, 5)
    ours = subdomain.write_sub_domain_files(tp, _torch_state(st),
                                            str(tmp_path / "p"),
                                            with_ghosts=ghosts)
    theirs = jsubdomain.write_sub_domain_files(jp, host_to_device(jp, st),
                                               str(tmp_path / "j"),
                                               with_ghosts=ghosts)
    assert len(ours) == P[0] * P[1]
    assert sorted(os.path.basename(p)[1:] for p in ours) == \
        sorted(os.path.basename(p)[1:] for p in theirs)
    for a in ours:
        b = os.path.join(tmp_path, "j" + os.path.basename(a)[1:])
        assert _same_bytes(a, b), a


@pytest.mark.parametrize("ghosts", [False, True], ids=["real", "ghosts"])
def test_read_window_matches_full_read(tmp_path, ghosts):
    """Each shard's window of a global file, streamed by the native
    reader, equals the same window of the whole file read at once."""
    tp = _params(armon_torch, P=(3, 2), N=(25, 19))
    st = _random_state(tp.config, 6)
    one = _params(armon_torch, N=(25, 19))
    path = tmp_path / "global"
    output.write_state_file(one.config, _torch_state(st), path,
                            with_ghosts=ghosts)
    full = output.read_state_file(one.config, path, with_ghosts=ghosts)
    win = subdomain.ghost_window if ghosts else subdomain.shard_real_window
    for s in Mesh(tp.config, tp.devices):
        _, got = subdomain.read_global_file_window(tp.config, path,
                                                   (s.ix, s.iy),
                                                   with_ghosts=ghosts)
        rs, cs, r0, c0 = win(tp.config, (s.ix, s.iy))
        hy, wx = rs.stop - rs.start, cs.stop - cs.start
        for v in SAVED_VARS:
            assert np.array_equal(got[v], full[v][r0:r0 + hy, c0:c0 + wx]), v


@pytest.mark.parametrize("test,dtype", [("Sod", np.float64),
                                        ("Sod_circ", np.float32)],
                         ids=["Sod-f64", "Sod_circ-f32"])
def test_goldens_through_written_files(tmp_path, test, dtype):
    """A golden run written with `write_output`, read back as a golden
    file is, and compared with `count_differences`: 0 differences (the
    ladder of `tests/test_convergence.py:35-49`); and through a 2x2 mesh
    with `use_MPI`, each shard's file against its window of the golden."""
    opts = dict(test=test, N=(100, 100), data_type=dtype, maxcycle=1000,
                maxtime=0.0, write_output=True, output_dir=str(tmp_path),
                output_file="run", return_data=True)
    params = _params(armon_torch, **opts)
    stats = armon_torch.armon(params)
    cfg = params.config
    atol, rtol = abs_tol(dtype), rel_tol(dtype)
    ref_dt, ref_cycles, ref = output.read_reference_csv(cfg, ref_file(test, dtype))
    assert stats.cycles == ref_cycles
    ours = output.read_state_file(cfg, tmp_path / "run")
    cnt, max_diff, details = output.count_differences(cfg, ours, ref, atol, rtol)
    assert cnt == 0, details

    mesh = _params(armon_torch, P=(2, 2), use_MPI=True, **opts)
    mstats = armon_torch.armon(mesh)
    assert os.path.exists(subdomain.sub_domain_file_path(str(tmp_path / "run"),
                                                         (1, 1)))
    _, cyc, total, _ = subdomain.compare_sub_domain_with_golden(
        mesh, mstats.data, ref_file(test, dtype), atol, rtol)
    assert (cyc, total) == (ref_cycles, 0)
    for s in Mesh(mesh.config, mesh.devices):
        coords = (s.ix, s.iy)
        mine = subdomain.read_sub_domain_file(
            mesh.config, subdomain.sub_domain_file_path(
                str(tmp_path / "run"), coords), coords)
        _, win = subdomain.read_global_file_window(mesh.config,
                                                   tmp_path / "run", coords)
        for v in SAVED_VARS:
            assert np.array_equal(mine[v], win[v]), (coords, v)


# ------------------------------------------------------------ compare mode

def _compare_run(pkg, tmp_path, **opts):
    o = dict(maxcycle=2, compare=True, output_dir=str(tmp_path),
             output_file="cmp")
    o.update(opts)
    if pkg is armon_tpu:
        o.setdefault("kernel_tier", "jnp")
    os.makedirs(o["output_dir"], exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = pkg.armon(_params(pkg, **o))
    return stats, buf.getvalue()


@pytest.mark.parametrize("ref,run,splitting", [
    (armon_tpu, armon_torch, "Sequential"),
    (armon_torch, armon_tpu, "Sequential"),
    (armon_tpu, armon_torch, "Strang")],
    ids=["jax-ref-port-run", "port-ref-jax-run", "strang-jax-ref"])
def test_compare_mode_across_packages(tmp_path, ref, run, splitting):
    """Step files of one package, compared by the other at the default
    tolerance (1e-10): the run goes to its end with no difference. The
    file names are the same in both packages, Strang's repeated X sweep
    under `_2`."""
    _compare_run(ref, tmp_path, is_ref=True, axis_splitting=splitting,
                 data_type=np.float64)
    names = sorted(os.listdir(tmp_path))
    stats, out = _compare_run(run, tmp_path, axis_splitting=splitting,
                              data_type=np.float64)
    assert stats.cycles == 2
    assert "difference" not in out
    assert sorted(os.listdir(tmp_path)) == names
    assert ("cmp_000_EOS_X_2" in names) == (splitting == "Strang")
    assert "cmp_001_time_step_Y" in names or splitting == "Strang"


def test_compare_mode_names_match_jax(tmp_path):
    """Both packages write the same set of step files for a mesh run
    (per-shard state files, one dt file)."""
    opts = dict(is_ref=True, P=(2, 1), N=(24, 20), data_type=np.float64)
    _compare_run(armon_tpu, tmp_path, output_dir=str(tmp_path / "j"), **opts)
    _compare_run(armon_torch, tmp_path, output_dir=str(tmp_path / "p"), **opts)
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "p"))
    assert "cmp_000_EOS_X_1×0" in os.listdir(tmp_path / "p")


def test_compare_mode_perturbed_run_stops_at_cycle_0(tmp_path):
    _compare_run(armon_tpu, tmp_path, is_ref=True)
    stats, out = _compare_run(armon_torch, tmp_path, cfl=0.5)
    assert stats.cycles == 0
    assert "Time step difference" in out


def test_compare_mode_corrupted_file_writes_diff(tmp_path):
    """A changed value in a reference step file: the port reports the
    difference at that sub-step, writes its state beside the file as
    `_diff`, and stops in that cycle."""
    _compare_run(armon_torch, tmp_path, is_ref=True)
    path = tmp_path / "cmp_001_cell_update_X"
    lines = path.read_text().splitlines()
    vals = lines[30].split(",")
    vals[2] = " %#26.17e" % (float(vals[2]) * 1.5)
    lines[30] = ",".join(vals)
    path.write_text("\n".join(lines) + "\n")
    stats, out = _compare_run(armon_torch, tmp_path)
    assert "At cell_update (cycle 1): 1 differences" in out
    assert os.path.exists(str(path) + "_diff")
    assert stats.cycles == 1
    assert not os.path.exists(tmp_path / "cmp_001_projection_remap_X_diff")


# ------------------------------------------------------- per-cycle driver

@pytest.mark.parametrize("route", [
    dict(pair_threshold=0, temporal_blocking=1), dict(temporal_blocking=1),
    dict(), dict(P=(2, 2)), dict(kernel_tier="torch")],
    ids=["per_sweep", "pair", "multicycle", "mesh-2x2", "op_path"])
def test_per_cycle_driver_matches_lean_loop(route):
    """`silent=1` runs the per-cycle driver (one host read a cycle, plus
    one for the line's t and dt); it gives the lean loop's bits, t, dt,
    cycle count and CFL carry on every route. A grid the lean loop runs
    on K5 takes K4 one cycle at a time (exact mode: the same bits)."""
    opts = dict(maxcycle=12, data_type=np.float64, return_data=True, **route)
    lean_p = _params(armon_torch, **opts)
    lean = armon_torch.armon(lean_p)
    cyc_p = _params(armon_torch, **dict(opts, silent=1))
    with contextlib.redirect_stdout(io.StringIO()):
        per = armon_torch.armon(cyc_p)
    assert (per.cycles, per.final_time, per.last_dt) == \
        (lean.cycles, lean.final_time, lean.last_dt)
    for f in State._fields:
        assert torch.equal(getattr(per.data, f), getattr(lean.data, f)), f
    if "kernel_tier" not in route:
        assert cyc_p._final_local_min == lean_p._final_local_min
        assert per.host_reads == 2 * per.cycles + 2
    else:
        assert per.host_reads == per.cycles


@DTYPES
def test_silent1_lines_match_jax(dtype):
    """The `silent=1` line: the JAX package's format, cycle for cycle, the
    dt and t within the op path's bounds, the drifts near 0."""
    opts = dict(maxcycle=4, silent=1, data_type=dtype)
    pat = re.compile(r"^Cycle +(\d+): dt = (\S+), t = (\S+), "
                     r"\|dM\| = ( *\S+)%, \|dE\| = ( *\S+)%$")
    lines = []
    for pkg, extra in ((armon_tpu, dict(kernel_tier="jnp")), (armon_torch, {})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pkg.armon(_params(pkg, **opts, **extra))
        lines.append([l for l in buf.getvalue().splitlines()
                      if l.startswith("Cycle ")])
    tol = 1e-13 if dtype is np.float64 else 1e-5
    assert len(lines[0]) == len(lines[1]) == 4
    for a, b in zip(*lines):
        ma, mb = pat.match(a), pat.match(b)
        assert ma and mb, (a, b)
        assert ma.group(1) == mb.group(1)
        assert len(ma.group(2)) == len(mb.group(2))
        for k in (2, 3):
            x, y = float(ma.group(k)), float(mb.group(k))
            assert abs(x - y) <= tol * abs(x), (a, b)
        for k in (4, 5):
            assert len(mb.group(k)) >= 8
            assert float(mb.group(k)) < (1e-10 if dtype is np.float64
                                         else 1e-3), b


def test_animation_frames_match_jax(tmp_path):
    """`animation_step=2`: frames `anim/<file>_<frame>` after cycles 1, 3
    and 5, per shard on a mesh with `use_MPI`, under the JAX package's
    names; their values within the op path's bounds of the JAX
    package's."""
    opts = dict(maxcycle=5, animation_step=2, P=(2, 1), use_MPI=True,
                data_type=np.float64)
    armon_tpu.armon(_params(armon_tpu, output_dir=str(tmp_path / "j"),
                            kernel_tier="jnp", **opts))
    armon_torch.armon(_params(armon_torch, output_dir=str(tmp_path / "p"),
                              **opts))
    names = sorted(os.listdir(tmp_path / "p" / "anim"))
    assert names == sorted(os.listdir(tmp_path / "j" / "anim"))
    assert names == [f"output_{k:03d}_{x}×0" for k in range(3) for x in (0, 1)]
    cfg = _params(armon_torch, P=(2, 1)).config
    for name in names:
        coords = (int(name[-3]), 0)
        a, b = (subdomain.read_sub_domain_file(
            cfg, str(tmp_path / pkg / "anim" / name), coords)
            for pkg in ("j", "p"))
        for v in SAVED_VARS:
            scale = max(1.0, float(np.max(np.abs(a[v]))))
            assert np.max(np.abs(a[v] - b[v])) <= 1e-13 * scale, (name, v)


def test_native_build_lands_in_build_dir():
    """The library is built into the checkout's ignored build directory,
    never beside the JAX package's copy."""
    from armon_torch.ops import _build
    lib = _build.load_io()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libarmon_io_")
    assert native.count_differences(np.zeros(3), np.zeros(3), 0.0, 0.0) == (0, 0.0)
