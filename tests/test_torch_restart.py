"""Checkpoint / restart in the port (`armon_torch/io/restart.py`,
`armon(restore_from=...)`) on the CPU, against the JAX package.

- The fingerprint string and the npz keys are the JAX package's, so a
  snapshot saved by either package loads in the other: a JAX snapshot
  (jnp tier, and the fused tier in interpret mode) resumes in the port,
  a port snapshot resumes in JAX, within the op path's bounds (1e-13 of a
  field's scale in f64; `tests/test_torch_op_path.py`).
- The port's own resumes are bit for bit against the uninterrupted run:
  on the per-sweep, pair and multicycle routes (an even cycle through
  K5's lean loop, an odd one through the full-state restore loop), on the
  op path from a kernel run's snapshot (its CFL carry overrides the first
  cycle's), from the per-cycle driver's `checkpoint_step` snapshot, and
  across mesh layouts (per-shard files, resharded).
- Refusals: a save without the CFL carry, a fingerprint mismatch.
"""

import os

import numpy as np
import pytest
import torch

import armon_tpu
from armon_tpu.core.solver import gather_state
from armon_tpu.io import restart as jrestart
import armon_torch
from armon_torch.core.state import State
from armon_torch.io import restart
from armon_torch.utils.errors import SolverException

BASE = dict(test="Sod_circ", N=(24, 20), maxtime=1e30, measure_time=False,
            data_type=np.float64)
FIELDS = ("rho", "u", "v", "E", "p")


def _params(pkg, **opts):
    o = dict(BASE, silent=5)
    o.update(opts)
    if pkg is armon_torch:
        o.setdefault("device", "cpu")
    return pkg.ArmonParameters(**o)


def _run(maxcycle, restore_from=None, **opts):
    p = _params(armon_torch, maxcycle=maxcycle, return_data=True, **opts)
    return p, armon_torch.armon(p, restore_from=restore_from)


def _assert_bitwise(a, b, fields=FIELDS, real=False):
    """Equal t, dt, cycle count and fields; with `real`, on the real cells
    only (a mesh's gathered ghost bands are not the one-device run's)."""
    assert (a.cycles, a.final_time, a.last_dt) == \
        (b.cycles, b.final_time, b.last_dt)
    r = (slice(4, -4), slice(4, -4)) if real else (slice(None),) * 2
    for f in fields:
        assert torch.equal(getattr(a.data, f)[r], getattr(b.data, f)[r]), f


def _assert_close(js, ts, tol=1e-13):
    """Fields on real cells within `tol` of their scale, t and dt within
    `tol` relative (the op path's bounds against JAX)."""
    assert js.cycles == ts.cycles
    assert abs(ts.final_time - js.final_time) <= tol * abs(js.final_time)
    assert abs(ts.last_dt - js.last_dt) <= tol * abs(js.last_dt)
    g = 4
    for f in FIELDS:
        a = np.asarray(getattr(js.data, f))[g:-g, g:-g]
        b = np.asarray(getattr(ts.data, f))[g:-g, g:-g]
        scale = max(1.0, float(np.max(np.abs(a))))
        assert np.max(np.abs(a - b)) <= tol * scale, f


CASES = [
    dict(), dict(test="Sod", data_type=np.float32),
    dict(test="Bizarrium", N=(30, 10)), dict(test="Sedov", nghost=5),
    dict(axis_splitting="Strang", scheme="Godunov", projection="euler"),
    dict(riemann_limiter="superbee", P=(2, 2)),
]


@pytest.mark.parametrize("opts", CASES, ids=lambda o: "-".join(
    f"{k}={getattr(v, '__name__', v)}" for k, v in o.items()) or "default")
def test_fingerprint_matches_jax(opts):
    assert restart._fingerprint(_params(armon_torch, **opts)) == \
        jrestart._fingerprint(_params(armon_tpu, **opts))


@pytest.mark.parametrize("route,cut", [
    (dict(pair_threshold=0, temporal_blocking=1), 7),
    (dict(temporal_blocking=1), 7),
    (dict(), 8),
    (dict(), 7),
    (dict(axis_splitting="Strang", pair_threshold=0), 5)],
    ids=["per_sweep", "pair", "multicycle-even", "multicycle-odd",
         "strang-per_sweep"])
def test_resume_bit_exact(tmp_path, route, cut):
    """A lean run's snapshot at `cut` cycles, resumed to 16: the
    uninterrupted run's bits, t, dt and cycle count. Under temporal
    blocking an odd cycle resumes through the full-state restore loop
    (K4, one cycle at a time), an even one through K5's lean loop."""
    p0, full = _run(16, **route)
    p1, s1 = _run(cut, **route)
    ckpt = tmp_path / "snap.npz"
    restart.save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles,
                            s1.last_dt)
    p2, s2 = _run(16, restore_from=str(ckpt), **route)
    _assert_bitwise(full, s2)
    assert p2._ran_fused is True
    assert p2._final_local_min == p0._final_local_min


def test_checkpoint_step_snapshot_resumes_in_lean_loop(tmp_path):
    """The per-cycle driver's `checkpoint_step` snapshot (cycle 8),
    resumed through the lean loop: the lean run's bits; and a 16-cycle
    per-cycle run equals the lean run too."""
    _, lean = _run(16)
    _run(8, checkpoint_step=8, output_dir=str(tmp_path), output_file="run")
    ckpt = tmp_path / "run.ckpt.npz"
    _, t, cycles, _, lm = restart.load_checkpoint(ckpt, _params(armon_torch))
    assert cycles == 8 and lm is not None
    _, resumed = _run(16, restore_from=str(ckpt))
    _assert_bitwise(lean, resumed)
    _, per = _run(16, checkpoint_step=100)
    _assert_bitwise(lean, per, State._fields)


def test_op_path_resume_from_kernel_snapshot_uses_carry(tmp_path):
    """A kernel run's snapshot (cycle-0 c, with its CFL carry) resumed on
    the op path: the carry overrides the first cycle's minimum, so the run
    equals the op path's uninterrupted one bit for bit (the op path and
    the kernels' plain versions agree bit for bit); without the override
    the stale c would give another dt."""
    _, op_full = _run(12, kernel_tier="torch")
    p1, s1 = _run(6)
    ckpt = tmp_path / "k.npz"
    restart.save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles,
                            s1.last_dt)
    p2, s2 = _run(12, restore_from=str(ckpt), kernel_tier="torch")
    _assert_bitwise(op_full, s2)
    assert p2._ran_fused is False
    # The same snapshot without its carry: the op path reduces the stale c.
    restart.save_checkpoint(tmp_path / "nc.npz", p1, s1.data, s1.final_time,
                            s1.cycles, s1.last_dt, local_min=None)
    _, s3 = _run(12, restore_from=str(tmp_path / "nc.npz"),
                 kernel_tier="torch")
    assert s3.last_dt != op_full.last_dt


def test_op_path_snapshot_resumes_on_kernels(tmp_path):
    """Op-path snapshots resume over the kernels: the op loop's, whose
    carry is the final states' CFL minimum, and the op path's per-cycle
    driver's (`checkpoint_step`), which records no carry (NaN) so that the
    kernels reseed from its fresh c: the uninterrupted run's bits; and
    through the op path's per-cycle driver too."""
    _, full = _run(12)
    p1, s1 = _run(6, kernel_tier="torch")
    restart.save_checkpoint(tmp_path / "op.npz", p1, s1.data, s1.final_time,
                            s1.cycles, s1.last_dt)
    p2, _ = _run(6, kernel_tier="torch", checkpoint_step=6,
                 output_dir=str(tmp_path), output_file="cyc")
    assert p2._ran_fused is False and p2._final_local_min is None
    for name in ("op.npz", "cyc.ckpt.npz"):
        ckpt = str(tmp_path / name)
        lm = restart.load_checkpoint(ckpt, p1)[4]
        assert (lm is None) == (name == "cyc.ckpt.npz")
        _, s2 = _run(12, restore_from=ckpt)
        _assert_bitwise(full, s2)
        _, s3 = _run(12, restore_from=ckpt, kernel_tier="torch",
                     checkpoint_step=100)
        _assert_bitwise(full, s3)


@pytest.mark.parametrize("src,dst", [((2, 2), (2, 2)), ((2, 2), (1, 1)),
                                     ((2, 2), (3, 2)), ((1, 1), (2, 2))],
                         ids=["2x2-verbatim", "2x2-to-1x1", "2x2-to-3x2",
                              "global-to-2x2"])
def test_reshard_resume(tmp_path, src, dst):
    """A `checkpoint_step` snapshot of a mesh run with `use_MPI` (per-shard
    files, `_<cx>×<cy>.npz`) or of one device (one file), resumed on
    another layout: the uninterrupted one-device run's bits."""
    N = (25, 19)
    _, full = _run(12, N=N)
    _run(6, N=N, P=src, use_MPI=True, checkpoint_step=6,
         output_dir=str(tmp_path), output_file="m")
    ckpt = str(tmp_path / "m.ckpt.npz")
    assert os.path.exists(restart._shard_ckpt_path(ckpt, (1, 1))) == \
        (src != (1, 1))
    _, s2 = _run(12, restore_from=ckpt, N=N, P=dst)
    _assert_bitwise(full, s2, real=dst != (1, 1))


def test_per_shard_load_is_verbatim(tmp_path):
    """Same layout: each shard's block comes back as it was saved, slack
    and ghosts included."""
    p1, s1 = _run(5, N=(25, 19), P=(3, 2), use_MPI=True)
    ckpt = tmp_path / "v.npz"
    restart.save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles,
                            s1.last_dt)
    with np.load(restart._shard_ckpt_path(ckpt, (2, 1))) as z:
        assert tuple(z["__geom"][:2]) == (3, 2)
        saved = z["field_rho"]
    loaded, t, cycles, dt, lm = restart.load_checkpoint(ckpt, p1)
    assert (t, cycles, dt, lm) == (s1.final_time, s1.cycles, s1.last_dt,
                                   p1._final_local_min)
    assert np.array_equal(loaded[5].rho.numpy(), saved)


def test_save_without_carry_refused(tmp_path):
    p1, s1 = _run(4)
    fresh = _params(armon_torch, maxcycle=4)
    with pytest.raises(SolverException, match="CFL carry"):
        restart.save_checkpoint(tmp_path / "x.npz", fresh, s1.data,
                                s1.final_time, s1.cycles, s1.last_dt)
    # The JAX package refuses the same save, before it reads the state.
    jfresh = _params(armon_tpu, maxcycle=4)
    with pytest.raises(armon_tpu.SolverException, match="CFL carry"):
        jrestart.save_checkpoint(tmp_path / "y.npz", jfresh,
                                 State(*(a.numpy() for a in s1.data)),
                                 s1.final_time, s1.cycles, s1.last_dt)
    # The params that ran the solve record the carry.
    restart.save_checkpoint(tmp_path / "z.npz", p1, s1.data, s1.final_time,
                            s1.cycles, s1.last_dt)


def test_fingerprint_mismatch_refused(tmp_path):
    p1, s1 = _run(3)
    restart.save_checkpoint(tmp_path / "a.npz", p1, s1.data, s1.final_time,
                            s1.cycles, s1.last_dt)
    with pytest.raises(SolverException, match="different configuration"):
        armon_torch.armon(_params(armon_torch, maxcycle=6,
                                  riemann_limiter="superbee"),
                          restore_from=str(tmp_path / "a.npz"))


@pytest.mark.parametrize("tier,cut", [("jnp", 6), ("pallas", 2)])
def test_jax_snapshot_resumes_in_port(tmp_path, tier, cut):
    """A JAX-saved snapshot with its CFL carry (the jnp tier's loop, or the
    fused tier in interpret mode, whose c is stale), resumed by the port:
    within the bounds of JAX's own uninterrupted jnp run."""
    n = 12 if tier == "jnp" else 6
    small = dict(N=(16, 12)) if tier == "pallas" else {}
    jp = _params(armon_tpu, maxcycle=cut, return_data=True, kernel_tier=tier,
                 **small)
    js = armon_tpu.armon(jp)
    ckpt = tmp_path / "j.npz"
    jrestart.save_checkpoint(ckpt, jp, js.data, js.final_time, js.cycles,
                             js.last_dt)
    with np.load(ckpt) as z:
        assert float(z["__local_min"]) == jp._final_local_min
    _, ts = _run(n, restore_from=str(ckpt), **small)
    jfull = armon_tpu.armon(_params(armon_tpu, maxcycle=n, return_data=True,
                                    kernel_tier="jnp", **small))
    _assert_close(jfull, ts)


def test_port_snapshot_resumes_in_jax(tmp_path):
    """Port snapshots, a kernel run's (with its carry, saved by the
    per-cycle driver) and a mesh run's per-shard files, resumed by the
    JAX package's jnp tier: within the bounds of JAX's uninterrupted
    run."""
    jfull = armon_tpu.armon(_params(armon_tpu, maxcycle=12, return_data=True,
                                    kernel_tier="jnp"))
    _run(6, checkpoint_step=6, output_dir=str(tmp_path), output_file="p")
    js = armon_tpu.armon(_params(armon_tpu, maxcycle=12, return_data=True,
                                 kernel_tier="jnp"),
                         restore_from=str(tmp_path / "p.ckpt.npz"))
    _assert_close(jfull, js)
    _run(6, P=(2, 2), use_MPI=True, checkpoint_step=6,
         output_dir=str(tmp_path), output_file="m")
    jmp = _params(armon_tpu, maxcycle=12, return_data=True,
                  kernel_tier="jnp", P=(2, 2))
    jm = armon_tpu.armon(jmp, restore_from=str(tmp_path / "m.ckpt.npz"))
    jm.data = gather_state(jmp, jm.data)
    jm.data = type(jm.data)(*(torch.from_numpy(np.asarray(a))
                              for a in jm.data))
    _assert_close(jfull, jm)
