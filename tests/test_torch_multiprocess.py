"""Runs of the port over several OS processes (ROADMAP A10b): the
counterpart of `tests/test_multiprocess.py` and `tests/mp_worker.py`.

Each job starts `nprocs` processes of this same file run as a script
(`python tests/test_torch_multiprocess.py <rank> <port> <tmp> <px> <py>
<nprocs> [<nx> <ny>]`), which join over `torch.distributed` (gloo, the
CPU) and drive one mesh, a contiguous block of shards each. A worker
imports `armon_torch`, torch and numpy only. Its legs, on Sod f64
GAD/minmod/euler_2nd, nghost 4:

1. the golden run (to cycle 45 at N=100^2) with per-shard output: each
   process writes its own shards' files, the per-shard golden comparison
   gives 0 differences at atol 1e-13, rtol 4 eps, with the golden's cycle
   count; `gather_state` and `device_to_host` refuse with "per-shard"; a
   second, different coordinator and a shard count that is not a multiple
   of the process count raise; the final shards go to an npz for the
   parent;
2. a per-shard snapshot at cycle 3, resumed to 6, bit for bit against an
   uninterrupted 6;
3. the op path (`kernel_tier="torch"`) against the kernels' plain
   versions (`pair_threshold=0`), 5 cycles, on each shard's real window,
   bit for bit: the port's exact arithmetic is the same on both;
4. the per-cycle driver (`silent=1`), whose conservation line sums every
   shard's (mass, energy) pair gathered across processes;
5. the counterpart of `tests/test_option_fuzz.py`'s resume and compare
   invariants (`:151`, `:295`) on one option set a layout: 3 cycles, a
   per-shard snapshot, resumed to 7, bit for bit against a straight 7;
   compare mode writing then comparing per-shard step files, clean.

The parent then holds every worker's final shards bit for bit against the
port's one-process run and within 1e-13 of the JAX package's mesh run on
the same P (conftest's virtual devices), and restores the processes'
snapshots in this one process on other layouts (`:64-91` of
`test_multiprocess.py`; the fuzz's reshard invariant, `:195`), resuming
bit for bit. A job whose worker fails kills its peers at once; no job
outlives `JOB_TIMEOUT`.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "reference_data", "ref_Sod_64bits.csv")
JOB_TIMEOUT = 120  # seconds, per job
G = 4
FIELDS = ("rho", "u", "v", "E", "p")
COMMON = dict(test="Sod", data_type="float64", scheme="GAD",
              projection="euler_2nd", riemann_limiter="minmod", nghost=4,
              silent=5, measure_time=False, device="cpu")
# One option set a layout for leg 5 (the option fuzz's counterpart).
OPTIONS = {
    (2, 1, 2): dict(test="Sod_circ", axis_splitting="Strang",
                    riemann_limiter="superbee", dt_on_even_cycles=True),
    (2, 2, 4): dict(test="Sedov", data_type="float32",
                    axis_splitting="Godunov"),
    (2, 2, 2): dict(test="Sod_y", scheme="Godunov", projection="euler",
                    nghost=2, kernel_tier="torch"),
    (3, 2, 3): dict(test="Bizarrium", axis_splitting="X_only", cfl=0.4),
}
# (px, py, processes, N): both axes cross processes on 2x2 over four;
# two shards a process on 2x2 over two; an uneven 3x2 over three.
JOBS = [(2, 1, 2, (100, 100)), (2, 2, 4, (100, 100)), (2, 2, 2, (100, 100)),
        (3, 2, 3, (100, 99))]


def _job_id(job):
    px, py, n, N = job
    return f"{px}x{py}-{n}procs-N{N[0]}x{N[1]}"


# ------------------------------------------------------------------ worker

def _blocks(params, data, vars=FIELDS):
    from armon_torch.io.subdomain import shard_coords_iter
    return dict(shard_coords_iter(params, data, vars=vars))


def _assert_same(a, b, what, window=None):
    assert a.keys() == b.keys(), what
    for coords in a:
        for v in a[coords]:
            x, y = a[coords][v], b[coords][v]
            if window is not None:
                rs, cs, _, _ = window(coords)
                x, y = x[rs, cs], y[rs, cs]
            assert np.array_equal(x, y), (what, coords, v)


def _worker(rank, port, tmp, px, py, nprocs, N):
    import torch
    torch.set_num_threads(1)
    from armon_torch import (ArmonParameters, armon, gather_state,
                             device_to_host, SolverException)
    from armon_torch.core.state import State
    from armon_torch.io.restart import save_checkpoint, _shard_ckpt_path
    from armon_torch.parallel import dist
    from armon_torch.io.subdomain import (compare_sub_domain_with_golden,
                                          shard_real_window,
                                          sub_domain_file_path)
    common = dict(COMMON, N=N, P=(px, py), num_processes=nprocs,
                  process_id=rank, coordinator_address=f"localhost:{port}")
    k = px * py // nprocs

    # --- leg 1: the golden run, per-shard output and comparison
    p = ArmonParameters(**common, maxcycle=1000, return_data=True,
                        write_output=True, output_dir=tmp,
                        output_file="mp_out")
    assert torch.distributed.get_world_size() == nprocs
    assert (p.process_count, p.process_index) == (nprocs, rank)
    assert p.use_MPI, "several processes must select per-shard I/O"
    stats = armon(p)
    assert isinstance(stats.data, list) and len(stats.data) == k
    final = _blocks(p, stats.data)
    assert [c for c in final] == [((rank * k + j) % px, (rank * k + j) // px)
                                  for j in range(k)]
    for coords in final:
        assert os.path.exists(sub_domain_file_path(
            os.path.join(tmp, "mp_out"), coords)), coords
    np.savez(os.path.join(tmp, f"final_{rank}.npz"),
             scalars=np.array([stats.cycles, stats.final_time,
                               stats.last_dt]),
             **{f"{v}_{cx}_{cy}": blk[v] for (cx, cy), blk in final.items()
                for v in FIELDS})
    if N == (100, 100):
        _, ref_cycles, cnt, max_diff = compare_sub_domain_with_golden(
            p, stats.data, REF, atol=1e-13, rtol=4 * np.finfo(np.float64).eps)
        assert stats.cycles == ref_cycles, (stats.cycles, ref_cycles)
        assert cnt == 0, f"{cnt} differences from the golden ({max_diff})"
    for gather in (gather_state, device_to_host):
        try:
            gather(p, stats.data)
            raise AssertionError(f"{gather.__name__} did not raise")
        except SolverException as e:
            assert "per-shard" in str(e), e
    for bad, match in ((dict(coordinator_address="localhost:1"),
                        "already initialized"),
                       (dict(P=(nprocs + 1, 1)), "not a multiple")):
        try:
            ArmonParameters(**dict(common, **bad))
            raise AssertionError(f"{bad} did not raise")
        except SolverException as e:
            assert match in str(e), e

    # --- leg 2: a per-shard snapshot resumed, bit for bit
    c2 = dict(common, return_data=True)
    p1 = ArmonParameters(**c2, maxcycle=3)
    s1 = armon(p1)
    ckpt = os.path.join(tmp, "mp.ckpt.npz")
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt)
    for coords in final:
        assert os.path.exists(_shard_ckpt_path(ckpt, coords))
    p2 = ArmonParameters(**c2, maxcycle=6)
    s2 = armon(p2, restore_from=ckpt)
    p3 = ArmonParameters(**c2, maxcycle=6)
    s3 = armon(p3)
    assert (s2.cycles, s2.final_time, s2.last_dt) == \
        (s3.cycles, s3.final_time, s3.last_dt) and s3.cycles == 6
    _assert_same(_blocks(p2, s2.data, State._fields),
                 _blocks(p3, s3.data, State._fields), "resume")

    # --- leg 3: the op path against the kernels' plain versions
    def tier_run(tier):
        pt = ArmonParameters(**c2, maxcycle=5, kernel_tier=tier,
                             pair_threshold=0)
        st = armon(pt)
        assert st.cycles == 5
        return pt, _blocks(pt, st.data, ("rho", "u", "v", "E"))

    (po, op), (_, kern) = tier_run("torch"), tier_run("auto")
    _assert_same(op, kern, "op path vs kernels",
                 lambda c: shard_real_window(po.config, c))

    # --- leg 4: the per-cycle driver's conservation line
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        armon(ArmonParameters(**dict(common, silent=1), maxcycle=4))
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("Cycle ")]
    assert len(lines) == 4, out.getvalue()
    with open(os.path.join(tmp, f"cycles_{rank}.txt"), "w") as f:
        f.write("\n".join(lines))

    # --- leg 5: the option fuzz's resume and compare invariants
    c5 = dict(c2, **OPTIONS[px, py, nprocs])
    q1 = ArmonParameters(**c5, maxcycle=3)
    r1 = armon(q1)
    ck5 = os.path.join(tmp, "opts.ckpt.npz")
    save_checkpoint(ck5, q1, r1.data, r1.final_time, r1.cycles, r1.last_dt)
    q2 = ArmonParameters(**c5, maxcycle=7)
    r2 = armon(q2, restore_from=ck5)
    q3 = ArmonParameters(**c5, maxcycle=7)
    r3 = armon(q3)
    assert (r2.cycles, r2.final_time, r2.last_dt) == \
        (r3.cycles, r3.final_time, r3.last_dt) and r3.cycles == 7
    _assert_same(_blocks(q2, r2.data), _blocks(q3, r3.data), "option resume",
                 lambda c: shard_real_window(q3.config, c))
    cmp_dir = os.path.join(tmp, "cmp")
    os.makedirs(cmp_dir, exist_ok=True)
    c6 = dict(c5, maxcycle=4, compare=True, output_dir=cmp_dir,
              output_file="step")
    armon(ArmonParameters(**c6, is_ref=True))
    clean = armon(ArmonParameters(**c6, is_ref=False))
    assert clean.cycles == 4, "compare mode stopped on a difference"
    print(dist.result_line("MPOK"), flush=True)
    dist.shutdown()


# ------------------------------------------------------------------ parent

def run_job(tmp, job):
    """Run the job's workers (`dist.run_workers`: a worker that fails, or
    the time limit, kills them all) and return `tmp`, where they wrote."""
    from armon_torch.parallel.dist import run_workers
    px, py, nprocs, N = job
    tmp = str(tmp)
    results = run_workers(
        lambda rank, port: [sys.executable, os.path.abspath(__file__), rank,
                            port, tmp, px, py, nprocs, *N],
        nprocs, JOB_TIMEOUT, tmp, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert results == ["MPOK"] * nprocs, results
    return tmp


# ------------------------------------------------------------------- tests

_RUNS = {}


@pytest.fixture(params=JOBS, ids=_job_id)
def job(request, tmp_path_factory):
    """(job, the directory its workers wrote), each job run once."""
    key = request.param
    if key not in _RUNS:
        _RUNS[key] = run_job(tmp_path_factory.mktemp(_job_id(key)), key)
    return key, _RUNS[key]


def _params(N, P, **opts):
    import armon_torch
    return armon_torch.ArmonParameters(**dict(COMMON, N=N, P=P, **opts))


def _one_process(N, P, restore_from=None, **opts):
    import armon_torch
    return armon_torch.armon(_params(N, P, **dict(dict(return_data=True),
                                                  **opts)),
                             restore_from=restore_from)


def _worker_shards(tmp, nprocs):
    """{(cx, cy): {field: padded block}} of every worker's final shards,
    and the scalars (cycles, t, dt) each worker ran to."""
    shards, scalars = {}, set()
    for rank in range(nprocs):
        with np.load(os.path.join(tmp, f"final_{rank}.npz")) as z:
            scalars.add(tuple(z["scalars"]))
            for key in z.files:
                if key != "scalars":
                    v, cx, cy = key.split("_")
                    shards.setdefault((int(cx), int(cy)), {})[v] = z[key]
    assert len(scalars) == 1, scalars
    return shards, scalars.pop()


def _windows(cfg, shards, glob):
    """Pairs (a worker shard's real window, the same cells of the global
    padded array `glob[field]`)."""
    from armon_torch.io.subdomain import shard_real_window
    for coords, blk in shards.items():
        rs, cs, row0, col0 = shard_real_window(cfg, coords)
        h, w = rs.stop - rs.start, cs.stop - cs.start
        for v in FIELDS:
            yield (coords, v), blk[v][rs, cs], \
                np.asarray(glob[v])[G + row0:G + row0 + h, G + col0:G + col0 + w]


def test_processes_equal_one_process_and_jax(job):
    """Every worker's final shards (the golden run, leg 1) are bit for bit
    the port's one-process run on the same P, and within 1e-13 of the
    JAX package's mesh run; every process's conservation lines (leg 4)
    are the one-process run's, character for character."""
    import armon_tpu
    from armon_torch.interop import to_numpy
    from armon_tpu.core.solver import gather_state as jax_gather
    (px, py, nprocs, N), tmp = job
    shards, (cycles, t, dt) = _worker_shards(tmp, nprocs)
    assert len(shards) == px * py
    one = _one_process(N, (px, py), maxcycle=1000)
    assert (one.cycles, one.final_time, one.last_dt) == (cycles, t, dt)
    data = to_numpy(one.data)
    cfg = _params(N, (px, py)).config
    for what, a, b in _windows(cfg, shards, data._asdict()):
        assert np.array_equal(a, b), what
    opts = {k: v for k, v in COMMON.items() if k != "device"}
    jp = armon_tpu.ArmonParameters(**dict(opts, data_type=np.float64), N=N,
                                   P=(px, py), maxcycle=1000,
                                   return_data=True)
    js = armon_tpu.armon(jp)
    assert js.cycles == cycles
    jdata = jax_gather(jp, js.data)
    for what, a, b in _windows(cfg, shards, jdata._asdict()):
        scale = max(float(np.abs(b).max()), 1.0)
        assert float(np.abs(a - b).max()) <= 1e-13 * scale, what
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _one_process(N, (px, py), maxcycle=4, silent=1, return_data=False)
    want = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("Cycle ")]
    for rank in range(nprocs):
        with open(os.path.join(tmp, f"cycles_{rank}.txt")) as f:
            assert f.read().splitlines() == want, rank


@pytest.mark.parametrize("target", [(1, 1), (3, 2)], ids=["1x1", "3x2"])
def test_processes_snapshot_restores_here(job, target):
    """The per-shard snapshot the processes wrote at cycle 3 (leg 2)
    restores in this one process on another layout and resumes to 6, bit
    for bit against an uninterrupted one-process run."""
    import torch
    (px, py, nprocs, N), tmp = job
    ref = _one_process(N, (1, 1), maxcycle=6)
    res = _one_process(N, target, maxcycle=6,
                       restore_from=os.path.join(tmp, "mp.ckpt.npz"))
    assert (res.cycles, res.final_time, res.last_dt) == \
        (ref.cycles, ref.final_time, ref.last_dt) and ref.cycles == 6
    for v in FIELDS:
        assert torch.equal(getattr(res.data, v)[G:-G, G:-G],
                           getattr(ref.data, v)[G:-G, G:-G]), v


def test_processes_option_invariants_reshard(job):
    """The option fuzz's reshard invariant (`tests/test_option_fuzz.py:
    195`) on the option set of leg 5, which the workers resumed and
    compared clean: their 3-cycle snapshot restores here on 1x1 and
    resumes to 7, bit for bit against a straight one-process 7 (the
    port's arithmetic is the same on every layout)."""
    import torch
    (px, py, nprocs, N), tmp = job
    kw = dict(OPTIONS[px, py, nprocs], maxcycle=7)
    ref = _one_process(N, (1, 1), **kw)
    res = _one_process(N, (1, 1), **kw,
                       restore_from=os.path.join(tmp, "opts.ckpt.npz"))
    assert (res.cycles, res.final_time, res.last_dt) == \
        (ref.cycles, ref.final_time, ref.last_dt) and ref.cycles == 7
    g = kw.get("nghost", G)
    for v in ("rho", "u", "v", "E"):
        assert torch.equal(getattr(res.data, v)[g:-g, g:-g],
                           getattr(ref.data, v)[g:-g, g:-g]), v


def test_scaling_script_rehearses_on_the_cpu():
    """`python -m armon_torch.scaling` on the CPU: its workers join over
    gloo on meshes of 1, 2 and 4 processes and print one line each, every
    time "not measured" (a CPU run gives no device time)."""
    import json
    import subprocess
    out = subprocess.run(
        [sys.executable, "-m", "armon_torch.scaling", "--device", "cpu",
         "--n-per-device", "32", "--max-procs", "4", "--cycles", "2",
         "--reps", "1"], cwd=os.path.dirname(HERE), capture_output=True,
        text=True, timeout=JOB_TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(ln)["scaling"] for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [(ln["P"], ln["backend"]) for ln in lines] == \
        [([1, 1], None), ([1, 2], "gloo"), ([2, 2], "gloo")]
    assert all(ln["cells_per_s"] == "not measured" for ln in lines)


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.path.insert(0, os.path.dirname(HERE))
    _worker(int(a[0]), a[1], a[2], int(a[3]), int(a[4]), int(a[5]),
            (int(a[6]), int(a[7])) if len(a) > 7 else (100, 100))
    sys.exit(0)
