"""The compile-once loop over several processes (`armon_torch/core/graphs.py`,
`core/step.KernelCycles`, `parallel/dist.py`): the counterpart of the JAX
package's `shard_map`-ed `lax.while_loop` (`armon_tpu/core/solver.py:
109-114,193-210`), whose body holds the halo exchange's `ppermute` and
`pmin_dt`.

On the CPU, where no graph runs:
- `eager_reason` and `use_graphs` by transport: NCCL processes on cards
  may replay graphs; gloo, the CPU and a mesh across cards give a reason,
  and `graphs=True` there raises; `whole_reason`, the transport rule that
  sends a lean run over NCCL processes to window graphs, and the loop's
  choice of form by it (`_Windows.drive`);
- over two gloo processes (this file run as a worker, as
  `tests/test_torch_multiprocess.py` does; one job for every case), the
  WHILE node's plain version (`graphs.while_plain`) drives `KernelCycles`
  on 2x1 per-sweep and 1x2 pair, Sequential from cycle 0 and Strang from
  the odd cycle 5, in f64 and f32: the same bits as the eager windowed
  loop and as the one-process run, the same iterations on every process;
  each body's records (the wrappers' launches and the collectives' calls)
  repeat, and the collectives read and write the loop's own buffers, the
  same pointers every body: nothing is allocated in a step; `graphs=True`
  over gloo raises; one case within 1e-13 of the JAX package's mesh on its
  jnp tier in f64.
On cards (marked `gpu`, skipped below two): over two NCCL processes, the
lean loop's default form (window graphs) against `graphs=False`, bit for
bit in f64 and f32 exact, with its form (`graphs.STATS`) and host reads;
a default `armon()` run over NCCL with NCCL's graph mixing turned off
(`NCCL_GRAPH_MIXING_SUPPORT=0`) finishes, bit for bit the eager loop's.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
JOB_TIMEOUT = 120  # seconds, per job
NPROCS = 2
N = (24, 20)
MAXCYCLE = 16
FIELDS = ("rho", "u", "v", "E", "p")
PER_SWEEP = dict(pair_threshold=0, temporal_blocking=1)
PAIR = dict(temporal_blocking=1)
# (name, P, route options, splitting, start cycle): 2x1 per-sweep and 1x2
# pair, each from cycle 0 and resumed at an odd cycle under Strang.
LAYOUTS = [("2x1-per_sweep", (2, 1), PER_SWEEP),
           ("1x2-pair", (1, 2), PAIR)]
STARTS = [("Sequential", 0), ("Strang", 5)]
DTYPES = ("float64", "float32")
CASES = [(f"{name}-{split}{start}-{dtype}", P, route, split, start, dtype)
         for name, P, route in LAYOUTS for split, start in STARTS
         for dtype in DTYPES]
CASE_IDS = [c[0] for c in CASES]


def _opts(P, route, split, dtype, device, **extra):
    return dict(test="Sod_circ", N=N, P=P, data_type=dtype,
                use_fast_math=False, axis_splitting=split, maxtime=1e30,
                maxcycle=MAXCYCLE, silent=5, measure_time=False,
                device=device, **route, **extra)


def _clone(fs):
    return [type(f)(*(a.clone() for a in f)) for f in fs]


def _start(params, fs, seed, start):
    """The carry run eagerly to cycle `start` (a resume): (carry, t, dt,
    lm)."""
    import dataclasses
    from armon_torch.core.solver import make_mesh
    from armon_torch.core.step import make_time_loop_lean
    if not start:
        return fs, 0.0, 0.0, float(seed)
    res = make_time_loop_lean(dataclasses.replace(params.config,
                                                  maxcycle=start),
                              make_mesh(params), graphs=False)(
        fs, 0.0, 0, 0.0, float(seed))
    return res.carry, res.t, res.dt_last, res.lm


def _scalars(res):
    return [res.cycles, res.t, res.dt_last, res.lm, res.ok, res.host_reads]


# ------------------------------------------------------------------ worker

def _sig(x):
    """A launch or collective argument as a JSON-able record: a tensor by
    its pointer, shape and strides; other objects by type and identity."""
    import torch
    from armon_torch.utils.enums import Axis
    if isinstance(x, torch.Tensor):
        return ["T", x.data_ptr(), list(x.shape), list(x.stride())]
    if isinstance(x, (tuple, list)):
        return [_sig(a) for a in x]
    if isinstance(x, dict):
        return [[k, _sig(v)] for k, v in sorted(x.items())]
    if isinstance(x, Axis):
        return int(x)
    if x is None or isinstance(x, (str, int, float)):
        return x
    return [type(x).__name__, id(x)]


def _ptrs(rec):
    if isinstance(rec, list) and rec[:1] == ["T"]:
        return {rec[1]}
    if isinstance(rec, list):
        return set().union(*(_ptrs(r) for r in rec)) if rec else set()
    return set()


class _Recorder:
    """The wrappers' launches (K1/K2 and K4 through their dispatch, K3)
    and the collectives' calls (`dist.exchange`, the loop's
    `all_gather_into`), in order; `step()` marks a cycle's start."""

    def __init__(self):
        from armon_torch.core import step as S
        from armon_torch.ops import cycle as C
        from armon_torch.ops import sweep as K
        from armon_torch.parallel import dist
        self.log, self.saved = [], []
        for mod, name in ((K, "_sweep"), (C, "cycle"), (K, "cfl_finish"),
                          (dist, "exchange"), (S, "all_gather_into")):
            real = getattr(mod, name)

            def spy(*args, _real=real, _name=name, **kw):
                self.log.append([_name, _sig(args[1:] if _name in (
                    "_sweep", "cycle", "cfl_finish") else args), _sig(kw)])
                return _real(*args, **kw)
            self.saved.append((mod, name, real))
            setattr(mod, name, spy)

    def step(self):
        self.log.append(["step"])

    def close(self):
        for mod, name, real in self.saved:
            setattr(mod, name, real)

    def bodies(self, n):
        """The records split into bodies of `n` cycles each."""
        out, steps = [], 0
        for rec in self.log:
            if rec == ["step"]:
                if steps % n == 0:
                    out.append([])
                steps += 1
            else:
                out[-1].append(rec)
        return out


def _while_plain_case(params, fs, t, start, dt, lm):
    """`graphs.while_plain` over `KernelCycles` from the carry, recorded:
    (LoopResult, iterations, body steps, the body check's findings)."""
    from armon_torch.core import graphs as G
    from armon_torch.core.solver import make_mesh
    from armon_torch.core.step import KernelCycles
    from armon_torch.ops import sweep as K
    from armon_torch.ops.routing import route
    cfg = params.config
    run = KernelCycles(cfg, make_mesh(params), fs, t, start, dt, lm,
                       route(cfg) == "pair")
    assert run.graphs is None and run.sends and run.gathers
    run.first_step()
    n = G.body_steps(run, start)
    rec = _Recorder()
    real = run.cycle

    def cycle(i):
        rec.step()
        real(i)
    run.cycle = cycle
    try:
        iters = G.while_plain(run, start, n, K.IS_RUN)
    finally:
        rec.close()
    bodies = rec.bodies(n)
    colls = [[r for r in b if r[0] in ("exchange", "all_gather_into")]
             for b in bodies]
    own = {b.data_ptr() for bufs in list(run.slabs.values()) +
           list(run.sends.values()) for sides in bufs for b in sides
           if b is not None} | {b.data_ptr() for pair in run.gathers.values()
                                for b in pair}
    check = {"bodies": len(bodies),
             "bodies_repeat": all(b == bodies[0] for b in bodies[1:]),
             "collectives_per_body": len(colls[0]),
             "collective_ptrs_own": _ptrs(colls[0]) <= own,
             "collective_ptrs_per_body": len({json.dumps(sorted(_ptrs(c)))
                                              for c in colls}),
             "exchanges_per_body": sum(r[0] == "exchange" for r in colls[0]),
             "gathers_per_body": sum(r[0] == "all_gather_into"
                                     for r in colls[0])}
    return run.result(1), iters, n, check


def _save(tmp, rank, key, params, res):
    from armon_torch.core.solver import make_mesh
    arrays = {f"{f}_{s.index}": np.asarray(getattr(c, f).cpu())
              for s, c in zip(make_mesh(params).local, res.carry)
              for f in FIELDS}
    np.savez(os.path.join(tmp, f"{key}_{rank}.npz"), **arrays)


def _gloo_worker(rank, port, tmp):
    """Every case's eager windowed loop and `while_plain` run over gloo on
    the CPU; `graphs=True` refusals."""
    import torch
    torch.set_num_threads(1)
    from armon_torch import ArmonParameters, armon, SolverException
    from armon_torch.core import graphs as G
    from armon_torch.core.solver import make_init_fused, make_mesh
    from armon_torch.core.step import make_time_loop_lean
    from armon_torch.parallel import dist
    procs = dict(coordinator_address=f"localhost:{port}",
                 num_processes=NPROCS, process_id=rank)
    out = {"rank": rank, "cases": {}}
    for key, P, route, split, start, dtype in CASES:
        params = ArmonParameters(**_opts(P, route, split, dtype, "cpu"),
                                 **procs)
        fs, seed = make_init_fused(params)()
        fs, t, dt, lm = _start(params, fs, seed, start)
        eager = make_time_loop_lean(params.config, make_mesh(params))(
            _clone(fs), t, start, dt, lm, check_every=8)
        plain, iters, n, check = _while_plain_case(params, _clone(fs), t,
                                                   start, dt, lm)
        _save(tmp, rank, f"eager_{key}", params, eager)
        _save(tmp, rank, f"plain_{key}", params, plain)
        out["cases"][key] = {"eager": _scalars(eager),
                             "plain": _scalars(plain), "iterations": iters,
                             "body_steps": n, **check}
    refusals = []
    reason = G.eager_reason("cuda:0", (), NPROCS, dist.backend())
    try:
        G.use_graphs(True, reason)
    except SolverException as e:
        refusals.append(str(e))
    try:
        armon(params, graphs=True)
    except SolverException as e:
        refusals.append(str(e))
    out["refusals"] = refusals
    out["backend"] = dist.backend()
    print(dist.result_line(out), flush=True)
    dist.shutdown()


def _nccl_worker(rank, port, tmp):
    """Every case on a card a process over NCCL: the lean loop's default
    form against `graphs=False`, bit for bit, with the form and the host
    reads."""
    import torch
    from armon_torch import ArmonParameters
    from armon_torch.core import graphs as G
    from armon_torch.core.solver import make_init_fused, make_mesh
    from armon_torch.core.step import make_time_loop_lean
    from armon_torch.parallel import dist
    procs = dict(coordinator_address=f"localhost:{port}",
                 num_processes=NPROCS, process_id=rank)
    out = {"rank": rank, "cases": {}}
    for key, P, route, split, start, dtype in CASES:
        params = ArmonParameters(**_opts(P, route, split, dtype, "cuda"),
                                 **procs)
        fs, seed = make_init_fused(params)()
        fs, t, dt, lm = _start(params, fs, seed, start)
        runs = {}
        for graphs in (False, None):
            G.reset_stats()
            res = make_time_loop_lean(params.config, make_mesh(params),
                                      graphs=graphs)(_clone(fs), t, start,
                                                     dt, lm)
            torch.cuda.synchronize()
            runs[graphs] = res, dict(G.STATS)
        (eager, _), (graphed, stats) = runs[False], runs[None]
        w = {torch.float64: torch.int64, torch.float32: torch.int32}
        same = all(torch.equal(a.view(w[a.dtype]), b.view(w[b.dtype]))
                   for x, y in zip(eager.carry, graphed.carry)
                   for a, b in zip(x, y))
        out["cases"][key] = {"eager": _scalars(eager),
                             "graphed": _scalars(graphed), "bitwise": same,
                             "form": stats["form"], "runs": stats["runs"],
                             "iterations": stats["iterations"]}
    out["backend"] = dist.backend()
    print(dist.result_line(out), flush=True)
    dist.shutdown()


def _nomix_worker(rank, port, tmp):
    """One case through `armon()` over NCCL with NCCL's graph mixing off
    (the parent sets `NCCL_GRAPH_MIXING_SUPPORT=0`): the default form
    against `graphs=False`, bit for bit."""
    import torch
    from armon_torch import ArmonParameters, armon
    from armon_torch.core import graphs as G
    from armon_torch.io.subdomain import shard_states
    from armon_torch.parallel import dist
    _, P, route, split, _, dtype = CASES[0]
    runs = {}
    for graphs in (False, None):
        params = ArmonParameters(**_opts(P, route, split, dtype, "cuda"),
                                 coordinator_address=f"localhost:{port}",
                                 num_processes=NPROCS, process_id=rank,
                                 return_data=True)
        G.reset_stats()
        st = armon(params, graphs=graphs)
        torch.cuda.synchronize()
        runs[graphs] = st, G.STATS["form"], shard_states(params, st.data)
    (eager, _, e), (graphed, form, g) = runs[False], runs[None]
    same = all(torch.equal(getattr(a, f).view(torch.int64),
                           getattr(b, f).view(torch.int64))
               for a, b in zip(e, g) for f in FIELDS)
    print(dist.result_line({
        "rank": rank, "mixing": os.environ.get("NCCL_GRAPH_MIXING_SUPPORT"),
        "form": form, "bitwise": same,
        "eager": [eager.cycles, eager.final_time, eager.last_dt],
        "graphed": [graphed.cycles, graphed.final_time, graphed.last_dt]}),
        flush=True)
    dist.shutdown()


# ------------------------------------------------------------------ parent

def _run_job(tmp, mode, **env):
    from armon_torch.parallel.dist import run_workers
    tmp = str(tmp)
    results = run_workers(
        lambda rank, port: [sys.executable, os.path.abspath(__file__), mode,
                            rank, port, tmp],
        NPROCS, JOB_TIMEOUT, tmp,
        env=dict(os.environ, OMP_NUM_THREADS="1", **env))
    assert all(r is not None for r in results), results
    return results


@pytest.fixture(scope="module")
def gloo_job(tmp_path_factory):
    """The gloo job's results in rank order, and the directory its workers
    wrote."""
    tmp = tmp_path_factory.mktemp("graph_processes")
    return _run_job(tmp, "gloo"), str(tmp)


def _shards(tmp, key):
    """{shard index: {field: array}} of every worker's final shards."""
    out = {}
    for rank in range(NPROCS):
        with np.load(os.path.join(tmp, f"{key}_{rank}.npz")) as z:
            for name in z.files:
                f, i = name.rsplit("_", 1)
                out.setdefault(int(i), {})[f] = z[name]
    return out


def _one_process(key):
    """The case run in this one process on the same mesh: (LoopResult,
    the parameters)."""
    import armon_torch
    from armon_torch.core.solver import make_init_fused, make_mesh
    from armon_torch.core.step import make_time_loop_lean
    _, P, route, split, start, dtype = CASES[CASE_IDS.index(key)]
    params = armon_torch.ArmonParameters(**_opts(P, route, split, dtype,
                                                 "cpu"))
    fs, seed = make_init_fused(params)()
    fs, t, dt, lm = _start(params, fs, seed, start)
    return make_time_loop_lean(params.config, make_mesh(params))(
        fs, t, start, dt, lm), params


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("key", CASE_IDS)
def test_while_plain_over_processes_matches_eager_and_one_process(gloo_job,
                                                                  key):
    """`while_plain` over two gloo processes: every shard bit for bit the
    eager windowed loop's and the one-process run's, the same scalars;
    one host read a run; the same iterations on both processes, as many
    bodies as cover the cycles run."""
    results, tmp = gloo_job
    rows = [r["cases"][key] for r in results]
    assert len({json.dumps(r["plain"]) for r in rows}) == 1, rows
    assert len({r["iterations"] for r in rows}) == 1, rows
    row = rows[0]
    assert row["plain"][:-1] == row["eager"][:-1]
    assert row["plain"][0] == MAXCYCLE and row["plain"][-1] == 3
    start = CASES[CASE_IDS.index(key)][4]
    assert row["iterations"] == -(-(MAXCYCLE - start) // row["body_steps"])
    plain, eager = _shards(tmp, f"plain_{key}"), _shards(tmp, f"eager_{key}")
    one, _ = _one_process(key)
    assert [one.cycles, one.t, one.dt_last, one.lm, one.ok] == row["plain"][:5]
    assert sorted(plain) == sorted(eager) == list(range(len(one.carry)))
    for i, carry in enumerate(one.carry):
        for f in FIELDS:
            want = getattr(carry, f).numpy()
            assert _bits(plain[i][f], eager[i][f]), (i, f)
            assert _bits(plain[i][f], want), (i, f)


@pytest.mark.parametrize("key", CASE_IDS)
def test_bodies_repeat_over_processes(gloo_job, key):
    """Each body of `while_plain` over processes makes the same launches
    and the same collective calls (an exchange per launch along a sharded
    axis, one gather a cycle), on the loop's own send stacks, slab
    buffers and gather buffers, whose pointers are the same every body:
    no tensor is made in a step."""
    results, _ = gloo_job
    for r in results:
        row = r["cases"][key]
        assert row["bodies"] == row["iterations"] >= 2, row
        assert row["bodies_repeat"], row
        assert row["collective_ptrs_own"], row
        assert row["collective_ptrs_per_body"] == 1, row
        assert row["gathers_per_body"] == row["body_steps"], row
        assert row["exchanges_per_body"] >= row["body_steps"], row


def test_graphs_true_over_gloo_raises(gloo_job):
    """Over gloo, `use_graphs(True, ...)` with the live group's backend
    and `armon(..., graphs=True)` raise on every process."""
    results, _ = gloo_job
    for r in results:
        assert r["backend"] == "gloo"
        gloo, cpu = r["refusals"]
        assert "processes" in gloo and "gloo" in gloo, gloo
        assert "graphs=True" in cpu and "CPU" in cpu, cpu


def test_while_plain_over_processes_within_jax_mesh(gloo_job):
    """2x1 per-sweep, Sequential f64, from cycle 0: the processes' shards
    within 1e-13 of their scale of the JAX package's mesh run on its jnp
    tier (XLA contracts multiply-adds), the same cycles, t within 4 eps."""
    import armon_tpu  # here: the card's machine has no jax
    from armon_tpu.core.solver import gather_state
    from armon_torch.io.subdomain import shard_real_window
    results, tmp = gloo_job
    key = "2x1-per_sweep-Sequential0-float64"
    row = results[0]["cases"][key]
    jp = armon_tpu.ArmonParameters(
        test="Sod_circ", N=N, P=(2, 1), data_type=np.float64,
        axis_splitting="Sequential", maxtime=1e30, maxcycle=MAXCYCLE,
        silent=5, measure_time=False, return_data=True, kernel_tier="jnp")
    js = armon_tpu.armon(jp)
    eps = np.finfo(np.float64).eps
    assert js.cycles == row["plain"][0] == MAXCYCLE
    assert abs(row["plain"][1] - js.final_time) <= 4 * eps * js.final_time
    glob = gather_state(jp, js.data)
    _, params = _one_process(key)
    g = params.config.nghost
    for i, blk in _shards(tmp, f"plain_{key}").items():
        coords = (i % 2, i // 2)
        rs, cs, row0, col0 = shard_real_window(params.config, coords)
        h, w = rs.stop - rs.start, cs.stop - cs.start
        for f in ("rho", "u", "v", "E"):
            b = np.asarray(getattr(glob, f))[g + row0:g + row0 + h,
                                             g + col0:g + col0 + w]
            a = blk[f][rs, cs]
            scale = max(float(np.abs(b).max()), 1.0)
            assert float(np.abs(a - b).max()) <= 1e-13 * scale, (i, f)


def test_eager_reason_by_transport():
    """NCCL processes on a card: graphs (None); gloo processes, the CPU
    and a mesh across cards: a reason, `use_graphs(None, ...)` False and
    `use_graphs(True, ...)` raising."""
    import armon_torch
    from armon_torch.core import graphs as G
    from armon_torch.core.solver import make_mesh
    from armon_torch.utils.errors import SolverException
    assert G.eager_reason("cuda:0", nprocs=2, backend="nccl") is None
    assert G.use_graphs(None, None) is True
    shard = make_mesh(armon_torch.ArmonParameters(
        test="Sod", N=N, P=(2, 1), device="cpu")).shards[1]
    for reason, what in (
            (G.eager_reason("cuda:0", nprocs=2, backend="gloo"), "gloo"),
            (G.eager_reason("cuda:0", nprocs=2), "processes"),
            (G.eager_reason("cpu", nprocs=2, backend="nccl"), "CPU"),
            (G.eager_reason("cuda:0", far=[shard], nprocs=2,
                            backend="nccl"), "across cards")):
        assert reason is not None and what in reason, reason
        assert G.use_graphs(None, reason) is False
        assert G.use_graphs(False, reason) is False
        with pytest.raises(SolverException, match=what):
            G.use_graphs(True, reason)


def test_whole_reason_by_transport():
    """The transport rule for the whole-run graph: one process may launch
    it; NCCL processes take window graphs, with a reason that names NCCL.
    `loop_graphs` records the form of a loop that runs no graph."""
    from armon_torch.core import graphs as G
    assert G.whole_reason(1) is None
    for nprocs in (2, 4):
        why = G.whole_reason(nprocs)
        assert why is not None and "NCCL" in why and "window" in why, why
    G.reset_stats()
    assert G.loop_graphs(False, None, "cuda:0") is None
    assert G.STATS["form"] == "eager"
    assert G.loop_graphs(None, "the CPU has no CUDA graphs", "cpu") is None
    G.reset_stats()
    assert G.STATS["form"] is None


class _FakeGraphs:
    """A `CycleGraphs` stand-in on the CPU: its transport rule
    (`takes_whole` on `why` and `strict`), windows run eagerly and
    recorded, and a whole run recorded as one."""

    def __init__(self, why, strict):
        from armon_torch.core import graphs as G
        self.why, self.strict, self.calls = why, strict, []
        self.takes_whole = lambda: G.CycleGraphs.takes_whole(self)

    def window(self, run, start, n):
        self.calls.append(("window", start, n))
        for i in range(start, start + n):
            run.cycle(i)

    def run(self, run, start, n, pred):
        self.calls.append(("whole", start, n))
        from armon_torch.core import graphs as G
        return G.while_plain(run, start, n, pred)


@pytest.mark.parametrize("nprocs,strict", [(1, False), (2, False), (2, True)],
                         ids=["one-process", "nccl", "nccl-graphs_true"])
def test_drive_takes_form_by_transport(nprocs, strict):
    """`_Windows.drive` with `whole`: one process launches the whole-run
    graph (one host read); over NCCL processes it replays windows of
    `check_every` cycles, one host read each, the same bits; with
    `graphs=True` it raises, naming NCCL."""
    import armon_torch
    from armon_torch.core import graphs as G
    from armon_torch.core.solver import make_init_fused
    from armon_torch.core.step import KernelCycles
    from armon_torch.ops import sweep as K
    from armon_torch.utils.errors import SolverException
    params = armon_torch.ArmonParameters(**_opts(
        (1, 1), PER_SWEEP, "Sequential", "float64", "cpu"))
    cfg = params.config
    fs, seed = make_init_fused(params)()

    def run():
        r = KernelCycles(cfg, None, _clone(fs), 0.0, 0, 0.0, float(seed),
                         False)
        r.first_step()
        return r
    eager = run()
    reads_e = eager.drive(0, 4, K.IS_RUN)
    r = run()
    r.graphs = fake = _FakeGraphs(G.whole_reason(nprocs), strict)
    if strict:
        with pytest.raises(SolverException, match="NCCL"):
            r.drive(0, 4, K.IS_RUN)
        assert fake.calls == []
        return
    reads = r.drive(0, 4, K.IS_RUN)
    if nprocs == 1:
        assert [c[0] for c in fake.calls] == ["whole"] and reads == 1
    else:
        assert fake.calls == [("window", i, 4) for i in range(0, MAXCYCLE, 4)]
        assert reads == reads_e == MAXCYCLE // 4
    for a, b in zip(r.result(reads).carry, eager.result(reads_e).carry):
        for x, y in zip(a, b):
            assert _bits(x.numpy(), y.numpy())


# ----------------------------------------------------------------- the card

@pytest.mark.gpu
def test_graphs_over_nccl_processes_on_cards(tmp_path):
    """Two NCCL processes, a card each: on every case the lean loop's
    default form (window graphs, by the transport rule) against
    `graphs=False`, bit for bit in f64 and f32 exact, the same scalars
    and host reads on both processes."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL puts one process on a card)")
    results = _run_job(tmp_path, "nccl")
    for r in results:
        assert r["backend"] == "nccl"
        for key, row in r["cases"].items():
            assert row["bitwise"], (key, row)
            assert row["graphed"][:-1] == row["eager"][:-1], (key, row)
            assert row["form"] == "windows" and row["runs"] == 0, (key, row)
    for key in CASE_IDS:
        assert len({json.dumps(r["cases"][key]["graphed"])
                    for r in results}) == 1, key
        assert len({r["cases"][key]["form"] for r in results}) == 1, key


@pytest.mark.gpu
def test_default_run_over_nccl_without_graph_mixing(tmp_path):
    """With NCCL's graph mixing off (`NCCL_GRAPH_MIXING_SUPPORT=0`), a
    default `armon()` run over two NCCL processes still finishes, in
    window graphs, bit for bit the eager loop's."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL puts one process on a card)")
    results = _run_job(tmp_path, "nomix", NCCL_GRAPH_MIXING_SUPPORT="0")
    for r in results:
        assert r["mixing"] == "0" and r["form"] == "windows", r
        assert r["bitwise"] and r["graphed"] == r["eager"], r
        assert r["graphed"][0] == MAXCYCLE, r
    assert results[0]["graphed"] == results[1]["graphed"]


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    mode, rank, port, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
        sys.argv[4]
    {"gloo": _gloo_worker, "nccl": _nccl_worker,
     "nomix": _nomix_worker}[mode](rank, port, tmp)
    sys.exit(0)
