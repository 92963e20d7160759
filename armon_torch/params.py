"""User-facing solver parameters (`armon_tpu/params.py`).

The same keyword cascade as the JAX package: each init step consumes its
options, and any leftover raises an error naming the unknown options
(`src/parameters.jl:359-372`). Every option of the JAX package is taken;
the x86 and MPI machinery with no card counterpart (threads, SIMD, NUMA,
`reorder_grid`, `global_comm`) is recorded and has no effect, as there.

PyTorch additions:
- ``device``: where the tensors live and the kernels run, ``"cuda"`` by
  default. ``"cpu"`` runs every kernel's plain PyTorch version in exact
  arithmetic (the tests use it). ``"cuda"`` without a card raises.
- ``devices``: with ``P=(px, py)``, the device of each shard, a list of
  px*py torch devices in row-major (py, px) order (over several
  processes, of this process's shards). Repeats are allowed:
  ``["cuda:0"] * 4`` runs a 2x2 mesh on one card. Without it, a mesh on
  ``"cuda"`` puts its shards on cuda:0..n-1 and raises when the machine
  has fewer cards; on ``"cpu"`` every shard is on the CPU.

Runs over several processes (`parallel/dist.py`): ``coordinator_address``
("host:port") joins the processes through `torch.distributed`, with
``num_processes`` and ``process_id`` (or the launcher's WORLD_SIZE and
RANK); a default process group the caller set up is used as it is. The
px*py shards are cut, in mesh order, into equal contiguous blocks, one a
process in rank order. Shards on CUDA talk over NCCL, or over gloo through
host copies with ``gpu_aware=False``, which two processes on one card
need; CPU shards talk over gloo.
"""

import os

import numpy as np
import torch

from .utils.errors import solver_error
from .models.cases import test_from_name, TestCase, _REGISTRY
from .core.config import SolverConfig, OP_PATH_TIERS
from .core.state import State
from .parallel import dist


_DTYPE_NAMES = {
    "float64": np.float64, "Float64": np.float64, "f64": np.float64,
    "float32": np.float32, "Float32": np.float32, "f32": np.float32,
}

# Field-sized arrays alive at the peaks `memory_required` counts, one
# shard on its device. Measured, not derived: Sod 8192^2 f32, the peak of
# `torch.cuda.max_memory_allocated` over the allocation before, in arrays
# of 8200^2 x 4 B, rounded up (NVIDIA H100 80GB HBM3, 700.00 W;
# `chip_smoke.py` phases 3, 9 and 11):
# - the op path's run, 20 cycles: 70.50 (18,962,072,064 B), the 11-field
#   State, its successor and a sweep's temporaries (its fused
#   multiply-adds are formed there in f64, `ops/fma.CHUNK` elements at a
#   time);
OP_PATH_PEAK_FIELDS = 71
# - a kernel run's initialisation (`make_init_fused`: init_state, the
#   cycle-0 EOS, the CFL maxima): 11.996 (3,226,473,984 B), over the time
#   loop's 9;
KERNEL_INIT_PEAK_FIELDS = 12
# - a kernel run that rebuilds the full State after its loop
#   (`return_data`, `write_output`, `write_slices`; `make_rehydrate`: the
#   carry's 5 and a re-run of init and EOS), 100 cycles: 16.00002
#   (4,303,364,608 B).
REHYDRATE_PEAK_FIELDS = 17

# kernel_tier values that select the hand-written kernels (the op path's
# are `core/config.OP_PATH_TIERS`).
KERNEL_TIERS = ("auto", "cuda", "pallas")


def _stencil_width_riemann(scheme: str) -> int:
    # src/riemann_schemes.jl:17-18
    return {"Godunov": 1, "GAD": 2}[scheme]


def _stencil_width_projection(projection: str) -> int:
    # src/projection_schemes.jl:11-12
    return {"euler": 1, "euler_2nd": 2}[projection]


def resolve_device(name) -> torch.device:
    """The torch.device for the `device` option. A CUDA device with no card
    present is an error, never a silent move to the CPU."""
    try:
        dev = torch.device(name)
    except (RuntimeError, TypeError) as e:
        solver_error("config", f"Unknown device: {name!r} ({e})")
    if dev.type not in ("cuda", "cpu"):
        solver_error("config", f"Unsupported device type: '{dev.type}' "
                               f"(armon_torch runs on 'cuda' or 'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        solver_error("config", "device 'cuda' requested but no CUDA card is "
                               "available (pass device='cpu' to run the "
                               "plain PyTorch path)")
    return dev


class ArmonParameters:
    """Validating front-end. ``ArmonParameters(**options)`` then
    ``armon(params)``."""

    def __init__(self, **options):
        opts = dict(options)

        # --- data type + grid (src/parameters.jl:348-353)
        data_type = opts.pop("data_type", np.float64)
        if isinstance(data_type, str):
            data_type = _DTYPE_NAMES.get(data_type)
        if isinstance(data_type, type) and data_type is float:
            data_type = np.float64
        if data_type not in (np.float64, np.float32):
            solver_error("config", f"Unsupported data_type: {options.get('data_type')}")
        self.data_type = np.dtype(data_type)

        N = tuple(opts.pop("N", (10, 10)))
        if len(N) != 2 or any(n <= 0 for n in N):
            solver_error("config", f"Invalid grid size N: {N}")
        self.N = N  # global real cells (nx, ny)

        self._init_scheme(opts)
        self._init_test(opts)
        self._init_mesh(opts)
        self._init_device(opts)
        self._init_profiling(opts)
        self._init_indexing(opts)
        self._init_output(opts)

        if opts:
            bad = ", ".join(f"'{k}'" for k in opts)
            raise TypeError(f"{len(opts)} unconsumed options:\n{bad}")

        self.initial_mass = 0.0
        self.initial_energy = 0.0
        self._config = None

    # ------------------------------------------------------------------ init
    def _init_scheme(self, o):
        """src/parameters.jl:577-630"""
        self.scheme = str(o.pop("scheme", "GAD"))
        if self.scheme not in ("Godunov", "GAD"):
            solver_error("config", f"Unknown scheme: '{self.scheme}'")
        self.projection = str(o.pop("projection", "euler_2nd"))
        if self.projection not in ("euler", "euler_2nd"):
            solver_error("config", f"Unknown projection scheme: '{self.projection}'")
        self.riemann_limiter = str(o.pop("riemann_limiter", "minmod"))
        if self.riemann_limiter not in ("no_limiter", "minmod", "superbee"):
            solver_error("config", f"Unknown limiter name: '{self.riemann_limiter}'")
        self.axis_splitting = str(o.pop("axis_splitting", "Sequential"))
        if self.axis_splitting == "SequentialSym":
            self.axis_splitting = "Godunov"
        if self.axis_splitting not in ("Sequential", "Godunov", "Strang", "X_only", "Y_only"):
            solver_error("config", f"Unknown splitting method: '{self.axis_splitting}'")

        self.nghost = int(o.pop("nghost", 4))
        # A real cell's output depends on ghosts up to depth
        # stencil(riemann) + stencil(projection): the SUM, not the Julia
        # reference's product rule (`src/parameters.jl:609-613`), which
        # under-counts at first-order projections.
        min_nghost = (_stencil_width_riemann(self.scheme)
                      + _stencil_width_projection(self.projection))
        if self.nghost < min_nghost:
            solver_error("config",
                         f"Not enough ghost cells for the scheme: at least "
                         f"{min_nghost} are needed (stencil sum; the "
                         f"reference's product rule under-counts), got "
                         f"{self.nghost}")

        self.cst_dt = bool(o.pop("cst_dt", False))
        self.Dt = float(o.pop("Dt", 0.0))
        self.dt_on_even_cycles = bool(o.pop("dt_on_even_cycles", False))
        if self.cst_dt and self.Dt == 0:
            solver_error("config", "Dt == 0 with constant step enabled")

    def _init_test(self, o):
        """src/parameters.jl:632-670"""
        test = o.pop("test", "Sod")
        domain_size = o.pop("domain_size", None)
        origin = o.pop("origin", None)
        cfl = float(o.pop("cfl", 0.0))
        maxtime = float(o.pop("maxtime", 0.0))
        # Clamped to int32, the device cycle counter's type.
        self.maxcycle = min(int(o.pop("maxcycle", 500_000)), 2**31 - 1)

        if isinstance(test, TestCase):
            self.test = test
        else:
            cls = _REGISTRY.get(str(test))
            if cls is None:
                solver_error("config", f"Unknown test case: '{test}'")
            ds = tuple(domain_size) if domain_size is not None else cls.default_domain_size
            self.test = test_from_name(test, ds[0] / self.N[0],
                                       ds[1] / self.N[1], self.data_type)

        tcls = type(self.test)
        self.domain_size = tuple(map(float, domain_size)) if domain_size is not None \
            else tuple(map(float, tcls.default_domain_size))
        self.origin = tuple(map(float, origin)) if origin is not None \
            else tuple(map(float, tcls.default_domain_origin))

        # cfl/maxtime default to the test's values (src/parameters.jl:666-667)
        self.cfl = cfl if cfl != 0 else self.test.default_CFL
        self.maxtime = maxtime if maxtime != 0 else self.test.default_max_time

    def _init_mesh(self, o):
        """src/parameters.jl:408-467 (`armon_tpu/params.py:194-229`): the
        shard grid P = (px, py), and the processes that drive it (joined
        in `_init_device`, once the device type is known)."""
        self.use_MPI = bool(o.pop("use_MPI", False))
        self.P = tuple(o.pop("P", (1, 1)))
        # The H100s of a host are joined all to all (NVLink switch), so no
        # shard placement beats another: the given order is always kept.
        self.reorder_grid = bool(o.pop("reorder_grid", True))
        o.pop("global_comm", None)  # the default process group is the one
        self.gpu_aware = bool(o.pop("gpu_aware", True))
        if len(self.P) != 2 or any(int(p) != p or p <= 0 for p in self.P):
            solver_error("config", f"Invalid process grid P: {self.P}")
        self.P = (int(self.P[0]), int(self.P[1]))
        self.coordinator_address = o.pop("coordinator_address", None)
        self.num_processes = o.pop("num_processes", None)
        self.process_id = o.pop("process_id", None)
        self._devices_option = o.pop("devices", None)

    def _init_processes(self, device_type):
        """Join the run's processes (`armon_tpu/params.py:213-229`):
        `coordinator_address` starts `torch.distributed` on the backend the
        device type and `gpu_aware` select (`dist.backend_for`); a default
        process group that already exists is used as it is. Over several
        processes the shard count must be a multiple of theirs, and
        `use_MPI` is forced: per-shard output and snapshots are the only
        routes when shards live on other processes (the gather paths
        raise there)."""
        if self.coordinator_address is not None:
            dist.init_distributed(self.coordinator_address, self.num_processes,
                                  self.process_id,
                                  dist.backend_for(device_type, self.gpu_aware))
        self.process_count = dist.process_count()
        self.process_index = dist.process_index()
        if self.process_count > 1:
            px, py = self.P
            if px * py % self.process_count:
                solver_error("config",
                             f"mesh {px}x{py} has {px * py} shards, not a "
                             f"multiple of the {self.process_count} processes")
            self.use_MPI = True

    def _place_shards(self, device, devices):
        """The device of each of this process's shards, in row-major
        (py, px) order: process r of n drives shards [r*k, (r+1)*k), k =
        px*py / n."""
        px, py = self.P
        n = px * py
        k = n // self.process_count
        if devices is not None:
            devs = [resolve_device(d) for d in devices]
            if len(devs) < k:
                solver_error("config", f"mesh {px}x{py} needs {k} devices"
                             + (" a process" if k < n else "")
                             + f", got {len(devs)}")
            # A bare "cuda" is the current card, named so that the shards
            # of a one-card mesh compare equal to their tensors' devices.
            devs = [torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None and n > 1 else d
                    for d in devs[:k]]
            if device is not None and resolve_device(device).type != devs[0].type:
                solver_error("config", f"device={device!r} disagrees with "
                                       f"devices={list(devices)!r}")
        else:
            dev = resolve_device("cuda" if device is None else device)
            first = dev.index or 0
            have = torch.cuda.device_count() if dev.type == "cuda" else 0
            if dev.type == "cpu" or n == 1:
                devs = [dev] * k
            elif k < n:
                # Process r's shards on the cards after the earlier
                # processes' ones, wrapping round the machine's cards.
                r = self.process_index
                devs = [torch.device("cuda", (first + r * k + j) % have)
                        for j in range(k)]
            else:
                if first + n > have:
                    solver_error("config",
                                 f"mesh {px}x{py} needs {n} CUDA cards from "
                                 f"cuda:{first}, the machine has {have} (pass "
                                 f"devices=['cuda:0'] * {n} to place every "
                                 f"shard on one card)")
                devs = [torch.device("cuda", first + i) for i in range(n)]
        if len({d.type for d in devs}) > 1:
            solver_error("config", f"a mesh cannot mix CPU and CUDA devices: "
                                   f"{[str(d) for d in devs]}")
        if k < n and devs[0].type == "cuda" and self.gpu_aware:
            self._check_one_process_a_card(devices is None, k)
        return tuple(devs)

    def _check_one_process_a_card(self, default_placement, k):
        """NCCL cannot put two processes on one card: say so before NCCL
        does. The machine's card count tells where there are more
        processes than cards, and the default placement where it wraps
        round them."""
        nprocs = self.process_count
        have = torch.cuda.device_count()
        cards = {(q * k) % have for q in range(nprocs)} \
            if default_placement else range(have)
        if nprocs > len(cards):
            solver_error("config",
                         f"{nprocs} processes would share {have} CUDA "
                         f"card(s), and NCCL cannot put two processes on one "
                         f"card: pass gpu_aware=False to exchange through "
                         f"host memory over gloo")

    def _init_device(self, o):
        """src/parameters.jl:470-530. Threading/SIMD/NUMA/cache-blocking are
        x86 machinery with no GPU counterpart; accepted as no-ops for
        configuration compatibility, as the JAX package does."""
        device = o.pop("device", None)
        devices = self._devices_option
        del self._devices_option
        # The JAX package keeps no compiled program for a run given
        # explicit devices (`_cached`); the port's program cache reads this.
        self._devices_given = devices is not None
        self._init_processes(resolve_device(
            devices[0] if devices else
            "cuda" if device is None else device).type)
        self.devices = self._place_shards(device, devices)
        self.device = self.devices[0]
        if self.process_count > 1:
            # Every process agrees on the mesh before any exchange (and
            # NCCL's communicator is made here, by every process at once).
            dist.barrier(f"ArmonParameters N={self.N} P={self.P}", self.device)
        self.use_gpu = bool(o.pop("use_gpu", False))
        if o.pop("use_kokkos", False):
            solver_error("config", "use_kokkos is not supported: the native "
                                   "kernels are hand-written CUDA")
        self.use_threading = bool(o.pop("use_threading", True))
        self.use_simd = bool(o.pop("use_simd", True))
        self.use_cache_blocking = bool(o.pop("use_cache_blocking", True))
        self.async_cycle = bool(o.pop("async_cycle", False))
        # A tile-size hint in the JAX package; the CUDA kernels' launch
        # shapes are fixed, so it is kept and has no effect.
        self.block_size = o.pop("block_size", None)
        self.use_two_step_reduction = bool(o.pop("use_two_step_reduction", False))
        self.workload_distribution = o.pop("workload_distribution", "simple")
        o.pop("distrib_params", None)
        self.numa_aware = bool(o.pop("numa_aware", False))
        self.lock_memory = bool(o.pop("lock_memory", False))
        self.busy_wait_limit = int(o.pop("busy_wait_limit", 100))
        # "auto", "cuda" and "pallas" select the hand-written kernels;
        # "torch" selects the op path (plain tensor ops, the JAX package's
        # jnp tier). "pallas" and "jnp" are accepted so option dicts written
        # for the JAX package run as they are. Only this option selects the
        # op path: nothing falls back to it.
        self.kernel_tier = str(o.pop("kernel_tier", "auto"))
        if self.kernel_tier not in KERNEL_TIERS + OP_PATH_TIERS:
            solver_error("config", f"Unknown kernel_tier: '{self.kernel_tier}'")
        # use_fast_math (src/generic_kernel.jl:3, default true): f32 CUDA
        # kernels divide through an approximate reciprocal. False = IEEE.
        # The op path always divides in IEEE arithmetic.
        self.use_fast_math = bool(o.pop("use_fast_math", True))
        # Route selection (`ops/routing.py`): pair_threshold=0 forces the
        # per-sweep kernels, temporal_blocking=1 turns off the K5 route.
        self.pair_threshold = int(o.pop(
            "pair_threshold", os.environ.get("ARMON_PAIR_THRESHOLD", 2048)))
        self.temporal_blocking = int(o.pop(
            "temporal_blocking", os.environ.get("ARMON_TEMPORAL_K", 8)))

    def _init_profiling(self, o):
        """src/parameters.jl:532-575. Known profilers: 'trace'
        (`torch.profiler`, a Chrome trace under `output_dir/profile`).
        `log_blocks` runs the per-cycle driver and keeps the solver log
        (`utils/solver_log.py`)."""
        prof = o.pop("profiling", [])
        # A bare string ('profiling=trace', the natural CLI spelling) is
        # ONE profiler name, not an iterable of characters.
        self.profiling = [prof] if isinstance(prof, str) else list(prof)
        unknown = set(map(str, self.profiling)) - {"trace"}
        if unknown:
            solver_error("config", "Unknown profiler" +
                         ("s" if len(unknown) > 1 else "") + ": " +
                         ", ".join(sorted(unknown)))
        self.measure_time = bool(o.pop("measure_time", True))
        self.time_async = bool(o.pop("time_async", True))
        self.log_blocks = bool(o.pop("log_blocks", False))
        o.pop("estimated_blk_log_size", None)

    def _init_indexing(self, o):
        """src/parameters.jl:673-697 (`armon_tpu/params.py:294-322`): split
        the global grid over the mesh. Every shard is padded to n_local =
        ceil(N/P) real cells and the hi-edge shard owns the short remainder
        n_edge; its slack cells are dead."""
        self.global_grid = self.N
        px, py = self.P
        nx, ny = self.global_grid
        self.n_local = (-(-nx // px), -(-ny // py))
        self.n_edge = (nx - (px - 1) * self.n_local[0],
                       ny - (py - 1) * self.n_local[1])
        if any(p > 1 and min(n, e) < self.nghost
               for p, n, e in zip(self.P, self.n_local, self.n_edge)):
            solver_error("config",
                         f"domain {self.global_grid} is too small to be split "
                         f"by {self.P} devices while keeping more than "
                         f"{self.nghost} cells along each axis")

    def _init_output(self, o):
        """src/parameters.jl:700-728, the JAX package's defaults
        (`armon_tpu/params.py:324-341`). `silent <= 1`, `animation_step`,
        `checkpoint_step` and `compare` run the per-cycle driver
        (`core/solver.py`), one host read a cycle."""
        self.silent = int(o.pop("silent", 0))
        self.output_dir = str(o.pop("output_dir", "."))
        self.output_file = str(o.pop("output_file", "output"))
        self.write_output = bool(o.pop("write_output", False))
        self.write_ghosts = bool(o.pop("write_ghosts", False))
        self.write_slices = bool(o.pop("write_slices", False))
        p = o.pop("output_precision", None)
        self.output_precision = int(p) if p is not None else \
            (17 if self.data_type.itemsize == 8 else 9)
        self.animation_step = int(o.pop("animation_step", 0))
        # A restartable snapshot every N cycles (`io/restart.py`; resume
        # with armon(..., restore_from=path)).
        self.checkpoint_step = int(o.pop("checkpoint_step", 0))
        self.compare = bool(o.pop("compare", False))
        self.is_ref = bool(o.pop("is_ref", False))
        self.comparison_tolerance = float(o.pop("comparison_tolerance", 1e-10))
        self.check_result = bool(o.pop("check_result", False))
        self.return_data = bool(o.pop("return_data", False))

    # ------------------------------------------------------------- derived
    @property
    def config(self) -> SolverConfig:
        if self._config is None:
            self._config = SolverConfig(
                dtype=self.data_type,
                nghost=self.nghost,
                n_global=self.global_grid,
                n_local=self.n_local,
                proc_dims=self.P,
                n_edge=self.n_edge,
                domain_size=self.domain_size,
                origin=self.origin,
                test=self.test,
                riemann=self.scheme,
                limiter=self.riemann_limiter,
                projection=self.projection,
                splitting=self.axis_splitting,
                cfl=self.cfl,
                maxtime=self.maxtime,
                maxcycle=self.maxcycle,
                Dt=self.Dt,
                cst_dt=self.cst_dt,
                dt_on_even_cycles=self.dt_on_even_cycles,
                fast_math=self.use_fast_math,
                kernel_tier=self.kernel_tier,
                pair_threshold=self.pair_threshold,
                temporal_blocking=self.temporal_blocking,
            )
        return self._config

    def memory_required(self) -> dict:
        """Device bytes of the run's buffers (`armon_tpu/params.py:
        374-387`, `src/blocking/block_grid.jl:598-709`), on the device that
        holds the most (`per_device_*`) and summed over devices
        (`total_bytes`, `fused_total_bytes`). A device counts every shard
        placed on it; over several processes, this process's shards only.
        Both paths are reported, with the JAX package's keys:

        - `per_device_total_bytes`, the op path's footprint (the full-state
          path): each shard's 11-field State and its successor, 22 fields,
          and the temporaries of the one shard a sweep works on, up to
          `OP_PATH_PEAK_FIELDS` fields in all; `per_device_transient_bytes`
          is what it holds besides the States (`per_device_state_bytes`);
        - `per_device_fused_total_bytes`, the kernel path's: its time
          loop, where each shard holds two sets of rho/u/v/E (the sweeps
          write out of place) plus p, 9 fields, a (4, g, cols) or (4, rows,
          g) ghost slab for each side that faces a neighbour
          (`per_device_halo_bytes`), and the CFL partials of the cycle's
          last launch, one column per block a shard: what a loop of the
          program cache keeps on the card from its first call on
          (`core/solver._cached`), so it stands beside the largest of the
          rest of a run: a shard's initialisation
          (`KERNEL_INIT_PEAK_FIELDS`) beside the earlier shards' 5-field
          carries; when the run rebuilds the full State after the loop,
          the rebuild (`REHYDRATE_PEAK_FIELDS` for one shard, 10 more for
          each other: its carry and its rebuilt x, y, c, g and zeros);
          and on a mesh that gathers the global State (`return_data`,
          `write_slices`, a global `write_output`), the shards' States and
          the global one on the first device;
        - `per_device_conservation_bytes`, in both totals: the scratch K6
          `ff_sum` keeps for each f32 shard on a card (16 bytes a real
          row and 20 more, `ops/reductions.FfScratch`), which the program
          cache keeps with the conservation function; 0 on the CPU, whose
          sums are the plain version's, and in f64;
        - `per_device_loop_bytes`: the time loop's fields and slabs on the
          path this run takes (22 fields a shard on the op path)."""
        from .ops import cycle as C, sweep as K
        from .ops.routing import cycle_route
        from .parallel.mesh import Mesh
        from .utils.enums import Axis
        cfg = self.config
        g = self.nghost
        nx, ny = self.n_local
        shape = rows, cols = ny + 2 * g, nx + 2 * g
        itemsize = self.data_type.itemsize
        field = rows * cols * itemsize
        px, py = self.P
        dev0 = self.devices[0]
        nb = max(K.n_partials(Axis.X, shape, dev0),
                 K.n_partials(Axis.Y, shape, dev0),
                 C.n_partials(shape, dev0, cfg.dtype)
                 if cycle_route(cfg) == "pair" else 0)
        n_state = len(State._fields)
        shards, halo, cons = {}, {}, {}
        for s in Mesh.of(self).local:
            ix, iy = s.ix, s.iy
            slabs = ((ix > 0) + (ix < px - 1)) * rows * g \
                + ((iy > 0) + (iy < py - 1)) * g * cols
            shards[s.device] = shards.get(s.device, 0) + 1
            halo[s.device] = halo.get(s.device, 0) + 4 * slabs * itemsize
            cons[s.device] = cons.get(s.device, 0) + (
                16 * s.n_real[1] + 20
                if itemsize == 4 and s.device.type == "cuda" else 0)
        rebuild = self.return_data or self.write_output or self.write_slices
        gather = len(self.devices) > 1 and (
            self.return_data or self.write_slices
            or (self.write_output and not (cfg.spmd and self.use_MPI)))
        gx, gy = self.N
        global_state = n_state * (gy + 2 * g) * (gx + 2 * g) * itemsize
        op, fused = {}, {}
        for dev, k in shards.items():
            op[dev] = (2 * n_state * k + OP_PATH_PEAK_FIELDS
                       - 2 * n_state) * field + cons[dev]
            loop = 9 * k * field + halo[dev] + cons[dev] + (
                2 * px * py * nb * itemsize if dev == dev0 else 0)
            fields = max(5 * (k - 1) + KERNEL_INIT_PEAK_FIELDS,
                         10 * (k - 1) + REHYDRATE_PEAK_FIELDS if rebuild
                         else 0)
            rest = fields * field
            if gather and dev == dev0:
                rest = max(rest, n_state * k * field + global_state)
            fused[dev] = loop + rest
        state = max(n_state * k * field for k in shards.values())
        total = max(op.values())
        return {
            "per_device_field_bytes": field,
            "per_device_state_bytes": state,
            "per_device_transient_bytes": total - state,
            "per_device_halo_bytes": max(halo.values()),
            "per_device_conservation_bytes": max(cons.values()),
            "per_device_total_bytes": total,
            "per_device_fused_total_bytes": max(fused.values()),
            "per_device_loop_bytes": max(
                2 * n_state * k * field for k in shards.values())
            if cfg.op_path else max(9 * k * field + halo[d]
                                    for d, k in shards.items()),
            "total_bytes": sum(op.values()),
            "fused_total_bytes": sum(fused.values()),
        }

    def __repr__(self):
        return (f"ArmonParameters(test={self.test!r}, N={self.N}, "
                f"dtype={self.data_type.name}, scheme={self.scheme}, "
                f"projection={self.projection}, limiter={self.riemann_limiter}, "
                f"splitting={self.axis_splitting}, device={self.device})")

    def describe(self) -> str:
        """Multi-line parameter block (`src/parameters.jl:826-900`)."""
        mem = self.memory_required()
        dt_line = (f"constant at {self.Dt}" if self.cst_dt else
                   "initialized automatically, updated " +
                   ("only at even cycles" if self.dt_on_even_cycles
                    else "every cycle"))
        from .ops.routing import route, temporal_pairs
        fast = self.use_fast_math and self.data_type.itemsize == 4 \
            and self.device.type == "cuda" and not self.config.op_path
        if self.config.op_path:
            kernels = f"torch op path (kernel_tier='{self.kernel_tier}')"
        else:
            kernels = {"per_sweep": "per-sweep kernels",
                       "pair": "whole-cycle kernel (pair route)",
                       "multicycle": "multicycle kernel (K=%d)"
                                     % len(temporal_pairs(self.config) or ())
                       }[route(self.config)]
        lines = [
            "Armon (PyTorch/CUDA) parameters:",
            f" - test:       {self.test!r}",
            f" - grid:       {self.N[0]}x{self.N[1]} cells "
            f"(+{self.nghost} ghosts), domain {self.domain_size} "
            f"from {self.origin}",
            f" - data type:  {self.data_type.name}",
            f" - scheme:     {self.scheme}"
            + (f" + {self.riemann_limiter} limiter"
               if self.scheme == "GAD" else ""),
            f" - projection: {self.projection}",
            f" - splitting:  {self.axis_splitting}",
            f" - time step:  {dt_line}; CFL={self.cfl}",
            f" - stops at:   t={self.maxtime} or {self.maxcycle} cycles",
            f" - device:     {self.device}, {kernels}, "
            + ("fast-math divides" if fast else "IEEE divides"),
        ]
        if self.P != (1, 1):
            lines.append(
                f" - mesh:       {self.P[0]}x{self.P[1]} shards of "
                f"{self.n_local[0]}x{self.n_local[1]} cells (edge "
                f"{self.n_edge[0]}x{self.n_edge[1]}) on "
                f"{', '.join(str(d) for d in self.devices)}")
        if self.process_count > 1:
            lines.append(
                f" - processes:  {self.process_count} over "
                f"{dist.backend()}, "
                f"this one {self.process_index}, with "
                f"{len(self.devices)} shard(s)")
        key = "per_device_total_bytes" if self.config.op_path \
            else "per_device_fused_total_bytes"
        lines.append(f" - memory:     {mem[key] / 1e6:.1f} MB in the time "
                     f"loop, on the busiest device")
        return "\n".join(lines)


def data_type(params: ArmonParameters):
    """Reference API parity (`src/Armon.jl:15`)."""
    return params.data_type.type


def memory_required(params: ArmonParameters):
    return params.memory_required()
