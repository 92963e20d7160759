"""Which kernels run a configuration: the JAX package's routing predicates
(`armon_tpu/core/step.py:253,382`, `armon_tpu/ops/pallas/sweep.py:897,
1854`), so that the same options pick the same kernel family in both
packages.

- Per-sweep (K1 `x_sweep` / K2 `y_sweep` + K3): grids above
  `pair_threshold`, `pair_threshold <= 0`, one-axis splittings, and every
  mesh sharded along X.
- Pair (K4 `cycle` + K3): ``max(n_local) <= pair_threshold`` (default
  2048; a shard's extent on a mesh) and the mesh not sharded along X,
  whose exchanged ghost columns only the per-sweep kernels splice. Each
  adjacent X/Y pair of a cycle's schedule is one K4 launch; a leftover
  sweep (Strang's trailing half sweep) stays K1/K2.
- Multicycle (K5 `multicycle`): `temporal_pairs` is not None: K =
  `temporal_blocking` > 1 (default 8), exactly one X/Y pair per cycle in
  both schedules (Sequential, Godunov), and `multicycle_geom_ok`, which
  refuses every mesh (no exchange can run inside a launch). It takes
  precedence over the pair route, as in the JAX package's lean loop.

Every clause of the JAX package is kept, TPU-born ones included. Born of
the TPU (Mosaic tiling, VMEM) and not of anything the port's kernels need:
the 256 KiB single-tile cap with its 128-lane padding, ``g <= 8`` and
``rows >= 8`` (the 8-row sublane splice), ``g <= 64`` (the lane roll), and
the f32 ``maxcycle < 2**24`` bound (the TPU kernel returns the cycle count
as a float; the port's counter is an int32). ``nx >= g`` and ``ny >= g``
(``rows >= 3g``) come from the JAX kernels' one-shot mirror fill; the
port's fills reflect sequentially and need neither. Retuning `pair_threshold`, `temporal_blocking`
and the cap for the H100 is later work, with measurements (PERF.md).

Not carried over (Mosaic strip workarounds, ROADMAP A11):
`cycle_strips_on`, `seed_cycle_strips`, `strip_emission_plan`,
`cycle_strip_plan` and the `inline_bc_*_ok` VMEM-chunk geometry; the
port's kernels always fill the ghosts in-kernel.
"""

import numpy as np

from ..utils.enums import Axis
from ..core.splitting import split_schedules


def pair_routing_on(cfg) -> bool:
    """`pair_routing_on` (`core/step.py:253`): the `pair_threshold`
    crossover on the shard's extent, and no mesh sharded along X."""
    if not (cfg.pair_threshold > 0
            and max(cfg.n_local) <= cfg.pair_threshold):
        return False
    return not (cfg.spmd and cfg.proc_dims[0] > 1)


def inline_bc_x_ok(cfg) -> bool:
    """The clauses of `inline_bc_x_ok` (`sweep.py:897`) that
    `multicycle_geom_ok` reads on one device: nx >= g and g <= 64."""
    g = cfg.nghost
    return cfg.n_local[0] >= g and g <= 64


def multicycle_geom_ok(cfg, shape) -> bool:
    """`multicycle_geom_ok` (`sweep.py:1854`): whether the K-cycles kernel
    admits a padded (rows, cols) grid. See the module doc for which
    clauses the TPU imposed."""
    if cfg.spmd:
        return False
    g = cfg.nghost
    rows, cols = shape
    if g > 8 or rows < max(8, 3 * g) or not inline_bc_x_ok(cfg):
        return False
    itemsize = np.dtype(cfg.dtype).itemsize
    if (rows + 8) * (-(-cols // 128) * 128) * itemsize > 256 * 1024:
        return False
    if itemsize == 4 and cfg.maxcycle >= (1 << 24):
        return False
    return True


def _one_pair_per_cycle(even, odd) -> bool:
    return all(len(s) == 2 and {s[0][0], s[1][0]} == {Axis.X, Axis.Y}
               for s in (even, odd))


def temporal_pairs(cfg):
    """`temporal_pairs` (`core/step.py:382`): the per-cycle
    ((x_first, fx, fy), ...) schedule of one K5 launch, starting on an even
    cycle, or None when temporal blocking does not apply. K is forced even
    when the schedules alternate (Godunov)."""
    K = cfg.temporal_blocking
    if K <= 1 or not multicycle_geom_ok(cfg, cfg.local_shape):
        return None
    even, odd = split_schedules(cfg.splitting)
    if not _one_pair_per_cycle(even, odd):
        return None
    if even != odd:
        K -= K % 2
        if K < 2:
            return None
    pairs = []
    for k in range(K):
        (a0, f0), (_, f1) = even if k % 2 == 0 else odd
        xf = a0 is Axis.X
        pairs.append((xf, f0 if xf else f1, f1 if xf else f0))
    return tuple(pairs)


def cycle_route(cfg) -> str:
    """"pair" or "per_sweep": the kernels of one cycle at a time, which
    the per-cycle driver and the full-state restore loop run (never K5,
    as in the JAX package: `solver_cycle_fused`)."""
    if pair_routing_on(cfg) and any(
            {s[i][0], s[i + 1][0]} == {Axis.X, Axis.Y}
            for s in split_schedules(cfg.splitting) for i in range(len(s) - 1)):
        return "pair"
    return "per_sweep"


def route(cfg) -> str:
    """"multicycle", "pair" or "per_sweep": the kernels `armon()` runs."""
    if temporal_pairs(cfg) is not None:
        return "multicycle"
    return cycle_route(cfg)
