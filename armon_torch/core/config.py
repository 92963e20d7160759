"""Static solver configuration (`armon_tpu/core/config.py`).

The frozen half of `ArmonParameters`: scheme selection, grid geometry and
dtype. Kernel variants are chosen from it, so equal configurations run
identical code.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..models.cases import TestCase

# kernel_tier values that select the op path.
OP_PATH_TIERS = ("torch", "jnp")


@dataclass(frozen=True)
class SolverConfig:
    # dtype / geometry
    dtype: np.dtype                      # np.float64 or np.float32
    nghost: int                          # ghost cells per side (>= stencil sum)
    n_global: Tuple[int, int]            # (nx, ny) global real cells
    n_local: Tuple[int, int]             # (nx, ny) real cells per shard
    domain_size: Tuple[float, float]     # (sx, sy)
    origin: Tuple[float, float]          # (ox, oy)

    # physics / scheme
    test: TestCase
    riemann: str = "GAD"                 # "Godunov" | "GAD"
    limiter: str = "minmod"              # "no_limiter" | "minmod" | "superbee"
    projection: str = "euler_2nd"        # "euler" | "euler_2nd"
    splitting: str = "Sequential"        # "Sequential" | "Godunov" | "Strang" | "X_only" | "Y_only"

    # time stepping
    cfl: float = 0.95
    maxtime: float = 0.20
    maxcycle: int = 500_000
    Dt: float = 0.0
    cst_dt: bool = False
    dt_on_even_cycles: bool = False

    # Routing, as in the JAX package (`ops/routing.py`): grids up to
    # `pair_threshold` run the whole-cycle kernel K4 (<= 0: never), and
    # single-tile grids run `temporal_blocking` cycles per K5 launch (<= 1:
    # never). Both defaults were set on the TPU (ROADMAP A7).
    pair_threshold: int = 2048
    temporal_blocking: int = 8

    # f32 approximate-reciprocal divides in the CUDA kernels (one Newton
    # step for primary divides, raw for correction factors). f64 and the
    # CPU reference path always divide exactly.
    fast_math: bool = True

    # "torch" or "jnp": the op path (`core/step.py` `make_time_loop`);
    # anything else: the hand-written kernels (`make_time_loop_lean`).
    kernel_tier: str = "auto"

    # Domain decomposition: the shard grid (px, py); (1, 1) = one shard.
    # Every shard is padded to n_local = ceil(N/P) real cells; the hi-edge
    # shard along each axis owns the remainder n_edge, and the rest of its
    # block is dead slack (`armon_tpu/core/config.py:45-55`).
    proc_dims: Tuple[int, int] = (1, 1)
    n_edge: Optional[Tuple[int, int]] = None

    @property
    def op_path(self) -> bool:
        return self.kernel_tier in OP_PATH_TIERS

    @property
    def spmd(self) -> bool:
        return self.proc_dims != (1, 1)

    @property
    def edge_cells(self) -> Tuple[int, int]:
        """Real cells of the hi-edge shard along each axis."""
        return self.n_edge if self.n_edge is not None else self.n_local

    def uneven(self, axis) -> bool:
        """Whether the split along `axis` leaves slack on the edge shard."""
        return self.edge_cells[int(axis)] != self.n_local[int(axis)]

    @property
    def dx(self) -> float:
        """Cell size along X: domain_size/global_grid (src/solver_state.jl:341)."""
        return self.domain_size[0] / self.n_global[0]

    @property
    def dy(self) -> float:
        return self.domain_size[1] / self.n_global[1]

    def cell_size(self, axis) -> float:
        return (self.dx, self.dy)[int(axis)]

    @property
    def local_shape(self) -> Tuple[int, int]:
        """(rows, cols) of a padded block: (ny+2g, nx+2g)."""
        g = self.nghost
        return (self.n_local[1] + 2 * g, self.n_local[0] + 2 * g)

    @property
    def gamma(self) -> float:
        return self.test.specific_heat_ratio
