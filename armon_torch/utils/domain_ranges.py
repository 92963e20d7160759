"""2D domain-range algebra (`armon_tpu/utils/domain_ranges.py`).

Rebuild of `src/domain_ranges.jl`: the reference iterates flattened arrays
through strided `DomainRange{col,row}` ranges and per-step corner offsets
(`StepsRanges`, `src/parameters.jl:984-1025`). Here the same information
is static 2D slices of the padded tensor.

A `DomainRange` is a pair of (start, stop) per axis in *cell* coordinates
relative to the real domain's bottom-left corner (0-based): the real domain
of an (nx, ny) block is ``DomainRange((0, nx), (0, ny))``; ghost extensions
go negative / beyond n.
"""

from dataclasses import dataclass
from typing import Tuple

from .enums import Axis


@dataclass(frozen=True)
class DomainRange:
    """Half-open index ranges along X and Y (`src/domain_ranges.jl:39-42`)."""
    x: Tuple[int, int]
    y: Tuple[int, int]

    @property
    def shape(self):
        return (self.y[1] - self.y[0], self.x[1] - self.x[0])

    @property
    def size(self):
        rows, cols = self.shape
        return max(rows, 0) * max(cols, 0)

    def expand(self, axis: Axis, lo: int, hi: int) -> "DomainRange":
        """Grow by `lo` cells on the first side and `hi` on the last side of
        `axis` (`src/domain_ranges.jl:63-79` expand/prepend ops)."""
        if axis is Axis.X:
            return DomainRange((self.x[0] - lo, self.x[1] + hi), self.y)
        return DomainRange(self.x, (self.y[0] - lo, self.y[1] + hi))

    def shift(self, axis: Axis, offset: int) -> "DomainRange":
        if axis is Axis.X:
            return DomainRange((self.x[0] + offset, self.x[1] + offset), self.y)
        return DomainRange(self.x, (self.y[0] + offset, self.y[1] + offset))

    def inflate(self, n: int) -> "DomainRange":
        """Grow by `n` on every side (`src/domain_ranges.jl:75-79`)."""
        return DomainRange((self.x[0] - n, self.x[1] + n),
                           (self.y[0] - n, self.y[1] + n))

    def intersect(self, other: "DomainRange") -> "DomainRange":
        return DomainRange(
            (max(self.x[0], other.x[0]), min(self.x[1], other.x[1])),
            (max(self.y[0], other.y[0]), min(self.y[1], other.y[1])))

    def array_slices(self, nghost: int):
        """(row_slice, col_slice) into the padded (ny+2g, nx+2g) array."""
        g = nghost
        return (slice(self.y[0] + g, self.y[1] + g),
                slice(self.x[0] + g, self.x[1] + g))


@dataclass(frozen=True)
class StepsRanges:
    """Per-solver-step iteration domains for one sweep axis
    (`src/parameters.jl:988-1025`): the extra cells each step must compute so
    no second BC pass is needed before the projection."""
    axis: Axis
    real_domain: DomainRange
    full_domain: DomainRange
    eos: DomainRange
    fluxes: DomainRange
    cell_update: DomainRange
    advection: DomainRange
    projection: DomainRange


def compute_steps_ranges(axis: Axis, n: Tuple[int, int], nghost: int,
                         projection: str) -> StepsRanges:
    """Exact rebuild of `compute_steps_ranges` (`src/parameters.jl:988-1025`)."""
    extra = {"euler": 1, "euler_2nd": 2}[projection]
    nx, ny = n
    real = DomainRange((0, nx), (0, ny))
    full = real.inflate(nghost)
    eos = real  # ghost values are overwritten by the BC right after
    fluxes = real.expand(axis, extra, extra + 1)
    cell_update = real.expand(axis, extra, extra)
    advection = real.expand(axis, 0, 1)
    projection_r = real
    return StepsRanges(axis, real, full, eos, fluxes, cell_update,
                       advection, projection_r)
