"""Axes and sides of the 2D domain (`armon_tpu/utils/enums.py`).

State arrays have shape ``(ny_tot, nx_tot)`` with X contiguous in the last
dimension, so ``Axis.X`` maps to tensor dim 1 and ``Axis.Y`` to dim 0.
"""

import enum


class Axis(enum.IntEnum):
    X = 0
    Y = 1

    @property
    def array_axis(self) -> int:
        """The tensor dimension this physical axis corresponds to."""
        return 1 if self is Axis.X else 0


class Side(enum.IntEnum):
    # Order of the Julia reference (`src/utils.jl:25`): Left, Right, Bottom, Top.
    LEFT = 0
    RIGHT = 1
    BOTTOM = 2
    TOP = 3


def axis_of(side: Side) -> Axis:
    """The axis a side lies along (`src/utils.jl:33-38`)."""
    return Axis.X if side in (Side.LEFT, Side.RIGHT) else Axis.Y


def is_first_side(side: Side) -> bool:
    """True for Left/Bottom, the lower coordinate (`src/utils.jl:54-59`)."""
    return side in (Side.LEFT, Side.BOTTOM)


def sides_along(axis: Axis):
    """Both sides of `axis`, first side first (`src/utils.jl:40-45`)."""
    return (Side.LEFT, Side.RIGHT) if axis is Axis.X else (Side.BOTTOM, Side.TOP)
