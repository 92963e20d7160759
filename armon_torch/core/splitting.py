"""Dimensional (axis) splitting schedules (`armon_tpu/core/splitting.py`,
`src/axis_splitting.jl:22-46`). A schedule is a tuple of (axis, dt_factor)
sweeps; Godunov and Strang alternate the order with cycle parity."""

from ..utils.enums import Axis
from ..utils.errors import solver_error


def split_schedules(splitting: str):
    """Returns (even_cycle_schedule, odd_cycle_schedule)."""
    X, Y = Axis.X, Axis.Y
    if splitting == "Sequential":
        s = ((X, 1.0), (Y, 1.0))
        return s, s
    if splitting in ("Godunov", "SequentialSym"):
        return ((X, 1.0), (Y, 1.0)), ((Y, 1.0), (X, 1.0))
    if splitting == "Strang":
        return (((X, 0.5), (Y, 1.0), (X, 0.5)),
                ((Y, 0.5), (X, 1.0), (Y, 0.5)))
    if splitting == "X_only":
        s = ((X, 1.0),)
        return s, s
    if splitting == "Y_only":
        s = ((Y, 1.0),)
        return s, s
    solver_error("config", f"Unknown splitting method: '{splitting}'")
