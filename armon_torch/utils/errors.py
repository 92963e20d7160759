"""Solver errors (`armon_tpu/utils/errors.py`, `src/utils.jl:89-113`)."""


class SolverException(Exception):
    """Exception raised by the solver. `category` is one of ``config``
    (invalid parameters), ``time`` (invalid time step), ``cpp`` (native
    kernel build or launch error)."""

    def __init__(self, category: str, msg: str):
        self.category = category
        super().__init__(f"[{category}] {msg}")


def solver_error(category: str, msg: str):
    raise SolverException(category, msg)
