"""Armon (PyTorch/CUDA): the 2D Lagrange-projection hydro solver on an
NVIDIA Hopper card.

The port of `armon_tpu` (the JAX/Pallas package, kept beside it as the
reference). Plain tensor code is PyTorch; the kernels (per-sweep,
whole-cycle and K-cycles) are hand-written CUDA (`armon_torch/csrc/`),
built with nvcc on first use.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version. The
command line is ``python -m armon_torch key=value ...``.

This package imports neither `jax` nor `armon_tpu`.
"""

from .params import ArmonParameters, data_type, memory_required
from .core.solver import armon, SolverStats, device_to_host, host_to_device
from .interop import gather_state
from .core.state import State, FusedCarry, MAIN_VARS, SAVED_VARS, COMM_VARS
from .core.config import SolverConfig
from .utils.errors import SolverException
from .utils.enums import Axis, Side
from .models.cases import (
    TestCase, Sod, SodY, SodCirc, Bizarrium, Sedov, DebugIndexes, test_from_name,
)

__version__ = "0.1.0"

__all__ = [
    "ArmonParameters", "armon", "SolverStats", "data_type", "memory_required",
    "device_to_host", "host_to_device", "gather_state",
    "State", "FusedCarry", "MAIN_VARS", "SAVED_VARS", "COMM_VARS",
    "SolverConfig",
    "SolverException", "Axis", "Side",
    "TestCase", "Sod", "SodY", "SodCirc", "Bizarrium", "Sedov",
    "DebugIndexes", "test_from_name",
]
