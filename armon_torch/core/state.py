"""Solver state (`armon_tpu/core/state.py`, `armon_tpu/core/step.py:109`).

Every field is a tensor of shape ``(ny + 2*nghost, nx + 2*nghost)``, indexed
``[j, i]`` with X contiguous, ghost cells included.
"""

from typing import NamedTuple

import numpy as np
import torch


class State(NamedTuple):
    x: torch.Tensor      # position of the cell's bottom-left corner
    y: torch.Tensor
    rho: torch.Tensor    # density
    u: torch.Tensor      # X velocity
    v: torch.Tensor      # Y velocity
    E: torch.Tensor      # total energy
    p: torch.Tensor      # pressure
    c: torch.Tensor      # sound speed
    g: torch.Tensor      # EOS fundamental derivative (unused by the scheme)
    ustar: torch.Tensor  # interface velocity
    pstar: torch.Tensor  # interface pressure


# The fields the reference's blocks hold besides ustar/pstar
# (`armon_tpu/core/state.py:39`).
MAIN_VARS = ("x", "y", "rho", "u", "v", "E", "p", "c", "g")

# The fields a ghost exchange fills on the op path (`armon_tpu/core/
# state.py:41`); the kernels' routes exchange rho/u/v/E only.
COMM_VARS = ("rho", "u", "v", "E", "p", "c", "g")

# The fields an output file holds, in its column order (`armon_tpu/core/
# state.py:41`, `src/blocking/blocks.jl:49`).
SAVED_VARS = ("x", "y", "rho", "u", "v", "p")


class FusedCarry(NamedTuple):
    """The five fields the per-sweep kernels read or write; x, y, c, g,
    ustar and pstar stay outside the time loop."""
    rho: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    E: torch.Tensor
    p: torch.Tensor


def torch_dtype(dtype) -> torch.dtype:
    """The tensor dtype of a run's numpy dtype (float64 or float32)."""
    return torch.float64 if np.dtype(dtype).itemsize == 8 else torch.float32
