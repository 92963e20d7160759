"""Moving state between numpy and the port.

Arrays come in as numpy (for example ``np.asarray`` of each field of a JAX
`FusedCarry` or `State`), so this package never imports JAX; they go out as
numpy the same way. Fields are converted to the run's dtype on
`params.device`.
"""

import numpy as np
import torch

from .core.state import State, FusedCarry


def _field(arrays, name, k):
    if isinstance(arrays, dict):
        return arrays[name]
    if hasattr(arrays, "_fields"):
        return getattr(arrays, name)
    return arrays[k]


def _tensor(params, a):
    a = np.array(a, dtype=params.data_type, order="C", copy=True)
    return torch.from_numpy(a).to(params.device)


def carry_from_numpy(params, arrays) -> FusedCarry:
    """A FusedCarry from rho/u/v/E/p given as a dict, a NamedTuple with
    those fields, or a sequence in that order."""
    return FusedCarry(*(_tensor(params, _field(arrays, n, k))
                        for k, n in enumerate(FusedCarry._fields)))


def state_from_numpy(params, arrays) -> State:
    """A State from its 11 fields, given like `carry_from_numpy`'s input."""
    return State(*(_tensor(params, _field(arrays, n, k))
                   for k, n in enumerate(State._fields)))


def to_numpy(x):
    """numpy copy of a tensor, or of every field of a State/FusedCarry
    (returned as the same NamedTuple type)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_fields"):
        return type(x)(*(to_numpy(a) for a in x))
    raise TypeError(f"to_numpy: unsupported {type(x).__name__}")
