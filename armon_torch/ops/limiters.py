"""Flux limiters of the op path (`armon_tpu/ops/limiters.py`,
`src/limiters.jl:2-15`), and the maximum they and the slopes take.

`torch.maximum` and `torch.minimum` propagate NaN as `jnp.maximum` and
`jnp.minimum` do, but on a tie of +0 with -0 they return either operand
(on the CPU the first in scalar code, the second in vector code), where
XLA's maximum is +0 and its minimum -0. Every such tie in the op path
meets a maximum whose first operand is +0 or more, so `maximum` maps a
-0 result to +0 and the minimum stays `torch.minimum`: the results agree
with the JAX ops bit for bit, signed zeros included.
"""

import torch

from ..utils.errors import solver_error


def maximum(a, b):
    """`jnp.maximum(a, b)` for an `a` of +0 or more: adding +0 leaves
    every value but -0, which becomes +0."""
    return torch.maximum(a, b) + 0.0


def no_limiter(r):
    return torch.ones_like(r)


def minmod(r):
    return maximum(torch.zeros_like(r), torch.minimum(torch.ones_like(r), r))


def superbee(r):
    return maximum(maximum(torch.zeros_like(r),
                           torch.minimum(2.0 * r, torch.ones_like(r))),
                   torch.minimum(r, torch.full_like(r, 2.0)))


_LIMITERS = {"no_limiter": no_limiter, "minmod": minmod, "superbee": superbee}


def limiter_from_name(name: str):
    try:
        return _LIMITERS[str(name)]
    except KeyError:
        solver_error("config", f"Unknown limiter name: '{name}'")
