"""Shifted reads for the op path's stencils (`armon_tpu/ops/shifts.py`).

``sh(a, k, axis)`` returns a tensor where ``out[i] = a[i + k]`` along the
physical axis: `torch.roll`, a wrap-around like `jnp.roll`, with X the last
(contiguous) dimension. The wrapped values land only in the outermost ghost
ring of the padded arrays; the nghost floor (the stencil sum,
`params.py`) keeps every read that a real cell's result depends on in
bounds, so the wrap-around never reaches a real cell.
"""

import torch


def sh(a, k: int, axis):
    if k == 0:
        return a
    return torch.roll(a, -k, axis.array_axis)
