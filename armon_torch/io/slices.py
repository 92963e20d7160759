"""1D slice output (`armon_tpu/io/slices.py`).

The reference declares `write_slices` (`src/parameters.jl:229,297`) and
calls `write_slices_files` (`src/solver.jl:508`) but never defines it. As
in the JAX package: the saved vars along the middle row, the middle column
and the main diagonal, one file per cut, in the full output's CSV format.
"""

import numpy as np

from ..core.state import SAVED_VARS
from .output import saved_vars_arrays, precision_of, _fmt


def write_slices_files(cfg, state, base_path, precision=None):
    """Write `<base_path>_X_slice`, `_Y_slice` and `_D_slice` from a
    gathered State; returns their paths."""
    if precision is None:
        precision = precision_of(cfg)
    arrs = saved_vars_arrays(cfg, state)
    ny, nx = arrs["x"].shape
    cuts = {
        "X": {v: arrs[v][ny // 2, :] for v in SAVED_VARS},
        "Y": {v: arrs[v][:, nx // 2] for v in SAVED_VARS},
        "D": {v: np.diagonal(arrs[v])[: min(nx, ny)] for v in SAVED_VARS},
    }
    fmt = _fmt(precision)
    paths = []
    for name, cut in cuts.items():
        path = f"{base_path}_{name}_slice"
        with open(path, "w") as f:
            for i in range(len(cut["x"])):
                f.write(fmt % tuple(cut[v][i] for v in SAVED_VARS))
                f.write("\n")
        paths.append(path)
    return paths
