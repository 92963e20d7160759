"""Text I/O and numerical comparison (`armon_tpu/io/output.py`,
`src/io.jl`).

gnuplot-`pm3d` CSV output of the saved variables (x, y, rho, u, v, p), its
read-back, and the ulp-reporting comparison of compare mode
(`src/io.jl:111-227`). The golden files under `tests/reference_data/` use
this format (`test/reference_data/reference_functions.jl:37-51`).

The functions take a State whose fields are tensors on any device or
numpy arrays: the global padded grid, as `interop.gather_state` gives it.
Files are written and read by the native library (`io/native.py`);
`write_cells_plain` and `read_rows_plain` are the plain numpy versions
the tests hold it against.
"""

import numpy as np

from ..core.state import State, SAVED_VARS
from . import native


def host_array(a):
    """A numpy view or copy of a tensor or array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def precision_of(cfg):
    """Digits after the point: 17 in f64, 9 in f32."""
    return 17 if np.dtype(cfg.dtype).itemsize == 8 else 9


def saved_vars_arrays(cfg, state: State, with_ghosts=False):
    """Host numpy arrays of the saved vars, real cells only by default."""
    g = cfg.nghost
    out = {}
    for var in SAVED_VARS:
        a = host_array(getattr(state, var))
        if not with_ghosts:
            a = a[g:-g, g:-g]
        out[var] = a
    return out


def _fmt(precision):
    return ", ".join(["%%#%d.%de" % (precision + 7, precision)] * len(SAVED_VARS))


def write_cells_file(path, arrs: dict, precision, for_3d=True,
                     extra_header=None):
    """Write a dict of (rows, cols) saved-var arrays as a pm3d CSV
    (`src/io.jl:4-27` row format) through the native library."""
    native.write_cells(path, [arrs[v] for v in SAVED_VARS], precision,
                       for_3d=for_3d, header=extra_header)


def write_cells_plain(path, arrs: dict, precision, for_3d=True,
                      extra_header=None):
    """Plain version of `write_cells_file`: Python's formatting, which
    rounds as C printf does, so the bytes are the same."""
    fmt = _fmt(precision)
    rows, cols = arrs["x"].shape
    with open(path, "w") as f:
        if extra_header is not None:
            f.write(extra_header + "\n")
        for j in range(rows):
            if for_3d and j > 0:
                f.write("\n")
            for i in range(cols):
                f.write(fmt % tuple(arrs[v][j, i] for v in SAVED_VARS))
                f.write("\n")


def write_state_file(cfg, state: State, path, precision=None, with_ghosts=False,
                     for_3d=True, extra_header=None):
    """Write rows of `x, y, rho, u, v, p` with a blank line between Y rows
    (`src/io.jl:4-27`). `extra_header` (e.g. "dt, cycles") is written first
    when given (`reference_functions.jl:41`)."""
    if precision is None:
        precision = precision_of(cfg)
    write_cells_file(path, saved_vars_arrays(cfg, state, with_ghosts),
                     precision, for_3d=for_3d, extra_header=extra_header)


def _read_rows(path, dtype, expected_cells, skip_header=False):
    """(header or None, (cells, 6) values in `dtype`) through the native
    reader."""
    header = None
    if skip_header:
        with open(path) as f:
            header = f.readline().strip()
    flat = native.read_cells(path, expected_cells * len(SAVED_VARS),
                             skip_lines=1 if skip_header else 0)
    return header, flat.reshape(-1, len(SAVED_VARS)).astype(dtype)


def read_rows_plain(path, dtype, skip_header=False):
    """Plain version of `_read_rows`: every cell row, parsed by numpy."""
    header = None
    values = []
    with open(path) as f:
        lines = f.readlines()
    if skip_header:
        header = lines[0].strip()
    for line in lines[1 if skip_header else 0:]:
        line = line.strip()
        if line:
            values.append([np.dtype(dtype).type(tok) for tok in line.split(",")])
    return header, np.asarray(values, dtype=dtype).reshape(-1, len(SAVED_VARS))


def _expected_cells(cfg, with_ghosts):
    g = cfg.nghost
    nx, ny = cfg.n_global
    if with_ghosts:
        nx, ny = nx + 2 * g, ny + 2 * g
    return nx * ny


def read_state_file(cfg, path, with_ghosts=False):
    """Read a file written by `write_state_file` back into per-var arrays
    (`src/io.jl:30-43`)."""
    _, data = _read_rows(path, cfg.dtype, _expected_cells(cfg, with_ghosts))
    return _reshape_vars(cfg, data, with_ghosts)


def read_reference_csv(cfg, path):
    """Read a golden reference file: `dt, cycles` header then cell rows
    (`reference_functions.jl:46-51`). Returns (dt, cycles, {var: (ny, nx)})."""
    header, data = _read_rows(path, cfg.dtype, _expected_cells(cfg, False),
                              skip_header=True)
    dt_str, cycles_str = header.split(",")
    dt = np.dtype(cfg.dtype).type(dt_str)
    return dt, int(cycles_str), _reshape_vars(cfg, data, with_ghosts=False)


def _reshape_vars(cfg, data, with_ghosts):
    g = cfg.nghost
    nx, ny = cfg.n_global
    if with_ghosts:
        nx, ny = nx + 2 * g, ny + 2 * g
    if data.shape != (nx * ny, len(SAVED_VARS)):
        raise ValueError(f"expected {nx * ny} cells, got {data.shape[0]}")
    return {v: data[:, k].reshape(ny, nx) for k, v in enumerate(SAVED_VARS)}


def count_differences(cfg, ours: dict, ref: dict, atol, rtol):
    """(diff_count, max_rel_diff, {var: (count, max_rel)}) over the saved
    vars, the gate of the golden regression (`reference_functions.jl:
    69-121`): a cell differs when ``|ref - ours| > max(atol, rtol *
    max(|ref|, |ours|))`` (Julia isapprox; a NaN cell differs), and the
    max relative diff, ``|ref - ours| / max(|ref|, smallest subnormal)``,
    counts differing cells only. f64 pairs go through the native
    comparator, others through numpy, as in the JAX package: the two use
    the same formulas."""
    total = 0
    max_diff = 0.0
    details = {}
    for var in SAVED_VARS:
        a, b = ref[var], ours[var]
        if np.dtype(a.dtype).itemsize == 8 and a.dtype == b.dtype:
            cnt, m = native.count_differences(a, b, atol, rtol)
        else:
            err = np.abs(a - b)
            tol = np.maximum(atol, rtol * np.maximum(np.abs(a), np.abs(b)))
            mask = ~(err <= tol)
            cnt, m = int(mask.sum()), 0.0
            if cnt:
                denom = np.maximum(np.abs(a),
                                   np.finfo(a.dtype).smallest_subnormal)
                m = float((err[mask] / denom[mask]).max())
        if cnt:
            max_diff = max(max_diff, m)
            details[var] = (cnt, m)
        total += cnt
    return total, max_diff, details


def compare_states(cfg, state: State, ref: dict, atol, rtol, with_ghosts=False):
    ours = saved_vars_arrays(cfg, state, with_ghosts)
    return count_differences(cfg, ours, ref, atol, rtol)
