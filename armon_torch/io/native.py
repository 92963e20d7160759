"""ctypes bridge to the native I/O library (`armon_torch/native/armon_io.cc`,
the counterpart of `armon_tpu/io/native.py`).

The library is built with the host C++ compiler on first use
(`ops/_build.load_io`). A failed build raises with the compiler's message:
nothing falls back to the numpy writer, which stays in `io/output.py` as
the plain version the tests hold this one against, byte for byte.
"""

import ctypes

import numpy as np


def _lib():
    from ..ops._build import load_io
    return load_io()


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_cells(path, arrays, precision, for_3d=True, header=None):
    """Write row-major (rows, cols) arrays as the pm3d CSV (C printf
    ``%#w.pe``, the reference's format)."""
    lib = _lib()
    arrs = [np.ascontiguousarray(a, dtype=np.float64) for a in arrays]
    rows, cols = arrs[0].shape
    if any(a.shape != (rows, cols) for a in arrs[1:]):
        raise ValueError("write_cells: mismatched variable shapes "
                         f"{[a.shape for a in arrs]}")
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
    rc = lib.armon_write_cells(
        str(path).encode(), ptrs, len(arrs), rows, cols, int(precision),
        1 if for_3d else 0, (header or "").encode())
    if rc != 0:
        raise IOError(f"native write failed ({rc}) for {path}")


def read_cells(path, expected_vals, skip_lines=0):
    """Up to `expected_vals` doubles of a pm3d CSV, after `skip_lines`
    header lines, as a float64 array."""
    lib = _lib()
    out = np.empty(expected_vals, np.float64)
    n = lib.armon_read_cells(str(path).encode(), _dptr(out), expected_vals,
                             skip_lines)
    if n < 0:
        raise IOError(f"native read failed ({n}) for {path}")
    return out[:n]


def read_window(path, nvars, gnx, row0, col0, hy, wx, skip_lines=0):
    """Stream a global-domain CSV and return only the (hy*wx, nvars)
    cell-major window, as (array, cells filled): an underfill (a truncated
    file, a layout mismatch) is for the caller to report with its own
    context. Raises on a short line."""
    lib = _lib()
    out = np.empty((hy * wx, nvars), np.float64)
    n = lib.armon_read_window(str(path).encode(), _dptr(out), nvars, gnx,
                              row0, col0, hy, wx, skip_lines)
    if n < 0:
        raise IOError(f"native window read failed ({n}) for {path}")
    return out, int(n)


def count_differences(ref, ours, atol, rtol):
    """(count, max_rel) with Julia isapprox semantics over float64 arrays
    of one shape."""
    lib = _lib()
    if np.shape(ref) != np.shape(ours):
        # The C loop reads ours[i] for i < ref.size.
        raise ValueError(f"count_differences: shape mismatch "
                         f"{np.shape(ref)} vs {np.shape(ours)}")
    a = np.ascontiguousarray(ref, np.float64).ravel()
    b = np.ascontiguousarray(ours, np.float64).ravel()
    mr = ctypes.c_double(0.0)
    cnt = lib.armon_count_differences(_dptr(a), _dptr(b), a.size, float(atol),
                                      float(rtol), ctypes.byref(mr))
    return int(cnt), float(mr.value)
