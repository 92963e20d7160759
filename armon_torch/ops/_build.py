"""Build and bind the CUDA kernels of `armon_torch/csrc/`.

Each source compiles with nvcc for `sm_90a` into a shared library with a
plain C interface, loaded with ctypes: the per-sweep kernels K1/K2
(`sweep_f*.cu`), K3 (`cfl.cu`), the whole-cycle kernel K4 (`cycle_f*.cu`)
and the K-cycles kernel K5 (`multicycle_f*.cu`, a cooperative launch),
and the probes' kernels (`armon_torch/probes/`): the mirror fill, copy
and I/O ladder (`probe_stream.cu`), the sweep chain in f32, f64 and
float-float (`probe_ff.cu`, `chain.cuh`), the per-class rate chains
(`probe_rates.cu`) and K4's measurement variants (`probe_cycle.cu`).
The sources are compiled in
parallel (one nvcc each) on first use, into ``build/armon_torch/`` at the
root of the checkout, under a name that hashes the sources and flags, so
a changed source rebuilds and an unchanged one loads. A failed build or
launch raises `SolverException`; nothing falls back to another path.

`-fmad=false` keeps every multiply and add separately rounded, which is
what makes exact mode bit-comparable with the plain PyTorch versions.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ..utils.enums import Axis
from ..utils.errors import solver_error
from ..models.cases import Bizarrium
from .sweep import ghost_mode

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "armon_torch")
SOURCES = ("sweep_f32.cu", "sweep_f64.cu", "cfl.cu", "cycle_f32.cu",
           "cycle_f64.cu", "multicycle_f32.cu", "multicycle_f64.cu",
           "probe_stream.cu", "probe_ff.cu", "probe_rates.cu",
           "probe_cycle.cu")
HEADERS = ("common.cuh", "sweep.cuh", "cycle.cuh", "chain.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

# Filled by `load()`: build seconds (0 when every library was cached) and
# the compiler's output per source (ptxas registers / spills).
BUILD_INFO = {"seconds": None, "logs": {}}

_LOCK = threading.Lock()
_LIBS = None

# Must match `armon::EosConst` in csrc/sweep.cuh.
EOS_KEYS = ("GM", "GM1", "RHO0", "S", "SK", "Q", "R", "2Q", "3R", "6R",
            "2S", "G0", "EPS0", "CV0T0", "C05K0R", "PK0C", "C05K0",
            "CM05K0", "G0RHO0", "INVRHO0", "E1C", "E2C", "E3C", "PPC")


class SweepArgs(ctypes.Structure):
    """Mirror of `armon::SweepArgs` (csrc/sweep.cuh)."""
    _fields_ = [
        ("src", ctypes.c_void_p * 4), ("dst", ctypes.c_void_p * 4),
        ("p", ctypes.c_void_p), ("partials", ctypes.c_void_p),
        ("scal", ctypes.c_void_p), ("iscal", ctypes.c_void_p),
        ("slab_lo", ctypes.c_void_p), ("slab_hi", ctypes.c_void_p),
        ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
        ("n_partials", ctypes.c_longlong),
        ("grid_x", ctypes.c_int), ("grid_y", ctypes.c_int),
        ("g", ctypes.c_int), ("nx", ctypes.c_int), ("ny", ctypes.c_int),
        ("riemann", ctypes.c_int), ("limiter", ctypes.c_int),
        ("projection", ctypes.c_int),
        ("mode_lo", ctypes.c_int), ("mode_hi", ctypes.c_int),
        ("emit", ctypes.c_int), ("fast", ctypes.c_int), ("biz", ctypes.c_int),
        ("dt_factor", ctypes.c_double), ("dx", ctypes.c_double),
        ("inv_dx", ctypes.c_double),
        ("f_lo", ctypes.c_double * 4), ("f_hi", ctypes.c_double * 4),
        ("k", ctypes.c_double * len(EOS_KEYS)),
    ]


class DtParams(ctypes.Structure):
    """Mirror of `armon::DtParams` (csrc/common.cuh)."""
    _fields_ = [
        ("cst_dt", ctypes.c_int), ("dt_on_even_cycles", ctypes.c_int),
        ("maxcycle", ctypes.c_int),
        ("cfl", ctypes.c_double), ("maxtime", ctypes.c_double),
        ("Dt", ctypes.c_double), ("cap", ctypes.c_double),
    ]


class CflArgs(ctypes.Structure):
    """Mirror of `armon::CflArgs` (csrc/cfl.cu)."""
    _fields_ = [
        ("partials", ctypes.c_void_p), ("scal", ctypes.c_void_p),
        ("iscal", ctypes.c_void_p),
        ("n_partials", ctypes.c_longlong), ("nblocks", ctypes.c_longlong),
        ("fold", ctypes.c_int), ("step", ctypes.c_int),
        ("dt", DtParams),
        ("dx", ctypes.c_double), ("dy", ctypes.c_double),
    ]


class CycleArgs(ctypes.Structure):
    """Mirror of `armon::CycleArgs` (csrc/cycle.cuh)."""
    _fields_ = [
        ("src", ctypes.c_void_p * 4), ("dst", ctypes.c_void_p * 4),
        ("p", ctypes.c_void_p), ("partials", ctypes.c_void_p),
        ("scal", ctypes.c_void_p), ("iscal", ctypes.c_void_p),
        ("slab_lo", ctypes.c_void_p), ("slab_hi", ctypes.c_void_p),
        ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
        ("n_partials", ctypes.c_longlong),
        ("grid_x", ctypes.c_int), ("grid_y", ctypes.c_int),
        ("g", ctypes.c_int), ("nx", ctypes.c_int), ("ny", ctypes.c_int),
        ("ymode_lo", ctypes.c_int), ("ymode_hi", ctypes.c_int),
        ("riemann", ctypes.c_int), ("limiter", ctypes.c_int),
        ("projection", ctypes.c_int), ("emit", ctypes.c_int),
        ("fast", ctypes.c_int), ("biz", ctypes.c_int),
        ("x_first", ctypes.c_int),
        ("fx", ctypes.c_double), ("fy", ctypes.c_double),
        ("dx", ctypes.c_double), ("dy", ctypes.c_double),
        ("inv_dx", ctypes.c_double), ("inv_dy", ctypes.c_double),
        ("fx_lo", ctypes.c_double * 4), ("fx_hi", ctypes.c_double * 4),
        ("fy_lo", ctypes.c_double * 4), ("fy_hi", ctypes.c_double * 4),
        ("k", ctypes.c_double * len(EOS_KEYS)),
    ]


class MultiArgs(ctypes.Structure):
    """Mirror of `armon::MultiArgs` (csrc/cycle.cuh)."""
    _fields_ = [
        ("c", CycleArgs), ("ncycles", ctypes.c_int),
        ("x_first", ctypes.c_int * 2),
        ("fx", ctypes.c_double * 2), ("fy", ctypes.c_double * 2),
        ("dt", DtParams),
    ]


class ChainArgs(ctypes.Structure):
    """Mirror of `armon::probe::ChainArgs` (csrc/probe_ff.cu)."""
    _fields_ = [("src", ctypes.c_void_p * 8), ("dst", ctypes.c_void_p * 8),
                ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong)]


class IoArgs(ctypes.Structure):
    """Mirror of `armon::probe::IoArgs` (csrc/probe_stream.cu)."""
    _fields_ = [("f", ctypes.c_void_p * 4), ("p", ctypes.c_void_p),
                ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong)]


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            path = cand if os.path.exists(cand) else None
    if path is None:
        solver_error("cpp", "nvcc not found: the CUDA kernels are built from "
                            "armon_torch/csrc on first use and need the CUDA "
                            "toolkit")
    return path


def _lib_path(src):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + (src,):
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def load():
    """Build (if needed) and load every kernel library. Returns a dict of
    ctypes libraries keyed by source stem."""
    global _LIBS
    with _LOCK:
        if _LIBS is not None:
            return _LIBS
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        jobs = {}
        for src in SOURCES:
            out = _lib_path(src)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, src)]
            jobs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
        failed = []
        for src, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            BUILD_INFO["logs"][src] = log
            if proc.returncode != 0:
                failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log[-4000:]}")
            else:
                os.replace(tmp, out)
        if failed:
            solver_error("cpp", "kernel build failed: " + "\n".join(failed))
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        libs = {}
        for src in SOURCES:
            libs[os.path.splitext(src)[0]] = ctypes.CDLL(_lib_path(src))
        for bits in (32, 64):
            fn = getattr(libs[f"sweep_f{bits}"], f"armon_sweep_f{bits}")
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(SweepArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = libs["cfl"].armon_cfl_finish
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(CflArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for bits in (32, 64):
            for stem, args in (("cycle", CycleArgs), ("multicycle", MultiArgs)):
                fn = getattr(libs[f"{stem}_f{bits}"], f"armon_{stem}_f{bits}")
                fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
                fn.restype = ctypes.c_int
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for stem, name, args in (
                ("probe_stream", "armon_flip", [ci, vp, vp, ll, ll, ci, vp]),
                ("probe_stream", "armon_io_ladder",
                 [ci, ctypes.POINTER(IoArgs), vp]),
                ("probe_ff", "armon_chain", [ci, ctypes.POINTER(ChainArgs), vp]),
                ("probe_rates", "armon_rate", [ci, vp, vp, ll, ci, vp]),
                ("probe_cycle", "armon_cycle_variant_f32",
                 [ci, ci, ctypes.POINTER(CycleArgs), vp])):
            fn = getattr(libs[stem], name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        libs["cfl"].armon_error_string.argtypes = [ctypes.c_int]
        libs["cfl"].armon_error_string.restype = ctypes.c_char_p
        _LIBS = libs
        return libs


def eos_constants(cfg):
    """The EOS constants of `_eos_prc`, computed with the same numpy
    expressions in dtype T (`ops/pallas/sweep.py:145-251`), once per dtype
    and gamma: every launch passes them, and computing them costs more
    host time than the rest of a launch's arguments."""
    return _eos_constants(np.dtype(cfg.dtype), float(cfg.gamma))


@functools.lru_cache(maxsize=None)
def _eos_constants(dtype, gamma):
    T = dtype.type
    gm = T(gamma)
    rho0 = T(10000.0); K0 = T(1e11); Cv0 = T(1000.0); T0 = T(300.0)
    eps0 = T(0.0); G0 = T(1.5); s = T(1.5)
    q = T(-42080895.0 / 14941154.0); r = T(727668333.0 / 149411540.0)
    vals = {
        "GM": gm, "GM1": gm - T(1.0),
        "RHO0": rho0, "S": s, "SK": s / 3 - 2, "Q": q, "R": r,
        "2Q": 2 * q, "3R": 3 * r, "6R": 6 * r, "2S": 2 * s, "G0": G0,
        "EPS0": eps0, "CV0T0": Cv0 * T0, "C05K0R": 0.5 * (K0 / rho0),
        "PK0C": -Cv0 * T0 * G0 * rho0, "C05K0": 0.5 * K0,
        "CM05K0": -0.5 * K0, "G0RHO0": G0 * rho0,
        "INVRHO0": T(1.0 / 10000.0),
        "E1C": eps0 - Cv0 * T0 * (1 + G0), "E2C": Cv0 * T0 * G0 * rho0,
        "E3C": T(0.5) * K0 / rho0, "PPC": -T(0.5) * K0 * rho0,
    }
    return tuple(float(T(vals[key])) for key in EOS_KEYS)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _require(t, dtype, device, numel, what):
    """Validate a tensor whose pointer goes to a kernel."""
    if (t.dtype != dtype or t.device != device or not t.is_contiguous()
            or t.numel() < numel):
        solver_error("config", f"{what} must be a contiguous {dtype} tensor "
                               f"of >= {numel} elements on {device}; got "
                               f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _partials_stride(partials, dtype, device, nblocks):
    """Validate a (2, n) CFL partials operand, possibly a column slice of a
    wider buffer (every shard of a mesh writes its own slice), with room
    for `nblocks`; returns its row stride."""
    if (partials.dtype != dtype or partials.device != device
            or partials.dim() != 2 or partials.shape[0] != 2
            or partials.stride(1) != 1 or partials.shape[1] < nblocks):
        solver_error("config", f"CFL partials must be a (2, >= {nblocks}) "
                               f"{dtype} tensor on {device} with unit column "
                               f"stride; got {partials.dtype} "
                               f"{tuple(partials.shape)} stride "
                               f"{partials.stride()} on {partials.device}")
    return partials.stride(0)


def _ghost_args(ghosts):
    """(modes, pointers) of the (lo, hi) ghost sources of a launch."""
    modes = [ghost_mode(s) for s in ghosts]
    ptrs = [_ptr(s) if m == 2 else None for s, m in zip(ghosts, modes)]
    return modes, ptrs


def _launch(fn, device, *args):
    """Call a library's launcher with the current stream of `device`. A
    launch on another card than the current one (a mesh may place shards
    on several) makes that card current for the call."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def _check_status(rc, what):
    if rc != 0:
        msg = load()["cfl"].armon_error_string(rc).decode()
        solver_error("cpp", f"{what} launch failed: code {rc} ({msg})")


def _set_common(a, cfg, src, dst, scal, iscal, grid, n_real):
    """The fields `SweepArgs` and `CycleArgs` share: operands, geometry
    (`n_real`: the shard's real cells), scheme switches and EOS
    constants."""
    from .sweep import fast_math_on
    dev = src[0].device
    _require(scal, src[0].dtype, dev, 4, "scal")
    _require(iscal, torch.int32, dev, 4, "iscal")
    a.src[:] = [_ptr(t) for t in src]
    a.dst[:] = [_ptr(t) for t in dst]
    a.scal, a.iscal = _ptr(scal), _ptr(iscal)
    a.rows, a.cols = src[0].shape
    a.grid_x, a.grid_y = grid
    a.g, a.nx, a.ny = cfg.nghost, n_real[0], n_real[1]
    a.riemann = 1 if cfg.riemann == "GAD" else 0
    a.limiter = ("no_limiter", "minmod", "superbee").index(cfg.limiter)
    a.projection = 1 if cfg.projection == "euler_2nd" else 0
    a.fast = int(fast_math_on(cfg, dev))
    a.biz = int(isinstance(cfg.test, Bizarrium))
    a.k[:] = eos_constants(cfg)


def launch_sweep(cfg, axis, src, dst, p, partials, scal, iscal, factor,
                 emit, ghosts, n_real):
    """Launch K1 (axis X) or K2 (axis Y) on the current stream."""
    from .sweep import grid_dims, mirror_factors
    libs = load()
    T = np.dtype(cfg.dtype).type
    gx, gy = grid_dims(axis, src[0].shape)
    dev = src[0].device
    f_lo, f_hi = mirror_factors(cfg, axis)
    dx = T(cfg.cell_size(axis))
    a = SweepArgs()
    _set_common(a, cfg, src, dst, scal, iscal, (gx, gy), n_real)
    a.p = _ptr(p) if emit else None
    a.partials = _ptr(partials) if emit else None
    a.n_partials = _partials_stride(partials, src[0].dtype, dev, gx * gy) \
        if emit else 0
    (a.mode_lo, a.mode_hi), (a.slab_lo, a.slab_hi) = _ghost_args(ghosts)
    a.emit = int(emit)
    a.dt_factor = float(T(factor))
    a.dx = float(dx)
    a.inv_dx = float(T(1.0) / dx)
    a.f_lo[:] = list(f_lo)
    a.f_hi[:] = list(f_hi)
    bits = 8 * np.dtype(cfg.dtype).itemsize
    fn = getattr(libs[f"sweep_f{bits}"], f"armon_sweep_f{bits}")
    rc = _launch(fn, dev, 0 if axis is Axis.X else 1, ctypes.byref(a))
    _check_status(rc, "x_sweep" if axis is Axis.X else "y_sweep")


def _dt_params(cfg):
    """The dt recurrence's scalars, rounded to T (`DtParams`)."""
    T = np.dtype(cfg.dtype).type
    d = DtParams()
    d.cst_dt, d.dt_on_even_cycles = int(cfg.cst_dt), int(cfg.dt_on_even_cycles)
    d.maxcycle = int(cfg.maxcycle)
    d.cfl, d.maxtime = float(T(cfg.cfl)), float(T(cfg.maxtime))
    d.Dt, d.cap = float(T(cfg.Dt)), float(T(1.05))
    return d


def launch_cfl_finish(cfg, partials, nblocks, scal, iscal, fold, step):
    """Launch K3 on the current stream."""
    libs = load()
    T = np.dtype(cfg.dtype).type
    _require(scal, partials.dtype, partials.device, 4, "scal")
    _require(iscal, torch.int32, partials.device, 4, "iscal")
    _require(partials, partials.dtype, partials.device, 2 * nblocks, "CFL partials")
    if partials.dim() != 2 or partials.shape[0] != 2:
        solver_error("config", "CFL partials must have shape (2, n)")
    a = CflArgs()
    a.partials, a.scal, a.iscal = _ptr(partials), _ptr(scal), _ptr(iscal)
    a.n_partials = partials.shape[1]
    a.nblocks = nblocks
    a.fold, a.step = int(fold), int(step)
    a.dt = _dt_params(cfg)
    a.dx, a.dy = float(T(cfg.dx)), float(T(cfg.dy))
    rc = _launch(libs["cfl"].armon_cfl_finish, scal.device,
                 8 * np.dtype(cfg.dtype).itemsize, ctypes.byref(a))
    _check_status(rc, "cfl_finish")


def _cycle_args(cfg, tile, src, dst, p, partials, scal, iscal, n_partials,
                y_ghosts=None, n_real=None):
    """`CycleArgs` of a K4 or K5 launch over tiles of edge `tile`;
    `n_partials` is the partials' row stride (already validated), 0 when
    nothing is emitted; the Y ghosts mirror unless `y_ghosts` says
    otherwise."""
    from .cycle import tile_grid
    from .sweep import mirror_factors, MIRRORED
    T = np.dtype(cfg.dtype).type
    gx, gy = tile_grid(tile, src[0].shape)
    a = CycleArgs()
    _set_common(a, cfg, src, dst, scal, iscal, (gx, gy), n_real or cfg.n_local)
    a.p = _ptr(p)
    a.partials = _ptr(partials) if n_partials else None
    a.n_partials = n_partials
    (a.ymode_lo, a.ymode_hi), (a.slab_lo, a.slab_hi) = \
        _ghost_args(y_ghosts or MIRRORED)
    dx, dy = T(cfg.dx), T(cfg.dy)
    a.dx, a.dy = float(dx), float(dy)
    a.inv_dx, a.inv_dy = float(T(1.0) / dx), float(T(1.0) / dy)
    f_lo, f_hi = mirror_factors(cfg, Axis.X)
    a.fx_lo[:], a.fx_hi[:] = list(f_lo), list(f_hi)
    f_lo, f_hi = mirror_factors(cfg, Axis.Y)
    a.fy_lo[:], a.fy_hi[:] = list(f_lo), list(f_hi)
    return a


def launch_cycle(cfg, x_first, fx, fy, src, dst, p, partials, scal, iscal,
                 emit, y_ghosts, n_real):
    """Launch K4 on the current stream."""
    from .cycle import CYCLE_TILE, tile_grid
    libs = load()
    T = np.dtype(cfg.dtype).type
    gx, gy = tile_grid(CYCLE_TILE, src[0].shape)
    stride = _partials_stride(partials, src[0].dtype, src[0].device,
                              gx * gy) if emit else 0
    a = _cycle_args(cfg, CYCLE_TILE, src, dst, p, partials, scal, iscal,
                    stride, y_ghosts, n_real)
    a.emit, a.x_first = int(emit), int(x_first)
    a.fx, a.fy = float(T(fx)), float(T(fy))
    bits = 8 * np.dtype(cfg.dtype).itemsize
    fn = getattr(libs[f"cycle_f{bits}"], f"armon_cycle_f{bits}")
    rc = _launch(fn, src[0].device, ctypes.byref(a))
    _check_status(rc, "cycle")


def launch_multicycle(cfg, parity_pairs, ncycles, src, dst, p, partials,
                      scal, iscal):
    """Launch K5 on the current stream (a cooperative launch)."""
    from .cycle import MULTI_TILE, tile_grid
    libs = load()
    T = np.dtype(cfg.dtype).type
    if partials.dim() != 3 or partials.shape[:2] != (2, 2):
        solver_error("config", "K5's CFL partials must have shape (2, 2, n)")
    gx, gy = tile_grid(MULTI_TILE, src[0].shape)
    _require(partials, src[0].dtype, src[0].device, 4 * gx * gy,
             "CFL partials")
    m = MultiArgs()
    m.c = _cycle_args(cfg, MULTI_TILE, src, dst, p, partials, scal, iscal,
                      partials.shape[2])
    m.ncycles = int(ncycles)
    m.x_first[:] = [int(xf) for xf, _, _ in parity_pairs]
    m.fx[:] = [float(T(fx)) for _, fx, _ in parity_pairs]
    m.fy[:] = [float(T(fy)) for _, _, fy in parity_pairs]
    m.dt = _dt_params(cfg)
    bits = 8 * np.dtype(cfg.dtype).itemsize
    fn = getattr(libs[f"multicycle_f{bits}"], f"armon_multicycle_f{bits}")
    rc = _launch(fn, src[0].device, ctypes.byref(m))
    _check_status(rc, "multicycle")


def launch_probe(stem, name, device, *args):
    """Launch a probe kernel of library `stem` (function `name`) on the
    current stream of `device`; raises if the launcher refuses it."""
    rc = _launch(getattr(load()[stem], name), device, *args)
    _check_status(rc, name)


def launch_cycle_variant(cfg, variant, tile, x_first, fx, fy, src, dst, p,
                         partials, scal, iscal):
    """Launch one of K4's measurement variants (csrc/probe_cycle.cu), an
    emitting launch over tiles of edge `tile`, on the current stream."""
    from .cycle import tile_grid
    T = np.dtype(cfg.dtype).type
    gx, gy = tile_grid(tile, src[0].shape)
    stride = _partials_stride(partials, src[0].dtype, src[0].device, gx * gy)
    a = _cycle_args(cfg, tile, src, dst, p, partials, scal, iscal, stride)
    a.emit, a.x_first = 1, int(x_first)
    a.fx, a.fy = float(T(fx)), float(T(fy))
    launch_probe("probe_cycle", "armon_cycle_variant_f32", src[0].device,
                 int(variant), int(tile), ctypes.byref(a))
