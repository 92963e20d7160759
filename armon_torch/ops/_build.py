"""Build and bind the CUDA kernels of `armon_torch/csrc/`.

Each source compiles with nvcc for `sm_90a` into a shared library with a
plain C interface, loaded with ctypes: the per-sweep kernels K1/K2
(`sweep_f*.cu`), K3 (`cfl.cu`), the whole-cycle kernel K4 (`cycle_f*.cu`)
and the K-cycles kernel K5 (`multicycle_f*.cu`, a cooperative launch),
and the probes' kernels (`armon_torch/probes/`): the mirror fill, copy
and I/O ladder (`probe_stream.cu`), the sweep chain in f32, f64 and
float-float (`probe_ff.cu`, `chain.cuh`), the per-class rate chains
(`probe_rates.cu`), K4's measurement variants (`probe_cycle.cu`) and K5
as one thread-block cluster (`probe_cluster.cu`, `cluster.cuh`),
the whole-run graph's WHILE node and its measurement body (`graph.cu`),
and K6, the f32 conservation sums (`reduce.cu`).
The sources are compiled in
parallel (one nvcc each) on first use, into ``build/armon_torch/`` at the
root of the checkout, under a name that hashes the sources and flags, so
a changed source rebuilds and an unchanged one loads. A failed build or
launch raises `SolverException`; nothing falls back to another path.

`-fmad=false` keeps every multiply and add separately rounded, except
the explicit fused multiply-adds (`fmadd`, `csrc/common.cuh`) at the sites
where the plain PyTorch versions contract (`ops/fma.py`): that is what
makes exact mode bit-comparable with them.

The native host libraries (`armon_torch/native/`: `armon_io.cc`, the I/O;
`armon_fma.cc`, the CPU tensors' fused multiply-add; no kernel) are built
the same way by the host C++ compiler (`load_io`, `load_fma`), on first
use, into the same directory.
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
           "probe_cycle.cu", "probe_cluster.cu", "graph.cu", "reduce.cu")
HEADERS = ("common.cuh", "sweep.cuh", "cycle.cuh", "cluster.cuh", "chain.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

IO_SOURCE = os.path.join(_PKG, "native", "armon_io.cc")
FMA_SOURCE = os.path.join(_PKG, "native", "armon_fma.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall")

# Filled by `load()`: build seconds (0 when every library was cached) and
# the compiler's output per source (ptxas registers / spills).
BUILD_INFO = {"seconds": None, "logs": {}}

_LOCK = threading.Lock()
_LIBS = None
_IO_LIB = None
_FMA_LIB = None

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
        ("fold_in", ctypes.c_int), ("x_out", ctypes.c_int),
        ("fold_rdx", ctypes.c_double), ("fold_k", ctypes.c_double),
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


class FinishArgs(ctypes.Structure):
    """Mirror of `armon::FinishArgs` (csrc/common.cuh)."""
    _fields_ = [
        ("partials", ctypes.c_void_p), ("scal", ctypes.c_void_p),
        ("iscal", ctypes.c_void_p), ("ticket", ctypes.c_void_p),
        ("stride", ctypes.c_longlong), ("n", ctypes.c_longlong),
        ("dt", DtParams),
        ("dx", ctypes.c_double), ("dy", ctypes.c_double),
        ("cond", ctypes.c_ulonglong), ("count", ctypes.c_void_p),
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
        ("x_out", ctypes.c_int),
        ("kf_x", ctypes.c_double), ("kf_y", ctypes.c_double),
    ]


class MultiArgs(ctypes.Structure):
    """Mirror of `armon::MultiArgs` (csrc/cycle.cuh)."""
    _fields_ = [
        ("c", CycleArgs), ("ncycles", ctypes.c_int),
        ("x_first", ctypes.c_int * 2),
        ("fx", ctypes.c_double * 2), ("fy", ctypes.c_double * 2),
        ("dt", DtParams), ("bar", ctypes.c_void_p),
        ("cond", ctypes.c_ulonglong), ("count", ctypes.c_void_p),
    ]


class McArgs(ctypes.Structure):
    """Mirror of `armon::McArgs` (csrc/cluster.cuh)."""
    _fields_ = [
        ("src", ctypes.c_void_p * 4), ("dst", ctypes.c_void_p * 4),
        ("p", ctypes.c_void_p), ("scal", ctypes.c_void_p),
        ("iscal", ctypes.c_void_p),
        ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
        ("g", ctypes.c_int), ("nx", ctypes.c_int), ("ny", ctypes.c_int),
        ("riemann", ctypes.c_int), ("limiter", ctypes.c_int),
        ("projection", ctypes.c_int), ("fast", ctypes.c_int),
        ("biz", ctypes.c_int), ("ncycles", ctypes.c_int),
        ("x_first", ctypes.c_int * 2),
        ("band_r", ctypes.c_int), ("band_c", ctypes.c_int),
        ("pitch_r", ctypes.c_int), ("pitch_c", ctypes.c_int),
        ("plane", ctypes.c_int), ("smem", ctypes.c_longlong),
        ("fx", ctypes.c_double * 2), ("fy", ctypes.c_double * 2),
        ("dx", ctypes.c_double), ("dy", ctypes.c_double),
        ("inv_dx", ctypes.c_double), ("inv_dy", ctypes.c_double),
        ("fx_lo", ctypes.c_double * 4), ("fx_hi", ctypes.c_double * 4),
        ("fy_lo", ctypes.c_double * 4), ("fy_hi", ctypes.c_double * 4),
        ("k", ctypes.c_double * len(EOS_KEYS)),
        ("kf_x", ctypes.c_double), ("kf_y", ctypes.c_double),
        ("dt", DtParams),
    ]


class ChainArgs(ctypes.Structure):
    """Mirror of `armon::probe::ChainArgs` (csrc/probe_ff.cu)."""
    _fields_ = [("src", ctypes.c_void_p * 8), ("dst", ctypes.c_void_p * 8),
                ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong)]


class FfSumArgs(ctypes.Structure):
    """Mirror of `armon::FfSumArgs` (csrc/reduce.cu)."""
    _fields_ = [("rho", ctypes.c_void_p), ("E", ctypes.c_void_p),
                ("rows", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("cols", ctypes.c_longlong),
                ("g", ctypes.c_int), ("nx", ctypes.c_int), ("ny", ctypes.c_int)]


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
        fin = ctypes.POINTER(FinishArgs)
        for bits in (32, 64):
            fn = getattr(libs[f"sweep_f{bits}"], f"armon_sweep_f{bits}")
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(SweepArgs), fin, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = libs["cfl"].armon_cfl_finish
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(CflArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for bits in (32, 64):
            fn = getattr(libs[f"cycle_f{bits}"], f"armon_cycle_f{bits}")
            fn.argtypes = [ctypes.POINTER(CycleArgs), fin, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(libs[f"multicycle_f{bits}"], f"armon_multicycle_f{bits}")
            fn.argtypes = [ctypes.POINTER(MultiArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(libs[f"multicycle_f{bits}"],
                         f"armon_multicycle_occupancy_f{bits}")
            fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            fn = getattr(libs[f"cycle_f{bits}"], f"armon_cycle_occupancy_f{bits}")
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            for name, last in ((f"armon_cluster_f{bits}", ctypes.c_void_p),
                               (f"armon_cluster_occupancy_f{bits}",
                                ctypes.POINTER(ctypes.c_int))):
                fn = getattr(libs["probe_cluster"], name)
                fn.argtypes = [ctypes.POINTER(McArgs), last]
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
        fn = libs["reduce"].armon_ff_sum
        fn.argtypes = [ctypes.POINTER(FfSumArgs), vp, vp]
        fn.restype = ctypes.c_int
        fn = libs["reduce"].armon_ff_sum_maps
        fn.argtypes = [ctypes.POINTER(FfSumArgs), ll, vp]
        fn.restype = ctypes.c_int
        pp = ctypes.POINTER(vp)
        ull = ctypes.c_ulonglong
        for name, args in (("armon_while_create",
                            [pp, ctypes.POINTER(ull), pp]),
                           ("armon_while_attach", [vp, vp, vp, pp]),
                           ("armon_while_launch", [vp, vp]),
                           ("armon_while_destroy", [vp, vp]),
                           ("armon_countdown", [vp, ull, vp, vp])):
            fn = getattr(libs["graph"], name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        libs["cfl"].armon_error_string.argtypes = [ctypes.c_int]
        libs["cfl"].armon_error_string.restype = ctypes.c_char_p
        _LIBS = libs
        return libs


def _cxx():
    path = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if path is None:
        solver_error("cpp", "no host C++ compiler (c++) found: the native "
                            "library is built from armon_torch/native on "
                            "first use")
    return path


def _load_native(source, stem, functions):
    """Build (if needed) and load a native host library from `source` with
    the host C++ compiler, into ``build/armon_torch/`` under a name that
    hashes the source and flags, and declare `functions` ((name, restype,
    argtypes), ...). A failed build raises with the compiler's message."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            solver_error("cpp", f"native {stem} build failed (exit "
                                f"{proc.returncode}):\n"
                                f"{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    for name, res, args in functions:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load_io():
    """The native I/O library (`armon_torch/native/armon_io.cc`), built on
    first use (`_load_native`)."""
    global _IO_LIB
    with _LOCK:
        if _IO_LIB is None:
            vp, cl, ci, dp = (ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_double))
            _IO_LIB = _load_native(IO_SOURCE, "armon_io", (
                ("armon_write_cells", ci, [ctypes.c_char_p, ctypes.POINTER(vp),
                                           cl, cl, cl, ci, ci, ctypes.c_char_p]),
                ("armon_read_cells", cl, [ctypes.c_char_p, dp, cl, cl]),
                ("armon_read_window", cl, [ctypes.c_char_p, dp] + [cl] * 7),
                ("armon_count_differences", cl,
                 [dp, dp, cl, ctypes.c_double, ctypes.c_double, dp])))
        return _IO_LIB


def load_fma():
    """The native FMA library (`armon_torch/native/armon_fma.cc`): one
    exactly rounded fma per element for CPU arrays, built on first use."""
    global _FMA_LIB
    with _LOCK:
        if _FMA_LIB is None:
            vp, cl = ctypes.c_void_p, ctypes.c_long
            _FMA_LIB = _load_native(FMA_SOURCE, "armon_fma", tuple(
                (name, None, [vp] * 4 + [cl])
                for name in ("armon_fma_f64", "armon_fma_f32")))
        return _FMA_LIB


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


def while_create():
    """Make a whole-run graph's outer graph (csrc/graph.cu): one WHILE node
    whose condition starts at 1 at every launch. Returns the handles
    (graph, cond, body): the graph, for `while_attach` and
    `while_destroy`; the node's condition handle, an int, which the last
    launch of the body sets (`ops/sweep.Cond`); the node's body graph."""
    graph, cond, body = ctypes.c_void_p(), ctypes.c_ulonglong(), ctypes.c_void_p()
    rc = load()["graph"].armon_while_create(ctypes.byref(graph),
                                            ctypes.byref(cond),
                                            ctypes.byref(body))
    _check_status(rc, "whole-run graph create")
    return graph.value, cond.value, body.value


def while_attach(graph, body, child):
    """Copy the recorded body, the CUDA graph `child` (a handle, an int),
    into the WHILE body `body` of `graph` (`while_create`) and instantiate.
    Returns the exec handle, for `while_launch` and `while_destroy`."""
    exe = ctypes.c_void_p()
    rc = load()["graph"].armon_while_attach(graph, body, child,
                                            ctypes.byref(exe))
    _check_status(rc, "whole-run graph build")
    return exe.value


def while_launch(exe, device):
    """Launch a whole-run graph on the current stream of `device`."""
    _check_status(_launch(load()["graph"].armon_while_launch, device, exe),
                  "whole-run graph")


def while_destroy(graph, exe):
    _check_status(load()["graph"].armon_while_destroy(graph, exe),
                  "whole-run graph destroy")


def _cond_fields(args, cond, device):
    """Set a launch's WHILE condition fields (`cond`, `count`) from the
    `ops/sweep.Cond` `cond`; None leaves them 0, which sets nothing."""
    if cond is None:
        return
    _require(cond.count, torch.int32, device, 1, "the WHILE count")
    args.cond, args.count = cond.handle, _ptr(cond.count)


def launch_countdown(pred, cond=None):
    """Launch the WHILE node's measurement body (csrc/graph.cu
    `countdown_kernel`) on the current stream: one from the int32 `pred`
    and, with `cond` (`ops/sweep.Cond`), the iteration counted and the
    condition set from what is left."""
    _require(pred, torch.int32, pred.device, 1, "the countdown predicate")
    if cond is not None:
        _require(cond.count, torch.int32, pred.device, 1, "the WHILE count")
    rc = _launch(load()["graph"].armon_countdown, pred.device, _ptr(pred),
                 cond.handle if cond else 0, _ptr(cond.count) if cond else None)
    _check_status(rc, "countdown")


def launch_ff_sum(cfg, rho, E, n_real, rows, out, ticket, maps):
    """Launch K6 `ff_sum` on the current stream: the f32 compensated sums
    of the `n_real` = (nx, ny) real cells' rho and rho*E into `out` (4,),
    with `rows` (4, >= ny) and `ticket` (int32, 0) as scratch. The load
    path is `reductions.ff_load_path`'s; on the TMA path the descriptors
    come from `maps`, the shard's kept `FfMaps`."""
    from .reductions import FF_MAPS_BYTES, ff_load_path, ff_map_key
    dev = rho.device
    nx, ny = n_real
    g = cfg.nghost
    shape = tuple(rho.shape)
    if len(shape) != 2 or tuple(E.shape) != shape or g + ny > shape[0] \
            or g + nx > shape[1]:
        solver_error("config", f"ff_sum: rho and E must be one padded block "
                               f"holding {nx}x{ny} real cells and {g} ghosts; "
                               f"got {shape} and {tuple(E.shape)}")
    for t, what in ((rho, "rho"), (E, "E")):
        _require(t, torch.float32, dev, t.numel(), what)
    _require(rows, torch.float32, dev, 4 * ny, "ff_sum rows")
    _require(out, torch.float32, dev, 4, "ff_sum out")
    _require(ticket, torch.int32, dev, 1, "ff_sum ticket")
    a = FfSumArgs()
    a.rho, a.E = _ptr(rho), _ptr(E)
    a.rows, a.out, a.ticket = _ptr(rows), _ptr(out), _ptr(ticket)
    a.cols, a.g, a.nx, a.ny = shape[1], g, nx, ny
    lib = load()["reduce"]
    buf = None
    if ff_load_path(shape[1], a.rho, a.E) == "tma":
        def encode():
            b = ctypes.create_string_buffer(FF_MAPS_BYTES)
            _check_status(lib.armon_ff_sum_maps(ctypes.byref(a), shape[0], b),
                          "ff_sum tensor maps")
            return b
        buf = maps.get(ff_map_key(rho, E), encode)
    _check_status(_launch(lib.armon_ff_sum, dev, ctypes.byref(a), buf),
                  "ff_sum")


def _set_common(a, cfg, src, dst, scal, iscal, grid, n_real):
    """The fields `SweepArgs`, `CycleArgs` and `McArgs` share: operands,
    geometry (`grid`, where the kernel takes one; `n_real`: the shard's
    real cells), scheme switches and EOS constants."""
    from .sweep import fast_math_on
    dev = src[0].device
    _require(scal, src[0].dtype, dev, 4, "scal")
    _require(iscal, torch.int32, dev, 4, "iscal")
    a.src[:] = [_ptr(t) for t in src]
    a.dst[:] = [_ptr(t) for t in dst]
    a.scal, a.iscal = _ptr(scal), _ptr(iscal)
    a.rows, a.cols = src[0].shape
    if grid is not None:
        a.grid_x, a.grid_y = grid
    a.g, a.nx, a.ny = cfg.nghost, n_real[0], n_real[1]
    a.riemann = 1 if cfg.riemann == "GAD" else 0
    a.limiter = ("no_limiter", "minmod", "superbee").index(cfg.limiter)
    a.projection = 1 if cfg.projection == "euler_2nd" else 0
    a.fast = int(fast_math_on(cfg, dev))
    a.biz = int(isinstance(cfg.test, Bizarrium))
    a.k[:] = eos_constants(cfg)


def launch_sweep(cfg, axis, src, dst, p, partials, scal, iscal, factor,
                 emit, ghosts, n_real, finish=None, cond=None, fold=None):
    """Launch K1 (axis X) or K2 (axis Y) on the current stream; with
    `finish` (`ops/sweep.Finish`), its finishing kernel, which with `cond`
    (`ops/sweep.Cond`) also sets a WHILE condition; `fold`, an
    `ops/sweep.Fold`, its place in the cycle's cross-sweep EOS fold."""
    from .eos import fold_const
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
    if fold is not None:
        a.x_out = int(fold.keep)
        if fold.prev is not None:
            a.fold_in = 1
            a.fold_rdx, a.fold_k = (float(k) for k in fold_const(cfg, fold.prev))
    fin = _finish_args(cfg, finish, partials, gx * gy, scal, iscal, cond)
    bits = 8 * np.dtype(cfg.dtype).itemsize
    fn = getattr(libs[f"sweep_f{bits}"], f"armon_sweep_f{bits}")
    rc = _launch(fn, dev, 0 if axis is Axis.X else 1, ctypes.byref(a), fin)
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


def _finish_args(cfg, finish, partials, nblocks, scal, iscal, cond=None):
    """`FinishArgs` of a finishing launch that writes `nblocks` partials
    into `partials`, a column slice of `finish.partials` inside the folded
    columns [0, finish.n); None without `finish`. Kept on `finish` for the
    next launch with the same configuration and operands: the loop makes
    the same finishing launch every cycle, and building the arguments
    costs more host time than the rest of the launch's. With `cond`
    (`ops/sweep.Cond`, the last launch of a whole-run graph's body), a
    copy that also sets its WHILE condition, kept on `cond`."""
    if finish is None:
        return None
    if cond is not None:
        base = _finish_args(cfg, finish, partials, nblocks, scal, iscal)
        f = FinishArgs.from_buffer_copy(base._obj)
        _cond_fields(f, cond, partials.device)
        cond.args = f
        return ctypes.byref(f)
    key = (partials.data_ptr(), nblocks, scal.data_ptr(), iscal.data_ptr())
    if finish.args is not None and finish.args[0] is cfg and finish.args[1] == key:
        return finish.args[2]
    dtype, dev = partials.dtype, partials.device
    stride = _partials_stride(finish.partials, dtype, dev, finish.n)
    off = (partials.data_ptr() - finish.partials.data_ptr()) // partials.element_size()
    if partials.stride(0) != stride or off < 0 or off + nblocks > finish.n:
        solver_error("config", f"a finishing launch's CFL partials must be "
                               f"columns of the {finish.n} it folds")
    _require(finish.ticket, torch.int32, dev, 1, "finish ticket")
    T = np.dtype(cfg.dtype).type
    f = FinishArgs()
    f.partials, f.scal, f.iscal = _ptr(finish.partials), _ptr(scal), _ptr(iscal)
    f.ticket = _ptr(finish.ticket)
    f.stride, f.n = stride, finish.n
    f.dt = _dt_params(cfg)
    f.dx, f.dy = float(T(cfg.dx)), float(T(cfg.dy))
    finish.args = (cfg, key, ctypes.byref(f))
    return finish.args[2]


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


def _cycle_args(cfg, window, src, dst, p, partials, scal, iscal, n_partials,
                y_ghosts=None, n_real=None):
    """`CycleArgs` of a K4 or K5 launch over `window`s (`tile_grid`);
    `n_partials` is the partials' row stride (already validated), 0 when
    nothing is emitted; the Y ghosts mirror unless `y_ghosts` says
    otherwise."""
    from .cycle import tile_grid
    from .sweep import MIRRORED
    gx, gy = tile_grid(window, src[0].shape)
    a = CycleArgs()
    _set_common(a, cfg, src, dst, scal, iscal, (gx, gy), n_real or cfg.n_local)
    a.p = _ptr(p)
    a.partials = _ptr(partials) if n_partials else None
    a.n_partials = n_partials
    (a.ymode_lo, a.ymode_hi), (a.slab_lo, a.slab_hi) = \
        _ghost_args(y_ghosts or MIRRORED)
    _set_axes(a, cfg)
    return a


def _set_axes(a, cfg):
    """The per-axis fields `CycleArgs` and `McArgs` share: cell sizes and
    their inverses in T, the mirror factors of both axes, and the
    cross-sweep EOS fold's constants K after an X and after a Y sweep
    (`ops/eos.fold_const`; the instances that fold read them)."""
    from .eos import fold_const, folds
    from .sweep import mirror_factors
    T = np.dtype(cfg.dtype).type
    dx, dy = T(cfg.dx), T(cfg.dy)
    a.dx, a.dy = float(dx), float(dy)
    a.inv_dx, a.inv_dy = float(T(1.0) / dx), float(T(1.0) / dy)
    f_lo, f_hi = mirror_factors(cfg, Axis.X)
    a.fx_lo[:], a.fx_hi[:] = list(f_lo), list(f_hi)
    f_lo, f_hi = mirror_factors(cfg, Axis.Y)
    a.fy_lo[:], a.fy_hi[:] = list(f_lo), list(f_hi)
    if folds(cfg):
        a.kf_x = float(fold_const(cfg, Axis.X)[1])
        a.kf_y = float(fold_const(cfg, Axis.Y)[1])


def launch_cycle(cfg, x_first, fx, fy, src, dst, p, partials, scal, iscal,
                 emit, y_ghosts, n_real, finish=None, cond=None, keep=False):
    """Launch K4 on the current stream; with `finish` (`ops/sweep.Finish`),
    its finishing kernel, which with `cond` also sets a WHILE condition
    (as `launch_sweep`); with `keep` its second sweep stores its new
    density unscaled (`ops/sweep.Fold`)."""
    from .cycle import cycle_window, tile_grid
    libs = load()
    T = np.dtype(cfg.dtype).type
    window = cycle_window(cfg.dtype)
    gx, gy = tile_grid(window, src[0].shape)
    stride = _partials_stride(partials, src[0].dtype, src[0].device,
                              gx * gy) if emit else 0
    a = _cycle_args(cfg, window, src, dst, p, partials, scal, iscal,
                    stride, y_ghosts, n_real)
    a.emit, a.x_first = int(emit), int(x_first)
    a.fx, a.fy = float(T(fx)), float(T(fy))
    a.x_out = int(keep)
    fin = _finish_args(cfg, finish, partials, gx * gy, scal, iscal, cond)
    bits = 8 * np.dtype(cfg.dtype).itemsize
    fn = getattr(libs[f"cycle_f{bits}"], f"armon_cycle_f{bits}")
    rc = _launch(fn, src[0].device, ctypes.byref(a), fin)
    _check_status(rc, "cycle")


def launch_multicycle(cfg, parity_pairs, ncycles, src, dst, p, partials,
                      scal, iscal, cond=None):
    """Launch K5 on the current stream (a cooperative launch); with `cond`
    (`ops/sweep.Cond`), it sets that WHILE condition from iscal[next]."""
    from .cycle import MULTI_BAR_COLS, multi_partials, multi_tile
    libs = load()
    T = np.dtype(cfg.dtype).type
    window = multi_tile(src[0].shape, cfg.dtype)
    n = multi_partials(src[0].shape, src[0].device, cfg.dtype) + MULTI_BAR_COLS
    if (partials.dim() != 3 or partials.shape[:2] != (2, 2)
            or partials.shape[2] < n):
        solver_error("config", f"K5's CFL partials must have shape (2, 2, n), "
                               f"n >= {n} (`new_multicycle_partials`)")
    _require(partials, src[0].dtype, src[0].device, partials.numel(),
             "CFL partials")
    m = MultiArgs()
    m.c = _cycle_args(cfg, window, src, dst, p, partials, scal, iscal,
                      partials.shape[2])
    m.ncycles = int(ncycles)
    m.x_first[:] = [int(xf) for xf, _, _ in parity_pairs]
    m.fx[:] = [float(T(fx)) for _, fx, _ in parity_pairs]
    m.fy[:] = [float(T(fy)) for _, _, fy in parity_pairs]
    m.dt = _dt_params(cfg)
    _cond_fields(m, cond, src[0].device)
    # The barrier count: the partials' last 8 bytes, past every row's n.
    m.bar = partials.data_ptr() + partials.numel() * partials.element_size() - 8
    bits = 8 * np.dtype(cfg.dtype).itemsize
    fn = getattr(libs[f"multicycle_f{bits}"], f"armon_multicycle_f{bits}")
    rc = _launch(fn, src[0].device, ctypes.byref(m))
    _check_status(rc, "multicycle")


def _cluster_args(cfg, plan, parity_pairs, ncycles, src, dst, p, scal,
                  iscal):
    """`McArgs` of a launch of the cluster probe's kernel with `plan`
    (probes/cluster.py `plan`)."""
    T = np.dtype(cfg.dtype).type
    rows, cols = src[0].shape
    g = cfg.nghost
    m = McArgs()
    _set_common(m, cfg, src, dst, scal, iscal, None,
                (cols - 2 * g, rows - 2 * g))
    m.p = _ptr(p)
    m.ncycles = int(ncycles)
    m.x_first[:] = [int(xf) for xf, _, _ in parity_pairs]
    for key in ("band_r", "band_c", "pitch_r", "pitch_c", "plane", "smem"):
        setattr(m, key, plan[key])
    m.fx[:] = [float(T(fx)) for _, fx, _ in parity_pairs]
    m.fy[:] = [float(T(fy)) for _, _, fy in parity_pairs]
    _set_axes(m, cfg)
    m.dt = _dt_params(cfg)
    return m


def launch_cluster(cfg, plan, parity_pairs, ncycles, src, dst, p, scal,
                   iscal):
    """Launch the cluster probe's K5 (csrc/cluster.cuh) on the current
    stream: one cluster of 16 CTAs with `plan`."""
    m = _cluster_args(cfg, plan, parity_pairs, ncycles, src, dst, p, scal,
                      iscal)
    bits = 8 * np.dtype(cfg.dtype).itemsize
    fn = getattr(load()["probe_cluster"], f"armon_cluster_f{bits}")
    rc = _launch(fn, src[0].device, ctypes.byref(m))
    _check_status(rc, "cluster multicycle")


def cluster_occupancy(cfg, plan, src):
    """What the card makes of the cluster probe's `plan` on `src`'s grid:
    {"max_active_clusters", "registers", "local_bytes"}."""
    dev = src[0].device
    scal = torch.zeros(4, dtype=src[0].dtype, device=dev)
    iscal = torch.zeros(4, dtype=torch.int32, device=dev)
    m = _cluster_args(cfg, plan, ((True, 1.0, 1.0),) * 2, 1, src, src,
                      src[0], scal, iscal)
    bits = 8 * np.dtype(cfg.dtype).itemsize
    out = (ctypes.c_int * 4)()
    fn = getattr(load()["probe_cluster"], f"armon_cluster_occupancy_f{bits}")
    _check_status(fn(ctypes.byref(m), out), "cluster occupancy")
    return {"max_active_clusters": out[0], "registers": out[2],
            "local_bytes": out[3]}


def cycle_occupancy(dtype, fast, biz):
    """(resident blocks per SM, threads per block, dynamic shared memory
    bytes) of a K4 instance on the current card."""
    bits = 8 * np.dtype(dtype).itemsize
    out = (ctypes.c_int * 3)()
    fn = getattr(load()[f"cycle_f{bits}"], f"armon_cycle_occupancy_f{bits}")
    _check_status(fn(int(fast), int(biz), out), "cycle occupancy")
    return tuple(out)


def multicycle_occupancy(shape, dtype, fast, biz):
    """What the card makes of the K5 instance a padded (rows, cols) grid
    takes: {"window", "tiles", "blocks_per_sm", "threads", "smem_bytes",
    "registers", "local_bytes"}."""
    bits = 8 * np.dtype(dtype).itemsize
    out = (ctypes.c_int * 7)()
    fn = getattr(load()[f"multicycle_f{bits}"], f"armon_multicycle_occupancy_f{bits}")
    _check_status(fn(int(shape[0]), int(shape[1]), int(fast), int(biz), out),
                  "multicycle occupancy")
    return dict(zip(("window", "tiles", "blocks_per_sm", "threads",
                     "smem_bytes", "registers", "local_bytes"), out))


def launch_probe(stem, name, device, *args):
    """Launch a probe kernel of library `stem` (function `name`) on the
    current stream of `device`; raises if the launcher refuses it."""
    rc = _launch(getattr(load()[stem], name), device, *args)
    _check_status(rc, name)


def launch_cycle_variant(cfg, variant, window, x_first, fx, fy, src, dst, p,
                         partials, scal, iscal):
    """Launch one of K4's measurement variants (csrc/probe_cycle.cu), an
    emitting launch over (columns, rows) windows (K4's own, or 96 x 128)
    or, for an int `window`, K5's tile body on square ones, on the current
    stream."""
    from .cycle import tile_grid, CYCLE_WINDOW
    T = np.dtype(cfg.dtype).type
    gx, gy = tile_grid(window, src[0].shape)
    stride = _partials_stride(partials, src[0].dtype, src[0].device, gx * gy)
    a = _cycle_args(cfg, window, src, dst, p, partials, scal, iscal, stride)
    a.emit, a.x_first = 1, int(x_first)
    a.fx, a.fy = float(T(fx)), float(T(fy))
    launch_probe("probe_cycle", "armon_cycle_variant_f32", src[0].device,
                 int(variant), window if isinstance(window, int) else
                 (0 if tuple(window) == CYCLE_WINDOW[4] else window[1]),
                 ctypes.byref(a))
