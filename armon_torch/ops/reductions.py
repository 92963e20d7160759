"""Global reductions: CFL time step and conservation variables
(`armon_tpu/ops/reductions.py`, `src/reductions.jl`).

The real domain of a shard is the slice ``[g:g+ny, g:g+nx]`` of its padded
block, (nx, ny) its real extent: `cfg.n_local`, or less on the hi-edge
shard of an uneven split, whose dead slack is left out. Max and min are
exact, so the CFL minimum is the same in any reduction order and over any
split; the conservation sums feed tolerance checks only, and a mesh adds
its shards' sums in f64 on the host (`core/solver.make_conservation`).
"""

import numpy as np
import torch

from .eos import scalar_like


def real_slice(cfg, n_real=None):
    g = cfg.nghost
    nx, ny = n_real or cfg.n_local
    return (slice(g, g + ny), slice(g, g + nx))


def cfl_limit(cfg, mx, my):
    """min(dx/mx, dy/my) with dx, dy rounded to T: the second half of the
    restructured CFL reduction (`ops/pallas/sweep.py:968-975`). NaN in
    either maximum propagates to the result."""
    T = np.dtype(cfg.dtype).type
    return torch.minimum(scalar_like(mx, T(cfg.dx)) / mx,
                         scalar_like(my, T(cfg.dy)) / my)


def cfl_maxima(cfg, u, v, c, n_real=None):
    """(max(|u|+c), max(|v|+c)) over the real cells, NaN propagating."""
    r = real_slice(cfg, n_real)
    c = c[r]
    return torch.amax(torch.abs(u[r]) + c), torch.amax(torch.abs(v[r]) + c)


def dt_cfl_min(cfg, state, n_real=None):
    """Minimum CFL-stable dt over the real cells of a State
    (`src/reductions.jl:14-20`, `armon_tpu/ops/reductions.py:60`) as
    min(dx/max(|u|+c), dy/max(|v|+c)): bitwise the per-cell form, since
    IEEE division is monotone in the denominator. The real cells are a
    slice: on the hi-edge shard of an uneven split, `n_real` leaves its
    dead slack out, bit for bit the JAX package's masked maximum (every
    real |u|+c is >= +0 or NaN, so the mask's zeros never win). Returns a
    0-dim tensor."""
    return cfl_limit(cfg, *cfl_maxima(cfg, state.u, state.v, state.c, n_real))


def pmin_dt(dts, device):
    """The minimum of the shards' CFL dt on `device` (`pmin_dt`,
    `armon_tpu/ops/reductions.py:91`): a NaN is mapped to 0 first, so
    that a diverged shard fails the dt gate instead of losing the
    minimum to the others."""
    d = torch.stack([x.to(device) for x in dts])
    return torch.where(torch.isnan(d), torch.zeros_like(d), d).amin()


def _ff_sum(x):
    """Compensated (Knuth 2Sum) sum of a 2D tensor, the plain version of K6
    `ff_sum` (`csrc/reduce.cu`) and the order it holds to: a vector 2Sum
    scan over the columns keeps one (hi, lo) pair per row, as the JAX
    package's `lax.scan` does; then a scalar 2Sum scan combines the row
    sums in row order, and the rows' lo terms are added to the low word as
    one sum taken in row order, sequentially in T from 0. f64-grade
    accuracy in pure f32; the (hi, lo) pair is combined on the host in f64
    (`conservation_scalar`)."""
    def two_sum(hi, lo, b):
        t = hi + b
        bp = t - hi
        err = (hi - (t - bp)) + (b - bp)
        return t, lo + err

    hi = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    lo = torch.zeros_like(hi)
    for i in range(x.shape[1]):
        hi, lo = two_sum(hi, lo, x[:, i])
    # The scalar scans in the same dtype on the host: numpy scalars round
    # every operation to T exactly as the device would.
    T = np.float64 if x.dtype == torch.float64 else np.float32
    h = l = L = T(0.0)
    with np.errstate(invalid="ignore", over="ignore"):  # inf and NaN carry
        for b, c in zip(hi.cpu().numpy(), lo.cpu().numpy()):
            h, l = two_sum(h, l, b)
            L = L + c
        return np.array([h, l + L], dtype=T)


def ff_sum_plain(cfg, rho, E, n_real=None):
    """K6's plain version: (h_m, l_m, h_e, l_e), the compensated sums of
    the real cells' rho and rho * E (`_ff_sum`), as one float32 array."""
    r = real_slice(cfg, n_real)
    rho = rho[r]
    return np.concatenate([_ff_sum(rho), _ff_sum(rho * E[r])])


# K6's load paths: TMA takes a 16-byte aligned base and row stride; its box
# coordinates take any element index, so the ghost width does not enter.
FF_MAPS_BYTES = 256  # `armon::FfMaps`: two CUtensorMap of 128 bytes
FF_MAPS_KEPT = 4     # descriptors a scratch keeps (a loop's buffer sets)


def ff_load_path(cols, rho_ptr, E_ptr):
    """K6's load path for a contiguous block of `cols` float32 columns at
    these addresses: "tma" (bulk tensor copies) where the row stride and
    both bases are 16-byte aligned, else "cp_async" (4-byte copies by
    every lane; the same kernel, the same bits)."""
    return "tma" if cols % 4 == 0 and rho_ptr % 16 == 0 and \
        E_ptr % 16 == 0 else "cp_async"


def ff_map_key(rho, E):
    """What K6's TMA descriptors of rho and E encode: both addresses and
    the block's shape. Equal keys give equal descriptors."""
    return (rho.data_ptr(), E.data_ptr()) + tuple(rho.shape)


class FfMaps:
    """K6's encoded TMA descriptors, kept by a shard's `FfScratch` so that
    a call whose tensors were seen before encodes nothing: up to
    `FF_MAPS_KEPT` keys (`ff_map_key`; a loop alternates buffer sets), the
    oldest dropped first."""
    __slots__ = ("kept",)

    def __init__(self):
        self.kept = {}

    def get(self, key, encode):
        """The descriptors for `key`, from `encode()` where not kept."""
        buf = self.kept.pop(key, None)
        if buf is None:
            buf = encode()
            if len(self.kept) >= FF_MAPS_KEPT:
                del self.kept[next(iter(self.kept))]
        self.kept[key] = buf
        return buf


class FfScratch:
    """K6's scratch for a shard of `ny` real rows on `device`: the per-row
    pairs (4, ny), the ticket (0 between launches: the kernel resets it),
    the output (4,) and the kept TMA descriptors (`FfMaps`, host memory).
    Made once per shard and kept (`core/solver.make_conservation`): 16
    bytes a row and 20 more on the device."""
    __slots__ = ("rows", "ticket", "out", "maps")

    def __init__(self, ny, device):
        self.rows = torch.empty((4, ny), dtype=torch.float32, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.out = torch.empty(4, dtype=torch.float32, device=device)
        self.maps = FfMaps()


def ff_sum(cfg, rho, E, n_real=None, scratch=None):
    """The f32 conservation sums of one shard as one host float32 array
    (h_m, l_m, h_e, l_e): for CUDA tensors K6 `ff_sum` (one launch for
    both fields, then one host read; `scratch` an `FfScratch` of the
    shard's rows on its device, made here where None), for CPU tensors its
    plain version. The two give the same bits. Replaces no TPU kernel: the
    `lax.scan` of `_ff_sum` (`armon_tpu/ops/reductions.py:108-130`)."""
    if rho.device.type != "cuda":
        return ff_sum_plain(cfg, rho, E, n_real)
    from . import _build
    from .sweep import LAUNCHES
    nx, ny = n_real or cfg.n_local
    if scratch is None:
        scratch = FfScratch(ny, rho.device)
    _build.launch_ff_sum(cfg, rho, E, (nx, ny), scratch.rows, scratch.out,
                         scratch.ticket, scratch.maps)
    LAUNCHES["ff_sum"] += 1
    return scratch.out.cpu().numpy()


def conservation_vars(cfg, rho, E, n_real=None, scratch=None):
    """(total mass, total energy) over real cells
    (`src/reductions.jl:202-216,254-258`). f64: ds-scaled scalars. f32:
    unscaled compensated (hi, lo) pairs (`ff_sum`, one host read for
    both; `scratch` as there); combine with `conservation_scalar`."""
    if np.dtype(cfg.dtype).itemsize == 4:
        v = ff_sum(cfg, rho, E, n_real, scratch)
        return v[:2], v[2:]
    T = np.dtype(cfg.dtype).type
    r = real_slice(cfg, n_real)
    rho = rho[r]
    ds = float(T(cfg.dx) * T(cfg.dy))
    return torch.sum(rho) * ds, torch.sum(rho * E[r]) * ds


def conservation_values(cfg, rho, E, n_real=None, scratch=None):
    """(mass, energy) of one shard as host f64 floats, from one host read
    (`conservation_vars`, then `conservation_scalar`)."""
    m, e = conservation_vars(cfg, rho, E, n_real, scratch)
    if isinstance(m, torch.Tensor):
        m, e = torch.stack([m, e]).tolist()
    return conservation_scalar(cfg, m), conservation_scalar(cfg, e)


def conservation_scalar(cfg, v) -> float:
    """Host f64 value of a `conservation_vars` output: a compensated
    (hi, lo) pair is combined and scaled by the cell area in f64."""
    a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float64)
    if a.ndim >= 1 and a.shape[-1] == 2:
        return float((a[..., 0] + a[..., 1]).sum() * (cfg.dx * cfg.dy))
    return float(a)
