"""Initial condition (`armon_tpu/ops/init.py`, `src/kernels.jl:106-145`):
cell corner positions from the global index, two-state initialization on
cell centres. Ghost cells get the analytic values of their global position.
"""

import numpy as np
import torch

from ..core.state import State, torch_dtype
from ..models.cases import DebugIndexes


def init_state(cfg, device, global_pos=(0, 0)) -> State:
    """The initial state of one padded (sub-)domain on `device`.

    `global_pos` is the 0-based global-grid index of the first real cell
    (the Julia reference's `N_origin - 1`, `src/parameters.jl:727`)."""
    T = np.dtype(cfg.dtype).type
    tdt = torch_dtype(cfg.dtype)
    g = cfg.nghost
    ny_tot, nx_tot = cfg.local_shape
    dx, dy = T(cfg.dx), T(cfg.dy)
    ox, oy = T(cfg.origin[0]), T(cfg.origin[1])

    gi = torch.arange(-g, nx_tot - g, dtype=torch.int32, device=device) + global_pos[0]
    gj = torch.arange(-g, ny_tot - g, dtype=torch.int32, device=device) + global_pos[1]
    gJ, gI = torch.meshgrid(gj, gi, indexing="ij")  # (ny_tot, nx_tot)

    # Cell corner position (src/kernels.jl:125)
    x = gI.to(tdt) * float(dx) + float(ox)
    y = gJ.to(tdt) * float(dy) + float(oy)
    zeros = torch.zeros((ny_tot, nx_tot), dtype=tdt, device=device)

    test = cfg.test
    if isinstance(test, DebugIndexes):
        lin = (gI + gJ * cfg.n_global[0] + 1).to(tdt)
        return State(x=x, y=y, rho=lin, u=lin, v=lin, E=lin, p=lin, c=lin,
                     g=lin, ustar=zeros, pstar=zeros)

    # Cell centre (src/kernels.jl:131)
    high = test.region_high(x + float(dx / 2), y + float(dy / 2))
    ip = test.init_params()

    def two_state(hi, lo):
        return torch.where(high, torch.tensor(float(T(hi)), dtype=tdt, device=device),
                           torch.tensor(float(T(lo)), dtype=tdt, device=device))

    return State(x=x, y=y,
                 rho=two_state(ip.high_rho, ip.low_rho),
                 u=two_state(ip.high_u, ip.low_u),
                 v=two_state(ip.high_v, ip.low_v),
                 E=two_state(ip.high_E, ip.low_E),
                 p=zeros, c=zeros, g=zeros, ustar=zeros, pstar=zeros)
