"""Global-domain boundary conditions of the op path
(`armon_tpu/ops/boundary.py`, `src/halo_exchange.jl:2-36`).

Ghost cell k (counting from the border) mirrors real cell k, with the
velocity component normal to a Dirichlet wall negated by (u_factor,
v_factor) (`src/tests.jl:150-161`): a flip of the first (last) g real lines.
Only the two sides along the sweep axis are filled, low side first: on a
grid thinner than the ghost band the high side's mirror reads cells the
low side has just filled, as the JAX package's sequential fill does.

The JAX functions are functional; these write into copies, so no field of
a State ever aliases another (an initial State shares one zero tensor
between its p, c, g, ustar and pstar).

`n` is the number of real cells along the side's axis: the high-side band
sits past them. It defaults to the padded size less both bands; the
hi-edge shard of an uneven split passes its own (`parallel/halo.py`).
"""

from ..utils.enums import Axis, Side, axis_of, is_first_side, sides_along
from ..core.state import COMM_VARS


def _span(a, side: Side, g: int, n=None):
    """(array dim, real count) of `side` in the padded `a`."""
    d = axis_of(side).array_axis
    return d, (a.shape[d] - 2 * g if n is None else n)


def mirror_slab(a, side: Side, g: int, n=None):
    """The g real lines of `a` next to `side`, flipped so that they fill
    the ghost band by mirror symmetry."""
    d, n = _span(a, side, g, n)
    return a.narrow(d, g if is_first_side(side) else n, g).flip(d)


def _fill(a, side: Side, g: int, slab, n=None):
    d, n = _span(a, side, g, n)
    a.narrow(d, 0 if is_first_side(side) else g + n, g).copy_(slab)


def set_ghost_slab(a, side: Side, g: int, slab, n=None):
    """A copy of `a` with `slab` in the g-wide ghost band of `side`."""
    a = a.clone()
    _fill(a, side, g, slab, n)
    return a


def _var_factor(var: str, u_factor, v_factor):
    if var == "u":
        return u_factor
    if var == "v":
        return v_factor
    return 1.0


def mirror_into(cfg, a, var, side, n=None):
    """Fill the ghost band of `side` in `a` (in place) by the mirror."""
    f = _var_factor(var, *cfg.test.boundary_factors(side))
    slab = mirror_slab(a, side, cfg.nghost, n)
    _fill(a, side, cfg.nghost, slab if f == 1.0 else slab * f, n)


def apply_side_bc(cfg, state, side: Side, vars=COMM_VARS, n=None):
    """The ghost band of `side` filled for `vars`
    (`src/halo_exchange.jl:2-36`), in copies."""
    updates = {}
    for var in vars:
        a = getattr(state, var).clone()
        mirror_into(cfg, a, var, side, n)
        updates[var] = a
    return state._replace(**updates)


def boundary_conditions(cfg, state, axis: Axis, vars=COMM_VARS, n=None):
    """One device's ghost exchange: both global borders along `axis`, low
    side then high side (`src/halo_exchange.jl:323-354`), one copy per
    field."""
    updates = {}
    for var in vars:
        a = getattr(state, var).clone()
        for side in sides_along(axis):
            mirror_into(cfg, a, var, side, n)
        updates[var] = a
    return state._replace(**updates)
