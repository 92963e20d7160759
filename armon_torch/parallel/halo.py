"""Ghost cells between the shards of a mesh (`armon_tpu/parallel/halo.py`).

A shard's ghost band along an axis holds its neighbour's g real lines next
to the shared border, or, at a global border, the mirror of its own first
(last) g real lines times the variable's +-1 factor. The JAX package moves
the neighbours' lines with `lax.ppermute`; here they are tensor copies
(`Tensor.copy_`, across devices where the shards sit on different cards).
Every function works on the fused exchange set (rho, u, v, E), given per
shard in the mesh's order.

- `ghost_slabs`: a shard's (lo, hi) ghost content along an axis, with the
  mirror selected at global borders (`_ghost_slabs`);
- `halo_slabs`: what the kernels consume: the neighbour's lines, packed
  into stacked (4, ...) slabs, on the sides that face a neighbour, and
  `MIRROR` on the global-border sides, which the kernels fill themselves;
- `halo_exchange`: the write-back form, ghost bands replaced in copies of
  the fields. The time loop does not use it.
- `halo_exchange_state`: the op path's write-back form over whole States
  and any set of fields, the seven `COMM_VARS` by default, as the JAX
  package's jnp tier exchanges them (`halo_exchange`, `:101-118`).

Slabs are (4, g, cols) along Y and (4, rows, g) along X: field, then the
g lines (Y) or the rows (X) in array order.
"""

import torch

from ..utils.enums import Axis, sides_along
from ..core.state import COMM_VARS
from ..ops.boundary import boundary_conditions, mirror_into
from ..ops.sweep import MIRROR, mirror_factors, fill_ghosts_plain


def _lines(a, axis, start, g):
    return a.narrow(Axis(axis).array_axis, start, g)


def _real_lines(cfg, fields, shard, axis, side):
    """The g real lines of `shard` next to `side` (0 low, 1 high)."""
    g = cfg.nghost
    n = shard.n_real[int(axis)]
    return [_lines(a, axis, n if side else g, g) for a in fields]


def ghost_slabs(cfg, mesh, fields, shard, axis):
    """(lo, hi) stacked (4, ...) ghost content of `shard` along `axis`: its
    neighbours' adjacent real lines, or the mirror of its own at a global
    border. `fields[s]` is shard s's (rho, u, v, E)."""
    axis = Axis(axis)
    d = axis.array_axis
    out = []
    for side, facs in enumerate(mirror_factors(cfg, axis)):
        nb = mesh.neighbour(shard, axis, side)
        if nb is None:
            own = _real_lines(cfg, fields[shard.index], shard, axis, side)
            lines = [torch.flip(a, (d,)) * f for a, f in zip(own, facs)]
        else:
            lines = [a.to(shard.device)
                     for a in _real_lines(cfg, fields[nb.index], nb, axis, 1 - side)]
        out.append(torch.stack(lines))
    return tuple(out)


def _pack(dst, lines):
    """Copy the four line blocks into the stacked slab `dst`."""
    if all(a.device == dst.device for a in lines):
        torch.stack(lines, out=dst)
    else:
        for d, a in zip(dst, lines):
            d.copy_(a)


def new_slab_buffers(cfg, mesh, fields, axis):
    """Per shard, (lo, hi) slab buffers for the sides that face a
    neighbour along `axis` (None at a global border), on the shard's
    device."""
    axis = Axis(axis)
    g = cfg.nghost
    out = []
    for s in mesh:
        rows, cols = fields[s.index][0].shape
        shape = (4, g, cols) if axis is Axis.Y else (4, rows, g)
        out.append(tuple(
            torch.empty(shape, dtype=fields[s.index][0].dtype, device=s.device)
            if mesh.neighbour(s, axis, side) is not None else None
            for side in (0, 1)))
    return out


def halo_slabs(cfg, mesh, fields, axis, out=None):
    """Per shard, the (lo, hi) ghost sources the kernels take along
    `axis`: a stacked slab of the neighbour's adjacent real lines on each
    side that faces one, `MIRROR` at a global border. With `out`
    (`new_slab_buffers`), the slabs are copied into those buffers; the
    sweeps write out of place, so the neighbours' fields they are read
    from are not written while a kernel reads the slabs."""
    axis = Axis(axis)
    if out is None:
        out = new_slab_buffers(cfg, mesh, fields, axis)
    res = []
    for s in mesh:
        sides = []
        for side in (0, 1):
            nb = mesh.neighbour(s, axis, side)
            if nb is None:
                sides.append(MIRROR)
                continue
            buf = out[s.index][side]
            _pack(buf, _real_lines(cfg, fields[nb.index], nb, axis, 1 - side))
            sides.append(buf)
        res.append(tuple(sides))
    return res


def halo_exchange(cfg, mesh, fields, axis):
    """The ghost bands of every shard's (rho, u, v, E) along `axis` filled
    from its neighbours, and mirrored at global borders (low side, then
    high side); returns new tensors per shard."""
    axis = Axis(axis)
    return [tuple(fill_ghosts_plain(cfg, axis, fields[s.index], s.n_real, gh))
            for s, gh in zip(mesh, halo_slabs(cfg, mesh, fields, axis))]


def halo_exchange_state(cfg, mesh, states, axis, vars=COMM_VARS):
    """Every shard's State (`states[s]`, mesh order) with the ghost bands
    of `vars` along `axis` filled, in copies: a neighbour's adjacent real
    lines on the sides that face one, the mirror at a global border (the
    hi-edge shard's band past its own real cells). A mesh flat along
    `axis` (one shard among them) is `boundary_conditions` on each shard,
    low side first. Along a sharded axis
    every band is read from the fields as they were, as `lax.ppermute`
    reads them; shards there hold at least g real lines, so no band is
    a source of another."""
    axis = Axis(axis)
    k = int(axis)
    if mesh.proc_dims[k] == 1:
        return [boundary_conditions(cfg, st, axis, vars) for st in states]
    g = cfg.nghost
    out = []
    for s in mesh:
        n = s.n_real[k]
        updates = {}
        for var in vars:
            a = getattr(states[s.index], var).clone()
            for side, border in enumerate(sides_along(axis)):
                nb = mesh.neighbour(s, axis, side)
                if nb is None:
                    mirror_into(cfg, a, var, border, n)
                else:
                    src = getattr(states[nb.index], var)
                    [lines] = _real_lines(cfg, [src], nb, axis, 1 - side)
                    _lines(a, axis, g + n if side else 0, g).copy_(lines)
            updates[var] = a
        out.append(states[s.index]._replace(**updates))
    return out
