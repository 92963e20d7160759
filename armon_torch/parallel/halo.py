"""Ghost cells between the shards of a mesh (`armon_tpu/parallel/halo.py`).

A shard's ghost band along an axis holds its neighbour's g real lines next
to the shared border, or, at a global border, the mirror of its own first
(last) g real lines times the variable's +-1 factor. The JAX package moves
the neighbours' lines with `lax.ppermute`; here they are tensor copies
(`Tensor.copy_`, across devices where the shards sit on different cards)
between the shards of one process, and messages between processes
(`dist.exchange`, one batch an exchange: each side that faces another
process's shard sends this shard's g lines and receives the neighbour's;
the time loop stacks the lines it sends into buffers made once,
`new_send_buffers`, and receives into its slab buffers).
Every function works on the fused exchange set (rho, u, v, E), given per
shard of this process (`mesh.local`, indexed by `Shard.slot`).

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
from . import dist


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
            own = _real_lines(cfg, fields[shard.slot], shard, axis, side)
            lines = [torch.flip(a, (d,)) * f for a, f in zip(own, facs)]
        else:
            lines = [a.to(shard.device)
                     for a in _real_lines(cfg, fields[nb.slot], nb, axis, 1 - side)]
        out.append(torch.stack(lines))
    return tuple(out)


def _pack(dst, lines):
    """Copy the four line blocks into the stacked slab `dst`."""
    if all(a.device == dst.device for a in lines):
        torch.stack(lines, out=dst)
    else:
        for d, a in zip(dst, lines):
            d.copy_(a)


def _slab_shape(cfg, axis, field, depth):
    rows, cols = field.shape
    g = cfg.nghost
    return (depth, g, cols) if Axis(axis) is Axis.Y else (depth, rows, g)


def _tag(shard, side):
    """The tag of the message that fills `shard`'s ghosts on `side`."""
    return 2 * shard.index + side


def _remote(mesh, shard, axis, side):
    """The neighbour of `shard` across `side` along `axis` where it lives
    on another process, else None."""
    nb = mesh.neighbour(shard, axis, side)
    return None if nb is None or mesh.is_local(nb) else nb


def _swap_remote(cfg, mesh, fields, axis, into, sends=None):
    """The exchange with the other processes along `axis`: each local
    shard sends, stacked, its g real lines of `fields[slot]` next to each
    side whose neighbour lives on another process, and receives that
    neighbour's into `into(shard, side)`. Every process walks the same
    mesh, so a send of one is a receive of the other, in the same order
    between any two processes. With `sends` (`new_send_buffers`), the
    lines are stacked into those buffers, so that nothing is allocated."""
    if mesh.nprocs == 1:
        return
    send, recv = [], []
    for s in mesh.local:
        for side in (0, 1):
            nb = _remote(mesh, s, axis, side)
            if nb is None:
                continue
            lines = _real_lines(cfg, fields[s.slot], s, axis, side)
            stack = torch.stack(lines) if sends is None else \
                torch.stack(lines, out=sends[s.slot][side])
            send.append((stack, nb.rank, _tag(nb, 1 - side)))
            recv.append((into(s, side), nb.rank, _tag(s, side)))
    dist.exchange(send, recv, mesh.local[0].device)


def _side_buffers(cfg, mesh, fields, axis, faces):
    """Per local shard, (lo, hi) slab-shaped buffers on the shard's device
    for the sides whose neighbour `faces(neighbour)` accepts (None
    elsewhere)."""
    out = []
    for s in mesh.local:
        f = fields[s.slot][0]
        nbs = [mesh.neighbour(s, axis, side) for side in (0, 1)]
        out.append(tuple(
            torch.empty(_slab_shape(cfg, axis, f, 4), dtype=f.dtype,
                        device=s.device)
            if nb is not None and faces(nb) else None for nb in nbs))
    return out


def new_slab_buffers(cfg, mesh, fields, axis):
    """Per local shard, (lo, hi) slab buffers for the sides that face a
    neighbour along `axis` (None at a global border), on the shard's
    device."""
    return _side_buffers(cfg, mesh, fields, axis, lambda nb: True)


def new_send_buffers(cfg, mesh, fields, axis):
    """Per local shard, (lo, hi) send stacks for the sides that face
    another process's shard along `axis` (None elsewhere), on the shard's
    device: what `halo_slabs` stacks a shard's own lines into before the
    exchange sends them."""
    return _side_buffers(cfg, mesh, fields, axis,
                         lambda nb: not mesh.is_local(nb))


def halo_slabs(cfg, mesh, fields, axis, out=None, sends=None):
    """Per shard, the (lo, hi) ghost sources the kernels take along
    `axis`: a stacked slab of the neighbour's adjacent real lines on each
    side that faces one, `MIRROR` at a global border. With `out`
    (`new_slab_buffers`), the slabs are copied into those buffers; the
    sweeps write out of place, so the neighbours' fields they are read
    from are not written while a kernel reads the slabs. With `sends`
    (`new_send_buffers`) too, the lines sent to other processes are
    stacked into those, and under NCCL nothing is allocated: the form the
    time loop's CUDA graphs capture."""
    axis = Axis(axis)
    if out is None:
        out = new_slab_buffers(cfg, mesh, fields, axis)
    res = []
    for s in mesh.local:
        sides = []
        for side in (0, 1):
            nb = mesh.neighbour(s, axis, side)
            if nb is None:
                sides.append(MIRROR)
                continue
            buf = out[s.slot][side]
            if mesh.is_local(nb):
                _pack(buf, _real_lines(cfg, fields[nb.slot], nb, axis,
                                       1 - side))
            sides.append(buf)
        res.append(tuple(sides))
    _swap_remote(cfg, mesh, fields, axis, lambda s, side: out[s.slot][side],
                 sends)
    return res


def halo_exchange(cfg, mesh, fields, axis):
    """The ghost bands of every shard's (rho, u, v, E) along `axis` filled
    from its neighbours, and mirrored at global borders (low side, then
    high side); returns new tensors per shard."""
    axis = Axis(axis)
    return [tuple(fill_ghosts_plain(cfg, axis, fields[s.slot], s.n_real, gh))
            for s, gh in zip(mesh.local, halo_slabs(cfg, mesh, fields, axis))]


def halo_exchange_state(cfg, mesh, states, axis, vars=COMM_VARS):
    """Every local shard's State (`states[slot]`) with the ghost bands
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
    fields = [tuple(getattr(st, v) for v in vars) for st in states]
    recv = {}

    def into(s, side):
        f = fields[s.slot][0]
        buf = recv[s.slot, side] = torch.empty(
            _slab_shape(cfg, axis, f, len(vars)), dtype=f.dtype,
            device=f.device)
        return buf

    _swap_remote(cfg, mesh, fields, axis, into)
    out = []
    for s in mesh.local:
        n = s.n_real[k]
        updates = {}
        for i, var in enumerate(vars):
            a = fields[s.slot][i].clone()
            for side, border in enumerate(sides_along(axis)):
                nb = mesh.neighbour(s, axis, side)
                if nb is None:
                    mirror_into(cfg, a, var, border, n)
                    continue
                if mesh.is_local(nb):
                    [lines] = _real_lines(cfg, [fields[nb.slot][i]], nb, axis,
                                          1 - side)
                else:
                    lines = recv[s.slot, side][i]
                _lines(a, axis, g + n if side else 0, g).copy_(lines)
            updates[var] = a
        out.append(states[s.slot]._replace(**updates))
    return out
