"""The X mirror-fill probe, counterpart of `scripts/probe_flip.py`.

    python -m armon_torch.probes.flip                 # on the card
    python -m armon_torch.probes.flip --device cpu    # plain versions

Two kernels (csrc/probe_stream.cu): ``mirror_fill`` copies a (rows, cols)
f32 array with its first and last g = 4 columns mirror-filled, as K1
fills its X ghost columns in its load (`kernel_mirror`, probe_flip.py:39);
``copy`` is the same pass without the fill (`kernel_copy` :47). The run
checks the fill bit for bit against the script's numpy mirror (:59-62)
and times both, and the copy as one PyTorch call (`Tensor.copy_`, the
library time): at the script's (512, 1024), which moves 4 MB and so
measures the launch, and at (8200, 8200), the main path's padded shape,
where the fill's own cost shows as the difference.
"""

import argparse

import numpy as np
import torch

from . import LAUNCHES, count
from .._card import bound, card_line, device_of, emit, kernel_entry, shown, time_ms

G = 4
SCRIPT_SHAPE = (512, 1024)   # probe_flip.py:52
MAIN_SHAPE = (8200, 8200)    # the main path's 8192^2 with its ghosts
SOURCE = "armon_torch/csrc/probe_stream.cu"
REPLACES = {"flip_mirror": "scripts/probe_flip.py:54",
            "flip_copy": "scripts/probe_flip.py:71"}


def mirror_plain(x, g=G):
    """Column i <- 2g-1-i and column cols-1-i <- cols-2g+i, the rest
    copied."""
    o = x.clone()
    o[:, :g] = torch.flip(x[:, g:2 * g], (1,))
    o[:, -g:] = torch.flip(x[:, -2 * g:-g], (1,))
    return o


def copy_plain(x):
    return x.clone()


def _flip(x, g, mirror, out):
    if x.device.type == "cpu":
        return mirror_plain(x, g) if mirror else copy_plain(x)
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"flip takes a contiguous 2-D float32 tensor; got "
                         f"{x.dtype} {tuple(x.shape)}")
    from ..ops import _build
    out = torch.empty_like(x) if out is None else out
    _build.launch_probe("probe_stream", "armon_flip", x.device, int(mirror),
                        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], g)
    count("flip_mirror" if mirror else "flip_copy")
    return out


def mirror_fill(x, g=G, out=None):
    """The mirror fill of `x` (a new tensor, or `out`)."""
    return _flip(x, g, True, out)


def copy(x, out=None):
    return _flip(x, G, False, out)


def _inputs(shape, device, seed):
    xh = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return xh, torch.from_numpy(xh).to(device)


def run(device="cuda", shapes=(SCRIPT_SHAPE, MAIN_SHAPE), seed=0, k=20):
    """Check the fill bit for bit against the script's numpy mirror and
    time copy and fill (and their plain versions) at each shape; prints
    and returns one row per shape."""
    dev = device_of(device)
    rows = []
    for shape in shapes:
        xh, x = _inputs(shape, dev, seed)
        ref = xh.copy()
        ref[:, :G] = xh[:, G:2 * G][:, ::-1]
        ref[:, -G:] = xh[:, -2 * G:-G][:, ::-1]
        bitwise = bool(np.array_equal(mirror_fill(x).cpu().numpy(), ref))
        out = torch.empty_like(x)
        ms = {"flip_copy": time_ms(lambda i: copy(x, out), dev, k),
              "flip_mirror": time_ms(lambda i: mirror_fill(x, G, out), dev, k)}
        plain = {"flip_copy": time_ms(lambda i: copy_plain(x), dev, 5),
                 "flip_mirror": time_ms(lambda i: mirror_plain(x), dev, 5)}
        # The copy is one PyTorch call; the mirror fill is not (`F.pad`
        # has no mode that repeats the edge column).
        library = {"flip_copy": shown(time_ms(lambda i: out.copy_(x), dev, k)),
                   "flip_mirror": None}
        b = bound(2 * x.numel() * 4)
        row = {"probe": "flip", "shape": list(shape), "bitwise": bitwise,
               "ms": {n: shown(v) for n, v in ms.items()},
               "plain_ms": {n: shown(v) for n, v in plain.items()},
               "library_ms": library,
               "fill_ms": shown(None if ms["flip_copy"] is None
                                else ms["flip_mirror"] - ms["flip_copy"]),
               "bound_ms": b[0], "bound_by": b[1]}
        if dev.type == "cuda":
            row["card"] = card_line()
        emit(row)
        rows.append(row)
        if not bitwise:
            raise AssertionError(f"mirror fill at {shape} differs from the "
                                 f"script's numpy mirror")
    return rows


def check(device="cuda", shapes=(SCRIPT_SHAPE, MAIN_SHAPE), seed=1):
    """Both kernels against their plain versions on the same inputs, bit
    for bit; returns the max abs difference by kernel."""
    dev = device_of(device)
    for shape in shapes:
        _, x = _inputs(shape, dev, seed)
        for name, fn, plain in (("flip_mirror", mirror_fill, mirror_plain),
                                ("flip_copy", copy, copy_plain)):
            if not torch.equal(fn(x), plain(x)):
                raise AssertionError(f"{name} at {shape} differs from its "
                                     f"plain version")
    return {"flip_mirror": 0.0, "flip_copy": 0.0}


def entries(rows, errs):
    """Kernels-line entries, at the main path's shape (the last row)."""
    r = rows[-1]
    return [kernel_entry(n, SOURCE, REPLACES[n], LAUNCHES.get(n, 0), errs[n],
                         r["ms"][n], r["plain_ms"][n],
                         (r["bound_ms"], r["bound_by"]), r["library_ms"][n])
            for n in ("flip_mirror", "flip_copy")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default="512x1024,8200x8200",
                    help="comma-separated ROWSxCOLS")
    args = ap.parse_args(argv)
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    return run(args.device, shapes)


if __name__ == "__main__":
    main()
