"""Domain decomposition over a mesh of shards on the PyTorch/CUDA port
(the port of `examples/multichip.py`): Sod_circ, 400^2 cells a shard.

    python examples/torch_multichip.py                  # a shard on every card
    python examples/torch_multichip.py shards=4         # 4 shards on cuda:0
    python examples/torch_multichip.py device=cpu shards=8   # 8 CPU shards

The mesh is the near-square (px, py) of the shard count: on the card,
one shard on each of `torch.cuda.device_count()` cards unless `shards=n`
is given, which puts n shards on one device; on the CPU, `shards`
defaults to 8 (the JAX script's virtual devices). `per_shard=n` sets
the cells of a shard's side; every other `key=value` argument overrides
an option below, as `python -m armon_torch` reads it. Without a card and
without `device=cpu` it raises.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from armon_torch import ArmonParameters, armon
from armon_torch.__main__ import options
from armon_torch.entry import mesh_of
from armon_torch.params import resolve_device

DEFAULTS = dict(test="Sod_circ", data_type="float32", maxcycle=100,
                silent=1, check_result=True)
PER_SHARD = 400
CPU_SHARDS = 8


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    opts = options(argv)
    shards = opts.pop("shards", None)
    per_shard = opts.pop("per_shard", PER_SHARD)
    dev = resolve_device(opts.get("device", "cuda"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if shards is None and dev.type == "cuda":
        n, devices = torch.cuda.device_count(), None
    else:
        n = shards or CPU_SHARDS
        devices = [dev] * n
    px, py = mesh_of(n)
    print(f"devices: {n} -> mesh {px}x{py}")
    params = ArmonParameters(**{**DEFAULTS, "N": (per_shard * px,
                                                  per_shard * py),
                                "P": (px, py), **opts,
                                **({"devices": devices} if devices else {})})
    stats = armon(params)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
