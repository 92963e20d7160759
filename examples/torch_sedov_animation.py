"""Sedov blast wave with animation frames (gnuplot pm3d compatible) on the
PyTorch/CUDA port (the port of `examples/sedov_animation.py`).

    python examples/torch_sedov_animation.py              # on the CUDA card
    python examples/torch_sedov_animation.py device=cpu   # on the CPU
    gnuplot -e "set pm3d map; splot 'anim/sedov_010' u 1:2:3" -p

Each `key=value` argument overrides an option below (e.g. `N=64,64`,
`maxcycle=30`), as `python -m armon_torch` reads it. Without a card and
without `device=cpu` it raises.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from armon_torch import ArmonParameters, armon
from armon_torch.__main__ import options

DEFAULTS = dict(test="Sedov", N=(500, 500), data_type="float32",
                maxcycle=600, animation_step=50, write_output=True,
                output_file="sedov", silent=2)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    stats = armon(ArmonParameters(**{**DEFAULTS, **options(argv)}))
    print(stats)
    print("frames under ./anim/, final state in ./sedov")
    return stats


if __name__ == "__main__":
    main()
