"""Sod shock tube on the PyTorch/CUDA port: run to t=0.2 and dump the 1D
density/pressure profile (the port of `examples/sod_profile.py`).

    python examples/torch_sod_profile.py              # on the CUDA card
    python examples/torch_sod_profile.py device=cpu   # on the CPU
    gnuplot -p -e "plot 'sod_X_slice' u 1:3 w l t 'rho', '' u 1:6 w l t 'p'"

Each `key=value` argument overrides an option below (e.g. `N=64,64`,
`output_dir=out`), as `python -m armon_torch` reads it. Without a card
and without `device=cpu` it raises.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from armon_torch import ArmonParameters, armon
from armon_torch.__main__ import options

DEFAULTS = dict(test="Sod", N=(400, 400), data_type="float32",
                write_slices=True, output_file="sod", silent=1,
                check_result=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    stats = armon(ArmonParameters(**{**DEFAULTS, **options(argv)}))
    print(stats)
    print("profiles written: sod_X_slice / sod_Y_slice / sod_D_slice")
    return stats


if __name__ == "__main__":
    main()
