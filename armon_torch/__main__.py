"""Command-line front-end: ``python -m armon_torch [key=value ...]``
(`armon_tpu/__main__.py`).

The same option space as `ArmonParameters`, from the shell; values are
parsed as Python literals when possible. Runs on the CUDA card unless
``device=cpu`` is given.

Examples:
    python -m armon_torch test=Sod N=1024,1024 maxcycle=10 silent=4
    python -m armon_torch test=Sedov data_type=float32 device=cpu \\
        write_output=true output_file=sedov.csv
"""

import ast
import sys

from .params import ArmonParameters
from .core.solver import armon


def _parse(value: str):
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        # numbers and tuples in any spelling: 100, 1e-4, 50,50, (50,50),
        # [50,50]
        v = ast.literal_eval(value)
        return tuple(v) if isinstance(v, list) else v
    except (ValueError, SyntaxError):
        pass
    if "," in value:
        return tuple(_parse(v) for v in value.strip("()[]").split(","))
    return value


def options(argv):
    """{key: value} of `key=value` arguments, values as `_parse` reads
    them (the example scripts take their overrides so); ValueError names
    an argument without `=`."""
    out = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value, got '{arg}'")
        key, value = arg.split("=", 1)
        out[key] = _parse(value)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    try:
        opts = options(argv)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    params = ArmonParameters(**opts)
    stats = armon(params)
    if params.silent < 5:
        print(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
