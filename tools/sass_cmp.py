"""The kernels' SASS in two trees, function by function.

    python3 tools/sass_cmp.py <parent tree> <tree>

Builds each tree's kernels (`armon_torch.ops._build.load()`, in a child
process run from that tree) and prints, for K3 (`cfl`), K4 (`cycle_f*`),
K5 (`multicycle_f*`) and each probe library, how many of its kernel
functions have the same SASS in both trees, naming those that differ; K1
and K2 (`sweep_f*`) are listed after them, for information. A change
that must leave those kernels as they were (a redesign of K1 and K2 in
`sweep.cuh`, a probe-only template parameter) should print every
function identical. K4's instances carry the probe
variant parameter in their mangled names (`...ELi64ELi0EE`) where the
tree has it; it is dropped before the names are compared. Needs the CUDA
toolkit (nvcc, cuobjdump).
"""

import glob
import hashlib
import os
import re
import shutil
import subprocess
import sys

STEMS = ("cfl", "cycle_f32", "cycle_f64", "multicycle_f32", "multicycle_f64",
         "probe_stream", "probe_ff", "probe_rates", "probe_cycle")
INFO = ("sweep_f32", "sweep_f64")
CUOBJDUMP = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def build(tree):
    subprocess.run([sys.executable, "-c",
                    "from armon_torch.ops import _build; _build.load()"],
                   cwd=tree, check=True)


def functions(tree, stem):
    """{kernel function name: hash of its SASS} of the newest library
    built from source `stem` in `tree`."""
    libs = glob.glob(os.path.join(tree, "build", "armon_torch", f"lib{stem}_*.so"))
    lib = max(libs, key=os.path.getmtime)
    text = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        name = re.sub(r"ELi64ELi0EE", "ELi64EE", name.strip())
        out[name] = hashlib.sha256(body.encode()).hexdigest()[:12]
    return out


def main(argv=None):
    parent, tree = (argv or sys.argv[1:])[:2]
    for t in (parent, tree):
        build(t)
    same_all = True
    for stem in STEMS + INFO:
        a, b = functions(parent, stem), functions(tree, stem)
        differ = sorted(k for k in a if a[k] != b.get(k))
        if stem in STEMS:
            same_all &= not differ
        print(f"{stem}: {len(a) - len(differ)}/{len(a)} functions with the "
              f"same SASS", differ or "")
    print("sass_cmp:", "all identical" if same_all else "some differ",
          f"({', '.join(STEMS)})")


if __name__ == "__main__":
    main()
