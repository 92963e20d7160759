"""The kernels' SASS in two trees, function by function.

    python3 tools/sass_cmp.py <parent tree> <tree> [--changed STEM,...]
    python3 tools/sass_cmp.py build/parent . --changed multicycle_f32,multicycle_f64

Builds each tree's kernels (`armon_torch.ops._build.load()`, in a child
process run from that tree) and prints, for every library (K1/K2
`sweep_f*`, K3 `cfl`, K4 `cycle_f*`, K5 `multicycle_f*`, the probes',
K6 `reduce`), how many of its kernel functions have the same SASS in
both trees,
naming those that differ, and how many functions only the tree has (a
new kernel, such as a finishing launch's). The libraries named by `--changed` (those the
change redesigns) are listed after the others, for information; every
other one must be identical (a library new in the tree is named as
such), and the last line says whether it is. K4's instances carry the
probe variant parameter in their mangled names (`...ELi64ELi0EE`) where
the tree has it; it is dropped before the names are compared. Needs the
CUDA toolkit (nvcc, cuobjdump).
"""

import glob
import hashlib
import os
import re
import shutil
import subprocess
import sys

STEMS = ("sweep_f32", "sweep_f64", "cfl", "cycle_f32", "cycle_f64",
         "multicycle_f32", "multicycle_f64", "probe_stream", "probe_ff",
         "probe_rates", "probe_cycle", "probe_cluster", "reduce")
CUOBJDUMP = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def build(tree):
    subprocess.run([sys.executable, "-c",
                    "from armon_torch.ops import _build; _build.load()"],
                   cwd=tree, check=True)


def functions(tree, stem):
    """{kernel function name: (hash of its SASS, its opcodes)} of the
    newest library built from source `stem` in `tree`; None where the tree
    has no such source."""
    libs = glob.glob(os.path.join(tree, "build", "armon_torch", f"lib{stem}_*.so"))
    if not libs:
        return None
    lib = max(libs, key=os.path.getmtime)
    text = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        name = re.sub(r"ELi64ELi0EE", "ELi64EE", name.strip())
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        out[name] = (hashlib.sha256(body.encode()).hexdigest()[:12], ops)
    return out


def _describe(a, b):
    """How two functions' SASS differ: in operands only (the same opcodes
    in the same order: registers, constant-bank offsets, addresses), or in
    their instructions."""
    if a[1] == b[1]:
        return "operands only"
    return f"{len(a[1])} -> {len(b[1])} instructions"


def main(argv=None):
    args = list(argv or sys.argv[1:])
    changed = ()
    if "--changed" in args:
        i = args.index("--changed")
        changed = tuple(args[i + 1].split(","))
        del args[i:i + 2]
    unknown = set(changed) - set(STEMS)
    if len(args) != 2 or unknown:
        sys.exit(__doc__ + (f"\nunknown stems: {sorted(unknown)}" if unknown else ""))
    parent, tree = args
    for t in (parent, tree):
        build(t)
    held = [s for s in STEMS if s not in changed]
    same_all = True
    for stem in held + list(changed):
        a, b = functions(parent, stem), functions(tree, stem)
        if a is None or b is None:  # a library one tree does not build
            print(f"{stem}: only in {tree if a is None else parent}")
            same_all &= a is None or stem in changed
            continue
        differ = sorted(k for k in a if k not in b or a[k][0] != b[k][0])
        new = len(set(b) - set(a))
        if stem in held:
            same_all &= not differ
        print(f"{stem}{' (changed)' if stem in changed else ''}: "
              f"{len(a) - len(differ)}/{len(a)} functions with the same SASS"
              + (f", {new} only in the tree" if new else ""),
              [f"{k} ({_describe(a[k], b[k]) if k in b else 'missing'})"
               for k in differ] or "")
    print("sass_cmp:", "all identical" if same_all else "some differ",
          f"({', '.join(held)})")
    sys.exit(0 if same_all else 1)


if __name__ == "__main__":
    main()
