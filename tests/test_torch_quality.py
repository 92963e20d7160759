"""Code-quality gate of the port, the counterpart of the JAX package's
`tests/test_quality.py`: every module under `armon_torch` imports, the
public API resolves, and no import touches the card or pulls in JAX."""

import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_modules():
    import armon_torch
    for m in pkgutil.walk_packages(armon_torch.__path__,
                                   prefix="armon_torch."):
        yield m.name


@pytest.mark.parametrize("name", sorted(_iter_modules()))
def test_module_imports(name):
    """`tests/test_quality.py:21-23`."""
    importlib.import_module(name)


def test_public_api_resolves():
    """The names of `tests/test_quality.py:26-31`."""
    import armon_torch
    for sym in ("ArmonParameters", "armon", "SolverStats", "Axis",
                "SolverException", "data_type", "memory_required",
                "device_to_host", "host_to_device"):
        assert hasattr(armon_torch, sym), sym


def test_no_card_use_at_import():
    """`tests/test_quality.py:33-50`: a fresh interpreter whose
    `torch.cuda.init` and `torch.cuda._lazy_init` raise imports the
    package and its entry points; after that no CUDA context exists and
    neither `jax` nor `armon_tpu` was loaded. A CUDA call at import would
    make `import armon_torch` need a card."""
    code = (
        "import sys, torch\n"
        "def _boom(*a, **k): raise RuntimeError('CUDA init at import')\n"
        "torch.cuda.init = _boom\n"
        "torch.cuda._lazy_init = _boom\n"
        "import armon_torch\n"
        "import armon_torch.core.solver, armon_torch.core.step\n"
        "import armon_torch.core.graphs, armon_torch.ops.sweep\n"
        "import armon_torch.ops.cycle, armon_torch.ops._build\n"
        "import armon_torch.io.restart, armon_torch.io.subdomain\n"
        "import armon_torch.parallel.dist, armon_torch.fuzz\n"
        "import armon_torch.kernel_fuzz, armon_torch.entry\n"
        "import armon_torch.probes\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'armon_tpu')]\n"
        "assert not bad, bad\n"
        "print('import-clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0 and "import-clean" in out.stdout, out.stderr
