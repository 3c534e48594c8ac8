"""Code-quality gate — the analog of the reference's `quality` test set
(`test/code_quality.jl`: method-ambiguity detection, a Julia-specific
class). The Python equivalents: every module under armon_tpu imports
cleanly (no import-time side effects that require a device), and the
public API surface resolves."""

import importlib
import pkgutil

import pytest


def _iter_modules():
    import armon_tpu
    for m in pkgutil.walk_packages(armon_tpu.__path__,
                                   prefix="armon_tpu."):
        yield m.name


@pytest.mark.parametrize("name", sorted(_iter_modules()))
def test_module_imports(name):
    importlib.import_module(name)


def test_public_api_resolves():
    import armon_tpu
    for sym in ("ArmonParameters", "armon", "SolverStats", "Axis",
                "SolverException", "data_type", "memory_required",
                "device_to_host", "host_to_device"):
        assert hasattr(armon_tpu, sym), sym


def test_no_device_use_at_import(monkeypatch):
    """Importing the package must not touch jax.devices(): the device is
    decided by the entry point that runs, never at import (a device chosen
    at import would pin the backend for every importer, tests included)."""
    import subprocess
    import sys
    # A fresh interpreter with a poisoned jax.devices proves no module
    # calls it at import time.
    code = (
        "import jax\n"
        "def _boom(*a, **k): raise RuntimeError('devices() at import')\n"
        "jax.devices = _boom\n"
        "import armon_tpu\n"
        "import armon_tpu.core.solver, armon_tpu.core.step\n"
        "import armon_tpu.utils.compile_cache, armon_tpu.utils.device_info\n"
        "import armon_tpu.utils.xplane, armon_tpu.io.golden\n"
        "import armon_tpu.io.restart, armon_tpu.io.subdomain\n"
        "print('import-clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0 and "import-clean" in out.stdout, out.stderr
