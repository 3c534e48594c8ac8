"""The measuring entry points (`chip_smoke.py`, `bench.py`) and the
compile-cache placement they share with `python -m armon_tpu`.

Without a GPU both entry points must fail and print no measurement: a
number from the CPU is never reported as a device number.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    full.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_placement(env_set, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and nothing else is
    set in code; without it, the cache is `<checkout>/.jax_cache`."""
    code = ("import jax\n"
            "from armon_tpu.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    env = {}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    if not env_set:
        full.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(full, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()[-2:]
    want = str(tmp_path / "cache") if env_set else \
        os.path.join(ROOT, ".jax_cache")
    assert returned == configured == want


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No GPU (or no repo beside the script): exit non-zero, no ok line."""
    cwd = ROOT
    script = "chip_smoke.py"
    if where == "alone":
        shutil.copy(os.path.join(ROOT, script), tmp_path / script)
        cwd = str(tmp_path)
    out = _run([script], cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if where == "checkout":
        assert "no GPU" in out.stderr


def test_bench_fails_without_gpu():
    out = _run(["bench.py", "--n", "16", "--cycles", "2"])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            assert "value" not in json.loads(line)
