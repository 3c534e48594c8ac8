"""Test configuration: run everything on a virtual 8-device CPU mesh with
x64 enabled — multi-device sharding is validated without an accelerator,
exactly as the reference oversubscribes MPI ranks on one node
(`test/mpi.jl:133-141`).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from armon_tpu.io.golden import (abs_tol, rel_tol,  # noqa: E402,F401
                                 golden_params as reference_params,
                                 golden_file as ref_file)
