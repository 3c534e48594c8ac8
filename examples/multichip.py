"""Domain decomposition over a device mesh.

On a multi-GPU host this shards the domain over all cards; without
accelerators run it with virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
    JAX_PLATFORMS=cpu python examples/multichip.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    jax.config.update("jax_platforms", "cpu")

from armon_tpu import ArmonParameters, armon

n = len(jax.devices())
px = max(1, int(n ** 0.5))
while n % px:
    px -= 1
py = n // px
print(f"devices: {n} -> mesh {px}x{py}")

params = ArmonParameters(
    test="Sod_circ", N=(400 * px, 400 * py), data_type="float32",
    P=(px, py), maxcycle=100, silent=1, check_result=True,
)
print(armon(params))
