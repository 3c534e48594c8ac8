"""What the measuring entry points say about the device they ran on.

Every measurement names its device: JAX's view (`platform`, `device_kind`,
device count) and the card's own (`nvidia-smi` name and power limit — a
card set below its maximum power runs slower under load). A measurement
that finds no GPU fails; it does not fall back to the CPU.
"""

import subprocess


def card_lines():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output lines, or [] when nvidia-smi is missing or fails. Run it before
    JAX initializes its backend, from a process that stays off the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


class NoGPUError(RuntimeError):
    pass


def require_gpu():
    """JAX's device description {"platform", "kind", "count"}; raises
    NoGPUError unless JAX's first device is a GPU."""
    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise NoGPUError(f"JAX found no GPU (first device: {dev.platform} "
                         f"{dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}
