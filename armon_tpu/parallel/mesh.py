"""Device mesh construction and sharding specs.

Replacement for the reference's MPI cartesian topology
(`src/parameters.jl:408-467`): the process grid `P=(px,py)` becomes a 2D
`jax.sharding.Mesh` with axes ("px", "py"), a plain reshape of the device
list. The reference's `reorder_grid` (letting MPI optimize rank placement)
has nothing to choose: every device reaches every other at the same rate,
so the option is accepted and has no effect.

State layout under SPMD: every device owns a *padded* block
(ny_loc+2g, nx_loc+2g). The global on-host array therefore has shape
(py*(ny_loc+2g), px*(nx_loc+2g)) in "blocked" layout — the direct analog of
the reference's per-rank sub-domain arrays. `shard_map` over the mesh gives
each program its own block.
"""

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(proc_dims, axis_names=("px", "py"), devices=None):
    """Build a (px, py) mesh over the first px*py devices, in the given
    order (`MPI.Cart_create`, `src/parameters.jl:432-448`): device
    k = by*px + bx owns block (bx, by)."""
    px, py = proc_dims
    if devices is None:
        devices = jax.devices()
    n = px * py
    if len(devices) < n:
        from ..utils.errors import solver_error
        solver_error("config",
                     f"mesh {px}x{py} needs {n} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(py, px)
    # Mesh axes ordered (py, px) to match the (rows, cols) array layout.
    return Mesh(dev_array, (axis_names[1], axis_names[0]))


def shard_state_spec(axis_names=("px", "py")):
    """PartitionSpec for the blocked state arrays: rows over py, cols over px."""
    return P(axis_names[1], axis_names[0])
