"""Initial condition kernel.

Rebuild of the reference `init_test` kernel (`src/kernels.jl:106-145,176-214`):
cell corner positions from the global index, two-state initialization on cell
centers, work variables zeroed. The NUMA first-touch logic
(`src/kernels.jl:193-206`) has no equivalent (device memory is uniform) and is
intentionally dropped (SURVEY.md §2.3.4).
"""

import jax.numpy as jnp
import numpy as np

from ..core.state import State
from ..models.cases import DebugIndexes, TestCase


def init_state(cfg, global_pos=(0, 0)) -> State:
    """Build the initial state of one padded (sub-)domain.

    `global_pos` is the 0-based global-grid index of the first *real* cell of
    this sub-domain (the reference's `N_origin - 1`, `src/parameters.jl:727`).
    Ghost cells get the analytic values of their global position, exactly like
    the reference (`src/kernels.jl:118-144` runs on the full block domain).
    """
    T = np.dtype(cfg.dtype).type
    g = cfg.nghost
    ny_tot, nx_tot = cfg.local_shape
    dx, dy = T(cfg.dx), T(cfg.dy)
    ox, oy = T(cfg.origin[0]), T(cfg.origin[1])

    # Global 0-based cell index of every cell (ghosts included)
    gi = jnp.arange(-g, nx_tot - g, dtype=jnp.int32) + global_pos[0]
    gj = jnp.arange(-g, ny_tot - g, dtype=jnp.int32) + global_pos[1]
    gI, gJ = jnp.meshgrid(gi, gj)  # (ny_tot, nx_tot)

    # Cell corner position (src/kernels.jl:125)
    x = gI * dx + ox
    y = gJ * dy + oy

    zeros = jnp.zeros((ny_tot, nx_tot), cfg.dtype)

    test: TestCase = cfg.test
    if isinstance(test, DebugIndexes):
        # Every var = 1-based global linear index (src/kernels.jl:93-103,136)
        nx_glob = cfg.n_global[0]
        lin = (gI + gJ * nx_glob + 1).astype(cfg.dtype)
        return State(x=x, y=y, rho=lin, u=lin, v=lin, E=lin, p=lin, c=lin,
                     g=lin, ustar=zeros, pstar=zeros)

    # Cell center (src/kernels.jl:131)
    mid_x = x + dx / 2
    mid_y = y + dy / 2

    ip = test.init_params()
    high = test.region_high(mid_x, mid_y)
    rho = jnp.where(high, T(ip.high_rho), T(ip.low_rho))
    E = jnp.where(high, T(ip.high_E), T(ip.low_E))
    u = jnp.where(high, T(ip.high_u), T(ip.low_u))
    v = jnp.where(high, T(ip.high_v), T(ip.low_v))

    # p, c, g zeroed (src/kernels.jl:87-89); work vars zeroed (src/kernels.jl:142-144)
    return State(x=x, y=y, rho=rho, u=u, v=v, E=E,
                 p=zeros, c=zeros, g=zeros, ustar=zeros, pstar=zeros)
