"""Global-domain boundary conditions.

Rebuild of the reference's ghost-cell BC kernel (`src/halo_exchange.jl:2-36`):
ghost cell k (counting from the border) mirrors real cell k, with the velocity
component normal to a Dirichlet wall negated via (u_factor, v_factor)
(`src/tests.jl:150-161`). Vectorized as a flip of the first/last `g` real
rows/columns.

Only the two sides along the current sweep axis are filled, exactly like the
reference (`src/halo_exchange.jl:323-344`): the orthogonal ghosts are stale
during a sweep but no kernel reads them (sweep stencils are 1D).
"""

import jax.numpy as jnp
import numpy as np

from ..utils.enums import Axis, Side, sides_along, is_first_side
from ..core.state import COMM_VARS


def mirror_slab(a, side: Side, g: int):
    """The g-wide slab of real cells adjacent to `side`, flipped so it fills
    the ghost band by mirror symmetry."""
    from ..utils.enums import axis_of
    ax = axis_of(side).array_axis
    if is_first_side(side):
        sl = [slice(None)] * a.ndim
        sl[ax] = slice(g, 2 * g)
        return jnp.flip(a[tuple(sl)], axis=ax)
    sl = [slice(None)] * a.ndim
    sl[ax] = slice(a.shape[ax] - 2 * g, a.shape[ax] - g)
    return jnp.flip(a[tuple(sl)], axis=ax)


def set_ghost_slab(a, side: Side, g: int, slab):
    """Write `slab` into the g-wide ghost band of `side`."""
    from ..utils.enums import axis_of
    ax = axis_of(side).array_axis
    sl = [slice(None)] * a.ndim
    if is_first_side(side):
        sl[ax] = slice(0, g)
    else:
        sl[ax] = slice(a.shape[ax] - g, a.shape[ax])
    return a.at[tuple(sl)].set(slab)


def _var_factor(var: str, u_factor, v_factor):
    if var == "u":
        return u_factor
    if var == "v":
        return v_factor
    return 1.0


def apply_side_bc(cfg, state, side: Side, vars=COMM_VARS):
    """Fill the ghost band of `side` for the given vars
    (`src/halo_exchange.jl:2-36`)."""
    T = np.dtype(cfg.dtype).type
    u_factor, v_factor = cfg.test.boundary_factors(side)
    g = cfg.nghost
    updates = {}
    for var in vars:
        a = getattr(state, var)
        f = _var_factor(var, u_factor, v_factor)
        slab = mirror_slab(a, side, g)
        if f != 1.0:
            slab = slab * T(f)
        updates[var] = set_ghost_slab(a, side, g, slab)
    return state._replace(**updates)


def boundary_conditions(cfg, state, axis: Axis, vars=COMM_VARS):
    """Single-device ghost exchange: both global borders along `axis`
    (`src/halo_exchange.jl:323-354`, global-boundary path)."""
    for side in sides_along(axis):
        state = apply_side_bc(cfg, state, side, vars)
    return state
