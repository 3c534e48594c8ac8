"""Solver state: a pytree of 2D field arrays.

The reference stores 16 SoA variables per block (`src/blocking/blocks.jl:18-47`:
x, y, rho, u, v, E, p, c, g, ustar, pstar, work_1..4, mask). Here the four
work arrays (advection fluxes) are transient values inside the sweep, which
XLA fuses without materializing them, and the ghost mask is a static slice, so the state is the
11 physical fields only.

All fields have shape ``(ny + 2*nghost, nx + 2*nghost)`` — the full padded
(sub-)domain, ghost cells included. Indexing is ``[j, i]`` with X contiguous
in memory.

Variable subsets (`src/blocking/blocks.jl:48-50`):
- ``MAIN_VARS``:  synced host<->device / compared in tests
- ``SAVED_VARS``: written to output files (x, y, rho, u, v, p)
- ``COMM_VARS``:  exchanged in halos (rho, u, v, E, p, c, g)
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


class State(NamedTuple):
    x: jax.Array      # position of the cell's bottom-left corner
    y: jax.Array
    rho: jax.Array    # density
    u: jax.Array      # X velocity
    v: jax.Array      # Y velocity
    E: jax.Array      # total energy
    p: jax.Array      # pressure
    c: jax.Array      # sound speed
    g: jax.Array      # EOS fundamental derivative (computed for parity; unused by the scheme)
    ustar: jax.Array  # interface velocity (Riemann flux)
    pstar: jax.Array  # interface pressure (Riemann flux)


MAIN_VARS = ("x", "y", "rho", "u", "v", "E", "p", "c", "g")
SAVED_VARS = ("x", "y", "rho", "u", "v", "p")
COMM_VARS = ("rho", "u", "v", "E", "p", "c", "g")


def zeros_state(shape, dtype) -> State:
    z = jnp.zeros(shape, dtype)
    return State(*([z] * len(State._fields)))
