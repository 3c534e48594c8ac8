"""Equations of state.

Vectorized rebuilds of the reference EOS kernels:
- perfect gas:  `src/kernels.jl:4-13`
- Bizarrium (Heuze/Jaouen/Jourdren, JCP 2009): `src/kernels.jl:16-55`

Scalar constants are materialized in the working dtype *before* any
arithmetic, matching the reference where every literal passes through ``T(x)``
— this is what makes the Float32 golden comparison meaningful.
"""

import jax.numpy as jnp
import numpy as np

from ..models.cases import Bizarrium


def perfect_gas_eos(gamma, rho, u, v, E, dtype):
    """p = (gamma-1)*rho*e, c = sqrt(gamma*p/rho), g = (1+gamma)/2
    (`src/kernels.jl:4-13`). Returns (p, c, g)."""
    T = np.dtype(dtype).type
    gm = T(gamma)
    e = E - 0.5 * (u ** 2 + v ** 2)
    p = (gm - T(1.0)) * rho * e
    c = jnp.sqrt(gm * p / rho)
    g = jnp.full_like(rho, (T(1.0) + gm) / T(2.0))
    return p, c, g


def bizarrium_eos(rho, u, v, E, dtype):
    """Stiffened non-convex EOS (`src/kernels.jl:16-55`). Returns (p, c, g)."""
    T = np.dtype(dtype).type
    rho0 = T(10000.0)
    K0 = T(1e11)
    Cv0 = T(1000.0)
    T0 = T(300.0)
    eps0 = T(0.0)
    G0 = T(1.5)
    s = T(1.5)
# The reference evaluates these ratios in Float64 and then converts to T
    # (`src/kernels.jl:33-34` via `@kernel_init` type annotations).
    q = T(-42080895.0 / 14941154.0)
    r = T(727668333.0 / 149411540.0)

    x = rho / rho0 - 1
    # G = G0 * (1 - rho0/rho)  (src/kernels.jl:38) — computed but unused below
    # except through epsk0.
    G = G0 * (1 - rho0 / rho)

    f0 = (1 + (s / 3 - 2) * x + q * x ** 2 + r * x ** 3) / (1 - s * x)
    f1 = (s / 3 - 2 + 2 * q * x + 3 * r * x ** 2 + s * f0) / (1 - s * x)
    f2 = (2 * q + 6 * r * x + 2 * s * f1) / (1 - s * x)
    f3 = (6 * r + 3 * s * f2) / (1 - s * x)

    epsk0 = eps0 - Cv0 * T0 * (1 + G) + 0.5 * (K0 / rho0) * x ** 2 * f0
    pk0 = -Cv0 * T0 * G0 * rho0 + 0.5 * K0 * x * (1 + x) ** 2 * (2 * f0 + x * f1)
    pk0prime = -0.5 * K0 * (1 + x) ** 3 * rho0 * (
        2 * (1 + 3 * x) * f0 + 2 * x * (2 + 3 * x) * f1 + x ** 2 * (1 + x) * f2)
    pk0second = 0.5 * K0 * (1 + x) ** 4 * rho0 ** 2 * (
        12 * (1 + 2 * x) * f0 + 6 * (1 + 6 * x + 6 * x ** 2) * f1
        + 6 * x * (1 + x) * (1 + 2 * x) * f2 + x ** 2 * (1 + x) ** 2 * f3)

    e = E - 0.5 * (u ** 2 + v ** 2)
    p = pk0 + G0 * rho0 * (e - epsk0)
    c = jnp.sqrt(G0 * rho0 * (p - pk0) - pk0prime) / rho
    g = 0.5 / (rho ** 3 * c ** 2) * (pk0second + (G0 * rho0) ** 2 * (p - pk0))
    return p, c, g


def update_eos(cfg, state):
    """Dispatch by test case (`src/kernels.jl:151-166`), computed on the full
    padded array — ghost values are overwritten by the boundary exchange
    before any kernel reads them (see `armon_tpu.ops.shifts`)."""
    if isinstance(cfg.test, Bizarrium):
        p, c, g = bizarrium_eos(state.rho, state.u, state.v, state.E, cfg.dtype)
    else:
        p, c, g = perfect_gas_eos(cfg.gamma, state.rho, state.u, state.v,
                                  state.E, cfg.dtype)
    return state._replace(p=p, c=c, g=g)
