"""Acoustic Riemann solvers.

Vectorized rebuilds of `src/riemann_schemes.jl`:
- two-point acoustic solver `acoustic_Godunov`:  `src/riemann_schemes.jl:21-30`
- 1st-order flux kernel `acoustic!`:             `src/riemann_schemes.jl:33-43`
- 2nd-order GAD kernel `acoustic_GAD!`:          `src/riemann_schemes.jl:55-104`

The data-dependent upwinding of the reference becomes `jnp.where` selects over
pre-shifted arrays — no gathers, fully fused by XLA.
"""

import numpy as np

from ..utils.enums import Axis
from .shifts import sh
from .limiters import limiter_from_name


def acoustic_godunov(rho_i, rho_im, c_i, c_im, u_i, u_im, p_i, p_im):
    """Two-point acoustic solver (`src/riemann_schemes.jl:21-30`).
    Returns (ustar, pstar) at the i-1/2 interface."""
    rc_l = rho_im * c_im
    rc_r = rho_i * c_i
    ustar = (rc_l * u_im + rc_r * u_i + (p_im - p_i)) / (rc_l + rc_r)
    pstar = (rc_r * p_im + rc_l * p_i + rc_l * rc_r * (u_im - u_i)) / (rc_l + rc_r)
    return ustar, pstar


def acoustic(axis: Axis, rho, uax, p, c):
    """1st-order fluxes (`src/riemann_schemes.jl:33-43`)."""
    return acoustic_godunov(
        rho, sh(rho, -1, axis), c, sh(c, -1, axis),
        uax, sh(uax, -1, axis), p, sh(p, -1, axis),
    )


def acoustic_gad(axis: Axis, dt, dx, rho, uax, p, c, limiter_name, dtype):
    """2nd-order GAD fluxes with limiter theta-blend
    (`src/riemann_schemes.jl:55-104`)."""
    T = np.dtype(dtype).type
    lim = limiter_from_name(limiter_name)

    rho_m = sh(rho, -1, axis)
    c_m = sh(c, -1, axis)
    u_m = sh(uax, -1, axis)
    p_m = sh(p, -1, axis)

    # First-order solve on the current (i-1/2) interface; the left/right
    # interface solves are the SAME elementwise map on shifted inputs, and
    # `sh` (jnp.roll) is a permutation, which commutes exactly with
    # elementwise math — deriving them by shifting is bitwise identical
    # everywhere while removing 2 of the 3 Godunov solves.
    us_i, ps_i = acoustic_godunov(rho, rho_m, c, c_m, uax, u_m, p, p_m)
    us_im, ps_im = sh(us_i, -1, axis), sh(ps_i, -1, axis)
    us_ip, ps_ip = sh(us_i, 1, axis), sh(ps_i, 1, axis)

    # Slope ratios (src/riemann_schemes.jl:84-87); the +1e-6 guard is part of
    # the reference scheme.
    eps = T(1e-6)
    r_um = (us_ip - uax) / (us_i - u_m + eps)
    r_pm = (ps_ip - p) / (ps_i - p_m + eps)
    r_up = (u_m - us_im) / (uax - us_i + eps)
    r_pp = (p_m - ps_im) / (p - ps_i + eps)

    r_um = lim(r_um)
    r_pm = lim(r_pm)
    r_up = lim(r_up)
    r_pp = lim(r_pp)

    dm_l = rho_m * dx
    dm_r = rho * dx
    Dm = (dm_l + dm_r) / 2

    rc_l = rho_m * c_m
    rc_r = rho * c
    theta = T(0.5) * (1 - (rc_l + rc_r) / 2 * (dt / Dm))

    ustar = us_i + theta * (r_up * (uax - us_i) - r_um * (us_i - u_m))
    pstar = ps_i + theta * (r_pp * (p - ps_i) - r_pm * (ps_i - p_m))
    return ustar, pstar


def numerical_fluxes(cfg, state, axis: Axis, dt):
    """Scheme dispatch (`src/riemann_schemes.jl:46-52,107-117`). Returns the
    state with updated (ustar, pstar)."""
    uax = state.u if axis is Axis.X else state.v
    if cfg.riemann == "Godunov":
        ustar, pstar = acoustic(axis, state.rho, uax, state.p, state.c)
    elif cfg.riemann == "GAD":
        dx = np.dtype(cfg.dtype).type(cfg.cell_size(axis))
        ustar, pstar = acoustic_gad(axis, dt, dx, state.rho, uax, state.p,
                                    state.c, cfg.limiter, cfg.dtype)
    else:
        raise ValueError(f"Unknown Riemann scheme: {cfg.riemann}")
    return state._replace(ustar=ustar, pstar=pstar)
