"""The solver schedule: sweep, cycle, jitted time loop.

This is the driver core replacing `src/solver.jl:288-403`. The reference's
per-block async state machine (`src/solver.jl:58-179`) exists to keep x86
cores busy and caches warm; under XLA one jitted cycle in a
`lax.while_loop` gives the same overlap (kernel fusion, async collectives)
with a statically compiled schedule (SURVEY.md §3.3 note).

Numerical schedule per sweep (`src/solver.jl:300-317`):
    EOS -> ghost exchange -> Riemann fluxes -> cell update -> remap
"""

import numpy as np

import jax.numpy as jnp
from jax import lax

from ..utils.enums import Axis
from ..ops.eos import update_eos
from ..ops.boundary import boundary_conditions
from ..ops.riemann import numerical_fluxes
from ..ops.update import cell_update
from ..ops.projection import projection_remap
from .splitting import split_schedules
from .timestep import next_time_step


def ghost_exchange(cfg, state, axis: Axis, vars=None):
    from ..core.state import COMM_VARS
    vars = COMM_VARS if vars is None else vars
    if cfg.spmd:
        from ..parallel.halo import halo_exchange
        return halo_exchange(cfg, state, axis, vars)
    return boundary_conditions(cfg, state, axis, vars)


def sweep(cfg, state, axis: Axis, dt):
    """One dimensional sweep with the (already dt_factor-scaled) time step."""
    state = update_eos(cfg, state)
    state = ghost_exchange(cfg, state, axis)
    state = numerical_fluxes(cfg, state, axis, dt)
    state = cell_update(cfg, state, axis, dt)
    state = projection_remap(cfg, state, axis, dt)
    return state


def run_schedule(cfg, state, schedule, dt):
    T = np.dtype(cfg.dtype).type
    for axis, factor in schedule:
        # state.dt = current_dt * dt_factor (src/solver_state.jl:342)
        state = sweep(cfg, state, axis, dt * T(factor))
    return state


def solver_cycle(cfg, state, dt_prev, cycle):
    """One full cycle. Returns (state, dt_used, dt_next_carry, ok)."""
    dt_use, dt_next, ok = next_time_step(cfg, state, dt_prev, cycle)
    even, odd = split_schedules(cfg.splitting)
    if even == odd:
        state = run_schedule(cfg, state, even, dt_use)
    else:
        state = lax.cond(
            cycle % 2 == 0,
            lambda s: run_schedule(cfg, s, even, dt_use),
            lambda s: run_schedule(cfg, s, odd, dt_use),
            state,
        )
    return state, dt_use, dt_next, ok


def make_time_loop(cfg, restore=False):
    """Build the fully-jitted time loop (`src/solver.jl:323-403` hot path):
    (state, t0, cycle0, dt0) -> (state, t, cycles, last_dt, ok).

    The returned function contains the whole run as a single XLA program:
    while (t < maxtime && cycle < maxcycle) { cycle(); }. With
    `restore=True` the cycle-0 EOS init is skipped — the carry scalars come
    from a checkpoint and `state.c` already holds the sound speed of the
    interrupted run, which reseeds the time step exactly.
    """
    T = np.dtype(cfg.dtype).type
    maxtime = T(cfg.maxtime)
    maxcycle = np.int32(cfg.maxcycle)

    def cond(carry):
        _, t, cycle, _, ok = carry
        return (t < maxtime) & (cycle < maxcycle) & ok

    def body(carry):
        state, t, cycle, dt_prev, _ = carry
        state, dt_use, dt_next, ok = solver_cycle(cfg, state, dt_prev, cycle)
        # next_cycle!: cycle += 1; time += current_dt (src/solver_state.jl:145-147)
        return (state, t + dt_use, cycle + 1, dt_next, ok)

    def loop(state, t0=None, cycle0=None, dt0=None):
        t0 = T(0.0) if t0 is None else t0
        cycle0 = np.int32(0) if cycle0 is None else cycle0
        dt0 = T(0.0) if dt0 is None else dt0
        if cfg.maxcycle > 0 and not restore:
            # Cycle-0 "EOS_init" (src/solver.jl:291-295), hoisted out of the loop.
            state = update_eos(cfg, state)
        carry = (state, t0, cycle0, dt0, jnp.asarray(True))
        return lax.while_loop(cond, body, carry)

    return loop
