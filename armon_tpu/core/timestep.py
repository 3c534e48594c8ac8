"""Global time-step logic.

Functional rebuild of the reference's `GlobalTimeStep` machinery
(`src/solver_state.jl:26-166`, `src/reductions.jl:113-199`):

- The dt used by cycle N was computed from the state at the *start* of cycle
  N-1 (the reference computes it "fully asynchronously", overlapping the MPI
  reduction with a whole cycle — `src/reductions.jl:117-125`). Cycles 0 and 1
  both use ``cfl * local_min(initial state)``.
- Growth is capped at +5% per cycle: ``dt_next = min(cfl*local, 1.05*dt)``
  (`src/solver_state.jl:129`).
- ``cst_dt`` short-circuits everything (`src/reductions.jl:131-133`).
- ``dt_on_even_cycles`` only recomputes on even cycles
  (`src/reductions.jl:135`).

On a device mesh the min-reduce is a `lax.pmin` over the mesh axes — the
XLA-scheduled equivalent of the hand-rolled non-blocking `MPI_Iallreduce`
(`src/utils.jl:126-143`); min is associative so the result is bit-identical.
The per-shard CFL minimum is an explicit reduction over the state at cycle
start (`armon_tpu.ops.reductions.dt_cfl_min`).
"""

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.reductions import dt_cfl_min, pmin_dt


def dt_update(cfg, local_min, dt_prev, cycle):
    """Apply the reference dt recurrence to this shard's CFL minimum.
    Returns (dt_use, dt_next, ok)."""
    T = np.dtype(cfg.dtype).type
    if cfg.cst_dt:
        dt = jnp.asarray(T(cfg.Dt))
        return dt, dt, jnp.asarray(True)

    if cfg.spmd:
        # Global min over the device mesh (replaces MPI_Iallreduce(MIN),
        # src/solver_state.jl:102-111)
        local_min = pmin_dt(local_min, cfg.axis_names)

    first = dt_prev == 0
    # KNOWN 1-ulp-class deviation (f32 only, only when the cap binds):
    # the reference computes `min(cfl*new_dt, 1.05*previous_dt)` with the
    # cap arm in Float64 (Julia literal promotion, src/solver_state.jl:129)
    # and one final conversion to T; here the cap arm rounds 1.05 and the
    # product in T. Matching it would need f64 scalar math, which f32 runs
    # don't enable (x64 off) — and an x64-conditional form would make two
    # f32 runs disagree with EACH OTHER depending on the x64 flag, a worse
    # trade. The f32 golden gates pass with this form.
    candidate = jnp.where(
        first,
        T(cfg.cfl) * local_min,
        jnp.minimum(T(cfg.cfl) * local_min, T(1.05) * dt_prev),
    )

    if cfg.dt_on_even_cycles:
        recompute = (cycle % 2 == 0) | first
        dt_next = jnp.where(recompute, candidate, dt_prev)
    else:
        dt_next = candidate

    dt_use = jnp.where(first, dt_next, dt_prev)
    ok = jnp.isfinite(dt_next) & (dt_next > 0)
    return dt_use, dt_next, ok


def next_time_step(cfg, state, dt_prev, cycle):
    """Compute the CFL minimum from the current state
    (the start-of-cycle state, `src/reductions.jl:164-199`) then update."""
    if cfg.cst_dt:
        return dt_update(cfg, None, dt_prev, cycle)
    if cfg.dt_on_even_cycles:
        # Skip the whole reduction on odd cycles like the reference
        # (`src/reductions.jl:135-137`) — except cycle 1, which still uses
        # the first-cycle seed path (dt_prev == 0).
        T = np.dtype(cfg.dtype).type

        def skip(_):
            ok = jnp.isfinite(dt_prev) & (dt_prev > 0)
            return jnp.asarray(dt_prev), jnp.asarray(dt_prev), ok

        def compute(state):
            return dt_update(cfg, dt_cfl_min(cfg, state), dt_prev, cycle)

        return lax.cond((cycle % 2 == 0) | (dt_prev == T(0.0)),
                        compute, skip, state)
    return dt_update(cfg, dt_cfl_min(cfg, state), dt_prev, cycle)
