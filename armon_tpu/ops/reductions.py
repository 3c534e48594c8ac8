"""Global reductions: CFL time step and conservation variables.

Rebuild of `src/reductions.jl`:
- per-cell CFL bound min(dx/|u±c|, dy/|v±c|):  `src/reductions.jl:2-20`
- grid min + (MPI) min-reduce:                 `src/reductions.jl:91-199`
- mass/energy sums scaled by the cell area:    `src/reductions.jl:202-323`

The reference masks ghost cells (`mask`); here the real domain is a static
slice of the padded array. The min-reduction is order-independent, so the
XLA tree reduction is bit-identical to the reference's sequential loop. The
conservation sums use pairwise reduction (more accurate than sequential);
they feed tolerance checks only (`src/solver.jl:478-487`).

On a device mesh these become `lax.pmin` / `lax.psum` over the mesh axes —
the equivalent of the reference's `MPI_Iallreduce(MIN)`
(`src/utils.jl:126-143`) and `MPI.Allreduce(SUM)` (`src/reductions.jl:318-320`).
"""

import jax
import jax.numpy as jnp
import numpy as np


def real_slice(cfg):
    g = cfg.nghost
    return (slice(g, -g), slice(g, -g))


def shard_real_extents(cfg):
    """Traced (nx_real, ny_real) of THIS shard. For an uneven split the
    hi-edge shard owns only n_edge real cells; the rest of its padded block
    is dead slack (`src/parameters.jl:673-697` analog). Must be called
    inside shard_map when cfg.spmd."""
    from jax import lax
    nx, ny = cfg.n_local
    if not cfg.spmd:
        return np.int32(nx), np.int32(ny)
    ex, ey = cfg.edge_cells
    nx_r = jnp.where(lax.axis_index(cfg.axis_names[0])
                     == cfg.proc_dims[0] - 1, np.int32(ex), np.int32(nx))
    ny_r = jnp.where(lax.axis_index(cfg.axis_names[1])
                     == cfg.proc_dims[1] - 1, np.int32(ey), np.int32(ny))
    return nx_r, ny_r


def _real_mask(cfg, shape):
    """Boolean mask of the real cells in a padded (rows, cols) shard block;
    accounts for edge-shard slack under an uneven split."""
    g = cfg.nghost
    nx_r, ny_r = shard_real_extents(cfg)
    rows = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return ((rows >= g) & (rows < g + ny_r) & (cols >= g) & (cols < g + nx_r))


def _uneven(cfg):
    return cfg.spmd and (cfg.uneven(0) or cfg.uneven(1))


def dt_cfl_min(cfg, state):
    """Minimum CFL-stable dt over the real cells (`src/reductions.jl:14-20`).

    Restructured as min(dx/max|u±c|, dy/max|v±c|): bitwise identical to the
    per-cell min(dx/..., dy/...) form (IEEE division is monotone in the
    denominator) with two divisions total instead of two per cell; and
    max(|u+c|, |u-c|) == |u| + c bitwise for FINITE c >= 0 (the winning
    branch is the single rounded addition of |u| and c either way; NaN
    propagates identically). Edge case: u = ±inf with c = inf gave NaN
    (inf - inf) in the old form but inf here, so a blown-up run yields
    dt = 0 instead of dt = NaN — equivalent downstream, because the
    driver's validity gate is `isfinite(dt) & (dt > 0)`
    (core/timestep.py:dt_update), which rejects both identically."""
    T = np.dtype(cfg.dtype).type
    dx, dy = T(cfg.dx), T(cfg.dy)
    if _uneven(cfg):
        # Masked form: the static slice would include the edge shard's dead
        # slack cells (garbage, possibly NaN). `where` keeps the max exact.
        u, v, c = state.u, state.v, state.c
        mask = _real_mask(cfg, u.shape)
        zero = T(0.0)
        mx = jnp.where(mask, jnp.abs(u) + c, zero)
        my = jnp.where(mask, jnp.abs(v) + c, zero)
        return jnp.minimum(dx / jnp.max(mx), dy / jnp.max(my))
    r = real_slice(cfg)
    u, v, c = state.u[r], state.v[r], state.c[r]
    mx = jnp.max(jnp.abs(u) + c)
    my = jnp.max(jnp.abs(v) + c)
    return jnp.minimum(dx / mx, dy / my)


def pmin_dt(x, axis_names):
    """NaN-safe cross-shard min for the CFL dt.

    XLA lowers the AllReduce-min computation with fmin-style NaN handling
    (min(NaN, x) can return x), so one diverged shard's NaN dt would
    silently lose to the other shards' finite values and the driver's
    validity gate would never fire (measured on the CPU mesh:
    tests/test_option_fuzz.py::test_divergence_aborts_run). Map NaN to 0
    BEFORE the collective: 0 wins any min against positive dts and fails
    the `isfinite(dt) & (dt > 0)` gate (core/timestep.py) exactly like
    the NaN it replaces (`src/solver_state.jl:123-125` fail-fast parity).
    Healthy runs are bit-unchanged (the where is identity without NaN)."""
    from jax import lax
    x = jnp.where(jnp.isnan(x), jnp.asarray(0.0, x.dtype), x)
    return lax.pmin(x, axis_name=axis_names)


def _ff_sum(x):
    """Compensated (float-float / Knuth 2Sum) sum of a 2D array: a vector
    2Sum scan down the columns keeps one (hi, lo) pair per row-lane, then a
    scalar 2Sum scan combines the lane sums. Every partial sum is carried
    with its rounding error, giving f64-grade accuracy in pure f32 — so the
    conservation check meets the reference's f64 validation bound ON CHIP,
    where real f64 is software-emulated (`test/conservation.jl:13-14`)."""
    def two_sum(carry, b):
        hi, lo = carry
        t = hi + b
        bp = t - hi
        err = (hi - (t - bp)) + (b - bp)
        return (t, lo + err), None

    zero_v = jnp.zeros(x.shape[0], x.dtype)
    (hi, lo), _ = jax.lax.scan(two_sum, (zero_v, zero_v),
                               jnp.swapaxes(x, 0, 1))
    zero_s = jnp.zeros((), x.dtype)
    (h, l), _ = jax.lax.scan(two_sum, (zero_s, zero_s), hi)
    # the (hi, lo) PAIR carries the f64-grade value; collapsing it to one
    # f32 would re-quantize — callers combine the pair in host f64
    # (`conservation_scalar`)
    return h, l + jnp.sum(lo)


def conservation_vars(cfg, state):
    """(total mass, total energy) over real cells
    (`src/reductions.jl:202-216,254-258`).

    f64: ds-scaled scalars (bitwise as always). f32: UNSCALED compensated
    (hi, lo) pairs of shape (2,) — combine with `conservation_scalar` on
    host, where f64 is free, so the <=1e-12 drift bound is measurable even
    on hardware whose f64 is emulated."""
    T = np.dtype(cfg.dtype).type
    ds = T(cfg.dx) * T(cfg.dy)
    compensated = np.dtype(cfg.dtype).itemsize == 4
    if _uneven(cfg):
        mask = _real_mask(cfg, state.rho.shape)
        zero = T(0.0)
        rho = jnp.where(mask, state.rho, zero)
        rhoE = jnp.where(mask, state.rho * state.E, zero)
    else:
        r = real_slice(cfg)
        rho, E = state.rho[r], state.E[r]
        rhoE = rho * E
    if compensated:
        return jnp.stack(_ff_sum(rho)), jnp.stack(_ff_sum(rhoE))
    return jnp.sum(rho) * ds, jnp.sum(rhoE) * ds


def conservation_scalar(cfg, v) -> float:
    """Host-side f64 value of a `conservation_vars` output: combines the
    compensated (hi, lo) pair(s) and applies the ds scaling in f64. Under
    SPMD f32 the input is the all-gathered stack of every shard's pair
    (..., 2): each pair is combined and the cross-shard sum runs in f64,
    keeping the whole measurement f64-grade."""
    a = np.asarray(jax.device_get(v), np.float64)
    if a.ndim >= 1 and a.shape[-1] == 2:
        return float((a[..., 0] + a[..., 1]).sum() * (cfg.dx * cfg.dy))
    return float(a)
