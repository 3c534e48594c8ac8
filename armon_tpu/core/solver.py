"""Solver entry point: `armon(params) -> SolverStats`.

Rebuild of `src/solver.jl:406-516` (init, conservation checks, time loop,
output) on top of three drivers:

- **jit driver**: the whole run is one XLA program (`lax.while_loop` of
  cycles) — the performance path, the analog of the reference's
  async/blocked hot loop.
- **cycle driver**: Python loop calling one jitted cycle at a time — used
  when per-cycle host work is requested (conservation printing `silent<=1`,
  `animation_step`), like the reference's synchronous `solver_cycle`.
- **step driver**: every solver sub-step runs separately with
  `step_checkpoint` hooks between — the `compare`/`is_ref` mode of
  `src/io.jl:185-227` / `src/solver.jl:288-320`.

All three trace the same op functions, so they are bit-identical.
"""

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax

from ..utils.enums import Axis
from ..utils.errors import solver_error
from ..params import ArmonParameters
from ..core.state import State
from ..ops.init import init_state
from ..ops.eos import update_eos
from ..ops.riemann import numerical_fluxes
from ..ops.update import cell_update
from ..ops.projection import projection_remap
from ..ops.reductions import conservation_vars
from .step import make_time_loop, solver_cycle, ghost_exchange
from .splitting import split_schedules
from .timestep import next_time_step


@dataclass
class SolverStats:
    """`src/solver.jl:13-23`."""
    final_time: float
    last_dt: float
    cycles: int
    solve_time: float            # seconds
    cell_count: int
    giga_cells_per_sec: float    # cell-cycles per second / 1e9
    data: Optional[State] = None
    timer: Optional[dict] = None
    grid_log: Optional[dict] = None

    def __repr__(self):
        return (f"Solver stats:\n"
                f" - final time:  {self.final_time:.18f}\n"
                f" - last dt:     {self.last_dt:.18f}\n"
                f" - cycles:      {self.cycles}\n"
                f" - performance: {self.giga_cells_per_sec * 1e3:.3f} x10^6 "
                f"cell-cycles/sec ({self.solve_time:.3f} sec, "
                f"{self.cell_count} cells)")


# Compiled-function cache: rebuilding the jit wrappers per armon() call
# would retrace/recompile identical programs (SolverConfig has value
# semantics, so equal configs share cache entries). Keyed off the config
# plus the builder kind; skipped when an explicit device list is given.
# LRU-bounded so parameter sweeps in one process don't grow it unboundedly
# (the jit executables themselves stay in XLA's own cache).
from collections import OrderedDict

_FN_CACHE = OrderedDict()
_FN_CACHE_MAX = 64


def _cached(params, kind, build):
    if params.devices is not None:
        return build()
    key = (params.config, kind)
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = _FN_CACHE[key] = build()
        while len(_FN_CACHE) > _FN_CACHE_MAX:
            _FN_CACHE.popitem(last=False)
    else:
        _FN_CACHE.move_to_end(key)
    return fn


# ---------------------------------------------------------------- SPMD glue

def _mesh_and_specs(params):
    from ..parallel.mesh import make_mesh, shard_state_spec
    from jax.sharding import PartitionSpec as P
    cfg = params.config
    mesh = make_mesh(cfg.proc_dims, cfg.axis_names, devices=params.devices)
    spec = shard_state_spec(cfg.axis_names)
    state_spec = State(*([spec] * len(State._fields)))
    return mesh, state_spec, P()


def _shard(params, fn, in_specs, out_specs):
    """Wrap `fn` in shard_map over the params' mesh."""
    mesh, _, _ = _mesh_and_specs(params)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def make_init(params):
    """Jitted initial-condition builder (single-device or sharded).
    The per-shard global origin is derived from the mesh coordinates, the
    analog of `N_origin` (`src/parameters.jl:727`)."""
    cfg = params.config

    def build():
        if not cfg.spmd:
            return jax.jit(lambda: init_state(cfg))

        def init_shard():
            from jax import lax
            ix = lax.axis_index(cfg.axis_names[0])
            iy = lax.axis_index(cfg.axis_names[1])
            gx = ix * cfg.n_local[0]
            gy = iy * cfg.n_local[1]
            return init_state(cfg, global_pos=(gx, gy))

        _, state_spec, _ = _mesh_and_specs(params)
        return _shard(params, init_shard, in_specs=(), out_specs=state_spec)

    return _cached(params, "init", build)


def make_conservation(params):
    """Returns a host-callable (state) -> (mass, energy) as Python f64
    floats — the f32 path's compensated (hi, lo) pairs are combined on
    host (`conservation_scalar`), giving an f64-grade drift measurement of
    an f32 run."""
    cfg = params.config
    from ..ops.reductions import conservation_scalar

    def build():
        if not cfg.spmd:
            dev = jax.jit(lambda s: conservation_vars(cfg, s))
        else:
            def cons(state):
                from jax import lax
                m, e = conservation_vars(cfg, state)
                if np.dtype(cfg.dtype).itemsize == 4:
                    # f32 compensated (hi, lo) pairs: a componentwise f32
                    # psum would re-introduce ~1e-7 of cross-shard rounding
                    # into the hi sum, defeating the f64-grade drift
                    # measurement. Gather every shard's pair instead; the
                    # host combines them in f64 (conservation_scalar).
                    for ax in cfg.axis_names:
                        m = lax.all_gather(m, ax)
                        e = lax.all_gather(e, ax)
                    return m, e
                # f64 scalars: MPI.Allreduce(SUM) analog
                # (src/reductions.jl:318-320) — exact in f64.
                m = lax.psum(m, cfg.axis_names)
                e = lax.psum(e, cfg.axis_names)
                return m, e

            _, state_spec, rep = _mesh_and_specs(params)
            dev = _shard(params, cons, in_specs=(state_spec,),
                         out_specs=(rep, rep))

        def call(state):
            m, e = dev(state)
            return conservation_scalar(cfg, m), conservation_scalar(cfg, e)

        return call

    return _cached(params, "conservation", build)


def make_jit_loop(params, restore=False):
    cfg = params.config

    def build():
        loop = make_time_loop(cfg, restore=restore)
        if not cfg.spmd:
            return jax.jit(loop)
        _, state_spec, rep = _mesh_and_specs(params)
        in_specs = (state_spec, rep, rep, rep) if restore else (state_spec,)
        return _shard(params, loop, in_specs=in_specs,
                      out_specs=(state_spec, rep, rep, rep, rep))

    return _cached(params, ("loop", restore), build)


def make_cycle(params):
    return _cached(params, "cycle", lambda: _build_cycle(params))


def _build_cycle(params):
    cfg = params.config

    def cycle(state, dt_prev, cycle_idx):
        return solver_cycle(cfg, state, dt_prev, cycle_idx)

    if not cfg.spmd:
        return jax.jit(cycle)
    _, state_spec, rep = _mesh_and_specs(params)
    return _shard(params, cycle,
                  in_specs=(state_spec, rep, rep),
                  out_specs=(state_spec, rep, rep, rep))


# ------------------------------------------------------------------ drivers

def _python_cycle_driver(params, state, checkpoint=None, solver_log=None,
                         restored=None):
    """Per-cycle (and optionally per-step) host loop. Returns
    (state, t, cycles, last_dt)."""
    cfg = params.config
    T = cfg.dtype.type
    conservation = make_conservation(params) if params.silent <= 1 else None

    if checkpoint is not None:
        step_fns = _make_step_fns(params)

    # EOS_init (src/solver.jl:291-295)
    eos_fn = jax.jit(lambda s: update_eos(cfg, s)) if not cfg.spmd else \
        _shard(params, lambda s: update_eos(cfg, s),
               in_specs=(_mesh_and_specs(params)[1],),
               out_specs=_mesh_and_specs(params)[1])

    t = T(0.0)
    cycles = 0
    dt_prev = T(0.0)
    if restored is not None:
        t, cycles, dt_prev = restored
        cycles = int(cycles)

    if restored is None:
        if checkpoint is not None and checkpoint("init_test", state, Axis.X, 0.0, 0):
            return state, float(t), cycles, float(dt_prev)

        if cfg.maxcycle > 0:
            state = eos_fn(state)
            if checkpoint is not None and checkpoint("EOS_init", state, Axis.X, 0.0, 0):
                return state, float(t), cycles, float(dt_prev)

    cycle_fn = make_cycle(params) if checkpoint is None else None

    while t < T(cfg.maxtime) and cycles < cfg.maxcycle:
        cycle_start = time.perf_counter()
        if checkpoint is None:
            state, dt_use, dt_next, ok = cycle_fn(state, dt_prev,
                                                  np.int32(cycles))
        else:
            state, dt_use, dt_next, ok, stop = _checkpointed_cycle(
                params, step_fns, state, dt_prev, cycles, checkpoint)
            if stop:
                return state, float(t), cycles, float(dt_next)
        if not bool(ok):
            solver_error("time", f"Invalid time step for cycle {cycles}: {dt_next}")
        t = t + T(dt_use)
        cycles += 1
        dt_prev = dt_next

        if solver_log is not None:
            jax.block_until_ready(state)
            solver_log.push(cycles, float(t), float(dt_use),
                            time.perf_counter() - cycle_start)

        if params.checkpoint_step and cycles % params.checkpoint_step == 0:
            from ..io.restart import save_checkpoint
            os.makedirs(params.output_dir, exist_ok=True)
            # np.savez appends .npz; name the file with the real suffix
            save_checkpoint(
                os.path.join(params.output_dir,
                             params.output_file + ".ckpt.npz"),
                params, state, float(t), cycles, float(dt_prev))

        if params.silent <= 1:
            m, e = conservation(state)
            dM = abs(params.initial_mass - float(m)) / params.initial_mass * 100
            dE = abs(params.initial_energy - float(e)) / params.initial_energy * 100
            # The reference prints AFTER next_cycle!, where current_dt has
            # been advanced to the NEXT cycle's dt (src/solver.jl:366-367,
            # src/solver_state.jl:162); '#' keeps trailing zeros like
            # Julia's %#8.6g.
            print(f"Cycle {cycles:4d}: dt = {float(dt_prev):.18f}, "
                  f"t = {float(t):.18f}, |dM| = {dM:#8.6g}%, |dE| = {dE:#8.6g}%")

        if params.animation_step != 0 and (cycles - 1) % params.animation_step == 0:
            frame = (cycles - 1) // params.animation_step
            anim_dir = os.path.join(params.output_dir, "anim")
            os.makedirs(anim_dir, exist_ok=True)
            path = os.path.join(anim_dir, f"{params.output_file}_{frame:03d}")
            if cfg.spmd and params.use_MPI:
                # per-shard frames, O(shard) host memory (src/io.jl:46-75)
                from ..io.subdomain import write_sub_domain_files
                write_sub_domain_files(params, state, path,
                                       precision=params.output_precision)
            else:
                from ..io.output import write_state_file
                write_state_file(cfg, gather_state(params, state), path,
                                 precision=params.output_precision)

    return state, float(t), cycles, float(dt_prev)


def _make_step_fns(params):
    """Individually-jitted solver sub-steps for the checkpoint/compare
    driver. Under SPMD each sub-step is shard_mapped over the mesh (the
    halo exchange and the dt pmin need the mesh axes), so compare mode
    runs per-shard like the reference's per-rank `step_checkpoint`
    (`src/io.jl:185-227`)."""
    cfg = params.config
    fns = {}
    if not cfg.spmd:
        for axis in (Axis.X, Axis.Y):
            fns[("eos", axis)] = jax.jit(lambda s, a=axis: update_eos(cfg, s))
            fns[("bc", axis)] = jax.jit(lambda s, a=axis: ghost_exchange(cfg, s, a))
            fns[("fluxes", axis)] = jax.jit(
                lambda s, dt, a=axis: numerical_fluxes(cfg, s, a, dt))
            fns[("update", axis)] = jax.jit(
                lambda s, dt, a=axis: cell_update(cfg, s, a, dt))
            fns[("remap", axis)] = jax.jit(
                lambda s, dt, a=axis: projection_remap(cfg, s, a, dt))
        fns["dt"] = jax.jit(lambda s, dtp, cyc: next_time_step(cfg, s, dtp, cyc))
        return fns

    _, sspec, rep = _mesh_and_specs(params)

    def sj(f):
        return _shard(params, f, in_specs=(sspec,), out_specs=sspec)

    def sdj(f):
        return _shard(params, f, in_specs=(sspec, rep), out_specs=sspec)

    for axis in (Axis.X, Axis.Y):
        fns[("eos", axis)] = sj(lambda s, a=axis: update_eos(cfg, s))
        fns[("bc", axis)] = sj(lambda s, a=axis: ghost_exchange(cfg, s, a))
        fns[("fluxes", axis)] = sdj(
            lambda s, dt, a=axis: numerical_fluxes(cfg, s, a, dt))
        fns[("update", axis)] = sdj(
            lambda s, dt, a=axis: cell_update(cfg, s, a, dt))
        fns[("remap", axis)] = sdj(
            lambda s, dt, a=axis: projection_remap(cfg, s, a, dt))
    fns["dt"] = _shard(params,
                       lambda s, dtp, cyc: next_time_step(cfg, s, dtp, cyc),
                       in_specs=(sspec, rep, rep), out_specs=(rep, rep, rep))
    return fns


def _checkpointed_cycle(params, fns, state, dt_prev, cycle_idx, checkpoint):
    """`solver_cycle` with a checkpoint after every sub-step
    (`src/solver.jl:288-320`)."""
    cfg = params.config
    T = cfg.dtype.type
    dt_use, dt_next, ok = fns["dt"](state, dt_prev, np.int32(cycle_idx))
    even, odd = split_schedules(cfg.splitting)
    # time_step files are tagged X at cycle 0, else with the PREVIOUS
    # cycle's last sweep axis — the reference's `state.axis` at that point
    # (src/io.jl:193-198), so cross-implementation compare mode finds the
    # same file names.
    ts_axis = Axis.X if cycle_idx == 0 else \
        (even if (cycle_idx - 1) % 2 == 0 else odd)[-1][0]
    if checkpoint("time_step", state, ts_axis, float(dt_use), cycle_idx):
        return state, dt_use, dt_next, ok, True

    schedule = even if cycle_idx % 2 == 0 else odd
    seen = {}  # per-axis sweep count within this cycle (Strang repeats one)
    for axis, factor in schedule:
        rep = seen[axis] = seen.get(axis, 0) + 1
        # `rep` rides a kwarg ONLY for a repeated axis (Strang's third
        # sweep), so user-supplied 5-arg checkpoint hooks keep working on
        # every schedule that has no repeats.
        rkw = {"rep": rep} if rep > 1 else {}
        dt = T(dt_use) * T(factor)
        state = fns[("eos", axis)](state)
        if checkpoint("EOS", state, axis, dt, cycle_idx, **rkw):
            return state, dt_use, dt_next, ok, True
        state = fns[("bc", axis)](state)
        if checkpoint("boundary_conditions", state, axis, dt, cycle_idx,
                      **rkw):
            return state, dt_use, dt_next, ok, True
        state = fns[("fluxes", axis)](state, dt)
        if checkpoint("numerical_fluxes", state, axis, dt, cycle_idx, **rkw):
            return state, dt_use, dt_next, ok, True
        state = fns[("update", axis)](state, dt)
        if checkpoint("cell_update", state, axis, dt, cycle_idx, **rkw):
            return state, dt_use, dt_next, ok, True
        state = fns[("remap", axis)](state, dt)
        if checkpoint("projection_remap", state, axis, dt, cycle_idx, **rkw):
            return state, dt_use, dt_next, ok, True
    return state, dt_use, dt_next, ok, False


def measure_sections(params, state, reps=3):
    """Per-SECTION wall times of one solver cycle — the analog of the
    reference's block-log event analysis (`src/logging.jl:75-300`:
    per-event step counts, stall/wait shares). Under XLA there is no host
    scheduler to instrument, so the operational decomposition is the
    jitted cycle's pieces, timed as separately-jitted steps over the
    CURRENT state (same traced ops as the production cycle; XLA fuses
    across sub-steps inside the whole-run program, so shares are
    indicative, not additive to the in-loop cycle time).

    Returns {section: seconds}: eos/bc/fluxes/update/remap per axis, plus
    time_step."""
    cfg = params.config
    T = cfg.dtype.type

    def timeit(fn, *args):
        jax.block_until_ready(fn(*args))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best

    dt = T(1e-6)
    sections = {}
    fns = _make_step_fns(params)
    for axis in (Axis.X, Axis.Y):
        sections[f"eos_{axis.name}"] = timeit(fns[("eos", axis)], state)
        sections[f"bc_{axis.name}"] = timeit(fns[("bc", axis)], state)
        sections[f"fluxes_{axis.name}"] = timeit(fns[("fluxes", axis)],
                                                 state, dt)
        sections[f"update_{axis.name}"] = timeit(fns[("update", axis)],
                                                 state, dt)
        sections[f"remap_{axis.name}"] = timeit(fns[("remap", axis)],
                                                state, dt)
    sections["time_step"] = timeit(fns["dt"], state, T(1e-6), np.int32(2))
    return sections


def gather_state(params, state: State) -> State:
    """Bring a (possibly sharded, blocked-layout) state back to a host-side
    globally-padded State — `device_to_host!` (`src/blocking/block_grid.jl:712-737`).

    Multi-process runs cannot gather: shards on other processes are not
    addressable here, and a global gather would defeat the O(shard) design
    anyway. Every distributed surface has a per-shard route that works
    multi-process: output `write_sub_domain_files`, checkpoints
    `save_checkpoint(per_shard=True)` (the `use_MPI=True` defaults), golden
    comparison `compare_sub_domain_with_golden` — all driven off
    `addressable_shards` only."""
    cfg = params.config
    for f in State._fields:
        leaf = getattr(state, f)
        if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
            solver_error("config",
                         "gather_state: state is sharded across multiple "
                         "processes; a global gather is not possible (and "
                         "not O(shard)). Use the per-shard paths instead: "
                         "write_sub_domain_files / save_checkpoint("
                         "per_shard=True) / compare_sub_domain_with_golden.")
    state = jax.device_get(state)
    if not cfg.spmd:
        return State(*[np.asarray(a) for a in state])

    g = cfg.nghost
    lr, lc = cfg.local_shape
    px, py = cfg.proc_dims
    nx, ny = cfg.n_global
    nxl, nyl = cfg.n_local
    ex, ey = cfg.edge_cells

    if (ex, ey) == (nxl, nyl):
        def unblock(a):
            a = np.asarray(a).reshape(py, lr, px, lc)
            out = np.zeros((ny + 2 * g, nx + 2 * g), cfg.dtype)
            # interior from each block's real cells
            real = a[:, g:lr - g, :, g:lc - g]
            out[g:-g, g:-g] = real.reshape(py * (lr - 2 * g), px * (lc - 2 * g))
            # global ghost bands + corners come from the border blocks
            out[:g, g:-g] = a[0, :g, :, g:lc - g].reshape(g, nx)
            out[-g:, g:-g] = a[-1, lr - g:, :, g:lc - g].reshape(g, nx)
            out[g:-g, :g] = a[:, g:lr - g, 0, :g].reshape(ny, g)
            out[g:-g, -g:] = a[:, g:lr - g, -1, lc - g:].reshape(ny, g)
            out[:g, :g] = a[0, :g, 0, :g]
            out[:g, -g:] = a[0, :g, -1, lc - g:]
            out[-g:, :g] = a[-1, lr - g:, 0, :g]
            out[-g:, -g:] = a[-1, lr - g:, -1, lc - g:]
            return out
    else:
        # Uneven split: the hi-edge shards own only (ex, ey) real cells;
        # their mirror-BC ghost bands sit just past those, and the remaining
        # slack is dead — skip it when reassembling.
        def unblock(a):
            a = np.asarray(a).reshape(py, lr, px, lc)
            out = np.zeros((ny + 2 * g, nx + 2 * g), cfg.dtype)
            for by in range(py):
                hy = ey if by == py - 1 else nyl
                r0 = g + by * nyl
                for bx in range(px):
                    wx = ex if bx == px - 1 else nxl
                    c0 = g + bx * nxl
                    blk = a[by, :, bx, :]
                    out[r0:r0 + hy, c0:c0 + wx] = blk[g:g + hy, g:g + wx]
                    if by == 0:
                        out[0:g, c0:c0 + wx] = blk[0:g, g:g + wx]
                    if by == py - 1:
                        out[g + ny:, c0:c0 + wx] = blk[g + hy:2 * g + hy,
                                                       g:g + wx]
                    if bx == 0:
                        out[r0:r0 + hy, 0:g] = blk[g:g + hy, 0:g]
                    if bx == px - 1:
                        out[r0:r0 + hy, g + nx:] = blk[g:g + hy,
                                                       g + wx:2 * g + wx]
                    if by == 0 and bx == 0:
                        out[:g, :g] = blk[:g, :g]
                    if by == 0 and bx == px - 1:
                        out[:g, g + nx:] = blk[:g, g + wx:2 * g + wx]
                    if by == py - 1 and bx == 0:
                        out[g + ny:, :g] = blk[g + hy:2 * g + hy, :g]
                    if by == py - 1 and bx == px - 1:
                        out[g + ny:, g + nx:] = blk[g + hy:2 * g + hy,
                                                    g + wx:2 * g + wx]
            return out

    return State(*[unblock(a) for a in state])


# -------------------------------------------------------------------- armon

def armon(params: ArmonParameters, checkpoint=None,
          restore_from=None) -> SolverStats:
    """Main entry point (`src/solver.jl:406-516`).

    `restore_from`: path of a snapshot written by
    `armon_tpu.io.restart.save_checkpoint` (or the `checkpoint_step` option);
    the run resumes bit-exactly from the saved carry."""
    cfg = params.config
    _ensure_x64(cfg)

    if params.silent < 3:
        print(params.describe())

    from ..utils.profiling import Timer, section, trace
    from ..utils.solver_log import SolverLog
    timer = Timer() if params.measure_time else None
    solver_log = SolverLog(cfg.n_global[0] * cfg.n_global[1]) \
        if params.log_blocks else None

    use_python_loop = (params.silent <= 1 or params.animation_step != 0
                       or params.compare or checkpoint is not None
                       or solver_log is not None or params.checkpoint_step != 0)

    restored = None
    state = None
    with section("init", timer, sync_args=lambda: state,
                 time_async=params.time_async):
        if restore_from is not None:
            from ..io.restart import load_checkpoint
            state, r_t, r_cycles, r_dt = load_checkpoint(restore_from, params)
            restored = (cfg.dtype.type(r_t), np.int32(r_cycles),
                        cfg.dtype.type(r_dt))
        else:
            state = jax.block_until_ready(make_init(params)())

    if params.check_result or params.silent <= 1:
        with section("conservation_vars", timer):
            m, e = make_conservation(params)(state)
            params.initial_mass, params.initial_energy = float(m), float(e)

    solve_start = time.perf_counter()
    if params.compare and checkpoint is None:
        checkpoint = make_file_checkpoint(params)

    tracing = "trace" in tuple(params.profiling)
    profile_dir = os.path.join(params.output_dir, "profile")
    profile_ctx = trace(profile_dir) if tracing else contextlib.nullcontext()
    with profile_ctx, section("solver_cycle", timer):
        if use_python_loop:
            state, final_t, cycles, last_dt = _python_cycle_driver(
                params, state, checkpoint=checkpoint, solver_log=solver_log,
                restored=restored)
        else:
            loop = make_jit_loop(params, restore=restored is not None)
            args = restored if restored is not None else ()
            state, t, cycles, last_dt, ok = loop(state, *args)
            # The host reads wait for the whole-run program to finish.
            final_t, cycles, last_dt = float(t), int(cycles), float(last_dt)
            if not bool(ok):
                solver_error("time", f"Invalid time step at cycle {cycles}")

    solve_time = time.perf_counter() - solve_start

    if solver_log is not None and cycles > 0:
        # Per-section breakdown of the cycle (the `analyse_log_stats`
        # analog, src/logging.jl:75-300) — measured on the final state.
        try:
            solver_log.sections = measure_sections(params, state)
        except Exception as e:  # a probe failure must not kill the run
            import warnings
            warnings.warn(f"section probe failed: {type(e).__name__}: {e}")
        if tracing:
            # In-loop per-kernel DEVICE truth from the XPlane dump the run
            # just produced — the reference's per-kernel profiling
            # callbacks (src/profiling.jl:6-68). The re-jitted probes
            # above stay available, labeled as probes, in analyse().
            from ..utils.xplane import parse_kernel_times
            solver_log.trace_sections = parse_kernel_times(profile_dir)

    # Final conservation check (src/solver.jl:467-490)
    if params.check_result and params.test.is_conservative and cycles > 0:
        m, e = make_conservation(params)(state)
        dm = abs(float(m) - params.initial_mass) / params.initial_mass
        de = abs(float(e) - params.initial_energy) / params.initial_energy
        rtol = 1e-2 * min(1.0, final_t / params.test.default_max_time)
        if not (_isapprox0(dm, 1e-12, rtol) and _isapprox0(de, 1e-12, rtol)):
            import warnings
            warnings.warn(
                f"Mass and energy are not constant, the solution might not be "
                f"valid!\n|dM|/M = {dm:.6g}\n|dE|/E = {de:.6g}")

    cell_count = cfg.n_global[0] * cfg.n_global[1]
    grind = solve_time / max(cycles, 1) / cell_count
    stats = SolverStats(
        final_time=final_t,
        last_dt=last_dt,
        cycles=cycles,
        solve_time=solve_time,
        cell_count=cell_count,
        giga_cells_per_sec=1.0 / grind / 1e9 if cycles > 0 else 0.0,
        data=state if params.return_data else None,
        timer=timer.report() if timer is not None else None,
        grid_log=solver_log,
    )

    if params.write_output or params.write_slices:
        os.makedirs(params.output_dir, exist_ok=True)
        path = os.path.join(params.output_dir, params.output_file)
        per_shard = params.write_output and cfg.spmd and params.use_MPI
        if per_shard:
            # Reference distributed-output behavior (`src/io.jl:46-75`):
            # one `_<cx>×<cy>` file per shard, NO global gather — host
            # memory stays O(shard) at any mesh/grid scale.
            from ..io.subdomain import write_sub_domain_files
            paths = write_sub_domain_files(
                params, state, path, precision=params.output_precision,
                with_ghosts=params.write_ghosts)
            if params.silent < 2:
                print(f"\nWrote to files {paths[0]} .. {paths[-1]}")
        if (params.write_output and not per_shard) or params.write_slices:
            host = gather_state(params, state)
            if params.write_output and not per_shard:
                from ..io.output import write_state_file
                write_state_file(cfg, host, path,
                                 precision=params.output_precision,
                                 with_ghosts=params.write_ghosts)
                if params.silent < 2:
                    print(f"\nWrote to file {path}")
            if params.write_slices:
                from ..io.slices import write_slices_files
                write_slices_files(cfg, host, path,
                                   precision=params.output_precision)

    if params.silent < 3 and cycles > 0:
        _print_summary(stats, params)

    return stats


def make_file_checkpoint(params):
    """The `step_checkpoint` hook (`src/io.jl:185-227`): with `is_ref=True`
    write a file per sub-step; otherwise compare against it. On a mismatch
    the differing state is written next to the reference file as `_diff`
    (`src/io.jl:220-222`). Under SPMD, state files are per-shard
    `_<cx>×<cy>` files with NO global gather (`src/io.jl:46-59` naming);
    the dt file stays global (the time step is replicated over the mesh)."""
    from ..io.output import write_state_file, read_state_file
    cfg = params.config

    def checkpoint(label, state, axis, dt, cycle, rep=1):
        # cycle-0 time_step files are tagged X (src/io.jl:193-198)
        axis_char = "X" if axis is Axis.X else "Y"
        # `rep` disambiguates an axis swept twice in one cycle (Strang's
        # (X, Y, X)): the reference's `_%03d_label_axis` naming
        # (`src/io.jl:192-198`) makes the two half-sweeps COLLIDE on one
        # file — its compare mode cannot work under Strang. Suffix the
        # repeat only, so every non-Strang name stays reference-exact.
        rep_tag = "" if rep == 1 else f"_{rep}"
        name = f"{params.output_file}_{cycle:03d}_{label}_{axis_char}{rep_tag}"
        path = os.path.join(params.output_dir, name)
        if label == "time_step":
            if params.is_ref:
                with open(path, "w") as f:
                    f.write(f"%#{params.output_precision + 7}.{params.output_precision}e\n"
                            % dt)
                return False
            with open(path) as f:
                # parse to the run's dtype like the reference's
                # `parse(T, ...)` (src/io.jl:198-203): 9 decimal digits
                # round-trip an f32 exactly only when read back AS f32.
                ref_dt = float(np.dtype(cfg.dtype).type(f.read().strip()))
            # Julia isapprox semantics (src/io.jl:210), same formula as
            # count_differences — NaN-safe: a NaN dt compares different.
            tol = params.comparison_tolerance * max(abs(ref_dt), abs(dt))
            diff = not (abs(ref_dt - dt) <= tol)
            if diff:
                print(f"Time step difference: ref dt = {ref_dt:.18f}, "
                      f"dt = {dt:.18f}, diff = {ref_dt - dt:.18f}")
            return diff

        if cfg.spmd:
            return _spmd_file_checkpoint(params, label, state, path, cycle)

        host = gather_state(params, state)
        if params.is_ref:
            write_state_file(cfg, host, path, precision=params.output_precision,
                             with_ghosts=params.write_ghosts)
            return False
        from ..io.output import compare_states
        ref = read_state_file(cfg, path, with_ghosts=params.write_ghosts)
        cnt, max_diff, details = compare_states(
            cfg, host, ref, atol=0.0, rtol=params.comparison_tolerance,
            with_ghosts=params.write_ghosts)
        if cnt:
            print(f"At {label} (cycle {cycle}): {cnt} differences "
                  f"(max rel {max_diff:.3e}): {details}")
            # the differing state, for inspection (src/io.jl:220-222)
            write_state_file(cfg, host, path + "_diff",
                             precision=params.output_precision,
                             with_ghosts=params.write_ghosts)
        return cnt > 0

    return checkpoint


def _spmd_file_checkpoint(params, label, state, path, cycle):
    """Per-shard write-or-compare of one sub-step under SPMD — the
    reference's per-rank `step_checkpoint` files (`src/io.jl:185-227` via
    `build_file_path`'s `_<coords>` naming, `src/io.jl:46-59`). Host memory
    stays O(shard): blocks come through `shard_coords_iter`, never a global
    gather."""
    from ..core.state import SAVED_VARS
    from ..io.output import count_differences, write_cells_file
    from ..io.subdomain import (write_sub_domain_files, read_sub_domain_file,
                                sub_domain_file_path, shard_coords_iter,
                                shard_real_window, _ghost_window)
    cfg = params.config
    if params.is_ref:
        write_sub_domain_files(params, state, path,
                               precision=params.output_precision,
                               with_ghosts=params.write_ghosts)
        return False
    win = _ghost_window if params.write_ghosts else shard_real_window
    total = 0
    for coords, blocks in shard_coords_iter(params, state):
        rs, cs, _, _ = win(cfg, coords)
        ours = {v: blocks[v][rs, cs] for v in SAVED_VARS}
        spath = sub_domain_file_path(path, coords)
        ref = read_sub_domain_file(cfg, spath, coords,
                                   with_ghosts=params.write_ghosts)
        cnt, max_diff, details = count_differences(
            cfg, ours, ref, atol=0.0, rtol=params.comparison_tolerance)
        if cnt:
            print(f"At {label} (cycle {cycle}, shard {coords}): {cnt} "
                  f"differences (max rel {max_diff:.3e}): {details}")
            write_cells_file(spath + "_diff", ours, params.output_precision)
        total += cnt
    return total > 0


def _isapprox0(x, atol, rtol):
    """Julia `isapprox(x, 0; atol, rtol)` (src/solver.jl:481-482)."""
    return abs(x) <= max(atol, rtol * abs(x))


def _print_summary(stats, params):
    if params.silent >= 3:
        return
    print()
    print(f"Total time:  {stats.solve_time:.5f} sec")
    grind_us = stats.solve_time / max(stats.cycles, 1) / stats.cell_count * 1e6
    print(f"Grind time:  {grind_us:.5f} us/cell/cycle")
    print(f"Cells/sec:   {stats.giga_cells_per_sec * 1e3:.5f} Mega cells/sec")
    print(f"Cycles:      {stats.cycles}")
    print(f"Last cycle:  {stats.final_time:.18f} sec, dt={stats.last_dt:.18f} sec")


def _ensure_x64(cfg):
    if cfg.dtype.itemsize == 8 and not jax.config.read("jax_enable_x64"):
        jax.config.update("jax_enable_x64", True)


# Reference API-parity helpers (src/Armon.jl:15-16 exports)
def device_to_host(params, state):
    return gather_state(params, state)


def host_to_device(params, state_host: State) -> State:
    """Inverse of `gather_state`: place a globally-padded host state onto the
    device (mesh) — `host_to_device!` (`src/blocking/block_grid.jl:712-737`)."""
    cfg = params.config
    if not cfg.spmd:
        return jax.device_put(state_host)

    from jax.sharding import NamedSharding
    from ..parallel.mesh import make_mesh, shard_state_spec
    mesh = make_mesh(cfg.proc_dims, cfg.axis_names, devices=params.devices)
    sharding = NamedSharding(mesh, shard_state_spec(cfg.axis_names))
    lr, lc = cfg.local_shape
    px, py = cfg.proc_dims
    nxl, nyl = cfg.n_local

    g = cfg.nghost
    nx, ny = cfg.n_global

    def block(a):
        a = np.asarray(a)
        # Uneven split: the edge shards' padded windows over-run the global
        # array by the slack; edge-replicate into it (slack cells are dead).
        sy = py * nyl + 2 * g - (ny + 2 * g)
        sx = px * nxl + 2 * g - (nx + 2 * g)
        if sy or sx:
            a = np.pad(a, ((0, sy), (0, sx)), mode="edge")
        out = np.empty((py * lr, px * lc), cfg.dtype)
        for by in range(py):
            for bx in range(px):
                out[by * lr:(by + 1) * lr, bx * lc:(bx + 1) * lc] = \
                    a[by * nyl:by * nyl + lr, bx * nxl:bx * nxl + lc]
        if sharding.is_fully_addressable:
            return jax.device_put(out, sharding)
        # Multi-process: every process passes the SAME global host state
        # (the sequential-init pattern) and contributes only its
        # addressable shards.
        return jax.make_array_from_callback(out.shape, sharding,
                                            lambda idx: out[idx])

    return State(*[block(a) for a in state_host])
