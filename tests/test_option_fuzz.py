"""Option-space interaction fuzz (SURVEY.md §2.5).

Every hand-written test pins one axis of the configuration space at a
time; this file samples random VALID combinations across ALL axes at once
(test case x scheme x limiter x projection x splitting x nghost x dtype x
mesh x dt mode) and demands the invariants
that must hold for every combination:

  * the run completes its cycles with a valid dt (`ok`),
  * every field is finite and the density strictly positive,
  * mass is conserved for the conservative test cases
    (`src/tests.jl:48-49`; bound per `test/conservation.jl:13-14`,
    loosened for the handful of cycles run here).

The sampler is seeded per case, so a failing combination reproduces from
its test id alone.
"""

import random

import numpy as np
import pytest

# The heavy invariants carry the `slow` mark (deselect with -m "not slow");
# the rest run in the quick tier.

import jax

from armon_tpu import ArmonParameters
from armon_tpu.core.solver import (make_init, make_jit_loop,
                                   make_conservation, gather_state)

CONSERVATIVE = {"Sod", "Sod_y", "Sod_circ"}  # gated in the reference's suite


def _sample(rng):
    """One random valid configuration (all constraints of params.py held
    by construction: nghost >= stencil(riemann) + stencil(projection) —
    the stencil-SUM floor — and shards always wider than the halo slab)."""
    scheme, limiter = rng.choice([
        ("Godunov", "no_limiter"),
        ("GAD", "no_limiter"), ("GAD", "minmod"), ("GAD", "superbee"),
    ])
    projection = rng.choice(["euler", "euler_2nd"])
    # the true dependency depth is the stencil SUM (params.py nghost floor)
    stencil = ((1 if scheme == "Godunov" else 2)
               + (1 if projection == "euler" else 2))
    opts = dict(
        test=rng.choice(["Sod", "Sod_y", "Sod_circ", "Bizarrium", "Sedov"]),
        scheme=scheme, riemann_limiter=limiter, projection=projection,
        axis_splitting=rng.choice(["Sequential", "SequentialSym", "Godunov",
                                   "Strang", "X_only", "Y_only"]),
        nghost=max(rng.choice([2, 4, 5]), stencil),
        N=(rng.choice([40, 48, 61]), rng.choice([40, 53, 64])),
        data_type=rng.choice([np.float32, np.float64]),
        maxcycle=6, maxtime=1e30,
        silent=5, write_output=False, measure_time=False,
    )
    P = rng.choice([None, (2, 1), (1, 2), (2, 2), (3, 2)])
    if P is not None:
        opts["P"] = P
        if rng.random() < 0.5:
            # distributed-I/O rule: per-shard `_<cx>×<cy>` snapshot and
            # output layout (io/subdomain.py) instead of gathered files
            opts["use_MPI"] = True
    # dt modes: default CFL recurrence / constant dt / even-cycle reuse.
    # cst_dt trusts the user's dt (no CFL guard, reference semantics), so
    # the fixed value must sit under each case's CFL limit — Bizarrium's
    # stiff EOS runs at c ~ 1e4 (dt ~ 1e-8 at these grids), Sedov's blast
    # center at c ~ 1e2.
    mode = rng.random()
    if mode < 0.2:
        stable_dt = {"Bizarrium": 1e-9, "Sedov": 1e-7}.get(opts["test"], 1e-5)
        opts.update(cst_dt=True, Dt=stable_dt)
    elif mode < 0.45:
        opts["dt_on_even_cycles"] = True
    return opts


@pytest.mark.parametrize("seed", range(14))
def test_random_option_combination(seed):
    opts = _sample(random.Random(20260818 + seed))
    needed = int(np.prod(opts.get("P", (1, 1))))
    if len(jax.devices()) < needed:
        pytest.skip(f"needs {needed} devices")

    params = ArmonParameters(**opts)
    state = make_init(params)()
    m0, _ = make_conservation(params)(state)
    state, t, cycles, dt, ok = make_jit_loop(params)(state)

    label = {k: (v.__name__ if isinstance(v, type) else v)
             for k, v in opts.items()}
    assert bool(ok), f"invalid time step: {label}"
    assert int(cycles) == opts["maxcycle"], f"stopped early: {label}"
    assert np.isfinite(float(dt)) and float(dt) > 0, label

    host = gather_state(params, state)
    g = params.nghost
    for var in ("rho", "u", "v", "E", "p"):
        a = np.asarray(getattr(host, var))[g:-g, g:-g]
        assert np.all(np.isfinite(a)), f"{var} not finite: {label}"
    assert np.all(np.asarray(host.rho)[g:-g, g:-g] > 0), \
        f"non-positive density: {label}"

    if opts["test"] in CONSERVATIVE:
        m, _ = make_conservation(params)(state)
        # 1e-12-grade per the reference, with headroom for the f32
        # compensated-sum path over these few cycles.
        tol = 1e-11 if np.dtype(params.config.dtype).itemsize == 8 else 1e-6
        assert abs(m - m0) <= tol * abs(m0), f"mass drift {m - m0}: {label}"


@pytest.mark.parametrize("P", [None, (2, 2), (2, 1), (1, 2)],
                         ids=["single", "2x2", "2x1", "1x2"])
def test_divergence_aborts_run(P):
    """A NaN in the state must surface as an invalid dt (`isfinite & > 0`,
    the `src/solver_state.jl:123-125` analog), flip `ok` and stop the
    while-loop — within two cycles (the dt carry is one cycle stale), on
    one device and on meshes (where the CFL reduction is a pmin)."""
    opts = dict(test="Sod", N=(48, 48), data_type=np.float64, maxcycle=10,
                maxtime=1e30, silent=5, write_output=False,
                measure_time=False)
    if P is not None:
        if len(jax.devices()) < int(np.prod(P)):
            pytest.skip("needs more devices")
        opts["P"] = P
    params = ArmonParameters(**opts)
    state = make_init(params)()
    E = np.asarray(state.E).copy()
    # Poison one cell that is REAL in both layouts: (g+5, g+5) sits in the
    # first shard's interior (under SPMD the state is the stack of padded
    # shard blocks, so the array center would be a ghost ring).
    g = params.nghost
    E[g + 5, g + 5] = np.nan
    state = state._replace(E=jax.numpy.asarray(E))
    state, t, cycles, dt, ok = make_jit_loop(params)(state)
    assert not bool(ok), "NaN state did not invalidate the time step"
    assert int(cycles) <= 2, f"abort took {int(cycles)} cycles"


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(100, 106))
def test_random_option_resume_bit_exact(seed, tmp_path):
    """Checkpoint/resume equivalence across the sampled option space: a
    straight 7-cycle run must be BIT-identical to 3 cycles + snapshot +
    resume for the remaining 4 — including the spicy interactions no
    hand-written restart test pairs up (dt_on_even_cycles resuming at an
    odd cycle, cst_dt, meshes)."""
    from armon_tpu import armon
    from armon_tpu.io.restart import save_checkpoint

    opts = _sample(random.Random(20260818 + seed))
    opts.update(maxcycle=7, return_data=True)
    needed = int(np.prod(opts.get("P", (1, 1))))
    if len(jax.devices()) < needed:
        pytest.skip(f"needs {needed} devices")
    label = {k: (v.__name__ if isinstance(v, type) else v)
             for k, v in opts.items()}

    ref = armon(ArmonParameters(**opts))

    p1 = ArmonParameters(**{**opts, "maxcycle": 3})
    part = armon(p1)
    ckpt = tmp_path / "fuzz.ckpt.npz"
    save_checkpoint(ckpt, p1, part.data, part.final_time, part.cycles,
                    part.last_dt)
    p2 = ArmonParameters(**opts)
    res = armon(p2, restore_from=str(ckpt))

    assert res.cycles == ref.cycles, label
    assert res.final_time == ref.final_time, label
    assert res.last_dt == ref.last_dt, label
    pref = ArmonParameters(**opts)
    a = gather_state(pref, ref.data)
    b = gather_state(p2, res.data)
    g = pref.nghost
    for var in ("rho", "u", "v", "E"):
        x = np.asarray(getattr(a, var))[g:-g, g:-g]
        y = np.asarray(getattr(b, var))[g:-g, g:-g]
        assert np.array_equal(x, y), f"{var}: {label}"


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(500, 504))
def test_random_option_reshard_resume(seed, tmp_path):
    """Elastic-restart fuzz: snapshot on one device layout, resume on a
    DIFFERENT one — compared against an uninterrupted run on the target
    layout. The reassembly path
    (`io/restart._reshard_load`) sees random schemes, splittings, dtypes,
    uneven extents and dt modes.

    Oracle strength: ulp-tight allclose, NOT bit-equality — cross-layout
    bit-equality is not an XLA-CPU guarantee for ANY case family.
    Measured (this fuzz's seed 500, then campaign seed 1000): XLA CPU's
    whole-cycle fusion can contract FMAs differently for different shard
    BLOCK SHAPES, so two layouts' jitted drivers can differ by 1 ulp on
    value-dependent rounding edges — the per-substep driver (smaller
    jits) shows ZERO cross-layout diffs on the same config, pinning it
    as a compile artifact, not solver math. Sod_circ+superbee+euler hits
    the edges too (a few ulps, flat in cycle count: 8e-16 rel at 7
    cycles, 4e-15 at 50); the stiff Bizarrium EOS amplifies its seed to
    ~2e-9 rel after 6 f64 cycles. The pure-I/O reshard LOAD (no solver
    math) stays bit-exact — gated by dryrun_multichip's elastic-restart
    leg and test_restart."""
    from armon_tpu import armon
    from armon_tpu.io.restart import save_checkpoint

    rng = random.Random(20260818 + seed)
    opts = _sample(rng)
    opts.update(maxcycle=7, return_data=True)
    opts.pop("use_MPI", None)
    src = opts.pop("P", None)
    layouts = [None, (2, 1), (1, 2), (2, 2), (3, 2)]
    dst = rng.choice([p for p in layouts if p != src])
    need = max(int(np.prod(src or (1,))), int(np.prod(dst or (1,))))
    if len(jax.devices()) < need:
        pytest.skip(f"needs {need} devices")
    label = {**{k: (v.__name__ if isinstance(v, type) else v)
                for k, v in opts.items()}, "src": src, "dst": dst}

    dkw = {"P": dst} if dst else {}
    pref = ArmonParameters(**{**opts, **dkw})
    ref = armon(pref)

    p1 = ArmonParameters(**{**opts, "maxcycle": 3,
                            **({"P": src} if src else {})})
    part = armon(p1)
    ckpt = tmp_path / "reshard.ckpt.npz"
    save_checkpoint(ckpt, p1, part.data, part.final_time, part.cycles,
                    part.last_dt, per_shard=src is not None)

    p2 = ArmonParameters(**{**opts, **dkw})
    res = armon(p2, restore_from=str(ckpt))

    f64 = np.dtype(ArmonParameters(**{**opts, **dkw}).config.dtype).itemsize == 8
    # perfect gas: ulp-class seeds only; stiff Bizarrium / Sedov amplify
    if opts["test"] in CONSERVATIVE:
        rtol = 1e-12 if f64 else 1e-5
    else:
        rtol = 1e-9 if f64 else 1e-4
    assert res.cycles == ref.cycles, label
    assert np.isclose(res.final_time, ref.final_time,
                      rtol=rtol, atol=0.0), label
    assert np.isclose(res.last_dt, ref.last_dt, rtol=rtol,
                      atol=0.0), label
    a = gather_state(pref, ref.data)
    b = gather_state(p2, res.data)
    g = pref.nghost
    for var in ("rho", "u", "v", "E"):
        x = np.asarray(getattr(a, var))[g:-g, g:-g]
        y = np.asarray(getattr(b, var))[g:-g, g:-g]
        assert np.allclose(x, y, rtol=rtol, atol=rtol), f"{var}: {label}"


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(200, 205))
def test_random_option_compare_roundtrip(seed, tmp_path):
    """step_checkpoint write-then-compare must round-trip CLEAN for any
    configuration (`src/io.jl:185-227`): an is_ref=True run writes every
    sub-step state (per-shard `_<cx>×<cy>` files under SPMD), and an
    identical is_ref=False run must compare equal at every sub-step and
    complete all its cycles."""
    from armon_tpu import armon

    opts = _sample(random.Random(20260818 + seed))
    opts.update(maxcycle=4, compare=True, output_dir=str(tmp_path),
                output_file="step", return_data=True)
    needed = int(np.prod(opts.get("P", (1, 1))))
    if len(jax.devices()) < needed:
        pytest.skip(f"needs {needed} devices")
    label = {k: (v.__name__ if isinstance(v, type) else v)
             for k, v in opts.items()}

    armon(ArmonParameters(is_ref=True, **opts))
    s = armon(ArmonParameters(is_ref=False, **opts))
    assert s.cycles == 4, f"compare stopped early (mismatch): {label}"


@pytest.mark.parametrize("seed", range(300, 305))
def test_random_option_output_roundtrip(seed, tmp_path):
    """Output I/O across the option space: a full run's written state file
    must read back EXACTLY (exact-decimal default precision), and the
    native C++ writer must stay byte-identical to the Python formatter at
    a RANDOM precision (the parity no fixed-config test can claim for the
    whole precision range)."""
    from armon_tpu.io.output import write_state_file, read_state_file
    from armon_tpu.io import native
    from armon_tpu import armon

    rng = random.Random(20260818 + seed)
    opts = _sample(rng)
    opts.pop("P", None)  # per-shard layout has its own windowed gates
    opts.update(maxcycle=4, return_data=True)
    params = ArmonParameters(**opts)
    cfg = params.config
    label = {k: (v.__name__ if isinstance(v, type) else v)
             for k, v in opts.items()}

    stats = armon(params)
    host = gather_state(params, stats.data)

    path = str(tmp_path / "out.csv")
    write_state_file(cfg, host, path)
    back = read_state_file(cfg, path)
    from armon_tpu.io.output import saved_vars_arrays, SAVED_VARS
    arrs = saved_vars_arrays(cfg, host)
    for v in SAVED_VARS:
        assert np.array_equal(back[v], arrs[v]), f"{v}: {label}"

    if native.available():
        prec = rng.choice([3, 6, 9, 12, 17])
        p_nat, p_py = str(tmp_path / "n.csv"), str(tmp_path / "p.csv")
        write_state_file(cfg, host, p_nat, precision=prec)
        orig = native.write_cells
        native.write_cells = lambda *a, **k: False
        try:
            write_state_file(cfg, host, p_py, precision=prec)
        finally:
            native.write_cells = orig
        assert open(p_nat, "rb").read() == open(p_py, "rb").read(), \
            f"native/python divergence at precision {prec}: {label}"


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(400, 408))
def test_random_tiny_grid(seed):
    """Degenerate extents: grids barely wider than the ghost band push the
    shifted-array stencils and the mirror fills through their narrowest
    cases. Driver equivalence is the oracle: the whole-run jitted loop
    must match the per-cycle host driver (one jitted cycle per call)
    bit-for-bit, with finite fields. (The per-substep driver compiles
    every sub-step alone, and XLA's CPU backend contracts FMAs across
    sub-step boundaries differently there: a few ulp on some configs.)"""
    from armon_tpu.core.solver import _python_cycle_driver
    rng = random.Random(20260818 + seed)
    opts = _sample(rng)
    opts.pop("P", None)
    opts.pop("use_MPI", None)
    g = opts["nghost"]
    opts["N"] = (rng.choice([max(2, g - 1), g, g + 1, 2 * g, 17]),
                 rng.choice([max(2, g - 1), g, g + 1, 2 * g, 23]))
    opts["data_type"] = np.float64
    opts["maxcycle"] = 5
    label = dict(opts)

    p = ArmonParameters(**opts)
    state, t, cycles, dt, ok = make_jit_loop(p)(make_init(p)())
    assert bool(ok), f"invalid dt: {label}"
    assert int(cycles) == 5, f"stopped early: {label}"
    sub, _, sub_cycles, sub_dt = _python_cycle_driver(p, make_init(p)())
    assert sub_cycles == 5 and sub_dt == float(dt), label
    a, b = gather_state(p, state), gather_state(p, sub)
    for v in ("rho", "u", "v", "E"):
        x = np.asarray(getattr(a, v))[g:-g, g:-g]
        y = np.asarray(getattr(b, v))[g:-g, g:-g]
        assert np.all(np.isfinite(x)), f"{v} not finite: {label}"
        assert np.array_equal(x, y), f"{v}: {label}"


def test_five_arg_user_checkpoint_hook():
    """armon(params, checkpoint=fn) with a classic 5-arg hook must keep
    working on schedules without repeated axes (every non-Strang
    schedule); only Strang's repeated sweep requires accepting `rep`."""
    from armon_tpu import armon

    calls = []

    def hook(label, state, axis, dt, cycle):  # no `rep` parameter
        calls.append((label, cycle))
        return False

    p = ArmonParameters(test="Sod", N=(40, 40), data_type=np.float64,
                        maxcycle=2, silent=5, write_output=False,
                        measure_time=False)
    armon(p, checkpoint=hook)
    assert any(lbl == "EOS" for lbl, _ in calls)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(600, 607))
def test_random_option_sharded_matches_single(seed):
    """Mesh run == single-device run across the sampled option space (the
    SPMD analog of the reference's `test/mpi.jl` golden gates, but for
    random configs its MPI suite can't run). Oracle policy mirrors
    test_random_option_reshard_resume: ulp-tight allclose, not
    bit-equality — XLA CPU contracts FMAs differently per shard block
    shape (measured, see that test's docstring), so no case family is
    exempt cross-layout; the pinned golden-config mesh matrix in
    test_mesh.py keeps the bit-exact anchor."""
    rng = random.Random(20260818 + seed)
    opts = _sample(rng)
    opts.pop("use_MPI", None)
    P = opts.pop("P", None) or rng.choice([(2, 1), (1, 2), (2, 2), (3, 2)])
    if len(jax.devices()) < int(np.prod(P)):
        pytest.skip(f"needs {int(np.prod(P))} devices")
    label = {**{k: (v.__name__ if isinstance(v, type) else v)
                for k, v in opts.items()}, "P": P}

    def solve(extra):
        p = ArmonParameters(**{**opts, **extra})
        state = make_init(p)()
        state, t, cycles, dt, ok = make_jit_loop(p)(state)
        assert bool(ok) and int(cycles) == opts["maxcycle"], label
        host = gather_state(p, state)
        g = p.nghost
        return {v: np.asarray(getattr(host, v))[g:-g, g:-g]
                for v in ("rho", "u", "v", "E")}, float(dt)

    a, dt_1 = solve({})
    b, dt_p = solve({"P": P})

    f64 = np.dtype(np.dtype(opts["data_type"])).itemsize == 8
    if opts["test"] in CONSERVATIVE:
        rtol = 1e-12 if f64 else 1e-5
    else:
        rtol = 1e-9 if f64 else 1e-4
    assert np.isclose(dt_1, dt_p, rtol=rtol, atol=0.0), label
    for var in a:
        assert np.allclose(a[var], b[var], rtol=rtol, atol=rtol), \
            f"{var}: {label}"


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(900, 908))
def test_random_option_axis_invariance_bitwise(seed):
    """Axis-invariance fuzz, BITWISE (`test/convergence.jl:31-64` made
    exact): a problem constant along one axis (Sod/Bizarrium along Y,
    Sod_y along X) must stay EXACTLY constant along it through full 2D
    sweep schedules — every transverse row/column sees identical inputs,
    and XLA's elementwise semantics apply the identical float sequence
    to each, so any nonzero transverse difference is a real leak (a
    coordinate mixed into sweep math, an asymmetric ghost fill, a chunk
    boundary touching real cells). Measured (probe seeds 900-915):
    bit-constant across all splittings and uneven meshes — where the reference
    gates this only at tolerance on one config. Mesh legs shard the
    constant axis too (transverse ppermute halos must preserve
    constancy bit-for-bit)."""
    rng = random.Random(20260818 + seed)
    opts = _sample(rng)
    case = rng.choice(["Sod", "Sod_y", "Bizarrium"])
    along_y = case in ("Sod", "Bizarrium")
    opts["test"] = case
    opts.pop("use_MPI", None)
    if opts.get("cst_dt"):
        opts["Dt"] = 1e-9 if case == "Bizarrium" else 1e-5
    needed = int(np.prod(opts.get("P", (1, 1))))
    if len(jax.devices()) < needed:
        pytest.skip(f"needs {needed} devices")
    label = {k: (v.__name__ if isinstance(v, type) else v)
             for k, v in opts.items()}

    params = ArmonParameters(**opts)
    state = make_init(params)()
    state, t, cycles, dt, ok = make_jit_loop(params)(state)
    assert bool(ok) and int(cycles) == opts["maxcycle"], label

    host = gather_state(params, state)
    g = params.nghost
    for var in ("rho", "u", "v", "E", "p"):
        a = np.asarray(getattr(host, var))[g:-g, g:-g]
        rows = a[1:, :] == a[:-1, :] if along_y else a[:, 1:] == a[:, :-1]
        assert rows.all(), \
            f"{var} not bit-constant along {'Y' if along_y else 'X'}: {label}"


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(800, 808))
def test_random_option_transpose_symmetry(seed):
    """X/Y transpose-symmetry fuzz (the `test_schemes.py` oracle across
    the option space): a run driven by X sweeps only must be the
    transpose — u and v swapped — of the same problem rotated 90° and
    driven by Y sweeps only. Sod pairs with Sod_y; Sod_circ and Sedov
    are their OWN transposes (radially symmetric init, `hypot` is
    argument-symmetric). Random scheme/limiter/projection/dtype/nghost/
    geometry/dt-mode, and transposed device meshes (P=(a,b) vs (b,a))
    when the sampler draws one. Measured (probe seeds 800-815 + 10 mesh
    legs): BIT-exact across the whole space, single device and
    transposed meshes alike — so it is gated with array_equal."""
    rng = random.Random(20260818 + seed)
    opts = _sample(rng)
    base = rng.choice(["Sod", "Sod_circ", "Sedov"])
    pair = {"Sod": "Sod_y"}.get(base, base)
    opts.pop("use_MPI", None)
    P = opts.pop("P", None)
    if opts.get("cst_dt"):
        opts["Dt"] = {"Sedov": 1e-7}.get(base, 1e-5)
    nx, ny = opts["N"]
    a_kw = dict(opts, test=base, axis_splitting="X_only", N=(nx, ny))
    b_kw = dict(opts, test=pair, axis_splitting="Y_only", N=(ny, nx))
    if P is not None:
        a_kw["P"] = P
        b_kw["P"] = (P[1], P[0])
        if len(jax.devices()) < int(np.prod(P)):
            pytest.skip(f"needs {int(np.prod(P))} devices")
    label = {k: (v.__name__ if isinstance(v, type) else v)
             for k, v in a_kw.items()}

    def solve(kw):
        p = ArmonParameters(**kw)
        state = make_init(p)()
        state, t, cycles, dt, ok = make_jit_loop(p)(state)
        assert bool(ok) and int(cycles) == opts["maxcycle"], label
        host = gather_state(p, state)
        g = p.nghost
        return {v: np.asarray(getattr(host, v))[g:-g, g:-g]
                for v in ("rho", "u", "v", "E", "p")}, float(dt)

    a, dt_x = solve(a_kw)
    b, dt_y = solve(b_kw)
    swap = {"u": "v", "v": "u"}
    assert dt_x == dt_y, label
    for var in a:
        assert np.array_equal(a[var], b[swap.get(var, var)].T), \
            f"{var} is not the transpose of {swap.get(var, var)}: {label}"


@pytest.mark.parametrize("seed", range(700, 707))
def test_random_option_ghost_poison(seed):
    """Ghost/dead-cell poison fuzz (the `test/convergence.jl:67-102` gate
    across the WHOLE option space): filling every non-real cell — ghost
    bands, corners, uneven-split dead slack — with a huge value must
    leave the real cells BIT-identical to the unpoisoned run of the same
    config. Same layout on both sides, so the equality is exact
    for every case/dtype. This is the direct gate on the unmasked
    padded-array design (docs/architecture.md)."""
    from armon_tpu.core.solver import _mesh_and_specs

    rng = random.Random(20260818 + seed)
    opts = _sample(rng)
    opts.pop("use_MPI", None)
    needed = int(np.prod(opts.get("P", (1, 1))))
    if len(jax.devices()) < needed:
        pytest.skip(f"needs {needed} devices")
    label = {k: (v.__name__ if isinstance(v, type) else v)
             for k, v in opts.items()}

    params = ArmonParameters(**opts)
    cfg = params.config
    g = cfg.nghost
    state0 = make_init(params)()
    loop = make_jit_loop(params)

    clean, t, cycles, dt_c, ok = loop(state0)
    assert bool(ok), label

    # Rebuild the init state and poison everything outside the per-shard
    # real windows (mask construction per test_both_axes_uneven_poisoned_slack).
    state = make_init(params)()
    lr, lc = cfg.local_shape
    px, py = cfg.proc_dims
    big = 1e100 if np.dtype(cfg.dtype).itemsize == 8 else 1e30

    def shard_mask(bx, by):
        m = np.ones((lr, lc), bool)
        nxl, nyl = cfg.n_local
        ex, ey = cfg.edge_cells
        hy = ey if by == py - 1 else nyl
        wx = ex if bx == px - 1 else nxl
        m[g:g + hy, g:g + wx] = False
        return m

    full_mask = np.block([[shard_mask(bx, by) for bx in range(px)]
                          for by in range(py)])
    if needed > 1:
        from jax.sharding import NamedSharding
        from armon_tpu.parallel.mesh import shard_state_spec
        mesh, _, _ = _mesh_and_specs(params)
        put = lambda a: jax.device_put(
            a, NamedSharding(mesh, shard_state_spec(cfg.axis_names)))
    else:
        put = jax.numpy.asarray
    poisoned = {}
    for var in ("rho", "u", "v", "E", "p", "c", "g"):
        a = np.asarray(jax.device_get(getattr(state, var))).copy()
        a[full_mask] = big
        poisoned[var] = put(a)
    state = state._replace(**poisoned)

    state, t, cycles_p, dt_p, ok = loop(state)
    assert bool(ok), f"poison invalidated the run: {label}"
    assert int(cycles_p) == int(cycles), label
    assert float(dt_p) == float(dt_c), f"poison changed dt: {label}"
    a = gather_state(params, clean)
    b = gather_state(params, state)
    for var in ("rho", "u", "v", "E"):
        x = np.asarray(getattr(a, var))[g:-g, g:-g]
        y = np.asarray(getattr(b, var))[g:-g, g:-g]
        assert np.array_equal(x, y), f"poison leaked into {var}: {label}"
