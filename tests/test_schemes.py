"""Scheme-space coverage: every Riemann scheme x limiter x projection x
splitting combination must run, conserve, and agree bit-for-bit between
the three drivers — the whole-run jitted loop, the per-cycle host loop and
the per-substep checkpoint loop (the reference's scheme options,
SURVEY.md §2.5)."""

import numpy as np
import pytest

from conftest import reference_params

from armon_tpu.core.solver import (make_init, make_jit_loop, gather_state,
                                   _python_cycle_driver)


def run(params):
    state = make_init(params)()
    loop = make_jit_loop(params)
    state, t, cycles, dt, ok = loop(state)
    assert bool(ok)
    return gather_state(params, state), int(cycles), float(dt), float(t)


def run_cycle_driver(params):
    """The per-cycle host loop: one jitted cycle per call."""
    state, t, cycles, dt = _python_cycle_driver(params, make_init(params)())
    return gather_state(params, state), cycles, dt, t


def run_substep_driver(params):
    """The per-substep loop (`_checkpointed_cycle`): every solver sub-step
    is its own program, with a (no-op) checkpoint hook between them."""
    state, t, cycles, dt = _python_cycle_driver(
        params, make_init(params)(), checkpoint=lambda *a, **k: False)
    return gather_state(params, state), cycles, dt, t


DRIVERS = {"jit": run, "cycle": run_cycle_driver,
           "substep": run_substep_driver}


@pytest.mark.parametrize("scheme,limiter", [
    ("Godunov", "minmod"),
    ("GAD", "no_limiter"),
    ("GAD", "minmod"),
    ("GAD", "superbee"),
])
@pytest.mark.parametrize("projection", ["euler", "euler_2nd"])
def test_driver_equivalence(scheme, limiter, projection):
    kw = dict(N=(64, 64), maxcycle=8, scheme=scheme, riemann_limiter=limiter,
              projection=projection)
    _check_driver_equivalence(kw)


@pytest.mark.parametrize("splitting", ["Godunov", "Strang", "X_only"])
def test_driver_equivalence_splitting(splitting):
    """The repeated-axis schedule (Strang) and the parity-alternating
    orders must match across the drivers too."""
    kw = dict(N=(64, 64), maxcycle=9, axis_splitting=splitting)
    _check_driver_equivalence(kw)


def _check_driver_equivalence(kw):
    runs = {name: drive(reference_params("Sod_circ", np.float64, **kw))
            for name, drive in DRIVERS.items()}
    h1, c1, d1, t1 = runs["jit"]
    g = 4
    for name, (h2, c2, d2, t2) in runs.items():
        assert (c1, d1, t1) == (c2, d2, t2), name
        for var in ("rho", "u", "v", "E", "p"):
            a = getattr(h1, var)[g:-g, g:-g]
            b = getattr(h2, var)[g:-g, g:-g]
            assert np.array_equal(a, b), f"{name}: {var}"


@pytest.mark.parametrize("splitting", ["Sequential", "SequentialSym",
                                       "Godunov", "Strang", "X_only", "Y_only"])
def test_splitting_methods(splitting):
    params = reference_params("Sod" if splitting != "Y_only" else "Sod_y",
                              np.float64, N=(50, 50), maxcycle=20,
                              axis_splitting=splitting)
    host, cycles, dt, t = run(params)
    assert cycles == 20 and np.isfinite(dt) and t > 0
    g = params.nghost
    rho = host.rho[g:-g, g:-g]
    assert np.isfinite(rho).all() and (rho > 0).all()


def test_strang_conserves():
    from armon_tpu.core.solver import make_conservation
    params = reference_params("Sod_circ", np.float64, N=(50, 50), maxcycle=200,
                              axis_splitting="Strang")
    cons = make_conservation(params)
    state = make_init(params)()
    m0, e0 = map(float, cons(state))
    loop = make_jit_loop(params)
    state, t, cycles, dt, ok = loop(state)
    m1, e1 = map(float, cons(state))
    assert abs(m0 - m1) <= 1e-12 and abs(e0 - e1) <= 1e-12


def test_cst_dt():
    """cst_dt runs every cycle at exactly Dt (src/reductions.jl:131-133)."""
    params = reference_params("Sod", np.float64, N=(50, 50), maxcycle=10,
                              cst_dt=True, Dt=1e-4)
    host, cycles, dt, t = run(params)
    assert dt == 1e-4
    assert abs(t - 10 * 1e-4) < 1e-15


def test_dt_on_even_cycles():
    """dt only changes after even cycles (src/reductions.jl:135)."""
    from armon_tpu.core.solver import make_cycle
    from armon_tpu.ops.eos import update_eos
    params = reference_params("Sod", np.float64, N=(50, 50),
                              dt_on_even_cycles=True)
    cfg = params.config
    state = update_eos(cfg, make_init(params)())
    cyc = make_cycle(params)
    dts = []
    dt_prev = np.float64(0)
    for i in range(6):
        state, dt_use, dt_prev, ok = cyc(state, dt_prev, np.int32(i))
        dts.append(float(dt_use))
    # The dt is always one cycle stale (src/reductions.jl:117-125), so the
    # even-cycle recompute takes effect one cycle later and holds for two:
    # [c0, c0, c0, c2, c2, c4].
    assert dts[0] == dts[1] == dts[2]
    assert dts[3] == dts[4]
    assert dts[2] != dts[3]
    assert dts[4] != dts[5]


@pytest.mark.parametrize("scheme,projection,floor", [
    ("Godunov", "euler", 2),
    ("Godunov", "euler_2nd", 3),
    ("GAD", "euler", 3),
])
def test_min_ghost_run_matches_deep_ghost(scheme, projection, floor):
    """A run at the minimum ghost depth (stencil sum — see
    test_params.test_nghost_floor_is_sum) must be BIT-identical on the
    real cells to the same run with the default deep ghost band: every
    read of the scheme stays inside the band, so extra ghost rings can't
    change anything. This is the gate that catches an under-counted
    stencil floor (at the reference's product floor the edge real cells
    read wrap/pad garbage and this equality breaks)."""
    def real(nghost):
        params = reference_params("Sod_circ", np.float64, N=(64, 53),
                                  maxcycle=10, scheme=scheme,
                                  projection=projection, nghost=nghost)
        host, cycles, dt, t = run(params)
        assert cycles == 10 and np.isfinite(dt)
        g = params.nghost
        return {v: np.asarray(getattr(host, v))[g:-g, g:-g]
                for v in ("rho", "u", "v", "E")}, dt

    shallow, dt_s = real(floor)
    deep, dt_d = real(6)
    assert dt_s == dt_d
    for v in shallow:
        assert np.array_equal(shallow[v], deep[v]), \
            f"{scheme}+{projection} nghost={floor} vs 6: {v} differs"


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("scheme,limiter,projection,dtype", [
    ("Godunov", "no_limiter", "euler", np.float64),
    ("GAD", "minmod", "euler_2nd", np.float64),
    ("GAD", "superbee", "euler_2nd", np.float32),
], ids=["godunov-e1-f64", "gad-minmod-e2-f64", "gad-superbee-e2-f32"])
def test_xy_transpose_symmetry(driver, scheme, limiter, projection, dtype):
    """Sod driven by X sweeps only must be the exact TRANSPOSE of Sod_y
    driven by Y sweeps only — bit-for-bit, with u and v swapped. The two
    problems are the same 1D tube along different memory axes, and every
    kernel applies the same per-cell float sequence along columns (X) and
    rows (Y), so the X-sweep path, the Y-sweep path, the limiters,
    the projection and the dt reduction all pin each other. A single
    reordered FMA, an off-by-one stencil on ONE axis, or an asymmetric
    ghost fill breaks the equality. (No reference analog: its X/Y
    kernels are one generated body, `src/kernels.jl`; here the two axes
    are shifts along different array axes.) Each driver
    compiles its own programs, so each is pinned separately."""
    def solve(test, split, N):
        params = reference_params(test, dtype, N=N, maxcycle=10,
                                  scheme=scheme, riemann_limiter=limiter,
                                  projection=projection,
                                  axis_splitting=split)
        host, cycles, dt, t = DRIVERS[driver](params)
        assert cycles == 10
        g = params.nghost
        return {v: np.asarray(getattr(host, v))[g:-g, g:-g]
                for v in ("rho", "u", "v", "E", "p")}, dt

    a, dt_x = solve("Sod", "X_only", (64, 40))
    b, dt_y = solve("Sod_y", "Y_only", (40, 64))
    assert dt_x == dt_y
    swap = {"u": "v", "v": "u"}
    for var in a:
        other = swap.get(var, var)
        assert np.array_equal(a[var], b[other].T), \
            f"{var} is not the transpose of {other}"


def test_xy_transpose_symmetry_mesh():
    """The transpose oracle across the HALO paths: Sod/X_only on a (2,1)
    device mesh (X-axis ppermute exchange, column-edge BCs) vs Sod_y/Y_only
    on (1,2) (Y-axis exchange, row-edge BCs) must still be bit-exact
    transposes — pinning the two exchange directions and the traced
    edge-shard boundary fills against each other."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")

    def solve(test, split, N, P):
        params = reference_params(test, np.float64, N=N, maxcycle=10,
                                  axis_splitting=split, P=P)
        host, cycles, dt, t = run(params)
        assert cycles == 10
        g = params.nghost
        return {v: np.asarray(getattr(host, v))[g:-g, g:-g]
                for v in ("rho", "u", "v", "E")}, dt

    a, dt_x = solve("Sod", "X_only", (64, 41), (2, 1))
    b, dt_y = solve("Sod_y", "Y_only", (41, 64), (1, 2))
    assert dt_x == dt_y
    swap = {"u": "v", "v": "u"}
    for var in a:
        assert np.array_equal(a[var], b[swap.get(var, var)].T), var
