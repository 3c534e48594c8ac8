"""Golden-data regression — the backbone of the test strategy
(`test/convergence.jl`, SURVEY.md §4).

Runs the 5 test cases x {Float32, Float64} on a 100x100 grid against the
frozen CSV references generated by the Julia reference's sequential scalar
CPU path (`test/reference_data/create_references.jl`). Sod variants must have
ZERO differences at atol/rtol of `reference_functions.jl:55-58`; Bizarrium
and Sedov are excluded from the zero assertion exactly like the reference
(`test/convergence.jl:24-27`), but their dt and cycle counts must match.
"""

import numpy as np
import pytest

from conftest import reference_params, ref_file, abs_tol, rel_tol

from armon_tpu import armon, Axis
from armon_tpu.io.output import read_reference_csv, compare_states
from armon_tpu.core.solver import gather_state, make_init, make_jit_loop


ALL_TESTS = ["Sod", "Sod_y", "Sod_circ", "Bizarrium", "Sedov"]
ZERO_DIFF_TESTS = {"Sod", "Sod_y", "Sod_circ"}


def run_reference(params):
    stats = armon(params)
    return stats, gather_state(params, stats.data)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("test", ALL_TESTS)
def test_golden(test, dtype):
    params = reference_params(test, dtype, return_data=True)
    stats, host = run_reference(params)
    cfg = params.config

    ref_dt, ref_cycles, ref = read_reference_csv(cfg, ref_file(test, dtype))
    atol, rtol = abs_tol(dtype), rel_tol(dtype)

    assert stats.cycles == ref_cycles
    assert abs(float(ref_dt) - stats.last_dt) <= max(atol, rtol * abs(float(ref_dt)))

    cnt, max_diff, details = compare_states(cfg, host, ref, atol=atol, rtol=rtol)
    if test in ZERO_DIFF_TESTS:
        assert cnt == 0, f"{cnt} diffs (max rel {max_diff}): {details}"
        assert max_diff == 0
    elif test == "Sedov":
        # Measured achievable bounds, pinned just above (the reference only
        # excludes these from its zero gate, `test/convergence.jl:24-27`;
        # these keep regression power). Measured: f64 zero-diff;
        # f32 767 diffs / max 2.5e-5.
        #
        # ROOT CAUSE of the f32 residual (round-4 probe, /tmp emulations
        # recorded in docs/parity_notes.md): the reference's f32 run is not
        # pure f32 — Julia f64 literals promote the EOS chain
        # (`e = E - 0.5*(u^2+v^2)`, `p = (gamma - 1.)*rho*e`,
        # src/kernels.jl:9-10: p stored with ONE f32 rounding) and the dt
        # cap arm (`1.05*previous_dt` in f64, src/solver_state.jl:129),
        # while this repo computes pure-T chains. The deviation is ulp-level
        # and ladder-invisible for the Sod family, but Sedov amplifies it
        # chaotically at the blast front (the +5% cap binds for hundreds of
        # cycles while dt recovers from the energy-spike seed): emulating
        # the promoted EOS and/or cap on CPU moves the count (767 pure-f32,
        # 526 f64-chain+cap, 864 f32-squares variant) without zeroing it —
        # i.e. any ulp-level perturbation lands in the same few-hundred-cell
        # / 1-3e-5 band, so the gate below pins that band, and matching the
        # golden bit-for-bit would require replicating Julia's promotion at
        # every op (extra converts in the hot kernels for no accuracy gain).
        if dtype is np.float64:
            assert cnt == 0 and max_diff == 0, details
        else:
            assert cnt <= 1500 and max_diff < 1e-4, details
    else:
        # Bizarrium: p crosses zero at the interface, so its RELATIVE diff
        # is unbounded there — gate the non-p fields tightly plus overall
        # diff-count ceilings. Measured: f64 12800 diffs, non-p 9.5e-14,
        # p 5.3e-7; f32 4500 diffs, non-p 4.3e-4, p 0.91.
        non_p = max((m for v, (c, m) in details.items() if v != "p"),
                    default=0.0)
        if dtype is np.float64:
            assert cnt <= 16000 and non_p < 1e-12 and max_diff < 1e-5, details
        else:
            assert cnt <= 6000 and non_p < 5e-3, details


@pytest.mark.parametrize("test,axis", [("Sod", Axis.Y), ("Sod_y", Axis.X),
                                       ("Bizarrium", Axis.Y)])
def test_axis_invariance(test, axis):
    """Solutions of X-only problems must be constant along Y and vice versa
    (`test/convergence.jl:31-64`)."""
    params = reference_params(test, np.float64, return_data=True)
    _, host = run_reference(params)
    g = params.nghost
    atol, rtol = abs_tol(np.float64), rel_tol(np.float64)

    for var in ("rho", "u", "v", "E", "p", "c", "g"):
        a = getattr(host, var)[g:-g, g:-g]
        if axis is Axis.Y:
            d = np.abs(a[1:, :] - a[:-1, :])
            tol = np.maximum(atol, rtol * np.maximum(np.abs(a[1:, :]), np.abs(a[:-1, :])))
        else:
            d = np.abs(a[:, 1:] - a[:, :-1])
            tol = np.maximum(atol, rtol * np.maximum(np.abs(a[:, 1:]), np.abs(a[:, :-1])))
        assert int((d > tol).sum()) == 0, f"axis invariance broken for {var}"


def test_ghost_poisoning():
    """1e100 in the ghost cells must never propagate into real cells
    (`test/convergence.jl:67-102`)."""
    dtype = np.float64
    params = reference_params("Sod_circ", dtype, return_data=True)
    cfg = params.config
    state = make_init(params)()

    g = cfg.nghost
    rows, cols = cfg.local_shape
    mask = np.ones((rows, cols), bool)
    mask[g:-g, g:-g] = False
    big = 1e100

    poisoned = {}
    for var in ("rho", "u", "v", "E", "p", "c", "g"):
        a = np.asarray(getattr(state, var)).copy()
        a[mask] = big
        poisoned[var] = a
    state = state._replace(**{k: v for k, v in poisoned.items()})

    loop = make_jit_loop(params)
    final, t, cycles, dt_last, ok = loop(state)
    assert bool(ok)

    ref_dt, ref_cycles, ref = read_reference_csv(cfg, ref_file("Sod_circ", dtype))
    assert int(cycles) == ref_cycles

    host = gather_state(params, final)
    cnt, max_diff, details = compare_states(
        cfg, host, ref, atol=abs_tol(dtype), rtol=rel_tol(dtype))
    assert cnt == 0 and max_diff == 0, details
