"""Profiling sections, timer report, the per-cycle solver log and the
profiler-trace reduction (the reference's `test/logging.jl` analog for the
observability layer, SURVEY.md §5)."""

import numpy as np
import pytest

from conftest import reference_params

from armon_tpu import armon, SolverException, ArmonParameters


def test_timer_report():
    params = reference_params("Sod", np.float64, maxcycle=3, measure_time=True)
    stats = armon(params)
    assert stats.timer is not None
    assert "init" in stats.timer and "solver_cycle" in stats.timer
    assert stats.timer["solver_cycle"]["seconds"] > 0
    assert stats.timer["solver_cycle"]["calls"] == 1


def test_solver_log():
    params = reference_params("Sod", np.float64, maxcycle=5, log_blocks=True)
    stats = armon(params)
    log = stats.grid_log
    assert log is not None and len(log.events) == 5
    a = log.analyse()
    assert a["cycles"] == 5
    assert a["mega_cells_per_sec"] > 0
    assert a["dt_first"] > 0 and a["final_time"] > 0
    assert "ms/cycle" in repr(log)
    # per-section breakdown (the analyse_log_stats analog): every
    # sub-step of both sweeps is timed, and shares sum to 1
    assert a["sections"], "section probe did not run"
    for sec in ("eos_X", "bc_X", "fluxes_Y", "remap_Y", "time_step"):
        assert a["sections"][sec] > 0, sec
    assert abs(sum(a["section_shares"].values()) - 1.0) < 1e-9


def test_trace_derived_sections(tmp_path):
    """`profiling=['trace']` + `log_blocks`: analyse()['sections'] must be
    the in-loop per-kernel DEVICE times parsed from the run's own XPlane
    dump (the reference's per-kernel profiling callbacks,
    src/profiling.jl:6-68), with the re-jitted probe numbers kept and
    labeled as probes."""
    params = reference_params("Sod", np.float64, maxcycle=5,
                              log_blocks=True, profiling=["trace"],
                              output_dir=str(tmp_path))
    stats = armon(params)
    a = stats.grid_log.analyse()
    assert stats.grid_log.trace_sections, "the trace yielded no kernels"
    assert a["sections_source"] == "trace"
    assert a["sections"], "trace yielded no kernels"
    assert all(v >= 0 for v in a["sections"].values())
    assert sum(a["sections"].values()) > 0
    # in-loop: each solver kernel ran ~once per cycle (compiles excluded)
    calls = [v["calls"] for v in a["trace_kernels"].values()]
    assert max(calls) >= 5, calls
    assert abs(sum(a["section_shares"].values()) - 1.0) < 1e-9
    # the probe numbers survive, labeled
    assert a["probe_sections"]["eos_X"] > 0
    assert "probe_section_shares" in a


def test_unknown_profiler_rejected():
    with pytest.raises(SolverException, match="Unknown profiler"):
        ArmonParameters(test="Sod", profiling=["nvtx"])


def test_domain_ranges():
    """Slice-algebra parity with `src/domain_ranges.jl` + steps ranges
    (`src/parameters.jl:988-1025`)."""
    from armon_tpu.utils.domain_ranges import (
        DomainRange, compute_steps_ranges)
    from armon_tpu.utils.enums import Axis

    r = DomainRange((0, 10), (0, 8))
    assert r.shape == (8, 10) and r.size == 80
    assert r.expand(Axis.X, 2, 3).x == (-2, 13)
    assert r.shift(Axis.Y, 4).y == (4, 12)
    assert r.inflate(4).shape == (16, 18)
    assert r.array_slices(4) == (slice(4, 12), slice(4, 14))

    # euler_2nd: extra = 2 (src/projection_schemes.jl:12)
    sr = compute_steps_ranges(Axis.X, (100, 100), 4, "euler_2nd")
    assert sr.fluxes.x == (-2, 103) and sr.fluxes.y == (0, 100)
    assert sr.cell_update.x == (-2, 102)
    assert sr.advection.x == (0, 101)
    assert sr.projection.x == (0, 100)
    assert sr.full_domain.shape == (108, 108)

    sr_y = compute_steps_ranges(Axis.Y, (100, 100), 4, "euler")
    assert sr_y.fluxes.y == (-1, 102) and sr_y.fluxes.x == (0, 100)


def test_solver_log_trend_and_collective_share():
    """Round-5 observability analogs (VERDICT r4 #8): per-half cycle-time
    trend (the `analyse_log_stats` variance diagnostics,
    src/logging.jl:75-300) and the collective-wait share (the MPI
    wait-fraction analog) from the trace kernel table."""
    from armon_tpu.utils.solver_log import SolverLog
    log = SolverLog(cell_count=100)
    for i, w in enumerate([0.010, 0.011, 0.020, 0.021]):
        log.push(i + 1, 0.1 * (i + 1), 1e-3, w)
    log.trace_sections = {
        "loop_fusion.3": {"seconds": 0.06, "calls": 4},
        "collective-permute.12": {"seconds": 0.03, "calls": 8},
        "all-reduce.7": {"seconds": 0.01, "calls": 4},
    }
    a = log.analyse()
    tr = a["cycle_time_trend"]
    assert tr["second_half_mean"] > tr["first_half_mean"]
    assert abs(tr["drift"] - (0.0205 - 0.0105) / a["mean_cycle_seconds"]) \
        < 1e-12
    assert abs(a["collective_seconds"] - 0.04) < 1e-12
    assert abs(a["collective_wait_share"] - 0.4) < 1e-12
    # trace shares replace probe shares and still sum to 1
    assert abs(sum(a["section_shares"].values()) - 1.0) < 1e-9


def test_profiler_trace_smoke(tmp_path):
    """profiling=['trace'] produces an XPlane dump directory."""
    params = reference_params("Sod", np.float64, maxcycle=2,
                              profiling=["trace"], output_dir=str(tmp_path))
    armon(params)
    prof = tmp_path / "profile"
    assert prof.exists() and any(prof.rglob("*.xplane.pb"))


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """A small recorded CPU trace of three calls of one jitted program."""
    import jax
    import jax.numpy as jnp
    d = tmp_path_factory.mktemp("trace")
    f = jax.jit(lambda x: jnp.sin(x) * 2.0 + jnp.cos(x).sum())
    x = jnp.ones((256, 256))
    jax.block_until_ready(f(x))
    with jax.profiler.trace(str(d)):
        for _ in range(3):
            jax.block_until_ready(f(x))
    return d


def test_trace_reader_cpu_events(cpu_trace):
    """The CPU fallback reads the host plane's executor lines: kernel
    events with durations, none of the thread-pool bookkeeping."""
    from armon_tpu.utils import xplane
    path = xplane.newest_dump(cpu_trace)
    ev = xplane.trace_events(path)
    assert ev["plane"] == "/host:CPU"
    assert ev["ops"], "no kernel events"
    names = {n for n, _, _ in ev["ops"]}
    assert not any(n.startswith(xplane._CPU_INFRA_PREFIXES) for n in names)
    assert all(d >= 0 for _, _, d in ev["ops"])
    table = xplane.parse_kernel_times(cpu_trace)
    # every kernel of the program ran once per call
    assert max(v["calls"] for v in table.values()) >= 3
    secs = [v["seconds"] for v in table.values()]
    assert secs == sorted(secs, reverse=True)


def test_trace_reader_interval_math():
    """busy = union of the event intervals; window = first start to last
    end; the table sums per name, seconds-descending."""
    from armon_tpu.utils.xplane import busy_seconds, window_seconds, \
        kernel_table
    ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("a", 30.0, 5.0),
           ("c", 31.0, 1.0)]
    assert busy_seconds(ops) == 20e-9
    assert window_seconds(ops) == 35e-9
    t = kernel_table(ops)
    assert list(t) == ["a", "b", "c"]
    assert t["a"] == {"seconds": 15e-9, "calls": 2}
    assert busy_seconds([]) == 0.0 and window_seconds([]) == 0.0


def test_trace_reader_raises_without_kernels(tmp_path):
    """No dump, or a dump without kernel events, raises — a traced run
    whose trace cannot be read fails instead of reporting nothing."""
    from armon_tpu.utils.xplane import parse_kernel_times, TraceParseError
    with pytest.raises(TraceParseError, match="no \\*.xplane.pb"):
        parse_kernel_times(tmp_path)
    import jax
    with jax.profiler.trace(str(tmp_path / "empty")):
        pass
    with pytest.raises(TraceParseError, match="no kernel events"):
        parse_kernel_times(tmp_path / "empty")
