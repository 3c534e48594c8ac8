"""Front-end validation (`src/parameters.jl` option cascade)."""

import numpy as np
import pytest

from armon_tpu import ArmonParameters, SolverException, memory_required


def test_unknown_option_rejected():
    # Unconsumed options error with their names (src/parameters.jl:369-372)
    with pytest.raises(TypeError, match="unconsumed"):
        ArmonParameters(test="Sod", not_an_option=1)


def test_defaults_follow_test_case():
    # cfl/maxtime fall back to the test's defaults (src/parameters.jl:666-667)
    p = ArmonParameters(test="Sod")
    assert p.cfl == 0.95 and p.maxtime == 0.20
    p = ArmonParameters(test="Bizarrium")
    assert p.cfl == 0.6 and p.maxtime == 80e-6
    p = ArmonParameters(test="Sedov")
    assert p.cfl == 0.7 and p.domain_size == (2.0, 2.0) and p.origin == (-1.0, -1.0)


def test_sedov_f32_constants_round_once():
    """Sedov's r and high_E follow Julia promotion: hypot in T, the
    divides in f64, ONE final rounding to T (`src/tests.jl:17,114` —
    Float32/Float64 promotes to Float64 there). NumPy weak scalar
    promotion would keep `float32 / python-float` in f32, shifting r by
    1 ulp on ~15% of grid sizes (round-3 review finding). N=5 shifts both
    r and high_E; the golden N=100 rounds identically either way."""
    import math
    from armon_tpu.models.cases import Sedov
    T = np.float32
    n = 5
    dx = dy = 2.0 / n
    case = Sedov.from_cell_size(dx, dy, dtype=T)
    assert case.r == T(float(np.hypot(T(dx), T(dy))) / math.sqrt(2.0))
    # the f32-division result differs — the regression this test pins
    assert case.r != T(np.hypot(T(dx), T(dy)) / T(math.sqrt(2.0)))
    ip = case.init_params()
    assert T(ip.high_E) == T((1.0 / 1.033) ** 5
                             / float(T(math.pi) * case.r ** 2))


def test_nghost_floor_is_sum():
    """min_nghost = stencil(riemann) + stencil(projection) — deliberately
    TIGHTER than the reference's product rule (`src/parameters.jl:609-613`).
    The product under-counts the real dependency depth: the fluxes range
    extends stencil(projection)+1 past the real domain
    (`src/parameters.jl:1008`) and GAD reads one more cell on each side
    (`src/riemann_schemes.jl:66-81`), so e.g. GAD+euler at the product
    floor (2) makes the last real cell read PAST the ghost band (measured:
    wrapped rows in the shifted-array stencils). The
    rules coincide at GAD+euler_2nd (4) — the only floor the reference's
    suite exercises."""
    for scheme, projection, floor in [("GAD", "euler_2nd", 4),
                                      ("GAD", "euler", 3),
                                      ("Godunov", "euler_2nd", 3),
                                      ("Godunov", "euler", 2)]:
        with pytest.raises(SolverException, match="ghost"):
            ArmonParameters(test="Sod", scheme=scheme, projection=projection,
                            nghost=floor - 1)
        ArmonParameters(test="Sod", scheme=scheme, projection=projection,
                        nghost=floor)


def test_cst_dt_requires_Dt():
    with pytest.raises(SolverException, match="Dt"):
        ArmonParameters(test="Sod", cst_dt=True)


def test_invalid_names():
    for kw in [dict(scheme="bogus"), dict(projection="bogus"),
               dict(riemann_limiter="bogus"), dict(axis_splitting="bogus"),
               dict(test="bogus")]:
        with pytest.raises(SolverException):
            ArmonParameters(**kw)


def test_mesh_split_validation():
    p = ArmonParameters(test="Sod", N=(100, 100), P=(2, 2))
    assert p.n_local == (50, 50) and p.n_edge == (50, 50)
    # Uneven splits are accepted: ceil-split shards, remainder-short edge
    # shard (the analog of `src/parameters.jl:673-697`).
    p = ArmonParameters(test="Sod", N=(101, 100), P=(2, 1))
    assert p.n_local == (51, 100) and p.n_edge == (50, 100)
    with pytest.raises(SolverException, match="too small"):
        ArmonParameters(test="Sod", N=(8, 8), P=(4, 4), nghost=4)


def test_memory_required():
    p = ArmonParameters(test="Sod", N=(100, 100), nghost=4)
    mem = memory_required(p)
    # 11 fields x 108^2 cells x 8 bytes
    assert mem["per_device_state_bytes"] == 11 * 108 * 108 * 8


def test_f32_dtype():
    p = ArmonParameters(test="Sod", data_type=np.float32)
    assert p.data_type == np.float32
    p = ArmonParameters(test="Sod", data_type="Float32")
    assert p.data_type == np.float32


def test_reference_noop_options_accepted():
    # The reference's x86/MPI/GPU machinery options are accepted for config
    # compatibility (SURVEY.md §2.5) even though XLA owns those decisions.
    ArmonParameters(
        test="Sod", use_MPI=False, use_threading=False, use_simd=False,
        use_cache_blocking=False, async_cycle=True, numa_aware=True,
        lock_memory=False, workload_distribution="scotch", busy_wait_limit=100,
        use_two_step_reduction=True, gpu_aware=True, reorder_grid=True,
        use_gpu=False, device="CUDA",
    )


@pytest.mark.parametrize("option,value", [
    ("kernel_tier", "pallas"), ("use_fast_math", True),
    ("pair_threshold", 2048), ("temporal_blocking", 8),
    ("block_size", (64, 64)),
])
def test_removed_kernel_options_rejected(option, value):
    """The options that chose and tuned the removed fused-kernel tier are
    unknown options now: the usual unconsumed-options error names them."""
    with pytest.raises(TypeError, match=f"'{option}'"):
        ArmonParameters(test="Sod", **{option: value})


def test_block_memory_accounting():
    """Per-device byte accounting: fields, loop transients and the halo
    slabs of a padded block; the mesh total is per-device x devices."""
    from armon_tpu.params import block_memory
    mem = block_memory((100, 100), 4, 8)
    field = 108 * 108 * 8
    assert mem["per_device_field_bytes"] == field
    assert mem["per_device_state_bytes"] == 11 * field
    assert mem["per_device_transient_bytes"] == 5 * field
    assert mem["per_device_halo_bytes"] == 2 * (108 + 108) * 4 * 7 * 8
    assert mem["per_device_total_bytes"] == (
        16 * field + mem["per_device_halo_bytes"])
    p = ArmonParameters(test="Sod", N=(100, 99), P=(2, 3))
    m = p.memory_required()
    assert m["total_bytes"] == 6 * m["per_device_total_bytes"]
    assert m["per_device_field_bytes"] == (33 + 8) * (50 + 8) * 8
