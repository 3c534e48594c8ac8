"""Multi-device sharding equivalence — the analog of the reference's MPI
test matrix (`test/mpi.jl:464-475,363-398`): N-device runs must reproduce the
single-device run bit-for-bit, and the halo exchange must move exactly the
right cells (DebugIndexes test, `test/mpi.jl:303-360`).

Runs on the virtual 8-device CPU mesh from conftest.
"""

import numpy as np
import pytest

import jax

from conftest import reference_params, ref_file, abs_tol, rel_tol

from armon_tpu import Axis
from armon_tpu.core.solver import (
    make_init, make_jit_loop, gather_state, _mesh_and_specs,
)
from armon_tpu.core.state import COMM_VARS
from armon_tpu.io.output import read_reference_csv, compare_states

# Process-grid matrix in the spirit of the reference (`test/mpi.jl:464-475`),
# restricted to grids that fit the 8 virtual devices. The grids that do not
# divide 100 evenly ((3,1), (1,3), (3,2)) exercise the uneven-split path:
# ceil-split shards with dead slack on the hi-edge shard, the analog of the
# reference's remainder-to-edge-ranks rule (`src/parameters.jl:673-697`).
MESHES = [(1, 2), (2, 1), (2, 2), (4, 2), (2, 4), (1, 4), (4, 1),
          (3, 1), (1, 3), (3, 2)]
# f32 on the mesh shapes of the four-card runs (chip_smoke.py --four-cards)
# and the other four-device row split.
CASES = ([(P, np.float64) for P in MESHES]
         + [(P, np.float32) for P in [(2, 2), (4, 1), (1, 4)]])


def run(params):
    state = make_init(params)()
    loop = make_jit_loop(params)
    state, t, cycles, dt, ok = loop(state)
    assert bool(ok)
    return gather_state(params, state), int(cycles), float(dt)


@pytest.mark.parametrize("P,dtype", CASES, ids=[
    f"{p[0]}x{p[1]}" + ("-f32" if d is np.float32 else "") for p, d in CASES])
def test_sharded_matches_single_device(P, dtype):
    needed = P[0] * P[1]
    if len(jax.devices()) < needed:
        pytest.skip(f"needs {needed} devices")
    single = reference_params("Sod_circ", dtype, maxcycle=20)
    ref_host, ref_cycles, ref_dt = run(single)

    sharded = reference_params("Sod_circ", dtype, maxcycle=20, P=P)
    host, cycles, dt = run(sharded)

    assert cycles == ref_cycles
    assert dt == ref_dt  # bit-exact: min/pmin are associative
    g = single.nghost
    for var in ("rho", "u", "v", "E", "p"):
        a = getattr(ref_host, var)[g:-g, g:-g]
        b = getattr(host, var)[g:-g, g:-g]
        assert np.array_equal(a, b), f"{var} differs on mesh {P}"


@pytest.mark.parametrize("P", [(2, 2), (4, 2), (3, 2)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
def test_sharded_against_golden(P):
    """Sharded run vs the sequential golden CSV — the analog of the
    sub-domain golden comparison (`test/mpi.jl:48-110`)."""
    if len(jax.devices()) < P[0] * P[1]:
        pytest.skip("not enough devices")
    dtype = np.float64
    params = reference_params("Sod", dtype, P=P)
    host, cycles, dt = run(params)
    cfg = params.config
    ref_dt, ref_cycles, ref = read_reference_csv(cfg, ref_file("Sod", dtype))
    assert cycles == ref_cycles
    cnt, max_diff, details = compare_states(
        cfg, host, ref, atol=abs_tol(dtype), rtol=rel_tol(dtype))
    assert cnt == 0 and max_diff == 0, details


def test_halo_debug_indexes():
    """After one halo exchange on a 2x2 mesh, every interior-facing ghost
    cell must hold its neighbour's global linear index
    (`test/mpi.jl:303-360` with the DebugIndexes case)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    params = reference_params("DebugIndexes", np.float64, N=(16, 16), P=(2, 2),
                              maxcycle=0)
    cfg = params.config
    state = make_init(params)()

    from armon_tpu.parallel.halo import halo_exchange
    mesh, state_spec, _ = _mesh_and_specs(params)

    # Poison every ghost cell so the exchange has to fill them
    # (DebugIndexes init already writes the analytic extension into ghosts).
    from jax.sharding import NamedSharding
    from armon_tpu.parallel.mesh import shard_state_spec
    sharding = NamedSharding(mesh, shard_state_spec(cfg.axis_names))
    g0 = cfg.nghost
    lr0, lc0 = cfg.local_shape
    px0, py0 = cfg.proc_dims
    ghost_mask = np.ones((lr0, lc0), bool)
    ghost_mask[g0:-g0, g0:-g0] = False
    full_mask = np.tile(ghost_mask, (py0, px0))
    poisoned = {}
    for var in COMM_VARS:
        a = np.asarray(jax.device_get(getattr(state, var))).copy()
        a[full_mask] = -1.0
        poisoned[var] = jax.device_put(a, sharding)
    state = state._replace(**poisoned)

    def do_exchange(s):
        s = halo_exchange(cfg, s, Axis.X)
        s = halo_exchange(cfg, s, Axis.Y)
        return s

    fn = jax.jit(jax.shard_map(do_exchange, mesh=mesh, in_specs=(state_spec,),
                               out_specs=state_spec, check_vma=False))
    state = fn(state)

    g = cfg.nghost
    nx, ny = cfg.n_global
    lr, lc = cfg.local_shape
    px, py = cfg.proc_dims

    blocked = np.asarray(jax.device_get(state.rho)).reshape(py, lr, px, lc)
    # Expected global index at any global (j, i) cell (0-based, ghosts use the
    # out-of-domain analytic extension)
    def lin(j, i):
        return i + j * nx + 1

    for by in range(py):
        for bx in range(px):
            block = blocked[by, :, bx, :]
            oy, ox = by * cfg.n_local[1], bx * cfg.n_local[0]
            for (jj, ii) in [(0, lc // 2), (lr - 1, lc // 2),
                             (lr // 2, 0), (lr // 2, lc - 1)]:
                gj, gi = oy + jj - g, ox + ii - g
                is_interior_ghost = (0 <= gj < ny) and (0 <= gi < nx)
                if is_interior_ghost:
                    assert block[jj, ii] == lin(gj, gi), \
                        f"block ({bx},{by}) ghost ({jj},{ii})"


def test_both_axes_uneven_bit_exact():
    """BOTH axes uneven at once — N=(100,99) over P=(3,2): ceil-split slack
    on X (34,34,32) and Y (50,49), a corner shard with dead cells in both
    dims, traced halo destinations on both axes and the CFL-mask cross
    term (`test/mpi.jl:464-475` + remainder rule `src/parameters.jl:673-697`).
    Must be bit-exact vs single-device."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    single = reference_params("Sod_circ", np.float64, N=(100, 99), maxcycle=20)
    ref_host, ref_cycles, ref_dt = run(single)
    sharded = reference_params("Sod_circ", np.float64, N=(100, 99),
                               maxcycle=20, P=(3, 2))
    cfg = sharded.config
    from armon_tpu import Axis as Ax
    assert cfg.uneven(Ax.X) and cfg.uneven(Ax.Y)
    host, cycles, dt = run(sharded)
    assert cycles == ref_cycles and dt == ref_dt
    g = single.nghost
    for var in ("rho", "u", "v", "E", "p"):
        a = getattr(ref_host, var)[g:-g, g:-g]
        b = getattr(host, var)[g:-g, g:-g]
        assert np.array_equal(a, b), f"{var} differs (both-axes-uneven)"


def test_both_axes_uneven_poisoned_slack():
    """1e100 poison in every ghost cell AND every dead slack cell of the
    edge shards must never reach a real cell (the sharded analog of
    `test/convergence.jl:67-102` plus the dead-slack invariant of the
    padded uneven-split design)."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    single = reference_params("Sod_circ", np.float64, N=(100, 99), maxcycle=15)
    ref_host, ref_cycles, ref_dt = run(single)

    params = reference_params("Sod_circ", np.float64, N=(100, 99),
                              maxcycle=15, P=(3, 2))
    cfg = params.config
    state = make_init(params)()

    from jax.sharding import NamedSharding
    from armon_tpu.parallel.mesh import shard_state_spec
    mesh, state_spec, _ = _mesh_and_specs(params)
    sharding = NamedSharding(mesh, shard_state_spec(cfg.axis_names))
    g = cfg.nghost
    lr, lc = cfg.local_shape
    px, py = cfg.proc_dims
    nxl, nyl = cfg.n_local
    ex, ey = cfg.edge_cells

    # Per-shard mask: everything OUTSIDE the real window (ghost bands,
    # mirror bands at per-shard positions, corners, dead slack)
    def shard_mask(bx, by):
        m = np.ones((lr, lc), bool)
        hy = ey if by == py - 1 else nyl
        wx = ex if bx == px - 1 else nxl
        m[g:g + hy, g:g + wx] = False
        return m

    full_mask = np.block([[shard_mask(bx, by) for bx in range(px)]
                          for by in range(py)])
    poisoned = {}
    for var in ("rho", "u", "v", "E", "p", "c", "g"):
        a = np.asarray(jax.device_get(getattr(state, var))).copy()
        a[full_mask] = 1e100
        poisoned[var] = jax.device_put(a, sharding)
    state = state._replace(**poisoned)

    loop = make_jit_loop(params)
    state, t, cycles, dt, ok = loop(state)
    assert bool(ok) and int(cycles) == ref_cycles
    assert float(dt) == ref_dt
    host = gather_state(params, state)
    gg = g
    for var in ("rho", "u", "v", "E"):
        a = getattr(ref_host, var)[gg:-gg, gg:-gg]
        b = getattr(host, var)[gg:-gg, gg:-gg]
        assert np.array_equal(a, b), f"{var}: poison leaked into real cells"


@pytest.mark.parametrize("test", ["Sedov", "Bizarrium"])
def test_sharded_sedov_bizarrium(test):
    """The reference excludes Sedov/Bizarrium from its MPI tests — they are
    broken under domain decomposition there (`test/mpi.jl:26-27`). The
    device-mesh path handles them: sharded == single-device bit-for-bit."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    single = reference_params(test, np.float64, maxcycle=25)
    ref_host, ref_cycles, ref_dt = run(single)
    sharded = reference_params(test, np.float64, maxcycle=25, P=(2, 2))
    host, cycles, dt = run(sharded)
    assert cycles == ref_cycles and dt == ref_dt
    g = single.nghost
    for var in ("rho", "u", "v", "E", "p"):
        a = getattr(ref_host, var)[g:-g, g:-g]
        b = getattr(host, var)[g:-g, g:-g]
        if test == "Sedov":
            assert np.array_equal(a, b), f"{var} differs for {test}"
        else:
            # Bizarrium's stiff-EOS polynomial chains pick up shard-shape-
            # dependent FMA contraction under XLA:CPU (~1-2 ulp per value);
            # the numerics are identical — the reference cannot run this
            # case under MPI at all (`test/mpi.jl:26-27`).
            # per-field scale: p crosses zero near the interface
            tol = 2e-13 * np.abs(a) + 1e-12 * np.abs(a).max()
            assert (np.abs(a - b) <= tol).all(), f"{var} differs for {test}"


def test_scatter_gather_roundtrip():
    """host_to_device(gather_state(s)) must reproduce the sharded state."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from armon_tpu.core.solver import host_to_device
    params = reference_params("Sod_circ", np.float64, N=(40, 40), P=(2, 2))
    state = make_init(params)()
    host = gather_state(params, state)
    back = host_to_device(params, host)
    for var in ("rho", "u", "v", "E", "x", "y"):
        a = np.asarray(jax.device_get(getattr(state, var)))
        b = np.asarray(jax.device_get(getattr(back, var)))
        assert np.array_equal(a, b), var


def test_uneven_roundtrip():
    """Scatter/gather consistency for an uneven split: the real+ghost
    window must survive a gather -> scatter -> gather roundtrip (the dead
    slack cells are not preserved by design)."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    from armon_tpu.core.solver import host_to_device
    params = reference_params("Sod_circ", np.float64, N=(50, 50), P=(3, 2))
    state = make_init(params)()
    host = gather_state(params, state)
    back = gather_state(params, host_to_device(params, host))
    for var in ("rho", "u", "v", "E", "x", "y"):
        a = np.asarray(getattr(host, var))
        b = np.asarray(getattr(back, var))
        assert np.array_equal(a, b), var


def test_uneven_split_shapes():
    """ceil-split bookkeeping: n_local/n_edge like the reference's
    remainder-to-edge rule (`src/parameters.jl:673-697`)."""
    p = reference_params("Sod", np.float64, N=(100, 100), P=(3, 2))
    assert p.n_local == (34, 50) and p.n_edge == (32, 50)
    cfg = p.config
    assert cfg.uneven(Axis.X) and not cfg.uneven(Axis.Y)
    with pytest.raises(Exception):
        # too small to split: edge shard would own < nghost cells
        reference_params("Sod", np.float64, N=(9, 9), P=(4, 1)).config


def test_dryrun_entry():
    """`__graft_entry__.dryrun_multichip` must compile and run on the
    virtual mesh."""
    import importlib.util, os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
