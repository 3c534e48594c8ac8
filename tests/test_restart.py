"""Checkpoint / restart: an interrupted run resumed from a snapshot must be
bit-identical to an uninterrupted run (every driver, incl. sharded)."""

import numpy as np
import pytest

import jax

from conftest import reference_params

from armon_tpu import armon
from armon_tpu.core.solver import gather_state
from armon_tpu.io.restart import save_checkpoint, load_checkpoint
from armon_tpu.utils.errors import SolverException


def full_run(test, maxcycle, **kw):
    params = reference_params(test, np.float64, maxcycle=maxcycle,
                              return_data=True, **kw)
    stats = armon(params)
    return params, stats


@pytest.mark.parametrize("driver", ["jit", "cycle"])
def test_resume_bit_exact(driver, tmp_path):
    ref_params, ref = full_run("Sod_circ", 20)

    # run 8 cycles, snapshot, resume for the remaining 12
    p1, s1 = full_run("Sod_circ", 8)
    ckpt = tmp_path / "run.ckpt.npz"
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt)

    # a checkpoint_step the run never reaches still selects the per-cycle
    # host driver (one jitted cycle per call)
    kw = dict(checkpoint_step=1000, output_dir=str(tmp_path)) \
        if driver == "cycle" else {}
    p2 = reference_params("Sod_circ", np.float64, maxcycle=20,
                          return_data=True, **kw)
    s2 = armon(p2, restore_from=str(ckpt))
    assert s2.cycles == ref.cycles
    assert s2.final_time == ref.final_time
    assert s2.last_dt == ref.last_dt

    a = gather_state(ref_params, ref.data)
    b = gather_state(p2, s2.data)
    g = ref_params.nghost
    for var in ("rho", "u", "v", "E"):
        x = getattr(a, var)[g:-g, g:-g]
        y = getattr(b, var)[g:-g, g:-g]
        assert np.array_equal(x, y), var


def test_resume_odd_cycle_dt_on_even_cycles(tmp_path):
    """A resume at an ODD cycle under dt_on_even_cycles must keep the
    saved dt for that cycle (no recompute) exactly like the uninterrupted
    run (`src/reductions.jl:135`)."""
    kw = dict(dt_on_even_cycles=True)
    ref_params, ref = full_run("Sod_circ", 14, **kw)
    p1, s1 = full_run("Sod_circ", 7, **kw)
    ckpt = tmp_path / "odd.ckpt.npz"
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt)
    p2 = reference_params("Sod_circ", np.float64, maxcycle=14,
                          return_data=True, **kw)
    s2 = armon(p2, restore_from=str(ckpt))
    assert (s2.cycles, s2.final_time, s2.last_dt) == \
        (ref.cycles, ref.final_time, ref.last_dt)
    a = gather_state(ref_params, ref.data)
    b = gather_state(p2, s2.data)
    g = ref_params.nghost
    for var in ("rho", "u", "v", "E"):
        assert np.array_equal(getattr(a, var)[g:-g, g:-g],
                              getattr(b, var)[g:-g, g:-g]), var


def test_resume_from_periodic_checkpoint(tmp_path):
    """The `checkpoint_step` snapshot written mid-run by the per-cycle
    driver resumes bit-exactly to the uninterrupted run's end."""
    ref_params, ref = full_run("Sod", 10)
    params = reference_params("Sod", np.float64, maxcycle=6,
                              checkpoint_step=3, output_dir=str(tmp_path),
                              output_file="run")
    armon(params)
    p2 = reference_params("Sod", np.float64, maxcycle=10, return_data=True)
    s2 = armon(p2, restore_from=str(tmp_path / "run.ckpt.npz"))
    assert (s2.cycles, s2.final_time, s2.last_dt) == \
        (ref.cycles, ref.final_time, ref.last_dt)
    a = gather_state(ref_params, ref.data)
    b = gather_state(p2, s2.data)
    g = ref_params.nghost
    for var in ("rho", "u", "v", "E"):
        assert np.array_equal(getattr(a, var)[g:-g, g:-g],
                              getattr(b, var)[g:-g, g:-g]), var


def test_checkpoint_scalars_roundtrip(tmp_path):
    """A snapshot holds the fingerprint, t, cycle and dt_prev — read back
    exactly — and the fields."""
    p1, s1 = full_run("Sod", 4)
    ckpt = tmp_path / "x.ckpt.npz"
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt)
    with np.load(ckpt) as z:
        scalars = sorted(k for k in z.files if k.startswith("__"))
    assert scalars == ["__cycles", "__dt_prev", "__fingerprint", "__t"]
    _, t, cycles, dt_prev = load_checkpoint(ckpt, p1)
    assert (t, cycles, dt_prev) == (s1.final_time, s1.cycles, s1.last_dt)


def test_checkpoint_step_option(tmp_path):
    params = reference_params("Sod", np.float64, maxcycle=6,
                              checkpoint_step=2, output_dir=str(tmp_path),
                              output_file="run")
    armon(params)
    ckpt = tmp_path / "run.ckpt.npz"
    assert ckpt.exists()
    p2 = reference_params("Sod", np.float64, maxcycle=6,
                          output_dir=str(tmp_path), output_file="run")
    state, t, cycles, dt_prev = load_checkpoint(ckpt, p2)
    assert cycles == 6 and t > 0


def test_fingerprint_mismatch(tmp_path):
    p1, s1 = full_run("Sod", 2)
    ckpt = tmp_path / "x.npz"
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt)
    p_other = reference_params("Sod_circ", np.float64, maxcycle=2)
    with pytest.raises(SolverException, match="different"):
        load_checkpoint(ckpt, p_other)


@pytest.mark.parametrize("P", [(2, 2), (3, 2)], ids=lambda p: f"{p[0]}x{p[1]}")
def test_resume_per_shard_no_gather(tmp_path, P, monkeypatch):
    """Per-shard snapshot layout: one npz per shard via shard_coords_iter,
    loaded back with make_array_from_single_device_arrays — NO global
    gather anywhere (asserted by poisoning gather_state), resume bit-exact
    (incl. a both-axes-uneven mesh)."""
    if len(jax.devices()) < P[0] * P[1]:
        pytest.skip("not enough devices")
    N = (40, 39) if P == (3, 2) else (40, 40)
    ref_params, ref = full_run("Sod_circ", 12, P=P, N=N)
    p1, s1 = full_run("Sod_circ", 5, P=P, N=N)

    import armon_tpu.core.solver as solver_mod

    def no_gather(*a, **k):
        raise AssertionError("gather_state called in the no-gather path")

    ckpt = tmp_path / "s.ckpt.npz"
    orig = solver_mod.gather_state
    monkeypatch.setattr(solver_mod, "gather_state", no_gather)
    try:
        save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles,
                        s1.last_dt, per_shard=True)
        assert not ckpt.exists()  # only per-shard files
        assert (tmp_path / "s.ckpt_0×0.npz").exists()
        assert (tmp_path / f"s.ckpt_{P[0]-1}×{P[1]-1}.npz").exists()

        p2 = reference_params("Sod_circ", np.float64, maxcycle=12, N=N,
                              return_data=True, P=P)
        state, t, cycles, dt_prev = load_checkpoint(ckpt, p2)
        # the reloaded device blocks are bit-identical to the running ones
        for var in ("rho", "u", "v", "E"):
            a = np.asarray(jax.device_get(getattr(s1.data, var)))
            b = np.asarray(jax.device_get(getattr(state, var)))
            assert np.array_equal(a, b), var
    finally:
        monkeypatch.setattr(solver_mod, "gather_state", orig)

    s2 = armon(p2, restore_from=str(ckpt))
    assert s2.cycles == ref.cycles and s2.last_dt == ref.last_dt
    a = gather_state(ref_params, ref.data)
    b = gather_state(p2, s2.data)
    g = ref_params.nghost
    for var in ("rho", "u", "v", "E"):
        assert np.array_equal(getattr(a, var)[g:-g, g:-g],
                              getattr(b, var)[g:-g, g:-g]), var


def test_checkpoint_step_per_shard(tmp_path):
    """checkpoint_step on a use_MPI mesh writes the per-shard layout."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    params = reference_params("Sod", np.float64, N=(40, 40), maxcycle=4,
                              checkpoint_step=2, P=(2, 2), use_MPI=True,
                              output_dir=str(tmp_path), output_file="run")
    armon(params)
    assert not (tmp_path / "run.ckpt.npz").exists()
    for cx in range(2):
        for cy in range(2):
            assert (tmp_path / f"run.ckpt_{cx}×{cy}.npz").exists()
    p2 = reference_params("Sod", np.float64, N=(40, 40), maxcycle=4,
                          P=(2, 2), use_MPI=True)
    state, t, cycles, dt_prev = load_checkpoint(
        tmp_path / "run.ckpt.npz", p2)
    assert cycles == 4 and t > 0


@pytest.mark.parametrize("src,dst,N", [
    ((2, 2), None, (40, 40)),    # per-shard mesh snapshot -> single device
    (None, (2, 2), (40, 40)),    # single-device global snapshot -> mesh
    ((3, 2), (2, 2), (40, 39)),  # mesh -> different mesh, both-axes-uneven
], ids=["mesh_to_single", "single_to_mesh", "mesh_to_mesh"])
def test_reshard_resume(tmp_path, src, dst, N):
    """Snapshots are MESH-NEUTRAL: the fingerprint pins the numerics only,
    so a snapshot saved on one device layout resumes on another — and the
    resumed run is BIT-identical to an uninterrupted run on the target
    layout (invariant 2: the decomposition never changes the numbers).
    Covers per-shard files resharded onto a single device, a global
    snapshot decomposed onto a mesh, and a mesh->mesh layout change with
    slack on both axes (`io/restart._reshard_load`)."""
    if len(jax.devices()) < max(int(np.prod(src or (1,))),
                                int(np.prod(dst or (1,)))):
        pytest.skip("not enough devices")

    dkw = {"P": dst} if dst else {}
    ref_params, ref = full_run("Sod_circ", 12, N=N, **dkw)
    p1, s1 = full_run("Sod_circ", 5, N=N, **({"P": src} if src else {}))
    ckpt = tmp_path / "r.ckpt.npz"
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt,
                    per_shard=src is not None)
    if src is not None:
        assert not ckpt.exists()  # genuinely loading from per-shard files

    p2 = reference_params("Sod_circ", np.float64, maxcycle=12, N=N,
                          return_data=True, **dkw)
    s2 = armon(p2, restore_from=str(ckpt))
    assert s2.cycles == ref.cycles and s2.last_dt == ref.last_dt
    a = gather_state(ref_params, ref.data)
    b = gather_state(p2, s2.data)
    g = ref_params.nghost
    for var in ("rho", "u", "v", "E"):
        assert np.array_equal(getattr(a, var)[g:-g, g:-g],
                              getattr(b, var)[g:-g, g:-g]), var


def test_resume_sharded(tmp_path):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    ref_params, ref = full_run("Sod", 12, P=(2, 2))
    p1, s1 = full_run("Sod", 5, P=(2, 2))
    ckpt = tmp_path / "s.npz"
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt)
    p2 = reference_params("Sod", np.float64, maxcycle=12, return_data=True,
                          P=(2, 2))
    s2 = armon(p2, restore_from=str(ckpt))
    assert s2.cycles == ref.cycles and s2.last_dt == ref.last_dt
    a = gather_state(ref_params, ref.data)
    b = gather_state(p2, s2.data)
    g = ref_params.nghost
    for var in ("rho", "u", "v", "E"):
        assert np.array_equal(getattr(a, var)[g:-g, g:-g],
                              getattr(b, var)[g:-g, g:-g]), var


def test_reshard_load_is_windowed(tmp_path, monkeypatch):
    """The resharding restore must stay O(shard): every source-file window
    `_reshard_load` requests is bounded by one TARGET padded block — no
    O(global) reassembly (VERDICT-r3 weak #4; the pre-round-4 path built
    the full global array on host)."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    import armon_tpu.io.restart as restart

    p1, s1 = full_run("Sod", 3, N=(40, 39), P=(3, 2))
    ckpt = tmp_path / "w.ckpt.npz"
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt,
                    per_shard=True)

    p2 = reference_params("Sod", np.float64, maxcycle=3, N=(40, 39),
                          return_data=True, P=(2, 2))
    lr, lc = p2.config.local_shape
    windows = []
    orig = restart._window_from_shards

    def spy(path, params, geom, r0, r1, c0, c1, meta_box, **kw):
        windows.append((r1 - r0, c1 - c0))
        return orig(path, params, geom, r0, r1, c0, c1, meta_box, **kw)

    monkeypatch.setattr(restart, "_window_from_shards", spy)
    state, t, cycles, dt_prev = load_checkpoint(ckpt, p2)
    assert windows, "reshard load did not go through the windowed reader"
    assert all(h <= lr and w <= lc for h, w in windows), windows
    # and the loaded state matches a direct same-layout gather of the run
    a = gather_state(p1, s1.data)
    b = gather_state(p2, state)
    g = p2.nghost
    for var in ("rho", "u", "v", "E"):
        assert np.array_equal(getattr(a, var)[g:-g, g:-g],
                              getattr(b, var)[g:-g, g:-g]), var
