"""Per-shard (sub-domain) I/O — the analog of the reference's distributed
output files (`src/io.jl:46-75`) and of the sub-domain-vs-global-golden
comparator (`test/mpi.jl:48-110`). No global gather anywhere in these paths.
"""

import os

import numpy as np
import pytest

import jax

from conftest import reference_params, ref_file, abs_tol, rel_tol

from armon_tpu import armon
from armon_tpu.core.solver import make_init, make_jit_loop, gather_state
from armon_tpu.core.state import SAVED_VARS
from armon_tpu.io.subdomain import (
    write_sub_domain_files, read_global_file_window, sub_domain_file_path,
    shard_real_window, compare_sub_domain_with_golden, shard_coords_iter,
)


def _run(params):
    state = make_init(params)()
    loop = make_jit_loop(params)
    state, t, cycles, dt, ok = loop(state)
    assert bool(ok)
    return state, int(cycles)


@pytest.mark.parametrize("P", [(2, 2), (3, 2)], ids=lambda p: f"{p[0]}x{p[1]}")
def test_sharded_golden_no_gather(P):
    """Every shard's window must match the sequential golden CSV with ZERO
    differences — without materializing the global array
    (`test/mpi.jl:94-130`)."""
    if len(jax.devices()) < P[0] * P[1]:
        pytest.skip("not enough devices")
    dtype = np.float64
    params = reference_params("Sod", dtype, P=P)
    state, cycles = _run(params)
    ref_dt, ref_cycles, cnt, max_diff = compare_sub_domain_with_golden(
        params, state, ref_file("Sod", dtype),
        atol=abs_tol(dtype), rtol=rel_tol(dtype))
    assert cycles == ref_cycles
    assert cnt == 0 and max_diff == 0


def test_window_reader_matches_full_read(tmp_path):
    """Windows of a global file == slices of the gathered write."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    from armon_tpu.io.output import write_state_file, read_state_file
    params = reference_params("Sod_circ", np.float64, N=(50, 40), P=(3, 2),
                              maxcycle=5)
    cfg = params.config
    state, _ = _run(params)
    host = gather_state(params, state)
    path = str(tmp_path / "global")
    write_state_file(cfg, host, path)
    full = read_state_file(cfg, path)
    for coords, _blocks in shard_coords_iter(params, state):
        _, win = read_global_file_window(cfg, path, coords)
        rs, cs, r0, c0 = shard_real_window(cfg, coords)
        hy, wx = rs.stop - rs.start, cs.stop - cs.start
        for v in SAVED_VARS:
            a = full[v][r0:r0 + hy, c0:c0 + wx]
            assert np.array_equal(a, win[v]), (coords, v)


def test_per_shard_files_roundtrip(tmp_path):
    """write_sub_domain_files output == the matching windows of the
    gathered state (file formatting roundtrips exactly)."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    from armon_tpu.io.output import _read_rows
    params = reference_params("Sod", np.float64, N=(50, 50), P=(3, 2),
                              maxcycle=5)
    cfg = params.config
    state, _ = _run(params)
    base = str(tmp_path / "out")
    paths = write_sub_domain_files(params, state, base)
    assert len(paths) == 6
    host = gather_state(params, state)
    g = cfg.nghost
    for coords, _blocks in shard_coords_iter(params, state):
        p = sub_domain_file_path(base, coords)
        assert p in paths and os.path.exists(p)
        _, data = _read_rows(p, cfg.dtype)
        rs, cs, r0, c0 = shard_real_window(cfg, coords)
        hy, wx = rs.stop - rs.start, cs.stop - cs.start
        assert data.shape == (hy * wx, len(SAVED_VARS))
        for k, v in enumerate(SAVED_VARS):
            a = np.asarray(getattr(host, v))[g + r0:g + r0 + hy,
                                             g + c0:g + c0 + wx]
            assert np.array_equal(a, data[:, k].reshape(hy, wx)), (coords, v)


def test_both_axes_uneven_windows(tmp_path):
    """Window reader + per-shard writer under a BOTH-axes-uneven split
    (N=(50,49) over P=(3,2): corner shard short in both dims)."""
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    from armon_tpu.io.output import write_state_file, read_state_file, _read_rows
    params = reference_params("Sod_circ", np.float64, N=(50, 49), P=(3, 2),
                              maxcycle=5)
    cfg = params.config
    from armon_tpu import Axis as Ax
    assert cfg.uneven(Ax.X) and cfg.uneven(Ax.Y)
    state, _ = _run(params)
    host = gather_state(params, state)
    path = str(tmp_path / "global")
    write_state_file(cfg, host, path)
    full = read_state_file(cfg, path)
    seen = 0
    for coords, blocks in shard_coords_iter(params, state):
        _, win = read_global_file_window(cfg, path, coords)
        rs, cs, r0, c0 = shard_real_window(cfg, coords)
        hy, wx = rs.stop - rs.start, cs.stop - cs.start
        for v in SAVED_VARS:
            assert np.array_equal(full[v][r0:r0 + hy, c0:c0 + wx],
                                  win[v]), (coords, v)
            assert np.array_equal(blocks[v][rs, cs],
                                  win[v]), (coords, v, "shard vs window")
        seen += hy * wx
    assert seen == 50 * 49  # every real cell covered exactly once


def test_armon_writes_per_shard_files(tmp_path):
    """End-to-end: write_output + use_MPI on a mesh writes `_<cx>×<cy>`
    files (`src/io.jl:53-56` naming), not one global file."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    params = reference_params("Sod", np.float64, N=(40, 40), P=(2, 2),
                              maxcycle=3, use_MPI=True, write_output=True,
                              output_dir=str(tmp_path), output_file="sub")
    armon(params)
    files = sorted(os.listdir(tmp_path))
    assert files == ["sub_0×0", "sub_0×1", "sub_1×0", "sub_1×1"], files


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_window_reader_native_python_parity(tmp_path, dtype, monkeypatch):
    """The native window streamer (armon_read_window) must agree with the
    pure-Python fallback bit-for-bit on every shard window — with and
    without a header line and ghost bands, at both dtypes (the f32 leg
    pins the parse-at-run-dtype behavior through the f64 native parse)."""
    from armon_tpu.io import native
    from armon_tpu.io.output import write_state_file
    if not native.available():
        pytest.skip("native io not built")
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")

    params = reference_params("Sod_circ", dtype, N=(50, 41), P=(3, 2),
                              maxcycle=4)
    cfg = params.config
    state, _ = _run(params)
    host = gather_state(params, state)
    plain = str(tmp_path / "global")
    write_state_file(cfg, host, plain)
    ghosted = str(tmp_path / "ghosted")
    write_state_file(cfg, host, ghosted, with_ghosts=True)
    headed = str(tmp_path / "headed")
    with open(headed, "w") as f:
        f.write("0.125, 4\n" + open(plain).read())

    cases = [(plain, dict()), (ghosted, dict(with_ghosts=True)),
             (headed, dict(skip_header=True))]
    for coords, _blocks in shard_coords_iter(params, state):
        for path, kw in cases:
            _, nat = read_global_file_window(cfg, path, coords, **kw)
            monkeypatch.setattr(native, "read_window",
                                lambda *a, **k: None)
            try:
                hdr, py = read_global_file_window(cfg, path, coords, **kw)
            finally:
                monkeypatch.undo()
            for v in SAVED_VARS:
                assert np.array_equal(nat[v], py[v]), (coords, path, v)
    assert hdr == "0.125, 4"


def test_window_reader_truncated_file(tmp_path):
    """Both reader tiers must refuse a truncated global file (underfill)
    rather than return heap garbage for the unreached window cells."""
    from armon_tpu.io import native
    from armon_tpu.io.output import write_state_file
    from armon_tpu.utils.errors import SolverException
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")

    params = reference_params("Sod_circ", np.float64, N=(50, 41), P=(3, 2),
                              maxcycle=1)
    cfg = params.config
    state, _ = _run(params)
    path = str(tmp_path / "trunc")
    write_state_file(cfg, gather_state(params, state), path)
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[: len(lines) // 2]))

    last = list(shard_coords_iter(params, state))[-1][0]
    with pytest.raises(SolverException, match="window was filled"):
        read_global_file_window(cfg, path, last)
    if native.available():
        import pytest as _pytest
        from unittest import mock
        with mock.patch.object(native, "read_window",
                               lambda *a, **k: None):
            with _pytest.raises(SolverException, match="window was filled"):
                read_global_file_window(cfg, path, last)
