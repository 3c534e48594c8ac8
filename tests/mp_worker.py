"""Worker for the 2-process localhost test (tests/test_multiprocess.py).

One OS process of a `jax.distributed` run — the analog of one MPI rank of
the reference's `test/mpi.jl` job. Each process owns ONE virtual CPU device
(XLA_FLAGS set below, before jax import) so the 2-process job spans a
global 2-device mesh with exactly one addressable shard per process.

Run: python mp_worker.py <process_id> <port> <tmpdir> [px py]
(px, py) is the process grid — default (2, 1); (2, 2) runs the 4-process
leg where BOTH mesh axes cross process boundaries (`test/mpi.jl:464-475`
process-grid matrix analog). Prints MPOK as the last line on success; any
assertion/exception fails the process and the parent test.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def main():
    pid, port, tmpdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    px, py = (int(sys.argv[4]), int(sys.argv[5])) if len(sys.argv) > 5 \
        else (2, 1)
    nprocs = px * py
    from armon_tpu import ArmonParameters, armon, gather_state
    from armon_tpu.utils.errors import SolverException
    from armon_tpu.io.subdomain import (compare_sub_domain_with_golden,
                                        shard_coords_iter,
                                        sub_domain_file_path)
    from armon_tpu.io.restart import save_checkpoint

    common = dict(
        test="Sod", data_type=np.float64, scheme="GAD",
        projection="euler_2nd", riemann_limiter="minmod", nghost=4,
        N=(100, 100), P=(px, py), maxcycle=1000,
        silent=5, measure_time=False,
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs, process_id=pid,
    )

    # --- leg 1: the golden config across 2 processes, per-shard output,
    # per-shard golden comparison — zero gather anywhere.
    p = ArmonParameters(**common, return_data=True, write_output=True,
                        output_dir=tmpdir, output_file="mp_out")
    assert jax.process_count() == nprocs, jax.process_count()
    assert p.use_MPI, "multi-process must auto-select per-shard I/O"
    stats = armon(p)

    # each process wrote exactly its own shard's file
    my_coords = [c for c, _ in shard_coords_iter(p, stats.data)]
    assert len(my_coords) == 1, my_coords
    mine = sub_domain_file_path(os.path.join(tmpdir, "mp_out"), my_coords[0])
    assert os.path.exists(mine), mine

    ref = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference_data", "ref_Sod_64bits.csv")
    ref_dt, ref_cycles, cnt, max_diff = compare_sub_domain_with_golden(
        p, stats.data, ref, atol=1e-13, rtol=4 * np.finfo(np.float64).eps)
    assert stats.cycles == ref_cycles, (stats.cycles, ref_cycles)
    assert cnt == 0, f"{cnt} diffs vs golden (max rel {max_diff})"

    # the gather paths must fail pointedly, not crash or hang
    try:
        gather_state(p, stats.data)
        raise AssertionError("gather_state did not raise on a "
                             "multi-process state")
    except SolverException as e:
        assert "per-shard" in str(e), e

    # --- leg 2: per-shard checkpoint + resume == uninterrupted, bit-exact
    common = dict(common, return_data=True)
    p1 = ArmonParameters(**dict(common, maxcycle=3))
    s1 = armon(p1)
    ckpt = os.path.join(tmpdir, "mp.ckpt.npz")
    save_checkpoint(ckpt, p1, s1.data, s1.final_time, s1.cycles, s1.last_dt)
    from armon_tpu.io.restart import _shard_ckpt_path
    assert os.path.exists(_shard_ckpt_path(ckpt, my_coords[0]))

    p2 = ArmonParameters(**dict(common, maxcycle=6))
    s2 = armon(p2, restore_from=ckpt)
    p3 = ArmonParameters(**dict(common, maxcycle=6))
    s3 = armon(p3)
    assert s2.cycles == s3.cycles == 6
    blocks2 = dict(shard_coords_iter(p2, s2.data))
    blocks3 = dict(shard_coords_iter(p3, s3.data))
    assert blocks2.keys() == blocks3.keys()
    for coords in blocks2:
        for v in blocks2[coords]:
            assert np.array_equal(blocks2[coords][v], blocks3[coords][v]), \
                (coords, v)

    print("MPOK", flush=True)


if __name__ == "__main__":
    main()
