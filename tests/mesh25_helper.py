"""25-virtual-device mesh matrix — run as a SUBPROCESS of test_mesh25.py
(the per-process device count is fixed at backend init, so the 8-device
conftest process cannot host these meshes).

Covers the reference's largest process grids (`test/mpi.jl:464-475`:
(5,2), (2,5), (5,5) over N=100) plus both-axes-uneven variants of each
(N=(99,97): ceil-split slack on X and Y at once, corner shard short in
both dims). Every mesh must reproduce the single-device run bit-for-bit,
and the (5,5) N=100 run must match the sequential Julia golden with zero
differences through the no-gather sub-domain comparator.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=25").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from conftest import reference_params, ref_file, abs_tol, rel_tol
from armon_tpu import Axis
from armon_tpu.core.solver import make_init, make_jit_loop, gather_state
from armon_tpu.io.subdomain import compare_sub_domain_with_golden


def run(params):
    state = make_init(params)()
    loop = make_jit_loop(params)
    state, t, cycles, dt, ok = loop(state)
    assert bool(ok)
    return state, int(cycles), float(dt)


def main():
    assert len(jax.devices()) >= 25, jax.devices()

    # --- bit-exact vs single device, even and both-axes-uneven splits
    for N in ((100, 100), (99, 97)):
        single = reference_params("Sod_circ", np.float64, N=N, maxcycle=12)
        sref, ref_cycles, ref_dt = run(single)
        ref_host = gather_state(single, sref)
        g = single.nghost
        for P in ((5, 2), (2, 5), (5, 5)):
            params = reference_params("Sod_circ", np.float64, N=N,
                                      maxcycle=12, P=P)
            if N == (99, 97):
                cfg = params.config
                assert cfg.uneven(Axis.X) and cfg.uneven(Axis.Y), (N, P)
            state, cycles, dt = run(params)
            assert cycles == ref_cycles and dt == ref_dt, (N, P)
            host = gather_state(params, state)
            for var in ("rho", "u", "v", "E", "p"):
                a = getattr(ref_host, var)[g:-g, g:-g]
                b = getattr(host, var)[g:-g, g:-g]
                assert np.array_equal(a, b), f"{var} differs at N={N} P={P}"
            print(f"OK N={N} P={P} bit-exact ({cycles} cycles)", flush=True)

    # --- (5,5) full golden run through the no-gather windowed comparator
    params = reference_params("Sod", np.float64, P=(5, 5))
    state, cycles, _dt = run(params)
    ref_dt, ref_cycles, cnt, max_diff = compare_sub_domain_with_golden(
        params, state, ref_file("Sod", np.float64),
        atol=abs_tol(np.float64), rtol=rel_tol(np.float64))
    assert cycles == ref_cycles
    assert cnt == 0 and max_diff == 0, (cnt, max_diff)
    print(f"OK (5,5) golden zero-diff ({cycles} cycles, no gather)", flush=True)
    print("mesh25 ALL OK")


if __name__ == "__main__":
    main()
