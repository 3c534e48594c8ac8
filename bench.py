"""Benchmark: steady cell-cycles/s of the jitted time loop on one GPU.

The reference's own metric is `giga_cells_per_sec` (cell-cycles/sec,
`src/solver.jl:19,386-394`). The whole run is one XLA program
(`core.solver.make_jit_loop`); it is compiled and run once as set-up, then
timed best of three. Prints one JSON line naming the device.

    python bench.py [--n 8192] [--ny NY] [--cycles 150] [--dtype f32|f64]
                    [--test Sod]

Exits non-zero, printing no measurement, when JAX finds no GPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def bench(n=8192, ny=None, cycles=150, dtype=np.float32, test="Sod"):
    """(cells_per_sec, best_seconds, compile_seconds) of the jitted loop."""
    import jax
    from armon_tpu import ArmonParameters
    from armon_tpu.core.solver import make_init, make_jit_loop

    if np.dtype(dtype).itemsize == 8:
        jax.config.update("jax_enable_x64", True)
    ny = ny or n
    params = ArmonParameters(
        test=test, N=(n, ny), data_type=dtype, scheme="GAD",
        projection="euler_2nd", riemann_limiter="minmod", nghost=4,
        maxcycle=cycles, maxtime=1e30, silent=5, measure_time=False,
    )
    state = jax.block_until_ready(make_init(params)())
    loop = make_jit_loop(params)

    t0 = time.perf_counter()
    out = jax.block_until_ready(loop(state))
    first = time.perf_counter() - t0
    del out

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _, t, ran, _, ok = jax.block_until_ready(loop(state))
        best = min(best, time.perf_counter() - t0)
    if not (bool(ok) and int(ran) == cycles):
        raise RuntimeError(f"run stopped at cycle {int(ran)} of {cycles}")
    return n * ny * cycles / best, best, first - best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--ny", type=int, default=0)
    ap.add_argument("--cycles", type=int, default=150)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--test", default="Sod")
    args = ap.parse_args(argv)

    from armon_tpu.utils.device_info import card_lines, require_gpu, \
        NoGPUError
    from armon_tpu.utils.compile_cache import enable_compile_cache
    cards = card_lines()
    enable_compile_cache()
    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1

    dtype = np.float32 if args.dtype == "f32" else np.float64
    ny = args.ny or args.n
    value, best, compile_s = bench(n=args.n, ny=ny, cycles=args.cycles,
                                   dtype=dtype, test=args.test)
    print(json.dumps({
        "metric": f"cell-cycles/sec ({args.test} {args.n}x{ny} "
                  f"{np.dtype(dtype).name} GAD+minmod euler_2nd, "
                  f"{args.cycles} cycles)",
        "value": value,
        "unit": "cells/s",
        "seconds": best,
        "setup_seconds": compile_s,
        "device": device,
        "card": cards[0] if cards else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
