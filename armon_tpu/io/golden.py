"""The golden-run configuration and its tolerance ladder.

The reference validates against frozen CSV states of a 100x100 run
(`test/reference_data/reference_functions.jl:7-19`), shipped here under
`tests/reference_data/ref_<test>_<bits>bits.csv`. The test suite and
`chip_smoke.py` both compare through these helpers.
"""

import os

import numpy as np

REFERENCE_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "reference_data")

def golden_params(test, dtype, **overrides):
    """ArmonParameters of the golden run
    (`test/reference_data/reference_functions.jl:7-19`)."""
    from ..params import ArmonParameters
    options = dict(
        data_type=dtype,
        test=test, scheme="GAD", projection="euler_2nd",
        riemann_limiter="minmod",
        nghost=4, N=(100, 100),
        maxcycle=1000,
        silent=5, write_output=False, measure_time=False,
    )
    options.update(overrides)
    return ArmonParameters(**options)


def golden_file(test, dtype):
    bits = np.dtype(dtype).itemsize * 8
    return os.path.join(REFERENCE_DATA, f"ref_{test}_{bits}bits.csv")


# Tolerance ladder (`reference_functions.jl:55-58`)
def abs_tol(dtype):
    return 1e-13 if np.dtype(dtype).itemsize == 8 else 1e-5


def rel_tol(dtype):
    return (4 * np.finfo(np.float64).eps if np.dtype(dtype).itemsize == 8
            else 20 * np.finfo(np.float32).eps)
