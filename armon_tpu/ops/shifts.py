"""Shifted array reads for stencil ops.

``sh(a, k, axis)`` returns an array where ``out[i] = a[i + k]`` along the
given physical axis — the replacement for the reference's strided
linear indexing ``a[i + k*s]`` (`src/blocking/blocking.jl:197-206` computes
the stride ``s``; kernels index with it, e.g. `src/kernels.jl:58-68`).

Implementation: `jnp.roll`, i.e. a wrap-around shift. The wrapped values land
only in the outermost ghost ring of the padded arrays. Reads at any position
where a kernel's result is consumed stay in-bounds (the params.py nghost
floor ``nghost >= stencil_width(riemann) + stencil_width(projection)``
guarantees it — the stencil SUM; the reference's product rule
`src/parameters.jl:609-613` under-counts at 1st-order projections, see
tests/test_params.py::test_nghost_floor_is_sum), so the wrap-around never affects
real cells — the same argument that makes the reference's ghost-poisoning
test pass (`test/convergence.jl:67-102`).
"""

import jax.numpy as jnp

from ..utils.enums import Axis


def sh(a, k: int, axis: Axis):
    if k == 0:
        return a
    return jnp.roll(a, -k, axis.array_axis)
