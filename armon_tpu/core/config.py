"""Static solver configuration.

This is the compile-time half of the reference's `ArmonParameters`
(`src/parameters.jl:267-389`): everything that shapes the traced program
(scheme selection, grid geometry, dtype, mesh layout). It is captured by
closure in the jitted step functions — changing any field triggers a
recompile, exactly like the reference's type-parameterized `SolverState`
(`src/solver_state.jl:275-318`) which encodes scheme choices in type
parameters to kill dynamic dispatch.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..models.cases import TestCase


@dataclass(frozen=True)
class SolverConfig:
    # dtype / geometry
    dtype: np.dtype                      # np.float64 or np.float32
    nghost: int                          # ghost cells per side (>= stencil sum)
    n_global: Tuple[int, int]            # (nx, ny) global real cells
    n_local: Tuple[int, int]             # (nx, ny) real cells per device shard
    domain_size: Tuple[float, float]     # (sx, sy)
    origin: Tuple[float, float]          # (ox, oy)

    # physics / scheme
    test: TestCase
    riemann: str = "GAD"                 # "Godunov" | "GAD"  (src/riemann_schemes.jl:5-6)
    limiter: str = "minmod"              # "no_limiter" | "minmod" | "superbee"
    projection: str = "euler_2nd"        # "euler" | "euler_2nd"
    splitting: str = "Sequential"        # "Sequential" | "Godunov" | "Strang" | "X_only" | "Y_only"

    # time stepping
    cfl: float = 0.95
    maxtime: float = 0.20
    maxcycle: int = 500_000
    Dt: float = 0.0
    cst_dt: bool = False
    dt_on_even_cycles: bool = False

    # parallel layout: device mesh dims (px, py). (1, 1) = single device.
    proc_dims: Tuple[int, int] = (1, 1)
    axis_names: Tuple[str, str] = ("px", "py")

    # Real cells of the LAST shard along each axis. Equal to n_local for an
    # even split. For an uneven split (the reference accepts any N over any
    # P, `src/parameters.jl:673-697`) every shard is padded to the same
    # n_local = ceil(N/P) shape and the hi-edge shard owns the short
    # remainder; its n_local - n_edge slack cells are dead by the padded
    # out-of-range-writes-are-dead design (docs/architecture.md).
    n_edge: Optional[Tuple[int, int]] = None

    @property
    def spmd(self) -> bool:
        return self.proc_dims != (1, 1)

    @property
    def edge_cells(self) -> Tuple[int, int]:
        """Real cells of the hi-edge shard along each axis."""
        return self.n_edge if self.n_edge is not None else self.n_local

    def uneven(self, axis) -> bool:
        """Whether the split along `axis` leaves slack on the edge shard."""
        return self.edge_cells[int(axis)] != self.n_local[int(axis)]

    @property
    def dx(self) -> float:
        """Cell size along X: domain_size/global_grid (src/solver_state.jl:341)."""
        return self.domain_size[0] / self.n_global[0]

    @property
    def dy(self) -> float:
        return self.domain_size[1] / self.n_global[1]

    def cell_size(self, axis) -> float:
        return (self.dx, self.dy)[int(axis)]

    @property
    def local_shape(self) -> Tuple[int, int]:
        """(rows, cols) of a padded per-device block: (ny_loc+2g, nx_loc+2g)."""
        g = self.nghost
        return (self.n_local[1] + 2 * g, self.n_local[0] + 2 * g)

    @property
    def cell_area(self) -> float:
        """ds used by the conservation reductions (src/reductions.jl:254)."""
        return self.dx * self.dy

    @property
    def gamma(self) -> float:
        return self.test.specific_heat_ratio
