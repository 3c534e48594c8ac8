"""Physics test cases (the reference's "model zoo").

Rebuild of `src/tests.jl` with the exact constants of the Julia
reference so the golden-data regression suite carries over:

- default CFL / max time / domain size / origin:  `src/tests.jl:32-44`
- specific heat ratio gamma = 7/5:                `src/tests.jl:46`
- two-state initial conditions:                   `src/tests.jl:84-121`
- high-region predicates:                         `src/tests.jl:59-63`
- boundary-condition tables + mirror factors:     `src/tests.jl:124-233`
"""

from dataclasses import dataclass
import enum
import math

from ..utils.enums import Side
from ..utils.errors import solver_error


class BC(enum.Enum):
    FREE_FLOW = 0
    DIRICHLET = 1


@dataclass(frozen=True)
class InitTwoState:
    """Two-state initial condition (`src/tests.jl:66-81`)."""
    high_rho: float
    low_rho: float
    high_E: float
    low_E: float
    high_u: float
    low_u: float
    high_v: float
    low_v: float


class TestCase:
    """Base test case. Subclasses provide constants and the high-region
    predicate; the init kernel (`armon_tpu.ops.init`) evaluates it on the
    cell-center coordinate grid."""

    name: str = "TestCase"
    default_CFL: float = 0.95
    default_max_time: float = 0.20
    default_domain_size = (1.0, 1.0)
    default_domain_origin = (0.0, 0.0)
    specific_heat_ratio: float = 7.0 / 5.0   # src/tests.jl:46
    is_conservative: bool = True             # src/tests.jl:48-49
    has_source_term: bool = False

    def init_params(self) -> InitTwoState:
        raise NotImplementedError

    def region_high(self, x, y):
        """Vectorized predicate: True where the 'high' state applies.
        `x`, `y` are cell-center coordinate arrays."""
        raise NotImplementedError

    # Boundary conditions -------------------------------------------------

    def boundaries(self) -> dict:
        """Per-side BC type (`src/tests.jl:164-233`)."""
        raise NotImplementedError

    def boundary_factors(self, side: Side):
        """(u_factor, v_factor) applied when mirroring ghost cells
        (`src/tests.jl:150-161`): FreeFlow -> (1, 1); Dirichlet mirrors the
        normal velocity: X sides -> (-1, 1), Y sides -> (1, -1)."""
        if self.boundaries()[side] is BC.FREE_FLOW:
            return (1.0, 1.0)
        if side in (Side.LEFT, Side.RIGHT):
            return (-1.0, 1.0)
        return (1.0, -1.0)

    def __repr__(self):
        return self.name

    # Value semantics so SolverConfig (and the jit caches keyed on it) can
    # treat equal configurations as equal.
    def _key(self):
        return (type(self).__name__,)

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


class Sod(TestCase):
    """Sod shock tube (`src/tests.jl:59,84-95,164-171`)."""
    name = "Sod"
    default_CFL = 0.95
    default_max_time = 0.20

    def init_params(self):
        return InitTwoState(1.0, 0.125, 2.5, 2.0, 0.0, 0.0, 0.0, 0.0)

    def region_high(self, x, y):
        return x <= 0.5

    def boundaries(self):
        return {Side.LEFT: BC.DIRICHLET, Side.RIGHT: BC.DIRICHLET,
                Side.BOTTOM: BC.FREE_FLOW, Side.TOP: BC.FREE_FLOW}


class SodY(Sod):
    """Sod along Y (`src/tests.jl:60,174-181`)."""
    name = "Sod_y"

    def region_high(self, x, y):
        return y <= 0.5

    def boundaries(self):
        return {Side.LEFT: BC.FREE_FLOW, Side.RIGHT: BC.FREE_FLOW,
                Side.BOTTOM: BC.DIRICHLET, Side.TOP: BC.DIRICHLET}


class SodCirc(Sod):
    """Sod with cylindrical symmetry (`src/tests.jl:61,184-191`)."""
    name = "Sod_circ"

    def region_high(self, x, y):
        # radius 0.3 around (0.5, 0.5): src/tests.jl:61
        return (x - 0.5) ** 2 + (y - 0.5) ** 2 <= 0.09

    def boundaries(self):
        return {s: BC.DIRICHLET for s in Side}


class Bizarrium(TestCase):
    """Bizarrium impact test, stiff non-ideal EOS
    (`src/tests.jl:62,97-108,194-201`)."""
    name = "Bizarrium"
    default_CFL = 0.6
    default_max_time = 80e-6
    is_conservative = False  # src/tests.jl:49

    def init_params(self):
        return InitTwoState(
            high_rho=1.42857142857e4, low_rho=10000.0,
            high_E=4.48657821135e6, low_E=0.5 * 250.0 ** 2,
            high_u=0.0, low_u=250.0, high_v=0.0, low_v=0.0,
        )

    def region_high(self, x, y):
        return x <= 0.5

    def boundaries(self):
        return {Side.LEFT: BC.DIRICHLET, Side.RIGHT: BC.FREE_FLOW,
                Side.BOTTOM: BC.DIRICHLET, Side.TOP: BC.DIRICHLET}


class Sedov(TestCase):
    """Sedov blast wave (`src/tests.jl:9-19,63,110-120,204-211`).

    `r` is the radius of the initial energy deposit, computed from the cell
    size as `hypot(dx, dy) / sqrt(2)` (`src/tests.jl:15-19`). The reference
    carries `r` (and squares it) in the working precision T; mirroring that
    keeps f32 boundary-cell classification identical.
    """
    name = "Sedov"
    default_CFL = 0.7
    default_max_time = 1.0
    default_domain_size = (2.0, 2.0)
    default_domain_origin = (-1.0, -1.0)

    def __init__(self, r: float, dtype=None):
        import numpy as np
        self.dtype = np.dtype(dtype if dtype is not None else np.float64)
        self.r = self.dtype.type(r)

    def _key(self):
        return (type(self).__name__, float(self.r), self.dtype.name)

    @classmethod
    def from_cell_size(cls, dx, dy, dtype=None):
        import numpy as np
        T = np.dtype(dtype if dtype is not None else np.float64).type
        # hypot in T, then /sqrt(2) in f64, converted once to T — the
        # reference's `r_Sedov::T = hypot(Δx...) / sqrt(2)` (src/tests.jl:
        # 15-19; Julia promotes Float32/Float64 to Float64 before the `::T`
        # conversion). float() forces the divide into f64 — NumPy's weak
        # scalar promotion would otherwise keep `float32 / python-float`
        # in f32 and shift r by 1 ulp on ~15% of grid sizes.
        return cls(float(np.hypot(T(dx), T(dy))) / math.sqrt(2.0), dtype)

    def init_params(self):
        # E such that the blast wave reaches r=1 at t=1 (src/tests.jl:114);
        # pi converts to T before the product, as Julia's Irrational does.
        import numpy as np
        T = self.dtype.type
        # Denominator in T (Julia: Irrational pi promotes to T, r^2 in T),
        # the division in f64 (Julia: Float64 / Float32 -> Float64), one
        # final rounding to T at use — float() forces the f64 divide that
        # NumPy's weak scalar promotion would otherwise do in f32.
        return InitTwoState(
            high_rho=1.0, low_rho=1.0,
            high_E=(1.0 / 1.033) ** 5 / float(T(math.pi) * self.r ** 2),
            low_E=2.5e-14,
            high_u=0.0, low_u=0.0, high_v=0.0, low_v=0.0,
        )

    def region_high(self, x, y):
        # r^2 evaluated in T (src/tests.jl:63: sum(x.^2) <= s.r^2)
        return x ** 2 + y ** 2 <= self.r ** 2

    def boundaries(self):
        return {s: BC.FREE_FLOW for s in Side}


class DebugIndexes(TestCase):
    """Debug case: every variable holds the global linear cell index
    (`src/tests.jl:217-233`, init at `src/kernels.jl:93-103`). Used by the
    halo-exchange tests."""
    name = "DebugIndexes"
    default_CFL = 0.0
    default_max_time = 0.0

    def init_params(self):  # pragma: no cover - not a two-state case
        raise NotImplementedError("DebugIndexes is initialized from indexes")

    def boundaries(self):
        return {s: BC.DIRICHLET for s in Side}


_REGISTRY = {
    "Sod": Sod,
    "Sod_y": SodY,
    "Sod_circ": SodCirc,
    "Bizarrium": Bizarrium,
    "Sedov": Sedov,
    "DebugIndexes": DebugIndexes,
}


def test_from_name(name, dx=None, dy=None, dtype=None) -> TestCase:
    """Instantiate a test case by name (`src/tests.jl:21-28`). `Sedov` needs
    the cell size (and working dtype) to compute its deposit radius
    (`src/tests.jl:15-19`)."""
    if isinstance(name, TestCase):
        return name
    cls = _REGISTRY.get(str(name))
    if cls is None:
        solver_error("config", f"Unknown test case: '{name}'")
    if cls is Sedov:
        if dx is None or dy is None:
            solver_error("config", "Sedov requires the cell size (dx, dy)")
        return Sedov.from_cell_size(dx, dy, dtype)
    return cls()
