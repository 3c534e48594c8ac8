"""Axes and sides of the 2D domain.

Rebuild of the reference's enums (`src/utils.jl:15-77`): `Axis`
(X, Y) and `Side` (Left/Right/Bottom/Top), with the side<->axis maps used by
boundary conditions and halo exchange.

Array convention used throughout this package: state arrays have shape
``(ny_tot, nx_tot)`` (row-major, X contiguous in the last dimension). ``Axis.X`` therefore maps to array axis 1 and
``Axis.Y`` to array axis 0.
"""

import enum


class Axis(enum.IntEnum):
    X = 0
    Y = 1

    @property
    def array_axis(self) -> int:
        """The numpy/jax array axis this physical axis corresponds to."""
        return 1 if self is Axis.X else 0


class Side(enum.IntEnum):
    # Order matches the reference (`src/utils.jl:25`): Left, Right, Bottom, Top.
    LEFT = 0
    RIGHT = 1
    BOTTOM = 2
    TOP = 3


def axis_of(side: Side) -> Axis:
    """Axis a side lies along (`src/utils.jl:33-38`)."""
    return Axis.X if side in (Side.LEFT, Side.RIGHT) else Axis.Y


def sides_along(axis: Axis):
    """Both sides of `axis`, first side first (`src/utils.jl:40-45`)."""
    return (Side.LEFT, Side.RIGHT) if axis is Axis.X else (Side.BOTTOM, Side.TOP)


def first_side(axis: Axis) -> Side:
    """The side at the lower coordinate along `axis` (`src/utils.jl:47-52`)."""
    return Side.LEFT if axis is Axis.X else Side.BOTTOM


def is_first_side(side: Side) -> bool:
    """True for Left/Bottom (`src/utils.jl:54-59`)."""
    return side in (Side.LEFT, Side.BOTTOM)


def opposite_of(side: Side) -> Side:
    """`src/utils.jl:61-66`."""
    return {
        Side.LEFT: Side.RIGHT,
        Side.RIGHT: Side.LEFT,
        Side.BOTTOM: Side.TOP,
        Side.TOP: Side.BOTTOM,
    }[side]


def side_offset(side: Side):
    """(di, dj) unit offset of a side in (x, y) cell coordinates (`src/utils.jl:68-77`)."""
    return {
        Side.LEFT: (-1, 0),
        Side.RIGHT: (1, 0),
        Side.BOTTOM: (0, -1),
        Side.TOP: (0, 1),
    }[side]
