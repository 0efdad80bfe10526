"""3-component integer vectors and axis-aligned boxes.

Counterpart of ``stencil_tpu/core/dim3.py`` (reference include/stencil/dim3.hpp:25
and rect3.hpp:13), kept as the port's own copy so the port imports nothing of
the JAX package:

* component-wise arithmetic (+, -, *, //, %) between ``Dim3`` s and with ints
* lexicographic ordering with x most significant (dim3.hpp:78-92)
* ``flatten`` = x*y*z (dim3.hpp:76)
* periodic ``wrap(lims)`` (dim3.hpp:216-231)
* ``all_lt / all_gt / any_lt / any_gt`` predicates (dim3.hpp:190-214)

The class is immutable and hashable so it can key dicts of per-direction state.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple


@dataclasses.dataclass(frozen=True, order=False)
class Dim3:
    x: int = 0
    y: int = 0
    z: int = 0

    @staticmethod
    def of(v) -> "Dim3":
        """Coerce an int, 3-tuple, or Dim3 into a Dim3."""
        if isinstance(v, Dim3):
            return v
        if isinstance(v, int):
            return Dim3(v, v, v)
        x, y, z = v
        return Dim3(int(x), int(y), int(z))

    def __post_init__(self):
        object.__setattr__(self, "x", int(self.x))
        object.__setattr__(self, "y", int(self.y))
        object.__setattr__(self, "z", int(self.z))

    def __iter__(self) -> Iterator[int]:
        yield self.x
        yield self.y
        yield self.z

    def tuple(self) -> Tuple[int, int, int]:
        return (self.x, self.y, self.z)

    def __getitem__(self, i: int) -> int:
        return (self.x, self.y, self.z)[i]

    def replace(self, axis: int, value: int) -> "Dim3":
        vals = [self.x, self.y, self.z]
        vals[axis] = value
        return Dim3(*vals)

    def __add__(self, o) -> "Dim3":
        o = Dim3.of(o)
        return Dim3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o) -> "Dim3":
        o = Dim3.of(o)
        return Dim3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o) -> "Dim3":
        return Dim3.of(o).__sub__(self)

    def __mul__(self, o) -> "Dim3":
        o = Dim3.of(o)
        return Dim3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __floordiv__(self, o) -> "Dim3":
        o = Dim3.of(o)
        return Dim3(self.x // o.x, self.y // o.y, self.z // o.z)

    def __mod__(self, o) -> "Dim3":
        o = Dim3.of(o)
        return Dim3(self.x % o.x, self.y % o.y, self.z % o.z)

    def __neg__(self) -> "Dim3":
        return Dim3(-self.x, -self.y, -self.z)

    # ordering: x most significant (dim3.hpp:78-92)
    def __lt__(self, o: "Dim3") -> bool:
        return self.tuple() < o.tuple()

    def __le__(self, o: "Dim3") -> bool:
        return self.tuple() <= o.tuple()

    def __gt__(self, o: "Dim3") -> bool:
        return self.tuple() > o.tuple()

    def __ge__(self, o: "Dim3") -> bool:
        return self.tuple() >= o.tuple()

    def any_lt(self, v: int) -> bool:
        return self.x < v or self.y < v or self.z < v

    def any_gt(self, v: int) -> bool:
        return self.x > v or self.y > v or self.z > v

    def all_lt(self, v: int) -> bool:
        return self.x < v and self.y < v and self.z < v

    def all_gt(self, v: int) -> bool:
        return self.x > v and self.y > v and self.z > v

    def all_ge(self, v: int) -> bool:
        return self.x >= v and self.y >= v and self.z >= v

    def flatten(self) -> int:
        """Number of points in a box of this extent (dim3.hpp:76)."""
        return self.x * self.y * self.z

    def wrap(self, lims: "Dim3") -> "Dim3":
        """Periodic wrap into [0, lims) for one period of out-of-range on
        either side (dim3.hpp:216-231)."""
        lims = Dim3.of(lims)
        return Dim3(
            (self.x + lims.x) % lims.x,
            (self.y + lims.y) % lims.y,
            (self.z + lims.z) % lims.z,
        )

    @staticmethod
    def next_power_of_two(v: int) -> int:
        """dim3.hpp:13-21."""
        if v <= 0:
            return 0 if v == 0 else v
        return 1 << max(0, (v - 1).bit_length())

    def __repr__(self) -> str:
        return f"[{self.x},{self.y},{self.z}]"


@dataclasses.dataclass(frozen=True)
class Rect3:
    """Half-open axis-aligned box [lo, hi) (reference rect3.hpp:13-27)."""

    lo: Dim3
    hi: Dim3

    def __post_init__(self):
        object.__setattr__(self, "lo", Dim3.of(self.lo))
        object.__setattr__(self, "hi", Dim3.of(self.hi))

    def extent(self) -> Dim3:
        return self.hi - self.lo

    def contains(self, p: Dim3) -> bool:
        return (
            self.lo.x <= p.x < self.hi.x
            and self.lo.y <= p.y < self.hi.y
            and self.lo.z <= p.z < self.hi.z
        )

    def points(self):
        """Iterate all integer points, z-major (matches reference loop nests)."""
        for z in range(self.lo.z, self.hi.z):
            for y in range(self.lo.y, self.hi.y):
                for x in range(self.lo.x, self.hi.x):
                    yield Dim3(x, y, z)

    def __repr__(self) -> str:
        return f"Rect3({self.lo}..{self.hi})"

