"""Per-direction tables over the 27 neighbor directions.

Counterpart of ``stencil_tpu/core/direction_map.py`` (reference
include/stencil/direction_map.hpp:11): a 3x3x3 table indexed by a direction
vector with components in {-1, 0, 1}.
"""

from __future__ import annotations

from typing import Generic, List, TypeVar

from stencil_tpu_torch.core.dim3 import Dim3

T = TypeVar("T")

#: The 26 neighbor directions in the reference's lexicographic order (x, then
#: y, then z most-to-least significant; tx_common.hpp:14-21).
DIRECTIONS_26: List[Dim3] = [
    Dim3(x, y, z)
    for x in (-1, 0, 1)
    for y in (-1, 0, 1)
    for z in (-1, 0, 1)
    if not (x == 0 and y == 0 and z == 0)
]

FACE_DIRECTIONS: List[Dim3] = [d for d in DIRECTIONS_26 if abs(d.x) + abs(d.y) + abs(d.z) == 1]
EDGE_DIRECTIONS: List[Dim3] = [d for d in DIRECTIONS_26 if abs(d.x) + abs(d.y) + abs(d.z) == 2]
CORNER_DIRECTIONS: List[Dim3] = [d for d in DIRECTIONS_26 if abs(d.x) + abs(d.y) + abs(d.z) == 3]


class DirectionMap(Generic[T]):
    """3x3x3 table indexed by direction in {-1,0,1}^3 (direction_map.hpp:11-57)."""

    __slots__ = ("_data",)

    def __init__(self, fill: T = 0):
        self._data = [fill for _ in range(27)]

    @staticmethod
    def _index(x: int, y: int, z: int) -> int:
        assert -1 <= x <= 1 and -1 <= y <= 1 and -1 <= z <= 1, (x, y, z)
        return (z + 1) * 9 + (y + 1) * 3 + (x + 1)

    def at_dir(self, x: int, y: int, z: int) -> T:
        return self._data[self._index(x, y, z)]

    def set_dir(self, x: int, y: int, z: int, v: T) -> None:
        self._data[self._index(x, y, z)] = v

    def __getitem__(self, d) -> T:
        d = Dim3.of(d)
        return self.at_dir(d.x, d.y, d.z)

    def __setitem__(self, d, v: T) -> None:
        d = Dim3.of(d)
        self.set_dir(d.x, d.y, d.z, v)

    def __eq__(self, o) -> bool:
        return isinstance(o, DirectionMap) and self._data == o._data

    def __hash__(self) -> int:
        return hash(tuple(self._data))

    def copy(self) -> "DirectionMap[T]":
        m = DirectionMap()
        m._data = list(self._data)
        return m

    def __repr__(self) -> str:
        entries = ", ".join(f"{d}:{self[d]}" for d in DIRECTIONS_26 if self[d])
        return f"DirectionMap({entries})"
