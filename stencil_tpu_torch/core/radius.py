"""Per-direction stencil radius.

Counterpart of ``stencil_tpu/core/radius.py`` (reference
include/stencil/radius.hpp:14-105): a 26-direction table of halo widths, with
uneven per-direction radii first-class (e.g. +x=2, -x=1).  The shell-carrying
layout allocates per-axis halo widths from the *face* radii
(local_domain.cuh:309-313), so ``validate()`` rejects edge/corner radii wider
than the faces of their axes.
"""

from __future__ import annotations

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.direction_map import (
    CORNER_DIRECTIONS,
    DIRECTIONS_26,
    EDGE_DIRECTIONS,
    FACE_DIRECTIONS,
    DirectionMap,
)


class Radius:
    __slots__ = ("_rads",)

    def __init__(self):
        self._rads: DirectionMap = DirectionMap(0)

    # --- accessors (radius.hpp:19-41) ----------------------------------------
    def dir(self, x, y=None, z=None) -> int:
        if y is None:
            d = Dim3.of(x)
            return self._rads.at_dir(d.x, d.y, d.z)
        return self._rads.at_dir(x, y, z)

    def set_dir(self, d, r: int) -> None:
        d = Dim3.of(d)
        self._rads.set_dir(d.x, d.y, d.z, int(r))

    def x(self, d: int) -> int:
        return self.dir(d, 0, 0)

    def y(self, d: int) -> int:
        return self.dir(0, d, 0)

    def z(self, d: int) -> int:
        return self.dir(0, 0, d)

    def axis(self, axis: int, sign: int) -> int:
        """Face radius along numbered axis (0=x, 1=y, 2=z)."""
        d = [0, 0, 0]
        d[axis] = sign
        return self.dir(*d)

    def scaled(self, k: int) -> "Radius":
        """A radius with every direction multiplied by ``k`` (the halo
        multiplier's shell)."""
        out = Radius()
        for d in DIRECTIONS_26:
            out.set_dir(d, self.dir(d) * k)
        return out

    # --- mutators (radius.hpp:46-79) -----------------------------------------
    def set_face(self, r: int) -> "Radius":
        for d in FACE_DIRECTIONS:
            self.set_dir(d, r)
        return self

    def set_edge(self, r: int) -> "Radius":
        for d in EDGE_DIRECTIONS:
            self.set_dir(d, r)
        return self

    def set_corner(self, r: int) -> "Radius":
        for d in CORNER_DIRECTIONS:
            self.set_dir(d, r)
        return self

    # --- factories (radius.hpp:81-104) ---------------------------------------
    @staticmethod
    def constant(r: int) -> "Radius":
        ret = Radius()
        for d in DIRECTIONS_26:
            ret.set_dir(d, r)
        # the reference's `constant` also sets the center entry
        # (radius.hpp:83-90 iterates all 27); matched for table equality
        ret._rads.set_dir(0, 0, 0, int(r))
        return ret

    @staticmethod
    def face_edge_corner(face: int, edge: int, corner: int) -> "Radius":
        ret = Radius()
        ret.set_face(face)
        ret.set_edge(edge)
        ret.set_corner(corner)
        ret._rads.set_dir(0, 0, 0, 0)
        return ret

    @staticmethod
    def from_dict(entries) -> "Radius":
        """Build from {direction: radius}; unspecified directions are 0."""
        ret = Radius()
        for d, r in dict(entries).items():
            ret.set_dir(Dim3.of(d), r)
        return ret

    # --- derived --------------------------------------------------------------
    def lo(self) -> Dim3:
        """Per-axis negative-side face widths (the shell's low offsets)."""
        return Dim3(self.x(-1), self.y(-1), self.z(-1))

    def hi(self) -> Dim3:
        """Per-axis positive-side face widths."""
        return Dim3(self.x(1), self.y(1), self.z(1))

    def max_radius(self) -> int:
        return max(self.dir(d) for d in DIRECTIONS_26)

    def validate(self) -> None:
        """Edge/corner radii must fit inside the face-radius shell."""
        for d in DIRECTIONS_26:
            r = self.dir(d)
            for axis in range(3):
                s = d[axis]
                if s != 0 and r > self.axis(axis, s):
                    raise ValueError(
                        f"radius {r} in direction {d} exceeds face radius "
                        f"{self.axis(axis, s)} on axis {axis} sign {s}; the halo "
                        f"shell is allocated from face radii (local_domain.cuh:309)"
                    )

    def __eq__(self, o) -> bool:
        return isinstance(o, Radius) and self._rads == o._rads

    def __hash__(self) -> int:
        return hash(self._rads)

    def __repr__(self) -> str:
        vals = {tuple(d): self.dir(d) for d in DIRECTIONS_26 if self.dir(d)}
        return f"Radius({vals})"
