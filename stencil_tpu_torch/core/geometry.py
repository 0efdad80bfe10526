"""Halo geometry math for one subdomain.

Counterpart of ``stencil_tpu/core/geometry.py``: the geometry half of the
reference's ``LocalDomain`` (local_domain.cuh:33-349, local_domain.cu:14-95)
and the interior/exterior split (stencil.cu:567-666).  ``LocalSpec`` is
host-side metadata: compute size ``sz``, global ``origin`` and ``Radius``.

* ``halo_pos(dir, halo)``: offset from allocation start of the halo
  (``halo=True``) or interior-edge (``halo=False``) region on side ``dir``.
* ``halo_extent(dir)``: ``sz`` on 0-axes, the face radius on +-1 axes.
* the ``-dir`` convention: a message sent in direction ``d`` has extent
  ``halo_extent(-d)``; the receiver's halo width rules the size
  (packer.cuh:91-93, 271-273).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.direction_map import DIRECTIONS_26
from stencil_tpu_torch.core.radius import Radius


def halo_extent(direction, sz: Dim3, radius: Radius) -> Dim3:
    """Point-size of the halo region on side ``dir`` (local_domain.cuh:285-298):
    each nonzero axis contributes that axis's face radius, so an edge region
    is face-radius-wide on both its axes; ``dir == (0,0,0)`` returns ``sz``."""
    d = Dim3.of(direction)
    return Dim3(
        sz.x if d.x == 0 else radius.x(d.x),
        sz.y if d.y == 0 else radius.y(d.y),
        sz.z if d.z == 0 else radius.z(d.z),
    )


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """Geometry of one subdomain (shell-carrying layout)."""

    sz: Dim3
    origin: Dim3
    radius: Radius

    @staticmethod
    def make(sz, origin, radius: Radius) -> "LocalSpec":
        return LocalSpec(Dim3.of(sz), Dim3.of(origin), radius)

    def raw_size(self) -> Dim3:
        """Allocation extent: sz plus both face radii per axis
        (local_domain.cuh:309-313)."""
        return self.sz + self.radius.lo() + self.radius.hi()

    def halo_pos(self, direction, halo: bool) -> Dim3:
        """local_domain.cu:56-95."""
        d = Dim3.of(direction)
        assert d.all_gt(-2) and d.all_lt(2)
        r = self.radius

        def one(axis: int, s: int) -> int:
            if s == 1:
                return self.sz[axis] + (r.axis(axis, -1) if halo else 0)
            if s == -1:
                return 0 if halo else r.axis(axis, -1)
            return r.axis(axis, -1)

        return Dim3(one(0, d.x), one(1, d.y), one(2, d.z))

    def halo_extent(self, direction) -> Dim3:
        return halo_extent(direction, self.sz, self.radius)

    def halo_coords(self, direction, halo: bool) -> Rect3:
        """Global coordinates of the region (local_domain.cu:14-32)."""
        pos = self.halo_pos(direction, halo) - self.radius.lo() + self.origin
        return Rect3(pos, pos + self.halo_extent(direction))

    def halo_bytes(self, direction, itemsize: int) -> int:
        """Bytes of one quantity's halo on side ``dir`` (local_domain.cuh:301-303)."""
        return int(itemsize) * self.halo_extent(direction).flatten()

    def compute_region(self) -> Rect3:
        return Rect3(self.origin, self.origin + self.sz)

    def interior(self) -> Rect3:
        """Compute region shrunk per-direction so no point reads a halo cell."""
        return shrink_by_radius(self.compute_region(), self.radius)

    def exterior(self) -> List[Rect3]:
        """Face slabs covering compute-region minus interior, in the
        reference's order +x, +y, +z, -x, -y, -z (stencil.cu:616-666)."""
        return exterior_of(self.compute_region(), self.interior())

    def to_local(self, r: Rect3) -> Rect3:
        """Global-coords region -> allocation-relative indices."""
        shift = self.radius.lo() - self.origin
        return Rect3(r.lo + shift, r.hi + shift)

    def local_slices(self, r: Rect3):
        """Index tuple (x, y, z order) for a global-coords region."""
        lr = self.to_local(r)
        return tuple(slice(lr.lo[a], lr.hi[a]) for a in range(3))

    def interior_slices(self):
        return self.local_slices(self.compute_region())


def shrink_by_radius(com: Rect3, radius: Radius) -> Rect3:
    """Shrink a region per-direction so no point inside reads outside it
    (stencil.cu:567-610)."""
    lo = list(com.lo)
    hi = list(com.hi)
    for d in DIRECTIONS_26:
        rad = radius.dir(d)
        for axis in range(3):
            if d[axis] < 0:
                lo[axis] = max(com.lo[axis] + rad, lo[axis])
            elif d[axis] > 0:
                hi[axis] = min(com.hi[axis] - rad, hi[axis])
    return Rect3(Dim3(*lo), Dim3(*hi))


def exterior_of(com: Rect3, int_reg: Rect3) -> List[Rect3]:
    """Non-overlapping face slabs covering ``com`` minus ``int_reg`` by the
    slide-in construction (stencil.cu:616-666): +x, +y, +z, -x, -y, -z."""
    clo, chi = list(com.lo), list(com.hi)
    ilo, ihi = list(int_reg.lo), list(int_reg.hi)
    out: List[Rect3] = []
    for axis in range(3):
        if ihi[axis] != chi[axis]:
            lo, hi = list(clo), list(chi)
            lo[axis] = ihi[axis]
            out.append(Rect3(Dim3(*lo), Dim3(*hi)))
            chi[axis] = ihi[axis]
    for axis in range(3):
        if ilo[axis] != clo[axis]:
            lo, hi = list(clo), list(chi)
            hi[axis] = ilo[axis]
            out.append(Rect3(Dim3(*lo), Dim3(*hi)))
            clo[axis] = ilo[axis]
    return out


def ripple_value(p: Dim3) -> float:
    """The analytic test field of the reference's exchange tests
    (test_exchange.cu:14-38): ``x + ripple[x%4] + y + ripple[y%4] + z +
    ripple[z%4]`` with ripple = [0, .25, 0, -.25]."""
    ripple = (0.0, 0.25, 0.0, -0.25)
    return p.x + ripple[p.x % 4] + p.y + ripple[p.y % 4] + p.z + ripple[p.z % 4]


def ripple_field(lo: Dim3, ext: Dim3, dtype=np.float32) -> np.ndarray:
    """Vectorized ripple over a box, returned with (x, y, z) index order."""
    ripple = np.array([0.0, 0.25, 0.0, -0.25])

    def axis_vals(start, n):
        idx = np.arange(start, start + n)
        return idx + ripple[idx % 4]

    vx = axis_vals(lo.x, ext.x)[:, None, None]
    vy = axis_vals(lo.y, ext.y)[None, :, None]
    vz = axis_vals(lo.z, ext.z)[None, None, :]
    return (vx + vy + vz).astype(dtype)
