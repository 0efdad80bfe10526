"""Global-coordinate views of a shell-carrying block (counterpart of
``stencil_tpu/core/accessor.py``).

The reference's ``Accessor<T>`` (include/stencil/accessor.hpp:13-45) lets a
stencil kernel index by global 3-D point, whatever the halo offsets.  Over
whole regions that is shifted slicing: the term ``src[o + (dx, dy, dz)]`` for
every ``o`` of a region is the region's slice of the block moved by the
offset.  ``Accessor`` takes anything that basic indexing slices, numpy arrays
and torch tensors alike; leading component dims (a ``(*components, X, Y,
Z)`` block) ride along unindexed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from stencil_tpu_torch.core.dim3 import Dim3, Rect3


@dataclasses.dataclass(frozen=True, eq=False)
class Accessor:
    """A raw block addressed in global coordinates: ``raw`` is indexed
    ``(..., x, y, z)``, ``origin`` the global point of its first interior cell and
    ``lo_off`` the low shell width per axis, so global point ``p`` lives at
    ``raw[p - origin + lo_off]``."""

    raw: Any
    origin: Dim3
    lo_off: Dim3

    def __getitem__(self, p) -> Any:
        """The value at one global point (accessor.hpp:27-40)."""
        i = Dim3.of(p) - self.origin + self.lo_off
        return self.raw[..., i.x, i.y, i.z]

    def region(self, r: Rect3) -> Any:
        """The cells of a global-coordinates region."""
        lo = r.lo - self.origin + self.lo_off
        hi = r.hi - self.origin + self.lo_off
        return self.raw[..., lo.x : hi.x, lo.y : hi.y, lo.z : hi.z]

    def shifted(self, region: Rect3, d) -> Any:
        """``src[o + d]`` for every ``o`` in ``region``: the stencil term, of
        ``region.extent()`` shape."""
        d = Dim3.of(d)
        return self.region(Rect3(region.lo + d, region.hi + d))
