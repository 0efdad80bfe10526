"""3D domain decomposition by recursive prime-factor splitting.

Counterpart of ``stencil_tpu/parallel/partition.py`` (reference
include/stencil/partition.hpp:23-310):

* ``RankPartition(size, n)``: split by the prime factors of ``n``, largest
  first, always cutting the currently longest axis (x wins ties, then y).
* ``NodePartition(size, radius, nodes, gpus)``: each step cuts the plane with
  the smallest radius-weighted interface area, across nodes then within a
  node (partition.hpp:210-264).
* ``ManualPartition(size, dim)``: a user-given grid.
* Uneven remainders: ceil sizes with trailing indices shrunk by one
  (partition.hpp:83-114); ``linearize``/``dimensionize`` are x fastest.
"""

from __future__ import annotations

from typing import List

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius


def prime_factors(n: int) -> List[int]:
    """Prime factors of ``n``, largest first (partition.hpp:31-50)."""
    result: List[int] = []
    if n == 0:
        return result
    while n % 2 == 0:
        result.append(2)
        n //= 2
    i = 3
    while i * i <= n:
        while n % i == 0:
            result.append(i)
            n //= i
        i += 2
    if n > 2:
        result.append(n)
    return sorted(result, reverse=True)


def _div_ceil(n: int, d: int) -> int:
    return (n + d - 1) // d


def _dimensionize_in(i: int, dim: Dim3) -> Dim3:
    assert 0 <= i < dim.flatten()
    x = i % dim.x
    i //= dim.x
    return Dim3(x, i % dim.y, i // dim.y)


class _PartitionBase:
    """Shared uneven-remainder and index math."""

    _size: Dim3  # ceil subdomain size
    _rem: Dim3  # input size % dim

    def dim(self) -> Dim3:
        raise NotImplementedError

    def subdomain_size(self, idx) -> Dim3:
        """partition.hpp:83-98: trailing indices shrink by one on axes with a
        remainder."""
        idx = Dim3.of(idx)
        ret = list(self._size)
        for ax in range(3):
            if self._rem[ax] != 0 and idx[ax] >= self._rem[ax]:
                ret[ax] -= 1
        return Dim3(*ret)

    def subdomain_origin(self, idx) -> Dim3:
        """partition.hpp:100-114."""
        idx = Dim3.of(idx)
        ret = list(self._size * idx)
        for ax in range(3):
            if self._rem[ax] != 0 and idx[ax] >= self._rem[ax]:
                ret[ax] -= idx[ax] - self._rem[ax]
        return Dim3(*ret)

    def linearize(self, idx) -> int:
        """x fastest (partition.hpp:117-130)."""
        idx = Dim3.of(idx)
        d = self.dim()
        assert idx.all_ge(0) and idx.x < d.x and idx.y < d.y and idx.z < d.z
        return idx.x + idx.y * d.x + idx.z * d.y * d.x

    def dimensionize(self, i: int) -> Dim3:
        """partition.hpp:133-143."""
        return _dimensionize_in(i, self.dim())

    def is_even(self) -> bool:
        return self._rem == Dim3(0, 0, 0)


class RankPartition(_PartitionBase):
    """Longest-axis recursive splitter (partition.hpp:56-78)."""

    def __init__(self, size, n: int):
        size = Dim3.of(size)
        self._dim = Dim3(1, 1, 1)
        cur = size
        for amt in prime_factors(n):
            if amt < 2:
                continue
            if cur.x >= cur.y and cur.x >= cur.z:
                ax = 0
            elif cur.y >= cur.z:
                ax = 1
            else:
                ax = 2
            cur = cur.replace(ax, _div_ceil(cur[ax], amt))
            self._dim = self._dim.replace(ax, self._dim[ax] * amt)
        self._size = cur
        self._rem = size % self._dim

    def dim(self) -> Dim3:
        return self._dim


class ManualPartition(_PartitionBase):
    """User-specified grid (the reference's future-work "manual partition",
    README.md:157-176)."""

    def __init__(self, size, dim):
        size = Dim3.of(size)
        self._dim = Dim3.of(dim)
        assert self._dim.all_ge(1)
        self._size = Dim3(*(_div_ceil(size[a], self._dim[a]) for a in range(3)))
        self._rem = size % self._dim

    def dim(self) -> Dim3:
        return self._dim

    def idx(self, i: int) -> Dim3:
        return self.dimensionize(i)


class NodePartition(_PartitionBase):
    """Two-level min-interface splitter (partition.hpp:210-264): ``sys_dim``
    is the across-node grid, ``node_dim`` the within-node grid."""

    def __init__(self, size, radius: Radius, nodes: int, gpus: int):
        size = Dim3.of(size)
        self._sys_dim = Dim3(1, 1, 1)
        self._node_dim = Dim3(1, 1, 1)
        cur = size

        def min_interface_axis(c: Dim3) -> int:
            # partition.hpp:227-231: interface area scaled by the summed
            # +/- face radii of the cut axis; x wins ties, then y
            x_iface = c.y * c.z * (radius.dir(1, 0, 0) + radius.dir(-1, 0, 0))
            y_iface = c.x * c.z * (radius.dir(0, 1, 0) + radius.dir(0, -1, 0))
            z_iface = c.x * c.y * (radius.dir(0, 0, 1) + radius.dir(0, 0, -1))
            if x_iface <= y_iface and x_iface <= z_iface:
                return 0
            if y_iface <= z_iface:
                return 1
            return 2

        for level in range(2):
            dim = Dim3(1, 1, 1)
            for amt in prime_factors(nodes if level == 0 else gpus):
                if amt < 2:
                    continue
                ax = min_interface_axis(cur)
                cur = cur.replace(ax, _div_ceil(cur[ax], amt))
                dim = dim.replace(ax, dim[ax] * amt)
            if level == 0:
                self._sys_dim = dim
            else:
                self._node_dim = dim

        self._size = cur
        self._rem = size % (self._sys_dim * self._node_dim)

    def sys_dim(self) -> Dim3:
        return self._sys_dim

    def node_dim(self) -> Dim3:
        return self._node_dim

    def dim(self) -> Dim3:
        return self._sys_dim * self._node_dim

    def sys_idx(self, i: int) -> Dim3:
        return _dimensionize_in(i, self._sys_dim)

    def node_idx(self, i: int) -> Dim3:
        return _dimensionize_in(i, self._node_dim)

    def idx(self, i: int) -> Dim3:
        return _dimensionize_in(i, self.dim())
