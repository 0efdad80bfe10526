"""The subdomain grid: every subdomain on the one device.

Counterpart of ``stencil_tpu/parallel/mesh.py``.  The JAX package lays its
subdomains over a device mesh; here all ``px*py*pz`` subdomains live on one
device, stacked as a ``(px, py, pz, Xr, Yr, Zr)`` tensor, as the reference's
own tests place several subdomains on one GPU (test_exchange.cu:57).  The grid
comes from ``ManualPartition`` when the caller fixes it, and otherwise from
``NodePartition`` over a subdomain count with one node.  Placement is the
identity on one device; the strategy is only recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.parallel.partition import ManualPartition, NodePartition
from stencil_tpu_torch.utils.config import PlacementStrategy

@dataclasses.dataclass(frozen=True)
class SubdomainGrid:
    partition: object  # ManualPartition | NodePartition
    strategy: PlacementStrategy

    def dim(self) -> Dim3:
        return self.partition.dim()

    def count(self) -> int:
        return self.dim().flatten()


def make_grid(
    size,
    radius: Radius,
    subdomains: int = 1,
    strategy: PlacementStrategy = PlacementStrategy.NodeAware,
    force_dim: Optional[Dim3] = None,
) -> SubdomainGrid:
    """Partition ``size`` into subdomains: ``force_dim`` verbatim when given,
    else the min-interface split of ``subdomains`` on one node."""
    if force_dim is not None:
        part = ManualPartition(Dim3.of(size), force_dim)
    else:
        part = NodePartition(Dim3.of(size), radius, 1, int(subdomains))
    return SubdomainGrid(part, strategy)
