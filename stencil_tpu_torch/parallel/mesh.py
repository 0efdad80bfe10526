"""The subdomain grid and its placement onto slots.

Counterpart of ``stencil_tpu/parallel/mesh.py``.  The JAX package lays its
subdomains over a device mesh; here all ``px*py*pz`` subdomains live on one
device, stacked as a ``(px, py, pz, Xr, Yr, Zr)`` tensor, as the reference's
own tests place several subdomains on one GPU (test_exchange.cu:57).  The grid
comes from ``ManualPartition`` when the caller fixes it, and otherwise from
``NodePartition`` over a subdomain count with one node.  Its ``placement``
(``parallel/placement.py``) maps the subdomains onto slots, one slot per
subdomain on the grid's device; it is solved at first use, so sizing a grid
before ``realize()`` costs no QAP.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.device import resolve_device
from stencil_tpu_torch.parallel.partition import ManualPartition, NodePartition
from stencil_tpu_torch.parallel.placement import Placement, make_placement
from stencil_tpu_torch.parallel.topology import slots_on
from stencil_tpu_torch.utils.config import PlacementStrategy


@dataclasses.dataclass(frozen=True)
class SubdomainGrid:
    partition: object  # ManualPartition | NodePartition
    strategy: PlacementStrategy
    radius: Radius
    device: torch.device

    def dim(self) -> Dim3:
        return self.partition.dim()

    def count(self) -> int:
        return self.dim().flatten()

    @functools.cached_property
    def placement(self) -> Placement:
        """The subdomains' slots on ``device`` (``make_placement``)."""
        return make_placement(self.strategy, self.partition, slots_on(self.device, self.count()), self.radius)


def make_grid(
    size,
    radius: Radius,
    subdomains: int = 1,
    strategy: PlacementStrategy = PlacementStrategy.NodeAware,
    force_dim: Optional[Dim3] = None,
    device=None,
) -> SubdomainGrid:
    """Partition ``size`` into subdomains: ``force_dim`` verbatim when given,
    else the min-interface split of ``subdomains`` on one node.  ``device``
    hosts the grid's slots; ``None`` is the port's default device
    (``device.resolve_device``: the card, and without one the port's no-GPU
    error; pass ``"cpu"`` for the CPU).  A device given is taken as it is:
    the domain resolves its own at construction."""
    if force_dim is not None:
        part = ManualPartition(Dim3.of(size), force_dim)
    else:
        part = NodePartition(Dim3.of(size), radius, 1, int(subdomains))
    return SubdomainGrid(part, strategy, radius, resolve_device() if device is None else torch.device(device))
