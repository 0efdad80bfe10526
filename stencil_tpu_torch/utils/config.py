"""Exchange-method and placement enums (counterpart of the two enums in
``stencil_tpu/utils/config.py``)."""

from __future__ import annotations

import enum


class MethodFlags(enum.Flag):
    Non = 0
    # Ppermute names the default transport: in this package, a neighbour
    # gather over the subdomain-grid axis on the one device
    Ppermute = enum.auto()
    # debug oracles of the JAX package; not ported yet (realize() raises)
    AllGather = enum.auto()
    RollCompare = enum.auto()
    # Reference-compat aliases (stencil.hpp:29-41): all map onto the default
    # transport, accepted so reference-style driver flags keep working
    CudaMpi = Ppermute
    CudaAwareMpi = Ppermute
    CudaMpiColocated = Ppermute
    CudaMemcpyPeer = Ppermute
    CudaKernel = Ppermute
    All = Ppermute

    def and_(self, o: "MethodFlags") -> bool:
        return bool(self & o)


class PlacementStrategy(enum.Enum):
    """partition.hpp:312.  With every subdomain on one device, placement is
    the identity; the strategy is recorded, not acted on."""

    NodeAware = 0
    Trivial = 1
