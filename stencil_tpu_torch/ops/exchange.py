"""The halo exchange over the subdomains of one device.

Counterpart of ``halo_exchange_multi`` / ``halo_exchange_shard``
(``stencil_tpu/ops/exchange.py:428-607``), ``direct`` route.  A quantity is a
``(px, py, pz, Xr, Yr, Zr)`` stack of shell-carrying blocks.  The exchange runs
up to three sweeps, x then y then z (``axes`` picks which); each sweep sends
slabs spanning the full raw extent of the other axes, so edges and corners
ride along.  Slab positions follow the JAX package exactly: the low halo
``[0, r_lo)`` receives the -1 neighbour's top interior slab ``[n, r_lo + n)``,
the high halo ``[r_lo + n, size)`` the +1 neighbour's bottom interior slab
``[r_lo, r_lo + r_hi)``, the ``-dir`` convention (packer.cuh:91-93).

Uneven sizes (pad-and-mask, ``stencil_tpu/ops/exchange.py:447-453``,
``:484-590``): every subdomain on an axis is padded to ``n = ceil(size /
dim)`` and the last one holds ``valid_last`` valid cells.  On such an axis the
last subdomain sends the top slab of its VALID cells, ``[n_valid, n_valid +
r_lo)`` (a per-block gather in torch, where JAX takes a
``lax.dynamic_slice``), and every subdomain's received +axis halo lands right
after its own valid cells, at ``r_lo + n_valid``, through
``blend_slab_dynamic`` with one offset per block.  The low halo stays at 0 on
the static ``blend_slab``.

``lax.ppermute`` becomes a neighbour gather (``shift_from_low`` /
``shift_from_high``): ``torch.roll`` by one along the grid axis, which on a
size-1 axis wraps a subdomain onto itself (the periodic boundary).  The JAX
package leaves this to an XLA collective, not to Pallas, so plain torch does
it here.  The halo WRITES go through ``blend_slab``, the kernel the TPU path
uses for them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.ops.halo_blend import blend_slab, blend_slab_dynamic

#: valid cells of the last subdomain per axis (None: the axis divides evenly)
ValidLast = Optional[Tuple[Optional[int], Optional[int], Optional[int]]]


def shift_from_low(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Each subdomain receives the value held by its -1 neighbour along grid
    axis ``axis`` (data moves +): ``x`` is a ``(px, py, pz, ...)`` stack
    (``_shift_from_low``, stencil_tpu/ops/exchange.py:181)."""
    return torch.roll(x, 1, axis)


def shift_from_high(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Each subdomain receives the value held by its +1 neighbour (data moves
    -) (``_shift_from_high``, stencil_tpu/ops/exchange.py:189)."""
    return torch.roll(x, -1, axis)


_POS_CACHE: Dict[tuple, torch.Tensor] = {}


def _hi_positions(grid, axis: int, base: int, n_pad: int, v_last: int, device) -> torch.Tensor:
    """Each block's +axis halo offset ``base + n_valid``, int32 on ``device``,
    in stack order (built once per geometry)."""
    key = (tuple(grid), axis, base, n_pad, v_last, str(device))
    pos = _POS_CACHE.get(key)
    if pos is None:
        nv = torch.full(tuple(grid), base + n_pad, dtype=torch.int32)
        nv.select(axis, grid[axis] - 1).fill_(base + v_last)
        pos = _POS_CACHE[key] = nv.reshape(-1).to(device)
    return pos


def halo_exchange_multi(
    stacks: Sequence[torch.Tensor],
    radius: Radius,
    valid_last: ValidLast = None,
    axes: Tuple[int, ...] = (0, 1, 2),
) -> List[torch.Tensor]:
    """Fill the halo shells of several quantities' stacks, in place, and
    return them.  Each stack is ``(px, py, pz, Xr, Yr, Zr)`` and all share one
    shape.  ``axes`` lists the sweeps to run (the wavefront route exchanges
    x and y in the array and carries z on separate slabs).  ``valid_last``
    holds the valid cells of the last subdomain per axis (None where the
    axis divides evenly): see the module docstring."""
    stacks = list(stacks)
    if not stacks:
        return stacks
    shape = stacks[0].shape
    if any(s.dim() != 6 or s.shape != shape for s in stacks):
        raise ValueError(
            "every quantity must be a (px, py, pz, Xr, Yr, Zr) stack of one shape; got "
            f"{[tuple(s.shape) for s in stacks]}"
        )
    spatial = shape[3:]
    grid = shape[:3]
    for axis in axes:
        r_lo = radius.axis(axis, -1)  # my low-side halo width
        r_hi = radius.axis(axis, +1)  # my high-side halo width
        if r_lo == 0 and r_hi == 0:
            continue
        dim = 3 + axis
        n = spatial[axis] - r_lo - r_hi  # (padded) interior width on this axis
        v_last = valid_last[axis] if valid_last is not None else None
        uneven = v_last is not None and v_last != n

        def top_valid(s: torch.Tensor) -> torch.Tensor:
            """Each subdomain's top valid slab of width r_lo: [n, n + r_lo),
            and [v_last, v_last + r_lo) on the last subdomain of a padded
            axis."""
            slab = s.narrow(dim, n, r_lo)
            if not uneven:
                return slab
            slab = slab.clone()
            slab.select(axis, grid[axis] - 1).copy_(
                s.select(axis, grid[axis] - 1).narrow(dim - 1, v_last, r_lo))
            return slab

        # gather every received slab before any halo write of this sweep
        lo_recv = hi_recv = None
        if r_lo > 0:
            # data moves +axis: each subdomain receives its -1 neighbour's
            # top slab of valid interior, width r_lo
            lo_recv = [shift_from_low(top_valid(s), axis).contiguous() for s in stacks]
        if r_hi > 0:
            # data moves -axis: the +1 neighbour's bottom interior slab
            hi_recv = [shift_from_high(s.narrow(dim, r_lo, r_hi), axis).contiguous() for s in stacks]
        if uneven and hi_recv is not None:
            pos = _hi_positions(grid, axis, r_lo, n, v_last, stacks[0].device)
        for j, s in enumerate(stacks):
            blocks = s.view(-1, *spatial)
            if lo_recv is not None:
                blend_slab(blocks, lo_recv[j].view(blocks.shape[0], *lo_recv[j].shape[3:]), axis, 0)
            if hi_recv is not None:
                slab = hi_recv[j].view(blocks.shape[0], *hi_recv[j].shape[3:])
                if uneven:
                    # right after each subdomain's valid cells
                    blend_slab_dynamic(blocks, slab, axis, pos)
                else:
                    blend_slab(blocks, slab, axis, r_lo + n)
    return stacks


def halo_exchange_shard(
    stack: torch.Tensor, radius: Radius, valid_last: ValidLast = None, axes: Tuple[int, ...] = (0, 1, 2)
) -> torch.Tensor:
    """Single-quantity convenience wrapper over ``halo_exchange_multi``."""
    return halo_exchange_multi([stack], radius, valid_last, axes=axes)[0]
