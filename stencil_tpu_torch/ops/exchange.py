"""The halo exchange over the subdomains of one device.

Counterpart of ``halo_exchange_multi`` / ``halo_exchange_shard``
(``stencil_tpu/ops/exchange.py:428-607``) with its routes.  A quantity is a
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

Routes (``EXCHANGE_ROUTES``, ``stencil_tpu/ops/exchange.py:62-92``): ``direct``
sends the slabs as sliced.  The packed routes send a thin shell as a buffer
whose thin extent leads (``ops/pack.py``): the z sweep on every packed route,
the y sweep on the ``yzpack_*`` routes; the x sweep is always ``direct``.  On
the ``*_xla`` routes the pack is torch slicing and the received buffer lands
through ``blend_slab``; on the ``*_pallas`` routes the pack and the unpack are
the hand-written shell kernels.  A packed sweep engages only on an evenly
divided axis whose dtypes the kernels take (``halo_blend.supports``);
otherwise that sweep runs ``direct``.  Every route fills the same halos, bit
for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.ops import pack
from stencil_tpu_torch.ops.halo_blend import blend_slab, blend_slab_dynamic, supports

#: valid cells of the last subdomain per axis (None: the axis divides evenly)
ValidLast = Optional[Tuple[Optional[int], Optional[int], Optional[int]]]

#: the exchange's routes for the y/z sweeps: ``direct`` (slabs as sliced),
#: ``zpack_*`` (the z shell as a ``(d, Y, X)`` buffer), ``yzpack_*`` (the y
#: shell as a ``(d, X, Z)`` buffer too); ``*_xla`` packs by torch slicing,
#: ``*_pallas`` by the hand-written kernels
EXCHANGE_ROUTES = ("direct", "zpack_xla", "zpack_pallas", "yzpack_xla", "yzpack_pallas")
#: routes whose z sweep is packed
Z_PACK_ROUTES = ("zpack_xla", "zpack_pallas", "yzpack_xla", "yzpack_pallas")
#: routes whose y sweep is packed
Y_PACK_ROUTES = ("yzpack_xla", "yzpack_pallas")


def zpack_supported(dtypes, valid_last: ValidLast = None) -> bool:
    """Can the packed z sweep engage: an evenly divided z axis (the packs cut
    the shell at static offsets) and dtypes the kernels take."""
    if valid_last is not None and valid_last[2] is not None:
        return False
    return all(supports(dt) for dt in dtypes)


def ypack_supported(dtypes, valid_last: ValidLast = None) -> bool:
    """The y twin of ``zpack_supported``."""
    if valid_last is not None and valid_last[1] is not None:
        return False
    return all(supports(dt) for dt in dtypes)


def route_supported(route: str, dtypes, valid_last: ValidLast = None) -> bool:
    """Can ``route`` engage any of its packed sweeps here?  ``direct``
    always; ``zpack_*`` need the z sweep; ``yzpack_*`` either sweep (each
    sweep falls back to ``direct`` on its own inside the exchange)."""
    if route == "direct":
        return True
    z_ok = zpack_supported(dtypes, valid_last)
    if route in Y_PACK_ROUTES:
        return z_ok or ypack_supported(dtypes, valid_last)
    return z_ok


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


def _packed_sweep(stacks: List[torch.Tensor], axis: int, r_lo: int, r_hi: int, n: int, route: str) -> None:
    """One y (axis 1) or z (axis 2) sweep through shell buffers, in place:
    the counterpart of ``_ypack_sweep`` / ``_zpack_sweep``
    (``stencil_tpu/ops/exchange.py:257-425``).  Per quantity and direction
    one pack over all subdomains, a neighbour roll of the ``(px, py, pz,
    depth, ·, ·)`` buffer stack and one unpack."""
    pallas = route.endswith("pallas")
    if axis == 2:
        pack_fn = pack.pack_zshell_pallas if pallas else pack.pack_zshell_xla
        unpack_fn = pack.unpack_zshell_pallas
        to_slab = pack.zshell_to_slab
    else:
        pack_fn = pack.pack_yshell_pallas if pallas else pack.pack_yshell_xla
        unpack_fn = pack.unpack_yshell_pallas
        to_slab = pack.yshell_to_slab
    grid = stacks[0].shape[:3]
    blocks = [s.view(-1, *s.shape[3:]) for s in stacks]

    def send(start: int, depth: int, shift) -> List[torch.Tensor]:
        out = []
        for b in blocks:
            buf = pack_fn(b, start, depth)
            out.append(shift(buf.view(*grid, *buf.shape[1:]), axis).view(buf.shape))
        return out

    # gather every received buffer before any halo write of this sweep: the
    # low halo [0, r_lo) receives the -1 neighbour's top interior [n, n + r_lo),
    # the high halo [r_lo + n, ...) the +1 neighbour's bottom [r_lo, r_lo + r_hi)
    recv = []
    if r_lo > 0:
        recv.append((0, r_lo, send(n, r_lo, shift_from_low)))
    if r_hi > 0:
        recv.append((r_lo + n, r_hi, send(r_lo, r_hi, shift_from_high)))
    for pos, depth, bufs in recv:
        for b, buf in zip(blocks, bufs):
            if pallas:
                unpack_fn(b, buf, pos, depth)
            else:
                blend_slab(b, to_slab(buf), axis, pos)


def halo_exchange_multi(
    stacks: Sequence[torch.Tensor],
    radius: Radius,
    valid_last: ValidLast = None,
    axes: Tuple[int, ...] = (0, 1, 2),
    route: str = "direct",
) -> List[torch.Tensor]:
    """Fill the halo shells of several quantities' stacks, in place, and
    return them.  Each stack is ``(px, py, pz, Xr, Yr, Zr)`` and all share one
    shape.  ``axes`` lists the sweeps to run (the wavefront route exchanges
    x and y in the array and carries z on separate slabs).  ``valid_last``
    holds the valid cells of the last subdomain per axis (None where the
    axis divides evenly); ``route`` is one of ``EXCHANGE_ROUTES``: see the
    module docstring."""
    if route not in EXCHANGE_ROUTES:
        raise ValueError(f"unknown exchange route {route!r} (one of {EXCHANGE_ROUTES})")
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
        packs = Y_PACK_ROUTES if axis == 1 else Z_PACK_ROUTES if axis == 2 else ()
        if route in packs and (ypack_supported if axis == 1 else zpack_supported)(
                [s.dtype for s in stacks], valid_last if uneven else None):
            _packed_sweep(stacks, axis, r_lo, r_hi, n, route)
            continue

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
    stack: torch.Tensor, radius: Radius, valid_last: ValidLast = None, axes: Tuple[int, ...] = (0, 1, 2),
    route: str = "direct",
) -> torch.Tensor:
    """Single-quantity convenience wrapper over ``halo_exchange_multi``."""
    return halo_exchange_multi([stack], radius, valid_last, axes=axes, route=route)[0]
