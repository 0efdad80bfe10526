"""The halo exchange over the subdomains of one device.

Counterpart of ``halo_exchange_multi`` / ``halo_exchange_shard``
(``stencil_tpu/ops/exchange.py:428-607``) with its routes.  A quantity is a
``(*components, px, py, pz, Xr, Yr, Zr)`` stack of shell-carrying blocks: a
scalar has no component dims, a ``(3,)`` vector one of 3, and every grid and
cell dim is addressed from the right.  The exchange runs
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

``fused_shell_exchange`` (``stencil_tpu/ops/exchange.py:610-741``) runs
the three sweeps of a ``yzpack_*`` route WITHOUT the unpack: it returns the
received shell as small buffers, corner-patched in the sweep order, for the
stream engine's fused passes (``halo="fused"``), and writes nothing into the
stacks.

``make_exchange_fn_allgather`` and ``make_exchange_fn_rollcompare``
(``stencil_tpu/ops/exchange.py:758-840``) are the two debug oracles of
``MethodFlags.AllGather`` / ``RollCompare``: each rebuilds every raw block
from the logical field (a wrapped-window gather; a wrap-pad and static
slices), structurally apart from the sweeps and from each other.  The JAX
package computes them with XLA, so plain torch does here.

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
    dim ``axis`` of ``x`` (data moves +) (``_shift_from_low``,
    stencil_tpu/ops/exchange.py:181)."""
    return torch.roll(x, 1, axis)


def shift_from_high(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Each subdomain receives the value held by its +1 neighbour (data moves
    -) (``_shift_from_high``, stencil_tpu/ops/exchange.py:189)."""
    return torch.roll(x, -1, axis)


def grid_dim(axis: int) -> int:
    """The dim of grid axis ``axis`` in a ``(*components, px, py, pz, ·, ·,
    ·)`` tensor, counted from the right (components lead)."""
    return axis - 6


def cell_dim(axis: int) -> int:
    """The dim of cell axis ``axis`` in a ``(..., X, Y, Z)`` tensor."""
    return axis - 3


_POS_CACHE: Dict[tuple, torch.Tensor] = {}


def _hi_positions(grid, axis: int, base: int, n_pad: int, v_last: int, copies: int, device) -> torch.Tensor:
    """Each block's +axis halo offset ``base + n_valid``, int32 on ``device``,
    in block order: the grid's offsets repeated once per component, as a
    ``(*components, px, py, pz, ...)`` stack flattens (built once per
    geometry)."""
    key = (tuple(grid), axis, base, n_pad, v_last, copies, str(device))
    pos = _POS_CACHE.get(key)
    if pos is None:
        nv = torch.full(tuple(grid), base + n_pad, dtype=torch.int32)
        nv.select(axis, grid[axis] - 1).fill_(base + v_last)
        pos = _POS_CACHE[key] = nv.reshape(-1).repeat(copies).to(device)
    return pos


def _packed_sweep(stacks: List[torch.Tensor], axis: int, r_lo: int, r_hi: int, n: int, route: str) -> None:
    """One y (axis 1) or z (axis 2) sweep through shell buffers, in place:
    the counterpart of ``_ypack_sweep`` / ``_zpack_sweep``
    (``stencil_tpu/ops/exchange.py:257-425``).  Per quantity and direction
    one pack over all its blocks (components times subdomains, as the JAX
    package flattens components into its packs), a neighbour roll of the
    ``(*components, px, py, pz, depth, ·, ·)`` buffer stack and one
    unpack."""
    pallas = route.endswith("pallas")
    if axis == 2:
        pack_fn = pack.pack_zshell_pallas if pallas else pack.pack_zshell_xla
        unpack_fn = pack.unpack_zshell_pallas
        to_slab = pack.zshell_to_slab
    else:
        pack_fn = pack.pack_yshell_pallas if pallas else pack.pack_yshell_xla
        unpack_fn = pack.unpack_yshell_pallas
        to_slab = pack.yshell_to_slab
    blocks = [s.view(-1, *s.shape[-3:]) for s in stacks]
    lead = [s.shape[:-3] for s in stacks]

    def send(start: int, depth: int, shift) -> List[torch.Tensor]:
        out = []
        for b, stack_lead in zip(blocks, lead):
            buf = pack_fn(b, start, depth)
            out.append(shift(buf.view(*stack_lead, *buf.shape[1:]), grid_dim(axis)).view(buf.shape))
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
    return them.  Each stack is ``(*components, px, py, pz, Xr, Yr, Zr)``:
    scalar and vector quantities mix, and all share the trailing six dims.
    Every grid and cell dim is addressed from the right, and a vector's
    components travel as further blocks of the same sweeps.  ``axes`` lists
    the sweeps to run (the wavefront route exchanges x and y in the array
    and carries z on separate slabs).  ``valid_last`` holds the valid cells
    of the last subdomain per axis (None where the axis divides evenly);
    ``route`` is one of ``EXCHANGE_ROUTES``: see the module docstring."""
    if route not in EXCHANGE_ROUTES:
        raise ValueError(f"unknown exchange route {route!r} (one of {EXCHANGE_ROUTES})")
    stacks = list(stacks)
    if not stacks:
        return stacks
    shape = stacks[0].shape[-6:]  # components may differ
    if any(s.dim() < 6 or s.shape[-6:] != shape for s in stacks):
        raise ValueError(
            "every quantity must be a (*components, px, py, pz, Xr, Yr, Zr) stack, all with the same "
            f"trailing six dims; got {[tuple(s.shape) for s in stacks]}"
        )
    grid, spatial = shape[:3], shape[3:]
    for axis in axes:
        r_lo = radius.axis(axis, -1)  # my low-side halo width
        r_hi = radius.axis(axis, +1)  # my high-side halo width
        if r_lo == 0 and r_hi == 0:
            continue
        gdim, cdim = grid_dim(axis), cell_dim(axis)
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
            slab = s.narrow(cdim, n, r_lo)
            if not uneven:
                return slab
            slab = slab.clone()
            slab.select(gdim, grid[axis] - 1).copy_(
                s.select(gdim, grid[axis] - 1).narrow(cdim, v_last, r_lo))
            return slab

        # gather every received slab before any halo write of this sweep
        lo_recv = hi_recv = None
        if r_lo > 0:
            # data moves +axis: each subdomain receives its -1 neighbour's
            # top slab of valid interior, width r_lo
            lo_recv = [shift_from_low(top_valid(s), gdim).contiguous() for s in stacks]
        if r_hi > 0:
            # data moves -axis: the +1 neighbour's bottom interior slab
            hi_recv = [shift_from_high(s.narrow(cdim, r_lo, r_hi), gdim).contiguous() for s in stacks]
        for j, s in enumerate(stacks):
            blocks = s.view(-1, *spatial)
            if lo_recv is not None:
                blend_slab(blocks, lo_recv[j].view(blocks.shape[0], *lo_recv[j].shape[-3:]), axis, 0)
            if hi_recv is not None:
                slab = hi_recv[j].view(blocks.shape[0], *hi_recv[j].shape[-3:])
                if uneven:
                    # right after each subdomain's valid cells
                    pos = _hi_positions(grid, axis, r_lo, n, v_last, blocks.shape[0] // grid.numel(),
                                        s.device)
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


def fused_shell_exchange(
    stacks: Sequence[torch.Tensor], radius: Radius, route: str = "yzpack_xla"
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """The exchange without the unpack (``fused_shell_exchange``,
    ``stencil_tpu/ops/exchange.py:610-741``): run the three sweeps and return
    the received shell buffers instead of writing them into the stacks.

    Each stack is ``(px, py, pz, X, Y, Z)`` (even shards, every shell width >
    0); for each quantity, over the ``n = px * py * pz`` blocks in stack
    order, it returns

    * ``xbufs`` ``(n, lo_x + hi_x, Y, Z)``: the whole-plane x slabs, ``[low |
      high]`` halo planes;
    * ``ybufs`` ``(n, lo_y + hi_y, X, Z)``: the y shell in the packs' wire
      layout (``buf[k, x, z]``; the JAX buffer is its ``(1, 0, 2)``
      transpose);
    * ``zbufs`` ``(n, lo_z + hi_z, Y, X)``: the z shell in the packs' wire
      layout (``buf[k, y, x]``, no lane pad; the JAX buffer is its
      ``(2, 0, 1)`` transpose).

    Sends: x slabs by ``shift_from_low``/``shift_from_high`` on the grid
    axis; y and z through ``pack_yshell_*``/``pack_zshell_*`` of ``route``
    (the ``*_pallas`` routes launch the shell pack kernels), each pack
    reading the blocks with their stale shell.  The corners are patched on
    the small buffers in the exchange's sweep order: the y messages' x-shell
    planes from the received x slabs, the z messages' x columns from the
    received x slabs and then their y rows from the received y buffers.  So
    every buffer cell equals the stacks' cell after ``halo_exchange_multi``
    on the same route, bit for bit."""
    if route not in Y_PACK_ROUTES:
        raise ValueError(f"fused_shell_exchange needs a y+z packed route ({Y_PACK_ROUTES}); got {route!r}")
    stacks = list(stacks)
    shape = stacks[0].shape
    if any(s.dim() != 6 or s.shape != shape for s in stacks):
        raise ValueError(
            "every quantity must be a (px, py, pz, X, Y, Z) stack of one shape; got "
            f"{[tuple(s.shape) for s in stacks]}"
        )
    grid, (X, Y, Z) = tuple(shape[:3]), tuple(shape[3:])
    lo = [radius.axis(a, -1) for a in range(3)]
    hi = [radius.axis(a, +1) for a in range(3)]
    if min(lo + hi) < 1:
        raise ValueError(f"fused_shell_exchange needs every shell width > 0, got {lo}/{hi}")
    n = [shape[3 + a] - lo[a] - hi[a] for a in range(3)]
    pallas = route.endswith("pallas")
    pack_y = pack.pack_yshell_pallas if pallas else pack.pack_yshell_xla
    pack_z = pack.pack_zshell_pallas if pallas else pack.pack_zshell_xla
    count = stacks[0].numel() // (X * Y * Z)

    def recv(dst: torch.Tensor, msg: torch.Tensor, axis: int, step: int) -> None:
        """Write into ``dst`` (a ``(px, py, pz, d, ...)`` slot of a buffer) the
        message each block receives along grid ``axis``: its -1 neighbour's
        (``step`` +1, ``shift_from_low``) or its +1 neighbour's (-1,
        ``shift_from_high``), two copies and no intermediate."""
        msg = msg.reshape(*grid, *msg.shape[1:]) if msg.dim() == 4 else msg
        g = grid[axis]
        if step > 0:
            dst.narrow(axis, 1, g - 1).copy_(msg.narrow(axis, 0, g - 1))
            dst.narrow(axis, 0, 1).copy_(msg.narrow(axis, g - 1, 1))
        else:
            dst.narrow(axis, 0, g - 1).copy_(msg.narrow(axis, 1, g - 1))
            dst.narrow(axis, g - 1, 1).copy_(msg.narrow(axis, 0, 1))

    def buffer(d: int, a: int, b: int, like: torch.Tensor) -> torch.Tensor:
        return torch.empty((count, d, a, b), dtype=like.dtype, device=like.device)

    xbufs, ybufs, zbufs = [], [], []
    for s in stacks:
        blocks = s.view(count, X, Y, Z)
        # x sweep: whole planes, [low | high]
        xb = buffer(lo[0] + hi[0], Y, Z, s)
        xg = xb.view(*grid, *xb.shape[1:])
        recv(xg[:, :, :, : lo[0]], s[:, :, :, n[0] : n[0] + lo[0]], 0, 1)
        recv(xg[:, :, :, lo[0] :], s[:, :, :, lo[0] : lo[0] + hi[0]], 0, -1)
        xlo, xhi = xb[:, : lo[0]], xb[:, lo[0] :]

        # y sweep: (n, d, X, Z) messages whose x-shell planes come from the
        # received x slabs (the in-array y sweep spans the x halos)
        yb = buffer(lo[1] + hi[1], X, Z, s)
        yg = yb.view(*grid, *yb.shape[1:])
        for y0, depth, at, step in ((n[1], lo[1], 0, 1), (lo[1], hi[1], lo[1], -1)):
            buf = pack_y(blocks, y0, depth)
            buf[:, :, 0 : lo[0]] = xlo[:, :, y0 : y0 + depth].transpose(1, 2)
            buf[:, :, X - hi[0] : X] = xhi[:, :, y0 : y0 + depth].transpose(1, 2)
            recv(yg[:, :, :, at : at + depth], buf, 1, step)
        ylo, yhi = yb[:, : lo[1]], yb[:, lo[1] :]

        # z sweep: (n, d, Y, X) messages, x columns from the x slabs, then y
        # rows from the y buffers (the x-y-z corners take two hops)
        zb = buffer(lo[2] + hi[2], Y, X, s)
        zg = zb.view(*grid, *zb.shape[1:])
        for z0, depth, at, step in ((n[2], lo[2], 0, 1), (lo[2], hi[2], lo[2], -1)):
            buf = pack_z(blocks, z0, depth)
            buf[..., 0 : lo[0]] = xlo[..., z0 : z0 + depth].permute(0, 3, 2, 1)
            buf[..., X - hi[0] : X] = xhi[..., z0 : z0 + depth].permute(0, 3, 2, 1)
            buf[:, :, 0 : lo[1]] = ylo[..., z0 : z0 + depth].permute(0, 3, 1, 2)
            buf[:, :, Y - hi[1] : Y] = yhi[..., z0 : z0 + depth].permute(0, 3, 1, 2)
            recv(zg[:, :, :, at : at + depth], buf, 2, step)
        xbufs.append(xb)
        ybufs.append(yb)
        zbufs.append(zb)
    return xbufs, ybufs, zbufs


def _logical(stack: torch.Tensor, spec, dim, lo) -> torch.Tensor:
    """The logical field ``(px*nx, py*ny, pz*nz)`` of a scalar stack: every
    subdomain's interior, in global order."""
    n = spec.sz
    inner = stack[..., lo.x : lo.x + n.x, lo.y : lo.y + n.y, lo.z : lo.z + n.z]
    return inner.permute(0, 3, 1, 4, 2, 5).reshape(dim.x * n.x, dim.y * n.y, dim.z * n.z)


def make_exchange_fn_allgather(radius: Radius, spec, dim):
    """The AllGather debug exchange (``make_exchange_fn_allgather``,
    ``stencil_tpu/ops/exchange.py:758-795``): every raw cell of every block
    is a read of the logical field at its wrapped global coordinate, one
    index gather per axis.  Returns ``exchange(stacks)``, which fills the
    scalar stacks in place.  Even sizes only."""
    raw, n, lo = spec.raw_size(), spec.sz, radius.lo()
    index = {}

    def axis_indices(ax: int, device) -> torch.Tensor:
        key = (ax, str(device))
        if key not in index:
            size = dim[ax] * n[ax]
            index[key] = torch.cat([(i * n[ax] - lo[ax] + torch.arange(raw[ax])) % size
                                    for i in range(dim[ax])]).to(device)
        return index[key]

    def exchange(stacks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        for s in stacks:
            g = _logical(s, spec, dim, lo)
            for ax in range(3):
                g = g.index_select(ax, axis_indices(ax, s.device))
            s.copy_(g.view(dim.x, raw.x, dim.y, raw.y, dim.z, raw.z).permute(0, 2, 4, 1, 3, 5))
        return list(stacks)

    return exchange


def _wrap_pad(g: torch.Tensor, ax: int, lo: int, hi: int) -> torch.Tensor:
    """``g`` with ``lo`` wrapped cells before and ``hi`` after along ``ax``
    (``jnp.pad(mode="wrap")``)."""
    size = g.shape[ax]
    return torch.cat([g.narrow(ax, size - lo, lo), g, g.narrow(ax, 0, hi)], dim=ax)


def make_exchange_fn_rollcompare(radius: Radius, spec, dim):
    """The RollCompare debug exchange (``make_exchange_fn_rollcompare``,
    ``stencil_tpu/ops/exchange.py:797-840``): wrap-pad the logical field by
    the shell and cut every raw block out of it by static slicing.  Returns
    ``exchange(stacks)``, which fills the scalar stacks in place.  Even
    sizes only."""
    raw, n, lo, hi = spec.raw_size(), spec.sz, radius.lo(), radius.hi()

    def exchange(stacks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        for s in stacks:
            padded = _logical(s, spec, dim, lo)
            for ax in range(3):
                padded = _wrap_pad(padded, ax, lo[ax], hi[ax])
            for ix in range(dim.x):
                for iy in range(dim.y):
                    for iz in range(dim.z):
                        s[ix, iy, iz].copy_(padded[ix * n.x : ix * n.x + raw.x,
                                                   iy * n.y : iy * n.y + raw.y,
                                                   iz * n.z : iz * n.z + raw.z])
        return list(stacks)

    return exchange


def side_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """A second CUDA stream on ``device`` for an exchange that runs beside
    compute (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def overlapped(side, interior, exchange):
    """``interior()`` on the current stream beside ``exchange()`` on
    ``side`` (``side_stream``); returns what ``interior`` returns, the
    current stream ordered after both.  The side stream first waits for the
    work issued so far (the stacks both read), and the interior is issued
    first, so the card runs it while the host issues the exchange's many
    small launches.  Every tensor the exchange makes is made and freed on
    the side stream; the stacks it writes outlive the wait.  Every wrapper
    reads the current stream when it launches, so the exchange's kernels
    land on ``side``.  On the CPU (``side`` None) the two run in turn."""
    if side is None:
        out = interior()
        exchange()
        return out
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    out = interior()
    with torch.cuda.stream(side):
        exchange()
    main.wait_stream(side)
    return out
