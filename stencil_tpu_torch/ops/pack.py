"""The shell packs of the packed exchange routes: z and y shells as message
buffers.

Counterpart of the shell half of ``stencil_tpu/ops/pack.py`` (``:286-474``).
The packed exchange routes (``ops/exchange.py`` ``EXCHANGE_ROUTES``) send a
thin shell of every block not as the sliced slab but as a buffer whose thin
extent leads:

* the **z shell** ``block[:, :, z0:z0+d]`` travels as ``(d, Y, X)``, x
  minor: ``buf[k, y, x] = block[x, y, z0 + k]``, a transpose;
* the **y shell** ``block[:, y0:y0+d, :]`` travels as ``(d, X, Z)``:
  ``buf[k, x, z] = block[x, y0 + k, z]``, no transpose.

Two implementations each, as in the JAX package, whose route names keep
them apart: ``pack_*shell_xla`` is plain torch slicing (the JAX package lets
XLA fuse it; its unpack goes through ``blend_slab`` after ``*shell_to_slab``
turns the buffer back into a slab), and the ``*_pallas`` functions, where
"pallas" names the hand-written-kernel route: on a CUDA tensor each launches
its kernel in ``csrc/pack.cu``, on a CPU tensor it runs its plain version
(``*_plain``).  ``unpack_*shell_pallas`` writes the window in place and
leaves every other cell of the block as it was.

Each function takes one ``(X, Y, Z)`` block or ``n`` blocks ``(n, X, Y, Z)``
with buffers ``(d, ·, ·)`` or ``(n, d, ·, ·)``; one launch serves all ``n``.

The z buffer carries no lane padding: the TPU pads X to a multiple of 128
(``lane_pad``, ``stencil_tpu/ops/pack.py:298-306``) for its (8,128) tiling,
while a Hopper row coalesces at any width, so the port's buffer is
``(d, Y, X)`` and the JAX buffer's ``[:, :, :X]`` is what it equals.
"""

from __future__ import annotations

import torch

from stencil_tpu_torch.kernels import check_tensor, same_device, stream_handle
from stencil_tpu_torch.ops.halo_blend import supports


def zshell_buffer_shape(block_shape, depth: int) -> tuple:
    """Shape of the z-shell buffer of ``(..., X, Y, Z)`` blocks."""
    *lead, X, Y, _ = block_shape
    return (*lead, depth, Y, X)


def yshell_buffer_shape(block_shape, depth: int) -> tuple:
    """Shape of the y-shell buffer of ``(..., X, Y, Z)`` blocks."""
    *lead, X, _, Z = block_shape
    return (*lead, depth, X, Z)


def pack_zshell_xla(block: torch.Tensor, z0: int, depth: int) -> torch.Tensor:
    """``block[..., z0:z0+depth]`` as the ``(..., depth, Y, X)`` buffer, by
    slicing and a transpose (the route ``zpack_xla``)."""
    return block.narrow(-1, z0, depth).transpose(-3, -1).contiguous()


def zshell_to_slab(buf: torch.Tensor) -> torch.Tensor:
    """The received ``(..., depth, Y, X)`` buffer as the ``(..., X, Y,
    depth)`` slab ``blend_slab`` writes (the JAX twin also drops the pad
    columns past X, which the port's buffer does not have)."""
    return buf.transpose(-3, -1).contiguous()


def pack_yshell_xla(block: torch.Tensor, y0: int, depth: int) -> torch.Tensor:
    """``block[..., y0:y0+depth, :]`` as the ``(..., depth, X, Z)`` buffer
    (the route ``yzpack_xla``)."""
    return block.narrow(-2, y0, depth).transpose(-3, -2).contiguous()


def yshell_to_slab(buf: torch.Tensor) -> torch.Tensor:
    """The received ``(..., depth, X, Z)`` buffer as the ``(..., X, depth,
    Z)`` slab ``blend_slab`` writes."""
    return buf.transpose(-3, -2).contiguous()


_SHAPES = {2: zshell_buffer_shape, 1: yshell_buffer_shape}


def _check(block: torch.Tensor, axis: int, start: int, depth: int, buf: torch.Tensor = None) -> None:
    check_tensor(block, "block", ndims=(3, 4))
    ext = block.shape[-3 + axis]
    if depth < 1 or start < 0 or start + depth > ext:
        raise ValueError(f"window [{start}, {start + depth}) does not fit axis {axis} of extent {ext}")
    if not supports(block.dtype):
        raise TypeError(f"the pack kernels take 1/2/4/8-byte dtypes, got {block.dtype}")
    if buf is None:
        return
    check_tensor(buf, "buf", ndims=(block.dim(),))
    same_device(block, buf)
    if buf.dtype != block.dtype:
        raise TypeError(f"buf dtype {buf.dtype} != block dtype {block.dtype}")
    want = _SHAPES[axis](tuple(block.shape), depth)
    if tuple(buf.shape) != want:
        raise ValueError(f"buf shape {tuple(buf.shape)}, want {want} for block {tuple(block.shape)}")


def _launch(fn: str, block: torch.Tensor, buf: torch.Tensor, start: int, depth: int) -> None:
    from stencil_tpu_torch.kernels import build

    lib = build.load("pack")
    n = block.shape[0] if block.dim() == 4 else 1
    X, Y, Z = block.shape[-3:]
    rc = getattr(lib, fn)(block.data_ptr(), buf.data_ptr(), block.element_size(), n, X, Y, Z,
                          start, depth, stream_handle(block.device))
    build.check(lib, rc, fn)


def pack_zshell_pallas_plain(block: torch.Tensor, z0: int, depth: int) -> torch.Tensor:
    """``buf[..., k, y, x] = block[..., x, y, z0 + k]`` for ``k < depth``."""
    _check(block, 2, z0, depth)
    return pack_zshell_xla(block, z0, depth)


def pack_zshell_pallas(block: torch.Tensor, z0: int, depth: int) -> torch.Tensor:
    """The z shell ``[z0, z0+depth)`` of ``block`` as a new ``(..., depth,
    Y, X)`` buffer.  CUDA tensors launch the kernel (any 1/2/4/8-byte
    dtype); CPU tensors take the plain version."""
    _check(block, 2, z0, depth)
    if block.device.type == "cpu":
        return pack_zshell_pallas_plain(block, z0, depth)
    buf = torch.empty(zshell_buffer_shape(tuple(block.shape), depth), dtype=block.dtype, device=block.device)
    _launch("stp_pack_zshell", block, buf, z0, depth)
    pack_zshell_pallas.launches += 1
    return buf


def unpack_zshell_pallas_plain(block: torch.Tensor, buf: torch.Tensor, z0: int, depth: int) -> torch.Tensor:
    """``block[..., x, y, z0 + k] = buf[..., k, y, x]``, in place."""
    _check(block, 2, z0, depth, buf)
    block.narrow(-1, z0, depth).copy_(buf.transpose(-3, -1))
    return block


def unpack_zshell_pallas(block: torch.Tensor, buf: torch.Tensor, z0: int, depth: int) -> torch.Tensor:
    """Write a ``(..., depth, Y, X)`` buffer into ``block[..., z0:z0+depth]``
    in place and return ``block``; no other cell changes.  CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    _check(block, 2, z0, depth, buf)
    if block.device.type == "cpu":
        return unpack_zshell_pallas_plain(block, buf, z0, depth)
    _launch("stp_unpack_zshell", block, buf, z0, depth)
    unpack_zshell_pallas.launches += 1
    return block


def pack_yshell_pallas_plain(block: torch.Tensor, y0: int, depth: int) -> torch.Tensor:
    """``buf[..., k, x, z] = block[..., x, y0 + k, z]`` for ``k < depth``."""
    _check(block, 1, y0, depth)
    return pack_yshell_xla(block, y0, depth)


def pack_yshell_pallas(block: torch.Tensor, y0: int, depth: int) -> torch.Tensor:
    """The y shell ``[y0, y0+depth)`` of ``block`` as a new ``(..., depth,
    X, Z)`` buffer.  CUDA tensors launch the kernel (any 1/2/4/8-byte
    dtype); CPU tensors take the plain version."""
    _check(block, 1, y0, depth)
    if block.device.type == "cpu":
        return pack_yshell_pallas_plain(block, y0, depth)
    buf = torch.empty(yshell_buffer_shape(tuple(block.shape), depth), dtype=block.dtype, device=block.device)
    _launch("stp_pack_yshell", block, buf, y0, depth)
    pack_yshell_pallas.launches += 1
    return buf


def unpack_yshell_pallas_plain(block: torch.Tensor, buf: torch.Tensor, y0: int, depth: int) -> torch.Tensor:
    """``block[..., x, y0 + k, z] = buf[..., k, x, z]``, in place."""
    _check(block, 1, y0, depth, buf)
    block.narrow(-2, y0, depth).copy_(buf.transpose(-3, -2))
    return block


def unpack_yshell_pallas(block: torch.Tensor, buf: torch.Tensor, y0: int, depth: int) -> torch.Tensor:
    """Write a ``(..., depth, X, Z)`` buffer into ``block[..., y0:y0+depth,
    :]`` in place and return ``block``; no other cell changes.  CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    _check(block, 1, y0, depth, buf)
    if block.device.type == "cpu":
        return unpack_yshell_pallas_plain(block, buf, y0, depth)
    _launch("stp_unpack_yshell", block, buf, y0, depth)
    unpack_yshell_pallas.launches += 1
    return block


#: kernel launches made by each wrapper (plain-version calls do not count)
pack_zshell_pallas.launches = 0
unpack_zshell_pallas.launches = 0
pack_yshell_pallas.launches = 0
unpack_yshell_pallas.launches = 0
