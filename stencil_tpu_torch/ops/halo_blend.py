"""Halo slab writes: ``blend_slab``, ``blend_slab_dynamic`` and their plain
versions.

Counterpart of ``stencil_tpu/ops/halo_blend.py``.  On the TPU, ``blend_slab``
is a Pallas kernel that keeps a thin halo write tile-local under the (8,128)
layout.  The port keeps what it computes: write ``slab`` into ``block`` at
offset ``pos`` along ``axis``, in place.  ``blend_slab_dynamic`` is the same
write at a run-time offset per block (the +axis halo of an uneven axis).  On a
CUDA tensor each is the hand-written kernel ``csrc/halo_blend.cu``; on a CPU
tensor it is the plain version, a copy into the narrowed view.

All take a single block ``(X, Y, Z)`` or ``n`` blocks ``(n, X, Y, Z)`` with
slabs of matching rank; one launch serves all ``n`` blocks.
"""

from __future__ import annotations

import torch

from stencil_tpu_torch.kernels import check_tensor, same_device, stream_handle


def supports(dtype: torch.dtype) -> bool:
    """Do the kernels (these and the shell packs) take ``dtype``?  Any of
    1, 2, 4 or 8 bytes (``stencil_tpu/ops/halo_blend.py:59`` knows the
    (8,128) tile geometry of the same widths)."""
    return dtype.itemsize in (1, 2, 4, 8)


def _check(block: torch.Tensor, slab: torch.Tensor, axis: int, pos: int) -> int:
    check_tensor(block, "block", ndims=(3, 4))
    check_tensor(slab, "slab", ndims=(block.dim(),))
    same_device(block, slab)
    if slab.dtype != block.dtype:
        raise TypeError(f"slab dtype {slab.dtype} != block dtype {block.dtype}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    lead = block.dim() - 3
    r = slab.shape[lead + axis]
    want = list(block.shape)
    want[lead + axis] = r
    if list(slab.shape) != want:
        raise ValueError(f"slab shape {tuple(slab.shape)} does not fit block {tuple(block.shape)} on axis {axis}")
    if not 0 <= pos <= block.shape[lead + axis] - r:
        raise ValueError(f"slab of width {r} at {pos} leaves axis {axis} of extent {block.shape[lead + axis]}")
    return r


def blend_slab_plain(block: torch.Tensor, slab: torch.Tensor, axis: int, pos: int) -> torch.Tensor:
    """``block[..., pos:pos+r, ...] = slab`` along spatial ``axis``, in place."""
    r = _check(block, slab, axis, pos)
    block.narrow(block.dim() - 3 + axis, pos, r).copy_(slab)
    return block


def blend_slab(block: torch.Tensor, slab: torch.Tensor, axis: int, pos: int) -> torch.Tensor:
    """Write ``slab`` into ``block`` at ``pos`` along ``axis`` (0 = x, 1 = y,
    2 = z), in place, and return ``block``.  CUDA tensors launch the kernel
    (any 1/2/4/8-byte dtype); CPU tensors take the plain version."""
    r = _check(block, slab, axis, pos)
    if block.device.type == "cpu":
        return blend_slab_plain(block, slab, axis, pos)
    from stencil_tpu_torch.kernels import build

    lib = build.load("halo_blend")
    n = block.shape[0] if block.dim() == 4 else 1
    X, Y, Z = block.shape[-3:]
    rc = lib.stp_blend_slab(
        block.data_ptr(), slab.data_ptr(), block.element_size(),
        n, X, Y, Z, axis, r, pos, stream_handle(block.device),
    )
    build.check(lib, rc, "blend_slab")
    blend_slab.launches += 1
    return block


#: kernel launches made by ``blend_slab`` (plain-version calls do not count)
blend_slab.launches = 0


def _check_dynamic(block: torch.Tensor, slab: torch.Tensor, axis: int, pos: torch.Tensor) -> int:
    r = _check(block, slab, axis, 0)
    n = block.shape[0] if block.dim() == 4 else 1
    check_tensor(pos, "pos", ndims=(1,), dtype=torch.int32)
    same_device(block, pos)
    if pos.shape[0] != n:
        raise ValueError(f"pos holds {pos.shape[0]} offsets for {n} block(s)")
    return r


def blend_slab_dynamic_plain(block: torch.Tensor, slab: torch.Tensor, axis: int,
                             pos: torch.Tensor) -> torch.Tensor:
    """``blend_slab_plain`` with one offset per block: block ``b``'s slab
    lands at ``pos[b]`` along ``axis``, clamped into ``[0, extent - r]`` as
    ``lax.dynamic_update_slice`` clamps; in place."""
    r = _check_dynamic(block, slab, axis, pos)
    blocks, slabs = (block[None], slab[None]) if block.dim() == 3 else (block, slab)
    top = blocks.shape[1 + axis] - r
    for b, p in enumerate(pos.tolist()):
        blocks[b].narrow(axis, min(max(p, 0), top), r).copy_(slabs[b])
    return block


def blend_slab_dynamic(block: torch.Tensor, slab: torch.Tensor, axis: int,
                       pos: torch.Tensor) -> torch.Tensor:
    """Write each block's ``slab`` at its own run-time offset ``pos[b]``
    along ``axis`` (0 = x, 1 = y, 2 = z), in place, and return ``block``: the
    +axis halo of a padded (uneven) axis, which lands right after each
    block's valid cells.  ``block`` is ``(n, X, Y, Z)`` (or one ``(X, Y,
    Z)``), ``pos`` an int32 tensor of ``n`` offsets on the block's device;
    an offset outside ``[0, extent - r]`` is clamped into it, so the CUDA
    path reads no offset back to the host.  CUDA tensors launch the kernel
    (any 1/2/4/8-byte dtype, all blocks in one launch); CPU tensors take the
    plain version.

    The TPU kernel serves axes 1 and 2; the JAX package writes the x halo
    with ``lax.dynamic_update_slice``.  The port sends axis 0 here too,
    because an x sub-view of the ``(n, X, Y, Z)`` stack is not contiguous."""
    r = _check_dynamic(block, slab, axis, pos)
    if block.device.type == "cpu":
        return blend_slab_dynamic_plain(block, slab, axis, pos)
    from stencil_tpu_torch.kernels import build

    lib = build.load("halo_blend")
    n = block.shape[0] if block.dim() == 4 else 1
    X, Y, Z = block.shape[-3:]
    rc = lib.stp_blend_slab_dynamic(
        block.data_ptr(), slab.data_ptr(), pos.data_ptr(), block.element_size(),
        n, X, Y, Z, axis, r, stream_handle(block.device),
    )
    build.check(lib, rc, "blend_slab_dynamic")
    blend_slab_dynamic.launches += 1
    return block


#: kernel launches made by ``blend_slab_dynamic`` (plain-version calls do not count)
blend_slab_dynamic.launches = 0
