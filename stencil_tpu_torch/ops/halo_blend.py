"""Halo slab writes: ``blend_slab``, ``blend_slab_dynamic`` and their plain
versions.

Counterpart of ``stencil_tpu/ops/halo_blend.py``.  On the TPU, ``blend_slab``
is a Pallas kernel that keeps a thin halo write tile-local under the (8,128)
layout.  The port keeps what it computes: write ``slab`` into ``block`` at
offset ``pos`` along ``axis``, in place.  ``blend_slab_dynamic`` is the same
write at a run-time offset per block (the +axis halo of an uneven axis).  On a
CUDA tensor each is the slab unpack of ``csrc/pack.cu`` (the n blocks as one
block, the slab as a box in it; the dynamic write moves each block's rows by
its offset, read on the device); on a CPU tensor each is the plain version, a
copy into the narrowed view.

Both launch through a cached descriptor, as the slab packs of ``ops/pack.py``
do: a geometry (block shape, dtype, axis, slab width and, for ``blend_slab``,
position) is checked once and its int64 descriptor cached, and a call then
checks the tensors, passes the descriptor's address, the data pointers (and
the offsets') and the raw stream to the C entry, and costs about what a
PyTorch copy costs on the host.

All take a single block ``(X, Y, Z)`` or ``n`` blocks ``(n, X, Y, Z)`` with
slabs of matching rank; one launch serves all ``n`` blocks.
"""

from __future__ import annotations

import math

import torch

from stencil_tpu_torch.kernels import check_tensor, current_raw_stream, same_device


def supports(dtype: torch.dtype) -> bool:
    """Do the kernels (these and the packs) take ``dtype``?  Any of
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


#: the int64 fields of a ``blend_slab`` descriptor, in the order the C entry
#: ``stp_blend_slab_desc`` of ``csrc/pack.cu`` reads them
BLEND_DESC_FIELDS = ("itemsize", "n", "X", "Y", "Z", "axis", "r", "pos")

#: the int64 fields of a ``blend_slab_dynamic`` descriptor, in the order the C
#: entry ``stp_blend_slab_dynamic_desc`` reads them (the offsets come apart)
BLEND_DYN_DESC_FIELDS = ("itemsize", "n", "X", "Y", "Z", "axis", "r")

_BLEND_LAUNCHES: dict = {}
_BLEND_DYN_LAUNCHES: dict = {}
_ENTRIES: dict = {}


def _blend_geometry(cache: dict, block: torch.Tensor, axis: int, r: int, pos):
    """The cached launch of a blend for this geometry: ``(descriptor, its
    address, slab shape)``; ``pos`` None is the dynamic write's, whose
    descriptor has no position.  A geometry is checked before it is cached."""
    key = (block.shape, block.dtype, axis, r) + (() if pos is None else (pos,))
    try:
        return cache[key]
    except (KeyError, TypeError):
        pass
    check_tensor(block, "block", ndims=(3, 4))
    if not supports(block.dtype):
        raise TypeError(f"the blend kernel takes 1/2/4/8-byte dtypes, got {block.dtype}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    lead = block.dim() - 3
    ext = block.shape[lead + axis]
    if not (r >= 0 and 0 <= (0 if pos is None else pos) <= ext - r):
        raise ValueError(f"slab of width {r} at {pos} leaves axis {axis} of extent {ext}")
    shape = list(block.shape)
    shape[lead + axis] = r
    if math.prod(shape) >= 2 ** 31:
        raise ValueError(f"slab {tuple(shape)} holds 2^31 cells or more")
    from stencil_tpu_torch.ops.pack import _remember

    n = block.shape[0] if lead else 1
    fields = (block.element_size(), n, *block.shape[-3:], axis, r) + (() if pos is None else (pos,))
    return _remember(cache, key, fields, torch.Size(shape))


def _blend_launch(block: torch.Tensor, axis: int, r: int, pos: int):
    """The cached launch of ``blend_slab``: ``(descriptor, its address, slab shape)``."""
    return _blend_geometry(_BLEND_LAUNCHES, block, axis, r, pos)


def _blend_dynamic_launch(block: torch.Tensor, axis: int, r: int):
    """The cached launch of ``blend_slab_dynamic``: ``(descriptor, its
    address, slab shape)``; the offsets are not part of it."""
    return _blend_geometry(_BLEND_DYN_LAUNCHES, block, axis, r, None)


def _entry(fn: str = "stp_blend_slab_desc"):
    """``(C entry, library)`` of ``fn`` in ``csrc/pack.cu``, built and loaded
    at the first launch."""
    found = _ENTRIES.get(fn)
    if found is None:
        from stencil_tpu_torch.kernels import build

        lib = build.load("pack")
        found = _ENTRIES[fn] = (getattr(lib, fn), lib)
    return found


def blend_slab(block: torch.Tensor, slab: torch.Tensor, axis: int, pos: int) -> torch.Tensor:
    """Write ``slab`` into ``block`` at ``pos`` along ``axis`` (0 = x, 1 = y,
    2 = z), in place, and return ``block``.  CUDA tensors launch the kernel
    (any 1/2/4/8-byte dtype) through the cached descriptor of the geometry;
    CPU tensors take the plain version."""
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return blend_slab_plain(block, slab, axis, pos)
    try:
        r = slab.shape[block.dim() - 3 + axis]
    except (AttributeError, IndexError, TypeError):
        r = _check(block, slab, axis, pos)  # raises with the reason
    _, addr, slab_shape = _blend_launch(block, axis, r, pos)
    dev = block.device
    if not (block.is_contiguous() and isinstance(slab, torch.Tensor) and slab.dtype == block.dtype
            and slab.shape == slab_shape and slab.is_contiguous() and slab.device == dev):
        _check(block, slab, axis, pos)  # raises with the reason
    entry, lib = _entry()
    rc = entry(addr, block.data_ptr(), slab.data_ptr(), current_raw_stream(dev.index))
    if rc:
        from stencil_tpu_torch.kernels import build

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
    (any 1/2/4/8-byte dtype, all blocks in one launch) through the cached
    descriptor of the geometry, the offsets checked and passed anew every
    call; CPU tensors take the plain version.

    The TPU kernel serves axes 1 and 2; the JAX package writes the x halo
    with ``lax.dynamic_update_slice``.  The port sends axis 0 here too,
    because an x sub-view of the ``(n, X, Y, Z)`` stack is not contiguous."""
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return blend_slab_dynamic_plain(block, slab, axis, pos)
    dev = block.device
    # the offsets first: a refused pos leaves the geometry's cache as it was
    if not (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 and pos.dim() == 1
            and pos.shape[0] == (block.shape[0] if block.dim() == 4 else 1) and pos.is_contiguous()
            and pos.device == dev):
        _check_dynamic(block, slab, axis, pos)  # raises with the reason
    try:
        r = slab.shape[block.dim() - 3 + axis]
    except (AttributeError, IndexError, TypeError):
        r = _check_dynamic(block, slab, axis, pos)  # raises with the reason
    _, addr, slab_shape = _blend_dynamic_launch(block, axis, r)
    if not (block.is_contiguous() and isinstance(slab, torch.Tensor) and slab.dtype == block.dtype
            and slab.shape == slab_shape and slab.is_contiguous() and slab.device == dev):
        _check_dynamic(block, slab, axis, pos)  # raises with the reason
    entry, lib = _entry("stp_blend_slab_dynamic_desc")
    rc = entry(addr, block.data_ptr(), slab.data_ptr(), pos.data_ptr(), current_raw_stream(dev.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "blend_slab_dynamic")
    blend_slab_dynamic.launches += 1
    return block


#: kernel launches made by ``blend_slab_dynamic`` (plain-version calls do not count)
blend_slab_dynamic.launches = 0
