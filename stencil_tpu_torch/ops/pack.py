"""Halo pack/unpack: the fused per-neighbour message layout, the slab packs
of bench-pack, and the shell packs of the packed exchange routes.

Counterpart of ``stencil_tpu/ops/pack.py``, in two halves.

**The plan half** (``:73-283``): ``PackPlan`` lays out one neighbour's
fused message as the reference's ``DevicePacker`` does (packer.cuh:136-178):
messages sorted by direction, for each quantity the offset aligned to its
itemsize, the receiver's ``-d`` halo extent ruling the slot's size.
``make_pack_fn`` / ``make_unpack_fn`` (the JAX package's ``xla`` backend)
gather every slot into one ``torch.uint8`` buffer (zeroed alignment gaps,
each slab in C order on (x, y, z), little-endian as JAX's bitcast) and
scatter it back into the halos in place.  ``make_pack_fn_pallas`` /
``make_unpack_fn_pallas`` do one quantity with one kernel launch a slot:
``pallas_pack_slab`` gathers ``block[pos:pos+ext]`` into a dense slab and
``pallas_unpack_slab`` writes a slab into that box in place, on a CUDA
tensor through ``csrc/pack.cu`` (any 1/2/4/8-byte dtype), on a CPU tensor
through the plain versions (``*_plain``).  Dtypes are torch dtypes.

**The shell half** (``:286-474``).
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

The slab packs and both shell pairs launch through cached descriptors, one
a geometry that a pack and its unpack share (``_slab_launch``,
``_zshell_launch``, ``_yshell_launch``): a geometry is checked once, and a
call then costs about what a PyTorch copy costs on the host.

The z buffer carries no lane padding: the TPU pads X to a multiple of 128
(``lane_pad``, ``stencil_tpu/ops/pack.py:298-306``) for its (8,128) tiling,
while a Hopper row coalesces at any width, so the port's buffer is
``(d, Y, X)`` and the JAX buffer's ``[:, :, :X]`` is what it equals.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.geometry import LocalSpec
from stencil_tpu_torch.kernels import check_tensor, current_raw_stream, same_device
from stencil_tpu_torch.ops.halo_blend import supports

# --- the message layout (stencil_tpu/ops/pack.py:73-126) -----------------------


def next_align_of(x: int, align: int) -> int:
    """Round ``x`` up to a multiple of ``align`` (reference align.cuh:7)."""
    return (x + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class PackSlot:
    """One (message, quantity) slice of the packed buffer."""

    direction: Dim3
    quantity: int
    offset: int  # bytes from buffer start (aligned to itemsize)
    pos: Dim3  # allocation-relative source position (interior side)
    unpack_pos: Dim3  # allocation-relative destination position (halo side)
    extent: Dim3
    itemsize: int

    @property
    def nbytes(self) -> int:
        return self.extent.flatten() * self.itemsize


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """Buffer layout for one neighbour's fused message
    (packer.cuh:136-178 prepare)."""

    slots: Tuple[PackSlot, ...]
    size: int  # total bytes

    @staticmethod
    def make(spec: LocalSpec, directions: Sequence, itemsizes: Sequence[int]) -> "PackPlan":
        dirs = sorted(Dim3.of(d) for d in directions)  # sorted by dir (packer.cuh:140)
        slots: List[PackSlot] = []
        size = 0
        for d in dirs:
            for qi, isz in enumerate(itemsizes):
                size = next_align_of(size, isz)
                ext = spec.halo_extent(-d)  # the receiver's -d halo width rules
                slots.append(PackSlot(direction=d, quantity=qi, offset=size, pos=spec.halo_pos(d, halo=False),
                                      unpack_pos=spec.halo_pos(-d, halo=True), extent=ext, itemsize=isz))
                size += ext.flatten() * isz
        if size == 0:
            raise ValueError("zero-size packer was prepared")  # packer.cuh:162
        return PackPlan(tuple(slots), size)


def _box(block: torch.Tensor, pos: Dim3, ext: Dim3) -> torch.Tensor:
    """The ``ext``-sized view of ``block`` at ``pos``."""
    return block[pos.x : pos.x + ext.x, pos.y : pos.y + ext.y, pos.z : pos.z + ext.z]


def make_pack_fn(spec: LocalSpec, directions: Sequence, dtypes: Sequence[torch.dtype]):
    """``pack(blocks) -> uint8 buffer`` over one subdomain's raw blocks (one
    per quantity, each of shape ``spec.raw_size()``), laid out by the
    ``PackPlan``; returns ``(pack, plan)``."""
    plan = PackPlan.make(spec, directions, [t.itemsize for t in dtypes])

    def pack(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        parts = []
        cursor = 0
        dev = blocks[0].device
        for slot in plan.slots:
            if slot.offset != cursor:  # alignment gap
                parts.append(torch.zeros(slot.offset - cursor, dtype=torch.uint8, device=dev))
            parts.append(_box(blocks[slot.quantity], slot.pos, slot.extent).contiguous().view(torch.uint8).reshape(-1))
            cursor = slot.offset + slot.nbytes
        return torch.cat(parts)

    return pack, plan


def make_unpack_fn(spec: LocalSpec, directions: Sequence, dtypes: Sequence[torch.dtype]):
    """``unpack(buffer, blocks) -> blocks`` writing each slot into the halo
    shell of its quantity's block, in place (copy.cuh:26-64 semantics; the
    JAX twin donates the blocks); returns ``(unpack, plan)``."""
    plan = PackPlan.make(spec, directions, [t.itemsize for t in dtypes])

    def unpack(buf: torch.Tensor, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        for slot in plan.slots:
            chunk = buf[slot.offset : slot.offset + slot.nbytes].view(dtypes[slot.quantity])
            _box(blocks[slot.quantity], slot.unpack_pos, slot.extent).copy_(chunk.view(tuple(slot.extent)))
        return list(blocks)

    return unpack, plan


# --- the slab packs (stencil_tpu/ops/pack.py:197-283) ----------------------------


def _check_slab(block: torch.Tensor, pos: Dim3, ext: Dim3, slab: torch.Tensor = None) -> None:
    check_tensor(block, "block", ndims=(3,))
    if not supports(block.dtype):
        raise TypeError(f"the slab kernels take 1/2/4/8-byte dtypes, got {block.dtype}")
    if pos.any_lt(0) or ext.any_lt(0) or any(pos[a] + ext[a] > block.shape[a] for a in range(3)):
        raise ValueError(f"box at {pos} of extent {ext} leaves block {tuple(block.shape)}")
    if ext.flatten() >= 2 ** 31:
        raise ValueError(f"slab extent {ext} holds 2^31 cells or more")
    if slab is None:
        return
    check_tensor(slab, "slab", ndims=(3,))
    same_device(block, slab)
    if slab.dtype != block.dtype:
        raise TypeError(f"slab dtype {slab.dtype} != block dtype {block.dtype}")
    if tuple(slab.shape) != tuple(ext):
        raise ValueError(f"slab shape {tuple(slab.shape)}, want {tuple(ext)}")


# --- the descriptor launch path (the slab packs, both shell pairs) ----------------
#
# A wrapper validates a geometry once and caches a launch for it: an int64
# descriptor that its C entry reads on the host, the descriptor's address and
# the shape of the slab it takes (or of the buffer it makes).  The cache key
# holds everything the kernel depends on (block shape, dtype and the box or
# window), so a hit needs no geometry check; each call still checks what can
# differ under one key (the tensors' type, device and contiguity, the slab's
# shape and dtype) and passes the data pointers and the stream anew, so the
# kernel reads their alignment on every call.  The C entry takes four
# arguments: the descriptor's address, the two data pointers and the stream.
# A pack and an unpack of one geometry share its launch.

#: the int64 fields of a descriptor, in the order the C entries read them
SLAB_DESC_FIELDS = ("itemsize", "X", "Y", "Z", "px", "py", "pz", "ex", "ey", "ez")
ZSHELL_DESC_FIELDS = ("itemsize", "n", "X", "Y", "Z", "z0", "depth")
YSHELL_DESC_FIELDS = ("itemsize", "n", "X", "Y", "Z", "y0", "depth")

_MAX_LAUNCHES = 1024  # geometries a cache holds before it starts afresh
_SLAB_LAUNCHES: dict = {}
_ZSHELL_LAUNCHES: dict = {}
_YSHELL_LAUNCHES: dict = {}
_ENTRIES: dict = {}


def _remember(cache: dict, key, fields: Sequence[int], shape: tuple):
    """Cache and return the launch ``(descriptor, its address, shape)`` of
    ``fields`` under ``key``; the tuple keeps the descriptor alive."""
    desc = (ctypes.c_int64 * len(fields))(*(int(f) for f in fields))
    launch = (desc, ctypes.addressof(desc), shape)
    if len(cache) >= _MAX_LAUNCHES:
        cache.clear()
    try:
        cache[key] = launch
    except TypeError:  # a list for a box corner or extent: checked anew each call
        pass
    return launch


def _slab_launch(block: torch.Tensor, pos, ext):
    """The cached launch of ``pallas_pack_slab`` and ``pallas_unpack_slab``
    for this geometry: ``(descriptor, its address, slab shape)``."""
    key = (block.shape, block.dtype, pos, ext)
    try:
        return _SLAB_LAUNCHES[key]
    except (KeyError, TypeError):
        pass
    pos, ext = Dim3.of(pos), Dim3.of(ext)
    _check_slab(block, pos, ext)
    return _remember(_SLAB_LAUNCHES, key, (block.element_size(), *block.shape, *pos, *ext), tuple(ext))


def _shell_launch(axis: int, block: torch.Tensor, start: int, depth: int):
    """The cached launch of the shell pair on ``axis`` (2: z, 1: y) for this
    geometry: ``(descriptor, its address, buffer shape)``."""
    cache = _ZSHELL_LAUNCHES if axis == 2 else _YSHELL_LAUNCHES
    key = (block.shape, block.dtype, start, depth)
    try:
        return cache[key]
    except (KeyError, TypeError):
        pass
    _check(block, axis, start, depth)
    n = block.shape[0] if block.dim() == 4 else 1
    return _remember(cache, key, (block.element_size(), n, *block.shape[-3:], start, depth),
                     _SHAPES[axis](tuple(block.shape), int(depth)))


def _zshell_launch(block: torch.Tensor, z0: int, depth: int):
    """The cached launch of ``pack_zshell_pallas`` and
    ``unpack_zshell_pallas``: ``(descriptor, its address, buffer shape)``."""
    return _shell_launch(2, block, z0, depth)


def _yshell_launch(block: torch.Tensor, y0: int, depth: int):
    """The cached launch of ``pack_yshell_pallas`` and
    ``unpack_yshell_pallas``: ``(descriptor, its address, buffer shape)``."""
    return _shell_launch(1, block, y0, depth)


def _entry(fn: str):
    """``(C entry, library)`` of ``csrc/pack.cu``, built and loaded at the first launch."""
    entry = _ENTRIES.get(fn)
    if entry is None:
        from stencil_tpu_torch.kernels import build

        lib = build.load("pack")
        entry = _ENTRIES[fn] = (getattr(lib, fn), lib)
    return entry


def _raise_launch(fn: str, rc: int) -> None:
    from stencil_tpu_torch.kernels import build

    build.check(_entry(fn)[1], rc, fn)


def pallas_pack_slab_plain(block: torch.Tensor, pos: Dim3, ext: Dim3) -> torch.Tensor:
    """``block[pos:pos+ext]`` as a new dense ``ext``-shaped tensor."""
    _check_slab(block, pos, ext)
    return _box(block, pos, ext).clone(memory_format=torch.contiguous_format)


def pallas_pack_slab(block: torch.Tensor, pos: Dim3, ext: Dim3) -> torch.Tensor:
    """The box ``block[pos:pos+ext]`` of an ``(X, Y, Z)`` block as a new dense
    ``ext``-shaped tensor, C order on (x, y, z).  CUDA tensors launch the
    kernel (any 1/2/4/8-byte dtype); CPU tensors take the plain version."""
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return pallas_pack_slab_plain(block, Dim3.of(pos), Dim3.of(ext))
    dev = block.device
    _, addr, slab_shape = _slab_launch(block, pos, ext)
    if not block.is_contiguous():
        _check_slab(block, Dim3.of(pos), Dim3.of(ext))  # raises with the reason
    slab = torch.empty(slab_shape, dtype=block.dtype, device=dev)
    rc = _entry("stp_pack_slab_desc")[0](addr, block.data_ptr(), slab.data_ptr(), current_raw_stream(dev.index))
    if rc:
        _raise_launch("stp_pack_slab_desc", rc)
    pallas_pack_slab.launches += 1
    return slab


def pallas_unpack_slab_plain(block: torch.Tensor, slab: torch.Tensor, pos: Dim3, ext: Dim3) -> torch.Tensor:
    """``block[pos:pos+ext] = slab``, in place."""
    _check_slab(block, pos, ext, slab)
    _box(block, pos, ext).copy_(slab)
    return block


def pallas_unpack_slab(block: torch.Tensor, slab: torch.Tensor, pos: Dim3, ext: Dim3) -> torch.Tensor:
    """Write the dense ``ext``-shaped ``slab`` into the box at ``pos`` of an
    ``(X, Y, Z)`` block in place and return ``block``; every cell outside the
    box keeps its value.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return pallas_unpack_slab_plain(block, slab, Dim3.of(pos), Dim3.of(ext))
    dev = block.device
    _, addr, slab_shape = _slab_launch(block, pos, ext)
    if not (block.is_contiguous() and isinstance(slab, torch.Tensor) and slab.dtype == block.dtype
            and slab.shape == slab_shape and slab.is_contiguous() and slab.device == dev):
        _check_slab(block, Dim3.of(pos), Dim3.of(ext), slab)  # raises with the reason
    rc = _entry("stp_unpack_slab_desc")[0](addr, block.data_ptr(), slab.data_ptr(), current_raw_stream(dev.index))
    if rc:
        _raise_launch("stp_unpack_slab_desc", rc)
    pallas_unpack_slab.launches += 1
    return block


def make_pack_fn_pallas(spec: LocalSpec, directions: Sequence, dtype: torch.dtype):
    """``pack(block) -> list of slabs`` for one quantity, one
    ``pallas_pack_slab`` launch a slot (layout per ``PackPlan``); returns
    ``(pack, plan)``."""
    plan = PackPlan.make(spec, directions, [dtype.itemsize])

    def pack(block: torch.Tensor) -> List[torch.Tensor]:
        return [pallas_pack_slab(block, slot.pos, slot.extent) for slot in plan.slots]

    return pack, plan


def make_unpack_fn_pallas(spec: LocalSpec, directions: Sequence, dtype: torch.dtype):
    """``unpack(block, slabs) -> block`` for one quantity, one
    ``pallas_unpack_slab`` launch a slot, in place; returns ``(unpack,
    plan)``."""
    plan = PackPlan.make(spec, directions, [dtype.itemsize])

    def unpack(block: torch.Tensor, slabs: Sequence[torch.Tensor]) -> torch.Tensor:
        for slot, slab in zip(plan.slots, slabs):
            pallas_unpack_slab(block, slab, slot.unpack_pos, slot.extent)
        return block

    return unpack, plan


# --- the shell packs (stencil_tpu/ops/pack.py:286-474) ----------------------------


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


def _pack_shell(entry: str, axis: int, block: torch.Tensor, start: int, depth: int) -> torch.Tensor:
    """Launch a shell pack on a CUDA ``block`` through ``entry``; returns the new buffer."""
    dev = block.device
    _, addr, buf_shape = _shell_launch(axis, block, start, depth)
    if not block.is_contiguous():
        _check(block, axis, start, depth)  # raises with the reason
    buf = torch.empty(buf_shape, dtype=block.dtype, device=dev)
    rc = _entry(entry)[0](addr, block.data_ptr(), buf.data_ptr(), current_raw_stream(dev.index))
    if rc:
        _raise_launch(entry, rc)
    return buf


def _unpack_shell(entry: str, axis: int, block: torch.Tensor, buf: torch.Tensor, start: int, depth: int) -> None:
    """Launch a shell unpack of ``buf`` into a CUDA ``block`` through ``entry``."""
    dev = block.device
    _, addr, buf_shape = _shell_launch(axis, block, start, depth)
    if not (block.is_contiguous() and isinstance(buf, torch.Tensor) and buf.dtype == block.dtype
            and buf.shape == buf_shape and buf.is_contiguous() and buf.device == dev):
        _check(block, axis, start, depth, buf)  # raises with the reason
    rc = _entry(entry)[0](addr, block.data_ptr(), buf.data_ptr(), current_raw_stream(dev.index))
    if rc:
        _raise_launch(entry, rc)


def pack_zshell_pallas_plain(block: torch.Tensor, z0: int, depth: int) -> torch.Tensor:
    """``buf[..., k, y, x] = block[..., x, y, z0 + k]`` for ``k < depth``."""
    _check(block, 2, z0, depth)
    return pack_zshell_xla(block, z0, depth)


def pack_zshell_pallas(block: torch.Tensor, z0: int, depth: int) -> torch.Tensor:
    """The z shell ``[z0, z0+depth)`` of ``block`` as a new ``(..., depth,
    Y, X)`` buffer.  CUDA tensors launch the kernel (any 1/2/4/8-byte
    dtype); CPU tensors take the plain version."""
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return pack_zshell_pallas_plain(block, z0, depth)
    buf = _pack_shell("stp_pack_zshell_desc", 2, block, z0, depth)
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
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return unpack_zshell_pallas_plain(block, buf, z0, depth)
    _unpack_shell("stp_unpack_zshell_desc", 2, block, buf, z0, depth)
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
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return pack_yshell_pallas_plain(block, y0, depth)
    buf = _pack_shell("stp_pack_yshell_desc", 1, block, y0, depth)
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
    if not isinstance(block, torch.Tensor) or block.device.type != "cuda":
        return unpack_yshell_pallas_plain(block, buf, y0, depth)
    _unpack_shell("stp_unpack_yshell_desc", 1, block, buf, y0, depth)
    unpack_yshell_pallas.launches += 1
    return block


#: kernel launches made by each wrapper (plain-version calls do not count)
pallas_pack_slab.launches = 0
pallas_unpack_slab.launches = 0
pack_zshell_pallas.launches = 0
unpack_zshell_pallas.launches = 0
pack_yshell_pallas.launches = 0
unpack_yshell_pallas.launches = 0
