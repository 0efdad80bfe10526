"""The descriptor launch path of the slab packs (``pallas_pack_slab``,
``pallas_unpack_slab``), the z-shell pair (``pack_zshell_pallas``,
``unpack_zshell_pallas``) and the y-shell pair (``pack_yshell_pallas``,
``unpack_yshell_pallas``) of ``stencil_tpu_torch/ops/pack.py``, and of
``blend_slab_dynamic`` (``ops/halo_blend.py``, the same C source), on the CPU.

* the descriptor holds the int64 fields the C entries of ``csrc/pack.cu``
  read, in their order;
* one geometry hits its cached launch, and another block shape, dtype, box or
  window misses it; a pack and an unpack of one geometry share it;
* a box or window that leaves the block raises before anything is cached;
* every refusal of the six wrappers raises with its message, on the launch
  path's own checks as on the plain branch;
* the wrappers on CPU tensors still run the plain versions, bitwise equal to
  the JAX package's Pallas kernels in interpret mode, and count no launch;
* ``blend_slab_dynamic``'s descriptor holds no offset: the offsets (an int32
  ``(n,)`` tensor on the block's device) are checked and passed anew every
  call, and one of the wrong dtype, length or device is refused every time
  and never cached.

The launch path itself runs here on tensors that report a CUDA device, with
a Python stand-in for each C entry that reads the descriptor at the address
it is given, as the C entry does.  The kernels themselves run only on the
card (tests/test_torch_cuda.py).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.ops import pack as jpk
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.ops import halo_blend as hb
from stencil_tpu_torch.ops import pack as pk

torch.set_num_threads(1)


def _fields(launch):
    return list(launch[0])


def test_slab_descriptor_holds_the_fields_the_c_entry_reads():
    block = torch.zeros(17, 19, 23, dtype=torch.float64)
    desc, addr, shape = pk._slab_launch(block, Dim3(1, 2, 20), Dim3(15, 17, 3))
    want = dict(itemsize=8, X=17, Y=19, Z=23, px=1, py=2, pz=20, ex=15, ey=17, ez=3)
    assert _fields((desc,)) == [want[f] for f in pk.SLAB_DESC_FIELDS]
    assert addr == ctypes.addressof(desc)
    assert shape == (15, 17, 3)


@pytest.mark.parametrize("shape,n", [((17, 19, 23), 1), ((3, 17, 19, 23), 3)])
def test_yshell_descriptor_holds_the_fields_the_c_entry_reads(shape, n):
    block = torch.zeros(shape, dtype=torch.bfloat16)
    desc, _, buf_shape = pk._yshell_launch(block, 5, 3)
    want = dict(itemsize=2, n=n, X=17, Y=19, Z=23, y0=5, depth=3)
    assert _fields((desc,)) == [want[f] for f in pk.YSHELL_DESC_FIELDS]
    assert buf_shape == pk.yshell_buffer_shape(shape, 3)


@pytest.mark.parametrize("shape,n", [((17, 19, 23), 1), ((3, 17, 19, 23), 3)])
def test_zshell_descriptor_holds_the_fields_the_c_entry_reads(shape, n):
    block = torch.zeros(shape, dtype=torch.uint8)
    desc, addr, buf_shape = pk._zshell_launch(block, 20, 3)
    want = dict(itemsize=1, n=n, X=17, Y=19, Z=23, z0=20, depth=3)
    assert _fields((desc,)) == [want[f] for f in pk.ZSHELL_DESC_FIELDS]
    assert addr == ctypes.addressof(desc)
    assert buf_shape == pk.zshell_buffer_shape(shape, 3) == shape[:-3] + (3, 19, 17)


def test_slab_launch_cache_hits_one_geometry_and_misses_others():
    block = torch.zeros(9, 10, 11)
    first = pk._slab_launch(block, Dim3(2, 1, 3), Dim3(4, 7, 5))
    # the same geometry, in another block of the same shape and dtype
    assert pk._slab_launch(torch.ones(9, 10, 11), Dim3(2, 1, 3), Dim3(4, 7, 5)) is first
    others = [
        pk._slab_launch(torch.zeros(9, 10, 12), Dim3(2, 1, 3), Dim3(4, 7, 5)),  # shape
        pk._slab_launch(block.double(), Dim3(2, 1, 3), Dim3(4, 7, 5)),  # dtype
        pk._slab_launch(block, Dim3(2, 1, 4), Dim3(4, 7, 5)),  # corner
        pk._slab_launch(block, Dim3(2, 1, 3), Dim3(4, 7, 4)),  # extent
    ]
    for other in others:
        assert other is not first and _fields(other) != _fields(first)
    assert _fields(others[0])[3] == 12 and _fields(others[1])[0] == 8
    # two shapes called in turn each keep their own launch
    for _ in range(2):
        assert pk._slab_launch(block, Dim3(2, 1, 3), Dim3(4, 7, 5)) is first
        assert _fields(pk._slab_launch(torch.zeros(9, 10, 12), Dim3(2, 1, 3), Dim3(4, 7, 5)))[3] == 12


def test_yshell_launch_cache_hits_one_geometry_and_misses_others():
    block = torch.zeros(3, 5, 7, 9)
    first = pk._yshell_launch(block, 2, 3)
    assert pk._yshell_launch(torch.ones(3, 5, 7, 9), 2, 3) is first
    others = [
        pk._yshell_launch(torch.zeros(2, 5, 7, 9), 2, 3),  # n
        pk._yshell_launch(torch.zeros(5, 7, 9), 2, 3),  # one block
        pk._yshell_launch(block.to(torch.uint8), 2, 3),  # dtype
        pk._yshell_launch(block, 1, 3),  # window start
        pk._yshell_launch(block, 2, 2),  # depth
    ]
    for other in others:
        assert other is not first and _fields(other) != _fields(first)
    assert others[0][2] == (2, 3, 5, 9) and others[4][2] == (3, 2, 5, 9)


def test_zshell_launch_cache_hits_one_geometry_and_misses_others():
    block = torch.zeros(3, 5, 7, 9)
    first = pk._zshell_launch(block, 2, 3)
    assert pk._zshell_launch(torch.ones(3, 5, 7, 9), 2, 3) is first
    others = [
        pk._zshell_launch(torch.zeros(2, 5, 7, 9), 2, 3),  # n
        pk._zshell_launch(torch.zeros(5, 7, 9), 2, 3),  # one block
        pk._zshell_launch(torch.zeros(3, 5, 8, 9), 2, 3),  # shape
        pk._zshell_launch(block.to(torch.float64), 2, 3),  # dtype
        pk._zshell_launch(block, 1, 3),  # window start
        pk._zshell_launch(block, 2, 2),  # depth
    ]
    for other in others:
        assert other is not first and _fields(other) != _fields(first)
    assert others[0][2] == (2, 3, 7, 5) and others[5][2] == (3, 2, 7, 5)
    # the y pair's cache is its own: the same geometry there is another launch
    assert pk._yshell_launch(block, 2, 3)[2] == (3, 3, 5, 9)


def test_a_zshell_window_that_leaves_the_block_is_refused_before_caching():
    block = torch.zeros(6, 6, 6)
    before = dict(pk._ZSHELL_LAUNCHES)
    for z0, depth in ((5, 2), (-1, 2), (0, 0), (0, 7)):
        with pytest.raises(ValueError, match="does not fit"):
            pk._zshell_launch(block, z0, depth)
    with pytest.raises(TypeError, match="1/2/4/8-byte"):
        pk._zshell_launch(block.to(torch.complex128), 0, 1)
    assert pk._ZSHELL_LAUNCHES == before


def test_a_box_or_window_that_leaves_the_block_is_refused_before_caching():
    block = torch.zeros(6, 6, 6)
    before = (dict(pk._SLAB_LAUNCHES), dict(pk._YSHELL_LAUNCHES))
    with pytest.raises(ValueError, match="leaves block"):
        pk._slab_launch(block, Dim3(4, 0, 0), Dim3(3, 1, 1))
    with pytest.raises(ValueError, match="leaves block"):
        pk._slab_launch(block, Dim3(0, -1, 0), Dim3(1, 1, 1))
    with pytest.raises(ValueError, match="does not fit"):
        pk._yshell_launch(block, 5, 2)
    with pytest.raises(TypeError, match="1/2/4/8-byte"):
        pk._yshell_launch(block.to(torch.complex128), 0, 1)
    assert (pk._SLAB_LAUNCHES, pk._YSHELL_LAUNCHES) == before


def test_a_list_box_is_checked_every_call_and_never_cached():
    block = torch.zeros(6, 6, 6)
    size = len(pk._SLAB_LAUNCHES)
    launch = pk._slab_launch(block, [1, 1, 1], [2, 2, 2])
    assert _fields(launch)[4:] == [1, 1, 1, 2, 2, 2] and len(pk._SLAB_LAUNCHES) == size


def test_the_caches_start_afresh_when_full(monkeypatch):
    monkeypatch.setattr(pk, "_MAX_LAUNCHES", 2)
    monkeypatch.setattr(pk, "_SLAB_LAUNCHES", {})
    block = torch.zeros(6, 6, 6)
    for z in range(3):
        pk._slab_launch(block, Dim3(0, 0, z), Dim3(1, 1, 1))
    assert len(pk._SLAB_LAUNCHES) == 1


def _refusals(fn, block, z):
    """``(exception, message, call)`` for every refusal of wrapper ``fn``
    on ``block`` (6, 6, 6), with ``z(*shape, dtype=)`` making its second
    tensors on the block's device."""
    if fn == "pack_slab":
        return [
            (TypeError, "1/2/4/8-byte", lambda: pk.pallas_pack_slab(block.to(torch.complex128), (0, 0, 0),
                                                                    (1, 1, 1))),
            (ValueError, "leaves block", lambda: pk.pallas_pack_slab(block, (4, 0, 0), (3, 1, 1))),
            (ValueError, "leaves block", lambda: pk.pallas_pack_slab(block, (0, -1, 0), (1, 1, 1))),
            (ValueError, "block must be C-contiguous", lambda: pk.pallas_pack_slab(block.transpose(0, 2), (0, 0, 0),
                                                                                   (2, 2, 2))),
            (ValueError, "block must have 3 dims", lambda: pk.pallas_pack_slab(block[None], (0, 0, 0), (1, 1, 1))),
            (TypeError, "block must be a torch.Tensor", lambda: pk.pallas_pack_slab(
                np.zeros((6, 6, 6), np.float32), (0, 0, 0), (1, 1, 1))),
        ]
    if fn == "unpack_yshell":
        return [
            (ValueError, "does not fit", lambda: pk.unpack_yshell_pallas(block, z(2, 6, 6), 5, 2)),
            (ValueError, "does not fit", lambda: pk.unpack_yshell_pallas(block, z(0, 6, 6), 0, 0)),
            (TypeError, "1/2/4/8-byte", lambda: pk.unpack_yshell_pallas(
                block.to(torch.complex128), z(1, 6, 6, dtype=torch.complex128), 0, 1)),
            (ValueError, "buf shape", lambda: pk.unpack_yshell_pallas(block, z(2, 6, 6), 0, 1)),
            (ValueError, "buf shape", lambda: pk.unpack_yshell_pallas(block, z(3, 6, 5), 1, 3)),
            (TypeError, "buf dtype", lambda: pk.unpack_yshell_pallas(block, z(1, 6, 6, dtype=torch.float64), 0, 1)),
            (ValueError, "buf must be C-contiguous", lambda: pk.unpack_yshell_pallas(block, z(1, 6, 6).transpose(1, 2),
                                                                                     0, 1)),
            (ValueError, "block must be C-contiguous", lambda: pk.unpack_yshell_pallas(block.transpose(0, 2),
                                                                                       z(1, 6, 6), 0, 1)),
            (ValueError, "buf must have 3 dims", lambda: pk.unpack_yshell_pallas(block, z(1, 1, 6, 6), 0, 1)),
            (TypeError, "buf must be a torch.Tensor", lambda: pk.unpack_yshell_pallas(
                block, np.zeros((1, 6, 6), np.float32), 0, 1)),
            (TypeError, "block must be a torch.Tensor", lambda: pk.unpack_yshell_pallas(
                np.zeros((6, 6, 6), np.float32), z(1, 6, 6), 0, 1)),
            (ValueError, "must have 3 or 4 dims", lambda: pk.unpack_yshell_pallas(z(6, 6), z(1, 6), 0, 1)),
        ]
    if fn == "pack_zshell":
        return [
            (ValueError, "does not fit", lambda: pk.pack_zshell_pallas(block, 5, 2)),
            (ValueError, "does not fit", lambda: pk.pack_zshell_pallas(block, 0, 0)),
            (TypeError, "1/2/4/8-byte", lambda: pk.pack_zshell_pallas(block.to(torch.complex128), 0, 1)),
            (ValueError, "block must be C-contiguous", lambda: pk.pack_zshell_pallas(block.transpose(0, 2), 0, 1)),
            (ValueError, "must have 3 or 4 dims", lambda: pk.pack_zshell_pallas(z(6, 6), 0, 1)),
            (TypeError, "block must be a torch.Tensor", lambda: pk.pack_zshell_pallas(
                np.zeros((6, 6, 6), np.float32), 0, 1)),
        ]
    if fn == "unpack_zshell":
        return [
            (ValueError, "does not fit", lambda: pk.unpack_zshell_pallas(block, z(2, 6, 6), 5, 2)),
            (ValueError, "does not fit", lambda: pk.unpack_zshell_pallas(block, z(0, 6, 6), 0, 0)),
            (TypeError, "1/2/4/8-byte", lambda: pk.unpack_zshell_pallas(
                block.to(torch.complex128), z(1, 6, 6, dtype=torch.complex128), 0, 1)),
            (ValueError, "buf shape", lambda: pk.unpack_zshell_pallas(block, z(2, 6, 6), 0, 1)),
            (ValueError, "buf shape", lambda: pk.unpack_zshell_pallas(block, z(3, 6, 5), 1, 3)),
            (TypeError, "buf dtype", lambda: pk.unpack_zshell_pallas(block, z(1, 6, 6, dtype=torch.float64), 0, 1)),
            (ValueError, "buf must be C-contiguous", lambda: pk.unpack_zshell_pallas(block, z(1, 6, 6).transpose(1, 2),
                                                                                     0, 1)),
            (ValueError, "block must be C-contiguous", lambda: pk.unpack_zshell_pallas(block.transpose(0, 2),
                                                                                       z(1, 6, 6), 0, 1)),
            (ValueError, "buf must have 3 dims", lambda: pk.unpack_zshell_pallas(block, z(1, 1, 6, 6), 0, 1)),
            (TypeError, "buf must be a torch.Tensor", lambda: pk.unpack_zshell_pallas(
                block, np.zeros((1, 6, 6), np.float32), 0, 1)),
            (TypeError, "block must be a torch.Tensor", lambda: pk.unpack_zshell_pallas(
                np.zeros((6, 6, 6), np.float32), z(1, 6, 6), 0, 1)),
            (ValueError, "must have 3 or 4 dims", lambda: pk.unpack_zshell_pallas(z(6, 6), z(1, 6), 0, 1)),
        ]
    raise KeyError(fn)


@pytest.mark.parametrize("fn", ["unpack", "pack_yshell", "pack_slab", "unpack_yshell", "pack_zshell", "unpack_zshell"])
def test_every_refusal_still_raises(fn):
    block = torch.zeros(6, 6, 6)
    if fn in ("pack_slab", "unpack_yshell", "pack_zshell", "unpack_zshell"):
        cases = _refusals(fn, block, torch.zeros)
    elif fn == "unpack":
        cases = [
            (TypeError, "1/2/4/8-byte", lambda: pk.pallas_unpack_slab(
                block.to(torch.complex128), torch.zeros(1, 1, 1, dtype=torch.complex128), (0, 0, 0), (1, 1, 1))),
            (ValueError, "leaves block", lambda: pk.pallas_unpack_slab(block, torch.zeros(3, 1, 1), (4, 0, 0),
                                                                       (3, 1, 1))),
            (ValueError, "slab shape", lambda: pk.pallas_unpack_slab(block, torch.zeros(2, 2, 2), (0, 0, 0),
                                                                     (2, 2, 3))),
            (TypeError, "slab dtype", lambda: pk.pallas_unpack_slab(block, torch.zeros(2, 2, 2, dtype=torch.float64),
                                                                    (0, 0, 0), (2, 2, 2))),
            (ValueError, "slab must be C-contiguous", lambda: pk.pallas_unpack_slab(
                block, torch.zeros(2, 2, 4)[:, :, ::2], (0, 0, 0), (2, 2, 2))),
            (ValueError, "block must be C-contiguous", lambda: pk.pallas_unpack_slab(
                block.transpose(0, 2), torch.zeros(2, 2, 2), (0, 0, 0), (2, 2, 2))),
            (TypeError, "slab must be a torch.Tensor", lambda: pk.pallas_unpack_slab(
                block, np.zeros((2, 2, 2), np.float32), (0, 0, 0), (2, 2, 2))),
            (TypeError, "block must be a torch.Tensor", lambda: pk.pallas_unpack_slab(
                np.zeros((6, 6, 6), np.float32), torch.zeros(2, 2, 2), (0, 0, 0), (2, 2, 2))),
        ]
    else:
        cases = [
            (ValueError, "does not fit", lambda: pk.pack_yshell_pallas(block, 5, 2)),
            (ValueError, "does not fit", lambda: pk.pack_yshell_pallas(block, 0, 0)),
            (TypeError, "1/2/4/8-byte", lambda: pk.pack_yshell_pallas(block.to(torch.complex128), 0, 1)),
            (ValueError, "block must be C-contiguous", lambda: pk.pack_yshell_pallas(block.transpose(0, 2), 0, 1)),
            (ValueError, "must have 3 or 4 dims", lambda: pk.pack_yshell_pallas(torch.zeros(6, 6), 0, 1)),
        ]
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
def test_wrappers_on_cpu_run_the_plain_versions_equal_pallas_interpret(dtype):
    rng = np.random.default_rng(11)
    block = (rng.random((3, 9, 10, 11)) * 100).astype(dtype)
    before = (pk.pallas_unpack_slab.launches, pk.pack_yshell_pallas.launches)
    got = pk.pack_yshell_pallas(torch.from_numpy(block), 4, 3).numpy()
    for b in range(3):  # the JAX kernel takes one block
        np.testing.assert_array_equal(got[b], np.asarray(jpk.pack_yshell_pallas(jnp.asarray(block[b]), 4, 3,
                                                                                 interpret=True)))
    one, slab = block[1], (rng.random((4, 7, 5)) * 100).astype(dtype)
    got = pk.pallas_unpack_slab(torch.from_numpy(one.copy()), torch.from_numpy(slab), Dim3(2, 1, 3), Dim3(4, 7, 5))
    want = jpk.pallas_unpack_slab(jnp.asarray(one), jnp.asarray(slab), JDim3(2, 1, 3), JDim3(4, 7, 5), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (pk.pallas_unpack_slab.launches, pk.pack_yshell_pallas.launches) == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
def test_pack_slab_and_unpack_yshell_on_cpu_equal_pallas_interpret(dtype):
    """The two wrappers this launch path took last: on CPU tensors their
    plain versions, bitwise equal to the JAX package's kernels."""
    rng = np.random.default_rng(12)
    block = (rng.random((3, 9, 10, 11)) * 100).astype(dtype)
    before = (pk.pallas_pack_slab.launches, pk.unpack_yshell_pallas.launches)
    for pos, ext in ((Dim3(2, 1, 3), Dim3(4, 7, 5)), (Dim3(0, 0, 8), Dim3(9, 10, 3)), (Dim3(6, 0, 0), Dim3(3, 10, 11))):
        got = pk.pallas_pack_slab(torch.from_numpy(block[0]), pos, ext)
        want = jpk.pallas_pack_slab(jnp.asarray(block[0]), JDim3(*pos), JDim3(*ext), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    buf = (rng.random((3, 3, 9, 11)) * 100).astype(dtype)
    got = pk.unpack_yshell_pallas(torch.from_numpy(block.copy()), torch.from_numpy(buf), 4, 3).numpy()
    for b in range(3):  # the JAX kernel takes one block
        want = jpk.unpack_yshell_pallas(jnp.asarray(block[b]), jnp.asarray(buf[b]), 4, 3, interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(want))
    assert (pk.pallas_pack_slab.launches, pk.unpack_yshell_pallas.launches) == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8, np.uint16])
def test_zshell_wrappers_on_cpu_equal_pallas_interpret(dtype):
    """The z pair on CPU tensors: their plain versions, bitwise equal to the
    JAX package's kernels (whose buffer pads X to 128 lanes), no launch."""
    rng = np.random.default_rng(15)
    block = (rng.random((3, 9, 10, 11)) * 100).astype(dtype)
    buf = (rng.random((3, 3, 10, 9)) * 100).astype(dtype)
    before = (pk.pack_zshell_pallas.launches, pk.unpack_zshell_pallas.launches)
    for z0, depth in ((4, 3), (0, 1), (10, 1), (0, 11)):
        got = pk.pack_zshell_pallas(torch.from_numpy(block), z0, depth).numpy()
        for b in range(3):  # the JAX kernel takes one block
            want = jpk.pack_zshell_pallas(jnp.asarray(block[b]), z0, depth, interpret=True)
            np.testing.assert_array_equal(got[b], np.asarray(want)[:, :, :9])
    got = pk.unpack_zshell_pallas(torch.from_numpy(block.copy()), torch.from_numpy(buf), 8, 3).numpy()
    for b in range(3):
        padded = np.zeros((3, 10, jpk.lane_pad(9)), dtype)
        padded[:, :, :9] = buf[b]
        want = jpk.unpack_zshell_pallas(jnp.asarray(block[b]), jnp.asarray(padded), 8, 3, interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(want))
    assert (pk.pack_zshell_pallas.launches, pk.unpack_zshell_pallas.launches) == before


# --- the launch path on the CPU: tensors that report a CUDA device -------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` as its device, so that a wrapper
    takes its launch path; its data stays in host memory."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _host_view(ptr: int, itemsize: int, shape) -> np.ndarray:
    """A writable numpy view of ``shape`` elements of ``itemsize`` bytes at ``ptr``."""
    raw = (ctypes.c_uint8 * (int(np.prod(shape)) * itemsize)).from_address(ptr)
    return np.frombuffer(raw, dtype=f"u{itemsize}").reshape(shape)


def _stand_in(fn: str, calls: list):
    """A Python stand-in for the C entry ``fn`` of ``csrc/pack.cu``: it reads
    the descriptor's fields at the address it is given, in the order the C
    entry reads them, and makes the same copy on host memory."""

    def slab(addr, block_ptr, slab_ptr, stream):
        isz, X, Y, Z, px, py, pz, ex, ey, ez = (ctypes.c_int64 * 10).from_address(addr)
        box = _host_view(block_ptr, isz, (X, Y, Z))[px:px + ex, py:py + ey, pz:pz + ez]
        flat = _host_view(slab_ptr, isz, (ex, ey, ez))
        if fn.startswith("stp_pack"):
            flat[...] = box
        else:
            box[...] = flat
        calls.append((fn, addr, stream))
        return 0

    def zshell(addr, block_ptr, buf_ptr, stream):
        isz, n, X, Y, Z, z0, depth = (ctypes.c_int64 * 7).from_address(addr)
        window = _host_view(block_ptr, isz, (n, X, Y, Z))[:, :, :, z0:z0 + depth].transpose(0, 3, 2, 1)
        buf = _host_view(buf_ptr, isz, (n, depth, Y, X))
        if fn.startswith("stp_pack"):
            buf[...] = window
        else:
            window[...] = buf
        calls.append((fn, addr, stream))
        return 0

    def yshell(addr, block_ptr, buf_ptr, stream):
        isz, n, X, Y, Z, y0, depth = (ctypes.c_int64 * 7).from_address(addr)
        window = _host_view(block_ptr, isz, (n, X, Y, Z))[:, :, y0:y0 + depth, :].transpose(0, 2, 1, 3)
        buf = _host_view(buf_ptr, isz, (n, depth, X, Z))
        if fn.startswith("stp_pack"):
            buf[...] = window
        else:
            window[...] = buf
        calls.append((fn, addr, stream))
        return 0

    return slab if "slab" in fn else zshell if "zshell" in fn else yshell


@pytest.fixture
def on_card(monkeypatch):
    """Route the six descriptor wrappers through their launch path on host
    memory: ``_OnCard`` tensors, ``torch.empty`` making them, a fixed raw
    stream, and the C entries' stand-ins.  Yields ``(to_card, calls)``."""
    calls = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: empty(*a, **kw).as_subclass(_OnCard))
    monkeypatch.setattr(pk, "current_raw_stream", lambda index: 7000 + index)
    monkeypatch.setattr(pk, "_entry", lambda fn: (_stand_in(fn, calls), None))
    yield (lambda t: t.clone().as_subclass(_OnCard)), calls


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(torch.Tensor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.uint8])
def test_slab_pack_and_unpack_share_one_cached_launch(on_card, dtype):
    to_card, calls = on_card
    block = (torch.from_numpy(np.random.default_rng(13).random((9, 10, 11))) * 100).to(dtype)
    before = (pk.pallas_pack_slab.launches, pk.pallas_unpack_slab.launches)
    for pos, ext in ((Dim3(2, 1, 3), Dim3(4, 7, 5)), (Dim3(0, 0, 8), Dim3(9, 10, 3))):
        slab = pk.pallas_pack_slab(to_card(block), pos, ext)
        assert isinstance(slab, _OnCard) and torch.equal(_host(slab), pk.pallas_pack_slab_plain(block, pos, ext))
        new = (slab.flip(0) + 1).as_subclass(_OnCard)
        got = pk.pallas_unpack_slab(to_card(block), new, pos, ext)
        assert torch.equal(_host(got), pk.pallas_unpack_slab_plain(block.clone(), _host(new), pos, ext))
        (pack_fn, pack_addr, stream), (unpack_fn, unpack_addr, _) = calls[-2:]
        assert (pack_fn, unpack_fn, stream) == ("stp_pack_slab_desc", "stp_unpack_slab_desc", 7000)
        assert pack_addr == unpack_addr == pk._slab_launch(block, pos, ext)[1]
    assert (pk.pallas_pack_slab.launches, pk.pallas_unpack_slab.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("shape", [(9, 10, 11), (3, 9, 10, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.uint8])
def test_yshell_pack_and_unpack_share_one_cached_launch(on_card, dtype, shape):
    to_card, calls = on_card
    block = (torch.from_numpy(np.random.default_rng(14).random(shape)) * 100).to(dtype)
    before = (pk.pack_yshell_pallas.launches, pk.unpack_yshell_pallas.launches)
    for y0, depth in ((4, 3), (0, 1), (0, 10)):
        buf = pk.pack_yshell_pallas(to_card(block), y0, depth)
        assert isinstance(buf, _OnCard) and torch.equal(_host(buf), pk.pack_yshell_pallas_plain(block, y0, depth))
        new = (buf.flip(-1) + 1).as_subclass(_OnCard)
        got = pk.unpack_yshell_pallas(to_card(block), new, y0, depth)
        assert torch.equal(_host(got), pk.unpack_yshell_pallas_plain(block.clone(), _host(new), y0, depth))
        (pack_fn, pack_addr, _), (unpack_fn, unpack_addr, _) = calls[-2:]
        assert (pack_fn, unpack_fn) == ("stp_pack_yshell_desc", "stp_unpack_yshell_desc")
        assert pack_addr == unpack_addr == pk._yshell_launch(block, y0, depth)[1]
    assert (pk.pack_yshell_pallas.launches, pk.unpack_yshell_pallas.launches) == (before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("shape", [(9, 10, 11), (3, 9, 10, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.uint8, torch.int16])
def test_zshell_pack_and_unpack_share_one_cached_launch(on_card, dtype, shape):
    to_card, calls = on_card
    block = (torch.from_numpy(np.random.default_rng(16).random(shape)) * 100).to(dtype)
    before = (pk.pack_zshell_pallas.launches, pk.unpack_zshell_pallas.launches)
    for z0, depth in ((4, 3), (0, 1), (10, 1), (0, 11)):
        buf = pk.pack_zshell_pallas(to_card(block), z0, depth)
        assert isinstance(buf, _OnCard) and torch.equal(_host(buf), pk.pack_zshell_pallas_plain(block, z0, depth))
        new = (buf.flip(-1) + 1).as_subclass(_OnCard)
        got = pk.unpack_zshell_pallas(to_card(block), new, z0, depth)
        assert torch.equal(_host(got), pk.unpack_zshell_pallas_plain(block.clone(), _host(new), z0, depth))
        (pack_fn, pack_addr, stream), (unpack_fn, unpack_addr, _) = calls[-2:]
        assert (pack_fn, unpack_fn, stream) == ("stp_pack_zshell_desc", "stp_unpack_zshell_desc", 7000)
        assert pack_addr == unpack_addr == pk._zshell_launch(block, z0, depth)[1]
    assert (pk.pack_zshell_pallas.launches, pk.unpack_zshell_pallas.launches) == (before[0] + 4, before[1] + 4)


@pytest.mark.parametrize("fn", ["pack_slab", "unpack_yshell", "pack_zshell", "unpack_zshell"])
def test_every_refusal_raises_on_the_launch_path(on_card, fn):
    """The refusals of the CPU branch, on tensors that take the launch
    path: the same messages, cached geometry or not, and no launch."""
    to_card, calls = on_card

    def z(*shape, dtype=torch.float32):
        return to_card(torch.zeros(*shape, dtype=dtype))

    block = z(6, 6, 6)
    pk.pallas_pack_slab(block, (0, 0, 0), (2, 2, 2))  # cache geometries the cases reuse
    pk.unpack_yshell_pallas(block, z(1, 6, 6), 0, 1)
    pk.unpack_zshell_pallas(block, z(1, 6, 6), 0, 1)
    launched = len(calls)
    cases = _refusals(fn, block, z)
    if fn.startswith("unpack_"):
        unpack = getattr(pk, f"{fn}_pallas")
        cases.append((ValueError, "different devices", lambda: unpack(block, torch.zeros(1, 6, 6), 0, 1)))
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()
    assert len(calls) == launched


# --- blend_slab_dynamic: the same C source, a descriptor without the offsets ----------


@pytest.mark.parametrize("shape,n", [((17, 19, 23), 1), ((3, 17, 19, 23), 3)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_blend_dynamic_descriptor_holds_the_fields_the_c_entry_reads(shape, n, axis):
    block = torch.zeros(shape, dtype=torch.int16)
    desc, addr, slab_shape = hb._blend_dynamic_launch(block, axis, 3)
    want = dict(itemsize=2, n=n, X=17, Y=19, Z=23, axis=axis, r=3)
    assert _fields((desc,)) == [want[f] for f in hb.BLEND_DYN_DESC_FIELDS]
    assert addr == ctypes.addressof(desc) and len(desc) == len(hb.BLEND_DYN_DESC_FIELDS)
    want_shape = list(shape)
    want_shape[len(shape) - 3 + axis] = 3
    assert tuple(slab_shape) == tuple(want_shape)


def test_blend_dynamic_launch_cache_hits_one_geometry_and_misses_others():
    block = torch.zeros(3, 9, 10, 11)
    first = hb._blend_dynamic_launch(block, 1, 2)
    # the same geometry, in another block of the same shape and dtype
    assert hb._blend_dynamic_launch(torch.ones(3, 9, 10, 11), 1, 2) is first
    others = [
        hb._blend_dynamic_launch(torch.zeros(2, 9, 10, 11), 1, 2),  # shape (n)
        hb._blend_dynamic_launch(torch.zeros(9, 10, 11), 1, 2),  # one block
        hb._blend_dynamic_launch(block.to(torch.uint8), 1, 2),  # dtype
        hb._blend_dynamic_launch(block, 0, 2),  # axis
        hb._blend_dynamic_launch(block, 1, 3),  # width
    ]
    for other in others:
        assert other is not first and _fields(other) != _fields(first)
    # the static write's cache is its own: its descriptor carries a position
    assert hb._blend_launch(block, 1, 2, 0) is not first and len(hb._blend_launch(block, 1, 2, 0)[0]) == 8
    for _ in range(2):
        assert hb._blend_dynamic_launch(block, 1, 2) is first
    with pytest.raises(ValueError, match="leaves axis"):
        hb._blend_dynamic_launch(block, 2, 12)


def _dynamic_stand_in(calls: list):
    """A Python stand-in for ``stp_blend_slab_dynamic_desc``: it reads the
    descriptor's fields and the n offsets at the addresses it is given, in
    the C entry's order, clamps each offset into [0, ext - r] and makes the
    write on host memory."""

    def entry(addr, block_ptr, slab_ptr, pos_ptr, stream):
        isz, n, X, Y, Z, axis, r = (ctypes.c_int64 * len(hb.BLEND_DYN_DESC_FIELDS)).from_address(addr)
        pos = list((ctypes.c_int32 * n).from_address(pos_ptr))
        blocks = _host_view(block_ptr, isz, (n, X, Y, Z))
        shape = [n, X, Y, Z]
        shape[1 + axis] = r
        slabs = _host_view(slab_ptr, isz, shape)
        for b, p in enumerate(pos):
            p = min(max(p, 0), (X, Y, Z)[axis] - r)
            index = [b, slice(None), slice(None), slice(None)]
            index[1 + axis] = slice(p, p + r)
            blocks[tuple(index)] = slabs[b]
        calls.append((addr, pos, stream))
        return 0

    return entry


@pytest.fixture
def on_card_dynamic(monkeypatch):
    """Route ``blend_slab_dynamic`` through its launch path on host memory:
    a fixed raw stream and the C entry's stand-in.  Yields ``(to_card,
    calls)``."""
    calls = []
    monkeypatch.setattr(hb, "current_raw_stream", lambda index: 7000 + index)
    monkeypatch.setattr(hb, "_entry", lambda fn: (_dynamic_stand_in(calls), None) if fn ==
                        "stp_blend_slab_dynamic_desc" else pytest.fail(f"blend_slab_dynamic asked for {fn}"))
    yield (lambda t: t.clone().as_subclass(_OnCard)), calls


@pytest.mark.parametrize("shape", [(9, 10, 11), (3, 9, 10, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.uint8, torch.int16])
def test_blend_dynamic_launch_path_writes_through_the_cached_launch(on_card_dynamic, dtype, shape):
    """Distinct offsets, one below 0 and one past ext - r (both clamped on
    the device), on every axis: equal to the plain version, one launch a
    call, the descriptor cached per geometry whatever the offsets."""
    to_card, calls = on_card_dynamic
    rng = np.random.default_rng(31)
    blocks = (torch.from_numpy(rng.random(shape)) * 100).to(dtype)
    n = shape[0] if len(shape) == 4 else 1
    lead = len(shape) - 3
    before = hb.blend_slab_dynamic.launches
    for axis in (0, 1, 2):
        ext = shape[lead + axis]
        sshape = list(shape)
        sshape[lead + axis] = 2
        slab = (torch.from_numpy(rng.random(sshape)) * 100 + 1).to(dtype)
        for pos in ([ext - 2, 1, 4][:n], [-3, ext + 5, 0][:n], [ext - 1] * n):
            p = torch.tensor(pos, dtype=torch.int32)
            card = to_card(blocks)
            got = hb.blend_slab_dynamic(card, to_card(slab), axis, to_card(p))
            assert got is card
            assert torch.equal(got.as_subclass(torch.Tensor), hb.blend_slab_dynamic_plain(blocks.clone(), slab, axis, p))
            addr, seen, stream = calls[-1]
            assert (addr, seen, stream) == (hb._blend_dynamic_launch(blocks, axis, 2)[1], pos, 7000)
    assert hb.blend_slab_dynamic.launches == before + 9 and len(calls) == 9


def test_blend_dynamic_refuses_a_bad_pos_on_every_call_and_never_caches_it(on_card_dynamic):
    """Offsets of the wrong dtype, length, rank, layout or device raise with
    the plain branch's messages on every call, launch nothing and leave the
    geometry cache as it was; a good call afterwards launches."""
    to_card, calls = on_card_dynamic
    block, slab = to_card(torch.zeros(2, 6, 6, 6)), to_card(torch.ones(2, 6, 6, 2))
    good = to_card(torch.tensor([4, 1], dtype=torch.int32))
    hb.blend_slab_dynamic(block, slab, 2, good)  # the geometry is cached
    cache, launched, before = dict(hb._BLEND_DYN_LAUNCHES), len(calls), hb.blend_slab_dynamic.launches
    bad = [
        (TypeError, "pos must be torch.int32", to_card(torch.tensor([4, 1], dtype=torch.int64))),
        (ValueError, "pos holds 3 offsets for 2 block", to_card(torch.tensor([4, 1, 0], dtype=torch.int32))),
        (ValueError, "pos holds 1 offsets for 2 block", to_card(torch.tensor([4], dtype=torch.int32))),
        (ValueError, "pos must have 1 dims", to_card(torch.tensor([[4, 1]], dtype=torch.int32))),
        (ValueError, "pos must be C-contiguous", to_card(torch.tensor([4, 0, 1, 0], dtype=torch.int32))[::2]),
        (ValueError, "different devices", torch.tensor([4, 1], dtype=torch.int32)),
        (TypeError, "pos must be a torch.Tensor", [4, 1]),
    ]
    for exc, match, pos in bad:
        for _ in range(2):  # refused on every call, not only before the geometry is cached
            with pytest.raises(exc, match=match):
                hb.blend_slab_dynamic(block, slab, 2, pos)
    # a new geometry with a bad pos is refused before it is cached
    with pytest.raises(TypeError, match="int32"):
        hb.blend_slab_dynamic(block, to_card(torch.ones(2, 6, 1, 6)), 1, bad[0][2])
    assert hb._BLEND_DYN_LAUNCHES == cache and all(len(k) == 4 for k in cache)
    assert len(calls) == launched and hb.blend_slab_dynamic.launches == before
    hb.blend_slab_dynamic(block, slab, 2, good)
    assert len(calls) == launched + 1 and hb.blend_slab_dynamic.launches == before + 1


def test_blend_dynamic_every_refusal_raises_on_cpu_and_on_the_launch_path(on_card_dynamic):
    """The slab's and the block's refusals: the same messages on the plain
    branch and on the launch path, cached geometry or not, and no launch."""
    to_card, calls = on_card_dynamic
    for z in (torch.zeros, lambda *shape, dtype=torch.float32: to_card(torch.zeros(*shape, dtype=dtype))):
        block = z(2, 6, 6, 6)
        pos = z(2, dtype=torch.int32)
        launched, before = len(calls), hb.blend_slab_dynamic.launches
        cases = [
            (ValueError, "does not fit", lambda: hb.blend_slab_dynamic(block, z(2, 6, 5, 1), 2, pos)),
            (ValueError, "does not fit", lambda: hb.blend_slab_dynamic(block, z(1, 1, 6, 6), 0, pos)),
            (ValueError, "leaves axis", lambda: hb.blend_slab_dynamic(block, z(2, 7, 6, 6), 0, pos)),
            (ValueError, "axis must be", lambda: hb.blend_slab_dynamic(block, z(2, 6, 6, 1), 3, pos)),
            (TypeError, "slab dtype", lambda: hb.blend_slab_dynamic(block, z(2, 1, 6, 6, dtype=torch.float64), 0,
                                                                    pos)),
            (ValueError, "slab must be C-contiguous", lambda: hb.blend_slab_dynamic(
                block, z(2, 6, 1, 6).transpose(1, 3), 2, pos)),
            (ValueError, "block must be C-contiguous", lambda: hb.blend_slab_dynamic(
                block.transpose(1, 3), z(2, 1, 6, 6), 0, pos)),
            (ValueError, "slab must have 4 dims", lambda: hb.blend_slab_dynamic(block, z(1, 6, 6), 0, pos)),
            (TypeError, "slab must be a torch.Tensor", lambda: hb.blend_slab_dynamic(
                block, np.zeros((2, 1, 6, 6), np.float32), 0, pos)),
            (TypeError, "block must be a torch.Tensor", lambda: hb.blend_slab_dynamic(
                np.zeros((2, 6, 6, 6), np.float32), z(2, 1, 6, 6), 0, pos)),
        ]
        for exc, match, call in cases:
            with pytest.raises(exc, match=match):
                call()
        assert len(calls) == launched and hb.blend_slab_dynamic.launches == before
