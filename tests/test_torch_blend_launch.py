"""The descriptor launch path of ``blend_slab`` (``stencil_tpu_torch/ops/halo_blend.py``),
on the CPU.

* the descriptor holds the int64 fields the C entry ``stp_blend_slab_desc``
  of ``csrc/pack.cu`` reads, in its order;
* one geometry hits its cached launch, and another block shape, dtype, axis,
  slab width or position misses it;
* a slab that leaves the block raises before anything is cached;
* every refusal of the wrapper raises with its message, on the launch path's
  own checks as on the plain branch;
* on CPU tensors the wrapper runs the plain version, bitwise equal to the JAX
  package's Pallas kernel in interpret mode on every axis, and counts no
  launch.

The launch path itself runs here on tensors that report a CUDA device, with
a Python stand-in for the C entry that reads the descriptor at the address
it is given, as the C entry does.  The kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.ops import halo_blend as jhb
from stencil_tpu_torch.ops import halo_blend as hb

torch.set_num_threads(1)


def _fields(launch):
    return list(launch[0])


@pytest.mark.parametrize("shape,n", [((17, 19, 23), 1), ((3, 17, 19, 23), 3)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_descriptor_holds_the_fields_the_c_entry_reads(shape, n, axis):
    block = torch.zeros(shape, dtype=torch.float64)
    desc, addr, slab_shape = hb._blend_launch(block, axis, 3, 5)
    want = dict(itemsize=8, n=n, X=17, Y=19, Z=23, axis=axis, r=3, pos=5)
    assert _fields((desc,)) == [want[f] for f in hb.BLEND_DESC_FIELDS]
    assert addr == ctypes.addressof(desc)
    want_shape = list(shape)
    want_shape[len(shape) - 3 + axis] = 3
    assert tuple(slab_shape) == tuple(want_shape)


def test_launch_cache_hits_one_geometry_and_misses_others():
    block = torch.zeros(3, 9, 10, 11)
    first = hb._blend_launch(block, 1, 2, 4)
    # the same geometry, in another block of the same shape and dtype
    assert hb._blend_launch(torch.ones(3, 9, 10, 11), 1, 2, 4) is first
    others = [
        hb._blend_launch(torch.zeros(2, 9, 10, 11), 1, 2, 4),  # shape (n)
        hb._blend_launch(torch.zeros(9, 10, 11), 1, 2, 4),  # one block
        hb._blend_launch(block.to(torch.bfloat16), 1, 2, 4),  # dtype
        hb._blend_launch(block, 2, 2, 4),  # axis
        hb._blend_launch(block, 1, 3, 4),  # width
        hb._blend_launch(block, 1, 2, 5),  # position
    ]
    for other in others:
        assert other is not first and _fields(other) != _fields(first)
    assert _fields(others[2])[0] == 2 and tuple(others[4][2]) == (3, 9, 3, 11)
    # two geometries called in turn each keep their own launch
    for _ in range(2):
        assert hb._blend_launch(block, 1, 2, 4) is first
        assert _fields(hb._blend_launch(block, 2, 2, 4))[5] == 2


def test_a_slab_that_leaves_the_block_is_refused_before_caching():
    block = torch.zeros(2, 6, 6, 6)
    before = dict(hb._BLEND_LAUNCHES)
    for axis, r, pos in ((0, 3, 4), (1, 1, 6), (2, 2, -1), (2, 7, 0)):
        with pytest.raises(ValueError, match="leaves axis"):
            hb._blend_launch(block, axis, r, pos)
    with pytest.raises(ValueError, match="axis must be"):
        hb._blend_launch(block, 3, 1, 0)
    with pytest.raises(TypeError, match="1/2/4/8-byte"):
        hb._blend_launch(block.to(torch.complex128), 0, 1, 0)
    with pytest.raises(ValueError, match="must have 3 or 4 dims"):
        hb._blend_launch(torch.zeros(6, 6), 0, 1, 0)
    assert hb._BLEND_LAUNCHES == before


def test_the_cache_starts_afresh_when_full(monkeypatch):
    from stencil_tpu_torch.ops import pack as pk

    monkeypatch.setattr(pk, "_MAX_LAUNCHES", 2)
    monkeypatch.setattr(hb, "_BLEND_LAUNCHES", {})
    block = torch.zeros(6, 6, 6)
    for pos in range(3):
        hb._blend_launch(block, 2, 1, pos)
    assert len(hb._BLEND_LAUNCHES) == 1


def _refusals(block, z):
    """``(exception, message, call)`` for every refusal of ``blend_slab`` on
    ``block`` (2, 6, 6, 6), with ``z(*shape, dtype=)`` making its slabs on
    the block's device."""
    return [
        (ValueError, "leaves axis", lambda: hb.blend_slab(block, z(2, 3, 6, 6), 0, 4)),
        (ValueError, "leaves axis", lambda: hb.blend_slab(block, z(2, 6, 6, 2), 2, -1)),
        (ValueError, "axis must be", lambda: hb.blend_slab(block, z(2, 6, 6, 1), 3, 0)),
        (ValueError, "does not fit", lambda: hb.blend_slab(block, z(2, 6, 5, 1), 2, 0)),
        (ValueError, "does not fit", lambda: hb.blend_slab(block, z(1, 1, 6, 6), 0, 0)),
        (TypeError, "slab dtype", lambda: hb.blend_slab(block, z(2, 1, 6, 6, dtype=torch.float64), 0, 0)),
        (ValueError, "slab must be C-contiguous", lambda: hb.blend_slab(block, z(2, 6, 1, 6).transpose(1, 3), 2, 0)),
        (ValueError, "block must be C-contiguous", lambda: hb.blend_slab(block.transpose(1, 3), z(2, 1, 6, 6), 0, 0)),
        (ValueError, "slab must have 4 dims", lambda: hb.blend_slab(block, z(1, 6, 6), 0, 0)),
        (TypeError, "slab must be a torch.Tensor", lambda: hb.blend_slab(block, np.zeros((2, 1, 6, 6), np.float32),
                                                                         0, 0)),
        (TypeError, "block must be a torch.Tensor", lambda: hb.blend_slab(np.zeros((2, 6, 6, 6), np.float32),
                                                                          z(2, 1, 6, 6), 0, 0)),
        (ValueError, "must have 3 or 4 dims", lambda: hb.blend_slab(z(6, 6), z(1, 6), 0, 0)),
    ]


def test_every_refusal_still_raises():
    before = hb.blend_slab.launches
    for exc, match, call in _refusals(torch.zeros(2, 6, 6, 6), torch.zeros):
        with pytest.raises(exc, match=match):
            call()
    assert hb.blend_slab.launches == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_wrapper_on_cpu_runs_the_plain_version_equal_pallas_interpret(dtype, axis):
    rng = np.random.default_rng(21 + axis)
    blocks = (rng.random((3, 9, 10, 11)) * 100).astype(dtype)
    before = hb.blend_slab.launches
    ext = blocks.shape[1 + axis]
    for r, pos in ((1, 0), (3, 2), (2, ext - 2)):
        shape = list(blocks.shape)
        shape[1 + axis] = r
        slab = (rng.random(shape) * 100).astype(dtype)
        got = hb.blend_slab(torch.from_numpy(blocks.copy()), torch.from_numpy(slab), axis, pos).numpy()
        for b in range(3):  # the JAX kernel takes one block
            want = jhb.blend_slab(jnp.asarray(blocks[b]), jnp.asarray(slab[b]), axis, pos, interpret=True)
            np.testing.assert_array_equal(got[b], np.asarray(want))
    assert hb.blend_slab.launches == before


# --- the launch path on the CPU: tensors that report a CUDA device -------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` as its device, so that the
    wrapper takes its launch path; its data stays in host memory."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _host_view(ptr: int, itemsize: int, shape) -> np.ndarray:
    """A writable numpy view of ``shape`` elements of ``itemsize`` bytes at ``ptr``."""
    raw = (ctypes.c_uint8 * (int(np.prod(shape)) * itemsize)).from_address(ptr)
    return np.frombuffer(raw, dtype=f"u{itemsize}").reshape(shape)


@pytest.fixture
def on_card(monkeypatch):
    """Route ``blend_slab`` through its launch path on host memory: a fixed
    raw stream and a stand-in for the C entry that reads the descriptor's
    fields at the address it is given, in the C entry's order, and makes the
    write.  Yields ``(to_card, calls)``."""
    calls = []

    def entry(addr, block_ptr, slab_ptr, stream):
        isz, n, X, Y, Z, axis, r, pos = (ctypes.c_int64 * len(hb.BLEND_DESC_FIELDS)).from_address(addr)
        blocks = _host_view(block_ptr, isz, (n, X, Y, Z))
        shape = [n, X, Y, Z]
        shape[1 + axis] = r
        index = [slice(None)] * 4
        index[1 + axis] = slice(pos, pos + r)
        blocks[tuple(index)] = _host_view(slab_ptr, isz, shape)
        calls.append((addr, stream))
        return 0

    monkeypatch.setattr(hb, "current_raw_stream", lambda index: 7000 + index)
    monkeypatch.setattr(hb, "_entry", lambda: (entry, None))
    yield (lambda t: t.clone().as_subclass(_OnCard)), calls


@pytest.mark.parametrize("shape", [(9, 10, 11), (3, 9, 10, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.uint8])
def test_launch_path_writes_each_axis_through_the_cached_launch(on_card, dtype, shape):
    to_card, calls = on_card
    blocks = (torch.from_numpy(np.random.default_rng(23).random(shape)) * 100).to(dtype)
    before = hb.blend_slab.launches
    lead = len(shape) - 3
    for axis in (0, 1, 2):
        ext = shape[lead + axis]
        for r, pos in ((1, 0), (3, ext - 3)):
            sshape = list(shape)
            sshape[lead + axis] = r
            slab = (torch.from_numpy(np.random.default_rng(axis * 7 + r).random(sshape)) * 100).to(dtype)
            card = to_card(blocks)
            got = hb.blend_slab(card, to_card(slab), axis, pos)
            assert got is card
            assert torch.equal(got.as_subclass(torch.Tensor), hb.blend_slab_plain(blocks.clone(), slab, axis, pos))
            addr, stream = calls[-1]
            assert addr == hb._blend_launch(blocks, axis, r, pos)[1] and stream == 7000
    assert hb.blend_slab.launches == before + 6 and len(calls) == 6


def test_every_refusal_raises_on_the_launch_path(on_card):
    """The refusals of the CPU branch, on tensors that take the launch path:
    the same messages, cached geometry or not, and no launch."""
    to_card, calls = on_card

    def z(*shape, dtype=torch.float32):
        return to_card(torch.zeros(*shape, dtype=dtype))

    block = z(2, 6, 6, 6)
    hb.blend_slab(block, z(2, 1, 6, 6), 0, 0)  # cache geometries the cases reuse
    hb.blend_slab(block, z(2, 6, 6, 1), 2, 0)
    launched, before = len(calls), hb.blend_slab.launches
    cases = _refusals(block, z) + [
        (ValueError, "different devices", lambda: hb.blend_slab(block, torch.zeros(2, 1, 6, 6), 0, 0)),
        # the plain version writes any dtype; the kernel moves 1/2/4/8-byte words
        (TypeError, "1/2/4/8-byte", lambda: hb.blend_slab(block.to(torch.complex128),
                                                          z(2, 1, 6, 6, dtype=torch.complex128), 0, 0)),
    ]
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()
    assert len(calls) == launched and hb.blend_slab.launches == before
