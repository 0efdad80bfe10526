"""The descriptor launch path of ``pallas_unpack_slab`` and
``pack_yshell_pallas`` (``stencil_tpu_torch/ops/pack.py``), on the CPU.

* the descriptor holds the int64 fields the C entries of ``csrc/pack.cu``
  read, in their order;
* one geometry hits its cached launch, and another block shape, dtype, box or
  window misses it;
* a box or window that leaves the block raises before anything is cached;
* every refusal of the two wrappers raises with its message, on the launch
  path's own checks as on the plain branch;
* the wrappers on CPU tensors still run the plain versions, bitwise equal to
  the JAX package's Pallas kernels in interpret mode, and count no launch.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.ops import pack as jpk
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.ops import pack as pk

torch.set_num_threads(1)


def _fields(launch):
    return list(launch[0])


def test_slab_descriptor_holds_the_fields_the_c_entry_reads():
    block = torch.zeros(17, 19, 23, dtype=torch.float64)
    desc, addr, shape = pk._unpack_slab_launch(block, Dim3(1, 2, 20), Dim3(15, 17, 3))
    want = dict(itemsize=8, X=17, Y=19, Z=23, px=1, py=2, pz=20, ex=15, ey=17, ez=3)
    assert _fields((desc,)) == [want[f] for f in pk.SLAB_DESC_FIELDS]
    assert addr == ctypes.addressof(desc)
    assert shape == (15, 17, 3)


@pytest.mark.parametrize("shape,n", [((17, 19, 23), 1), ((3, 17, 19, 23), 3)])
def test_yshell_descriptor_holds_the_fields_the_c_entry_reads(shape, n):
    block = torch.zeros(shape, dtype=torch.bfloat16)
    desc, _, buf_shape = pk._pack_yshell_launch(block, 5, 3)
    want = dict(itemsize=2, n=n, X=17, Y=19, Z=23, y0=5, depth=3)
    assert _fields((desc,)) == [want[f] for f in pk.YSHELL_DESC_FIELDS]
    assert buf_shape == pk.yshell_buffer_shape(shape, 3)


def test_slab_launch_cache_hits_one_geometry_and_misses_others():
    block = torch.zeros(9, 10, 11)
    first = pk._unpack_slab_launch(block, Dim3(2, 1, 3), Dim3(4, 7, 5))
    # the same geometry, in another block of the same shape and dtype
    assert pk._unpack_slab_launch(torch.ones(9, 10, 11), Dim3(2, 1, 3), Dim3(4, 7, 5)) is first
    others = [
        pk._unpack_slab_launch(torch.zeros(9, 10, 12), Dim3(2, 1, 3), Dim3(4, 7, 5)),  # shape
        pk._unpack_slab_launch(block.double(), Dim3(2, 1, 3), Dim3(4, 7, 5)),  # dtype
        pk._unpack_slab_launch(block, Dim3(2, 1, 4), Dim3(4, 7, 5)),  # corner
        pk._unpack_slab_launch(block, Dim3(2, 1, 3), Dim3(4, 7, 4)),  # extent
    ]
    for other in others:
        assert other is not first and _fields(other) != _fields(first)
    assert _fields(others[0])[3] == 12 and _fields(others[1])[0] == 8
    # two shapes called in turn each keep their own launch
    for _ in range(2):
        assert pk._unpack_slab_launch(block, Dim3(2, 1, 3), Dim3(4, 7, 5)) is first
        assert _fields(pk._unpack_slab_launch(torch.zeros(9, 10, 12), Dim3(2, 1, 3), Dim3(4, 7, 5)))[3] == 12


def test_yshell_launch_cache_hits_one_geometry_and_misses_others():
    block = torch.zeros(3, 5, 7, 9)
    first = pk._pack_yshell_launch(block, 2, 3)
    assert pk._pack_yshell_launch(torch.ones(3, 5, 7, 9), 2, 3) is first
    others = [
        pk._pack_yshell_launch(torch.zeros(2, 5, 7, 9), 2, 3),  # n
        pk._pack_yshell_launch(torch.zeros(5, 7, 9), 2, 3),  # one block
        pk._pack_yshell_launch(block.to(torch.uint8), 2, 3),  # dtype
        pk._pack_yshell_launch(block, 1, 3),  # window start
        pk._pack_yshell_launch(block, 2, 2),  # depth
    ]
    for other in others:
        assert other is not first and _fields(other) != _fields(first)
    assert others[0][2] == (2, 3, 5, 9) and others[4][2] == (3, 2, 5, 9)


def test_a_box_or_window_that_leaves_the_block_is_refused_before_caching():
    block = torch.zeros(6, 6, 6)
    before = (dict(pk._SLAB_LAUNCHES), dict(pk._YSHELL_LAUNCHES))
    with pytest.raises(ValueError, match="leaves block"):
        pk._unpack_slab_launch(block, Dim3(4, 0, 0), Dim3(3, 1, 1))
    with pytest.raises(ValueError, match="leaves block"):
        pk._unpack_slab_launch(block, Dim3(0, -1, 0), Dim3(1, 1, 1))
    with pytest.raises(ValueError, match="does not fit"):
        pk._pack_yshell_launch(block, 5, 2)
    with pytest.raises(TypeError, match="1/2/4/8-byte"):
        pk._pack_yshell_launch(block.to(torch.complex128), 0, 1)
    assert (pk._SLAB_LAUNCHES, pk._YSHELL_LAUNCHES) == before


def test_a_list_box_is_checked_every_call_and_never_cached():
    block = torch.zeros(6, 6, 6)
    size = len(pk._SLAB_LAUNCHES)
    launch = pk._unpack_slab_launch(block, [1, 1, 1], [2, 2, 2])
    assert _fields(launch)[4:] == [1, 1, 1, 2, 2, 2] and len(pk._SLAB_LAUNCHES) == size


def test_the_caches_start_afresh_when_full(monkeypatch):
    monkeypatch.setattr(pk, "_MAX_LAUNCHES", 2)
    monkeypatch.setattr(pk, "_SLAB_LAUNCHES", {})
    block = torch.zeros(6, 6, 6)
    for z in range(3):
        pk._unpack_slab_launch(block, Dim3(0, 0, z), Dim3(1, 1, 1))
    assert len(pk._SLAB_LAUNCHES) == 1


@pytest.mark.parametrize("fn", ["unpack", "pack_yshell"])
def test_every_refusal_still_raises(fn):
    block = torch.zeros(6, 6, 6)
    if fn == "unpack":
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
