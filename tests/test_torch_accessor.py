"""The port's global-coordinate ``Accessor`` (the cases of
``tests/test_accessor.py``, reference test_cuda_accessor.cu), over numpy
arrays and torch tensors, and against the JAX package's ``Accessor``."""

import numpy as np
import pytest
import torch

from stencil_tpu.core.accessor import Accessor as JAccessor
from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.dim3 import Rect3 as JRect3
from stencil_tpu_torch.core import Accessor
from stencil_tpu_torch.core.dim3 import Dim3, Rect3

torch.set_num_threads(1)

BACKENDS = ["numpy", "torch"]


def _make(backend):
    # interior 4x5x6 at global origin (10, 20, 30), shell width 2
    raw = np.arange(8 * 9 * 10, dtype=np.float32).reshape(8, 9, 10)
    data = raw if backend == "numpy" else torch.from_numpy(raw)
    return Accessor(data, origin=Dim3(10, 20, 30), lo_off=Dim3(2, 2, 2)), raw


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("backend", BACKENDS)
def test_scalar_read_origin_offset(backend):
    acc, raw = _make(backend)
    # the interior origin lives at raw index (2, 2, 2) (accessor.hpp:27-40)
    assert acc[Dim3(10, 20, 30)] == raw[2, 2, 2]
    assert acc[(11, 22, 33)] == raw[3, 4, 5]
    # halo cells are addressable below the origin
    assert acc[(9, 19, 29)] == raw[1, 1, 1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_region_slice(backend):
    acc, raw = _make(backend)
    r = Rect3(Dim3(10, 20, 30), Dim3(12, 23, 34))
    np.testing.assert_array_equal(_np(acc.region(r)), raw[2:4, 2:5, 2:6])


@pytest.mark.parametrize("backend", BACKENDS)
def test_shifted_is_stencil_term(backend):
    acc, raw = _make(backend)
    region = Rect3(Dim3(10, 20, 30), Dim3(14, 25, 36))  # the whole interior
    center = _np(acc.shifted(region, (0, 0, 0)))
    plus_x = _np(acc.shifted(region, (1, 0, 0)))
    np.testing.assert_array_equal(plus_x[:-1], center[1:])
    minus_z = _np(acc.shifted(region, (0, 0, -1)))
    np.testing.assert_array_equal(minus_z[:, :, 1:], center[:, :, :-1])


def test_equals_jax_accessor_and_takes_components():
    """Every read equals the JAX ``Accessor``'s on the same block, and a
    ``(3, X, Y, Z)`` block reads all three components at once."""
    raw = np.random.default_rng(0).random((3, 8, 9, 10)).astype(np.float32)
    acc = Accessor(torch.from_numpy(raw), Dim3(10, 20, 30), Dim3(2, 1, 3))
    jacc = JAccessor(raw[1], JDim3(10, 20, 30), JDim3(2, 1, 3))
    region, jregion = Rect3(Dim3(9, 20, 28), Dim3(14, 26, 33)), JRect3(JDim3(9, 20, 28), JDim3(14, 26, 33))
    for d in ((0, 0, 0), (1, -1, 2), (-1, 2, -1)):
        got = acc.shifted(region, d).numpy()
        assert got.shape == (3, 5, 6, 5)
        np.testing.assert_array_equal(got[1], np.asarray(jacc.shifted(jregion, d)))
    np.testing.assert_array_equal(acc[(12, 21, 31)].numpy(), raw[:, 4, 2, 4])
    assert acc[(12, 21, 31)][1] == jacc[(12, 21, 31)]
