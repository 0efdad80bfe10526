"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit: it carries the
``cuda`` marker and skips (inside the fixture, never at import) where
``torch.cuda.is_available()`` is false.  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not use.)

The comparison is bitwise: each kernel repeats its plain version's
arithmetic in the same order, built without fast-math or FMA contraction.
"""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.ops import halo_blend as hb
from stencil_tpu_torch.ops import jacobi_kernels as jk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rand(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_wrap_kernel_equals_plain(dev, k):
    block = _rand((66, 70, 130), 1, dev)
    before = jk.jacobi_wrap_step.launches
    got = jk.jacobi_wrap_step(block, k)
    torch.cuda.synchronize()
    assert jk.jacobi_wrap_step.launches == before + k
    assert torch.equal(got, jk.jacobi_wrap_step_plain(block, k))


def test_plane_kernel_equals_plain(dev):
    gs = (130, 140, 260)
    blocks = _rand((2, 66, 70, 130), 2, dev)
    origins = torch.tensor([[64, 0, 128], [0, 68, 0]], dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (68, 128), gs, dev) for o in origins])
    got = jk.jacobi_plane_step(blocks, origins, d2, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, jk.jacobi_plane_step_plain(blocks, origins, d2, gs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_blend_kernel_equals_plain(dev, axis, dtype):
    blocks = (_rand((3, 17, 19, 23), 3, dev) * 100).to(dtype)
    for r, pos in ((1, 0), (2, 5), (3, blocks.shape[1 + axis] - 3)):
        shape = list(blocks.shape)
        shape[1 + axis] = r
        slab = (_rand(shape, 4 + r, dev) * 100).to(dtype)
        want = hb.blend_slab_plain(blocks.clone(), slab, axis, pos)
        got = hb.blend_slab(blocks.clone(), slab, axis, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_model_routes_agree_on_card(dev):
    wrap = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    shell = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    shell.dd.set_partition(2, 2, 2)
    ref = Jacobi3D(32, 32, 32)
    for m in (wrap, shell, ref):
        m.realize()
        m.step(6)
    assert np.array_equal(wrap.temperature(), shell.temperature())
    np.testing.assert_allclose(wrap.temperature(), ref.temperature(), rtol=1e-6)
