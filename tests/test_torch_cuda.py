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


def _wavefront_case(dev, m, s_off, ring, slabs, z_valid=None):
    """Kernel and plain version of one wavefront call over 2 ragged blocks;
    returns both results and the valid-region slices."""
    Xr, Yr, Z = 22, 26, 128 if ring else 30
    gs = (2 * (Xr - 2 * s_off) + 3, 2 * (Yr - 2 * s_off), 2 * Z)
    raw = _rand((2, Xr, Yr, Z), 7, dev)
    org = torch.tensor([[5, 0, 7], [gs[0] - 3, Yr - 2 * s_off, 0]], dtype=torch.int32, device=dev)
    zs = _rand((2, Xr, 2 * s_off, Yr), 8, dev) if slabs else None
    if ring:
        d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s_off, int(o[2]), s_off, Yr, Z, gs, dev)
                          for o in org])
        args = (raw, m, org, d2, gs, zs)
        kw = dict(interior_offset=s_off)
        fn, plain, zsl = jk.jacobi_zring_wavefront_step, jk.jacobi_zring_wavefront_step_plain, slice(None)
    else:
        d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s_off, int(o[2]) - s_off, (Yr, Z), gs, dev)
                          for o in org])
        args = (raw, m, org, d2, gs)
        kw = dict(interior_offset=s_off, z_slabs=zs, z_valid=z_valid)
        fn, plain = jk.jacobi_shell_wavefront_step, jk.jacobi_shell_wavefront_step_plain
        zsl = slice(s_off, (z_valid or Z) - s_off)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1  # m levels in one launch
    want = plain(*args, **kw)
    if not slabs:
        got, want = (got, None), (want, None)
    return got, want, slice(s_off, -s_off), zsl


@pytest.mark.parametrize("m,s_off", [(1, 1), (2, 2), (2, 3), (3, 4)])
@pytest.mark.parametrize("slabs", [False, True])
def test_shell_wavefront_kernel_equals_plain(dev, m, s_off, slabs):
    got, want, S, zsl = _wavefront_case(dev, m, s_off, False, slabs, z_valid=27)
    assert torch.equal(got[0][:, S, S, zsl], want[0][:, S, S, zsl])
    if slabs:
        assert torch.equal(got[1][:, S, :, S], want[1][:, S, :, S])


@pytest.mark.parametrize("m,s_off", [(1, 1), (2, 2), (2, 3), (3, 4)])
def test_zring_wavefront_kernel_equals_plain(dev, m, s_off):
    got, want, S, zsl = _wavefront_case(dev, m, s_off, True, True)
    assert torch.equal(got[0][:, S, S], want[0][:, S, S])
    assert torch.equal(got[1][:, S, :, S], want[1][:, S, :, S])


def test_model_routes_agree_on_card(dev):
    wrap = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    shell = Jacobi3D(32, 32, 32, kernel_impl="cuda", pallas_path="shell")
    shell.dd.set_partition(2, 2, 2)
    wavefront = Jacobi3D(32, 32, 32, kernel_impl="cuda")
    wavefront.dd.set_partition(2, 2, 2)
    ref = Jacobi3D(32, 32, 32)
    for m in (wrap, shell, wavefront, ref):
        m.realize()
        m.step(6)
    assert wavefront._pallas_path == "wavefront"
    assert np.array_equal(wrap.temperature(), shell.temperature())
    assert np.array_equal(wrap.temperature(), wavefront.temperature())
    np.testing.assert_allclose(wrap.temperature(), ref.temperature(), rtol=1e-6)
