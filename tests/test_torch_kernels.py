"""The port's kernels, through their plain PyTorch versions, against the JAX
package's Pallas kernels in interpret mode, bitwise.

On a CPU tensor each wrapper runs its plain version, so these tests hold the
arithmetic the CUDA kernels repeat (summation order, the multiply by
float32(1/6), the integer sphere test, the wrap and the shell pass-through)
to the TPU kernels.  ``tests/test_torch_cuda.py`` holds the kernels to the
plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.ops import halo_blend as jhb
from stencil_tpu.ops import jacobi_pallas as jjp
from stencil_tpu_torch.ops import halo_blend as thb
from stencil_tpu_torch.ops import jacobi_kernels as tjk

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)


def _f32(rng, shape):
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_wrap_step_bitwise_vs_pallas(k):
    rng = np.random.default_rng(11)
    block = _f32(rng, (20, 18, 22))
    want = np.asarray(jjp.jacobi_wrap_step(jnp.asarray(block, jnp.float32), interpret=True, k=k))
    got = tjk.jacobi_wrap_step(torch.from_numpy(block), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrap_step_spheres_fire_and_input_kept():
    """At 30^3 the clamps fire (radius 3 spheres), and the wrapper leaves
    its input untouched (it returns a new tensor, like the JAX function)."""
    block = torch.full((30, 30, 30), 0.5)
    before = block.clone()
    out = tjk.jacobi_wrap_step(block, 2)
    assert torch.equal(block, before)
    assert out[10, 15, 15] == 1.0 and out[20, 15, 15] == 0.0
    want = np.asarray(jjp.jacobi_wrap_step(jnp.asarray(before.numpy()), interpret=True, k=2))
    np.testing.assert_array_equal(out.numpy(), want)


def test_sixth_is_the_float32_multiply():
    """XLA compiles `sum / 6.0` as `sum * float32(1/6)`; the port multiplies
    by that constant.  A true divide differs by 1 ulp on some cells."""
    assert tjk.SIXTH == float.fromhex("0x1.555556p-3")
    s = torch.from_numpy(np.random.default_rng(2).random(4096).astype(np.float32) * 6)
    assert not torch.equal(s / 6.0, s * tjk.SIXTH)


@pytest.mark.parametrize("origin", [(0, 0, 0), (5, 7, 30), (37, 3, 41)])
def test_plane_step_bitwise_vs_pallas(origin):
    rng = np.random.default_rng(12)
    gs = (40, 36, 44)
    block = _f32(rng, (10, 12, 14))
    org = np.asarray(origin, np.int32)
    d2j = jjp.yz_dist2_plane(origin[1], origin[2], (10, 12), gs).astype(jnp.int32)
    want = np.asarray(
        jjp.jacobi_plane_step(jnp.asarray(block), jnp.asarray(org), d2j, gs, interpret=True)
    )
    d2t = tjk.yz_dist2_plane(origin[1], origin[2], (10, 12), gs)
    np.testing.assert_array_equal(d2t.numpy(), np.asarray(d2j))
    got = tjk.jacobi_plane_step(torch.from_numpy(block), torch.from_numpy(org), d2t, gs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plane_step_batched_equals_per_block():
    """One call over n blocks (the counterpart of shard_map) equals n calls,
    and ``out=`` receives the result."""
    rng = np.random.default_rng(13)
    gs = (16, 16, 16)
    blocks = torch.from_numpy(_f32(rng, (4, 10, 10, 10)))
    origins = torch.tensor([[0, 0, 0], [8, 0, 0], [0, 8, 8], [8, 8, 8]], dtype=torch.int32)
    d2 = torch.stack([tjk.yz_dist2_plane(int(o[1]), int(o[2]), (8, 8), gs) for o in origins])
    out = torch.empty_like(blocks)
    res = tjk.jacobi_plane_step(blocks, origins, d2, gs, out=out)
    assert res is out
    for b in range(4):
        one = tjk.jacobi_plane_step(blocks[b].contiguous(), origins[b].contiguous(), d2[b].contiguous(), gs)
        assert torch.equal(one, out[b])
    # the shell passes through
    assert torch.equal(out[:, 0], blocks[:, 0]) and torch.equal(out[:, :, :, -1], blocks[:, :, :, -1])


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("pos_kind", ["lo", "mid", "hi"])
def test_blend_slab_bitwise_vs_pallas(axis, pos_kind):
    shape = (6, 21, 19)
    r = 3
    rng = np.random.default_rng(14)
    block = _f32(rng, shape)
    slab_shape = list(shape)
    slab_shape[axis] = r
    slab = _f32(rng, slab_shape)
    pos = {"lo": 0, "mid": 2, "hi": shape[axis] - r}[pos_kind]
    want = np.asarray(jhb.blend_slab(jnp.asarray(block), jnp.asarray(slab), axis, pos, interpret=True))
    tb = torch.from_numpy(block.copy())
    got = thb.blend_slab(tb, torch.from_numpy(slab), axis, pos)
    assert got is tb  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_blend_slab_batched_and_checked():
    rng = np.random.default_rng(15)
    blocks = torch.from_numpy(_f32(rng, (3, 5, 6, 7)))
    slab = torch.from_numpy(_f32(rng, (3, 5, 6, 2)))
    want = blocks.clone()
    want[..., 4:6] = slab
    thb.blend_slab(blocks, slab, 2, 4)
    assert torch.equal(blocks, want)
    with pytest.raises(ValueError):
        thb.blend_slab(blocks, slab, 2, 6)  # runs off the end
    with pytest.raises(ValueError):
        thb.blend_slab(blocks, slab, 1, 0)  # wrong axis for this slab
    with pytest.raises(TypeError):
        thb.blend_slab(blocks, slab.double(), 2, 0)


def test_choose_temporal_k_validates_like_jax():
    assert tjk.choose_temporal_k((512, 512, 512)) == tjk.WRAP_AUTO_K
    assert tjk.choose_temporal_k((6, 8, 8)) == 3
    assert tjk.choose_temporal_k((20, 8, 8), 10) == 10
    for bad in (0, 11):
        with pytest.raises(ValueError):
            tjk.choose_temporal_k((20, 8, 8), bad)
        with pytest.raises(ValueError):
            jjp.choose_temporal_k((20, 8, 8), 4, bad)
    assert tjk.sphere_params(512) == jjp.sphere_params(512)


@pytest.mark.parametrize("bad", ["meta", "strided", "dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    """A tensor that is neither on the CPU (plain version) nor on CUDA (the
    kernel), or that is strided or of the wrong dtype, raises: no wrapper
    quietly computes it another way."""
    block = torch.zeros(8, 6, 10)
    if bad == "meta":
        block = block.to("meta")
    elif bad == "strided":
        block = torch.zeros(8, 6, 20)[:, :, ::2]
    else:
        block = block.half()  # float64 is a ported dtype (tests/test_torch_jacobi_dtypes.py)
    with pytest.raises((ValueError, TypeError)):
        tjk.jacobi_wrap_step(block, 1)
    with pytest.raises((ValueError, TypeError)):
        tjk.jacobi_plane_step(block, torch.zeros(3, dtype=torch.int32),
                              torch.zeros(4, 8, dtype=torch.int32), (8, 6, 10))
    if bad != "dtype":  # blend_slab takes any 1/2/4/8-byte dtype
        with pytest.raises(ValueError):
            thb.blend_slab(block, torch.zeros(8, 6, 1, device=block.device), 2, 0)
