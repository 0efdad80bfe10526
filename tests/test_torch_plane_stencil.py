"""The mean-of-6 kernels of the port against the JAX package's
``stencil_tpu/ops/plane_stencil.py``, on 16^3 f32 blocks made from a numpy
seed, the JAX kernels in interpret mode (as ``tests/test_plane_stencil.py``
runs them).

* ``mean6_plane_step`` is bitwise equal, for even and uneven shell widths;
* ``mean6_shell_wavefront_step`` is bitwise at m = 1 and within rtol 1e-6 at
  m = 2 and 3 on the valid interior ``[s, N - s)``: XLA on the CPU contracts a
  level's multiply into the next level's adds (ROADMAP.md queue 3, "FMA
  contraction"), which the port does not;
* the unported axes raise ``NotImplementedError`` naming queue 1 item 9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.ops import plane_stencil as jps
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.ops import plane_stencil as ps

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

N = 16


def _src(seed=11):
    return np.random.default_rng(seed).random((N, N, N)).astype(np.float32)


@pytest.mark.parametrize("lo,hi", [((1, 1, 1), (1, 1, 1)), ((1, 2, 3), (3, 1, 2)), ((3, 3, 3), (3, 3, 3))])
def test_mean6_plane_step_bitwise_vs_jax(lo, hi):
    src = _src()
    want = np.asarray(jps.mean6_plane_step(jnp.asarray(src), JDim3.of(lo), JDim3.of(hi), interpret=True))
    before = ps.mean6_plane_step.launches
    got = ps.mean6_plane_step(torch.from_numpy(src), Dim3.of(lo), Dim3.of(hi))
    assert ps.mean6_plane_step.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    # the shell passes through
    inside = np.zeros(src.shape, bool)
    inside[lo[0]:N - hi[0], lo[1]:N - hi[1], lo[2]:N - hi[2]] = True
    np.testing.assert_array_equal(got.numpy()[~inside], src[~inside])
    out = torch.full((N, N, N), -1.0)
    assert ps.mean6_plane_step(torch.from_numpy(src), lo, hi, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("m,s", [(1, 1), (1, 3), (2, 3), (3, 3)])
def test_mean6_shell_wavefront_step_vs_jax(m, s):
    src = _src(12)
    # the JAX kernel writes its input in place: a fresh device buffer
    want = np.asarray(jps.mean6_shell_wavefront_step(jnp.asarray(src.copy()), m=m, shell_width=s, interpret=True))
    before = ps.mean6_shell_wavefront_step.launches
    got = ps.mean6_shell_wavefront_step(torch.from_numpy(src), m, s).numpy()
    assert ps.mean6_shell_wavefront_step.launches == before
    core = (slice(s, N - s),) * 3
    if m == 1:
        np.testing.assert_array_equal(got[core], want[core])
    else:
        np.testing.assert_allclose(got[core], want[core], rtol=1e-6, atol=0)


def test_mean6_wavefront_levels_equal_plane_steps():
    """m levels in one pass equal m plane steps over the shrinking window on
    the interior, bitwise (one arithmetic, no contraction)."""
    src = torch.from_numpy(_src(13))
    got = ps.mean6_shell_wavefront_step(src, 3, 3)
    c = src
    for level in range(1, 4):
        c = ps.mean6_plane_step(c, (level,) * 3, (level,) * 3)
    core = (slice(3, N - 3),) * 3
    assert torch.equal(got[core], c[core])


def test_mean6_unported_axes_and_limits_raise():
    block = torch.zeros(N, N, N)
    one = Dim3(1, 1, 1)
    for kw in ({"compute_unit": "mxu"}, {"f32_accumulate": True}, {"mxu_input": "bf16"}):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            ps.mean6_plane_step(block, one, one, **kw)
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            ps.mean6_shell_wavefront_step(block, 2, 3, **kw)
    with pytest.raises(NotImplementedError, match="float32"):
        ps.mean6_plane_step(block.double(), one, one)
    with pytest.raises(ValueError, match=">= 1"):
        ps.mean6_plane_step(block, Dim3(0, 1, 1), one)
    with pytest.raises(ValueError, match="shell_width"):
        ps.mean6_shell_wavefront_step(block, 4, 3)
    # deeper than one block's shared memory holds: the JAX package allows it
    with pytest.raises(ValueError, match="shared memory"):
        ps.mean6_shell_wavefront_step(torch.zeros(20, 20, 20), ps.MEAN6_MAX_M + 1, 9)
    assert ps.mean6_wavefront_smem_bytes(ps.MEAN6_MAX_M) <= 232_448 < ps.mean6_wavefront_smem_bytes(9)
