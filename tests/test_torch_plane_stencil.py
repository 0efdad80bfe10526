"""The mean-of-6 kernels of the port against the JAX package's
``stencil_tpu/ops/plane_stencil.py``, on 16^3 f32 blocks made from a numpy
seed, the JAX kernels in interpret mode (as ``tests/test_plane_stencil.py``
runs them).

* ``mean6_plane_step`` is bitwise equal, for even and uneven shell widths;
* ``mean6_shell_wavefront_step`` is bitwise at m = 1 and within rtol 1e-6 at
  m = 2 and 3 on the valid interior ``[s, N - s)``: XLA on the CPU contracts a
  level's multiply into the next level's adds (ROADMAP.md queue 3, "FMA
  contraction"), which the port does not;
* the unported axes (the contraction) raise ``NotImplementedError`` naming
  queue 1 item 9; bf16 storage and float64 blocks engage (and equal the JAX
  kernels: tests/test_torch_jacobi_dtypes.py);
* ``mean6_shell_wavefront_step``'s launch path, on tensors that report a
  CUDA device with a Python stand-in for the C entry ``stp_mean6_march``:
  its arguments in order, the raw stream, a scratch exactly where m needs two
  marches, one library lookup, only the interior written, a failure raised
  with no fallback, and the plan entry's fields.
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.ops import plane_stencil as jps
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.kernels import build
from stencil_tpu_torch.ops import jacobi_kernels as jk
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
    # the contraction form is ported (tests/test_torch_stream_mxu.py): an
    # unknown unit or operand precision is refused, and a float64 block under
    # a contracting unit, where the JAX kernel asserts an f32 accumulator
    for kw in ({"compute_unit": "gpu"}, {"mxu_input": "fp8"}):
        with pytest.raises(ValueError, match="unknown"):
            ps.mean6_plane_step(block, one, one, **kw)
        with pytest.raises(ValueError, match="unknown"):
            ps.mean6_shell_wavefront_step(block, 2, 3, **kw)
    with pytest.raises(AssertionError, match="f32 accumulator"):
        ps.mean6_plane_step(block.double(), one, one, compute_unit="mxu")
    # bf16 storage (f32_accumulate) and float64 blocks are ported: each
    # engages and equals the JAX kernel (tests/test_torch_jacobi_dtypes.py
    # holds them at more shapes and depths)
    src = _src()
    bf = torch.from_numpy(src).to(torch.bfloat16)
    want = jps.mean6_plane_step(jnp.asarray(src).astype(jnp.bfloat16), JDim3(1, 1, 1), JDim3(1, 1, 1),
                                interpret=True, f32_accumulate=True)
    got = ps.mean6_plane_step(bf, one, one, f32_accumulate=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    want = jps.mean6_shell_wavefront_step(jnp.asarray(src.astype(np.float64)), m=1, shell_width=3, interpret=True)
    got = ps.mean6_shell_wavefront_step(torch.from_numpy(src).double(), 1, 3)
    assert got.dtype == torch.float64
    core = (slice(3, N - 3),) * 3
    np.testing.assert_array_equal(got.numpy()[core], np.asarray(want)[core])
    with pytest.raises(ValueError, match=">= 1"):
        ps.mean6_plane_step(block, Dim3(0, 1, 1), one)
    with pytest.raises(ValueError, match="shell_width"):
        ps.mean6_shell_wavefront_step(block, 4, 3)
    # deeper than two chained marches of WAVEFRONT_SUB_DEPTH levels: the JAX package allows it
    with pytest.raises(ValueError, match="at most two marches of 4 levels"):
        ps.mean6_shell_wavefront_step(torch.zeros(20, 20, 20), ps.MEAN6_MAX_M + 1, 9)
    assert ps.MEAN6_MAX_M == 2 * jk.WAVEFRONT_SUB_DEPTH == 8
    assert [jk.wavefront_marches(m) for m in range(1, ps.MEAN6_MAX_M + 1)] == [1] * 4 + [2] * 4
    # shared memory is no longer the limit: one more level would still fit a block many times over
    assert max(ps.mean6_wavefront_smem_bytes(m) for m in range(1, ps.MEAN6_MAX_M + 2)) * 2 <= jk.SMEM_PER_BLOCK


# --- mean6_shell_wavefront_step's launch path on the CPU ------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` as its device, so that the
    wrapper takes its launch path; its data stays in host memory."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _view(ptr: int, shape) -> torch.Tensor:
    """A writable f32 tensor over ``shape`` elements at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * 4
    return torch.from_numpy(np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), np.float32).reshape(shape))


#: what the plan stand-in reports: one march of depth 3 at (1, 518^3) on 132 SMs
_PLAN = (1, 3, 2, 132, 1620, 86, 6, 49696, 256, 9, 20)


@pytest.fixture
def on_card(monkeypatch):
    """Route the wrapper through its launch path on host memory: a fixed raw
    stream, a stand-in library whose ``stp_mean6_march`` records its
    arguments and writes the plain version's interior (or returns
    ``card.rc`` when set), and a count of library lookups."""
    card = types.SimpleNamespace(calls=[], loads=[], plans=[], rc=0,
                                 to_card=lambda t: t.clone().as_subclass(_OnCard))

    def march(raw_p, out_p, scratch_p, n, Xr, Yr, Zr, m, s, stream):
        card.calls.append((raw_p, out_p, scratch_p, n, Xr, Yr, Zr, m, s, stream))
        if card.rc:
            return card.rc
        want = ps.mean6_shell_wavefront_step_plain(_view(raw_p, (Xr, Yr, Zr)).clone(), m, s)
        S = slice(s, -s)
        _view(out_p, (Xr, Yr, Zr))[S, S, S] = want[S, S, S]
        return 0

    def plan(*args):
        card.plans.append(args[:-1])
        for j, v in enumerate(_PLAN):
            args[-1][j] = v
        return card.rc

    lib = types.SimpleNamespace(stp_mean6_march=march, stp_mean6_march_plan=plan, stp_jacobi_wavefront=None,
                                stp_error_string=lambda code: b"stand-in error")

    def load(name):
        card.loads.append(name)
        return lib

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(jk, "_ENTRY", None)
    monkeypatch.setattr(jk, "_ENTRIES", {})
    monkeypatch.setattr(ps, "current_raw_stream", lambda index: 7000 + index)
    return card


@pytest.mark.parametrize("m,s", [(1, 1), (3, 3), (4, 5), (5, 5), (8, 8)])
def test_mean6_wavefront_launch_passes_the_arguments_in_order(on_card, m, s):
    """The C entry's arguments in its order; a scratch of the block's shape,
    apart from both, exactly where m needs two marches; only the interior of
    ``out`` written; one launch a call, however many marches."""
    shape = (2 * s + 9, 2 * s + 7, 2 * s + 11)
    raw = torch.from_numpy(np.random.default_rng(m).random(shape).astype(np.float32))
    out = on_card.to_card(torch.full(shape, -1.0))
    before = ps.mean6_shell_wavefront_step.launches
    got = ps.mean6_shell_wavefront_step(on_card.to_card(raw), m, s, out=out)
    assert got is out and ps.mean6_shell_wavefront_step.launches == before + 1
    (raw_p, out_p, scratch_p, *dims, stream), = on_card.calls
    assert out_p == out.data_ptr() and raw_p not in (out_p, scratch_p) and stream == 7000
    assert dims == [1, *shape, m, s]
    assert (scratch_p is None) == (jk.wavefront_marches(m) == 1) and scratch_p != out_p
    S = slice(s, -s)
    host = got.as_subclass(torch.Tensor)
    assert torch.equal(host[S, S, S], ps.mean6_shell_wavefront_step_plain(raw, m, s)[S, S, S])
    shell = torch.ones(shape, dtype=torch.bool)
    shell[S, S, S] = False
    assert bool((host[shell] == -1.0).all())  # the shell is not written


def test_mean6_wavefront_library_is_looked_up_once_over_many_calls(on_card):
    raw = on_card.to_card(torch.rand(15, 14, 16))
    for m in (1, 2, 6):
        ps.mean6_shell_wavefront_step(raw, m, 6 if m == 6 else 3)
    ps.mean6_wavefront_launch((518, 518, 518), 3, 3)
    assert on_card.loads == ["jacobi_wavefront"] and len(on_card.calls) == 3


@pytest.mark.parametrize("rc,match", [(2, "launch failed \\(2\\): stand-in error"), (-1, "unsupported argument")])
def test_mean6_wavefront_failed_launch_raises_with_no_fallback(on_card, rc, match):
    on_card.rc = rc
    before = ps.mean6_shell_wavefront_step.launches
    with pytest.raises(RuntimeError, match=match):
        ps.mean6_shell_wavefront_step(on_card.to_card(torch.rand(12, 12, 12)), 3, 3)
    assert ps.mean6_shell_wavefront_step.launches == before and len(on_card.calls) == 1


def test_mean6_wavefront_plan_entry_gets_its_arguments_and_names_its_fields(on_card):
    plan = ps.mean6_wavefront_launch((518, 518, 518), 3, 3)
    assert on_card.plans == [(1, 518, 518, 518, 3, 3)]
    assert list(plan)[: len(jk.WRAP_PLAN_FIELDS)] == list(jk.WRAP_PLAN_FIELDS)
    assert (plan["launches"], plan["depth"], plan["smem_bytes"]) == (1, 3, ps.mean6_wavefront_smem_bytes(3))
    assert plan["waves"] == 1620 / (2 * 132)
    on_card.rc = -1
    with pytest.raises(RuntimeError, match="unsupported argument"):
        ps.mean6_wavefront_launch((518, 518, 518), 9, 9)
