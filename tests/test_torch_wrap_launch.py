"""The launch path of ``jacobi_wrap_step`` (``stencil_tpu_torch/ops/
jacobi_kernels.py``), on the CPU.

* the C entry ``stp_jacobi_wrap`` gets its arguments in its order, the
  stream from ``current_raw_stream`` and, where k needs more than one
  march, a scratch buffer apart from the input and the output;
* the library is looked up once over many calls;
* a nonzero return code raises, with no fallback to the plain version, and
  counts no launch; ``launches`` counts one a call;
* ``jacobi_wrap_launch`` passes the plan entry its arguments and names its
  fields;
* the march split of k levels (``wrap_march_depths``);
* on CPU tensors the wrapper runs the plain version, bitwise equal to the
  JAX package's Pallas kernel in interpret mode, and counts no launch.

The launch path runs here on tensors that report a CUDA device, with a
Python stand-in for the C entry that reads the input at the address it is
given and writes the plain version's result at the output's, as the kernel
does.  The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.ops import jacobi_pallas as jp
from stencil_tpu_torch.kernels import build
from stencil_tpu_torch.ops import jacobi_kernels as jk

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` as its device, so that the
    wrapper takes its launch path; its data stays in host memory."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _view(ptr: int, shape) -> torch.Tensor:
    """A writable f32 tensor over ``shape`` elements at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * 4
    return torch.from_numpy(np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=np.float32).reshape(shape))


def _stand_in(in_p, out_p, scratch_p, X, Y, Z, k, hot_x, cold_x, in_r2, stream):
    """What the kernel computes, from the arguments in the C entry's order:
    the plain version of the input at ``in_p``, into ``out_p``."""
    assert (hot_x, cold_x, in_r2) == jk.sphere_params(X)
    _view(out_p, (X, Y, Z)).copy_(jk.jacobi_wrap_step_plain(_view(in_p, (X, Y, Z)).clone(), k))
    if scratch_p is not None:
        _view(scratch_p, (X, Y, Z)).fill_(float("nan"))  # the first march's level, garbage to the caller
    return 0


#: the plan the stand-in plan entry reports: 2 marches of 4, the rest as a
#: 512^3 call might read
_PLAN = (2, 4, 2, 132, 1320, 86, 6, 66080, 256, 10, 22)


@pytest.fixture
def on_card(monkeypatch):
    """Route ``jacobi_wrap_step`` through its launch path on host memory: a
    fixed raw stream, a stand-in library whose entry records its arguments
    and runs ``_stand_in`` (or returns ``card.rc`` when set), and a count of
    library lookups."""
    card = types.SimpleNamespace(calls=[], loads=[], plans=[], rc=0, plan=_PLAN,
                                 to_card=lambda t: t.clone().as_subclass(_OnCard))

    def entry(*args):
        card.calls.append(args)
        return card.rc if card.rc else _stand_in(*args)

    def plan(*args):
        card.plans.append(args[:-1])
        for j, v in enumerate(card.plan):
            args[-1][j] = v
        return card.rc

    lib = types.SimpleNamespace(stp_jacobi_wrap=entry, stp_jacobi_wrap_plan=plan,
                                stp_jacobi_wavefront=None, stp_error_string=lambda code: b"stand-in error")

    def load(name):
        card.loads.append(name)
        return lib

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(jk, "_ENTRY", None)
    monkeypatch.setattr(jk, "_VARIANTS", {})  # the other builds' cache
    monkeypatch.setattr(jk, "_ENTRIES", {})
    monkeypatch.setattr(jk, "current_raw_stream", lambda index: 7000 + index)
    return card


@pytest.mark.parametrize("shape,k", [((8, 9, 10), 1), ((12, 7, 33), 4), ((10, 12, 70), 5), ((16, 20, 24), 8),
                                     ((24, 9, 11), 12)])
def test_launch_path_passes_the_arguments_in_order(on_card, shape, k):
    block = torch.from_numpy(_rand(shape, k))
    card_in = on_card.to_card(block)
    before = jk.jacobi_wrap_step.launches
    got = jk.jacobi_wrap_step(card_in, k)
    assert jk.jacobi_wrap_step.launches == before + 1 and len(on_card.calls) == 1
    args = on_card.calls[0]
    X, Y, Z = shape
    assert args[3:] == (X, Y, Z, k, *jk.sphere_params(X), 7000)
    assert args[0] == card_in.data_ptr() and args[1] == got.data_ptr()
    # a scratch buffer of its own exactly where k needs more than one march
    assert (args[2] is not None) == (len(jk.wrap_march_depths(k)) > 1)
    assert args[2] not in (args[0], args[1])
    # a fresh output; the input left as it was
    assert got.data_ptr() != card_in.data_ptr() and got.shape == block.shape
    assert torch.equal(card_in.as_subclass(torch.Tensor), block)
    assert torch.equal(got.as_subclass(torch.Tensor), jk.jacobi_wrap_step_plain(block, k))


def test_library_is_looked_up_once_over_many_calls(on_card):
    c = on_card.to_card
    before = jk.jacobi_wrap_step.launches
    for k in (1, 2, 8, 3, 5):
        jk.jacobi_wrap_step(c(torch.from_numpy(_rand((16, 6, 8), k))), k)
    jk.jacobi_wrap_launch((512, 512, 512), 8)
    assert on_card.loads == ["jacobi_wavefront"]
    assert len(on_card.calls) == 5 and {a[-1] for a in on_card.calls} == {7000}
    assert jk.jacobi_wrap_step.launches == before + 5


@pytest.mark.parametrize("rc,match", [(2, "launch failed \\(2\\): stand-in error"),
                                      (-1, "unsupported argument")])
@pytest.mark.parametrize("k", [1, 8])
def test_a_failed_launch_raises_with_no_fallback(on_card, rc, match, k):
    block = on_card.to_card(torch.from_numpy(_rand((16, 6, 8), 3)))
    before = jk.jacobi_wrap_step.launches
    on_card.rc = rc
    with pytest.raises(RuntimeError, match=match):
        jk.jacobi_wrap_step(block, k)
    assert jk.jacobi_wrap_step.launches == before and len(on_card.calls) == 1


def test_refusals_raise_before_the_launch(on_card):
    c = on_card.to_card
    with pytest.raises(ValueError, match="X//2"):
        jk.jacobi_wrap_step(c(torch.zeros(8, 5, 5)), 5)
    with pytest.raises(TypeError, match="float32"):
        jk.jacobi_wrap_step(c(torch.zeros(8, 5, 5, dtype=torch.float16)), 1)  # float64 is ported
    with pytest.raises(ValueError, match="contiguous"):
        jk.jacobi_wrap_step(c(torch.zeros(8, 5, 5)).transpose(1, 2), 1)
    assert on_card.calls == [] and on_card.loads == []


@pytest.mark.parametrize("k,depths", [(1, [1]), (4, [4]), (5, [3, 2]), (8, [4, 4]), (12, [4, 4, 4])])
def test_march_split(k, depths):
    assert jk.wrap_march_depths(k) == depths


def test_march_split_covers_every_depth():
    """ceil(k/4) marches of at most 4 levels, as even as can be, the deeper
    first, their levels adding up to k."""
    for k in range(1, 41):
        d = jk.wrap_march_depths(k)
        assert sum(d) == k and len(d) == -(-k // jk.WAVEFRONT_SUB_DEPTH)
        assert max(d) <= jk.WAVEFRONT_SUB_DEPTH and max(d) - min(d) <= 1 and d == sorted(d, reverse=True)


def test_plan_entry_gets_its_arguments_and_names_its_fields(on_card):
    plan = jk.jacobi_wrap_launch((512, 512, 512), 8)
    assert on_card.plans == [(512, 512, 512, 8)]
    assert list(plan)[: len(jk.WRAP_PLAN_FIELDS)] == list(jk.WRAP_PLAN_FIELDS)
    assert plan["launches"] == 2 and plan["depths"] == [4, 4] and plan["xchunk"] == 86
    assert plan["waves"] == 1320 / (2 * 132)
    # a C split other than the wrapper's is refused
    with pytest.raises(RuntimeError, match="otherwise than wrap_march_depths"):
        jk.jacobi_wrap_launch((512, 512, 512), 12)
    on_card.rc = -1
    with pytest.raises(RuntimeError, match="unsupported argument"):
        jk.jacobi_wrap_launch((512, 512, 512), 8)


# --- the wrapper on CPU tensors: the plain version, equal to Pallas interpret --------


@pytest.mark.parametrize("shape,k", [((16, 20, 24), k) for k in (4, 5, 6, 7, 8)] + [((16, 5, 7), 4)])
def test_wrapper_on_cpu_equals_pallas_interpret(shape, k):
    """k = 4..8 on a block both spheres cross, and y and z axes shorter than
    a march's apron (16, 5, 7) at k = 4."""
    block = _rand(shape, 60 + k)
    before = jk.jacobi_wrap_step.launches
    got = jk.jacobi_wrap_step(torch.from_numpy(block), k).numpy()
    want = np.asarray(jp.jacobi_wrap_step(jnp.asarray(block), interpret=True, k=k))
    assert jk.jacobi_wrap_step.launches == before
    assert (got == jk.HOT_TEMP).any() and (got == jk.COLD_TEMP).any()
    np.testing.assert_array_equal(got, want)


# --- the kernel axes: each form launches its own build -------------------------------


def _tview(ptr: int, shape, dtype) -> torch.Tensor:
    """A writable tensor of ``dtype`` over ``shape`` at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).view(shape)


@pytest.fixture
def axis_card(monkeypatch):
    """A stand-in ``stp_jacobi_wrap`` in every build: it records its
    arguments and the build it was looked up in, and writes the plain
    version of the form at the output's address."""
    card = types.SimpleNamespace(calls=[], loads=[], form=None)

    def load(name):
        card.loads.append(name)

        def entry(in_p, out_p, scratch_p, X, Y, Z, k, hot_x, cold_x, in_r2, stream):
            unit, mi, bf16 = card.form
            card.calls.append((name, scratch_p, X, Y, Z, k, stream))
            dt = torch.bfloat16 if bf16 else torch.float32
            src = _tview(in_p, (X, Y, Z), dt).clone()
            want = jk.jacobi_wrap_step_plain(src, k, compute_unit=unit, mxu_input=mi, f32_accumulate=bf16)
            _tview(out_p, (X, Y, Z), dt).copy_(want)
            return 0

        return types.SimpleNamespace(stp_jacobi_wrap=entry, stp_jacobi_wavefront=None,
                                     stp_error_string=lambda code: b"stand-in error")

    monkeypatch.setattr(build, "load", load)
    for cache, value in (("_ENTRY", None), ("_ENTRIES", {}), ("_VARIANTS", {})):
        monkeypatch.setattr(jk, cache, value)
    monkeypatch.setattr(jk, "current_raw_stream", lambda index: 7000 + index)
    return card


@pytest.mark.parametrize("unit,mi,bf16,lib,counter", [
    ("vpu", "f32", True, "jacobi_wavefront_bf16", "bf16_launches"),
    ("mxu", "f32", False, "jacobi_wavefront_mxu", "mxu_launches"),
    ("mxu_band", "bf16", False, "jacobi_wavefront_mxu16", "mxu_bf16in_launches"),
    ("mxu_band", "f32", True, "jacobi_wavefront_mxu_bf16", "mxu_launches"),
    ("mxu", "bf16", True, "jacobi_wavefront_mxu16_bf16", "mxu_bf16in_launches")])
@pytest.mark.parametrize("k", [1, 8, 12])
def test_axis_form_launches_its_build(axis_card, unit, mi, bf16, lib, counter, k):
    """One lookup of the form's build, its counter alone moves, a scratch
    where k needs more than one march, the form's plain result."""
    axis_card.form = (unit, mi, bf16)
    block = torch.from_numpy(_rand((24, 16, 32), k))
    if bf16:
        block = block.to(torch.bfloat16)
    before = {c: getattr(jk.jacobi_wrap_step, c) for c in jk.CONTRACTION_COUNTERS}
    got = jk.jacobi_wrap_step(block.clone().as_subclass(_OnCard), k, compute_unit=unit, mxu_input=mi,
                              f32_accumulate=bf16)
    assert axis_card.loads == [lib] and len(axis_card.calls) == 1
    name, scratch_p, *rest = axis_card.calls[0]
    assert rest == [24, 16, 32, k, 7000] and (scratch_p is not None) == (k > 4)
    after = {c: getattr(jk.jacobi_wrap_step, c) for c in jk.CONTRACTION_COUNTERS}
    assert {c: after[c] - before[c] for c in after} == {c: int(c == counter) for c in after}
    want = jk.jacobi_wrap_step_plain(block, k, compute_unit=unit, mxu_input=mi, f32_accumulate=bf16)
    assert got.dtype == block.dtype and torch.equal(got.as_subclass(torch.Tensor), want)


def test_bf16_wrap_scratch_keeps_the_levels_at_f32():
    """Under bf16 storage every march but the last writes f32 scratch: one
    buffer for two marches, two from three on; f32 storage ping-pongs
    through the output as before."""
    assert jk.wrap_scratch_shape((8, 9, 10), 4, True) is None
    assert jk.wrap_scratch_shape((8, 9, 10), 8, True) == (1, 8, 9, 10)
    assert jk.wrap_scratch_shape((8, 9, 10), 12, True) == (2, 8, 9, 10)
    assert jk.wrap_scratch_shape((8, 9, 10), 12, False) == (8, 9, 10)


def test_wrap_plan_reports_the_build(on_card):
    plan = jk.jacobi_wrap_launch((512, 512, 512), 8, compute_unit="mxu_band", mxu_input="bf16", storage="bf16")
    assert on_card.loads == ["jacobi_wavefront_mxu16_bf16"]
    assert (plan["compute_unit"], plan["mxu_input"], plan["storage"]) == ("mxu_band", "bf16", "bf16")
    with pytest.warns(RuntimeWarning, match="running the dense mxu form"):
        plan = jk.jacobi_wrap_launch((16, 13, 13), 8, compute_unit="mxu_band")
    assert plan["compute_unit"] == "mxu" and plan["mxu_input"] == "f32"
    plan = jk.jacobi_wrap_launch((512, 512, 512), 8, mxu_input="bf16")
    assert (plan["compute_unit"], plan["mxu_input"], plan["storage"]) == ("vpu", "f32", "native")
    with pytest.raises(ValueError, match="unknown storage dtype"):
        jk.jacobi_wrap_launch((512, 512, 512), 8, storage="fp8")
