"""The launch path of ``jacobi_plane_step`` and ``jacobi_slab_step``
(``stencil_tpu_torch/ops/jacobi_kernels.py``), on the CPU.

* the C entries ``stp_jacobi_plane`` and ``stp_jacobi_slab`` get their
  arguments in their order and the stream from ``current_raw_stream``;
* the library (``jacobi_wavefront``, which holds both forms) is looked up
  once over many calls of both wrappers and both plan functions;
* a nonzero return code raises, with no fallback to the plain version, and
  counts no launch; ``launches`` counts one a call;
* ``jacobi_plane_launch`` and ``jacobi_slab_launch`` pass their plan entries
  the arguments and name the fields;
* on CPU tensors each wrapper runs its plain version, bitwise equal to the
  JAX package's Pallas kernel in interpret mode, and counts no launch.

The launch path runs here on tensors that report a CUDA device, with Python
stand-ins for the C entries that read the inputs at the addresses they are
given and write the plain version's result at the output's, as the kernels
do.  The kernels themselves run only on the card (tests/test_torch_cuda.py).
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


def _view(ptr: int, shape, dtype=np.float32) -> torch.Tensor:
    """A writable tensor over ``shape`` elements at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * 4
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return torch.from_numpy(np.frombuffer(buf, dtype=dtype).reshape(shape))


def _plane_stand_in(in_p, out_p, org_p, d2_p, n, X, Y, Z, gx, hot_x, cold_x, in_r2, stream):
    """What the plane form computes, from the arguments in its C entry's
    order."""
    assert (hot_x, cold_x, in_r2) == jk.sphere_params(gx)
    org = _view(org_p, (n, 3), np.int32).clone()
    d2 = _view(d2_p, (n, Y - 2, Z - 2), np.int32).clone()
    want = jk.jacobi_plane_step_plain(_view(in_p, (n, X, Y, Z)).clone(), org, d2, (gx, 1, 1))
    _view(out_p, (n, X, Y, Z)).copy_(want)
    return 0


def _slab_stand_in(in_p, out_p, xlo, xhi, ylo, yhi, zlo, zhi, org_p, d2_p, n, X, Y, Z, gx, hot_x, cold_x,
                   in_r2, stream):
    """What the slab form computes, from the arguments in its C entry's
    order."""
    assert (hot_x, cold_x, in_r2) == jk.sphere_params(gx)
    faces = [_view(p, (n,) + s).clone() for p, s in zip((xlo, xhi, ylo, yhi, zlo, zhi),
                                                         ((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = _view(org_p, (n, 3), np.int32).clone()
    d2 = _view(d2_p, (n, Y, Z), np.int32).clone()
    want = jk.jacobi_slab_step_plain(_view(in_p, (n, X, Y, Z)).clone(), *faces, org, d2, (gx, 1, 1))
    _view(out_p, (n, X, Y, Z)).copy_(want)
    return 0


#: the plan the stand-in plan entries report, as an (8, 258^3) call might
_PLAN = (4, 132, 5760, 16, 16, 16928, 256, 5, 9)


@pytest.fixture
def on_card(monkeypatch):
    """Route both wrappers through their launch path on host memory: a fixed
    raw stream, a stand-in library whose entries record their arguments and
    run the stand-ins (or return ``card.rc`` when set), and a count of
    library lookups."""
    card = types.SimpleNamespace(calls=[], loads=[], plans=[], rc=0,
                                 to_card=lambda t: t.clone().as_subclass(_OnCard))

    def entry(name, stand_in):
        def call(*args):
            card.calls.append((name, args))
            return card.rc if card.rc else stand_in(*args)
        return call

    def plan(name):
        def call(*args):
            card.plans.append((name, args[:-1]))
            for j, v in enumerate(_PLAN):
                args[-1][j] = v
            return card.rc
        return call

    lib = types.SimpleNamespace(stp_jacobi_plane=entry("plane", _plane_stand_in),
                                stp_jacobi_slab=entry("slab", _slab_stand_in),
                                stp_jacobi_plane_plan=plan("plane"), stp_jacobi_slab_plan=plan("slab"),
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


def _plane_args(n, X, Y, Z, seed):
    gs = (40, Y, Z + 3)
    blocks = torch.from_numpy(_rand((n, X, Y, Z), seed))
    org = torch.tensor([[(13 * b + 9) % 40, b, 2 * b] for b in range(n)], dtype=torch.int32)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y - 2, Z - 2), gs) for o in org])
    return blocks, org, d2, gs


def _slab_args(n, X, Y, Z, seed):
    gs = (40, Y + 1, Z + 2)
    block = torch.from_numpy(_rand((n, X, Y, Z), seed))
    faces = [torch.from_numpy(_rand((n,) + s, seed + 1 + i))
             for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = torch.tensor([[(13 * b + 9) % 40, b, 2 * b] for b in range(n)], dtype=torch.int32)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y, Z), gs) for o in org])
    return block, faces, org, d2, gs


@pytest.mark.parametrize("shape", [(1, 3, 3, 3), (2, 7, 9, 11), (8, 6, 34, 66)])
def test_plane_launch_passes_the_arguments_in_order(on_card, shape):
    n, X, Y, Z = shape
    blocks, org, d2, gs = _plane_args(n, X, Y, Z, 1)
    c = on_card.to_card
    card_in, card_org, card_d2 = c(blocks), c(org), c(d2)
    before = jk.jacobi_plane_step.launches
    got = jk.jacobi_plane_step(card_in, card_org, card_d2, gs)
    assert jk.jacobi_plane_step.launches == before + 1 and len(on_card.calls) == 1
    name, args = on_card.calls[0]
    assert name == "plane"
    assert args[:4] == (card_in.data_ptr(), got.data_ptr(), card_org.data_ptr(), card_d2.data_ptr())
    assert args[4:] == (n, X, Y, Z, gs[0], *jk.sphere_params(gs[0]), 7000)
    assert got.data_ptr() != card_in.data_ptr() and got.shape == blocks.shape
    assert torch.equal(card_in.as_subclass(torch.Tensor), blocks)
    assert torch.equal(got.as_subclass(torch.Tensor), jk.jacobi_plane_step_plain(blocks, org, d2, gs))
    # out= receives the result
    out = c(torch.zeros_like(blocks))
    assert jk.jacobi_plane_step(card_in, card_org, card_d2, gs, out=out) is out
    assert on_card.calls[1][1][1] == out.data_ptr()


@pytest.mark.parametrize("shape", [(1, 2, 1, 1), (3, 7, 33, 70), (8, 4, 31, 63)])
def test_slab_launch_passes_the_arguments_in_order(on_card, shape):
    n, X, Y, Z = shape
    block, faces, org, d2, gs = _slab_args(n, X, Y, Z, 2)
    c = on_card.to_card
    card_in, card_faces, card_org, card_d2 = c(block), [c(f) for f in faces], c(org), c(d2)
    before = jk.jacobi_slab_step.launches
    got = jk.jacobi_slab_step(card_in, *card_faces, card_org, card_d2, gs)
    assert jk.jacobi_slab_step.launches == before + 1 and len(on_card.calls) == 1
    name, args = on_card.calls[0]
    assert name == "slab"
    assert args[:10] == (card_in.data_ptr(), got.data_ptr(), *(f.data_ptr() for f in card_faces),
                         card_org.data_ptr(), card_d2.data_ptr())
    assert args[10:] == (n, X, Y, Z, gs[0], *jk.sphere_params(gs[0]), 7000)
    assert got.data_ptr() != card_in.data_ptr() and got.shape == block.shape
    assert torch.equal(card_in.as_subclass(torch.Tensor), block)
    assert torch.equal(got.as_subclass(torch.Tensor), jk.jacobi_slab_step_plain(block, *faces, org, d2, gs))


def test_library_is_looked_up_once_over_many_calls(on_card):
    c = on_card.to_card
    before = (jk.jacobi_plane_step.launches, jk.jacobi_slab_step.launches)
    for seed in range(3):
        blocks, org, d2, gs = _plane_args(2, 5, 6, 7, seed)
        jk.jacobi_plane_step(c(blocks), c(org), c(d2), gs)
        block, faces, org, d2, gs = _slab_args(2, 5, 6, 7, seed)
        jk.jacobi_slab_step(c(block), *(c(f) for f in faces), c(org), c(d2), gs)
    jk.jacobi_plane_launch((8, 258, 258, 258))
    jk.jacobi_slab_launch((8, 256, 256, 256))
    assert on_card.loads == ["jacobi_wavefront"]
    assert [name for name, _ in on_card.calls] == ["plane", "slab"] * 3
    assert {args[-1] for _, args in on_card.calls} == {7000}
    assert (jk.jacobi_plane_step.launches, jk.jacobi_slab_step.launches) == (before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("rc,match", [(2, "launch failed \\(2\\): stand-in error"), (-1, "unsupported argument")])
@pytest.mark.parametrize("kernel", ["plane", "slab"])
def test_a_failed_launch_raises_with_no_fallback(on_card, rc, match, kernel):
    c = on_card.to_card
    on_card.rc = rc
    if kernel == "plane":
        blocks, org, d2, gs = _plane_args(2, 5, 6, 7, 3)
        fn, call = jk.jacobi_plane_step, lambda: jk.jacobi_plane_step(c(blocks), c(org), c(d2), gs)
    else:
        block, faces, org, d2, gs = _slab_args(2, 5, 6, 7, 3)
        fn, call = jk.jacobi_slab_step, lambda: jk.jacobi_slab_step(c(block), *(c(f) for f in faces), c(org), c(d2), gs)
    before = fn.launches
    with pytest.raises(RuntimeError, match=match):
        call()
    assert fn.launches == before and len(on_card.calls) == 1


def test_refusals_raise_before_the_launch(on_card):
    c = on_card.to_card
    blocks, org, d2, gs = _plane_args(1, 5, 6, 7, 4)
    with pytest.raises(ValueError, match="yz_d2 shape"):
        jk.jacobi_plane_step(c(blocks), c(org), c(torch.zeros(1, 6, 7, dtype=torch.int32)), gs)
    with pytest.raises(ValueError, match=">= 3 cells"):
        jk.jacobi_plane_step(c(blocks[:, :2].contiguous()), c(org), c(d2), gs)
    with pytest.raises(ValueError, match="separate tensor"):
        card_in = c(blocks)
        jk.jacobi_plane_step(card_in, c(org), c(d2), gs, out=card_in)
    block, faces, org, d2, gs = _slab_args(1, 1, 6, 7, 5)
    with pytest.raises(ValueError, match="X >= 2"):
        jk.jacobi_slab_step(c(block), *(c(f) for f in faces), c(org), c(d2), gs)
    block, faces, org, d2, gs = _slab_args(1, 3, 6, 7, 5)
    with pytest.raises(ValueError, match="zlo shape"):
        jk.jacobi_slab_step(c(block), *(c(f) for f in faces[:4]), c(faces[4].transpose(1, 2).contiguous()),
                            c(faces[5]), c(org), c(d2), gs)
    assert on_card.calls == [] and on_card.loads == []


@pytest.mark.parametrize("which", ["plane", "slab"])
def test_plan_entry_gets_its_arguments_and_names_its_fields(on_card, which):
    launch = jk.jacobi_plane_launch if which == "plane" else jk.jacobi_slab_launch
    plan = launch((8, 258, 258, 258))
    launch((5, 6, 7))  # one block
    assert on_card.plans == [(which, (8, 258, 258, 258)), (which, (1, 5, 6, 7))]
    assert list(plan)[: len(jk.ONELEVEL_PLAN_FIELDS)] == list(jk.ONELEVEL_PLAN_FIELDS)
    assert plan["xchunk"] == 16 and plan["tiles_y"] == 9 and plan["smem_bytes"] == 16928
    assert plan["waves"] == 5760 / (4 * 132)
    on_card.rc = -1
    with pytest.raises(RuntimeError, match="unsupported argument"):
        launch((8, 258, 258, 258))


# --- the wrappers on CPU tensors: the plain versions, equal to Pallas interpret ----


@pytest.mark.parametrize("shape,origin", [((3, 3, 3), (0, 0, 0)), ((9, 7, 12), (11, 2, 5)),
                                          ((12, 10, 14), (8, 3, 14))])
def test_plane_wrapper_on_cpu_equals_pallas_interpret(shape, origin):
    """Both spheres cross the (12, 10, 14) block; the (3, 3, 3) block has
    one interior cell."""
    X, Y, Z = shape
    gs = (30, 12, 40)
    block = _rand(shape, 70 + X)
    org = np.asarray(origin, np.int32)
    d2 = jk.yz_dist2_plane(origin[1], origin[2], (Y - 2, Z - 2), gs)
    want = np.asarray(jp.jacobi_plane_step(jnp.asarray(block), jnp.asarray(org), jnp.asarray(d2.numpy()), gs,
                                           interpret=True))
    before = jk.jacobi_plane_step.launches
    got = jk.jacobi_plane_step(torch.from_numpy(block), torch.from_numpy(org), d2, gs).numpy()
    assert jk.jacobi_plane_step.launches == before
    if X == 12:
        assert (got == jk.HOT_TEMP).any() and (got == jk.COLD_TEMP).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,origin", [((2, 3, 5), (0, 0, 0)), ((2, 1, 1), (7, 0, 0)),
                                          ((10, 9, 11), (8, 1, 4))])
def test_slab_wrapper_on_cpu_equals_pallas_interpret(shape, origin):
    """X = 2 (the contract's least), a one-cell plane, and a block both
    spheres cross; random face slabs (the JAX kernel takes z slabs (Y, X))."""
    X, Y, Z = shape
    gs = (30, 10, 15)
    block = _rand(shape, 80 + X)
    slabs = [_rand(s, 81 + i) for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = np.asarray(origin, np.int32)
    d2 = jk.yz_dist2_plane(origin[1], origin[2], (Y, Z), gs)
    jslabs = [jnp.asarray(s) for s in slabs[:4]] + [jnp.asarray(s.T) for s in slabs[4:]]
    want = np.asarray(jp.jacobi_slab_step(jnp.asarray(block), *jslabs, jnp.asarray(org), jnp.asarray(d2.numpy()),
                                          gs, interpret=True))
    before = jk.jacobi_slab_step.launches
    got = jk.jacobi_slab_step(torch.from_numpy(block), *(torch.from_numpy(s) for s in slabs),
                              torch.from_numpy(org), d2, gs).numpy()
    assert jk.jacobi_slab_step.launches == before
    if X == 10:
        assert (got == jk.HOT_TEMP).any() and (got == jk.COLD_TEMP).any()
    np.testing.assert_array_equal(got, want)


# --- bf16 storage: the plane and slab forms' bf16 build ------------------------------


def _tview(ptr: int, shape, dtype) -> torch.Tensor:
    """A writable tensor of ``dtype`` over ``shape`` at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).view(shape)


@pytest.fixture
def bf16_card(monkeypatch):
    """Stand-in plane and slab entries in every build: each records the
    build it was looked up in and writes the bf16 plain version."""
    card = types.SimpleNamespace(calls=[], loads=[])

    def load(name):
        card.loads.append(name)
        bf = torch.bfloat16

        def plane(in_p, out_p, org_p, d2_p, n, X, Y, Z, gx, hot_x, cold_x, in_r2, stream):
            card.calls.append((name, "plane", stream))
            want = jk.jacobi_plane_step_plain(_tview(in_p, (n, X, Y, Z), bf).clone(),
                                              _tview(org_p, (n, 3), torch.int32).clone(),
                                              _tview(d2_p, (n, Y - 2, Z - 2), torch.int32).clone(), (gx, 1, 1),
                                              f32_accumulate=True)
            _tview(out_p, (n, X, Y, Z), bf).copy_(want)
            return 0

        def slab(in_p, out_p, xlo, xhi, ylo, yhi, zlo, zhi, org_p, d2_p, n, X, Y, Z, gx, hot_x, cold_x, in_r2,
                 stream):
            card.calls.append((name, "slab", stream))
            faces = [_tview(p, (n,) + s, bf).clone() for p, s in zip(
                (xlo, xhi, ylo, yhi, zlo, zhi), ((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
            want = jk.jacobi_slab_step_plain(_tview(in_p, (n, X, Y, Z), bf).clone(), *faces,
                                             _tview(org_p, (n, 3), torch.int32).clone(),
                                             _tview(d2_p, (n, Y, Z), torch.int32).clone(), (gx, 1, 1),
                                             f32_accumulate=True)
            _tview(out_p, (n, X, Y, Z), bf).copy_(want)
            return 0

        return types.SimpleNamespace(stp_jacobi_plane=plane, stp_jacobi_slab=slab, stp_jacobi_wavefront=None,
                                     stp_error_string=lambda code: b"stand-in error")

    monkeypatch.setattr(build, "load", load)
    for cache, value in (("_ENTRY", None), ("_ENTRIES", {}), ("_VARIANTS", {})):
        monkeypatch.setattr(jk, cache, value)
    monkeypatch.setattr(jk, "current_raw_stream", lambda index: 7000 + index)
    return card


@pytest.mark.parametrize("which", ["plane", "slab"])
def test_bf16_blocks_launch_the_bf16_build(bf16_card, which):
    """A bfloat16 block under ``f32_accumulate`` takes the bf16 build, counts
    under ``bf16_launches`` alone and returns the bf16 plain result; the
    f32 build is never looked up."""
    c = lambda t: t.clone().as_subclass(_OnCard)  # noqa: E731
    wrapper = jk.jacobi_plane_step if which == "plane" else jk.jacobi_slab_step
    before = {k: getattr(wrapper, k) for k in jk.STORAGE_COUNTERS}
    if which == "plane":
        blocks, org, d2, gs = _plane_args(2, 6, 9, 11, 5)
        blocks = blocks.to(torch.bfloat16)
        got = wrapper(c(blocks), c(org), c(d2), gs, f32_accumulate=True)
        want = jk.jacobi_plane_step_plain(blocks, org, d2, gs, f32_accumulate=True)
    else:
        block, faces, org, d2, gs = _slab_args(2, 6, 9, 11, 5)
        block, faces = block.to(torch.bfloat16), [f.to(torch.bfloat16) for f in faces]
        got = wrapper(c(block), *map(c, faces), c(org), c(d2), gs, f32_accumulate=True)
        want = jk.jacobi_slab_step_plain(block, *faces, org, d2, gs, f32_accumulate=True)
    assert bf16_card.loads == ["jacobi_wavefront_bf16"] and bf16_card.calls == [("jacobi_wavefront_bf16", which,
                                                                                   7000)]
    after = {k: getattr(wrapper, k) for k in jk.STORAGE_COUNTERS}
    assert after["bf16_launches"] == before["bf16_launches"] + 1 and after["launches"] == before["launches"]
    assert got.dtype == torch.bfloat16 and torch.equal(got.as_subclass(torch.Tensor), want)
    with pytest.raises(TypeError, match="f32_accumulate"):
        jk.jacobi_plane_step(c(torch.zeros(2, 5, 5, 5, dtype=torch.bfloat16)), c(org), c(d2[:, :3, :3]), gs)


def test_onelevel_plans_report_the_storage(on_card):
    plan = jk.jacobi_plane_launch((8, 258, 258, 258), storage="bf16")
    assert on_card.loads == ["jacobi_wavefront_bf16"] and plan["storage"] == "bf16"
    assert jk.jacobi_slab_launch((8, 256, 256, 256))["storage"] == "native"
