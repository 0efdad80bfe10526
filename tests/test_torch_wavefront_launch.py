"""The launch path of the Jacobi wavefront wrappers
(``jacobi_shell_wavefront_step``, ``jacobi_zring_wavefront_step`` in
``stencil_tpu_torch/ops/jacobi_kernels.py``), on the CPU.

* the C entry ``stp_jacobi_wavefront`` gets its arguments in its order, the
  stream from ``current_raw_stream`` and, where m needs two marches, a
  scratch buffer;
* the library is looked up once over many calls;
* a nonzero return code raises, with no fallback to the plain version, and
  counts no launch; ``launches`` counts one a call;
* ``jacobi_wavefront_launch`` passes the plan entry its arguments and names
  its fields;
* on CPU tensors the wrappers run the plain versions, bitwise equal to the
  JAX package's Pallas kernels in interpret mode, and count no launch.

The launch path runs here on tensors that report a CUDA device, with a
Python stand-in for the C entry that reads the tensors at the addresses it is
given and writes the plain version's result, as the kernel does.  The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import ctypes
import warnings
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


def _view(ptr: int, dtype, shape) -> torch.Tensor:
    """A writable tensor over ``shape`` elements of ``dtype`` at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return torch.from_numpy(np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).reshape(shape))


def _stand_in(raw_p, out_p, org_p, d2_p, zs_p, zout_p, scratch_p, n, Xr, Yr, Zraw, W, m, s, d2_w, gx, hot_x,
              cold_x, in_r2, ring, stream):
    """What the kernel computes, from the arguments in the C entry's order:
    the plain version over the tensors at those addresses, into ``out`` and
    ``zout``."""
    assert (hot_x, cold_x, in_r2) == jk.sphere_params(gx)
    raw = _view(raw_p, np.float32, (n, Xr, Yr, Zraw))
    org = _view(org_p, np.int32, (n, 3))
    d2 = _view(d2_p, np.int32, (n, Yr, d2_w))
    zs = None if zs_p is None else _view(zs_p, np.float32, (n, Xr, 2 * s, Yr))
    gs = (gx, 1, 1)  # the levels read the x extent only; d2 carries y and z
    if ring:
        assert W == Zraw + 2 * s and d2_w == jk._ZRING_OFF + Zraw
        out, zout = jk.jacobi_zring_wavefront_step_plain(raw, m, org, d2, gs, zs, interior_offset=s)
    else:
        assert d2_w == Zraw
        res = jk.jacobi_shell_wavefront_step_plain(raw, m, org, d2, gs, interior_offset=s, z_slabs=zs, z_valid=W)
        out, zout = res if zs is not None else (res, None)
    _view(out_p, np.float32, (n, Xr, Yr, Zraw)).copy_(out)
    if zout is not None:
        _view(zout_p, np.float32, (n, Xr, 2 * s, Yr)).copy_(zout)
    return 0


@pytest.fixture
def on_card(monkeypatch):
    """Route the wavefront wrappers through their launch path on host
    memory: a fixed raw stream, a stand-in library whose entry records its
    arguments and runs ``_stand_in`` (or returns ``card.rc`` when set), and
    a count of library lookups."""
    card = types.SimpleNamespace(calls=[], loads=[], plans=[], rc=0,
                                 to_card=lambda t: t.clone().as_subclass(_OnCard))

    def entry(*args):
        card.calls.append(args)
        return card.rc if card.rc else _stand_in(*args)

    def plan(*args):
        card.plans.append(args[:-1])
        ring, slabs = args[-3:-1]
        form = 0 if ring else (1 if slabs else 2)
        for j, v in enumerate((form, 2, 4, 2, 132, 1320, 88, 3, 66080, 512, 5, 11)):
            args[-1][j] = v
        return card.rc

    lib = types.SimpleNamespace(stp_jacobi_wavefront=entry, stp_jacobi_wavefront_plan=plan,
                                stp_error_string=lambda code: b"stand-in error")

    def load(name):
        card.loads.append(name)
        return lib

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(jk, "_ENTRY", None)
    monkeypatch.setattr(jk, "_VARIANTS", {})  # the other builds' cache
    monkeypatch.setattr(jk, "current_raw_stream", lambda index: 7000 + index)
    return card


def _case(n, m, s_off, form, seed=0):
    """Seeded arguments of one wavefront call (``form``: "ring", "slabs" or
    "shell"); n = 1 gives single blocks (3-D tensors)."""
    Xr, Yr, Z = 2 * s_off + 7, 2 * s_off + 9, 2 * s_off + 11
    gs = (2 * s_off + 5, Yr - 2 * s_off, Z if form == "ring" else Z - 2 * s_off - 1)
    lead = () if n == 1 else (n,)
    raw = torch.from_numpy(_rand(lead + (Xr, Yr, Z), seed))
    org = torch.tensor([[(3 * b) % gs[0], b, 2 * b] for b in range(n)], dtype=torch.int32)
    if form == "ring":
        d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s_off, int(o[2]), s_off, Yr, Z, gs) for o in org])
    else:
        d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s_off, int(o[2]) - s_off, (Yr, Z), gs) for o in org])
    zs = torch.from_numpy(_rand(lead + (Xr, 2 * s_off, Yr), seed + 1)) if form != "shell" else None
    if n == 1:
        org, d2 = org[0], d2[0]
    return raw, org, d2, zs, gs


def _call(fn_kind, raw, m, org, d2, gs, zs, s_off, z_valid=None):
    if fn_kind == "ring":
        return jk.jacobi_zring_wavefront_step(raw, m, org, d2, gs, zs, interior_offset=s_off)
    return jk.jacobi_shell_wavefront_step(raw, m, org, d2, gs, interior_offset=s_off, z_slabs=zs, z_valid=z_valid)


@pytest.mark.parametrize("form", ["ring", "slabs", "shell"])
@pytest.mark.parametrize("n,m,s_off", [(1, 2, 2), (3, 3, 4), (1, 6, 6), (3, 8, 9)])
def test_launch_path_passes_the_arguments_in_order(on_card, form, n, m, s_off):
    raw, org, d2, zs, gs = _case(n, m, s_off, form, seed=n + m)
    zv = None if form == "ring" else raw.shape[-1] - 1
    fn = jk.jacobi_zring_wavefront_step if form == "ring" else jk.jacobi_shell_wavefront_step
    before = fn.launches
    c = on_card.to_card
    card_in = [c(raw), c(org), c(d2), None if zs is None else c(zs)]
    got = _call(form, card_in[0], m, card_in[1], card_in[2], gs, card_in[3], s_off, zv)
    want = _call(form, raw, m, org, d2, gs, zs, s_off, zv)
    assert fn.launches == before + 1 and len(on_card.calls) == 1
    args = on_card.calls[0]
    nb = 1 if raw.dim() == 3 else raw.shape[0]
    Xr, Yr, Z = raw.shape[-3:]
    W = Z + 2 * s_off if form == "ring" else zv
    d2_w = jk._ZRING_OFF + Z if form == "ring" else Z
    hot_x, cold_x, in_r2 = jk.sphere_params(gs[0])
    assert args[7:] == (nb, Xr, Yr, Z, W, m, s_off, d2_w, gs[0], hot_x, cold_x, in_r2, int(form == "ring"), 7000)
    outs = [got, None] if form == "shell" else list(got)
    want_ptrs = [t.data_ptr() for t in card_in[:3]] + [None if t is None else t.data_ptr() for t in card_in[3:]]
    assert [args[0], args[2], args[3], args[4]] == want_ptrs
    assert [args[1], args[5]] == [None if t is None else t.data_ptr() for t in outs]
    # a scratch buffer exactly where m needs two marches
    assert (args[6] is not None) == (jk.wavefront_marches(m) == 2)
    S = slice(s_off, -s_off)
    zsl = slice(None) if form == "ring" else slice(s_off, zv - s_off)
    if form == "shell":
        got, want = (got, None), (want, None)
    gv = got[0].as_subclass(torch.Tensor)
    assert torch.equal(gv[..., S, S, zsl], want[0][..., S, S, zsl])
    if zs is not None:
        assert torch.equal(got[1].as_subclass(torch.Tensor)[..., S, :, S], want[1][..., S, :, S])


def test_library_is_looked_up_once_over_many_calls(on_card):
    raw, org, d2, zs, gs = _case(3, 2, 2, "ring")
    c = on_card.to_card
    before = jk.jacobi_zring_wavefront_step.launches
    for _ in range(5):
        jk.jacobi_zring_wavefront_step(c(raw), 2, c(org), c(d2), gs, c(zs))
    raw, org, d2, zs, gs = _case(3, 5, 5, "slabs")
    for _ in range(3):
        jk.jacobi_shell_wavefront_step(c(raw), 5, c(org), c(d2), gs, z_slabs=c(zs))
    assert on_card.loads == ["jacobi_wavefront"]
    assert len(on_card.calls) == 8 and {a[-1] for a in on_card.calls} == {7000}
    assert jk.jacobi_zring_wavefront_step.launches == before + 5


@pytest.mark.parametrize("rc,match", [(2, "launch failed \\(2\\): stand-in error"),
                                      (-1, "unsupported argument")])
@pytest.mark.parametrize("form", ["ring", "slabs", "shell"])
def test_a_failed_launch_raises_with_no_fallback(on_card, rc, match, form):
    raw, org, d2, zs, gs = _case(3, 8, 8, form)
    c = on_card.to_card
    fn = jk.jacobi_zring_wavefront_step if form == "ring" else jk.jacobi_shell_wavefront_step
    before = fn.launches
    on_card.rc = rc
    with pytest.raises(RuntimeError, match=match):
        _call(form, c(raw), 8, c(org), c(d2), gs, None if zs is None else c(zs), 8)
    assert fn.launches == before and len(on_card.calls) == 1


def test_refusals_raise_before_the_launch(on_card):
    raw, org, d2, zs, gs = _case(3, 2, 2, "ring")
    c = on_card.to_card
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jk.jacobi_zring_wavefront_step(c(raw), 2, c(org), c(d2), gs, c(zs), alias=True)
    with pytest.raises(ValueError, match="different devices"):
        jk.jacobi_zring_wavefront_step(c(raw), 2, org, c(d2), gs, c(zs))
    with pytest.raises(ValueError, match="shared memory"):
        jk.jacobi_shell_wavefront_step(c(torch.zeros(3, 30, 30, 30)), 9, c(org),
                                       c(torch.zeros(3, 30, 30, dtype=torch.int32)), (40, 30, 30))
    assert on_card.calls == [] and on_card.loads == []


@pytest.mark.parametrize("m,marches", [(1, 1), (3, 1), (4, 1), (5, 2), (6, 2), (8, 2)])
def test_marches_of_a_call(m, marches):
    assert jk.wavefront_marches(m) == marches
    # every depth the plan can pick fits the plan's shared-memory model
    assert jk.wavefront_smem_fits(m)


@pytest.mark.parametrize("ring,slabs,form", [(True, True, "z-ring"), (False, True, "shell z-slab"),
                                             (False, False, "shell")])
def test_plan_entry_gets_its_arguments_and_names_its_fields(on_card, ring, slabs, form):
    on_card.loads.clear()
    plan = jk.jacobi_wavefront_launch((8, 272, 272, 256 if ring else 272), 8, ring=ring, slabs=slabs,
                                      z_valid=None if ring else 270)
    width = 256 + 16 if ring else 270
    assert on_card.plans == [(8, 272, 272, 256 if ring else 272, width, 8, 8, int(ring), int(slabs))]
    assert list(plan)[: len(jk.WAVEFRONT_PLAN_FIELDS)] == list(jk.WAVEFRONT_PLAN_FIELDS)
    assert plan["form"] == form and plan["launches"] == 2 and plan["smem_bytes"] == 66080
    assert plan["waves"] == 1320 / (2 * 132)
    on_card.rc = -1
    with pytest.raises(RuntimeError, match="unsupported argument"):
        jk.jacobi_wavefront_launch((272, 272, 256), 8, ring=True)


# --- the wrappers on CPU tensors: the plain versions, equal to Pallas interpret -------


@pytest.mark.parametrize("m,s_off,slabs", [(1, 1, True), (2, 3, False), (3, 3, True)])
def test_shell_wrapper_on_cpu_equals_pallas_interpret(m, s_off, slabs):
    Xr, Yr, Zr = 11, 12, 15
    gs = (2 * s_off + 5, Yr - 2 * s_off, Zr - 2 * s_off - 1)
    raw = _rand((Xr, Yr, Zr), 40 + m)
    origin = np.array([1, 2, 3], np.int32)
    d2 = jk.yz_dist2_plane(origin[1] - s_off, origin[2] - s_off, (Yr, Zr), gs)
    zs = _rand((Xr, 2 * s_off, Yr), 41) if slabs else None
    before = jk.jacobi_shell_wavefront_step.launches
    got = jk.jacobi_shell_wavefront_step(
        torch.from_numpy(raw), m, torch.from_numpy(origin), d2, gs, interior_offset=s_off,
        z_slabs=None if zs is None else torch.from_numpy(zs), z_valid=Zr - 1)
    want = jp.jacobi_shell_wavefront_step(
        jnp.asarray(raw), m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs, interior_offset=s_off,
        interpret=True, alias=False, z_slabs=None if zs is None else jnp.asarray(zs), z_valid=Zr - 1)
    assert jk.jacobi_shell_wavefront_step.launches == before
    if not slabs:
        got, want = (got,), (want,)
    S, zsl = slice(s_off, -s_off), slice(s_off, Zr - 1 - s_off)
    np.testing.assert_array_equal(got[0].numpy()[S, S, zsl], np.asarray(want[0])[S, S, zsl])
    if slabs:
        np.testing.assert_array_equal(got[1].numpy()[S, :, S], np.asarray(want[1])[S, :, S])


@pytest.mark.parametrize("m,s_off", [(1, 2), (2, 2), (3, 4)])
def test_zring_wrapper_on_cpu_equals_pallas_interpret(m, s_off):
    Xr, Yr, Zi = 2 * s_off + 6, 2 * s_off + 7, 128
    gs = (2 * s_off + 5, Yr - 2 * s_off, Zi)
    raw = _rand((Xr, Yr, Zi), 50 + m)
    origin = np.array([2, 1, 0], np.int32)
    d2 = jk.zring_dist2_plane(origin[1] - s_off, origin[2], s_off, Yr, Zi, gs)
    zs = _rand((Xr, 2 * s_off, Yr), 51)
    before = jk.jacobi_zring_wavefront_step.launches
    got = jk.jacobi_zring_wavefront_step(torch.from_numpy(raw), m, torch.from_numpy(origin), d2, gs,
                                         torch.from_numpy(zs), interior_offset=s_off)
    want = jp.jacobi_zring_wavefront_step(jnp.asarray(raw), m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
                                          z_slabs=jnp.asarray(zs), interior_offset=s_off, interpret=True)
    assert jk.jacobi_zring_wavefront_step.launches == before
    S = slice(s_off, -s_off)
    # both spheres reach this block, so the clamp is held too
    assert (got[0][S, S] == jk.HOT_TEMP).any() and (got[0][S, S] == jk.COLD_TEMP).any()
    np.testing.assert_array_equal(got[0].numpy()[S, S], np.asarray(want[0])[S, S])
    np.testing.assert_array_equal(got[1].numpy()[S, :, S], np.asarray(want[1])[S, :, S])


# --- the kernel axes: each form launches its own build -------------------------------


def _tview(ptr: int, shape, dtype) -> torch.Tensor:
    """A writable tensor of ``dtype`` over ``shape`` at host address ``ptr``."""
    nbytes = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).view(shape)


@pytest.fixture
def axis_card(monkeypatch):
    """A stand-in ``stp_jacobi_wavefront`` in every build: it records its
    arguments and the build it was looked up in, and writes the plain
    version of the form at the outputs' addresses."""
    card = types.SimpleNamespace(calls=[], loads=[], form=None)

    def load(name):
        card.loads.append(name)

        def entry(raw_p, out_p, org_p, d2_p, zs_p, zout_p, scratch_p, n, Xr, Yr, Zraw, W, m, s, d2_w, gx,
                  hot_x, cold_x, in_r2, ring, stream):
            unit, mi, bf16 = card.form
            card.calls.append((name, scratch_p is not None, n, Xr, Yr, Zraw, W, m, s, ring, stream))
            dt = torch.bfloat16 if bf16 else torch.float32
            raw = _tview(raw_p, (n, Xr, Yr, Zraw), dt).clone()
            org = _tview(org_p, (n, 3), torch.int32).clone()
            d2 = _tview(d2_p, (n, Yr, d2_w), torch.int32).clone()
            zs = _tview(zs_p, (n, Xr, 2 * s, Yr), dt).clone()
            kw = dict(compute_unit=unit, mxu_input=mi, f32_accumulate=bf16, interior_offset=s)
            if ring:
                out, zout = jk.jacobi_zring_wavefront_step_plain(raw, m, org, d2, (gx, 1, 1), zs, **kw)
            else:
                out, zout = jk.jacobi_shell_wavefront_step_plain(raw, m, org, d2, (gx, 1, 1), z_slabs=zs, z_valid=W,
                                                                 **kw)
            _tview(out_p, (n, Xr, Yr, Zraw), dt).copy_(out)
            _tview(zout_p, (n, Xr, 2 * s, Yr), dt).copy_(zout)
            return 0

        return types.SimpleNamespace(stp_jacobi_wavefront=entry, stp_error_string=lambda code: b"stand-in error")

    monkeypatch.setattr(build, "load", load)
    for cache, value in (("_ENTRY", None), ("_ENTRIES", {}), ("_VARIANTS", {})):
        monkeypatch.setattr(jk, cache, value)
    monkeypatch.setattr(jk, "current_raw_stream", lambda index: 7000 + index)
    return card


@pytest.mark.parametrize("unit,mi,bf16,lib,counter", [
    ("vpu", "f32", True, "jacobi_wavefront_bf16", "bf16_launches"),
    ("mxu_band", "f32", False, "jacobi_wavefront_mxu", "mxu_launches"),
    ("mxu", "bf16", True, "jacobi_wavefront_mxu16_bf16", "mxu_bf16in_launches")])
@pytest.mark.parametrize("m", [2, 6])
@pytest.mark.parametrize("form", ["ring", "slabs"])
def test_axis_form_launches_its_build(axis_card, form, m, unit, mi, bf16, lib, counter):
    """One lookup of the form's build, its counter alone moves, a scratch
    where m needs two marches, the form's plain result at its dtype."""
    axis_card.form = (unit, mi, bf16)
    raw, org, d2, zs, gs = _case(2, m, m, form, seed=m)
    if bf16:
        raw, zs = raw.to(torch.bfloat16), zs.to(torch.bfloat16)
    c = lambda t: t.clone().as_subclass(_OnCard)  # noqa: E731
    wrapper = jk.jacobi_zring_wavefront_step if form == "ring" else jk.jacobi_shell_wavefront_step
    before = {k: getattr(wrapper, k) for k in jk.CONTRACTION_COUNTERS}
    kw = dict(compute_unit=unit, mxu_input=mi, f32_accumulate=bf16, interior_offset=m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # a band on an untilable plane names the dense form
        if form == "ring":
            got = wrapper(c(raw), m, c(org), c(d2), gs, c(zs), **kw)
            want = jk.jacobi_zring_wavefront_step_plain(raw, m, org, d2, gs, zs, **kw)
        else:
            got = wrapper(c(raw), m, c(org), c(d2), gs, z_slabs=c(zs), **kw)
            want = jk.jacobi_shell_wavefront_step_plain(raw, m, org, d2, gs, z_slabs=zs, **kw)
    assert axis_card.loads == [lib] and len(axis_card.calls) == 1
    assert axis_card.calls[0][1] == (m > 4) and axis_card.calls[0][-1] == 7000
    after = {k: getattr(wrapper, k) for k in jk.CONTRACTION_COUNTERS}
    assert {k: after[k] - before[k] for k in after} == {k: int(k == counter) for k in after}
    S = slice(m, -m)
    for g, w in zip(got, want):
        assert g.dtype == raw.dtype
        assert torch.equal(g.as_subclass(torch.Tensor)[:, S], w[:, S])


def test_wavefront_plan_reports_the_build(on_card):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plan = jk.jacobi_wavefront_launch((8, 272, 272, 256), 8, ring=True, compute_unit="mxu_band",
                                          mxu_input="bf16", storage="bf16")
    assert on_card.loads == ["jacobi_wavefront_mxu16_bf16"]
    assert (plan["compute_unit"], plan["mxu_input"], plan["storage"]) == ("mxu_band", "bf16", "bf16")
    plan = jk.jacobi_wavefront_launch((8, 272, 272, 272), 8, slabs=True, storage="bf16")
    assert on_card.loads[-1] == "jacobi_wavefront_bf16" and plan["form"] == "shell z-slab"
    assert (plan["compute_unit"], plan["mxu_input"]) == ("vpu", "f32")
