"""The tensor-core contraction (``compute_unit`` ``mxu`` / ``mxu_band``,
``mxu_input`` ``f32`` / ``bf16``) under the fused halo and the split
schedule: the fused forms of #7 ``stream_plane_pass`` and #8
``stream_wavefront_pass``, and the split schedule's band passes, against the
JAX package's on the CPU.

The fused passes patch the level-0 blocks from the shell buffers before the
contraction reads their planes (``_fused_plane_patch``,
``stencil_tpu/ops/stream.py:239-259``); every pass of the JAX package takes
``**unit_kw``, the fused groups and the split schedule's narrow passes
included (``stencil_tpu/ops/stream.py:1595-1757``).  Tolerances, as
``tests/test_torch_stream_mxu.py`` states them: bitwise at depth 1 and on
the plane route; ``rtol=1e-6`` deeper (the FMA note of ROADMAP.md queue 3);
``bf16_storage_atol`` a pass and ``mxu_bf16_input_atol`` a level where they
apply.

Also pinned: split's interiors equal ``overlap="off"``'s bitwise under a
unit; each band pass resolves the unit on its own plane, where the port's
exactly ``3w``-wide window can run ``mxu`` and the JAX package's
granule-rounded one keeps ``mxu_band``; the band passes' traced kernels are
built with the step, which warns once; the fused forms' launch path and
their counters on stand-in C entries; ``AstarothSim`` and its command line under
each schedule that plans them.
"""

import ctypes
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.models.astaroth import AstarothSim as JAstaroth
from stencil_tpu.ops import stream as jst
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.kernels import build, ledger
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.ops import stream as st
from stencil_tpu_torch.ops.stream_trace import StreamKernel
from ulp import bf16_storage_atol, mxu_bf16_input_atol

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
AXES = [("mxu", "f32"), ("mxu", "bf16"), ("mxu_band", "f32"), ("mxu_band", "bf16")]
STORAGES = ("f32", "bf16")
#: the engine's cases: (unit, operands, bf16 storage)
ENGINE = [("mxu", "f32", False), ("mxu_band", "bf16", False), ("mxu", "bf16", True)]


def mean6_kernel(views, info):
    return {name: (src.sh(-1, 0, 0) + src.sh(0, -1, 0) + src.sh(0, 0, -1)
                   + src.sh(1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, 0, 1)) / 6.0
            for name, src in views.items()}


def mean6_kernel_mxu(views, info):
    return {name: (src.sh(-1, 0, 0) + src.sh(1, 0, 0) + src.plane_nbr_sum()) / 6.0
            for name, src in views.items()}


def off_kernel_mxu(views, info):
    """Reads x-1 off the centre (the wavefront's general form) and a
    diagonal in-plane tap beside the contraction."""
    u = views["u"]
    return {"u": u.sh(-1, 1, 0) * 0.25 + u.sh(1, 0, -1) * 0.25 + u.plane_nbr_sum() * 0.125}


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape) - 0.5


def _pair(a, storage):
    t = torch.from_numpy(np.ascontiguousarray(a)).float()
    j = jnp.asarray(a, dtype=jnp.float32)
    if storage == "bf16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _same(got, want, storage, exact, passes=1, mi="f32", levels=1):
    g, w = _np(got), _np(want)
    scale = float(np.abs(w).max()) or 1.0
    if exact:
        np.testing.assert_array_equal(g, w)
    elif storage == "bf16" or mi == "bf16":
        bound = (bf16_storage_atol(passes, scale) if storage == "bf16" else 0.0) + (
            mxu_bf16_input_atol(levels, scale) if mi == "bf16" else 0.0)
        assert np.abs(g - w).max() <= bound
    else:
        np.testing.assert_allclose(g, w, **TOL)


def _jax_axes(unit, mi, storage):
    return dict(interpret=True, compute_unit=unit, mxu_input=mi, f32_accumulate=storage == "bf16")


def _fused_inputs(X, Y, Z, lo, hi, nf, seed, storage):
    """One block's fused buffers per field, ``(xbufs, ybufs, zbufs)``, in the
    port's layouts and the JAX package's."""
    shapes = ((lo.x + hi.x, Y, Z), (lo.y + hi.y, X, Z), (lo.z + hi.z, Y, X))
    perms = ((0, 1, 2), (1, 0, 2), (2, 0, 1))  # the JAX package's y rows (X, 2s, Z), z columns (X, 2s, Y)
    port, jax_ = [], []
    for j, (shape, perm) in enumerate(zip(shapes, perms)):
        pairs = [_pair(_rand(shape, seed + 10 * j + q), storage) for q in range(nf)]
        port.append([p[0] for p in pairs])
        jax_.append([jnp.transpose(p[1], perm) for p in pairs])
    return tuple(port), tuple(jax_)


# --- the fused passes' plain versions against the JAX passes ------------------------------


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("unit,mi", AXES)
def test_plane_fused_plain_vs_pallas(storage, unit, mi):
    """Bitwise, the shell passed through from the buffers included."""
    lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
    X, Y, Z = 9, 16, 12
    gs = (20, 30, 40)
    pairs = [_pair(_rand((X, Y, Z), 21 + q), storage) for q in range(2)]
    pfs, jfs = _fused_inputs(X, Y, Z, lo, hi, 2, 100, storage)
    origin = np.array([3, 5, 7], np.int32)
    got = st.stream_plane_pass_plain(mean6_kernel_mxu, ["a", "b"], [p[0] for p in pairs], lo, hi, 1,
                                     torch.from_numpy(origin), gs, fused_shell=pfs, compute_unit=unit, mxu_input=mi)
    want = jst.stream_plane_pass(mean6_kernel_mxu, ["a", "b"], [p[1] for p in pairs], JDim3(*lo), JDim3(*hi), 1,
                                 jnp.asarray(origin), JDim3(*gs), fused_shell=jfs, **_jax_axes(unit, mi, storage))
    for g, w in zip(got, want):
        assert g.dtype == pairs[0][0].dtype
        _same(g, w, storage, exact=True)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("unit,mi", AXES)
@pytest.mark.parametrize("m", [1, 3])
def test_wavefront_fused_plain_vs_pallas(storage, unit, mi, m):
    """The queue-form kernel over a fused block, depth 1 and 3."""
    s = 3
    Xr, Yr, Zr = 11, 16, 24
    s3 = Dim3(s, s, s)
    gs = (20, 30, 40)
    pairs = [_pair(_rand((Xr, Yr, Zr), 51 + q), storage) for q in range(2)]
    pfs, jfs = _fused_inputs(Xr, Yr, Zr, s3, s3, 2, 200, storage)
    origin = np.array([4, 2, 9], np.int32)
    got, gz = st.stream_wavefront_pass_plain(mean6_kernel_mxu, ["a", "b"], [p[0] for p in pairs], m, s,
                                             torch.from_numpy(origin), gs, fused_shell=pfs, compute_unit=unit,
                                             mxu_input=mi)
    want, _ = jst.stream_wavefront_pass(mean6_kernel_mxu, ["a", "b"], [p[1] for p in pairs], m, s,
                                        jnp.asarray(origin), JDim3(*gs), fused_shell=jfs,
                                        **_jax_axes(unit, mi, storage))
    assert gz is None
    S = slice(s, -s)
    for g, w in zip(got, want):
        _same(g[S, S, S], np.asarray(w)[S, S, S], storage, exact=m == 1, mi=mi, levels=m)


@pytest.mark.parametrize("unit,mi", [("mxu", "f32"), ("mxu_band", "bf16")])
def test_general_form_fused_plain_vs_pallas(unit, mi):
    """A kernel with off-centre x reads and in-plane diagonals beside the
    contraction, fused, at depth 2 (the wavefront's general form) and on
    the plane pass."""
    s = 2
    s2 = Dim3(s, s, s)
    X, Y, Z = 10, 16, 24
    gs = (20, 30, 40)
    t, j = _pair(_rand((X, Y, Z), 301), "f32")
    pfs, jfs = _fused_inputs(X, Y, Z, s2, s2, 1, 310, "f32")
    origin = np.array([1, 2, 3], np.int32)
    axes = dict(compute_unit=unit, mxu_input=mi)
    got, _ = st.stream_wavefront_pass_plain(off_kernel_mxu, ["u"], [t], 2, s, torch.from_numpy(origin), gs,
                                            fused_shell=pfs, **axes)
    want, _ = jst.stream_wavefront_pass(off_kernel_mxu, ["u"], [j], 2, s, jnp.asarray(origin), JDim3(*gs),
                                        fused_shell=jfs, **_jax_axes(unit, mi, "f32"))
    S = slice(s, -s)
    _same(got[0][S, S, S], np.asarray(want[0])[S, S, S], "f32", exact=False, mi=mi, levels=2)
    got = st.stream_plane_pass_plain(off_kernel_mxu, ["u"], [t], s2, s2, 1, torch.from_numpy(origin), gs,
                                     fused_shell=pfs, **axes)
    want = jst.stream_plane_pass(off_kernel_mxu, ["u"], [j], JDim3(*s2), JDim3(*s2), 1, jnp.asarray(origin),
                                 JDim3(*gs), fused_shell=jfs, **_jax_axes(unit, mi, "f32"))
    _same(got[0], want[0], "f32", exact=True)


# --- the engine on 8 subdomains against the JAX domain ------------------------------------

N = 16


def _domains(bf16=False, seed=5, route=None, size=N, mult=3):
    td = DistributedDomain(size, size, size, device="cpu")
    jd = JDomain(size, size, size)
    for d, rad in ((td, Radius), (jd, JRadius)):
        d.set_radius(rad.constant(1))
        d.set_halo_multiplier(mult)
        if route is not None:
            d.set_exchange_route(route)
    td.set_subdomains(8)
    jd.set_devices(jax.devices()[:8])
    th = [td.add_data(f"q{i}", dtype=torch.float32) for i in range(2)]
    jh = [jd.add_data(f"q{i}", dtype=jnp.float32) for i in range(2)]
    if bf16:
        td.set_storage("bf16")
        jd.set_storage("bf16")
    td.realize()
    jd.realize()
    for i, (a, b) in enumerate(zip(th, jh)):
        v = _rand((size, size, size), seed + i).astype(np.float32)
        td.set_quantity(a, v)
        jd.set_quantity(b, v)
    return td, th, jd, jh


def _quantities(dd, hs):
    return [np.asarray(dd.quantity_to_host(h)).astype(np.float64) for h in hs]


def _quiet(fn, *a, **kw):
    """``fn`` with the mxu_band-without-a-band-tile warnings held back."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a, **kw)


PLAN_KEYS = ("route", "m", "overlap", "halo", "compute_unit", "mxu_input")


@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("path", ["plane", "auto"])
@pytest.mark.parametrize("unit,mi,bf16", ENGINE)
def test_stream_step_vs_jax(mode, path, unit, mi, bf16):
    """``make_stream_step`` with the fused halo (``yzpack_xla``) or the split
    schedule (``direct``) under a unit, against the JAX domain: equal plans
    and the same fields after 4 steps (the plane route bitwise)."""
    route = "yzpack_xla" if mode == "fused" else "direct"
    td, th, jd, jh = _domains(bf16, route=route)
    kw = dict(engine="stream", stream_path=path, compute_unit=unit, mxu_input=mi, mxu_kernel=mean6_kernel_mxu)
    kw.update({"stream_halo": "fused"} if mode == "fused" else {"stream_overlap": "split"})
    ts = _quiet(td.make_step, mean6_kernel, **kw)
    js = jd.make_step(mean6_kernel, interpret=True, **kw)
    tp, jp = ts._stream_plan, js._stream_plan
    for key in PLAN_KEYS:
        assert tp[key] == jp[key], key
    assert (tp["compute_unit"], tp["mxu_input"], tp["f32_accumulate"], tp["z_slabs"]) == (unit, mi, bf16, False)
    assert (tp["halo"], tp["overlap"]) == (("fused", "off") if mode == "fused" else ("array", "split"))
    steps = 4
    td.run_step(ts, steps)
    jd.run_step(js, steps)
    for g, w in zip(_quantities(td, th), _quantities(jd, jh)):
        _same(g, w, "bf16" if bf16 else "f32", exact=tp["route"] == "plane", passes=steps, mi=mi, levels=steps)


@pytest.mark.parametrize("path", ["plane", "auto"])
@pytest.mark.parametrize("unit,mi,bf16", ENGINE)
def test_split_interiors_equal_off(path, unit, mi, bf16):
    """Under a unit the split schedule's interiors are ``overlap="off"``'s
    bit for bit on the CPU (the plain form both), and its band passes
    count under the array forms' contraction counters."""
    outs = []
    for overlap in ("off", "split"):
        td, th, _, _ = _domains(bf16, seed=9)
        step = _quiet(td.make_step, mean6_kernel, engine="stream", stream_path=path, stream_overlap=overlap,
                      stream_z_slabs=False, compute_unit=unit, mxu_input=mi, mxu_kernel=mean6_kernel_mxu)
        assert step._stream_plan["overlap"] == overlap and step._stream_plan["compute_unit"] == unit
        td.run_step(step, 5)
        outs.append(_quantities(td, th))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_fused_step_equals_array_under_a_unit():
    """The fused halo under a unit is the array halo's step bit for bit, the
    raw blocks' interiors (the CPU runs both plain versions)."""
    outs = []
    for halo in ("array", "fused"):
        td, th, _, _ = _domains(route="yzpack_xla", seed=13)
        step = td.make_step(mean6_kernel, engine="stream", stream_halo=halo, stream_z_slabs=False,
                            compute_unit="mxu", mxu_kernel=mean6_kernel_mxu)
        assert step._stream_plan["halo"] == halo
        td.run_step(step, 5)
        outs.append(_quantities(td, th))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# --- the band passes' units -----------------------------------------------------------------


def _record_port_units(monkeypatch):
    seen = []
    orig = st._pass_unit

    def rec(compute_unit, mxu_input, fields, plane_y, plane_z, where):
        out = orig(compute_unit, mxu_input, fields, plane_y, plane_z, where)
        seen.append(((plane_y, plane_z), out[0]))
        return out

    monkeypatch.setattr(st, "_pass_unit", rec)
    return seen


def _record_jax_units(monkeypatch):
    seen = []
    orig = jst._pass_band_setup

    def rec(compute_unit, mxu_input, plane_y, plane_z, where):
        out = orig(compute_unit, mxu_input, plane_y, plane_z, where)
        seen.append(((plane_y, plane_z), out[0]))
        return out

    monkeypatch.setattr(jst, "_pass_band_setup", rec)
    return seen


@pytest.mark.parametrize("path", ["plane", "auto"])
def test_band_passes_resolve_the_unit_per_side(monkeypatch, path):
    """20^3 on 8 subdomains, shell 3: the blocks' (16, 16) planes admit a
    band tile, so the interior passes run ``mxu_band`` on both sides.  The
    port's y and z band windows are exactly ``3w`` wide ((3w, 16) and
    (16, 3w): no band tile, ``mxu``); the JAX package's are rounded up to
    its tile granule (32 rows, 128 columns, cut to the block: (16, 16),
    ``mxu_band``).  The values are the same."""
    port_seen, jax_seen = _record_port_units(monkeypatch), _record_jax_units(monkeypatch)
    td, th, jd, jh = _domains(route="direct", size=20)
    kw = dict(engine="stream", stream_path=path, stream_overlap="split", compute_unit="mxu_band",
              mxu_kernel=mean6_kernel_mxu)
    with pytest.warns(RuntimeWarning, match="band planes") as caught:
        ts = td.make_step(mean6_kernel, **kw)
    assert len([w for w in caught if "band planes" in str(w.message)]) == 1
    js = jd.make_step(mean6_kernel, interpret=True, **kw)
    for key in PLAN_KEYS:
        assert ts._stream_plan[key] == js._stream_plan[key], key
    m = ts._stream_plan["m"]
    w = 1 if path == "plane" else m
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a call warns no more
        td.run_step(ts, m)
    jd.run_step(js, m)
    port, jax_ = dict(port_seen), dict(jax_seen)
    assert port == {(16, 16): "mxu_band", (3 * w, 16): "mxu", (16, 3 * w): "mxu"}
    assert jax_ == {(16, 16): "mxu_band"}
    for g, want in zip(_quantities(td, th), _quantities(jd, jh)):
        _same(g, want, "f32", exact=path == "plane", levels=m)


def test_band_units_follow_the_planes():
    """``_band_units``: every axis and width of the plan, the x bands on the
    block's plane, vpu and mxu untouched."""
    td, _, _, _ = _domains(size=20)
    plan = {"route": "wavefront", "m": 3}
    units = st._band_units(td, plan, "mxu", 1)
    assert set(units) == {(ax, w) for ax in range(3) for w in (1, 2, 3)} and set(units.values()) == {"mxu"}
    assert set(st._band_units(td, {"route": "plane", "m": 1}, "vpu", 2)) == {(0, 2), (1, 2), (2, 2)}
    with pytest.warns(RuntimeWarning, match=r"\(3, 16\), \(6, 16\), \(9, 16\), \(16, 3\)"):
        units = st._band_units(td, plan, "mxu_band", 1)
    assert {k: v for k, v in units.items() if v == "mxu_band"} == {(0, 1): "mxu_band", (0, 2): "mxu_band",
                                                                   (0, 3): "mxu_band"}


def test_band_passes_run_traced_kernels(monkeypatch):
    """The band passes' kernels are traced when the step is built (one set a
    unit), so no pass traces at a call."""
    td, _, _, _ = _domains(route="direct", size=20)
    built = []
    orig_init = StreamKernel.__init__

    def counting_init(self, *a, **kw):
        built.append(kw.get("compute_unit"))
        orig_init(self, *a, **kw)

    monkeypatch.setattr(StreamKernel, "__init__", counting_init)
    with pytest.warns(RuntimeWarning, match="band planes"):
        step = td.make_step(mean6_kernel, engine="stream", stream_overlap="split", compute_unit="mxu_band",
                            mxu_kernel=mean6_kernel_mxu)
    assert sorted(built) == ["mxu", "mxu_band"]  # one joint group: the interior's kernel and the bands'
    built.clear()
    td.run_step(step, 4)
    assert built == []


# --- the launch path on stand-in C entries -------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the wrappers take their
    launch path, and the stand-in entries read its host memory."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _view(ptr, shape):
    nbytes = int(np.prod(shape)) * 4
    return torch.from_numpy(np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=np.float32)
                            .reshape(shape))


@pytest.fixture
def on_card(monkeypatch):
    """Stand-in libraries whose fused entries compute the plain version
    under the unit their source was built for, at the addresses given."""
    card = types.SimpleNamespace(loads=[], unit=None)

    def plane(in_p, xb_p, yb_p, zb_p, out_p, org_p, n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, r, gx, gy, gz, _s):
        lo, hi = Dim3(lox, loy, loz), Dim3(hix, hiy, hiz)
        raws = [_view(in_p[0], (n, X, Y, Z))]
        fs = ([_view(xb_p[0], (n, lox + hix, Y, Z))], [_view(yb_p[0], (n, loy + hiy, X, Z))],
              [_view(zb_p[0], (n, loz + hiz, Y, X))])
        org = torch.from_numpy(np.frombuffer((ctypes.c_char * (12 * n)).from_address(org_p), dtype=np.int32)
                               .reshape(n, 3).copy())
        out = st.stream_plane_pass_plain(mean6_kernel_mxu, ["u"], raws, lo, hi, r, org, (gx, gy, gz),
                                         fused_shell=fs, **card.unit)
        _view(out_p[0], (n, X, Y, Z)).copy_(out[0])
        return 0

    def wavefront(raw_p, xb_p, yb_p, zb_p, out_p, org_p, n, Xr, Yr, Zr, m, s, gx, gy, gz, _s):
        raws = [_view(raw_p[0], (n, Xr, Yr, Zr))]
        fs = ([_view(xb_p[0], (n, 2 * s, Yr, Zr))], [_view(yb_p[0], (n, 2 * s, Xr, Zr))],
              [_view(zb_p[0], (n, 2 * s, Yr, Xr))])
        org = torch.from_numpy(np.frombuffer((ctypes.c_char * (12 * n)).from_address(org_p), dtype=np.int32)
                               .reshape(n, 3).copy())
        out, _ = st.stream_wavefront_pass_plain(mean6_kernel_mxu, ["u"], raws, m, s, org, (gx, gy, gz),
                                                fused_shell=fs, **card.unit)
        _view(out_p[0], (n, Xr, Yr, Zr)).copy_(out[0])
        return 0

    def load_generated(template, text):
        card.loads.append((template, "#define STP_FUSED 1" in text, "#define STP_NBR_MASK 0x1" in text,
                           "#define STP_MXU 2" in text))
        return types.SimpleNamespace(stp_stream_plane_fused=plane, stp_stream_wavefront_fused=wavefront,
                                     stp_error_string=lambda code: b"stand-in error")

    monkeypatch.setattr(build, "load_generated", load_generated)
    monkeypatch.setattr(st, "stream_handle", lambda dev: 7000)
    return card


@pytest.mark.parametrize("kind", ["plane", "wavefront"])
@pytest.mark.parametrize("unit,mi", [("mxu", "f32"), ("mxu_band", "bf16")])
def test_fused_contraction_launch_counts_its_form(on_card, kind, unit, mi):
    """A fused pass under a unit loads the fused contraction build (its
    source defines STP_FUSED, STP_NBR_MASK and the operands' STP_MXU),
    launches once, and counts under ``fused_mxu[_bf16in]_launches`` alone."""
    on_card.unit = dict(compute_unit=unit, mxu_input=mi)
    n, X, Y, Z, s = 2, 9, 16, 24, 2
    sh = Dim3(s, s, s)
    raw = torch.from_numpy(_rand((n, X, Y, Z), 401).astype(np.float32))
    fs = ([torch.from_numpy(_rand((n, 2 * s, Y, Z), 402).astype(np.float32))],
          [torch.from_numpy(_rand((n, 2 * s, X, Z), 403).astype(np.float32))],
          [torch.from_numpy(_rand((n, 2 * s, Y, X), 404).astype(np.float32))])
    org = torch.tensor([[1, 2, 3], [7, 5, 0]], dtype=torch.int32)
    c = lambda t: t.clone().as_subclass(_OnCard)  # noqa: E731
    cfs = tuple([c(t) for t in b] for b in fs)
    gs = (20, 30, 40)
    wrapper = st.stream_plane_pass if kind == "plane" else st.stream_wavefront_pass
    form = "fused_mxu" + ("_bf16in" if mi == "bf16" else "")
    ledger.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # (16, 24) admits no band tile: the dense form
        if kind == "plane":
            got = st.stream_plane_pass(mean6_kernel_mxu, ["u"], [c(raw)], sh, sh, 1, c(org), gs, fused_shell=cfs,
                                       **on_card.unit)[0]
            want = st.stream_plane_pass_plain(mean6_kernel_mxu, ["u"], [raw], sh, sh, 1, org, gs, fused_shell=fs,
                                              **on_card.unit)[0]
            region = (slice(None),) * 4
        else:
            got = st.stream_wavefront_pass(mean6_kernel_mxu, ["u"], [c(raw)], 2, s, c(org), gs, fused_shell=cfs,
                                           **on_card.unit)[0][0]
            want = st.stream_wavefront_pass_plain(mean6_kernel_mxu, ["u"], [raw], 2, s, org, gs, fused_shell=fs,
                                                  **on_card.unit)[0][0]
            region = (slice(None),) + (slice(s, -s),) * 3
    assert on_card.loads == [(f"stream_{kind}_fused", True, True, mi == "bf16")]
    counts = {k: v for k, v in ledger.launch_counts().items() if v}
    assert counts == {f"stream_{kind}_pass_{form}": 1} and getattr(wrapper, f"{form}_launches") == 1
    assert torch.equal(got.as_subclass(torch.Tensor)[region], want[region])


def test_unit_step_prebuilds_the_fused_contraction_builds(monkeypatch):
    """A fused step under a unit builds its fused libraries, every depth of
    the wavefront's, from the contraction trace, in one batch."""
    batches = []
    monkeypatch.setattr(build, "build_generated", lambda sources: batches.append(list(sources)))
    sk = StreamKernel(mean6_kernel_mxu, ["q0"], 1, (16, 16, 16), compute_unit="mxu", mxu_input="bf16")
    for plan in (dict(route="plane", m=1, halo="fused"), dict(route="wavefront", m=3, halo="fused")):
        st._prebuild([sk], plan)
    assert [sorted({t for t, _ in b}) for b in batches] == [["stream_plane_fused"], ["stream_wavefront_fused"]]
    assert [len(b) for b in batches] == [1, 3]
    assert all("#define STP_FUSED 1" in text and "#define STP_MXU 2" in text for b in batches for _, text in b)


# --- the model and its command line ---------------------------------------------------------

#: AstarothSim runs: key -> (schedule, exchange route, stream halo, stream overlap, route)
AST = {"per-step fused": ("per-step", "yzpack_xla", "fused", "auto", "plane"),
       "auto fused": ("auto", "yzpack_xla", "fused", "auto", "wavefront"),
       "auto split": ("auto", "direct", "auto", "split", "wavefront")}


@pytest.mark.parametrize("key", sorted(AST))
@pytest.mark.parametrize("unit,mi", [("mxu", "f32"), ("mxu_band", "bf16")])
def test_astaroth_vs_jax(key, unit, mi):
    """``AstarothSim(kernel_impl="cuda", compute_unit=..., stream_halo=... /
    stream_overlap=...)`` on 8 subdomains against the JAX package's pallas
    engine in interpret mode, from its state: the plane route bitwise, the
    wavefront within rtol 1e-6."""
    schedule, route, halo, overlap, want_route = AST[key]
    kw = dict(schedule=schedule, exchange_route=route, stream_halo=halo, stream_overlap=overlap,
              compute_unit=unit, mxu_input=mi)
    j = JAstaroth(N, N, N, num_quantities=2, devices=jax.devices()[:8], kernel_impl="pallas", interpret=True, **kw)
    j.realize()
    t = AstarothSim(N, N, N, num_quantities=2, subdomains=8, device="cpu", kernel_impl="cuda", **kw)
    _quiet(t.realize)
    tp, jp = t._step._stream_plan, j._step._stream_plan
    for k in PLAN_KEYS:
        assert tp[k] == jp[k], k
    assert tp["route"] == want_route and (t._compute_unit, t._mxu_input) == (unit, mi)
    assert (tp["halo"], tp["overlap"]) == (("fused", "off") if halo == "fused" else ("array", "split"))
    t.load_state([np.asarray(j.dd.raw_to_host(h)) for h in j.handles])
    for sim in (j, t):
        sim.step(5)
    for q in range(2):
        _same(t.field(q), np.asarray(j.field(q)), "f32", exact=want_route == "plane", mi=mi, levels=5)


def test_astaroth_f64_degrades_the_unit_under_fused_and_split():
    """Float64 fields degrade the unit to vpu with a warning, fused and split
    alike (no float64 contraction build)."""
    for kw in ({"exchange_route": "yzpack_xla", "stream_halo": "fused"}, {"stream_overlap": "split"}):
        t = AstarothSim(N, N, N, num_quantities=1, subdomains=8, device="cpu", kernel_impl="cuda",
                        dtype=torch.float64, compute_unit="mxu", **kw)
        with pytest.warns(RuntimeWarning, match="not f32"):
            t.realize()
        plan = t._step._stream_plan
        assert t._compute_unit == "vpu" and (plan["halo"], plan["overlap"]) != ("array", "off")
        t.step(3)
        assert np.isfinite(t.field(0)).all()


@pytest.mark.parametrize("flags", [["--stream-halo", "fused", "--exchange-route", "yzpack_xla"],
                                   ["--stream-overlap", "split"]])
def test_cli_combines_the_unit_with_fused_and_split(capsys, flags):
    from stencil_tpu_torch.bin import astaroth_sim

    rc = _quiet(astaroth_sim.main, ["--x", "12", "--y", "12", "--z", "12", "--iters", "1", "--quantities", "2",
                                    "--device", "cpu", "--partition", "2,2,2", "--compute-unit", "mxu_band",
                                    "--mxu-input", "bf16", *flags])
    assert rc == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[0] == "astaroth" and row[4:7] == ["12", "12", "12"] and float(row[7]) > 0
