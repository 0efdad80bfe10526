"""The port's user-kernel stream engine against the JAX package's.

The same seeded inputs go through the JAX stream passes (Pallas in interpret
mode, as tests/test_stream.py runs them) and the port's kernels, whose plain
versions run here on CPU tensors; then whole routes run end to end through
both packages' ``make_step``.  Tolerances, and why:

* bitwise wherever the two compute the same float32 operations in the same
  order: every one-level pass, every route against the JAX package's XLA
  (``jnp``) engine, and the plane route against its stream engine;
* ``TOL`` (rtol = atol = 1e-6, ``tests/test_stream.py:26``) against the JAX
  package's interpret-mode wrap and wavefront passes at depth >= 2: XLA on
  the CPU fuses a level's ``* float32(1/c)`` into the next level's adds (a
  fused multiply-add across levels), so those passes differ from the JAX
  package's own ``jnp`` route by an ulp; the port does not contract (see
  ``ops/stream_trace.py``) and is held bitwise to the ``jnp`` route instead;
* ``TOL`` for ``vc_diffusion``, whose ``c * lap + u`` XLA contracts into one
  fused multiply-add even within a level.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.ops import stream as jst
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.kernels import build
from stencil_tpu_torch.ops import stream as st
from stencil_tpu_torch.ops.stream_trace import StreamKernel, x_reads_centred

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def mean6(views, info):
    return {
        name: (src.sh(-1, 0, 0) + src.sh(0, -1, 0) + src.sh(0, 0, -1)
               + src.sh(1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, 0, 1)) / 6.0
        for name, src in views.items()
    }


def k27(views, info):
    """The 27-point user kernel of ``__graft_entry__.py:115-122``."""
    src = views["u"]
    acc = 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                acc = acc + src.sh(dx, dy, dz) / (2.0 ** (abs(dx) + abs(dy) + abs(dz)))
    return {"u": acc / 8.0}


def vc_diffusion(views, info):
    """``tests/test_stream.py:86-96``: the coefficient field passes through."""
    u, c = views["u"], views["c"]
    lap = (u.sh(-1, 0, 0) + u.sh(1, 0, 0) + u.sh(0, -1, 0) + u.sh(0, 1, 0)
           + u.sh(0, 0, -1) + u.sh(0, 0, 1) - 6.0 * u.center())
    return {"u": u.center() + c.center() * lap}


def _forced(where):
    """``tests/test_stream.py:99-107`` with the framework's ``where``."""

    def forced(views, info):
        src = views["u"]
        cx, cy, cz = info.coords()
        g = info.global_size
        val = (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, -1, 0)) / 4.0
        d2 = (cx - g.x // 2) ** 2 + (cy - g.y // 2) ** 2 + (cz - g.z // 2) ** 2
        return {"u": where(d2 < 9, 1.0, val).astype(src.center().dtype)}

    return forced


def r2_kernel(views, info):
    """Reads at distance 2 on every axis (the plane route's any-r case)."""
    s = views["u"]
    return {"u": (s.sh(-2, 0, 0) + s.sh(2, 0, 1) + s.sh(0, -2, 1)
                  + s.sh(1, 2, 0) + s.sh(0, 0, -2) + s.sh(-1, 0, 2)) / 6.0}


KERNELS = {  # name: (JAX kernel, port kernel, field names, bitwise vs the XLA engine)
    "mean6": (mean6, mean6, ["u", "v"], True),
    "k27": (k27, k27, ["u"], True),
    "forced": (_forced(jnp.where), _forced(torch.where), ["u"], True),
    "vc_diffusion": (vc_diffusion, vc_diffusion, ["u", "c"], False),
}


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _fields(name, shape, seed):
    """Seeded inputs of a kernel's fields; vc_diffusion's coefficient in
    [0.04, 0.06), a stable diffusion as tests/test_stream.py sets it up."""
    out = [_rand(shape, seed + q) for q in range(len(KERNELS[name][2]))]
    if name == "vc_diffusion":
        out[1] = (0.04 + 0.02 * out[1]).astype(np.float32)
    return out


def _same(got, want, bitwise):
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# --- the repaired torch engine ---------------------------------------------------------


@pytest.mark.parametrize("subdomains", [1, 8])
def test_torch_engine_divides_like_xla(subdomains):
    """``x / 6.0`` in a user kernel is a multiply by float32(1/6), as XLA
    compiles it: the torch engine equals the JAX package's XLA engine bit
    for bit (an IEEE divide differs in most cells)."""
    size = (16, 16, 16)
    j = JDomain(*size)
    j.set_radius(JRadius.constant(1))
    j.set_devices(jax.devices()[:subdomains])
    jh = j.add_data("u")
    j.realize()
    t = DistributedDomain(*size, device="cpu")
    t.set_radius(Radius.constant(1))
    t.set_subdomains(subdomains)
    th = t.add_data("u")
    t.realize()
    field = _rand(size, 1)
    j.set_quantity(jh, field)
    t.set_quantity(th, field)
    j.run_step(j.make_step(mean6, overlap=False), 3)
    t.run_step(t.make_step(mean6), 3)
    np.testing.assert_array_equal(t.quantity_to_host(th), np.asarray(j.quantity_to_host(jh)))


# --- each kernel's plain version against the JAX pass ---------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_wrap_pass_plain_vs_pallas(k):
    """k = 1 bitwise; deeper passes bitwise against k one-level JAX passes
    and within TOL of the k-level one (module docstring)."""
    gs = (10, 12, 14)
    blocks = [_rand(gs, 2), _rand(gs, 3)]
    org = np.zeros(3, np.int32)
    want = jst.stream_wrap_pass(mean6, ["u", "v"], [jnp.asarray(b) for b in blocks], k,
                                jnp.asarray(org), JDim3(*gs), interpret=True)
    chained = [jnp.asarray(b) for b in blocks]
    for _ in range(k):
        chained = jst.stream_wrap_pass(mean6, ["u", "v"], chained, 1, jnp.asarray(org), JDim3(*gs),
                                       interpret=True)
    got = st.stream_wrap_pass(mean6, ["u", "v"], [torch.from_numpy(b) for b in blocks], k,
                              torch.from_numpy(org), gs)
    for g, w, c in zip(got, want, chained):
        np.testing.assert_array_equal(g.numpy(), np.asarray(c))
        _same(g.numpy(), np.asarray(w), k == 1)


@pytest.mark.parametrize("name", ["forced", "vc_diffusion"])
def test_wrap_pass_coords_and_passthrough(name):
    jk, tk, names, bitwise = KERNELS[name]
    gs = (10, 12, 14)
    blocks = _fields(name, gs, 4)
    org = np.zeros(3, np.int32)
    want = jst.stream_wrap_pass(jk, names, [jnp.asarray(b) for b in blocks], 1, jnp.asarray(org),
                                JDim3(*gs), interpret=True)
    got = st.stream_wrap_pass(tk, names, [torch.from_numpy(b) for b in blocks], 1,
                              torch.from_numpy(org), gs)
    _same(got[0].numpy(), np.asarray(want[0]), bitwise)
    for g, w in zip(got[1:], want[1:]):  # pass-through fields are untouched
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name,r", [("mean6", 1), ("forced", 1), ("r2", 2)])
def test_plane_pass_plain_vs_pallas(name, r):
    """One level over two shell-carrying blocks with uneven shell widths and
    non-zero origins, at read radius 1 and 2: bitwise, shell cells passed
    through."""
    jk, tk, names, _ = KERNELS[name] if name in KERNELS else (r2_kernel, r2_kernel, ["u"], True)
    lo, hi = (r, r + 1, r), (r + 1, r, r + 2)
    gs = (18, 20, 22)
    shape = (12, 13, 14)
    orgs = np.array([[0, 0, 0], [9, 4, 11]], np.int32)
    raws = [_rand((2,) + shape, 10 + q) for q in range(len(names))]
    got = st.stream_plane_pass(tk, names, [torch.from_numpy(b) for b in raws], Dim3(*lo), Dim3(*hi), r,
                               torch.from_numpy(orgs), gs)
    for b in range(2):
        want = jst.stream_plane_pass(jk, names, [jnp.asarray(x[b]) for x in raws], JDim3(*lo), JDim3(*hi),
                                     r, jnp.asarray(orgs[b]), JDim3(*gs), interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("m,s", [(1, 1), (2, 3), (3, 3)])
@pytest.mark.parametrize("slabs", [False, True])
def test_wavefront_pass_plain_vs_pallas(m, s, slabs):
    """m levels over s-shell blocks in the plain and z-slab forms (with dead
    columns past ``z_valid``): bitwise at m = 1, within TOL deeper; compared
    on the valid region (the interior, the emitted slabs at interior planes
    and rows)."""
    Xr, Yr, Zr = 14, 16, 18
    zv = 16 if slabs else Zr
    gs = (2 * (Xr - 2 * s), 2 * (Yr - 2 * s), 2 * (zv - 2 * s))
    orgs = np.array([[0, 0, 0], [Xr - 2 * s, 0, zv - 2 * s]], np.int32)
    names = ["u", "v"]
    raws = [_rand((2, Xr, Yr, Zr), 20 + q) for q in range(2)]
    zs = [_rand((2, Xr, 2 * s, Yr), 30 + q) for q in range(2)] if slabs else None
    got, got_z = st.stream_wavefront_pass(
        mean6, names, [torch.from_numpy(x) for x in raws], m, s, torch.from_numpy(orgs), gs,
        z_slabs=[torch.from_numpy(z) for z in zs] if slabs else None, z_valid=zv if slabs else None)
    S = slice(s, -s)
    for b in range(2):
        want, want_z = jst.stream_wavefront_pass(
            mean6, names, [jnp.asarray(x[b]) for x in raws], m, s, jnp.asarray(orgs[b]), JDim3(*gs),
            z_slabs=[jnp.asarray(z[b]) for z in zs] if slabs else None,
            z_valid=zv if slabs else None, interpret=True)
        for q in range(2):
            _same(got[q][b, S, S, s:zv - s].numpy(), np.asarray(want[q])[S, S, s:zv - s], m == 1)
            if slabs:
                _same(got_z[q][b, S, :, S].numpy(), np.asarray(want_z[q])[S, :, S], m == 1)


# --- routes end to end --------------------------------------------------------------


def _jdomain(size, radius, names, subdomains, mult, fields):
    dd = JDomain(*size)
    dd.set_radius(JRadius.constant(radius))
    dd.set_devices(jax.devices()[:subdomains])
    if mult != 1:
        dd.set_halo_multiplier(mult)
    hs = [dd.add_data(n) for n in names]
    dd.realize()
    for h, f in zip(hs, fields):
        dd.set_quantity(h, f)
    return dd, hs


def _tdomain(size, radius, names, subdomains, mult, fields):
    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(Radius.constant(radius))
    dd.set_subdomains(subdomains)
    if mult != 1:
        dd.set_halo_multiplier(mult)
    hs = [dd.add_data(n) for n in names]
    dd.realize()
    for h, f in zip(hs, fields):
        dd.set_quantity(h, f)
    return dd, hs


ROUTES = {  # name: (subdomains, halo multiplier, stream_path, expected route, m)
    "wrap": (1, 1, "auto", "wrap", 6),
    "wavefront": (8, 3, "auto", "wavefront", 3),
    "plane": (8, 1, "plane", "plane", 1),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_stream_route_vs_jax(route, name):
    """5 iterations (a macro and a remainder on the deep routes) through the
    port's ``make_step(engine="stream")`` against the JAX package's XLA
    engine (bitwise, but vc_diffusion) and its interpret-mode stream engine
    (bitwise on the plane route; TOL on the deep routes, module
    docstring)."""
    jk, tk, names, bitwise = KERNELS[name]
    subdomains, mult, path, want_route, m = ROUTES[route]
    size = (12, 12, 12)
    fields = _fields(name, size, 40)
    ref, ref_h = _jdomain(size, 1, names, subdomains, 1, fields)
    ref.run_step(ref.make_step(jk, overlap=False), 5)
    jd, jh = _jdomain(size, 1, names, subdomains, mult, fields)
    jstep = jd.make_step(jk, engine="stream", stream_path=path, interpret=True)
    jd.run_step(jstep, 5)
    td, th = _tdomain(size, 1, names, subdomains, mult, fields)
    step = td.make_step(tk, engine="stream", stream_path=path)
    assert step._stream_plan["route"] == jstep._stream_plan["route"] == want_route
    assert step._stream_plan["m"] == m and step._marks_shell_stale
    td.run_step(step, 5)
    for q in range(len(names)):
        got = td.quantity_to_host(th[q])
        _same(got, np.asarray(ref.quantity_to_host(ref_h[q])), bitwise)
        _same(got, np.asarray(jd.quantity_to_host(jh[q])), bitwise and route == "plane")


def test_wavefront_plain_form_and_stale_shell():
    """``z_slabs=False`` runs the wavefront with every axis exchanged in the
    array; it equals the z-slab form bitwise, and the readback of the raw
    blocks re-exchanges the stale shell first."""
    size = (12, 12, 12)
    fields = [_rand(size, 50)]
    outs = []
    for z_slabs in (True, False):
        td, th = _tdomain(size, 1, ["u"], 8, 3, fields)
        step = td.make_step(mean6, engine="stream", stream_z_slabs=z_slabs)
        assert step._stream_plan["z_slabs"] is z_slabs
        td.run_step(step, 7)
        assert td._shell_stale
        outs.append((td.quantity_to_host(th[0]), td.raw_to_host(th[0])))
        assert not td._shell_stale
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


# --- planning ---------------------------------------------------------------------------


def _plans(size, radius, nf, subdomains, mult=1, **kw):
    names = [f"q{i}" for i in range(nf)]
    fields = [np.zeros(size, np.float32)] * nf
    jd, _ = _jdomain(size, radius, names, subdomains, mult, fields)
    td, _ = _tdomain(size, radius, names, subdomains, mult, fields)
    path = kw.pop("path", "auto")
    return (jst.plan_stream(jd, 1, path, **{"max_m": None, **kw}),
            st.plan_stream(td, 1, path, **{"max_m": None, **kw}))


@pytest.mark.parametrize("case", [
    dict(size=(16, 16, 16), radius=1, nf=1, subdomains=1),
    dict(size=(16, 16, 16), radius=1, nf=1, subdomains=1, max_m=3),
    dict(size=(16, 16, 16), radius=3, nf=2, subdomains=8),
    dict(size=(16, 16, 16), radius=1, nf=1, subdomains=8, mult=3),
    dict(size=(16, 16, 16), radius=3, nf=2, subdomains=8, max_m=2),
    dict(size=(16, 16, 16), radius=3, nf=2, subdomains=8, path="plane"),
    dict(size=(16, 16, 16), radius=1, nf=1, subdomains=8),
])
def test_plan_stream_agrees_with_jax(case):
    want, got = _plans(**case)
    assert got == want


def test_plan_stream_documented_differences(monkeypatch):
    """Where the two memory models differ (``plan_stream`` docstring)."""
    # 4 fields at radius 3: jointly m = 2 fits, m = 3 does not, so a
    # separable kernel goes per field at m = 3, as the JAX package does under
    # a tight VMEM budget (tests/test_stream.py:349-368)
    monkeypatch.setenv("STENCIL_VMEM_LIMIT_BYTES", "5000000")
    want, got = _plans((24, 24, 24), 3, 4, 8, separable=True)
    monkeypatch.delenv("STENCIL_VMEM_LIMIT_BYTES")
    assert got == want == {"route": "wavefront", "m": 3, "z_slabs": True, "grouping": "per-field"}
    # 3 fields at radius 3, not separable: the JAX package keeps joint m = 3
    # at small sizes; one Hopper block holds 3 fields only at m = 2
    want, got = _plans((16, 16, 16), 3, 3, 8)
    assert want["m"] == 3 and got == {"route": "wavefront", "m": 2, "z_slabs": True, "grouping": "joint"}
    assert st.stream_smem_fits(2, 3) and not st.stream_smem_fits(3, 3)
    # the 8-field bench configuration plans per field at m = 3
    assert not st.stream_smem_fits(2, 8) and st.stream_smem_fits(3, 1)
    # a read radius of 2 has no wavefront or wrap route in either package
    td, _ = _tdomain((16, 16, 16), 2, ["u"], 1, 1, [np.zeros((16, 16, 16), np.float32)])
    assert st.plan_stream(td, 2)["route"] == "plane"
    with pytest.raises(ValueError, match="wrap"):
        st.plan_stream(td, 2, "wrap")
    with pytest.raises(ValueError, match="wavefront"):
        st.plan_stream(td, 2, "wavefront")


# --- what the engine refuses ----------------------------------------------------------


@pytest.mark.parametrize("body,exc,match", [
    (lambda s, i: torch.sin(s.center()), TypeError, "sin"),
    (lambda s, i: s.center() // 2, TypeError, "//"),
    (lambda s, i: s.center() % 2, TypeError, "%"),
    (lambda s, i: s.center() if s.center() else s.center(), TypeError, "branch"),
    (lambda s, i: s.center() + torch.ones(3), TypeError, "tensor"),
    (lambda s, i: i.coords()[0] / 2, TypeError, "integer true division"),
    (lambda s, i: s.center() ** 0.5, TypeError, "int exponent"),
    (lambda s, i: s.center().sum(), TypeError, "sum"),
    (lambda s, i: s.sh(2, 0, 0), ValueError, "x_radius"),
    (lambda s, i: s.sh(0, 0, -2), ValueError, "x_radius"),
])
def test_tracer_rejects_unsupported_ops(body, exc, match):
    sk = StreamKernel(lambda views, info: {"u": body(views["u"], info)}, ["u"], 1, (8, 8, 8))
    with pytest.raises(exc, match=match):
        sk.trace()


def test_tracer_arithmetic_contract():
    """Python numbers are float32 beside floats and int32 beside ints, a
    division by a number is a multiply by its float32 reciprocal, ``**`` is
    a multiply chain, and the CUDA body cannot contract."""
    def kern(views, info):
        u = views["u"]
        cx, _, _ = info.coords()
        return {"u": torch.where(abs(cx - 4) ** 3 > 9, u.center() / 3.0, -u.sh(1, 0, 0) * 0.5 / u.center())}

    sk = StreamKernel(kern, ["u"], 1, (8, 8, 8))
    ops = [n.op for n in sk.trace().live()]
    assert ops.count("mul") == 4 and ops.count("div") == 1 and "cast" not in ops
    body = sk.cuda_body([1])
    assert "__fmul_rn" in body and "__fdiv_rn" in body and "0x1.5555560000000p-2f" in body
    assert "(unsigned)" in body and "fma" not in body
    u = torch.from_numpy(_rand((8, 8, 8), 60))
    x = torch.arange(8, dtype=torch.int32).view(8, 1, 1)
    got = sk.evaluate(lambda q, dx, dy, dz: torch.roll(u, (-dx, -dy, -dz), (0, 1, 2)),
                      lambda: (x, x * 0, x * 0), "cpu")[0]
    want = torch.where(((x - 4).abs() ** 3) > 9, u * np.float32(1 / 3),
                       -torch.roll(u, -1, 0) * 0.5 / u)
    assert torch.equal(got, want)


def test_level_dependent_kernel_gets_a_body_per_level():
    def kern(views, info):
        return {"u": views["u"].center() * (info.level + 1)}

    sk = StreamKernel(kern, ["u"], 1, (8, 8, 8))
    body = sk.cuda_body([1, 2, 3])
    assert "level == 1" in body and "level == 3" in body
    assert StreamKernel(mean6, ["u"], 1, (8, 8, 8)).cuda_body([1, 2, 3]).count("level ==") == 0


def test_unported_axes_and_alias_name_the_roadmap():
    td, _ = _tdomain((12, 12, 12), 1, ["u"], 8, 2, [np.zeros((12, 12, 12), np.float32)])
    # the kernel axes are ported (tests/test_torch_stream_mxu.py): with no
    # declared contraction form a unit degrades to vpu, and the split
    # schedule under an engaged unit plans on the re-planned plain wavefront
    # (tests/test_torch_stream_mxu_fused.py)
    for kw in ({"compute_unit": "mxu"}, {"compute_unit": "mxu_band"}, {"mxu_input": "bf16"}):
        with pytest.warns(RuntimeWarning, match="cannot engage|has no effect"):
            assert td.make_step(mean6, engine="stream", **kw)._stream_plan["compute_unit"] == "vpu"
        if "compute_unit" in kw:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # mxu_band on planes without a band tile
                plan = td.make_step(mean6, engine="stream", stream_overlap="split", mxu_kernel=mean6,
                                    **kw)._stream_plan
            assert (plan["route"], plan["z_slabs"], plan["overlap"], plan["compute_unit"]) == (
                "wavefront", False, "split", kw["compute_unit"])
    # split and fused are ported: split engages on the re-planned plain
    # wavefront, fused degrades with its warning off the yzpack_* routes
    plan = td.make_step(mean6, engine="stream", stream_overlap="split")._stream_plan
    assert (plan["route"], plan["z_slabs"], plan["overlap"]) == ("wavefront", False, "split")
    with pytest.warns(RuntimeWarning, match="does not pack the y shell"):
        plan = td.make_step(mean6, engine="stream", stream_halo="fused")._stream_plan
    assert plan["halo"] == "array"
    with pytest.raises(ValueError, match="unknown stream overlap"):
        td.make_step(mean6, engine="stream", stream_overlap="sideways")
    for depth in (0, True, 1.5):
        with pytest.raises(ValueError, match="stream_depth"):
            td.make_step(mean6, engine="stream", stream_depth=depth)
    assert td.make_step(mean6, engine="stream", stream_depth=1)._stream_plan["route"] == "plane"
    raw = [torch.zeros(10, 10, 10)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        st.stream_wavefront_pass(mean6, ["u"], raw, 1, 2, torch.zeros(3, dtype=torch.int32), (8, 8, 8),
                                 alias=True)


def test_generated_sources_and_missing_nvcc(monkeypatch, tmp_path):
    """A template's hook takes the emitted body, each body gets a library of
    its own, and a missing nvcc raises before anything is written."""
    a = st._source(StreamKernel(mean6, ["u"], 1, (8, 8, 8)), "stream_plane", [1])
    b = st._source(StreamKernel(k27, ["u"], 1, (8, 8, 8)), "stream_plane", [1])
    assert build.GENERATED_HOOK not in a and "stp_body" in a and "#define STP_NF 1" in a
    assert build._generated_paths("stream_plane", a) != build._generated_paths("stream_plane", b)
    monkeypatch.setattr(build.shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc was not found"):
        build.build_generated([("stream_plane", a)])
    assert list(tmp_path.iterdir()) == []



# --- the wavefront kernel's two forms -----------------------------------------------------


def _forced_diag(where):
    """Coordinate forcing that reads x+1 off the centre."""

    def forced_diag(views, info):
        src = views["u"]
        cx, cy, _ = info.coords()
        val = (src.sh(1, 1, 0) + src.sh(-1, 0, 0)) / 2.0
        return {"u": where(cx + cy < 9, 1.0, val).astype(src.center().dtype)}

    return forced_diag


def level_diag(views, info):
    """A level-dependent kernel that reads x-1 off the centre (its products
    by powers of two are exact, so no contraction can change them)."""
    u = views["u"]
    return {"u": (u.sh(-1, 0, 1) + u.sh(1, 0, 0)) * (0.5 ** info.level)}


def level_centred(views, info):
    u = views["u"]
    return {"u": (u.sh(-1, 0, 0) + u.sh(0, 1, -1) + u.sh(1, 0, 0)) * (0.5 ** info.level)}


def _astaroth(n_fields):
    from stencil_tpu_torch.models.astaroth import AstarothSim

    return AstarothSim(8, 8, 8, device="cpu")._kernel, [f"d{i}" for i in range(n_fields)]


FORM_KERNELS = {  # name: (JAX kernel, port kernel)
    "forced diag": (_forced_diag(jnp.where), _forced_diag(torch.where)),
    "level diag": (level_diag, level_diag),
    "level centred": (level_centred, level_centred),
}


@pytest.mark.parametrize("name,queue", [
    ("astaroth", True), ("astaroth x2", True), ("mean6", True), ("vc_diffusion", True), ("forced", True),
    ("level centred", True), ("k27", False), ("forced diag", False), ("level diag", False),
])
def test_emit_cuda_picks_the_wavefront_form(name, queue):
    """The register-queue form (``STP_X_QUEUE``) exactly where every read at
    x-1 or x+1 sits at in-plane offset (0, 0): Astaroth's and the mean6
    bodies, the forced kernel of tests/test_stream.py (its x reads are
    centred) and a centred level-dependent kernel; the general form for the
    27-point kernel and for coordinate-forced and level-dependent kernels
    that read x+-1 off the centre.  Every level's trace counts."""
    if name.startswith("astaroth"):
        kern, names = _astaroth(2 if name.endswith("x2") else 1)
    elif name in FORM_KERNELS:
        kern, names = FORM_KERNELS[name][1], ["u"]
    else:
        kern, names = KERNELS[name][1:3]
    sk = StreamKernel(kern, names, 1, (16, 16, 16))
    text = st._source(sk, *st._wavefront_variant(3))
    assert ("#define STP_X_QUEUE 1" in text) is queue
    assert x_reads_centred([sk.trace(level) for level in (1, 2, 3)]) is queue
    assert build.GENERATED_HOOK not in text and text.count("stp_body(") == 3


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(FORM_KERNELS))
def test_wavefront_pass_of_either_form_vs_pallas(m, name):
    """The plain version of a pass, what either form is held to on the card,
    against the JAX package's pass: bitwise at every depth, since every
    product of these kernels is exact; compared on the valid region."""
    jk, tk = FORM_KERNELS[name]
    s, Xr, Yr, Zr = 3, 14, 16, 18
    gs = (2 * (Xr - 2 * s), 2 * (Yr - 2 * s), 2 * (Zr - 2 * s))
    orgs = np.array([[0, 0, 0], [Xr - 2 * s, 2, Zr - 2 * s]], np.int32)
    raws = _rand((2, Xr, Yr, Zr), 70)
    got, _ = st.stream_wavefront_pass(tk, ["u"], [torch.from_numpy(raws)], m, s, torch.from_numpy(orgs), gs)
    S = slice(s, -s)
    for b in range(2):
        want, _ = jst.stream_wavefront_pass(jk, ["u"], [jnp.asarray(raws[b])], m, s, jnp.asarray(orgs[b]),
                                            JDim3(*gs), interpret=True)
        np.testing.assert_array_equal(got[0][b, S, S, S].numpy(), np.asarray(want[0])[S, S, S])
