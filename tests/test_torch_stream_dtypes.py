"""The stream engine's field dtypes against the JAX package's, on the CPU.

bf16 storage (the JAX passes' ``f32_accumulate``: read at float32, float32
level rings, one rounding to bfloat16 a pass) and float64 fields, through
the plain versions of the three stream kernels (#6 ``stream_wrap_pass``, #7
``stream_plane_pass`` and its fused form, #8 ``stream_wavefront_pass`` in
its queue-form and general-form kernels, z-slab and fused), through
``make_step(engine="stream")`` on bf16, float64 and mixed float32 + float64
domains (array, fused and split), and through ``AstarothSim`` under every
schedule on 1 and 8 subdomains.  Tolerances, and why:

* bitwise where the JAX route contracts no multiply and add: every depth-1
  pass of the mean-of-6 and 27-point kernels, the plane route, and the
  JAX package's XLA (``jnp``) engine;
* elsewhere the JAX interpret-mode passes fuse a level's multiply into the
  next level's adds on the CPU (``tests/test_torch_stream.py``): bf16
  within ``tests/ulp.py``'s ``bf16_storage_atol`` of its passes (one
  bfloat16 rounding a pass apart), float64 within rtol 1e-15 (and 1e-15
  of the field's largest magnitude, for fields that cross zero), float32
  (the mixed domains' float32 fields) within ``TOL``;
* ``vc_diffusion`` (``c * lap + u``, contracted within a level) takes the
  same bounds at every depth.

Also pinned: XLA's float64 ``x / c`` is a multiply by the float64
reciprocal, as the port's trace emits it; captured runs equal uncaptured
runs under each dtype; the torch engine degrades bf16 storage with its
warning; the shared-memory model prices float64 planes at 8 bytes; the
ledger's new forms; buffers of another dtype than their field's are
refused.
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
from stencil_tpu.models.astaroth import AstarothSim as JAstaroth
from stencil_tpu.ops import stream as jst
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.kernels import ledger
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.ops import stream as st
from stencil_tpu_torch.ops.stream_trace import StreamKernel
from ulp import bf16_storage_atol

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
F64_RTOL = 1e-15
DTYPES = ("bf16", "f64")
_TORCH = {"bf16": torch.bfloat16, "f64": torch.float64, "f32": torch.float32}
_JAX = {"bf16": jnp.bfloat16, "f64": jnp.float64, "f32": jnp.float32}


def mean6(views, info):
    """Astaroth's kernel: the mean of the six face neighbours."""
    return {name: (src.sh(-1, 0, 0) + src.sh(0, -1, 0) + src.sh(0, 0, -1)
                   + src.sh(1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, 0, 1)) / 6.0
            for name, src in views.items()}


def k27(views, info):
    """The 27-point kernel of ``tests/test_torch_stream.py`` (reads x-1 off
    the centre: the wavefront kernel's general form)."""
    src = views["u"]
    acc = 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                acc = acc + src.sh(dx, dy, dz) / (2.0 ** (abs(dx) + abs(dy) + abs(dz)))
    return {"u": acc / 8.0}


def vc_diffusion(views, info):
    """``tests/test_stream.py:86-96``: two joint fields, the coefficient
    passing through."""
    u, c = views["u"], views["c"]
    lap = (u.sh(-1, 0, 0) + u.sh(1, 0, 0) + u.sh(0, -1, 0) + u.sh(0, 1, 0)
           + u.sh(0, 0, -1) + u.sh(0, 0, 1) - 6.0 * u.center())
    return {"u": u.center() + c.center() * lap}


#: name: (kernel, fields, contracts a multiply and an add within a level)
KERNELS = {"mean6": (mean6, ["a", "b"], False), "k27": (k27, ["u"], False),
           "vc_diffusion": (vc_diffusion, ["u", "c"], True)}


def _rand(shape, seed, scale=1.0, offset=0.0):
    return offset + scale * np.random.default_rng(seed).random(shape)


def _fields(name, shape, seed):
    """Float64 inputs of a kernel's fields; vc_diffusion's coefficient in
    [0.04, 0.06)."""
    out = [_rand(shape, seed + q) for q in range(len(KERNELS[name][1]))]
    if name == "vc_diffusion":
        out[1] = _rand(shape, seed + 1, 0.02, 0.04)
    return out


def _pair(a, dt):
    """The same data for both packages at ``dt`` (bf16 rounded once, to
    nearest even, by each)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    j = jnp.asarray(a)
    if dt == "bf16":
        t32, j32 = t.float(), j.astype(jnp.float32)
        return t32.to(torch.bfloat16), j32.astype(jnp.bfloat16)
    return t.to(_TORCH[dt]), j.astype(_JAX[dt])


def _np(x) -> np.ndarray:
    """A result as float64 numpy (bf16 upcast, exact)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _same(got, want, dt, exact, passes=1):
    """``got`` (port) against ``want`` (JAX), both at ``dt``: bitwise when
    ``exact``, else within one bf16 rounding a pass, or rtol 1e-15."""
    if isinstance(got, torch.Tensor):
        assert got.dtype == _TORCH[dt], (got.dtype, dt)
    if isinstance(want, jax.Array):
        assert want.dtype == _JAX[dt], (want.dtype, dt)
    g, w = _np(got), _np(want)
    if exact:
        np.testing.assert_array_equal(g, w)
    elif dt == "bf16":
        scale = float(np.abs(w).max()) or 1.0
        assert np.abs(g - w).max() <= bf16_storage_atol(passes, scale)
    elif dt == "f64":  # relative to the field's scale too: sine fields cross zero
        np.testing.assert_allclose(g, w, rtol=F64_RTOL, atol=F64_RTOL * float(np.abs(w).max()))
    else:
        np.testing.assert_allclose(g, w, **TOL)


# --- the division rule, measured --------------------------------------------------------


def test_xla_divides_f64_by_a_constant_as_a_reciprocal_multiply():
    """XLA on the CPU compiles ``x / c`` at float64 into ``x * (1 / c)``
    with the float64 reciprocal, in its ``jnp`` route and in the Pallas
    interpret-mode stream passes alike (a true divide differs in about a
    third of the cells); the port's trace does the same at float64, and
    keeps the float32 reciprocal at float32."""
    x = _rand((6, 8, 8), 1, 10.0, -5.0)
    xj = jnp.asarray(x)
    assert xj.dtype == jnp.float64  # the suite runs JAX with 64-bit mode on
    recip = x * (np.float64(1.0) / np.float64(6.0))
    assert np.count_nonzero(recip != x / 6.0) > x.size // 10
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: v / 6.0)(xj)), recip)

    def div6(views, info):
        return {"u": views["u"].center() / 6.0}

    org = jnp.zeros(3, jnp.int32)
    wrapped = jst.stream_wrap_pass(div6, ["u"], [xj], 1, org, JDim3(6, 8, 8), interpret=True)[0]
    np.testing.assert_array_equal(np.asarray(wrapped), recip)
    got = st.stream_wrap_pass_plain(div6, ["u"], [torch.from_numpy(x)], 1, torch.zeros(3, dtype=torch.int32),
                                    (6, 8, 8))[0]
    np.testing.assert_array_equal(got.numpy(), recip)
    # the emitted bodies: the float64 reciprocal at double, the float32 one at float
    body64 = StreamKernel(div6, ["u"], 1, (6, 8, 8), dtypes=[torch.float64]).cuda_body([1])
    assert "const double t4 = 0x1.5555555555555p-3;" in body64 and "__dmul_rn(t3, t4)" in body64
    assert "#define STP_C double" in body64
    body32 = StreamKernel(div6, ["u"], 1, (6, 8, 8)).cuda_body([1])
    assert "const float t4 = 0x1.5555560000000p-3f;" in body32 and "__fmul_rn(t3, t4)" in body32
    assert "#define STP_C float" in body32


def test_emitted_types_per_field():
    """The generated part's types: one storage for all, bf16 with float
    levels, or float with double (each double field's pointer cast)."""
    def body(dtypes):
        return StreamKernel(vc_diffusion, ["u", "c"], 1, (8, 8, 8), dtypes=dtypes).cuda_body([1])

    f32 = body([torch.float32] * 2)
    assert "#define STP_S float" in f32 and "#define STP_LD(p, q, i) p[i]" in f32 and "STP_WIDE" not in f32
    bf = body([torch.bfloat16] * 2)
    assert "#define STP_S __nv_bfloat16" in bf and "#define STP_C float" in bf and "STP_SCRATCH" in bf
    mixed = body([torch.float32, torch.float64])
    assert "#define STP_C double" in mixed and "#define STP_WIDE 0x2" in mixed
    # the float field's loads come in at float, its output at float
    assert "const float t3 = ld(0, -1, 0, 0);" in mixed and "__double2float_rn(" in mixed
    with pytest.raises(TypeError, match="one dtype"):
        body([torch.bfloat16, torch.float32])


# --- the plain versions against the JAX passes --------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("k", [1, 3])
def test_wrap_plain_vs_pallas(dt, name, k):
    kern, names, contracts = KERNELS[name]
    shape, gs = (10, 12, 14), (10, 12, 14)
    pairs = [_pair(a, dt) for a in _fields(name, shape, 11)]
    origin = np.array([0, 0, 0], np.int32)
    got = st.stream_wrap_pass_plain(kern, names, [p[0] for p in pairs], k, torch.from_numpy(origin), gs)
    want = jst.stream_wrap_pass(kern, names, [p[1] for p in pairs], k, jnp.asarray(origin), JDim3(*gs),
                                interpret=True, f32_accumulate=dt == "bf16")
    for g, w in zip(got, want):
        _same(g, w, dt, exact=k == 1 and not contracts)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plane_plain_vs_pallas(dt, name):
    kern, names, contracts = KERNELS[name]
    lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
    shape, gs = (9, 10, 12), (20, 30, 40)
    pairs = [_pair(a, dt) for a in _fields(name, shape, 21)]
    origin = np.array([3, 5, 7], np.int32)
    got = st.stream_plane_pass_plain(kern, names, [p[0] for p in pairs], lo, hi, 1, torch.from_numpy(origin), gs)
    want = jst.stream_plane_pass(kern, names, [p[1] for p in pairs], JDim3(*lo), JDim3(*hi), 1,
                                 jnp.asarray(origin), JDim3(*gs), interpret=True, f32_accumulate=dt == "bf16")
    for g, w in zip(got, want):
        _same(g, w, dt, exact=not contracts)


def _fused_bufs(n, X, Y, Z, lo, hi, nf, seed, dt):
    """Fused shell buffers per field at ``dt``: the port's layouts and the
    JAX package's (``tests/test_torch_stream_fused.py``)."""
    port, jax_ = ([], [], []), ([], [], [])
    for q in range(nf):
        for j, (shape, perm) in enumerate((((n, lo.x + hi.x, Y, Z), (0, 1, 2, 3)),
                                           ((n, lo.y + hi.y, X, Z), (0, 2, 1, 3)),
                                           ((n, lo.z + hi.z, Y, X), (0, 3, 1, 2)))):
            t, a = _pair(_rand(shape, seed + 10 * j + q), dt)
            port[j].append(t[0])
            jax_[j].append(a.transpose(perm)[0])
    return port, jax_


@pytest.mark.parametrize("dt", DTYPES)
def test_plane_plain_fused_vs_pallas(dt):
    lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
    X, Y, Z = 9, 10, 12
    gs = (20, 30, 40)
    pairs = [_pair(a, dt) for a in _fields("mean6", (X, Y, Z), 31)]
    pf, jf = _fused_bufs(1, X, Y, Z, lo, hi, 2, 40, dt)
    origin = np.array([3, 5, 7], np.int32)
    got = st.stream_plane_pass_plain(mean6, ["a", "b"], [p[0] for p in pairs], lo, hi, 1,
                                     torch.from_numpy(origin), gs, fused_shell=pf)
    want = jst.stream_plane_pass(mean6, ["a", "b"], [p[1] for p in pairs], JDim3(*lo), JDim3(*hi), 1,
                                 jnp.asarray(origin), JDim3(*gs), interpret=True, f32_accumulate=dt == "bf16",
                                 fused_shell=jf)
    for g, w in zip(got, want):
        _same(g, w, dt, exact=True)


#: the wavefront's forms: (kernel, z slabs, fused)
WAVEFRONT_FORMS = {"queue": ("mean6", False, False), "general": ("k27", False, False),
                   "zslab": ("mean6", True, False), "zslab_general": ("k27", True, False),
                   "fused": ("mean6", False, True), "two_fields": ("vc_diffusion", True, False)}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("form", sorted(WAVEFRONT_FORMS))
@pytest.mark.parametrize("deep", [False, True])
def test_wavefront_plain_vs_pallas(dt, form, deep):
    """Depth 1, and the deepest the shared-memory model lets the kernel run
    over these fields (m = 3, or 2 for two float64 fields)."""
    name, slabs, fused = WAVEFRONT_FORMS[form]
    kern, names, contracts = KERNELS[name]
    m = 1 if not deep else 2 if dt == "f64" and len(names) == 2 else 3
    s = 3
    Xr, Yr, Zr = 11, 12, 14
    zv = Zr - 1 if slabs else Zr
    gs = (20, 30, 40)
    pairs = [_pair(a, dt) for a in _fields(name, (Xr, Yr, Zr), 51)]
    origin = np.array([4, 2, 9], np.int32)
    kw_t, kw_j = {}, {}
    if slabs:
        zp = [_pair(_rand((Xr, 2 * s, Yr), 61 + q), dt) for q in range(len(names))]
        kw_t.update(z_slabs=[p[0] for p in zp], z_valid=zv)
        kw_j.update(z_slabs=[p[1] for p in zp], z_valid=zv)
    if fused:
        s3 = Dim3(s, s, s)
        pf, jf = _fused_bufs(1, Xr, Yr, Zr, s3, s3, len(names), 70, dt)
        kw_t["fused_shell"], kw_j["fused_shell"] = pf, jf
    got, gz = st.stream_wavefront_pass_plain(kern, names, [p[0] for p in pairs], m, s, torch.from_numpy(origin),
                                             gs, **kw_t)
    want, wz = jst.stream_wavefront_pass(kern, names, [p[1] for p in pairs], m, s, jnp.asarray(origin),
                                         JDim3(*gs), interpret=True, f32_accumulate=dt == "bf16", **kw_j)
    exact = m == 1 and not contracts
    S, Sz = slice(s, -s), slice(s, zv - s)
    for g, w in zip(got, want):
        _same(g[S, S, Sz], np.asarray(w)[S, S, Sz].astype(np.float64) if dt == "bf16" else w[S, S, Sz], dt,
              exact, passes=1)
    if slabs:
        for g, w in zip(gz, wz):
            assert g.dtype == _TORCH[dt]
            _same(g[S, :, S], np.asarray(w)[S, :, S].astype(np.float64) if dt == "bf16" else w[S, :, S], dt,
                  exact, passes=1)
    else:
        assert gz is None


# --- the wrappers' checks --------------------------------------------------------------------


def test_buffers_of_another_dtype_than_their_field_are_refused():
    org = torch.zeros(2, 3, dtype=torch.int32)
    lo = hi = Dim3(1, 1, 1)
    raws = [torch.zeros(2, 6, 7, 8, dtype=torch.float64), torch.zeros(2, 6, 7, 8)]
    st.stream_plane_pass(mean6, ["a", "b"], raws, lo, hi, 1, org, (8, 8, 8))  # float32 with float64 runs
    with pytest.raises(TypeError, match="torch.float64 \\(its field's dtype\\)"):
        st.stream_plane_pass(mean6, ["a", "b"], raws, lo, hi, 1, org, (8, 8, 8),
                             out=[torch.zeros(2, 6, 7, 8), torch.zeros(2, 6, 7, 8)])
    with pytest.raises(TypeError, match="bfloat16 fields stream only"):
        st.stream_plane_pass(mean6, ["a", "b"], [raws[1].bfloat16(), raws[1]], lo, hi, 1, org, (8, 8, 8))
    with pytest.raises(TypeError, match="float32, torch.bfloat16 or torch.float64"):
        st.stream_plane_pass(mean6, ["a"], [raws[1].half()], lo, hi, 1, org, (8, 8, 8))
    b = [torch.zeros(2, 8, 8, 8, dtype=torch.bfloat16)]
    with pytest.raises(TypeError, match="z_slabs must be torch.bfloat16"):
        st.stream_wavefront_pass(mean6, ["a"], b, 1, 2, org, (8, 8, 8), z_slabs=[torch.zeros(2, 8, 4, 8)])
    # a traced kernel holds its fields' dtypes
    sk = StreamKernel(mean6, ["a"], 1, (8, 8, 8))
    with pytest.raises(TypeError, match="dtypes"):
        st.stream_wavefront_pass(sk, ["a"], b, 1, 2, org, (8, 8, 8))


def test_smem_model_prices_each_dtype():
    """The planes are kept at the compute type: 4 bytes under bf16 storage
    (float levels), 8 for float64 (the JAX package's ``ring_itemsizes``)."""
    assert st.ring_itemsize([torch.bfloat16]) == st.ring_itemsize([torch.float32]) == 4
    assert st.ring_itemsize([torch.float64]) == st.ring_itemsize([torch.float32, torch.float64]) == 8
    assert st.stream_smem_bytes(3, 1, 8) == 2 * st.stream_smem_bytes(3, 1) == 155_648
    assert st.stream_smem_fits(3, 1, 8) and not st.stream_smem_fits(3, 2, 8) and st.stream_smem_fits(2, 2, 8)


def test_ledger_lists_the_dtype_forms():
    names = [f"stream_{fn}_pass_{dt}" for fn in ("wrap", "plane", "wavefront") for dt in DTYPES]
    names += [f"stream_{fn}_pass_fused_{dt}" for fn in ("plane", "wavefront") for dt in DTYPES]
    assert set(names) <= set(ledger.FORMS)
    counts = ledger.launch_counts()
    assert all(isinstance(counts[n], int) for n in names)
    assert ledger.counter("stream_wavefront_pass_fused_f64") == (st.stream_wavefront_pass, "fused_f64_launches")


# --- steps on a domain against the JAX package's ------------------------------------------------

N = 16


def _domains(dts, subdomains=8, radius=1, mult=1, route=None, bf16=False, seed=5):
    """A port and a JAX domain with fields of ``dts`` (f32 / f64) holding the
    same seeded values, bf16 storage when ``bf16``."""
    td = DistributedDomain(N, N, N, device="cpu")
    jd = JDomain(N, N, N)
    for d in (td, jd):
        d.set_radius(Radius.constant(radius) if d is td else JRadius.constant(radius))
        if mult > 1:
            d.set_halo_multiplier(mult)
        if route is not None:
            d.set_exchange_route(route)
    td.set_subdomains(subdomains)
    jd.set_devices(jax.devices()[:subdomains])
    ths = [td.add_data(f"q{i}", dtype=_TORCH[d]) for i, d in enumerate(dts)]
    jhs = [jd.add_data(f"q{i}", dtype=_JAX[d]) for i, d in enumerate(dts)]
    if bf16:
        td.set_storage("bf16")
        jd.set_storage("bf16")
    td.realize()
    jd.realize()
    for i, (a, b) in enumerate(zip(ths, jhs)):
        v = _rand((N, N, N), seed + i)
        td.set_quantity(a, v.astype(np.float32) if dts[i] == "f32" else v)
        jd.set_quantity(b, v.astype(np.float32) if dts[i] == "f32" else v)
    return td, ths, jd, jhs


def _quantities(dd, hs):
    return [np.asarray(dd.quantity_to_host(h)).astype(np.float64) for h in hs]


@pytest.mark.parametrize("subdomains", [1, 8])
@pytest.mark.parametrize("path", ["auto", "plane"])
def test_bf16_domain_stream_step_vs_jax(subdomains, path):
    """The counterpart of ``tests/test_kernel_axes.py:370``: a bf16-storage
    domain under the stream engine, the port's plain versions against the
    JAX passes in interpret mode (plane bitwise; wrap and wavefront within
    a bf16 rounding a pass)."""
    td, th, jd, jh = _domains(["f32"], subdomains, mult=2, bf16=True)
    assert td.get_curr(th[0]).dtype == torch.bfloat16
    ts = td.make_step(mean6, engine="stream", stream_path=path)
    js = jd.make_step(mean6, engine="stream", interpret=True, stream_path=path)
    plan = ts._stream_plan
    assert plan["route"] == js._stream_plan["route"] and plan["f32_accumulate"]
    steps = 5
    td.run_step(ts, steps)
    jd.run_step(js, steps)
    for g, w in zip(_quantities(td, th), _quantities(jd, jh)):
        _same(g, w, "bf16", exact=plan["route"] == "plane", passes=steps)


@pytest.mark.parametrize("subdomains", [1, 8])
@pytest.mark.parametrize("path", ["auto", "plane"])
def test_f64_domain_stream_step_vs_jax(subdomains, path):
    """A float64 domain under the stream engine: bitwise against the JAX
    package's XLA (jnp) engine, and against its interpret-mode stream
    passes on the plane route (rtol 1e-15 on the others)."""
    td, th, jd, jh = _domains(["f64", "f64"], subdomains, mult=3)
    jr, jrh = _domains(["f64", "f64"], subdomains)[2:]  # the XLA engine's steps are raw at multiplier 1
    ts = td.make_step(mean6, engine="stream", stream_path=path)
    js = jd.make_step(mean6, engine="stream", interpret=True, stream_path=path)
    ref = jr.make_step(mean6, overlap=False)
    plan = ts._stream_plan
    assert plan["route"] == js._stream_plan["route"] and not plan["f32_accumulate"]
    if plan["route"] == "wavefront":  # two joint float64 fields: 8-byte planes (ROADMAP.md queue 3)
        assert plan["m"] == 2 and js._stream_plan["m"] == 3
    steps = 7
    td.run_step(ts, steps)
    jd.run_step(js, steps)
    jr.run_step(ref, steps)
    for g, w, x in zip(_quantities(td, th), _quantities(jd, jh), _quantities(jr, jrh)):
        np.testing.assert_array_equal(g, x)
        _same(g, w, "f64", exact=plan["route"] == "plane")


def test_f64_two_field_kernel_plans_shallower():
    """Two joint float64 fields at shell 3: the Hopper model prices the
    planes at 8 bytes and plans m = 2 where float32 plans m = 3 (ROADMAP.md
    queue 3); the run is right all the same."""
    td, th = _domains(["f64", "f64"], 8, mult=3, seed=9)[:2]
    jd, jh = _domains(["f64", "f64"], 8, seed=9)[2:]  # the XLA engine's steps are raw at multiplier 1
    ts = td.make_step(vc_diffusion_q, engine="stream")
    assert ts._stream_plan["route"] == "wavefront" and ts._stream_plan["m"] == 2
    js = jd.make_step(vc_diffusion_q, overlap=False)
    td.run_step(ts, 4)
    jd.run_step(js, 4)
    for g, w in zip(_quantities(td, th), _quantities(jd, jh)):
        np.testing.assert_allclose(g, w, rtol=F64_RTOL, atol=0)


def vc_diffusion_q(views, info):
    """``vc_diffusion`` over a domain's fields ``q0`` (diffused) and ``q1``
    (the coefficient)."""
    u, c = views["q0"], views["q1"]
    lap = (u.sh(-1, 0, 0) + u.sh(1, 0, 0) + u.sh(0, -1, 0) + u.sh(0, 1, 0)
           + u.sh(0, 0, -1) + u.sh(0, 0, 1) - 6.0 * u.center())
    return {"q0": u.center() + 0.01 * c.center() * lap}


@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("path", ["plane", "auto"])
def test_mixed_f32_f64_domain_vs_jax(mode, path):
    """Float32 and float64 quantities in one joint group (the counterparts
    of ``tests/test_stream_fused.py:128`` and ``tests/test_overlap_split.py:149``):
    each computes at its own dtype, the fused exchange packs each at its
    own; against the JAX package's same schedule, and bitwise against the
    port's array form."""
    kw = {"stream_halo": "fused"} if mode == "fused" else {"stream_overlap": "split"}
    route = "yzpack_xla" if mode == "fused" else None
    td, th, jd, jh = _domains(["f32", "f64"], 8, mult=3, route=route)
    ta, tah = _domains(["f32", "f64"], 8, mult=3, route=route)[:2]
    ts = td.make_step(mean6, engine="stream", stream_path=path, **kw)
    tarr = ta.make_step(mean6, engine="stream", stream_path=path, stream_z_slabs=False)
    js = jd.make_step(mean6, engine="stream", interpret=True, stream_path=path, **kw)
    plan = ts._stream_plan
    assert plan[{"fused": "halo", "split": "overlap"}[mode]] == mode
    assert plan["route"] == js._stream_plan["route"] and plan["m"] == tarr._stream_plan["m"]
    steps = 4
    ledger.reset_launch_counts()
    for d, s in ((td, ts), (ta, tarr), (jd, js)):
        d.run_step(s, steps)
    exact = plan["route"] == "plane"
    for q, (g, a, w) in enumerate(zip(_quantities(td, th), _quantities(ta, tah), _quantities(jd, jh))):
        np.testing.assert_array_equal(g, a)
        _same(g, w, ("f32", "f64")[q], exact)


# --- the models ------------------------------------------------------------------------------


def _jax_model(subdomains, **kw):
    m = JAstaroth(N, N, N, num_quantities=2, devices=jax.devices()[:subdomains], **kw)
    m.realize()
    return m


def _port_model(subdomains, **kw):
    m = AstarothSim(N, N, N, num_quantities=2, subdomains=subdomains, device="cpu", **kw)
    m.realize()
    return m


ROUTES = {(1, "auto"): "wrap", (8, "auto"): "wavefront", (1, "per-step"): "plane",
          (8, "per-step"): "plane", (1, "wavefront"): "wavefront", (8, "wavefront"): "wavefront"}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("subdomains", [1, 8])
@pytest.mark.parametrize("schedule", ["auto", "per-step", "wavefront"])
def test_astaroth_dtypes_vs_jax(dt, subdomains, schedule):
    """``AstarothSim(storage_dtype="bf16")`` and ``AstarothSim(dtype=
    float64)`` on the CUDA engine (plain versions here) against the JAX
    package's pallas engine in interpret mode, from its state: the plane
    route bitwise, the others within a bf16 rounding a pass or rtol 1e-15."""
    kw_t = {"storage_dtype": "bf16"} if dt == "bf16" else {"dtype": torch.float64}
    kw_j = {"storage_dtype": "bf16"} if dt == "bf16" else {"dtype": jnp.float64}
    j = _jax_model(subdomains, kernel_impl="pallas", interpret=True, schedule=schedule, **kw_j)
    t = _port_model(subdomains, kernel_impl="cuda", schedule=schedule, **kw_t)
    plan = t._step._stream_plan
    assert plan["route"] == j._step._stream_plan["route"] == ROUTES[(subdomains, schedule)]
    assert t._wavefront_m == j._wavefront_m
    assert t.dd.get_curr(t.handles[0]).dtype == _TORCH[dt]
    assert plan["f32_accumulate"] == (dt == "bf16")
    t.load_state([np.asarray(j.dd.raw_to_host(h)) for h in j.handles])
    steps = 5
    ledger.reset_launch_counts()
    for m in (j, t):
        m.step(steps)
    assert all(v == 0 for v in ledger.launch_counts().values())  # the CPU runs the plain versions
    passes = steps if plan["route"] != "wavefront" else 2
    for q in range(2):
        got, want = t.field(q), np.asarray(j.field(q))
        assert got.dtype == want.dtype == (np.float32 if dt == "bf16" else np.float64)
        _same(got.astype(np.float64), want.astype(np.float64), dt, exact=plan["route"] == "plane",
              passes=passes)


@pytest.mark.parametrize("subdomains", [1, 8])
def test_astaroth_f64_vs_jnp(subdomains):
    """The JAX package's XLA engine is the oracle without cross-level
    fusion: at float64 every port route, and the torch engine, equal it bit
    for bit."""
    j = _jax_model(subdomains, dtype=jnp.float64)
    start = [np.asarray(j.dd.raw_to_host(h)) for h in j.handles]
    j.step(5)
    want = [np.asarray(j.field(q)) for q in range(2)]
    for kw in ({"kernel_impl": "cuda", "schedule": "auto"}, {"kernel_impl": "cuda", "schedule": "per-step"},
               {"kernel_impl": "cuda", "schedule": "wavefront"}, {"kernel_impl": "torch"}):
        t = _port_model(subdomains, dtype=torch.float64, **kw)
        t.load_state(start)
        t.step(5)
        for q in range(2):
            assert t.field(q).dtype == np.float64
            np.testing.assert_array_equal(t.field(q), want[q])


def test_torch_engine_degrades_bf16_storage():
    """The torch engine has no f32-accumulate kernels: a bf16 request
    degrades to native with a warning, as the JAX package's XLA engine
    degrades it; non-f32 fields degrade on the CUDA engine too."""
    with pytest.warns(RuntimeWarning, match="storage_dtype=bf16 .* cannot engage for astaroth:torch"):
        t = _port_model(1, storage_dtype="bf16")
    assert t._storage_dtype == "native" and t.dd.get_curr(t.handles[0]).dtype == torch.float32
    with pytest.warns(RuntimeWarning, match="not f32"):
        t = _port_model(1, kernel_impl="cuda", storage_dtype="bf16", dtype=torch.float64)
    assert t.dd.get_curr(t.handles[0]).dtype == torch.float64
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = _port_model(1, kernel_impl="cuda", storage_dtype="bf16")
    assert t._storage_dtype == "bf16" and t.dd.storage_dtype() == "bf16"
    # the contraction half of item 9 is ported (tests/test_torch_stream_mxu.py):
    # the torch engine has no contraction kernels and degrades it with a
    # warning, and bf16 storage qualifies for it on the CUDA engine
    with pytest.warns(RuntimeWarning, match="compute_unit=mxu .* cannot engage for astaroth:torch"):
        m = AstarothSim(8, 8, 8, device="cpu", storage_dtype="bf16", compute_unit="mxu")
        m.realize()
    assert m._compute_unit == "vpu"
    m = AstarothSim(8, 8, 8, kernel_impl="cuda", device="cpu", storage_dtype="bf16", compute_unit="mxu",
                    mxu_input="bf16")
    m.realize()
    assert (m._compute_unit, m._mxu_input, m._step._stream_plan["f32_accumulate"]) == ("mxu", "bf16", True)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("schedule,subdomains", [("auto", 1), ("per-step", 8), ("wavefront", 8)])
def test_captured_equals_uncaptured(dt, schedule, subdomains):
    """The captured step loop under each dtype: bitwise the uncaptured run,
    the launch counts alike (none on the CPU)."""
    kw = {"storage_dtype": "bf16"} if dt == "bf16" else {"dtype": torch.float64}
    runs = []
    for capture in (False, True):
        t = _port_model(subdomains, kernel_impl="cuda", schedule=schedule, capture=capture, **kw)
        t.step(4)
        t.step(3)
        runs.append([t.field(q) for q in range(2)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_c_entries_match_their_ctypes_signatures():
    """Each stream template's C entries, and each plain source's and build
    variant's (the Jacobi builds' mean-of-6 entries, the mean-of-6 plane
    kernel's dtype entries), take as many arguments as ``kernels/build.py``
    binds (ctypes passes surplus arguments through unchecked, so a parameter
    added to a C entry and not to its binding shifts the stream handle)."""
    import os
    import re

    from stencil_tpu_torch.kernels import build

    tables = [(build.TEMPLATE_FILES.get(t, t), e) for t, e in build.TEMPLATE_SIGNATURES.items()]
    tables += list(build.SIGNATURES.items())
    for source, entries in tables:
        with open(build.source_path(source)) as f:
            text = f.read()
        params = {name: len([p for p in args.split(",") if p.strip()])
                  for name, args in re.findall(r"^int (stp_\w+)\(([^)]*)\)", text, flags=re.M | re.S)}
        for fn, argtypes in entries.items():
            assert params[fn] == len(argtypes), (source, fn, params[fn], len(argtypes))
    assert os.path.basename(build.source_path("stream_wrap")) == "stream_wrap.cu"
    assert os.path.basename(build.source_path("jacobi_wavefront_f64")) == "jacobi_wavefront.cu"
