"""The contraction form (``compute_unit`` ``mxu`` / ``mxu_band``, ``mxu_input``
``f32`` / ``bf16``) of the stream kernels (#6 ``stream_wrap_pass``, #7
``stream_plane_pass``, #8 ``stream_wavefront_pass``) and the mean-of-6
kernels (#17 ``mean6_shell_wavefront_step``, #18 ``mean6_plane_step``)
against the JAX package's, on the CPU.

The seam is ``PlaneView.plane_nbr_sum`` (``stencil_tpu/ops/stream.py:189-200``):
under ``vpu`` the trace expands it to four loads, under a contracting unit it
is one node that each pass's plain version computes as the band contraction
over the whole plane of the pass.  Tolerances, and why:

* bitwise at depth 1 (and on the plane route at every depth): the port's
  band matmul sums the same two cells an axis as the JAX package's, and the
  level ``(x-1 + x+1) + nbr`` rounds the same;
* deeper, within ``rtol=1e-6, atol=1e-6``: the JAX interpret-mode passes
  fuse a level's multiply into the next level's adds on the CPU (the FMA
  note of ROADMAP.md queue 3); bf16 storage within ``tests/ulp.py``'s
  ``bf16_storage_atol`` a pass (one bfloat16 rounding a pass apart); bf16
  operands within its ``mxu_bf16_input_atol`` a level (an f32 value one ulp
  apart may round to another bfloat16 operand at the next level).

Also pinned: the vpu source the seam emits is byte for byte the parent's;
``make_stream_step`` plans as the JAX package's on 1 and 8 subdomains;
``AstarothSim(compute_unit=...)`` on every schedule; every degrade warns and
lands where the JAX package lands; unknown values raise ``ValueError``; the
fused halo and the split schedule under a unit plan and run
(``tests/test_torch_stream_mxu_fused.py`` holds their values against the JAX
package).
"""

import hashlib
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
from stencil_tpu.ops import plane_stencil as jps
from stencil_tpu.ops import stream as jst
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.kernels import ledger
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops import plane_stencil as ps
from stencil_tpu_torch.ops import stream as st
from stencil_tpu_torch.ops.stream_trace import StreamKernel, x_reads_centred
from ulp import bf16_storage_atol, mxu_bf16_input_atol

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
AXES = [("mxu", "f32"), ("mxu", "bf16"), ("mxu_band", "f32"), ("mxu_band", "bf16")]
STORAGES = ("f32", "bf16")


def mean6_kernel(views, info):
    """``tests/test_kernel_axes.py``'s vpu kernel (Astaroth's)."""
    return {name: (src.sh(-1, 0, 0) + src.sh(0, -1, 0) + src.sh(0, 0, -1)
                   + src.sh(1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, 0, 1)) / 6.0
            for name, src in views.items()}


def mean6_kernel_mxu(views, info):
    """``tests/test_kernel_axes.py``'s declared contraction form: the same
    mean with the four in-plane taps through ``plane_nbr_sum``."""
    return {name: (src.sh(-1, 0, 0) + src.sh(1, 0, 0) + src.plane_nbr_sum()) / 6.0
            for name, src in views.items()}


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape) - 0.5


def _pair(a, storage):
    """The same data for both packages: float32, or bf16 storage (rounded
    once to nearest even by each)."""
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


# --- the tracer seam ----------------------------------------------------------------------

#: sha256 of the generated part the parent emitted for Astaroth's ``_kernel``
#: over one float32 field, and over two bf16-storage fields (levels 1-3)
PARENT_VPU_BODIES = {
    "f32x1": "cc93e09ad994b5ddc4f367202e4ada3f406b84fe74cb5032cc2d94c5df840dda",
    "bf16x2": "ed2d3c1f9720603391a52891630775b9abcae5731f75cbb4291e57548d280e0e",
}


def test_vpu_source_is_the_parents():
    for key, (names, dts) in {"f32x1": (["d0"], None), "bf16x2": (["a", "b"], [torch.bfloat16] * 2)}.items():
        body = StreamKernel(AstarothSim._kernel, names, 1, (16, 16, 16), dtypes=dts).cuda_body([1, 2, 3])
        assert hashlib.sha256(body.encode()).hexdigest() == PARENT_VPU_BODIES[key], key
        assert "STP_NBR_MASK" not in body and "nb(" not in body


def test_plane_nbr_sum_under_vpu_is_the_load_chain():
    """Under vpu the seam traces to y+1, y-1, z+1, z-1 in that order, and the
    mxu form evaluates bitwise as that chain summed after x-1 + x+1."""
    sk = StreamKernel(mean6_kernel_mxu, ["u"], 1, (12, 12, 12))
    loads = [n.args[1:] for n in sk.trace(1).live() if n.op == "load"]
    assert loads == [(-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    assert not sk.uses_nbr() and "STP_NBR_MASK" not in sk.cuda_body([1])
    u = torch.from_numpy(_rand((10, 12, 14), 1)).float()
    got = sk.evaluate(lambda q, dx, dy, dz: st._roll(u, dx, dy, dz), None, u.device)[0]
    sh = lambda dx, dy, dz: st._roll(u, dx, dy, dz)  # noqa: E731
    chain = sh(0, 1, 0) + sh(0, -1, 0) + sh(0, 0, 1) + sh(0, 0, -1)
    assert torch.equal(got, (sh(-1, 0, 0) + sh(1, 0, 0) + chain) * np.float32(1 / 6))


@pytest.mark.parametrize("unit,mi", AXES)
def test_contraction_trace_and_emit(unit, mi):
    sk = StreamKernel(mean6_kernel_mxu, ["a", "b"], 1, (12, 12, 12), compute_unit=unit, mxu_input=mi)
    nodes = [n for n in sk.trace(1).live() if n.op == "nbr"]
    assert [n.args for n in nodes] == [(0, unit, mi), (1, unit, mi)]
    assert sk.uses_nbr() and x_reads_centred([sk.trace(1)])
    body = sk.cuda_body([1, 2])
    assert "#define STP_NBR_MASK 0x3" in body and f"#define STP_MXU {1 if mi == 'f32' else 2}" in body
    assert "nb(0)" in body and "nb(1)" in body and "const Nb& nb" in body
    assert "#define STP_X_QUEUE 1" in st._source(sk, *st._wavefront_variant(3))
    with pytest.raises(TypeError, match="no plane to contract"):
        sk.evaluate(lambda q, dx, dy, dz: torch.zeros(2), None, "cpu")
    with pytest.raises(TypeError, match="float32"):
        StreamKernel(mean6_kernel_mxu, ["u"], 1, (8, 8, 8), dtypes=[torch.float64], compute_unit=unit).trace(1)


# --- the plain versions against the JAX passes --------------------------------------------


def _jax_axes(unit, mi, storage):
    return dict(interpret=True, compute_unit=unit, mxu_input=mi, f32_accumulate=storage == "bf16")


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("unit,mi", AXES)
@pytest.mark.parametrize("k", [1, 3])
def test_wrap_plain_vs_pallas(storage, unit, mi, k):
    shape, gs = (10, 16, 24), (10, 16, 24)
    pairs = [_pair(_rand(shape, 11 + q), storage) for q in range(2)]
    origin = np.zeros(3, np.int32)
    got = st.stream_wrap_pass_plain(mean6_kernel_mxu, ["a", "b"], [p[0] for p in pairs], k,
                                    torch.from_numpy(origin), gs, compute_unit=unit, mxu_input=mi)
    want = jst.stream_wrap_pass(mean6_kernel_mxu, ["a", "b"], [p[1] for p in pairs], k, jnp.asarray(origin),
                                JDim3(*gs), **_jax_axes(unit, mi, storage))
    for g, w in zip(got, want):
        assert g.dtype == pairs[0][0].dtype
        _same(g, w, storage, exact=k == 1, mi=mi, levels=k)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("unit,mi", AXES)
def test_plane_plain_vs_pallas(storage, unit, mi):
    lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
    shape, gs = (9, 16, 12), (20, 30, 40)
    pairs = [_pair(_rand(shape, 21 + q), storage) for q in range(2)]
    origin = np.array([3, 5, 7], np.int32)
    got = st.stream_plane_pass_plain(mean6_kernel_mxu, ["a", "b"], [p[0] for p in pairs], lo, hi, 1,
                                     torch.from_numpy(origin), gs, compute_unit=unit, mxu_input=mi)
    want = jst.stream_plane_pass(mean6_kernel_mxu, ["a", "b"], [p[1] for p in pairs], JDim3(*lo), JDim3(*hi), 1,
                                 jnp.asarray(origin), JDim3(*gs), **_jax_axes(unit, mi, storage))
    for g, w in zip(got, want):
        _same(g, w, storage, exact=True)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("unit,mi", AXES)
@pytest.mark.parametrize("slabs", [False, True])
@pytest.mark.parametrize("m", [1, 3])
def test_wavefront_plain_vs_pallas(storage, unit, mi, slabs, m):
    """The queue-form kernel (``_kernel_mxu`` reads x-1 and x+1 at the
    centre), plain and z-slab layouts, depth 1 and 3."""
    s = 3
    Xr, Yr, Zr = 11, 16, 24
    zv = Zr - 2 if slabs else Zr
    gs = (20, 30, 40)
    pairs = [_pair(_rand((Xr, Yr, Zr), 51 + q), storage) for q in range(2)]
    origin = np.array([4, 2, 9], np.int32)
    kw_t, kw_j = {}, {}
    if slabs:
        zp = [_pair(_rand((Xr, 2 * s, Yr), 61 + q), storage) for q in range(2)]
        kw_t.update(z_slabs=[p[0] for p in zp], z_valid=zv)
        kw_j.update(z_slabs=[p[1] for p in zp], z_valid=zv)
    got, gz = st.stream_wavefront_pass_plain(mean6_kernel_mxu, ["a", "b"], [p[0] for p in pairs], m, s,
                                             torch.from_numpy(origin), gs, compute_unit=unit, mxu_input=mi, **kw_t)
    want, wz = jst.stream_wavefront_pass(mean6_kernel_mxu, ["a", "b"], [p[1] for p in pairs], m, s,
                                         jnp.asarray(origin), JDim3(*gs), **_jax_axes(unit, mi, storage), **kw_j)
    S, Sz = slice(s, -s), slice(s, zv - s)
    for g, w in zip(got, want):
        _same(g[S, S, Sz], np.asarray(w)[S, S, Sz], storage, exact=m == 1, mi=mi, levels=m)
    for g, w in zip(gz or [], wz or []):
        _same(g[S, :, S], np.asarray(w)[S, :, S], storage, exact=m == 1, mi=mi, levels=m)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("unit,mi", AXES)
def test_mean6_plane_plain_vs_pallas(storage, unit, mi):
    lo, hi = Dim3(1, 2, 3), Dim3(2, 1, 1)
    t, j = _pair(_rand((10, 16, 24), 71), storage)
    got = ps.mean6_plane_step_plain(t, lo, hi, compute_unit=unit, f32_accumulate=storage == "bf16", mxu_input=mi)
    want = jps.mean6_plane_step(j, JDim3(*lo), JDim3(*hi), **_jax_axes(unit, mi, storage))
    assert got.dtype == t.dtype
    _same(got, want, storage, exact=True)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("unit,mi", AXES)
@pytest.mark.parametrize("m", [1, 2, 3])
def test_mean6_wavefront_plain_vs_pallas(storage, unit, mi, m):
    s = 3
    t, j = _pair(_rand((14, 16, 24), 81), storage)
    got = ps.mean6_shell_wavefront_step_plain(t, m, s, compute_unit=unit, f32_accumulate=storage == "bf16",
                                              mxu_input=mi)
    want = jps.mean6_shell_wavefront_step(j, m, s, **_jax_axes(unit, mi, storage))
    core = (slice(s, -s),) * 3
    _same(got[core], np.asarray(want)[core], storage, exact=m == 1, mi=mi, levels=m)


def test_plane_nbr_sum_host_batched():
    """``plane_nbr_sum_host`` over batched planes: each plane as the 2-D
    call gives it, and the blocked band form bitwise the dense circulants
    (the same two cells an axis), on both operand precisions."""
    c = torch.from_numpy(_rand((3, 5, 16, 24), 91)).float()
    for unit in ("vpu", "mxu", "mxu_band"):
        for mi in ("f32", "bf16"):
            got = jk.plane_nbr_sum_host(c, unit, mxu_input=mi)
            assert torch.equal(got[1, 2], jk.plane_nbr_sum_host(c[1, 2], unit, mxu_input=mi))
            if unit == "mxu_band":
                assert torch.equal(got, jk.plane_nbr_sum_host(c, "mxu", mxu_input=mi))


# --- the engine and the model ---------------------------------------------------------------

N = 16


def _domains(subdomains, bf16=False, seed=5, route=None):
    td = DistributedDomain(N, N, N, device="cpu")
    jd = JDomain(N, N, N)
    for d, rad in ((td, Radius), (jd, JRadius)):
        d.set_radius(rad.constant(1))
        d.set_halo_multiplier(3)
        if route is not None:
            d.set_exchange_route(route)
    td.set_subdomains(subdomains)
    jd.set_devices(jax.devices()[:subdomains])
    th = [td.add_data(f"q{i}", dtype=torch.float32) for i in range(2)]
    jh = [jd.add_data(f"q{i}", dtype=jnp.float32) for i in range(2)]
    if bf16:
        td.set_storage("bf16")
        jd.set_storage("bf16")
    td.realize()
    jd.realize()
    for i, (a, b) in enumerate(zip(th, jh)):
        v = _rand((N, N, N), seed + i).astype(np.float32)
        td.set_quantity(a, v)
        jd.set_quantity(b, v)
    return td, th, jd, jh


def _quantities(dd, hs):
    return [np.asarray(dd.quantity_to_host(h)).astype(np.float64) for h in hs]


@pytest.mark.parametrize("subdomains", [1, 8])
@pytest.mark.parametrize("path", ["auto", "plane"])
@pytest.mark.parametrize("unit,mi,bf16", [("mxu", "f32", False), ("mxu_band", "bf16", False),
                                          ("mxu", "bf16", True)])
def test_stream_step_vs_jax(subdomains, path, unit, mi, bf16):
    """``make_stream_step(compute_unit=..., mxu_kernel=...)`` against the JAX
    domain: equal plans and the same fields (the plane route bitwise)."""
    td, th, jd, jh = _domains(subdomains, bf16)
    kw = dict(engine="stream", stream_path=path, compute_unit=unit, mxu_input=mi, mxu_kernel=mean6_kernel_mxu)
    ts = td.make_step(mean6_kernel, **kw)
    js = jd.make_step(mean6_kernel, interpret=True, **kw)
    tp, jp = ts._stream_plan, js._stream_plan
    for key in ("compute_unit", "mxu_input", "m", "route"):
        assert tp[key] == jp[key], key
    assert (tp["compute_unit"], tp["mxu_input"], tp["f32_accumulate"]) == (unit, mi, bf16)
    steps = 4
    td.run_step(ts, steps)
    jd.run_step(js, steps)
    exact = tp["route"] == "plane"
    for g, w in zip(_quantities(td, th), _quantities(jd, jh)):
        _same(g, w, "bf16" if bf16 else "f32", exact=exact, passes=steps, mi=mi, levels=steps)


def _jax_model(subdomains, **kw):
    m = JAstaroth(N, N, N, num_quantities=2, devices=jax.devices()[:subdomains], **kw)
    m.realize()
    return m


def _port_model(subdomains, **kw):
    m = AstarothSim(N, N, N, num_quantities=2, subdomains=subdomains, device="cpu", **kw)
    m.realize()
    return m


@pytest.mark.parametrize("schedule,subdomains", [("auto", 1), ("per-step", 8), ("wavefront", 8),
                                                 ("wavefront", 1)])
@pytest.mark.parametrize("unit,mi", [("mxu", "f32"), ("mxu_band", "bf16")])
def test_astaroth_vs_jax(schedule, subdomains, unit, mi):
    """``AstarothSim(kernel_impl="cuda", compute_unit=...)`` (plain versions
    here) against the JAX package's pallas engine in interpret mode, from
    its state: the plane route bitwise, the others within rtol 1e-6."""
    j = _jax_model(subdomains, kernel_impl="pallas", interpret=True, schedule=schedule, compute_unit=unit,
                   mxu_input=mi)
    t = _port_model(subdomains, kernel_impl="cuda", schedule=schedule, compute_unit=unit, mxu_input=mi)
    tp, jp = t._step._stream_plan, j._step._stream_plan
    for key in ("compute_unit", "mxu_input", "route"):
        assert tp[key] == jp[key], key
    assert (t._compute_unit, t._mxu_input) == (unit, mi) and t._wavefront_m == j._wavefront_m
    t.load_state([np.asarray(j.dd.raw_to_host(h)) for h in j.handles])
    ledger.reset_launch_counts()
    for m in (j, t):
        m.step(5)
    assert all(v == 0 for v in ledger.launch_counts().values())  # the CPU runs the plain versions
    for q in range(2):
        _same(t.field(q), np.asarray(j.field(q)), "f32", exact=tp["route"] == "plane", mi=mi, levels=5)


def test_astaroth_mxu_matches_vpu_within_the_reassociation_bound():
    """``tests/test_kernel_axes.py``'s ``test_stream_mxu_matches_vpu`` on the
    port's model: the contraction form within 4 reordered roundings a level
    of the vpu route, at the six-sum's magnitude."""
    from ulp import assert_reassociation_close

    runs = []
    for unit in ("vpu", "mxu"):
        t = _port_model(8, kernel_impl="cuda", schedule="wavefront", compute_unit=unit)
        t.step(4)
        runs.append(t.field(0))
    assert_reassociation_close(runs[1], runs[0], rounds=4 * 4, scale=6.0, context="astaroth mxu")


# --- degrades, refusals and the launch bookkeeping -------------------------------------------


def _jax_degrade(dd, **kw):
    """The JAX package logs its degrades (``log_warn``); where it lands."""
    return dd.make_step(mean6_kernel, engine="stream", interpret=True, **kw)._stream_plan


def _port_degrade(dd, match, **kw):
    with pytest.warns(RuntimeWarning, match=match):
        return dd.make_step(mean6_kernel, engine="stream", **kw)._stream_plan


def test_degrades_land_where_the_jax_package_lands():
    td, _, jd, _ = _domains(8)
    # no declared contraction form
    for plan in (_port_degrade(td, "no axis-separable", compute_unit="mxu"), _jax_degrade(jd, compute_unit="mxu")):
        assert (plan["compute_unit"], plan["mxu_input"]) == ("vpu", "f32")
    # bf16 operands under vpu
    for plan in (_port_degrade(td, "mxu_input=bf16", mxu_input="bf16"), _jax_degrade(jd, mxu_input="bf16")):
        assert (plan["compute_unit"], plan["mxu_input"]) == ("vpu", "f32")
    # mxu_band on planes without a band tile: the plan keeps the request, the
    # passes run the dense form (14-cell raw planes of 8 subdomains)
    with pytest.warns(RuntimeWarning, match="cannot tile"):
        tp = td.make_step(mean6_kernel, engine="stream", compute_unit="mxu_band", mxu_kernel=mean6_kernel_mxu)
    jp = jd.make_step(mean6_kernel, engine="stream", interpret=True, compute_unit="mxu_band",
                      mxu_kernel=mean6_kernel_mxu)
    assert tp._stream_plan["compute_unit"] == jp._stream_plan["compute_unit"] == "mxu_band"


@pytest.mark.parametrize("dts", [["f64"], ["f32", "f64"]])
def test_f64_fields_degrade_to_vpu(dts):
    tdt = {"f32": torch.float32, "f64": torch.float64}
    jdt = {"f32": jnp.float32, "f64": jnp.float64}
    td = DistributedDomain(N, N, N, device="cpu")
    jd = JDomain(N, N, N)
    for d, rad in ((td, Radius), (jd, JRadius)):
        d.set_radius(rad.constant(1))
    td.set_subdomains(8)
    jd.set_devices(jax.devices()[:8])
    for i, dt in enumerate(dts):
        td.add_data(f"q{i}", dtype=tdt[dt])
        jd.add_data(f"q{i}", dtype=jdt[dt])
    td.realize()
    jd.realize()
    kw = dict(compute_unit="mxu", mxu_kernel=mean6_kernel_mxu)
    assert _port_degrade(td, "not f32", **kw)["compute_unit"] == _jax_degrade(jd, **kw)["compute_unit"] == "vpu"


def test_unknown_values_raise():
    td, _, _, _ = _domains(1)
    with pytest.raises(ValueError, match="unknown compute unit"):
        td.make_step(mean6_kernel, engine="stream", compute_unit="gpu")
    with pytest.raises(ValueError, match="unknown mxu input"):
        td.make_step(mean6_kernel, engine="stream", mxu_input="fp8")
    u = torch.zeros(8, 8, 8)
    org = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown compute unit"):
        st.stream_wrap_pass(mean6_kernel_mxu, ["u"], [u], 1, org, (8, 8, 8), compute_unit="tpu")
    with pytest.raises(ValueError, match="unknown mxu input"):
        st.stream_wrap_pass(mean6_kernel_mxu, ["u"], [u], 1, org, (8, 8, 8), compute_unit="mxu", mxu_input="fp8")
    with pytest.raises(ValueError, match="unknown mxu input"):
        ps.mean6_plane_step(u, Dim3(1, 1, 1), Dim3(1, 1, 1), compute_unit="mxu", mxu_input="int8")
    with pytest.raises(TypeError, match="float32"):
        st.stream_wrap_pass(mean6_kernel_mxu, ["u"], [u.double()], 1, org, (8, 8, 8), compute_unit="mxu")
    with pytest.raises(AssertionError, match="f32 accumulator"):
        ps.mean6_shell_wavefront_step(u.double(), 1, 3, compute_unit="mxu")


def test_fused_and_split_under_a_unit_name_item_9_3():
    """The fused halo and the split schedule under a contracting unit plan
    and run (their values against the JAX package are in
    ``tests/test_torch_stream_mxu_fused.py``)."""
    td, _, _, _ = _domains(8, route="yzpack_xla")
    kw = dict(engine="stream", compute_unit="mxu", mxu_kernel=mean6_kernel_mxu)
    for extra, want in (({"stream_overlap": "split"}, ("split", "array")), ({"stream_halo": "fused"},
                                                                            ("off", "fused"))):
        step = td.make_step(mean6_kernel, **extra, **kw)
        plan = step._stream_plan
        assert (plan["overlap"], plan["halo"], plan["compute_unit"], plan["z_slabs"]) == (*want, "mxu", False)
        td.run_step(step, 2)
    # a split that degrades first (the wrap route has nothing to hide) runs the unit
    t1, _, _, _ = _domains(1)
    with pytest.warns(RuntimeWarning, match="overlap=split"):
        plan = t1.make_step(mean6_kernel, stream_overlap="split", **kw)._stream_plan
    assert (plan["route"], plan["overlap"], plan["compute_unit"]) == ("wrap", "off", "mxu")


def test_torch_engine_degrades_the_unit():
    with pytest.warns(RuntimeWarning, match="compute_unit=mxu_band .* cannot engage for astaroth:torch"):
        t = _port_model(1, compute_unit="mxu_band", mxu_input="bf16")
    assert (t._compute_unit, t._mxu_input) == ("vpu", "f32")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = _port_model(1)
    assert t._compute_unit == "vpu"


def test_smem_model_prices_the_plane_of_sums():
    """Under a unit the general form keeps one plane of sums more a field;
    Astaroth's per-field depth 3 is unchanged, and a joint group that fits
    under vpu can plan shallower."""
    for m, nf in ((3, 1), (2, 3)):
        assert st.stream_smem_bytes(m, nf, 4, "mxu") == st.stream_smem_bytes(m, nf) * (2 * m + 3) // (2 * m + 2)
    assert st.stream_smem_fits(3, 1, 4, "mxu") and st.stream_smem_fits(3, 2, 4, "mxu")
    assert st.stream_smem_fits(3, 2) and st.stream_smem_bytes(3, 2, 4, "mxu") == 175_104


def test_wrappers_count_the_contraction_forms():
    """The plain versions launch nothing; the counters exist for every form."""
    for fn in (st.stream_wrap_pass, st.stream_plane_pass, st.stream_wavefront_pass, ps.mean6_plane_step,
               ps.mean6_shell_wavefront_step):
        assert fn.mxu_launches == 0 and fn.mxu_bf16in_launches == 0
    sk = StreamKernel(mean6_kernel_mxu, ["u"], 1, (8, 8, 8), compute_unit="mxu", mxu_input="bf16")
    assert st._form([torch.zeros(1, dtype=torch.bfloat16)], sk) == "mxu_bf16in"
    assert st._form([torch.zeros(1)], StreamKernel(mean6_kernel_mxu, ["u"], 1, (8, 8, 8))) == ""
