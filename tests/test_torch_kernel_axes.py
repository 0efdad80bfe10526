"""The Jacobi kernel axes of the port (``compute_unit``, ``mxu_input``,
``storage_dtype``) against the JAX package, on the CPU.

The counterparts of tests/test_kernel_axes.py's axis, kernel and model cases
(its env, tune, ladder and telemetry cases wait for ROADMAP.md queue 1 items
10-11).  What each is held to:

* the band helpers (``band_matrix``, ``band_wide_tile``, ``band_tile_size``,
  ``band_tile_plan``, ``plane_band_unit``, ``mxu_flops_per_plane``) equal
  the JAX package's; ``plane_nbr_sum_host`` bitwise at radius 1 (a sum of
  two values is order-free) and within tests/ulp.py's reassociation bound
  at radius 2 (four values an axis, summed in the matmul's order);
* every plain form of #1-#3 under ``mxu``, ``mxu_band`` and bf16 operands,
  and #1-#5 under ``f32_accumulate`` on bfloat16 blocks, bitwise equal to
  ``jacobi_pallas`` in interpret mode (the band entries are exactly 0, 1
  and 2, so each in-plane pair sums to one rounded f32 add either way);
* ``Jacobi3D`` under each axis value on 8 subdomains bitwise equal to the
  JAX model, on even and uneven sizes;
* the degrades (f64 fields, the torch engine, ``slab``/``shell``,
  ``mxu_input`` under ``vpu``) warn and land where the JAX package lands;
  unknown values raise; the default build is bitwise the explicit
  ``vpu``/``native`` one; bf16 storage halves the exchange bytes and a
  packed route stays bitwise equal to ``direct``; the shared-memory model
  prices the contraction's pitch.

JAX inputs are explicit f32 (tests/conftest.py sets x64).
"""

import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.ops import jacobi_pallas as jp
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.kernels import ledger
from stencil_tpu_torch.models.jacobi import COLD_TEMP, HOT_TEMP, Jacobi3D
from stencil_tpu_torch.ops import jacobi_kernels as jk
from ulp import assert_reassociation_close

torch.set_num_threads(1)

EIGHT = jax.devices()[:8]
#: the combinations of the axes other than f32 vpu: (compute unit, operands, bf16 storage)
AXES = [("vpu", "f32", True), ("mxu", "f32", False), ("mxu_band", "f32", False), ("mxu", "bf16", False),
        ("mxu_band", "bf16", False), ("mxu", "f32", True), ("mxu_band", "bf16", True)]


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _bits(a) -> np.ndarray:
    """An array's values as f32 (a bfloat16 one upcast, exact)."""
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a).astype(np.float32))


def _pair(a: np.ndarray, bf16: bool):
    """The same data for both packages: (torch, jax), bfloat16 under bf16."""
    t, j = torch.from_numpy(a), jnp.asarray(a)
    return (t.to(torch.bfloat16), j.astype(jnp.bfloat16)) if bf16 else (t, j)


@contextlib.contextmanager
def _quiet():
    """The axes' degrade warnings (a band on an untilable plane) silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


# --- the band helpers ---------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 128])
def test_band_matrix_equals_jax(n, r):
    """The circulant band, the n = 2 double count (entries 2) included."""
    np.testing.assert_array_equal(jk.band_matrix(n, r=r).numpy(), np.asarray(jp.band_matrix(n, jnp.float32, r)))
    if n == 2 and r == 1:
        assert jk.band_matrix(2).tolist() == [[0.0, 2.0], [2.0, 0.0]]


@pytest.mark.parametrize("g,r", [(3, 1), (8, 1), (16, 1), (5, 2), (8, 2)])
def test_band_wide_tile_equals_jax(g, r):
    np.testing.assert_array_equal(jk.band_wide_tile(g, r).numpy(), np.asarray(jp.band_wide_tile(g, r, jnp.float32)))


@pytest.mark.parametrize("r", [1, 2])
def test_band_tile_size_and_plan_equal_jax(r):
    for n in range(1, 600):
        assert jk.band_tile_size(n, r) == jp.band_tile_size(n, r), n
    for y, z in [(32, 256), (24, 48), (40, 120), (16, 13), (13, 13), (512, 512), (272, 384), (258, 258)]:
        assert jk.band_tile_plan(y, z, r) == jp.band_tile_plan(y, z, r)


def test_band_tile_plan_selection_and_structural_degrade():
    """The JAX package's pins (tests/test_kernel_axes.py:744): granule
    choice, untilable axes, and the degrade to the dense form, which warns."""
    assert jk.band_tile_size(512) == 8 and jk.band_tile_size(512, r=2) == 8
    assert jk.band_tile_size(12) == 3 and jk.band_tile_size(24, r=2) == 6
    assert jk.band_tile_size(14) is None and jk.band_tile_size(13) is None
    assert jk.band_tile_plan(16, 13) is None
    with pytest.warns(RuntimeWarning, match="mxu_band cannot tile a \\(16, 13\\) plane"):
        assert jk.plane_band_unit("mxu_band", 16, 13) == "mxu"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert jk.plane_band_unit("mxu_band", 16, 16) == "mxu_band"
        assert jk.plane_band_unit("vpu", 16, 13) == "vpu"
    assert jk.mxu_flops_per_plane(13, 13, "mxu_band") == jk.mxu_flops_per_plane(13, 13)


@pytest.mark.parametrize("unit", ["mxu", "mxu_band"])
def test_mxu_flops_model_equals_jax(unit):
    for y, z in [(512, 512), (272, 384), (258, 258), (13, 17), (24, 48)]:
        assert jk.mxu_flops_per_plane(y, z, unit) == jp.mxu_flops_per_plane(y, z, unit)


def test_tensor_core_flops_of_the_card_contraction():
    """The FLOPs the card's tile contraction issues a cell and level: 276
    TF32 (three pieces), 120 bf16 (the chunks inside a 32 x 64 tile)."""
    assert jk.tensor_core_flops_per_cell("f32") == 276
    assert jk.tensor_core_flops_per_cell("bf16") == 120


@pytest.mark.parametrize("mxu_input", ["f32", "bf16"])
@pytest.mark.parametrize("unit", ["vpu", "mxu", "mxu_band"])
@pytest.mark.parametrize("r", [1, 2])
def test_plane_nbr_sum_host_equals_jax(unit, r, mxu_input):
    """Bitwise at r = 1; at r = 2 each axis sums four values, in the
    matmul's order, so within the reassociation bound (tests/ulp.py) of
    2r roundings a sum at operand scale."""
    rng = np.random.default_rng(11)
    for y, z in ((32, 256), (24, 48), (40, 120)):
        c = rng.standard_normal((y, z)).astype(np.float32)
        with _quiet():
            got = jk.plane_nbr_sum_host(torch.from_numpy(c), unit, r=r, mxu_input=mxu_input).numpy()
            want = np.asarray(jp.plane_nbr_sum_host(jnp.asarray(c), unit, r=r, mxu_input=mxu_input))
        if r == 1 or unit == "vpu":
            np.testing.assert_array_equal(got, want)
        else:
            assert_reassociation_close(got, want, rounds=4 * r, scale=float(np.abs(c).max()) * 4 * r)


def test_plane_nbr_sum_double_count():
    """n = 2 on both axes: each neighbour pair is one cell counted twice,
    and the band's 2.0 entries count it so too."""
    c = torch.tensor([[1.0, 2.0], [3.0, 5.0]])
    with _quiet():
        for unit in ("vpu", "mxu"):
            np.testing.assert_array_equal(jk.plane_nbr_sum_host(c, unit).numpy(),
                                          np.asarray(jp.plane_nbr_sum_host(jnp.asarray(c.numpy()), unit)))


# --- the plain forms against the Pallas kernels in interpret mode -------------------


@pytest.mark.parametrize("unit,mxu_input,bf16", AXES)
@pytest.mark.parametrize("k", [1, 3])
def test_wrap_plain_equals_pallas_interpret(unit, mxu_input, bf16, k):
    t, j = _pair(_rand((12, 16, 16), 7), bf16)
    got = jk.jacobi_wrap_step_plain(t, k, compute_unit=unit, f32_accumulate=bf16, mxu_input=mxu_input)
    want = jp.jacobi_wrap_step(j, interpret=True, k=k, compute_unit=unit, f32_accumulate=bf16,
                               mxu_input=mxu_input)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("unit,mxu_input,bf16", AXES)
@pytest.mark.parametrize("slabs", [False, True])
def test_shell_wavefront_plain_equals_pallas_interpret(unit, mxu_input, bf16, slabs):
    Xr, Yr, Zr, s, m = 14, 16, 24, 3, 3
    gs = (2 * s + 5, Yr - 2 * s, Zr - 2 * s - 1)
    origin = np.array([1, 2, 3], np.int32)
    d2 = jk.yz_dist2_plane(origin[1] - s, origin[2] - s, (Yr, Zr), gs)
    raw_t, raw_j = _pair(_rand((Xr, Yr, Zr), 3), bf16)
    zs_t, zs_j = _pair(_rand((Xr, 2 * s, Yr), 4), bf16) if slabs else (None, None)
    kw = dict(compute_unit=unit, mxu_input=mxu_input, f32_accumulate=bf16, interior_offset=s, z_valid=Zr - 1)
    with _quiet():
        got = jk.jacobi_shell_wavefront_step_plain(raw_t, m, torch.from_numpy(origin), d2, gs, z_slabs=zs_t, **kw)
        want = jp.jacobi_shell_wavefront_step(raw_j, m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
                                              interpret=True, alias=False, z_slabs=zs_j, **kw)
    if not slabs:
        got, want = (got,), (want,)
    S, zsl = slice(s, -s), slice(s, Zr - 1 - s)
    np.testing.assert_array_equal(_bits(got[0])[S, S, zsl], _bits(want[0])[S, S, zsl])
    if slabs:
        np.testing.assert_array_equal(_bits(got[1])[S, :, S], _bits(want[1])[S, :, S])


@pytest.mark.parametrize("unit,mxu_input,bf16", AXES)
def test_zring_wavefront_plain_equals_pallas_interpret(unit, mxu_input, bf16):
    s, m = 3, 3
    Xr, Yr, Zi = 2 * s + 6, 2 * s + 7, 128
    gs = (2 * s + 5, Yr - 2 * s, Zi)
    origin = np.array([2, 1, 0], np.int32)
    d2 = jk.zring_dist2_plane(origin[1] - s, origin[2], s, Yr, Zi, gs)
    raw_t, raw_j = _pair(_rand((Xr, Yr, Zi), 50), bf16)
    zs_t, zs_j = _pair(_rand((Xr, 2 * s, Yr), 51), bf16)
    kw = dict(compute_unit=unit, mxu_input=mxu_input, f32_accumulate=bf16, interior_offset=s)
    with _quiet():
        got = jk.jacobi_zring_wavefront_step_plain(raw_t, m, torch.from_numpy(origin), d2, gs, zs_t, **kw)
        want = jp.jacobi_zring_wavefront_step(raw_j, m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
                                              z_slabs=zs_j, interpret=True, **kw)
    S = slice(s, -s)
    np.testing.assert_array_equal(_bits(got[0])[S, S], _bits(want[0])[S, S])
    np.testing.assert_array_equal(_bits(got[1])[S, :, S], _bits(want[1])[S, :, S])


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_plain_bf16_equals_pallas_interpret(seed):
    X, Y, Z = 9, 12, 15
    gs = (X + 4, Y, Z)
    origin = np.array([2, 1, 3], np.int32)
    d2 = jk.yz_dist2_plane(origin[1], origin[2], (Y - 2, Z - 2), gs)
    t, j = _pair(_rand((X, Y, Z), 60 + seed), True)
    got = jk.jacobi_plane_step_plain(t, torch.from_numpy(origin), d2, gs, f32_accumulate=True)
    want = jp.jacobi_plane_step(j, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs, interpret=True,
                                f32_accumulate=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_slab_plain_bf16_equals_pallas_interpret(seed):
    X, Y, Z = 6, 9, 11
    gs = (X + 5, Y, Z)
    origin = np.array([1, 0, 2], np.int32)
    d2 = jk.yz_dist2_plane(origin[1], origin[2], (Y, Z), gs)
    t, j = _pair(_rand((X, Y, Z), 70 + seed), True)
    faces = [_pair(_rand(sh, 71 + i + seed), True) for i, sh in enumerate([(Y, Z)] * 2 + [(X, Z)] * 2 + [(X, Y)] * 2)]
    got = jk.jacobi_slab_step_plain(t, *(f[0] for f in faces), torch.from_numpy(origin), d2, gs,
                                    f32_accumulate=True)
    # the JAX kernel takes the z slabs transposed, (Y, X)
    jf = [f[1] for f in faces[:4]] + [f[1].T for f in faces[4:]]
    want = jp.jacobi_slab_step(j, *jf, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs, interpret=True,
                               f32_accumulate=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --- the wrappers' checks ------------------------------------------------------------


def test_wrappers_refuse_what_the_kernels_do_not_take():
    b = torch.zeros(8, 6, 6)
    with pytest.raises(ValueError, match="unknown compute unit"):
        jk.jacobi_wrap_step(b, 1, compute_unit="tpu")
    with pytest.raises(ValueError, match="unknown mxu input"):
        jk.jacobi_wrap_step(b, 1, compute_unit="mxu", mxu_input="fp8")
    with pytest.raises(TypeError, match="f32_accumulate"):
        jk.jacobi_wrap_step(b.to(torch.bfloat16), 1)
    with pytest.raises(TypeError, match="float32"):  # float64 is ported: tests/test_torch_jacobi_dtypes.py
        jk.jacobi_wrap_step(b.half(), 1)
    with pytest.raises(AssertionError, match="f32 accumulator"):
        jk._check_compute_unit("mxu", torch.float64)
    with pytest.raises(TypeError, match="f32_accumulate"):
        jk.jacobi_plane_step(torch.zeros(5, 5, 5, dtype=torch.bfloat16), torch.zeros(3, dtype=torch.int32),
                             torch.zeros(3, 3, dtype=torch.int32), (5, 5, 5))


def test_wrappers_on_cpu_tensors_count_no_launch():
    ledger.reset_launch_counts()
    t = torch.from_numpy(_rand((8, 6, 6), 1))
    jk.jacobi_wrap_step(t.to(torch.bfloat16), 2, f32_accumulate=True)
    jk.jacobi_wrap_step(t, 2, compute_unit="mxu_band", mxu_input="bf16")
    assert not any(ledger.launch_counts().values())


def test_forms_are_in_the_ledger():
    counts = ledger.launch_counts()
    for fn in ("jacobi_wrap_step", "jacobi_zring_wavefront_step", "jacobi_shell_wavefront_step"):
        for form in ("bf16", "mxu", "mxu_bf16in"):
            assert f"{fn}_{form}" in counts and ledger.form_entry(f"{fn}_{form}")["counter"] == f"{form}_launches"
    assert "jacobi_plane_step_bf16" in counts and "jacobi_slab_step_bf16" in counts
    assert jk.form_counter("mxu_band", "bf16", True) == "mxu_bf16in_launches"
    assert jk.library_name("mxu", "f32", True) == "jacobi_wavefront_mxu_bf16"
    assert jk.library_name() == jk.BASE_LIBRARY


# --- the resolvers ---------------------------------------------------------------------


def test_resolvers_precedence_and_degrades():
    assert jk.resolve_compute_unit(None, [torch.float32]) == ("vpu", "static")
    assert jk.resolve_compute_unit("mxu_band", [torch.float32]) == ("mxu_band", "explicit")
    assert jk.resolve_storage_dtype("auto", [torch.float32]) == ("native", "static")
    assert jk.resolve_mxu_input("bf16", "mxu") == ("bf16", "explicit")
    with pytest.warns(RuntimeWarning, match="float64"):
        assert jk.resolve_compute_unit("mxu", [torch.float64]) == ("vpu", "explicit/degraded")
    with pytest.warns(RuntimeWarning, match="float64"):
        assert jk.resolve_storage_dtype("bf16", [np.float64]) == ("native", "explicit/degraded")
    with pytest.warns(RuntimeWarning, match="no contraction to feed"):
        assert jk.resolve_mxu_input("bf16", "vpu") == ("f32", "explicit/degraded")
    assert not jk.mxu_supported([torch.float64]) and not jk.bf16_supported([torch.float64])
    for fn, bad in ((jk.resolve_compute_unit, "tpu"), (jk.resolve_storage_dtype, "fp4")):
        with pytest.raises(ValueError, match="unknown value"):
            fn(bad, [torch.float32])
    with pytest.raises(ValueError, match="unknown value"):
        jk.resolve_mxu_input("fp8", "mxu")


# --- the model --------------------------------------------------------------------------


def _port(size, **kw):
    m = Jacobi3D(*size, subdomains=kw.pop("subdomains", 8), device="cpu", **kw)
    m.realize()
    return m


def _jax(size, **kw):
    m = JJacobi3D(*size, devices=kw.pop("devices", EIGHT), **kw)
    m.realize()
    return m


@pytest.mark.parametrize("size", [(24, 24, 24), (21, 21, 21)])
@pytest.mark.parametrize("unit,mxu_input,bf16", AXES)
def test_jacobi_wavefront_axes_equal_jax(size, unit, mxu_input, bf16):
    """8 subdomains: the wavefront route (the plain form on uneven 21^3),
    each axis value bitwise equal to the JAX model's."""
    kw = dict(compute_unit=unit, mxu_input=mxu_input, storage_dtype="bf16" if bf16 else None)
    with _quiet():
        j = _jax(size, kernel_impl="pallas", interpret=True, **kw)
        t = _port(size, kernel_impl="cuda", **kw)
    assert t._pallas_path == j._pallas_path == "wavefront"
    assert (t._compute_unit, t._mxu_input, t.dd.storage_dtype()) == (j._compute_unit, j._mxu_input,
                                                                       j.dd.storage_dtype())
    assert t.dd.get_curr(t.h).dtype == (torch.bfloat16 if bf16 else torch.float32)
    # the FLOP model over the port's plane, which keeps Zr where the JAX
    # package pads the lanes to 128 (ROADMAP.md queue 3)
    raw = t.dd.local_spec().raw_size()
    want = jk.mxu_flops_per_plane(raw.y, raw.z, unit) * raw.x * 8 if jk.unit_uses_mxu(unit) else 0
    assert t._mxu_flops_iter == want
    j.step(4)
    with _quiet():
        t.step(4)
    got = t.temperature()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, j.temperature())


@pytest.mark.parametrize("unit,mxu_input,bf16", AXES)
def test_jacobi_wrap_axes_equal_jax(unit, mxu_input, bf16):
    kw = dict(compute_unit=unit, mxu_input=mxu_input, storage_dtype="bf16" if bf16 else None, temporal_k=3)
    with _quiet():
        j = _jax((20, 16, 18), devices=EIGHT[:1], kernel_impl="pallas", interpret=True, **kw)
        t = _port((20, 16, 18), subdomains=1, kernel_impl="cuda", **kw)
    assert t._pallas_path == j._pallas_path == "wrap"
    assert t._compute_unit == j._compute_unit and t._mxu_flops_iter == j._mxu_flops_iter
    j.step(5)
    with _quiet():
        t.step(5)
    np.testing.assert_array_equal(t.temperature(), j.temperature())


@pytest.mark.parametrize("path", ["shell", "slab"])
def test_jacobi_one_level_routes_take_bf16_and_degrade_mxu(path):
    """shell and slab: bf16 storage through #4 / #5, bitwise equal to the
    JAX model's; an mxu request degrades to vpu with a warning."""
    kw = dict(pallas_path=path, storage_dtype="bf16", compute_unit="mxu")
    with pytest.warns(RuntimeWarning, match=f"jacobi-{path}"):
        t = _port((24, 24, 24), kernel_impl="cuda", **kw)
    with _quiet():
        j = _jax((24, 24, 24), kernel_impl="pallas", interpret=True, **kw)
    assert t._pallas_path == j._pallas_path == path
    assert t._compute_unit == j._compute_unit == "vpu" and t.dd.storage_dtype() == "bf16"
    j.step(3)
    t.step(3)
    np.testing.assert_array_equal(t.temperature(), j.temperature())


def test_torch_engine_degrades_both_axes():
    with pytest.warns(RuntimeWarning) as rec:
        t = _port((16, 16, 16), kernel_impl="torch", compute_unit="mxu", storage_dtype="bf16")
    msgs = " ".join(str(w.message) for w in rec)
    assert "storage_dtype=bf16" in msgs and "compute_unit=mxu" in msgs and "torch engine" in msgs
    assert t._compute_unit == "vpu" and t.dd.storage_dtype() == "native"
    assert t.dd.get_curr(t.h).dtype == torch.float32


def test_mxu_input_under_vpu_degrades_with_a_warning():
    with pytest.warns(RuntimeWarning, match="mxu_input=bf16"):
        t = _port((16, 16, 16), subdomains=1, kernel_impl="cuda", mxu_input="bf16")
    assert t._mxu_input == "f32"


def test_unknown_axis_values_rejected():
    with pytest.raises(ValueError, match="unknown value"):
        _port((16, 16, 16), kernel_impl="cuda", compute_unit="gpu")
    with pytest.raises(ValueError, match="unknown value"):
        _port((16, 16, 16), kernel_impl="cuda", storage_dtype="fp8")
    with pytest.raises(ValueError, match="unknown storage dtype"):
        DistributedDomain(8, 8, 8, device="cpu").set_storage("fp8")


@pytest.mark.parametrize("subdomains", [1, 8])
def test_default_build_bitwise_equal_to_explicit_vpu_native(subdomains):
    a = _port((24, 24, 24), subdomains=subdomains, kernel_impl="cuda")
    b = _port((24, 24, 24), subdomains=subdomains, kernel_impl="cuda", compute_unit="vpu", mxu_input="f32",
              storage_dtype="native")
    a.step(3)
    b.step(3)
    np.testing.assert_array_equal(a.temperature(), b.temperature())


@pytest.mark.parametrize("unit,mxu_input,bf16", [("vpu", "f32", True), ("mxu_band", "bf16", False),
                                                  ("mxu", "f32", True)])
def test_capture_runs_under_every_axis_value(unit, mxu_input, bf16):
    """The captured step loop (its CPU stand-in) equals the uncaptured one."""
    kw = dict(kernel_impl="cuda", compute_unit=unit, mxu_input=mxu_input, storage_dtype="bf16" if bf16 else None)
    with _quiet():
        a, b = _port((24, 24, 24), **kw), _port((24, 24, 24), capture=True, **kw)
        a.step(9)
        b.step(9)
    np.testing.assert_array_equal(a.temperature(), b.temperature())


def test_bounds_of_the_axes_against_f32_vpu():
    """The analytic bounds of tests/ulp.py hold on the port too: bf16
    storage within one rounding a pass, the contraction within 4 ulps a
    level, and the field inside [COLD, HOT]."""
    ref = _port((24, 24, 24), kernel_impl="cuda")
    ref.step(8)
    want = ref.temperature()
    with _quiet():
        b = _port((24, 24, 24), kernel_impl="cuda", storage_dtype="bf16")
        m = _port((24, 24, 24), kernel_impl="cuda", compute_unit="mxu_band")
        b.step(8)
        m.step(8)
    passes = 8 // b._wavefront_m
    assert np.abs(b.temperature() - want).max() <= (passes + 1) * 2.0 ** -9
    d = np.abs(m.temperature().view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert d.max() <= 4 * 8
    for t in (b.temperature(), m.temperature()):
        assert COLD_TEMP <= t.min() and t.max() <= HOT_TEMP


# --- the domain under bf16 storage ------------------------------------------------------


def test_bf16_halves_exchange_bytes_as_jax():
    a = _port((24, 24, 24), kernel_impl="cuda")
    b = _port((24, 24, 24), kernel_impl="cuda", storage_dtype="bf16")
    assert b.dd.exchange_bytes_total() * 2 == a.dd.exchange_bytes_total()
    j = _jax((24, 24, 24), kernel_impl="pallas", interpret=True, storage_dtype="bf16")
    assert b.dd.exchange_bytes_total() == j.dd.exchange_bytes_total()
    assert sum(b.dd.exchange_hop_bytes().values()) * 2 == sum(a.dd.exchange_hop_bytes().values())


def _bf16_domain(route, size=(16, 16, 16), radius=2, device="cpu"):
    dd = DistributedDomain(*size, device=device)
    dd.set_radius(Radius.constant(radius))
    dd.set_subdomains(8)
    dd.set_exchange_route(route)
    h = dd.add_data("q0")
    dd.set_storage("bf16")
    dd.realize()
    dd.init_by_coords(h, lambda x, y, z: torch.sin(0.13 * (x + 2 * y + 3 * z)))
    return dd, h


@pytest.mark.parametrize("route", ["zpack_xla", "zpack_pallas", "yzpack_xla", "yzpack_pallas"])
def test_bf16_packed_route_equals_direct(route):
    """The packed routes move 2-byte cells, bitwise equal to ``direct``."""
    ref, h = _bf16_domain("direct")
    got, g = _bf16_domain(route)
    assert got.exchange_route() == route and got.get_curr(g).dtype == torch.bfloat16
    for dd in (ref, got):
        dd.exchange()
    assert torch.equal(got.get_curr(g), ref.get_curr(h))
    raw = got.raw_to_host(g)
    assert raw.dtype == np.float32
    np.testing.assert_array_equal(raw, ref.raw_to_host(h))


def test_bf16_domain_equals_jax_domain_after_exchange():
    ours, h = _bf16_domain("direct", size=(16, 16, 16))
    jd = JDomain(16, 16, 16)
    jd.set_radius(JRadius.constant(2))
    jd.set_devices(EIGHT)
    jh = jd.add_data("q0", dtype=jnp.float32)
    jd.set_storage("bf16")
    jd.realize()
    jd.init_by_coords(jh, lambda x, y, z: jnp.sin(0.13 * (x + 2 * y + 3 * z)).astype(jnp.float32))
    assert jd.field_dtype(jh) == jnp.bfloat16 and ours.field_dtype(h) == torch.bfloat16
    jd.exchange()
    ours.exchange()
    np.testing.assert_array_equal(ours.quantity_to_host(h), jd.quantity_to_host(jh))


def test_set_storage_bf16_degrades_on_mixed_dtype_domain():
    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(Radius.constant(1))
    dd.add_data("f", dtype=torch.float32)
    dd.add_data("d", dtype=torch.float64)
    dd.set_storage("bf16")
    with pytest.warns(RuntimeWarning, match="storage bf16 cannot engage"):
        dd.realize()
    assert dd.storage_dtype() == "native"
    assert dd.get_curr(dd._handles[0]).dtype == torch.float32


def test_stream_engine_refuses_a_bf16_domain():
    """The stream engine takes a bf16-storage domain (float32 levels, one
    rounding a pass), bitwise equal to the JAX package's on the plane route;
    on it, as on any domain, a kernel that declares no contraction form
    degrades the contraction to vpu with a warning (the contraction itself:
    tests/test_torch_stream_mxu.py)."""
    dd, h = _bf16_domain("direct")
    jd = JDomain(16, 16, 16)
    jd.set_radius(JRadius.constant(2))
    jd.set_devices(EIGHT)
    jh = jd.add_data("q0")
    jd.set_storage("bf16")
    jd.realize()
    jd.set_quantity(jh, dd.quantity_to_host(h))

    def kernel(views, info):
        return {"q0": (views["q0"].center() + views["q0"].sh(1, 0, 0)) / 3.0}

    for kw in ({"compute_unit": "mxu"}, {"mxu_input": "bf16"}):
        with pytest.warns(RuntimeWarning, match="cannot engage|has no effect"):
            plan = dd.make_step(kernel, engine="stream", **kw)._stream_plan
        assert (plan["compute_unit"], plan["mxu_input"], plan["f32_accumulate"]) == ("vpu", "f32", True)
    step = dd.make_step(kernel, engine="stream", stream_path="plane")
    assert step._stream_plan["f32_accumulate"] and step._stream_plan["route"] == "plane"
    dd.run_step(step, 3)
    jd.run_step(jd.make_step(kernel, engine="stream", interpret=True, stream_path="plane"), 3)
    assert dd.get_curr(h).dtype == torch.bfloat16
    np.testing.assert_array_equal(dd.quantity_to_host(h), np.asarray(jd.quantity_to_host(jh)))


# --- the shared-memory model -------------------------------------------------------------


def test_smem_model_prices_the_contraction_pitch():
    """The tensor-core builds pitch the first march's 2d planes of 32 rows
    at 72 cells: at m = 8 that is 8,192 bytes more, and the plan still
    fits m = 8 (229,376 of 232,448 bytes) and so picks it on 512^3 over
    2x2x2; m = 9 fits neither unit."""
    assert jk.mxu_smem_extra_bytes(8) == 2 * 4 * 32 * 8 * 4 == 8192
    assert jk.mxu_smem_extra_bytes(3) == 2 * 3 * 32 * 8 * 4
    assert jk.wavefront_smem_bytes(8, "mxu_band") == jk.wavefront_smem_bytes(8) + 8192 == 229_376
    assert jk.wavefront_smem_fits(8, "mxu") and not jk.wavefront_smem_fits(9, "mxu")
    assert jk.wavefront_auto_depth(256, "mxu_band") == jk.wavefront_auto_depth(256) == 8
    t = _port((24, 24, 24), kernel_impl="cuda", compute_unit="mxu", temporal_k="auto")
    assert t._wavefront_m == jk.wavefront_auto_depth(12, "mxu")


def test_jacobi3d_driver_takes_the_axis_flags(capsys):
    from stencil_tpu_torch.bin import jacobi3d

    with _quiet():
        assert jacobi3d.main(["16", "16", "16", "--no-weak-scale", "--device", "cpu", "--iters", "1",
                              "--compute-unit", "mxu_band", "--mxu-input", "bf16"]) == 0
        assert jacobi3d.main(["16", "16", "16", "--no-weak-scale", "--device", "cpu", "--iters", "1",
                              "--partition", "2,2,2", "--storage-dtype", "bf16"]) == 0
    assert capsys.readouterr().out.count("jacobi3d,") == 2
