"""Float64 fields on the Jacobi kernels (rows 1-5), and bf16 storage and
float64 on the mean-of-6 kernels (rows 17-18), against the JAX package on
the CPU.

Inputs come from ``numpy.random.default_rng(seed)`` at explicit dtypes; the
JAX kernels run in Pallas interpret mode (tests/conftest.py turns on x64),
the port's wrappers run their plain versions (CPU tensors).  What each is
held to:

* XLA's division rule, measured: the Jacobi and mean-of-6 interpret passes
  compile ``sum / 6.0`` at float64 into a multiply by the float64
  reciprocal, which the port's plain versions (``SIXTH_F64``) and its
  float64 build do too; a true divide differs on some cells;
* the float64 plain versions of #1-#5 (wrap at k = 1 and 3; z-ring and
  shell wavefronts at m = 2 and 4, with slabs, and the shell's plain form;
  plane; slab): bitwise, since both sum the six neighbours in one order and
  nothing contracts (no level's product feeds an add: the clamp's select
  lies between);
* the mean-of-6 kernels #17 and #18 under ``f32_accumulate`` (bfloat16
  blocks) and on float64 blocks: the plane kernel and the wavefront at m =
  1 bitwise; the wavefront at m = 2 and 3 within ``tests/ulp.py``'s
  ``bf16_storage_atol`` of one pass (bf16) and rtol 1e-15 (float64),
  because XLA on the CPU contracts a level's multiply into the next level's
  adds there (ROADMAP.md queue 3, "FMA contraction"), which the port does
  not;
* ``Jacobi3D(dtype=torch.float64, kernel_impl="cuda")`` against the JAX
  ``Jacobi3D(dtype=jnp.float64, kernel_impl="pallas", interpret=True)`` on
  ``wrap``, ``shell``, ``slab``, the z-ring and z-slab wavefronts, ``auto``
  on 8 subdomains and an uneven size: bitwise; its state carried between
  the packages; captured runs bitwise equal to uncaptured;
* the degrades on f64 fields (``storage_dtype="bf16"``, ``compute_unit``
  ``"mxu"``) warn and land where the JAX package lands; the plan models
  price 8-byte cells; the ledger lists the new forms; the launch path of
  each new form, on tensors that report a CUDA device with Python
  stand-ins for the C entries, looks up its own build and counts under its
  own counter;
* a bfloat16 block without ``f32_accumulate`` is refused, where the JAX
  kernels compute at bf16 with XLA rounding every operation (pinned here:
  ROADMAP.md queue 2).
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
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.ops import jacobi_pallas as jp
from stencil_tpu.ops import plane_stencil as jps
from stencil_tpu_torch.kernels import build, ledger
from stencil_tpu_torch.models.jacobi import COLD_TEMP, HOT_TEMP, Jacobi3D, to_jax_state, to_torch_state
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops import plane_stencil as ps
from ulp import bf16_storage_atol

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

EIGHT = jax.devices()[:8]
F64_RTOL = 1e-15


def _rand(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).random(shape)


def _pair(a: np.ndarray, dt: str):
    """The same data for both packages at ``dt`` (``f64``, or ``bf16``
    rounded once from f32)."""
    if dt == "f64":
        return torch.from_numpy(a.astype(np.float64)), jnp.asarray(a.astype(np.float64))
    a32 = a.astype(np.float32)
    return torch.from_numpy(a32).to(torch.bfloat16), jnp.asarray(a32).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    """A result as float64 numpy (bf16 upcast, exact)."""
    return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float64)


def _d2(origin, shape_yz, gs):
    return jk.yz_dist2_plane(int(origin[1]), int(origin[2]), shape_yz, gs)


# --- the division rule, measured ---------------------------------------------------------


@pytest.mark.parametrize("kernel", ["wrap", "plane", "mean6_plane"])
def test_xla_divides_f64_by_six_as_a_reciprocal_multiply(kernel):
    """The JAX kernels' ``/ 6.0`` at float64 in interpret mode is ``* (1/6)``
    with the float64 reciprocal, what the port computes; a true divide
    differs on some cells."""
    x = _rand((12, 14, 16), 1) * 10.0
    c = torch.from_numpy(x)
    X, Y, Z = x.shape
    sl = (slice(1, -1),) * 3
    s = jk._level(c, 0, "vpu", "f32")  # the kernels' order; periodic rolls
    if kernel == "wrap":
        want = np.asarray(jp.jacobi_wrap_step(jnp.asarray(x), interpret=True, k=1))
        got = jk.jacobi_wrap_step_plain(c, 1)
        hot_x, cold_x, in_r2 = jk.sphere_params(X)
        d2 = jk.yz_dist2_plane(0, 0, (Y, Z), x.shape)[None]
        x_g = torch.arange(X)[:, None, None]
        mul, div = (jk._clamp_spheres(v, d2, x_g, hot_x, cold_x, in_r2).numpy()
                    for v in (s * jk.SIXTH_F64, s / 6.0))
    elif kernel == "plane":
        gs, origin = (X + 3, Y, Z), np.array([2, 1, 3], np.int32)
        d2 = _d2(origin, (Y - 2, Z - 2), gs)
        want = np.asarray(jp.jacobi_plane_step(jnp.asarray(x), jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
                                               interpret=True))[sl]
        got = jk.jacobi_plane_step_plain(c, torch.from_numpy(origin), d2, gs)[sl]
        hot_x, cold_x, in_r2 = jk.sphere_params(gs[0])
        x_g = (int(origin[0]) + torch.arange(X - 2))[:, None, None] % gs[0]
        mul, div = (jk._clamp_spheres(v[sl], d2[None], x_g, hot_x, cold_x, in_r2).numpy()
                    for v in (s * jk.SIXTH_F64, s / 6.0))
    else:
        one = JDim3(1, 1, 1)
        want = np.asarray(jps.mean6_plane_step(jnp.asarray(x), one, one, interpret=True))[sl]
        got = ps.mean6_plane_step_plain(c, (1, 1, 1), (1, 1, 1))[sl]
        mul, div = (s * jk.SIXTH_F64)[sl].numpy(), (s / 6.0)[sl].numpy()
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_array_equal(want, mul)
    np.testing.assert_array_equal(got.numpy(), mul)
    assert np.count_nonzero(div != mul) > 0
    assert jk.SIXTH_F64 == float.fromhex("0x1.5555555555555p-3") == jk.sixth(torch.float64)
    assert jk.sixth(torch.float32) == jk.SIXTH


# --- the float64 plain versions of #1-#5 against the Pallas kernels -----------------------


@pytest.mark.parametrize("k", [1, 3])
def test_wrap_plain_f64_equals_pallas_interpret(k):
    t, j = _pair(_rand((12, 16, 18), 7), "f64")
    got = jk.jacobi_wrap_step_plain(t, k)
    want = jp.jacobi_wrap_step(j, interpret=True, k=k)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper on a CPU tensor runs the plain version and counts nothing
    ledger.reset_launch_counts()
    assert torch.equal(jk.jacobi_wrap_step(t, k), got) and not any(ledger.launch_counts().values())


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("slabs", [True, False])
def test_shell_wavefront_plain_f64_equals_pallas_interpret(m, slabs):
    """With z slabs (#3) and without (the shell form's plain variant)."""
    s = m
    Xr, Yr, Zr = 2 * s + 8, 2 * s + 9, 2 * s + 12
    zv = Zr - 1
    gs = (2 * s + 5, Yr - 2 * s, zv - 2 * s)
    origin = np.array([1, 2, 3], np.int32)
    d2 = jk.yz_dist2_plane(origin[1] - s, origin[2] - s, (Yr, Zr), gs)
    raw_t, raw_j = _pair(_rand((Xr, Yr, Zr), 3 + m), "f64")
    zs_t, zs_j = _pair(_rand((Xr, 2 * s, Yr), 4 + m), "f64") if slabs else (None, None)
    kw = dict(interior_offset=s, z_valid=zv)
    got = jk.jacobi_shell_wavefront_step_plain(raw_t, m, torch.from_numpy(origin), d2, gs, z_slabs=zs_t, **kw)
    want = jp.jacobi_shell_wavefront_step(raw_j, m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
                                          interpret=True, alias=False, z_slabs=zs_j, **kw)
    if not slabs:
        got, want = (got,), (want,)
    assert got[0].dtype == torch.float64
    S, zsl = slice(s, -s), slice(s, zv - s)
    np.testing.assert_array_equal(got[0].numpy()[S, S, zsl], np.asarray(want[0])[S, S, zsl])
    if slabs:
        assert got[1].dtype == torch.float64
        np.testing.assert_array_equal(got[1].numpy()[S, :, S], np.asarray(want[1])[S, :, S])


@pytest.mark.parametrize("m", [2, 4])
def test_zring_wavefront_plain_f64_equals_pallas_interpret(m):
    s = m
    Xr, Yr, Zi = 2 * s + 6, 2 * s + 7, 128
    gs = (2 * s + 5, Yr - 2 * s, Zi)
    origin = np.array([2, 1, 0], np.int32)
    d2 = jk.zring_dist2_plane(origin[1] - s, origin[2], s, Yr, Zi, gs)
    raw_t, raw_j = _pair(_rand((Xr, Yr, Zi), 50 + m), "f64")
    zs_t, zs_j = _pair(_rand((Xr, 2 * s, Yr), 51 + m), "f64")
    got = jk.jacobi_zring_wavefront_step_plain(raw_t, m, torch.from_numpy(origin), d2, gs, zs_t, interior_offset=s)
    want = jp.jacobi_zring_wavefront_step(raw_j, m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
                                          z_slabs=zs_j, interior_offset=s, interpret=True)
    S = slice(s, -s)
    assert got[0].dtype == got[1].dtype == torch.float64
    np.testing.assert_array_equal(got[0].numpy()[S, S], np.asarray(want[0])[S, S])
    np.testing.assert_array_equal(got[1].numpy()[S, :, S], np.asarray(want[1])[S, :, S])


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_plain_f64_equals_pallas_interpret(seed):
    X, Y, Z = 9, 12, 15
    gs = (X + 4, Y, Z)
    origin = np.array([2, 1, 3], np.int32)
    d2 = _d2(origin, (Y - 2, Z - 2), gs)
    t, j = _pair(_rand((X, Y, Z), 60 + seed), "f64")
    got = jk.jacobi_plane_step_plain(t, torch.from_numpy(origin), d2, gs)
    want = jp.jacobi_plane_step(j, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs, interpret=True)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_slab_plain_f64_equals_pallas_interpret(seed):
    X, Y, Z = 6, 9, 11
    gs = (X + 5, Y, Z)
    origin = np.array([1, 0, 2], np.int32)
    d2 = _d2(origin, (Y, Z), gs)
    t, j = _pair(_rand((X, Y, Z), 70 + seed), "f64")
    faces = [_pair(_rand(sh, 71 + i + seed), "f64") for i, sh in enumerate([(Y, Z)] * 2 + [(X, Z)] * 2 + [(X, Y)] * 2)]
    got = jk.jacobi_slab_step_plain(t, *(f[0] for f in faces), torch.from_numpy(origin), d2, gs)
    # the JAX kernel takes the z slabs transposed, (Y, X)
    jf = [f[1] for f in faces[:4]] + [f[1].T for f in faces[4:]]
    want = jp.jacobi_slab_step(j, *jf, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs, interpret=True)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the mean-of-6 kernels #17 and #18 ----------------------------------------------------


@pytest.mark.parametrize("dt", ["bf16", "f64"])
@pytest.mark.parametrize("lo,hi", [((1, 1, 1), (1, 1, 1)), ((1, 2, 3), (3, 1, 2))])
def test_mean6_plane_dtypes_equal_jax(dt, lo, hi):
    """Bitwise; under bf16 storage the shell passes through as its stored
    bytes and the window rounds once."""
    t, j = _pair(_rand((16, 16, 16), 11), dt)
    bf16 = dt == "bf16"
    want = jps.mean6_plane_step(j, JDim3.of(lo), JDim3.of(hi), interpret=True, f32_accumulate=bf16)
    before = dict(ledger.launch_counts())
    got = ps.mean6_plane_step(t, lo, hi, f32_accumulate=bf16)
    assert ledger.launch_counts() == before  # a CPU tensor runs the plain version
    assert got.dtype == t.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    inside = np.zeros(t.shape, bool)
    inside[lo[0]:16 - hi[0], lo[1]:16 - hi[1], lo[2]:16 - hi[2]] = True
    assert torch.equal(got[torch.from_numpy(~inside)], t[torch.from_numpy(~inside)])
    out = torch.full(t.shape, -1.0, dtype=t.dtype)
    assert ps.mean6_plane_step(t, lo, hi, f32_accumulate=bf16, out=out) is out and torch.equal(out, got)


@pytest.mark.parametrize("dt", ["bf16", "f64"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_mean6_wavefront_dtypes_equal_jax(dt, m):
    s = 3
    t, j = _pair(_rand((16, 16, 16), 12), dt)
    bf16 = dt == "bf16"
    # the JAX kernel writes its input in place: a fresh device buffer
    want = _np(jps.mean6_shell_wavefront_step(j + 0, m=m, shell_width=s, interpret=True, f32_accumulate=bf16))
    got = ps.mean6_shell_wavefront_step(t, m, s, f32_accumulate=bf16)
    assert got.dtype == t.dtype
    core = (slice(s, -s),) * 3
    g, w = _np(got)[core], want[core]
    if m == 1:
        np.testing.assert_array_equal(g, w)
    elif bf16:
        assert np.abs(g - w).max() <= bf16_storage_atol(1)  # fields in [0, 1]: scale 1
    else:
        np.testing.assert_allclose(g, w, rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("dt", ["bf16", "f64"])
def test_mean6_wavefront_levels_equal_plane_steps(dt):
    """m levels in one pass equal m plane steps over the shrinking window
    on the interior: bitwise at f64; under bf16 storage the plane steps
    round every level, the pass once, so one bf16 rounding a level apart."""
    t, _ = _pair(_rand((16, 16, 16), 13), dt)
    bf16 = dt == "bf16"
    got = ps.mean6_shell_wavefront_step(t, 3, 3, f32_accumulate=bf16)
    c = t
    for level in range(1, 4):
        c = ps.mean6_plane_step(c, (level,) * 3, (level,) * 3, f32_accumulate=bf16)
    core = (slice(3, 13),) * 3
    if bf16:
        assert (got[core].double() - c[core].double()).abs().max() <= bf16_storage_atol(3)
    else:
        assert torch.equal(got[core], c[core])


def test_mean6_axes_and_dtypes_checked():
    """The contraction axes are ported (tests/test_torch_stream_mxu.py): f32
    and bf16-storage blocks take them, a float64 block under a contracting
    unit is refused as the JAX kernels assert an f32 accumulator, and bf16
    operands under vpu change nothing; a bfloat16 block needs
    ``f32_accumulate``; f32 blocks take it as the JAX kernels do (it changes
    nothing); a float64 block refuses it; ``out`` matches the block's dtype."""
    one = (1, 1, 1)
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        block = torch.zeros(10, 10, 10, dtype=dt)
        acc = dt == torch.bfloat16
        for kw in ({"compute_unit": "mxu"}, {"mxu_input": "bf16"}):
            if dt == torch.float64 and "compute_unit" in kw:
                with pytest.raises(AssertionError, match="f32 accumulator"):
                    ps.mean6_plane_step(block, one, one, f32_accumulate=acc, **kw)
                with pytest.raises(AssertionError, match="f32 accumulator"):
                    ps.mean6_shell_wavefront_step(block, 2, 3, f32_accumulate=acc, **kw)
                continue
            assert ps.mean6_plane_step(block, one, one, f32_accumulate=acc, **kw).dtype == dt
            assert ps.mean6_shell_wavefront_step(block, 2, 3, f32_accumulate=acc, **kw).dtype == dt
    with pytest.raises(TypeError, match="f32_accumulate"):
        ps.mean6_plane_step(torch.zeros(8, 8, 8, dtype=torch.bfloat16), one, one)
    with pytest.raises(TypeError, match="f32_accumulate"):
        ps.mean6_shell_wavefront_step(torch.zeros(8, 8, 8, dtype=torch.float64), 1, 1, f32_accumulate=True)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        ps.mean6_plane_step(torch.zeros(8, 8, 8, dtype=torch.float16), one, one)
    b = torch.from_numpy(_rand((8, 8, 8), 3).astype(np.float32))
    assert torch.equal(ps.mean6_plane_step(b, one, one, f32_accumulate=True), ps.mean6_plane_step(b, one, one))
    with pytest.raises(TypeError, match="float64"):
        ps.mean6_plane_step(b.double(), one, one, out=torch.zeros(8, 8, 8))
    assert ps.mean6_wavefront_smem_bytes(8, 8) == 2 * ps.mean6_wavefront_smem_bytes(8) == 132_160


# --- the native bfloat16 form, refused ------------------------------------------------------


def test_native_bf16_blocks_refused_where_jax_rounds_every_operation():
    """A bfloat16 block without ``f32_accumulate``: the JAX mean-of-6 plane
    kernel runs it in interpret mode, XLA rounding each add to bfloat16 and
    dividing by 6 at f32 before one more rounding (neither a reciprocal
    multiply nor one f32 sum rounded once).  The port refuses the form
    (ROADMAP.md queue 2)."""
    a32 = _rand((12, 12, 12), 21).astype(np.float32)
    b = jnp.asarray(a32).astype(jnp.bfloat16)
    got = np.asarray(jps.mean6_plane_step(b, JDim3(1, 1, 1), JDim3(1, 1, 1), interpret=True))
    assert got.dtype == jnp.bfloat16

    def r(v):  # one rounding to bfloat16, as f32
        return np.asarray(jnp.asarray(v, jnp.float32).astype(jnp.bfloat16)).astype(np.float32)

    a = np.asarray(b).astype(np.float32)
    n = 12

    def sh(dx, dy, dz):
        return a[1 + dx:n - 1 + dx, 1 + dy:n - 1 + dy, 1 + dz:n - 1 + dz]

    terms = [sh(-1, 0, 0), sh(1, 0, 0), sh(0, -1, 0), sh(0, 1, 0), sh(0, 0, -1), sh(0, 0, 1)]
    per_op, once = terms[0], terms[0]
    for t in terms[1:]:
        per_op, once = r(per_op + t), once + t
    core = got.astype(np.float32)[1:-1, 1:-1, 1:-1]
    np.testing.assert_array_equal(core, r(per_op / np.float32(6)))
    assert not np.array_equal(core, r(once * np.float32(jk.SIXTH)))
    assert jp.jacobi_wrap_step(jnp.asarray(a32[:8, :6, :6]).astype(jnp.bfloat16), interpret=True).dtype == jnp.bfloat16
    tb = torch.from_numpy(a32).to(torch.bfloat16)
    with pytest.raises(TypeError, match="queue 2"):
        ps.mean6_plane_step(tb, (1, 1, 1), (1, 1, 1))
    with pytest.raises(TypeError, match="queue 2"):
        jk.jacobi_wrap_step(tb[:8, :6, :6].contiguous(), 1)


# --- Jacobi3D at float64 against the JAX model -------------------------------------------


def _port(size, partition=None, **kw):
    m = Jacobi3D(*size, device="cpu", dtype=torch.float64, **kw)
    if partition is not None:
        m.dd.set_partition(*partition)
    m.realize()
    return m


def _jax(size, devices, partition=None, **kw):
    m = JJacobi3D(*size, devices=devices, dtype=jnp.float64, **kw)
    if partition is not None:
        m.dd.set_partition(*partition)
    m.realize()
    return m


#: name: (size, partition (None: 8 subdomains), JAX devices, kwargs, route, wavefront form)
ROUTES = {
    "wrap": ((20, 16, 18), (1, 1, 1), 1, dict(temporal_k=3), "wrap", None),
    "shell": ((24, 24, 24), None, 8, dict(pallas_path="shell"), "shell", None),
    "slab": ((24, 24, 24), None, 8, dict(pallas_path="slab"), "slab", None),
    "auto": ((24, 24, 24), None, 8, dict(), "wavefront", "z-slab"),
    "wavefront z-ring": ((16, 16, 128), (2, 1, 1), 2, dict(pallas_path="wavefront", temporal_k=2), "wavefront",
                         "z-ring"),
    "wavefront z_ring=False": ((16, 16, 128), (2, 1, 1), 2,
                               dict(pallas_path="wavefront", temporal_k=2, z_ring=False), "wavefront", "z-slab"),
    "uneven auto": ((21, 21, 21), None, 8, dict(), "wavefront", "plain"),
    "uneven shell": ((23, 21, 22), None, 8, dict(pallas_path="shell"), "shell", None),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_jacobi_f64_routes_equal_jax(name):
    size, part, ndev, kw, route, form = ROUTES[name]
    j = _jax(size, jax.devices()[:ndev], part, kernel_impl="pallas", interpret=True, **kw)
    t = _port(size, part if part is not None else None, subdomains=1 if part else 8, kernel_impl="cuda", **kw)
    assert t._pallas_path == j._pallas_path == route
    if route == "wavefront":
        assert t._wavefront_m == j._wavefront_m
        assert (t._wavefront_z_ring, t._wavefront_z_slabs) == (form == "z-ring", form != "plain")
        assert (j._wavefront_z_ring, j._wavefront_z_slabs) == (form == "z-ring", form != "plain")
    assert t.dd.get_curr(t.h).dtype == torch.float64
    j.step(5)
    t.step(5)
    got = t.temperature()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, j.temperature())
    assert got.min() >= COLD_TEMP and got.max() <= HOT_TEMP


def test_jacobi_f64_cuda_equals_torch_engine_within_rounding():
    """The torch engine sums in ``_kernel``'s order, the kernels in the TPU
    kernels': about one ulp a level apart, at float64 now."""
    t = _port((24, 24, 24), subdomains=8, kernel_impl="cuda")
    r = _port((24, 24, 24), subdomains=8, kernel_impl="torch")
    t.step(6)
    r.step(6)
    np.testing.assert_allclose(t.temperature(), r.temperature(), rtol=1e-14, atol=0)


@pytest.mark.parametrize("route", ["wrap", "shell"])
def test_state_carries_between_packages_f64(route):
    """JAX runs 3 steps at f64, the state moves to the port, both run 3
    more: bitwise equal; and the port's state round-trips back."""
    size = (24, 24, 24)
    if route == "wrap":
        j = _jax(size, jax.devices()[:1], kernel_impl="pallas", interpret=True)
        t = _port(size, kernel_impl="cuda")
    else:
        j = _jax(size, EIGHT, kernel_impl="pallas", interpret=True, pallas_path="shell")
        t = _port(size, subdomains=8, kernel_impl="cuda", pallas_path="shell")
    j.step(3)
    to_torch_state(j.dd.raw_to_host(j.h), t.dd)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    j.step(3)
    t.step(3)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    raw = to_jax_state(t.dd)
    assert raw.dtype == np.float64 and raw.shape == j.dd.raw_to_host(j.h).shape
    back = _port(size, subdomains=t.dd.num_subdomains(), kernel_impl="cuda", pallas_path=route)
    to_torch_state(raw, back.dd)
    np.testing.assert_array_equal(back.temperature(), t.temperature())


@pytest.mark.parametrize("name", ["wrap", "wavefront z-ring", "uneven shell"])
def test_jacobi_f64_captured_equals_uncaptured(name):
    size, part, _, kw, route, _ = ROUTES[name]
    sub = 1 if part else 8
    cap = _port(size, part, subdomains=sub, kernel_impl="cuda", capture=True, **kw)
    ref = _port(size, part, subdomains=sub, kernel_impl="cuda", **kw)
    assert cap._pallas_path == route and cap.dd.capture()
    for n in (3, 5, 2):
        cap.step(n)
        ref.step(n)
        np.testing.assert_array_equal(cap.temperature(), ref.temperature())
    loop = cap._step._loop
    assert loop.captures > 0 and loop.replays > 0


def test_bf16_storage_and_mxu_degrade_on_f64_fields():
    """The counterparts of tests/test_kernel_axes.py's
    ``test_mxu_degrades_on_f64_fields`` and
    ``test_bf16_degrades_on_f64_fields_and_xla_engine``: each request warns,
    lands on vpu / native as the JAX model does, and runs the plain f64
    route bitwise."""
    ref = _port((24, 24, 24), subdomains=8, kernel_impl="cuda")
    ref.step(2)
    for kw, what in (({"compute_unit": "mxu"}, "compute_unit=mxu"), ({"storage_dtype": "bf16"}, "storage_dtype=bf16"),
                     ({"compute_unit": "mxu_band", "mxu_input": "bf16"}, "compute_unit=mxu_band")):
        with pytest.warns(RuntimeWarning, match=what):
            t = _port((24, 24, 24), subdomains=8, kernel_impl="cuda", **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            j = _jax((24, 24, 24), EIGHT, kernel_impl="pallas", interpret=True, **kw)
        assert t._compute_unit == j._compute_unit == "vpu"
        assert t.dd.storage_dtype() == j.dd.storage_dtype() == "native"
        assert t._wavefront_m == ref._wavefront_m and t.dd.get_curr(t.h).dtype == torch.float64
        t.step(2)
        np.testing.assert_array_equal(t.temperature(), ref.temperature())
    with pytest.warns(RuntimeWarning, match="storage_dtype=bf16"):
        _port((24, 24, 24), subdomains=8, kernel_impl="torch", storage_dtype="bf16")


# --- the plan models at 8-byte cells ----------------------------------------------------


def test_plan_models_price_f64_cells_at_8_bytes():
    """The depth plan prices the working itemsize: at f64 the 512^3 2x2x2
    plan takes m = 4 (8 at f32; the JAX package's VMEM plan 16 at both:
    ROADMAP.md queue 3); the kernels still take m <= 8, two marches of 4
    levels whose block asks ``march_smem_bytes(m, 8)``."""
    assert jk.wavefront_smem_bytes(4, itemsize=8) == 2 * jk.wavefront_smem_bytes(4) == 204_800
    assert jk.wavefront_smem_fits(4, itemsize=8) and not jk.wavefront_smem_fits(5, itemsize=8)
    assert jk.wavefront_auto_depth(256, itemsize=8) == 4 and jk.wavefront_auto_depth(256) == 8
    assert jk.wavefront_auto_depth(12, itemsize=8) == jk.wavefront_auto_depth(12) == 3
    assert jk.march_smem_bytes(8, 8) == 132_160 <= jk.SMEM_PER_BLOCK
    assert jk.march_smem_bytes(3) == ps.mean6_wavefront_smem_bytes(3) == 49_696
    plans = {}
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        t = Jacobi3D(512, 512, 512, subdomains=8, kernel_impl="cuda", dtype=tdt, device="cpu")
        j = JJacobi3D(512, 512, 512, devices=EIGHT, kernel_impl="pallas", dtype=jdt)
        plans[str(tdt)] = (t._plan_wavefront(), j._plan_wavefront())
    assert plans == {"torch.float32": (8, 16), "torch.float64": (4, 16)}
    t = Jacobi3D(512, 512, 512, subdomains=8, kernel_impl="cuda", dtype=torch.float64, device="cpu",
                 pallas_path="wavefront", temporal_k=5)
    with pytest.raises(ValueError, match="258048 bytes of shared memory"):
        t._plan_wavefront()
    # the wrap route's depth reads no itemsize: k = 8, two marches of 4
    assert jk.choose_temporal_k((512, 512, 512)) == 8 and jk.wrap_march_depths(8) == [4, 4]
    assert jk.wrap_scratch_shape((8, 9, 10), 8) == (8, 9, 10) and jk.work_dtype(torch.float64) == torch.float64
    assert jk.work_dtype(torch.bfloat16) == torch.float32


# --- the ledger, the builds and the launch path --------------------------------------------


def test_new_forms_in_the_ledger_and_the_builds():
    counts = ledger.launch_counts()
    for fn in ("jacobi_wrap_step", "jacobi_zring_wavefront_step", "jacobi_shell_wavefront_step",
               "jacobi_plane_step", "jacobi_slab_step"):
        assert f"{fn}_f64" in counts and ledger.form_entry(f"{fn}_f64")["counter"] == "f64_launches"
        assert ledger.form_entry(f"{fn}_f64")["source"] == "stencil_tpu_torch/csrc/jacobi_wavefront.cu"
    for fn, source in (("mean6_shell_wavefront_step", "jacobi_wavefront.cu"), ("mean6_plane_step", "plane_stencil.cu")):
        for dt in ("bf16", "f64"):
            e = ledger.form_entry(f"{fn}_{dt}")
            assert f"{fn}_{dt}" in counts and e["counter"] == f"{dt}_launches" and e["source"].endswith(source)
    assert jk.library_name(f64=True) == "jacobi_wavefront_f64" and jk.form_counter(f64=True) == "f64_launches"
    assert build.VARIANTS["jacobi_wavefront_f64"] == ("jacobi_wavefront", ("-DSTP_JW_STORAGE=2",))
    for name in ("jacobi_wavefront", "jacobi_wavefront_bf16", "jacobi_wavefront_f64"):
        assert {"stp_mean6_march", "stp_mean6_march_plan", "stp_jacobi_plane", "stp_jacobi_slab"} <= set(
            build.SIGNATURES[name])
    assert set(build.SIGNATURES["plane_stencil"]) == {"stp_mean6_plane_level", "stp_mean6_plane_level_bf16",
                                                      "stp_mean6_plane_level_f64", "stp_mean6_plane_level_mxu",
                                                      "stp_mean6_plane_level_mxu_bf16"}
    with pytest.raises(AssertionError, match="f32 accumulator"):
        jk.jacobi_wrap_launch((8, 8, 8), 2, compute_unit="mxu", storage="f64")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` as its device, so that a
    wrapper takes its launch path; its data stays in host memory."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _card(t):
    """A tensor's copy that reports ``cuda:0`` (other arguments as they are)."""
    return t.clone().as_subclass(_OnCard) if isinstance(t, torch.Tensor) else t


def _host(ptr: int, like: torch.Tensor) -> torch.Tensor:
    """A writable tensor over ``like``'s bytes at host address ``ptr``."""
    nbytes = like.numel() * like.element_size()
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return torch.frombuffer(buf, dtype=like.dtype).view(like.shape)


@pytest.fixture
def card(monkeypatch):
    """Stand-in libraries whose entries record the build and the arguments
    they were called with and write the plain version's result, a fixed
    raw stream, and a record of library loads."""
    rec = types.SimpleNamespace(loads=[], calls=[], plain=None)

    def library(name):
        def entry(fn):
            def call(*args):
                rec.calls.append((name, fn, args))
                rec.plain(args)
                return 0
            return call
        return types.SimpleNamespace(**{fn: entry(fn) for fn in build.SIGNATURES[name]},
                                     stp_error_string=lambda code: b"stand-in error")

    def load(name):
        rec.loads.append(name)
        return library(name)

    monkeypatch.setattr(build, "load", load)
    for cache, value in (("_ENTRY", None), ("_ENTRIES", {}), ("_VARIANTS", {})):
        monkeypatch.setattr(jk, cache, value)
    monkeypatch.setattr(jk, "current_raw_stream", lambda index: 7000 + index)
    monkeypatch.setattr(ps, "current_raw_stream", lambda index: 7000 + index)
    return rec


def _counts(wrapper, counters):
    return {c: getattr(wrapper, c) for c in counters}


@pytest.mark.parametrize("k", [1, 8])
def test_f64_wrap_launches_its_build(card, k):
    block = torch.from_numpy(_rand((24, 16, 32), k))
    want = jk.jacobi_wrap_step_plain(block, k)
    card.plain = lambda args: _host(args[1], block).copy_(want)
    before = _counts(jk.jacobi_wrap_step, jk.CONTRACTION_COUNTERS)
    got = jk.jacobi_wrap_step(block.clone().as_subclass(_OnCard), k)
    after = _counts(jk.jacobi_wrap_step, jk.CONTRACTION_COUNTERS)
    assert card.loads == ["jacobi_wavefront_f64"]
    (lib, fn, args), = card.calls
    assert fn == "stp_jacobi_wrap" and args[3:] == (24, 16, 32, k, *jk.sphere_params(24), 7000)
    assert (args[2] is None) == (k <= 4)
    assert {c: after[c] - before[c] for c in after} == {c: int(c == "f64_launches") for c in after}
    assert got.dtype == torch.float64 and torch.equal(got.as_subclass(torch.Tensor), want)


@pytest.mark.parametrize("m", [2, 6])
def test_f64_wavefront_takes_a_double_scratch(card, m, monkeypatch):
    """Two marches pass their level through a scratch of the block's dtype."""
    scratch = []
    monkeypatch.setattr(torch.Tensor, "new_empty", lambda self, shape, dtype=None: scratch.append(dtype) or
                        torch.empty(shape, dtype=dtype))
    s = m
    raw = torch.from_numpy(_rand((2, 2 * s + 5, 2 * s + 6, 2 * s + 7), m))
    org = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    gs = (40, 40, 40)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s, int(o[2]) - s, raw.shape[-2:], gs) for o in org])
    card.plain = lambda args: None
    before = _counts(jk.jacobi_shell_wavefront_step, jk.CONTRACTION_COUNTERS)
    jk.jacobi_shell_wavefront_step(*map(_card, (raw, m, org, d2)), gs)
    after = _counts(jk.jacobi_shell_wavefront_step, jk.CONTRACTION_COUNTERS)
    assert card.loads == ["jacobi_wavefront_f64"] and card.calls[0][1] == "stp_jacobi_wavefront"
    assert (card.calls[0][2][6] is None) == (m <= 4)
    assert scratch == ([torch.float64] if m > 4 else [])
    assert after["f64_launches"] == before["f64_launches"] + 1 and after["launches"] == before["launches"]


@pytest.mark.parametrize("which", ["plane", "slab"])
def test_f64_one_level_forms_launch_their_build(card, which):
    n, X, Y, Z = 2, 6, 9, 11
    gs = (X + 5, Y + 1, Z + 2)
    org = torch.tensor([[1, 0, 2], [3, 4, 5]], dtype=torch.int32)
    wrapper = jk.jacobi_plane_step if which == "plane" else jk.jacobi_slab_step
    block = torch.from_numpy(_rand((n, X, Y, Z), 80))
    if which == "plane":
        d2 = torch.stack([_d2(o, (Y - 2, Z - 2), gs) for o in org])
        want = jk.jacobi_plane_step_plain(block, org, d2, gs)
        card.plain = lambda args: _host(args[1], block).copy_(want)
        before = _counts(wrapper, jk.STORAGE_COUNTERS)
        got = wrapper(*map(_card, (block, org, d2)), gs)
    else:
        d2 = torch.stack([_d2(o, (Y, Z), gs) for o in org])
        faces = [torch.from_numpy(_rand(sh, 81 + i)) for i, sh in enumerate([(n, Y, Z)] * 2 + [(n, X, Z)] * 2
                                                                             + [(n, X, Y)] * 2)]
        want = jk.jacobi_slab_step_plain(block, *faces, org, d2, gs)
        card.plain = lambda args: _host(args[1], block).copy_(want)
        before = _counts(wrapper, jk.STORAGE_COUNTERS)
        got = wrapper(*map(_card, (block, *faces, org, d2)), gs)
    after = _counts(wrapper, jk.STORAGE_COUNTERS)
    assert card.loads == ["jacobi_wavefront_f64"] and card.calls[0][1] == f"stp_jacobi_{which}"
    assert {c: after[c] - before[c] for c in after} == {c: int(c == "f64_launches") for c in after}
    assert got.dtype == torch.float64 and torch.equal(got.as_subclass(torch.Tensor), want)


@pytest.mark.parametrize("dt", ["f32", "bf16", "f64"])
def test_mean6_plane_launches_the_entry_of_its_dtype(card, dt):
    """#18 on the direct launch path: the entry of the block's dtype in the
    one ``plane_stencil`` library, the raw stream, the form's counter."""
    a = _rand((14, 13, 12), 90)
    block = torch.from_numpy(a.astype(np.float32)) if dt == "f32" else _pair(a, dt)[0]
    acc = dt == "bf16"
    want = ps.mean6_plane_step_plain(block, (1, 2, 1), (2, 1, 3), f32_accumulate=acc)
    card.plain = lambda args: _host(args[1], block).copy_(want)
    counters = tuple(ps._COUNTER.values())
    before = _counts(ps.mean6_plane_step, counters)
    got = ps.mean6_plane_step(block.as_subclass(_OnCard), (1, 2, 1), (2, 1, 3), f32_accumulate=acc)
    after = _counts(ps.mean6_plane_step, counters)
    (lib, fn, args), = card.calls
    assert card.loads == ["plane_stencil"] and lib == "plane_stencil"
    assert fn == "stp_mean6_plane_level" + {"f32": "", "bf16": "_bf16", "f64": "_f64"}[dt]
    assert args[2:] == (14, 13, 12, 1, 2, 1, 2, 1, 3, 7000)
    assert {c: after[c] - before[c] for c in after} == {c: int(c == ps._COUNTER[dt]) for c in after}
    assert got.dtype == block.dtype and torch.equal(got.as_subclass(torch.Tensor), want)


@pytest.mark.parametrize("dt", ["bf16", "f64"])
@pytest.mark.parametrize("m", [3, 6])
def test_mean6_wavefront_launches_the_build_of_its_dtype(card, dt, m):
    t = _pair(_rand((2 * m + 7, 2 * m + 6, 2 * m + 5), 91), dt)[0]
    acc = dt == "bf16"
    S = slice(m, -m)
    want = ps.mean6_shell_wavefront_step_plain(t, m, m, f32_accumulate=acc)
    card.plain = lambda args: _host(args[1], t)[S, S, S].copy_(want[S, S, S])
    before = _counts(ps.mean6_shell_wavefront_step, tuple(ps._COUNTER.values()))
    got = ps.mean6_shell_wavefront_step(t.as_subclass(_OnCard), m, m, f32_accumulate=acc)
    after = _counts(ps.mean6_shell_wavefront_step, tuple(ps._COUNTER.values()))
    assert card.loads == [f"jacobi_wavefront_{dt}"]
    (lib, fn, args), = card.calls
    assert fn == "stp_mean6_march" and args[3:] == (1, *t.shape, m, m, 7000) and (args[2] is None) == (m <= 4)
    assert {c: after[c] - before[c] for c in after} == {c: int(c == f"{dt}_launches") for c in after}
    assert torch.equal(got.as_subclass(torch.Tensor)[S, S, S], want[S, S, S])
