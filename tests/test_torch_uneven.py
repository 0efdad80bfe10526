"""Uneven global sizes (pad-and-mask) in the port against the JAX package.

A size the subdomain grid does not divide is padded to ``ceil(size / dim)``
cells per subdomain and axis; the last subdomain owns the remainder
(``stencil_tpu/domain.py:478-510``).  The exchange sends each subdomain's top
VALID slab and writes the received +axis halo right after its valid cells,
through ``blend_slab_dynamic``.  Inputs come from seeded numpy or from
coordinates; the JAX side runs on the fake 8-device mesh (tests/conftest.py),
its Pallas kernels in interpret mode.  What each case is held to:

* ``blend_slab_dynamic_plain`` against the JAX kernel and against
  ``lax.dynamic_update_slice``: bitwise;
* the exchange's raw arrays, halos and pad cells included: bitwise;
* ``Jacobi3D`` on the torch engine, the shell route and the plain wavefront:
  bitwise against the same JAX route, and the kernel routes against the
  one-subdomain wrap route (no padding there);
* the stream engine (mean6) and ``AstarothSim``: bitwise against the JAX
  ``jnp`` route, within rtol 1e-6 of its interpret-mode wavefront (XLA
  contracts a level's multiply into the next level's adds there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.models.astaroth import AstarothSim as JAstaroth
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.ops import halo_blend as jhb
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.ops import halo_blend as hb

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _coord_field(x, y, z):
    return x * 10000.0 + y * 100.0 + z


# --- blend_slab_dynamic ----------------------------------------------------------


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("r", [1, 3, 5])
def test_blend_dynamic_plain_equals_pallas(axis, r):
    """Three blocks, each written at its own offset, against the JAX kernel
    called per block (its offset is per shard)."""
    shape = (5, 21, 19)
    rng = np.random.default_rng(axis * 10 + r)
    blocks = rng.random((3,) + shape).astype(np.float32)
    slab_shape = list(blocks.shape)
    slab_shape[1 + axis] = r
    slabs = rng.random(slab_shape).astype(np.float32)
    ext = shape[axis]
    pos = np.array([0, ext // 2 - 1, ext - r], np.int32)
    got = hb.blend_slab_dynamic(torch.from_numpy(blocks.copy()), torch.from_numpy(slabs), axis,
                                torch.from_numpy(pos))
    for b in range(3):
        want = jhb.blend_slab_dynamic(jnp.asarray(blocks[b]), jnp.asarray(slabs[b]), axis,
                                      jnp.int32(pos[b]), interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.uint8])
def test_blend_dynamic_equals_dynamic_update_slice(axis, dtype):
    """Every dtype the kernel takes and all three axes (the port also sends
    the x halo through it), an offset per block, one of them out of range:
    ``lax.dynamic_update_slice`` clamps it, and so does the port."""
    shape = (2, 9, 11, 13)
    blocks = (torch.from_numpy(_rand(shape, 1)) * 100).to(dtype)
    slab_shape = list(shape)
    slab_shape[1 + axis] = 2
    slab = (torch.from_numpy(_rand(slab_shape, 2)) * 100).to(dtype)
    ext = shape[1 + axis]
    pos = torch.tensor([3, ext + 4], dtype=torch.int32)  # the second clamps to ext - 2
    got = hb.blend_slab_dynamic(blocks.clone(), slab, axis, pos)
    for b in range(2):
        start = [0, 0, 0]
        start[axis] = int(pos[b])
        want = jax.lax.dynamic_update_slice(jnp.asarray(blocks[b].float().numpy()),
                                            jnp.asarray(slab[b].float().numpy()), start)
        np.testing.assert_array_equal(got[b].float().numpy(), np.asarray(want))


def test_blend_dynamic_arguments_checked():
    blocks = torch.zeros((2, 4, 5, 6))
    slab = torch.zeros((2, 4, 1, 6))
    with pytest.raises(TypeError, match="int32"):
        hb.blend_slab_dynamic(blocks, slab, 1, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="offsets"):
        hb.blend_slab_dynamic(blocks, slab, 1, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not fit"):
        hb.blend_slab_dynamic(blocks, slab, 2, torch.zeros(2, dtype=torch.int32))
    one = hb.blend_slab_dynamic(torch.zeros((4, 5, 6)), torch.ones((4, 5, 2)), 2,
                                torch.tensor([3], dtype=torch.int32))
    assert float(one[..., 3:5].min()) == 1.0 and float(one.sum()) == 4 * 5 * 2


# --- domain and exchange ---------------------------------------------------------


def _domains(size, radius, dtypes=(np.float32,)):
    """JAX and port domains over 8 subdomains, each quantity initialised from
    its coordinates and exchanged once."""
    j = JDomain(*size)
    j.set_radius(radius(JRadius))
    t = DistributedDomain(*size, device="cpu")
    t.set_radius(radius(Radius))
    t.set_subdomains(8)
    jh = [j.add_data(f"q{i}", dt) for i, dt in enumerate(dtypes)]
    th = [t.add_data(f"q{i}", dt) for i, dt in enumerate(dtypes)]
    j.realize()
    t.realize()
    assert tuple(t.grid_dim()) == tuple(j.placement.dim())
    assert t.valid_last() == j._valid_last
    for a, b, dt in zip(jh, th, dtypes):
        j.init_by_coords(a, lambda x, y, z, dt=dt: _coord_field(x, y, z).astype(dt))
        t.init_by_coords(b, _coord_field)
    j.exchange()
    t.exchange()
    return j, jh, t, th


@pytest.mark.parametrize("size", [(15, 16, 16), (17, 18, 19), (15, 13, 19)])
@pytest.mark.parametrize("radius", ["faces1", "fec211"])
def test_uneven_exchange_bitwise_vs_jax(size, radius):
    rad = {"faces1": lambda R: R.constant(0).set_face(1), "fec211": lambda R: R.face_edge_corner(2, 1, 1)}
    j, jh, t, th = _domains(size, rad[radius])
    assert t.padded()
    np.testing.assert_array_equal(t.raw_to_host(th[0]), j.raw_to_host(jh[0]))


def test_uneven_exchange_wraps_at_the_last_valid_cell():
    """(15, 16, 16): x pads 15 over 2 to 8 + 7.  Subdomain (0,0,0)'s -x halo
    holds global x = 14, and the last x subdomain's +x halo, right after its
    7 valid cells, holds global x = 0 (tests/test_uneven.py:42-64)."""
    t = DistributedDomain(15, 16, 16, device="cpu")
    t.set_radius(Radius.constant(1))
    t.set_subdomains(8)
    h = t.add_data("q")
    t.realize()
    t.init_by_coords(h, _coord_field)
    before = t.quantity_to_host(h)
    t.exchange()
    np.testing.assert_array_equal(t.quantity_to_host(h), before)
    stack = t.get_curr(h)
    assert float(stack[0, 0, 0, 0, 1, 1]) == 14 * 10000.0
    assert t.shard_valid((1, 0, 0)) == Dim3(7, 8, 8)
    assert float(stack[1, 0, 0, 1 + 7, 1, 1]) == 0.0


def test_uneven_multi_quantity_mixed_dtype_exchange():
    """f32 and f64 quantities exchanged together keep the per-subdomain
    offsets (tests/test_uneven.py:171-195)."""
    j, jh, t, th = _domains((15, 16, 16), lambda R: R.constant(1), (np.float32, np.float64))
    for a, b in zip(jh, th):
        got = t.raw_to_host(b)
        assert got.dtype == np.asarray(j.raw_to_host(a)).dtype
        np.testing.assert_array_equal(got, j.raw_to_host(a))


def test_realize_pads_and_host_round_trip():
    """Padded geometry as the JAX package's; a host array round-trips through
    the valid cells, and pad cells and the shell load as zeros."""
    size = (17, 13, 19)
    j = JDomain(*size)
    j.set_radius(JRadius.constant(1))
    jh = j.add_data("q")
    j.realize()
    t = DistributedDomain(*size, device="cpu")
    t.set_radius(Radius.constant(1))
    t.set_subdomains(8)
    h = t.add_data("q")
    t.realize()
    dim = t.grid_dim()
    assert t.local_spec().sz == Dim3(*j.subdomain_size()) and t.valid_last() == j._valid_last
    for idx in ((0, 0, 0), tuple(d - 1 for d in dim)):
        assert tuple(t.shard_valid(idx)) == tuple(j.shard_valid(idx))
    field = _rand(size, 3)
    t.set_quantity(h, field)
    j.set_quantity(jh, field)
    np.testing.assert_array_equal(t.quantity_to_host(h), field)
    np.testing.assert_array_equal(t.raw_to_host(h), j.raw_to_host(jh))
    # the raw array keeps its shape through the JAX layout
    t.set_raw(h, j.raw_to_host(jh))
    np.testing.assert_array_equal(t.quantity_to_host(h), field)


@pytest.mark.parametrize("size,radius,partition", [((9, 8, 8), 5, (2, 1, 1)), ((10, 8, 8), 1, (8, 1, 1))])
def test_too_small_remainder_raises(size, radius, partition):
    """A last subdomain thinner than the shell, or empty (10 cells over 8:
    ceil gives 2, and 7 * 2 >= 10), is refused, as in the JAX package."""
    t = DistributedDomain(*size, device="cpu")
    t.set_radius(radius)
    t.set_partition(*partition)
    t.add_data("q")
    with pytest.raises(ValueError, match="radius shell|trailing subdomain"):
        t.realize()


# --- Jacobi3D ----------------------------------------------------------------------


def _jacobi_pair(size, jax_kw, port_kw):
    j = JJacobi3D(*size, **jax_kw)
    j.realize()
    t = Jacobi3D(*size, device="cpu", subdomains=8, **port_kw)
    t.realize()
    assert tuple(t.dd.grid_dim()) == tuple(j.dd.placement.dim())
    return j, t


@pytest.mark.parametrize("size", [(17, 17, 17), (15, 18, 13)])
@pytest.mark.parametrize("route", ["torch", "shell", "wavefront"])
def test_uneven_jacobi_bitwise_vs_jax(size, route):
    if route == "torch":
        j, t = _jacobi_pair(size, {}, {})
    else:
        kw = dict(pallas_path=route, temporal_k=3 if route == "wavefront" else "auto")
        j, t = _jacobi_pair(size, dict(kernel_impl="pallas", interpret=True, **kw), dict(kernel_impl="cuda", **kw))
        assert t._pallas_path == j._pallas_path == route
    if route == "wavefront":
        assert t._wavefront_m == j._wavefront_m == 3
        assert not t._wavefront_z_slabs and not j._wavefront_z_slabs  # the plain form
    j.step(7)  # wavefront: 2 macros and a shallower remainder
    t.step(7)
    np.testing.assert_array_equal(t.temperature(), j.temperature())


@pytest.mark.parametrize("size,route,m", [((17, 17, 17), "wavefront", 2), ((15, 18, 13), "shell", 0)])
def test_uneven_auto_route_matches_jax(size, route, m):
    """``auto`` on padded subdomains: the plain wavefront where the smallest
    valid extent allows m >= 2, else shell (slab needs even sizes)."""
    j, t = _jacobi_pair(size, dict(kernel_impl="pallas", interpret=True), dict(kernel_impl="cuda"))
    assert t._pallas_path == j._pallas_path == route
    assert t._wavefront_m == j._wavefront_m == m
    assert not t._wavefront_z_slabs


@pytest.mark.parametrize("route", ["shell", "wavefront"])
def test_uneven_kernel_routes_equal_one_subdomain(route):
    """The gold check of tests/test_uneven.py: padded subdomains give the
    field one unpadded subdomain gives (the wrap route, same summation
    order), bitwise."""
    size = (17, 17, 17)
    kw = dict(kernel_impl="cuda", pallas_path=route, temporal_k=3 if route == "wavefront" else "auto")
    multi = Jacobi3D(*size, device="cpu", subdomains=8, **kw)
    multi.realize()
    single = Jacobi3D(*size, device="cpu", kernel_impl="cuda", temporal_k=3)
    single.realize()
    assert single._pallas_path == "wrap" and multi.dd.padded()
    multi.step(7)
    single.step(7)
    np.testing.assert_array_equal(multi.temperature(), single.temperature())


def test_driver_runs_an_uneven_size(capsys):
    from stencil_tpu_torch.bin import jacobi3d

    rc = jacobi3d.main(["17", "17", "17", "--no-weak-scale", "--iters", "2", "--device", "cpu",
                        "--partition", "2,2,2"])
    assert rc == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[4:7] == ["17", "17", "17"] and float(row[7]) > 0


# --- stream engine and Astaroth ----------------------------------------------------


def _mean6(views, info):
    return {
        name: (src.sh(-1, 0, 0) + src.sh(0, -1, 0) + src.sh(0, 0, -1)
               + src.sh(1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, 0, 1)) / 6.0
        for name, src in views.items()
    }


def _mean6_domain(mod, size, count, mult):
    def init(x, y, z):
        return (x * 31 + y * 7 + z) / 1000.0

    if mod == "jax":
        dd = JDomain(*size)
        dd.set_radius(JRadius.constant(1))
        dd.set_devices(jax.devices()[:count])
    else:
        dd = DistributedDomain(*size, device="cpu")
        dd.set_radius(Radius.constant(1))
        dd.set_subdomains(count)
    if mult != 1:
        dd.set_halo_multiplier(mult)
    h = dd.add_data("u", np.float32 if mod == "jax" else torch.float32)
    dd.realize()
    dd.init_by_coords(h, init)
    return dd, h


@pytest.mark.parametrize("path,mult", [("wavefront", 3), ("plane", 1)])
def test_uneven_stream_mean6_vs_jax(path, mult):
    """The stream engine on padded subdomains (15, 18, 13): the plain
    wavefront (m = 3, 2 macros and a remainder) and the plane route, against
    the JAX stream engine and the one-device JAX jnp route."""
    size = (15, 18, 13)
    td, th = _mean6_domain("port", size, 8, mult)
    step = td.make_step(_mean6, engine="stream", stream_path=path)
    assert step._stream_plan["route"] == path and not step._stream_plan["z_slabs"]
    jd, jh = _mean6_domain("jax", size, 8, mult)
    jstep = jd.make_step(_mean6, engine="stream", interpret=True, stream_path=path)
    assert jstep._stream_plan["route"] == path and not jstep._stream_plan["z_slabs"]
    rd, rh = _mean6_domain("jax", size, 1, 1)
    rd.run_step(rd.make_step(_mean6, overlap=False), 7)
    td.run_step(step, 7)
    jd.run_step(jstep, 7)
    np.testing.assert_array_equal(td.quantity_to_host(th), rd.quantity_to_host(rh))
    np.testing.assert_allclose(td.quantity_to_host(th), jd.quantity_to_host(jh), **TOL)
    if path == "wavefront":
        with pytest.raises(ValueError, match="unpadded"):
            td.make_step(_mean6, engine="stream", stream_z_slabs=True)


@pytest.mark.parametrize("schedule,route", [("auto", "wavefront"), ("per-step", "plane")])
def test_uneven_astaroth_vs_jax(schedule, route):
    """Radius 3 over padded subdomains (15, 14, 13): the port's cuda routes
    and torch engine against the JAX jnp route on the same grid and on one
    device (tests/test_uneven.py:148-159), bitwise."""
    size = (15, 14, 13)
    j = JAstaroth(*size, num_quantities=2)
    j.realize()
    one = JAstaroth(*size, num_quantities=2, devices=jax.devices()[:1])
    one.realize()
    t = AstarothSim(*size, num_quantities=2, subdomains=8, kernel_impl="cuda", schedule=schedule, device="cpu")
    t.realize()
    ref = AstarothSim(*size, num_quantities=2, subdomains=8, device="cpu")
    ref.realize()
    assert t.dd.padded() and tuple(t.dd.grid_dim()) == tuple(j.dd.placement.dim())
    plan = t._step._stream_plan
    assert plan["route"] == route and not plan["z_slabs"]
    state = [np.asarray(j.dd.raw_to_host(h)) for h in j.handles]
    t.load_state(state)
    ref.load_state(state)
    for m in (j, one, t, ref):
        m.step(5)
    for q in range(2):
        want = np.asarray(j.field(q))
        np.testing.assert_array_equal(t.field(q), want)
        np.testing.assert_array_equal(ref.field(q), want)
        np.testing.assert_allclose(t.field(q), np.asarray(one.field(q)), rtol=1e-5, atol=1e-6)
