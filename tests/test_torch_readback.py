"""Region readback, the two debug oracles and the byte accounting of the
port, against the JAX package.

The cases of ``tests/test_readback.py`` on the port (``device="cpu"``, 8
subdomains of one device) beside the JAX domain on the fake 8-device mesh
(tests/conftest.py):

* ``region_to_host`` / ``interior_to_host`` and the ``slot=`` readbacks;
* ``MethodFlags.RollCompare`` and ``AllGather`` bitwise equal to the default
  exchange, to each other and to the JAX oracles, and refused on uneven
  sizes and on component quantities;
* ``sweep_bytes`` against ``exchange_bytes``, and ``exchange_bytes_total`` /
  ``exchange_hop_bytes`` / ``exchange_bytes_for_method`` equal to the JAX
  domain's numbers for the same geometry;
* ``subdomain_size`` / ``get_interior`` / ``get_exterior``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import geometry as jgeo
from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.dim3 import Rect3 as JRect3
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.utils.config import MethodFlags as JMethodFlags
from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.geometry import LocalSpec, exchange_bytes, sweep_bytes, sweep_hop_bytes
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.utils.config import MethodFlags

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

ORACLES = ["RollCompare", "AllGather"]


def _port(size=(16, 16, 16), radius=2, methods=MethodFlags.All, grid=None, quantities=(("q", ()),), mult=1):
    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(Radius.constant(radius) if isinstance(radius, int) else radius)
    dd.set_subdomains(8)
    if grid is not None:
        dd.set_partition(*grid)
    if mult > 1:
        dd.set_halo_multiplier(mult)
    dd.set_methods(methods)
    hs = [dd.add_data(n, components=c) for n, c in quantities]
    dd.realize()
    return dd, hs


def _jax(size=(16, 16, 16), radius=2, methods=JMethodFlags.All, grid=None, quantities=(("q", ()),), mult=1):
    dd = JDomain(*size)
    dd.set_radius(JRadius.constant(radius) if isinstance(radius, int) else radius)
    if grid is not None:
        dd.set_partition(*grid)
    if mult > 1:
        dd.set_halo_multiplier(mult)
    dd.set_methods(methods)
    hs = [dd.add_data(n, dtype=jnp.float32, components=c) for n, c in quantities]
    dd.realize()
    return dd, hs


def _ripple_domain(methods=MethodFlags.All, grid=None):
    dd, (h,) = _port(methods=methods, grid=grid)
    dd.init_by_coords(h, lambda x, y, z: (x * 10000 + y * 100 + z).to(torch.float32))
    return dd, h


@pytest.mark.parametrize(
    "region",
    [
        ((0, 0, 0), (16, 16, 16)),  # the whole domain
        ((3, 5, 7), (11, 9, 13)),  # across subdomain boundaries
        ((9, 0, 2), (10, 4, 16)),  # a thin slab in one x row of subdomains
        ((4, 4, 4), (4, 9, 9)),  # empty
    ],
)
def test_region_to_host(region):
    lo, hi = region
    dd, h = _ripple_domain(grid=(2, 1, 4))
    j, (jh,) = _jax(grid=(2, 1, 4))
    j.set_quantity(jh, dd.quantity_to_host(h))
    got = dd.region_to_host(h, Rect3(Dim3(*lo), Dim3(*hi)))
    full = dd.quantity_to_host(h)
    np.testing.assert_array_equal(got, full[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]])
    np.testing.assert_array_equal(got, j.region_to_host(jh, JRect3(JDim3(*lo), JDim3(*hi))))


def test_region_to_host_uneven_and_out_of_range():
    size = (15, 13, 16)
    dd, (h,) = _port(size=size, radius=1)
    j, (jh,) = _jax(size=size, radius=1)
    field = np.random.default_rng(7).random(size).astype(np.float32)
    dd.set_quantity(h, field)
    j.set_quantity(jh, field)
    for lo, hi in (((0, 0, 0), size), ((5, 6, 3), (15, 13, 11)), ((7, 0, 0), (9, 13, 1))):
        got = dd.region_to_host(h, Rect3(Dim3(*lo), Dim3(*hi)))
        np.testing.assert_array_equal(got, field[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]])
        np.testing.assert_array_equal(got, j.region_to_host(jh, JRect3(JDim3(*lo), JDim3(*hi))))
    with pytest.raises(ValueError, match="leaves the domain"):
        dd.region_to_host(h, Rect3(Dim3(0, 0, 0), Dim3(16, 13, 16)))


def test_interior_to_host_alias_and_slots():
    dd, h = _ripple_domain()
    np.testing.assert_array_equal(dd.interior_to_host(h), dd.quantity_to_host(h))
    field = np.random.default_rng(3).random((16, 16, 16)).astype(np.float32)
    dd.set_quantity(h, field, slot="next")
    np.testing.assert_array_equal(dd.quantity_to_host(h, slot="next"), field)
    np.testing.assert_array_equal(dd.interior_to_host(h, "next"), field)
    np.testing.assert_array_equal(dd.region_to_host(h, Rect3(Dim3(1, 2, 3), Dim3(5, 6, 7)), slot="next"),
                                  field[1:5, 2:6, 3:7])
    assert dd.raw_to_host(h, slot="next").shape == dd.raw_to_host(h).shape
    dd.swap()
    np.testing.assert_array_equal(dd.quantity_to_host(h), field)
    with pytest.raises(ValueError, match="slot"):
        dd.quantity_to_host(h, slot="prev")


@pytest.mark.parametrize("grid", [(2, 2, 2), (2, 1, 4)])
@pytest.mark.parametrize("oracle", ORACLES)
def test_oracle_exchange_matches_default_and_jax(oracle, grid):
    """Each oracle's raw arrays equal the default exchange's, the other
    oracle's and the JAX oracle's, bitwise, on two seeded quantities."""
    size = (16, 16, 16)
    fields = [np.random.default_rng(s).random(size).astype(np.float32) for s in (11, 12)]
    quantities = (("a", ()), ("b", ()))
    raws = {}
    for name in ["default"] + ORACLES:
        method = MethodFlags.All if name == "default" else getattr(MethodFlags, name)
        dd, hs = _port(methods=method, grid=grid, quantities=quantities)
        assert dd.exchange_route() == "direct"
        for h, f in zip(hs, fields):
            dd.set_quantity(h, f)
        dd.exchange()
        raws[name] = [dd.raw_to_host(h) for h in hs]
    j, jhs = _jax(methods=getattr(JMethodFlags, oracle), grid=grid, quantities=quantities)
    for h, f in zip(jhs, fields):
        j.set_quantity(h, f)
    j.exchange()
    for q, jh in enumerate(jhs):
        np.testing.assert_array_equal(raws[oracle][q], raws["default"][q])
        np.testing.assert_array_equal(raws["RollCompare"][q], raws["AllGather"][q])
        np.testing.assert_array_equal(raws[oracle][q], j.raw_to_host(jh))


@pytest.mark.parametrize("oracle", ORACLES)
def test_oracle_exchange_many_and_halo_multiplier(oracle):
    """``exchange_many`` runs the oracle, and a halo multiplier's wider
    shell fills as the default exchange fills it."""
    outs = []
    for method in (MethodFlags.All, getattr(MethodFlags, oracle)):
        dd, (h,) = _port(radius=1, methods=method, grid=(2, 1, 4), mult=2)
        dd.set_quantity(h, np.random.default_rng(5).random((16, 16, 16)).astype(np.float32))
        dd.exchange_many(2)
        outs.append(dd.raw_to_host(h))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("oracle", ORACLES)
def test_oracle_rejects_uneven_sizes_and_components(oracle):
    method = getattr(MethodFlags, oracle)
    with pytest.raises(ValueError, match="even sizes"):
        _port(size=(17, 16, 16), radius=1, methods=method)
    with pytest.raises(ValueError, match="scalar quantities only"):
        _port(radius=1, methods=method, quantities=(("v", (3,)),))
    # the JAX domain refuses both alike
    jmethod = getattr(JMethodFlags, oracle)
    with pytest.raises(ValueError, match="even sizes"):
        _jax(size=(17, 16, 16), radius=1, methods=jmethod)
    with pytest.raises(ValueError, match="scalar quantities only"):
        _jax(radius=1, methods=jmethod, quantities=(("v", (3,)),))


def test_sweep_bytes_model():
    # a single-axis radius: the sweeps send exactly the two face messages
    r = Radius.constant(0)
    r.set_dir(Dim3(1, 0, 0), 2)
    r.set_dir(Dim3(-1, 0, 0), 2)
    spec = LocalSpec.make(Dim3(8, 8, 8), Dim3(0, 0, 0), r)
    assert sweep_bytes(spec, [4]) == exchange_bytes(spec, [4])

    # faces only on all axes: the sweeps also carry the y and z halo overhang
    r = Radius.constant(0)
    r.set_face(1)
    spec = LocalSpec.make(Dim3(8, 8, 8), Dim3(0, 0, 0), r)
    assert sweep_bytes(spec, [4]) > exchange_bytes(spec, [4])

    # a full constant radius: edge data rides two sweeps and corner data
    # three, one and two copies above the 26-message model
    spec = LocalSpec.make(Dim3(8, 8, 8), Dim3(0, 0, 0), Radius.constant(2))
    edge_cells = 12 * (2 * 2 * 8)
    corner_cells = 8 * (2 * 2 * 2)
    assert sweep_bytes(spec, [4]) == exchange_bytes(spec, [4]) + 4 * (edge_cells + 2 * corner_cells)
    assert sum(sweep_hop_bytes(spec, [4, 8]).values()) == sweep_bytes(spec, [4, 8])


#: radii to compare the byte models on: (port radius, JAX radius)
_UNEVEN = {(1, 0, 0): 2, (-1, 0, 0): 1, (0, 1, 0): 1, (0, -1, 0): 3, (0, 0, 1): 0, (0, 0, -1): 2}
BYTE_RADII = {
    "constant2": lambda R: R.constant(2),
    "faces1": lambda R: R.constant(0).set_face(1),
    "uneven": lambda R: R.from_dict(_UNEVEN),
    "fec211": lambda R: R.face_edge_corner(2, 1, 1),
}


@pytest.mark.parametrize("radius", sorted(BYTE_RADII))
def test_geometry_byte_models_match_jax(radius):
    spec = LocalSpec.make(Dim3(8, 10, 12), Dim3(0, 0, 0), BYTE_RADII[radius](Radius))
    jspec = jgeo.LocalSpec.make(JDim3(8, 10, 12), JDim3(0, 0, 0), BYTE_RADII[radius](JRadius))
    for sizes in ([4], [4, 8, 12]):
        assert exchange_bytes(spec, sizes) == jgeo.exchange_bytes(jspec, sizes)
        assert sweep_bytes(spec, sizes) == jgeo.sweep_bytes(jspec, sizes)
        assert sweep_hop_bytes(spec, sizes) == jgeo.sweep_hop_bytes(jspec, sizes)


@pytest.mark.parametrize("grid", [(2, 2, 2), (2, 1, 4), (8, 1, 1)])
@pytest.mark.parametrize("mult", [1, 2])
def test_domain_byte_accounting_matches_jax(grid, mult):
    """Per-exchange bytes of a mixed domain (a vector, an f32 and an f64
    scalar): the 26-message total, the per-hop sweep bytes (0 on a size-1
    grid axis) and the per-method split equal the JAX domain's."""
    doms = []
    for Domain, R, kw in ((JDomain, JRadius, {}), (DistributedDomain, Radius, {"device": "cpu"})):
        d = Domain(16, 16, 16, **kw)
        d.set_radius(R.constant(1))
        d.set_partition(*grid)
        if mult > 1:
            d.set_halo_multiplier(mult)
        d.add_data("v", dtype=np.float32, components=(3,))
        d.add_data("s", dtype=np.float32)
        d.add_data("d", dtype=np.float64)
        d.realize()
        doms.append(d)
    j, t = doms
    assert t.exchange_bytes_total() == j.exchange_bytes_total() > 0
    assert t.exchange_hop_bytes() == j.exchange_hop_bytes()
    for name in ("Ppermute", "All", "AllGather", "RollCompare", "CudaKernel"):
        assert t.exchange_bytes_for_method(getattr(MethodFlags, name)) == \
            j.exchange_bytes_for_method(getattr(JMethodFlags, name))
    assert tuple(t.subdomain_size()) == tuple(j.subdomain_size())

    def box(r):
        return tuple(r.lo), tuple(r.hi)

    assert box(t.get_interior()) == box(j.get_interior())
    assert [box(r) for r in t.get_exterior()] == [box(r) for r in j.get_exterior()]
