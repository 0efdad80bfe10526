"""The port's geometry, partitions and statistics against the JAX package's.

``stencil_tpu_torch`` keeps its own copies of ``core/*``,
``parallel/partition.py`` and ``utils/statistics.py``; these tests hold each
copy to the original over a sweep of radii, sizes and counts.
"""

import itertools
import math

import numpy as np
import pytest

from stencil_tpu.core import geometry as jgeo
from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.direction_map import DIRECTIONS_26 as J_DIRS
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.parallel import partition as jpart
from stencil_tpu.utils.config import MethodFlags as JMethodFlags
from stencil_tpu.utils.statistics import Statistics as JStatistics
from stencil_tpu_torch.core import geometry as tgeo
from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.direction_map import DIRECTIONS_26, DirectionMap
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.parallel import partition as tpart
from stencil_tpu_torch.utils.config import MethodFlags
from stencil_tpu_torch.utils.statistics import Statistics

SIZES = [(16, 16, 16), (17, 18, 19), (64, 32, 8), (5, 40, 3), (512, 512, 512)]


def _radii():
    """(port, jax) radius pairs: constants, face/edge/corner and an uneven
    per-direction table."""
    out = []
    for r in (0, 1, 2):
        out.append((Radius.constant(r), JRadius.constant(r)))
    out.append((Radius.face_edge_corner(2, 1, 1), JRadius.face_edge_corner(2, 1, 1)))
    faces = {(1, 0, 0): 2, (-1, 0, 0): 1, (0, 1, 0): 1, (0, -1, 0): 3, (0, 0, 1): 0, (0, 0, -1): 1}
    out.append((Radius.from_dict(faces), JRadius.from_dict(faces)))
    t, j = Radius.constant(0), JRadius.constant(0)
    t.set_face(1)
    j.set_face(1)
    out.append((t, j))
    return out


def _t(d):
    return tuple(d)


def test_directions_and_dim3_match():
    assert [_t(d) for d in DIRECTIONS_26] == [_t(d) for d in J_DIRS]
    a, b = Dim3(3, -4, 7), Dim3(2, 5, -1)
    ja, jb = JDim3(3, -4, 7), JDim3(2, 5, -1)
    for op in ("__add__", "__sub__", "__mul__", "__floordiv__", "__mod__"):
        assert _t(getattr(a, op)(Dim3(2, 3, 5))) == _t(getattr(ja, op)(JDim3(2, 3, 5)))
    assert _t(a.wrap(Dim3(4, 4, 4))) == _t(ja.wrap(JDim3(4, 4, 4)))
    assert (a < b) == (ja < jb) and a.flatten() == ja.flatten()
    assert [Dim3.next_power_of_two(v) for v in range(-2, 70)] == [
        JDim3.next_power_of_two(v) for v in range(-2, 70)
    ]
    assert list(Rect3(Dim3(0, 1, 2), Dim3(2, 3, 4)).points()) == [
        Dim3(*p) for p in ((x, y, z) for z in (2, 3) for y in (1, 2) for x in (0, 1))
    ]
    m = DirectionMap(0)
    m[Dim3(1, -1, 0)] = 5
    assert m.at_dir(1, -1, 0) == 5 and m.copy() == m


@pytest.mark.parametrize("case", range(6))
def test_radius_and_localspec_match(case):
    r, jr = _radii()[case]
    for d in DIRECTIONS_26:
        assert r.dir(d) == jr.dir(JDim3(*d))
    assert _t(r.lo()) == _t(jr.lo()) and _t(r.hi()) == _t(jr.hi())
    assert r.max_radius() == jr.max_radius()
    for ax, s in itertools.product(range(3), (-1, 1)):
        assert r.axis(ax, s) == jr.axis(ax, s)
    assert [r.scaled(3).dir(d) for d in DIRECTIONS_26] == [jr.scaled(3).dir(JDim3(*d)) for d in J_DIRS]
    for sz, origin in [((8, 9, 10), (0, 0, 0)), ((16, 4, 7), (16, 8, 21))]:
        spec = tgeo.LocalSpec.make(sz, origin, r)
        jspec = jgeo.LocalSpec.make(sz, origin, jr)
        assert _t(spec.raw_size()) == _t(jspec.raw_size())
        for d in DIRECTIONS_26:
            jd = JDim3(*d)
            for halo in (True, False):
                assert _t(spec.halo_pos(d, halo)) == _t(jspec.halo_pos(jd, halo))
                hc, jhc = spec.halo_coords(d, halo), jspec.halo_coords(jd, halo)
                assert (_t(hc.lo), _t(hc.hi)) == (_t(jhc.lo), _t(jhc.hi))
            assert _t(spec.halo_extent(d)) == _t(jspec.halo_extent(jd))
            # the -dir convention: the receiver's halo width rules the size
            assert _t(tgeo.halo_extent(-d, spec.sz, r)) == _t(jgeo.halo_extent(-jd, jspec.sz, jr))
            assert spec.halo_bytes(d, 4) == jspec.halo_bytes(jd, 4)
        ir, jir = spec.interior(), jspec.interior()
        assert (_t(ir.lo), _t(ir.hi)) == (_t(jir.lo), _t(jir.hi))
        assert [(_t(e.lo), _t(e.hi)) for e in spec.exterior()] == [
            (_t(e.lo), _t(e.hi)) for e in jspec.exterior()
        ]
        assert spec.interior_slices() == jspec.interior_slices()


def test_ripple_field_matches():
    lo, ext = Dim3(3, 5, 7), Dim3(6, 4, 9)
    np.testing.assert_array_equal(
        tgeo.ripple_field(lo, ext), jgeo.ripple_field(JDim3(3, 5, 7), JDim3(6, 4, 9))
    )
    assert tgeo.ripple_value(Dim3(5, 6, 7)) == jgeo.ripple_value(JDim3(5, 6, 7))


@pytest.mark.parametrize("size", SIZES)
def test_partitions_match(size):
    assert all(tpart.prime_factors(n) == jpart.prime_factors(n) for n in range(0, 200))
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 27):
        p, jp_ = tpart.RankPartition(size, n), jpart.RankPartition(JDim3(*size), n)
        assert _t(p.dim()) == _t(jp_.dim()) and p.is_even() == jp_.is_even()
        for i in range(p.dim().flatten()):
            idx = p.dimensionize(i)
            assert _t(idx) == _t(jp_.dimensionize(i)) and p.linearize(idx) == i
            assert _t(p.subdomain_size(idx)) == _t(jp_.subdomain_size(JDim3(*idx)))
            assert _t(p.subdomain_origin(idx)) == _t(jp_.subdomain_origin(JDim3(*idx)))
        for (r, jr), (nodes, gpus) in itertools.product(_radii()[1:], ((1, n), (2, n))):
            q = tpart.NodePartition(size, r, nodes, gpus)
            jq = jpart.NodePartition(JDim3(*size), jr, nodes, gpus)
            assert _t(q.sys_dim()) == _t(jq.sys_dim()) and _t(q.node_dim()) == _t(jq.node_dim())
            last = q.dim() - 1
            assert _t(q.subdomain_size(last)) == _t(jq.subdomain_size(JDim3(*last)))
        m, jm = tpart.ManualPartition(size, (2, 1, 3)), jpart.ManualPartition(JDim3(*size), (2, 1, 3))
        assert _t(m.subdomain_origin((1, 0, 2))) == _t(jm.subdomain_origin(JDim3(1, 0, 2)))


def test_statistics_and_method_flags_match():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 5, 8, 33):
        s, js = Statistics(), JStatistics()
        for v in rng.random(n):
            s.insert(v)
            js.insert(v)
        for f in ("min", "max", "avg", "stddev", "med", "trimean"):
            a, b = getattr(s, f)(), getattr(js, f)()
            assert (math.isnan(a) and math.isnan(b)) or a == b, (f, n)
    assert [m.name for m in MethodFlags] == [m.name for m in JMethodFlags]
    assert MethodFlags.CudaKernel == MethodFlags.Ppermute == MethodFlags.All
