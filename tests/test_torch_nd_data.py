"""Component (N-D) quantities in the port against the JAX package.

The cases of ``tests/test_nd_data.py`` on the port (``device="cpu"``, 8
subdomains of one device) held against the JAX domain on the fake 8-device
mesh (tests/conftest.py): a ``(*components, X, Y, Z)`` quantity round-trips,
every exchange route fills each component's shell as the JAX exchange does,
vector and scalar quantities mix in one exchange, the torch engine steps a
vector as the JAX ``xla`` engine does, regions read back, uneven sizes
round-trip and exchange.  The fields are seeded and asymmetric (a wrong axis
shows), and the grids differ per axis (2x1x4 beside 2x2x2).  Every comparison
is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.dim3 import Rect3 as JRect3
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DataHandle, DistributedDomain
from stencil_tpu_torch.ops import exchange as ex
from stencil_tpu_torch.ops.captured import Loop
from stencil_tpu_torch.ops.stream_trace import StreamKernel

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

ROUTES = ex.EXCHANGE_ROUTES
GRIDS = [(2, 2, 2), (2, 1, 4)]


def _ripple(c, x, y, z):
    return c * 1e6 + x * 10000.0 + y * 100.0 + z


def _ripple_field(components, size):
    field = np.zeros(components + size, np.float32)
    xs, ys, zs = np.meshgrid(*[np.arange(s) for s in size], indexing="ij")
    for c in np.ndindex(*components):
        field[c] = _ripple(c[0] if c else 0, xs, ys, zs)
    return field


def _seeded(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _pair(size, radius, quantities, grid=None, route=None, mult=1):
    """A JAX domain and a port domain of one configuration; ``quantities``
    lists ``(name, components)``; ``radius(R)`` builds the radius."""
    out = []
    for Domain, R, kw in ((JDomain, JRadius, {}), (DistributedDomain, Radius, {"device": "cpu"})):
        d = Domain(*size, **kw)
        d.set_radius(radius(R))
        if Domain is DistributedDomain:
            d.set_subdomains(8)
        if grid is not None:
            d.set_partition(*grid)
        if route is not None:
            d.set_exchange_route(route)
        if mult > 1:
            d.set_halo_multiplier(mult)
        hs = [d.add_data(n, components=c) for n, c in quantities]
        d.realize()
        out.append((d, hs))
    (j, jh), (t, th) = out
    assert tuple(t.grid_dim()) == tuple(j.placement.dim())
    return j, jh, t, th


def _load(j, jh, t, th, fields):
    for a, b, f in zip(jh, th, fields):
        j.set_quantity(a, f)
        t.set_quantity(b, f)


def _fec(r):
    return lambda R: R.face_edge_corner(r, r, r)


# --- the handle and the storage ---------------------------------------------------


def test_handle_cell_count_and_stack_shape():
    j, jh, t, th = _pair((16, 16, 16), _fec(1), [("v", (3,)), ("m", (2, 3)), ("s", ())])
    for a, b in zip(jh, th):
        assert b.components == a.components and b.cell_count() == a.cell_count()
    assert DataHandle("s", torch.float32).cell_count() == 1
    raw = tuple(t.local_spec().raw_size())
    for b in th:
        assert tuple(t.get_curr(b).shape) == b.components + (2, 2, 2) + raw
    with pytest.raises(ValueError, match="positive"):
        DistributedDomain(8, 8, 8, device="cpu").add_data("bad", components=(0,))


@pytest.mark.parametrize("grid", GRIDS)
def test_nd_roundtrip(grid):
    j, jh, t, th = _pair((16, 16, 16), _fec(2), [("v", (3,))], grid)
    field = _ripple_field((3,), (16, 16, 16))
    _load(j, jh, t, th, [field])
    np.testing.assert_array_equal(t.quantity_to_host(th[0]), field)
    np.testing.assert_array_equal(t.raw_to_host(th[0]), j.raw_to_host(jh[0]))
    # set_raw takes back what raw_to_host gives
    other = DistributedDomain(16, 16, 16, device="cpu")
    other.set_radius(Radius.face_edge_corner(2, 2, 2))
    other.set_partition(*grid)
    oh = other.add_data("v", components=(3,))
    other.realize()
    other.set_raw(oh, j.raw_to_host(jh[0]))
    assert torch.equal(other.get_curr(oh), t.get_curr(th[0]))


# --- the exchange -------------------------------------------------------------------


@pytest.mark.filterwarnings("ignore:exchange route")
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("route", ROUTES)
def test_nd_exchange_fills_shell_per_component(route, grid):
    """Every raw cell of every component holds the periodic-wrapped ripple
    value, and equals the JAX domain's exchange under the same route."""
    size = (16, 16, 16)
    j, jh, t, th = _pair(size, _fec(2), [("v", (3,))], grid, route)
    _load(j, jh, t, th, [_ripple_field((3,), size)])
    j.exchange()
    t.exchange()
    raw = t.raw_to_host(th[0])
    np.testing.assert_array_equal(raw, j.raw_to_host(jh[0]))
    dim, rawsz, lo, n = t.grid_dim(), t.local_spec().raw_size(), t.shell_radius().lo(), t.subdomain_size()
    g = [((np.arange(dim[a] * rawsz[a]) // rawsz[a]) * n[a] + np.arange(dim[a] * rawsz[a]) % rawsz[a] - lo[a])
         % size[a] for a in range(3)]
    gx, gy, gz = np.meshgrid(*g, indexing="ij")
    for c in range(3):
        np.testing.assert_array_equal(raw[c], _ripple(c, gx, gy, gz).astype(np.float32))


#: (size, grid): even, and uneven on x and y (the +axis halos through
#: blend_slab_dynamic, one offset per block per component)
MIXED = {"even": ((16, 16, 16), (2, 1, 4)), "uneven": ((15, 13, 16), (2, 2, 2))}


@pytest.mark.filterwarnings("ignore:exchange route")
@pytest.mark.parametrize("case", sorted(MIXED))
@pytest.mark.parametrize("route", ROUTES)
def test_nd_mixed_with_scalar(route, case):
    """A vector and a scalar in one exchange: each equals the JAX domain's,
    and each component equals a scalar domain exchanged alone."""
    size, grid = MIXED[case]
    j, jh, t, th = _pair(size, lambda R: R.face_edge_corner(2, 1, 1), [("v", (3,)), ("s", ())], grid, route)
    vec, sca = _seeded((3,) + size, 1), _seeded(size, 2)
    _load(j, jh, t, th, [vec, sca])
    j.exchange()
    t.exchange()
    assert t.exchange_route() == j.exchange_route()
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(t.raw_to_host(b), j.raw_to_host(a))
    raw = t.raw_to_host(th[0])
    for c in range(3):
        one = DistributedDomain(*size, device="cpu")
        one.set_radius(Radius.face_edge_corner(2, 1, 1))
        one.set_partition(*grid)
        one.set_exchange_route(route)
        q = one.add_data("q")
        one.realize()
        one.set_quantity(q, vec[c])
        one.exchange()
        np.testing.assert_array_equal(one.raw_to_host(q), raw[c])


@pytest.mark.filterwarnings("ignore:exchange route")
@pytest.mark.parametrize("route", ["direct", "yzpack_pallas"])
def test_nd_exchange_many_and_capture_replay_bitwise(route):
    """``exchange_many`` on a mixed domain equals repeated ``exchange()``
    (the captured loop's stand-in replays on the CPU), and a stack-carried
    loop's spare set takes each vector stack's shape."""
    size = (15, 16, 16)
    doms = []
    for _ in range(2):
        d = DistributedDomain(*size, device="cpu")
        d.set_radius(Radius.face_edge_corner(1, 1, 1))
        d.set_partition(2, 1, 4)
        d.set_exchange_route(route)
        hs = [d.add_data("v", components=(3,)), d.add_data("s")]
        d.realize()
        d.set_quantity(hs[0], _seeded((3,) + size, 3))
        d.set_quantity(hs[1], _seeded(size, 4))
        doms.append((d, hs))
    (a, ah), (b, bh) = doms
    for _ in range(3):
        a.exchange()
    b.exchange_many(3)
    b.exchange_many(2)
    for x, y in zip(ah, bh):
        assert torch.equal(a.get_curr(x), b.get_curr(y))
    assert len(b._exchange_loop.graphs) > 0 and b._exchange_loop.replays > 0

    shapes = {}

    def body(cur, nxt, depth):
        for src, dst in zip(cur.fields, nxt.fields):
            shapes.setdefault("spare", []).append(tuple(dst.shape))
            dst.copy_(src)

    loop = Loop(["v", "s"], 1, body)
    out = loop.run({"v": a.get_curr(ah[0]), "s": a.get_curr(ah[1])}, 2, capture=True)
    assert shapes["spare"][:2] == [tuple(a.get_curr(ah[0]).shape), tuple(a.get_curr(ah[1]).shape)]
    assert torch.equal(out["v"], a.get_curr(ah[0])) and torch.equal(out["s"], a.get_curr(ah[1]))


@pytest.mark.filterwarnings("ignore:exchange route")
@pytest.mark.parametrize("route", ROUTES)
def test_nd_uneven_roundtrip_and_exchange(route):
    """Padded axes with a component dim: the interior survives, and the
    exchange equals JAX's (the packed sweeps on padded axes degrade)."""
    size = (15, 13, 16)
    j, jh, t, th = _pair(size, lambda R: R.constant(1), [("v", (2,))], route=route)
    field = _seeded((2,) + size, 2)
    _load(j, jh, t, th, [field])
    j.exchange()
    t.exchange()
    np.testing.assert_array_equal(t.quantity_to_host(th[0]), field)
    np.testing.assert_array_equal(t.raw_to_host(th[0]), j.raw_to_host(jh[0]))


# --- readback -------------------------------------------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
def test_nd_region_readback(grid):
    j, jh, t, th = _pair((16, 16, 16), _fec(2), [("v", (3,))], grid)
    field = _ripple_field((3,), (16, 16, 16))
    _load(j, jh, t, th, [field])
    got = t.region_to_host(th[0], Rect3(Dim3(3, 1, 5), Dim3(9, 14, 12)))
    np.testing.assert_array_equal(got, field[:, 3:9, 1:14, 5:12])
    np.testing.assert_array_equal(got, j.region_to_host(jh[0], JRect3(JDim3(3, 1, 5), JDim3(9, 14, 12))))


# --- the torch engine -------------------------------------------------------------------


def _mean6(views, info):
    src = views["v"]
    val = (
        src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0)
        + src.sh(0, -1, 0) + src.sh(0, 0, 1) + src.sh(0, 0, -1)
    ) / 6.0
    return {"v": val.astype(src.center().dtype)}


def _stack(vals):
    """``torch.stack`` on the port's traced values, ``jnp.stack`` on JAX's."""
    return jnp.stack(vals) if isinstance(vals[0], jnp.ndarray) else torch.stack(vals, dim=0)


def _curl(views, info):
    """A curl-like kernel: each component from shifts of the other two, and
    the scalar ``s`` from all three."""
    v = views["v"]
    w0 = v.sh(0, 1, 0)[2] - v.sh(0, -1, 0)[2] - v.sh(0, 0, 1)[1] + v.sh(0, 0, -1)[1]
    w1 = v.sh(0, 0, 1)[0] - v.sh(0, 0, -1)[0] - v.sh(1, 0, 0)[2] + v.sh(-1, 0, 0)[2]
    w2 = v.sh(1, 0, 0)[1] - v.sh(-1, 0, 0)[1] - v.sh(0, 1, 0)[0] + v.sh(0, -1, 0)[0]
    s = views["s"].center()
    return {"v": v.center() + 0.5 * _stack([w0, w1, w2]), "s": s + v.center()[0] * 0.25 - v.center()[-1]}


@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("overlap", [True, False])
def test_nd_make_step_matches_jax_and_per_component_scalar_runs(overlap, mult, capture):
    """A 3-component mean-of-6 step equals the JAX ``xla`` engine's and
    three independent scalar domains, bitwise."""
    size = (16, 16, 16)
    j, jh, t, th = _pair(size, lambda R: R.constant(1), [("v", (3,))], (2, 1, 4), mult=mult)
    field = _seeded((3,) + size, 1)
    _load(j, jh, t, th, [field])
    j.run_step(j.make_step(_mean6, overlap=overlap), 3)
    t.set_capture(capture)
    step = t.make_step(_mean6, overlap=overlap)
    t.run_step(step, 2)
    t.run_step(step, 1)
    got = t.quantity_to_host(th[0])
    np.testing.assert_array_equal(got, j.quantity_to_host(jh[0]))
    for c in range(3):
        sd = DistributedDomain(*size, device="cpu")
        sd.set_radius(1)
        sd.set_partition(2, 1, 4)
        if mult > 1:
            sd.set_halo_multiplier(mult)
        sh = sd.add_data("v")
        sd.realize()
        sd.set_quantity(sh, field[c])
        sd.run_step(sd.make_step(_mean6, overlap=overlap), 3)
        np.testing.assert_array_equal(got[c], sd.quantity_to_host(sh))


@pytest.mark.parametrize("overlap", [True, False])
def test_nd_component_mixing_kernel_vs_jax(overlap):
    """Indexing and ``torch.stack`` on the torch engine against ``jnp`` on
    the JAX ``xla`` engine, bitwise: the kernel's weights are powers of two,
    so no product is inexact and an FMA that XLA contracts rounds as the
    port's separate multiply and add do (``stream_trace``'s arithmetic
    contract).  Overlap and no overlap agree bitwise too."""
    size = (16, 16, 16)
    outs = []
    for ov in (overlap, not overlap):
        j, jh, t, th = _pair(size, lambda R: R.constant(1), [("v", (3,)), ("s", ())], (2, 1, 4))
        _load(j, jh, t, th, [_seeded((3,) + size, 5), _seeded(size, 6)])
        j.run_step(j.make_step(_curl, overlap=ov), 2)
        t.run_step(t.make_step(_curl, overlap=ov), 2)
        for a, b in zip(jh, th):
            np.testing.assert_array_equal(t.quantity_to_host(b), j.quantity_to_host(a))
        outs.append([t.quantity_to_host(b) for b in th])
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def test_stream_engine_refuses_components():
    t = DistributedDomain(16, 16, 16, device="cpu")
    t.set_radius(1)
    t.add_data("v", components=(3,))
    t.realize()
    with pytest.raises(ValueError, match="N-D component data"):
        t.make_step(_mean6, engine="stream")


def test_tracer_component_ops_and_refusals():
    """The torch engine's traces take ``[i]`` and ``torch.stack(..., dim=0)``;
    ``emit_cuda`` refuses both, naming the op; a stream kernel's trace
    refuses them at once; shapes are checked at trace time."""
    gs = (8, 8, 8)
    sk = StreamKernel(_curl, ["v", "s"], None, gs, components=[(3,), ()])
    assert sk.updates() == [True, True]
    with pytest.raises(TypeError, match="'index'"):
        sk.cuda_body([1])

    def stacked(views, info):
        a = views["u"].center()
        return {"u": torch.stack([a, a * 2.0], dim=0)[1]}

    sk = StreamKernel(stacked, ["u"], None, gs, components=[()])
    with pytest.raises(TypeError, match="'stack'"):
        sk.cuda_body([1])
    with pytest.raises(TypeError, match="stream kernels"):
        StreamKernel(stacked, ["u"], 1, gs).trace()
    with pytest.raises(TypeError, match="stream kernels"):
        StreamKernel(_curl, ["v", "s"], 1, gs).trace()

    def bad(fn):
        return StreamKernel(fn, ["v", "s"], None, gs, components=[(3,), ()])

    with pytest.raises(TypeError, match="no component dims"):
        bad(lambda v, i: {"s": v["s"].center()[0]}).trace()
    with pytest.raises(IndexError):
        bad(lambda v, i: {"v": v["v"].center()[3]}).trace()
    with pytest.raises(TypeError, match="integer component index"):
        bad(lambda v, i: {"v": v["v"].center()[0:2]}).trace()
    with pytest.raises(TypeError, match="dim=0"):
        bad(lambda v, i: {"v": torch.stack([v["s"].center()] * 3, dim=1)}).trace()
    with pytest.raises(ValueError, match="do not broadcast"):
        bad(lambda v, i: {"s": v["v"].center()}).trace()
    with pytest.raises(ValueError, match="do not broadcast"):
        bad(lambda v, i: {"v": v["v"].center() + torch.stack([v["s"].center()] * 2)}).trace()
    # a scalar value broadcasts over a vector's components, as in JAX
    bad(lambda v, i: {"v": v["s"].center() * 2.0}).trace()
