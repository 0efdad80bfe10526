"""The packed exchange routes of the port against the JAX package's.

* the four shell-pack kernels' plain versions against the Pallas kernels in
  interpret mode, on seeded blocks of a ragged shape, and the ``*_xla`` packs
  and ``*shell_to_slab`` against their JAX twins.  The port's z buffer is
  ``(d, Y, X)``, without the TPU's lane padding, so the JAX buffer's
  ``[:, :, :X]`` is what it equals;
* every route's exchange on 8 subdomains against the JAX domain's under the
  same route on the fake 8-device mesh (tests/conftest.py), raw shell-carrying
  arrays: several radii, uneven sizes, a halo multiplier, mixed dtypes;
* route resolution and the support gates against the JAX functions' answers;
* ``make_step`` and Astaroth's plane route under packed routes.

Every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.models.astaroth import AstarothSim as JAstaroth
from stencil_tpu.ops import exchange as jex
from stencil_tpu.ops import pack as jpk
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain, torch_dtype
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.ops import exchange as ex
from stencil_tpu_torch.ops import pack as pk

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

PACKED_ROUTES = [r for r in ex.EXCHANGE_ROUTES if r != "direct"]
SHAPE = (10, 12, 14)  # ragged: no extent a multiple of another

#: per shell axis: the port's (pack, unpack) and the JAX (pack, unpack)
KERNELS = {
    "z": (pk.pack_zshell_pallas_plain, pk.unpack_zshell_pallas_plain,
          jpk.pack_zshell_pallas, jpk.unpack_zshell_pallas),
    "y": (pk.pack_yshell_pallas_plain, pk.unpack_yshell_pallas_plain,
          jpk.pack_yshell_pallas, jpk.unpack_yshell_pallas),
}


def _seeded(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True).astype(dtype)


def _jax_buf(axis, buf):
    """The port's buffer as the JAX kernel takes it: X lane-padded on z."""
    if axis == "y":
        return buf
    d, Y, X = buf.shape
    out = np.zeros((d, Y, jpk.lane_pad(X)), buf.dtype)
    out[:, :, :X] = buf
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int8])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("axis", ["z", "y"])
def test_plain_packs_equal_pallas_interpret(axis, depth, dtype):
    pack, unpack, jpack, junpack = KERNELS[axis]
    dim = 2 if axis == "z" else 1
    X = SHAPE[0]
    block = _seeded(SHAPE, dtype, depth)
    for start in (1, SHAPE[dim] - depth):
        want = np.asarray(jpack(jnp.asarray(block), start, depth, interpret=True))
        got = pack(torch.from_numpy(block), start, depth).numpy()
        np.testing.assert_array_equal(got, want[:, :, :X] if axis == "z" else want)

        buf = _seeded(got.shape, dtype, 10 + start)
        want = np.asarray(junpack(jnp.asarray(block), jnp.asarray(_jax_buf(axis, buf)), start, depth,
                                  interpret=True))
        got = unpack(torch.from_numpy(block.copy()), torch.from_numpy(buf), start, depth).numpy()
        np.testing.assert_array_equal(got, want)
        # every cell outside the window is the block's own
        outside = np.ones(SHAPE, bool)
        outside[(slice(None),) * dim + (slice(start, start + depth),)] = False
        np.testing.assert_array_equal(got[outside], block[outside])


@pytest.mark.parametrize("axis", ["z", "y"])
def test_batched_wrappers_on_cpu_equal_per_block_plain(axis):
    """A stack of n blocks packs and unpacks as n single blocks; the
    wrapper on a CPU tensor runs the plain version and counts no launch."""
    pack, unpack, _, _ = KERNELS[axis]
    wrap, unwrap = {"z": (pk.pack_zshell_pallas, pk.unpack_zshell_pallas),
                    "y": (pk.pack_yshell_pallas, pk.unpack_yshell_pallas)}[axis]
    blocks = torch.from_numpy(_seeded((3,) + SHAPE, np.float32, 3))
    before = (wrap.launches, unwrap.launches)
    buf = wrap(blocks, 2, 3)
    assert tuple(buf.shape) == (pk.zshell_buffer_shape if axis == "z" else pk.yshell_buffer_shape)(
        tuple(blocks.shape), 3)
    for b in range(3):
        assert torch.equal(buf[b], pack(blocks[b], 2, 3))
    new = torch.from_numpy(_seeded(tuple(buf.shape), np.float32, 4))
    got = unwrap(blocks.clone(), new, 5, 3)
    for b in range(3):
        assert torch.equal(got[b], unpack(blocks[b].clone(), new[b], 5, 3))
    assert (wrap.launches, unwrap.launches) == before
    with pytest.raises(ValueError, match="does not fit"):
        wrap(blocks, SHAPE[2 if axis == "z" else 1] - 2, 3)
    with pytest.raises(ValueError, match="buf shape"):
        unwrap(blocks.clone(), new[:, :2].contiguous(), 5, 3)


@pytest.mark.parametrize("axis", ["z", "y"])
def test_xla_packs_and_to_slab_equal_jax(axis):
    block = _seeded(SHAPE, np.float32, 7)
    X = SHAPE[0]
    if axis == "z":
        want = np.asarray(jpk.pack_zshell_xla(jnp.asarray(block), 11, 3))
        got = pk.pack_zshell_xla(torch.from_numpy(block), 11, 3).numpy()
        np.testing.assert_array_equal(got, want[:, :, :X])
        slab = np.asarray(jpk.zshell_to_slab(jnp.asarray(want), X))
        np.testing.assert_array_equal(pk.zshell_to_slab(torch.from_numpy(got)).numpy(), slab)
        assert slab.shape == (X, SHAPE[1], 3)
    else:
        want = np.asarray(jpk.pack_yshell_xla(jnp.asarray(block), 8, 3))
        got = pk.pack_yshell_xla(torch.from_numpy(block), 8, 3).numpy()
        np.testing.assert_array_equal(got, want)
        slab = np.asarray(jpk.yshell_to_slab(jnp.asarray(want)))
        np.testing.assert_array_equal(pk.yshell_to_slab(torch.from_numpy(got)).numpy(), slab)
        assert slab.shape == (X, 3, SHAPE[2])
    assert pk.zshell_buffer_shape(SHAPE, 3)[:2] == jpk.zshell_buffer_shape(SHAPE, 3)[:2]
    assert pk.yshell_buffer_shape(SHAPE, 3) == jpk.yshell_buffer_shape(SHAPE, 3)


# --- every route's exchange against the JAX domain's ---------------------------------

_UNEVEN_R = {(1, 0, 0): 2, (-1, 0, 0): 1, (0, 1, 0): 1, (0, -1, 0): 3, (0, 0, 1): 0, (0, 0, -1): 2}

#: (size, radius, halo multiplier, dtypes)
CASES = {
    "faces1": ((16, 16, 16), lambda R: R.constant(0).set_face(1), 1, (np.float32,)),
    "uneven_radius": ((16, 16, 16), lambda R: R.from_dict(_UNEVEN_R), 1, (np.float32,)),
    "fec211": ((16, 16, 16), lambda R: R.face_edge_corner(2, 1, 1), 1, (np.float32,)),
    "uneven_xy": ((17, 15, 16), lambda R: R.constant(1), 1, (np.float32,)),
    "uneven_z": ((16, 16, 17), lambda R: R.constant(1), 1, (np.float32,)),
    "mult2": ((16, 16, 16), lambda R: R.constant(1), 2, (np.float32,)),
    "mixed": ((16, 16, 16), lambda R: R.constant(1), 1, (np.float32, np.float64, np.int8, np.bool_)),
}


def _field(size, dtype, i):
    x, y, z = np.meshgrid(*(np.arange(n) for n in size), indexing="ij")
    if dtype == np.bool_:
        return (x + 2 * y + 3 * z + i) % 2 == 0
    return (x * 37 + y * 5 + z + i * 1000).astype(dtype)


def _jax_domain(route, size, radius, mult, dtypes):
    j = JDomain(*size)
    j.set_radius(radius(JRadius))
    j.set_exchange_route(route)
    if mult > 1:
        j.set_halo_multiplier(mult)
    hs = [j.add_data(f"q{i}", dtype=dt) for i, dt in enumerate(dtypes)]
    j.realize()
    for i, h in enumerate(hs):
        j.set_quantity(h, _field(size, dtypes[i], i))
    return j, hs


def _port_domain(route, size, radius, mult, dtypes):
    t = DistributedDomain(*size, device="cpu")
    t.set_radius(radius(Radius))
    t.set_subdomains(8)
    t.set_exchange_route(route)
    if mult > 1:
        t.set_halo_multiplier(mult)
    hs = [t.add_data(f"q{i}", dtype=dt) for i, dt in enumerate(dtypes)]
    t.realize()
    for i, h in enumerate(hs):
        t.set_quantity(h, _field(size, dtypes[i], i))
    return t, hs


@pytest.mark.filterwarnings("ignore:exchange route")
@pytest.mark.parametrize("route", ex.EXCHANGE_ROUTES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_route_exchange_bitwise_vs_jax(case, route):
    j, jh = _jax_domain(route, *CASES[case])
    t, th = _port_domain(route, *CASES[case])
    assert t.exchange_route() == j.exchange_route()
    assert tuple(t.grid_dim()) == tuple(j.placement.dim())
    j.exchange()
    t.exchange()
    for a, b in zip(jh, th):
        want, got = j.raw_to_host(a), t.raw_to_host(b)
        np.testing.assert_array_equal(got, want)
    # the shell really was filled
    assert (t.raw_to_host(th[0]) != 0).mean() > 0.9


#: per route, the calls one exchange of one quantity makes: packs (and
#: unpacks) of the z and y shells, and blend_slab writes, at an even size and
#: at (17,15,16), where x and y are padded (each writes its high halo with
#: blend_slab_dynamic) and only the z sweep packs
ENGAGED = {
    "direct": (dict(z=0, y=0, blend=6), dict(z=0, y=0, blend=4)),
    "zpack_xla": (dict(z=2, y=0, blend=6), dict(z=2, y=0, blend=4)),
    "zpack_pallas": (dict(z=4, y=0, blend=4), dict(z=4, y=0, blend=2)),
    "yzpack_xla": (dict(z=2, y=2, blend=6), dict(z=2, y=0, blend=4)),
    "yzpack_pallas": (dict(z=4, y=4, blend=2), dict(z=4, y=0, blend=2)),
}


@pytest.mark.parametrize("route", ex.EXCHANGE_ROUTES)
def test_packed_sweeps_engage_per_axis(monkeypatch, route):
    """Which functions each route's exchange calls; a padded axis runs its
    sweep direct."""
    calls = {}

    def spy(fn, key):
        def run(*a):
            calls[key] += 1
            return fn(*a)
        return run

    # the plain versions the pallas wrappers run here call pack_*shell_xla
    kinds = ("pack_{}shell_pallas", "unpack_{}shell_pallas") if route.endswith("pallas") else ("pack_{}shell_xla",)
    for axis in ("z", "y"):
        for kind in kinds:
            name = kind.format(axis)
            monkeypatch.setattr(pk, name, spy(getattr(pk, name), axis))
    monkeypatch.setattr(ex, "blend_slab", spy(ex.blend_slab, "blend"))
    for size, want in zip(((16, 16, 16), (17, 15, 16)), ENGAGED[route]):
        calls.update(z=0, y=0, blend=0)
        t, _ = _port_domain(route, size, lambda R: R.constant(1), 1, (np.float32,))
        t.exchange()
        assert calls == want, (size, calls)


# --- route resolution ------------------------------------------------------------


def test_route_resolution_matches_jax():
    def port(x, y, z):
        d = DistributedDomain(x, y, z, device="cpu")
        d.set_subdomains(8)
        d.set_radius(Radius.constant(1))
        return d

    def jax_domain(x, y, z):
        d = JDomain(x, y, z)
        d.set_radius(JRadius.constant(1))
        return d

    def resolve(make, route, size=(16, 16, 16)):
        d = make(*size)
        d.set_exchange_route(route)
        d.add_data("q")
        d.realize()
        return d.exchange_route()

    for route in ex.EXCHANGE_ROUTES + ("auto", None):
        want = resolve(jax_domain, route)
        assert resolve(port, route) == want == (route if route in ex.EXCHANGE_ROUTES else "direct")
    for route in ("yzpack_xla", "yzpack_pallas", "zpack_pallas"):
        # y and z both padded: no packed sweep can engage
        want = resolve(jax_domain, route, (16, 17, 17))
        with pytest.warns(RuntimeWarning, match="degrading to 'direct'"):
            assert resolve(port, route, (16, 17, 17)) == want == "direct"
    for make in (jax_domain, port):
        with pytest.raises(ValueError, match="unknown exchange route"):
            make(16, 16, 16).set_exchange_route("bogus")
    with pytest.raises(ValueError, match="unknown exchange route"):
        ex.halo_exchange_shard(torch.zeros(1, 1, 1, 3, 3, 3), Radius.constant(1), route="zpack")
    dd = port(16, 16, 16)
    dd.add_data("q")
    dd.realize()
    with pytest.raises(AssertionError, match="precede realize"):
        dd.set_exchange_route("zpack_xla")


def test_support_gates_match_jax():
    """``zpack_supported``, ``ypack_supported`` and ``route_supported`` give
    the JAX functions' answers on every route, padding and dtype set."""
    dtype_sets = [(np.float32,), (np.float32, np.int8), (np.float64, np.bool_, np.int16), (np.complex128,)]
    valid_lasts = [None, (None, None, None), (7, None, None), (None, 7, None), (None, None, 7), (None, 7, 7)]
    for dts in dtype_sets:
        tdts = [torch_dtype(d) for d in dts]
        jdts = [jnp.dtype(d) for d in dts]
        for vl in valid_lasts:
            assert ex.zpack_supported(tdts, vl) == jex.zpack_supported(jdts, vl)
            assert ex.ypack_supported(tdts, vl) == jex.ypack_supported(jdts, vl)
            for route in ex.EXCHANGE_ROUTES:
                assert ex.route_supported(route, tdts, vl) == jex.route_supported(route, jdts, vl), (route, dts, vl)
    assert ex.Z_PACK_ROUTES == jex.Z_PACK_ROUTES and ex.Y_PACK_ROUTES == jex.Y_PACK_ROUTES
    assert ex.EXCHANGE_ROUTES == jex.EXCHANGE_ROUTES


# --- make_step and Astaroth under packed routes ----------------------------------------


def _mean6(views, info):
    out = {}
    for name, src in views.items():
        out[name] = (src.sh(-1, 0, 0) + src.sh(1, 0, 0) + src.sh(0, -1, 0) + src.sh(0, 1, 0)
                     + src.sh(0, 0, -1) + src.sh(0, 0, 1)) / 6.0
    return out


def test_make_step_zpack_pallas_bitwise_vs_jax():
    field = _field((16, 16, 16), np.float32, 0) / np.float32(1000)
    j, jh = _jax_domain("zpack_pallas", (16, 16, 16), lambda R: R.constant(1), 1, (np.float32,))
    t, th = _port_domain("zpack_pallas", (16, 16, 16), lambda R: R.constant(1), 1, (np.float32,))
    j.set_quantity(jh[0], field)
    t.set_quantity(th[0], field)
    j.run_step(j.make_step(_mean6), 3)
    t.run_step(t.make_step(_mean6), 3)
    np.testing.assert_array_equal(t.quantity_to_host(th[0]), j.quantity_to_host(jh[0]))


N = 16


@pytest.mark.parametrize("route", PACKED_ROUTES)
def test_astaroth_per_step_packed_route_bitwise(route):
    """The plane route (one exchange an iteration) under a packed route:
    bitwise equal to the JAX plane route under the same route and to the
    port's ``direct``."""
    j = JAstaroth(N, N, N, num_quantities=2, kernel_impl="pallas", interpret=True, schedule="per-step",
                  exchange_route=route)
    j.realize()
    runs = [AstarothSim(N, N, N, num_quantities=2, subdomains=8, kernel_impl="cuda", schedule="per-step",
                        exchange_route=r, device="cpu") for r in (route, "direct")]
    start = [np.asarray(j.dd.raw_to_host(h)) for h in j.handles]
    for m in runs:
        m.realize()
        m.load_state(start)
        m.step(4)
    j.step(4)
    assert runs[0].dd.exchange_route() == j.dd.exchange_route() == route
    for i in range(2):
        want = np.asarray(j.field(i))
        np.testing.assert_array_equal(runs[0].field(i), want)
        np.testing.assert_array_equal(runs[1].field(i), want)


@pytest.mark.parametrize("z_slabs", [False, True])
def test_stream_wavefront_forms_and_the_route(monkeypatch, z_slabs):
    """The plain wavefront form exchanges through the domain's route; the
    z-slab form's x/y exchange stays direct (stencil_tpu/ops/stream.py:1821).
    Both stay bitwise equal to the form under ``direct``."""
    calls = []
    for name in ("pack_zshell_pallas", "pack_yshell_pallas"):
        fn = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    fields = []
    for route in ("yzpack_pallas", "direct"):
        m = AstarothSim(12, 12, 12, num_quantities=2, subdomains=8, kernel_impl="cuda", exchange_route=route,
                        device="cpu")
        m.realize()
        m._step = m.dd.make_step(m._kernel, engine="stream", x_radius=1, separable=True, stream_z_slabs=z_slabs)
        assert m._step._stream_plan["route"] == "wavefront" and m._step._stream_plan["z_slabs"] == z_slabs
        m.step(4)
        fields.append([m.field(i) for i in range(2)])
    # 2 fields, one exchange per macro (4 = a macro of 3 and one of 1), 2 directions a sweep
    assert sorted(set(calls)) == ([] if z_slabs else ["pack_yshell_pallas", "pack_zshell_pallas"])
    assert len(calls) == (0 if z_slabs else 2 * 2 * 2 * 2)
    for got, want in zip(*fields):
        np.testing.assert_array_equal(got, want)


def test_drivers_take_exchange_route(capsys):
    from stencil_tpu_torch.bin import astaroth_sim, jacobi3d

    rc = astaroth_sim.main(["--x", "12", "--y", "12", "--z", "12", "--iters", "1", "--quantities", "2",
                            "--device", "cpu", "--partition", "2,2,2", "--schedule", "per-step",
                            "--exchange-route", "yzpack_pallas"])
    assert rc == 0 and capsys.readouterr().out.strip().split(",")[0] == "astaroth"
    rc = jacobi3d.main(["8", "8", "8", "--iters", "1", "--device", "cpu", "--partition", "2,2,2",
                        "--kernel-impl", "torch", "--exchange-route", "zpack_xla"])
    assert rc == 0 and capsys.readouterr().out.strip().split(",")[0] == "jacobi3d"
    with pytest.raises(SystemExit):
        jacobi3d.main(["8", "8", "8", "--exchange-route", "zpack"])
