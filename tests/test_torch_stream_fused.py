"""The port's fused halo (``halo="fused"``) against the JAX package's and
against its own array form, on the CPU.

* ``fused_shell_exchange`` (``ops/exchange.py``) against the JAX function on
  its fake 8-device mesh (``yzpack_xla``, and ``yzpack_pallas`` with the
  packs in interpret mode), its three buffers permuted to the JAX layouts:
  bitwise; and every buffer cell against the stacks after
  ``halo_exchange_multi`` on the same route: bitwise;
* the fused plane and wavefront passes' plain versions (``fused_shell=``)
  against the JAX passes in interpret mode on the same seeded inputs:
  bitwise for the plane pass, ``TOL`` for the wavefront at depth >= 2 (the
  JAX interpret passes contract a level's multiply into the next level's
  adds; ROADMAP.md queue 3);
* ``make_step(engine="stream", stream_halo="fused")`` against
  ``stream_halo="array"`` in the port: the raw blocks bitwise, shell
  included, on the plane route (read radius 1 and 2, a wide shell) and the
  plain wavefront (two macros and a remainder); against the JAX package's
  fused step: bitwise on the plane route, ``TOL`` on the wavefront;
* every degradation of ``tests/test_stream_fused.py:193-254``, with its
  warning and the plan it resolves to;
* the fused forms' launch path on tensors that report a CUDA device, with
  stand-in C entries (argument order, the raw stream, refusals).

``TOL`` is rtol = atol = 1e-6 (``tests/test_stream_fused.py:34``).
"""

import ctypes
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from stencil_tpu.core.dim3 import Dim3 as JDim3
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.ops import exchange as jex
from stencil_tpu.ops import stream as jst
from stencil_tpu.parallel.mesh import MESH_AXES
from stencil_tpu.utils.compat import shard_map
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.kernels import build, ledger
from stencil_tpu_torch.ops import exchange as tex
from stencil_tpu_torch.ops import stream as st

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def mean6(views, info):
    return {n: (s.sh(-1, 0, 0) + s.sh(0, -1, 0) + s.sh(0, 0, -1) + s.sh(1, 0, 0) + s.sh(0, 1, 0)
                + s.sh(0, 0, 1)) / 6.0 for n, s in views.items()}


def r2_kernel(views, info):
    """Reads at distance 2 on every axis."""
    s = views["q0"]
    return {"q0": (s.sh(-2, 0, 0) + s.sh(2, 0, 1) + s.sh(0, -2, 1) + s.sh(1, 2, 0) + s.sh(0, 0, -2)
                   + s.sh(-1, 0, 2)) / 6.0}


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _tmk(size=(16, 16, 16), radius=1, mult=1, route="yzpack_xla", nf=2, subdomains=8, seed=3):
    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(Radius.constant(radius))
    dd.set_subdomains(subdomains)
    if mult > 1:
        dd.set_halo_multiplier(mult)
    if route is not None:
        dd.set_exchange_route(route)
    hs = [dd.add_data(f"q{i}") for i in range(nf)]
    dd.realize()
    for i, h in enumerate(hs):
        dd.set_quantity(h, _rand(size, seed + i))
    return dd, hs


def _jmk(size=(16, 16, 16), radius=1, mult=1, route="yzpack_xla", nf=2, subdomains=8, seed=3):
    dd = JDomain(*size)
    dd.set_radius(JRadius.constant(radius))
    dd.set_devices(jax.devices()[:subdomains])
    if route is not None:
        dd.set_exchange_route(route)
    if mult > 1:
        dd.set_halo_multiplier(mult)
    hs = [dd.add_data(f"q{i}") for i in range(nf)]
    dd.realize()
    for i, h in enumerate(hs):
        dd.set_quantity(h, _rand(size, seed + i))
    return dd, hs


def _raw_pair(radius, mult, route, seed):
    """A port and a JAX domain over 2x2x2 holding the same seeded raw arrays,
    shells included (a stale shell the packs read)."""
    td, th = _tmk(radius=radius, mult=mult, route=route)
    jd, jh = _jmk(radius=radius, mult=mult, route=route)
    spec = NamedSharding(jd.mesh, P(*MESH_AXES))
    for i, (a, b) in enumerate(zip(th, jh)):
        raw = _rand(td.raw_to_host(a).shape, seed + i)
        td.set_raw(a, raw)
        jd._curr[b.name] = jax.device_put(jnp.asarray(raw), spec)
    return td, th, jd, jh


def _jax_fused(jd, jh, route):
    """The JAX ``fused_shell_exchange`` per shard, as (n, ...) numpy blocks
    in stack order: xbufs (n, 2s, Y, Z), ybufs (n, X, 2s, Z), zbufs (n, X,
    2s, Y)."""
    mesh_shape = tuple(jd.mesh.shape[a] for a in MESH_AXES)
    nf = len(jh)

    def per_shard(*blocks):
        xb, yb, zb = jex.fused_shell_exchange(blocks, jd._shell_radius, mesh_shape, route=route)
        return tuple(xb) + tuple(yb) + tuple(zb)

    spec = P(*MESH_AXES)
    fn = shard_map(per_shard, mesh=jd.mesh, in_specs=tuple(spec for _ in jh),
                   out_specs=tuple(spec for _ in range(3 * nf)), check_vma=False)
    outs = [np.asarray(o) for o in jax.jit(fn)(*[jd._curr[h.name] for h in jh])]
    grid = mesh_shape

    def blocks(a):
        g = a.reshape(grid[0], a.shape[0] // grid[0], grid[1], a.shape[1] // grid[1], grid[2], a.shape[2] // grid[2])
        return g.transpose(0, 2, 4, 1, 3, 5).reshape(-1, *g.shape[1::2])

    return [[blocks(o) for o in outs[k * nf:(k + 1) * nf]] for k in range(3)]


# --- fused_shell_exchange ---------------------------------------------------------


@pytest.mark.parametrize("radius,mult", [(1, 1), (1, 2), (2, 1)])
@pytest.mark.parametrize("route", ["yzpack_xla", "yzpack_pallas"])
def test_fused_shell_exchange_bitwise_vs_jax(route, radius, mult):
    td, th, jd, jh = _raw_pair(radius, mult, route, 70)
    xb, yb, zb = tex.fused_shell_exchange([td.get_curr(h) for h in th], td.shell_radius(), route)
    jx, jy, jz = _jax_fused(jd, jh, route)
    for q in range(len(th)):
        np.testing.assert_array_equal(xb[q].numpy(), jx[q])
        # the port's wire layouts: y (n, 2s, X, Z), z (n, 2s, Y, X)
        np.testing.assert_array_equal(yb[q].numpy(), jy[q].transpose(0, 2, 1, 3))
        np.testing.assert_array_equal(zb[q].numpy(), jz[q].transpose(0, 2, 3, 1))


@pytest.mark.parametrize("route", ["yzpack_xla", "yzpack_pallas"])
def test_fused_buffers_patch_the_exchanged_blocks(route):
    """The blocks with the buffers patched in, x planes, then y rows, then z
    columns (the passes' order), are the stacks after the in-array exchange
    of the same route, every cell; the fused exchange writes nothing into
    the stacks."""
    td, th = _tmk(radius=1, mult=3, route=route)
    stacks = [td.get_curr(h) for h in th]
    for s in stacks:
        s.add_(torch.from_numpy(_rand(tuple(s.shape), 9)))  # a stale, nonzero shell
    before = [s.clone() for s in stacks]
    xb, yb, zb = tex.fused_shell_exchange(stacks, td.shell_radius(), route)
    assert all(torch.equal(a, b) for a, b in zip(stacks, before))
    post = tex.halo_exchange_multi([s.clone() for s in stacks], td.shell_radius(), route=route)
    lo, hi = td.shell_radius().lo(), td.shell_radius().hi()
    for q, (s, p) in enumerate(zip(stacks, post)):
        patched = st._fused_level0(s.view(-1, *s.shape[3:]), xb[q], yb[q], zb[q], lo, hi)
        assert torch.equal(patched, p.view(-1, *p.shape[3:]))
        assert not torch.equal(s, p)  # the shell was stale


def test_fused_shell_exchange_refuses():
    td, th = _tmk()
    stacks = [td.get_curr(h) for h in th]
    for route in ("direct", "zpack_xla", "zpack_pallas"):
        with pytest.raises(ValueError, match="y\\+z packed route"):
            tex.fused_shell_exchange(stacks, td.shell_radius(), route)
    with pytest.raises(ValueError, match="every shell width > 0"):
        tex.fused_shell_exchange(stacks, Radius.constant(0), "yzpack_xla")
    with pytest.raises(ValueError, match="one shape"):
        tex.fused_shell_exchange([stacks[0], stacks[1][..., :-1]], td.shell_radius(), "yzpack_xla")


# --- the fused passes' plain versions against the JAX passes ----------------------


def _fused_inputs(n, X, Y, Z, lo, hi, nf, seed):
    """Port buffers ``(xbufs, ybufs, zbufs)`` per field and their JAX layouts."""
    xb = [_rand((n, lo.x + hi.x, Y, Z), seed + q) for q in range(nf)]
    yb = [_rand((n, lo.y + hi.y, X, Z), seed + 10 + q) for q in range(nf)]
    zb = [_rand((n, lo.z + hi.z, Y, X), seed + 20 + q) for q in range(nf)]
    port = tuple([torch.from_numpy(a) for a in bufs] for bufs in (xb, yb, zb))
    jax_ = ([a for a in xb], [a.transpose(0, 2, 1, 3) for a in yb], [a.transpose(0, 3, 1, 2) for a in zb])
    return port, jax_


@pytest.mark.parametrize("kern,names,r,lo,hi", [
    (mean6, ["q0", "q1"], 1, (1, 2, 1), (2, 1, 3)),
    (r2_kernel, ["q0"], 2, (2, 3, 2), (2, 2, 3)),
])
def test_plane_pass_plain_fused_vs_pallas(kern, names, r, lo, hi):
    lo, hi = Dim3(*lo), Dim3(*hi)
    X, Y, Z = 9, 10, 12
    gs = (20, 30, 40)
    raws = [_rand((X, Y, Z), 30 + q) for q in range(len(names))]
    (pxb, pyb, pzb), (jxb, jyb, jzb) = _fused_inputs(1, X, Y, Z, lo, hi, len(names), 40)
    origin = np.array([3, 5, 7], np.int32)
    got = st.stream_plane_pass_plain(kern, names, [torch.from_numpy(a) for a in raws], lo, hi, r,
                                     torch.from_numpy(origin), gs,
                                     fused_shell=tuple([t[0] for t in b] for b in (pxb, pyb, pzb)))
    want = jst.stream_plane_pass(kern, names, [jnp.asarray(a) for a in raws], JDim3(*lo), JDim3(*hi), r,
                                 jnp.asarray(origin), JDim3(*gs), interpret=True,
                                 fused_shell=tuple([jnp.asarray(t[0]) for t in b] for b in (jxb, jyb, jzb)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m", [1, 2, 3])
def test_wavefront_pass_plain_fused_vs_pallas(m):
    s = 3
    Xr, Yr, Zr = 11, 12, 13
    names = ["q0", "q1"]
    gs = (20, 30, 40)
    s3 = Dim3(s, s, s)
    raws = [_rand((Xr, Yr, Zr), 50 + q) for q in range(2)]
    (pxb, pyb, pzb), (jxb, jyb, jzb) = _fused_inputs(1, Xr, Yr, Zr, s3, s3, 2, 60)
    origin = np.array([4, 2, 9], np.int32)
    got, gz = st.stream_wavefront_pass_plain(mean6, names, [torch.from_numpy(a) for a in raws], m, s,
                                             torch.from_numpy(origin), gs,
                                             fused_shell=tuple([t[0] for t in b] for b in (pxb, pyb, pzb)))
    want, _ = jst.stream_wavefront_pass(mean6, names, [jnp.asarray(a) for a in raws], m, s, jnp.asarray(origin),
                                        JDim3(*gs), interpret=True,
                                        fused_shell=tuple([jnp.asarray(t[0]) for t in b] for b in (jxb, jyb, jzb)))
    assert gz is None
    S = slice(s, -s)
    for g, w in zip(got, want):
        if m == 1:
            np.testing.assert_array_equal(g.numpy()[S, S, S], np.asarray(w)[S, S, S])
        else:
            np.testing.assert_allclose(g.numpy()[S, S, S], np.asarray(w)[S, S, S], **TOL)


def test_fused_pass_arguments_are_checked():
    lo = hi = Dim3(1, 1, 1)
    raws = [torch.zeros(2, 6, 7, 8)]
    org = torch.zeros(2, 3, dtype=torch.int32)
    good = ([torch.zeros(2, 2, 7, 8)], [torch.zeros(2, 2, 6, 8)], [torch.zeros(2, 2, 7, 6)])
    st.stream_plane_pass(mean6, ["u"], raws, lo, hi, 1, org, (8, 8, 8), fused_shell=good)
    for bad, match in ((good[:2], "xbufs, ybufs, zbufs"),
                       ((good[0], [torch.zeros(2, 2, 8, 6)], good[2]), "ybufs: shape"),
                       ((good[0], good[1], good[2] * 2), "zbufs: 2 buffers"),
                       ((good[0], good[1], [torch.zeros(2, 2, 7, 6, dtype=torch.float64)]), "float32")):
        with pytest.raises((ValueError, TypeError), match=match):
            st.stream_plane_pass(mean6, ["u"], raws, lo, hi, 1, org, (8, 8, 8), fused_shell=bad)
    with pytest.raises(ValueError, match="plain form"):
        st.stream_wavefront_pass(mean6, ["u"], [torch.zeros(2, 8, 8, 8)], 1, 2, org, (8, 8, 8),
                                 z_slabs=[torch.zeros(2, 8, 4, 8)], fused_shell=good)


# --- the fused step in the port and against the JAX package ------------------------

#: (stream_path, kernel, names, radius, halo multiplier, steps, expected route)
STEPS = {
    "plane_r1": ("plane", mean6, ["q0", "q1"], 1, 1, 3, "plane"),
    "plane_r2": ("plane", r2_kernel, ["q0"], 2, 1, 3, "plane"),
    "plane_wide": ("plane", mean6, ["q0", "q1"], 1, 2, 3, "plane"),
    "wavefront": ("auto", mean6, ["q0", "q1"], 1, 3, 7, "wavefront"),
}


def _port_step(case, halo, route, **kw):
    path, kern, names, radius, mult, steps, _ = STEPS[case]
    dd, hs = _tmk(radius=radius, mult=mult, route=route, nf=len(names))
    step = dd.make_step(kern, engine="stream", stream_path=path, stream_halo=halo, **kw)
    ledger.reset_launch_counts()
    dd.run_step(step, steps)
    return dd, hs, step


@pytest.mark.parametrize("case", sorted(STEPS))
@pytest.mark.parametrize("route", ["yzpack_xla", "yzpack_pallas"])
def test_fused_step_equals_array_raw_blocks(case, route):
    """The raw blocks, shell included, bitwise; the stacks never see a halo
    write under fused (no unpack, no blend), and the wavefront's z-slab
    plan re-plans to the plain form."""
    da, ha, sa = _port_step(case, "array", route, stream_z_slabs=False)
    db, hb, sb = _port_step(case, "fused", route)
    plan = sb._stream_plan
    assert plan["halo"] == "fused" and plan["route"] == STEPS[case][6] and not plan["z_slabs"]
    assert plan["m"] == sa._stream_plan["m"] and sa._stream_plan["halo"] == "array"
    for a, b in zip(ha, hb):
        assert torch.equal(da.get_curr(a), db.get_curr(b))


@pytest.mark.parametrize("case", ["plane_r1", "wavefront"])
def test_fused_step_vs_jax(case):
    """Against the JAX package's fused step (interpret mode): bitwise on the
    plane route, TOL on the wavefront (module docstring)."""
    path, kern, names, radius, mult, steps, _ = STEPS[case]
    td, th, step = _port_step(case, "fused", "yzpack_xla")
    jd, jh = _jmk(radius=radius, mult=mult, nf=len(names))
    jstep = jd.make_step(kern, engine="stream", stream_path=path, interpret=True, stream_halo="fused")
    assert jstep._stream_plan["halo"] == "fused" and jstep._stream_plan["m"] == step._stream_plan["m"]
    jd.run_step(jstep, steps)
    for a, b in zip(th, jh):
        got, want = td.quantity_to_host(a), np.asarray(jd.quantity_to_host(b))
        if case == "plane_r1":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, **TOL)


# --- resolution and degradation (tests/test_stream_fused.py:193-254) ---------------


def test_halo_unknown_request_rejected():
    dd, _ = _tmk(mult=2)
    with pytest.raises(ValueError, match="unknown stream halo"):
        dd.make_step(mean6, engine="stream", stream_halo="bogus")


@pytest.mark.parametrize("route", [None, "direct", "zpack_xla", "zpack_pallas"])
def test_fused_degrades_without_ypack_route(route):
    dd, hs = _tmk(mult=2, route=route)
    with pytest.warns(RuntimeWarning, match="does not pack the y shell"):
        step = dd.make_step(mean6, engine="stream", stream_halo="fused")
    assert step._stream_plan["halo"] == "array" and not step._stream_plan["z_slabs"]
    dd.run_step(step, 2)


def test_fused_degrades_under_split():
    dd, _ = _tmk(mult=2)
    with pytest.warns(RuntimeWarning, match="exterior band passes read exchanged blocks"):
        step = dd.make_step(mean6, engine="stream", stream_overlap="split", stream_halo="fused")
    assert step._stream_plan["overlap"] == "split" and step._stream_plan["halo"] == "array"


def test_fused_degrades_on_wrap_route():
    dd, _ = _tmk(subdomains=1)
    with pytest.warns(RuntimeWarning, match="'wrap' route has no exchange to fuse"):
        step = dd.make_step(mean6, engine="stream", stream_halo="fused")
    assert step._stream_plan["route"] == "wrap" and step._stream_plan["halo"] == "array"


def test_fused_degrades_on_uneven_shards():
    """Padded shards: the domain's packed route already falls back to
    ``direct`` there, and the shards alone rule fused out too."""
    dd, hs = _tmk(size=(15, 15, 15), route=None)
    with pytest.warns(RuntimeWarning, match="halo=fused"):
        step = dd.make_step(mean6, engine="stream", stream_halo="fused")
    assert step._stream_plan["halo"] == "array"
    assert "padded" in st.fused_halo_ineligible(dd, step._stream_plan, "yzpack_xla")
    dd.run_step(step, 2)


def test_fused_replans_zslab_to_plain_form():
    dd, _ = _tmk(mult=2)
    static = st.plan_stream(dd, 1)
    assert static["route"] == "wavefront" and static["z_slabs"]
    step = dd.make_step(mean6, engine="stream", stream_halo="fused")
    plan = step._stream_plan
    assert plan["route"] == "wavefront" and not plan["z_slabs"] and plan["halo"] == "fused"
    assert plan["m"] == static["m"]
    # an explicit z_slabs=True keeps the slab form, and fused degrades there
    with pytest.warns(RuntimeWarning, match="z-slab wavefront already keeps z halos"):
        step = dd.make_step(mean6, engine="stream", stream_halo="fused", stream_z_slabs=True)
    assert step._stream_plan["z_slabs"] and step._stream_plan["halo"] == "array"


def test_halo_resolution_matches_jax():
    """auto, array and fused resolve as in the JAX package on the same
    domains (a packed route and ``direct``); a degradation warns in both."""
    for route in ("yzpack_xla", "direct"):
        for halo in ("auto", "array", "fused"):
            td, _ = _tmk(mult=2, route=route)
            jd, _ = _jmk(mult=2, route=route)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = td.make_step(mean6, engine="stream", stream_halo=halo)._stream_plan
            want = jd.make_step(mean6, engine="stream", interpret=True, stream_halo=halo)._stream_plan
            assert (got["halo"], got["route"], got["z_slabs"], got["m"]) == \
                (want["halo"], want["route"], want["z_slabs"], want["m"])
            degraded = halo == "fused" and route == "direct"
            assert any(issubclass(w.category, RuntimeWarning) for w in caught) == degraded


# --- the fused launch path on stand-in C entries -------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:0``, so the wrappers take their
    launch path; its data stays in host memory."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _view(ptr, shape):
    nbytes = int(np.prod(shape)) * 4
    return torch.from_numpy(np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=np.float32)
                            .reshape(shape))


def _ptr_list(arr, nf):
    return [arr[q] for q in range(nf)]


@pytest.fixture
def on_card(monkeypatch):
    """The stream wrappers' launch path on host memory: stand-in libraries
    whose fused entries record their arguments and compute the plain
    version at the addresses given (or return ``card.rc``), a fixed raw
    stream, and the templates each lookup asked for."""
    card = types.SimpleNamespace(calls=[], loads=[], rc=0, kernel=None, names=None,
                                 to_card=lambda t: t.clone().as_subclass(_OnCard))

    def plane(in_p, xb_p, yb_p, zb_p, out_p, org_p, n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, r, gx, gy, gz, stream):
        card.calls.append(("plane", n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, r, gx, gy, gz, stream))
        if card.rc:
            return card.rc
        nf = len(card.names)
        lo, hi = Dim3(lox, loy, loz), Dim3(hix, hiy, hiz)
        raws = [_view(p, (n, X, Y, Z)) for p in _ptr_list(in_p, nf)]
        fs = ([_view(p, (n, lox + hix, Y, Z)) for p in _ptr_list(xb_p, nf)],
              [_view(p, (n, loy + hiy, X, Z)) for p in _ptr_list(yb_p, nf)],
              [_view(p, (n, loz + hiz, Y, X)) for p in _ptr_list(zb_p, nf)])
        org = torch.from_numpy(np.frombuffer((ctypes.c_char * (12 * n)).from_address(org_p), dtype=np.int32)
                               .reshape(n, 3).copy())
        outs = st.stream_plane_pass_plain(card.kernel, card.names, raws, lo, hi, r, org, (gx, gy, gz), fused_shell=fs)
        for p, o in zip(_ptr_list(out_p, nf), outs):
            _view(p, (n, X, Y, Z)).copy_(o)
        return 0

    def wavefront(raw_p, xb_p, yb_p, zb_p, out_p, org_p, n, Xr, Yr, Zr, m, s, gx, gy, gz, stream):
        card.calls.append(("wavefront", n, Xr, Yr, Zr, m, s, gx, gy, gz, stream))
        if card.rc:
            return card.rc
        nf = len(card.names)
        raws = [_view(p, (n, Xr, Yr, Zr)) for p in _ptr_list(raw_p, nf)]
        fs = ([_view(p, (n, 2 * s, Yr, Zr)) for p in _ptr_list(xb_p, nf)],
              [_view(p, (n, 2 * s, Xr, Zr)) for p in _ptr_list(yb_p, nf)],
              [_view(p, (n, 2 * s, Yr, Xr)) for p in _ptr_list(zb_p, nf)])
        org = torch.from_numpy(np.frombuffer((ctypes.c_char * (12 * n)).from_address(org_p), dtype=np.int32)
                               .reshape(n, 3).copy())
        outs, _ = st.stream_wavefront_pass_plain(card.kernel, card.names, raws, m, s, org, (gx, gy, gz),
                                                 fused_shell=fs)
        for p, o in zip(_ptr_list(out_p, nf), outs):
            _view(p, (n, Xr, Yr, Zr)).copy_(o)
        return 0

    def load_generated(template, text):
        card.loads.append((template, "#define STP_FUSED 1" in text))
        return types.SimpleNamespace(stp_stream_plane_fused=plane, stp_stream_wavefront_fused=wavefront,
                                     stp_error_string=lambda code: b"stand-in error")

    monkeypatch.setattr(build, "load_generated", load_generated)
    monkeypatch.setattr(st, "stream_handle", lambda dev: 7000 + dev.index)
    return card


def _launch_case(kind, nf, seed):
    names = [f"q{i}" for i in range(nf)]
    n, X, Y, Z = 2, 9, 10, 11
    s = 2
    lo = hi = Dim3(s, s, s)
    raws = [torch.from_numpy(_rand((n, X, Y, Z), seed + q)) for q in range(nf)]
    (fs, _) = _fused_inputs(n, X, Y, Z, lo, hi, nf, seed + 10)
    org = torch.tensor([[1, 2, 3], [7, 5, 0]], dtype=torch.int32)
    return names, raws, fs, org, lo, hi, s


@pytest.mark.parametrize("kind", ["plane", "wavefront"])
@pytest.mark.parametrize("nf", [1, 2])
def test_fused_launch_path_passes_the_arguments_in_order(on_card, kind, nf):
    names, raws, fs, org, lo, hi, s = _launch_case(kind, nf, 80)
    on_card.kernel, on_card.names = mean6, names
    c = on_card.to_card
    gs = (20, 30, 40)
    args = ([c(r) for r in raws], tuple([c(t) for t in b] for b in fs), c(org))
    counter = st.stream_plane_pass if kind == "plane" else st.stream_wavefront_pass
    before = (counter.launches, counter.fused_launches)
    if kind == "plane":
        got = st.stream_plane_pass(mean6, names, args[0], lo, hi, 1, args[2], gs, fused_shell=args[1])
        want = st.stream_plane_pass_plain(mean6, names, raws, lo, hi, 1, org, gs, fused_shell=fs)
        assert on_card.calls == [("plane", 2, 9, 10, 11, s, s, s, s, s, s, 1, *gs, 7000)]
        assert on_card.loads == [("stream_plane_fused", True)]
        region = (slice(None),) * 4
    else:
        got, gz = st.stream_wavefront_pass(mean6, names, args[0], 2, s, args[2], gs, fused_shell=args[1])
        want, _ = st.stream_wavefront_pass_plain(mean6, names, raws, 2, s, org, gs, fused_shell=fs)
        assert gz is None
        assert on_card.calls == [("wavefront", 2, 9, 10, 11, 2, s, *gs, 7000)]
        assert on_card.loads == [("stream_wavefront_fused", True)]
        region = (slice(None),) + (slice(s, -s),) * 3
    assert (counter.launches, counter.fused_launches) == (before[0], before[1] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g.as_subclass(torch.Tensor)[region], w[region])


@pytest.mark.parametrize("rc,match", [(2, "launch failed \\(2\\): stand-in error"), (-1, "unsupported argument")])
@pytest.mark.parametrize("kind", ["plane", "wavefront"])
def test_a_failed_fused_launch_raises_with_no_fallback(on_card, kind, rc, match):
    names, raws, fs, org, lo, hi, s = _launch_case(kind, 1, 90)
    on_card.kernel, on_card.names, on_card.rc = mean6, names, rc
    c = on_card.to_card
    counter = st.stream_plane_pass if kind == "plane" else st.stream_wavefront_pass
    before = counter.fused_launches
    fsc = tuple([c(t) for t in b] for b in fs)
    with pytest.raises(RuntimeError, match=match):
        if kind == "plane":
            st.stream_plane_pass(mean6, names, [c(r) for r in raws], lo, hi, 1, c(org), (8, 8, 8), fused_shell=fsc)
        else:
            st.stream_wavefront_pass(mean6, names, [c(r) for r in raws], 2, s, c(org), (8, 8, 8), fused_shell=fsc)
    assert counter.fused_launches == before and len(on_card.calls) == 1


def test_fused_launch_refuses_buffers_off_the_blocks_device(on_card):
    names, raws, fs, org, lo, hi, s = _launch_case("plane", 1, 95)
    on_card.kernel, on_card.names = mean6, names
    c = on_card.to_card
    with pytest.raises(ValueError, match="different devices"):
        st.stream_plane_pass(mean6, names, [c(r) for r in raws], lo, hi, 1, c(org), (8, 8, 8), fused_shell=fs)
    assert on_card.calls == []


def test_fused_step_prebuilds_only_the_fused_forms(monkeypatch):
    """On the card a fused step builds the fused libraries, every depth of
    the wavefront's, in one batch; a split step the array forms."""
    batches = []
    monkeypatch.setattr(build, "build_generated", lambda sources: batches.append(list(sources)))
    plans = [dict(route="plane", m=1, halo="fused"), dict(route="wavefront", m=3, halo="fused"),
             dict(route="wavefront", m=3, halo="array")]
    sk = st.StreamKernel(mean6, ["q0"], 1, (16, 16, 16))
    for plan in plans:
        st._prebuild([sk], plan)
    assert [sorted({t for t, _ in b}) for b in batches] == [["stream_plane_fused"], ["stream_wavefront_fused"],
                                                            ["stream_wavefront"]]
    assert [len(b) for b in batches] == [1, 3, 3]
    assert all(("#define STP_FUSED 1" in text) == t.endswith("_fused") for b in batches for t, text in b)
