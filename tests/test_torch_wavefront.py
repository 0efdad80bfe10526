"""The port's temporally blocked wavefront route against the JAX package's.

Inputs come from ``numpy.random.default_rng(seed)``; the JAX kernels run in
Pallas interpret mode, as tests/test_jacobi_pallas.py runs them, and the
port's wrappers run their plain versions (CPU tensors).  Everything here is
held bitwise:

* each wavefront kernel's plain version against the Pallas kernel, on the
  valid region (the block interior ``[s, ext - s)`` of every shelled axis,
  and the outgoing z slabs at interior x planes and y rows; shell cells are
  unspecified in both packages);
* ``Jacobi3D(kernel_impl="cuda")`` on the ``wavefront`` route against JAX
  ``pallas_path="wavefront"``, in the z-ring and the padded z-slab forms, with
  a ``steps % m`` remainder, and on one subdomain against the wrap route;
* ``step(1)`` calls, which take up the last call's arrays, against one call;
* the torch engine under ``set_halo_multiplier(2)`` against JAX ``jnp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.ops import jacobi_pallas as jp
from stencil_tpu.ops import stream as jstream
from stencil_tpu_torch.models.jacobi import Jacobi3D, to_jax_state, to_torch_state
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops import stream as tstream

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

ONE = jax.devices()[:1]
TWO = jax.devices()[:2]


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _port(size, partition=None, **kw):
    m = Jacobi3D(*size, device="cpu", **kw)
    if partition is not None:
        m.dd.set_partition(*partition)
    m.realize()
    return m


def _jax(size, devices=None, partition=None, **kw):
    m = JJacobi3D(*size, devices=devices, **kw)
    if partition is not None:
        m.dd.set_partition(*partition)
    m.realize()
    return m


# --- kernel level -------------------------------------------------------------


@pytest.mark.parametrize(
    "m,s_off,slabs,z_valid",
    [
        (1, 1, False, None),
        (2, 2, False, 14),
        (2, 3, False, None),
        (2, 2, True, None),
        (2, 3, True, 13),
        (3, 3, True, 14),
    ],
)
def test_shell_wavefront_plain_equals_pallas(m, s_off, slabs, z_valid):
    Xr, Yr, Zr = 12, 13, 16
    gs = (2 * (Xr - 2 * s_off) + 1, 2 * (Yr - 2 * s_off), 40)
    raw = _rand((Xr, Yr, Zr), 1)
    origin = np.array([gs[0] - 2, 3, 5], np.int32)
    d2 = jk.yz_dist2_plane(origin[1] - s_off, origin[2] - s_off, (Yr, Zr), gs)
    zs = _rand((Xr, 2 * s_off, Yr), 2) if slabs else None
    want = jp.jacobi_shell_wavefront_step(
        jnp.asarray(raw), m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
        interior_offset=s_off, interpret=True, alias=False,
        z_slabs=None if zs is None else jnp.asarray(zs), z_valid=z_valid,
    )
    got = jk.jacobi_shell_wavefront_step(
        torch.from_numpy(raw), m, torch.from_numpy(origin), d2, gs, interior_offset=s_off,
        z_slabs=None if zs is None else torch.from_numpy(zs), z_valid=z_valid,
    )
    if not slabs:
        want, got = (want, None), (got, None)
    S = slice(s_off, -s_off)
    zv = Zr if z_valid is None else z_valid
    np.testing.assert_array_equal(got[0].numpy()[S, S, s_off : zv - s_off],
                                  np.asarray(want[0])[S, S, s_off : zv - s_off])
    if slabs:
        np.testing.assert_array_equal(got[1].numpy()[S, :, S], np.asarray(want[1])[S, :, S])


@pytest.mark.parametrize("m,s_off", [(1, 1), (1, 2), (2, 2), (2, 3), (3, 3)])
def test_zring_wavefront_plain_equals_pallas(m, s_off):
    Xr, Yr, Zi = 10, 12, 128
    gs = (2 * (Xr - 2 * s_off) + 3, 2 * (Yr - 2 * s_off), 2 * Zi)
    raw = _rand((Xr, Yr, Zi), 3)
    origin = np.array([4, Yr - 2 * s_off, Zi], np.int32)
    d2 = jk.zring_dist2_plane(origin[1] - s_off, origin[2], s_off, Yr, Zi, gs)
    np.testing.assert_array_equal(
        d2.numpy(), np.asarray(jp.zring_dist2_plane(origin[1] - s_off, origin[2], s_off, Yr, Zi, gs))
    )
    zs = _rand((Xr, 2 * s_off, Yr), 4)
    want = jp.jacobi_zring_wavefront_step(
        jnp.asarray(raw), m, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
        z_slabs=jnp.asarray(zs), interior_offset=s_off, interpret=True,
    )
    got = jk.jacobi_zring_wavefront_step(
        torch.from_numpy(raw), m, torch.from_numpy(origin), d2, gs, torch.from_numpy(zs),
        interior_offset=s_off,
    )
    S = slice(s_off, -s_off)
    np.testing.assert_array_equal(got[0].numpy()[S, S], np.asarray(want[0])[S, S])
    np.testing.assert_array_equal(got[1].numpy()[S, :, S], np.asarray(want[1])[S, :, S])


def test_wavefront_wrappers_batch_blocks():
    """One call over n blocks equals n single-block calls, for both wrappers."""
    gs = (40, 30, 64)
    raw = torch.from_numpy(_rand((2, 10, 11, 12), 5))
    org = torch.tensor([[0, 3, 4], [20, 0, 9]], dtype=torch.int32)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - 2, int(o[2]) - 2, (11, 12), gs) for o in org])
    zs = torch.from_numpy(_rand((2, 10, 4, 11), 6))
    out, zout = jk.jacobi_shell_wavefront_step(raw, 2, org, d2, gs, z_slabs=zs, z_valid=11)
    ring_raw = torch.from_numpy(_rand((2, 10, 11, 32), 7))
    rd2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - 2, int(o[2]), 2, 11, 32, gs) for o in org])
    rout, rzout = jk.jacobi_zring_wavefront_step(ring_raw, 2, org, rd2, gs, zs)
    for b in range(2):
        o, z = jk.jacobi_shell_wavefront_step(raw[b], 2, org[b], d2[b], gs, z_slabs=zs[b], z_valid=11)
        assert torch.equal(out[b], o) and torch.equal(zout[b], z)
        o, z = jk.jacobi_zring_wavefront_step(ring_raw[b], 2, org[b], rd2[b], gs, zs[b])
        assert torch.equal(rout[b], o) and torch.equal(rzout[b], z)


def test_wavefront_arguments_checked():
    gs = (40, 30, 64)
    raw = torch.zeros((10, 11, 12))
    org = torch.zeros(3, dtype=torch.int32)
    d2 = jk.yz_dist2_plane(0, 0, (11, 12), gs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jk.jacobi_shell_wavefront_step(raw, 2, org, d2, gs, alias=True)
    with pytest.raises(ValueError, match="interior_offset"):
        jk.jacobi_shell_wavefront_step(raw, 3, org, d2, gs, interior_offset=2)
    with pytest.raises(ValueError, match="shared memory"):
        jk.jacobi_shell_wavefront_step(torch.zeros((30, 30, 30)), 10, org,
                                       jk.yz_dist2_plane(0, 0, (30, 30), gs), gs)
    with pytest.raises(ValueError, match="d2 shape"):
        jk.jacobi_zring_wavefront_step(raw, 2, org, d2, gs, torch.zeros((10, 4, 11)))
    assert jk.wavefront_smem_fits(8) and not jk.wavefront_smem_fits(9)
    assert jk.wavefront_smem_bytes(8) == 221_184


def test_slab_helpers_match_jax():
    """prime_z_slabs and the y/x slab extenders, one subdomain per grid axis
    (the JAX helpers' ppermute over a size-1 axis is the identity shift)."""
    Xr, Yr, Zr, s = 9, 10, 11, 2
    block = _rand((Xr, Yr, Zr), 8)
    want = np.asarray(jstream.prime_z_slabs(jnp.asarray(block), Zr, s))
    got = tstream.prime_z_slabs(torch.from_numpy(block)[None, None, None], Zr, s)[0, 0, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert tstream.lane_pad_width(Zr) == jstream.lane_pad_width(Zr) == 128
    yext, xext = tstream.make_slab_extenders(Xr, Yr, s)
    S = torch.from_numpy(_rand((1, 1, 1, Xr, s, Yr), 9))
    ext = xext(yext(S))[0, 0, 0].numpy()
    raw = S[0, 0, 0].numpy()
    np.testing.assert_array_equal(ext[s:-s, :, s:-s], raw[s:-s, :, s:-s])
    np.testing.assert_array_equal(ext[s:-s, :, :s], raw[s:-s, :, Yr - 2 * s : Yr - s])
    np.testing.assert_array_equal(ext[:s], ext[Xr - 2 * s : Xr - s])


# --- route level --------------------------------------------------------------


@pytest.mark.parametrize(
    "size,temporal_k,m,z_slabs,steps",
    [((24, 24, 24), 2, 2, True, 5),  # padded z-slab form: 2 macros + a remainder of 1
     ((12, 12, 12), "auto", 1, False, 3)],  # depth cap 1: the plain form
)
def test_wavefront_route_bitwise_vs_jax_2x2x2(size, temporal_k, m, z_slabs, steps):
    kw = dict(pallas_path="wavefront", temporal_k=temporal_k)
    j = _jax(size, kernel_impl="pallas", interpret=True, **kw)
    t = _port(size, (2, 2, 2), kernel_impl="cuda", **kw)
    assert t._pallas_path == j._pallas_path == "wavefront"
    assert t._wavefront_m == j._wavefront_m == m
    assert t._wavefront_z_slabs == j._wavefront_z_slabs == z_slabs
    assert not t._wavefront_z_ring
    j.step(steps)
    t.step(steps)
    np.testing.assert_array_equal(t.temperature(), j.temperature())


@pytest.mark.parametrize("z_ring", [None, False])
def test_wavefront_z_forms_bitwise_vs_jax(z_ring):
    """(16,16,128) over 2x1x1: the subdomain's z extent is lane-aligned, so
    both packages take the z-ring form, or with ``z_ring=False`` the padded
    z-slab form."""
    size = (16, 16, 128)
    kw = dict(pallas_path="wavefront", temporal_k=2, z_ring=z_ring)
    j = _jax(size, TWO, (2, 1, 1), kernel_impl="pallas", interpret=True, **kw)
    t = _port(size, (2, 1, 1), kernel_impl="cuda", **kw)
    assert t._wavefront_z_ring == j._wavefront_z_ring == (z_ring is None)
    assert t._wavefront_z_slabs and j._wavefront_z_slabs
    j.step(5)
    t.step(5)
    np.testing.assert_array_equal(t.temperature(), j.temperature())


@pytest.mark.parametrize("z_ring", [None, False])
def test_wavefront_step_calls_resume_bitwise(z_ring):
    """Each call takes up the working array and z slabs the last one left:
    five ``step(1)`` calls equal one ``step(5)``; a state loaded between
    calls (random, so no kept cell is right for it) is what the next call
    advances, as on a model that never stepped."""
    size = (16, 16, 128)
    kw = dict(pallas_path="wavefront", temporal_k=2, z_ring=z_ring)
    ones, once, fresh = (_port(size, (2, 1, 1), kernel_impl="cuda", **kw) for _ in range(3))
    assert ones.dd.planned_grid().dim() == ones.dd.grid_dim()
    for _ in range(5):
        ones.step(1)
    once.step(5)
    np.testing.assert_array_equal(ones.temperature(), once.temperature())
    state = _rand(to_jax_state(once.dd).shape, 11)
    to_torch_state(state, ones.dd)
    to_torch_state(state, fresh.dd)
    ones.step(3)
    fresh.step(3)
    np.testing.assert_array_equal(ones.temperature(), fresh.temperature())


def test_wavefront_one_subdomain_bitwise_vs_wrap():
    """On one subdomain the self-shifted shell is the periodic wrap, and the
    wavefront kernel sums in the wrap kernel's order."""
    size = (20, 18, 22)
    wf = _port(size, kernel_impl="cuda", pallas_path="wavefront", temporal_k=3)
    wrap = _port(size, kernel_impl="cuda", temporal_k=3)
    assert wf._pallas_path == "wavefront" and wf._wavefront_m == 3
    assert wrap._pallas_path == "wrap"
    wf.step(6)
    wrap.step(6)
    np.testing.assert_array_equal(wf.temperature(), wrap.temperature())
    j = _jax(size, ONE, kernel_impl="pallas", interpret=True, pallas_path="wavefront", temporal_k=3)
    j.step(6)
    np.testing.assert_array_equal(wf.temperature(), j.temperature())


@pytest.mark.parametrize(
    "size,partition",
    [((24, 24, 24), (2, 2, 2)), ((32, 32, 32), (2, 2, 2)), ((16, 16, 128), (2, 1, 1)),
     ((12, 12, 12), (2, 2, 2)), ((16, 16, 16), None)],
)
def test_auto_route_matches_jax(size, partition):
    """The same route, depth and form as the JAX package picks (auto)."""
    count = 1 if partition is None else int(np.prod(partition))
    j = _jax(size, jax.devices()[:count], partition, kernel_impl="pallas", interpret=True)
    t = _port(size, partition, kernel_impl="cuda")
    assert t._pallas_path == j._pallas_path
    if j._pallas_path == "wavefront":
        assert t._wavefront_m == j._wavefront_m
        assert t._wavefront_z_slabs == j._wavefront_z_slabs
        assert t._wavefront_z_ring == j._wavefront_z_ring


def test_wavefront_state_carries_between_packages():
    """JAX runs 3 wavefront steps, the state moves to the port, both run 3
    more: bitwise equal; the port's raw state (re-exchanged) equals JAX's."""
    size = (24, 24, 24)
    j = _jax(size, kernel_impl="pallas", interpret=True, pallas_path="wavefront", temporal_k=2)
    t = _port(size, (2, 2, 2), kernel_impl="cuda", pallas_path="wavefront", temporal_k=2)
    j.step(3)
    to_torch_state(j.dd.raw_to_host(j.h), t.dd)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    j.step(3)
    t.step(3)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    assert t.dd._shell_stale
    np.testing.assert_array_equal(to_jax_state(t.dd), j.dd.raw_to_host(j.h))


def test_torch_engine_halo_multiplier_bitwise_vs_jnp():
    size = (24, 24, 24)
    j = JJacobi3D(*size)
    j.dd.set_halo_multiplier(2)
    j.realize()
    t = Jacobi3D(*size, device="cpu")
    t.dd.set_partition(2, 2, 2)
    t.dd.set_halo_multiplier(2)
    t.realize()
    assert t.dd.local_spec().raw_size().tuple() == (16, 16, 16)
    j.step(4)
    t.step(4)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    with pytest.raises(ValueError, match="multiple of the halo multiplier"):
        t.step(3)
