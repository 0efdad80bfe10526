"""The port's ``slab`` route and its kernel against the JAX package's.

Inputs come from ``numpy.random.default_rng(seed)``; the JAX kernel runs in
Pallas interpret mode, as tests/test_slab_step.py runs it, and the port's
wrapper runs its plain version (CPU tensors).  Everything here is held
bitwise: ``jacobi_slab_step`` sums x-1, x+1, y-1, y+1, z-1, z+1 and multiplies
by float32(1/6) in both packages.

* ``jacobi_slab_step_plain`` against the Pallas kernel, on random face slabs
  and on a block's own faces (the periodic wrap, so also against the wrap
  kernel); the port's z slabs are ``(X, Y)``, the JAX kernel's ``(Y, X)``;
* ``Jacobi3D(kernel_impl="cuda", pallas_path="slab")`` against JAX
  ``pallas_path="slab"`` and within rtol 1e-6 of its ``jnp`` route (another
  summation order); the route choice, the raw readback and the driver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.ops import jacobi_pallas as jp
from stencil_tpu_torch.models.jacobi import Jacobi3D, to_jax_state
from stencil_tpu_torch.ops import jacobi_kernels as jk

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _self_faces(b):
    """A block's own boundary planes as its received slabs (the port's
    layout): the periodic wrap."""
    return (b[-1], b[0], b[:, -1, :], b[:, 0, :], b[:, :, -1], b[:, :, 0])


def _port(size, partition=None, **kw):
    m = Jacobi3D(*size, device="cpu", kernel_impl="cuda", **kw)
    if partition is not None:
        m.dd.set_partition(*partition)
    m.realize()
    return m


def _jax(size, devices=None, **kw):
    m = JJacobi3D(*size, devices=devices, **kw)
    m.realize()
    return m


# --- kernel level -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 16)])
@pytest.mark.parametrize("faces", ["random", "self"])
def test_slab_plain_equals_pallas(shape, faces):
    X, Y, Z = shape
    block = _rand(shape, 1)
    if faces == "self":
        gs, origin = shape, np.zeros(3, np.int32)
        slabs = [np.ascontiguousarray(s) for s in _self_faces(block)]
    else:
        # a block inside a larger domain whose x wraps past gx
        gs = (2 * X + 3, 2 * Y, 3 * Z)
        origin = np.array([X + 3, Y, 2 * Z], np.int32)
        slabs = [_rand(s, 2 + i) for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    d2 = jk.yz_dist2_plane(int(origin[1]), int(origin[2]), (Y, Z), gs)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jp.yz_dist2_plane(origin[1], origin[2], (Y, Z), gs)))
    jslabs = [jnp.asarray(s) for s in slabs[:4]] + [jnp.asarray(s.T) for s in slabs[4:]]
    want = jp.jacobi_slab_step(jnp.asarray(block), *jslabs, jnp.asarray(origin), jnp.asarray(d2.numpy()), gs,
                               interpret=True)
    got = jk.jacobi_slab_step(torch.from_numpy(block), *(torch.from_numpy(s) for s in slabs),
                              torch.from_numpy(origin), d2, gs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if faces == "self" and X == Y == Z:
        # a block fed its own faces is the periodic wrap
        np.testing.assert_array_equal(got.numpy(), jk.jacobi_wrap_step(torch.from_numpy(block), 1).numpy())


def test_slab_step_batches_blocks_and_fills_out():
    """One call over n blocks equals n single-block calls; ``out`` is filled."""
    n, X, Y, Z = 3, 6, 7, 9
    gs = (3 * X, 20, 30)
    block = torch.from_numpy(_rand((n, X, Y, Z), 5))
    slabs = [torch.from_numpy(_rand((n,) + s, 6 + i))
             for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
    org = torch.tensor([[0, 3, 4], [X, 0, 9], [2 * X, 13, 21]], dtype=torch.int32)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (Y, Z), gs) for o in org])
    out = torch.empty_like(block)
    res = jk.jacobi_slab_step(block, *slabs, org, d2, gs, out=out)
    assert res is out
    for b in range(n):
        one = jk.jacobi_slab_step(block[b], *(s[b] for s in slabs), org[b], d2[b], gs)
        assert torch.equal(out[b], one)


def test_slab_step_arguments_checked():
    """``X >= 2`` (the TPU kernel's assertion, jacobi_pallas.py:1393-1395) is
    a raise; so are slabs of the wrong shape or layout."""
    thin = torch.zeros((1, 8, 8))
    d2 = jk.yz_dist2_plane(0, 0, (8, 8), (1, 8, 8))
    org = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="X >= 2"):
        jk.jacobi_slab_step(thin, *_self_faces(thin), org, d2, (1, 8, 8))
    block = torch.zeros((4, 5, 6))
    d2 = jk.yz_dist2_plane(0, 0, (5, 6), (4, 5, 6))
    faces = [f.contiguous() for f in _self_faces(block)]
    faces[4] = faces[4].T.contiguous()  # the JAX layout (Y, X)
    with pytest.raises(ValueError, match="zlo shape"):
        jk.jacobi_slab_step(block, *faces, org, d2, (4, 5, 6))
    with pytest.raises(ValueError, match="C-contiguous"):
        jk.jacobi_slab_step(block, *_self_faces(block), org, d2, (4, 5, 6))
    with pytest.raises(ValueError, match="separate tensor"):
        faces = [f.contiguous() for f in _self_faces(block)]
        jk.jacobi_slab_step(block, *faces, org, d2, (4, 5, 6), out=block)


# --- route level --------------------------------------------------------------


@pytest.mark.parametrize("size", [(24, 24, 24), (16, 24, 32)])
def test_slab_route_bitwise_vs_jax(size):
    j = _jax(size, kernel_impl="pallas", interpret=True, pallas_path="slab")
    t = _port(size, tuple(j.dd.placement.dim()), pallas_path="slab")
    assert t._pallas_path == j._pallas_path == "slab"
    assert t.dd.num_subdomains() == 8
    ref = _jax(size)  # the jnp route sums in another order
    for m in (j, t, ref):
        m.step(4)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    np.testing.assert_allclose(t.temperature(), ref.temperature(), rtol=1e-6)


def test_slab_route_launches_once_per_step_and_calls_compose(monkeypatch):
    """One ``jacobi_slab_step`` per step over all subdomains; five ``step(1)``
    calls equal one ``step(5)``."""
    size = (16, 16, 16)
    ones, once = _port(size, (2, 2, 2), pallas_path="slab"), _port(size, (2, 2, 2), pallas_path="slab")
    calls = []
    real = jk.jacobi_slab_step_plain

    def spy(block, *a, **k):
        calls.append(tuple(block.shape))
        return real(block, *a, **k)

    monkeypatch.setattr(jk, "jacobi_slab_step_plain", spy)
    once.step(5)
    monkeypatch.undo()
    assert calls == [(8, 8, 8, 8)] * 5
    for _ in range(5):
        ones.step(1)
    np.testing.assert_array_equal(ones.temperature(), once.temperature())


def test_slab_route_one_subdomain_equals_wrap():
    """Forced ``slab`` on one subdomain gets its own faces back: the wrap."""
    size = (20, 18, 22)
    slab = _port(size, pallas_path="slab")
    wrap = _port(size)
    assert slab._pallas_path == "slab" and wrap._pallas_path == "wrap"
    slab.step(6)
    wrap.step(6)
    np.testing.assert_array_equal(slab.temperature(), wrap.temperature())


def test_slab_raw_readback_refreshes_shell():
    """The slab route never writes the shell: the raw readback re-exchanges,
    and equals the JAX package's raw state after the same steps."""
    size = (24, 24, 24)
    j = _jax(size, kernel_impl="pallas", interpret=True, pallas_path="slab")
    t = _port(size, (2, 2, 2), pallas_path="slab")
    j.step(2)
    t.step(2)
    assert t.dd._shell_stale
    raw = to_jax_state(t.dd)
    assert not t.dd._shell_stale
    np.testing.assert_array_equal(raw, j.dd.raw_to_host(j.h))
    inner = t.temperature()
    n = t.dd.local_spec().sz
    # subdomain (0,0,0)'s -x halo is subdomain (1,0,0)'s top interior plane
    np.testing.assert_array_equal(raw[0, 1 : 1 + n.y, 1 : 1 + n.z], inner[2 * n.x - 1, : n.y, : n.z])


@pytest.mark.parametrize(
    "size,partition,route",
    [((12, 12, 12), (2, 2, 2), "slab"),  # planned depth 1: slab, as in the JAX package
     ((15, 12, 12), (2, 2, 2), "shell"),  # uneven, depth 1: shell
     ((4, 16, 16), (2, 1, 1), "slab"),  # 2 x-planes per subdomain
     ((24, 24, 24), (2, 2, 2), "wavefront")],
)
def test_auto_takes_slab_where_jax_does(size, partition, route):
    """``auto`` with several subdomains takes ``slab`` when the planned
    wavefront depth is below 2 on even sizes (models/jacobi.py:130-136,
    :781-786 of the JAX package); its 128-aligned x gate is a TPU compile
    constraint, absent in interpret mode as in the port."""
    count = int(np.prod(partition))
    j = JJacobi3D(*size, devices=jax.devices()[:count], kernel_impl="pallas", interpret=True)
    j.dd.set_partition(*partition)
    j.realize()
    t = _port(size, partition)
    assert t._pallas_path == j._pallas_path == route


@pytest.mark.parametrize("size,partition", [((15, 16, 16), (2, 2, 2)), ((2, 16, 16), (2, 1, 1))])
def test_forced_slab_raises_where_jax_does(size, partition):
    """Forced ``slab`` on uneven sizes or subdomains of one x-plane raises,
    in both packages."""
    count = int(np.prod(partition))
    j = JJacobi3D(*size, devices=jax.devices()[:count], kernel_impl="pallas", interpret=True,
                  pallas_path="slab")
    j.dd.set_partition(*partition)
    with pytest.raises(ValueError, match="slab"):
        j.realize()
    with pytest.raises(ValueError, match="slab"):
        _port(size, partition, pallas_path="slab")


def test_driver_runs_the_slab_route(capsys):
    from stencil_tpu_torch.bin import jacobi3d

    rc = jacobi3d.main(["16", "16", "16", "--no-weak-scale", "--iters", "2", "--device", "cpu",
                        "--partition", "2,2,2", "--pallas-path", "slab"])
    assert rc == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:7] == ["jacobi3d", "ppermute", "1", "1", "16", "16", "16"]
    assert float(row[7]) > 0
