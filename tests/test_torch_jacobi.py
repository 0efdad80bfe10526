"""The port's ``Jacobi3D`` against the JAX package's, and its state carried
across the two packages.

The port's ``cuda`` engine runs here through the kernels' plain versions (CPU
tensors).  Routes and what each is held to:

* ``cuda``/wrap vs JAX ``pallas``/wrap (interpret) on one subdomain: bitwise;
* ``cuda``/shell vs JAX ``pallas``/shell on 2x2x2: bitwise;
* ``torch`` vs JAX ``jnp``: bitwise (both sum in ``_kernel``'s order and
  multiply by float32(1/6));
* ``torch`` vs ``cuda``: rtol 1e-6, as tests/test_jacobi_pallas.py:25 holds
  ``jnp`` vs ``pallas``, because ``_kernel`` sums x+1, x-1, y+1, ... while the
  kernels sum x-1, x+1, y-1, ..., about 1 ulp apart per level.
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.models.jacobi import weak_scaled_size as j_weak_scaled_size
from stencil_tpu_torch.models.jacobi import (
    COLD_TEMP,
    HOT_TEMP,
    Jacobi3D,
    to_jax_state,
    to_torch_state,
    weak_scaled_size,
)

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

ONE = jax.devices()[:1]


def _port(size, subdomains=1, **kw):
    m = Jacobi3D(*size, subdomains=subdomains, device="cpu", **kw)
    m.realize()
    return m


def _jax(size, devices=None, **kw):
    m = JJacobi3D(*size, devices=devices, **kw)
    m.realize()
    return m


def test_cuda_wrap_route_bitwise_vs_pallas_wrap():
    size = (26, 24, 22)
    j = _jax(size, ONE, kernel_impl="pallas", interpret=True, temporal_k=3)
    t = _port(size, kernel_impl="cuda", temporal_k=3)
    assert t._pallas_path == "wrap" and j._pallas_path == "wrap"
    j.step(5)  # one blocked call of 3 plus a remainder of 2
    t.step(5)
    got = t.temperature()
    np.testing.assert_array_equal(got, j.temperature())
    assert got.max() == HOT_TEMP and got.min() == COLD_TEMP


def test_cuda_shell_route_bitwise_vs_pallas_shell():
    size = (24, 24, 24)
    j = _jax(size, kernel_impl="pallas", interpret=True, pallas_path="shell")
    t = _port(size, subdomains=8, kernel_impl="cuda", pallas_path="shell")
    assert t._pallas_path == "shell" and tuple(t.dd.grid_dim()) == (2, 2, 2)
    j.step(4)
    t.step(4)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    # the shell route keeps a fresh shell: raw blocks agree too
    np.testing.assert_array_equal(to_jax_state(t.dd), j.dd.raw_to_host(j.h))


@pytest.mark.parametrize("subdomains", [1, 8])
def test_torch_route_bitwise_vs_jnp(subdomains):
    size = (24, 24, 24)
    j = _jax(size, ONE if subdomains == 1 else None)
    t = _port(size, subdomains=subdomains)
    j.step(4)
    t.step(4)
    np.testing.assert_array_equal(t.temperature(), j.temperature())


def test_torch_route_vs_cuda_routes():
    """Summation order differs (see module docstring): rtol 1e-6.  The wrap
    and shell routes share the kernels' order and agree bitwise."""
    size = (24, 24, 24)
    ref = _port(size, subdomains=8)
    shell = _port(size, subdomains=8, kernel_impl="cuda", pallas_path="shell")
    wrap = _port(size, kernel_impl="cuda")
    for m in (ref, shell, wrap):
        m.step(4)
    np.testing.assert_allclose(shell.temperature(), ref.temperature(), rtol=1e-6)
    np.testing.assert_array_equal(wrap.temperature(), shell.temperature())


@pytest.mark.parametrize("route", ["wrap", "shell"])
def test_state_carries_between_packages(route):
    """JAX runs 3 steps, the state moves to the port, both run 3 more:
    bitwise equal; and the port's state round-trips back."""
    size = (24, 24, 24)
    if route == "wrap":
        j = _jax(size, ONE, kernel_impl="pallas", interpret=True)
        t = _port(size, kernel_impl="cuda")
    else:
        j = _jax(size, kernel_impl="pallas", interpret=True, pallas_path="shell")
        t = _port(size, subdomains=8, kernel_impl="cuda", pallas_path="shell")
    j.step(3)
    to_torch_state(j.dd.raw_to_host(j.h), t.dd)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    j.step(3)
    t.step(3)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    raw = to_jax_state(t.dd)
    assert raw.shape == j.dd.raw_to_host(j.h).shape
    back = _port(size, subdomains=t.dd.num_subdomains(), kernel_impl="cuda", pallas_path=route)
    to_torch_state(raw, back.dd)
    np.testing.assert_array_equal(back.temperature(), t.temperature())


def test_wrap_marks_shell_stale_and_readback_reexchanges():
    t = _port((12, 10, 8), kernel_impl="cuda")
    t.step(2)
    assert t.dd._shell_stale
    raw = to_jax_state(t.dd)  # re-exchanges first
    assert not t.dd._shell_stale
    inner = t.temperature()
    np.testing.assert_array_equal(raw[0, 1:-1, 1:-1], inner[-1])  # -x halo = last plane
    np.testing.assert_array_equal(raw[1:-1, 1:-1, -1], inner[:, :, 0])


def test_unported_options_name_the_roadmap():
    for kw in ({"wavefront_alias": True},):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Jacobi3D(8, 8, 8, device="cpu", **kw)
    # float64 fields on the CUDA kernels are ported: the wrap route engages
    # at f64 and equals the JAX pallas model (every route:
    # tests/test_torch_jacobi_dtypes.py)
    t = _port((8, 8, 8), kernel_impl="cuda", dtype=torch.float64)
    j = _jax((8, 8, 8), ONE, kernel_impl="pallas", interpret=True, dtype=jax.numpy.float64)
    assert t._pallas_path == j._pallas_path == "wrap" and t.dd.get_curr(t.h).dtype == torch.float64
    t.step(3)
    j.step(3)
    np.testing.assert_array_equal(t.temperature(), j.temperature())
    # the kernel axes are ported (tests/test_torch_kernel_axes.py)
    for kw in ({"compute_unit": "mxu"}, {"storage_dtype": "bf16"}, {"mxu_input": "bf16"}):
        Jacobi3D(8, 8, 8, device="cpu", **kw)
    m = Jacobi3D(8, 8, 8, device="cpu")
    # component quantities are ported: the model's domain accepts one
    h = m.dd.add_data("v", components=(3,))
    assert h.components == (3,) and h.cell_count() == 3
    wrap8 = Jacobi3D(16, 16, 16, subdomains=8, kernel_impl="cuda", pallas_path="wrap", device="cpu")
    with pytest.raises(ValueError, match="single subdomain"):
        wrap8.realize()


@pytest.mark.parametrize("subdomains", [1, 8])
def test_jacobi_kernel_on_the_stream_engine(subdomains):
    """Jacobi3D's own kernel runs on ``make_step(engine="stream")`` (the
    wrap route on one subdomain, the plane route on 2x2x2) and equals the
    torch engine bitwise: both evaluate the same trace."""
    size = (16, 16, 16)
    ref = _port(size, subdomains=subdomains)
    m = _port(size, subdomains=subdomains)
    step = m.dd.make_step(m._kernel, engine="stream")
    assert step._stream_plan["route"] == ("wrap" if subdomains == 1 else "plane")
    ref.step(5)
    m.dd.run_step(step, 5)
    np.testing.assert_array_equal(m.temperature(), ref.temperature())


def test_weak_scaled_size_matches():
    for base in (64, 100, 512):
        for n in (1, 2, 8, 27):
            assert weak_scaled_size(base, n) == j_weak_scaled_size(base, n)
