"""The port's halo exchange on 8 subdomains of one CPU device against the JAX
package's exchange on the fake 8-device mesh (tests/conftest.py).

Both domains load the reference's ripple field (test_exchange.cu:14-38) and
exchange once; the raw shell-carrying blocks must agree bitwise, halos,
edges and corners included.
"""

import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.geometry import ripple_field
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain, ShardView
from stencil_tpu_torch.ops.exchange import halo_exchange_shard
from stencil_tpu_torch.ops.stream_trace import run_kernel

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

_UNEVEN = {(1, 0, 0): 2, (-1, 0, 0): 1, (0, 1, 0): 1, (0, -1, 0): 3, (0, 0, 1): 0, (0, 0, -1): 2}

RADII = {
    "faces1": lambda R: R.constant(0).set_face(1),
    "uneven": lambda R: R.from_dict(_UNEVEN),
    "fec211": lambda R: R.face_edge_corner(2, 1, 1),
}


def _exchanged(size, radius_name, partition=None):
    field = ripple_field(Dim3(0, 0, 0), Dim3(*size))
    j = JDomain(*size)
    j.set_radius(RADII[radius_name](JRadius))
    jh = j.add_data("q")
    j.realize()
    j.set_quantity(jh, field)
    j.exchange()

    t = DistributedDomain(*size, device="cpu")
    t.set_radius(RADII[radius_name](Radius))
    t.set_subdomains(8)
    if partition is not None:
        t.set_partition(*partition)
    th = t.add_data("q")
    t.realize()
    assert tuple(t.grid_dim()) == tuple(j.placement.dim())
    t.set_quantity(th, field)
    t.exchange()
    return j.raw_to_host(jh), t.raw_to_host(th), t


@pytest.mark.parametrize("radius_name", sorted(RADII))
@pytest.mark.parametrize("size", [(16, 16, 16), (24, 16, 20)])
def test_exchange_bitwise_vs_jax_8_subdomains(size, radius_name):
    want, got, dd = _exchanged(size, radius_name)
    assert dd.num_subdomains() == 8
    np.testing.assert_array_equal(got, want)
    # the shell really was filled: every raw cell holds a ripple value
    assert np.isfinite(got).all() and (got != 0).mean() > 0.99


def test_size1_axis_wraps_onto_itself():
    """A grid axis of size 1 sends each subdomain its own slab: the periodic
    boundary inside one subdomain."""
    size = (8, 12, 10)
    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(Radius.constant(0).set_face(1))
    dd.set_partition(2, 1, 1)
    h = dd.add_data("q")
    dd.realize()
    field = ripple_field(Dim3(0, 0, 0), Dim3(*size))
    dd.set_quantity(h, field)
    dd.exchange()
    stack = dd.get_curr(h)  # (2, 1, 1, 6, 14, 12)
    np.testing.assert_array_equal(stack[0, 0, 0, 1:-1, 0, 1:-1].numpy(), field[0:4, -1, :])
    np.testing.assert_array_equal(stack[1, 0, 0, 1:-1, -1, 1:-1].numpy(), field[4:8, 0, :])
    np.testing.assert_array_equal(stack[0, 0, 0, 0, 1:-1, 1:-1].numpy(), field[7])


def test_exchange_rejects_uneven_sizes_naming_roadmap():
    """Uneven sizes are padded now (tests/test_torch_uneven.py); what is
    still refused is a remainder that does not fit one trailing subdomain,
    which the JAX package refuses too (its domain.py:492-503)."""
    dd = DistributedDomain(15, 16, 16, device="cpu")
    dd.set_radius(1)
    dd.set_subdomains(8)
    dd.add_data("q")
    dd.realize()
    assert dd.valid_last() == (7, None, None)
    empty = DistributedDomain(10, 8, 8, device="cpu")
    empty.set_radius(1)
    empty.set_partition(8, 1, 1)
    empty.add_data("q")
    with pytest.raises(ValueError, match="trailing subdomain"):
        empty.realize()
    # a padded axis on its own: the -x halo of subdomain 0 holds the last
    # valid plane (index 3 of subdomain 1), not its pad plane
    stack = torch.arange(2 * 6 * 3 * 3, dtype=torch.float32).view(2, 1, 1, 6, 3, 3)
    halo_exchange_shard(stack, Radius.constant(0).set_face(1), valid_last=(3, None, None))
    assert torch.equal(stack[0, 0, 0, 0, 1:2, 1:2], stack[1, 0, 0, 3, 1:2, 1:2])


def test_reference_loop_equals_make_step():
    """The reference-style loop (exchange, compute into the next slot, swap)
    gives what ``make_step`` + ``run_step`` give, when the loop evaluates the
    kernel with the engine's arithmetic (``run_kernel``: ``/ 6`` is a
    multiply by float32(1/6), as XLA compiles it)."""

    def mean6(views, info):
        s = views["q"]
        return {"q": (s.sh(1, 0, 0) + s.sh(-1, 0, 0) + s.sh(0, 1, 0)
                      + s.sh(0, -1, 0) + s.sh(0, 0, 1) + s.sh(0, 0, -1)) / 6}

    size = (8, 12, 16)
    field = ripple_field(Dim3(0, 0, 0), Dim3(*size))
    doms = []
    for _ in range(2):
        dd = DistributedDomain(*size, device="cpu")
        dd.set_radius(Radius.constant(0).set_face(1))
        dd.set_partition(2, 1, 2)
        h = dd.add_data("q")
        dd.realize()
        dd.set_quantity(h, field)
        doms.append((dd, h))
    (a, ha), (b, hb) = doms
    a.run_step(a.make_step(mean6), 2)
    for _ in range(2):
        b.exchange()
        lo, n = b.local_spec().radius.lo(), b.local_spec().sz
        region = tuple(slice(0, n[ax]) for ax in range(3))
        vals = run_kernel(mean6, {"q": ShardView(b.get_curr(hb), lo, region)})["q"]
        b.get_next(hb)[..., 1:-1, 1:-1, 1:-1] = vals
        b.swap()
    np.testing.assert_array_equal(a.quantity_to_host(ha), b.quantity_to_host(hb))
