"""The z-slab helpers of the wavefront route.

Counterpart of the slab helpers in ``stencil_tpu/ops/stream.py:1080-1135``
(only those; the user-kernel stream engine is ROADMAP.md queue 1 item 7).
The wavefront route keeps the z halo out of the big array: each subdomain's
z shell lives in a z-major ``(Xr, 2s, Yr)`` slab buffer, rows ``[0, s)`` its
low halo and ``[s, 2s)`` its high halo, which the kernel patches into every
plane and re-emits for the next macro step.  Here every buffer is a
``(px, py, pz, Xr, 2s, Yr)`` stack over the subdomain grid, and the JAX
package's ``ppermute`` is ``shift_from_low`` / ``shift_from_high`` along the
grid axis.  The JAX package leaves these to XLA, not to Pallas, so they are
plain torch.
"""

from __future__ import annotations

import torch

from stencil_tpu_torch.ops.exchange import shift_from_high, shift_from_low


def lane_pad_width(z: int) -> int:
    """Plane width rounded up to a 128 multiple.  The TPU route pads its
    z-slab planes so; the port's route does not (a Hopper row coalesces at
    any width), and keeps this for the kernel's ``z_valid`` tests."""
    return -(-z // 128) * 128


def prime_z_slabs(block: torch.Tensor, Zr: int, s: int) -> torch.Tensor:
    """The first outgoing z-slab buffer of a macro chain: the blocks'
    interior z-boundary columns, packed ``[(-z)-bound | (+z)-bound]`` and
    transposed z-major, ``(..., Xr, Yr, Zr) -> (..., Xr, 2s, Yr)``.  Every
    later slab buffer is kernel-emitted."""
    return torch.cat(
        [block[..., Zr - 2 * s : Zr - s].transpose(-1, -2), block[..., s : 2 * s].transpose(-1, -2)],
        dim=-2,
    ).contiguous()


def make_slab_extenders(Xr: int, Yr: int, s: int):
    """``(yext, xext)`` for ``(px, py, pz, Xr, s, Yr)`` slab stacks: after the
    z shift each slab takes rows from its y neighbours, then planes from its
    x neighbours, two hops that carry the xyz-corner cells from the diagonal
    subdomains, in the in-array exchange's sweep order.  Both return a new
    tensor."""

    def yext(S: torch.Tensor) -> torch.Tensor:
        lo_ = shift_from_low(S[..., Yr - 2 * s : Yr - s], 1)
        hi_ = shift_from_high(S[..., s : 2 * s], 1)
        S = S.clone()
        S[..., 0:s] = lo_
        S[..., Yr - s : Yr] = hi_
        return S

    def xext(S: torch.Tensor) -> torch.Tensor:
        lo_ = shift_from_low(S[..., Xr - 2 * s : Xr - s, :, :], 0)
        hi_ = shift_from_high(S[..., s : 2 * s, :, :], 0)
        S = S.clone()
        S[..., 0:s, :, :] = lo_
        S[..., Xr - s : Xr, :, :] = hi_
        return S

    return yext, xext


def permute_and_extend_z_slabs(zout: torch.Tensor, s: int, yext, xext) -> torch.Tensor:
    """One macro step's incoming z-slab stack from the previous one's
    outgoing stack ``(px, py, pz, Xr, 2s, Yr)``: shift the two direction
    halves along grid axis z, then extend each with y- and x-neighbour
    content (corner propagation)."""
    zlo = shift_from_low(zout[..., 0:s, :], 2)
    zhi = shift_from_high(zout[..., s : 2 * s, :], 2)
    return torch.cat([xext(yext(zlo)), xext(yext(zhi))], dim=-2)
