"""7-point Jacobi heat stencil with hot/cold sphere forcing.

Counterpart of ``stencil_tpu/models/jacobi.py`` (reference bin/jacobi3d.cu):
one f32 quantity, radius-1 faces, whole domain initialised to (HOT+COLD)/2, a
hot sphere (radius X/10) at (X/3, Y/2, Z/2) clamped to HOT and a cold one at
(2X/3, Y/2, Z/2) clamped to COLD each step, elsewhere the mean of the six
face neighbours; periodic.

Engines (``kernel_impl``):

* ``"torch"``, the counterpart of ``"jnp"``: ``make_step(self._kernel)``,
  plain tensor code over every subdomain at once.
* ``"cuda"``, the counterpart of ``"pallas"``, through the hand-written
  kernels.  ``pallas_path="auto"`` picks ``wrap`` for one subdomain (slice out
  the interior, ``jacobi_wrap_step``, write back; the shell goes stale) and
  ``shell`` otherwise (exchange with ``blend_slab`` halo writes, then
  ``jacobi_plane_step`` on all subdomains in one launch, every iteration).

The two engines sum the neighbours in different orders (``_kernel``: x+1,
x-1, y+1, y-1, z+1, z-1; the kernels: x-1, x+1, y-1, y+1, z-1, z+1), so they
agree to about 1 ulp per level, not bitwise; the ``wrap`` and ``shell``
routes share an order and agree bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.ops.exchange import halo_exchange_shard
from stencil_tpu_torch.ops.jacobi_kernels import (
    SIXTH,
    choose_temporal_k,
    jacobi_plane_step,
    jacobi_wrap_step,
    yz_dist2_plane,
)
from stencil_tpu_torch.utils.config import MethodFlags, PlacementStrategy

COLD_TEMP = 0.0
HOT_TEMP = 1.0

_PATH_ROADMAP = {
    "wavefront": "the temporally blocked wavefront route is the next port slice (ROADMAP.md queue 1 item 6)",
    "slab": "the slab route (jacobi_slab_step) is not ported yet (ROADMAP.md queue 1 item 6)",
}


class Jacobi3D:
    def __init__(
        self,
        x: int,
        y: int,
        z: int,
        overlap: bool = True,
        strategy: PlacementStrategy = PlacementStrategy.NodeAware,
        methods: MethodFlags = MethodFlags.All,
        subdomains: int = 1,  # the JAX package's device count
        dtype=torch.float32,
        kernel_impl: str = "torch",  # "torch" (plain tensors) | "cuda" (kernels)
        temporal_k="auto",  # wrap-route levels per call (int | "auto")
        pallas_path: str = "auto",  # "auto" | "wrap" | "shell"
        compute_unit: str = None,  # only the vpu form is ported
        storage_dtype: str = None,  # only native storage is ported
        device="cuda",
    ):
        self.dd = DistributedDomain(x, y, z, device=device)
        # radius 1 on faces only (jacobi3d.cu:205-214)
        radius = Radius.constant(0)
        radius.set_face(1)
        self.dd.set_radius(radius)
        self.dd.set_methods(methods)
        self.dd.set_placement(strategy)
        self.dd.set_subdomains(subdomains)
        self.h = self.dd.add_data("temp", dtype=dtype)
        if kernel_impl not in ("torch", "cuda"):
            raise ValueError(f"unknown kernel_impl {kernel_impl!r} (torch | cuda)")
        if pallas_path in _PATH_ROADMAP:
            raise NotImplementedError(f"pallas_path={pallas_path!r}: {_PATH_ROADMAP[pallas_path]}")
        if pallas_path not in ("auto", "wrap", "shell"):
            raise ValueError(f"unknown pallas_path {pallas_path!r}")
        if compute_unit not in (None, "auto", "vpu"):
            raise NotImplementedError(
                f"compute_unit={compute_unit!r} is not ported yet (ROADMAP.md queue 1 item 9)"
            )
        if storage_dtype not in (None, "auto", "native"):
            raise NotImplementedError(
                f"storage_dtype={storage_dtype!r} is not ported yet (ROADMAP.md queue 1 item 9)"
            )
        if kernel_impl == "cuda" and self.h.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA kernels take float32 fields, got {self.h.dtype} (ROADMAP.md queue 1 item 9)"
            )
        self.overlap = overlap
        self.kernel_impl = kernel_impl
        self.temporal_k = temporal_k
        self.pallas_path_request = pallas_path
        self._step = None
        # which route realize() picked: "wrap" | "shell" (None on the torch engine)
        self._pallas_path = None

    def realize(self) -> None:
        self.dd.realize()
        # set compute region to (HOT+COLD)/2 (jacobi3d.cu:15-29, 253-263)
        mid = (HOT_TEMP + COLD_TEMP) / 2
        self.dd.init_by_coords(self.h, lambda x, y, z: torch.full((), mid) + 0 * (x + y + z))
        if self.kernel_impl == "cuda":
            self._step = self._make_cuda_step()
        else:
            self._step = self.dd.make_step(self._kernel, overlap=self.overlap)

    def _make_cuda_step(self):
        dd = self.dd
        want = self.pallas_path_request
        single = dd.num_subdomains() == 1
        if want == "wrap" and not single:
            raise ValueError("pallas_path='wrap' requires a single subdomain")
        n = dd.local_spec().sz
        lo = dd._shell_radius.lo()
        name = self.h.name
        if want == "wrap" or (want == "auto" and single):
            self._pallas_path = "wrap"
            k = choose_temporal_k(n.tuple(), self.temporal_k)

            def wrap_step(curr, steps: int = 1):
                interior = curr[name][0, 0, 0, lo.x : lo.x + n.x, lo.y : lo.y + n.y, lo.z : lo.z + n.z]
                block = interior.contiguous()
                # each level's arithmetic is the same whatever the split into
                # calls, so (blocked, remainder) is bitwise equal to k=1 calls
                blocked, rem = divmod(steps, k)
                for _ in range(blocked):
                    block = jacobi_wrap_step(block, k)
                if rem:
                    block = jacobi_wrap_step(block, rem)
                interior.copy_(block)
                return curr

            wrap_step._marks_shell_stale = True
            return wrap_step

        self._pallas_path = "shell"
        shell = dd._shell_radius
        gsize = dd.size().tuple()
        origins = dd.origins()
        yz_d2 = torch.stack(
            [yz_dist2_plane(int(o[1]), int(o[2]), (n.y, n.z), gsize, dd.device) for o in origins.cpu()]
        )
        spare = {}

        def shell_step(curr, steps: int = 1):
            stack = curr[name]
            out = spare.pop(name, None)
            if out is None:
                out = torch.empty_like(stack)
            for _ in range(steps):
                halo_exchange_shard(stack, shell)
                blocks = stack.view(-1, *stack.shape[3:])
                jacobi_plane_step(blocks, origins, yz_d2, gsize, out=out.view(blocks.shape))
                stack, out = out, stack
            spare[name] = out
            curr[name] = stack
            return curr

        return shell_step

    def _kernel(self, views, info):
        size = info.global_size
        hot_c = Dim3(size.x // 3, size.y // 2, size.z // 2)
        cold_c = Dim3(size.x * 2 // 3, size.y // 2, size.z // 2)
        sphere_r = size.x // 10

        src = views["temp"]
        # the JAX source divides by 6.0, which XLA compiles as a multiply by
        # float32(1/6); SIXTH is that constant, so this matches it bitwise
        val = (
            src.sh(1, 0, 0)
            + src.sh(-1, 0, 0)
            + src.sh(0, 1, 0)
            + src.sh(0, -1, 0)
            + src.sh(0, 0, 1)
            + src.sh(0, 0, -1)
        ) * SIXTH

        cx, cy, cz = info.coords()

        def dist2(c: Dim3):
            return (cx - c.x) ** 2 + (cy - c.y) ** 2 + (cz - c.z) ** 2

        # floor(sqrtf(d2)) <= r  is exactly  d2 < (r+1)^2 at these magnitudes
        # (jacobi3d.cu:31-33; see the JAX package's models/jacobi.py)
        in_r2 = (sphere_r + 1) ** 2
        val = torch.where(dist2(hot_c) < in_r2, HOT_TEMP, val)
        val = torch.where(dist2(cold_c) < in_r2, COLD_TEMP, val)
        return {"temp": val.to(src.center().dtype)}

    def step(self, steps: int = 1) -> None:
        """Advance ``steps`` iterations."""
        self.dd.run_step(self._step, steps)

    def temperature(self) -> np.ndarray:
        return self.dd.quantity_to_host(self.h)

    def block_until_ready(self) -> None:
        self.dd.block_until_ready()


def weak_scaled_size(base: int, num_subdomains: int) -> int:
    """jacobi3d.cu:167-169: scale each axis by numSubdoms^(1/3), rounded."""
    return int(float(base) * float(num_subdomains) ** 0.33333 + 0.5)


def to_torch_state(raw_global: np.ndarray, dd: DistributedDomain, h=None) -> None:
    """Carry a JAX domain's state into the port: ``raw_global`` is the JAX
    package's raw shell-carrying global array ``(px*Xr, py*Yr, pz*Zr)`` as
    numpy (``raw_to_host``), loaded into ``dd``'s storage for quantity ``h``
    (default: the only one).  The field is this system's whole state."""
    h = h if h is not None else _only_handle(dd)
    dd.set_raw(h, np.asarray(raw_global))


def to_jax_state(dd: DistributedDomain, h=None) -> np.ndarray:
    """The port's state as the JAX package's raw global array (a stale shell
    is refreshed first, as the JAX ``raw_to_host`` does)."""
    return dd.raw_to_host(h if h is not None else _only_handle(dd))


def _only_handle(dd: DistributedDomain):
    if len(dd._handles) != 1:
        raise ValueError(f"name the quantity: the domain holds {len(dd._handles)}")
    return dd._handles[0]
