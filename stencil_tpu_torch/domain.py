"""``DistributedDomain``: the public orchestrator, on one device.

Counterpart of ``stencil_tpu/domain.py`` (reference include/stencil/
stencil.hpp:61, src/stencil.cu), with the same lifecycle: construct with a
global size, configure (``set_radius`` / ``add_data`` / ``set_partition`` /
``set_placement`` / ``set_methods``), ``realize()``, then iterate
``exchange()`` / compute / ``swap()`` or ``make_step`` + ``run_step``.

Storage: each quantity is ONE tensor of shape ``(px, py, pz, Xr, Yr, Zr)``: the
``px*py*pz`` subdomains of the grid, each the reference's shell-carrying
``LocalDomain`` allocation (``raw_size``), all on the one device.  The JAX
package's global raw array ``(px*Xr, py*Yr, pz*Zr)`` is the same data in
another order; ``set_raw`` / ``raw_to_host`` convert.

Uneven sizes are padded and masked as in the JAX package
(``stencil_tpu/domain.py:478-510``, the reference's partition.hpp:83-114):
every subdomain on an axis holds ``n = ceil(size / dim)`` interior cells and
the last one owns the remainder, ``valid_last`` valid cells followed by pad
cells; the exchange writes each +axis halo right after the valid cells.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.geometry import LocalSpec, shrink_by_radius
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.device import resolve_device
from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES, ValidLast, halo_exchange_multi, route_supported
from stencil_tpu_torch.ops.stream_trace import StreamKernel
from stencil_tpu_torch.parallel.mesh import SubdomainGrid, make_grid
from stencil_tpu_torch.utils.config import MethodFlags, PlacementStrategy


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


@dataclasses.dataclass(frozen=True)
class DataHandle:
    """Typed handle to a named quantity (reference local_domain.cuh:17-25)."""

    name: str
    dtype: torch.dtype
    components: tuple = ()


class ShardView:
    """Stencil-term access inside step kernels, over ALL subdomains at once.

    ``sh(dx, dy, dz)`` returns the region's cells shifted by the offset (the
    reference's ``src[o + Dim3(dx,dy,dz)]`` accessor, accessor.hpp:27-40) as a
    ``(px, py, pz, nx, ny, nz)`` view of the stack."""

    def __init__(self, stack: torch.Tensor, r_lo: Dim3, region: Tuple[slice, slice, slice]):
        self._stack = stack
        self._lo = r_lo
        self._region = region

    def sh(self, dx: int = 0, dy: int = 0, dz: int = 0) -> torch.Tensor:
        idx = tuple(
            slice(self._lo[ax] + s.start + d, self._lo[ax] + s.stop + d)
            for ax, s, d in zip(range(3), self._region, (dx, dy, dz))
        )
        return self._stack[(Ellipsis,) + idx]

    def center(self) -> torch.Tensor:
        return self.sh(0, 0, 0)


@dataclasses.dataclass
class BlockInfo:
    """Per-step context handed to step kernels.  ``origin`` holds each
    subdomain's interior start per axis, shaped to broadcast over the
    ``(px, py, pz, ...)`` stack dims."""

    origin: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    interior: Dim3
    global_size: Dim3
    radius: Radius
    region: Tuple[slice, slice, slice]

    def coords(self):
        """Global (x, y, z) coordinate tensors for the region, broadcastable
        to ``(px, py, pz, nx, ny, nz)``, wrapped periodically."""
        out = []
        for ax in range(3):
            s = self.region[ax]
            shape = [1] * 6
            shape[3 + ax] = -1
            local = torch.arange(s.start, s.stop, device=self.origin[ax].device).view(shape)
            out.append((self.origin[ax] + local) % self.global_size[ax])
        return tuple(out)


#: a step kernel: (views, info) -> {name: new values for info.region}
StepKernel = Callable[[Dict[str, ShardView], BlockInfo], Dict[str, torch.Tensor]]


class DistributedDomain:
    def __init__(self, x: int, y: int, z: int, device="cuda"):
        self.device = resolve_device(device)
        self._size = Dim3(x, y, z)
        self._radius = Radius.constant(0)
        self._handles: List[DataHandle] = []
        self._methods = MethodFlags.All
        self._strategy = PlacementStrategy.NodeAware
        self._subdomains = 1
        self._force_dim: Optional[Dim3] = None
        self._halo_mult = 1
        self._exchange_route_req: Optional[str] = None
        self._exchange_route = "direct"
        self._realized = False
        self._shell_stale = False
        self.grid: Optional[SubdomainGrid] = None
        self._spec: Optional[LocalSpec] = None
        self._shell_radius: Optional[Radius] = None
        self._valid_last: ValidLast = (None, None, None)
        self._curr: Dict[str, torch.Tensor] = {}
        self._next: Dict[str, torch.Tensor] = {}

    # --- configuration (stencil.hpp:276-306) ---------------------------------
    def set_radius(self, radius) -> None:
        self._radius = Radius.constant(radius) if isinstance(radius, int) else radius

    def radius(self) -> Radius:
        return self._radius

    def add_data(self, name: str, dtype=torch.float32, components=()) -> DataHandle:
        if tuple(components):
            raise NotImplementedError(
                "component (N-D) quantities are not ported yet (ROADMAP.md queue 1 item 3)"
            )
        h = DataHandle(name, torch_dtype(dtype))
        self._handles.append(h)
        return h

    def set_methods(self, methods: MethodFlags) -> None:
        self._methods = methods

    def set_placement(self, strategy: PlacementStrategy) -> None:
        self._strategy = strategy

    def set_subdomains(self, n: int) -> None:
        """The subdomain count the grid is derived from (the JAX package's
        device count, ``set_devices``)."""
        assert not self._realized
        self._subdomains = int(n)

    def set_partition(self, px: int, py: int, pz: int) -> None:
        """Fix the subdomain grid instead of deriving it (manual partition,
        the reference's future-work item, README.md:157-176)."""
        assert not self._realized
        self._force_dim = Dim3(px, py, pz)

    def set_halo_multiplier(self, k: int) -> None:
        """Allocate ``k * radius``-wide shells and run ``k`` compute sub-steps
        per exchange (the reference's future-work item, README.md:157-176).
        A step built by ``make_step`` then advances ``k`` iterations per
        call."""
        assert k >= 1
        assert not self._realized, "set_halo_multiplier must precede realize()"
        self._halo_mult = int(k)

    def halo_multiplier(self) -> int:
        return self._halo_mult

    def set_exchange_route(self, route: Optional[str]) -> None:
        """Pin the y/z-sweep exchange route (``ops/exchange.py``
        ``EXCHANGE_ROUTES``); ``None``/"auto" clears the request, and
        ``realize()`` then resolves ``direct``.  A pinned route degrades to
        ``direct`` at ``realize()`` when none of its packed sweeps can engage
        (``route_supported``)."""
        if route in (None, "auto"):
            self._exchange_route_req = None
            return
        if route not in EXCHANGE_ROUTES:
            raise ValueError(f"unknown exchange route {route!r} (one of {EXCHANGE_ROUTES})")
        assert not self._realized, "set_exchange_route must precede realize()"
        self._exchange_route_req = route

    def exchange_route(self) -> str:
        """The resolved y/z-sweep route (meaningful after ``realize()``)."""
        return self._exchange_route

    def _resolve_exchange_route(self) -> str:
        """The explicit request, else the static ``direct``
        (``stencil_tpu/domain.py:809-863`` without its environment variable
        and tune cache); a route none of whose packed sweeps can engage here
        (uneven packed axes, a dtype the kernels do not take) degrades to
        ``direct`` with a warning."""
        route = self._exchange_route_req or "direct"
        if not route_supported(route, [self.field_dtype(h) for h in self._handles], self._valid_last):
            warnings.warn(
                f"exchange route {route!r} cannot engage here (uneven packed axes or unsupported "
                "dtype); degrading to 'direct'",
                RuntimeWarning,
                stacklevel=3,
            )
            route = "direct"
        return route

    def set_storage(self, storage: str) -> None:
        if storage != "native":
            raise NotImplementedError(
                f"storage dtype {storage!r} is not ported yet (ROADMAP.md queue 1 item 9)"
            )

    def size(self) -> Dim3:
        return self._size

    def field_dtype(self, h: DataHandle) -> torch.dtype:
        """The storage dtype of ``h``'s buffers: its own dtype (only native
        storage is ported, ROADMAP.md queue 1 item 9)."""
        return h.dtype

    # --- realize (src/stencil.cu:27-539) -------------------------------------
    def planned_grid(self) -> SubdomainGrid:
        """The subdomain grid ``realize()`` builds from the configuration so
        far; callers that size things before ``realize()`` ask here."""
        return make_grid(self._size, self._radius, self._subdomains, self._strategy, self._force_dim)

    def realize(self) -> None:
        self._radius.validate()
        if self._methods in (MethodFlags.AllGather, MethodFlags.RollCompare):
            raise NotImplementedError(
                f"exchange method {self._methods} is not ported yet (ROADMAP.md queue 1 item 3)"
            )
        self.grid = self.planned_grid()
        dim = self.grid.dim()
        # uneven sizes: pad each axis to ceil(size/dim); the LAST subdomain
        # on a padded axis owns size - (dim-1)*n valid cells
        n = Dim3(*(-(-self._size[ax] // dim[ax]) for ax in range(3)))
        vlast = [self._size[ax] - (dim[ax] - 1) * n[ax] for ax in range(3)]
        valid_last = tuple(None if v == n[ax] else v for ax, v in enumerate(vlast))
        if min(vlast) <= 0:
            # the remainder must fit ONE trailing subdomain; the reference
            # spreads +-1-cell remainders instead, which has no equal-block
            # analog (stencil_tpu/domain.py:492-503)
            raise ValueError(
                f"axis remainder does not fit in one trailing subdomain: size {self._size} over "
                f"grid {dim} gives last-subdomain valid cells {valid_last}; choose a grid with "
                "(dim-1)*ceil(size/dim) < size"
            )
        r = self._radius.scaled(self._halo_mult)
        max_r = max(*r.lo(), *r.hi())
        if min(n) < max_r or min(vlast) < max_r:
            raise ValueError(f"subdomain {n} (last-subdomain valid {valid_last}) smaller than radius shell")
        self._valid_last = valid_last
        self._exchange_route = self._resolve_exchange_route()
        self._shell_radius = r
        self._spec = LocalSpec.make(n, Dim3(0, 0, 0), r)
        shape = dim.tuple() + self._spec.raw_size().tuple()
        for h in self._handles:
            self._curr[h.name] = torch.zeros(shape, dtype=h.dtype, device=self.device)
            self._next[h.name] = torch.zeros(shape, dtype=h.dtype, device=self.device)
        self._realized = True

    # --- geometry accessors ---------------------------------------------------
    def local_spec(self) -> LocalSpec:
        return self._spec

    def shell_radius(self) -> Radius:
        """The allocated shell: the radius scaled by the halo multiplier."""
        return self._shell_radius

    def num_subdomains(self) -> int:
        return self.grid.count()

    def grid_dim(self) -> Dim3:
        return self.grid.dim()

    def valid_last(self) -> ValidLast:
        """Valid cells of the last subdomain per axis; None where the axis
        divides evenly."""
        return self._valid_last

    def padded(self) -> bool:
        return any(v is not None for v in self._valid_last)

    def shard_valid(self, idx) -> Dim3:
        """Valid (unpadded) interior extent of the subdomain at grid index
        ``idx``: the last one on a padded axis owns the remainder."""
        dim, n = self.grid.dim(), self._spec.sz
        return Dim3(*(
            self._valid_last[ax] if idx[ax] == dim[ax] - 1 and self._valid_last[ax] is not None else n[ax]
            for ax in range(3)
        ))

    def origins(self) -> torch.Tensor:
        """``(n, 3)`` int32 global interior starts, one row per subdomain in
        stack order (x index slowest, as the stack's leading dims)."""
        dim = self.grid.dim()
        n = self._spec.sz
        idx = torch.stack(
            torch.meshgrid(*(torch.arange(d) for d in dim), indexing="ij"), dim=-1
        ).reshape(-1, 3)
        return (idx * torch.tensor(n.tuple())).to(torch.int32).to(self.device)

    def _origin_views(self) -> Tuple[torch.Tensor, ...]:
        dim = self.grid.dim()
        out = []
        for ax in range(3):
            shape = [1] * 6
            shape[ax] = -1
            out.append((torch.arange(dim[ax], device=self.device) * self._spec.sz[ax]).view(shape))
        return tuple(out)

    # --- data movement --------------------------------------------------------
    def _interior_view(self, stack: torch.Tensor) -> torch.Tensor:
        lo, n = self._shell_radius.lo(), self._spec.sz
        return stack[..., lo.x : lo.x + n.x, lo.y : lo.y + n.y, lo.z : lo.z + n.z]

    def set_quantity(self, h: DataHandle, interior: np.ndarray) -> None:
        """Load a full (X, Y, Z) user-domain array into a quantity's valid
        interior cells; the shell and the pad cells of uneven sizes are zeroed,
        as the JAX package's ``_to_raw_global`` leaves them."""
        if tuple(interior.shape) != self._size.tuple():
            raise ValueError(f"interior shape {interior.shape}, want {self._size.tuple()}")
        dim, n = self.grid.dim(), self._spec.sz
        padded = torch.zeros((dim * n).tuple(), dtype=h.dtype)
        X, Y, Z = self._size.tuple()
        padded[:X, :Y, :Z] = torch.tensor(np.asarray(interior)).to(h.dtype)
        blocks = padded.reshape(dim.x, n.x, dim.y, n.y, dim.z, n.z).permute(0, 2, 4, 1, 3, 5)
        stack = self._curr[h.name]
        stack.zero_()
        self._interior_view(stack).copy_(blocks.to(self.device))

    def quantity_to_host(self, h: DataHandle) -> np.ndarray:
        """Gather a quantity's valid interior cells to a (X, Y, Z) host array
        (reference quantity_to_host, local_domain.cuh:329-346)."""
        inner = self._interior_view(self._curr[h.name])
        dim, n = self.grid.dim(), self._spec.sz
        out = inner.permute(0, 3, 1, 4, 2, 5).reshape((dim * n).tuple())
        X, Y, Z = self._size.tuple()
        # a copy even on the CPU, where reshape may return a view of the
        # live storage that the next step overwrites
        return out[:X, :Y, :Z].to("cpu", copy=True).numpy()

    def mark_shell_stale(self) -> None:
        """Steps that skip the shell (the single-subdomain wrap route) leave
        it holding whatever the last exchange wrote; raw readback then
        re-exchanges first (``quantity_to_host`` reads interiors only)."""
        self._shell_stale = True

    def raw_to_host(self, h: DataHandle) -> np.ndarray:
        """The JAX package's raw shell-carrying global array
        ``(px*Xr, py*Yr, pz*Zr)``, halos visible.  A stale shell is refreshed
        with one exchange first."""
        if self._shell_stale:
            self.exchange()
        stack = self._curr[h.name]
        px, py, pz, X, Y, Z = stack.shape
        return stack.permute(0, 3, 1, 4, 2, 5).reshape(px * X, py * Y, pz * Z).to("cpu", copy=True).numpy()

    def set_raw(self, h: DataHandle, raw: np.ndarray) -> None:
        """Load the JAX package's raw global array ``(px*Xr, py*Yr, pz*Zr)``
        (halos included) into a quantity's stack."""
        stack = self._curr[h.name]
        px, py, pz, X, Y, Z = stack.shape
        if tuple(raw.shape) != (px * X, py * Y, pz * Z):
            raise ValueError(f"raw shape {raw.shape}, want {(px * X, py * Y, pz * Z)}")
        src = torch.tensor(np.asarray(raw)).to(h.dtype)
        stack.copy_(src.reshape(px, X, py, Y, pz, Z).permute(0, 2, 4, 1, 3, 5).to(self.device))
        self._shell_stale = False

    def init_by_coords(self, h: DataHandle, fn) -> None:
        """Fill the interior with ``fn(cx, cy, cz)``, which maps broadcastable
        global coordinate tensors (``(px,1,1,nx,1,1)``-shaped and so on) to
        values.  Pad cells of uneven sizes get ``fn`` of their unwrapped
        coordinates (``>= size``), as in the JAX package."""
        coords = []
        for ax, origin in enumerate(self._origin_views()):
            shape = [1] * 6
            shape[3 + ax] = -1
            coords.append(origin + torch.arange(self._spec.sz[ax], device=self.device).view(shape))
        target = self._interior_view(self._curr[h.name])
        vals = torch.as_tensor(fn(*coords), device=self.device)
        target.copy_(vals.to(h.dtype).expand(target.shape))

    # --- the hot path ---------------------------------------------------------
    def exchange(self) -> None:
        """Fill every quantity's halo shell (src/stencil.cu:670-864)."""
        assert self._realized
        halo_exchange_multi([self._curr[h.name] for h in self._handles], self._shell_radius,
                            self._valid_last, route=self._exchange_route)
        self._shell_stale = False

    def swap(self) -> None:
        """Swap curr/next slots (src/stencil.cu:541-561)."""
        self._curr, self._next = self._next, self._curr

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_curr(self, h: DataHandle) -> torch.Tensor:
        """The ``(px, py, pz, Xr, Yr, Zr)`` storage of ``h``'s current slot."""
        return self._curr[h.name]

    def get_next(self, h: DataHandle) -> torch.Tensor:
        return self._next[h.name]

    def make_step(
        self,
        kernel: StepKernel,
        overlap: bool = True,
        engine: str = "torch",
        x_radius: int = None,
        stream_path: str = "auto",
        separable: bool = False,
        stream_depth: int = None,
        stream_overlap: str = "auto",
        stream_halo: str = "auto",
        compute_unit: str = "auto",
        mxu_input: str = "auto",
        mxu_kernel=None,
        stream_z_slabs: bool = None,
    ):
        """Build ``step(curr, steps) -> curr`` fusing exchange + compute (the
        JAX package's ``make_step``, domain.py:1411).

        ``engine="torch"`` (the JAX package's ``"xla"``): each step exchanges
        (through ``exchange_route()``), then evaluates ``kernel`` over every
        subdomain's interior at once and writes the result back in place.
        The kernel is traced once (``ops/stream_trace.py``) and evaluated
        with torch on the shifted slices, so its arithmetic is the stream
        engine's and XLA's: a division by a Python number is a multiply by
        its float32 reciprocal.
        With a halo multiplier ``k`` each step is a MACRO step: one exchange
        of the ``k*r``-wide shells, then ``k`` sub-steps over regions that
        shrink by the user radius from the whole shell down to the interior,
        so ``step(curr, s)`` advances ``s*k`` iterations.  ``overlap`` is
        accepted and computes the same cells: the two-stream
        interior/exterior split is ROADMAP.md queue 1 item 8.

        ``engine="stream"``: the plane-streaming engine
        (``ops/stream.make_stream_step``) with the hand-written CUDA stream
        kernels: ``wrap`` on one subdomain, the temporally blocked
        ``wavefront`` when a uniform shell >= 2 allows it, ``plane``
        otherwise; ``x_radius`` (default the largest user radius) bounds the
        kernel's shifts, ``stream_path``/``separable``/``stream_depth`` and
        the axis arguments as in ``make_stream_step`` (``stream_z_slabs``
        is its ``z_slabs``).  A stream step counts RAW iterations."""
        assert self._realized
        if engine == "stream":
            from stencil_tpu_torch.ops.stream import make_stream_step

            if x_radius is None:
                x_radius = max(*self._radius.lo(), *self._radius.hi())
            return make_stream_step(
                self, kernel, x_radius=x_radius, path=stream_path, separable=separable,
                max_depth=stream_depth, overlap=stream_overlap, halo=stream_halo,
                compute_unit=compute_unit, mxu_input=mxu_input, mxu_kernel=mxu_kernel,
                z_slabs=stream_z_slabs,
            )
        if engine != "torch":
            raise ValueError(f"unknown engine {engine!r}")
        del overlap
        n = self._spec.sz
        shell = self._shell_radius
        lo = shell.lo()
        names = [h.name for h in self._handles]
        route = self._exchange_route
        # sub-step regions in interior-local coords: the whole shell is valid
        # after the exchange and each sub-step shrinks it by the user radius,
        # landing on the interior after the last one (domain.py:1553-1569 of
        # the JAX package); multiplier 1 gives the interior alone
        rect = Rect3(Dim3(0, 0, 0) - lo, n + shell.hi())
        subs = []
        for _ in range(self._halo_mult):
            rect = shrink_by_radius(rect, self._radius)
            region = tuple(slice(rect.lo[ax], rect.hi[ax]) for ax in range(3))
            info = BlockInfo(self._origin_views(), n, self._size, self._radius, region)
            static = {"interior": info.interior, "radius": info.radius, "region": info.region}
            subs.append((info, StreamKernel(kernel, names, None, self._size, static)))

        def step(curr: Dict[str, torch.Tensor], steps: int = 1) -> Dict[str, torch.Tensor]:
            for _ in range(steps):
                stacks = halo_exchange_multi([curr[k] for k in names], shell, self._valid_last, route=route)
                for info, sk in subs:
                    views = [ShardView(b, lo, info.region) for b in stacks]
                    # all values computed before any write
                    vals = sk.evaluate(lambda q, dx, dy, dz: views[q].sh(dx, dy, dz), info.coords,
                                       self.device)
                    for view, v, written in zip(views, vals, sk.updates()):
                        if written:
                            view.center().copy_(v)
            return curr

        return step

    def run_step(self, step_fn, steps: int = 1) -> None:
        """Apply a built step to curr and make its output the new curr."""
        self._curr = step_fn(self._curr, steps)
        if getattr(step_fn, "_marks_shell_stale", False):
            self.mark_shell_stale()
