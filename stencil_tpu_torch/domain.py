"""``DistributedDomain``: the public orchestrator, on one device.

Counterpart of ``stencil_tpu/domain.py`` (reference include/stencil/
stencil.hpp:61, src/stencil.cu), with the same lifecycle: construct with a
global size, configure (``set_radius`` / ``add_data`` / ``set_partition`` /
``set_placement`` / ``set_methods``), ``realize()``, then iterate
``exchange()`` / compute / ``swap()`` or ``make_step`` + ``run_step``.

Storage: each quantity is ONE tensor of shape ``(*components, px, py, pz, Xr,
Yr, Zr)``: the ``px*py*pz`` subdomains of the grid, each the reference's
shell-carrying ``LocalDomain`` allocation (``raw_size``), all on the one
device.  ``components`` are a quantity's leading per-cell dims (N-D data, the
reference's future-work item, README.md:157-176): none for a scalar, ``(3,)``
for a vector.  They lead, as in the JAX array ``(*components, gX, gY, gZ)``,
so every grid and cell dim is addressed from the right and the 6-D
coordinate tensors of ``BlockInfo.coords`` broadcast over them.  The JAX
package's global raw array ``(*components, px*Xr, py*Yr, pz*Zr)`` is the same
data in another order; ``set_raw`` / ``raw_to_host`` convert.

Uneven sizes are padded and masked as in the JAX package
(``stencil_tpu/domain.py:478-510``, the reference's partition.hpp:83-114):
every subdomain on an axis holds ``n = ceil(size / dim)`` interior cells and
the last one owns the remainder, ``valid_last`` valid cells followed by pad
cells; the exchange writes each +axis halo right after the valid cells.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.geometry import (
    LocalSpec, exterior_of, shrink_by_radius, sweep_hop_bytes, exchange_bytes,
)
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.device import resolve_device
from stencil_tpu_torch.ops.captured import Loop, as_step
from stencil_tpu_torch.ops.exchange import (
    EXCHANGE_ROUTES, ValidLast, halo_exchange_multi, make_exchange_fn_allgather,
    make_exchange_fn_rollcompare, overlapped, route_supported, side_stream,
)
from stencil_tpu_torch.ops.stream_trace import StreamKernel
from stencil_tpu_torch.parallel.mesh import SubdomainGrid, make_grid
from stencil_tpu_torch.utils.config import MethodFlags, PlacementStrategy
from stencil_tpu_torch.utils.logging import log_info

#: the grid axes' names, as the JAX package names its mesh axes
GRID_AXES = ("x", "y", "z")
#: the debug oracles' makers (``MethodFlags`` debug set, stencil.hpp:29-41)
_ORACLES = {
    MethodFlags.AllGather: make_exchange_fn_allgather,
    MethodFlags.RollCompare: make_exchange_fn_rollcompare,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


@dataclasses.dataclass(frozen=True)
class DataHandle:
    """Typed handle to a named quantity (reference local_domain.cuh:17-25).
    ``components`` are the leading per-cell dims: a ``(3,)`` quantity holds
    a vector per cell."""

    name: str
    dtype: torch.dtype
    components: tuple = ()

    def cell_count(self) -> int:
        """Values per cell: the product of the components."""
        return math.prod(self.components)


class ShardView:
    """Stencil-term access inside step kernels, over ALL subdomains at once.

    ``sh(dx, dy, dz)`` returns the region's cells shifted by the offset (the
    reference's ``src[o + Dim3(dx,dy,dz)]`` accessor, accessor.hpp:27-40) as a
    ``(*components, px, py, pz, nx, ny, nz)`` view of the stack."""

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
        self._storage = "native"
        self._realized = False
        self._shell_stale = False
        self.grid: Optional[SubdomainGrid] = None
        self._spec: Optional[LocalSpec] = None
        self._shell_radius: Optional[Radius] = None
        self._valid_last: ValidLast = (None, None, None)
        self._curr: Dict[str, torch.Tensor] = {}
        self._next: Dict[str, torch.Tensor] = {}
        self._capture = False
        self._exchange_loop = None
        self._exchange_fn = None

    # --- configuration (stencil.hpp:276-306) ---------------------------------
    def set_radius(self, radius) -> None:
        self._radius = Radius.constant(radius) if isinstance(radius, int) else radius

    def radius(self) -> Radius:
        return self._radius

    def add_data(self, name: str, dtype=torch.float32, components=()) -> DataHandle:
        """A quantity of ``dtype``, one value per cell, or a
        ``components``-shaped array per cell (``(3,)``: a vector)."""
        components = tuple(int(c) for c in components)
        if any(c < 1 for c in components):
            raise ValueError(f"components must be positive, got {components}")
        h = DataHandle(name, torch_dtype(dtype), components)
        self._handles.append(h)
        return h

    def set_methods(self, methods: MethodFlags) -> None:
        """The exchange method: the default transport, or one of the debug
        oracles ``MethodFlags.AllGather`` / ``RollCompare``, which
        ``exchange()`` and ``exchange_many()`` then run (even sizes and
        scalar quantities only; ``make_step`` keeps the sweeps)."""
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
        """Pin the fields' STORAGE dtype axis (``"native"`` | ``"bf16"``,
        ``ops/jacobi_kernels.py`` ``STORAGE_DTYPES``; ``stencil_tpu/domain.py:
        384-404``) before ``realize()``.  The models resolve the axis
        (``resolve_storage_dtype``) and hand the result here.  Under ``bf16``
        every f32 field is allocated as bfloat16, so every exchange route
        moves 2-byte cells; the Jacobi kernels accumulate at f32 and round
        once a pass (``f32_accumulate``), as do the stream kernels' bf16
        builds (levels at f32, one rounding a pass), and readback upcasts to
        the native dtype."""
        from stencil_tpu_torch.ops.jacobi_kernels import STORAGE_DTYPES

        if storage not in STORAGE_DTYPES:
            raise ValueError(f"unknown storage dtype {storage!r} (one of {STORAGE_DTYPES})")
        assert not self._realized, "set_storage must precede realize()"
        self._storage = storage

    def storage_dtype(self) -> str:
        """The storage axis: ``"native"`` or ``"bf16"``."""
        return self._storage

    def size(self) -> Dim3:
        return self._size

    def field_dtype(self, h: DataHandle) -> torch.dtype:
        """The dtype ``h``'s buffers store: bfloat16 for an f32 field under
        the bf16 storage axis, the field's own dtype otherwise
        (``stencil_tpu/domain.py:410-416``)."""
        if self._storage == "bf16" and h.dtype == torch.float32:
            return torch.bfloat16
        return h.dtype

    # --- realize (src/stencil.cu:27-539) -------------------------------------
    def planned_grid(self) -> SubdomainGrid:
        """The subdomain grid ``realize()`` builds from the configuration so
        far; callers that size things before ``realize()`` ask here."""
        return make_grid(self._size, self._radius, self._subdomains, self._strategy, self._force_dim)

    def realize(self) -> None:
        self._radius.validate()
        if self._storage == "bf16":
            # the JAX package's gate (stencil_tpu/domain.py:519-534): the
            # f32-accumulate passes upcast every quantity alike, so a domain
            # with any non-f32 field keeps native storage whole
            from stencil_tpu_torch.ops.jacobi_kernels import bf16_supported

            if not bf16_supported([h.dtype for h in self._handles]):
                warnings.warn(
                    f"storage bf16 cannot engage: fields are {[str(h.dtype) for h in self._handles]}, "
                    "not all float32; degrading to native storage",
                    RuntimeWarning,
                    stacklevel=2,
                )
                self._storage = "native"
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
        self._shell_radius = r
        self._spec = LocalSpec.make(n, Dim3(0, 0, 0), r)
        oracle = _ORACLES.get(self._methods)
        if oracle is not None:
            # the debug oracles (stencil_tpu/domain.py:563-583): even sizes
            # and scalar quantities only; they have no packed route
            if self.padded():
                raise ValueError("debug exchange methods require even sizes")
            if any(h.components for h in self._handles):
                raise ValueError("debug exchange methods support scalar quantities only")
            self._exchange_route = "direct"
            self._exchange_fn = oracle(r, self._spec, dim)
        else:
            route = self._exchange_route = self._resolve_exchange_route()
            self._exchange_fn = lambda stacks: halo_exchange_multi(stacks, r, valid_last, route=route)
        raw = self._spec.raw_size()
        for h in self._handles:
            shape = h.components + dim.tuple() + raw.tuple()
            self._curr[h.name] = torch.zeros(shape, dtype=self.field_dtype(h), device=self.device)
            self._next[h.name] = torch.zeros(shape, dtype=self.field_dtype(h), device=self.device)
        self._realized = True
        log_info(f"realized {self._size} over grid {dim} (raw subdomain {raw}, shell lo {r.lo()} hi {r.hi()}, "
                 f"route {self._exchange_route}{'' if oracle is None else f', method {self._methods}'}"
                 f"{', storage bf16' if self._storage == 'bf16' else ''})")

    # --- geometry accessors ---------------------------------------------------
    def local_spec(self) -> LocalSpec:
        return self._spec

    def subdomain_size(self) -> Dim3:
        return self._spec.sz

    def get_interior(self) -> Rect3:
        """The interior region in interior-local coordinates: the cells no
        stencil read takes outside the subdomain (src/stencil.cu:567-610)."""
        return self._spec.interior()

    def get_exterior(self) -> List[Rect3]:
        """The face slabs that cover the subdomain minus its interior
        (src/stencil.cu:616-666)."""
        return self._spec.exterior()

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

    def _slot(self, slot: str) -> Dict[str, torch.Tensor]:
        if slot not in ("curr", "next"):
            raise ValueError(f"slot must be 'curr' or 'next', got {slot!r}")
        return self._curr if slot == "curr" else self._next

    @staticmethod
    def _to_global(t: torch.Tensor) -> torch.Tensor:
        """``(*components, px, py, pz, a, b, c)`` blocks as the global
        ``(*components, px*a, py*b, pz*c)`` array."""
        k = t.dim() - 6
        px, py, pz, a, b, c = t.shape[k:]
        lead = tuple(range(k))
        return t.permute(*lead, k, k + 3, k + 1, k + 4, k + 2, k + 5).reshape(
            *t.shape[:k], px * a, py * b, pz * c)

    @staticmethod
    def _to_blocks(t: torch.Tensor, dim: Dim3, ext: Dim3) -> torch.Tensor:
        """The inverse of ``_to_global``: a global ``(*components, dim.x *
        ext.x, ...)`` array as ``(*components, *dim, *ext)`` blocks."""
        k = t.dim() - 3
        lead = tuple(range(k))
        return t.reshape(*t.shape[:k], dim.x, ext.x, dim.y, ext.y, dim.z, ext.z).permute(
            *lead, k, k + 2, k + 4, k + 1, k + 3, k + 5)

    def set_quantity(self, h: DataHandle, interior: np.ndarray, slot: str = "curr") -> None:
        """Load a full ``(*components, X, Y, Z)`` user-domain array into a
        quantity's valid interior cells; the shell and the pad cells of
        uneven sizes are zeroed, as the JAX package's ``_to_raw_global``
        leaves them."""
        want = h.components + self._size.tuple()
        if tuple(interior.shape) != want:
            raise ValueError(f"interior shape {interior.shape}, want {want}")
        dim, n = self.grid.dim(), self._spec.sz
        # one contiguous copy to the device; the padding and the reorder
        # into blocks run there
        padded = torch.zeros(h.components + (dim * n).tuple(), dtype=self.field_dtype(h), device=self.device)
        X, Y, Z = self._size.tuple()
        # through the native dtype first, as the JAX package's _to_raw_global
        # casts the user's array: one rounding to the storage dtype
        padded[..., :X, :Y, :Z] = torch.tensor(np.asarray(interior)).to(h.dtype).to(self.device)
        stack = self._slot(slot)[h.name]
        stack.zero_()
        self._interior_view(stack).copy_(self._to_blocks(padded, dim, n))

    def quantity_to_host(self, h: DataHandle, slot: str = "curr") -> np.ndarray:
        """Gather a quantity's valid interior cells to a ``(*components, X,
        Y, Z)`` host array (reference quantity_to_host,
        local_domain.cuh:329-346)."""
        out = self._to_global(self._interior_view(self._slot(slot)[h.name]))
        X, Y, Z = self._size.tuple()
        # a copy even on the CPU, where reshape may return a view of the
        # live storage that the next step overwrites; bf16 storage upcast to
        # the native dtype (exact)
        return out[..., :X, :Y, :Z].to("cpu", copy=True).to(h.dtype).numpy()

    def interior_to_host(self, h: DataHandle, slot: str = "curr") -> np.ndarray:
        """The whole interior (reference ``interior_to_host``,
        local_domain.cuh:329-346): ``quantity_to_host``."""
        return self.quantity_to_host(h, slot)

    def region_to_host(self, h: DataHandle, region: Rect3, slot: str = "curr") -> np.ndarray:
        """The cells of a region in user-domain (global) coordinates, as a
        ``(*components, *region.extent())`` host array: the reference's
        ``LocalDomain::region_to_host`` (src/local_domain.cu:97) over the
        whole domain.  Copies only the subdomains the region touches."""
        assert self._realized
        r = Rect3(Dim3.of(region.lo), Dim3.of(region.hi))
        if r.lo.any_lt(0) or (self._size - r.hi).any_lt(0):
            raise ValueError(f"region {r} leaves the domain {self._size}")
        dim, n, lo = self.grid.dim(), self._spec.sz, self._shell_radius.lo()
        stack = self._slot(slot)[h.name]
        ext = r.extent()
        out = np.zeros(h.components + ext.tuple(), dtype=torch.empty(0, dtype=h.dtype).numpy().dtype)
        first = [r.lo[a] // n[a] for a in range(3)]
        last = [min((r.hi[a] - 1) // n[a] if r.hi[a] > r.lo[a] else first[a], dim[a] - 1) for a in range(3)]
        for ix in range(first[0], last[0] + 1):
            for iy in range(first[1], last[1] + 1):
                for iz in range(first[2], last[2] + 1):
                    idx = Dim3(ix, iy, iz)
                    v = self.shard_valid(idx)
                    # the request's overlap with this subdomain's valid interior
                    olo = Dim3(*(max(r.lo[a], idx[a] * n[a]) for a in range(3)))
                    ohi = Dim3(*(min(r.hi[a], idx[a] * n[a] + v[a]) for a in range(3)))
                    if (ohi - olo).any_lt(1):
                        continue
                    src = tuple(slice(lo[a] + olo[a] - idx[a] * n[a], lo[a] + ohi[a] - idx[a] * n[a])
                                for a in range(3))
                    dst = tuple(slice(olo[a] - r.lo[a], ohi[a] - r.lo[a]) for a in range(3))
                    out[(Ellipsis,) + dst] = stack[(Ellipsis, ix, iy, iz) + src].cpu().to(h.dtype).numpy()
        return out

    def mark_shell_stale(self) -> None:
        """Steps that skip the shell (the single-subdomain wrap route) leave
        it holding whatever the last exchange wrote; raw readback then
        re-exchanges first (``quantity_to_host`` reads interiors only)."""
        self._shell_stale = True

    def raw_to_host(self, h: DataHandle, slot: str = "curr") -> np.ndarray:
        """The JAX package's raw shell-carrying global array
        ``(*components, px*Xr, py*Yr, pz*Zr)``, halos visible.  A stale
        shell of the current slot is refreshed with one exchange first."""
        if self._shell_stale and slot == "curr":
            self.exchange()
        return self._to_global(self._slot(slot)[h.name]).to("cpu", copy=True).to(h.dtype).numpy()

    def set_raw(self, h: DataHandle, raw: np.ndarray) -> None:
        """Load the JAX package's raw global array ``(*components, px*Xr,
        py*Yr, pz*Zr)`` (halos included) into a quantity's stack."""
        stack = self._curr[h.name]
        dim, ext = self.grid.dim(), self._spec.raw_size()
        want = h.components + (dim * ext).tuple()
        if tuple(raw.shape) != want:
            raise ValueError(f"raw shape {raw.shape}, want {want}")
        src = torch.tensor(np.asarray(raw)).to(h.dtype).to(self.device)
        stack.copy_(self._to_blocks(src, dim, ext))  # rounded to the storage dtype
        self._shell_stale = False

    def init_by_coords(self, h: DataHandle, fn) -> None:
        """Fill the interior with ``fn(cx, cy, cz)``, which maps broadcastable
        global coordinate tensors (``(px,1,1,nx,1,1)``-shaped and so on) to
        values, broadcast over the components.  Pad cells of uneven sizes
        get ``fn`` of their unwrapped coordinates (``>= size``), as in the
        JAX package."""
        coords = []
        for ax, origin in enumerate(self._origin_views()):
            shape = [1] * 6
            shape[3 + ax] = -1
            coords.append(origin + torch.arange(self._spec.sz[ax], device=self.device).view(shape))
        target = self._interior_view(self._curr[h.name])
        vals = torch.as_tensor(fn(*coords), device=self.device)
        # the native dtype, then the storage dtype (one rounding, as the JAX
        # package's init stores at field_dtype)
        target.copy_(vals.to(h.dtype).expand(target.shape))

    # --- the hot path ---------------------------------------------------------
    def exchange(self) -> None:
        """Fill every quantity's halo shell (src/stencil.cu:670-864): the
        sweeps of ``exchange_route()``, or the debug oracle of
        ``set_methods``."""
        assert self._realized
        self._exchange_fn([self._curr[h.name] for h in self._handles])
        self._shell_stale = False

    def exchange_many(self, steps: int) -> None:
        """Run ``steps`` exchanges in one dispatch (``exchange_many``,
        ``stencil_tpu/domain.py:1264-1282``): on the card one captured
        exchange replayed ``steps`` times, in place on the stacks (exchanging
        is idempotent on a filled domain, so this measures the steady-state
        exchange); on the CPU the same loop, called.  The shell is fresh
        after it, as after ``exchange()``."""
        assert self._realized
        if self._exchange_loop is None:
            exchange_fn = self._exchange_fn

            def body(cur, nxt, depth):
                exchange_fn(cur.fields)

            self._exchange_loop = Loop([h.name for h in self._handles], 1, body, in_place=True)
        self._curr = self._exchange_loop.run(self._curr, steps, capture=True)
        self._shell_stale = False

    def exchange_bytes_total(self) -> int:
        """Bytes one exchange moves over all subdomains by the reference's
        26-message model (``exchange_bytes``; src/stencil.cu:6-25)."""
        return exchange_bytes(self._spec, self._itemsizes()) * self.num_subdomains()

    def exchange_hop_bytes(self) -> Dict[Tuple[str, str], int]:
        """Bytes one exchange of the sweeps moves over each hop, summed over
        the subdomains, keyed ``(grid axis name, side)`` with side ``low``
        or ``high`` (``sweep_hop_bytes``).  A size-1 grid axis reports 0:
        its subdomain wraps onto itself."""
        per_sub = sweep_hop_bytes(self._spec, self._itemsizes())
        dim, count = self.grid.dim(), self.num_subdomains()
        return {(GRID_AXES[axis], side): nb * count if dim[axis] > 1 else 0
                for (axis, side), nb in per_sub.items()}

    def exchange_bytes_for_method(self, method: MethodFlags) -> int:
        """Bytes by method (src/stencil.cu:6-25): every exchange rides the
        default transport, so ``Ppermute`` (the reference's All) gets them
        all and the debug methods 0."""
        return self.exchange_bytes_total() if method & MethodFlags.Ppermute else 0

    def _itemsizes(self) -> List[int]:
        """Bytes a cell per quantity."""
        return [self.field_dtype(h).itemsize * h.cell_count() for h in self._handles]

    def swap(self) -> None:
        """Swap curr/next slots (src/stencil.cu:541-561)."""
        self._curr, self._next = self._next, self._curr

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_curr(self, h: DataHandle) -> torch.Tensor:
        """The ``(*components, px, py, pz, Xr, Yr, Zr)`` storage of ``h``'s
        current slot."""
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
        its float32 reciprocal.  A component quantity's values carry its
        components, so a kernel steps a vector whole, and may take one
        (``v.sh(1, 0, 0)[0]``) or build one (``torch.stack(..., dim=0)``).
        With a halo multiplier ``k`` each step is a MACRO step: one exchange
        of the ``k*r``-wide shells, then ``k`` sub-steps over regions that
        shrink by the user radius from the whole shell down to the interior,
        so ``step(curr, s)`` advances ``s*k`` iterations.  ``overlap=True``
        (the JAX package's ``domain.py:1585-1627``) evaluates the interior,
        the cells whose reads stay inside the valid interior (on padded
        axes short of the earliest halo too), from the PRE-exchange stacks
        on the current stream while the exchange runs on a second CUDA
        stream, then the exterior slabs of the first sub-step's region
        (``exterior_of``) from the exchanged stacks, and writes them all; it
        computes the same cells as ``overlap=False``, bit for bit.

        ``engine="stream"``: the plane-streaming engine
        (``ops/stream.make_stream_step``) with the hand-written CUDA stream
        kernels: ``wrap`` on one subdomain, the temporally blocked
        ``wavefront`` when a uniform shell >= 2 allows it, ``plane``
        otherwise; ``x_radius`` (default the largest user radius) bounds the
        kernel's shifts, ``stream_path``/``separable``/``stream_depth`` and
        the axis arguments as in ``make_stream_step`` (``stream_z_slabs``
        is its ``z_slabs``).  A stream step counts RAW iterations; the stream
        engine refuses component quantities."""
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
        n = self._spec.sz
        shell = self._shell_radius
        lo = shell.lo()
        names = [h.name for h in self._handles]
        components = [h.components for h in self._handles]
        dtypes = [self.field_dtype(h) for h in self._handles]
        route = self._exchange_route

        def region_of(rect: Rect3):
            """(info, traced kernel) of one region in interior-local coords."""
            region = tuple(slice(rect.lo[ax], rect.hi[ax]) for ax in range(3))
            info = BlockInfo(self._origin_views(), n, self._size, self._radius, region)
            static = {"interior": info.interior, "radius": info.radius, "region": info.region}
            return info, StreamKernel(kernel, names, None, self._size, static, components, dtypes)

        # sub-step regions in interior-local coords: the whole shell is valid
        # after the exchange and each sub-step shrinks it by the user radius,
        # landing on the interior after the last one (domain.py:1553-1569 of
        # the JAX package); multiplier 1 gives the interior alone
        rect = Rect3(Dim3(0, 0, 0) - lo, n + shell.hi())
        rects = []
        for _ in range(self._halo_mult):
            rect = shrink_by_radius(rect, self._radius)
            rects.append(rect)
        subs = [region_of(r) for r in rects]
        if overlap:
            # the cells computable before the exchange: their user-radius
            # reads stay inside the valid interior; a padded axis also stops
            # short of its earliest halo (JAX domain.py:1530-1550)
            inner = shrink_by_radius(Rect3(Dim3(0, 0, 0), n), self._radius)
            vl = self._valid_last or (None, None, None)
            pad = [n[ax] - vl[ax] if vl[ax] is not None else 0 for ax in range(3)]
            inner = Rect3(inner.lo, Dim3(*[max(inner.hi[ax] - pad[ax], inner.lo[ax]) for ax in range(3)]))
            interior = region_of(inner)
            exterior = [region_of(r) for r in exterior_of(rects[0], inner)]
        side = side_stream(self.device) if overlap else None

        def evaluate(stacks, info, sk):
            views = [ShardView(b, lo, info.region) for b in stacks]
            return views, sk.evaluate(lambda q, dx, dy, dz: views[q].sh(dx, dy, dz), info.coords, self.device)

        def write(views, vals, sk):
            for view, v, written in zip(views, vals, sk.updates()):
                if written:
                    view.center().copy_(v)

        # one macro step a body, in place on the stacks
        def body(cur, nxt, depth):
            del nxt, depth
            stacks = cur.fields
            first = 0
            if overlap:
                inside = overlapped(side, lambda: evaluate(stacks, *interior),
                                    lambda: halo_exchange_multi(stacks, shell, self._valid_last, route=route))
                outside = [evaluate(stacks, *r) for r in exterior]
                # every value computed before any write; a value that is
                # a view of the stacks (a pass-through) is copied first
                done = [(views, [v.clone() if v._is_view() else v for v in vals], sk)
                        for (views, vals), (_, sk) in zip([inside] + outside, [interior] + exterior)]
                for views, vals, sk in done:
                    write(views, vals, sk)
                first = 1
            else:
                halo_exchange_multi(stacks, shell, self._valid_last, route=route)
            for info, sk in subs[first:]:
                # all values computed before any write
                write(*evaluate(stacks, info, sk), sk)

        return as_step(Loop(names, 1, body, in_place=True))

    def set_capture(self, on: bool) -> None:
        """Run ``run_step`` as captured CUDA graphs (``ops/captured.py``),
        the counterpart of the JAX step's one-dispatch ``fori_loop``: each
        phase of the step's loop is captured at its first occurrence and
        replayed after.  Default off.  On a CPU domain the same binding and
        bookkeeping run and each phase is called where the card would
        replay it."""
        self._capture = bool(on)

    def capture(self) -> bool:
        return self._capture

    def run_step(self, step_fn, steps: int = 1) -> None:
        """Apply a built step to curr and make its output the new curr.
        Under ``set_capture(True)`` the step's loop (``step_fn._loop``) runs
        captured; a step without one is refused, a capture or replay that
        fails raises."""
        if self._capture:
            loop = getattr(step_fn, "_loop", None)
            if loop is None:
                raise ValueError(
                    "set_capture(True) runs a step's loop: build the step with make_step or a model"
                )
            self._curr = loop.run(self._curr, steps, capture=True)
            step_fn.captured = loop.captured
        else:
            self._curr = step_fn(self._curr, steps)
        if getattr(step_fn, "_marks_shell_stale", False):
            self.mark_shell_stale()
