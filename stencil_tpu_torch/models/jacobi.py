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
  the interior, ``jacobi_wrap_step``, write back; the shell goes stale), and
  otherwise ``wavefront`` when the plan gives a depth m >= 2, else ``slab``
  on even sizes with >= 2 x-planes per subdomain, else ``shell`` (exchange
  with ``blend_slab`` halo writes, then ``jacobi_plane_step`` on all
  subdomains in one launch, every iteration).  ``wavefront`` is the JAX
  package's temporally blocked route (``_make_wavefront_step``): m-wide
  shells, and per macro step one x/y exchange in the array, one z exchange on
  separate z-major slab buffers, and ONE m-level kernel launch
  (``jacobi_zring_wavefront_step`` when the subdomain's z extent is a
  multiple of 128, else ``jacobi_shell_wavefront_step``); a ``steps % m``
  remainder runs one shallower launch over the same shell.  ``slab`` is its
  one-level baseline (``_make_slab_step``): the bare interiors, six face slabs
  gathered from the neighbours and ONE ``jacobi_slab_step`` launch per step,
  with no halo written.

The kernel axes (``stencil_tpu/models/jacobi.py:57-103``): ``compute_unit``
(``vpu``, or ``mxu`` / ``mxu_band``, the in-plane sums on the tensor cores)
with ``mxu_input`` (``f32`` | ``bf16`` operands), and ``storage_dtype``
(``native`` | ``bf16``: the field stored as bfloat16, the kernels
accumulating at f32 and rounding once a pass).  Each resolves explicit >
static (``ops/jacobi_kernels.py``); the storage axis before allocation.  The
``wrap`` and ``wavefront`` routes take both; ``shell`` and ``slab`` have no
contraction kernel, so they degrade ``mxu`` to ``vpu`` with a warning and
take bf16 storage; the torch engine degrades both axes with a warning.

Field dtypes: ``dtype=torch.float32`` (the default) or ``torch.float64`` on
either engine.  A float64 field runs every ``cuda`` route through the
kernels' float64 build (levels at f64); ``compute_unit="mxu"`` and
``storage_dtype="bf16"`` degrade on it with a warning, as in the JAX package.
The wavefront plan prices its shared memory at the working itemsize (8 bytes
at f64), so a float64 field plans shallower depths (ROADMAP.md queue 3).

Uneven sizes (padded subdomains, ``DistributedDomain``) run on the torch
engine, on ``shell`` and on the wavefront in its plain form (every axis
exchanged in the array), as in the JAX package: each exchange writes the +axis
halo right after the valid cells (``blend_slab_dynamic``), and the clamp's
global x, ``(origin + x) mod gx``, wraps there to the cells past the boundary.

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
from stencil_tpu_torch.ops.captured import Loop, as_step, window_loop
from stencil_tpu_torch.ops.exchange import halo_exchange_shard, shift_from_high, shift_from_low
from stencil_tpu_torch.ops.jacobi_kernels import (
    _ZRING_OFF,
    COMPUTE_UNITS,
    choose_temporal_k,
    jacobi_plane_step,
    jacobi_shell_wavefront_step,
    jacobi_slab_step,
    jacobi_wrap_step,
    jacobi_zring_wavefront_step,
    mxu_flops_per_plane,
    pack_d2,
    resolve_compute_unit,
    resolve_mxu_input,
    resolve_storage_dtype,
    unit_uses_mxu,
    wavefront_auto_depth,
    wavefront_smem_bytes,
    wavefront_smem_fits,
    yz_dist2_plane,
    zring_dist2_plane,
)
from stencil_tpu_torch.ops.stream import (
    make_slab_extenders,
    permute_and_extend_z_slabs,
    prime_z_slabs,
)
from stencil_tpu_torch.utils.config import MethodFlags, PlacementStrategy

COLD_TEMP = 0.0
HOT_TEMP = 1.0


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
        temporal_k="auto",  # wrap / wavefront levels per call (int | "auto")
        pallas_path: str = "auto",  # "auto" | "wrap" | "slab" | "shell" | "wavefront"
        z_ring: bool = None,  # wavefront: z-ring layout where it applies
        # (None = yes); False keeps the z shell columns in the array
        wavefront_alias: bool = None,  # in-place wavefront: refused
        compute_unit: str = None,  # "vpu" | "mxu" | "mxu_band" | None/"auto" (vpu)
        mxu_input: str = None,  # the contraction's operands: "f32" | "bf16" | None/"auto" (f32)
        storage_dtype: str = None,  # "native" | "bf16" | None/"auto" (native)
        device="cuda",
        capture: bool = False,  # run steps as captured CUDA graphs (dd.set_capture)
    ):
        self.dd = DistributedDomain(x, y, z, device=device)
        self.dd.set_capture(capture)
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
        if pallas_path not in ("auto", "wrap", "slab", "shell", "wavefront"):
            raise ValueError(f"unknown pallas_path {pallas_path!r}")
        if wavefront_alias:
            raise NotImplementedError(
                "wavefront_alias=True is refused: the CUDA wavefront's blocks march x "
                "independently, so an in-place write can land before a neighbouring "
                "tile reads it (ROADMAP.md, deliberate differences)"
            )
        self.overlap = overlap
        self.kernel_impl = kernel_impl
        self.temporal_k = temporal_k
        self.pallas_path_request = pallas_path
        self.z_ring_request = z_ring
        self.compute_unit_request = compute_unit
        self.mxu_input_request = mxu_input
        self.storage_dtype_request = storage_dtype
        # the resolved axes (realize() and the step builders fill them in)
        self._compute_unit = "vpu"
        self._mxu_input = "f32"
        self._storage_dtype = "native"
        self._mxu_flops_iter = 0  # the JAX package's FLOP model of the contraction, a raw iteration
        self._step = None
        # which route realize() picked: "wrap" | "slab" | "shell" | "wavefront" (None on
        # the torch engine); the wavefront's depth and form
        self._pallas_path = None
        self._wavefront_m = 0
        self._wavefront_z_slabs = False
        self._wavefront_z_ring = False

    def realize(self) -> None:
        self._wavefront_m = 0
        # the storage axis first: it shapes the allocation
        self._resolve_storage()
        if self.kernel_impl == "torch":
            # the torch engine has no contraction kernel (the storage axis
            # degraded above)
            self._compute_unit = resolve_compute_unit(
                self.compute_unit_request, [self.h.dtype], where="jacobi:torch", engine_ok=False,
                engine_why="the torch engine has no contraction kernels")[0]
        if self.kernel_impl == "cuda" and self.pallas_path_request in ("auto", "wavefront"):
            # decided BEFORE dd.realize(): the wavefront rides the halo
            # multiplier (m-wide shells), which shapes the allocation
            if self.pallas_path_request == "wavefront":
                self._wavefront_m = self._plan_wavefront()  # raises if not viable
            elif self.dd.halo_multiplier() == 1 and self.dd.planned_grid().count() > 1:
                try:
                    m = self._plan_wavefront()
                except ValueError:
                    m = 0
                # depth 1 buys nothing over the one-level routes
                self._wavefront_m = m if m >= 2 else 0
            if self._wavefront_m:
                self.dd.set_halo_multiplier(self._wavefront_m)
        self.dd.realize()
        # set compute region to (HOT+COLD)/2 (jacobi3d.cu:15-29, 253-263)
        mid = (HOT_TEMP + COLD_TEMP) / 2
        self.dd.init_by_coords(self.h, lambda x, y, z: torch.full((), mid) + 0 * (x + y + z))
        if self.kernel_impl == "cuda":
            if self._wavefront_m:
                self._step = self._make_wavefront_step()
            elif self.dd.halo_multiplier() != 1:
                raise ValueError(
                    "kernel_impl='cuda' requires halo multiplier 1 on the wrap, slab and "
                    "shell routes (their kernels assume a radius-1 shell); use kernel_impl='torch' "
                    "with set_halo_multiplier, or pallas_path='wavefront', which sets its own"
                )
            else:
                self._step = self._make_cuda_step()
        else:
            self._step = self.dd.make_step(self._kernel, overlap=self.overlap)

    def _resolve_storage(self) -> None:
        """The storage axis (the JAX package's ``_resolve_storage``,
        models/jacobi.py:200-228), pinned on the domain before allocation:
        the explicit request, else native; the torch engine has no
        f32-accumulate kernels and degrades bf16 to native."""
        sd, _ = resolve_storage_dtype(
            self.storage_dtype_request, [self.h.dtype], where=f"jacobi:{self.kernel_impl}",
            engine_ok=self.kernel_impl == "cuda", engine_why="the torch engine has no f32-accumulate kernels")
        self._storage_dtype = sd
        if sd != "native":
            self.dd.set_storage(sd)

    def _resolve_unit(self, where: str) -> dict:
        """The compute unit and operand precision of a route with a
        contraction kernel (``wrap``, ``wavefront``), and the kernels'
        keywords for them and the storage axis."""
        unit, _ = resolve_compute_unit(self.compute_unit_request, [self.h.dtype], where=where)
        mi, _ = resolve_mxu_input(self.mxu_input_request, unit, where=where)
        self._compute_unit, self._mxu_input = unit, mi
        return {"compute_unit": unit, "mxu_input": mi, "f32_accumulate": self._f32_accumulate()}

    def _resolve_unit_no_contraction(self, where: str) -> None:
        """The routes without a contraction kernel (``shell``, ``slab``;
        models/jacobi.py:909-925): any mxu request degrades to vpu with a
        warning."""
        self._compute_unit = resolve_compute_unit(
            self.compute_unit_request, [self.h.dtype], where=where, engine_ok=False,
            engine_why="the slab/shell routes have no contraction kernels")[0]
        self._mxu_flops_iter = 0

    def _f32_accumulate(self) -> bool:
        return self.dd.field_dtype(self.h) != self.h.dtype

    def _make_cuda_step(self):
        dd = self.dd
        want = self.pallas_path_request
        single = dd.num_subdomains() == 1
        if want == "wrap" and not single:
            raise ValueError("pallas_path='wrap' requires a single subdomain")
        n = dd.local_spec().sz
        # the slab kernel needs bare interiors of >= 2 x-planes (its contract)
        # and no padding; the JAX package's 128-aligned x gate is a Mosaic
        # constraint, absent here as in its interpret mode
        slab_ok = not dd.padded() and n.x >= 2
        if want == "slab" and not slab_ok:
            raise ValueError(
                "pallas_path='slab' requires even (unpadded) sizes and >= 2 x-planes per subdomain"
            )
        lo = dd.shell_radius().lo()
        name = self.h.name
        if want == "wrap" or (want == "auto" and single):
            self._pallas_path = "wrap"
            k = choose_temporal_k(n.tuple(), self.temporal_k)
            kw = self._resolve_unit("jacobi-wrap")
            if unit_uses_mxu(kw["compute_unit"]):
                self._mxu_flops_iter = mxu_flops_per_plane(n.y, n.z, kw["compute_unit"]) * n.x
            inner = (0, 0, 0, slice(lo.x, lo.x + n.x), slice(lo.y, lo.y + n.y), slice(lo.z, lo.z + n.z))

            # the interior is worked on in two (X, Y, Z) buffers, k levels a
            # body; each level's arithmetic is the same whatever the split
            # into calls, so (blocked, remainder) is bitwise equal to k=1 calls
            # (under bf16 storage, a call rounds once: k levels a rounding)
            def wrap_body(cur, nxt, depth):
                jacobi_wrap_step(cur.fields[0], depth, out=nxt.fields[0], **kw)

            step = as_step(window_loop([name], k, wrap_body, inner))
            step._marks_shell_stale = True
            return step

        gsize = dd.size().tuple()
        origins = dd.origins()
        yz_d2 = torch.stack(
            [yz_dist2_plane(int(o[1]), int(o[2]), (n.y, n.z), gsize, dd.device) for o in origins.cpu()]
        )
        if want in ("auto", "slab") and slab_ok:
            return self._make_slab_step(origins, yz_d2)

        self._pallas_path = "shell"
        self._resolve_unit_no_contraction("jacobi-shell")
        f32_acc = self._f32_accumulate()
        shell = dd.shell_radius()
        valid_last = dd.valid_last()

        # the stack and a spare, ping-ponged: exchange in place, then one
        # level into the other
        def shell_body(cur, nxt, depth):
            stack = cur.fields[0]
            halo_exchange_shard(stack, shell, valid_last)
            blocks = stack.view(-1, *stack.shape[3:])
            jacobi_plane_step(blocks, origins, yz_d2, gsize, out=nxt.fields[0].view(blocks.shape),
                              f32_accumulate=f32_acc)

        return as_step(Loop([name], 1, shell_body))

    def _make_slab_step(self, origins, yz_d2):
        """The one-level multi-subdomain route without halo writes (the JAX
        package's ``_make_slab_step``, models/jacobi.py:832-909): the bare
        interiors are sliced out of the stack once per call; each step gathers
        the six face slabs, each the sending neighbour's outermost interior
        plane (the ``-dir`` convention, packer.cuh:91-93), with the neighbour
        shifts, and ONE ``jacobi_slab_step`` launch advances every subdomain;
        the interiors are written back once per call.  The shell goes stale."""
        dd = self.dd
        n = dd.local_spec().sz
        lo = dd.shell_radius().lo()
        name = self.h.name
        count = dd.num_subdomains()
        gsize = dd.size().tuple()
        self._pallas_path = "slab"
        self._resolve_unit_no_contraction("jacobi-slab")
        f32_acc = self._f32_accumulate()
        inner = (Ellipsis, slice(lo.x, lo.x + n.x), slice(lo.y, lo.y + n.y), slice(lo.z, lo.z + n.z))

        def batch(t):  # (px, py, pz, ...) -> (n, ...): one launch serves all
            return t.contiguous().view(count, *t.shape[3:])

        # the interiors are worked on in two buffers, one level a body
        def slab_body(cur, nxt, depth):
            b = cur.fields[0]
            faces = (
                shift_from_low(b[..., n.x - 1, :, :], 0), shift_from_high(b[..., 0, :, :], 0),
                shift_from_low(b[..., :, n.y - 1, :], 1), shift_from_high(b[..., :, 0, :], 1),
                shift_from_low(b[..., n.z - 1], 2), shift_from_high(b[..., 0], 2),
            )
            jacobi_slab_step(batch(b), *(batch(f) for f in faces), origins, yz_d2, gsize,
                             out=batch(nxt.fields[0]), f32_accumulate=f32_acc)

        step = as_step(window_loop([name], 1, slab_body, inner))
        step._marks_shell_stale = True
        return step

    def _plan_wavefront(self) -> int:
        """The wavefront depth m (>= 1), chosen before ``dd.realize()`` as
        the JAX package's ``_plan_wavefront`` does (models/jacobi.py:227-348):
        an explicit ``temporal_k`` must satisfy 1 <= m <= the smallest shard
        extent; "auto" takes the deepest m up to
        ``min(_WRAP_MAX_K, n_min // 4, n_min)`` whose kernel fits the H100's
        shared memory per block (``wavefront_smem_fits``, the Hopper
        counterpart of the VMEM model).  m >= 2 plans the z-slab forms, m = 1
        the plain form, as in the JAX package; padded (uneven) subdomains plan
        the plain form at any depth, capped by the smallest valid extent
        (models/jacobi.py:234-241).  The depth model prices the requested
        contraction unit (``wavefront_smem_bytes``), as the JAX package
        prices its prospective unit; its tune cache is ROADMAP.md queue 1
        item 11."""
        dd = self.dd
        if dd.halo_multiplier() != 1:
            raise ValueError("pallas_path='wavefront' manages the halo multiplier itself")
        size = dd.size()
        dim = dd.planned_grid().dim()
        n = [-(-size[ax] // dim[ax]) for ax in range(3)]
        # last-shard valid extents; the smallest caps the depth
        v = [size[ax] - n[ax] * (dim[ax] - 1) for ax in range(3)]
        padded = v != n
        if min(v) < 1:
            raise ValueError(
                f"pallas_path='wavefront': empty last shard for {tuple(size)} over {tuple(dim)}"
            )
        n_min = min(min(n), min(v))
        # the prospective unit (the build resolves it, with its warnings),
        # and the levels' itemsize (the JAX package's ring_itemsize: the
        # native dtype's, 4 under bf16 storage of f32 fields, 8 at f64)
        req = self.compute_unit_request
        unit = req if req in COMPUTE_UNITS else "vpu"
        item = self.h.dtype.itemsize
        if self.temporal_k != "auto":
            m = int(self.temporal_k)
            if not 1 <= m <= n_min:
                raise ValueError(
                    f"wavefront temporal_k={m} needs 1 <= m <= min(shard/valid)={n_min}"
                )
            if not wavefront_smem_fits(m, unit, item):
                raise ValueError(
                    f"wavefront temporal_k={m} needs {wavefront_smem_bytes(m, unit, item)} bytes of shared "
                    "memory per block, more than the H100 grants one block"
                )
            # the z-slab forms' emit slices sit at the interior z boundary,
            # so padded subdomains take the plain form
            self._wavefront_z_planned = not padded
            return m
        m = wavefront_auto_depth(n_min, unit, item)
        self._wavefront_z_planned = m >= 2 and not padded
        return m

    def _make_wavefront_step(self):
        """The temporally blocked multi-subdomain step (the JAX package's
        ``_make_wavefront_step``, models/jacobi.py:350-629).  Per macro step:
        exchange the m-wide x/y shells in the array, shift and extend the
        z-major z-slab buffers (the z halo never touches the array), then one
        m-level wavefront launch over every subdomain, which also emits the
        next slabs.  ``steps % m`` runs one shallower launch over the same
        m-wide shell (``interior_offset=m``).  Three forms, as in the JAX
        package: z-ring (the array holds only the z interior), padded z-slab
        (without the lane padding: a Hopper row coalesces at any width) and
        plain (all three axes exchanged in the array: depth 1, or padded
        subdomains, whose +axis halos land after the valid cells).  A call
        takes up the working array and
        slabs the last one left when the quantity is untouched since, so
        ``step(1)`` repeated costs a depth-1 pass and the copy back each, not
        the copy out and the priming too.  The shell goes stale."""
        dd = self.dd
        m = self._wavefront_m
        n = dd.local_spec().sz
        shell = dd.shell_radius()
        raw = dd.local_spec().raw_size()
        Xr, Yr, Zr = raw.tuple()
        grid = dd.grid_dim().tuple()
        count = dd.num_subdomains()
        gsize = dd.size().tuple()
        origins = dd.origins()
        org = origins.cpu().tolist()
        name = self.h.name
        valid_last = dd.valid_last()
        z_slab_mode = self._wavefront_z_planned
        ring_pref = True if self.z_ring_request is None else bool(self.z_ring_request)
        z_ring_mode = z_slab_mode and n.z % 128 == 0 and 2 * m <= _ZRING_OFF and ring_pref
        kw = self._resolve_unit("jacobi-wavefront")
        if unit_uses_mxu(kw["compute_unit"]):
            plane_z = _ZRING_OFF + n.z if z_ring_mode else Zr
            self._mxu_flops_iter = mxu_flops_per_plane(Yr, plane_z, kw["compute_unit"]) * Xr * count
        self._pallas_path = "wavefront"
        self._wavefront_z_slabs = z_slab_mode
        self._wavefront_z_ring = z_ring_mode
        yext, xext = make_slab_extenders(Xr, Yr, m)

        def batch(t):  # (px, py, pz, ...) -> (n, ...): one launch serves all
            return t.view(count, *t.shape[3:])

        def zslabs(stacks):  # one set's z-slab buffer
            return [torch.empty((*grid, Xr, 2 * m, Yr), dtype=stacks[0].dtype, device=stacks[0].device)]

        # a call takes up the working array and z slabs the last one left
        # while nothing has written the quantity since (``resume``), so a
        # caller stepping one iteration at a time pays neither the
        # z-interior copy out nor the slab priming again
        if z_ring_mode:
            Zi = n.z
            d2 = torch.stack([
                pack_d2(zring_dist2_plane(o[1] - m, o[2], m, Yr, Zi, gsize, dd.device), gsize)
                for o in org
            ])

            def ring_enter(stacks, cur):
                cur.fields[0].copy_(stacks[0][..., m : m + Zi])  # no z shell in the array
                prime_z_slabs(stacks[0], Zr, m, out=cur.extra[0])

            def ring_body(cur, nxt, depth):
                b = cur.fields[0]
                halo_exchange_shard(b, shell, axes=(0, 1))
                zs = permute_and_extend_z_slabs(cur.extra[0], m, yext, xext)
                jacobi_zring_wavefront_step(batch(b), depth, origins, d2, gsize, z_slabs=batch(zs),
                                            interior_offset=m, out=batch(nxt.fields[0]),
                                            z_out=batch(nxt.extra[0]), **kw)

            loop = Loop(
                [name], m, ring_body, resume=True, extra=zslabs, enter=ring_enter,
                work=lambda stacks: [torch.empty_like(stacks[0][..., m : m + Zi],
                                                      memory_format=torch.contiguous_format)],
                leave=lambda stacks, cur: stacks[0][..., m : m + Zi].copy_(cur.fields[0]),
            )
        else:
            d2 = torch.stack([
                pack_d2(yz_dist2_plane(o[1] - m, o[2] - m, (Yr, Zr), gsize, dd.device), gsize)
                for o in org
            ])

            def shell_body(cur, nxt, depth):
                b = cur.fields[0]
                if z_slab_mode:
                    halo_exchange_shard(b, shell, axes=(0, 1))
                    zs = permute_and_extend_z_slabs(cur.extra[0], m, yext, xext)
                    jacobi_shell_wavefront_step(
                        batch(b), depth, origins, d2, gsize, interior_offset=m, z_slabs=batch(zs),
                        z_valid=Zr, out=batch(nxt.fields[0]), z_out=batch(nxt.extra[0]), **kw,
                    )
                else:
                    halo_exchange_shard(b, shell, valid_last)
                    jacobi_shell_wavefront_step(batch(b), depth, origins, d2, gsize, interior_offset=m,
                                                out=batch(nxt.fields[0]), **kw)

            # the stack and a spare, ping-ponged
            loop = Loop(
                [name], m, shell_body, resume=z_slab_mode, extra=zslabs if z_slab_mode else None,
                enter=(lambda stacks, cur: prime_z_slabs(stacks[0], Zr, m, out=cur.extra[0]))
                if z_slab_mode else None,
            )
        step = as_step(loop)
        step._marks_shell_stale = True
        return step

    @staticmethod
    def _kernel(views, info):
        size = info.global_size
        hot_c = Dim3(size.x // 3, size.y // 2, size.z // 2)
        cold_c = Dim3(size.x * 2 // 3, size.y // 2, size.z // 2)
        sphere_r = size.x // 10

        src = views["temp"]
        # the engines trace the kernel: `/ 6.0` is a multiply by float32(1/6),
        # as XLA compiles the JAX source's division
        val = (
            src.sh(1, 0, 0)
            + src.sh(-1, 0, 0)
            + src.sh(0, 1, 0)
            + src.sh(0, -1, 0)
            + src.sh(0, 0, 1)
            + src.sh(0, 0, -1)
        ) / 6.0

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
        """Advance ``steps`` iterations.  The torch engine under a halo
        multiplier is built in macro steps (one exchange per ``mult``
        iterations), so ``steps`` must divide into whole macros there; the
        cuda routes count iterations themselves."""
        mult = self.dd.halo_multiplier()
        if self.kernel_impl == "torch" and mult > 1:
            if steps % mult:
                raise ValueError(
                    f"steps={steps} must be a multiple of the halo multiplier {mult} "
                    "on the torch engine (macro steps)"
                )
            steps //= mult
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
