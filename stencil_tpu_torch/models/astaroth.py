"""Astaroth MHD proxy: radius 3, sin-wave fields, mean of the 6 face neighbours.

Counterpart of ``stencil_tpu/models/astaroth.py`` (reference
bin/astaroth_sim.cu): radius 3 in all 26 directions (astaroth_sim.cu:184),
every quantity initialised to ``sin(2*pi/period * (x + y + z))`` over the
interior, and each step the mean of the 6 face neighbours at distance 1 (the
radius-3 halo is exchanged even though the kernel reads only distance 1,
modelling Astaroth's real communication volume).  ``num_quantities`` is the
number of exchanged fields (the real Astaroth has 8).

Engines (``kernel_impl``):

* ``"torch"``, the counterpart of ``"jnp"``: ``make_step(self._kernel)``,
  the torch engine, one exchange per iteration;
* ``"cuda"``, the counterpart of ``"pallas"``: ``_kernel`` VERBATIM through
  the plane-streaming engine (``ops/stream.py``) and its hand-written CUDA
  kernels.  ``schedule="auto"`` takes the exchange-free ``wrap`` route on
  one subdomain and otherwise the m-level ``wavefront`` (m <= 3 x the halo
  multiplier: the radius-3 shell feeds 3 levels of the distance-1 stencil);
  ``"wavefront"`` forces the wavefront (raising when not viable: the
  ``bench.py`` configuration); ``"per-step"`` the ``plane`` route, one
  exchange per iteration (reference exchange-cadence parity).  ``_kernel``
  updates each field from itself only, so the engine may stream the fields
  one at a time (``separable``) at full depth.

Both engines sum x-1, y-1, z-1, x+1, y+1, z+1 and multiply by float32(1/6)
(the ``/ 6.0``, as XLA compiles it), so every route is bitwise equal to every
other on the valid cells.

The initial field is computed in float64 and stored as float32, as the JAX
package computes it with 64-bit mode on (its tests); a ``sin`` of another
library may differ in the last bit of a float64, so the tests hand the JAX
package's initial fields across with ``load_state``.

``exchange_route`` pins the halo exchange's y/z-sweep route (one of
``ops/exchange.py`` ``EXCHANGE_ROUTES``; None or ``"auto"`` resolves
``direct``): it reaches every exchange of the torch engine, the plane route
and the plain wavefront form, and the packed ``*_pallas`` routes run the
hand-written shell pack kernels.  The z-slab wavefront's x/y exchange stays
``direct``, as in the JAX package.

Field dtypes: ``dtype=torch.float64`` runs every route at float64 (the CUDA
kernels' float64 builds); ``storage_dtype="bf16"`` stores every field as
bfloat16 and runs the CUDA kernels' bf16 builds, which read at float32, keep
their levels at float32 and round once a pass (the JAX package's
``f32_accumulate``).  The storage axis resolves as the JAX package's
``realize`` resolves it, without its env and tune sources: the explicit
request, else ``native``; the torch engine has no such kernels and degrades
a bf16 request to native with a ``RuntimeWarning``, and so do non-f32 fields.
The initial field is rounded from float64 to float32 and then to bfloat16,
where the JAX package rounds once: the tests hand its fields across.

The compute-unit axis: ``compute_unit="mxu"`` / ``"mxu_band"`` (and
``mxu_input="bf16"``) hands the stream engine ``_kernel_mxu``, the same mean
with its four in-plane taps written through ``PlaneView.plane_nbr_sum``,
which the CUDA kernels contract on the tensor cores (within 4 ulps a level
of the ``vpu`` route; the plain versions equal the JAX package's passes).
The axes resolve as ``make_stream_step`` resolves them (explicit, else
``vpu`` / ``f32``, recorded in ``_compute_unit`` / ``_mxu_input``); the
torch engine has no contraction kernels and degrades both with a
``RuntimeWarning``, as does a float64 field.  A unit combines with
``stream_halo="fused"`` and ``stream_overlap="split"`` on every schedule
that plans them: the fused passes contract the level-0 planes patched from
the shell buffers, and the split schedule's band passes contract their
sub-blocks' planes, each resolving ``mxu_band`` on its own plane.

Every step goes through ``DistributedDomain.run_step`` with the label
``astaroth``; ``check_divergence_every`` turns on the divergence sentinel,
and ``realize()`` registers the JAX package's magnitude-envelope guardband.
The storage axis and, through ``make_stream_step``, the stream plan and its
axes consult the autotuner's ``stream`` config (``tune/``) behind their
environment knobs, as the JAX package's ``AstarothSim`` does.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.ops.jacobi_kernels import resolve_compute_unit, resolve_mxu_input, resolve_storage_dtype
from stencil_tpu_torch.telemetry.numerics import magnitude_envelope
from stencil_tpu_torch.utils.config import PlacementStrategy


class AstarothSim:
    def __init__(
        self,
        x: int,
        y: int,
        z: int,
        num_quantities: int = 1,
        period: float = 10.0,
        overlap: bool = True,
        strategy: PlacementStrategy = PlacementStrategy.NodeAware,
        subdomains: int = 1,  # the JAX package's device count
        dtype=torch.float32,
        kernel_impl: str = "torch",  # "torch" (plain tensors) | "cuda" (stream kernels)
        schedule: str = "auto",  # "auto" | "per-step" | "wavefront"
        check_divergence_every: int = 0,  # divergence sentinel cadence (0: off)
        stream_overlap: str = "auto",
        stream_halo: str = "auto",
        exchange_route: str = None,
        compute_unit: str = "auto",
        mxu_input: str = "auto",
        storage_dtype: str = None,
        device="cuda",
        capture: bool = False,  # run steps as captured CUDA graphs (dd.set_capture)
    ):
        if kernel_impl not in ("torch", "cuda"):
            raise ValueError(f"unknown kernel_impl {kernel_impl!r} (torch | cuda)")
        if schedule not in ("auto", "per-step", "wavefront"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.dd = DistributedDomain(x, y, z, device=device)
        self.dd.set_capture(capture)
        if check_divergence_every:
            self.dd.set_divergence_check(check_divergence_every)
        self.dd.set_radius(Radius.constant(3))  # astaroth_sim.cu:184
        self.dd.set_placement(strategy)
        self.dd.set_subdomains(subdomains)
        if exchange_route not in (None, "auto"):
            self.dd.set_exchange_route(exchange_route)  # raises ValueError on an unknown route
        self.period = period
        self.handles = [self.dd.add_data(f"d{i}", dtype=dtype) for i in range(num_quantities)]
        self.overlap = overlap
        self.kernel_impl = kernel_impl
        self.schedule = schedule
        self.stream_overlap = stream_overlap
        self.stream_halo = stream_halo
        self.storage_dtype_request = storage_dtype
        self._storage_dtype = "native"
        self.compute_unit = compute_unit
        self.mxu_input = mxu_input
        self._compute_unit, self._mxu_input = "vpu", "f32"
        self._step = None

    def realize(self) -> None:
        # the storage axis resolves before allocation (the JAX package's
        # realize, models/astaroth.py:127-129): explicit >
        # STENCIL_STORAGE_DTYPE > the tuned "stream" config > native; only
        # the CUDA engine has f32-accumulate kernels
        tuned = None
        if self.storage_dtype_request in (None, "auto") and self.kernel_impl == "cuda":
            from stencil_tpu_torch import tune

            tuned = (tune.best_config(self.dd.tune_key("stream")) or {}).get("storage_dtype")
        sd, _ = resolve_storage_dtype(
            self.storage_dtype_request, tuned, [h.dtype for h in self.handles], where=f"astaroth:{self.kernel_impl}",
            engine_ok=self.kernel_impl == "cuda", engine_why="the torch engine has no f32-accumulate kernels")
        self._storage_dtype = sd
        if sd != "native":
            self.dd.set_storage(sd)
        self.dd.realize()
        w = 2 * math.pi / self.period
        for h in self.handles:
            # float64 before the store, as the JAX package in 64-bit mode
            self.dd.init_by_coords(h, lambda x, y, z: torch.sin(w * (x + y + z).double()))
        # the JAX package's guardband (models/astaroth.py:146-155): the
        # mean-of-6 update is non-expansive, so every quantity stays under
        # its unit-amplitude init; the envelope sits at 1.5x
        self.dd.numerics().register_guardband(
            magnitude_envelope(1.5, quantities=tuple(h.name for h in self.handles)))
        if self.dd.halo_multiplier() != 1 and self.schedule == "per-step":
            raise ValueError(
                "schedule='per-step' (exchange-cadence parity) contradicts a halo multiplier; "
                "use schedule='auto'"
            )
        if self.kernel_impl == "cuda":
            if not self.overlap:
                raise ValueError(
                    "overlap=False has no meaning for the stream engine's step; use "
                    "kernel_impl='torch' for overlap comparisons"
                )
        elif self.schedule == "wavefront":
            raise ValueError("schedule='wavefront' requires kernel_impl='cuda'")
        self._step = self._build_step()

    def _build_step(self):
        if self.kernel_impl == "cuda":
            path = {"auto": "auto", "wavefront": "wavefront", "per-step": "plane"}[self.schedule]
            step = self.dd.make_step(
                self._kernel,
                engine="stream",
                x_radius=1,
                stream_path=path,
                # _kernel updates each field from itself only, so many-field
                # runs may stream per field at full wavefront depth
                separable=True,
                stream_overlap=self.stream_overlap,
                stream_halo=self.stream_halo,
                compute_unit=self.compute_unit,
                mxu_input=self.mxu_input,
                # the declared axis-separable contraction form: what lets
                # compute_unit=mxu engage on this kernel
                mxu_kernel=self._kernel_mxu,
            )
            self._compute_unit = step._stream_plan["compute_unit"]
            self._mxu_input = step._stream_plan["mxu_input"]
            return step
        # the torch engine has no contraction kernels: an explicit request
        # degrades with a warning (the JAX package's XLA engine's resolver)
        where = "astaroth:torch"
        self._compute_unit, _ = resolve_compute_unit(
            self.compute_unit, None, [h.dtype for h in self.handles], where=where, engine_ok=False,
            engine_why="the torch engine has no contraction kernels")
        self._mxu_input, _ = resolve_mxu_input(self.mxu_input, None, self._compute_unit, where=where)
        return self.dd.make_step(self._kernel, overlap=self.overlap)

    def rebuild_after_reshard(self) -> None:
        """Rebuild the step for the domain's CURRENT buffers: the
        supervisor's ``on_mesh_change`` hook, after its fallback re-realized
        the domain (the ``Jacobi3D`` twin)."""
        self._step = self._build_step()

    @property
    def _wavefront_m(self) -> int:
        """The wavefront depth (0 off the wavefront route)."""
        plan = getattr(self._step, "_stream_plan", None)
        if plan is not None and plan["route"] == "wavefront":
            return plan["m"]
        return 0

    @staticmethod
    def _kernel(views, info):
        # iterate the views HANDED IN (not self.handles): each field updates
        # from itself only, so the kernel is correct on any subset
        out = {}
        for name, src in views.items():
            out[name] = (
                src.sh(-1, 0, 0)
                + src.sh(0, -1, 0)
                + src.sh(0, 0, -1)
                + src.sh(1, 0, 0)
                + src.sh(0, 1, 0)
                + src.sh(0, 0, 1)
            ) / 6.0
        return out

    @staticmethod
    def _kernel_mxu(views, info):
        # the SAME mean-of-6 with its four in-plane taps written through the
        # contraction seam (PlaneView.plane_nbr_sum): contracted on the
        # tensor cores under compute_unit=mxu / mxu_band, the load chain
        # y+1, y-1, z+1, z-1 under vpu; the x taps stay plane reads
        out = {}
        for name, src in views.items():
            out[name] = (src.sh(-1, 0, 0) + src.sh(1, 0, 0) + src.plane_nbr_sum()) / 6.0
        return out

    def step(self, steps: int = 1) -> None:
        """Advance ``steps`` RAW iterations.  The torch engine under a halo
        multiplier is built in macro steps, so ``steps`` must divide into
        whole macros there."""
        mult = self.dd.halo_multiplier()
        if self.kernel_impl == "torch" and mult > 1:
            if steps % mult:
                raise ValueError(
                    f"steps={steps} must be a multiple of the halo multiplier {mult} on the torch "
                    "engine (macro steps)"
                )
            steps //= mult
        self.dd.run_step(self._step, steps, label="astaroth")

    def field(self, i: int = 0) -> np.ndarray:
        return self.dd.quantity_to_host(self.handles[i])

    def state(self) -> List[np.ndarray]:
        """Every quantity as the JAX package's raw global array
        ``(px*Xr, py*Yr, pz*Zr)`` (a stale shell is refreshed first)."""
        return [self.dd.raw_to_host(h) for h in self.handles]

    def load_state(self, raws: Sequence[np.ndarray]) -> None:
        """Load raw global arrays in the JAX package's layout (its
        ``raw_to_host``), one per quantity: the simulation's whole state."""
        if len(raws) != len(self.handles):
            raise ValueError(f"{len(raws)} arrays for {len(self.handles)} quantities")
        for h, raw in zip(self.handles, raws):
            self.dd.set_raw(h, np.asarray(raw))

    def block_until_ready(self) -> None:
        self.dd.block_until_ready()
