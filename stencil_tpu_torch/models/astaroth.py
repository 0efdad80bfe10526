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

Not ported: the MXU form (``_kernel_mxu``, ``compute_unit="mxu"``; ROADMAP.md
queue 1 item 9), bf16 storage (item 9), the numerics guardband and
divergence sentinel (items 10/11), ``rebuild_after_reshard`` and the tune
cache (items 11/13).  Each raises ``NotImplementedError`` naming its item
where the JAX package takes an argument for it.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
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
        check_divergence_every: int = 0,  # only 0: the sentinel is not ported
        stream_overlap: str = "auto",
        stream_halo: str = "auto",
        exchange_route: str = None,
        compute_unit: str = "auto",
        mxu_input: str = "auto",
        storage_dtype: str = None,
        device="cuda",
    ):
        if kernel_impl not in ("torch", "cuda"):
            raise ValueError(f"unknown kernel_impl {kernel_impl!r} (torch | cuda)")
        if schedule not in ("auto", "per-step", "wavefront"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if check_divergence_every:
            raise NotImplementedError(
                "the divergence sentinel is not ported yet (ROADMAP.md queue 1 items 10/11)"
            )
        if storage_dtype not in (None, "auto", "native"):
            raise NotImplementedError(
                f"storage_dtype={storage_dtype!r} is not ported yet (ROADMAP.md queue 1 item 9)"
            )
        if compute_unit not in ("auto", "vpu") or mxu_input not in ("auto", "f32"):
            raise NotImplementedError(
                f"compute_unit={compute_unit!r}, mxu_input={mxu_input!r}: only vpu/f32 is ported "
                "(ROADMAP.md queue 1 item 9)"
            )
        self.dd = DistributedDomain(x, y, z, device=device)
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
        self._step = None

    def realize(self) -> None:
        self.dd.realize()
        w = 2 * math.pi / self.period
        for h in self.handles:
            # float64 before the store, as the JAX package in 64-bit mode
            self.dd.init_by_coords(h, lambda x, y, z: torch.sin(w * (x + y + z).double()))
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
            return self.dd.make_step(
                self._kernel,
                engine="stream",
                x_radius=1,
                stream_path=path,
                # _kernel updates each field from itself only, so many-field
                # runs may stream per field at full wavefront depth
                separable=True,
                stream_overlap=self.stream_overlap,
                stream_halo=self.stream_halo,
            )
        return self.dd.make_step(self._kernel, overlap=self.overlap)

    @property
    def _wavefront_m(self) -> int:
        """The wavefront depth (0 off the wavefront route)."""
        plan = getattr(self._step, "_stream_plan", None)
        if plan is not None and plan["route"] == "wavefront":
            return plan["m"]
        return 0

    def _kernel(self, views, info):
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
        self.dd.run_step(self._step, steps)

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
