"""Workload keys: what a tuned config is for (counterpart of
``stencil_tpu/tune/key.py``).

A config measured on one workload is never applied to another: the depth
plateau, the layout and the unit picks move with the card, the domain's
shape, the dtype, the field count, the subdomain grid, the radius and the
engine route.  ``WorkloadKey`` pins all seven; the torch / CUDA toolchain is
checked apart by the cache (``cache.py``), so a toolchain upgrade turns every
stored config into a miss without changing the key or the file name.

The fields, ``to_dict``, the JSON canonicalisation of ``digest`` and
``label`` are the JAX package's, so one dict gives the same 16-hex digest in
both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Tuple


def chip_kind(device=None) -> str:
    """The card kind tuned configs are keyed by: ``torch.cuda.get_device_name``
    when CUDA is up (of ``device`` when it is a CUDA device), else ``"cpu"``
    (and ``"cpu"`` for a CPU ``device``: a CPU run's plain versions are not
    the card's kernels)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    try:
        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name(device))
    except Exception:  # noqa: BLE001 - a driver that fails to answer is no card
        pass
    return "cpu"


@dataclasses.dataclass(frozen=True)
class WorkloadKey:
    """One tunable workload: (card kind, global domain shape, dtype,
    n_fields, subdomain grid, radius, engine route)."""

    chip: str
    domain: Tuple[int, int, int]
    dtype: str
    n_fields: int
    mesh: Tuple[int, int, int]
    radius: int
    route: str  # "jacobi-wrap" | "jacobi-wavefront" | "stream" | "exchange"

    def to_dict(self) -> dict:
        return {
            "chip": self.chip,
            "domain": list(self.domain),
            "dtype": self.dtype,
            "n_fields": self.n_fields,
            "mesh": list(self.mesh),
            "radius": self.radius,
            "route": self.route,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadKey":
        return cls(
            chip=str(d["chip"]),
            domain=tuple(int(v) for v in d["domain"]),
            dtype=str(d["dtype"]),
            n_fields=int(d["n_fields"]),
            mesh=tuple(int(v) for v in d["mesh"]),
            radius=int(d["radius"]),
            route=str(d["route"]),
        )

    def digest(self) -> str:
        """Stable content hash: the cache file's stem."""
        canon = json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    def label(self) -> str:
        """Log and fault-plan label, e.g.
        ``jacobi-wrap:512x512x512:float32x1:mesh1x1x1``."""
        return (
            f"{self.route}:{'x'.join(map(str, self.domain))}:"
            f"{self.dtype}x{self.n_fields}:mesh{'x'.join(map(str, self.mesh))}"
        )
