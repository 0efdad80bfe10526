"""Foundation geometry types: pure Python, no torch needed."""

from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.direction_map import DIRECTIONS_26, DirectionMap
from stencil_tpu_torch.core.geometry import LocalSpec
from stencil_tpu_torch.core.radius import Radius

__all__ = ["Dim3", "Rect3", "DirectionMap", "DIRECTIONS_26", "Radius", "LocalSpec"]
