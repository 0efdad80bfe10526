"""stencil_tpu_torch: the PyTorch + CUDA port of stencil_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  It imports
torch, numpy and the standard library only.  Layout at public functions is the
JAX package's: (X, Y, Z), C-contiguous, Z fastest.  Entry points take
``device=`` (default ``"cuda"``); the hand-written kernels in ``csrc/`` build
with nvcc at first use.
"""

from stencil_tpu_torch.core.dim3 import Dim3, Rect3
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.utils.config import MethodFlags, PlacementStrategy

__all__ = ["Dim3", "Rect3", "Radius", "DistributedDomain", "MethodFlags", "PlacementStrategy"]
