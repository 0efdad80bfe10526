"""Device choice for every entry point of the package.

Entry points take ``device=`` and default to ``"cuda"``.  Without a GPU the
caller must ask for the CPU explicitly (``device="cpu"``), which runs each
kernel's plain PyTorch version; nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
