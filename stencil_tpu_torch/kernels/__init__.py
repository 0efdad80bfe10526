"""Kernel build, binding and bookkeeping shared by the ops wrappers.

``build`` compiles ``csrc/*.cu`` (imported lazily by the wrappers, so this
package imports on a CPU-only install); ``ledger`` maps every TPU kernel of
the JAX package to its port.  The helpers below are the wrappers' common
argument checks.
"""

from __future__ import annotations

import torch


def check_tensor(t: torch.Tensor, what: str, ndims=None, dtype=None) -> None:
    """Raise on what a kernel does not take: a non-tensor, a device other
    than cpu/cuda, a wrong rank or dtype, or a non-contiguous layout."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} lies on {t.device}; the kernels run on cuda (plain versions on cpu)")
    if ndims is not None and t.dim() not in ndims:
        raise ValueError(f"{what} must have {' or '.join(map(str, ndims))} dims, got shape {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be C-contiguous")


def check_out(out: torch.Tensor, like: torch.Tensor, what: str = "out") -> torch.Tensor:
    """Raise unless ``out`` can take a result shaped like ``like``: a
    contiguous tensor of its shape, dtype and device that is not ``like``
    itself (the kernels write ``out`` while they read ``like``)."""
    check_tensor(out, what, ndims=(like.dim(),), dtype=like.dtype)
    if out.shape != like.shape or out.device != like.device:
        raise ValueError(f"{what} {tuple(out.shape)} on {out.device} must match {tuple(like.shape)} on {like.device}")
    if out.data_ptr() == like.data_ptr():
        raise ValueError(f"{what} must not alias its input")
    return out


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors lie on different devices: {dev} and {t.device}")
    return dev


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle the C
    interface takes."""
    return torch.cuda.current_stream(device).cuda_stream


def current_raw_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device ``index``,
    read without building a ``torch.cuda.Stream`` as ``stream_handle`` does
    (the call Triton's launcher makes).  The descriptor launches use it."""
    return torch._C._cuda_getCurrentRawStream(index)


#: the query whose line every record of a card's numbers carries: the name
#: and the power limit, as ``nvidia-smi`` prints them
NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")


def toolchain() -> dict:
    """What the kernels are built and run with: ``torch`` and ``cuda``
    (``torch.__version__``, ``torch.version.cuda``; None on a CPU build),
    ``device`` (``torch.cuda.get_device_name(0)``, or None), ``card`` (the
    first line of ``NVIDIA_SMI_QUERY``'s output, ``name, power limit``, or
    None), ``power_limit`` (its second field, or None), ``nvcc`` (its path,
    or None) and ``triton`` (whether the package imports).  Never raises:
    on a machine without a card every card field is None.  The tune cache
    stamps its files with ``torch`` and ``cuda``."""
    import importlib.util
    import subprocess

    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "device": None, "card": None,
           "power_limit": None, "nvcc": None, "triton": importlib.util.find_spec("triton") is not None}
    try:
        if torch.cuda.is_available():
            out["device"] = torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 - a driver that fails to answer is no card
        pass
    try:
        lines = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=30,
                               check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    if lines:
        out["card"] = lines[0].strip()
        parts = [p.strip() for p in out["card"].split(",")]
        out["power_limit"] = parts[1] if len(parts) > 1 else None
    from stencil_tpu_torch.kernels import build

    try:
        out["nvcc"] = build.find_nvcc()
    except build.KernelBuildError:
        pass
    return out
