"""The port's kernel ledger: every TPU kernel of the JAX package and its port.

Keyed by the JAX package's ``(file, function)`` pairs, the same set as
``PALLAS_KERNELS`` in ``stencil_tpu/analysis/registry.py``.  A ported entry
names the port's wrapper (which launches the hand-written kernel on CUDA
tensors), its plain PyTorch version, the CUDA source and the line of the TPU
kernel it replaces.  An entry still to port stays in the ledger with status
``"to port"``; ROADMAP.md queue 2 orders them.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

_JP = "stencil_tpu/ops/jacobi_pallas.py"
_HB = "stencil_tpu/ops/halo_blend.py"
_PK = "stencil_tpu/ops/pack.py"
_PS = "stencil_tpu/ops/plane_stencil.py"
_ST = "stencil_tpu/ops/stream.py"


def _ported(wrapper: str, plain: str, source: str, replaces: str) -> dict:
    return {
        "status": "ported",
        "route": "cuda",
        "kernel": wrapper,
        "plain": plain,
        "source": source,
        "replaces": replaces,
    }


def _to_port(replaces: str) -> dict:
    return {"status": "to port", "replaces": replaces}


PORTED_KERNELS: Dict[Tuple[str, str], dict] = {
    (_JP, "jacobi_wrap_step"): _ported(
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_wrap_step",
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_wrap_step_plain",
        "stencil_tpu_torch/csrc/jacobi.cu",
        f"{_JP}:869",
    ),
    (_JP, "jacobi_plane_step"): _ported(
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_plane_step",
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_plane_step_plain",
        "stencil_tpu_torch/csrc/jacobi.cu",
        f"{_JP}:1484",
    ),
    (_HB, "blend_slab"): _ported(
        "stencil_tpu_torch.ops.halo_blend:blend_slab",
        "stencil_tpu_torch.ops.halo_blend:blend_slab_plain",
        "stencil_tpu_torch/csrc/halo_blend.cu",
        f"{_HB}:84",
    ),
    (_JP, "jacobi_zring_wavefront_step"): _ported(
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_zring_wavefront_step",
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_zring_wavefront_step_plain",
        "stencil_tpu_torch/csrc/jacobi_wavefront.cu",
        f"{_JP}:1204",
    ),
    (_JP, "jacobi_shell_wavefront_step"): _ported(
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_shell_wavefront_step",
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_shell_wavefront_step_plain",
        "stencil_tpu_torch/csrc/jacobi_wavefront.cu",
        f"{_JP}:983",
    ),
    (_JP, "jacobi_slab_step"): _ported(
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_slab_step",
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_slab_step_plain",
        "stencil_tpu_torch/csrc/jacobi_slab.cu",
        f"{_JP}:1347",
    ),
    (_ST, "stream_wrap_pass"): _ported(
        "stencil_tpu_torch.ops.stream:stream_wrap_pass",
        "stencil_tpu_torch.ops.stream:stream_wrap_pass_plain",
        "stencil_tpu_torch/csrc/stream_wrap.cu",
        f"{_ST}:698",
    ),
    (_ST, "stream_plane_pass"): _ported(
        "stencil_tpu_torch.ops.stream:stream_plane_pass",
        "stencil_tpu_torch.ops.stream:stream_plane_pass_plain",
        "stencil_tpu_torch/csrc/stream_plane.cu",
        f"{_ST}:279",
    ),
    (_ST, "stream_wavefront_pass"): _ported(
        "stencil_tpu_torch.ops.stream:stream_wavefront_pass",
        "stencil_tpu_torch.ops.stream:stream_wavefront_pass_plain",
        "stencil_tpu_torch/csrc/stream_wavefront.cu",
        f"{_ST}:481",
    ),
    (_HB, "blend_slab_dynamic"): _ported(
        "stencil_tpu_torch.ops.halo_blend:blend_slab_dynamic",
        "stencil_tpu_torch.ops.halo_blend:blend_slab_dynamic_plain",
        "stencil_tpu_torch/csrc/halo_blend.cu",
        f"{_HB}:179",
    ),
    **{
        (_PK, fn): _ported(
            f"stencil_tpu_torch.ops.pack:{fn}",
            f"stencil_tpu_torch.ops.pack:{fn}_plain",
            "stencil_tpu_torch/csrc/pack.cu",
            f"{_PK}:{line}",
        )
        for fn, line in (("pack_zshell_pallas", 331), ("unpack_zshell_pallas", 358),
                         ("pack_yshell_pallas", 422), ("unpack_yshell_pallas", 449))
    },
    (_PK, "pallas_pack_slab"): _to_port(f"{_PK}:197"),
    (_PK, "pallas_unpack_slab"): _to_port(f"{_PK}:225"),
    (_PS, "mean6_shell_wavefront_step"): _to_port(f"{_PS}:20"),
    (_PS, "mean6_plane_step"): _to_port(f"{_PS}:114"),
}


def resolve(dotted: str):
    """``"pkg.module:function"`` -> the function."""
    mod, fn = dotted.split(":")
    return getattr(importlib.import_module(mod), fn)


def ported() -> Dict[Tuple[str, str], dict]:
    return {k: v for k, v in PORTED_KERNELS.items() if v["status"] == "ported"}


def wrapper_name(entry: dict) -> str:
    return entry["kernel"].split(":")[1]


def launch_counts() -> Dict[str, int]:
    """Kernel launches per ported wrapper since the last reset."""
    return {wrapper_name(e): resolve(e["kernel"]).launches for e in ported().values()}


def reset_launch_counts() -> None:
    for e in ported().values():
        resolve(e["kernel"]).launches = 0
