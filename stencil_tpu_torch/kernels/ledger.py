"""The port's kernel ledger: every TPU kernel of the JAX package and its port.

Keyed by the JAX package's ``(file, function)`` pairs, the same set as
``PALLAS_KERNELS`` in ``stencil_tpu/analysis/registry.py``.  A ported entry
names the port's wrapper (which launches the hand-written kernel on CUDA
tensors), its plain PyTorch version, the CUDA source and the line of the TPU
kernel it replaces.  Every entry is ported.  ``FORMS`` lists the forms of a
ported kernel that count their launches apart (the fused forms of the stream
plane and wavefront kernels; the stream kernels' bf16-storage and float64
builds, ``ops/stream.py`` ``_count``; the Jacobi kernels' bf16-storage,
float64 and tensor-core forms, ``ops/jacobi_kernels.py`` ``form_counter``;
the mean-of-6 kernels' bf16-storage and float64 forms; the tensor-core
contraction forms of the stream and mean-of-6 kernels, and of the stream
plane and wavefront kernels' fused forms), by the wrapper's counter that
counts them.
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


PORTED_KERNELS: Dict[Tuple[str, str], dict] = {
    (_JP, "jacobi_wrap_step"): _ported(
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_wrap_step",
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_wrap_step_plain",
        "stencil_tpu_torch/csrc/jacobi_wavefront.cu",
        f"{_JP}:869",
    ),
    (_JP, "jacobi_plane_step"): _ported(
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_plane_step",
        "stencil_tpu_torch.ops.jacobi_kernels:jacobi_plane_step_plain",
        "stencil_tpu_torch/csrc/jacobi_wavefront.cu",
        f"{_JP}:1484",
    ),
    (_HB, "blend_slab"): _ported(
        "stencil_tpu_torch.ops.halo_blend:blend_slab",
        "stencil_tpu_torch.ops.halo_blend:blend_slab_plain",
        "stencil_tpu_torch/csrc/pack.cu",
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
        "stencil_tpu_torch/csrc/jacobi_wavefront.cu",
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
        "stencil_tpu_torch/csrc/pack.cu",
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
                         ("pack_yshell_pallas", 422), ("unpack_yshell_pallas", 449),
                         ("pallas_pack_slab", 197), ("pallas_unpack_slab", 225))
    },
    (_PS, "mean6_shell_wavefront_step"): _ported(
        "stencil_tpu_torch.ops.plane_stencil:mean6_shell_wavefront_step",
        "stencil_tpu_torch.ops.plane_stencil:mean6_shell_wavefront_step_plain",
        "stencil_tpu_torch/csrc/jacobi_wavefront.cu",
        f"{_PS}:20",
    ),
    (_PS, "mean6_plane_step"): _ported(
        "stencil_tpu_torch.ops.plane_stencil:mean6_plane_step",
        "stencil_tpu_torch.ops.plane_stencil:mean6_plane_step_plain",
        "stencil_tpu_torch/csrc/plane_stencil.cu",
        f"{_PS}:114",
    ),
}


#: forms of a ported kernel whose launches its wrapper counts apart:
#: name -> (the ported entry's key, the wrapper's counter)
FORMS: Dict[str, Tuple[Tuple[str, str], str]] = {
    "stream_plane_pass_fused": ((_ST, "stream_plane_pass"), "fused_launches"),
    "stream_wavefront_pass_fused": ((_ST, "stream_wavefront_pass"), "fused_launches"),
    # the stream kernels' field dtypes: bf16 storage (float levels) and
    # float64 fields (a group with one), each in the array and fused forms
    **{f"stream_{fn}_pass_{dt}": ((_ST, f"stream_{fn}_pass"), f"{dt}_launches")
       for fn in ("wrap", "plane", "wavefront") for dt in ("bf16", "f64")},
    **{f"stream_{fn}_pass_fused_{dt}": ((_ST, f"stream_{fn}_pass"), f"fused_{dt}_launches")
       for fn in ("plane", "wavefront") for dt in ("bf16", "f64")},
    # the Jacobi kernels' axes: bf16 storage (vpu), and the tensor-core
    # contraction on f32 / bf16 operands (either storage)
    **{f"{fn}_{form}": ((_JP, fn), f"{form}_launches")
       for fn in ("jacobi_wrap_step", "jacobi_zring_wavefront_step", "jacobi_shell_wavefront_step")
       for form in ("bf16", "mxu", "mxu_bf16in")},
    **{f"{fn}_bf16": ((_JP, fn), "bf16_launches") for fn in ("jacobi_plane_step", "jacobi_slab_step")},
    # float64 fields on the five Jacobi kernels (their float64 build)
    **{f"{fn}_f64": ((_JP, fn), "f64_launches")
       for fn in ("jacobi_wrap_step", "jacobi_zring_wavefront_step", "jacobi_shell_wavefront_step",
                  "jacobi_plane_step", "jacobi_slab_step")},
    # the mean-of-6 kernels' bf16 storage and float64 fields
    **{f"{fn}_{dt}": ((_PS, fn), f"{dt}_launches")
       for fn in ("mean6_shell_wavefront_step", "mean6_plane_step") for dt in ("bf16", "f64")},
    # the tensor-core contraction on f32 / bf16 operands (either storage) of
    # the stream kernels and the mean-of-6 kernels
    **{f"stream_{fn}_pass_{form}": ((_ST, f"stream_{fn}_pass"), f"{form}_launches")
       for fn in ("wrap", "plane", "wavefront") for form in ("mxu", "mxu_bf16in")},
    **{f"{fn}_{form}": ((_PS, fn), f"{form}_launches")
       for fn in ("mean6_shell_wavefront_step", "mean6_plane_step") for form in ("mxu", "mxu_bf16in")},
    # the fused forms of the stream plane and wavefront kernels under the
    # contraction, on f32 / bf16 operands (either storage)
    **{f"stream_{fn}_pass_fused_{form}": ((_ST, f"stream_{fn}_pass"), f"fused_{form}_launches")
       for fn in ("plane", "wavefront") for form in ("mxu", "mxu_bf16in")},
}


def resolve(dotted: str):
    """``"pkg.module:function"`` -> the function."""
    mod, fn = dotted.split(":")
    return getattr(importlib.import_module(mod), fn)


def ported() -> Dict[Tuple[str, str], dict]:
    return {k: v for k, v in PORTED_KERNELS.items() if v["status"] == "ported"}


def wrapper_name(entry: dict) -> str:
    return entry["kernel"].split(":")[1]


def form_entry(name: str) -> dict:
    """The ported entry of a ``FORMS`` form (its kernel's, with its counter)."""
    key, counter = FORMS[name]
    return dict(PORTED_KERNELS[key], counter=counter)


def _counters() -> Dict[str, Tuple[object, str]]:
    """Each launch counter: name -> (the wrapper that holds it, its attribute)."""
    out = {wrapper_name(e): (resolve(e["kernel"]), "launches") for e in ported().values()}
    for name in FORMS:
        e = form_entry(name)
        out[name] = (resolve(e["kernel"]), e["counter"])
    return out


def launch_counts() -> Dict[str, int]:
    """Kernel launches per ported wrapper, and per ``FORMS`` form, since the
    last reset."""
    return {name: getattr(obj, attr) for name, (obj, attr) in _counters().items()}


def counter(name: str) -> Tuple[object, str]:
    """``(wrapper, attribute)`` of the counter ``launch_counts`` reports as ``name``."""
    return _counters()[name]


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set the named counters (``launch_counts``' names) to the given values."""
    found = _counters()
    for name, value in counts.items():
        obj, attr = found[name]
        setattr(obj, attr, value)


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(_counters(), 0))
