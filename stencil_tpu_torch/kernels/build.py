"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, built at first use into ``_build/`` inside the package (listed in
``.gitignore``).  A kernel TEMPLATE (``TEMPLATE_SIGNATURES``: the stream
kernels) is a ``csrc/<name>.cu`` whose line ``// @STP_GENERATED@`` takes a
generated part, the traced user kernel's body that ``ops/stream_trace.py``
emits; each (template, generated part) pair is written to ``_build/`` and
becomes a library of its own.  A VARIANT (``VARIANTS``: the kernel axes of
``csrc/jacobi_wavefront.cu``) is a source built once more with defines, a
library of its own beside the plain one.  Every build runs

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas -v

No ``--use_fast_math``, and ``--fmad=false`` so no add/multiply contracts: the
kernels are held bitwise against their plain versions.  ``build()`` and
``build_generated()`` start one nvcc per source at once and wait for all of
them.  A source may include the headers of ``csrc/`` (``#include
"<name>.cuh"``; nvcc runs with ``-I csrc``).  A library is named by a hash of
its source text, the text of the headers it includes and its flags, so an
edited source or header or a new kernel body rebuilds.  If nvcc is missing or a build
fails this raises ``KernelBuildError`` with the compiler's output; there is no
fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Sequence, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the entries of every build of ``csrc/jacobi_wavefront.cu`` (the
#: wavefront, wrap and mean-of-6 forms), and of its vpu builds (the plane and
#: slab forms)
_JACOBI_MARCHES = {
    "stp_jacobi_wavefront": [_P] * 7 + [_I] * 13 + [_P],
    "stp_jacobi_wavefront_plan": [_I] * 9 + [ctypes.POINTER(ctypes.c_int)],
    "stp_jacobi_wrap": [_P] * 3 + [_I] * 7 + [_P],
    "stp_jacobi_wrap_plan": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)],
    # the mean-of-6 form (ops/plane_stencil.py)
    "stp_mean6_march": [_P] * 3 + [_I] * 6 + [_P],
    "stp_mean6_march_plan": [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
}
_JACOBI_VPU = {
    "stp_jacobi_plane": [_P] * 4 + [_I] * 8 + [_P],
    "stp_jacobi_plane_plan": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)],
    "stp_jacobi_slab": [_P] * 10 + [_I] * 8 + [_P],
    "stp_jacobi_slab_plan": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)],
}

#: builds of a source with defines, each a library of its own: name ->
#: (source, defines).  ``csrc/jacobi_wavefront.cu``'s kernel axes
#: (ops/jacobi_kernels.py ``library_name``): bf16 storage, float64 fields,
#: and the tensor-core contraction on f32 (TF32 pieces) or bf16 operands,
#: either storage
VARIANTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "jacobi_wavefront_bf16": ("jacobi_wavefront", ("-DSTP_JW_STORAGE=1",)),
    "jacobi_wavefront_f64": ("jacobi_wavefront", ("-DSTP_JW_STORAGE=2",)),
    "jacobi_wavefront_mxu": ("jacobi_wavefront", ("-DSTP_JW_UNIT=1",)),
    "jacobi_wavefront_mxu_bf16": ("jacobi_wavefront", ("-DSTP_JW_UNIT=1", "-DSTP_JW_STORAGE=1")),
    "jacobi_wavefront_mxu16": ("jacobi_wavefront", ("-DSTP_JW_UNIT=2",)),
    "jacobi_wavefront_mxu16_bf16": ("jacobi_wavefront", ("-DSTP_JW_UNIT=2", "-DSTP_JW_STORAGE=1")),
}

#: exported C functions per source, with their argument types (every pointer
#: and the stream as c_void_p, so ctypes does not cut them to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    **{name: {**_JACOBI_MARCHES, **_JACOBI_VPU}
       for name in ("jacobi_wavefront", "jacobi_wavefront_bf16", "jacobi_wavefront_f64")},
    **{name: dict(_JACOBI_MARCHES) for name in VARIANTS if "mxu" in name},
    "pack": {
        # descriptor entries: the address of a cached int64 descriptor, two
        # data pointers, the stream (ops/pack.py, ops/halo_blend.py)
        **{fn: [_P] * 4 for fn in ("stp_pack_slab_desc", "stp_unpack_slab_desc", "stp_pack_zshell_desc",
                                   "stp_unpack_zshell_desc", "stp_pack_yshell_desc", "stp_unpack_yshell_desc",
                                   "stp_blend_slab_desc")},
        # and the dynamic write's offsets (n int32 on the device) before the stream
        "stp_blend_slab_dynamic_desc": [_P] * 5,
    },
    # one entry a field dtype: float32, bf16 storage, float64; and the
    # contraction form's for float32 and bf16 storage (mxu_input 1 / 2 before
    # the stream)
    "plane_stencil": {
        **{f"stp_mean6_plane_level{sfx}": [_P, _P] + [_I] * 9 + [_P] for sfx in ("", "_bf16", "_f64")},
        **{f"stp_mean6_plane_level_mxu{sfx}": [_P, _P] + [_I] * 10 + [_P] for sfx in ("", "_bf16")},
    },
}
SOURCES = tuple(SIGNATURES)

_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers, one per field

#: kernel templates, with the exported C functions of every library built
#: from them
TEMPLATE_SIGNATURES: Dict[str, Dict[str, list]] = {
    "stream_wrap": {
        # in, out, origin; X, Y, Z, gx, gy, gz, level, in_acc, out_acc; stream
        "stp_stream_wrap_level": [_PP, _PP, _P] + [_I] * 9 + [_P],
    },
    "stream_plane": {
        "stp_stream_plane_level": [_PP, _PP, _P] + [_I] * 13 + [_P],
    },
    "stream_wavefront": {
        "stp_stream_wavefront": [_PP] * 4 + [_P] + [_I] * 11 + [_P],
        "stp_stream_wavefront_plan": [_I] * 8 + [ctypes.POINTER(ctypes.c_int)],
    },
    # the fused forms: the same sources built with STP_FUSED defined
    "stream_plane_fused": {
        "stp_stream_plane_fused": [_PP] * 5 + [_P] + [_I] * 14 + [_P],
    },
    "stream_wavefront_fused": {
        "stp_stream_wavefront_fused": [_PP] * 5 + [_P] + [_I] * 9 + [_P],
        "stp_stream_wavefront_plan": [_I] * 8 + [ctypes.POINTER(ctypes.c_int)],
    },
}

#: templates built from another template's source (with a define that the
#: generated part carries)
TEMPLATE_FILES = {"stream_plane_fused": "stream_plane", "stream_wavefront_fused": "stream_wavefront"}

#: the line of a template that its generated part replaces
GENERATED_HOOK = "// @STP_GENERATED@\n"

#: per source: build seconds, whether it was already built, and nvcc's
#: output (ptxas register and spill report)
BUILD_LOG: Dict[str, dict] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    search = os.pathsep.join([os.environ.get("PATH", ""), os.path.join(cuda_home, "bin")])
    nvcc = shutil.which("nvcc", path=search)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc was not found on PATH or in $CUDA_HOME/bin: the CUDA kernels "
            "of stencil_tpu_torch cannot be built.  Install the CUDA toolkit, "
            "or pass device='cpu' to run the plain PyTorch versions."
        )
    return nvcc


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{VARIANTS.get(name, (name,))[0]}.cu")


def variant_flags(name: str) -> Tuple[str, ...]:
    """The defines a build adds to ``NVCC_FLAGS`` (none but for ``VARIANTS``)."""
    return VARIANTS.get(name, (name, ()))[1]


@functools.lru_cache(maxsize=None)
def _header(name: str) -> bytes:
    with open(os.path.join(CSRC_DIR, name), "rb") as f:
        return f.read()


def _headers(text: bytes) -> bytes:
    """The text of the ``csrc/`` headers a source includes (``#include
    "<name>.cuh"``), in the order it includes them."""
    return b"".join(_header(name.decode()) for name in re.findall(rb'^#include "(\w+\.cuh)"', text, flags=re.M))


def _digest(text: bytes, extra: Sequence[str] = ()) -> str:
    return hashlib.sha256(text + _headers(text) + " ".join((*NVCC_FLAGS, *extra)).encode()).hexdigest()[:16]


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        return os.path.join(BUILD_DIR, f"lib{name}-{_digest(f.read(), variant_flags(name))}.so")


def _compile(jobs: Sequence[Tuple]) -> None:
    """Run one nvcc per ``(label, source, library[, defines])`` job whose
    library is not built yet, all started together, and wait for all of
    them."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for label, src, so, *extra in jobs:
        if os.path.exists(so):
            # keep the record of the build that made it, if this process did
            BUILD_LOG.setdefault(label, {"seconds": 0.0, "cached": True, "output": ""})
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(extra[0] if extra else ()), "-I", CSRC_DIR, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[label] = (proc, time.perf_counter(), tmp, so, src)
    errors = []
    for label, (proc, t0, tmp, so, src) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
        with open(f"{so}.log", "w") as f:  # the ptxas report, beside the library
            f.write(out)
        BUILD_LOG[label] = {"seconds": seconds, "cached": False, "output": out}
    if errors:
        raise KernelBuildError("\n".join(errors))


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build the named sources that are not built yet, one nvcc each, all
    started together.  Returns {name: library path}."""
    names = list(names)
    for name in names:
        if name not in SIGNATURES:
            raise KeyError(f"unknown kernel source {name!r} (one of {SOURCES})")
    paths = {name: library_path(name) for name in names}
    _compile([(name, source_path(name), paths[name], variant_flags(name)) for name in names])
    return paths


def generated_source(template: str, generated: str) -> str:
    """The full source of ``csrc/<template>.cu`` with ``generated`` (the
    defines and ``stp_body`` of one traced kernel) in place of its hook."""
    if template not in TEMPLATE_SIGNATURES:
        raise KeyError(f"unknown kernel template {template!r} (one of {tuple(TEMPLATE_SIGNATURES)})")
    with open(source_path(TEMPLATE_FILES.get(template, template))) as f:
        text = f.read()
    if text.count(GENERATED_HOOK) != 1:
        raise KernelBuildError(f"{source_path(template)} has no single {GENERATED_HOOK.strip()!r} line")
    return text.replace(GENERATED_HOOK, generated)


@functools.lru_cache(maxsize=None)
def _generated_tag(template: str, text: str) -> str:
    """``<template>-<digest>`` of one full template source, worked out once
    a process: a step looks its libraries up at every launch."""
    return f"{template}-{_digest(text.encode())}"


def _generated_paths(template: str, text: str) -> Tuple[str, str, str]:
    tag = _generated_tag(template, text)
    return tag, os.path.join(BUILD_DIR, f"{tag}.cu"), os.path.join(BUILD_DIR, f"lib{tag}.so")


def build_generated(sources: Iterable[Tuple[str, str]]) -> List[str]:
    """Build ``(template, full source text)`` pairs that are not built yet,
    one nvcc each, all started together.  Returns their library paths."""
    find_nvcc()  # raises before anything is written
    jobs = []
    for template, text in sources:
        label, src, so = _generated_paths(template, text)
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(f"{src}.{os.getpid()}.tmp", "w") as f:
                f.write(text)
            os.replace(f"{src}.{os.getpid()}.tmp", src)
        jobs.append((label, src, so))
    _compile(jobs)
    return [so for _, _, so in jobs]


def _bind(path: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.stp_error_string.argtypes = [ctypes.c_int]
    lib.stp_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = _bind(build([name])[name], SIGNATURES[name])
    return lib


def load_generated(template: str, text: str) -> ctypes.CDLL:
    """The loaded library of one full template source (``generated_source``),
    built at first use."""
    label = _generated_paths(template, text)[0]
    lib = _LIBS.get(label)
    if lib is None:
        path = build_generated([(template, text)])[0]
        lib = _LIBS[label] = _bind(path, TEMPLATE_SIGNATURES[template])
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned an error code."""
    if rc != 0:
        msg = "unsupported argument" if rc < 0 else lib.stp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA kernel launch failed ({rc}): {msg}")
