"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, built at first use into ``_build/`` inside the package (listed in
``.gitignore``).  A kernel TEMPLATE (``TEMPLATE_SIGNATURES``: the stream
kernels) is a ``csrc/<name>.cu`` whose line ``// @STP_GENERATED@`` takes a
generated part, the traced user kernel's body that ``ops/stream_trace.py``
emits; each (template, generated part) pair is written to ``_build/`` and
becomes a library of its own.  Every build runs

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas -v

No ``--use_fast_math``, and ``--fmad=false`` so no add/multiply contracts: the
kernels are held bitwise against their plain versions.  ``build()`` and
``build_generated()`` start one nvcc per source at once and wait for all of
them.  A library is named by a hash of its source text and flags, so an
edited source or a new kernel body rebuilds.  If nvcc is missing or a build
fails this raises ``KernelBuildError`` with the compiler's output; there is no
fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
_L = ctypes.c_int64

#: exported C functions per source, with their argument types (every pointer
#: and the stream as c_void_p, so ctypes does not cut them to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "jacobi": {
        "stp_jacobi_wrap_level": [_P, _P] + [_I] * 8 + [_P],
        "stp_jacobi_plane_level": [_P] * 4 + [_I] * 8 + [_P],
    },
    "halo_blend": {
        "stp_blend_slab": [_P, _P, _I, _L, _L, _L, _L, _I, _L, _L, _P],
        "stp_blend_slab_dynamic": [_P, _P, _P, _I, _L, _L, _L, _L, _I, _L, _P],
    },
    "jacobi_slab": {
        "stp_jacobi_slab_level": [_P] * 10 + [_I] * 8 + [_P],
    },
    "jacobi_wavefront": {
        "stp_jacobi_wavefront": [_P] * 6 + [_I] * 13 + [_P],
    },
    "pack": {
        fn: [_P, _P, _I] + [_L] * 6 + [_P]
        for fn in ("stp_pack_zshell", "stp_unpack_zshell", "stp_pack_yshell", "stp_unpack_yshell")
    },
}
SOURCES = tuple(SIGNATURES)

_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers, one per field

#: kernel templates, with the exported C functions of every library built
#: from them
TEMPLATE_SIGNATURES: Dict[str, Dict[str, list]] = {
    "stream_wrap": {
        "stp_stream_wrap_level": [_PP, _PP, _P] + [_I] * 7 + [_P],
    },
    "stream_plane": {
        "stp_stream_plane_level": [_PP, _PP, _P] + [_I] * 13 + [_P],
    },
    "stream_wavefront": {
        "stp_stream_wavefront": [_PP] * 4 + [_P] + [_I] * 11 + [_P],
    },
}

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
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _digest(text: bytes) -> str:
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        return os.path.join(BUILD_DIR, f"lib{name}-{_digest(f.read())}.so")


def _compile(jobs: Sequence[Tuple[str, str, str]]) -> None:
    """Run one nvcc per ``(label, source, library)`` job whose library is not
    built yet, all started together, and wait for all of them."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for label, src, so in jobs:
        if os.path.exists(so):
            # keep the record of the build that made it, if this process did
            BUILD_LOG.setdefault(label, {"seconds": 0.0, "cached": True, "output": ""})
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
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
    _compile([(name, source_path(name), paths[name]) for name in names])
    return paths


def generated_source(template: str, generated: str) -> str:
    """The full source of ``csrc/<template>.cu`` with ``generated`` (the
    defines and ``stp_body`` of one traced kernel) in place of its hook."""
    if template not in TEMPLATE_SIGNATURES:
        raise KeyError(f"unknown kernel template {template!r} (one of {tuple(TEMPLATE_SIGNATURES)})")
    with open(source_path(template)) as f:
        text = f.read()
    if text.count(GENERATED_HOOK) != 1:
        raise KernelBuildError(f"{source_path(template)} has no single {GENERATED_HOOK.strip()!r} line")
    return text.replace(GENERATED_HOOK, generated)


def _generated_paths(template: str, text: str) -> Tuple[str, str, str]:
    tag = f"{template}-{_digest(text.encode())}"
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
