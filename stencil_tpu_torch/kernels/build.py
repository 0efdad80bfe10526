"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, built at first use into ``_build/`` inside the package (listed in
``.gitignore``) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --fmad=false -Xptxas -v

No ``--use_fast_math``, and ``--fmad=false`` so no add/multiply contracts: the
kernels are held bitwise against their plain versions.  ``build()`` starts one
nvcc per source at once and waits for all of them.  A library is named by a
hash of its source and flags, so an edited source rebuilds.  If nvcc is
missing or a build fails this raises ``KernelBuildError`` with the compiler's
output; there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

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
    },
    "jacobi_wavefront": {
        "stp_jacobi_wavefront": [_P] * 6 + [_I] * 13 + [_P],
    },
}
SOURCES = tuple(SIGNATURES)

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


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build the named sources that are not built yet, one nvcc each, all
    started together.  Returns {name: library path}."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, running = {}, {}
    for name in names:
        if name not in SIGNATURES:
            raise KeyError(f"unknown kernel source {name!r} (one of {SOURCES})")
        so = library_path(name)
        paths[name] = so
        if os.path.exists(so):
            # keep the record of the build that made it, if this process did
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "cached": True, "output": ""})
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, time.perf_counter(), tmp, so)
    errors = []
    for name, (proc, t0, tmp, so) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            errors.append(f"nvcc failed on {source_path(name)} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
        BUILD_LOG[name] = {"seconds": seconds, "cached": False, "output": out}
    if errors:
        raise KernelBuildError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.stp_error_string.argtypes = [ctypes.c_int]
        lib.stp_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned an error code."""
    if rc != 0:
        msg = "unsupported argument" if rc < 0 else lib.stp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA kernel launch failed ({rc}): {msg}")
