"""The mean-of-6 kernels: ``mean6_plane_step``, ``mean6_shell_wavefront_step``
and their plain versions.

Counterpart of ``stencil_tpu/ops/plane_stencil.py`` in its ``vpu`` form: the
Jacobi level without the sphere clamp, over a block that carries a shell of
any width (the Astaroth proxy's radius-3 shell read at distance 1).  No route
of either package calls them.  On a CUDA tensor each wrapper launches its
hand-written kernel (``csrc/plane_stencil.cu``; the mean-of-6 form of
``csrc/jacobi_wavefront.cu``'s register-queue march, the Jacobi wavefront's
body without the sphere clamp); on a CPU tensor it runs the plain PyTorch
version.

Both sum the six neighbours as a left fold x-1, x+1, y-1, y+1, z-1, z+1
(``plane_stencil.py:188-195``) and multiply by ``SIXTH``, the float32 constant
XLA puts in place of the JAX source's ``/ 6.0`` (``SIXTH_F64``, the float64
reciprocal, at f64).

Field dtypes (``plane_stencil.py:64``, ``:148``): float32 and float64 blocks
compute at their own dtype; a bfloat16 block under ``f32_accumulate=True``
(bf16 storage) is upcast at load, its levels run at f32 and the result is
rounded once to bfloat16 (the plane kernel's shell passes through as its
stored bytes).  On the card each dtype runs its own build
(``stp_mean6_plane_level{,_bf16,_f64}``; ``jacobi_wavefront``, ``_bf16``,
``_f64``), counted under ``launches``, ``bf16_launches`` and
``f64_launches``.  A bfloat16 block without ``f32_accumulate`` (the JAX
kernels compute at bf16 then) is refused: ROADMAP.md queue 2.

The contraction form (``compute_unit`` ``mxu`` / ``mxu_band``, ``mxu_input``
``f32`` / ``bf16``; ``plane_stencil.py:64-100``, ``:149-215``): a level is
``(x-1 + x+1) + nbr``, ``nbr`` the in-plane neighbour sums of the centre
plane contracted against the band over the whole (Y, Z) plane, periodic
(``jk.plane_nbr_sum_host``: dense, or blocked under ``mxu_band`` where
the plane admits a band tile), the operand rounded to bfloat16 under
``mxu_input="bf16"``; ``mean6_plane_step`` slices it to the window.  On the
card the wavefront runs the mean-of-6 form of the tensor-core builds of
``csrc/jacobi_wavefront.cu`` and the plane kernel
``stp_mean6_plane_level_mxu{,_bf16}`` (``csrc/band_mma.cuh``), within 4
ulps a level of the plain versions; launches count under ``mxu_launches`` /
``mxu_bf16in_launches`` (either storage).  ``mxu_band`` on a plane without
a band tile degrades to ``mxu`` with a warning (``plane_band_unit``); a
float64 block under a contracting unit is refused, where the JAX kernel
asserts an f32 accumulator (``_check_compute_unit``).
"""

from __future__ import annotations

import ctypes

import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.kernels import check_tensor, current_raw_stream, same_device
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops.jacobi_kernels import WAVEFRONT_SUB_DEPTH, sixth


def _check_axes(block: torch.Tensor, compute_unit: str, f32_accumulate: bool, mxu_input: str) -> str:
    """Validate one call's axes; returns the block's dtype form: ``f32``,
    ``bf16`` (bf16 storage under ``f32_accumulate``) or ``f64``."""
    if mxu_input not in jk.MXU_INPUTS:
        raise ValueError(f"unknown mxu input {mxu_input!r} (one of {jk.MXU_INPUTS})")
    check_tensor(block, "block", ndims=(3,))
    if block.dtype == torch.bfloat16:
        if not f32_accumulate:
            raise TypeError("a bfloat16 block needs f32_accumulate=True (bf16 storage; the native bf16 form is "
                            "ROADMAP.md queue 2)")
        return "bf16"
    if block.dtype == torch.float64:
        if f32_accumulate:
            raise TypeError("f32_accumulate takes bfloat16 blocks; a float64 block computes at f64")
        return "f64"
    if block.dtype != torch.float32:
        raise TypeError(f"the mean6 kernels take float32, float64 or bfloat16 blocks, got {block.dtype}")
    return "f32"  # f32_accumulate changes nothing here


def _unit(block: torch.Tensor, compute_unit: str, mxu_input: str, where: str):
    """``(unit, mxu_input)`` of one call: the unit validated (a contraction
    on an f64 block raises, the JAX kernel's assert), ``mxu_band`` on a
    plane without a band tile degraded to ``mxu`` with a warning, the
    operands ``f32`` under ``vpu``."""
    jk._check_compute_unit(compute_unit, torch.float64 if block.dtype == torch.float64 else torch.float32)
    if not jk.unit_uses_mxu(compute_unit):
        return compute_unit, "f32"
    return jk.plane_band_unit(compute_unit, *block.shape[1:], where=where), mxu_input


def _counter(form: str, unit: str, mxu_input: str) -> str:
    """The launch counter of a call: its unit's form when it contracts
    (``jk.form_counter``), else its dtype form's."""
    return jk.form_counter(unit, mxu_input) if jk.unit_uses_mxu(unit) else _COUNTER[form]


#: a dtype form's C-entry suffix and launch counter
_SUFFIX = {"f32": "", "bf16": "_bf16", "f64": "_f64"}
_COUNTER = {"f32": "launches", "bf16": "bf16_launches", "f64": "f64_launches"}


def _check_out(block: torch.Tensor, out) -> None:
    if out is None:
        return
    check_tensor(out, "out", ndims=(3,), dtype=block.dtype)
    same_device(block, out)
    if out.shape != block.shape or out.data_ptr() == block.data_ptr():
        raise ValueError("out must be a separate tensor of the block's shape")


def _mean6(c: torch.Tensor, xs: slice, ys: slice, zs: slice, unit: str = "vpu",
           mxu_input: str = "f32") -> torch.Tensor:
    """One level at the cells ``c[xs, ys, zs]``, whose neighbours lie in
    ``c``, at ``c``'s working dtype (a bfloat16 block upcast to f32); under
    a contracting unit ``(x-1 + x+1) + nbr``, ``nbr`` over the whole (Y, Z)
    planes sliced to the cells."""
    c = c.to(jk.work_dtype(c.dtype))

    def sh(s: slice, d: int) -> slice:
        return slice(s.start + d, s.stop + d)

    s = c[sh(xs, -1), ys, zs] + c[sh(xs, 1), ys, zs]  # x-1, x+1
    if jk.unit_uses_mxu(unit):
        return (s + jk.plane_nbr_sum_host(c[xs], unit, mxu_input=mxu_input)[:, ys, zs]) * sixth(c.dtype)
    s = s + c[xs, sh(ys, -1), zs]  # y-1
    s = s + c[xs, sh(ys, 1), zs]  # y+1
    s = s + c[xs, ys, sh(zs, -1)]  # z-1
    s = s + c[xs, ys, sh(zs, 1)]  # z+1
    return s * sixth(c.dtype)


# --- mean6_plane_step ---------------------------------------------------------------


def _check_plane(block, lo: Dim3, hi: Dim3, out, axes) -> str:
    form = _check_axes(block, *axes)
    if not (lo.all_ge(1) and hi.all_ge(1)):
        # the distance-1 reads need a neighbour inside the allocation
        raise ValueError(f"every shell width must be >= 1, got lo={lo} hi={hi}")
    _check_out(block, out)
    return form


def mean6_plane_step_plain(block: torch.Tensor, lo, hi, compute_unit: str = "vpu", f32_accumulate: bool = False,
                           mxu_input: str = "f32", out: torch.Tensor = None) -> torch.Tensor:
    """One mean-of-6 level over the window ``[lo, N - hi)`` of every axis of
    an ``(X, Y, Z)`` block; the shell passes through.  Returns ``out`` (a
    fresh tensor when None), at the block's dtype: under ``f32_accumulate``
    the window's means are taken at f32 and rounded once to bfloat16."""
    lo, hi = Dim3.of(lo), Dim3.of(hi)
    _check_plane(block, lo, hi, out, (compute_unit, f32_accumulate, mxu_input))
    unit, mi = _unit(block, compute_unit, mxu_input, "mean6-plane")
    res = torch.empty_like(block) if out is None else out
    res.copy_(block)
    window = tuple(slice(lo[a], max(lo[a], block.shape[a] - hi[a])) for a in range(3))
    res[window] = _mean6(block, *window, unit, mi)
    return res


def mean6_plane_step(block: torch.Tensor, lo, hi, compute_unit: str = "vpu", f32_accumulate: bool = False,
                     mxu_input: str = "f32", out: torch.Tensor = None) -> torch.Tensor:
    """One mean-of-6 level over a shell-carrying block (per-axis shell widths
    ``lo``, ``hi`` >= 1; the shell passes through); arguments and result as
    ``mean6_plane_step_plain``.  On the card one launch of
    ``csrc/plane_stencil.cu``'s entry for the block's dtype, or its
    contraction entry for the storage (``stp_mean6_plane_level_mxu``,
    ``_mxu_bf16``) under a contracting unit."""
    lo, hi = Dim3.of(lo), Dim3.of(hi)
    form = _check_plane(block, lo, hi, out, (compute_unit, f32_accumulate, mxu_input))
    if block.device.type == "cpu":
        return mean6_plane_step_plain(block, lo, hi, compute_unit, f32_accumulate, mxu_input, out)
    unit, mi = _unit(block, compute_unit, mxu_input, "mean6-plane")
    res = torch.empty_like(block) if out is None else out
    stream = current_raw_stream(block.device.index)
    if jk.unit_uses_mxu(unit):
        entry, lib = jk._c_entry(f"stp_mean6_plane_level_mxu{_SUFFIX[form]}", "plane_stencil")
        rc = entry(block.data_ptr(), res.data_ptr(), *block.shape, *lo, *hi, 1 if mi == "f32" else 2, stream)
    else:
        entry, lib = jk._c_entry(f"stp_mean6_plane_level{_SUFFIX[form]}", "plane_stencil")
        rc = entry(block.data_ptr(), res.data_ptr(), *block.shape, *lo, *hi, stream)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "mean6_plane_step")
    jk._count(mean6_plane_step, _counter(form, unit, mi))
    return res


#: kernel launches made by ``mean6_plane_step``, by dtype form and, where it
#: contracts, by unit form (plain-version calls do not count)
jk._zero_counters(mean6_plane_step, jk.CONTRACTION_COUNTERS)


# --- mean6_shell_wavefront_step -----------------------------------------------------

#: the deepest level count one call takes: ``csrc/jacobi_wavefront.cu``
#: runs m <= ``WAVEFRONT_SUB_DEPTH`` (4) levels as one register-queue march and
#: m in 5..8 as two through a scratch, and chains no more than two; shared
#: memory is not the limit (``mean6_wavefront_smem_bytes``)
MEAN6_MAX_M = 2 * WAVEFRONT_SUB_DEPTH


def mean6_wavefront_smem_bytes(m: int, itemsize: int = 4) -> int:
    """Shared memory a block of the first (the deeper) march of an m-level
    call asks (``jk.march_smem_bytes``: the Jacobi marches' model, cells of
    the working ``itemsize``, 4 for f32 and bf16 storage, 8 for f64):
    66,080 bytes at most at f32 and 132,160 at f64, below the 232,448 a
    block may take."""
    return jk.march_smem_bytes(m, itemsize)


def _check_wavefront(raw, m: int, shell_width: int, out, axes) -> str:
    form = _check_axes(raw, *axes)
    if not 1 <= m <= shell_width:
        raise ValueError(f"m={m} needs 1 <= m <= shell_width={shell_width}")
    if not 2 * shell_width < min(raw.shape):
        raise ValueError(f"raw {tuple(raw.shape)} needs > 2*{shell_width} cells per axis")
    if m > MEAN6_MAX_M:
        raise ValueError(
            f"m={m}: one call chains at most two marches of {WAVEFRONT_SUB_DEPTH} levels, "
            f"so it takes at most m={MEAN6_MAX_M} levels"
        )
    _check_out(raw, out)
    return form


def mean6_shell_wavefront_step_plain(raw: torch.Tensor, m: int, shell_width: int, compute_unit: str = "vpu",
                                     f32_accumulate: bool = False, mxu_input: str = "f32",
                                     out: torch.Tensor = None) -> torch.Tensor:
    """``m`` mean-of-6 levels over an ``(Xr, Yr, Zr)`` block with a filled
    ``shell_width``-wide shell, with rolls: every axis wraps, and the wrapped
    cells are the ones the shell was sized to sacrifice.  Only the interior
    ``[s, ext - s)`` is exact; shell cells are unspecified.  Returns ``out``
    (a fresh tensor when None) at the block's dtype: under
    ``f32_accumulate`` the levels run at f32 and the last rounds once to
    bfloat16.  Under a contracting unit each level is ``(x-1 + x+1) +
    nbr``, ``nbr`` over the whole (Yr, Zr) planes, periodic."""
    _check_wavefront(raw, m, shell_width, out, (compute_unit, f32_accumulate, mxu_input))
    unit, mi = _unit(raw, compute_unit, mxu_input, "mean6-wavefront")
    w = raw.to(jk.work_dtype(raw.dtype))
    for _ in range(m):
        s = torch.roll(w, 1, 0) + torch.roll(w, -1, 0)  # x-1, x+1
        if jk.unit_uses_mxu(unit):
            w = (s + jk.plane_nbr_sum_host(w, unit, mxu_input=mi)) * sixth(w.dtype)
            continue
        s = s + torch.roll(w, 1, 1)  # y-1
        s = s + torch.roll(w, -1, 1)  # y+1
        s = s + torch.roll(w, 1, 2)  # z-1
        s = s + torch.roll(w, -1, 2)  # z+1
        w = s * sixth(w.dtype)
    w = w.to(raw.dtype)
    return w if out is None else out.copy_(w)


def mean6_shell_wavefront_step(raw: torch.Tensor, m: int, shell_width: int, compute_unit: str = "vpu",
                               f32_accumulate: bool = False, mxu_input: str = "f32",
                               out: torch.Tensor = None) -> torch.Tensor:
    """``m`` <= ``shell_width`` mean-of-6 levels in ONE call over an s-shelled
    block, each input plane read once and each output plane written once.
    Arguments and result as ``mean6_shell_wavefront_step_plain``.

    On the card this is the register-queue march of
    ``csrc/jacobi_wavefront.cu`` without the clamp (the build of the
    block's dtype): one march of m <= 4 levels, or two through an ``(Xr,
    Yr, Zr)`` scratch at the working dtype from torch's allocator; one call
    of the wrapper either way.  Only the interior ``[s,
    ext - s)`` of the result is written: its shell holds whatever the buffer
    held (``torch.empty_like`` when ``out`` is None), so a caller exchanges
    the shell again before the next call.

    The result lands in a fresh buffer (or ``out``), where the TPU kernel
    writes its input in place (``input_output_aliases={0: 0}``,
    ``stencil_tpu/ops/plane_stencil.py:107``): the CUDA blocks march x
    independently, so an in-place write could land before a neighbouring
    tile reads it, the rule of every wavefront of the port (ROADMAP.md queue
    3).  At most ``MEAN6_MAX_M`` levels a call.  Under a contracting unit
    the march is the tensor-core build's (``jk.library_name``)."""
    form = _check_wavefront(raw, m, shell_width, out, (compute_unit, f32_accumulate, mxu_input))
    if raw.device.type == "cpu":
        return mean6_shell_wavefront_step_plain(raw, m, shell_width, compute_unit, f32_accumulate, mxu_input, out)
    unit, mi = _unit(raw, compute_unit, mxu_input, "mean6-wavefront")
    res = torch.empty_like(raw) if out is None else out
    scratch = raw.new_empty(raw.shape, dtype=jk.work_dtype(raw.dtype)) if jk.wavefront_marches(m) > 1 else None
    entry, lib = jk._c_entry("stp_mean6_march", jk.library_name(unit, mi, form == "bf16", form == "f64"))
    rc = entry(raw.data_ptr(), res.data_ptr(), None if scratch is None else scratch.data_ptr(), 1, *raw.shape, m,
               shell_width, current_raw_stream(raw.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "mean6_shell_wavefront_step")
    jk._count(mean6_shell_wavefront_step, _counter(form, unit, mi))
    return res


#: kernel launches made by ``mean6_shell_wavefront_step`` (one a call, whatever
#: its marches), by dtype form and, where it contracts, by unit form
jk._zero_counters(mean6_shell_wavefront_step, jk.CONTRACTION_COUNTERS)


def mean6_wavefront_launch(shape, m: int, shell_width: int, storage: str = "native", compute_unit: str = "vpu",
                           mxu_input: str = "f32") -> dict:
    """The launches a ``mean6_shell_wavefront_step`` call over an ``(Xr, Yr,
    Zr)`` block makes on the card, without making them: kernel ``launches``
    a call (marches), and of the first march its ``depth``, blocks an SM the
    occupancy calculator allows, SMs, the grid's blocks and its ``waves``,
    the x chunking, the shared memory and threads a block asks and the tiles
    along z and y (fields as ``jk.WRAP_PLAN_FIELDS``), in the build of
    ``storage`` (``native`` f32, ``bf16`` or ``f64``) and the unit."""
    if storage not in ("native", "bf16", "f64"):
        raise ValueError(f"unknown storage {storage!r} (native | bf16 | f64)")
    mxu = jk.unit_uses_mxu(compute_unit)
    if mxu and storage == "f64":
        raise ValueError("the contraction takes f32 accumulators: no f64 build")
    lib = jk._library(jk.library_name(compute_unit, mxu_input if mxu else "f32", storage == "bf16",
                                      storage == "f64"))
    info = (ctypes.c_int * len(jk.WRAP_PLAN_FIELDS))()
    rc = lib.stp_mean6_march_plan(1, *shape, m, shell_width, info)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "mean6_wavefront_launch")
    plan = dict(zip(jk.WRAP_PLAN_FIELDS, info))
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    plan["storage"] = storage
    plan["compute_unit"], plan["mxu_input"] = (compute_unit, mxu_input) if mxu else ("vpu", "f32")
    return plan
