"""The mean-of-6 kernels: ``mean6_plane_step``, ``mean6_shell_wavefront_step``
and their plain versions.

Counterpart of ``stencil_tpu/ops/plane_stencil.py`` in its ``vpu``/native f32
form: the Jacobi level without the sphere clamp, over a block that carries a
shell of any width (the Astaroth proxy's radius-3 shell read at distance 1).
No route of either package calls them.  On a CUDA tensor each wrapper
launches its hand-written kernel (``csrc/plane_stencil.cu``; the mean-of-6
form of ``csrc/jacobi_wavefront.cu``'s register-queue march, the Jacobi
wavefront's body without the sphere clamp); on a CPU tensor it runs the plain
PyTorch version.

Both sum the six neighbours as a left fold x-1, x+1, y-1, y+1, z-1, z+1
(``plane_stencil.py:188-195``) and multiply by ``SIXTH``, the float32 constant
XLA puts in place of the JAX source's ``/ 6.0``.

The ``compute_unit``, ``f32_accumulate`` and ``mxu_input`` axes and dtypes
other than float32 are ROADMAP.md queue 1 item 9: anything but the defaults
raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.kernels import check_tensor, current_raw_stream, same_device, stream_handle
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops.jacobi_kernels import SIXTH, WAVEFRONT_SUB_DEPTH, WAVEFRONT_TILE_W, WAVEFRONT_TILE_Y


def _check_axes(block: torch.Tensor, compute_unit: str, f32_accumulate: bool, mxu_input: str) -> None:
    for name, value, default in (("compute_unit", compute_unit, "vpu"), ("f32_accumulate", f32_accumulate, False),
                                 ("mxu_input", mxu_input, "f32")):
        if value != default:
            raise NotImplementedError(f"{name}={value!r} is not ported yet (ROADMAP.md queue 1 item 9)")
    check_tensor(block, "block", ndims=(3,))
    if block.dtype != torch.float32:
        raise NotImplementedError(
            f"the mean6 kernels take float32 blocks, got {block.dtype} (ROADMAP.md queue 1 item 9)"
        )


def _check_out(block: torch.Tensor, out) -> None:
    if out is None:
        return
    check_tensor(out, "out", ndims=(3,), dtype=torch.float32)
    same_device(block, out)
    if out.shape != block.shape or out.data_ptr() == block.data_ptr():
        raise ValueError("out must be a separate tensor of the block's shape")


def _mean6(c: torch.Tensor, xs: slice, ys: slice, zs: slice) -> torch.Tensor:
    """One level at the cells ``c[xs, ys, zs]``, whose neighbours lie in ``c``."""
    def sh(s: slice, d: int) -> slice:
        return slice(s.start + d, s.stop + d)

    s = c[sh(xs, -1), ys, zs] + c[sh(xs, 1), ys, zs]  # x-1, x+1
    s = s + c[xs, sh(ys, -1), zs]  # y-1
    s = s + c[xs, sh(ys, 1), zs]  # y+1
    s = s + c[xs, ys, sh(zs, -1)]  # z-1
    s = s + c[xs, ys, sh(zs, 1)]  # z+1
    return s * SIXTH


# --- mean6_plane_step ---------------------------------------------------------------


def _check_plane(block, lo: Dim3, hi: Dim3, out, axes) -> None:
    _check_axes(block, *axes)
    if not (lo.all_ge(1) and hi.all_ge(1)):
        # the distance-1 reads need a neighbour inside the allocation
        raise ValueError(f"every shell width must be >= 1, got lo={lo} hi={hi}")
    _check_out(block, out)


def mean6_plane_step_plain(block: torch.Tensor, lo, hi, compute_unit: str = "vpu", f32_accumulate: bool = False,
                           mxu_input: str = "f32", out: torch.Tensor = None) -> torch.Tensor:
    """One mean-of-6 level over the window ``[lo, N - hi)`` of every axis of
    an ``(X, Y, Z)`` block; the shell passes through.  Returns ``out`` (a
    fresh tensor when None)."""
    lo, hi = Dim3.of(lo), Dim3.of(hi)
    _check_plane(block, lo, hi, out, (compute_unit, f32_accumulate, mxu_input))
    res = torch.empty_like(block) if out is None else out
    res.copy_(block)
    window = tuple(slice(lo[a], max(lo[a], block.shape[a] - hi[a])) for a in range(3))
    res[window] = _mean6(block, *window)
    return res


def mean6_plane_step(block: torch.Tensor, lo, hi, compute_unit: str = "vpu", f32_accumulate: bool = False,
                     mxu_input: str = "f32", out: torch.Tensor = None) -> torch.Tensor:
    """One mean-of-6 level over a shell-carrying block (per-axis shell widths
    ``lo``, ``hi`` >= 1; the shell passes through); arguments and result as
    ``mean6_plane_step_plain``."""
    lo, hi = Dim3.of(lo), Dim3.of(hi)
    _check_plane(block, lo, hi, out, (compute_unit, f32_accumulate, mxu_input))
    if block.device.type == "cpu":
        return mean6_plane_step_plain(block, lo, hi, out=out)
    from stencil_tpu_torch.kernels import build

    lib = build.load("plane_stencil")
    res = torch.empty_like(block) if out is None else out
    rc = lib.stp_mean6_plane_level(block.data_ptr(), res.data_ptr(), *block.shape, *lo, *hi,
                                   stream_handle(block.device))
    build.check(lib, rc, "mean6_plane_step")
    mean6_plane_step.launches += 1
    return res


#: kernel launches made by ``mean6_plane_step`` (plain-version calls do not count)
mean6_plane_step.launches = 0


# --- mean6_shell_wavefront_step -----------------------------------------------------

#: the deepest level count one call takes: ``csrc/jacobi_wavefront.cu``
#: runs m <= ``WAVEFRONT_SUB_DEPTH`` (4) levels as one register-queue march and
#: m in 5..8 as two through a scratch, and chains no more than two; shared
#: memory is not the limit (``mean6_wavefront_smem_bytes``)
MEAN6_MAX_M = 2 * WAVEFRONT_SUB_DEPTH


def mean6_wavefront_smem_bytes(m: int) -> int:
    """Shared memory a block of the first (the deeper) march of an m-level
    call asks: 2d planes of the 32 x 64 tile and two rows of padding, d = m,
    or ceil(m/2) for two marches (the C source's ``queue_smem``): 66,080
    bytes at most, far below the 232,448 a block may take."""
    d = m if m <= WAVEFRONT_SUB_DEPTH else -(-m // 2)
    return (2 * d * WAVEFRONT_TILE_Y * WAVEFRONT_TILE_W + 2 * (WAVEFRONT_TILE_W + 4)) * 4


def _check_wavefront(raw, m: int, shell_width: int, out, axes) -> None:
    _check_axes(raw, *axes)
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


def mean6_shell_wavefront_step_plain(raw: torch.Tensor, m: int, shell_width: int, compute_unit: str = "vpu",
                                     f32_accumulate: bool = False, mxu_input: str = "f32",
                                     out: torch.Tensor = None) -> torch.Tensor:
    """``m`` mean-of-6 levels over an ``(Xr, Yr, Zr)`` block with a filled
    ``shell_width``-wide shell, with rolls: every axis wraps, and the wrapped
    cells are the ones the shell was sized to sacrifice.  Only the interior
    ``[s, ext - s)`` is exact; shell cells are unspecified.  Returns ``out``
    (a fresh tensor when None)."""
    _check_wavefront(raw, m, shell_width, out, (compute_unit, f32_accumulate, mxu_input))
    w = raw
    for _ in range(m):
        s = torch.roll(w, 1, 0) + torch.roll(w, -1, 0)  # x-1, x+1
        s = s + torch.roll(w, 1, 1)  # y-1
        s = s + torch.roll(w, -1, 1)  # y+1
        s = s + torch.roll(w, 1, 2)  # z-1
        s = s + torch.roll(w, -1, 2)  # z+1
        w = s * SIXTH
    return w if out is None else out.copy_(w)


def mean6_shell_wavefront_step(raw: torch.Tensor, m: int, shell_width: int, compute_unit: str = "vpu",
                               f32_accumulate: bool = False, mxu_input: str = "f32",
                               out: torch.Tensor = None) -> torch.Tensor:
    """``m`` <= ``shell_width`` mean-of-6 levels in ONE call over an s-shelled
    block, each input plane read once and each output plane written once.
    Arguments and result as ``mean6_shell_wavefront_step_plain``.

    On the card this is the register-queue march of
    ``csrc/jacobi_wavefront.cu`` without the clamp: one march of m <= 4
    levels, or two through an ``(Xr, Yr, Zr)`` scratch from torch's
    allocator; one call of the wrapper either way.  Only the interior ``[s,
    ext - s)`` of the result is written: its shell holds whatever the buffer
    held (``torch.empty_like`` when ``out`` is None), so a caller exchanges
    the shell again before the next call.

    The result lands in a fresh buffer (or ``out``), where the TPU kernel
    writes its input in place (``input_output_aliases={0: 0}``,
    ``stencil_tpu/ops/plane_stencil.py:107``): the CUDA blocks march x
    independently, so an in-place write could land before a neighbouring
    tile reads it, the rule of every wavefront of the port (ROADMAP.md queue
    3).  At most ``MEAN6_MAX_M`` levels a call."""
    _check_wavefront(raw, m, shell_width, out, (compute_unit, f32_accumulate, mxu_input))
    if raw.device.type == "cpu":
        return mean6_shell_wavefront_step_plain(raw, m, shell_width, out=out)
    res = torch.empty_like(raw) if out is None else out
    scratch = raw.new_empty(raw.shape) if jk.wavefront_marches(m) > 1 else None
    entry, lib = jk._c_entry("stp_mean6_march")
    rc = entry(raw.data_ptr(), res.data_ptr(), None if scratch is None else scratch.data_ptr(), 1, *raw.shape, m,
               shell_width, current_raw_stream(raw.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "mean6_shell_wavefront_step")
    mean6_shell_wavefront_step.launches += 1
    return res


#: kernel launches made by ``mean6_shell_wavefront_step`` (one a call, whatever its marches)
mean6_shell_wavefront_step.launches = 0


def mean6_wavefront_launch(shape, m: int, shell_width: int) -> dict:
    """The launches a ``mean6_shell_wavefront_step`` call over an ``(Xr, Yr,
    Zr)`` block makes on the card, without making them: kernel ``launches``
    a call (marches), and of the first march its ``depth``, blocks an SM the
    occupancy calculator allows, SMs, the grid's blocks and its ``waves``,
    the x chunking, the shared memory and threads a block asks and the tiles
    along z and y (fields as ``jk.WRAP_PLAN_FIELDS``)."""
    lib = jk._entry()[1]
    info = (ctypes.c_int * len(jk.WRAP_PLAN_FIELDS))()
    rc = lib.stp_mean6_march_plan(1, *shape, m, shell_width, info)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "mean6_wavefront_launch")
    plan = dict(zip(jk.WRAP_PLAN_FIELDS, info))
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan
