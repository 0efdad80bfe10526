"""Jacobi level kernels: ``jacobi_wrap_step``, ``jacobi_plane_step`` and their
plain versions.

Counterpart of ``stencil_tpu/ops/jacobi_pallas.py`` in its ``vpu``/native f32
form.  On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/jacobi.cu``); on a CPU tensor it runs the plain PyTorch version.

Semantics, per level, match ``Jacobi3D._kernel`` of the JAX package: mean of
the six face neighbours, then the hot and cold sphere clamps.  Two details
make the port bitwise equal to the TPU kernels:

* the neighbours are summed as a left fold in the TPU kernels' order
  x-1, x+1, y-1, y+1, z-1, z+1 (``_make_level_sum``, jacobi_pallas.py:515-524);
* the mean is ``sum * SIXTH`` with ``SIXTH = float32(1/6)``: XLA compiles
  the JAX source's ``sum / 6.0`` as that multiply, and a true divide differs
  by 1 ulp on some cells.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stencil_tpu_torch.kernels import check_tensor, same_device, stream_handle

HOT_TEMP = 1.0
COLD_TEMP = 0.0

#: float32(1/6) as an exact Python float, so multiplying an f32 tensor by it
#: multiplies by 0x1.555556p-3 (the constant XLA substitutes for `/ 6.0`)
SIXTH = float(np.float32(1.0 / 6.0))

#: the wrap route's depth for ``temporal_k="auto"``.  The wrap kernel runs one
#: level per launch, so the depth only sets how many launches one call makes;
#: a shared-memory temporal-blocking kernel will re-derive it from tile sizes.
WRAP_AUTO_K = 8


def sphere_params(gx: int):
    """Hot/cold sphere x-centres and the integer membership bound
    d2 < (r+1)^2 (the truncated-float-sqrt test, jacobi3d.cu:31-33)."""
    return gx // 3, gx * 2 // 3, (gx // 10 + 1) ** 2


def yz_dist2_plane(origin_y: int, origin_z: int, shape_yz: Tuple[int, int], global_size,
                   device=None) -> torch.Tensor:
    """(y - gy/2)^2 + (z - gz/2)^2 over the interior plane, wrapped
    periodically, as int32; shared by both spheres (same y/z centre)."""
    gy, gz = global_size[1], global_size[2]
    y = (origin_y + torch.arange(shape_yz[0], device=device)) % gy
    z = (origin_z + torch.arange(shape_yz[1], device=device)) % gz
    return (((y - gy // 2) ** 2)[:, None] + ((z - gz // 2) ** 2)[None, :]).to(torch.int32)


def choose_temporal_k(shape: Tuple[int, int, int], requested="auto") -> int:
    """The wrap route's levels per call: a validated explicit int
    (1 <= k <= X//2, as in the JAX package) or ``WRAP_AUTO_K`` clipped to it."""
    X = shape[0]
    top = max(1, X // 2)
    if requested != "auto":
        k = int(requested)
        if not 1 <= k <= top:
            raise ValueError(f"temporal_k={k} needs 1 <= k <= X//2 = {X // 2}")
        return k
    return min(WRAP_AUTO_K, top)


def _clamp_spheres(val, d2, x_g, hot_x, cold_x, in_r2):
    """d2 broadcasts over the plane, x_g over the x axis (int tensors)."""
    val = torch.where(d2 < in_r2 - (x_g - hot_x) ** 2, HOT_TEMP, val)
    return torch.where(d2 < in_r2 - (x_g - cold_x) ** 2, COLD_TEMP, val)


# --- jacobi_wrap_step ---------------------------------------------------------


def _check_k(block: torch.Tensor, k: int) -> None:
    check_tensor(block, "block", ndims=(3,), dtype=torch.float32)
    if not 1 <= k <= max(1, block.shape[0] // 2):
        raise ValueError(f"k={k} needs 1 <= k <= X//2 = {block.shape[0] // 2}")


def jacobi_wrap_step_plain(block: torch.Tensor, k: int = 1) -> torch.Tensor:
    """``k`` periodic Jacobi levels over the whole (X, Y, Z) domain, with
    rolls; returns a new tensor."""
    _check_k(block, k)
    X, Y, Z = block.shape
    hot_x, cold_x, in_r2 = sphere_params(X)
    d2 = yz_dist2_plane(0, 0, (Y, Z), block.shape, block.device)[None]
    x_g = torch.arange(X, device=block.device)[:, None, None]
    c = block
    for _ in range(k):
        s = torch.roll(c, 1, 0) + torch.roll(c, -1, 0)  # x-1, x+1
        s = s + torch.roll(c, 1, 1)  # y-1
        s = s + torch.roll(c, -1, 1)  # y+1
        s = s + torch.roll(c, 1, 2)  # z-1
        s = s + torch.roll(c, -1, 2)  # z+1
        c = _clamp_spheres(s * SIXTH, d2, x_g, hot_x, cold_x, in_r2)
    return c


def jacobi_wrap_step(block: torch.Tensor, k: int = 1) -> torch.Tensor:
    """``k`` Jacobi levels over the WHOLE periodic domain (the single-
    subdomain route); returns a new tensor, ``block`` is left as it was.

    On CUDA: ``k`` launches of the one-level kernel, ping-ponging between two
    fresh buffers so the last level lands in the returned one."""
    _check_k(block, k)
    if block.device.type == "cpu":
        return jacobi_wrap_step_plain(block, k)
    from stencil_tpu_torch.kernels import build

    lib = build.load("jacobi")
    X, Y, Z = block.shape
    hot_x, cold_x, in_r2 = sphere_params(X)
    bufs = [torch.empty_like(block), torch.empty_like(block) if k > 1 else None]
    stream = stream_handle(block.device)
    src = block
    for level in range(k):
        dst = bufs[(k - 1 - level) % 2]
        rc = lib.stp_jacobi_wrap_level(
            src.data_ptr(), dst.data_ptr(), X, Y, Z, hot_x, cold_x, in_r2,
            Y // 2, Z // 2, stream,
        )
        build.check(lib, rc, "jacobi_wrap_step")
        jacobi_wrap_step.launches += 1
        src = dst
    return bufs[0]


#: kernel launches made by ``jacobi_wrap_step`` (plain-version calls do not count)
jacobi_wrap_step.launches = 0


# --- jacobi_plane_step --------------------------------------------------------


def _check_plane(blocks, origins, yz_d2, out):
    check_tensor(blocks, "blocks", ndims=(3, 4), dtype=torch.float32)
    single = blocks.dim() == 3
    check_tensor(origins, "origins", ndims=(1,) if single else (2,), dtype=torch.int32)
    check_tensor(yz_d2, "yz_d2", ndims=(2,) if single else (3,), dtype=torch.int32)
    tensors = [blocks, origins, yz_d2]
    n = 1 if single else blocks.shape[0]
    X, Y, Z = blocks.shape[-3:]
    if min(X, Y, Z) < 3:
        raise ValueError(f"shell-carrying block {tuple(blocks.shape)} needs >= 3 cells per axis")
    if tuple(origins.shape) != ((3,) if single else (n, 3)):
        raise ValueError(f"origins shape {tuple(origins.shape)} does not fit {n} block(s)")
    want = (Y - 2, Z - 2) if single else (n, Y - 2, Z - 2)
    if tuple(yz_d2.shape) != want:
        raise ValueError(f"yz_d2 shape {tuple(yz_d2.shape)}, want {want}")
    if out is not None:
        check_tensor(out, "out", ndims=(blocks.dim(),), dtype=torch.float32)
        if out.shape != blocks.shape or out.data_ptr() == blocks.data_ptr():
            raise ValueError("out must be a separate tensor of the blocks' shape")
        tensors.append(out)
    same_device(*tensors)
    return n, X, Y, Z


def jacobi_plane_step_plain(blocks, origins, yz_d2, global_size, out=None) -> torch.Tensor:
    """One Jacobi level over radius-1 shell-carrying block(s) ``(X, Y, Z)`` or
    ``(n, X, Y, Z)``; shell cells pass through.  ``origins`` are the global
    coordinates of each block's interior start, ``yz_d2`` each block's
    ``yz_dist2_plane`` over its interior."""
    _check_plane(blocks, origins, yz_d2, out)
    single = blocks.dim() == 3
    c = blocks[None] if single else blocks
    org = origins[None] if single else origins
    d2 = (yz_d2[None] if single else yz_d2)[:, None]
    X = c.shape[1]
    gx = global_size[0]
    hot_x, cold_x, in_r2 = sphere_params(gx)
    core = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
    s = c[:, :-2, 1:-1, 1:-1] + c[:, 2:, 1:-1, 1:-1]  # x-1, x+1
    s = s + c[:, 1:-1, :-2, 1:-1]  # y-1
    s = s + c[:, 1:-1, 2:, 1:-1]  # y+1
    s = s + c[:, 1:-1, 1:-1, :-2]  # z-1
    s = s + c[:, 1:-1, 1:-1, 2:]  # z+1
    # raw plane p holds interior x = p - 1; torch's % is non-negative here
    x_g = (org[:, 0:1].long() + torch.arange(X - 2, device=c.device)) % gx
    val = _clamp_spheres(s * SIXTH, d2, x_g[:, :, None, None], hot_x, cold_x, in_r2)
    res = torch.empty_like(c) if out is None else (out[None] if single else out)
    res.copy_(c)
    res[core] = val
    return res[0] if single else res


def jacobi_plane_step(blocks, origins, yz_d2, global_size, out=None) -> torch.Tensor:
    """One Jacobi level over radius-1 shell-carrying block(s); returns
    ``out`` (a fresh tensor when None).  One CUDA launch serves all ``n``
    blocks, the port's counterpart of running the TPU kernel per shard."""
    n, X, Y, Z = _check_plane(blocks, origins, yz_d2, out)
    if blocks.device.type == "cpu":
        return jacobi_plane_step_plain(blocks, origins, yz_d2, global_size, out)
    from stencil_tpu_torch.kernels import build

    lib = build.load("jacobi")
    gx = int(global_size[0])
    hot_x, cold_x, in_r2 = sphere_params(gx)
    res = torch.empty_like(blocks) if out is None else out
    rc = lib.stp_jacobi_plane_level(
        blocks.data_ptr(), res.data_ptr(), origins.data_ptr(), yz_d2.data_ptr(),
        n, X, Y, Z, gx, hot_x, cold_x, in_r2, stream_handle(blocks.device),
    )
    build.check(lib, rc, "jacobi_plane_step")
    jacobi_plane_step.launches += 1
    return res


#: kernel launches made by ``jacobi_plane_step`` (plain-version calls do not count)
jacobi_plane_step.launches = 0
