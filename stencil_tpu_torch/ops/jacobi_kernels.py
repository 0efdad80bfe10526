"""Jacobi level kernels: ``jacobi_wrap_step``, ``jacobi_plane_step``,
``jacobi_slab_step``, ``jacobi_shell_wavefront_step``,
``jacobi_zring_wavefront_step`` and their plain versions.

Counterpart of ``stencil_tpu/ops/jacobi_pallas.py`` in its ``vpu``/native f32
form.  On a CUDA tensor each wrapper launches its hand-written kernel, a
form of the register-queue march of ``csrc/jacobi_wavefront.cu``; on a CPU
tensor it runs the plain PyTorch version.

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

import ctypes
from typing import Tuple

import numpy as np
import torch

from stencil_tpu_torch.kernels import check_out, check_tensor, current_raw_stream, same_device

HOT_TEMP = 1.0
COLD_TEMP = 0.0

#: float32(1/6) as an exact Python float, so multiplying an f32 tensor by it
#: multiplies by 0x1.555556p-3 (the constant XLA substitutes for `/ 6.0`)
SIXTH = float(np.float32(1.0 / 6.0))

#: the wrap route's depth for ``temporal_k="auto"``: one call runs its k
#: levels as ``wrap_march_depths(k)`` marches of the wavefront kernel's wrap
#: form (two at k = 8)
WRAP_AUTO_K = 8

#: the deepest temporal depth the JAX package plans (jacobi_pallas.py:627);
#: the wavefront plan caps its depth with it, as the JAX package does
_WRAP_MAX_K = 16

#: lane offset of the interior in the z-ring working plane and d2 layout
#: (jacobi_pallas.py:1183): the low halo sits just below it, the high halo
#: wraps to column 0
_ZRING_OFF = 128

#: the tile of the wavefront depth plan: 32 output rows of y, and 64 columns
#: of z with the m-cell apron on each side (64 - 2m output columns); and the
#: shared memory one block may opt into on an H100 (232,448 bytes).
#: ``wavefront_smem_bytes`` is the plan's model of a block; every launch of
#: ``csrc/jacobi_wavefront.cu`` asks less (its header)
WAVEFRONT_TILE_Y = 32
WAVEFRONT_TILE_W = 64
SMEM_PER_BLOCK = 232_448

#: the deepest march one kernel launch of ``csrc/jacobi_wavefront.cu`` makes
#: (``kSubDepth``): deeper calls run as two marches through a scratch buffer
WAVEFRONT_SUB_DEPTH = 4


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


def wrap_march_depths(k: int) -> list:
    """The depths of the marches one ``jacobi_wrap_step`` call of ``k``
    levels launches: ceil(k / ``WAVEFRONT_SUB_DEPTH``) of them, as even as
    can be, the deeper first (``wrap_depth`` in csrc/jacobi_wavefront.cu)."""
    q = -(-k // WAVEFRONT_SUB_DEPTH)
    return [k // q + (1 if j < k % q else 0) for j in range(q)]


def jacobi_wrap_step(block: torch.Tensor, k: int = 1, out: torch.Tensor = None) -> torch.Tensor:
    """``k`` Jacobi levels over the WHOLE periodic domain (the single-
    subdomain route) from one read of ``block``; returns ``out`` (a new
    tensor when None), ``block`` is left as it was.

    On CUDA: one call of the wavefront kernel's wrap form, its k levels as
    ``wrap_march_depths(k)`` marches; more than one pass through an (X, Y,
    Z) scratch from torch's caching allocator, the last march writing the
    returned tensor."""
    _check_k(block, k)
    if out is not None:
        check_out(out, block)
    if block.device.type == "cpu":
        res = jacobi_wrap_step_plain(block, k)
        return res if out is None else out.copy_(res)
    X, Y, Z = block.shape
    hot_x, cold_x, in_r2 = sphere_params(X)
    out = torch.empty_like(block) if out is None else out
    scratch = torch.empty_like(block) if k > WAVEFRONT_SUB_DEPTH else None
    entry, lib = _c_entry("stp_jacobi_wrap")
    rc = entry(block.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
               X, Y, Z, k, hot_x, cold_x, in_r2, current_raw_stream(block.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_wrap_step")
    jacobi_wrap_step.launches += 1
    return out


#: calls of ``jacobi_wrap_step`` on CUDA, one a call whatever its marches
#: (plain-version calls do not count)
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
    blocks, the port's counterpart of running the TPU kernel per shard: the
    plane form of ``csrc/jacobi_wavefront.cu``, a march of depth 1 that
    writes every cell of ``out`` (the shell copied through)."""
    n, X, Y, Z = _check_plane(blocks, origins, yz_d2, out)
    if blocks.device.type == "cpu":
        return jacobi_plane_step_plain(blocks, origins, yz_d2, global_size, out)
    gx = int(global_size[0])
    res = torch.empty_like(blocks) if out is None else out
    entry, lib = _c_entry("stp_jacobi_plane")
    rc = entry(blocks.data_ptr(), res.data_ptr(), origins.data_ptr(), yz_d2.data_ptr(),
               n, X, Y, Z, gx, *sphere_params(gx), current_raw_stream(blocks.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_plane_step")
    jacobi_plane_step.launches += 1
    return res


#: kernel launches made by ``jacobi_plane_step`` (plain-version calls do not count)
jacobi_plane_step.launches = 0


# --- jacobi_slab_step ---------------------------------------------------------


def _check_slab(block, slabs, origins, yz_d2, out):
    check_tensor(block, "block", ndims=(3, 4), dtype=torch.float32)
    single = block.dim() == 3
    n = 1 if single else block.shape[0]
    X, Y, Z = block.shape[-3:]
    if X < 2:
        # the TPU kernel's first and last plane branches both fire at X == 1
        # (jacobi_pallas.py:1393-1395); the route choice keeps the same rule
        raise ValueError(f"jacobi_slab_step requires X >= 2 planes per block, got {X}")
    lead = () if single else (n,)
    faces = {"xlo": (Y, Z), "xhi": (Y, Z), "ylo": (X, Z), "yhi": (X, Z), "zlo": (X, Y), "zhi": (X, Y)}
    for (what, want), t in zip(faces.items(), slabs):
        check_tensor(t, what, ndims=(block.dim() - 1,), dtype=torch.float32)
        if tuple(t.shape) != lead + want:
            raise ValueError(f"{what} shape {tuple(t.shape)}, want {lead + want}")
    check_tensor(origins, "origins", ndims=(1,) if single else (2,), dtype=torch.int32)
    if tuple(origins.shape) != lead + (3,):
        raise ValueError(f"origins shape {tuple(origins.shape)} does not fit {n} block(s)")
    check_tensor(yz_d2, "yz_d2", ndims=(block.dim() - 1,), dtype=torch.int32)
    if tuple(yz_d2.shape) != lead + (Y, Z):
        raise ValueError(f"yz_d2 shape {tuple(yz_d2.shape)}, want {lead + (Y, Z)}")
    tensors = [block, *slabs, origins, yz_d2]
    if out is not None:
        check_tensor(out, "out", ndims=(block.dim(),), dtype=torch.float32)
        if out.shape != block.shape or out.data_ptr() == block.data_ptr():
            raise ValueError("out must be a separate tensor of the block's shape")
        tensors.append(out)
    same_device(*tensors)
    return n, X, Y, Z


def jacobi_slab_step_plain(block, xlo, xhi, ylo, yhi, zlo, zhi, origins, yz_d2, global_size,
                           out=None) -> torch.Tensor:
    """One Jacobi level over bare interior(s) ``(X, Y, Z)`` or ``(n, X, Y,
    Z)`` (no shell), the boundary neighbours taken from the six received face
    slabs: ``xlo``/``xhi`` ``(.., Y, Z)`` (the -x / +x neighbour's outermost
    plane), ``ylo``/``yhi`` ``(.., X, Z)`` and ``zlo``/``zhi`` ``(.., X, Y)``.
    ``origins`` are each block's global start, ``yz_d2`` its
    ``yz_dist2_plane`` over the (Y, Z) interior.  Returns ``out`` (a fresh
    tensor when None).

    The JAX kernel takes the z slabs transposed, ``(Y, X)``; the port keeps
    them ``(X, Y)`` (a GPU has no lane axis to put x on)."""
    slabs = (xlo, xhi, ylo, yhi, zlo, zhi)
    _check_slab(block, slabs, origins, yz_d2, out)
    single = block.dim() == 3
    if single:
        block, origins, yz_d2, out = _batched(block, origins, yz_d2, out)
        slabs = _batched(*slabs)
    xlo, xhi, ylo, yhi, zlo, zhi = slabs
    c = block
    X = c.shape[1]
    gx = global_size[0]
    hot_x, cold_x, in_r2 = sphere_params(gx)
    s = torch.cat([xlo[:, None], c[:, :-1]], 1) + torch.cat([c[:, 1:], xhi[:, None]], 1)  # x-1, x+1
    s = s + torch.cat([ylo[:, :, None], c[:, :, :-1]], 2)  # y-1
    s = s + torch.cat([c[:, :, 1:], yhi[:, :, None]], 2)  # y+1
    s = s + torch.cat([zlo[..., None], c[..., :-1]], 3)  # z-1
    s = s + torch.cat([c[..., 1:], zhi[..., None]], 3)  # z+1
    x_g = (origins[:, 0:1].long() + torch.arange(X, device=c.device)) % gx
    val = _clamp_spheres(s * SIXTH, yz_d2[:, None], x_g[:, :, None, None], hot_x, cold_x, in_r2)
    res = val if out is None else out.copy_(val)
    return res[0] if single else res


def jacobi_slab_step(block, xlo, xhi, ylo, yhi, zlo, zhi, origins, yz_d2, global_size,
                     out=None) -> torch.Tensor:
    """One Jacobi level over bare interior(s) from six received face slabs
    (the ``slab`` route's kernel); arguments and result as
    ``jacobi_slab_step_plain``.  One CUDA launch serves all ``n`` blocks:
    the slab form of ``csrc/jacobi_wavefront.cu``, a march of depth 1 whose
    level-0 fetch reads a face slab one cell outside the block."""
    slabs = (xlo, xhi, ylo, yhi, zlo, zhi)
    n, X, Y, Z = _check_slab(block, slabs, origins, yz_d2, out)
    if block.device.type == "cpu":
        return jacobi_slab_step_plain(block, *slabs, origins, yz_d2, global_size, out)
    gx = int(global_size[0])
    res = torch.empty_like(block) if out is None else out
    entry, lib = _c_entry("stp_jacobi_slab")
    rc = entry(block.data_ptr(), res.data_ptr(), *(t.data_ptr() for t in slabs), origins.data_ptr(),
               yz_d2.data_ptr(), n, X, Y, Z, gx, *sphere_params(gx), current_raw_stream(block.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_slab_step")
    jacobi_slab_step.launches += 1
    return res


#: kernel launches made by ``jacobi_slab_step`` (plain-version calls do not count)
jacobi_slab_step.launches = 0


# --- the wavefront kernels ----------------------------------------------------


def zring_dist2_plane(origin_y: int, origin_z: int, s_off: int, shape_y: int, z_interior: int,
                      global_size, device=None) -> torch.Tensor:
    """``yz_dist2_plane`` in the z-ring layout (jacobi_pallas.py:1186-1201):
    columns ``[0, s_off)`` hold the high halo (z = Zi .. Zi+s_off), columns
    ``[_ZRING_OFF - s_off, _ZRING_OFF)`` the low halo, columns
    ``[_ZRING_OFF, _ZRING_OFF + Zi)`` the interior; ``(Yr, Zi + 128)`` int32."""
    gy, gz = global_size[1], global_size[2]
    y = (origin_y + torch.arange(shape_y, device=device)) % gy
    c = torch.arange(_ZRING_OFF + z_interior, device=device)
    z = torch.where(c < s_off, origin_z + z_interior + c, origin_z + c - _ZRING_OFF) % gz
    return (((y - gy // 2) ** 2)[:, None] + ((z - gz // 2) ** 2)[None, :]).to(torch.int32)


def pack_d2(yz_d2: torch.Tensor, global_size) -> torch.Tensor:
    """The d2 plane as int32 (jacobi_pallas.py:740)."""
    del global_size
    return yz_d2.to(torch.int32)


def wavefront_smem_bytes(m: int) -> int:
    """Shared memory of one block of the m-level wavefront kernel: 2m+1
    working planes (two per level below m, one incoming) and the d2 tile,
    each a (32 + 2m) x 64 tile of 4-byte cells.  A constant of m, so the CPU
    and the card plan the same depth."""
    return (2 * m + 2) * (WAVEFRONT_TILE_Y + 2 * m) * WAVEFRONT_TILE_W * 4


def wavefront_smem_fits(m: int) -> bool:
    return wavefront_smem_bytes(m) <= SMEM_PER_BLOCK


def wavefront_auto_depth(n_min: int) -> int:
    """The wavefront depth ``temporal_k="auto"`` plans for a smallest shard
    extent ``n_min`` (the JAX package's static plan, models/jacobi.py:336-347):
    the deepest m in ``[2, min(_WRAP_MAX_K, n_min // 4, n_min)]`` whose kernel
    fits, else 1.  The n_min // 4 cap keeps the redundant shell traffic a
    small fraction of the shard."""
    depth_cap = min(_WRAP_MAX_K, max(1, n_min // 4), n_min)
    m = 1
    for cand in range(2, depth_cap + 1):
        if wavefront_smem_fits(cand):
            m = cand
    return m


def _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, ring, z_valid=None):
    """Validate one wavefront call; returns (n, Xr, Yr, Zraw, zv)."""
    if alias:
        raise NotImplementedError(
            "alias=True (an in-place wavefront) is refused: blocks march along x "
            "independently, so a write can land before a neighbouring tile reads "
            "it; see ROADMAP.md (deliberate differences)"
        )
    check_tensor(raw, "raw", ndims=(3, 4), dtype=torch.float32)
    single = raw.dim() == 3
    n = 1 if single else raw.shape[0]
    Xr, Yr, Zraw = raw.shape[-3:]
    check_tensor(origin, "origin", ndims=(1,) if single else (2,), dtype=torch.int32)
    if tuple(origin.shape) != ((3,) if single else (n, 3)):
        raise ValueError(f"origin shape {tuple(origin.shape)} does not fit {n} block(s)")
    check_tensor(d2, "d2", ndims=(2,) if single else (3,), dtype=torch.int32)
    zv = Zraw if z_valid is None else int(z_valid)
    want_d2 = (Yr, _ZRING_OFF + Zraw) if ring else (Yr, Zraw)
    if tuple(d2.shape[-2:]) != want_d2 or (not single and d2.shape[0] != n):
        raise ValueError(f"d2 shape {tuple(d2.shape)}, want {want_d2} per block")
    if not 1 <= m <= s_off:
        raise ValueError(f"m={m} needs 1 <= m <= interior_offset={s_off}")
    shelled = (Xr, Yr) if ring else (Xr, Yr, zv)
    if 2 * s_off >= min(shelled):
        raise ValueError(f"raw {tuple(raw.shape)} needs > 2*{s_off} cells per shelled axis")
    if 2 * s_off >= global_size[0]:
        # keeps the kernel's x_g = (origin_x + gx + p - s_off) mod gx operand >= 0
        raise ValueError(f"interior_offset={s_off} needs 2*interior_offset < gx = {global_size[0]}")
    if not zv <= Zraw:
        raise ValueError(f"z_valid={zv} exceeds the plane width {Zraw}")
    if ring and not (2 * s_off <= _ZRING_OFF and s_off <= Zraw):
        raise ValueError(
            f"the z-ring layout needs 2*interior_offset <= {_ZRING_OFF} and "
            f"interior_offset <= Zi = {Zraw}"
        )
    if not wavefront_smem_fits(m):
        raise ValueError(
            f"m={m} needs {wavefront_smem_bytes(m)} bytes of shared memory per block, "
            f"over the H100's {SMEM_PER_BLOCK}"
        )
    tensors = [raw, origin, d2]
    if z_slabs is not None:
        check_tensor(z_slabs, "z_slabs", ndims=(raw.dim(),), dtype=torch.float32)
        want = (Xr, 2 * s_off, Yr) if single else (n, Xr, 2 * s_off, Yr)
        if tuple(z_slabs.shape) != want:
            raise ValueError(f"z_slabs shape {tuple(z_slabs.shape)}, want {want}")
        tensors.append(z_slabs)
    same_device(*tensors)
    return n, Xr, Yr, Zraw, zv


def _wavefront_levels(w, m, origin, d2, global_size, s_off):
    """``m`` Jacobi levels over the working planes ``w`` (n, Xr, Yr, W) with
    rolls: every axis wraps, and the wrapped cells are the ones the shell was
    sized to sacrifice.  Raw plane p sits at global x ``origin_x + p - s_off``;
    the sphere test follows it on shell planes too, since their intermediate
    levels feed valid cells."""
    gx = global_size[0]
    hot_x, cold_x, in_r2 = sphere_params(gx)
    Xr = w.shape[1]
    x_g = (origin[:, 0:1].long() + gx + torch.arange(Xr, device=w.device) - s_off) % gx
    x_g = x_g[:, :, None, None]
    d2 = d2[:, None]
    for _ in range(m):
        s = torch.roll(w, 1, 1) + torch.roll(w, -1, 1)  # x-1, x+1
        s = s + torch.roll(w, 1, 2)  # y-1
        s = s + torch.roll(w, -1, 2)  # y+1
        s = s + torch.roll(w, 1, 3)  # z-1
        s = s + torch.roll(w, -1, 3)  # z+1
        w = _clamp_spheres(s * SIXTH, d2, x_g, hot_x, cold_x, in_r2)
    return w


def _emit(w, lo_col: int, hi_col: int, s_off: int) -> torch.Tensor:
    """The outgoing z slabs, z-major ``(n, Xr, 2s, Yr)``: rows [0, s) the
    columns from ``hi_col`` (top interior, the -z-bound message), rows
    [s, 2s) the columns from ``lo_col`` (bottom interior, +z-bound)."""
    return torch.cat(
        [w[..., hi_col : hi_col + s_off], w[..., lo_col : lo_col + s_off]], dim=-1
    ).transpose(-1, -2).contiguous()


def _batched(*ts):
    return [None if t is None else t[None] for t in ts]


def jacobi_shell_wavefront_step_plain(raw, m, origin, d2, global_size, interior_offset=None,
                                      alias=False, z_slabs=None, z_valid=None):
    """``m`` Jacobi levels over s-shelled block(s) ``(Xr, Yr, Zr)`` or
    ``(n, Xr, Yr, Zr)`` (jacobi_pallas.py:983).  ``d2`` is
    ``yz_dist2_plane`` over each raw plane; ``z_slabs`` ``(.., Xr, 2s, Yr)``
    replace the z-shell columns ``[0, s)`` and ``[z_valid - s, z_valid)``
    (columns ``[z_valid, Zr)`` are dead).  Returns the new block(s), and with
    ``z_slabs`` also the outgoing slabs.  The interior ``[s, ext - s)`` of
    every axis is exact; shell cells are unspecified."""
    s_off = m if interior_offset is None else interior_offset
    _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, False, z_valid)
    single = raw.dim() == 3
    if single:
        raw, origin, d2, z_slabs = _batched(raw, origin, d2, z_slabs)
    zv = raw.shape[-1] if z_valid is None else z_valid
    w = raw.clone()
    if z_slabs is not None:
        zst = z_slabs.transpose(-1, -2)  # (n, Xr, Yr, 2s)
        w[..., 0:s_off] = zst[..., 0:s_off]
        w[..., zv - s_off : zv] = zst[..., s_off:]
    w = _wavefront_levels(w, m, origin, d2, global_size, s_off)
    out = w[0] if single else w
    if z_slabs is None:
        return out
    z_out = _emit(w, s_off, zv - 2 * s_off, s_off)
    return out, (z_out[0] if single else z_out)


def _outs(raw, z_slabs, out, z_out):
    """The output buffers a wavefront call writes: ``out`` and ``z_out`` as
    given (checked), else fresh ones."""
    out = torch.empty_like(raw) if out is None else check_out(out, raw)
    if z_slabs is None:
        if z_out is not None:
            raise ValueError("z_out needs z_slabs")
        return out, None
    return out, torch.empty_like(z_slabs) if z_out is None else check_out(z_out, z_slabs, "z_out")


def _plain_into(res, out, z_out):
    """A plain version's result, copied into ``out`` / ``z_out`` where given."""
    if out is None and z_out is None:
        return res
    o, z = res if isinstance(res, tuple) else (res, None)
    o = o if out is None else out.copy_(o)
    z = z if z_out is None else z_out.copy_(z)
    return (o, z) if isinstance(res, tuple) else o


def jacobi_shell_wavefront_step(raw, m, origin, d2, global_size, interior_offset=None,
                                alias=False, z_slabs=None, z_valid=None, out=None, z_out=None):
    """``m`` Jacobi levels over s-shelled block(s) in ONE pass: the compute
    half of the temporally blocked multi-subdomain route.  Arguments and
    result as ``jacobi_shell_wavefront_step_plain``; ``alias=True`` is
    refused (see ``_check_wavefront``).  One CUDA launch serves all ``n``
    blocks; the output is ``out`` (and ``z_out``), fresh buffers when None,
    written on the valid region only."""
    s_off = m if interior_offset is None else interior_offset
    n, Xr, Yr, Zr, zv = _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, False, z_valid)
    if raw.device.type == "cpu":
        _outs(raw, z_slabs, out, z_out)  # checks the buffers
        return _plain_into(jacobi_shell_wavefront_step_plain(raw, m, origin, d2, global_size, interior_offset,
                                                             alias, z_slabs, z_valid), out, z_out)
    out, z_out = _outs(raw, z_slabs, out, z_out)
    _launch_wavefront(raw, out, origin, d2, z_slabs, z_out, n, Xr, Yr, Zr, zv, m, s_off,
                      Zr, global_size, ring=False)
    jacobi_shell_wavefront_step.launches += 1
    return out if z_out is None else (out, z_out)


#: kernel launches made by ``jacobi_shell_wavefront_step``
jacobi_shell_wavefront_step.launches = 0


def jacobi_zring_wavefront_step_plain(raw, m, origin, d2, global_size, z_slabs,
                                      interior_offset=None, alias=False):
    """``m`` Jacobi levels over block(s) ``(Xr, Yr, Zi)`` that carry their
    x/y shell in the array and no z shell (jacobi_pallas.py:1204): each plane
    is staged into the z-ring working plane ``(Yr, 128 + Zi)`` (interior at
    column 128, low halo just below, high halo wrapped to column 0, from
    ``z_slabs``), ``d2`` is ``zring_dist2_plane``.  Returns ``(out, z_out)``;
    exact on the x/y interior and every z column."""
    s_off = m if interior_offset is None else interior_offset
    _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, True)
    single = raw.dim() == 3
    if single:
        raw, origin, d2, z_slabs = _batched(raw, origin, d2, z_slabs)
    Zi = raw.shape[-1]
    w = torch.zeros(raw.shape[:-1] + (_ZRING_OFF + Zi,), dtype=raw.dtype, device=raw.device)
    w[..., _ZRING_OFF:] = raw
    zst = z_slabs.transpose(-1, -2)  # (n, Xr, Yr, 2s)
    w[..., _ZRING_OFF - s_off : _ZRING_OFF] = zst[..., 0:s_off]
    w[..., 0:s_off] = zst[..., s_off:]
    w = _wavefront_levels(w, m, origin, d2, global_size, s_off)
    out = w[..., _ZRING_OFF:].contiguous()
    z_out = _emit(w, _ZRING_OFF, _ZRING_OFF + Zi - s_off, s_off)
    return (out[0], z_out[0]) if single else (out, z_out)


def jacobi_zring_wavefront_step(raw, m, origin, d2, global_size, z_slabs,
                                interior_offset=None, alias=False, out=None, z_out=None):
    """``m`` Jacobi levels in ONE pass over z-interior-only block(s), the z
    halo taken from ``z_slabs`` and the next slabs emitted; arguments and
    result as ``jacobi_zring_wavefront_step_plain``.  One CUDA launch serves
    all ``n`` blocks; the outputs are ``out`` and ``z_out``, fresh buffers
    when None."""
    s_off = m if interior_offset is None else interior_offset
    n, Xr, Yr, Zi, _ = _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, True)
    if raw.device.type == "cpu":
        _outs(raw, z_slabs, out, z_out)
        return _plain_into(jacobi_zring_wavefront_step_plain(raw, m, origin, d2, global_size, z_slabs,
                                                             interior_offset, alias), out, z_out)
    out, z_out = _outs(raw, z_slabs, out, z_out)
    _launch_wavefront(raw, out, origin, d2, z_slabs, z_out, n, Xr, Yr, Zi, Zi + 2 * s_off, m,
                      s_off, _ZRING_OFF + Zi, global_size, ring=True)
    jacobi_zring_wavefront_step.launches += 1
    return out, z_out


#: kernel launches made by ``jacobi_zring_wavefront_step``
jacobi_zring_wavefront_step.launches = 0


def wavefront_marches(m: int) -> int:
    """Kernel launches one wavefront call of ``m`` levels makes: one march,
    or two (the first of ceil(m/2) levels) above ``WAVEFRONT_SUB_DEPTH``."""
    return 1 if m <= WAVEFRONT_SUB_DEPTH else 2


_ENTRY = None
_ENTRIES = {}


def _entry():
    """``(C entry, library)`` of ``stp_jacobi_wavefront``, built and loaded
    at the first launch."""
    global _ENTRY
    if _ENTRY is None:
        from stencil_tpu_torch.kernels import build

        lib = build.load("jacobi_wavefront")
        _ENTRY = (lib.stp_jacobi_wavefront, lib)
    return _ENTRY


def _c_entry(name: str):
    """``(C entry, library)`` of ``stp_jacobi_wrap``, ``stp_jacobi_plane``,
    ``stp_jacobi_slab`` or ``stp_mean6_march``, from the same library, looked
    up at the first launch."""
    found = _ENTRIES.get(name)
    if found is None:
        lib = _entry()[1]
        found = _ENTRIES[name] = (getattr(lib, name), lib)
    return found


def _launch_wavefront(raw, out, origin, d2, z_slabs, z_out, n, Xr, Yr, Zraw, width, m, s_off,
                      d2_w, global_size, ring):
    """One call of ``csrc/jacobi_wavefront.cu`` over all ``n`` blocks;
    ``width`` is the logical plane width (z_valid, or Zi + 2s on the ring).
    Two marches pass their intermediate level through an ``(n, Xr, Yr,
    width)`` scratch from torch's caching allocator."""
    gx = int(global_size[0])
    hot_x, cold_x, in_r2 = sphere_params(gx)
    scratch = None
    if wavefront_marches(m) > 1:
        scratch = raw.new_empty((n, Xr, Yr, width))
    entry, lib = _entry()
    rc = entry(
        raw.data_ptr(), out.data_ptr(), origin.data_ptr(), d2.data_ptr(),
        None if z_slabs is None else z_slabs.data_ptr(),
        None if z_out is None else z_out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        n, Xr, Yr, Zraw, width, m, s_off, d2_w, gx, hot_x, cold_x, in_r2, int(ring),
        current_raw_stream(raw.device.index),
    )
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_zring_wavefront_step" if ring else "jacobi_shell_wavefront_step")


#: the fields of ``jacobi_wavefront_launch``, in the order the C entry
#: ``stp_jacobi_wavefront_plan`` fills them
WAVEFRONT_PLAN_FIELDS = ("form", "launches", "depth", "blocks_per_sm", "sms", "blocks", "xchunk", "nchunks",
                         "smem_bytes", "threads", "tiles_z", "tiles_y")
_WAVEFRONT_FORMS = ("z-ring", "shell z-slab", "shell")


def jacobi_wavefront_launch(shape, m: int, interior_offset=None, ring: bool = False, slabs: bool = False,
                            z_valid=None) -> dict:
    """The launches a wavefront call over blocks of ``shape`` (``(Xr, Yr,
    Z)`` or ``(n, Xr, Yr, Z)``) makes on the card, without making them:
    ``form`` ("z-ring", "shell z-slab" or "shell"), kernel ``launches`` a call
    (marches) and the first march's ``depth``, blocks an SM the occupancy
    calculator allows, the grid's blocks and its ``waves`` (blocks over the
    blocks resident at once), the x chunking, the shared memory and threads a
    block asks and the tiles along z and y (fields as
    ``WAVEFRONT_PLAN_FIELDS``)."""
    n = 1 if len(shape) == 3 else shape[0]
    Xr, Yr, Z = shape[-3:]
    s_off = m if interior_offset is None else interior_offset
    width = Z + 2 * s_off if ring else (Z if z_valid is None else int(z_valid))
    lib = _entry()[1]
    info = (ctypes.c_int * len(WAVEFRONT_PLAN_FIELDS))()
    rc = lib.stp_jacobi_wavefront_plan(n, Xr, Yr, Z, width, m, s_off, int(ring), int(ring or slabs), info)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_wavefront_launch")
    plan = dict(zip(WAVEFRONT_PLAN_FIELDS, info))
    plan["form"] = _WAVEFRONT_FORMS[plan["form"]]
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan


#: the fields of ``jacobi_wrap_launch``, in the order the C entry
#: ``stp_jacobi_wrap_plan`` fills them
WRAP_PLAN_FIELDS = ("launches", "depth", "blocks_per_sm", "sms", "blocks", "xchunk", "nchunks", "smem_bytes",
                    "threads", "tiles_z", "tiles_y")


def jacobi_wrap_launch(shape, k: int) -> dict:
    """The launches a ``jacobi_wrap_step`` call of ``k`` levels over an
    ``(X, Y, Z)`` domain makes on the card, without making them: kernel
    ``launches`` a call (marches) and their ``depths``, and of the first
    march its ``depth``, blocks an SM the occupancy calculator allows, SMs,
    the grid's blocks and its ``waves``, the x chunking, the shared memory
    and threads a block asks and the tiles along z and y (fields as
    ``WRAP_PLAN_FIELDS``)."""
    X, Y, Z = shape
    lib = _entry()[1]
    info = (ctypes.c_int * len(WRAP_PLAN_FIELDS))()
    rc = lib.stp_jacobi_wrap_plan(X, Y, Z, k, info)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_wrap_launch")
    plan = dict(zip(WRAP_PLAN_FIELDS, info))
    plan["depths"] = wrap_march_depths(k)
    if (plan["launches"], plan["depth"]) != (len(plan["depths"]), plan["depths"][0]):
        raise RuntimeError(f"stp_jacobi_wrap_plan splits k={k} otherwise than wrap_march_depths: {plan}")
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan


#: the fields of ``jacobi_plane_launch`` and ``jacobi_slab_launch``, in the
#: order the C entries ``stp_jacobi_plane_plan`` / ``stp_jacobi_slab_plan``
#: fill them
ONELEVEL_PLAN_FIELDS = ("blocks_per_sm", "sms", "blocks", "xchunk", "nchunks", "smem_bytes", "threads",
                        "tiles_z", "tiles_y")


def _onelevel_launch(plan_entry: str, shape) -> dict:
    n = 1 if len(shape) == 3 else shape[0]
    X, Y, Z = shape[-3:]
    lib = _entry()[1]
    info = (ctypes.c_int * len(ONELEVEL_PLAN_FIELDS))()
    rc = getattr(lib, plan_entry)(n, X, Y, Z, info)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, plan_entry)
    plan = dict(zip(ONELEVEL_PLAN_FIELDS, info))
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan


def jacobi_plane_launch(shape) -> dict:
    """The launch a ``jacobi_plane_step`` call over shell-carrying blocks of
    ``shape`` (``(X, Y, Z)`` or ``(n, X, Y, Z)``) makes on the card, without
    making it: one kernel, a march of depth 1; blocks an SM the occupancy
    calculator allows, SMs, the grid's blocks and its ``waves``, the x
    chunking, the shared memory and threads a block asks and the tiles along
    z and y (fields as ``ONELEVEL_PLAN_FIELDS``)."""
    return _onelevel_launch("stp_jacobi_plane_plan", shape)


def jacobi_slab_launch(shape) -> dict:
    """The launch a ``jacobi_slab_step`` call over bare interiors of
    ``shape`` makes on the card, as ``jacobi_plane_launch``."""
    return _onelevel_launch("stp_jacobi_slab_plan", shape)
