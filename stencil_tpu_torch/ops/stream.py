"""The plane-streaming engine for user step kernels, and the z-slab helpers.

Counterpart of ``stencil_tpu/ops/stream.py``.  It runs the SAME
``(views, info) -> {name: values}`` kernel that ``make_step``'s torch engine
runs, through three hand-written CUDA kernels that replace the JAX package's
TPU kernels:

* ``stream_wrap_pass`` (``stream.py:698``): k levels over the whole
  single-subdomain periodic domain (``csrc/stream_wrap.cu``, one level per
  launch);
* ``stream_plane_pass`` (``stream.py:279``): one level over shell-carrying
  blocks, any read radius r >= 1, the shell passing through
  (``csrc/stream_plane.cu``);
* ``stream_wavefront_pass`` (``stream.py:481``): m levels (r = 1) over
  s-shell blocks in one pass, in z-slab and plain forms
  (``csrc/stream_wavefront.cu``; a kernel that reads x-1 and x+1 only at
  the centre, as Astaroth's does, gets its register-queue form).

The kernel is traced once (``ops/stream_trace.py``) into an expression graph;
its CUDA body is emitted into each kernel template and built by nvcc, and its
torch evaluation is each kernel's plain version.  On a CUDA tensor each
wrapper launches its kernel (one launch for all subdomains and all fields of
a group); on a CPU tensor it runs the plain version.

``plan_stream`` and ``make_stream_step`` pick and build the routes as the
JAX package does, with a Hopper shared-memory model (``stream_smem_fits``)
in place of the VMEM model: a constant of tile, depth and field count, so
the CPU and the card plan the same depth.  Not ported here: the MXU units,
bf16 inputs and bf16 storage (ROADMAP.md queue 1 item 9), the env and tune
sources of the overlap and halo axes, the tune cache, telemetry events and
the resilience ladder (items 10/11).

**The fused halo** (``halo="fused"``, ``stencil_tpu/ops/stream.py:71-94``):
under a ``yzpack_*`` exchange route each step calls
``ops/exchange.fused_shell_exchange``, which returns the received shell as
small buffers per field (x planes, y rows, z columns, corner-patched in the
sweep order), and the plane and plain-wavefront passes take them as
``fused_shell``: each level-0 cell at a shell position is read from them, z
column over y row over x plane (the fused forms of ``csrc/stream_plane.cu``
and ``csrc/stream_wavefront.cu``).  The stacks never see a halo write: no
unpack, no blend.  Every output cell, shell included, equals the array
form's bit for bit (the wavefront's shell is unwritten on the card in both
forms).  It needs even shards and every shell width > 0.

**The split schedule** (``overlap="split"``, ``stream.py:32-69``): the
interior pass runs on PyTorch's current stream over the PRE-exchange stacks
while ``halo_exchange_multi`` runs on a second CUDA stream; an event orders
after both six narrow passes over ``3w``-wide face sub-blocks (``w = m * r``)
of the exchanged stacks, whose width-``w`` bands are written into the
outputs (x: plane copies; y/z: ``blend_slab``, or ``blend_slab_dynamic`` at
the padded shards' per-block offsets).  A cell at distance ``>= w`` from the
shell never reads the shell, so the interiors are bitwise those of
``overlap="off"``.  The port's exchange writes in place, so the side stream
writes the shell of the stacks the interior pass reads: a value read there
reaches only band cells, which the narrow passes rewrite, and the output's
pass-through shell, which is stale by contract (the step marks it so).  On
the CPU the schedule runs serially and computes the same values.

The z-slab helpers (``stream.py:1080-1135``): the wavefront keeps the z halo
out of the big array.  Each subdomain's z shell lives in a z-major
``(Xr, 2s, Yr)`` slab buffer, rows ``[0, s)`` its low halo and ``[s, 2s)`` its
high halo, which the kernel patches into every plane and re-emits for the
next macro step.  Here every buffer is a ``(px, py, pz, Xr, 2s, Yr)`` stack
over the subdomain grid, and the JAX package's ``ppermute`` is
``shift_from_low`` / ``shift_from_high`` along the grid axis.  The JAX
package leaves these to XLA, not to Pallas, so they are plain torch.
"""

from __future__ import annotations

import ctypes
import operator
import warnings
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.kernels import build, check_out, check_tensor, same_device, stream_handle
from stencil_tpu_torch.ops.captured import Loop, as_step, window_loop
from stencil_tpu_torch.ops.exchange import (
    Y_PACK_ROUTES, fused_shell_exchange, halo_exchange_multi, overlapped, shift_from_high, shift_from_low,
    side_stream,
)
from stencil_tpu_torch.ops.halo_blend import blend_slab, blend_slab_dynamic, supports
from stencil_tpu_torch.ops.jacobi_kernels import _WRAP_MAX_K, SMEM_PER_BLOCK, _emit
from stencil_tpu_torch.ops.stream_trace import PlaneInfo, PlaneView, StreamKernel

__all__ = [
    "PlaneInfo", "PlaneView", "StreamKernel", "make_stream_step", "plan_stream",
    "stream_plane_pass", "stream_plane_pass_plain", "stream_smem_bytes", "stream_smem_fits",
    "stream_wavefront_launch", "stream_wavefront_pass", "stream_wavefront_pass_plain", "stream_wrap_pass",
    "stream_wrap_pass_plain",
]

#: the stream wavefront kernel's tile per block in its general form (the
#: plan's model): 32 output rows of y, and 64 columns of z with the m-cell
#: apron on each side (``csrc/stream_wavefront.cu``)
STREAM_TILE_Y = 32
STREAM_TILE_W = 64

#: what the JAX package plans for its axes, and what the port accepts of them
_PORTED_AXES = {
    "compute_unit": ("vpu", ("mxu", "mxu_band"), "queue 1 item 9"),
    "mxu_input": ("f32", ("bf16",), "queue 1 item 9"),
}

#: the overlap schedules and halo consumption modes (``STREAM_OVERLAP``,
#: ``STREAM_HALO`` of the JAX package)
STREAM_OVERLAP = ("off", "split")
STREAM_HALO = ("array", "fused")

#: the define that builds a template's fused form
_FUSED = "#define STP_FUSED 1\n"

Kernel = Union[Callable, StreamKernel]


def lane_pad_width(z: int) -> int:
    """Plane width rounded up to a 128 multiple.  The TPU route pads its
    z-slab planes so; the port's routes do not (a Hopper row coalesces at
    any width), and keep this for the kernels' ``z_valid`` tests."""
    return -(-z // 128) * 128


def prime_z_slabs(block: torch.Tensor, Zr: int, s: int, out: torch.Tensor = None) -> torch.Tensor:
    """The first outgoing z-slab buffer of a macro chain: the blocks'
    interior z-boundary columns, packed ``[(-z)-bound | (+z)-bound]`` and
    transposed z-major, ``(..., Xr, Yr, Zr) -> (..., Xr, 2s, Yr)``, into
    ``out`` when given.  Every later slab buffer is kernel-emitted."""
    parts = [block[..., Zr - 2 * s : Zr - s].transpose(-1, -2), block[..., s : 2 * s].transpose(-1, -2)]
    if out is not None:
        return torch.cat(parts, dim=-2, out=out)
    return torch.cat(parts, dim=-2).contiguous()


def make_slab_extenders(Xr: int, Yr: int, s: int):
    """``(yext, xext)`` for ``(px, py, pz, Xr, s, Yr)`` slab stacks: after the
    z shift each slab takes rows from its y neighbours, then planes from its
    x neighbours, two hops that carry the xyz-corner cells from the diagonal
    subdomains, in the in-array exchange's sweep order.  Both return a new
    tensor."""

    def yext(S: torch.Tensor) -> torch.Tensor:
        lo_ = shift_from_low(S[..., Yr - 2 * s : Yr - s], 1)
        hi_ = shift_from_high(S[..., s : 2 * s], 1)
        S = S.clone()
        S[..., 0:s] = lo_
        S[..., Yr - s : Yr] = hi_
        return S

    def xext(S: torch.Tensor) -> torch.Tensor:
        lo_ = shift_from_low(S[..., Xr - 2 * s : Xr - s, :, :], 0)
        hi_ = shift_from_high(S[..., s : 2 * s, :, :], 0)
        S = S.clone()
        S[..., 0:s, :, :] = lo_
        S[..., Xr - s : Xr, :, :] = hi_
        return S

    return yext, xext


def permute_and_extend_z_slabs(zout: torch.Tensor, s: int, yext, xext) -> torch.Tensor:
    """One macro step's incoming z-slab stack from the previous one's
    outgoing stack ``(px, py, pz, Xr, 2s, Yr)``: shift the two direction
    halves along grid axis z, then extend each with y- and x-neighbour
    content (corner propagation)."""
    zlo = shift_from_low(zout[..., 0:s, :], 2)
    zhi = shift_from_high(zout[..., s : 2 * s, :], 2)
    return torch.cat([xext(yext(zlo)), xext(yext(zhi))], dim=-2)


# --- shared pieces of the three kernels ---------------------------------------------


def stream_smem_bytes(m: int, n_fields: int) -> int:
    """The plan's model of one block of the m-level stream wavefront kernel:
    per field, 2m + 2 planes (two per level below m, the incoming one and a
    spare for each level's result) of (32 + 2m) x 64 4-byte cells, what the
    kernel's general form asks; its register-queue form asks less
    (``csrc/stream_wavefront.cu``), and each launch computes its own.  A
    constant of depth and field count, so the CPU and the card plan the same
    depth."""
    return n_fields * (2 * m + 2) * (STREAM_TILE_Y + 2 * m) * STREAM_TILE_W * 4


def stream_smem_fits(m: int, n_fields: int) -> bool:
    return stream_smem_bytes(m, n_fields) <= SMEM_PER_BLOCK


def _as_kernel(kernel: Kernel, names: Sequence[str], x_radius: int, global_size) -> StreamKernel:
    """A traced kernel for ``names``: ``kernel`` itself when it is one (the
    engine traces once per step build), else a new trace of the callable."""
    if isinstance(kernel, StreamKernel):
        if kernel.names != list(names):
            raise ValueError(f"traced kernel fields {kernel.names} != {list(names)}")
        return kernel
    return StreamKernel(kernel, names, x_radius, global_size)


def _check_fields(ts: Sequence[torch.Tensor], what: str, ndims) -> Tuple[torch.Size, torch.device]:
    if not ts:
        raise ValueError(f"{what}: no fields")
    for t in ts:
        check_tensor(t, what, ndims=ndims, dtype=torch.float32)
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{what}: every field must have one shape, got {[tuple(t.shape) for t in ts]}")
    return ts[0].shape, same_device(*ts)


def _check_origin(origin: torch.Tensor, n: int, single: bool) -> None:
    check_tensor(origin, "origin", ndims=(1,) if single else (2,), dtype=torch.int32)
    if tuple(origin.shape) != ((3,) if single else (n, 3)):
        raise ValueError(f"origin shape {tuple(origin.shape)} does not fit {n} block(s)")


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _library(sk: StreamKernel, template: str, levels: Sequence[int], defines: str = ""):
    """The built library of ``template`` for this traced kernel."""
    return build.load_generated(template, _source(sk, template, levels, defines))


def _source(sk: StreamKernel, template: str, levels: Sequence[int], defines: str = "") -> str:
    """The full source of ``template`` with this traced kernel's body."""
    key = (template, tuple(levels), defines)
    text = sk.cache.get(key)
    if text is None:
        text = sk.cache[key] = build.generated_source(template, sk.cuda_body(levels) + defines)
    return text


def _full(vals: Sequence[torch.Tensor], shape) -> List[torch.Tensor]:
    """Each value broadcast to ``shape`` as a tensor of its own (a constant
    or a pass-through output may be a view)."""
    return [v.expand(shape).contiguous() if v.shape != shape else v for v in vals]


def _roll(t: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    """``t`` read at (x+dx, y+dy, z+dz) over its last three axes, wrapping."""
    shifts = [(-d, t.dim() - 3 + ax) for ax, d in enumerate((dx, dy, dz)) if d]
    if not shifts:
        return t
    return torch.roll(t, [s for s, _ in shifts], [a for _, a in shifts])


def _wrapped(origin_col: torch.Tensor, start: int, count: int, g: int, shape) -> torch.Tensor:
    """Global coordinates ``(origin + g + start + i) mod g`` for i < count,
    int32, viewed to ``shape`` (``_yz_coord_planes`` of the JAX package)."""
    i = torch.arange(count, device=origin_col.device)
    return ((origin_col.long() + g + start + i) % g).to(torch.int32).view(shape)


def _check_fused(fused_shell, raws, lo, hi) -> None:
    """The fused shell buffers of ``raws`` (``(X, Y, Z)`` or ``(n, X, Y, Z)``
    blocks per field): ``(xbufs, ybufs, zbufs)``, one tensor per field each,
    ``(.., lo.x + hi.x, Y, Z)``, ``(.., lo.y + hi.y, X, Z)`` and ``(.., lo.z
    + hi.z, Y, X)`` float32 on the blocks' device (``fused_shell_exchange``'s
    layouts).  The passes' own checks hold every shell width >= 1."""
    if not (isinstance(fused_shell, (tuple, list)) and len(fused_shell) == 3):
        raise ValueError("fused_shell must be (xbufs, ybufs, zbufs)")
    *lead, X, Y, Z = raws[0].shape
    wants = ((lo.x + hi.x, Y, Z), (lo.y + hi.y, X, Z), (lo.z + hi.z, Y, X))
    for what, bufs, want in zip(("xbufs", "ybufs", "zbufs"), fused_shell, wants):
        if len(bufs) != len(raws):
            raise ValueError(f"fused_shell {what}: {len(bufs)} buffers for {len(raws)} fields")
        shape, _ = _check_fields(bufs, f"fused_shell {what}", (len(lead) + 3,))
        if tuple(shape) != (*lead, *want):
            raise ValueError(f"fused_shell {what}: shape {tuple(shape)}, want {(*lead, *want)}")
        same_device(raws[0], bufs[0])


def _fused_level0(b: torch.Tensor, xb, yb, zb, lo, hi) -> torch.Tensor:
    """Block(s) ``b`` ``(n, X, Y, Z)`` with the fused shell in place, as the
    exchange would have left them (``_fused_plane_patch``,
    ``stencil_tpu/ops/stream.py:239-259``): the x planes, then the y rows,
    then the z columns.  Returns a new tensor."""
    X, Y, Z = b.shape[-3:]
    w = b.clone()
    w[:, : lo.x] = xb[:, : lo.x]
    w[:, X - hi.x :] = xb[:, lo.x :]
    w[:, :, : lo.y] = yb[:, : lo.y].transpose(1, 2)
    w[:, :, Y - hi.y :] = yb[:, lo.y :].transpose(1, 2)
    w[..., : lo.z] = zb[:, : lo.z].permute(0, 3, 2, 1)
    w[..., Z - hi.z :] = zb[:, lo.z :].permute(0, 3, 2, 1)
    return w


def _fused_blocks(bs, fused_shell, lo, hi, single: bool) -> List[torch.Tensor]:
    """The ``(n, X, Y, Z)`` level-0 blocks of a fused pass's plain version."""
    lead = (lambda t: t[None]) if single else (lambda t: t)
    return [_fused_level0(b, lead(xb), lead(yb), lead(zb), lo, hi) for b, xb, yb, zb in zip(bs, *fused_shell)]


# --- stream_wrap_pass ---------------------------------------------------------------


def _check_wrap(names, blocks, k, origin):
    shape, dev = _check_fields(blocks, "blocks", (3,))
    if len(names) != len(blocks):
        raise ValueError(f"{len(names)} names for {len(blocks)} blocks")
    if not 1 <= k <= max(1, shape[0] // 2):
        raise ValueError(f"k={k} needs 1 <= k <= X//2 = {shape[0] // 2}")
    _check_origin(origin, 1, True)
    same_device(blocks[0], origin)
    return shape, dev


def stream_wrap_pass_plain(kernel: Kernel, names, blocks, k: int, origin, global_size) -> List[torch.Tensor]:
    """``k`` levels of ``kernel`` over the whole periodic domain, one
    ``(X, Y, Z)`` tensor per field, with rolls; returns new tensors."""
    shape, dev = _check_wrap(names, blocks, k, origin)
    sk = _as_kernel(kernel, names, 1, global_size)
    X, Y, Z = shape
    gx, gy, gz = sk.global_size
    org = origin.cpu()
    xyz = (_wrapped(org[0], 0, X, gx, (X, 1, 1)).to(dev), _wrapped(org[1], 0, Y, gy, (1, Y, 1)).to(dev),
           _wrapped(org[2], 0, Z, gz, (1, 1, Z)).to(dev))
    cur = list(blocks)
    for level in range(1, k + 1):
        src = cur
        cur = _full(sk.evaluate(lambda q, dx, dy, dz: _roll(src[q], dx, dy, dz), lambda: xyz, dev, level), shape)
    return cur


def _check_outs(out, ins) -> List[torch.Tensor]:
    """``out``: one buffer per input, each of its input's shape, none of them
    an input."""
    if len(out) != len(ins):
        raise ValueError(f"out holds {len(out)} tensors for {len(ins)} fields")
    for o in out:
        check_out(o, ins[0])
    if {o.data_ptr() for o in out} & {t.data_ptr() for t in ins}:
        raise ValueError("out must not alias the inputs")
    return list(out)


def stream_wrap_pass(kernel: Kernel, names, blocks, k: int, origin, global_size, out=None) -> List[torch.Tensor]:
    """``k`` levels of ``kernel`` over the WHOLE periodic domain (the single-
    subdomain route), one ``(X, Y, Z)`` float32 tensor per field; ``origin``
    the (3,) int32 global start.  Returns ``out`` (new tensors when None);
    ``blocks`` are left as they were.  On CUDA: ``k`` launches of the
    one-level kernel over all fields, ping-ponging between the outputs and a
    second set of fresh buffers."""
    shape, dev = _check_wrap(names, blocks, k, origin)
    if out is not None:
        out = _check_outs(out, blocks)
    if dev.type == "cpu":
        res = stream_wrap_pass_plain(kernel, names, blocks, k, origin, global_size)
        return res if out is None else [o.copy_(r) for o, r in zip(out, res)]
    sk = _as_kernel(kernel, names, 1, global_size)
    lib = _library(sk, "stream_wrap", _WRAP_LEVELS if k <= _WRAP_MAX_K else range(1, k + 1))
    X, Y, Z = shape
    gx, gy, gz = sk.global_size
    bufs = [[torch.empty_like(b) for b in blocks] if out is None else out,
            [torch.empty_like(b) for b in blocks] if k > 1 else None]
    stream = stream_handle(dev)
    src = list(blocks)
    for level in range(1, k + 1):
        dst = bufs[(k - level) % 2]
        rc = lib.stp_stream_wrap_level(_ptrs(src), _ptrs(dst), origin.data_ptr(), X, Y, Z,
                                       gx, gy, gz, level, stream)
        build.check(lib, rc, "stream_wrap_pass")
        stream_wrap_pass.launches += 1
        src = dst
    return bufs[0]


#: kernel launches made by ``stream_wrap_pass`` (plain-version calls do not count)
stream_wrap_pass.launches = 0


# --- stream_plane_pass --------------------------------------------------------------


def _check_plane(names, raws, lo, hi, x_radius, origin, out, fused_shell=None):
    shape, dev = _check_fields(raws, "raws", (3, 4))
    if len(names) != len(raws):
        raise ValueError(f"{len(names)} names for {len(raws)} blocks")
    single = len(shape) == 3
    n = 1 if single else shape[0]
    X, Y, Z = shape[-3:]
    r = int(x_radius)
    if r < 1 or min(*lo, *hi) < r:
        raise ValueError(f"shell {tuple(lo)}/{tuple(hi)} narrower than the read radius {r}")
    if lo.x + hi.x >= X or lo.y + hi.y >= Y or lo.z + hi.z >= Z:
        raise ValueError(f"block {tuple(shape)} has no interior inside shell {tuple(lo)}/{tuple(hi)}")
    _check_origin(origin, n, single)
    same_device(raws[0], origin)
    if out is not None:
        _check_fields(out, "out", (len(shape),))
        if out[0].shape != shape or len(out) != len(raws):
            raise ValueError("out must hold one tensor of the blocks' shape per field")
        if {o.data_ptr() for o in out} & {r_.data_ptr() for r_ in raws}:
            raise ValueError("out must not alias the input blocks")
        same_device(raws[0], *out)
    if fused_shell is not None:
        _check_fused(fused_shell, raws, lo, hi)
    return n, X, Y, Z, dev


def stream_plane_pass_plain(kernel: Kernel, names, raws, lo: Dim3, hi: Dim3, x_radius: int, origin,
                            global_size, out=None, fused_shell=None) -> List[torch.Tensor]:
    """One level of ``kernel`` over shell-carrying block(s) ``(X, Y, Z)`` or
    ``(n, X, Y, Z)`` per field, with slices; shell cells pass through.
    ``origin`` holds each block's interior start.  ``fused_shell``
    ``(xbufs, ybufs, zbufs)`` (``_check_fused``) is patched into a copy of
    the blocks first, x planes, y rows, z columns, and the shell passes
    through with those values."""
    n, X, Y, Z, dev = _check_plane(names, raws, lo, hi, x_radius, origin, out, fused_shell)
    sk = _as_kernel(kernel, names, x_radius, global_size)
    single = raws[0].dim() == 3
    bs = [r[None] if single else r for r in raws]
    if fused_shell is not None:
        bs = _fused_blocks(bs, fused_shell, lo, hi, single)
    org = (origin[None] if single else origin).cpu()
    gx, gy, gz = sk.global_size
    ex = (X - lo.x - hi.x, Y - lo.y - hi.y, Z - lo.z - hi.z)
    xyz = tuple(
        torch.stack([_wrapped(org[b, ax], 0, ex[ax], g, (ex[ax],)) for b in range(n)]).view(
            [n] + [ex[ax] if a == ax else 1 for a in range(3)]).to(dev)
        for ax, g in enumerate((gx, gy, gz))
    )

    def load(q, dx, dy, dz):
        return bs[q][:, lo.x + dx : X - hi.x + dx, lo.y + dy : Y - hi.y + dy, lo.z + dz : Z - hi.z + dz]

    vals = sk.evaluate(load, lambda: xyz, dev)
    res = []
    for q, b in enumerate(bs):
        o = torch.empty_like(b) if out is None else (out[q][None] if single else out[q])
        o.copy_(b)
        o[:, lo.x : X - hi.x, lo.y : Y - hi.y, lo.z : Z - hi.z] = vals[q]
        res.append(o[0] if single else o)
    return res


def stream_plane_pass(kernel: Kernel, names, raws, lo: Dim3, hi: Dim3, x_radius: int, origin,
                      global_size, out=None, fused_shell=None) -> List[torch.Tensor]:
    """ONE level of ``kernel`` over shell-carrying block(s) per field (lo/hi
    the shell widths, every shift within ``x_radius`` <= them); shell cells
    pass through.  Returns ``out`` (fresh tensors when None).  One CUDA
    launch serves all ``n`` blocks and all fields.  With ``fused_shell``
    the blocks' shell is stale and every shell-position cell is read from
    the buffers (the fused form; ``stream_plane_pass_plain``)."""
    n, X, Y, Z, dev = _check_plane(names, raws, lo, hi, x_radius, origin, out, fused_shell)
    if dev.type == "cpu":
        return stream_plane_pass_plain(kernel, names, raws, lo, hi, x_radius, origin, global_size, out,
                                       fused_shell)
    sk = _as_kernel(kernel, names, x_radius, global_size)
    res = [torch.empty_like(r) for r in raws] if out is None else list(out)
    gx, gy, gz = sk.global_size
    geometry = (n, X, Y, Z, lo.x, lo.y, lo.z, hi.x, hi.y, hi.z)
    if fused_shell is None:
        lib = _library(sk, "stream_plane", [1])
        rc = lib.stp_stream_plane_level(_ptrs(raws), _ptrs(res), origin.data_ptr(), *geometry, gx, gy, gz,
                                        stream_handle(dev))
        build.check(lib, rc, "stream_plane_pass")
        stream_plane_pass.launches += 1
        return res
    lib = _library(sk, "stream_plane_fused", [1], _FUSED)
    xb, yb, zb = fused_shell
    rc = lib.stp_stream_plane_fused(_ptrs(raws), _ptrs(xb), _ptrs(yb), _ptrs(zb), _ptrs(res), origin.data_ptr(),
                                    *geometry, int(x_radius), gx, gy, gz, stream_handle(dev))
    build.check(lib, rc, "stream_plane_pass (fused)")
    stream_plane_pass.fused_launches += 1
    return res


#: kernel launches made by ``stream_plane_pass``: its array form, and its
#: fused form (``fused_shell``; one a call, its far and band kernels)
stream_plane_pass.launches = 0
stream_plane_pass.fused_launches = 0


# --- stream_wavefront_pass -----------------------------------------------------------


def _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs, z_valid, alias, fused_shell=None):
    if alias:
        raise NotImplementedError(
            "alias=True (an in-place wavefront) is refused: blocks march along x "
            "independently, so a write can land before a neighbouring tile reads "
            "it; see ROADMAP.md (deliberate differences)"
        )
    shape, dev = _check_fields(raws, "raws", (3, 4))
    if len(names) != len(raws):
        raise ValueError(f"{len(names)} names for {len(raws)} blocks")
    single = len(shape) == 3
    n = 1 if single else shape[0]
    Xr, Yr, Zr = shape[-3:]
    zv = Zr if z_valid is None else int(z_valid)
    if not 1 <= m <= s_off:
        raise ValueError(f"m={m} needs 1 <= m <= s_off={s_off}")
    if 2 * s_off >= min(Xr, Yr, zv):
        raise ValueError(f"raws {tuple(shape)} (z_valid {zv}) need > 2*{s_off} cells per axis")
    if zv > Zr:
        raise ValueError(f"z_valid={zv} exceeds the plane width {Zr}")
    if not stream_smem_fits(m, len(raws)):
        raise ValueError(
            f"m={m} over {len(raws)} field(s) needs {stream_smem_bytes(m, len(raws))} bytes of "
            f"shared memory per block, over the H100's {SMEM_PER_BLOCK}; pass fewer fields per call"
        )
    _check_origin(origin, n, single)
    tensors = [raws[0], origin]
    if z_slabs is not None:
        want = (Xr, 2 * s_off, Yr) if single else (n, Xr, 2 * s_off, Yr)
        zshape, _ = _check_fields(z_slabs, "z_slabs", (len(shape),))
        if tuple(zshape) != want or len(z_slabs) != len(raws):
            raise ValueError(f"z_slabs: one {want} tensor per field, got {tuple(zshape)}")
        tensors.append(z_slabs[0])
    same_device(*tensors)
    if fused_shell is not None:
        if z_slabs is not None or zv != Zr:
            raise ValueError("fused_shell takes the plain form: no z_slabs, z_valid = Zr")
        s3 = Dim3(s_off, s_off, s_off)
        _check_fused(fused_shell, raws, s3, s3)
    return n, Xr, Yr, Zr, zv, dev


def stream_wavefront_pass_plain(kernel: Kernel, names, raws, m: int, s_off: int, origin, global_size,
                                z_slabs=None, z_valid=None, alias=False, fused_shell=None):
    """``m`` levels of ``kernel`` over s-shelled block(s) ``(Xr, Yr, Zr)`` or
    ``(n, Xr, Yr, Zr)`` per field, with rolls: every axis wraps, and the
    wrapped cells are the ones the shell was sized to sacrifice.  ``z_slabs``
    ``(.., Xr, 2s, Yr)`` per field replace the z-shell columns ``[0, s)`` and
    ``[z_valid - s, z_valid)`` (columns ``[z_valid, Zr)`` are dead).
    ``fused_shell`` ``(xbufs, ybufs, zbufs)`` (``_check_fused``, every width
    s; the plain form only) is patched into the level-0 blocks, x planes, y
    rows, z columns.  Returns ``(outs, zouts)`` (``zouts`` None without
    slabs); the interior ``[s, ext - s)`` of every axis is exact, shell
    cells are unspecified."""
    n, Xr, Yr, Zr, zv, dev = _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs,
                                              z_valid, alias, fused_shell)
    sk = _as_kernel(kernel, names, 1, global_size)
    single = raws[0].dim() == 3
    if fused_shell is not None:
        s3 = Dim3(s_off, s_off, s_off)
        w = _fused_blocks([r[None] if single else r for r in raws], fused_shell, s3, s3, single)
    else:
        w = [(r[None] if single else r).clone() for r in raws]
    if z_slabs is not None:
        for q, zs in enumerate(z_slabs):
            zst = (zs[None] if single else zs).transpose(-1, -2)  # (n, Xr, Yr, 2s)
            w[q][..., 0:s_off] = zst[..., 0:s_off]
            w[q][..., zv - s_off : zv] = zst[..., s_off:]
    org = (origin[None] if single else origin).cpu()
    gx, gy, gz = sk.global_size
    ext = (Xr, Yr, Zr)
    xyz = tuple(
        torch.stack([_wrapped(org[b, ax], -s_off, ext[ax], g, (ext[ax],)) for b in range(n)]).view(
            [n] + [ext[ax] if a == ax else 1 for a in range(3)]).to(dev)
        for ax, g in enumerate((gx, gy, gz))
    )
    shape = w[0].shape
    for level in range(1, m + 1):
        src = w
        w = _full(sk.evaluate(lambda q, dx, dy, dz: _roll(src[q], dx, dy, dz), lambda: xyz, dev, level),
                  shape)
    outs = [o[0] if single else o for o in w]
    if z_slabs is None:
        return outs, None
    zouts = [_emit(o, s_off, zv - 2 * s_off, s_off) for o in w]
    return outs, [z[0] if single else z for z in zouts]


def stream_wavefront_pass(kernel: Kernel, names, raws, m: int, s_off: int, origin, global_size,
                          z_slabs=None, z_valid=None, alias=False, fused_shell=None, out=None, z_out=None):
    """``m`` levels of ``kernel`` (read radius 1) in ONE pass over s-shelled
    block(s) per field: the compute half of the temporally blocked route.
    Arguments and result as ``stream_wavefront_pass_plain``; ``alias=True``
    is refused.  One CUDA launch serves all ``n`` blocks and all fields; the
    outputs are ``out`` (and ``z_out`` with ``z_slabs``), fresh buffers when
    None, written on the valid region only.  With ``fused_shell`` the
    blocks' shell is stale and every level-0 cell at a shell position is
    read from the buffers (the fused form)."""
    n, Xr, Yr, Zr, zv, dev = _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs,
                                              z_valid, alias, fused_shell)
    if out is not None:
        out = _check_outs(out, raws)
    if z_out is not None:
        if z_slabs is None:
            raise ValueError("z_out needs z_slabs")
        z_out = _check_outs(z_out, z_slabs)
    if dev.type == "cpu":
        outs, zouts = stream_wavefront_pass_plain(kernel, names, raws, m, s_off, origin, global_size,
                                                  z_slabs, z_valid, alias, fused_shell)
        if out is not None:
            outs = [o.copy_(r) for o, r in zip(out, outs)]
        if z_out is not None:
            zouts = [o.copy_(r) for o, r in zip(z_out, zouts)]
        return outs, zouts
    sk = _as_kernel(kernel, names, 1, global_size)
    outs = [torch.empty_like(r) for r in raws] if out is None else out
    gx, gy, gz = sk.global_size
    if fused_shell is not None:
        lib = _library(sk, *_wavefront_variant(m, fused=True))
        xb, yb, zb = fused_shell
        rc = lib.stp_stream_wavefront_fused(_ptrs(raws), _ptrs(xb), _ptrs(yb), _ptrs(zb), _ptrs(outs),
                                            origin.data_ptr(), n, Xr, Yr, Zr, m, s_off, gx, gy, gz,
                                            stream_handle(dev))
        build.check(lib, rc, "stream_wavefront_pass (fused)")
        stream_wavefront_pass.fused_launches += 1
        return outs, None
    lib = _library(sk, *_wavefront_variant(m))
    zouts = None if z_slabs is None else [torch.empty_like(z) for z in z_slabs] if z_out is None else z_out
    slabs = z_slabs is not None
    rc = lib.stp_stream_wavefront(
        _ptrs(raws), _ptrs(outs), _ptrs(z_slabs) if slabs else None, _ptrs(zouts) if slabs else None,
        origin.data_ptr(), n, Xr, Yr, Zr, zv, m, s_off, gx, gy, gz, int(slabs), stream_handle(raws[0].device),
    )
    build.check(lib, rc, "stream_wavefront_pass")
    stream_wavefront_pass.launches += 1
    return outs, zouts


#: the fields of ``stream_wavefront_launch``, in the order the C entry fills them
WAVEFRONT_PLAN_FIELDS = ("queue", "blocks_per_sm", "sms", "blocks", "xchunk", "nchunks", "smem_bytes",
                         "threads", "tiles_z", "tiles_y")


def stream_wavefront_launch(kernel: Kernel, names, raws, m: int, s_off: int, global_size, z_slabs=None,
                            z_valid=None, fused: bool = False) -> dict:
    """The launch ``stream_wavefront_pass`` makes for these arguments on the
    card, without making it: ``form`` ("queue", the register-queue form, or
    "general"), the blocks an SM the occupancy calculator allows, the grid's
    blocks and its ``waves`` (blocks over the blocks resident at once), the
    x chunking, the shared memory and threads a block asks and the tiles
    along z and y (fields as ``WAVEFRONT_PLAN_FIELDS``); ``fused`` plans the
    fused form's launch."""
    shape = raws[0].shape
    n = 1 if len(shape) == 3 else shape[0]
    Xr, Yr, Zr = shape[-3:]
    zv = Zr if z_valid is None else int(z_valid)
    sk = _as_kernel(kernel, names, 1, global_size)
    lib = _library(sk, *_wavefront_variant(m, fused))
    info = (ctypes.c_int * len(WAVEFRONT_PLAN_FIELDS))()
    rc = lib.stp_stream_wavefront_plan(n, Xr, Yr, Zr, zv, m, s_off, int(z_slabs is not None), info)
    build.check(lib, rc, "stream_wavefront_launch")
    plan = dict(zip(WAVEFRONT_PLAN_FIELDS, info))
    plan["form"] = "queue" if plan.pop("queue") else "general"
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan


def _wavefront_variant(m: int, fused: bool = False):
    """(template, levels, defines) of the wavefront library for depth m, or
    of its fused form: one library per depth, so a remainder pass never
    compiles inside a loop."""
    if fused:
        return "stream_wavefront_fused", range(1, m + 1), f"#define STP_M {m}\n" + _FUSED
    return "stream_wavefront", range(1, m + 1), f"#define STP_M {m}\n"


#: the levels a wrap library serves (a kernel that reads ``info.level`` gets
#: one branch per level; the others one body): the deepest wrap plan, or an
#: explicit deeper k
_WRAP_LEVELS = range(1, _WRAP_MAX_K + 1)


#: kernel launches made by ``stream_wavefront_pass``: its z-slab and plain
#: forms, and its fused form (``fused_shell``)
stream_wavefront_pass.launches = 0
stream_wavefront_pass.fused_launches = 0


# --- planning -------------------------------------------------------------------------


def plan_stream(dd, x_radius: int, path: str = "auto", separable: bool = False, max_m: int = None) -> dict:
    """Route planning for ``make_stream_step`` on a realized domain
    (``stencil_tpu/ops/stream.py:913``).

    Returns ``{"route": "wrap"|"wavefront"|"plane", "m": int, "z_slabs": bool,
    "grouping": "joint"|"per-field"}``.  One subdomain and ``x_radius`` 1
    take ``wrap`` (no shell, no exchange), k = min(16, X // 2) levels per
    call (the CUDA kernel runs one level per launch, so no shared memory
    caps k).  Otherwise ``x_radius`` 1 and a uniform face shell s >= 2 take
    the z-slab ``wavefront`` at the deepest m in [2, min(s, 16)] whose
    kernel fits (``stream_smem_fits``): jointly, or per field when the
    kernel is ``separable`` and that goes deeper (joint wins ties).  The
    ``plane`` route covers the rest, jointly (its kernel keeps no planes in
    shared memory).  ``path`` forces a route ("wavefront"/"wrap" raise when
    not viable); ``max_m`` caps the depth.

    Differences from the JAX package's plan, from the two memory models:
    the wrap depth is never capped by memory; the wavefront's joint depth
    falls with the field count (3 fields at s = 3 plan per-field m = 3, or
    joint m = 2 when not separable, where the JAX package keeps joint m = 3
    at small sizes); the plane route never groups per field; the z-slab
    form needs no lane padding, so on even subdomains the plain form is
    reached only with ``make_stream_step(z_slabs=False)``.

    Padded (uneven) subdomains take both routes as in the JAX package
    (``stencil_tpu/ops/stream.py:926-938``): the exchange writes each +axis
    halo right after the valid cells, where the wrapped coordinates ``(origin
    - s + index) mod g`` are right too, and pad cells past it reach only the
    levels the shell sacrifices; only the z-slab form, whose emitted slabs
    sit at the interior z boundary, stays even-only, so they plan the plain
    wavefront."""
    if path not in ("auto", "plane", "wavefront", "wrap"):
        raise ValueError(f"unknown stream path {path!r}")
    shell = dd.shell_radius()
    lo, hi = shell.lo(), shell.hi()
    n = dd.local_spec().sz
    if not all(lo[ax] >= x_radius and hi[ax] >= x_radius for ax in range(3)):
        raise ValueError(f"shell {lo}/{hi} narrower than the kernel x_radius {x_radius}")
    nf = len(dd._handles)
    groupings = [("joint", nf)] + ([("per-field", 1)] if separable and nf > 1 else [])
    if path in ("auto", "wrap") and dd.num_subdomains() == 1 and x_radius == 1:
        cap = min(_WRAP_MAX_K, n.x // 2)
        if max_m is not None:
            cap = min(cap, max_m)
        if cap >= 1:
            return {"route": "wrap", "m": cap, "z_slabs": False, "grouping": "joint"}
    if path == "wrap":
        raise ValueError("path='wrap' needs a single subdomain with >= 2 x-planes and x_radius 1")
    uniform = len({lo.x, lo.y, lo.z, hi.x, hi.y, hi.z}) == 1
    s = lo.x
    if path != "plane" and x_radius == 1 and uniform and s >= 2:
        cap = min(s, _WRAP_MAX_K)
        if max_m is not None:
            cap = min(cap, max_m)
        best = None
        for grouping, fields in groupings:
            m = max([c for c in range(2, cap + 1) if stream_smem_fits(c, fields)], default=0)
            if m >= 2 and (best is None or m > best["m"]):
                best = {"route": "wavefront", "m": m, "z_slabs": not dd.padded(), "grouping": grouping}
        if best is not None:
            return best
    if path == "wavefront":
        raise ValueError(
            "path='wavefront' needs x_radius 1, a uniform face shell >= 2 and shared memory "
            f"for m >= 2; got shell {lo}/{hi}"
        )
    return {"route": "plane", "m": 1, "z_slabs": False, "grouping": "joint"}


def _check_axes(**requests) -> None:
    for axis, value in requests.items():
        static, later, item = _PORTED_AXES[axis]
        if value not in ("auto", static):
            raise NotImplementedError(
                f"{axis}={value!r}: the port runs 'auto' or {static!r} only (ROADMAP.md {item} "
                f"ports the JAX package's {later})"
            )


def _warn(msg: str) -> None:
    warnings.warn(msg, RuntimeWarning, stacklevel=4)


def _resolve_stream_overlap(plan: dict) -> Tuple[str, str]:
    """``(value, source)`` of a plan's overlap schedule
    (``stencil_tpu/ops/stream.py:1156-1218`` without the env and tune
    sources): an explicit request (``overlap_forced``) or the static
    ``off``.  A ``split`` the plan cannot serve (the wrap route has no
    exchange to hide; the z-slab wavefront interleaves its slab permutes
    with the pass) degrades to ``off`` with a ``RuntimeWarning``, source
    tagged ``/degraded``."""
    val, source = (plan["overlap"], "explicit") if plan.get("overlap_forced") else ("off", "static")
    if val == "split" and (plan.get("route") not in ("plane", "wavefront") or plan.get("z_slabs")):
        why = ("the z-slab wavefront interleaves its slab permutes with the pass" if plan.get("z_slabs")
               else f"the {plan.get('route')!r} route has no exchange to hide")
        _warn(f"overlap=split ({source}) cannot engage here ({why}); degrading to overlap=off")
        val, source = "off", source + "/degraded"
    return val, source


def fused_halo_ineligible(dd, plan: dict, exch_route: str) -> Optional[str]:
    """Why ``halo="fused"`` cannot engage for this plan, domain and exchange
    route, or None when it can (``stencil_tpu/ops/stream.py:1221-1251``)."""
    if plan.get("route") not in ("plane", "wavefront"):
        return f"the {plan.get('route')!r} route has no exchange to fuse"
    if plan.get("z_slabs"):
        return "the z-slab wavefront already keeps z halos out of the big array"
    if plan.get("overlap") == "split":
        return "the split schedule's exterior band passes read exchanged blocks"
    if exch_route not in Y_PACK_ROUTES:
        return (f"the {exch_route!r} exchange route does not pack the y shell "
                f"(fused needs one of {Y_PACK_ROUTES})")
    if dd.padded():
        return "padded (uneven) shards: the fused pack cuts at static offsets"
    if not all(supports(h.dtype) for h in dd._handles):
        return "a field dtype the pack kernels do not take"
    return None


def _resolve_stream_halo(dd, plan: dict, exch_route: str) -> Tuple[str, str]:
    """``(value, source)`` of a plan's halo consumption mode
    (``stencil_tpu/ops/stream.py:1254-1311`` without the env and tune
    sources): an explicit request (``halo_forced``) or the static
    ``array``; a ``fused`` the plan cannot serve (``fused_halo_ineligible``)
    degrades to ``array`` with a ``RuntimeWarning``."""
    val, source = (plan["halo"], "explicit") if plan.get("halo_forced") else ("array", "static")
    if val == "fused":
        why = fused_halo_ineligible(dd, plan, exch_route)
        if why is not None:
            _warn(f"halo=fused ({source}) cannot engage here ({why}); degrading to halo=array")
            val, source = "array", source + "/degraded"
    return val, source


def plain_wavefront_plan(plan: dict) -> Optional[dict]:
    """The plain-form twin of a z-slab wavefront plan, or None
    (``stencil_tpu/ops/stream.py:1314-1342``): split and fused need every
    axis's halo on the blocks' side of the pass.  The port's shared-memory
    model (``stream_smem_fits``) does not depend on the z form, so the twin
    keeps the plan's depth."""
    if plan.get("route") != "wavefront" or not plan.get("z_slabs"):
        return None
    return dict(plan, z_slabs=False)


def _check_depth(max_depth):
    if max_depth is None:
        return None
    if isinstance(max_depth, bool):  # True would cap depth at 1 silently
        raise ValueError(f"stream_depth must be an integer, got {max_depth!r}")
    try:
        max_depth = operator.index(max_depth)
    except TypeError:
        raise ValueError(f"stream_depth must be an integer >= 1, got {max_depth!r}") from None
    if max_depth < 1:
        raise ValueError(
            f"stream_depth must be >= 1, got {max_depth} (a 0/negative cap would silently "
            "disable temporal blocking)"
        )
    return max_depth


def make_stream_step(dd, kernel: Callable, x_radius: int = 1, path: str = "auto", separable: bool = False,
                     max_depth: int = None, overlap: str = "auto", halo: str = "auto",
                     compute_unit: str = "auto", mxu_input: str = "auto", mxu_kernel: Callable = None,
                     z_slabs: Optional[bool] = None):
    """Build ``step(curr, steps) -> curr`` running ``kernel`` under the
    plane-streaming engine (``DistributedDomain.make_step(...,
    engine="stream")``; ``stencil_tpu/ops/stream.py:1861``).

    The kernel is the same ``(views, info) -> {name: values}`` callable the
    torch engine accepts, restricted to what ``ops/stream_trace.py`` traces:
    every shift within ``x_radius``, elementwise arithmetic.
    ``separable=True`` declares the kernel correct on any subset of the
    views, so many fields may stream per field.  ``max_depth`` caps the
    temporal depth (wrap k / wavefront m).  ``compute_unit`` and
    ``mxu_input`` take ``"auto"`` or the static value the port runs (vpu,
    f32); ``mxu_kernel`` is accepted and unused.  ``z_slabs=False`` runs a
    wavefront plan in its plain form (every axis exchanged in the array, as
    on uneven sizes, where the plan takes it and ``z_slabs=True`` raises).

    ``overlap`` (``"auto"`` = ``"off"``, or ``"split"``) and ``halo``
    (``"auto"`` = ``"array"``, or ``"fused"``) select the split schedule and
    the fused halo (module docstring).  A ``split`` or ``fused`` request
    re-plans a z-slab wavefront to the plain form (``plain_wavefront_plan``;
    not when ``z_slabs`` is given); a request the plan cannot serve degrades
    with a ``RuntimeWarning`` where the JAX package degrades it: split on
    the wrap route or a z-slab plan; fused on the wrap route, a z-slab plan,
    under split, off the ``yzpack_*`` exchange routes or on uneven shards.

    Per call, on the plan's route: ``wrap`` slices each subdomain interior
    out, runs ``steps // k`` passes of k levels and one of ``steps % k``,
    and writes it back; ``plane`` exchanges and runs one level per step;
    ``wavefront`` runs ``steps // m`` macro steps of m levels and one of
    ``steps % m`` over the same s-wide shell, each macro exchanging x/y in
    the array and z on the slab buffers (z-slab form) or all axes in the
    array (plain form).  The plane route and the plain form exchange through
    ``dd.exchange_route()``; the z-slab form's x/y exchange is ``direct``,
    as in the JAX package.  Fields stream jointly or per field as the plan
    groups them.  On CUDA every kernel variant the plan can launch is built
    when the step is built, all nvcc runs at once.  The shell goes stale
    (``step._marks_shell_stale``); ``step._stream_plan`` is the plan, with
    the resolved ``overlap`` and ``halo``.  Component (N-D) quantities
    are refused, as the JAX engine refuses them
    (``stencil_tpu/ops/stream.py:953-954``): the torch engine takes them."""
    if any(h.components for h in dd._handles):
        raise ValueError("the streaming engine does not support N-D component data")
    _check_axes(compute_unit=compute_unit, mxu_input=mxu_input)
    if overlap not in ("auto",) + STREAM_OVERLAP:
        raise ValueError(f"unknown stream overlap {overlap!r} (one of {('auto',) + STREAM_OVERLAP})")
    if halo not in ("auto",) + STREAM_HALO:
        raise ValueError(f"unknown stream halo mode {halo!r} (one of {('auto',) + STREAM_HALO})")
    del mxu_kernel
    max_depth = _check_depth(max_depth)
    plan = dict(plan_stream(dd, x_radius, path, separable, max_m=max_depth))
    if z_slabs is not None and plan["route"] == "wavefront":
        if z_slabs and dd.padded():
            raise ValueError("z_slabs=True: the z-slab wavefront form needs even (unpadded) subdomains")
        plan["z_slabs"] = bool(z_slabs)
    if overlap != "auto":
        plan.update(overlap=overlap, overlap_forced=True)
    if halo != "auto":
        plan.update(halo=halo, halo_forced=True)
    if z_slabs is None and (overlap == "split" or halo == "fused"):
        plan = plain_wavefront_plan(plan) or plan
    plan["overlap"] = _resolve_stream_overlap(plan)[0]
    plan["halo"] = _resolve_stream_halo(dd, plan, dd.exchange_route())[0]
    for key in ("overlap_forced", "halo_forced"):
        plan.pop(key, None)
    plan.update(compute_unit="vpu", mxu_input="f32")
    names = [h.name for h in dd._handles]
    if dd.device.type == "cuda" and any(h.dtype != torch.float32 for h in dd._handles):
        raise NotImplementedError(
            "the CUDA stream kernels take float32 fields (ROADMAP.md queue 1 item 9)"
        )
    groups = [[q] for q in range(len(names))] if plan["grouping"] == "per-field" else [list(range(len(names)))]
    gsize = dd.size()
    programs = [StreamKernel(kernel, [names[q] for q in g], x_radius, gsize) for g in groups]
    route = plan["route"]
    if dd.device.type == "cuda":
        _prebuild(programs, plan)
    build = {"wrap": _wrap_route, "plane": _plane_route, "wavefront": _wavefront_route}[route]
    step = build(dd, names, groups, programs, plan, x_radius)
    step._stream_plan = plan
    step._marks_shell_stale = True
    return step


def _prebuild(programs: Sequence[StreamKernel], plan: dict) -> None:
    """Build every library the plan's route can launch, one nvcc each, all
    started together (the same body is built once)."""
    route, fused = plan["route"], plan["halo"] == "fused"
    if route == "wrap":
        variants = [("stream_wrap", _WRAP_LEVELS, "")]
    elif route == "plane":
        variants = [("stream_plane_fused", [1], _FUSED) if fused else ("stream_plane", [1], "")]
    else:  # the plan's depth and every remainder depth (the split bands' too)
        variants = [_wavefront_variant(d, fused) for d in range(1, plan["m"] + 1)]
    want = [(v[0], _source(p, *v)) for p in programs for v in variants]
    build.build_generated(dict.fromkeys(want))


# --- the split schedule (stencil_tpu/ops/stream.py:1453-1549) -----------------------


def _window(t: torch.Tensor, ax: int, starts: Sequence[int], width: int) -> torch.Tensor:
    """``[start, start + width)`` along spatial ``ax`` of each block of the
    ``(n, X, Y, Z)`` batch ``t``, contiguous (one start per block)."""
    if len(set(starts)) == 1:
        return t.narrow(1 + ax, starts[0], width).contiguous()
    return torch.stack([t[b].narrow(ax, p, width) for b, p in enumerate(starts)])


def _exterior_fix(dd, narrow: Callable, keys: Sequence[Tuple[int, bool]]) -> Callable:
    """``fix(outs, ex, w, shift_all)``: recompute the six width-``w`` boundary
    bands of the ``(n, X, Y, Z)`` outputs ``outs`` from the exchanged blocks
    ``ex`` and write them in (``_exterior_fix``,
    ``stencil_tpu/ops/stream.py:1516-1538``).  Each band's support window is
    exactly ``3w`` wide (``_band_window`` rounds it up to the TPU's tile
    granule, a Mosaic constraint the card does not have; the band values are
    the same either way), slid down, never past 0, to stay inside the raw
    extent.  ``narrow(subs, ax, w, origin_sub)`` runs the pass over the
    window sub-blocks, the origin shifted so that wrapped coordinates match
    the full pass: along ``ax`` by ``start - lo + w``, and along the other
    axes by ``w - lo`` when ``shift_all`` (the wavefront's pseudo shell of
    ``w`` on every axis).  The high face sits right after each block's valid
    cells: per-block offsets on padded axes, written by
    ``blend_slab_dynamic``; x bands on even axes are plane copies, y and z
    bands go through ``blend_slab``.  Band overlaps at edges and corners
    write identical values twice.  The band table of every ``(w, shift_all)`` in ``keys``
    (its int32 offsets and origins on the device) is built here, with the
    step, so a call makes no host-to-device copy."""
    lo, hi = dd.shell_radius().lo(), dd.shell_radius().hi()
    raw = dd.local_spec().raw_size()
    n = dd.local_spec().sz
    grid = dd.grid_dim().tuple()
    count = dd.num_subdomains()
    valid_last = dd.valid_last() or (None, None, None)
    index = [[(b // (grid[1] * grid[2]), b // grid[2] % grid[1], b % grid[2])[ax] for b in range(count)]
             for ax in range(3)]
    origins = dd.origins()

    def bands(w: int, shift_all: bool) -> list:
        out = []
        for ax in range(3):
            nvs = [valid_last[ax] if valid_last[ax] is not None and i == grid[ax] - 1 else n[ax]
                   for i in index[ax]]
            width = min(3 * w, raw[ax])
            for starts, poss in (([lo[ax] - w] * count, [lo[ax]] * count),
                                 ([lo[ax] + v - 2 * w for v in nvs], [lo[ax] + v - w for v in nvs])):
                starts = [max(min(p, raw[ax] - width), 0) for p in starts]
                delta = torch.tensor([[p - lo[ax] + w if b == ax else (w - lo[b] if shift_all else 0)
                                       for b in range(3)] for p in starts], dtype=torch.int32)
                origin_sub = (origins + delta.to(origins.device)).contiguous()
                pos = torch.tensor(poss, dtype=torch.int32, device=origins.device)
                offs = [p - q for p, q in zip(poss, starts)]
                out.append((ax, starts, width, offs, poss, pos, origin_sub))
        return out

    table = {key: bands(*key) for key in keys}

    def fix(outs: List[torch.Tensor], ex: List[torch.Tensor], w: int, shift_all: bool) -> None:
        for ax, starts, width, offs, poss, pos, origin_sub in table[(w, shift_all)]:
            subs = narrow([_window(e, ax, starts, width) for e in ex], ax, w, origin_sub)
            for o, sub in zip(outs, subs):
                band = _window(sub, ax, offs, w)
                if len(set(poss)) > 1:
                    blend_slab_dynamic(o, band, ax, pos)
                elif ax == 0:
                    o.narrow(1, poss[0], w).copy_(band)
                else:
                    blend_slab(o, band, ax, poss[0])

    return fix


# --- the routes -------------------------------------------------------------------------
#
# Each route is a ``captured.Loop`` (``ops/captured.py``): the same phases run
# uncaptured from ``step(curr, steps)`` and as CUDA graphs under
# ``DistributedDomain.set_capture``.


def _blocks(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``(px, py, pz, ...) -> (n, ...)`` views: one launch serves all."""
    return [t.view(-1, *t.shape[3:]) for t in ts]


def _wrap_route(dd, names, groups, programs, plan, x_radius):
    k = plan["m"]
    n = dd.local_spec().sz
    lo = dd.shell_radius().lo()
    origin = dd.origins()[0].contiguous()
    gsize = dd.size()
    inner = (0, 0, 0, slice(lo.x, lo.x + n.x), slice(lo.y, lo.y + n.y), slice(lo.z, lo.z + n.z))

    # each field's interior is worked on in two (X, Y, Z) buffers, k levels a body
    def body(cur, nxt, depth):
        for g, sk in zip(groups, programs):
            stream_wrap_pass(sk, sk.names, [cur.fields[q] for q in g], depth, origin, gsize,
                             out=[nxt.fields[q] for q in g])

    return as_step(window_loop(names, k, body, inner))


def _grouped(groups, bs, fused_bufs, run, outs) -> None:
    """``run(sk_index, blocks, fused_shell, out)`` for each group over its
    fields' blocks (fused buffers and outputs)."""
    for j, g in enumerate(groups):
        fs = None if fused_bufs is None else tuple([b[q] for q in g] for b in fused_bufs)
        run(j, [bs[q] for q in g], fs, [outs[q] for q in g])


def _plane_route(dd, names, groups, programs, plan, x_radius):
    shell = dd.shell_radius()
    lo, hi = shell.lo(), shell.hi()
    origins = dd.origins()
    gsize = dd.size()
    valid_last = dd.valid_last()
    route = dd.exchange_route()
    split, fused = plan["overlap"] == "split", plan["halo"] == "fused"

    def passes(bs, outs, fused_bufs=None):
        _grouped(groups, bs, fused_bufs, lambda j, b, fs, o: stream_plane_pass(
            programs[j], programs[j].names, b, lo, hi, x_radius, origins, gsize, out=o, fused_shell=fs), outs)

    def narrow_plane(subs, ax, w, origin_sub):
        """One level over ``3w``-wide face sub-blocks (``w == x_radius``):
        the sliced axis carries a ``w``-deep pseudo shell, the others keep
        the true shell widths (``narrow_plane``, JAX ``:1634-1656``)."""
        lo2 = Dim3(*[w if b == ax else lo[b] for b in range(3)])
        hi2 = Dim3(*[w if b == ax else hi[b] for b in range(3)])
        out = list(subs)
        for j, g in enumerate(groups):
            for q, o in zip(g, stream_plane_pass(programs[j], programs[j].names, [subs[q] for q in g], lo2, hi2,
                                                 x_radius, origin_sub, gsize)):
                out[q] = o
        return out

    side = side_stream(dd.device) if split else None
    fix = _exterior_fix(dd, narrow_plane, [(x_radius, False)]) if split else None

    # the stacks and a spare set, ping-ponged: one level a body
    def body(cur, nxt, depth):
        stacks = cur.fields
        blocks, outs = _blocks(stacks), _blocks(nxt.fields)
        if fused:
            # the received shell rides into the pass: no halo write
            passes(blocks, outs, fused_shell_exchange(stacks, shell, route))
        elif split:
            overlapped(side, lambda: passes(blocks, outs),
                       lambda: halo_exchange_multi(stacks, shell, valid_last, route=route))
            fix(outs, blocks, x_radius, False)
        else:
            halo_exchange_multi(stacks, shell, valid_last, route=route)
            passes(blocks, outs)

    return as_step(Loop(names, 1, body))


def _wavefront_route(dd, names, groups, programs, plan, x_radius):
    m = plan["m"]
    z_slab_mode = plan["z_slabs"]
    split, fused = plan["overlap"] == "split", plan["halo"] == "fused"
    shell = dd.shell_radius()
    s = shell.lo().x
    Xr, Yr, Zr = dd.local_spec().raw_size().tuple()
    origins = dd.origins()
    gsize = dd.size()
    valid_last = dd.valid_last()
    yext, xext = make_slab_extenders(Xr, Yr, s)
    # the z-slab form's in-array x/y exchange takes no route, as in the JAX
    # package (stencil_tpu/ops/stream.py:1821); the plain form takes the
    # domain's
    axes, route = ((0, 1), "direct") if z_slab_mode else ((0, 1, 2), dd.exchange_route())

    def passes(bs, depth, outs, fused_bufs=None):
        _grouped(groups, bs, fused_bufs, lambda j, b, fs, o: stream_wavefront_pass(
            programs[j], programs[j].names, b, depth, s, origins, gsize, fused_shell=fs, out=o), outs)

    def narrow_wavefront(subs, ax, w, origin_sub):
        """``w`` levels over ``3w``-wide face sub-blocks (``w`` is this
        macro's depth) with a pseudo shell of ``w`` on every axis
        (``narrow_wavefront``, JAX ``:1732-1757``)."""
        out = list(subs)
        for j, g in enumerate(groups):
            res = stream_wavefront_pass(programs[j], programs[j].names, [subs[q] for q in g], w, w,
                                        origin_sub, gsize)[0]
            for q, o in zip(g, res):
                out[q] = o
        return out

    side = side_stream(dd.device) if split else None
    # every macro's depth: the plan's and each remainder's
    fix = _exterior_fix(dd, narrow_wavefront, [(d, True) for d in range(1, m + 1)]) if split else None

    def plain_macro(stacks, depth, outs):
        blocks = _blocks(stacks)
        if fused:
            passes(blocks, depth, outs, fused_shell_exchange(stacks, shell, route))
        elif split:
            overlapped(side, lambda: passes(blocks, depth, outs),
                       lambda: halo_exchange_multi(stacks, shell, valid_last, route=route))
            fix(outs, blocks, depth, True)
        else:
            halo_exchange_multi(stacks, shell, valid_last, route=route)
            passes(blocks, depth, outs)

    # the stacks and a spare set, ping-ponged: one macro a body; the z-slab
    # form carries each field's z slabs in the sets too, primed per call
    def body(cur, nxt, depth):
        stacks = cur.fields
        if not z_slab_mode:
            plain_macro(stacks, depth, _blocks(nxt.fields))
            return
        halo_exchange_multi(stacks, shell, valid_last, axes=axes, route=route)
        zs = _blocks([permute_and_extend_z_slabs(z, s, yext, xext) for z in cur.extra])
        bs, outs, zouts = _blocks(stacks), _blocks(nxt.fields), _blocks(nxt.extra)
        for g, sk in zip(groups, programs):
            stream_wavefront_pass(sk, sk.names, [bs[q] for q in g], depth, s, origins, gsize,
                                  z_slabs=[zs[q] for q in g], z_valid=Zr, out=[outs[q] for q in g],
                                  z_out=[zouts[q] for q in g])

    def zslabs(stacks):
        return [t.new_empty((*t.shape[:3], Xr, 2 * s, Yr)) for t in stacks]

    def prime(stacks, cur):
        for t, z in zip(stacks, cur.extra):
            prime_z_slabs(t, Zr, s, out=z)

    if z_slab_mode:
        return as_step(Loop(names, m, body, extra=zslabs, enter=prime))
    return as_step(Loop(names, m, body))
