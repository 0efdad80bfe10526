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
  (``csrc/stream_wavefront.cu``).

The kernel is traced once (``ops/stream_trace.py``) into an expression graph;
its CUDA body is emitted into each kernel template and built by nvcc, and its
torch evaluation is each kernel's plain version.  On a CUDA tensor each
wrapper launches its kernel (one launch for all subdomains and all fields of
a group); on a CPU tensor it runs the plain version.

``plan_stream`` and ``make_stream_step`` pick and build the routes as the
JAX package does, with a Hopper shared-memory model (``stream_smem_fits``)
in place of the VMEM model: a constant of tile, depth and field count, so
the CPU and the card plan the same depth.  Not ported here: the split
overlap schedule and the fused halo (ROADMAP.md queue 1 item 8), the MXU
units, bf16 inputs and bf16 storage (item 9), the tune cache, telemetry
events and the resilience ladder (items 10/11).

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.kernels import build, check_tensor, same_device, stream_handle
from stencil_tpu_torch.ops.exchange import halo_exchange_multi, shift_from_high, shift_from_low
from stencil_tpu_torch.ops.jacobi_kernels import _WRAP_MAX_K, SMEM_PER_BLOCK, _emit
from stencil_tpu_torch.ops.stream_trace import PlaneInfo, PlaneView, StreamKernel

__all__ = [
    "PlaneInfo", "PlaneView", "StreamKernel", "make_stream_step", "plan_stream",
    "stream_plane_pass", "stream_plane_pass_plain", "stream_smem_bytes", "stream_smem_fits",
    "stream_wavefront_pass", "stream_wavefront_pass_plain", "stream_wrap_pass",
    "stream_wrap_pass_plain",
]

#: the stream wavefront kernel's tile per block: 32 output rows of y, and 64
#: columns of z with the m-cell apron on each side (``csrc/stream_wavefront.cu``)
STREAM_TILE_Y = 32
STREAM_TILE_W = 64

#: what the JAX package plans for its axes, and what the port accepts of them
_PORTED_AXES = {
    "overlap": ("off", ("split",), "queue 1 item 8"),
    "halo": ("array", ("fused",), "queue 1 item 8"),
    "compute_unit": ("vpu", ("mxu", "mxu_band"), "queue 1 item 9"),
    "mxu_input": ("f32", ("bf16",), "queue 1 item 9"),
}

Kernel = Union[Callable, StreamKernel]


def lane_pad_width(z: int) -> int:
    """Plane width rounded up to a 128 multiple.  The TPU route pads its
    z-slab planes so; the port's routes do not (a Hopper row coalesces at
    any width), and keep this for the kernels' ``z_valid`` tests."""
    return -(-z // 128) * 128


def prime_z_slabs(block: torch.Tensor, Zr: int, s: int) -> torch.Tensor:
    """The first outgoing z-slab buffer of a macro chain: the blocks'
    interior z-boundary columns, packed ``[(-z)-bound | (+z)-bound]`` and
    transposed z-major, ``(..., Xr, Yr, Zr) -> (..., Xr, 2s, Yr)``.  Every
    later slab buffer is kernel-emitted."""
    return torch.cat(
        [block[..., Zr - 2 * s : Zr - s].transpose(-1, -2), block[..., s : 2 * s].transpose(-1, -2)],
        dim=-2,
    ).contiguous()


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
    """Shared memory of one block of the m-level stream wavefront kernel:
    per field, 2m + 2 planes (two per level below m, the incoming one and a
    spare for each level's result) of (32 + 2m) x 64 4-byte cells.  A
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


def stream_wrap_pass(kernel: Kernel, names, blocks, k: int, origin, global_size) -> List[torch.Tensor]:
    """``k`` levels of ``kernel`` over the WHOLE periodic domain (the single-
    subdomain route), one ``(X, Y, Z)`` float32 tensor per field; ``origin``
    the (3,) int32 global start.  Returns new tensors; ``blocks`` are left as
    they were.  On CUDA: ``k`` launches of the one-level kernel over all
    fields, ping-ponging between two sets of fresh buffers."""
    shape, dev = _check_wrap(names, blocks, k, origin)
    if dev.type == "cpu":
        return stream_wrap_pass_plain(kernel, names, blocks, k, origin, global_size)
    sk = _as_kernel(kernel, names, 1, global_size)
    lib = _library(sk, "stream_wrap", _WRAP_LEVELS if k <= _WRAP_MAX_K else range(1, k + 1))
    X, Y, Z = shape
    gx, gy, gz = sk.global_size
    bufs = [[torch.empty_like(b) for b in blocks], [torch.empty_like(b) for b in blocks] if k > 1 else None]
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


def _check_plane(names, raws, lo, hi, x_radius, origin, out):
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
    return n, X, Y, Z, dev


def stream_plane_pass_plain(kernel: Kernel, names, raws, lo: Dim3, hi: Dim3, x_radius: int, origin,
                            global_size, out=None) -> List[torch.Tensor]:
    """One level of ``kernel`` over shell-carrying block(s) ``(X, Y, Z)`` or
    ``(n, X, Y, Z)`` per field, with slices; shell cells pass through.
    ``origin`` holds each block's interior start."""
    n, X, Y, Z, dev = _check_plane(names, raws, lo, hi, x_radius, origin, out)
    sk = _as_kernel(kernel, names, x_radius, global_size)
    single = raws[0].dim() == 3
    bs = [r[None] if single else r for r in raws]
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
                      global_size, out=None) -> List[torch.Tensor]:
    """ONE level of ``kernel`` over shell-carrying block(s) per field (lo/hi
    the shell widths, every shift within ``x_radius`` <= them); shell cells
    pass through.  Returns ``out`` (fresh tensors when None).  One CUDA
    launch serves all ``n`` blocks and all fields."""
    n, X, Y, Z, dev = _check_plane(names, raws, lo, hi, x_radius, origin, out)
    if dev.type == "cpu":
        return stream_plane_pass_plain(kernel, names, raws, lo, hi, x_radius, origin, global_size, out)
    sk = _as_kernel(kernel, names, x_radius, global_size)
    lib = _library(sk, "stream_plane", [1])
    res = [torch.empty_like(r) for r in raws] if out is None else list(out)
    gx, gy, gz = sk.global_size
    rc = lib.stp_stream_plane_level(_ptrs(raws), _ptrs(res), origin.data_ptr(), n, X, Y, Z,
                                    lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, gx, gy, gz, stream_handle(dev))
    build.check(lib, rc, "stream_plane_pass")
    stream_plane_pass.launches += 1
    return res


#: kernel launches made by ``stream_plane_pass``
stream_plane_pass.launches = 0


# --- stream_wavefront_pass -----------------------------------------------------------


def _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs, z_valid, alias):
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
    return n, Xr, Yr, Zr, zv, dev


def stream_wavefront_pass_plain(kernel: Kernel, names, raws, m: int, s_off: int, origin, global_size,
                                z_slabs=None, z_valid=None, alias=False):
    """``m`` levels of ``kernel`` over s-shelled block(s) ``(Xr, Yr, Zr)`` or
    ``(n, Xr, Yr, Zr)`` per field, with rolls: every axis wraps, and the
    wrapped cells are the ones the shell was sized to sacrifice.  ``z_slabs``
    ``(.., Xr, 2s, Yr)`` per field replace the z-shell columns ``[0, s)`` and
    ``[z_valid - s, z_valid)`` (columns ``[z_valid, Zr)`` are dead).  Returns
    ``(outs, zouts)`` (``zouts`` None without slabs); the interior
    ``[s, ext - s)`` of every axis is exact, shell cells are unspecified."""
    n, Xr, Yr, Zr, zv, dev = _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs,
                                              z_valid, alias)
    sk = _as_kernel(kernel, names, 1, global_size)
    single = raws[0].dim() == 3
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
                          z_slabs=None, z_valid=None, alias=False):
    """``m`` levels of ``kernel`` (read radius 1) in ONE pass over s-shelled
    block(s) per field: the compute half of the temporally blocked route.
    Arguments and result as ``stream_wavefront_pass_plain``; ``alias=True``
    is refused.  One CUDA launch serves all ``n`` blocks and all fields; the
    outputs are fresh buffers, written on the valid region only."""
    n, Xr, Yr, Zr, zv, dev = _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs,
                                              z_valid, alias)
    if dev.type == "cpu":
        return stream_wavefront_pass_plain(kernel, names, raws, m, s_off, origin, global_size,
                                           z_slabs, z_valid, alias)
    sk = _as_kernel(kernel, names, 1, global_size)
    lib = _library(sk, *_wavefront_variant(m))
    outs = [torch.empty_like(r) for r in raws]
    zouts = None if z_slabs is None else [torch.empty_like(z) for z in z_slabs]
    gx, gy, gz = sk.global_size
    slabs = z_slabs is not None
    rc = lib.stp_stream_wavefront(
        _ptrs(raws), _ptrs(outs), _ptrs(z_slabs) if slabs else None, _ptrs(zouts) if slabs else None,
        origin.data_ptr(), n, Xr, Yr, Zr, zv, m, s_off, gx, gy, gz, int(slabs), stream_handle(raws[0].device),
    )
    build.check(lib, rc, "stream_wavefront_pass")
    stream_wavefront_pass.launches += 1
    return outs, zouts


def _wavefront_variant(m: int):
    """(template, levels, defines) of the wavefront library for depth m: one
    library per depth, so a remainder pass never compiles inside a loop."""
    return "stream_wavefront", range(1, m + 1), f"#define STP_M {m}\n"


#: the levels a wrap library serves (a kernel that reads ``info.level`` gets
#: one branch per level; the others one body): the deepest wrap plan, or an
#: explicit deeper k
_WRAP_LEVELS = range(1, _WRAP_MAX_K + 1)


#: kernel launches made by ``stream_wavefront_pass``
stream_wavefront_pass.launches = 0


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
    temporal depth (wrap k / wavefront m).  ``overlap``, ``halo``,
    ``compute_unit`` and ``mxu_input`` take ``"auto"`` or the static value
    the port runs (off, array, vpu, f32); ``mxu_kernel`` is accepted and
    unused.  ``z_slabs=False`` runs a wavefront plan in its plain form
    (every axis exchanged in the array; the JAX package reaches that form
    through its split and fused paths, not ported yet, and on uneven sizes,
    where the plan takes it and ``z_slabs=True`` raises).

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
    (``step._marks_shell_stale``); ``step._stream_plan`` is the plan."""
    _check_axes(overlap=overlap, halo=halo, compute_unit=compute_unit, mxu_input=mxu_input)
    del mxu_kernel
    max_depth = _check_depth(max_depth)
    plan = dict(plan_stream(dd, x_radius, path, separable, max_m=max_depth))
    if z_slabs is not None and plan["route"] == "wavefront":
        if z_slabs and dd.padded():
            raise ValueError("z_slabs=True: the z-slab wavefront form needs even (unpadded) subdomains")
        plan["z_slabs"] = bool(z_slabs)
    plan.update(overlap="off", halo="array", compute_unit="vpu", mxu_input="f32")
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
    route = plan["route"]
    if route == "wrap":
        variants = [("stream_wrap", _WRAP_LEVELS, "")]
    elif route == "plane":
        variants = [("stream_plane", [1], "")]
    else:  # the plan's depth and every remainder depth
        variants = [_wavefront_variant(d) for d in range(1, plan["m"] + 1)]
    want = [(v[0], _source(p, *v)) for p in programs for v in variants]
    build.build_generated(dict.fromkeys(want))


def _wrap_route(dd, names, groups, programs, plan, x_radius):
    k = plan["m"]
    n = dd.local_spec().sz
    lo = dd.shell_radius().lo()
    origin = dd.origins()[0].contiguous()
    gsize = dd.size()
    inner = (0, 0, 0, slice(lo.x, lo.x + n.x), slice(lo.y, lo.y + n.y), slice(lo.z, lo.z + n.z))

    def step(curr: Dict[str, torch.Tensor], steps: int = 1) -> Dict[str, torch.Tensor]:
        bs = [curr[name][inner].contiguous() for name in names]
        blocked, rem = divmod(steps, k)
        for depth in [k] * blocked + ([rem] if rem else []):
            for g, sk in zip(groups, programs):
                outs = stream_wrap_pass(sk, sk.names, [bs[q] for q in g], depth, origin, gsize)
                for q, o in zip(g, outs):
                    bs[q] = o
        for name, b in zip(names, bs):
            curr[name][inner].copy_(b)
        return curr

    return step


def _plane_route(dd, names, groups, programs, plan, x_radius):
    shell = dd.shell_radius()
    lo, hi = shell.lo(), shell.hi()
    origins = dd.origins()
    count = dd.num_subdomains()
    gsize = dd.size()
    valid_last = dd.valid_last()
    route = dd.exchange_route()

    def step(curr: Dict[str, torch.Tensor], steps: int = 1) -> Dict[str, torch.Tensor]:
        stacks = [curr[name] for name in names]
        shape = stacks[0].shape
        for _ in range(steps):
            halo_exchange_multi(stacks, shell, valid_last, route=route)
            blocks = [s.view(count, *shape[3:]) for s in stacks]
            new = list(stacks)
            for g, sk in zip(groups, programs):
                outs = stream_plane_pass(sk, sk.names, [blocks[q] for q in g], lo, hi, x_radius, origins, gsize)
                for q, o in zip(g, outs):
                    new[q] = o.view(shape)
            stacks = new
        for name, s in zip(names, stacks):
            curr[name] = s
        return curr

    return step


def _wavefront_route(dd, names, groups, programs, plan, x_radius):
    m = plan["m"]
    z_slab_mode = plan["z_slabs"]
    shell = dd.shell_radius()
    s = shell.lo().x
    Xr, Yr, Zr = dd.local_spec().raw_size().tuple()
    origins = dd.origins()
    count = dd.num_subdomains()
    gsize = dd.size()
    valid_last = dd.valid_last()
    yext, xext = make_slab_extenders(Xr, Yr, s)
    # the z-slab form's in-array x/y exchange takes no route, as in the JAX
    # package (stencil_tpu/ops/stream.py:1821); the plain form takes the
    # domain's
    axes, route = ((0, 1), "direct") if z_slab_mode else ((0, 1, 2), dd.exchange_route())

    def batch(t):  # (px, py, pz, ...) -> (n, ...): one launch serves all
        return t.view(count, *t.shape[3:])

    def run_pass(sk, bs, depth, zs):
        return stream_wavefront_pass(sk, sk.names, bs, depth, s, origins, gsize, z_slabs=zs,
                                     z_valid=Zr if zs is not None else None)

    def step(curr: Dict[str, torch.Tensor], steps: int = 1) -> Dict[str, torch.Tensor]:
        stacks = [curr[name] for name in names]
        shape = stacks[0].shape
        macros, rem = divmod(steps, m)
        zouts = [prime_z_slabs(b, Zr, s) for b in stacks] if z_slab_mode else None
        for depth in [m] * macros + ([rem] if rem else []):
            halo_exchange_multi(stacks, shell, valid_last, axes=axes, route=route)
            zs = [permute_and_extend_z_slabs(z, s, yext, xext) for z in zouts] if z_slab_mode else None
            new, new_z = list(stacks), list(zouts) if z_slab_mode else None
            for g, sk in zip(groups, programs):
                outs, zo = run_pass(sk, [batch(stacks[q]) for q in g], depth,
                                    [batch(zs[q]) for q in g] if z_slab_mode else None)
                for j, q in enumerate(g):
                    new[q] = outs[j].view(shape)
                    if z_slab_mode:
                        new_z[q] = zo[j].view(zouts[q].shape)
            stacks, zouts = new, new_z
        for name, b in zip(names, stacks):
            curr[name] = b
        return curr

    return step
