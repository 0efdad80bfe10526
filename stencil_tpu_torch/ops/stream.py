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
the CPU and the card plan the same depth.

**Field dtypes** (``stencil_tpu/ops/stream.py``'s ``f32_accumulate`` and its
float64 fields): each pass takes float32, float64 or bf16-storage fields
(float32 and float64 may share a joint group).  A float64 field computes at
float64; a bfloat16 field is read at float32, keeps its levels at float32 and
is rounded once to bfloat16 at the pass's store, as each JAX ``pallas_call``
rounds once; the wrap pass's k launches keep the levels between them in
float32 buffers for that.  Each dtype combination is a build of its own (the
emitted body names its types), and its launches count apart
(``bf16_launches``, ``f64_launches`` and their fused twins).

**The contraction form** (``compute_unit`` ``mxu`` / ``mxu_band``,
``mxu_input`` ``f32`` / ``bf16``; ``stencil_tpu/ops/stream.py:145-277``):
a kernel's axis-separable form (``make_stream_step(mxu_kernel=...)``)
writes its four in-plane taps as ``PlaneView.plane_nbr_sum()``, which the
trace keeps as one node (``ops/stream_trace.py``).  Each pass takes
``compute_unit`` and ``mxu_input``: its plain version computes that node
as ``jacobi_kernels.plane_nbr_sum_host`` does, the band contracted over the
whole plane of the pass, periodic (the wrap plane, the raw block plane,
the wavefront plane), the operand rounded to bfloat16 under
``mxu_input="bf16"`` (``jacobi_kernels.plane_nbr_sum_host``); its CUDA kernel contracts the plane's tile on the
tensor cores (``csrc/band_mma.cuh``; ``mma.sync`` on three exact TF32
pieces, or on bf16 operands) within 4 ulps a level of that.  ``mxu_band``
on a plane that admits no band tile degrades to ``mxu`` per pass, with a
warning (``plane_band_unit``); on the card both run one contraction.  The
launches count under ``mxu_launches`` / ``mxu_bf16in_launches``, either
storage, and the fused forms' under ``fused_mxu_launches`` /
``fused_mxu_bf16in_launches``.  The fused halo contracts the patched
level-0 plane (the plane and wavefront passes with ``fused_shell``), and
the split schedule's band passes contract their sub-blocks' planes, each
pass resolving the unit on its own plane (``make_stream_step``).

**The degradation ladder** (``stencil_tpu/ops/stream.py:2055-2200``):
``make_stream_step`` returns a step over a ``DegradationLadder`` labelled
``stream`` whose rungs are the JAX package's, named as it names them
(``wavefront[m=3]``, ``plane[m=1,split]``, ``wrap[m=8,mxu]``).  On VMEM_OOM
or COMPILE_REJECT before a route's step is entered it steps down at the
same depth first, ``mxu_band`` to ``mxu`` to ``vpu``, then the fused halo to
the array, then the split schedule to off, then the wavefront or wrap depth
m to m - 1 (re-planned over the same shell), the plane route the bottom
rung.  Every rung is a CUDA route on a CUDA domain, built with its kernels
at once; the prefilter is the plan's shared-memory model
(``stream_smem_fits``).  ``step._stream_plan`` is the current rung's plan,
``step._resilience`` the ladder.

**The axes' sources** (``stencil_tpu/ops/stream.py:824-870, 1162-1311,
1896-1935``): ``plan_stream``'s unconstrained auto path consults the tuned
config (``tune/``, the ``stream`` key; ``_tuned_stream_plan`` re-checks it
and falls back to the static plan with a warning), and each axis of
``make_stream_step`` resolves explicit > env (``STENCIL_STREAM_OVERLAP``,
``STENCIL_STREAM_HALO``, ``STENCIL_COMPUTE_UNIT``, ``STENCIL_MXU_INPUT``) >
the tuned plan's field > static, emitting ``step.overlap``, ``step.halo``
and the ``kernel.*`` events.  The ladder sits above the chain: its rungs
take resolved plans.  The port never aliases a pass (a fresh output every
pass), so a tuned ``alias`` is not read.

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

Accounting (``stencil_tpu/ops/stream.py:2180-2229``): each call of a built
step counts ``step.overlap.exterior_cells`` under split (the band cells the
exterior passes recompute) and ``kernel.mxu.flops`` under a contracting
unit (the JAX package's FLOP model of the contraction on the plane each
pass contracts), both from the plan the call ends on.  While telemetry is on
or a device-profile capture is open, the split schedule's interior pass runs
inside the ``step.overlap.interior`` profiler scope and its exterior (the
exchange on the side stream, then the band passes) inside
``step.overlap.exterior``.
"""

from __future__ import annotations

import ctypes
import operator
import warnings
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from stencil_tpu_torch import telemetry
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.kernels import build, check_out, check_tensor, same_device, stream_handle
from stencil_tpu_torch.ops.captured import Loop, as_step, window_loop
from stencil_tpu_torch.ops.exchange import (
    Y_PACK_ROUTES, fused_shell_exchange, halo_exchange_multi, overlapped, shift_from_high, shift_from_low,
    side_stream,
)
from stencil_tpu_torch.ops.halo_blend import blend_slab, blend_slab_dynamic, supports
from stencil_tpu_torch.ops.jacobi_kernels import (
    _WRAP_MAX_K, COMPUTE_UNITS, MXU_INPUTS, SMEM_PER_BLOCK, _emit, band_tile_plan, mxu_flops_per_plane,
    plane_band_unit, plane_nbr_sum_host, resolve_compute_unit, resolve_mxu_input, unit_uses_mxu,
)
from stencil_tpu_torch.ops.stream_trace import STORAGE, PlaneInfo, PlaneView, StreamKernel, compute_kind
from stencil_tpu_torch.telemetry import names as tm

__all__ = [
    "PlaneInfo", "PlaneView", "StreamKernel", "make_stream_step", "plan_stream",
    "stream_pass_smem_bytes",
    "stream_plane_pass", "stream_plane_pass_plain", "stream_smem_bytes", "stream_smem_fits",
    "stream_wavefront_launch", "stream_wavefront_pass", "stream_wavefront_pass_plain", "stream_wrap_pass",
    "stream_wrap_pass_plain",
]

#: the stream wavefront kernel's tile per block in its general form (the
#: plan's model): 32 output rows of y, and 64 columns of z with the m-cell
#: apron on each side (``csrc/stream_wavefront.cu``)
STREAM_TILE_Y = 32
STREAM_TILE_W = 64

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


def stream_smem_bytes(m: int, n_fields: int, itemsize: int = 4, compute_unit: str = "vpu") -> int:
    """The plan's model of one block of the m-level stream wavefront kernel:
    per field, 2m + 2 planes (two per level below m, the incoming one and a
    spare for each level's result) of (32 + 2m) x 64 cells of ``itemsize``
    bytes, the compute type the levels are kept at (``ring_itemsize``: 4
    for float32 and bf16 storage, whose rings are float32, 8 when a field is
    float64), what the kernel's general form asks; its register-queue form
    asks less (``csrc/stream_wavefront.cu``), and each launch computes its
    own.  Under a contracting ``compute_unit`` the general form keeps one
    plane of sums more a field (the queue form's m planes of sums still ask
    less).  A constant of depth, field count, dtypes and unit, so the CPU
    and the card plan the same depth."""
    planes = 2 * m + 2 + (1 if unit_uses_mxu(compute_unit) else 0)
    return n_fields * planes * (STREAM_TILE_Y + 2 * m) * STREAM_TILE_W * itemsize


def stream_smem_fits(m: int, n_fields: int, itemsize: int = 4, compute_unit: str = "vpu") -> bool:
    return stream_smem_bytes(m, n_fields, itemsize, compute_unit) <= SMEM_PER_BLOCK


#: the staged tile of the wrap and plane kernels' contraction form, its
#: one-cell apron included (``kSR`` x ``kSC`` in ``csrc/stream_wrap.cu`` and
#: ``csrc/stream_plane.cu``)
STREAM_PASS_TILE = (32, 64)


def stream_pass_smem_bytes(n_fields: int, compute_unit: str = "vpu") -> int:
    """The dynamic shared memory one block of the wrap or plane kernel asks
    (what its launcher passes ``cudaFuncSetAttribute``): none in the vpu
    form, which reads its neighbours from global memory one level a launch
    whatever the depth; under a contracting ``compute_unit`` a staging tile
    and one tile of sums a field, at float32 (``kMxuSmem``)."""
    if not unit_uses_mxu(compute_unit):
        return 0
    return (1 + n_fields) * STREAM_PASS_TILE[0] * STREAM_PASS_TILE[1] * 4


def ring_itemsize(dtypes: Sequence[torch.dtype]) -> int:
    """The bytes of a cell of the wavefront kernel's planes for fields of
    these storage dtypes: 8 when one is float64 (a group that mixes float32
    with float64 keeps every plane at double), else 4 (the JAX package's
    ``ring_itemsizes`` rule, ``stencil_tpu/ops/stream.py:802-816``: bf16
    storage keeps float32 rings)."""
    return 8 if torch.float64 in set(dtypes) else 4


def _form(ts: Sequence[torch.Tensor], sk: StreamKernel = None) -> str:
    """The form a launch over these fields counts under: ``"mxu"`` /
    ``"mxu_bf16in"`` (a kernel ``sk`` that contracts, on f32 / bf16
    operands, either storage), ``"bf16"`` (bf16 storage, float levels),
    ``"f64"`` (a float64 field among them) or ``""`` (float32)."""
    if sk is not None and sk.uses_nbr():
        return "mxu" if sk.mxu_input == "f32" else "mxu_bf16in"
    kinds = {STORAGE[t.dtype] for t in ts}
    return "bf16" if "bf16" in kinds else "f64" if "f64" in kinds else ""


def _count(wrapper, form: str, fused: bool = False) -> None:
    """One launch of ``wrapper`` in ``form`` (``_form``), in its fused form
    when ``fused``: ``[fused_][form_]launches``."""
    counter = ("fused_" if fused else "") + (f"{form}_" if form else "") + "launches"
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def _as_kernel(kernel: Kernel, names: Sequence[str], x_radius: int, global_size,
               fields: Sequence[torch.Tensor], compute_unit: str = "vpu", mxu_input: str = "f32") -> StreamKernel:
    """A traced kernel for ``names`` over ``fields`` (their storage dtypes)
    under one unit: ``kernel`` itself when it is one (the engine traces once
    per step build), else a new trace of the callable."""
    dtypes = [t.dtype for t in fields]
    if isinstance(kernel, StreamKernel):
        if kernel.names != list(names):
            raise ValueError(f"traced kernel fields {kernel.names} != {list(names)}")
        if kernel.dtypes != dtypes:
            raise TypeError(f"traced kernel dtypes {kernel.dtypes} != the fields' {dtypes}")
        if unit_uses_mxu(kernel.compute_unit) != unit_uses_mxu(compute_unit) or (
                unit_uses_mxu(compute_unit) and kernel.mxu_input != mxu_input):
            raise ValueError(f"traced kernel unit {kernel.compute_unit}/{kernel.mxu_input} != the pass's "
                             f"{compute_unit}/{mxu_input}")
        return kernel
    return StreamKernel(kernel, names, x_radius, global_size, dtypes=dtypes, compute_unit=compute_unit,
                        mxu_input=mxu_input)


def _pass_unit(compute_unit: str, mxu_input: str, fields: Sequence[torch.Tensor], plane_y: int, plane_z: int,
               where: str) -> Tuple[str, str]:
    """One pass's ``(unit, mxu_input)`` (``_pass_band_setup``,
    ``stencil_tpu/ops/stream.py:262-277``): validated, ``mxu_band`` on a
    plane without a band tile degraded to ``mxu`` with a warning, the
    operands ``f32`` under ``vpu``.  A contraction needs every field to
    compute at float32 (bf16 storage does)."""
    if compute_unit not in ("vpu", "mxu", "mxu_band"):
        raise ValueError(f"unknown compute unit {compute_unit!r} (one of ('vpu', 'mxu', 'mxu_band'))")
    if mxu_input not in ("f32", "bf16"):
        raise ValueError(f"unknown mxu input {mxu_input!r} (one of ('f32', 'bf16'))")
    if not unit_uses_mxu(compute_unit):
        return compute_unit, "f32"
    if any(compute_kind(t.dtype) != "f32" for t in fields):
        raise TypeError(f"{where}: compute_unit={compute_unit!r} needs fields that compute at float32, got "
                        f"{[t.dtype for t in fields]} (the engine degrades such a request to vpu)")
    return plane_band_unit(compute_unit, plane_y, plane_z, where=where), mxu_input


def _check_fields(ts: Sequence[torch.Tensor], what: str, ndims, like=None) -> Tuple[torch.Size, torch.device]:
    """One shape for all, each of the storage dtypes the kernels take
    (float32, bfloat16, float64; bfloat16 with no other); ``like``: the
    fields these buffers belong to, one each, whose dtypes they must have."""
    if not ts:
        raise ValueError(f"{what}: no fields")
    for j, t in enumerate(ts):
        check_tensor(t, what, ndims=ndims)
        if like is not None and t.dtype != like[j].dtype:
            raise TypeError(f"{what} must be {like[j].dtype} (its field's dtype), got {t.dtype}")
        if t.dtype not in STORAGE:
            raise TypeError(f"{what} must be torch.float32, torch.bfloat16 or torch.float64, got {t.dtype}")
    kinds = {STORAGE[t.dtype] for t in ts}
    if "bf16" in kinds and len(kinds) > 1:
        raise TypeError(f"{what}: bfloat16 fields stream only with bfloat16 fields, got {[t.dtype for t in ts]}")
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


def _full(vals: Sequence[torch.Tensor], shape, dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """Each value broadcast to ``shape`` as a tensor of its own (a constant
    or a pass-through output may be a view), at its field's compute dtype
    (a pass-through of a bf16 level-0 block upcast, as the JAX ring keeps
    it)."""
    return [(v.expand(shape).contiguous() if v.shape != shape else v).to(d) for v, d in zip(vals, dtypes)]


def _compute_dtypes(ts: Sequence[torch.Tensor]) -> List[torch.dtype]:
    """Each field's compute dtype (``stream_trace.compute_kind``): float64
    for float64, float32 for float32 and bfloat16 storage."""
    return [torch.float64 if compute_kind(t.dtype) == "f64" else torch.float32 for t in ts]


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
    + hi.z, Y, X)`` of the field's dtype on the blocks' device (``fused_shell_exchange``'s
    layouts).  The passes' own checks hold every shell width >= 1."""
    if not (isinstance(fused_shell, (tuple, list)) and len(fused_shell) == 3):
        raise ValueError("fused_shell must be (xbufs, ybufs, zbufs)")
    *lead, X, Y, Z = raws[0].shape
    wants = ((lo.x + hi.x, Y, Z), (lo.y + hi.y, X, Z), (lo.z + hi.z, Y, X))
    for what, bufs, want in zip(("xbufs", "ybufs", "zbufs"), fused_shell, wants):
        if len(bufs) != len(raws):
            raise ValueError(f"fused_shell {what}: {len(bufs)} buffers for {len(raws)} fields")
        shape, _ = _check_fields(bufs, f"fused_shell {what}", (len(lead) + 3,), like=raws)
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


def stream_wrap_pass_plain(kernel: Kernel, names, blocks, k: int, origin, global_size,
                           compute_unit: str = "vpu", mxu_input: str = "f32") -> List[torch.Tensor]:
    """``k`` levels of ``kernel`` over the whole periodic domain, one
    ``(X, Y, Z)`` tensor per field, with rolls; returns new tensors.  Each
    field's levels run at its compute dtype and the result is rounded once
    to its storage dtype (bfloat16 blocks: the JAX package's
    ``f32_accumulate``; float64 blocks compute at float64).  Under a
    contracting ``compute_unit`` a level's ``plane_nbr_sum`` is
    ``plane_nbr_sum_host`` of the field's whole (Y, Z) planes."""
    shape, dev = _check_wrap(names, blocks, k, origin)
    unit, mi = _pass_unit(compute_unit, mxu_input, blocks, shape[1], shape[2], "stream-wrap")
    sk = _as_kernel(kernel, names, 1, global_size, blocks, unit, mi)
    cdt = _compute_dtypes(blocks)
    X, Y, Z = shape
    gx, gy, gz = sk.global_size
    org = origin.cpu()
    xyz = (_wrapped(org[0], 0, X, gx, (X, 1, 1)).to(dev), _wrapped(org[1], 0, Y, gy, (1, Y, 1)).to(dev),
           _wrapped(org[2], 0, Z, gz, (1, 1, Z)).to(dev))
    cur = list(blocks)
    for level in range(1, k + 1):
        src = cur
        cur = _full(sk.evaluate(lambda q, dx, dy, dz: _roll(src[q], dx, dy, dz), lambda: xyz, dev, level,
                                lambda q: plane_nbr_sum_host(src[q].to(cdt[q]), unit, mxu_input=mi)), shape, cdt)
    return [c.to(b.dtype) for c, b in zip(cur, blocks)]


def _check_outs(out, ins) -> List[torch.Tensor]:
    """``out``: one buffer per input, each of its input's shape, none of them
    an input."""
    if len(out) != len(ins):
        raise ValueError(f"out holds {len(out)} tensors for {len(ins)} fields")
    for o, t in zip(out, ins):
        check_out(o, t)
    if {o.data_ptr() for o in out} & {t.data_ptr() for t in ins}:
        raise ValueError("out must not alias the inputs")
    return list(out)


def stream_wrap_pass(kernel: Kernel, names, blocks, k: int, origin, global_size, out=None,
                     compute_unit: str = "vpu", mxu_input: str = "f32") -> List[torch.Tensor]:
    """``k`` levels of ``kernel`` over the WHOLE periodic domain (the single-
    subdomain route), one ``(X, Y, Z)`` tensor per field (float32, bfloat16
    storage with float32 levels, float64; ``stream_wrap_pass_plain``);
    ``origin`` the (3,) int32 global start.  Returns ``out`` (new tensors
    when None); ``blocks`` are left as they were.  On CUDA: ``k`` launches
    of the one-level kernel over all fields, ping-ponging between the
    outputs and a second set of fresh buffers; under bf16 storage the
    levels between the first launch and the last go through two float32
    sets instead, so that the call rounds once, as the JAX pass does.
    ``compute_unit`` / ``mxu_input``: the contraction form
    (``stream_wrap_pass_plain``; the module docstring)."""
    shape, dev = _check_wrap(names, blocks, k, origin)
    if out is not None:
        out = _check_outs(out, blocks)
    if dev.type == "cpu":
        res = stream_wrap_pass_plain(kernel, names, blocks, k, origin, global_size, compute_unit, mxu_input)
        return res if out is None else [o.copy_(r) for o, r in zip(out, res)]
    unit, mi = _pass_unit(compute_unit, mxu_input, blocks, shape[1], shape[2], "stream-wrap")
    sk = _as_kernel(kernel, names, 1, global_size, blocks, unit, mi)
    lib = _library(sk, "stream_wrap", _WRAP_LEVELS if k <= _WRAP_MAX_K else range(1, k + 1))
    X, Y, Z = shape
    gx, gy, gz = sk.global_size
    form = _form(blocks, sk)
    outs = [torch.empty_like(b) for b in blocks] if out is None else out
    if any(b.dtype == torch.bfloat16 for b in blocks):  # float32 sets between the first launch and the last
        sets = [[b.new_empty(shape, dtype=torch.float32) for b in blocks] for _ in range(min(2, k - 1))]
        dst_of = lambda level: outs if level == k else sets[(level - 1) % 2]  # noqa: E731
    else:
        spare = [torch.empty_like(b) for b in blocks] if k > 1 else None
        dst_of = lambda level: (outs, spare)[(k - level) % 2]  # noqa: E731
    stream = stream_handle(dev)
    src = list(blocks)
    for level in range(1, k + 1):
        dst = dst_of(level)
        rc = lib.stp_stream_wrap_level(_ptrs(src), _ptrs(dst), origin.data_ptr(), X, Y, Z,
                                       gx, gy, gz, level, int(level > 1), int(level < k), stream)
        build.check(lib, rc, "stream_wrap_pass")
        _count(stream_wrap_pass, form)
        src = dst
    return outs


#: kernel launches made by ``stream_wrap_pass`` (plain-version calls do not
#: count): float32 fields, bf16 storage, groups with a float64 field, and
#: the contraction form on f32 / bf16 operands (either storage)
stream_wrap_pass.launches = 0
stream_wrap_pass.bf16_launches = 0
stream_wrap_pass.f64_launches = 0
stream_wrap_pass.mxu_launches = 0
stream_wrap_pass.mxu_bf16in_launches = 0


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
        if len(out) != len(raws):
            raise ValueError("out must hold one tensor of the blocks' shape per field")
        _check_fields(out, "out", (len(shape),), like=raws)
        if out[0].shape != shape:
            raise ValueError("out must hold one tensor of the blocks' shape per field")
        if {o.data_ptr() for o in out} & {r_.data_ptr() for r_ in raws}:
            raise ValueError("out must not alias the input blocks")
        same_device(raws[0], *out)
    if fused_shell is not None:
        _check_fused(fused_shell, raws, lo, hi)
    return n, X, Y, Z, dev


def stream_plane_pass_plain(kernel: Kernel, names, raws, lo: Dim3, hi: Dim3, x_radius: int, origin,
                            global_size, out=None, fused_shell=None, compute_unit: str = "vpu",
                            mxu_input: str = "f32") -> List[torch.Tensor]:
    """One level of ``kernel`` over shell-carrying block(s) ``(X, Y, Z)`` or
    ``(n, X, Y, Z)`` per field, with slices; shell cells pass through.
    ``origin`` holds each block's interior start.  ``fused_shell``
    ``(xbufs, ybufs, zbufs)`` (``_check_fused``) is patched into a copy of
    the blocks first, x planes, y rows, z columns, and the shell passes
    through with those values.  The level runs at each field's compute
    dtype and is rounded once to its storage dtype (bfloat16: the JAX
    package's ``f32_accumulate``); the shell keeps its stored bits.  Under a
    contracting ``compute_unit`` the level's ``plane_nbr_sum`` is
    ``plane_nbr_sum_host`` of each block's whole raw (Y, Z) planes, sliced
    to the interior."""
    n, X, Y, Z, dev = _check_plane(names, raws, lo, hi, x_radius, origin, out, fused_shell)
    unit, mi = _pass_unit(compute_unit, mxu_input, raws, Y, Z, "stream-plane")
    sk = _as_kernel(kernel, names, x_radius, global_size, raws, unit, mi)
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

    def nbr(q):
        c = bs[q][:, lo.x : X - hi.x].to(_compute_dtypes(raws)[q])
        return plane_nbr_sum_host(c, unit, mxu_input=mi)[..., lo.y : Y - hi.y, lo.z : Z - hi.z]

    vals = sk.evaluate(load, lambda: xyz, dev, nbr=nbr)
    res = []
    for q, b in enumerate(bs):
        o = torch.empty_like(b) if out is None else (out[q][None] if single else out[q])
        o.copy_(b)
        o[:, lo.x : X - hi.x, lo.y : Y - hi.y, lo.z : Z - hi.z] = vals[q]
        res.append(o[0] if single else o)
    return res


def stream_plane_pass(kernel: Kernel, names, raws, lo: Dim3, hi: Dim3, x_radius: int, origin,
                      global_size, out=None, fused_shell=None, compute_unit: str = "vpu",
                      mxu_input: str = "f32") -> List[torch.Tensor]:
    """ONE level of ``kernel`` over shell-carrying block(s) per field (lo/hi
    the shell widths, every shift within ``x_radius`` <= them); shell cells
    pass through.  Returns ``out`` (fresh tensors when None).  One CUDA
    launch serves all ``n`` blocks and all fields.  With ``fused_shell``
    the blocks' shell is stale and every shell-position cell is read from
    the buffers (the fused form; ``stream_plane_pass_plain``).
    ``compute_unit`` / ``mxu_input``: the contraction form, array or fused
    (the module docstring)."""
    n, X, Y, Z, dev = _check_plane(names, raws, lo, hi, x_radius, origin, out, fused_shell)
    if dev.type == "cpu":
        return stream_plane_pass_plain(kernel, names, raws, lo, hi, x_radius, origin, global_size, out,
                                       fused_shell, compute_unit, mxu_input)
    unit, mi = _pass_unit(compute_unit, mxu_input, raws, Y, Z, "stream-plane")
    sk = _as_kernel(kernel, names, x_radius, global_size, raws, unit, mi)
    res = [torch.empty_like(r) for r in raws] if out is None else list(out)
    gx, gy, gz = sk.global_size
    geometry = (n, X, Y, Z, lo.x, lo.y, lo.z, hi.x, hi.y, hi.z)
    form = _form(raws, sk)
    if fused_shell is None:
        lib = _library(sk, "stream_plane", [1])
        rc = lib.stp_stream_plane_level(_ptrs(raws), _ptrs(res), origin.data_ptr(), *geometry, gx, gy, gz,
                                        stream_handle(dev))
        build.check(lib, rc, "stream_plane_pass")
        _count(stream_plane_pass, form)
        return res
    lib = _library(sk, "stream_plane_fused", [1], _FUSED)
    xb, yb, zb = fused_shell
    rc = lib.stp_stream_plane_fused(_ptrs(raws), _ptrs(xb), _ptrs(yb), _ptrs(zb), _ptrs(res), origin.data_ptr(),
                                    *geometry, int(x_radius), gx, gy, gz, stream_handle(dev))
    build.check(lib, rc, "stream_plane_pass (fused)")
    _count(stream_plane_pass, form, fused=True)
    return res


#: kernel launches made by ``stream_plane_pass``: its array form, and its
#: fused form (``fused_shell``; one a call, its far and band kernels, or the
#: contraction's one kernel), each on float32 fields, under bf16 storage and
#: with a float64 field, and under the contraction on f32 / bf16 operands
#: (either storage)
stream_plane_pass.launches = 0
stream_plane_pass.fused_launches = 0
stream_plane_pass.bf16_launches = 0
stream_plane_pass.fused_bf16_launches = 0
stream_plane_pass.f64_launches = 0
stream_plane_pass.fused_f64_launches = 0
stream_plane_pass.mxu_launches = 0
stream_plane_pass.mxu_bf16in_launches = 0
stream_plane_pass.fused_mxu_launches = 0
stream_plane_pass.fused_mxu_bf16in_launches = 0


# --- stream_wavefront_pass -----------------------------------------------------------


def _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs, z_valid, alias, fused_shell=None,
                     compute_unit="vpu"):
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
    item = ring_itemsize([r.dtype for r in raws])
    if not stream_smem_fits(m, len(raws), item, compute_unit):
        raise ValueError(
            f"m={m} over {len(raws)} field(s) of {item}-byte levels needs "
            f"{stream_smem_bytes(m, len(raws), item, compute_unit)} bytes of shared memory per block "
            f"({compute_unit}), over the H100's {SMEM_PER_BLOCK}; pass fewer fields per call"
        )
    _check_origin(origin, n, single)
    tensors = [raws[0], origin]
    if z_slabs is not None:
        want = (Xr, 2 * s_off, Yr) if single else (n, Xr, 2 * s_off, Yr)
        if len(z_slabs) != len(raws):
            raise ValueError(f"z_slabs: one {want} tensor per field, got {len(z_slabs)}")
        zshape, _ = _check_fields(z_slabs, "z_slabs", (len(shape),), like=raws)
        if tuple(zshape) != want:
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
                                z_slabs=None, z_valid=None, alias=False, fused_shell=None,
                                compute_unit: str = "vpu", mxu_input: str = "f32"):
    """``m`` levels of ``kernel`` over s-shelled block(s) ``(Xr, Yr, Zr)`` or
    ``(n, Xr, Yr, Zr)`` per field, with rolls: every axis wraps, and the
    wrapped cells are the ones the shell was sized to sacrifice.  ``z_slabs``
    ``(.., Xr, 2s, Yr)`` per field replace the z-shell columns ``[0, s)`` and
    ``[z_valid - s, z_valid)`` (columns ``[z_valid, Zr)`` are dead).
    ``fused_shell`` ``(xbufs, ybufs, zbufs)`` (``_check_fused``, every width
    s; the plain form only) is patched into the level-0 blocks, x planes, y
    rows, z columns.  Returns ``(outs, zouts)`` (``zouts`` None without
    slabs); the interior ``[s, ext - s)`` of every axis is exact, shell
    cells are unspecified.  The levels run at each field's compute dtype
    and the outputs (and emitted slabs) are rounded once to its storage
    dtype (bfloat16: the JAX package's ``f32_accumulate``, float32 level
    rings).  Under a contracting ``compute_unit`` a level's
    ``plane_nbr_sum`` is ``plane_nbr_sum_host`` of the whole (Yr, Zr)
    planes of the level below, periodic as the rolls."""
    n, Xr, Yr, Zr, zv, dev = _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs,
                                              z_valid, alias, fused_shell, compute_unit)
    unit, mi = _pass_unit(compute_unit, mxu_input, raws, Yr, Zr, "stream-wavefront")
    sk = _as_kernel(kernel, names, 1, global_size, raws, unit, mi)
    cdt = _compute_dtypes(raws)
    single = raws[0].dim() == 3
    if fused_shell is not None:
        s3 = Dim3(s_off, s_off, s_off)
        w = _fused_blocks([r[None] if single else r for r in raws], fused_shell, s3, s3, single)
        w = [t.to(d) for t, d in zip(w, cdt)]
    else:
        w = [(r[None] if single else r).to(d, copy=True) for r, d in zip(raws, cdt)]
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
        w = _full(sk.evaluate(lambda q, dx, dy, dz: _roll(src[q], dx, dy, dz), lambda: xyz, dev, level,
                              lambda q: plane_nbr_sum_host(src[q], unit, mxu_input=mi)), shape, cdt)
    outs = [o.to(r.dtype) for o, r in zip(w, raws)]
    outs = [o[0] if single else o for o in outs]
    if z_slabs is None:
        return outs, None
    zouts = [_emit(o, s_off, zv - 2 * s_off, s_off).to(r.dtype) for o, r in zip(w, raws)]
    return outs, [z[0] if single else z for z in zouts]


def stream_wavefront_pass(kernel: Kernel, names, raws, m: int, s_off: int, origin, global_size,
                          z_slabs=None, z_valid=None, alias=False, fused_shell=None, out=None, z_out=None,
                          compute_unit: str = "vpu", mxu_input: str = "f32"):
    """``m`` levels of ``kernel`` (read radius 1) in ONE pass over s-shelled
    block(s) per field: the compute half of the temporally blocked route.
    Arguments and result as ``stream_wavefront_pass_plain``; ``alias=True``
    is refused.  One CUDA launch serves all ``n`` blocks and all fields; the
    outputs are ``out`` (and ``z_out`` with ``z_slabs``), fresh buffers when
    None, written on the valid region only.  With ``fused_shell`` the
    blocks' shell is stale and every level-0 cell at a shell position is
    read from the buffers (the fused form).  ``compute_unit`` /
    ``mxu_input``: the contraction form (every layout; the module
    docstring)."""
    n, Xr, Yr, Zr, zv, dev = _check_wavefront(names, raws, m, s_off, origin, global_size, z_slabs,
                                              z_valid, alias, fused_shell, compute_unit)
    if out is not None:
        out = _check_outs(out, raws)
    if z_out is not None:
        if z_slabs is None:
            raise ValueError("z_out needs z_slabs")
        z_out = _check_outs(z_out, z_slabs)
    if dev.type == "cpu":
        outs, zouts = stream_wavefront_pass_plain(kernel, names, raws, m, s_off, origin, global_size,
                                                  z_slabs, z_valid, alias, fused_shell, compute_unit, mxu_input)
        if out is not None:
            outs = [o.copy_(r) for o, r in zip(out, outs)]
        if z_out is not None:
            zouts = [o.copy_(r) for o, r in zip(z_out, zouts)]
        return outs, zouts
    unit, mi = _pass_unit(compute_unit, mxu_input, raws, Yr, Zr, "stream-wavefront")
    sk = _as_kernel(kernel, names, 1, global_size, raws, unit, mi)
    outs = [torch.empty_like(r) for r in raws] if out is None else out
    gx, gy, gz = sk.global_size
    form = _form(raws, sk)
    if fused_shell is not None:
        lib = _library(sk, *_wavefront_variant(m, fused=True))
        xb, yb, zb = fused_shell
        rc = lib.stp_stream_wavefront_fused(_ptrs(raws), _ptrs(xb), _ptrs(yb), _ptrs(zb), _ptrs(outs),
                                            origin.data_ptr(), n, Xr, Yr, Zr, m, s_off, gx, gy, gz,
                                            stream_handle(dev))
        build.check(lib, rc, "stream_wavefront_pass (fused)")
        _count(stream_wavefront_pass, form, fused=True)
        return outs, None
    lib = _library(sk, *_wavefront_variant(m))
    zouts = None if z_slabs is None else [torch.empty_like(z) for z in z_slabs] if z_out is None else z_out
    slabs = z_slabs is not None
    rc = lib.stp_stream_wavefront(
        _ptrs(raws), _ptrs(outs), _ptrs(z_slabs) if slabs else None, _ptrs(zouts) if slabs else None,
        origin.data_ptr(), n, Xr, Yr, Zr, zv, m, s_off, gx, gy, gz, int(slabs), stream_handle(raws[0].device),
    )
    build.check(lib, rc, "stream_wavefront_pass")
    _count(stream_wavefront_pass, form)
    return outs, zouts


#: the fields of ``stream_wavefront_launch``, in the order the C entry fills them
WAVEFRONT_PLAN_FIELDS = ("queue", "blocks_per_sm", "sms", "blocks", "xchunk", "nchunks", "smem_bytes",
                         "threads", "tiles_z", "tiles_y")


def stream_wavefront_launch(kernel: Kernel, names, raws, m: int, s_off: int, global_size, z_slabs=None,
                            z_valid=None, fused: bool = False, compute_unit: str = "vpu",
                            mxu_input: str = "f32") -> dict:
    """The launch ``stream_wavefront_pass`` makes for these arguments on the
    card, without making it: ``form`` ("queue", the register-queue form, or
    "general"), the blocks an SM the occupancy calculator allows, the grid's
    blocks and its ``waves`` (blocks over the blocks resident at once), the
    x chunking, the shared memory and threads a block asks and the tiles
    along z and y (fields as ``WAVEFRONT_PLAN_FIELDS``); ``fused`` plans the
    fused form's launch, ``compute_unit`` / ``mxu_input`` the contraction
    form's."""
    shape = raws[0].shape
    n = 1 if len(shape) == 3 else shape[0]
    Xr, Yr, Zr = shape[-3:]
    zv = Zr if z_valid is None else int(z_valid)
    unit, mi = _pass_unit(compute_unit, mxu_input, raws, Yr, Zr, "stream-wavefront")
    sk = _as_kernel(kernel, names, 1, global_size, raws, unit, mi)
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
#: forms, and its fused form (``fused_shell``), each on float32 fields,
#: under bf16 storage and with a float64 field, and under the contraction
#: on f32 / bf16 operands (either storage)
stream_wavefront_pass.launches = 0
stream_wavefront_pass.fused_launches = 0
stream_wavefront_pass.bf16_launches = 0
stream_wavefront_pass.fused_bf16_launches = 0
stream_wavefront_pass.f64_launches = 0
stream_wavefront_pass.fused_f64_launches = 0
stream_wavefront_pass.mxu_launches = 0
stream_wavefront_pass.mxu_bf16in_launches = 0
stream_wavefront_pass.fused_mxu_launches = 0
stream_wavefront_pass.fused_mxu_bf16in_launches = 0


# --- planning -------------------------------------------------------------------------


def _tuned_stream_plan(dd, x_radius: int, separable: bool) -> Optional[dict]:
    """A structurally valid stored plan for this domain from the autotuner,
    or None (``stencil_tpu/ops/stream.py:824-870``).  Its validity is
    checked here, not trusted from the file: a hand-edited or stale entry
    falls back to the static plan with a warning, never an error.  The axes'
    fields (``overlap``, ``halo``, ``compute_unit``, ``mxu_input``) ride
    along when present and must be in their vocabularies; ``alias`` is not
    read (the port's passes never alias)."""
    from stencil_tpu_torch import tune

    cfg = tune.best_config(dd.tune_key("stream"))
    if cfg is None:
        return None
    route, m = cfg.get("route"), cfg.get("m")
    plan = {"route": route, "m": m, "z_slabs": bool(cfg.get("z_slabs", False)),
            "grouping": cfg.get("grouping", "joint")}
    for axis in ("overlap", "compute_unit", "mxu_input", "halo"):
        if cfg.get(axis) is not None:
            plan[axis] = cfg[axis]
    n = dd.local_spec().sz
    shell = dd.shell_radius()
    lo, hi = shell.lo(), shell.hi()
    ok = isinstance(m, int) and not isinstance(m, bool) and m >= 1
    for axis, vocab in (("overlap", STREAM_OVERLAP), ("halo", STREAM_HALO), ("compute_unit", COMPUTE_UNITS),
                        ("mxu_input", MXU_INPUTS)):
        if ok and plan.get(axis) is not None:
            ok = plan[axis] in vocab
    if ok and plan["grouping"] == "per-field":
        ok = separable and len(dd._handles) > 1
    elif ok and plan["grouping"] != "joint":
        ok = False
    if ok and route == "wrap":
        ok = dd.num_subdomains() == 1 and x_radius == 1 and m <= n.x // 2
    elif ok and route == "wavefront":
        uniform = len({lo.x, lo.y, lo.z, hi.x, hi.y, hi.z}) == 1
        v_min = min(dd.valid_last()[ax] if dd.valid_last()[ax] is not None else n[ax] for ax in range(3))
        ok = (x_radius == 1 and uniform and lo.x >= 2 and 2 <= m <= min(lo.x, v_min)
              and not (plan["z_slabs"] and dd.padded()))
    elif ok and route == "plane":
        ok = m == 1 and not plan["z_slabs"]
    elif ok:
        ok = False
    if not ok:
        from stencil_tpu_torch.utils.logging import log_warn

        log_warn(f"tuned stream config {cfg} is structurally invalid for this domain (shell/shards changed "
                 "since it was measured?); using the static plan")
        return None
    return plan


def plan_stream(dd, x_radius: int, path: str = "auto", separable: bool = False, max_m: int = None,
                compute_unit: str = "vpu") -> dict:
    """Route planning for ``make_stream_step`` on a realized domain
    (``stencil_tpu/ops/stream.py:913``).  On the unconstrained auto path
    (``path="auto"``, no ``max_m``) the tuned plan comes first
    (``_tuned_stream_plan``); a forced route or a depth cap plans statically
    (the ladder's step-down must not re-apply the depth that failed).

    Returns ``{"route": "wrap"|"wavefront"|"plane", "m": int, "z_slabs": bool,
    "grouping": "joint"|"per-field"}``.  One subdomain and ``x_radius`` 1
    take ``wrap`` (no shell, no exchange), k = min(16, X // 2) levels per
    call (the CUDA kernel runs one level per launch, so no shared memory
    caps k).  Otherwise ``x_radius`` 1 and a uniform face shell s >= 2 take
    the z-slab ``wavefront`` at the deepest m in [2, min(s, 16)] whose
    kernel fits (``stream_smem_fits`` at ``ring_itemsize`` of the fields'
    dtypes: a float64 field doubles the planes; under a contracting
    ``compute_unit`` a plane of sums more a field): jointly, or per field when the
    kernel is ``separable`` and that goes deeper (joint wins ties).  The
    ``plane`` route covers the rest, jointly (its kernel keeps no planes in
    shared memory).  ``path`` forces a route ("wavefront"/"wrap" raise when
    not viable); ``max_m`` caps the depth.

    Differences from the JAX package's plan, from the two memory models:
    the wrap depth is never capped by memory; the wavefront's joint depth
    falls with the field count (3 fields at s = 3 plan per-field m = 3, or
    joint m = 2 when not separable, where the JAX package keeps joint m = 3
    at small sizes; float64 fields, priced at 8 bytes a cell, plan shallower
    still: two float64 fields at s = 3 plan joint m = 2); the plane route
    never groups per field; the z-slab
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
    if path == "auto" and max_m is None:
        tuned = _tuned_stream_plan(dd, x_radius, separable)
        if tuned is not None:
            return tuned
    return _static_plan(dd, x_radius, path, separable, max_m, compute_unit)


def _static_plan(dd, x_radius: int, path: str, separable: bool, max_m: Optional[int], compute_unit: str) -> dict:
    """``plan_stream``'s static model (its docstring)."""
    shell = dd.shell_radius()
    lo, hi = shell.lo(), shell.hi()
    n = dd.local_spec().sz
    if not all(lo[ax] >= x_radius and hi[ax] >= x_radius for ax in range(3)):
        raise ValueError(f"shell {lo}/{hi} narrower than the kernel x_radius {x_radius}")
    nf = len(dd._handles)
    item = ring_itemsize([dd.field_dtype(h) for h in dd._handles])
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
            m = max([c for c in range(2, cap + 1) if stream_smem_fits(c, fields, item, compute_unit)], default=0)
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


def _warn(msg: str) -> None:
    warnings.warn(msg, RuntimeWarning, stacklevel=4)


def _axis_request(plan: dict, axis: str, env_name: str, vocab, static: str) -> Tuple[str, str]:
    """Before the structural gate: ``(value, source)`` of a plan's
    ``overlap`` or ``halo`` (``stencil_tpu/ops/stream.py:1156-1192,
    1254-1286``): a forced value (``<axis>_forced``: an explicit request, an
    autotuner candidate) > the env knob > the plan's tuned value (outside
    the vocabulary: a warning, then the static value) > static."""
    from stencil_tpu_torch.utils.config import env_choice

    if plan.get(f"{axis}_forced") and plan.get(axis) is not None:
        if plan[axis] not in vocab:
            raise ValueError(f"unknown stream {axis} {plan[axis]!r} (one of {vocab})")
        return plan[axis], "explicit"
    env = env_choice(env_name, "auto", ("auto",) + tuple(vocab))
    if env != "auto":
        return env, "env"
    tuned = plan.get(axis)
    if tuned is not None:
        if tuned in vocab:
            return str(tuned), "tuned"
        _warn(f"tuned stream {axis} {tuned!r} is not one of {vocab}; using the static {static!r} fallback")
    return static, "static"


def _overlap_request(plan: dict) -> Tuple[str, str]:
    return _axis_request(plan, "overlap", "STENCIL_STREAM_OVERLAP", STREAM_OVERLAP, "off")


def _halo_request(plan: dict) -> Tuple[str, str]:
    return _axis_request(plan, "halo", "STENCIL_STREAM_HALO", STREAM_HALO, "array")


def _resolve_stream_overlap(plan: dict) -> Tuple[str, str]:
    """``(value, source)`` of a plan's overlap schedule
    (``stencil_tpu/ops/stream.py:1156-1218``): ``_overlap_request``, then
    the structural gate: a ``split`` the plan cannot serve (the wrap route
    has no exchange to hide; the z-slab wavefront interleaves its slab
    permutes with the pass) degrades to ``off`` with a ``RuntimeWarning``,
    source tagged ``/degraded``."""
    val, source = _overlap_request(plan)
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
    (``stencil_tpu/ops/stream.py:1254-1311``): ``_halo_request``, then the
    structural gate: a ``fused`` the plan cannot serve
    (``fused_halo_ineligible``) degrades to ``array`` with a
    ``RuntimeWarning``."""
    val, source = _halo_request(plan)
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
    temporal depth (wrap k / wavefront m).  The fields may be float32,
    float64 (each computes at its own dtype; float32 and float64 fields
    stream jointly at double) or bf16 storage (``dd.set_storage("bf16")``:
    every pass computes at float32 and rounds once, the JAX package's
    ``f32_accumulate``, recorded in ``step._stream_plan``).  ``z_slabs=False`` runs a
    wavefront plan in its plain form (every axis exchanged in the array, as
    on uneven sizes, where the plan takes it and ``z_slabs=True`` raises).

    ``compute_unit`` (``"vpu"``, ``"mxu"``, ``"mxu_band"``) and
    ``mxu_input`` (``"f32"``, ``"bf16"``) resolve as
    ``stencil_tpu/ops/stream.py:1405-1446`` resolves them: the explicit
    request, else ``STENCIL_COMPUTE_UNIT`` / ``STENCIL_MXU_INPUT``, else the
    tuned plan's field, else ``vpu`` / ``f32``.  A
    contracting unit engages only on a kernel that declares its
    axis-separable form (``mxu_kernel``, the same stencil with its in-plane
    taps written through ``PlaneView.plane_nbr_sum``), which every pass then
    traces in place of ``kernel``, and only where every field computes at
    float32 (bf16 storage does); otherwise it degrades to ``vpu`` with a
    ``RuntimeWarning``, as does ``mxu_input="bf16"`` under ``vpu``.  The
    plan records the resolved ``compute_unit`` and ``mxu_input``; a pass
    whose plane admits no band tile runs ``mxu_band`` as ``mxu``, with a
    warning when the step is built.  Under an engaged unit the wavefront's
    depth is planned with the contraction's shared memory
    (``stream_smem_bytes``), and the split schedule and the fused halo
    resolve as under ``vpu``.  Each of the split schedule's band passes
    resolves the unit on its own sub-block's plane, ``(3w, Z)`` or ``(Y,
    3w)`` (``_band_units``): ``mxu_band`` there may run as ``mxu`` where
    the JAX package, which rounds each band window up to its tile granule,
    keeps ``mxu_band``; the values are the same.

    ``overlap`` (``"off"`` or ``"split"``) and ``halo`` (``"array"`` or
    ``"fused"``) select the split schedule and the fused halo (module
    docstring); ``"auto"`` resolves ``STENCIL_STREAM_OVERLAP`` /
    ``STENCIL_STREAM_HALO``, else the tuned plan's field, else ``off`` /
    ``array``.  A ``split`` or ``fused`` request
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
    the resolved ``overlap`` and ``halo``, of the degradation ladder's
    current rung (module docstring; ``step._resilience`` is the ladder).
    Component (N-D) quantities are refused, as the JAX engine refuses them
    (``stencil_tpu/ops/stream.py:953-954``): the torch engine takes them."""
    if any(h.components for h in dd._handles):
        raise ValueError("the streaming engine does not support N-D component data")
    if overlap not in ("auto",) + STREAM_OVERLAP:
        raise ValueError(f"unknown stream overlap {overlap!r} (one of {('auto',) + STREAM_OVERLAP})")
    if halo not in ("auto",) + STREAM_HALO:
        raise ValueError(f"unknown stream halo mode {halo!r} (one of {('auto',) + STREAM_HALO})")
    if compute_unit not in ("auto", "vpu", "mxu", "mxu_band"):
        raise ValueError(f"unknown compute unit {compute_unit!r} (one of ('auto', 'vpu', 'mxu', 'mxu_band'))")
    if mxu_input not in ("auto", "f32", "bf16"):
        raise ValueError(f"unknown mxu input {mxu_input!r} (one of ('auto', 'f32', 'bf16'))")
    max_depth = _check_depth(max_depth)
    # the tuned plan on the unconstrained auto path (plan_stream's consult,
    # made once here), else the static one
    tuned = _tuned_stream_plan(dd, x_radius, separable) if path == "auto" and max_depth is None else None
    plan = dict(tuned) if tuned is not None else _static_plan(dd, x_radius, path, separable, max_depth, "vpu")
    plan = resolve_plan(dd, plan, x_radius, separable, overlap=overlap, halo=halo, compute_unit=compute_unit,
                        mxu_input=mxu_input, mxu_kernel=mxu_kernel, z_slabs=z_slabs,
                        replan=None if tuned is not None else (path, max_depth))
    return _ladder_step(dd, plan, kernel, mxu_kernel, x_radius, path, separable, z_slabs)


def resolve_plan(dd, plan: dict, x_radius: int, separable: bool, *, overlap: str = "auto", halo: str = "auto",
                 compute_unit: str = "auto", mxu_input: str = "auto", mxu_kernel: Callable = None,
                 z_slabs: Optional[bool] = None, replan=None) -> dict:
    """Resolve a plan's axes, each explicit > env > the plan's tuned field >
    static, through the structural gates (``make_stream_step``'s docstring),
    emitting ``kernel.compute_unit``, ``kernel.mxu_input``, ``step.overlap``
    and ``step.halo``.  A request other than ``"auto"`` is explicit.
    ``replan=(path, max_depth)`` re-plans a static plan's depth under an
    engaged contraction unit; a tuned or a candidate plan (None) keeps its
    measured depth.  Returns the resolved plan the ladder's rungs take (the
    autotuner's stream trials build theirs through it too)."""
    plan = {k: v for k, v in plan.items() if k not in ("alias", "halo_multiplier")}
    # the compute-unit axis, degraded where the kernel declares no
    # contraction form or a field computes off f32; then the operands (bf16
    # only under a contracting unit)
    where = f"stream:{plan['route']}"
    unit_req = None if compute_unit == "auto" else compute_unit
    unit, _ = resolve_compute_unit(
        unit_req, None if unit_req else plan.get("compute_unit"), [h.dtype for h in dd._handles], where=where,
        engine_ok=mxu_kernel is not None,
        engine_why="the kernel declares no axis-separable contraction form (make_stream_step mxu_kernel=...)")
    mi_req = None if mxu_input == "auto" else mxu_input
    mi, _ = resolve_mxu_input(mi_req, None if mi_req else plan.get("mxu_input"), unit, where=where)
    if unit_uses_mxu(unit) and replan is not None:
        # the depth planned with the contraction's shared memory
        plan = dict(_static_plan(dd, x_radius, replan[0], separable, replan[1], unit))
    if z_slabs is not None and plan["route"] == "wavefront":
        if z_slabs and dd.padded():
            raise ValueError("z_slabs=True: the z-slab wavefront form needs even (unpadded) subdomains")
        plan["z_slabs"] = bool(z_slabs)
    if overlap != "auto":
        plan.update(overlap=overlap, overlap_forced=True)
    if halo != "auto":
        plan.update(halo=halo, halo_forced=True)
    # a split or fused request (explicit, env or tuned) re-plans a z-slab
    # wavefront to its plain form first
    if z_slabs is None and (_overlap_request(plan)[0] == "split" or _halo_request(plan)[0] == "fused"):
        plan = plain_wavefront_plan(plan) or plan
    plan["overlap"], source = _resolve_stream_overlap(plan)
    telemetry.emit_event(tm.EVENT_STEP_OVERLAP, overlap=plan["overlap"], source=source, route=plan["route"],
                         m=plan["m"])
    exch_route = dd.exchange_route()
    plan["halo"], source = _resolve_stream_halo(dd, plan, exch_route)
    telemetry.emit_event(tm.EVENT_STEP_HALO, halo=plan["halo"], source=source, route=plan["route"], m=plan["m"],
                         exchange_route=exch_route)
    for key in ("overlap_forced", "halo_forced"):
        plan.pop(key, None)
    dtypes = [dd.field_dtype(h) for h in dd._handles]
    plan.update(compute_unit=unit, mxu_input=mi, f32_accumulate=torch.bfloat16 in dtypes)
    return plan


def _rung_name(plan: dict) -> str:
    """The JAX package's rung name of a resolved plan (``route[m=..]`` and
    the engaged axes)."""
    suffix = ",split" if plan["overlap"] == "split" else ""
    if plan["halo"] == "fused":
        suffix += ",fused"
    if plan["compute_unit"] != "vpu":
        suffix += f",{plan['compute_unit']}"
    return f"{plan['route']}[m={plan['m']}{suffix}]"


class _LadderStep:
    """``step(curr, steps, capture=False) -> curr`` over the stream ladder:
    the current rung's step, with its execute hook and descent.  A class,
    not a closure: the properties read the ladder's current rung, and no
    function refers to itself (a cycle would outlive the model)."""

    _writes_in_place = True
    _marks_shell_stale = True
    _resilience_label = "stream"

    def __init__(self, ladder):
        self._resilience = ladder
        self.captured = False

    @property
    def _stream_plan(self) -> dict:
        return self._resilience.rung.state["plan"]

    @property
    def _loop(self):
        return self._resilience.built()._loop

    def __call__(self, curr, steps: int = 1, capture: bool = False):
        out = self._resilience.step(curr, steps, capture=capture)
        cells, flops = self._resilience.rung.state["count"]
        if cells:
            telemetry.inc(tm.STEP_OVERLAP_EXTERIOR_CELLS, steps * cells)
        if flops:
            telemetry.inc(tm.KERNEL_MXU_FLOPS, steps * flops)
        return out


def _step_counts(dd, plan: dict, x_radius: int) -> Tuple[int, int]:
    """``(exterior cells, tensor-core FLOPs)`` a raw iteration of ``plan``
    counts over all subdomains and fields (``stencil_tpu/ops/stream.py:
    2180-2214``): the split schedule's six bands of width ``x_radius`` on the
    plane route, of the macro's depth a level on the wavefront (one band
    width a level either way), 0 off split; the contraction's FLOPs on the
    plane each pass contracts (the wrap route's bare interior, the z-slab
    wavefront's lane-padded plane, else the raw block), 0 under vpu."""
    raw, n_int = dd.local_spec().raw_size(), dd.local_spec().sz
    per = len(dd._handles) * dd.num_subdomains()
    cells = 0
    if plan.get("overlap") == "split":
        band = 2 * (raw.y * raw.z + raw.x * raw.z + raw.x * raw.y) * per
        cells = band if plan["route"] == "wavefront" else band * x_radius
    flops = 0
    unit = plan.get("compute_unit", "vpu")
    if unit_uses_mxu(unit):
        if plan.get("route") == "wrap":
            py, pz, px = n_int.y, n_int.z, n_int.x
        else:
            py, px = raw.y, raw.x
            pz = lane_pad_width(raw.z) if plan.get("z_slabs") else raw.z
        flops = mxu_flops_per_plane(py, pz, unit) * px * per
    return cells, flops


def _ladder_step(dd, plan: dict, kernel, mxu_kernel, x_radius: int, path: str, separable: bool,
                 z_slabs) -> _LadderStep:
    """The stream engine's degradation ladder over the resolved ``plan``
    (``stencil_tpu/ops/stream.py:2038-2170``; module docstring): a rung
    under a contracting unit traces ``mxu_kernel``, else ``kernel``."""
    from stencil_tpu_torch.resilience.ladder import DegradationLadder, Rung
    from stencil_tpu_torch.utils.logging import log_warn

    def rung_for(p: dict) -> Rung:
        return Rung(name=_rung_name(p), build=lambda: _build_plan(
            dd, p, mxu_kernel if unit_uses_mxu(p["compute_unit"]) else kernel, x_radius),
            state={"plan": p, "count": _step_counts(dd, p, x_radius)},
            # the plain versions need no build; on the card the generated
            # templates' libraries are not named here (no cross-process stamp)
            libraries=lambda: () if dd.device.type != "cuda" else None)

    def lower(rung, cls, exc):
        p = rung.state["plan"]
        at = f"{p['route']}[m={p['m']}] exceeded the card's capability ({cls.value})"
        if p["compute_unit"] == "mxu_band":
            log_warn(f"compute_unit=mxu_band on {at}; stepping down to the dense mxu form at the same depth")
            return rung_for(dict(p, compute_unit="mxu"))
        if p["compute_unit"] == "mxu":
            log_warn(f"compute_unit=mxu on {at}; stepping down to vpu at the same depth")
            return rung_for(dict(p, compute_unit="vpu", mxu_input="f32"))
        if p["halo"] == "fused":
            log_warn(f"halo=fused on {at}; stepping down to halo=array at the same depth")
            return rung_for(dict(p, halo="array"))
        if p["overlap"] == "split":
            log_warn(f"split-step overlap on {at}; stepping down to overlap=off at the same depth")
            return rung_for(dict(p, overlap="off"))
        if p["route"] not in ("wavefront", "wrap") or p["m"] <= 1:
            return None  # the plane route, or wrap[m=1]: the bottom rung
        new_max = p["m"] - 1
        log_warn(f"{p['route']} depth m={p['m']} exceeded the card's capability ({cls.value}); stepping down "
                 f"to m<={new_max}")
        # below depth 2 the wavefront is the plane route
        p2 = dict(plan_stream(dd, x_radius, "plane" if p["route"] == "wavefront" and new_max < 2 else path,
                              separable, max_m=new_max))
        if z_slabs is not None and p2["route"] == "wavefront":
            p2["z_slabs"] = bool(z_slabs)
        # the axes have stepped down before any depth: vpu, off, array
        p2.update(overlap="off", halo="array", compute_unit="vpu", mxu_input="f32",
                  f32_accumulate=p["f32_accumulate"])
        return rung_for(p2)

    def prefilter(rung):
        p = rung.state["plan"]
        if p["route"] != "wavefront":
            return None
        fields = 1 if p["grouping"] == "per-field" else len(dd._handles)
        item = ring_itemsize([dd.field_dtype(h) for h in dd._handles])
        if stream_smem_fits(p["m"], fields, item, p["compute_unit"]):
            return None
        return (f"wavefront[m={p['m']}] needs {stream_smem_bytes(p['m'], fields, item, p['compute_unit'])} "
                "bytes of shared memory per block, more than the H100 grants one block")

    return _LadderStep(DegradationLadder(rung_for(plan), lower=lower, label="stream", prefilter=prefilter))


def _build_plan(dd, plan: dict, kernel: Callable, x_radius: int):
    """One rung's step: trace ``kernel`` for the resolved ``plan``, build
    every library its route can launch (on the card, all nvcc runs at once)
    and build the route's loop."""
    unit, mi, dtypes = plan["compute_unit"], plan["mxu_input"], [dd.field_dtype(h) for h in dd._handles]
    names = [h.name for h in dd._handles]
    groups = [[q] for q in range(len(names))] if plan["grouping"] == "per-field" else [list(range(len(names)))]
    gsize = dd.size()
    route = plan["route"]

    def trace(u: str) -> List[StreamKernel]:
        return [StreamKernel(kernel, [names[q] for q in g], x_radius, gsize, dtypes=[dtypes[q] for q in g],
                             compute_unit=u, mxu_input=mi) for g in groups]

    band_units = _band_units(dd, plan, unit, x_radius) if plan["overlap"] == "split" else {}
    # each pass's unit: mxu_band on a plane that admits no band tile runs as
    # mxu (stencil_tpu/ops/stream.py:262-277), warned here, once
    if unit_uses_mxu(unit):
        n, raw = dd.local_spec().sz, dd.local_spec().raw_size()
        plane = (n.y, n.z) if route == "wrap" else (raw.y, raw.z)
        unit = plane_band_unit(unit, *plane, where=f"stream-{route}")
    ukw = {"compute_unit": unit, "mxu_input": mi}
    programs = trace(unit)
    # the band passes' traced kernels and keywords, by (axis, width)
    traced = {unit: programs}
    for u in set(band_units.values()) - {unit}:
        traced[u] = trace(u)
    band = {key: (traced[u], {"compute_unit": u, "mxu_input": mi}) for key, u in band_units.items()}
    if dd.device.type == "cuda":
        _prebuild([p for ps in traced.values() for p in ps], plan)
    build = {"wrap": _wrap_route, "plane": _plane_route, "wavefront": _wavefront_route}[route]
    return build(dd, names, groups, programs, plan, x_radius, ukw, band)


def _band_units(dd, plan: dict, unit: str, x_radius: int) -> dict:
    """``{(axis, w): unit}`` of the split schedule's band passes (``w``:
    ``x_radius`` on the plane route, each macro depth 1..m on the
    wavefront): each pass resolves ``unit`` on its own sub-block's plane, as
    ``_pass_band_setup`` does per pass (``stencil_tpu/ops/stream.py:262-277``).
    An x band's plane is the block's; a y or z band's is ``min(3w, Yr)`` or
    ``min(3w, Zr)`` wide on that axis (``_exterior_fix``'s window, which the
    JAX package rounds up to its tile granule).  ``mxu_band`` on a plane
    that admits no band tile runs as ``mxu``, with one warning for the y
    and z bands (the block's own plane warns for the passes over it)."""
    raw = dd.local_spec().raw_size()
    widths = [x_radius] if plan["route"] == "plane" else range(1, plan["m"] + 1)
    units, dense = {}, set()
    for w in widths:
        for ax in range(3):
            plane = [min(3 * w, raw[b]) if b == ax else raw[b] for b in (1, 2)]
            units[(ax, w)] = unit
            if unit == "mxu_band" and band_tile_plan(*plane) is None:
                units[(ax, w)] = "mxu"
                if ax:
                    dense.add(tuple(plane))
    if dense:
        _warn(f"compute_unit=mxu_band cannot tile the split schedule's band planes {sorted(dense)} "
              "(no admissible granule divides both extents); those band passes run the dense mxu form")
    return units


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


def _scoped(scoped: bool, name: str, fn: Callable) -> Callable:
    """``fn`` run inside the profiler scope ``name`` when ``scoped``."""
    if not scoped:
        return fn

    def run():
        with telemetry.profiler_scope(name):
            return fn()

    return run


def _blocks(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``(px, py, pz, ...) -> (n, ...)`` views: one launch serves all."""
    return [t.view(-1, *t.shape[3:]) for t in ts]


def _wrap_route(dd, names, groups, programs, plan, x_radius, ukw, band):
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
                             out=[nxt.fields[q] for q in g], **ukw)

    return as_step(window_loop(names, k, body, inner))


def _grouped(groups, bs, fused_bufs, run, outs) -> None:
    """``run(sk_index, blocks, fused_shell, out)`` for each group over its
    fields' blocks (fused buffers and outputs)."""
    for j, g in enumerate(groups):
        fs = None if fused_bufs is None else tuple([b[q] for q in g] for b in fused_bufs)
        run(j, [bs[q] for q in g], fs, [outs[q] for q in g])


def _plane_route(dd, names, groups, programs, plan, x_radius, ukw, band):
    shell = dd.shell_radius()
    lo, hi = shell.lo(), shell.hi()
    origins = dd.origins()
    gsize = dd.size()
    valid_last = dd.valid_last()
    route = dd.exchange_route()
    split, fused = plan["overlap"] == "split", plan["halo"] == "fused"

    def passes(bs, outs, fused_bufs=None):
        _grouped(groups, bs, fused_bufs, lambda j, b, fs, o: stream_plane_pass(
            programs[j], programs[j].names, b, lo, hi, x_radius, origins, gsize, out=o, fused_shell=fs, **ukw),
            outs)

    def narrow_plane(subs, ax, w, origin_sub):
        """One level over ``3w``-wide face sub-blocks (``w == x_radius``):
        the sliced axis carries a ``w``-deep pseudo shell, the others keep
        the true shell widths (``narrow_plane``, JAX ``:1634-1656``); the
        pass's unit is its plane's (``_band_units``)."""
        lo2 = Dim3(*[w if b == ax else lo[b] for b in range(3)])
        hi2 = Dim3(*[w if b == ax else hi[b] for b in range(3)])
        progs, bkw = band[(ax, w)]
        out = list(subs)
        for sk, g in zip(progs, groups):
            for q, o in zip(g, stream_plane_pass(sk, sk.names, [subs[q] for q in g], lo2, hi2, x_radius, origin_sub,
                                                 gsize, **bkw)):
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
            scoped = telemetry.scoping()
            overlapped(side, _scoped(scoped, tm.SPAN_OVERLAP_INTERIOR, lambda: passes(blocks, outs)),
                       _scoped(scoped, tm.SPAN_OVERLAP_EXTERIOR,
                               lambda: halo_exchange_multi(stacks, shell, valid_last, route=route)))
            with telemetry.scope(tm.SPAN_OVERLAP_EXTERIOR):
                fix(outs, blocks, x_radius, False)
        else:
            halo_exchange_multi(stacks, shell, valid_last, route=route)
            passes(blocks, outs)

    return as_step(Loop(names, 1, body))


def _wavefront_route(dd, names, groups, programs, plan, x_radius, ukw, band):
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
            programs[j], programs[j].names, b, depth, s, origins, gsize, fused_shell=fs, out=o, **ukw), outs)

    def narrow_wavefront(subs, ax, w, origin_sub):
        """``w`` levels over ``3w``-wide face sub-blocks (``w`` is this
        macro's depth) with a pseudo shell of ``w`` on every axis
        (``narrow_wavefront``, JAX ``:1732-1757``); the pass's unit is its
        plane's (``_band_units``)."""
        progs, bkw = band[(ax, w)]
        out = list(subs)
        for sk, g in zip(progs, groups):
            for q, o in zip(g, stream_wavefront_pass(sk, sk.names, [subs[q] for q in g], w, w, origin_sub, gsize,
                                                     **bkw)[0]):
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
            scoped = telemetry.scoping()
            overlapped(side, _scoped(scoped, tm.SPAN_OVERLAP_INTERIOR, lambda: passes(blocks, depth, outs)),
                       _scoped(scoped, tm.SPAN_OVERLAP_EXTERIOR,
                               lambda: halo_exchange_multi(stacks, shell, valid_last, route=route)))
            with telemetry.scope(tm.SPAN_OVERLAP_EXTERIOR):
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
                                  z_out=[zouts[q] for q in g], **ukw)

    def zslabs(stacks):
        return [t.new_empty((*t.shape[:3], Xr, 2 * s, Yr)) for t in stacks]

    def prime(stacks, cur):
        for t, z in zip(stacks, cur.extra):
            prime_z_slabs(t, Zr, s, out=z)

    if z_slab_mode:
        return as_step(Loop(names, m, body, extra=zslabs, enter=prime))
    return as_step(Loop(names, m, body))
