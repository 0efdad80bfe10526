"""Jacobi level kernels: ``jacobi_wrap_step``, ``jacobi_plane_step``,
``jacobi_slab_step``, ``jacobi_shell_wavefront_step``,
``jacobi_zring_wavefront_step`` and their plain versions, with the kernel
axes of ``stencil_tpu/ops/jacobi_pallas.py``.

Counterpart of ``stencil_tpu/ops/jacobi_pallas.py``.  On a CUDA tensor each
wrapper launches its hand-written kernel, a form of the register-queue
march of ``csrc/jacobi_wavefront.cu``; on a CPU tensor it runs the plain
PyTorch version.

Semantics, per level, match ``Jacobi3D._kernel`` of the JAX package: mean of
the six face neighbours, then the hot and cold sphere clamps.  Two details
make the port bitwise equal to the TPU kernels:

* the neighbours are summed as a left fold in the TPU kernels' order
  x-1, x+1, y-1, y+1, z-1, z+1 (``_make_level_sum``, jacobi_pallas.py:515-524);
* the mean is ``sum * SIXTH`` with ``SIXTH = float32(1/6)``: XLA compiles
  the JAX source's ``sum / 6.0`` as that multiply, and a true divide differs
  by 1 ulp on some cells.

The kernel axes (jacobi_pallas.py:39-250):

* ``compute_unit``: ``vpu``, the left fold above; ``mxu`` and ``mxu_band``
  sum a level as ``(x-1 + x+1) + (ysum + zsum)``, the in-plane pairs
  contracted against the ``(2r+1)``-band (``_make_level_sum``,
  jacobi_pallas.py:498-526).  On the card both run one tensor-core
  contraction of a tile and its apron against the band's nonzeros
  (``mma.sync``, f32 accumulation); ``plane_band_unit`` still decides which
  of the two names a build reports.  With ``mxu_input="f32"`` each operand
  runs as three exact TF32 pieces, with ``"bf16"`` it is rounded to
  bfloat16 once a read.  The wrap, wavefront and z-ring kernels take it;
  the plane and slab kernels have no contraction form.
* ``f32_accumulate``: a bfloat16 block (``storage_dtype="bf16"``) is
  upcast at load, every level runs at f32, and the last store rounds once
  to bfloat16 (round to nearest even), as ``astype(bfloat16)`` does
  (jacobi_pallas.py:960-966).  Every form takes it.

Field dtypes: a float32 block computes at f32, a bfloat16 one under
``f32_accumulate`` at f32, and a float64 one at f64 (the JAX kernels'
``acc_dtype = block.dtype``, jacobi_pallas.py:920, :1068, :1267), every form
on the card through the float64 build of ``csrc/jacobi_wavefront.cu``.  At
f64 the mean multiplies by the float64 reciprocal of 6 (``SIXTH_F64``): XLA
compiles ``sum / 6.0`` at float64 into that multiply as well.  The
contraction needs an f32 accumulator, and bf16 storage narrows f32 fields
only, so both degrade to ``vpu`` / ``native`` on f64 fields with a warning
(the resolvers below).  A bfloat16 block without ``f32_accumulate`` (the
JAX kernels compute at bf16 then) is refused: ROADMAP.md queue 2.

Precedence of the axes is explicit > static (the JAX package's env knobs and
tune cache are ROADMAP.md queue 1 items 10-11); a structural degrade warns
with a ``RuntimeWarning``.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Tuple

import numpy as np
import torch

from stencil_tpu_torch.kernels import check_out, check_tensor, current_raw_stream, same_device

HOT_TEMP = 1.0
COLD_TEMP = 0.0

#: float32(1/6) as an exact Python float, so multiplying an f32 tensor by it
#: multiplies by 0x1.555556p-3 (the constant XLA substitutes for `/ 6.0`)
SIXTH = float(np.float32(1.0 / 6.0))

#: the float64 reciprocal of 6, 0x1.5555555555555p-3: XLA's constant for
#: `/ 6.0` at float64
SIXTH_F64 = 1.0 / 6.0


def sixth(dtype: torch.dtype) -> float:
    """The constant the mean multiplies by at a compute dtype."""
    return SIXTH_F64 if dtype == torch.float64 else SIXTH


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a block of ``dtype`` computes at on the kernels' forms (and
    their scratch holds): f32 for bfloat16 storage, else its own."""
    return torch.float32 if dtype == torch.bfloat16 else dtype

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

#: the row pitch, in cells, of a tensor-core build's shared planes
#: (``kMxuPitch``): 8 more than the tile's 64 columns, so that the fragment
#: loads and stores hit every bank once
MXU_PITCH = 72


# --- the kernel axes (jacobi_pallas.py:39-250) ---------------------------------

#: the compute-unit axis: ``vpu`` the left fold of six neighbours (the
#: default, bitwise-pinned); ``mxu`` and ``mxu_band`` the in-plane pairs
#: contracted against the band on the tensor cores
COMPUTE_UNITS = ("vpu", "mxu", "mxu_band")

#: the units that contract: every gate goes through ``unit_uses_mxu``
MXU_UNITS = ("mxu", "mxu_band")

#: the contraction operands' precision: ``f32`` (three exact TF32 pieces on
#: the card) or ``bf16`` (one round to nearest a read); the band's 0/1/2
#: entries are exact either way and the accumulator is f32
MXU_INPUTS = ("f32", "bf16")

#: the storage axis: ``native`` keeps the field's dtype, ``bf16`` stores
#: f32 fields as bfloat16 while the kernels accumulate at f32
STORAGE_DTYPES = ("native", "bf16")


def unit_uses_mxu(compute_unit: str) -> bool:
    """True for the units that contract on the tensor cores."""
    return compute_unit in MXU_UNITS


def _dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


def mxu_supported(compute_dtypes) -> bool:
    """The contraction forms need every field to compute at f32: the
    tensor cores accumulate at f32, so an f64 field would lose precision
    and an integer field has no contraction form.  A bf16 STORAGE field
    computes at f32 and qualifies."""
    return all(_dtype(dt) == torch.float32 for dt in compute_dtypes)


def bf16_supported(native_dtypes) -> bool:
    """bf16 storage narrows f32 fields only (one round to nearest of at
    most 2^-9 relative a store); f64 and integer fields stay native."""
    return all(_dtype(dt) == torch.float32 for dt in native_dtypes)


def _resolve_axis_value(request, choices, static: str):
    """Explicit > static: ``(value, source)`` before the structural gates."""
    if request not in (None, "auto"):
        if request not in choices:
            raise ValueError(f"unknown value {request!r} (one of {choices})")
        return request, "explicit"
    return static, "static"


def _degrade(msg: str) -> None:
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def resolve_compute_unit(request, compute_dtypes, where: str = "kernel", engine_ok: bool = True,
                         engine_why: str = "this engine has no contraction kernel"):
    """The compute unit of one kernel build: the explicit request, else
    ``vpu``; a contraction the kernels cannot serve (non-f32 compute dtypes,
    an engine without a contraction kernel) degrades to ``vpu`` with a
    warning.  Returns ``(unit, source)``."""
    val, source = _resolve_axis_value(request, COMPUTE_UNITS, "vpu")
    if unit_uses_mxu(val) and not (engine_ok and mxu_supported(compute_dtypes)):
        why = engine_why if not engine_ok else (
            f"fields compute at {[str(_dtype(d)).replace('torch.', '') for d in compute_dtypes]}, not f32")
        _degrade(f"compute_unit={val} ({source}) cannot engage for {where} ({why}); degrading to vpu")
        val, source = "vpu", source + "/degraded"
    return val, source


def resolve_storage_dtype(request, native_dtypes, where: str = "kernel", engine_ok: bool = True,
                          engine_why: str = "this engine accumulates at the storage dtype"):
    """The storage axis of one model build: the explicit request, else
    ``native``; ``bf16`` on non-f32 fields or on an engine without
    f32-accumulate kernels degrades to ``native`` with a warning.  Returns
    ``(storage, source)``."""
    val, source = _resolve_axis_value(request, STORAGE_DTYPES, "native")
    if val == "bf16" and not (engine_ok and bf16_supported(native_dtypes)):
        why = engine_why if not engine_ok else (
            f"fields are {[str(_dtype(d)).replace('torch.', '') for d in native_dtypes]}, not f32")
        _degrade(f"storage_dtype=bf16 ({source}) cannot engage for {where} ({why}); degrading to native")
        val, source = "native", source + "/degraded"
    return val, source


def resolve_mxu_input(request, compute_unit: str, where: str = "kernel"):
    """The contraction operands' precision: the explicit request, else
    ``f32``; ``bf16`` under a unit that does not contract has nothing to
    feed and degrades to ``f32`` with a warning.  Returns ``(value,
    source)``."""
    val, source = _resolve_axis_value(request, MXU_INPUTS, "f32")
    if val == "bf16" and not unit_uses_mxu(compute_unit):
        _degrade(f"mxu_input=bf16 ({source}) has no effect for {where}: the resolved compute unit is "
                 f"{compute_unit!r} (no contraction to feed); using f32")
        val, source = "f32", source + "/degraded"
    return val, source


def band_matrix(n: int, dtype=torch.float32, r: int = 1) -> torch.Tensor:
    """The ``(n, n)`` circulant ``(2r+1)``-band: ``(B @ v)[i] = sum over d
    = 1..r of v[(i-d) % n] + v[(i+d) % n]``, the roll pair as one matmul.
    Built as a sum of shift matrices, so a short axis keeps the double
    count of the rolls (n = 2, r = 1: entries 2)."""
    i = torch.arange(n)
    d = (i[:, None] - i[None, :]) % n
    out = torch.zeros((n, n), dtype=dtype)
    for off in range(1, r + 1):
        out = out + (d == off % n).to(dtype) + (d == (n - off) % n).to(dtype)
    return out


def band_tile_size(n: int, r: int = 1):
    """The band-tile granule of an axis of extent ``n`` under ``mxu_band``,
    or None: a divisor ``g`` of ``n`` with ``g >= 2r+1`` and ``3g < n``,
    the smallest multiple of 8 among them, else the smallest."""
    divs = [d for d in range(max(2 * r + 1, 2), n) if n % d == 0 and 3 * d < n]
    for d in divs:
        if d % 8 == 0:
            return d
    return divs[0] if divs else None


def band_tile_plan(plane_y: int, plane_z: int, r: int = 1):
    """``(gy, gz)`` granules of a (Y, Z) plane, or None when either axis
    admits none: the band form engages on the whole plane or not at all."""
    gy = band_tile_size(plane_y, r)
    gz = band_tile_size(plane_z, r)
    if gy is None or gz is None:
        return None
    return gy, gz


def band_wide_tile(g: int, r: int = 1, dtype=torch.float32) -> torch.Tensor:
    """The ``(g, 3g)`` wide tile ``[L | D | U]`` of the blocked band matmul:
    ``W[p, j] = 1`` iff ``1 <= |p + g - j| <= r``, column ``j`` addressing
    position ``j - g`` from the output block's start."""
    p = torch.arange(g)[:, None]
    j = torch.arange(3 * g)[None, :]
    d = (p + g - j).abs()
    return ((d >= 1) & (d <= r)).to(dtype)


def plane_band_unit(compute_unit: str, plane_y: int, plane_z: int, r: int = 1, where: str = "kernel") -> str:
    """The variant a build of one plane geometry reports: ``mxu_band`` on a
    plane that admits no band tile degrades to ``mxu`` with a warning.  On
    the card both run the same tile contraction over the band's nonzeros."""
    if compute_unit == "mxu_band" and band_tile_plan(plane_y, plane_z, r) is None:
        _degrade(f"compute_unit=mxu_band cannot tile a ({plane_y}, {plane_z}) plane at r={r} for {where} "
                 "(no admissible granule divides both extents); running the dense mxu form")
        return "mxu"
    return compute_unit


def _operand(c: torch.Tensor, mxu_input: str) -> torch.Tensor:
    """The contraction operand: ``c`` at f32, or rounded to bfloat16 once
    (to nearest even) and held at f32, which a product with the exact band
    entries leaves as it is."""
    return c.to(torch.bfloat16).float() if mxu_input == "bf16" else c


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 matmul at full f32 on the card too: TF32 is switched off (it
    is off by default) before the first product on a CUDA tensor."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a, b)


def _nbr_sum(c: torch.Tensor, mxu_input: str, r: int = 1) -> torch.Tensor:
    """``ysum + zsum`` of every ``(Y, Z)`` plane of ``c`` (the last two
    axes): the ``(2r+1)``-band contracted over y and over z, periodic, f32
    products and f32 accumulation (the dense circulants; at r = 1 the band
    form sums the same two values an axis, zeros adding exactly)."""
    Y, Z = c.shape[-2:]
    cc = _operand(c, mxu_input)
    by = band_matrix(Y, c.dtype, r).to(c.device)
    bz = band_matrix(Z, c.dtype, r).to(c.device)
    return _matmul(by, cc) + _matmul(cc, bz)


def plane_nbr_sum_host(c: torch.Tensor, compute_unit: str, r: int = 1, mxu_input: str = "f32") -> torch.Tensor:
    """The in-plane ``(2r+1)``-band neighbour sum of every ``(Y, Z)`` plane
    of ``c`` (its last two axes), periodic, under one compute unit
    (jacobi_pallas.py:475): ``vpu`` the roll chain, ``mxu`` the dense
    circulants ``B_Y @ c + c @ B_Z``, ``mxu_band`` the blocked form, each
    output granule block against the wide tile over its three neighbour
    blocks (a plane without a band tile takes the dense form, with
    ``plane_band_unit``'s warning).  The stream and mean-of-6 kernels'
    plain versions take their ``plane_nbr_sum`` from it."""
    *lead, Y, Z = c.shape
    if compute_unit == "vpu":
        out = torch.zeros_like(c)
        for off in range(1, r + 1):
            out = (out + torch.roll(c, off, -2) + torch.roll(c, -off, -2) + torch.roll(c, off, -1)
                   + torch.roll(c, -off, -1))
        return out
    unit = plane_band_unit(compute_unit, Y, Z, r, where="host")
    if unit == "mxu":
        return _nbr_sum(c, mxu_input, r)
    cc = _operand(c, mxu_input)
    gy, gz = band_tile_plan(Y, Z, r)
    wy = band_wide_tile(gy, r, c.dtype).to(c.device)
    wz = band_wide_tile(gz, r, c.dtype).to(c.device).T
    c3 = cc.reshape(*lead, Y // gy, gy, Z)
    ext = torch.cat([torch.roll(c3, 1, -3), c3, torch.roll(c3, -1, -3)], dim=-2)  # (..., nby, 3gy, Z)
    ysum = _matmul(wy, ext).reshape(*lead, Y, Z)
    c3z = cc.reshape(*lead, Y, Z // gz, gz)
    extz = torch.cat([torch.roll(c3z, 1, -2), c3z, torch.roll(c3z, -1, -2)], dim=-1)  # (..., Y, nbz, 3gz)
    zsum = _matmul(extz, wz).reshape(*lead, Y, Z)
    return ysum + zsum


def _check_compute_unit(compute_unit: str, acc_dtype) -> None:
    """A kernel reached with a contraction on a non-f32 accumulator is a
    wiring fault (the resolvers degrade such requests before a build)."""
    if compute_unit not in COMPUTE_UNITS:
        raise ValueError(f"unknown compute unit {compute_unit!r} (one of {COMPUTE_UNITS})")
    if unit_uses_mxu(compute_unit) and _dtype(acc_dtype) != torch.float32:
        raise AssertionError(
            "mxu contraction requires an f32 accumulator; the resolver should have degraded this "
            f"build (got {acc_dtype})"
        )


def mxu_flops_per_plane(plane_y: int, plane_z: int, compute_unit: str = "mxu", r: int = 1) -> int:
    """The JAX package's FLOP model of one level over one (Y, Z) plane
    (jacobi_pallas.py:541): dense ``2Y^2 Z + 2Y Z^2``; band ``6 gy Y Z + 6 gz
    Y Z``.  The card's contraction issues ``tensor_core_flops_per_cell``
    a tile cell instead."""
    if compute_unit == "mxu_band":
        plan = band_tile_plan(plane_y, plane_z, r)
        if plan is not None:
            gy, gz = plan
            return 6 * gy * plane_y * plane_z + 6 * gz * plane_y * plane_z
    return 2 * plane_y * plane_y * plane_z + 2 * plane_y * plane_z * plane_z


def tensor_core_flops_per_cell(mxu_input: str = "f32") -> int:
    """Tensor-core FLOPs the card's contraction issues a tile cell and level
    (apron cells included, the tile's average), each ``mma.sync`` counted at
    2 m n k.  A warp contracts a 16 x 16 quarter of the 32 x 64 tile as two
    16 x 8 outputs a sum: over y against the row chunks that hold rows
    r0 - 1 .. r0 + 16, over z against the column chunks that hold columns
    z0 - 1 .. z0 + 8, chunks inside the tile only.  f32 inputs: chunks of 8
    in m16n8k8 TF32 products, three pieces each; bf16 inputs: chunks of 16
    in m16n8k16 products (``csrc/jacobi_wavefront.cu``)."""
    rows, cols = WAVEFRONT_TILE_Y, WAVEFRONT_TILE_W
    kc, pieces = (8, 3) if mxu_input == "f32" else (16, 1)
    n = 0
    for r0 in range(0, rows, 16):
        for z0 in range(0, cols, 8):
            n += sum(1 for k0 in range(0, rows, kc) if k0 <= r0 + 16 and k0 + kc > r0 - 1)
            n += sum(1 for k0 in range(0, cols, kc) if k0 <= z0 + 8 and k0 + kc > z0 - 1)
    return n * pieces * 2 * 16 * 8 * kc // (rows * cols)


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


# --- the axes of one call ----------------------------------------------------------

#: the build of ``csrc/jacobi_wavefront.cu`` that the f32 ``vpu`` forms run
#: (and the mean-of-6 form); the others are ``library_name``'s
BASE_LIBRARY = "jacobi_wavefront"


def _axes(t: torch.Tensor, compute_unit: str, f32_accumulate: bool, mxu_input: str, plane_yz, where: str):
    """Validate one call's axes (jacobi_pallas.py:888-893): a float32 or
    float64 block, or a bfloat16 one under ``f32_accumulate``; a
    contraction only on the f32 accumulator.  Returns the unit the build
    reports (``plane_band_unit``), the effective operand precision (``f32``
    under ``vpu``), whether the block is stored as bfloat16 and whether it
    is float64."""
    if mxu_input not in MXU_INPUTS:
        raise ValueError(f"unknown mxu input {mxu_input!r} (one of {MXU_INPUTS})")
    if t.dtype == torch.bfloat16:
        if not f32_accumulate:
            raise TypeError(f"{where}: a bfloat16 block needs f32_accumulate=True (bf16 storage; the native "
                            "bf16 form is ROADMAP.md queue 2)")
    elif t.dtype == torch.float64:
        if f32_accumulate:
            raise TypeError(f"{where}: f32_accumulate takes bfloat16 blocks; a float64 block computes at f64")
    elif t.dtype != torch.float32:
        raise TypeError(f"{where}: the block must be torch.float32 or torch.float64, or torch.bfloat16 under "
                        f"f32_accumulate, got {t.dtype}")
    _check_compute_unit(compute_unit, torch.float32 if f32_accumulate else t.dtype)
    bf16, f64 = t.dtype == torch.bfloat16, t.dtype == torch.float64
    if not unit_uses_mxu(compute_unit):
        return compute_unit, "f32", bf16, f64
    return plane_band_unit(compute_unit, *plane_yz, where=where), mxu_input, bf16, f64


def library_name(compute_unit: str = "vpu", mxu_input: str = "f32", bf16: bool = False, f64: bool = False) -> str:
    """The build of ``csrc/jacobi_wavefront.cu`` a launch takes: the f32
    vpu one, ``_bf16`` for bf16 storage, ``_f64`` for float64 fields,
    ``_mxu`` / ``_mxu16`` for the tensor-core contraction on f32 / bf16
    operands (``kernels/build.py`` ``VARIANTS``)."""
    name = BASE_LIBRARY
    if unit_uses_mxu(compute_unit):
        name += "_mxu" if mxu_input == "f32" else "_mxu16"
    return name + ("_bf16" if bf16 else "_f64" if f64 else "")


def form_counter(compute_unit: str = "vpu", mxu_input: str = "f32", bf16: bool = False, f64: bool = False) -> str:
    """The wrapper attribute that counts a launch: ``launches`` (f32, vpu),
    ``bf16_launches`` (bf16 storage, vpu), ``f64_launches`` (float64
    fields), ``mxu_launches`` / ``mxu_bf16in_launches`` (the contraction on
    f32 / bf16 operands, either storage).  A launch counts once, under its
    unit's form when it contracts (``kernels/ledger.py`` ``FORMS``)."""
    if unit_uses_mxu(compute_unit):
        return "mxu_launches" if mxu_input == "f32" else "mxu_bf16in_launches"
    return "bf16_launches" if bf16 else "f64_launches" if f64 else "launches"


def _count(wrapper, counter: str) -> None:
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def _zero_counters(wrapper, forms) -> None:
    for counter in forms:
        setattr(wrapper, counter, 0)


#: the counters of the wrappers with a contraction form, and of those without
CONTRACTION_COUNTERS = ("launches", "bf16_launches", "f64_launches", "mxu_launches", "mxu_bf16in_launches")
STORAGE_COUNTERS = ("launches", "bf16_launches", "f64_launches")


def _lift(t: torch.Tensor) -> torch.Tensor:
    """A block at its compute dtype (``work_dtype``): bfloat16 upcast to
    f32, f32 and f64 as they are."""
    return t.to(work_dtype(t.dtype))


def _level(c: torch.Tensor, x_axis: int, compute_unit: str, mxu_input: str) -> torch.Tensor:
    """One level's six-neighbour numerator over working planes with rolls:
    the left fold x-1, x+1, y-1, y+1, z-1, z+1 (``vpu``), or ``(x-1 + x+1)
    + (ysum + zsum)`` (``mxu``, ``mxu_band``); y and z are the last two
    axes."""
    s = torch.roll(c, 1, x_axis) + torch.roll(c, -1, x_axis)  # x-1, x+1
    if unit_uses_mxu(compute_unit):
        return s + _nbr_sum(c, mxu_input)
    s = s + torch.roll(c, 1, -2)  # y-1
    s = s + torch.roll(c, -1, -2)  # y+1
    s = s + torch.roll(c, 1, -1)  # z-1
    return s + torch.roll(c, -1, -1)  # z+1


# --- jacobi_wrap_step ---------------------------------------------------------


def _check_k(block: torch.Tensor, k: int) -> None:
    check_tensor(block, "block", ndims=(3,))
    if not 1 <= k <= max(1, block.shape[0] // 2):
        raise ValueError(f"k={k} needs 1 <= k <= X//2 = {block.shape[0] // 2}")


def jacobi_wrap_step_plain(block: torch.Tensor, k: int = 1, compute_unit: str = "vpu",
                           f32_accumulate: bool = False, mxu_input: str = "f32") -> torch.Tensor:
    """``k`` periodic Jacobi levels over the whole (X, Y, Z) domain, with
    rolls; returns a new tensor of the block's dtype (a bfloat16 block is
    upcast once, run at f32 and rounded once at the end)."""
    _check_k(block, k)
    unit, mxu_input, _, _ = _axes(block, compute_unit, f32_accumulate, mxu_input, block.shape[1:], "wrap")
    X, Y, Z = block.shape
    hot_x, cold_x, in_r2 = sphere_params(X)
    d2 = yz_dist2_plane(0, 0, (Y, Z), block.shape, block.device)[None]
    x_g = torch.arange(X, device=block.device)[:, None, None]
    c = _lift(block)
    for _ in range(k):
        c = _clamp_spheres(_level(c, 0, unit, mxu_input) * sixth(c.dtype), d2, x_g, hot_x, cold_x, in_r2)
    return c.to(block.dtype)


def wrap_march_depths(k: int) -> list:
    """The depths of the marches one ``jacobi_wrap_step`` call of ``k``
    levels launches: ceil(k / ``WAVEFRONT_SUB_DEPTH``) of them, as even as
    can be, the deeper first (``wrap_depth`` in csrc/jacobi_wavefront.cu)."""
    q = -(-k // WAVEFRONT_SUB_DEPTH)
    return [k // q + (1 if j < k % q else 0) for j in range(q)]


def wrap_scratch_shape(shape, k: int, bf16: bool = False):
    """The scratch a ``jacobi_wrap_step`` call on the card takes (at the
    block's ``work_dtype``), or None for one march: an (X, Y, Z) buffer
    that the marches ping-pong through with the output; under bf16 storage
    the levels between marches stay f32, so every march but the last
    writes a scratch: one buffer for two marches, two (2, X, Y, Z) for
    more."""
    marches = len(wrap_march_depths(k))
    if marches == 1:
        return None
    return tuple(shape) if not bf16 else (min(marches - 1, 2),) + tuple(shape)


def jacobi_wrap_step(block: torch.Tensor, k: int = 1, out: torch.Tensor = None, *, compute_unit: str = "vpu",
                     f32_accumulate: bool = False, mxu_input: str = "f32") -> torch.Tensor:
    """``k`` Jacobi levels over the WHOLE periodic domain (the single-
    subdomain route) from one read of ``block``; returns ``out`` (a new
    tensor when None), ``block`` is left as it was.  The axes as
    ``jacobi_wrap_step_plain`` (jacobi_pallas.py:869-885).

    On CUDA: one call of the wavefront kernel's wrap form, its k levels as
    ``wrap_march_depths(k)`` marches; more than one pass through a scratch
    from torch's caching allocator (``wrap_scratch_shape``, f32 under bf16
    storage, else the block's dtype), the last march writing the returned
    tensor."""
    _check_k(block, k)
    if out is not None:
        check_out(out, block)
    if block.device.type == "cpu":
        res = jacobi_wrap_step_plain(block, k, compute_unit, f32_accumulate, mxu_input)
        return res if out is None else out.copy_(res)
    unit, mi, bf16, f64 = _axes(block, compute_unit, f32_accumulate, mxu_input, block.shape[1:], "wrap")
    X, Y, Z = block.shape
    hot_x, cold_x, in_r2 = sphere_params(X)
    out = torch.empty_like(block) if out is None else out
    shape = wrap_scratch_shape(block.shape, k, bf16)
    scratch = None if shape is None else block.new_empty(shape, dtype=work_dtype(block.dtype))
    entry, lib = _c_entry("stp_jacobi_wrap", library_name(unit, mi, bf16, f64))
    rc = entry(block.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
               X, Y, Z, k, hot_x, cold_x, in_r2, current_raw_stream(block.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_wrap_step")
    _count(jacobi_wrap_step, form_counter(unit, mi, bf16, f64))
    return out


#: calls of ``jacobi_wrap_step`` on CUDA, one a call whatever its marches,
#: counted by form (``form_counter``; plain-version calls do not count)
_zero_counters(jacobi_wrap_step, CONTRACTION_COUNTERS)


# --- jacobi_plane_step --------------------------------------------------------


def _check_plane(blocks, origins, yz_d2, out, f32_accumulate=False):
    check_tensor(blocks, "blocks", ndims=(3, 4))
    _axes(blocks, "vpu", f32_accumulate, "f32", (), "jacobi_plane_step")
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
        check_tensor(out, "out", ndims=(blocks.dim(),), dtype=blocks.dtype)
        if out.shape != blocks.shape or out.data_ptr() == blocks.data_ptr():
            raise ValueError("out must be a separate tensor of the blocks' shape")
        tensors.append(out)
    same_device(*tensors)
    return n, X, Y, Z


def jacobi_plane_step_plain(blocks, origins, yz_d2, global_size, out=None, f32_accumulate=False) -> torch.Tensor:
    """One Jacobi level over radius-1 shell-carrying block(s) ``(X, Y, Z)`` or
    ``(n, X, Y, Z)``; shell cells pass through.  ``origins`` are the global
    coordinates of each block's interior start, ``yz_d2`` each block's
    ``yz_dist2_plane`` over its interior.  Bfloat16 blocks under
    ``f32_accumulate``: the mean at f32, one rounding at the interior's
    store (jacobi_pallas.py:1492); float64 blocks at f64."""
    _check_plane(blocks, origins, yz_d2, out, f32_accumulate)
    single = blocks.dim() == 3
    c = blocks[None] if single else blocks
    org = origins[None] if single else origins
    d2 = (yz_d2[None] if single else yz_d2)[:, None]
    X = c.shape[1]
    gx = global_size[0]
    hot_x, cold_x, in_r2 = sphere_params(gx)
    core = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
    a = _lift(c)
    s = a[:, :-2, 1:-1, 1:-1] + a[:, 2:, 1:-1, 1:-1]  # x-1, x+1
    s = s + a[:, 1:-1, :-2, 1:-1]  # y-1
    s = s + a[:, 1:-1, 2:, 1:-1]  # y+1
    s = s + a[:, 1:-1, 1:-1, :-2]  # z-1
    s = s + a[:, 1:-1, 1:-1, 2:]  # z+1
    # raw plane p holds interior x = p - 1; torch's % is non-negative here
    x_g = (org[:, 0:1].long() + torch.arange(X - 2, device=c.device)) % gx
    val = _clamp_spheres(s * sixth(a.dtype), d2, x_g[:, :, None, None], hot_x, cold_x, in_r2)
    res = torch.empty_like(c) if out is None else (out[None] if single else out)
    res.copy_(c)
    res[core] = val
    return res[0] if single else res


def jacobi_plane_step(blocks, origins, yz_d2, global_size, out=None, *, f32_accumulate=False) -> torch.Tensor:
    """One Jacobi level over radius-1 shell-carrying block(s); returns
    ``out`` (a fresh tensor when None).  One CUDA launch serves all ``n``
    blocks, the port's counterpart of running the TPU kernel per shard: the
    plane form of ``csrc/jacobi_wavefront.cu``, a march of depth 1 that
    writes every cell of ``out`` (the shell copied through); its bf16 build
    for bfloat16 blocks, its float64 build for float64 ones."""
    n, X, Y, Z = _check_plane(blocks, origins, yz_d2, out, f32_accumulate)
    if blocks.device.type == "cpu":
        return jacobi_plane_step_plain(blocks, origins, yz_d2, global_size, out, f32_accumulate)
    bf16, f64 = blocks.dtype == torch.bfloat16, blocks.dtype == torch.float64
    gx = int(global_size[0])
    res = torch.empty_like(blocks) if out is None else out
    entry, lib = _c_entry("stp_jacobi_plane", library_name(bf16=bf16, f64=f64))
    rc = entry(blocks.data_ptr(), res.data_ptr(), origins.data_ptr(), yz_d2.data_ptr(),
               n, X, Y, Z, gx, *sphere_params(gx), current_raw_stream(blocks.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_plane_step")
    _count(jacobi_plane_step, form_counter(bf16=bf16, f64=f64))
    return res


#: kernel launches made by ``jacobi_plane_step``, by form (plain-version
#: calls do not count)
_zero_counters(jacobi_plane_step, STORAGE_COUNTERS)


# --- jacobi_slab_step ---------------------------------------------------------


def _check_slab(block, slabs, origins, yz_d2, out, f32_accumulate=False):
    check_tensor(block, "block", ndims=(3, 4))
    _axes(block, "vpu", f32_accumulate, "f32", (), "jacobi_slab_step")
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
        check_tensor(t, what, ndims=(block.dim() - 1,), dtype=block.dtype)
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
        check_tensor(out, "out", ndims=(block.dim(),), dtype=block.dtype)
        if out.shape != block.shape or out.data_ptr() == block.data_ptr():
            raise ValueError("out must be a separate tensor of the block's shape")
        tensors.append(out)
    same_device(*tensors)
    return n, X, Y, Z


def jacobi_slab_step_plain(block, xlo, xhi, ylo, yhi, zlo, zhi, origins, yz_d2, global_size,
                           out=None, f32_accumulate=False) -> torch.Tensor:
    """One Jacobi level over bare interior(s) ``(X, Y, Z)`` or ``(n, X, Y,
    Z)`` (no shell), the boundary neighbours taken from the six received face
    slabs: ``xlo``/``xhi`` ``(.., Y, Z)`` (the -x / +x neighbour's outermost
    plane), ``ylo``/``yhi`` ``(.., X, Z)`` and ``zlo``/``zhi`` ``(.., X, Y)``.
    ``origins`` are each block's global start, ``yz_d2`` its
    ``yz_dist2_plane`` over the (Y, Z) interior.  Returns ``out`` (a fresh
    tensor when None).  Bfloat16 block and slabs under ``f32_accumulate``:
    the mean at f32, one rounding at the store (jacobi_pallas.py:1360);
    float64 ones at f64.

    The JAX kernel takes the z slabs transposed, ``(Y, X)``; the port keeps
    them ``(X, Y)`` (a GPU has no lane axis to put x on)."""
    slabs = (xlo, xhi, ylo, yhi, zlo, zhi)
    _check_slab(block, slabs, origins, yz_d2, out, f32_accumulate)
    single = block.dim() == 3
    if single:
        block, origins, yz_d2, out = _batched(block, origins, yz_d2, out)
        slabs = _batched(*slabs)
    xlo, xhi, ylo, yhi, zlo, zhi = (_lift(t) for t in slabs)
    c = _lift(block)
    X = c.shape[1]
    gx = global_size[0]
    hot_x, cold_x, in_r2 = sphere_params(gx)
    s = torch.cat([xlo[:, None], c[:, :-1]], 1) + torch.cat([c[:, 1:], xhi[:, None]], 1)  # x-1, x+1
    s = s + torch.cat([ylo[:, :, None], c[:, :, :-1]], 2)  # y-1
    s = s + torch.cat([c[:, :, 1:], yhi[:, :, None]], 2)  # y+1
    s = s + torch.cat([zlo[..., None], c[..., :-1]], 3)  # z-1
    s = s + torch.cat([c[..., 1:], zhi[..., None]], 3)  # z+1
    x_g = (origins[:, 0:1].long() + torch.arange(X, device=c.device)) % gx
    val = _clamp_spheres(s * sixth(c.dtype), yz_d2[:, None], x_g[:, :, None, None], hot_x, cold_x, in_r2)
    res = val.to(block.dtype) if out is None else out.copy_(val)
    return res[0] if single else res


def jacobi_slab_step(block, xlo, xhi, ylo, yhi, zlo, zhi, origins, yz_d2, global_size,
                     out=None, *, f32_accumulate=False) -> torch.Tensor:
    """One Jacobi level over bare interior(s) from six received face slabs
    (the ``slab`` route's kernel); arguments and result as
    ``jacobi_slab_step_plain``.  One CUDA launch serves all ``n`` blocks:
    the slab form of ``csrc/jacobi_wavefront.cu``, a march of depth 1 whose
    level-0 fetch reads a face slab one cell outside the block; its bf16
    build for bfloat16 blocks, its float64 build for float64 ones."""
    slabs = (xlo, xhi, ylo, yhi, zlo, zhi)
    n, X, Y, Z = _check_slab(block, slabs, origins, yz_d2, out, f32_accumulate)
    if block.device.type == "cpu":
        return jacobi_slab_step_plain(block, *slabs, origins, yz_d2, global_size, out, f32_accumulate)
    bf16, f64 = block.dtype == torch.bfloat16, block.dtype == torch.float64
    gx = int(global_size[0])
    res = torch.empty_like(block) if out is None else out
    entry, lib = _c_entry("stp_jacobi_slab", library_name(bf16=bf16, f64=f64))
    rc = entry(block.data_ptr(), res.data_ptr(), *(t.data_ptr() for t in slabs), origins.data_ptr(),
               yz_d2.data_ptr(), n, X, Y, Z, gx, *sphere_params(gx), current_raw_stream(block.device.index))
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_slab_step")
    _count(jacobi_slab_step, form_counter(bf16=bf16, f64=f64))
    return res


#: kernel launches made by ``jacobi_slab_step``, by form (plain-version
#: calls do not count)
_zero_counters(jacobi_slab_step, STORAGE_COUNTERS)


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


def first_march_depth(m: int) -> int:
    """The depth of a wavefront call's first march: all m levels, or the
    deeper half of two (``first_depth`` in csrc/jacobi_wavefront.cu)."""
    return m if m <= WAVEFRONT_SUB_DEPTH else (m + 1) // 2


def mxu_smem_extra_bytes(m: int) -> int:
    """What the tensor-core contraction adds to a block's shared memory:
    its planes' rows pitched at ``MXU_PITCH`` cells instead of 64, over the
    first march's 2d planes of 32 rows (the counterpart of
    ``mxu_vmem_extra_bytes``, jacobi_pallas.py:650)."""
    return 2 * first_march_depth(m) * WAVEFRONT_TILE_Y * (MXU_PITCH - WAVEFRONT_TILE_W) * 4


def wavefront_smem_bytes(m: int, compute_unit: str = "vpu", itemsize: int = 4) -> int:
    """Shared memory of one block of the m-level wavefront kernel: 2m+1
    working planes (two per level below m, one incoming) and the d2 tile,
    each a (32 + 2m) x 64 tile of ``itemsize``-byte cells, and under a
    contraction unit ``mxu_smem_extra_bytes``.  A constant of m, the unit
    and the itemsize, so the CPU and the card plan the same depth.  The
    planes hold the levels at the working dtype: 4 bytes for f32 and bf16
    storage, 8 for f64 fields (the JAX package's ``ring_itemsize``)."""
    extra = mxu_smem_extra_bytes(m) if unit_uses_mxu(compute_unit) else 0
    return (2 * m + 2) * (WAVEFRONT_TILE_Y + 2 * m) * WAVEFRONT_TILE_W * itemsize + extra


def wavefront_smem_fits(m: int, compute_unit: str = "vpu", itemsize: int = 4) -> bool:
    return wavefront_smem_bytes(m, compute_unit, itemsize) <= SMEM_PER_BLOCK


def wavefront_auto_depth(n_min: int, compute_unit: str = "vpu", itemsize: int = 4) -> int:
    """The wavefront depth ``temporal_k="auto"`` plans for a smallest shard
    extent ``n_min`` (the JAX package's static plan, models/jacobi.py:336-347):
    the deepest m in ``[2, min(_WRAP_MAX_K, n_min // 4, n_min)]`` whose kernel
    fits under ``compute_unit`` at the working ``itemsize``, else 1 (at f64
    m <= 4: ROADMAP.md queue 3).  The n_min // 4 cap keeps the redundant
    shell traffic a small fraction of the shard."""
    depth_cap = min(_WRAP_MAX_K, max(1, n_min // 4), n_min)
    m = 1
    for cand in range(2, depth_cap + 1):
        if wavefront_smem_fits(cand, compute_unit, itemsize):
            m = cand
    return m


def march_smem_bytes(m: int, itemsize: int = 4) -> int:
    """Shared memory one block of an m-level call's first (the deeper)
    march asks on the card (``queue_smem`` in csrc/jacobi_wavefront.cu): 2d
    planes of the 32 x 64 tile and two rows of padding, d =
    ``first_march_depth(m)``, cells of the working ``itemsize`` (at f64, m =
    8: 132,160 bytes)."""
    d = first_march_depth(m)
    return (2 * d * WAVEFRONT_TILE_Y * WAVEFRONT_TILE_W + 2 * (WAVEFRONT_TILE_W + 4)) * itemsize


def _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, ring, z_valid=None,
                     compute_unit="vpu"):
    """Validate one wavefront call (its axes apart); returns (n, Xr, Yr,
    Zraw, zv)."""
    if alias:
        raise NotImplementedError(
            "alias=True (an in-place wavefront) is refused: blocks march along x "
            "independently, so a write can land before a neighbouring tile reads "
            "it; see ROADMAP.md (deliberate differences)"
        )
    check_tensor(raw, "raw", ndims=(3, 4))
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
    # the kernels' depth limit is the f32 model's (m <= 8, two marches of 4
    # levels): a float64 call's first march asks march_smem_bytes(m, 8) <=
    # 132,160 bytes; only the depth plan prices f64 cells at 8 bytes
    if not wavefront_smem_fits(m, compute_unit):
        raise ValueError(
            f"m={m} needs {wavefront_smem_bytes(m, compute_unit)} bytes of shared memory per block, "
            f"over the H100's {SMEM_PER_BLOCK}"
        )
    tensors = [raw, origin, d2]
    if z_slabs is not None:
        check_tensor(z_slabs, "z_slabs", ndims=(raw.dim(),), dtype=raw.dtype)
        want = (Xr, 2 * s_off, Yr) if single else (n, Xr, 2 * s_off, Yr)
        if tuple(z_slabs.shape) != want:
            raise ValueError(f"z_slabs shape {tuple(z_slabs.shape)}, want {want}")
        tensors.append(z_slabs)
    same_device(*tensors)
    return n, Xr, Yr, Zraw, zv


def _wavefront_levels(w, m, origin, d2, global_size, s_off, compute_unit="vpu", mxu_input="f32"):
    """``m`` Jacobi levels over the working planes ``w`` (n, Xr, Yr, W; f32 or f64)
    with rolls (or the band contraction, ``_level``): every axis wraps, and
    the wrapped cells are the ones the shell was sized to sacrifice.  Raw
    plane p sits at global x ``origin_x + p - s_off``; the sphere test
    follows it on shell planes too, since their intermediate levels feed
    valid cells."""
    gx = global_size[0]
    hot_x, cold_x, in_r2 = sphere_params(gx)
    Xr = w.shape[1]
    x_g = (origin[:, 0:1].long() + gx + torch.arange(Xr, device=w.device) - s_off) % gx
    x_g = x_g[:, :, None, None]
    d2 = d2[:, None]
    for _ in range(m):
        w = _clamp_spheres(_level(w, 1, compute_unit, mxu_input) * sixth(w.dtype), d2, x_g, hot_x, cold_x, in_r2)
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
                                      alias=False, z_slabs=None, z_valid=None, compute_unit="vpu",
                                      f32_accumulate=False, mxu_input="f32"):
    """``m`` Jacobi levels over s-shelled block(s) ``(Xr, Yr, Zr)`` or
    ``(n, Xr, Yr, Zr)`` (jacobi_pallas.py:983).  ``d2`` is
    ``yz_dist2_plane`` over each raw plane; ``z_slabs`` ``(.., Xr, 2s, Yr)``
    replace the z-shell columns ``[0, s)`` and ``[z_valid - s, z_valid)``
    (columns ``[z_valid, Zr)`` are dead).  Returns the new block(s), and with
    ``z_slabs`` also the outgoing slabs, at the block's dtype (the axes as
    ``jacobi_wrap_step_plain``; the contraction over the ``(Yr, Zr)``
    plane).  The interior ``[s, ext - s)`` of every axis is exact; shell
    cells are unspecified."""
    s_off = m if interior_offset is None else interior_offset
    _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, False, z_valid, compute_unit)
    unit, mxu_input, _, _ = _axes(raw, compute_unit, f32_accumulate, mxu_input, raw.shape[-2:], "wavefront")
    single = raw.dim() == 3
    if single:
        raw, origin, d2, z_slabs = _batched(raw, origin, d2, z_slabs)
    zv = raw.shape[-1] if z_valid is None else z_valid
    w = raw.to(work_dtype(raw.dtype), copy=True)
    if z_slabs is not None:
        zst = z_slabs.transpose(-1, -2)  # (n, Xr, Yr, 2s)
        w[..., 0:s_off] = zst[..., 0:s_off]
        w[..., zv - s_off : zv] = zst[..., s_off:]
    w = _wavefront_levels(w, m, origin, d2, global_size, s_off, unit, mxu_input)
    out = (w[0] if single else w).to(raw.dtype)
    if z_slabs is None:
        return out
    z_out = _emit(w, s_off, zv - 2 * s_off, s_off).to(raw.dtype)
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
                                alias=False, z_slabs=None, z_valid=None, out=None, z_out=None, *,
                                compute_unit="vpu", f32_accumulate=False, mxu_input="f32"):
    """``m`` Jacobi levels over s-shelled block(s) in ONE pass: the compute
    half of the temporally blocked multi-subdomain route.  Arguments and
    result as ``jacobi_shell_wavefront_step_plain``; ``alias=True`` is
    refused (see ``_check_wavefront``).  One CUDA launch serves all ``n``
    blocks; the output is ``out`` (and ``z_out``), fresh buffers when None,
    written on the valid region only."""
    s_off = m if interior_offset is None else interior_offset
    n, Xr, Yr, Zr, zv = _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, False,
                                         z_valid, compute_unit)
    if raw.device.type == "cpu":
        _outs(raw, z_slabs, out, z_out)  # checks the buffers
        return _plain_into(jacobi_shell_wavefront_step_plain(
            raw, m, origin, d2, global_size, interior_offset, alias, z_slabs, z_valid, compute_unit,
            f32_accumulate, mxu_input), out, z_out)
    unit, mi, bf16, f64 = _axes(raw, compute_unit, f32_accumulate, mxu_input, raw.shape[-2:], "wavefront")
    out, z_out = _outs(raw, z_slabs, out, z_out)
    _launch_wavefront(raw, out, origin, d2, z_slabs, z_out, n, Xr, Yr, Zr, zv, m, s_off,
                      Zr, global_size, False, library_name(unit, mi, bf16, f64))
    _count(jacobi_shell_wavefront_step, form_counter(unit, mi, bf16, f64))
    return out if z_out is None else (out, z_out)


#: kernel launches made by ``jacobi_shell_wavefront_step``, by form
_zero_counters(jacobi_shell_wavefront_step, CONTRACTION_COUNTERS)


def jacobi_zring_wavefront_step_plain(raw, m, origin, d2, global_size, z_slabs,
                                      interior_offset=None, alias=False, compute_unit="vpu",
                                      f32_accumulate=False, mxu_input="f32"):
    """``m`` Jacobi levels over block(s) ``(Xr, Yr, Zi)`` that carry their
    x/y shell in the array and no z shell (jacobi_pallas.py:1204): each plane
    is staged into the z-ring working plane ``(Yr, 128 + Zi)`` (interior at
    column 128, low halo just below, high halo wrapped to column 0, from
    ``z_slabs``), ``d2`` is ``zring_dist2_plane``.  Returns ``(out, z_out)``
    at the block's dtype (the axes as ``jacobi_wrap_step_plain``; the
    contraction over the working plane, whose wrap is the ring's seam);
    exact on the x/y interior and every z column."""
    s_off = m if interior_offset is None else interior_offset
    _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, True, None, compute_unit)
    unit, mxu_input, _, _ = _axes(raw, compute_unit, f32_accumulate, mxu_input,
                                  (raw.shape[-2], _ZRING_OFF + raw.shape[-1]), "zring")
    single = raw.dim() == 3
    if single:
        raw, origin, d2, z_slabs = _batched(raw, origin, d2, z_slabs)
    Zi = raw.shape[-1]
    w = torch.zeros(raw.shape[:-1] + (_ZRING_OFF + Zi,), dtype=work_dtype(raw.dtype), device=raw.device)
    w[..., _ZRING_OFF:] = raw
    zst = z_slabs.transpose(-1, -2)  # (n, Xr, Yr, 2s)
    w[..., _ZRING_OFF - s_off : _ZRING_OFF] = zst[..., 0:s_off]
    w[..., 0:s_off] = zst[..., s_off:]
    w = _wavefront_levels(w, m, origin, d2, global_size, s_off, unit, mxu_input)
    out = w[..., _ZRING_OFF:].to(raw.dtype).contiguous()
    z_out = _emit(w, _ZRING_OFF, _ZRING_OFF + Zi - s_off, s_off).to(raw.dtype)
    return (out[0], z_out[0]) if single else (out, z_out)


def jacobi_zring_wavefront_step(raw, m, origin, d2, global_size, z_slabs,
                                interior_offset=None, alias=False, out=None, z_out=None, *,
                                compute_unit="vpu", f32_accumulate=False, mxu_input="f32"):
    """``m`` Jacobi levels in ONE pass over z-interior-only block(s), the z
    halo taken from ``z_slabs`` and the next slabs emitted; arguments and
    result as ``jacobi_zring_wavefront_step_plain``.  One CUDA launch serves
    all ``n`` blocks; the outputs are ``out`` and ``z_out``, fresh buffers
    when None."""
    s_off = m if interior_offset is None else interior_offset
    n, Xr, Yr, Zi, _ = _check_wavefront(raw, m, origin, d2, global_size, z_slabs, s_off, alias, True, None,
                                        compute_unit)
    if raw.device.type == "cpu":
        _outs(raw, z_slabs, out, z_out)
        return _plain_into(jacobi_zring_wavefront_step_plain(
            raw, m, origin, d2, global_size, z_slabs, interior_offset, alias, compute_unit, f32_accumulate,
            mxu_input), out, z_out)
    unit, mi, bf16, f64 = _axes(raw, compute_unit, f32_accumulate, mxu_input, (Yr, _ZRING_OFF + Zi), "zring")
    out, z_out = _outs(raw, z_slabs, out, z_out)
    _launch_wavefront(raw, out, origin, d2, z_slabs, z_out, n, Xr, Yr, Zi, Zi + 2 * s_off, m,
                      s_off, _ZRING_OFF + Zi, global_size, True, library_name(unit, mi, bf16, f64))
    _count(jacobi_zring_wavefront_step, form_counter(unit, mi, bf16, f64))
    return out, z_out


#: kernel launches made by ``jacobi_zring_wavefront_step``, by form
_zero_counters(jacobi_zring_wavefront_step, CONTRACTION_COUNTERS)


def wavefront_marches(m: int) -> int:
    """Kernel launches one wavefront call of ``m`` levels makes: one march,
    or two (the first of ceil(m/2) levels) above ``WAVEFRONT_SUB_DEPTH``."""
    return 1 if m <= WAVEFRONT_SUB_DEPTH else 2


_ENTRY = None
_ENTRIES = {}
#: the other builds of the source (``library_name``), loaded at first use
_VARIANTS = {}


def _entry():
    """``(C entry, library)`` of ``stp_jacobi_wavefront`` in the f32 vpu
    build, built and loaded at the first launch."""
    global _ENTRY
    if _ENTRY is None:
        from stencil_tpu_torch.kernels import build

        lib = build.load(BASE_LIBRARY)
        _ENTRY = (lib.stp_jacobi_wavefront, lib)
    return _ENTRY


def _library(name: str):
    """The loaded build ``name`` of ``csrc/jacobi_wavefront.cu``
    (``library_name``), built at first use."""
    if name == BASE_LIBRARY:
        return _entry()[1]
    lib = _VARIANTS.get(name)
    if lib is None:
        from stencil_tpu_torch.kernels import build

        lib = _VARIANTS[name] = build.load(name)
    return lib


def _c_entry(name: str, library: str = BASE_LIBRARY):
    """``(C entry, library)`` of ``stp_jacobi_wrap``, ``stp_jacobi_plane``,
    ``stp_jacobi_slab``, ``stp_jacobi_wavefront`` or ``stp_mean6_march``
    in build ``library``, looked up at the first launch."""
    found = _ENTRIES.get((library, name))
    if found is None:
        lib = _library(library)
        found = _ENTRIES[(library, name)] = (getattr(lib, name), lib)
    return found


def _launch_wavefront(raw, out, origin, d2, z_slabs, z_out, n, Xr, Yr, Zraw, width, m, s_off,
                      d2_w, global_size, ring, library=BASE_LIBRARY):
    """One call of ``csrc/jacobi_wavefront.cu`` (build ``library``) over all
    ``n`` blocks; ``width`` is the logical plane width (z_valid, or Zi + 2s
    on the ring).  Two marches pass their intermediate level through an
    ``(n, Xr, Yr, width)`` scratch at the block's ``work_dtype`` from
    torch's caching allocator."""
    gx = int(global_size[0])
    hot_x, cold_x, in_r2 = sphere_params(gx)
    scratch = None
    if wavefront_marches(m) > 1:
        scratch = raw.new_empty((n, Xr, Yr, width), dtype=work_dtype(raw.dtype))
    entry, lib = _entry() if library == BASE_LIBRARY else _c_entry("stp_jacobi_wavefront", library)
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


#: the storage values a plan takes: the axis's, and ``f64`` for float64 fields
PLAN_STORAGES = STORAGE_DTYPES + ("f64",)


def _plan_axes(plane_yz, compute_unit, mxu_input, storage, where):
    """The build a plan reports: ``(library, {compute_unit, mxu_input,
    storage})`` with the unit ``plane_band_unit`` names and the operand
    precision in effect; ``storage="f64"`` plans the float64 build (vpu)."""
    for value, choices, what in ((compute_unit, COMPUTE_UNITS, "compute unit"), (mxu_input, MXU_INPUTS, "mxu input"),
                                 (storage, PLAN_STORAGES, "storage dtype")):
        if value not in choices:
            raise ValueError(f"unknown {what} {value!r} (one of {choices})")
    mxu = unit_uses_mxu(compute_unit)
    _check_compute_unit(compute_unit, torch.float64 if storage == "f64" else torch.float32)
    unit = plane_band_unit(compute_unit, *plane_yz, where=where) if mxu else compute_unit
    mi = mxu_input if mxu else "f32"
    return (library_name(unit, mi, storage == "bf16", storage == "f64"),
            {"compute_unit": unit, "mxu_input": mi, "storage": storage})


def jacobi_wavefront_launch(shape, m: int, interior_offset=None, ring: bool = False, slabs: bool = False,
                            z_valid=None, compute_unit: str = "vpu", mxu_input: str = "f32",
                            storage: str = "native") -> dict:
    """The launches a wavefront call over blocks of ``shape`` (``(Xr, Yr,
    Z)`` or ``(n, Xr, Yr, Z)``) makes on the card, without making them:
    ``form`` ("z-ring", "shell z-slab" or "shell"), kernel ``launches`` a call
    (marches) and the first march's ``depth``, blocks an SM the occupancy
    calculator allows, the grid's blocks and its ``waves`` (blocks over the
    blocks resident at once), the x chunking, the shared memory and threads a
    block asks and the tiles along z and y (fields as
    ``WAVEFRONT_PLAN_FIELDS``); and the build's ``compute_unit``,
    ``mxu_input`` and ``storage``."""
    n = 1 if len(shape) == 3 else shape[0]
    Xr, Yr, Z = shape[-3:]
    s_off = m if interior_offset is None else interior_offset
    width = Z + 2 * s_off if ring else (Z if z_valid is None else int(z_valid))
    plane = (Yr, _ZRING_OFF + Z) if ring else (Yr, Z)
    name, axes = _plan_axes(plane, compute_unit, mxu_input, storage, "zring" if ring else "wavefront")
    lib = _library(name)
    info = (ctypes.c_int * len(WAVEFRONT_PLAN_FIELDS))()
    rc = lib.stp_jacobi_wavefront_plan(n, Xr, Yr, Z, width, m, s_off, int(ring), int(ring or slabs), info)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, "jacobi_wavefront_launch")
    plan = dict(zip(WAVEFRONT_PLAN_FIELDS, info))
    plan["form"] = _WAVEFRONT_FORMS[plan["form"]]
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    plan.update(axes)
    return plan


#: the fields of ``jacobi_wrap_launch``, in the order the C entry
#: ``stp_jacobi_wrap_plan`` fills them
WRAP_PLAN_FIELDS = ("launches", "depth", "blocks_per_sm", "sms", "blocks", "xchunk", "nchunks", "smem_bytes",
                    "threads", "tiles_z", "tiles_y")


def jacobi_wrap_launch(shape, k: int, compute_unit: str = "vpu", mxu_input: str = "f32",
                       storage: str = "native") -> dict:
    """The launches a ``jacobi_wrap_step`` call of ``k`` levels over an
    ``(X, Y, Z)`` domain makes on the card, without making them: kernel
    ``launches`` a call (marches) and their ``depths``, and of the first
    march its ``depth``, blocks an SM the occupancy calculator allows, SMs,
    the grid's blocks and its ``waves``, the x chunking, the shared memory
    and threads a block asks and the tiles along z and y (fields as
    ``WRAP_PLAN_FIELDS``); and the build's ``compute_unit``, ``mxu_input``
    and ``storage``."""
    X, Y, Z = shape
    name, axes = _plan_axes((Y, Z), compute_unit, mxu_input, storage, "wrap")
    lib = _library(name)
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
    plan.update(axes)
    return plan


#: the fields of ``jacobi_plane_launch`` and ``jacobi_slab_launch``, in the
#: order the C entries ``stp_jacobi_plane_plan`` / ``stp_jacobi_slab_plan``
#: fill them
ONELEVEL_PLAN_FIELDS = ("blocks_per_sm", "sms", "blocks", "xchunk", "nchunks", "smem_bytes", "threads",
                        "tiles_z", "tiles_y")


def _onelevel_launch(plan_entry: str, shape, storage: str) -> dict:
    n = 1 if len(shape) == 3 else shape[0]
    X, Y, Z = shape[-3:]
    name, axes = _plan_axes((Y, Z), "vpu", "f32", storage, plan_entry)
    lib = _library(name)
    info = (ctypes.c_int * len(ONELEVEL_PLAN_FIELDS))()
    rc = getattr(lib, plan_entry)(n, X, Y, Z, info)
    if rc:
        from stencil_tpu_torch.kernels import build

        build.check(lib, rc, plan_entry)
    plan = dict(zip(ONELEVEL_PLAN_FIELDS, info))
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    plan["storage"] = axes["storage"]
    return plan


def jacobi_plane_launch(shape, storage: str = "native") -> dict:
    """The launch a ``jacobi_plane_step`` call over shell-carrying blocks of
    ``shape`` (``(X, Y, Z)`` or ``(n, X, Y, Z)``) makes on the card, without
    making it: one kernel, a march of depth 1; blocks an SM the occupancy
    calculator allows, SMs, the grid's blocks and its ``waves``, the x
    chunking, the shared memory and threads a block asks and the tiles along
    z and y (fields as ``ONELEVEL_PLAN_FIELDS``), and the build's
    ``storage``."""
    return _onelevel_launch("stp_jacobi_plane_plan", shape, storage)


def jacobi_slab_launch(shape, storage: str = "native") -> dict:
    """The launch a ``jacobi_slab_step`` call over bare interiors of
    ``shape`` makes on the card, as ``jacobi_plane_launch``."""
    return _onelevel_launch("stp_jacobi_slab_plan", shape, storage)
