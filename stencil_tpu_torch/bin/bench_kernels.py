"""Device times of the Jacobi wrap, wavefront, plane and slab kernels, the
stream wavefront kernel, blend_slab, the z-shell pair, the mean6 wavefront
and blend_slab_dynamic at the main path's shapes, in a form that times an
older tree of the port as well.

    python -m stencil_tpu_torch.bin.bench_kernels [--out FILE] [--only SECTION ...]
    PYTHONPATH=<other tree> python <this file> --out FILE   # that tree's kernels

It calls only what the port has had since these kernels landed
(``jacobi_wrap_step``, ``jacobi_zring_wavefront_step``, ``jacobi_shell_wavefront_step``,
``jacobi_plane_step``, ``jacobi_slab_step``, ``stream_wavefront_pass``,
``blend_slab``, ``pack_zshell_pallas``, ``unpack_zshell_pallas``,
``mean6_shell_wavefront_step``, ``blend_slab_dynamic``, ``AstarothSim``;
``stream_plane_pass`` and the fused forms only where the tree has them),
so two trees
timed in turn on one card compare like with like.  It prints, and writes to
``--out``, one JSON object with the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them)
and (``--only`` keeps the sections named):

* ``jacobi_wrap``: ``jacobi_wrap_step`` over one 512^3 f32 domain at k = 8
  (the wrap route's call) and k = 1: device ms a call (torch.profiler over
  10 calls, as below: a call may launch several kernels), CUDA-event ms a
  call, the bound (one read and one write of the domain over 3.35 TB/s,
  whatever k) and, where the tree has ``jacobi_wrap_launch``, the plan;
* ``jacobi_wavefront``: the Jacobi wavefront kernels at the three shapes of
  ``Jacobi3D`` on 2x2x2 that take them, m = 8: the z-ring form at (8, 272,
  272, 256) with z slabs (512^3, ``pallas_path="auto"``), the shell form at
  (8, 272, 272, 272) with z slabs (``z_ring=False``) and without (511^3,
  ``auto``): device ms a call (torch.profiler over 10 calls, each kernel's
  mean over the launches its trace holds times its launches a call; a call
  may launch more than one kernel), CUDA-event ms a call and the bound (the
  bytes a call must move over 3.35 TB/s);
* ``jacobi_plane``: ``jacobi_plane_step`` over the shell route's blocks on
  2x2x2 at 512^3, (8, 258, 258, 258) f32 into ``out=``; ``jacobi_slab``:
  ``jacobi_slab_step`` over the slab route's, (8, 256, 256, 256) f32 and six
  face slabs (8, 256, 256): each its device ms a call (torch.profiler over
  10 calls), CUDA-event ms a call, the bound (one read and one write of the
  blocks, the slabs, d2 and the origins over 3.35 TB/s) and, where the tree
  has ``jacobi_plane_launch`` / ``jacobi_slab_launch``, the plan;
* ``wavefront``: ``stream_wavefront_pass`` of the Astaroth kernel on one
  field, m = 3, z slabs, at (1, 518, 518, 518) (``AstarothSim(512^3,
  schedule="wavefront")`` on one subdomain) and (8, 262, 262, 262) (its
  ``auto`` route on 2x2x2): device ms a launch (torch.profiler over 10
  launches, the mean of the launches its trace holds) and CUDA-event ms a
  call;
* ``blend``: ``blend_slab`` at the per-step route's shapes, 8 blocks of
  262^3 f32 and depth-3 slabs, each axis's low and high write in turn: device
  ms a launch back to back (20 launches), the same for
  ``narrow(...).copy_(slab)``, and the host µs a call of each (100 calls,
  no synchronize between);
* ``zshell``: ``pack_zshell_pallas`` at z0 = 3 and 256 and
  ``unpack_zshell_pallas`` at z0 = 0 and 259 (the windows the packed routes
  send and receive), over 8 blocks of 262^3 f32, depth 3: device ms a launch
  back to back (hot in L2; 20 launches) and cold (each launch after a 64 MB
  scratch write that flushes the L2; 10 launches), the CUDA-event ms a call
  back to back, the same device times of ``copy_`` between the window and
  the buffer (the same function in one PyTorch call), the byte bound (the
  window read once and written once over 3.35 TB/s) and the sector floor:
  the 32-byte sectors of the block that the window's runs touch
  (``zshell_sector_bytes``), read by a pack beside the buffer's bytes, and
  filled and written back by an unpack beside the buffer read;
* ``mean6``: ``mean6_shell_wavefront_step`` over one 518^3 f32 block (the
  Astaroth proxy's 512^3 subdomain with a radius-3 shell), s = 3 at m = 3
  and s = 8 at m = 8, into ``out=``: device ms a call (torch.profiler over 10
  calls; a call may launch two kernels), CUDA-event ms a call, the bound
  (the block read once and its interior written once over 3.35 TB/s) and,
  where the tree has ``mean6_wavefront_launch``, the plan;
* ``blend_dynamic``: ``blend_slab_dynamic`` at the uneven 511^3 wavefront's
  +axis halo writes, 8 blocks of 272^3 f32 and slabs of width 8, and at the
  511^3 ``shell`` route's, 8 blocks of 258^3 and slabs of width 1 (keys
  "<axis> shell"), at per-block offsets (the last block's differ), each
  axis in turn: device ms a launch back to back (20 launches), CUDA-event
  ms a call and the bound (the slab read once and written once, and the
  offsets);
* ``fused``: the stream plane kernel (#7) over 8 Astaroth fields and the
  stream wavefront kernel (#8, m = 3, one field, the plain form) at the
  phase-16 shapes of ``chip_smoke.py``, 8 blocks of 262^3 f32 (512^3 on
  2x2x2, shell 3), in their array forms and, where the tree has them
  (``fused_shell``), their fused forms, which read the shell from the
  x/y/z buffers ``fused_shell_exchange`` returns: device ms a call
  (torch.profiler over 10 calls), CUDA-event ms a call and the bound (each
  cell read once, from the block or a buffer, and the output written once,
  over 3.35 TB/s: the same for both forms; the wavefront's output is its
  valid region);
* ``direct``: ``AstarothSim(512^3, num_quantities=8, schedule="per-step",
  exchange_route="direct")`` on 2x2x2: ms/iter (the better of two runs of 24
  iterations), and from 24 iterations under torch.profiler the device ms an
  iteration of each kernel, of ``blend_slab``'s kernels together, and the
  device's idle share;
* ``jacobi_bf16``: the bf16-storage twin of every Jacobi row above (the
  wrap kernel at k = 8 and 1, the three wavefront forms, the plane and slab
  kernels), bfloat16 blocks and slabs under ``f32_accumulate``, timed the
  same way, each beside its bound at 2 bytes a cell (d2 and the origins at
  4);
* ``jacobi_mxu``: the tensor-core forms (``compute_unit="mxu_band"``) of
  the wrap kernel (k = 8) and the three wavefront forms, on f32 and on bf16
  operands, timed the same way, each beside its bound: the larger of its
  bytes over 3.35 TB/s and its tensor-core FLOPs
  (``tensor_core_flops_per_cell`` a cell and level) over the dense peak,
  495 TFLOP/s TF32 or 989 bf16;
* ``mxu_vs_vpu``: ``bench.py``'s ``mxu_vs_vpu_ab`` on the card: the wrap
  kernel over one 512^3 domain at 0.5, k = 8, under ``vpu``, ``mxu``,
  ``mxu_band`` and ``mxu_band`` on bf16 operands (``mxu_band+bf16in``),
  the legs alternating over 5 reps of 10 calls (CUDA events; rep 0 dropped,
  the median kept): ms a dispatch, Mcells/s, device ms a call, the bound and
  the speed-ups against ``vpu``, under ``bench.py``'s keys;
* ``stream_bf16`` / ``stream_f64``: the stream kernels' bf16-storage and
  float64 builds beside their float32 build on the same seeded data, at the
  main path's shapes: #6 ``stream_wrap_pass`` over 8 Astaroth fields of
  512^3 at k = 1 (one launch; bf16 to bf16) and k = 8 (the first launch
  into a float32 set and the last out of one, under bf16); #7
  ``stream_plane_pass`` over 8 fields of (8, 262^3), shell 3, in the array
  and fused forms; #8 ``stream_wavefront_pass`` of one field at m = 3 with
  z slabs at (1, 518^3), and in the fused form at (8, 262^3): per form its
  device ms a call (torch.profiler over 10 calls), CUDA-event ms a call,
  the plan (#8), the bound (the larger of the bytes a call must move at the
  storage itemsize over 3.35 TB/s and its operations over 67 TFLOP/s at
  float32 or 34 at float64, H100 SXM outside the tensor cores) and the
  ptxas registers and spill bytes of each kernel the library holds;
* ``jacobi_f64``: the float64 build of every Jacobi row (#1-#5) beside the
  f32 form on the same seeded data, in one process: the wrap kernel at k =
  8 and 1, the three wavefront forms at m = 8 (the f32 rows' shapes, two
  marches) and at the float64 route's m = 4 (8, 264, 264, 256) / (8,
  264^3) (one march), the plane and slab kernels: device ms a call, CUDA-event
  ms a call, the plan and the bound (the larger of the bytes at 8 bytes a
  cell, d2 and the origins at 4, over 3.35 TB/s and seven operations a
  cell-level over 34 TFLOP/s f64, H100 SXM outside the tensor cores; the
  f32 rows at 4 bytes and 67 TFLOP/s), and the registers, spill bytes and
  shared memory of each kernel of the float64 library (``-Xptxas -v``);
* ``mean6_dtypes``: the mean-of-6 kernels #17 and #18 under bf16 storage
  (``f32_accumulate``) and at float64 beside float32, over one 518^3 block
  (the Astaroth proxy's 512^3 subdomain, shell 3): the wavefront at m = 3
  (s = 3) and m = 8 (s = 8) and one plane level (lo = hi = 3), into
  ``out=``: device ms a call, CUDA-event ms a call, the plan (#17) and the
  bound (the larger of the bytes at the storage itemsize over 3.35 TB/s and
  six operations a cell-level over 67 TFLOP/s f32 or 34 f64), and the
  registers and spill bytes of the bf16 and float64 libraries' mean-of-6
  kernels;
* ``stream_mxu``: the tensor-core contraction form of #6-#8, #17 and #18
  beside its ``vpu`` form on the same seeded data, f32 operands under
  ``compute_unit="mxu"`` and bf16 operands under ``"mxu_band"`` (the two
  runs of ``AstarothSim`` it serves), at the main path's shapes: #6 over 8
  Astaroth fields (``_kernel_mxu``) of 512^3 at k = 1, #7 over 8 fields of
  (8, 262^3), #8 of one field at m = 3 with z slabs at (1, 518^3), #17 at m
  = 3 and #18 over one 518^3 block: device ms a call (torch.profiler over 10
  calls), CUDA-event ms a call, the vpu form's two, the plan (#8, #17) and
  the bound (``jacobi_bound``: the larger of the bytes over 3.35 TB/s, the
  f32 operations over 67 TFLOP/s and the tile contraction's tensor-core
  FLOPs over 495 TFLOP/s TF32 or 989 bf16).  It calls ``compute_unit=``
  on #6-#8, #17 and #18, so it times a tree from this one on;
* ``stream_fused_mxu``: the fused forms of #7 and #8 under the contraction
  (f32 operands under ``mxu``, bf16 under ``mxu_band``) at the main path's
  shapes of the 2x2x2 fused routes, #7 over 8 Astaroth fields of (8,
  262^3) and #8 of one field at m = 3, each with random (8, 6, 262, 262)
  shell buffers a field: device ms a call (torch.profiler over 10 calls),
  CUDA-event ms a call, the vpu fused form's and the array contraction
  form's two on the same blocks, the plan (#8) and the bound
  (``jacobi_bound`` at the fused rows' bytes: each cell read once, from the
  block or a buffer, and the output written once).  It calls the fused
  forms under a unit, so it times a tree from this one on.

A CUDA card is required; it exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from stencil_tpu_torch.kernels import toolchain

N = 512
ITERS = 24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
F64_FLOPS_PER_S = 34e12  # H100 SXM, f64 outside the tensor cores
#: H100 SXM dense tensor-core peaks, by operand type
TENSOR_FLOPS_PER_S = {"f32": 495e12, "bf16": 989e12}  # TF32 and bf16
#: the kernels that blend_slab launches, by name: the slab unpack of
#: csrc/pack.cu (or, in a tree before it, a one-thread-a-cell scatter)
BLEND_KERNEL_NAMES = ("blend_slab_kernel<", "slab_rows_kernel<", "slab_cells_kernel<")


def _sync() -> None:
    torch.cuda.synchronize()


def _seeded(shape, seed: int, dev) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32)).to(dev)


def _profile(fn, calls: int, per_call: int = None):
    """``fn`` called ``calls`` times under torch.profiler after one warm-up
    call: (device ms a call by CUDA kernel name, wall ms a call).  A
    kernel's ms a call is its mean time over the launches the trace holds
    times its launches a call (the launches held over ``calls``); where the
    caller knows a call's kernel launches (``per_call``), the mean over all
    launches held times that, spread over the kernels by their time.  The
    trace can drop launches, so the self time is not divided by ``calls``
    (whole traces held one of a wrap call's two same-named marches,
    PERF.md).  A trace that holds no launch is taken again, twice at
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        _sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            _sync()
            wall = (time.perf_counter() - t0) * 1e3 / calls
        kept = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        if kept:
            held = sum(e.count for e in kept)
            return {e.key[:96]: e.self_device_time_total / 1e3 * (per_call / held if per_call else
                                                                  max(1, round(e.count / calls)) / e.count)
                    for e in kept}, wall
    raise RuntimeError("torch.profiler held no kernel launch in three traces")


def _cuda_ms(fn, reps: int = 7, inner: int = 5) -> float:
    """Median CUDA-event ms a call over ``reps`` reps of ``inner`` calls, after
    a dropped warm-up rep."""
    times = []
    for _ in range(reps + 1):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times[1:])


def _host_us(fn, calls: int = 100) -> float:
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    _sync()
    return dt / calls * 1e6


def zshell_sector_bytes(shape, itemsize: int, z0: int, depth: int, base: int = 0) -> int:
    """Bytes of the 32-byte sectors that the z window ``[z0, z0+depth)`` of
    ``(..., X, Y, Z)`` blocks at address ``base`` touches: each (x, y) run of
    ``depth`` cells fills part of one sector or more."""
    rows = int(np.prod(shape[:-1]))
    start = base + (np.arange(rows, dtype=np.int64) * shape[-1] + z0) * itemsize
    return int(((start + depth * itemsize - 1) // 32 - start // 32 + 1).sum()) * 32


def blend_ms(kernels_ms: dict) -> dict:
    """The entries of a profile (name: device ms) that are blend_slab's."""
    return {k: v for k, v in kernels_ms.items() if any(n in k for n in BLEND_KERNEL_NAMES)}


def wavefront_bytes(n, Xr, Yr, W, m, s_off, slabs, itemsize: int = 4) -> int:
    """Bytes one Jacobi wavefront call over n blocks must move (as
    ``chip_smoke.py``): each cell its m levels reach read once, with d2 over
    those rows and columns and the origins, the valid region written once;
    W is the logical plane width, whose s outer columns a side come from the
    slabs when they are given.  Cells at ``itemsize`` bytes (2 under bf16
    storage), d2 and the origins at 4."""
    e = s_off - m
    Xa, Ya, Wa = Xr - 2 * e, Yr - 2 * e, W - 2 * e
    Xi, Yi, Wi = Xr - 2 * s_off, Yr - 2 * s_off, W - 2 * s_off
    reads = Xa * Ya * (Wa - 2 * m if slabs else Wa)
    writes = Xi * Yi * Wi
    if slabs:
        reads += Xa * 2 * m * Ya
        writes += Xi * 2 * s_off * Yi
    return n * ((reads + writes) * itemsize + (Ya * Wa + 3) * 4)


def stream_wavefront_bytes(n, Xr, Yr, W, m, s_off, slabs, fields, itemsize: int = 4) -> int:
    """Bytes one stream wavefront call must move (``wavefront_bytes``
    without the d2 plane): per field and block, the cells its m levels reach
    read once, the valid region written once, at ``itemsize``; the
    origins."""
    e = s_off - m
    Xa, Ya, Wa = Xr - 2 * e, Yr - 2 * e, W - 2 * e
    Xi, Yi, Wi = Xr - 2 * s_off, Yr - 2 * s_off, W - 2 * s_off
    reads = Xa * Ya * (Wa - 2 * m if slabs else Wa)
    writes = Xi * Yi * Wi
    if slabs:
        reads += Xa * 2 * m * Ya
        writes += Xi * 2 * s_off * Yi
    return fields * n * (reads + writes) * itemsize + n * 12


def jacobi_bound(nbytes: int, cell_levels: int, compute_unit: str = "vpu", mxu_input: str = "f32",
                 f64: bool = False) -> dict:
    """The least time a Jacobi call could take: the larger of its bytes over
    3.35 TB/s, its f32 operations over 67 TFLOP/s (seven a cell-level: six
    adds and a multiply; four beside a contraction; at float64 seven over
    34 TFLOP/s) and, for a contraction unit, its tensor-core FLOPs
    (``tensor_core_flops_per_cell`` of each cell-level) over the dense peak
    of its operands' type."""
    mxu = compute_unit != "vpu"
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    if f64:
        times["f64 operations"] = cell_levels * 7 / F64_FLOPS_PER_S * 1e3
    else:
        times["f32 operations"] = cell_levels * (4 if mxu else 7) / F32_FLOPS_PER_S * 1e3
    tc = 0
    if mxu:  # (a tree before the axes times its vpu rows through here too)
        from stencil_tpu_torch.ops import jacobi_kernels as jk

        tc = cell_levels * jk.tensor_core_flops_per_cell(mxu_input)
        times["tensor-core operations"] = tc / TENSOR_FLOPS_PER_S[mxu_input] * 1e3
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": "bytes" if by == "bytes" else "operations", "bound_of": by,
            "tensor_core_flops": tc}


#: a storage value's block dtype and itemsize (``f64``: float64 fields)
_STORAGE = {"native": (torch.float32, 4), "bf16": (torch.bfloat16, 2), "f64": (torch.float64, 8)}


def _axes_kw(storage: str, unit: str, mxu_input: str) -> dict:
    """The kernel-axis keywords of a call, none for the f32 vpu form (so that
    a tree from before the axes runs it) nor for float64 blocks."""
    kw = {}
    if storage == "bf16":
        kw["f32_accumulate"] = True
    if unit != "vpu":
        kw.update(compute_unit=unit, mxu_input=mxu_input)
    return kw


def jacobi_wrap_times(dev, storage: str = "native", unit: str = "vpu", mxu_input: str = "f32",
                      ks=(8, 1)) -> dict:
    """The wrap kernel over one 512^3 domain at each k of ``ks``, in one
    form of the kernel axes (bf16 blocks under ``storage="bf16"``)."""
    from stencil_tpu_torch.ops import jacobi_kernels as jk

    kw = _axes_kw(storage, unit, mxu_input)
    dt, item = _STORAGE[storage]
    block = _seeded((N, N, N), 40, dev).to(dt)
    plan = getattr(jk, "jacobi_wrap_launch", None)
    axes = {} if storage == "native" and unit == "vpu" else {"compute_unit": unit, "mxu_input": mxu_input,
                                                             "storage": storage}
    out = {}
    for k in ks:
        def call(k=k):
            return jk.jacobi_wrap_step(block, k, **kw)

        prof, _ = _profile(call, 10, per_call=len(jk.wrap_march_depths(k)))
        out[f"k={k}"] = {"device_ms": sum(prof.values()), "kernels": prof, "ms": _cuda_ms(call, inner=2),
                         **jacobi_bound(2 * N ** 3 * item, N ** 3 * k, unit, mxu_input, storage == "f64"),
                         "launch": None if plan is None else plan((N, N, N), k, **axes)}
    del block
    torch.cuda.empty_cache()
    return out


def jacobi_wavefront_times(dev, storage: str = "native", unit: str = "vpu", mxu_input: str = "f32",
                           m: int = 8) -> dict:
    from stencil_tpu_torch.ops import jacobi_kernels as jk

    kw = _axes_kw(storage, unit, mxu_input)
    dt, item = _STORAGE[storage]
    half = N // 2
    r = half + 2 * m
    out = {}
    for label, n_glob, Z, ring, slabs in (("zring", N, half, True, True), ("zslab", N, r, False, True),
                                          ("plain_511", N - 1, r, False, False)):
        gs = (n_glob,) * 3
        raw = _seeded((8, r, r, Z), 30, dev).to(dt)
        org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)],
                           dtype=torch.int32, device=dev)
        zs = _seeded((8, r, 2 * m, r), 31, dev).to(dt) if slabs else None
        if ring:
            d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - m, int(o[2]), m, r, Z, gs, dev) for o in org])

            def call():
                return jk.jacobi_zring_wavefront_step(raw, m, org, d2, gs, zs, **kw)
        else:
            d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - m, int(o[2]) - m, (r, Z), gs, dev) for o in org])

            def call():
                return jk.jacobi_shell_wavefront_step(raw, m, org, d2, gs, z_slabs=zs, z_valid=Z if slabs else None,
                                                      **kw)

        prof, _ = _profile(call, 10)
        W = Z + 2 * m if ring else Z
        out[label] = {"shape": [8, r, r, Z], "m": m, "device_ms": sum(prof.values()), "kernels": prof,
                      "ms": _cuda_ms(call, inner=2),
                      **jacobi_bound(wavefront_bytes(8, r, r, W, m, m, slabs, item), 8 * half ** 3 * m, unit,
                                     mxu_input, storage == "f64")}
        if storage == "f64":
            out[label]["launch"] = jk.jacobi_wavefront_launch((8, r, r, Z), m, ring=ring, slabs=slabs,
                                                              storage=storage)
        del raw, zs, d2
        torch.cuda.empty_cache()
    return out


def _onelevel_case(dev, which: str, storage: str = "native") -> dict:
    """The shell route's ``jacobi_plane_step`` call or the slab route's
    ``jacobi_slab_step`` call on 2x2x2 at 512^3, timed as ``jacobi_wrap``."""
    from stencil_tpu_torch.ops import jacobi_kernels as jk

    kw = _axes_kw(storage, "vpu", "f32")
    dt, item = _STORAGE[storage]
    half, gs = N // 2, (N, N, N)
    ext = half + 2 if which == "plane" else half
    block = _seeded((8, ext, ext, ext), 50, dev).to(dt)
    org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)],
                       dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in org])
    out = torch.empty_like(block)
    if which == "plane":
        slabs = []

        def call():
            return jk.jacobi_plane_step(block, org, d2, gs, out=out, **kw)
    else:
        slabs = [_seeded((8, half, half), 51 + i, dev).to(dt) for i in range(6)]

        def call():
            return jk.jacobi_slab_step(block, *slabs, org, d2, gs, out=out, **kw)

    prof, _ = _profile(call, 10)
    nbytes = (2 * block.numel() + sum(s.numel() for s in slabs)) * item + (d2.numel() + org.numel()) * 4
    plan = getattr(jk, f"jacobi_{which}_launch", None)
    res = {"shape": list(block.shape), "device_ms": sum(prof.values()), "kernels": prof, "ms": _cuda_ms(call),
           **jacobi_bound(nbytes, 8 * half ** 3, f64=storage == "f64"),
           "launch": None if plan is None else plan(tuple(block.shape),
                                                    **({} if storage == "native" else {"storage": storage}))}
    del block, slabs, out
    torch.cuda.empty_cache()
    return res


def jacobi_bf16_times(dev) -> dict:
    """The bf16-storage twin of every Jacobi row (section ``jacobi_bf16``)."""
    return {"wrap": jacobi_wrap_times(dev, "bf16"), "wavefront": jacobi_wavefront_times(dev, "bf16"),
            "plane": _onelevel_case(dev, "plane", "bf16"), "slab": _onelevel_case(dev, "slab", "bf16")}


def library_ptxas(name: str) -> list:
    """``ptxas_report`` of a built plain source or variant (its ``.so.log``),
    with each kernel's shared memory where ptxas reports it."""
    import os

    from stencil_tpu_torch.kernels import build

    log = build.library_path(name) + ".log"
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return ptxas_report(f.read())


def jacobi_f64_times(dev) -> dict:
    """The float64 build of every Jacobi row beside its f32 form (section
    ``jacobi_f64``)."""
    from stencil_tpu_torch.ops import jacobi_kernels as jk

    m4 = jk.wavefront_auto_depth(N // 2, itemsize=8)  # the f64 route's depth on 2x2x2 (4)
    out = {}
    for storage in ("f64", "native"):
        out[storage] = {"wrap": jacobi_wrap_times(dev, storage), "wavefront": jacobi_wavefront_times(dev, storage),
                        f"wavefront_m{m4}": jacobi_wavefront_times(dev, storage, m=m4),
                        "plane": _onelevel_case(dev, "plane", storage), "slab": _onelevel_case(dev, "slab", storage)}
    out["ptxas"] = library_ptxas("jacobi_wavefront_f64")
    return out


def mean6_dtype_times(dev) -> dict:
    """The mean-of-6 kernels under each field dtype (section
    ``mean6_dtypes``)."""
    from stencil_tpu_torch.ops import jacobi_kernels as jk
    from stencil_tpu_torch.ops import plane_stencil as ps

    ws, s3 = N + 6, 3
    res = {}
    for storage in ("native", "bf16", "f64"):
        dt, item = _STORAGE[storage]
        flops = F64_FLOPS_PER_S if storage == "f64" else F32_FLOPS_PER_S
        acc = storage == "bf16"
        block = _seeded((ws, ws, ws), 60, dev).to(dt)
        out = torch.empty_like(block)
        row = {}
        for m, s in ((3, 3), (8, 8)):
            def call(m=m, s=s):
                return ps.mean6_shell_wavefront_step(block, m, s, f32_accumulate=acc, out=out)

            prof, _ = _profile(call, 10, per_call=jk.wavefront_marches(m))
            times = {"bytes": (ws ** 3 + (ws - 2 * s) ** 3) * item / HBM_BYTES_PER_S * 1e3,
                     "operations": 6 * m * (ws - 2 * s) ** 3 / flops * 1e3}
            by = max(times, key=times.get)
            row[f"wavefront m={m}"] = {"shape": [ws] * 3, "s": s, "device_ms": sum(prof.values()), "kernels": prof,
                                       "ms": _cuda_ms(call, inner=2), "bound_ms": times[by], "bound_by": by,
                                       "launch": ps.mean6_wavefront_launch((ws, ws, ws), m, s, storage)}

        def plane():
            return ps.mean6_plane_step(block, (s3,) * 3, (s3,) * 3, f32_accumulate=acc, out=out)

        prof, _ = _profile(plane, 10)
        times = {"bytes": 2 * ws ** 3 * item / HBM_BYTES_PER_S * 1e3, "operations": 6 * N ** 3 / flops * 1e3}
        by = max(times, key=times.get)
        row["plane"] = {"shape": [ws] * 3, "lo_hi": s3, "device_ms": sum(prof.values()), "kernels": prof,
                        "ms": _cuda_ms(plane), "bound_ms": times[by], "bound_by": by}
        res[storage] = row
        del block, out
        torch.cuda.empty_cache()
    res["ptxas"] = {name: [e for e in library_ptxas(name) if "Li6E" in e["entry"] or "mean6" in e["entry"]]
                    for name in ("jacobi_wavefront_bf16", "jacobi_wavefront_f64", "plane_stencil")}
    return res


def jacobi_mxu_times(dev) -> dict:
    """The tensor-core forms of the wrap (k = 8) and wavefront kernels on f32
    and bf16 operands (section ``jacobi_mxu``)."""
    return {mi: {"wrap": jacobi_wrap_times(dev, unit="mxu_band", mxu_input=mi, ks=(8,)),
                 "wavefront": jacobi_wavefront_times(dev, unit="mxu_band", mxu_input=mi)}
            for mi in ("f32", "bf16")}


def mxu_vs_vpu_times(dev, k: int = 8, reps: int = 5, inner: int = 10) -> dict:
    """``bench.py``'s ``mxu_vs_vpu_ab`` (bench.py:100-188) on the card: the
    same k-level wrap call over a 512^3 domain at 0.5 under each compute
    unit, the legs alternating rep by rep (CUDA events, ``inner`` calls a
    rep; rep 0 dropped, the median kept); under its keys, with each leg's
    device ms a call, bound and tensor-core FLOPs beside."""
    from stencil_tpu_torch.ops import jacobi_kernels as jk

    cells = N ** 3
    band_ok = jk.band_tile_plan(N, N) is not None
    legs = [("vpu", "vpu", "f32"), ("mxu", "mxu", "f32")]
    if band_ok:
        legs += [("mxu_band", "mxu_band", "f32"), ("mxu_band+bf16in", "mxu_band", "bf16")]
    block = torch.full((N, N, N), 0.5, device=dev)
    out = torch.empty_like(block)

    def leg(unit, mi):
        def call():
            return jk.jacobi_wrap_step(block, k, out=out, compute_unit=unit, mxu_input=mi)
        return call

    calls = [leg(unit, mi) for _, unit, mi in legs]
    for call in calls:
        call()  # build and warm
    _sync()
    per_rep = [[] for _ in legs]
    for _ in range(reps):
        for j, call in enumerate(calls):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                call()
            stop.record()
            stop.synchronize()
            per_rep[j].append(start.elapsed_time(stop) / inner)
    section = {"eligible": True, "band_eligible": band_ok, "k": k,
               "measurement_protocol": {"alternating": True, "drop_rep0": True, "stat": "median",
                                        "reps": reps, "inner": inner, "timer": "cuda events"},
               "units": {}, "speedup_vs_vpu": None, "speedups_vs_vpu": {}}
    for (key, unit, mi), times, call in zip(legs, per_rep, calls):
        ms = statistics.median(times[1:])
        prof, _ = _profile(call, 10, per_call=len(jk.wrap_march_depths(k)))
        section["units"][key] = {"ms_per_dispatch": ms, "mcells_per_s": cells * k / (ms * 1e-3) / 1e6,
                                 "device_ms": sum(prof.values()), "reps_ms": times,
                                 **jacobi_bound(2 * cells * 4, cells * k, unit, mi),
                                 "model_flops": (jk.mxu_flops_per_plane(N, N, unit) * N * k
                                                 if jk.unit_uses_mxu(unit) else 0)}
    vpu_ms = section["units"]["vpu"]["ms_per_dispatch"]
    for key, u in section["units"].items():
        if key != "vpu":
            section["speedups_vs_vpu"][key] = vpu_ms / u["ms_per_dispatch"]
    section["speedup_vs_vpu"] = section["speedups_vs_vpu"].get("mxu")
    del block, out
    torch.cuda.empty_cache()
    return section


def wavefront_times(dev) -> dict:
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    kern = AstarothSim(8, 8, 8, device=dev)._kernel
    out = {}
    for n, ext in ((1, N + 6), (8, N // 2 + 6)):
        gs = (N, N, N)
        sk = StreamKernel(kern, ["d0"], 1, gs)
        raws = [_seeded((n, ext, ext, ext), 1, dev)]
        zs = [_seeded((n, ext, 6, ext), 2, dev)]
        org = torch.tensor([[(ext - 6) * (b & 1), 0, 0] for b in range(n)], dtype=torch.int32, device=dev)

        def call():
            return st.stream_wavefront_pass(sk, ["d0"], raws, 3, 3, org, gs, z_slabs=zs, z_valid=ext)

        prof, _ = _profile(call, 10)
        out[f"({n},{ext},{ext},{ext})"] = {"device_ms": sum(prof.values()), "kernels": prof,
                                           "ms": _cuda_ms(call, inner=2)}
        del raws, zs
        torch.cuda.empty_cache()
    return out


def blend_times(dev) -> dict:
    from stencil_tpu_torch.ops.halo_blend import blend_slab

    ps = N // 2 + 6
    blocks = _seeded((8, ps, ps, ps), 3, dev)
    out = {}
    for axis in (0, 1, 2):
        shape = [8, ps, ps, ps]
        shape[1 + axis] = 3
        slabs = [(_seeded(shape, 4 + 2 * axis + i, dev), pos) for i, pos in enumerate((0, ps - 3))]

        def kernel():
            for s, pos in slabs:
                blend_slab(blocks, s, axis, pos)

        def library():
            for s, pos in slabs:
                blocks.narrow(1 + axis, pos, 3).copy_(s)

        out[str(axis)] = {
            "device_ms": sum(_profile(kernel, 10)[0].values()) / 2,
            "copy_device_ms": sum(_profile(library, 10)[0].values()) / 2,
            "ms": _cuda_ms(kernel) / 2, "copy_ms": _cuda_ms(library) / 2,
            "host_us": _host_us(kernel) / 2, "copy_host_us": _host_us(library) / 2,
        }
    return out


def zshell_times(dev) -> dict:
    from stencil_tpu_torch.ops import pack as pk

    ps, depth = N // 2 + 6, 3
    blocks = _seeded((8, ps, ps, ps), 5, dev)
    buf = pk.pack_zshell_pallas(blocks, 0, depth)
    scratch = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)  # 64 MB, more than the 50 MB L2

    def flush():
        scratch.fill_(1.0)

    def device_ms(fn, cold: bool) -> float:
        """Device ms a call of ``fn``'s kernels; cold: each call after the flush,
        whose kernel is left out."""
        if not cold:
            return sum(_profile(fn, 20)[0].values())
        prof = _profile(lambda: (flush(), fn()), 10)[0]
        return sum(v for k, v in prof.items() if "FillFunctor" not in k)

    window = buf.numel() * 4
    out = {}
    for kind, z0s in (("pack", (3, ps - 6)), ("unpack", (0, ps - 3))):
        for z0 in z0s:
            if kind == "pack":
                def kernel(z0=z0):
                    return pk.pack_zshell_pallas(blocks, z0, depth)

                def library(z0=z0):
                    return buf.copy_(blocks.narrow(3, z0, depth).permute(0, 3, 2, 1))
            else:
                def kernel(z0=z0):
                    return pk.unpack_zshell_pallas(blocks, buf, z0, depth)

                def library(z0=z0):
                    return blocks.narrow(3, z0, depth).copy_(buf.permute(0, 3, 2, 1))
            sectors = zshell_sector_bytes(blocks.shape, 4, z0, depth, blocks.data_ptr())
            floor = sectors + window if kind == "pack" else window + 2 * sectors
            out[f"{kind} z0={z0}"] = {
                "device_ms_hot": device_ms(kernel, False), "device_ms_cold": device_ms(kernel, True),
                "ms": _cuda_ms(kernel), "copy_device_ms_hot": device_ms(library, False),
                "copy_device_ms_cold": device_ms(library, True), "copy_ms": _cuda_ms(library),
                "bound_ms": 2 * window / HBM_BYTES_PER_S * 1e3, "sector_bytes": sectors,
                "sector_floor_ms": floor / HBM_BYTES_PER_S * 1e3}
    del blocks, buf, scratch
    torch.cuda.empty_cache()
    return out


def mean6_times(dev) -> dict:
    from stencil_tpu_torch.ops import plane_stencil as ps

    ws = N + 6
    block = _seeded((ws, ws, ws), 60, dev)
    out = torch.empty_like(block)
    plan = getattr(ps, "mean6_wavefront_launch", None)
    res = {}
    for m, s in ((3, 3), (8, 8)):
        def call(m=m, s=s):
            return ps.mean6_shell_wavefront_step(block, m, s, out=out)

        prof, _ = _profile(call, 10)
        res[f"m={m}"] = {"shape": [ws] * 3, "s": s, "device_ms": sum(prof.values()), "kernels": prof,
                         "ms": _cuda_ms(call, inner=2),
                         "bound_ms": (ws ** 3 + (ws - 2 * s) ** 3) * 4 / HBM_BYTES_PER_S * 1e3,
                         "launch": None if plan is None else plan((ws, ws, ws), m, s)}
    del block, out
    torch.cuda.empty_cache()
    return res


def blend_dynamic_times(dev) -> dict:
    from stencil_tpu_torch.ops.halo_blend import blend_slab_dynamic

    half = N // 2
    out = {}
    for tag, m in (("", 8), (" shell", 1)):  # the 511^3 wavefront's depth-8 halo; the shell route's
        r = half + 2 * m
        blocks = _seeded((8, r, r, r), 61, dev)
        for axis in (0, 1, 2):
            shape = [8, r, r, r]
            shape[1 + axis] = m
            slab = _seeded(shape, 62 + axis, dev)
            last = [(b >> (2 - axis)) & 1 for b in range(8)]  # grid index on the axis, stack order
            pos = torch.tensor([m + (half - 1 if i else half) for i in last], dtype=torch.int32, device=dev)

            def kernel(slab=slab, axis=axis, pos=pos):
                return blend_slab_dynamic(blocks, slab, axis, pos)

            out[f"{axis}{tag}"] = {"slab": shape, "device_ms": sum(_profile(kernel, 20)[0].values()),
                                   "ms": _cuda_ms(kernel),
                                   "bound_ms": (2 * slab.numel() * 4 + 8 * 4) / HBM_BYTES_PER_S * 1e3}
        del blocks
        torch.cuda.empty_cache()
    return out


def fused_times(dev) -> dict:
    import inspect

    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    kern = AstarothSim(8, 8, 8, device=dev)._kernel
    fused = "fused_shell" in inspect.signature(st.stream_plane_pass).parameters
    gs = (N, N, N)
    n, ext, s = 8, N // 2 + 6, 3
    shell = Dim3(s, s, s)
    org = torch.tensor([[(N // 2) * (b >> 2), (N // 2) * (b >> 1 & 1), (N // 2) * (b & 1)] for b in range(n)],
                       dtype=torch.int32, device=dev)
    block = n * ext ** 3 * 4
    out = {"fused_forms": fused}
    for kind, fields in (("plane", 8), ("wavefront", 1)):
        names = [f"d{q}" for q in range(fields)]
        sk = StreamKernel(kern, names, 1, gs)
        raws = [_seeded((n, ext, ext, ext), 10 + q, dev) for q in range(fields)]
        fs = tuple([_seeded((n, 2 * s, a, b), 20 + 3 * q + j, dev) for q in range(fields)]
                   for j, (a, b) in enumerate(((ext, ext),) * 3))
        # each cell read once (from the block or a buffer) and the output
        # written once: the whole block on the plane, the valid region on
        # the wavefront
        nbytes = fields * (2 * block if kind == "plane" else block + n * (ext - 2 * s) ** 3 * 4)
        for form in ("array", "fused") if fused else ("array",):
            kw = {"fused_shell": fs} if form == "fused" else {}
            if kind == "plane":
                def call():
                    return st.stream_plane_pass(sk, names, raws, shell, shell, 1, org, gs, **kw)
            else:
                def call():
                    return st.stream_wavefront_pass(sk, names, raws, 3, s, org, gs, **kw)
            prof, _ = _profile(call, 10)
            out[f"{kind} {form}"] = {"device_ms": sum(prof.values()), "kernels": prof, "ms": _cuda_ms(call, inner=2),
                                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "fields": fields,
                                     "shape": [n, ext, ext, ext]}
            if kind == "wavefront":
                out[f"{kind} {form}"]["launch"] = st.stream_wavefront_launch(
                    sk, names, raws, 3, s, gs, **({"fused": True} if form == "fused" else {}))
        del raws, fs
        torch.cuda.empty_cache()
    return out


def ptxas_report(text: str) -> list:
    """Each kernel's registers and spill bytes from nvcc's ``-Xptxas -v``
    output: ``[{"entry", "registers", "spill_stores", "spill_loads"}]``."""
    import re

    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


def _library_report(template: str, text: str) -> list:
    """``ptxas_report`` of a built stream library (its ``.so.log``)."""
    import os

    from stencil_tpu_torch.kernels import build

    log = build._generated_paths(template, text)[2] + ".log"
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return ptxas_report(f.read())


def device_rand(shape, seed: int, dev, dtype) -> torch.Tensor:
    """Seeded values in [0, 1) made on the device at float64 and rounded to
    ``dtype`` (the main path's shapes take seconds to fill on the host)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64).to(dtype)


def stream_dtype_times(dev, dtype: str, device_ms=None, f32: bool = True) -> dict:
    """The ``stream_bf16`` / ``stream_f64`` section: each stream kernel's
    ``dtype`` build beside its float32 build (module docstring; ``f32``
    False leaves the float32 build out).  ``device_ms(call, per_call)``
    reads a call's device ms in place of ``_profile`` (``chip_smoke.py``
    passes its own, which falls back to CUDA events where the profiler
    holds no launch)."""
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.kernels import build
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    kern = AstarothSim(8, 8, 8, device=dev)._kernel
    gs = (N, N, N)
    storage = {"bf16": torch.bfloat16, "f64": torch.float64}[dtype]
    n, ext, s, m = 8, N // 2 + 6, 3, 3
    shell = Dim3(s, s, s)
    org8 = torch.tensor([[(N // 2) * (b >> 2), (N // 2) * (b >> 1 & 1), (N // 2) * (b & 1)] for b in range(n)],
                        dtype=torch.int32, device=dev)
    ws = N + 2 * s
    org1 = torch.zeros(1, 3, dtype=torch.int32, device=dev)

    def ops_per_cell(sk) -> int:
        return sum(x.op not in ("load", "coord", "const") for x in sk.trace().live()) // len(sk.names)

    def case(dt, fields):
        names = [f"d{q}" for q in range(fields)]
        return StreamKernel(kern, names, 1, gs, dtypes=[dt] * fields), names

    # every library first, one nvcc each, all at once
    dts = (torch.float32, storage) if f32 else (storage,)
    want = []
    for dt in dts:
        sk8, _ = case(dt, 8)
        sk1, _ = case(dt, 1)
        want += [("stream_wrap", st._source(sk8, "stream_wrap", st._WRAP_LEVELS)),
                 ("stream_plane", st._source(sk8, "stream_plane", [1])),
                 ("stream_plane_fused", st._source(sk8, "stream_plane_fused", [1], st._FUSED)),
                 ("stream_wavefront", st._source(sk1, *st._wavefront_variant(m))),
                 ("stream_wavefront_fused", st._source(sk1, *st._wavefront_variant(m, True)))]
    build.build_generated(dict.fromkeys(want))
    libs = {t: _library_report(t, text) for t, text in want}

    out = {}
    for dt in dts:
        label = "f32" if dt == torch.float32 else dtype
        item = dt.itemsize
        flops = F64_FLOPS_PER_S if dt == torch.float64 else F32_FLOPS_PER_S

        def timed(call, nbytes, cell_levels, sk, template, extra=None, launches=None):
            if device_ms is None:
                prof = _profile(call, 10, per_call=launches)[0]
                dev_ms = sum(prof.values())
            else:
                prof, dev_ms = None, device_ms(call, launches)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops_per_cell(sk) * cell_levels / flops * 1e3
            row = {"device_ms": dev_ms, "kernels": prof, "ms": _cuda_ms(call, inner=2),
                   "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "ptxas": _library_report(template, st._source(sk, *extra))}
            return row

        # #6: 8 fields x 512^3, k = 1 and 8 (launches of one level each)
        sk8, names8 = case(dt, 8)
        blocks = [device_rand(gs, 10 + q, dev, dt) for q in range(8)]
        org0 = torch.zeros(3, dtype=torch.int32, device=dev)
        for k in (1, 8):
            call = (lambda k=k: st.stream_wrap_pass(sk8, names8, blocks, k, org0, gs))
            # the fields read and written once a launch; under bf16 the
            # launches between go through float32 sets
            per_launch = [(item if lv == 1 else 4 if dt == torch.bfloat16 else item)
                          + (item if lv == k else 4 if dt == torch.bfloat16 else item) for lv in range(1, k + 1)]
            out[f"wrap {label} k={k}"] = timed(call, 8 * N ** 3 * sum(per_launch), 8 * N ** 3 * k, sk8,
                                               "stream_wrap", ("stream_wrap", st._WRAP_LEVELS), launches=k)
        del blocks
        torch.cuda.empty_cache()
        # #7: 8 fields x (8, 262^3), array and fused
        raws = [device_rand((n, ext, ext, ext), 20 + q, dev, dt) for q in range(8)]
        fs = tuple([device_rand((n, 2 * s, ext, ext), 30 + 3 * q + j, dev, dt) for q in range(8)] for j in range(3))
        outs = [torch.empty_like(r) for r in raws]
        nbytes = 8 * 2 * n * ext ** 3 * item
        out[f"plane {label}"] = timed(lambda: st.stream_plane_pass(sk8, names8, raws, shell, shell, 1, org8, gs,
                                                                   out=outs),
                                      nbytes, 8 * n * (ext - 2 * s) ** 3, sk8, "stream_plane",
                                      ("stream_plane", [1]))
        out[f"plane fused {label}"] = timed(lambda: st.stream_plane_pass(sk8, names8, raws, shell, shell, 1, org8,
                                                                         gs, out=outs, fused_shell=fs),
                                            nbytes, 8 * n * (ext - 2 * s) ** 3, sk8, "stream_plane_fused",
                                            ("stream_plane_fused", [1], st._FUSED))
        del raws, fs, outs
        torch.cuda.empty_cache()
        # #8: one field, m = 3: z slabs at (1, 518^3); fused at (8, 262^3)
        sk1, names1 = case(dt, 1)
        raw = [device_rand((1, ws, ws, ws), 40, dev, dt)]
        zs = [device_rand((1, ws, 2 * s, ws), 41, dev, dt)]
        nbytes = stream_wavefront_bytes(1, ws, ws, ws, m, s, True, 1, item)
        row = timed(lambda: st.stream_wavefront_pass(sk1, names1, raw, m, s, org1, gs, z_slabs=zs, z_valid=ws),
                    nbytes, N ** 3 * m, sk1, "stream_wavefront", st._wavefront_variant(m))
        row["launch"] = st.stream_wavefront_launch(sk1, names1, raw, m, s, gs, z_slabs=zs, z_valid=ws)
        out[f"wavefront {label}"] = row
        del raw, zs
        torch.cuda.empty_cache()
        raws = [device_rand((n, ext, ext, ext), 50, dev, dt)]
        fs = tuple([device_rand((n, 2 * s, ext, ext), 51 + j, dev, dt)] for j in range(3))
        nbytes = (n * ext ** 3 + n * (ext - 2 * s) ** 3) * item
        row = timed(lambda: st.stream_wavefront_pass(sk1, names1, raws, m, s, org8, gs, fused_shell=fs),
                    nbytes, n * (ext - 2 * s) ** 3 * m, sk1, "stream_wavefront_fused",
                    st._wavefront_variant(m, True))
        row["launch"] = st.stream_wavefront_launch(sk1, names1, raws, m, s, gs, fused=True)
        out[f"wavefront fused {label}"] = row
        del raws, fs
        torch.cuda.empty_cache()
    out["libraries"] = libs
    return out


#: the contraction forms ``stream_mxu`` times: ledger suffix -> (unit, operands)
MXU_FORMS = {"mxu": ("mxu", "f32"), "mxu_bf16in": ("mxu_band", "bf16")}


def stream_mxu_times(dev, device_ms=None, plain: bool = False, check=None) -> dict:
    """The ``stream_mxu`` section (module docstring), keyed by the ledger's
    form names (``stream_wrap_pass_mxu``, ...).  ``device_ms(call,
    per_call)`` reads a call's device ms in place of ``_profile``
    (``chip_smoke.py`` passes its own); ``plain`` also times each form's
    plain version (CUDA events, 3 reps of one call); ``check(form, got,
    want, levels)`` is handed each form's valid region and its plain
    version's on these inputs before the timing."""
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.kernels import build
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import plane_stencil as ps
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    gs = (N, N, N)
    n, ext, s, m = 8, N // 2 + 6, 3, 3
    shell = Dim3(s, s, s)
    ws = N + 2 * s
    org8 = torch.tensor([[(N // 2) * (b >> 2), (N // 2) * (b >> 1 & 1), (N // 2) * (b & 1)] for b in range(n)],
                        dtype=torch.int32, device=dev)
    org0, org1 = torch.zeros(3, dtype=torch.int32, device=dev), torch.zeros(1, 3, dtype=torch.int32, device=dev)
    names8 = [f"d{q}" for q in range(8)]

    def kernel(unit, mi, fields):
        fn = AstarothSim._kernel_mxu if unit != "vpu" else AstarothSim._kernel
        return StreamKernel(fn, names8[:fields], 1, gs, compute_unit=unit, mxu_input=mi)

    # every library first, one nvcc each, all at once
    want = []
    for unit, mi in [("vpu", "f32")] + list(MXU_FORMS.values()):
        sk8, sk1 = kernel(unit, mi, 8), kernel(unit, mi, 1)
        want += [("stream_wrap", st._source(sk8, "stream_wrap", st._WRAP_LEVELS)),
                 ("stream_plane", st._source(sk8, "stream_plane", [1])),
                 ("stream_wavefront", st._source(sk1, *st._wavefront_variant(m)))]
    build.build_generated(dict.fromkeys(want))

    def timed(call, nbytes, cell_levels, unit, mi, launches=1):
        dev_ms = sum(_profile(call, 10, per_call=launches)[0].values()) if device_ms is None else device_ms(
            call, launches)
        return dict({"device_ms": dev_ms, "ms": _cuda_ms(call, inner=2), "bytes": nbytes},
                    **jacobi_bound(nbytes, cell_levels, unit, mi))

    out = {}
    blocks = [device_rand(gs, 70 + q, dev, torch.float32) for q in range(8)]
    raws = [device_rand((n, ext, ext, ext), 80 + q, dev, torch.float32) for q in range(8)]
    raw1 = [device_rand((1, ws, ws, ws), 90, dev, torch.float32)]
    zs1 = [device_rand((1, ws, 2 * s, ws), 91, dev, torch.float32)]
    S = slice(s, -s)
    for suffix, (unit, mi) in MXU_FORMS.items():
        kw = {"compute_unit": unit, "mxu_input": mi}
        sk8, sk1 = kernel(unit, mi, 8), kernel(unit, mi, 1)
        vk8, vk1 = kernel("vpu", "f32", 8), kernel("vpu", "f32", 1)
        # name: (the form's call, the vpu form's, the plain version's, the
        # valid region of an output, its levels, bytes, cell-levels, kernel
        # launches a call, the plan)
        cases = {
            "stream_wrap_pass": (
                lambda: st.stream_wrap_pass(sk8, names8, blocks, 1, org0, gs, **kw),
                lambda: st.stream_wrap_pass(vk8, names8, blocks, 1, org0, gs),
                lambda: st.stream_wrap_pass_plain(sk8, names8, blocks, 1, org0, gs, **kw),
                lambda o: o, 1, 8 * N ** 3 * 8, 8 * N ** 3, 1, None),
            "stream_plane_pass": (
                lambda: st.stream_plane_pass(sk8, names8, raws, shell, shell, 1, org8, gs, **kw),
                lambda: st.stream_plane_pass(vk8, names8, raws, shell, shell, 1, org8, gs),
                lambda: st.stream_plane_pass_plain(sk8, names8, raws, shell, shell, 1, org8, gs, **kw),
                lambda o: o[:, S, S, S], 1, 8 * 2 * n * ext ** 3 * 4, 8 * n * (ext - 2 * s) ** 3, 1, None),
            "stream_wavefront_pass": (
                lambda: st.stream_wavefront_pass(sk1, names8[:1], raw1, m, s, org1, gs, z_slabs=zs1, z_valid=ws,
                                                 **kw)[0],
                lambda: st.stream_wavefront_pass(vk1, names8[:1], raw1, m, s, org1, gs, z_slabs=zs1, z_valid=ws)[0],
                lambda: st.stream_wavefront_pass_plain(sk1, names8[:1], raw1, m, s, org1, gs, z_slabs=zs1,
                                                       z_valid=ws, **kw)[0],
                lambda o: o[:, S, S, S], m, stream_wavefront_bytes(1, ws, ws, ws, m, s, True, 1), N ** 3 * m, 1,
                lambda: st.stream_wavefront_launch(sk1, names8[:1], raw1, m, s, gs, z_slabs=zs1, z_valid=ws, **kw)),
            "mean6_shell_wavefront_step": (
                lambda: [ps.mean6_shell_wavefront_step(raw1[0][0], m, s, **kw)],
                lambda: [ps.mean6_shell_wavefront_step(raw1[0][0], m, s)],
                lambda: [ps.mean6_shell_wavefront_step_plain(raw1[0][0], m, s, **kw)],
                lambda o: o[S, S, S], m, (ws ** 3 + N ** 3) * 4, m * N ** 3, 1,
                lambda: ps.mean6_wavefront_launch((ws, ws, ws), m, s, "native", unit, mi)),
            "mean6_plane_step": (
                lambda: [ps.mean6_plane_step(raw1[0][0], shell, shell, **kw)],
                lambda: [ps.mean6_plane_step(raw1[0][0], shell, shell)],
                lambda: [ps.mean6_plane_step_plain(raw1[0][0], shell, shell, **kw)],
                lambda o: o, 1, 2 * ws ** 3 * 4, N ** 3, 1, None),
        }
        for name, (call, vcall, pcall, valid, levels, nbytes, cell_levels, launches, plan) in cases.items():
            if check is not None:
                got = [valid(o) for o in call()]
                _sync()
                check(f"{name}_{suffix}", got, [valid(o) for o in pcall()], levels)
                del got
            row = timed(call, nbytes, cell_levels, unit, mi, launches)
            row.update(vpu_ms=_cuda_ms(vcall, inner=2), vpu_device_ms=(
                sum(_profile(vcall, 10, per_call=launches)[0].values()) if device_ms is None
                else device_ms(vcall, launches)), compute_unit=unit, mxu_input=mi)
            if plain:
                row["plain_ms"] = _cuda_ms(pcall, reps=3, inner=1)
            if plan is not None:
                row["launch"] = plan()
            out[f"{name}_{suffix}"] = row
            torch.cuda.empty_cache()
    del blocks, raws, raw1, zs1
    torch.cuda.empty_cache()
    return out


def stream_fused_mxu_times(dev, device_ms=None, plain: bool = False, check=None) -> dict:
    """The ``stream_fused_mxu`` section (module docstring), keyed by the
    ledger's form names (``stream_plane_pass_fused_mxu``, ...); the
    arguments as ``stream_mxu_times``'."""
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.kernels import build
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    gs = (N, N, N)
    n, ext, s, m = 8, N // 2 + 6, 3, 3
    shell = Dim3(s, s, s)
    org8 = torch.tensor([[(N // 2) * (b >> 2), (N // 2) * (b >> 1 & 1), (N // 2) * (b & 1)] for b in range(n)],
                        dtype=torch.int32, device=dev)
    names8 = [f"d{q}" for q in range(8)]

    def kernel(unit, mi, fields):
        fn = AstarothSim._kernel_mxu if unit != "vpu" else AstarothSim._kernel
        return StreamKernel(fn, names8[:fields], 1, gs, compute_unit=unit, mxu_input=mi)

    # every library first, one nvcc each, all at once
    want = []
    for unit, mi in [("vpu", "f32")] + list(MXU_FORMS.values()):
        sk8, sk1 = kernel(unit, mi, 8), kernel(unit, mi, 1)
        want += [("stream_plane_fused", st._source(sk8, "stream_plane_fused", [1], st._FUSED)),
                 ("stream_wavefront_fused", st._source(sk1, *st._wavefront_variant(m, True)))]
        if unit != "vpu":
            want += [("stream_plane", st._source(sk8, "stream_plane", [1])),
                     ("stream_wavefront", st._source(sk1, *st._wavefront_variant(m)))]
    build.build_generated(dict.fromkeys(want))

    def dev_ms(call, launches=1):
        return (sum(_profile(call, 10, per_call=launches)[0].values()) if device_ms is None
                else device_ms(call, launches))

    # each pass's fused and array libraries: (template, levels, defines)
    libs = {"stream_plane_pass": (("stream_plane_fused", [1], st._FUSED), ("stream_plane", [1])),
            "stream_wavefront_pass": (st._wavefront_variant(m, True), st._wavefront_variant(m))}
    raws = [device_rand((n, ext, ext, ext), 110 + q, dev, torch.float32) for q in range(8)]
    fs8 = tuple([device_rand((n, 2 * s, ext, ext), 120 + 3 * q + j, dev, torch.float32) for q in range(8)]
                for j in range(3))
    fs1 = tuple([b[0]] for b in fs8)
    block = n * ext ** 3 * 4
    S = slice(s, -s)
    out = {}
    for suffix, (unit, mi) in MXU_FORMS.items():
        kw = {"compute_unit": unit, "mxu_input": mi}
        sk8, sk1 = kernel(unit, mi, 8), kernel(unit, mi, 1)
        vk8, vk1 = kernel("vpu", "f32", 8), kernel("vpu", "f32", 1)
        # name: (the form's call, the vpu fused form's and its kernel
        # launches, the array contraction form's, the plain version's, the
        # valid region, levels, bytes, cell-levels, the plan)
        cases = {
            "stream_plane_pass": (
                lambda: st.stream_plane_pass(sk8, names8, raws, shell, shell, 1, org8, gs, fused_shell=fs8, **kw),
                lambda: st.stream_plane_pass(vk8, names8, raws, shell, shell, 1, org8, gs, fused_shell=fs8), 2,
                lambda: st.stream_plane_pass(sk8, names8, raws, shell, shell, 1, org8, gs, **kw),
                lambda: st.stream_plane_pass_plain(sk8, names8, raws, shell, shell, 1, org8, gs, fused_shell=fs8,
                                                   **kw),
                lambda o: o, 1, 8 * 2 * block, 8 * n * (ext - 2 * s) ** 3, None),
            "stream_wavefront_pass": (
                lambda: st.stream_wavefront_pass(sk1, names8[:1], raws[:1], m, s, org8, gs, fused_shell=fs1, **kw)[0],
                lambda: st.stream_wavefront_pass(vk1, names8[:1], raws[:1], m, s, org8, gs, fused_shell=fs1)[0], 1,
                lambda: st.stream_wavefront_pass(sk1, names8[:1], raws[:1], m, s, org8, gs, **kw)[0],
                lambda: st.stream_wavefront_pass_plain(sk1, names8[:1], raws[:1], m, s, org8, gs, fused_shell=fs1,
                                                       **kw)[0],
                lambda o: o[:, S, S, S], m, block + n * (ext - 2 * s) ** 3 * 4, n * (ext - 2 * s) ** 3 * m,
                lambda: st.stream_wavefront_launch(sk1, names8[:1], raws[:1], m, s, gs, fused=True, **kw)),
        }
        for name, (call, vcall, vlaunches, acall, pcall, valid, levels, nbytes, cell_levels, plan) in cases.items():
            if check is not None:
                got = [valid(o) for o in call()]
                _sync()
                check(f"{name}_fused_{suffix}", got, [valid(o) for o in pcall()], levels)
                del got
            row = dict({"device_ms": dev_ms(call), "ms": _cuda_ms(call, inner=2), "bytes": nbytes},
                       **jacobi_bound(nbytes, cell_levels, unit, mi))
            row.update(vpu_fused_ms=_cuda_ms(vcall, inner=2), vpu_fused_device_ms=dev_ms(vcall, vlaunches),
                       mxu_array_ms=_cuda_ms(acall, inner=2), mxu_array_device_ms=dev_ms(acall), compute_unit=unit,
                       mxu_input=mi)
            if plain:
                row["plain_ms"] = _cuda_ms(pcall, reps=3, inner=1)
            if plan is not None:
                row["launch"] = plan()
            # the registers and spills of the fused and array contraction libraries
            sk = sk8 if name == "stream_plane_pass" else sk1
            for key, v in zip(("ptxas", "mxu_array_ptxas"), libs[name]):
                row[key] = _library_report(v[0], st._source(sk, *v))
            out[f"{name}_fused_{suffix}"] = row
            torch.cuda.empty_cache()
    del raws, fs8, fs1
    torch.cuda.empty_cache()
    return out


def direct_route(dev) -> dict:
    from stencil_tpu_torch.models.astaroth import AstarothSim

    sim = AstarothSim(N, N, N, num_quantities=8, kernel_impl="cuda", schedule="per-step", exchange_route="direct",
                      device=dev)
    sim.dd.set_partition(2, 2, 2)
    sim.realize()
    sim.step(ITERS)  # builds the kernels
    dts = []
    for _ in range(2):
        _sync()
        t0 = time.perf_counter()
        sim.step(ITERS)
        _sync()
        dts.append((time.perf_counter() - t0) / ITERS * 1e3)
    kernels, wall = _profile(lambda: sim.step(1), ITERS)
    busy = sum(kernels.values())
    blends = blend_ms(kernels)
    return {"ms_per_iter": min(dts), "ms_per_iter_runs": dts, "device_ms_per_iter": busy,
            "idle_share": 1 - busy / wall, "blend_device_ms_per_iter": sum(blends.values()),
            "blend_kernels": blends, "kernels": kernels}


def main(argv=None) -> int:
    sections = {"jacobi_wrap": jacobi_wrap_times, "jacobi_wavefront": jacobi_wavefront_times,
                "jacobi_plane": lambda dev: _onelevel_case(dev, "plane"),
                "jacobi_slab": lambda dev: _onelevel_case(dev, "slab"), "wavefront": wavefront_times,
                "blend": blend_times, "zshell": zshell_times, "mean6": mean6_times,
                "blend_dynamic": blend_dynamic_times, "fused": fused_times, "direct": direct_route,
                "jacobi_bf16": jacobi_bf16_times, "jacobi_mxu": jacobi_mxu_times, "mxu_vs_vpu": mxu_vs_vpu_times,
                "stream_bf16": lambda dev: stream_dtype_times(dev, "bf16"),
                "stream_f64": lambda dev: stream_dtype_times(dev, "f64"),
                "jacobi_f64": jacobi_f64_times, "mean6_dtypes": mean6_dtype_times, "stream_mxu": stream_mxu_times,
                "stream_fused_mxu": stream_fused_mxu_times}
    p = argparse.ArgumentParser("bench-kernels")
    p.add_argument("--out", default=None, help="also write the JSON object here")
    p.add_argument("--only", nargs="+", choices=sorted(sections), default=None, help="time only these sections")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench-kernels: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    card = toolchain()["card"]
    if card is None:
        raise RuntimeError("bench-kernels: nvidia-smi did not report the card's name and power limit")
    dev = torch.device("cuda")
    result = {"card": card}
    for name, fn in sections.items():
        if args.only is None or name in args.only:
            result[name] = fn(dev)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
