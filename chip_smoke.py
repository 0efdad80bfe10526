#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (stencil_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises, prints its traceback and exits
non-zero before the result line:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles every CUDA source of the port with nvcc, all at once;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on seeded inputs at a ragged size and at the main path's shapes
   (phases 14-15 hold the slab and mean6 kernels at theirs; the Jacobi
   wavefront kernels also at m = 4, 6 and 8, one march and two, on ragged
   blocks that both spheres cross; the wrap kernel at k = 1..8 and 12 on a
   ragged block, on axes shorter than a march's apron, and at 512^3 at
   k = 1 and the main path's k = 8; the plane and slab kernels, depth-1
   marches, on ragged blocks both spheres cross, axes shorter than a tile,
   X = 2 for the slab kernel, random faces and each block's own, and the
   plane kernel at the shell route's blocks of 512^3 and of 511^3, padded
   shards); the expected result is bitwise equality;
4. main path, wrap route: Jacobi3D at 512^3 f32 on one subdomain, 200 steps
   through the entry points a user calls, launch counters reset just before
   and read just after; checked bitwise against the plain path at step 10,
   within rtol 1e-6 of the torch engine (another summation order), finite
   and inside [COLD, HOT] at step 200;
5. main path, shell route: the same on a 2x2x2 subdomain grid with
   ``pallas_path="shell"`` (exchange with blend_slab, then
   jacobi_plane_step); bitwise equal to phase 4 at step 10;
6. main path, wavefront route: the same grid with the default
   ``pallas_path="auto"``, which takes the temporally blocked z-ring
   wavefront (jacobi_zring_wavefront_step, one launch per macro step of m
   levels); then the ``z_ring=False`` form (jacobi_shell_wavefront_step
   with z slabs), 200 steps each with the counters reset before and read
   after; both bitwise equal to phase 4 at step 10, within rtol 1e-6 of the
   torch engine, finite and inside [COLD, HOT] at step 200;
7. times with CUDA events (median of 7 reps after a dropped warm-up rep) of
   each kernel, its plain version and, for blend_slab, the library copy,
   beside the least time the card could take (bytes over 3.35 TB/s or f32
   operations over 67 TFLOP/s, H100 SXM); each route's Mcells/s; from 20
   more steps of each route under torch.profiler, device time by kernel and
   the device's idle share; and the host-clock ms of a ``step(1)`` call on
   the wavefront and shell routes; for each Jacobi wavefront form (z-ring,
   shell with z slabs, shell without: the 511^3 ``auto`` route's) at the main
   path's shapes, m = 8, its device ms a call (torch.profiler) beside its
   CUDA-event ms and bound, and its launch plan
   (``jacobi_wavefront_launch``: marches, blocks an SM, waves, x chunks);
   the same for the wrap kernel at 512^3, k = 8 (the wrap route's call) and
   k = 1 (``jacobi_wrap_launch``), and for jacobi_plane_step at the shell
   route's (8, 258^3) (``jacobi_plane_launch``);
8. the Astaroth main path: ``AstarothSim(512, 512, 512, num_quantities=8,
   kernel_impl="cuda", schedule="wavefront")`` on one subdomain (the
   ``bench.py`` configuration: per-field stream_wavefront_pass launches at
   m = 3), then ``auto`` (the wrap route, stream_wrap_pass), ``per-step`` on
   2x2x2 (the plane route, stream_plane_pass) and ``auto`` on 2x2x2 (the
   wavefront again), 24 iterations each with the counters reset before and
   read after; every route bitwise equal to the first after those 24, the
   fields finite and inside [-1, 1]; then 2 x 24 timed iterations (the
   better is ms/iter and Mupdates/s = 8 * 512^3 / dt, as ``bench.py``), 24
   under torch.profiler (device time by kernel, idle share).  Before it, the
   same routes at 32^3 with 2 quantities against the torch engine, bitwise;
9. times of the three stream kernels at the main path's shapes, as phase 7;
   for the wavefront kernel at (1, 518^3) and (8, 262^3), m = 3, z slabs, its
   launch (form, blocks an SM, waves, x chunks) and device ms a launch
   (torch.profiler over 10 launches) beside its bound;
10. the slab route: ``Jacobi3D(512, 512, 512, kernel_impl="cuda",
    pallas_path="slab")`` on 2x2x2, 200 steps with the counters reset before
    and read after (one jacobi_slab_step launch per step, no halo written),
    bitwise equal to phase 4 at step 10, finite and inside [COLD, HOT] at
    step 200; Mcells/s and a torch.profiler breakdown;
11. uneven sizes: ``Jacobi3D(511, 511, 511, kernel_impl="cuda")`` on 2x2x2
    (256 + 255 cells a side, every axis padded): ``auto`` takes the plain
    wavefront and forced ``shell`` the plane kernel, 200 steps each with the
    counters reset before and read after, every +axis halo of the exchange
    written by blend_slab_dynamic; both bitwise equal to the one-subdomain
    511^3 wrap route at step 10; then ``AstarothSim(511, 511, 511,
    num_quantities=8, kernel_impl="cuda")`` on 2x2x2, ``auto`` (per-field
    plain wavefront) and ``per-step`` (plane), 24 iterations each, bitwise
    equal to the one-subdomain 511^3 wrap route; Mcells/s or ms/iter, and
    profiles;
12. times of jacobi_slab_step at the slab route's shapes (its device ms a
    call and launch plan, ``jacobi_slab_launch``, as phase 7) and of
    blend_slab_dynamic at the uneven wavefront's +x, +y and +z halo writes
    (CUDA-event ms and device ms a call on each axis, and the cached
    descriptor the +x write launches through), beside their bounds, plain
    versions and, for blend_slab_dynamic, the library call that makes the
    same write (``Tensor.scatter_`` with per-block indices);
13. the packed exchange routes: ``AstarothSim(512, 512, 512,
    num_quantities=8, kernel_impl="cuda", schedule="per-step",
    exchange_route=r)`` on 2x2x2 (the plane route, one 8-field exchange an
    iteration) for ``direct`` and the four packed routes, 24 iterations each
    with the counters reset before and read after: exactly 16 launches an
    iteration of each shell-pack kernel a route's packed sweeps use (8
    fields x 2 directions) and the matching blend_slab count; every route
    bitwise equal to phase 8's result; ms/iter and Mupdates/s (the
    better of 2 x 24 timed iterations), the ms of one 8-field
    ``dd.exchange()`` (median of 7 CUDA-event reps of 2 calls, host issue
    included) and its device ms (torch.profiler, 7 calls) and, on ``direct``
    and ``yzpack_pallas``, a torch.profiler breakdown (on ``yzpack_pallas``
    also the launches of 200 iterations); then the times of the four
    shell-pack kernels at that path's shapes (8 blocks of 262^3 f32, depth
    3), their plain versions and the library call that makes the same copy
    (``Tensor.copy_`` between the buffer and the permuted window of the
    block; for pack_yshell_pallas, which allocates its buffer, the
    allocating ``pack_yshell_xla``, with the ``copy_`` kept beside it), and
    each kernel's device ms a launch: in the ``yzpack_pallas`` profile (the
    window cold in L2, the ``device_ms`` of the kernels line) and back to
    back on one block (the window hot in the
    50 MB L2), beside the library call's back to back; the host µs a call
    (100 calls on the host clock, no synchronize between) of
    pack_yshell_pallas and unpack_yshell_pallas beside their library calls;
    each kernel's byte bound and, for the z pair, its sector floor (the
    32-byte sectors of the block that the window's runs touch,
    ``bench_kernels.zshell_sector_bytes``: read by the pack, filled and
    written back by the unpack, beside the buffer's bytes);
    then blend_slab at the same shapes, each axis's depth-3 low and high
    writes held against the plain version, and a launch's device ms back to
    back and in the ``direct`` profile, CUDA-event ms and host µs, beside
    ``narrow(...).copy_`` of the same write and the bound;
14. bench-pack: ``stencil_tpu_torch.bin.bench_pack.main`` in-process at
    ``--size 512`` (518^3 f32, radius 3) on the ``pallas`` backend (the slab
    kernels; exactly the launches bench-pack makes, counters reset before
    and read after), the ``xla`` backend (no kernel) and ``--inner 8``, its
    lines logged; then pallas_pack_slab and pallas_unpack_slab on each face,
    held bitwise against their plain versions and timed beside their bound,
    plain versions and the one PyTorch call that makes the same copy
    (``.contiguous()`` of the box, ``copy_`` into it), both device ms a
    launch back to back, the host µs a call of each kernel and its library
    call,
    and ``make_pack_fn`` (the uint8 buffer) against ``make_pack_fn_pallas``;
15. the mean6 kernels at full width, one 512^3 f32 subdomain with a radius-3
    shell (518^3 raw, the Astaroth proxy's geometry) of a periodic
    ``DistributedDomain``: 200 levels of ``dd.exchange()`` +
    mean6_plane_step, and 200 levels of one exchange + one
    mean6_shell_wavefront_step a pass (m = 3; 10 levels in passes of 3, 3, 3
    and 1, then 190 in 63 of 3 and 1 of 1), counters reset before each run
    and checked after; both bitwise equal at level 10 and 200 to the stream
    engine's ``plane`` route running a mean6 user kernel written in the
    kernels' order; each kernel held bitwise against its plain version and
    timed beside its bound (the wavefront kernel's device ms a call as well,
    and its launch plan at (518^3, m = 3), ``mean6_wavefront_launch``);
16. the fused halo and the split schedule: ``AstarothSim(512, 512, 512,
    num_quantities=8, kernel_impl="cuda")`` on 2x2x2, 24 iterations each
    with the counters reset before and read after: ``per-step`` on
    ``yzpack_pallas`` with ``stream_halo="fused"`` (the plane route's fused
    form; no unpack and no blend launch, 16 launches an iteration of each
    shell pack), ``auto`` on ``yzpack_pallas`` fused (the plain wavefront's
    fused form, m = 3), ``per-step`` on ``direct`` with
    ``stream_overlap="split"`` (the exchange on a second CUDA stream) and
    ``auto`` on ``direct`` split (the plain wavefront); each bitwise equal to
    phase 8's result, its ms/iter and Mupdates/s (the better of 2 x 24), and
    for the fused and split per-step runs a torch.profiler breakdown; then
    ``AstarothSim(511, ...)`` on 2x2x2 ``auto`` split, bitwise equal to phase
    11's 511^3 reference, and a fused request there, which degrades with its
    warning; then each fused form held bitwise against its plain version at
    (8, 262^3) (the plane form over 8 fields, the wavefront at m = 3) and
    timed beside its bound, its plain version and (device ms a call) its
    array form;
17. the one-dispatch step loop (``ops/captured.py``): each route run with
    ``capture=True`` (the step's loop replayed as CUDA graphs) beside the
    same route uncaptured, two calls each with the counters reset before
    and read after (equal), the valid interiors bitwise equal after them
    and at the end: Jacobi3D 512^3 ``wrap`` (one subdomain) and the z-ring
    ``wavefront`` on 2x2x2, 511^3 ``auto`` (the plain wavefront) and
    ``shell`` on 2x2x2, 200 steps a call; AstarothSim 8 x 512^3
    ``wavefront`` 1x1x1, ``auto`` and ``per-step`` on 2x2x2 under
    ``direct`` and ``yzpack_pallas``, both schedules fused
    (``yzpack_pallas``) and split (``direct``), 24 iterations a call; per
    run its ms/iter and Mcells/s (the better of two calls), the host µs of
    the call, a torch.profiler breakdown (idle share, device ms a step),
    and the captured loop's graphs, capture seconds and replays; then
    ``dd.exchange_many(24)`` against 24 ``dd.exchange()`` calls on the
    8-field 2x2x2 domain, stacks bitwise and launches equal, ms and host µs
    and the breakdown; every graph freed before the phase ends.
18. component (N-D) quantities and the debug oracles, 2x2x2: a (3,) f32
    vector beside a scalar (radius 3, faces, edges and corners; seeded
    with ``set_quantity``) and the same data as four scalar quantities, at
    512^3 on each of the five exchange routes and at 511^3 on ``direct``
    and ``yzpack_pallas`` (which degrades there, every axis padded, with
    its warning): 24 ``exchange()`` calls and ``exchange_many(24)``, each
    from the loaded stacks with the counters reset before and read after,
    the launches equal and as the route's sweeps predict, every stack
    bitwise equal to ``direct``'s vector domain; the ms an exchange of each
    domain, uncaptured and under ``exchange_many`` (CUDA events, the better
    of two runs of 24); kernels #9-#14 (#10 at 511^3) held against their
    plain versions on the vector's 24 blocks; the torch engine over the
    vector at 512^3 (radius 1, 4 steps): the mean-of-6 kernel with overlap
    on and off, captured and not, each bitwise equal to three scalar
    domains, and a component-mixing kernel (indexing and ``torch.stack``)
    equal across the four, at 512^3 to ``curl_roll18`` (the same operations
    with ``torch.roll`` on the logical fields, on the card) and, at 64^3, to
    its CPU run; the AllGather and
    RollCompare oracles on two scalars at 512^3 (the vector's first two
    components), bitwise equal to
    ``direct``, ``exchange()`` and ``exchange_many`` alike, with their ms
    an exchange; every domain freed before the phase ends.
19. the Jacobi kernel axes (``ops/jacobi_kernels.py``): every new form of
    rows 1-5 held against its plain version on the card, on ragged blocks
    that both spheres cross at k/m = 1, 4 and 8 (the wrap kernel; the z-ring,
    shell-with-slabs and plain shell wavefronts, two marches at m = 8) and
    on the plane and slab kernels, then at the main path's shapes: bf16
    storage (``f32_accumulate``) on ``vpu`` bitwise; the tensor-core
    contraction (``mxu`` / ``mxu_band``) within 4 ulps a level on f32
    operands and ``tests/ulp.py``'s ``mxu_bf16_input_atol`` on bf16 ones,
    on bf16 storage within one bf16 ulp; the largest ulps measured printed;
    each form's times beside its plain version's and its bound (bytes at the
    storage itemsize, or tensor-core FLOPs over 495 TFLOP/s TF32 or 989
    bf16, whichever is larger; ``bench_kernels.jacobi_bound``).  Then the
    routes at full width, 200 steps each with the counters reset before
    and read after: ``Jacobi3D(512^3)`` ``wrap``, the z-ring and z-slab
    wavefronts and forced ``shell`` and ``slab`` on 2x2x2, each in f32 vpu
    and under bf16 storage, and ``wrap`` and both wavefronts under
    ``mxu_band`` on f32 and on bf16 operands: each held against the f32 vpu
    run of its route (``bf16_storage_atol`` of its kernel calls, 4 ulps a
    step, ``mxu_bf16_input_atol``), finite and inside [COLD, HOT], its
    Mcells/s beside the f32 vpu run's (and the same three axis runs of the
    plain wavefront at 511^3, uneven); then ``bench.py``'s ``mxu_vs_vpu``
    A/B on the wrap kernel (``bench_kernels.mxu_vs_vpu_times``).
20. the stream kernels' field dtypes (rows 6-8): every bf16-storage and
    float64 form held bitwise against its plain version on ragged blocks
    (the Astaroth kernel's wrap at k = 1 and 3, the plane kernel in both
    forms, its wavefront and the 27-point kernel's at m = 1 and 3, z-slab
    and fused) and at the main path's shapes (8 fields of 512^3, k = 1; 8
    fields of (8, 262^3) array and fused; one field of (1, 518^3) m = 3
    with z slabs, and of (8, 262^3) fused), each form's CUDA-event ms and
    device ms beside its float32 form's, its plain version's and its bound,
    with the ptxas registers and spills of its library
    (``bench_kernels.stream_dtype_times``); then ``AstarothSim(512^3, 8
    fields)`` under ``storage_dtype="bf16"`` (``wavefront`` and ``auto`` on
    1x1x1; on 2x2x2 ``per-step`` under ``direct`` and ``yzpack_pallas``,
    ``per-step`` fused, ``auto``, ``auto`` fused, ``auto`` split, and
    ``auto`` at 511^3) and under ``dtype=torch.float64`` on the same
    routes, 24 iterations each with the counters reset before and read
    after: every launch under the dtype's form and none under the float32
    one, finite, held against the float32 run of its route (phases 8, 11,
    13 and 16: ``bf16_storage_atol`` of its passes; float64 within the
    float32 run's own rounding, ``f32_rounding_atol``), its ms/iter (the
    better of two runs of 24) beside the float32 run's; and the bf16
    ``wavefront`` run captured against uncaptured, bitwise.
21. float64 on the Jacobi kernels (rows 1-5) and bf16 storage and float64
    on the mean-of-6 kernels (rows 17-18): every new form held bitwise
    against its plain version on ragged blocks that both spheres cross (the
    wrap kernel at k = 1, 4 and 8; the z-ring, z-slab and plain shell
    wavefronts at m = 4 and 8, one march and two; the plane and slab
    kernels; #17 at m = 3 and 8 and #18 under both dtypes), then at the main
    path's shapes (512^3 wrap at k = 8; on 2x2x2 the z-ring (8, 264, 264,
    256) and z-slab (8, 264^3) wavefronts at the f64 plan's m = 4, the plane
    (8, 258^3) and slab (8, 256^3) kernels; #17 m = 3 and #18 at 518^3),
    each form's CUDA-event and device ms beside its float32 form's on the
    same data, its plain version's and its bound (bytes at the storage
    itemsize, or f64 operations over 34 TFLOP/s), its launch plan and the
    float64 library's ptxas registers and spills; then ``Jacobi3D(512^3,
    dtype=torch.float64, kernel_impl="cuda")`` on ``wrap`` (1x1x1), the
    z-ring and z-slab wavefronts, ``shell`` and ``slab`` (2x2x2) and
    ``auto`` at 511^3, 200 steps each with the counters reset before and
    read after: every launch under the f64 form and none under the f32
    one, bitwise equal to the f64 plain path (k = 1 wrap calls) at step 10
    and within rtol 1e-14 of the f64 torch engine, finite and inside [COLD,
    HOT] at step 200, its Mcells/s beside phase 19's f32 run of the route;
    the f64 ``wrap`` run captured against uncaptured, bitwise; and 24
    levels of exchange + #18 and of exchange + #17 (m = 3) on a periodic
    512^3 domain with a radius-3 shell under bf16 storage and at f64 (f64
    plane and wavefront bitwise equal, bf16 within ``bf16_storage_atol`` of
    its roundings of the f64 run).
22. the tensor-core contraction form (``compute_unit`` ``mxu`` /
    ``mxu_band``, ``mxu_input`` ``f32`` / ``bf16``) of the stream kernels
    (rows 6-8) and the mean-of-6 kernels (rows 17-18): every form held
    against its plain version on ragged blocks (#6 at k = 3 and over a
    2 x 1 plane, #7 over two blocks, #8 in the register-queue form with z
    slabs and in the general form, #17 at m = 3 and 8, #18; f32 storage and
    bf16 storage) within the card's bound (4 ulps a level on f32 operands,
    ``mxu_bf16_input_atol`` on bf16 ones, a bf16 ulp under bf16 storage),
    then at the main path's shapes (``bench_kernels.stream_mxu_times``: #6
    over 8 Astaroth fields of 512^3 at k = 1, #7 over 8 fields of (8,
    262^3), #8 of one field at m = 3 with z slabs at (1, 518^3), #17 at m =
    3 and #18 over 518^3), each form's CUDA-event and device ms beside its
    vpu form's, its plain version's and its bound (``jacobi_bound``: bytes,
    f32 or tensor-core operations); then ``AstarothSim(512^3, 8 fields,
    kernel_impl="cuda")`` under ``compute_unit="mxu"`` and under
    ``"mxu_band"`` with ``mxu_input="bf16"`` on ``auto`` (1x1x1, wrap),
    ``wavefront`` (1x1x1) and ``per-step`` (2x2x2, plane), 24 iterations
    each with the counters reset before and read after: every launch under
    the contraction form and none under the vpu one, finite, held against
    the phase-8 f32 vpu run within ``mxu_vs_vpu_atol`` (the reassociation
    bound of ``tests/test_kernel_axes.py``'s ``test_stream_mxu_matches_vpu``,
    4 roundings a level at the six-sum's magnitude, plus the card's 4 ulps a
    level, plus the bf16-input bound on bf16 operands), its ms/iter beside
    the vpu run's; and 24 levels of exchange + #18 and of exchange + #17 (m
    = 3) on a periodic 512^3 domain with a radius-3 shell under each unit,
    held against the same run under ``vpu`` within that bound.
23. the tensor-core contraction under the fused halo and the split
    schedule: the fused forms of #7 and #8 under ``mxu`` (f32 operands) and
    ``mxu_band`` (bf16 operands) held against their plain versions on
    ragged blocks with random shell buffers (#7 over two blocks with uneven
    shells, the shell passed through bitwise; #8 in the register-queue form
    at m = 3 and the general form at m = 2; f32 and bf16 storage), then at
    the main path's shapes (``bench_kernels.stream_fused_mxu_times``: #7
    over 8 Astaroth fields of (8, 262^3), #8 of one field at m = 3, (8, 6,
    262, 262) buffers a field), each form's CUDA-event and device ms beside
    the vpu fused form's and the array contraction form's, its plain
    version's and its bound; then ``AstarothSim(512^3, 8 fields)`` on
    2x2x2 under each unit, ``per-step`` fused and ``auto`` fused on
    ``yzpack_pallas``, ``auto`` split and ``per-step`` split on ``direct``,
    24 iterations each with the counters reset before and read after: every
    pass under the fused contraction form (fused) or the array contraction
    form (split: the interior pass and six band passes a group), none under
    the vpu ones, finite, held against the phase-8 f32 vpu run within
    ``mxu_vs_vpu_atol``, its ms/iter (the better of two runs of 24) beside
    phase 16's vpu run of the same schedule and, on the plane route, phase
    22's array contraction run.

``torch.cuda.reset_peak_memory_stats()`` runs as each phase starts, and each
phase's peak device memory goes to ``phase_peak_gb``.

Phase 2 builds the stream kernels (templates plus the traced Astaroth
kernel's emitted body, the mean6 reference's, and the bodies the phase-3
checks use) in the same
parallel nvcc batch as the other sources; phase 3 also holds every stream
kernel against its plain version, on ragged shapes (a 27-point and a
coordinate-forced kernel, two joint fields, and two joint fields read off
the centre at x+-1: both forms of the wavefront kernel) and at the main
path's shapes.

Then it prints the card line, one ``{"kernels": [...]}`` JSON line and, as the
last line, ``{"ok": true, "device": {...}}``.  The full record also goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N = 512  # the reference's default domain, 512^3 f32
STEPS = 200
CHECK_AT = 10
AST_Q = 8  # the real Astaroth's field count (bench.py's astaroth section)
AST_ITERS = 24  # bench.py's astaroth iterations
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
OUT_DIR = "chiprun_out"


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 7, inner: int = 5) -> float:
    """Median ms per call over ``reps`` timed reps of ``inner`` calls each,
    after one dropped warm-up rep."""
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times[1:])


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seeded(shape, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def logical18(t: torch.Tensor, shell: int = 1) -> torch.Tensor:
    """A quantity's ``(*components, px, py, pz, Xr, Yr, Zr)`` stack with a
    ``shell``-wide halo on every side as its logical ``(*components, X, Y,
    Z)`` field: each block's interior placed at its grid position (an even
    split, so every block holds the same cells)."""
    t = t[..., shell:-shell, shell:-shell, shell:-shell]
    c = t.dim() - 6
    p, n = t.shape[c:c + 3], t.shape[c + 3:]
    perm = [*range(c), c, c + 3, c + 1, c + 4, c + 2, c + 5]
    return t.permute(perm).reshape(*t.shape[:c], *(a * b for a, b in zip(p, n)))


def curl_roll18(v: torch.Tensor, s: torch.Tensor, steps: int):
    """Phase 18's component-mixing kernel on the logical periodic fields
    ``v`` (3, X, Y, Z) and ``s`` (X, Y, Z) with ``torch.roll``, one
    elementwise op at a time in the kernel's own order (``sh(dx, dy, dz)``
    reads the cell at +d, a roll by -d): a reference that shares nothing
    with the domain, its exchange or the traced engine."""
    half_, quarter = (torch.full((), c, dtype=v.dtype, device=v.device) for c in (0.5, 0.25))

    def sh(c, dx, dy, dz):
        return torch.roll(v[c], shifts=(-dx, -dy, -dz), dims=(0, 1, 2))

    for _ in range(steps):
        w0 = sh(2, 0, 1, 0) - sh(2, 0, -1, 0) - sh(1, 0, 0, 1) + sh(1, 0, 0, -1)
        w1 = sh(0, 0, 0, 1) - sh(0, 0, 0, -1) - sh(2, 1, 0, 0) + sh(2, -1, 0, 0)
        w2 = sh(1, 1, 0, 0) - sh(1, -1, 0, 0) - sh(0, 0, 1, 0) + sh(0, 0, -1, 0)
        v, s = v + half_ * torch.stack([w0, w1, w2], dim=0), s - w0 * quarter
    return v, s


def k27_kernel(views, info):
    """The 27-point user kernel of ``__graft_entry__.py``."""
    src, acc = views["u"], 0.0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                acc = acc + src.sh(dx, dy, dz) / (2.0 ** (abs(dx) + abs(dy) + abs(dz)))
    return {"u": acc / 8.0}


def forced_kernel(views, info):
    """Coordinate forcing (tests/test_stream.py) that also reads the level."""
    src = views["u"]
    cx, cy, cz = info.coords()
    g = info.global_size
    val = (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, -1, 0)) / 4.0
    d2 = (cx - g.x // 2) ** 2 + (cy - g.y // 2) ** 2 + (cz - g.z // 2) ** 2
    return {"u": torch.where(d2 < 9, 1.0, val * info.level)}


def xdiag_kernel(views, info):
    """Two joint fields that read x+-1 off the centre (the general form of
    the wavefront kernel)."""
    u, c = views["u"], views["c"]
    return {"u": (u.sh(1, 1, 0) + c.sh(-1, 0, 1) + u.sh(0, -1, -1)) / 3.0, "c": c.sh(-1, 0, 0) * 0.5 + u.center()}


def mean6_kernel(views, info):
    """The mean of the six face neighbours, summed in the mean6 kernels'
    order (x-1, x+1, y-1, y+1, z-1, z+1)."""
    u = views["u"]
    return {"u": (u.sh(-1, 0, 0) + u.sh(1, 0, 0) + u.sh(0, -1, 0) + u.sh(0, 1, 0) + u.sh(0, 0, -1)
                  + u.sh(0, 0, 1)) / 6.0}


def device_breakdown(model, steps: int = 20) -> dict:
    """``steps`` steps of a built model under torch.profiler: wall ms per step
    (profiler on), device ms per step by CUDA kernel, and the device's idle
    share of the wall time.  A trace that holds no launch is taken again
    (``steps`` more steps), twice at most; after three such traces the
    device numbers are None, the miss is logged and kept in
    ``PROFILER_MISSES``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.step(steps)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        kernels = {
            e.key[:72]: e.self_device_time_total / 1e3 / steps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        }
        if kernels:
            busy = sum(kernels.values())
            return {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
                    "idle_share": 1 - busy / wall_ms, "kernels_ms_per_step": kernels}
    PROFILER_MISSES.append({"fn": f"device_breakdown({type(model).__name__}, {steps} steps)"})
    log(f"torch.profiler held no kernel launch in three traces of {steps} steps of {type(model).__name__}")
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": None, "idle_share": None,
            "kernels_ms_per_step": {}}


PROFILER_MISSES = []  # readings that CUDA events took because no trace held a launch


def device_ms_per_call(fn, calls: int = 7, per_call: int = None) -> float:
    """Device ms per call of ``fn`` under torch.profiler (the host's issue
    time, which CUDA events between calls would count, left out): each CUDA
    kernel's mean time over the launches the trace holds, times its launches
    a call.  The trace can drop launches (on the H100's machine a trace
    held none, and others read 0.8x: PERF.md), so the self time is not
    divided by ``calls``; a trace that holds no launch is taken again, and
    after five such traces the reading is the CUDA-event ms of ``calls``
    back-to-back calls, logged and kept in ``PROFILER_MISSES``.  Where the
    caller knows a call's kernel launches (``per_call``) the reading is the
    mean over all launches held times that (whole traces held one of a wrap
    call's two same-named marches: PERF.md)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            sync()
        kept = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        if kept:
            if per_call:
                return sum(e.self_device_time_total for e in kept) / sum(e.count for e in kept) * per_call / 1e3
            return sum(e.self_device_time_total / e.count * max(1, round(e.count / calls)) for e in kept) / 1e3
    ms = cuda_ms(fn, reps=3, inner=calls)
    where = f"{getattr(fn, '__qualname__', repr(fn))} ({calls} calls)"
    PROFILER_MISSES.append({"fn": where, "cuda_event_ms": ms})
    log(f"torch.profiler held no kernel launch in five traces of {where}: CUDA events read {ms:.4f} ms a call")
    return ms


def host_us_per_call(fn, calls: int = 100) -> float:
    """Host µs a call of ``fn`` over ``calls`` calls with no synchronize
    between them (the issue time), then one synchronize."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    sync()
    return dt / calls * 1e6


def plan_str(plan: dict) -> str:
    """A kernel's launch plan on one line."""
    return ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in plan.items())


def ms4(v) -> str:
    """A reading to four places, or "not measured" where it is None."""
    return "not measured" if v is None else f"{v:.4f}"


def log_breakdown(route: str, b: dict) -> None:
    if b["idle_share"] is None:
        log(f"profile {route}: wall {b['wall_ms_per_step']:.4f} ms/step (profiler on), device time not measured "
            "(no trace held a launch)")
        return
    top = sorted(b["kernels_ms_per_step"].items(), key=lambda kv: -kv[1])
    log(f"profile {route}: wall {b['wall_ms_per_step']:.4f} ms/step (profiler on), device busy "
        f"{b['device_ms_per_step']:.4f} ms/step, idle share {b['idle_share']:.3f}; "
        + "; ".join(f"{k} {v:.4f}" for k, v in top))


def phase18(card: str, dev: torch.device, nu: int) -> dict:
    """Phase 18 (see the module's docstring): components on every exchange
    route, the torch engine over a vector, the debug oracles; returns the
    phase's record.  Every domain it makes is freed before it returns."""
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.ops import halo_blend as hb
    from stencil_tpu_torch.ops import pack as pk
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES
    from stencil_tpu_torch.utils.config import MethodFlags

    t18 = time.perf_counter()

    def log18(msg: str) -> None:
        log(f"[phase 18 +{time.perf_counter() - t18:.1f} s] {msg}")

    nd18 = {"card": card, "exchange": {}, "kernels_vs_plain": {}, "torch_engine": {}, "oracles": {}}
    vec18, sca18 = ("v", (3,)), ("s", ())
    comps18 = (("v0", ()), ("v1", ()), ("v2", ()), sca18)  # the vector's components as scalars, and s

    def domain18(size, quantities, route="direct", radius=3, methods=None):
        """A 2x2x2 domain of ``size``^3 and its handles; the RuntimeWarnings
        that realize() gave (a packed route degrading)."""
        dd = DistributedDomain(size, size, size)
        dd.set_radius(Radius.face_edge_corner(radius, radius, radius))
        dd.set_partition(2, 2, 2)
        dd.set_exchange_route(route)
        if methods is not None:
            dd.set_methods(methods)
        hs = [dd.add_data(n, components=c) for n, c in quantities]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dd.realize()
        return dd, hs, [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]

    def load18(dd, hs, stacks):
        for h, t in zip(hs, stacks):
            dd.get_curr(h).copy_(t)

    def exchanges18(dd, many, n=AST_ITERS):
        if many:
            dd.exchange_many(n)
        else:
            for _ in range(n):
                dd.exchange()

    def exchange_ms18(dd, many):
        """ms an exchange: CUDA events, the better of two runs of 24."""
        runs = []
        for _ in range(2):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            sync()
            start.record()
            exchanges18(dd, many)
            stop.record()
            stop.synchronize()
            runs.append(start.elapsed_time(stop) / AST_ITERS)
        return min(runs), runs

    def seeded18(size):
        """The phase's seeded vector and scalar, (3, size^3) and (size^3) f32 on the host."""
        rng = np.random.default_rng(18)
        return rng.random((3, size, size, size), dtype=np.float32), rng.random((size,) * 3, dtype=np.float32)

    def same18(a, b, what):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"phase 18: {what}")

    # every route's exchange of a (3,) vector beside a scalar, and of the same
    # data as four scalars: 24 exchange() calls and exchange_many(24), each
    # from the loaded (un-exchanged) stacks with the counters reset before
    # and read after; every result bitwise equal to direct's vector domain
    #: per route, the launches one exchange of one quantity makes at an even size
    per_q18 = {
        "direct": {"blend_slab": 6}, "zpack_xla": {"blend_slab": 6}, "yzpack_xla": {"blend_slab": 6},
        "zpack_pallas": {"blend_slab": 4, "pack_zshell_pallas": 2, "unpack_zshell_pallas": 2},
        "yzpack_pallas": {"blend_slab": 2, "pack_zshell_pallas": 2, "unpack_zshell_pallas": 2,
                          "pack_yshell_pallas": 2, "unpack_yshell_pallas": 2},
    }
    for size, routes in ((N, EXCHANGE_ROUTES), (nu, ("direct", "yzpack_pallas"))):
        vec_h, sca_h = seeded18(size)
        base, bh, _ = domain18(size, (vec18, sca18))
        base.set_quantity(bh[0], vec_h)
        base.set_quantity(bh[1], sca_h)
        ref = [base.get_curr(h).clone() for h in bh]  # loaded, not exchanged
        del base, bh, vec_h, sca_h
        torch.cuda.empty_cache()
        want = None
        for route in routes:
            vd, vh, warned = domain18(size, (vec18, sca18), route)
            sd, sh, _ = domain18(size, comps18, route)
            if size == nu and route != "direct" and not (warned and vd.exchange_route() == "direct"):
                raise AssertionError(f"{route} at {size}^3 (every axis padded) did not degrade to direct")
            res = {"resolved": vd.exchange_route(), "warnings": warned}
            for dd, hs, stacks, key in ((vd, vh, ref, "vector"),
                                        (sd, sh, [ref[0][0], ref[0][1], ref[0][2], ref[1]], "scalars")):
                launches = {}
                for many in (False, True):
                    load18(dd, hs, stacks)
                    ledger.reset_launch_counts()
                    sync()
                    exchanges18(dd, many)
                    sync()
                    launches[many] = ledger.launch_counts()
                    got = [dd.get_curr(h) for h in hs]
                    if want is None:
                        want = [g.clone() for g in got]
                    elif key == "vector":
                        same18(got, want, f"{route} {size}^3 vector exchange{'_many' if many else ''} != direct")
                    else:
                        same18(got, [want[0][0], want[0][1], want[0][2], want[1]],
                               f"{route} {size}^3 scalar domain{'_many' if many else ''} != the vector's components")
                if launches[False] != launches[True]:
                    raise AssertionError(f"{route} {size}^3 {key}: exchange_many launches {launches[True]} != "
                                         f"exchange() {launches[False]}")
                used = {k: v for k, v in launches[False].items() if v}
                if size == N:
                    expect = {k: v * AST_ITERS * len(hs) for k, v in per_q18[route].items()}
                else:  # every axis padded: low halos by blend_slab, high halos by blend_slab_dynamic
                    expect = {"blend_slab": 3 * AST_ITERS * len(hs), "blend_slab_dynamic": 3 * AST_ITERS * len(hs)}
                if used != expect:
                    raise AssertionError(f"{route} {size}^3 {key}: launches {used}, want {expect}")
                res[key] = {"launches": used}
            for dd, key in ((vd, "vector"), (sd, "scalars")):
                ms, runs = exchange_ms18(dd, False)
                ms_many, runs_many = exchange_ms18(dd, True)
                loop = dd._exchange_loop
                res[key].update(ms_per_exchange=ms, ms_runs=runs, many_ms_per_exchange=ms_many,
                                many_ms_runs=runs_many, graphs=len(loop.graphs), replays=loop.replays)
                loop.release()
            v, s = res["vector"], res["scalars"]
            log18(f"components {size}^3 2x2x2 r=3 {route} (resolved {res['resolved']}): ms an exchange, (3,) + scalar "
                f"-> four scalars: {v['ms_per_exchange']:.4f} -> {s['ms_per_exchange']:.4f} uncaptured, "
                f"{v['many_ms_per_exchange']:.4f} -> {s['many_ms_per_exchange']:.4f} exchange_many; launches "
                f"{v['launches']} / {s['launches']}; bitwise equal to direct and to the scalars on {card}")
            nd18["exchange"][f"{size} {route}"] = res
            del vd, sd, vh, sh, dd, hs, stacks, got, loop
            torch.cuda.empty_cache()

        # kernels #9-#14 on the vector's 24 blocks, against their plain versions
        blocks = want[0].view(-1, *want[0].shape[-3:])
        nb, X = blocks.shape[0], blocks.shape[1]
        errs18 = {}

        def held(name, kernel, plain):
            got, exp = kernel(), plain()
            sync()
            errs18[name] = max_err(got, exp)
            if errs18[name] != 0.0:
                raise AssertionError(f"phase 18: {name} on the vector's {nb} blocks != its plain version")

        if size == N:
            zbuf, ybuf = seeded((nb, 3, X, X), 181, dev), seeded((nb, 3, X, X), 182, dev)
            held("pack_zshell_pallas", lambda: pk.pack_zshell_pallas(blocks, 3, 3),
                 lambda: pk.pack_zshell_pallas_plain(blocks, 3, 3))
            held("pack_yshell_pallas", lambda: pk.pack_yshell_pallas(blocks, 3, 3),
                 lambda: pk.pack_yshell_pallas_plain(blocks, 3, 3))
            held("unpack_zshell_pallas", lambda: pk.unpack_zshell_pallas(blocks.clone(), zbuf, X - 3, 3),
                 lambda: pk.unpack_zshell_pallas_plain(blocks.clone(), zbuf, X - 3, 3))
            held("unpack_yshell_pallas", lambda: pk.unpack_yshell_pallas(blocks.clone(), ybuf, X - 3, 3),
                 lambda: pk.unpack_yshell_pallas_plain(blocks.clone(), ybuf, X - 3, 3))
            held("blend_slab", lambda: hb.blend_slab(blocks.clone(), zbuf.transpose(1, 3).contiguous(), 2, 0),
                 lambda: hb.blend_slab_plain(blocks.clone(), zbuf.transpose(1, 3).contiguous(), 2, 0))
            del zbuf, ybuf
        else:
            slab = seeded((nb, 3, X, X), 183, dev)
            half = -(-size // 2)  # each subdomain's padded width; the last holds size - half
            pos = torch.tensor([3 + (size - half if ix == 1 else half) for _ in range(3) for ix in range(2)
                                for _ in range(4)], dtype=torch.int32, device=dev)
            held("blend_slab_dynamic", lambda: hb.blend_slab_dynamic(blocks.clone(), slab, 0, pos),
                 lambda: hb.blend_slab_dynamic_plain(blocks.clone(), slab, 0, pos))
            del slab, pos
        nd18["kernels_vs_plain"][str(size)] = errs18
        if size == N:
            ref512 = ref  # the torch engine and the oracles start from it
        log18(f"kernels on the (3,) vector's {nb} blocks of {X}^3 ({size}^3 2x2x2): {sorted(errs18)} bitwise equal "
            f"to their plain versions on {card}")
        del ref, want, blocks
        torch.cuda.empty_cache()

    # the torch engine over the vector: mean-of-6, 4 steps, overlap on and
    # off, captured and not, each bitwise equal to three scalar domains; the
    # component-mixing kernel equal across the four and, at 512^3, to
    # curl_roll18 on the card (torch.roll over the logical fields), and at
    # 64^3 to its CPU run
    def mean6_v(views, info):
        src = views["v"]
        return {"v": (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0)
                      + src.sh(0, -1, 0) + src.sh(0, 0, 1) + src.sh(0, 0, -1)) / 6.0}

    def curl_v(views, info):
        v = views["v"]
        w0 = v.sh(0, 1, 0)[2] - v.sh(0, -1, 0)[2] - v.sh(0, 0, 1)[1] + v.sh(0, 0, -1)[1]
        w1 = v.sh(0, 0, 1)[0] - v.sh(0, 0, -1)[0] - v.sh(1, 0, 0)[2] + v.sh(-1, 0, 0)[2]
        w2 = v.sh(1, 0, 0)[1] - v.sh(-1, 0, 0)[1] - v.sh(0, 1, 0)[0] + v.sh(0, -1, 0)[0]
        return {"v": v.center() + 0.5 * torch.stack([w0, w1, w2], dim=0), "s": views["s"].center() - w0 * 0.25}

    STEPS18 = 4
    ref = [torch.zeros((*r.shape[:-3], *(e - 4 for e in r.shape[-3:])), device=dev) for r in ref512]
    for r1, r3 in zip(ref, ref512):  # the same seeded interior in a radius-1 shell
        r1[..., 1:-1, 1:-1, 1:-1] = r3[..., 3:-3, 3:-3, 3:-3]
    del r1, r3
    scalars = []
    for c in range(3):
        sd, sh, _ = domain18(N, (("v", ()),), radius=1)
        load18(sd, sh, [ref[0][c]])
        sd.run_step(sd.make_step(mean6_v), STEPS18)
        scalars.append(sd.get_curr(sh[0]).clone())
        del sd, sh
    torch.cuda.empty_cache()
    eng = {}
    for kernel_name, kernel in (("mean6", mean6_v), ("mixing", curl_v)):
        first = None
        for overlap in (True, False):
            for capture in (False, True):
                dd, hs, _ = domain18(N, (vec18, sca18), radius=1)
                load18(dd, hs, ref)
                dd.set_capture(capture)
                step = dd.make_step(kernel, overlap=overlap)
                ledger.reset_launch_counts()
                sync()
                t0 = time.perf_counter()
                dd.run_step(step, STEPS18 // 2)
                dd.run_step(step, STEPS18 - STEPS18 // 2)
                sync()
                dt = time.perf_counter() - t0
                got = [dd.get_curr(h).clone() for h in hs]
                if capture and not step.captured:
                    raise AssertionError(f"phase 18: the captured {kernel_name} step holds no CUDA graph")
                if kernel_name == "mean6":
                    same18(got[0], scalars, f"vector mean6 (overlap {overlap}, capture {capture}) != three scalar domains")
                if first is None:
                    first = got
                    if not all(bool(torch.isfinite(g).all()) for g in got):
                        raise AssertionError(f"phase 18: {kernel_name} gave non-finite values")
                    if kernel_name == "mixing":
                        want_v, want_s = curl_roll18(logical18(ref[0]), logical18(ref[1]), STEPS18)
                        same18([logical18(got[0]), logical18(got[1])], [want_v, want_s],
                               f"the mixing kernel at {N}^3 != torch.roll over the logical fields")
                        del want_v, want_s
                else:
                    same18(got, first, f"{kernel_name} (overlap {overlap}, capture {capture}) != overlap, uncaptured")
                eng[f"{kernel_name} overlap={overlap} capture={capture}"] = {
                    "s_for_steps": dt, "steps": STEPS18, "launches": {k: v for k, v in ledger.launch_counts().items() if v}}
                step._loop.release()
                del dd, hs, step, got
                torch.cuda.empty_cache()
        del first
    del ref, scalars
    torch.cuda.empty_cache()
    # the mixing kernel on the card against its CPU run, 64^3 on 2x2x2
    small = {}
    for device in ("cpu", "cuda"):
        dd = DistributedDomain(64, 64, 64, device=device)
        dd.set_radius(1)
        dd.set_partition(2, 2, 2)
        hs = [dd.add_data(n, components=c) for n, c in (vec18, sca18)]
        dd.realize()
        rng = np.random.default_rng(184)
        dd.set_quantity(hs[0], rng.random((3, 64, 64, 64), dtype=np.float32))
        dd.set_quantity(hs[1], rng.random((64, 64, 64), dtype=np.float32))
        dd.run_step(dd.make_step(curl_v), STEPS18)
        small[device] = [dd.quantity_to_host(h) for h in hs]
    if not all(np.array_equal(a, b) for a, b in zip(small["cpu"], small["cuda"])):
        raise AssertionError("phase 18: the mixing kernel at 64^3 on the card != its CPU run")
    del small
    nd18["torch_engine"] = eng
    log18(f"torch engine, (3,) vector {N}^3 2x2x2 r=1, {STEPS18} steps: mean6 bitwise equal to three scalar domains, "
        f"overlap on/off and captured/uncaptured alike; the mixing kernel (index + torch.stack) equal across the "
        f"four, to torch.roll over the logical {N}^3 fields, and to its CPU run at 64^3 on {card}")

    # the debug oracles: two scalars at 512^3 on 2x2x2, radius 3, against
    # direct, loaded with the seeded vector's first two components
    ref = [ref512[0][0], ref512[0][1]]
    want = None
    for name, method in (("direct", None), ("AllGather", MethodFlags.AllGather),
                         ("RollCompare", MethodFlags.RollCompare)):
        dd, hs, _ = domain18(N, (("a", ()), ("b", ())), methods=method)
        out = {}
        for many in (False, True):
            load18(dd, hs, ref)
            exchanges18(dd, many, 2)
            sync()
            got = [dd.get_curr(h) for h in hs]
            if want is None:
                want = [g.clone() for g in got]
            else:
                same18(got, want, f"{name} exchange{'_many' if many else ''} != direct")
        ms, runs = exchange_ms18(dd, False)
        ms_many, runs_many = exchange_ms18(dd, True)
        dd._exchange_loop.release()
        nd18["oracles"][name] = {"ms_per_exchange": ms, "ms_runs": runs, "many_ms_per_exchange": ms_many,
                                 "many_ms_runs": runs_many}
        log18(f"exchange method {name}, two scalars {N}^3 2x2x2 r=3: {ms:.4f} ms an exchange, {ms_many:.4f} under "
            f"exchange_many; bitwise equal to direct on {card}")
        del dd, hs, got
        torch.cuda.empty_cache()
    del ref, ref512, want
    torch.cuda.empty_cache()
    log18(f"phase 18 done: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    return nd18


def ulp_dist(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place between two float32
    or bfloat16 tensors of one dtype (their bits on a line where adjacent
    values differ by 1, -0 on +0: ``tests/ulp.py``'s ``ulp_diff``)."""
    it, fold = (torch.int32, -(2 ** 31)) if a.dtype == torch.float32 else (torch.int16, -(2 ** 15))
    ai, bi = (t.contiguous().view(it).long() for t in (a, b))
    ai = torch.where(ai < 0, fold - ai, ai)
    bi = torch.where(bi < 0, fold - bi, bi)
    return int((ai - bi).abs().max()) if a.numel() else 0


def mxu_bf16_input_atol(levels: int, scale: float, taps: int = 4) -> float:
    """``tests/ulp.py``'s bound for bf16 contraction operands against f32
    ones: one rounding of each of the four in-plane operands a level."""
    return levels * taps * 2.0 ** -9 * scale


def bf16_storage_atol(passes: int, scale: float = 1.0) -> float:
    """``tests/ulp.py``'s bound for bf16 storage against f32: one rounding a
    pass (a store) and one of the input."""
    return (passes + 1) * 2.0 ** -9 * scale


#: phase 19's forms of the Jacobi kernels: the ledger's name suffix ->
#: (compute unit, operand precision, storage) of the run that stands for it
AXIS_FORMS = {"bf16": ("vpu", "f32", "bf16"), "mxu": ("mxu_band", "f32", "native"),
              "mxu_bf16in": ("mxu_band", "bf16", "native")}


def phase19(card: str, dev: torch.device) -> dict:
    """Phase 19 (see the module's docstring): the Jacobi kernel axes, bf16
    storage and the tensor-core contraction, on rows 1-5; returns the
    phase's record with, under ``forms``, each new form's kernels-line
    numbers."""
    from stencil_tpu_torch.bin import bench_kernels as bk
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.models.jacobi import COLD_TEMP, HOT_TEMP, Jacobi3D
    from stencil_tpu_torch.ops import jacobi_kernels as jk

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' contractions at full f32
    rec = {"checks": [], "routes": {}, "forms": {}, "max_ulps": {}}
    errs = {}

    def hold(form: str, got, want, unit: str, mi: str, storage: str, levels: int, what: str) -> None:
        """Hold a form against its plain version: bf16 storage on vpu
        bitwise; a contraction within 4 ulps a level (f32 operands) or
        ``mxu_bf16_input_atol`` (bf16 operands); under bf16 storage a
        contraction within one bf16 ulp (its f32 levels within those bounds,
        rounded once)."""
        sync()
        err = max_err(got, want)
        ulps = ulp_dist(got, want)
        errs[form] = max(errs.get(form, 0.0), err)
        rec["max_ulps"][form] = max(rec["max_ulps"].get(form, 0), ulps)
        if unit == "vpu":
            ok, limit = torch.equal(got, want), "bitwise"
        elif storage == "bf16":
            ok, limit = ulps <= 1, "1 bf16 ulp"
        elif mi == "f32":
            ok, limit = ulps <= 4 * levels, f"{4 * levels} ulps"
        else:
            atol = mxu_bf16_input_atol(levels, float(want.abs().max()))
            ok, limit = err <= atol, f"atol {atol:.3e}"
        rec["checks"].append({"form": form, "what": what, "unit": unit, "mxu_input": mi, "storage": storage,
                              "levels": levels, "max_abs_err": err, "ulps": ulps, "limit": limit, "ok": ok})
        if not (ok and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{form} {what}: kernel against plain version: max abs err {err}, {ulps} ulps, "
                                 f"limit {limit}")

    def combos(storages=("native", "bf16")):
        """(form, unit, operands, storage) of every axis value but f32 vpu;
        a contraction on bf16 storage counts under its unit's form."""
        for storage in storages:
            for unit, mi in (("vpu", "f32"), ("mxu_band", "f32"), ("mxu", "bf16")):
                if unit == "vpu" and storage == "native":
                    continue
                form = "bf16" if unit == "vpu" else ("mxu" if mi == "f32" else "mxu_bf16in")
                yield form, unit, mi, storage

    def as_storage(t, storage):
        return t.to(torch.bfloat16) if storage == "bf16" else t

    # -- each new form against its plain version: ragged blocks that both
    # spheres cross at k/m = 1, 4, 8, then the main path's shapes
    t0 = time.perf_counter()
    for k in (1, 4, 8):
        block = seeded((40, 36, 70), 190 + k, dev)
        for form, unit, mi, storage in combos():
            b = as_storage(block, storage)
            kw = dict(compute_unit=unit, mxu_input=mi, f32_accumulate=storage == "bf16")
            hold(f"jacobi_wrap_step_{form}", jk.jacobi_wrap_step(b, k, **kw), jk.jacobi_wrap_step_plain(b, k, **kw),
                 unit, mi, storage, k, f"(40,36,70) k={k}")
        for ring, slabs in ((True, True), (False, True), (False, False)):
            s = k
            n, Xr, Yr = 2, 2 * s + 21, 2 * s + 33
            Z = 128 if ring else 2 * s + 70
            zv = Z - 1 if slabs and not ring else Z
            gs = (2 * s + 30, Yr - 2 * s + 3, (Z if ring else zv - 2 * s) + 5)
            raw = seeded((n, Xr, Yr, Z), 200 + k, dev)
            org = torch.tensor([[3, 1, 2], [9, 4, 0]], dtype=torch.int32, device=dev)
            if ring:
                d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s, int(o[2]), s, Yr, Z, gs, dev) for o in org])
            else:
                d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s, int(o[2]) - s, (Yr, Z), gs, dev) for o in org])
            zs = seeded((n, Xr, 2 * s, Yr), 201 + k, dev) if slabs else None
            name = "jacobi_zring_wavefront_step" if ring else "jacobi_shell_wavefront_step"
            S, zsl = slice(s, -s), (slice(None) if ring else slice(s, zv - s))
            for form, unit, mi, storage in combos():
                r_, z_ = as_storage(raw, storage), None if zs is None else as_storage(zs, storage)
                kw = dict(compute_unit=unit, mxu_input=mi, f32_accumulate=storage == "bf16")
                if ring:
                    got = jk.jacobi_zring_wavefront_step(r_, k, org, d2, gs, z_, **kw)
                    want = jk.jacobi_zring_wavefront_step_plain(r_, k, org, d2, gs, z_, **kw)
                else:
                    kw.update(z_slabs=z_, z_valid=zv)
                    got = jk.jacobi_shell_wavefront_step(r_, k, org, d2, gs, **kw)
                    want = jk.jacobi_shell_wavefront_step_plain(r_, k, org, d2, gs, **kw)
                if not slabs:
                    got, want = (got,), (want,)
                what = f"({n},{Xr},{Yr},{Z}) m={k} {'ring' if ring else 'slabs' if slabs else 'plain'}"
                hold(f"{name}_{form}", got[0][:, S, S, zsl], want[0][:, S, S, zsl], unit, mi, storage, k, what)
                if slabs:
                    hold(f"{name}_{form}", got[1][:, S, :, S], want[1][:, S, :, S], unit, mi, storage, k,
                         what + " z_out")
    for which, shape in (("plane", (3, 20, 37, 70)), ("slab", (3, 18, 36, 70))):
        n, X, Y, Z = shape
        gs = (X + 11, Y + 3, Z + 5)
        org = torch.tensor([[1, 2, 3], [7, 0, 1], [4, 5, 6]], dtype=torch.int32, device=dev)
        inner = (Y - 2, Z - 2) if which == "plane" else (Y, Z)
        d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), inner, gs, dev) for o in org])
        b = seeded(shape, 210, dev).to(torch.bfloat16)
        if which == "plane":
            got = jk.jacobi_plane_step(b, org, d2, gs, f32_accumulate=True)
            want = jk.jacobi_plane_step_plain(b, org, d2, gs, f32_accumulate=True)
        else:
            faces = [seeded(f, 211 + j, dev).to(torch.bfloat16)
                     for j, f in enumerate([(n, Y, Z)] * 2 + [(n, X, Z)] * 2 + [(n, X, Y)] * 2)]
            got = jk.jacobi_slab_step(b, *faces, org, d2, gs, f32_accumulate=True)
            want = jk.jacobi_slab_step_plain(b, *faces, org, d2, gs, f32_accumulate=True)
        hold(f"jacobi_{which}_step_bf16", got, want, "vpu", "f32", "bf16", 1, str(shape))
    log(f"phase 19: every form against its plain version on ragged blocks, {len(rec['checks'])} checks, "
        f"{time.perf_counter() - t0:.1f} s; max ulps " + ", ".join(f"{k} {v}" for k, v in rec["max_ulps"].items()))

    # the main path's shapes: 512^3 (wrap, k = 8), and on 2x2x2 the z-ring
    # (8, 272, 272, 256) and shell (8, 272^3) wavefronts at m = 8 with z
    # slabs, the plane (8, 258^3) and slab (8, 256^3) kernels; each form's
    # times (CUDA events and device ms a call) beside its plain version's
    # and its bound (bench_kernels.jacobi_bound), at its storage itemsize
    half, m, gs = N // 2, 8, (N, N, N)
    r = half + 2 * m
    borg = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)],
                        dtype=torch.int32, device=dev)
    cases = {}
    block = seeded((N, N, N), 220, dev)
    cases["jacobi_wrap_step"] = (
        block, lambda b, **kw: jk.jacobi_wrap_step(b, 8, **kw), lambda b, **kw: jk.jacobi_wrap_step_plain(b, 8, **kw),
        lambda item, unit, mi: bk.jacobi_bound(2 * N ** 3 * item, N ** 3 * 8, unit, mi), f"({N},{N},{N}) k=8", 8,
        lambda t: t)
    ring_raw = seeded((8, r, r, half), 221, dev)
    ring_zs = seeded((8, r, 2 * m, r), 222, dev)
    ring_d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - m, int(o[2]), m, r, half, gs, dev) for o in borg])
    cases["jacobi_zring_wavefront_step"] = (
        (ring_raw, ring_zs), lambda t, **kw: jk.jacobi_zring_wavefront_step(t[0], m, borg, ring_d2, gs, t[1], **kw),
        lambda t, **kw: jk.jacobi_zring_wavefront_step_plain(t[0], m, borg, ring_d2, gs, t[1], **kw),
        lambda item, unit, mi: bk.jacobi_bound(bk.wavefront_bytes(8, r, r, half + 2 * m, m, m, True, item),
                                               8 * half ** 3 * m, unit, mi),
        f"(8,{r},{r},{half}) m={m}, z slabs (8,{r},{2 * m},{r})", m,
        lambda o: (o[0][:, m:-m, m:-m], o[1][:, m:-m, :, m:-m]))
    sh_raw = seeded((8, r, r, r), 223, dev)
    sh_d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - m, int(o[2]) - m, (r, r), gs, dev) for o in borg])
    cases["jacobi_shell_wavefront_step"] = (
        (sh_raw, ring_zs),
        lambda t, **kw: jk.jacobi_shell_wavefront_step(t[0], m, borg, sh_d2, gs, z_slabs=t[1], z_valid=r, **kw),
        lambda t, **kw: jk.jacobi_shell_wavefront_step_plain(t[0], m, borg, sh_d2, gs, z_slabs=t[1], z_valid=r, **kw),
        lambda item, unit, mi: bk.jacobi_bound(bk.wavefront_bytes(8, r, r, r, m, m, True, item), 8 * half ** 3 * m,
                                               unit, mi),
        f"(8,{r},{r},{r}) m={m}, z slabs (8,{r},{2 * m},{r}), z_valid={r}", m,
        lambda o: (o[0][:, m:-m, m:-m, m:-m], o[1][:, m:-m, :, m:-m]))
    pl_blocks = seeded((8, half + 2, half + 2, half + 2), 224, dev)
    pl_d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in borg])
    cases["jacobi_plane_step"] = (
        pl_blocks, lambda b, **kw: jk.jacobi_plane_step(b, borg, pl_d2, gs, f32_accumulate=True),
        lambda b, **kw: jk.jacobi_plane_step_plain(b, borg, pl_d2, gs, f32_accumulate=True),
        lambda item, unit, mi: bk.jacobi_bound((2 * pl_blocks.numel()) * item + (pl_d2.numel() + 24) * 4,
                                               8 * half ** 3),
        f"(8,{half + 2},{half + 2},{half + 2})", 1, lambda t: t)
    sl_block = seeded((8, half, half, half), 225, dev)
    sl_faces = [seeded((8, half, half), 226 + j, dev) for j in range(6)]
    sl_d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in borg])
    cases["jacobi_slab_step"] = (
        (sl_block, *sl_faces),
        lambda t, **kw: jk.jacobi_slab_step(t[0], *t[1:], borg, sl_d2, gs, f32_accumulate=True),
        lambda t, **kw: jk.jacobi_slab_step_plain(t[0], *t[1:], borg, sl_d2, gs, f32_accumulate=True),
        lambda item, unit, mi: bk.jacobi_bound((2 * sl_block.numel() + 6 * half * half * 8) * item
                                               + (sl_d2.numel() + 24) * 4, 8 * half ** 3),
        f"(8,{half},{half},{half}), six face slabs (8,{half},{half})", 1, lambda t: t)

    for name, (inputs, call, plain, bound_of, shape, levels, valid) in cases.items():
        forms = ("bf16",) if name in ("jacobi_plane_step", "jacobi_slab_step") else tuple(AXIS_FORMS)
        for form in forms:
            unit, mi, storage = AXIS_FORMS[form]
            kw = {"f32_accumulate": True} if storage == "bf16" else {"compute_unit": unit, "mxu_input": mi}
            ins = (tuple(as_storage(t, storage) for t in inputs) if isinstance(inputs, tuple)
                   else as_storage(inputs, storage))
            got, want = valid(call(ins, **kw)), valid(plain(ins, **kw))
            for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
                hold(f"{name}_{form}", g, w, unit, mi, storage, levels, shape)
            del got, want
            fn = (lambda ins=ins, kw=kw: call(ins, **kw))
            item = 2 if storage == "bf16" else 4
            b = bound_of(item, unit, mi)
            rec["forms"][f"{name}_{form}"] = {
                "ms": cuda_ms(fn, inner=2),
                "device_ms": device_ms_per_call(fn, per_call=levels // jk.WAVEFRONT_SUB_DEPTH or 1),
                "plain_ms": cuda_ms(lambda ins=ins, kw=kw: plain(ins, **kw), reps=3, inner=1),
                "bound": (b["bound_ms"], b["bound_by"]), "bound_of": b["bound_of"],
                "tensor_core_flops": b["tensor_core_flops"], "shape": f"{shape} "
                + ("bf16 storage" if storage == "bf16" else f"{unit}, {mi} operands"),
                "launch": (jk.jacobi_wrap_launch((N, N, N), 8, unit, mi, storage) if name == "jacobi_wrap_step"
                           else jk.jacobi_wavefront_launch(tuple(ins[0].shape), m, ring="zring" in name, slabs=True,
                                                           compute_unit=unit, mxu_input=mi, storage=storage)
                           if "wavefront" in name else None)}
            f = rec["forms"][f"{name}_{form}"]
            log(f"{name}_{form} {f['shape']}: CUDA events {f['ms']:.4f} ms a call, device {f['device_ms']:.4f} "
                f"(plain {f['plain_ms']:.4f}), bound {f['bound'][0]:.4f} ms ({f['bound_of']}); max ulps against "
                f"the plain version {rec['max_ulps'][f'{name}_{form}']} on {card}")
            del ins
    del cases, block, ring_raw, ring_zs, sh_raw, pl_blocks, sl_block, sl_faces
    torch.cuda.empty_cache()

    # -- the routes at full width: 200 steps each, the counters reset before
    # and read after, held against the f32 vpu run of the same route
    def run(label: str, grid: bool, size: int = N, **kw) -> dict:
        model = Jacobi3D(size, size, size, kernel_impl="cuda", **kw)
        if grid:
            model.dd.set_partition(2, 2, 2)
        model.realize()
        ledger.reset_launch_counts()
        sync()
        model.step(CHECK_AT)
        sync()
        t0 = time.perf_counter()
        model.step(STEPS - CHECK_AT)
        sync()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in ledger.launch_counts().items() if v}
        final = torch.from_numpy(model.temperature())
        kernel = {"wrap": "jacobi_wrap_step", "shell": "jacobi_plane_step", "slab": "jacobi_slab_step",
                  "wavefront": "jacobi_zring_wavefront_step" if model._wavefront_z_ring
                  else "jacobi_shell_wavefront_step"}[model._pallas_path]
        res = {"path": model._pallas_path, "compute_unit": model._compute_unit, "mxu_input": model._mxu_input,
               "storage": model.dd.storage_dtype(), "m": model._wavefront_m, "kernel": kernel, "launches": counts,
               "mcells_per_s": size ** 3 * (STEPS - CHECK_AT) / seconds / 1e6, "final": final}
        if not (torch.isfinite(final).all() and final.min() >= COLD_TEMP and final.max() <= HOT_TEMP):
            raise AssertionError(f"phase 19 {label}: field not finite or outside [COLD, HOT] after {STEPS} steps")
        del model
        torch.cuda.empty_cache()
        return res

    routes = {"wrap": (False, {}), "wavefront z-ring": (True, {}),
              "wavefront z-slab": (True, {"pallas_path": "wavefront", "z_ring": False}),
              f"wavefront plain {N - 1}^3": (True, {"size": N - 1}),
              "shell": (True, {"pallas_path": "shell"}), "slab": (True, {"pallas_path": "slab"})}
    axis_runs = {"bf16": {"storage_dtype": "bf16"}, "mxu": {"compute_unit": "mxu_band"},
                 "mxu_bf16in": {"compute_unit": "mxu_band", "mxu_input": "bf16"}}
    for route, (grid, kw) in routes.items():
        ref = run(f"{route} f32 vpu", grid, **kw)
        rec["routes"][route] = {"f32 vpu": {k: v for k, v in ref.items() if k != "final"}}
        for form, axes in axis_runs.items():
            if route in ("shell", "slab") and form != "bf16":
                continue
            got = run(f"{route} {form}", grid, **kw, **axes)
            name = f"{ref['kernel']}_{form}"
            calls = got["launches"].get(name, 0)
            want_calls = ref["launches"][ref["kernel"]]
            if got["kernel"] != ref["kernel"] or calls != want_calls or got["m"] != ref["m"]:
                raise AssertionError(f"phase 19 {route} {form}: kernel {got['kernel']} m={got['m']}, "
                                     f"{calls} launches of {name} against {want_calls} of the f32 vpu run")
            err = float((got["final"].double() - ref["final"].double()).abs().max())
            if form == "bf16":
                limit = bf16_storage_atol(calls)
                ok = err <= limit
            elif form == "mxu":
                limit = 4 * STEPS
                ok = ulp_dist(got["final"], ref["final"]) <= limit
            else:
                limit = mxu_bf16_input_atol(STEPS, 1.0)
                ok = err <= limit
            entry = {k: v for k, v in got.items() if k != "final"}
            entry.update(max_abs_err_vs_f32_vpu=err, ulps_vs_f32_vpu=ulp_dist(got["final"], ref["final"]),
                         limit=limit, launches_of_form=calls)
            rec["routes"][route][form] = entry
            log(f"phase 19 {route} {form}: {got['mcells_per_s']:.1f} Mcells/s against {ref['mcells_per_s']:.1f} "
                f"(f32 vpu, same call); {calls} launches of {name}; max abs err against f32 vpu {err:.3e} "
                f"({entry['ulps_vs_f32_vpu']} ulps, limit {limit}) on {card}")
            if not ok:
                raise AssertionError(f"phase 19 {route} {form}: {err} against the f32 vpu run exceeds {limit}")
            if name in rec["forms"] and "counts" not in rec["forms"][name]:  # its first route's run
                rec["forms"][name]["counts"] = got["launches"]
                rec["forms"][name]["want"] = want_calls
            del got
        del ref
        torch.cuda.empty_cache()

    missing = [name for name, f in rec["forms"].items() if "counts" not in f]
    if missing:
        raise AssertionError(f"phase 19: no route run launched {missing}")

    # -- item 7's A/B: bench.py's mxu_vs_vpu on the wrap kernel, 512^3, k = 8
    rec["mxu_vs_vpu"] = bk.mxu_vs_vpu_times(dev)
    log(f"phase 19 mxu_vs_vpu ({bk.N}^3, k=8, ms a dispatch): "
        + ", ".join(f"{k} {u['ms_per_dispatch']:.4f} (device {u['device_ms']:.4f}, bound {u['bound_ms']:.4f})"
                    for k, u in rec["mxu_vs_vpu"]["units"].items())
        + f"; speed-ups against vpu {rec['mxu_vs_vpu']['speedups_vs_vpu']} on {card}")
    rec["errs"] = errs
    return rec


def f32_rounding_atol(levels: int, scale: float = 6.0) -> float:
    """How far a float32 mean-of-6 run may lie from the float64 one after
    ``levels`` levels: seven roundings a level (six adds and the multiply)
    of at most half an ulp at the six-sum's magnitude ``scale``, carried
    unamplified by the mean, and the input's one rounding."""
    return (7 * levels + 1) * 2.0 ** -24 * scale


#: phase 20's Astaroth runs: key -> (schedule, grid, exchange route, stream
#: halo, stream overlap, size less than N), and the phase-8/11/13/16 float32
#: run of the same route (the record, its key) it is held against
AST20 = {
    "wavefront 1x1x1": ("wavefront", None, None, "auto", "auto", 0, ("ast", "wavefront 1x1x1")),
    "auto 1x1x1": ("auto", None, None, "auto", "auto", 0, ("ast", "auto 1x1x1")),
    "per-step 2x2x2 direct": ("per-step", (2, 2, 2), "direct", "auto", "auto", 0, ("routes_13", "direct")),
    "per-step 2x2x2 yzpack_pallas": ("per-step", (2, 2, 2), "yzpack_pallas", "auto", "auto", 0,
                                     ("routes_13", "yzpack_pallas")),
    "per-step fused": ("per-step", (2, 2, 2), "yzpack_pallas", "fused", "auto", 0, ("f16", "per-step fused")),
    "auto 2x2x2": ("auto", (2, 2, 2), None, "auto", "auto", 0, ("ast", "auto 2x2x2")),
    "auto fused": ("auto", (2, 2, 2), "yzpack_pallas", "fused", "auto", 0, ("f16", "auto fused")),
    "auto split": ("auto", (2, 2, 2), "direct", "auto", "split", 0, ("f16", "auto split")),
    "auto uneven 2x2x2": ("auto", (2, 2, 2), None, "auto", "auto", 1, ("ast_u", "auto")),
}


def phase20(card: str, dev: torch.device, refs: dict, f32_runs: dict) -> dict:
    """Phase 20 (see the module's docstring): the stream kernels' field
    dtypes, bf16 storage and float64, on rows 6-8.  ``refs``: the float32
    interiors after ``AST_ITERS`` iterations at 512^3 and 511^3 (host
    tensors, every float32 route's); ``f32_runs``: the float32 route
    records by ``AST20``'s keys.  Returns the phase's record with, under
    ``forms``, each new form's kernels-line numbers."""
    from stencil_tpu_torch.bin import bench_kernels as bk
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    rec = {"checks": [], "forms": {}, "routes": {}, "times": {}}
    errs = {}
    dtypes = {"bf16": torch.bfloat16, "f64": torch.float64}
    ast_kernel = AstarothSim(8, 8, 8, device=dev)._kernel

    def hold(form: str, got, want, what: str) -> None:
        """A kernel against its plain version: bitwise."""
        sync()
        got, want = (list(got), list(want)) if isinstance(got, (list, tuple)) else ([got], [want])
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                err = max_err(g, w) if g.dtype == w.dtype else float("nan")
                raise AssertionError(f"phase 20 {form} {what}: kernel against plain version: max abs err {err}, "
                                     f"dtypes {g.dtype} / {w.dtype}")
        errs[form] = 0.0
        rec["checks"].append({"form": form, "what": what, "bitwise": True})

    def rand(shape, seed, dt):
        return bk.device_rand(shape, seed, dev, dt)

    # -- every form against its plain version on ragged blocks: the
    # Astaroth kernel (the wavefront's queue form; its libraries are the main
    # path's) and the 27-point kernel (the general form), k/m = 1 and 3; two
    # joint fields and float32 with float64 are the card tests'
    t0 = time.perf_counter()
    gs_r = (30, 40, 140)
    for dname, dt in dtypes.items():
        for kname, fn, names in (("astaroth", ast_kernel, ["d0"]), ("k27", k27_kernel, ["u"])):
            sk = StreamKernel(fn, names, 1, gs_r, dtypes=[dt] * len(names))
            blocks = [rand((19, 21, 70), 400 + q, dt) for q in range(len(names))]
            org1 = torch.tensor([3, 1, 2], dtype=torch.int32, device=dev)
            for k in (1, 3) if kname == "astaroth" else ():
                hold(f"stream_wrap_pass_{dname}", st.stream_wrap_pass(sk, names, blocks, k, org1, gs_r),
                     st.stream_wrap_pass_plain(sk, names, blocks, k, org1, gs_r), f"{kname} (19,21,70) k={k}")
            lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
            n, X, Y, Z = 2, 17, 19, 70
            raws = [rand((n, X, Y, Z), 410 + q, dt) for q in range(len(names))]
            org2 = torch.tensor([[0, 0, 0], [13, 17, 60]], dtype=torch.int32, device=dev)
            fs = tuple([rand((n, w, a, b), seed + q, dt) for q in range(len(names))]
                       for seed, (w, a, b) in ((420, (lo.x + hi.x, Y, Z)), (430, (lo.y + hi.y, X, Z)),
                                               (440, (lo.z + hi.z, Y, X))))
            for fused in (None, fs) if kname == "astaroth" else ():
                form = f"stream_plane_pass_{'fused_' if fused else ''}{dname}"
                hold(form, st.stream_plane_pass(sk, names, raws, lo, hi, 1, org2, gs_r, fused_shell=fused),
                     st.stream_plane_pass_plain(sk, names, raws, lo, hi, 1, org2, gs_r, fused_shell=fused),
                     f"{kname} {(n, X, Y, Z)}")
            s, n, Xr, Yr, Zr = 3, 2, 64, 100, 77
            S = slice(s, -s)
            raws = [rand((n, Xr, Yr, Zr), 450 + q, dt) for q in range(len(names))]
            zs = [rand((n, Xr, 2 * s, Yr), 460 + q, dt) for q in range(len(names))]
            fs = tuple([rand((n, 2 * s, a, b), seed + q, dt) for q in range(len(names))]
                       for seed, (a, b) in ((470, (Yr, Zr)), (480, (Xr, Zr)), (490, (Yr, Xr))))
            org2 = torch.tensor([[gs_r[0] - 2, 7, 3], [4, 30, 40]], dtype=torch.int32, device=dev)
            for m in (1, 3):
                zv = Zr - 2
                got, gz = st.stream_wavefront_pass(sk, names, raws, m, s, org2, gs_r, z_slabs=zs, z_valid=zv)
                want, wz = st.stream_wavefront_pass_plain(sk, names, raws, m, s, org2, gs_r, z_slabs=zs, z_valid=zv)
                hold(f"stream_wavefront_pass_{dname}", [g[:, S, S, s:zv - s] for g in got] + [g[:, S, :, S] for g in gz],
                     [w[:, S, S, s:zv - s] for w in want] + [w[:, S, :, S] for w in wz],
                     f"{kname} {(n, Xr, Yr, Zr)} m={m} z slabs")
                got, _ = st.stream_wavefront_pass(sk, names, raws, m, s, org2, gs_r, fused_shell=fs)
                want, _ = st.stream_wavefront_pass_plain(sk, names, raws, m, s, org2, gs_r, fused_shell=fs)
                hold(f"stream_wavefront_pass_fused_{dname}", [g[:, S, S, S] for g in got],
                     [w[:, S, S, S] for w in want], f"{kname} {(n, Xr, Yr, Zr)} m={m} fused")
            del raws, zs, fs, blocks
    log(f"phase 20: every dtype form against its plain version on ragged blocks, bitwise, {len(rec['checks'])} "
        f"checks, {time.perf_counter() - t0:.1f} s")

    # -- the main path's shapes: each form bitwise against its plain version,
    # then its times beside the float32 form's and its bound
    # (bench_kernels.stream_dtype_times: CUDA events, device ms, the plan,
    # ptxas registers and spills)
    t0 = time.perf_counter()
    half, s, m = N // 2, 3, 3
    ext, ws = half + 2 * s, N + 2 * s
    shell = Dim3(s, s, s)
    gs = (N, N, N)
    org8 = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)], dtype=torch.int32,
                        device=dev)
    names8 = [f"d{q}" for q in range(AST_Q)]
    for dname, dt in dtypes.items():
        sk8 = StreamKernel(ast_kernel, names8, 1, gs, dtypes=[dt] * AST_Q)
        sk1 = StreamKernel(ast_kernel, names8[:1], 1, gs, dtypes=[dt])
        plain_ms = {}
        blocks = [rand(gs, 500 + q, dt) for q in range(AST_Q)]
        org0 = torch.zeros(3, dtype=torch.int32, device=dev)
        hold(f"stream_wrap_pass_{dname}", st.stream_wrap_pass(sk8, names8, blocks, 1, org0, gs),
             st.stream_wrap_pass_plain(sk8, names8, blocks, 1, org0, gs), f"{AST_Q} x {gs} k=1")
        plain_ms["wrap"] = cuda_ms(lambda: st.stream_wrap_pass_plain(sk8, names8, blocks, 1, org0, gs), reps=3,
                                   inner=1)
        del blocks
        torch.cuda.empty_cache()
        raws = [rand((8, ext, ext, ext), 510 + q, dt) for q in range(AST_Q)]
        fs = tuple([rand((8, 2 * s, ext, ext), 520 + 3 * q + j, dt) for q in range(AST_Q)] for j in range(3))
        for key, fused in (("plane", None), ("plane fused", fs)):
            form = f"stream_plane_pass_{'fused_' if fused else ''}{dname}"
            hold(form, st.stream_plane_pass(sk8, names8, raws, shell, shell, 1, org8, gs, fused_shell=fused),
                 st.stream_plane_pass_plain(sk8, names8, raws, shell, shell, 1, org8, gs, fused_shell=fused),
                 f"{AST_Q} x (8,{ext},{ext},{ext})")
            plain_ms[key] = cuda_ms(lambda fused=fused: st.stream_plane_pass_plain(
                sk8, names8, raws, shell, shell, 1, org8, gs, fused_shell=fused), reps=3, inner=1)
        del raws, fs
        torch.cuda.empty_cache()
        raw = [rand((1, ws, ws, ws), 530, dt)]
        zs = [rand((1, ws, 2 * s, ws), 531, dt)]
        orgw = torch.zeros(1, 3, dtype=torch.int32, device=dev)
        S = slice(s, -s)
        got, gz = st.stream_wavefront_pass(sk1, names8[:1], raw, m, s, orgw, gs, z_slabs=zs, z_valid=ws)
        want, wz = st.stream_wavefront_pass_plain(sk1, names8[:1], raw, m, s, orgw, gs, z_slabs=zs, z_valid=ws)
        hold(f"stream_wavefront_pass_{dname}", [got[0][:, S, S, S], gz[0][:, S, :, S]],
             [want[0][:, S, S, S], wz[0][:, S, :, S]], f"(1,{ws},{ws},{ws}) m=3 z slabs")
        del got, gz, want, wz
        plain_ms["wavefront"] = cuda_ms(lambda: st.stream_wavefront_pass_plain(
            sk1, names8[:1], raw, m, s, orgw, gs, z_slabs=zs, z_valid=ws), reps=3, inner=1)
        del raw, zs
        torch.cuda.empty_cache()
        raws = [rand((8, ext, ext, ext), 540, dt)]
        fs = tuple([rand((8, 2 * s, ext, ext), 541 + j, dt)] for j in range(3))
        got, _ = st.stream_wavefront_pass(sk1, names8[:1], raws, m, s, org8, gs, fused_shell=fs)
        want, _ = st.stream_wavefront_pass_plain(sk1, names8[:1], raws, m, s, org8, gs, fused_shell=fs)
        hold(f"stream_wavefront_pass_fused_{dname}", got[0][:, S, S, S], want[0][:, S, S, S],
             f"(8,{ext},{ext},{ext}) m=3 fused")
        del got, want
        plain_ms["wavefront fused"] = cuda_ms(lambda: st.stream_wavefront_pass_plain(
            sk1, names8[:1], raws, m, s, org8, gs, fused_shell=fs), reps=3, inner=1)
        del raws, fs
        torch.cuda.empty_cache()
        # the float32 forms timed once, beside the bf16 ones
        times = bk.stream_dtype_times(dev, dname, device_ms=lambda call, n: device_ms_per_call(call, per_call=n),
                                      f32=dname == "bf16")
        rec["times"][dname] = times
        times = dict(rec["times"]["bf16"], **times)
        for key, form, shape in (("wrap", "stream_wrap_pass", f"{AST_Q} fields x ({N},{N},{N}), k=1"),
                                 ("plane", "stream_plane_pass", f"{AST_Q} fields x (8,{ext},{ext},{ext}), shell 3"),
                                 ("plane fused", "stream_plane_pass_fused",
                                  f"{AST_Q} fields x (8,{ext},{ext},{ext}), buffers (8,6,{ext},{ext}) x 3"),
                                 ("wavefront", "stream_wavefront_pass",
                                  f"1 field x (1,{ws},{ws},{ws}) m=3 s=3, z slabs (1,{ws},6,{ws})"),
                                 ("wavefront fused", "stream_wavefront_pass_fused",
                                  f"1 field x (8,{ext},{ext},{ext}) m=3 s=3, buffers x 3")):
            tkey = f"{key} {dname}" if key != "wrap" else f"wrap {dname} k=1"
            fkey = f"{key} f32" if key != "wrap" else "wrap f32 k=1"
            t, f = times[tkey], times[fkey]
            rec["forms"][f"{form}_{dname}"] = {
                "ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": plain_ms[key],
                "bound": (t["bound_ms"], t["bound_by"]), "f32_ms": f["ms"], "f32_device_ms": f["device_ms"],
                "shape": f"{shape}, {dname}", "launch": t.get("launch"), "ptxas": t["ptxas"]}
            r = rec["forms"][f"{form}_{dname}"]
            log(f"{form}_{dname} {r['shape']}: CUDA events {r['ms']:.4f} ms a call, device {r['device_ms']:.4f} "
                f"(f32 form {f['ms']:.4f}, device {f['device_ms']:.4f}; plain {r['plain_ms']:.4f}), bound "
                f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); ptxas "
                + ", ".join(f"{e.get('registers')} regs {e.get('spill_stores', 0)}/{e.get('spill_loads', 0)} B spill"
                            for e in r["ptxas"]) + f" on {card}")
        torch.cuda.empty_cache()
    log(f"phase 20: main-path shapes held and timed in {time.perf_counter() - t0:.1f} s")

    # -- Astaroth at full width under each dtype: 24 iterations with the
    # counters reset before and read after, held against the float32 run of
    # its route; the better of two timed runs of 24
    def interiors_of(sim, size) -> list:
        lo, n = sim.dd.shell_radius().lo(), sim.dd.local_spec().sz
        dim = sim.dd.grid_dim()
        return [sim.dd.get_curr(h)[..., lo.x:lo.x + n.x, lo.y:lo.y + n.y, lo.z:lo.z + n.z]
                .permute(0, 3, 1, 4, 2, 5).reshape(dim.x * n.x, dim.y * n.y, dim.z * n.z)[:size, :size, :size]
                for h in sim.handles]

    def build_sim(key, dname, capture=False):
        schedule, part, route, halo, overlap, less, _ = AST20[key]
        size = N - less
        kw = {"storage_dtype": "bf16"} if dname == "bf16" else {"dtype": torch.float64}
        sim = AstarothSim(size, size, size, num_quantities=AST_Q, kernel_impl="cuda", schedule=schedule,
                          exchange_route=route, stream_halo=halo, stream_overlap=overlap, capture=capture, **kw)
        if part is not None:
            sim.dd.set_partition(*part)
        sim.realize()
        return sim

    for dname in ("bf16", "f64"):  # every route above under each
        for key in AST20:
            size = N - AST20[key][5]
            rec_name, rkey = AST20[key][6]
            f32 = f32_runs[rec_name][rkey]
            sim = build_sim(key, dname)
            plan = sim._step._stream_plan
            ledger.reset_launch_counts()
            sync()
            sim.step(AST_ITERS)
            sync()
            counts = {k: v for k, v in ledger.launch_counts().items() if v}
            route = plan["route"]
            fused = plan["halo"] == "fused"
            kernel = f"stream_{route}_pass{'_fused' if fused else ''}"
            form = f"{kernel}_{dname}"
            # a launch a level (wrap), a step (plane) or a macro (wavefront),
            # per group, and six band passes beside each under split
            groups = AST_Q if plan["grouping"] == "per-field" else 1
            want = groups * (AST_ITERS if route != "wavefront" else -(-AST_ITERS // plan["m"])) \
                * (7 if plan["overlap"] == "split" else 1)
            if counts.get(form, 0) != want or counts.get(kernel, 0) or route != f32.get("route", route):
                raise AssertionError(f"phase 20 astaroth {key} {dname}: plan {plan}, launches {counts}, want {want} "
                                     f"of {form} and none of {kernel} (the f32 run: {f32['launches'][kernel]})")
            # roundings a field: one a pass (a wrap call of k levels, a macro of m)
            passes = AST_ITERS if route == "plane" else -(-AST_ITERS // plan["m"])
            ref = refs[size]
            err = 0.0
            finite = True
            for q, got in enumerate(interiors_of(sim, size)):
                finite = finite and bool(torch.isfinite(got).all())
                err = max(err, float((got.double() - ref[q].to(dev).double()).abs().max()))
            limit = bf16_storage_atol(passes) if dname == "bf16" else f32_rounding_atol(AST_ITERS)
            dts = []
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                sim.step(AST_ITERS)
                sync()
                dts.append((time.perf_counter() - t0) / AST_ITERS)
            dt = min(dts)
            entry = {"route": route, "m": plan["m"], "f32_m": f32.get("m"), "grouping": plan["grouping"],
                     "f32_launches": f32["launches"][kernel], "halo": plan["halo"],
                     "overlap": plan["overlap"], "z_slabs": plan["z_slabs"], "launches": counts,
                     "launches_of_form": counts[form], "max_abs_err_vs_f32": err, "limit": limit, "passes": passes,
                     "ms_per_iter": dt * 1e3, "ms_per_iter_runs": [t * 1e3 for t in dts],
                     "f32_ms_per_iter": f32["ms_per_iter"], "mupdates_per_s": AST_Q * size ** 3 / dt / 1e6}
            rec["routes"][f"{key} {dname}"] = entry
            log(f"phase 20 astaroth {AST_Q}q {size}^3 {key} {dname} ({route}, m={plan['m']}, {plan['grouping']}): "
                f"{dt * 1e3:.4f} ms/iter against {f32['ms_per_iter']:.4f} (f32, phase {rec_name}); {counts[form]} "
                f"launches of {form}; max abs err against f32 {err:.3e} (limit {limit:.3e}) on {card}")
            if not finite or err > limit:
                raise AssertionError(f"phase 20 astaroth {key} {dname}: finite {finite}, {err} against the f32 run "
                                     f"exceeds {limit}")
            fe = rec["forms"].get(form)
            if fe is not None and "counts" not in fe:
                fe["counts"], fe["want"] = counts, want
            del sim
            torch.cuda.empty_cache()

    # -- capture: one bf16 route captured against uncaptured, bitwise
    outs = []
    for capture in (False, True):
        sim = build_sim("wavefront 1x1x1", "bf16", capture=capture)
        ledger.reset_launch_counts()
        sim.step(AST_ITERS)
        sync()
        outs.append((ledger.launch_counts()["stream_wavefront_pass_bf16"], interiors_of(sim, N)))
        if capture and not getattr(sim._step, "captured", None):
            raise AssertionError("phase 20: the captured bf16 run holds no CUDA graph")
        del sim
    (ca, a), (cb, b) = outs
    if ca != cb or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"phase 20: captured bf16 wavefront != uncaptured ({ca}, {cb} launches)")
    rec["captured_bf16_wavefront"] = {"bitwise": True, "launches": ca}
    log(f"phase 20: bf16 wavefront 1x1x1 captured bitwise equal to uncaptured, {ca} launches each")
    del outs, a, b
    torch.cuda.empty_cache()
    missing = [name for name, f in rec["forms"].items() if "counts" not in f]
    if missing:
        raise AssertionError(f"phase 20: no route run launched {missing}")
    rec["errs"] = errs
    return rec


#: phase 21's float64 Jacobi routes: key -> (2x2x2 grid, size, model
#: keywords); each stands beside phase 19's f32 vpu run of the same key
J21 = {
    "wrap": (False, N, {}),
    "wavefront z-ring": (True, N, {}),
    "wavefront z-slab": (True, N, {"pallas_path": "wavefront", "z_ring": False}),
    "shell": (True, N, {"pallas_path": "shell"}),
    "slab": (True, N, {"pallas_path": "slab"}),
    f"wavefront plain {N - 1}^3": (True, N - 1, {}),
}
#: the float64 run's bound against the float64 torch engine at step 10: the
#: two sum in other orders, about one ulp a level apart (the f32 phases'
#: rtol 1e-6 is ~8 f32 ulps; this is ~45 f64 ulps)
F64_ENGINE_RTOL = 1e-14


def phase21(card: str, dev: torch.device, f32_routes: dict) -> dict:
    """Phase 21 (see the module's docstring): float64 fields on the Jacobi
    kernels (rows 1-5), bf16 storage and float64 on the mean-of-6 kernels
    (rows 17-18).  ``f32_routes``: phase 19's route records (their f32 vpu
    runs).  Returns the phase's record with, under ``forms``, each new
    form's kernels-line numbers."""
    from stencil_tpu_torch.bin import bench_kernels as bk
    from stencil_tpu_torch.domain import DistributedDomain
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.models.jacobi import COLD_TEMP, HOT_TEMP, Jacobi3D
    from stencil_tpu_torch.ops import jacobi_kernels as jk
    from stencil_tpu_torch.ops import plane_stencil as m6

    rec = {"checks": [], "forms": {}, "routes": {}, "mean6_runs": {}}
    f64, f32 = torch.float64, torch.float32
    m6_dts = {"bf16": torch.bfloat16, "f64": f64}

    def hold(form: str, got, want, what: str) -> None:
        """A kernel against its plain version: bitwise."""
        sync()
        got, want = (list(got), list(want)) if isinstance(got, (list, tuple)) else ([got], [want])
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                err = max_err(g, w) if g.dtype == w.dtype else float("nan")
                raise AssertionError(f"phase 21 {form} {what}: kernel against plain version: max abs err {err}, "
                                     f"dtypes {g.dtype} / {w.dtype}")
        rec["checks"].append({"form": form, "what": what, "bitwise": True})

    def rand(shape, seed, dt=f64):
        return bk.device_rand(shape, seed, dev, dt)

    # -- every new form against its plain version on ragged blocks that both
    # spheres cross: the wrap kernel at k = 1, 4, 8; the z-ring, shell with z
    # slabs and plain shell wavefronts at m = 4 (one march) and 8 (two); the
    # plane and slab kernels; the mean-of-6 kernels under bf16 storage and
    # at f64, the wavefront at m = 3 and 8
    t0 = time.perf_counter()
    for k in (1, 4, 8):
        b = rand((40, 36, 70), 300 + k)
        hold("jacobi_wrap_step_f64", jk.jacobi_wrap_step(b, k), jk.jacobi_wrap_step_plain(b, k), f"(40,36,70) k={k}")
    org2 = torch.tensor([[3, 1, 2], [9, 4, 0]], dtype=torch.int32, device=dev)
    for m in (4, 8):
        for ring, slabs in ((True, True), (False, True), (False, False)):
            s, n = m, 2
            Xr, Yr = 2 * s + 21, 2 * s + 33
            Z = 128 if ring else 2 * s + 70
            zv = Z - 1 if slabs and not ring else Z
            gs = (2 * s + 30, Yr - 2 * s + 3, (Z if ring else zv - 2 * s) + 5)
            raw = rand((n, Xr, Yr, Z), 310 + m)
            zs = rand((n, Xr, 2 * s, Yr), 311 + m) if slabs else None
            S, zsl = slice(s, -s), (slice(None) if ring else slice(s, zv - s))
            if ring:
                d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s, int(o[2]), s, Yr, Z, gs, dev) for o in org2])
                got = jk.jacobi_zring_wavefront_step(raw, m, org2, d2, gs, zs)
                want = jk.jacobi_zring_wavefront_step_plain(raw, m, org2, d2, gs, zs)
            else:
                d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s, int(o[2]) - s, (Yr, Z), gs, dev) for o in org2])
                got = jk.jacobi_shell_wavefront_step(raw, m, org2, d2, gs, z_slabs=zs, z_valid=zv)
                want = jk.jacobi_shell_wavefront_step_plain(raw, m, org2, d2, gs, z_slabs=zs, z_valid=zv)
            if not slabs:
                got, want = (got,), (want,)
            name = "jacobi_zring_wavefront_step" if ring else "jacobi_shell_wavefront_step"
            what = f"({n},{Xr},{Yr},{Z}) m={m} {'ring' if ring else 'slabs' if slabs else 'plain'}"
            hold(f"{name}_f64", [got[0][:, S, S, zsl]] + ([got[1][:, S, :, S]] if slabs else []),
                 [want[0][:, S, S, zsl]] + ([want[1][:, S, :, S]] if slabs else []), what)
    for which, shape in (("plane", (3, 20, 37, 70)), ("slab", (3, 18, 36, 70))):
        n, X, Y, Z = shape
        gs = (X + 11, Y + 3, Z + 5)
        org = torch.tensor([[1, 2, 3], [7, 0, 1], [4, 5, 6]], dtype=torch.int32, device=dev)
        inner = (Y - 2, Z - 2) if which == "plane" else (Y, Z)
        d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), inner, gs, dev) for o in org])
        b = rand(shape, 320)
        if which == "plane":
            got, want = jk.jacobi_plane_step(b, org, d2, gs), jk.jacobi_plane_step_plain(b, org, d2, gs)
        else:
            faces = [rand(f, 321 + j) for j, f in enumerate([(n, Y, Z)] * 2 + [(n, X, Z)] * 2 + [(n, X, Y)] * 2)]
            got, want = jk.jacobi_slab_step(b, *faces, org, d2, gs), jk.jacobi_slab_step_plain(b, *faces, org, d2, gs)
        hold(f"jacobi_{which}_step_f64", got, want, str(shape))
    for dname, dt in m6_dts.items():
        acc = dname == "bf16"
        for m in (3, 8):
            raw = rand((2 * m + 41, 2 * m + 29, 2 * m + 75), 330 + m, dt)
            S = slice(m, -m)
            hold(f"mean6_shell_wavefront_step_{dname}", m6.mean6_shell_wavefront_step(raw, m, m, f32_accumulate=acc)[S, S, S],
                 m6.mean6_shell_wavefront_step_plain(raw, m, m, f32_accumulate=acc)[S, S, S], f"{tuple(raw.shape)} m={m}")
        b = rand((37, 41, 70), 340, dt)
        hold(f"mean6_plane_step_{dname}", m6.mean6_plane_step(b, (1, 2, 3), (3, 1, 2), f32_accumulate=acc),
             m6.mean6_plane_step_plain(b, (1, 2, 3), (3, 1, 2), f32_accumulate=acc), "(37,41,70) lo (1,2,3) hi (3,1,2)")
    log(f"phase 21: every new form against its plain version on ragged blocks, bitwise, {len(rec['checks'])} checks, "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the main path's shapes: each form held bitwise, then its CUDA-event
    # and device ms beside the f32 form's on the same data, its plain
    # version's and its bound (bytes at the storage itemsize; seven f64
    # operations a cell-level over 34 TFLOP/s, six for the mean of 6)
    t0 = time.perf_counter()
    half, gs = N // 2, (N, N, N)
    m4 = jk.wavefront_auto_depth(half, itemsize=8)  # the f64 routes' depth on 2x2x2
    r = half + 2 * m4
    ws = N + 6
    borg = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)], dtype=torch.int32,
                        device=dev)
    ring_d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - m4, int(o[2]), m4, r, half, gs, dev) for o in borg])
    sh_d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - m4, int(o[2]) - m4, (r, r), gs, dev) for o in borg])
    one_d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in borg])

    def jbound(nbytes, cell_levels):
        b = bk.jacobi_bound(nbytes, cell_levels, f64=True)
        return b["bound_ms"], b["bound_by"]

    def m6bound(nbytes, cell_levels, dname):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 6 * cell_levels / (bk.F64_FLOPS_PER_S if dname == "f64" else F32_FLOPS_PER_S) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    # name: (inputs at a dtype, the call, the plain call, valid region,
    # kernel launches a call, the bound at the form's dtype, shape, plan)
    cases = {
        "jacobi_wrap_step_f64": (
            lambda dt: rand((N, N, N), 350, dt), lambda b: jk.jacobi_wrap_step(b, 8),
            lambda b: jk.jacobi_wrap_step_plain(b, 8), lambda o: o, 2,
            jbound(2 * N ** 3 * 8, N ** 3 * 8), f"({N},{N},{N}) k=8",
            lambda: jk.jacobi_wrap_launch((N, N, N), 8, storage="f64")),
        "jacobi_zring_wavefront_step_f64": (
            lambda dt: (rand((8, r, r, half), 351, dt), rand((8, r, 2 * m4, r), 352, dt)),
            lambda t: jk.jacobi_zring_wavefront_step(t[0], m4, borg, ring_d2, gs, t[1]),
            lambda t: jk.jacobi_zring_wavefront_step_plain(t[0], m4, borg, ring_d2, gs, t[1]),
            lambda o: (o[0][:, m4:-m4, m4:-m4], o[1][:, m4:-m4, :, m4:-m4]), 1,
            jbound(bk.wavefront_bytes(8, r, r, half + 2 * m4, m4, m4, True, 8), 8 * half ** 3 * m4),
            f"(8,{r},{r},{half}) m={m4}, z slabs (8,{r},{2 * m4},{r})",
            lambda: jk.jacobi_wavefront_launch((8, r, r, half), m4, ring=True, slabs=True, storage="f64")),
        "jacobi_shell_wavefront_step_f64": (
            lambda dt: (rand((8, r, r, r), 353, dt), rand((8, r, 2 * m4, r), 354, dt)),
            lambda t: jk.jacobi_shell_wavefront_step(t[0], m4, borg, sh_d2, gs, z_slabs=t[1], z_valid=r),
            lambda t: jk.jacobi_shell_wavefront_step_plain(t[0], m4, borg, sh_d2, gs, z_slabs=t[1], z_valid=r),
            lambda o: (o[0][:, m4:-m4, m4:-m4, m4:-m4], o[1][:, m4:-m4, :, m4:-m4]), 1,
            jbound(bk.wavefront_bytes(8, r, r, r, m4, m4, True, 8), 8 * half ** 3 * m4),
            f"(8,{r},{r},{r}) m={m4}, z slabs (8,{r},{2 * m4},{r}), z_valid={r}",
            lambda: jk.jacobi_wavefront_launch((8, r, r, r), m4, slabs=True, storage="f64")),
        "jacobi_plane_step_f64": (
            lambda dt: rand((8, half + 2, half + 2, half + 2), 355, dt),
            lambda b: jk.jacobi_plane_step(b, borg, one_d2, gs), lambda b: jk.jacobi_plane_step_plain(b, borg, one_d2, gs),
            lambda o: o, 1, jbound(2 * 8 * (half + 2) ** 3 * 8 + (one_d2.numel() + 24) * 4, 8 * half ** 3),
            f"(8,{half + 2},{half + 2},{half + 2})", lambda: jk.jacobi_plane_launch((8, half + 2, half + 2, half + 2),
                                                                                     storage="f64")),
        "jacobi_slab_step_f64": (
            lambda dt: tuple(rand(sh, 356 + j, dt) for j, sh in enumerate([(8, half, half, half)] + [(8, half, half)] * 6)),
            lambda t: jk.jacobi_slab_step(t[0], *t[1:], borg, one_d2, gs),
            lambda t: jk.jacobi_slab_step_plain(t[0], *t[1:], borg, one_d2, gs), lambda o: o, 1,
            jbound((2 * 8 * half ** 3 + 6 * 8 * half * half) * 8 + (one_d2.numel() + 24) * 4, 8 * half ** 3),
            f"(8,{half},{half},{half}), six face slabs (8,{half},{half})",
            lambda: jk.jacobi_slab_launch((8, half, half, half), storage="f64")),
    }
    for dname, dt in m6_dts.items():
        item = dt.itemsize
        cases[f"mean6_shell_wavefront_step_{dname}"] = (
            lambda dt, dname=dname: rand((ws, ws, ws), 360, dt),
            lambda b: m6.mean6_shell_wavefront_step(b, 3, 3, f32_accumulate=b.dtype == torch.bfloat16),
            lambda b: m6.mean6_shell_wavefront_step_plain(b, 3, 3, f32_accumulate=b.dtype == torch.bfloat16),
            lambda o: o[3:-3, 3:-3, 3:-3], 1, m6bound((ws ** 3 + N ** 3) * item, 3 * N ** 3, dname),
            f"({ws},{ws},{ws}) m=3 s=3", lambda dname=dname: m6.mean6_wavefront_launch((ws, ws, ws), 3, 3, dname))
        cases[f"mean6_plane_step_{dname}"] = (
            lambda dt, dname=dname: rand((ws, ws, ws), 361, dt),
            lambda b: m6.mean6_plane_step(b, (3, 3, 3), (3, 3, 3), f32_accumulate=b.dtype == torch.bfloat16),
            lambda b: m6.mean6_plane_step_plain(b, (3, 3, 3), (3, 3, 3), f32_accumulate=b.dtype == torch.bfloat16),
            lambda o: o, 1, m6bound(2 * ws ** 3 * item, N ** 3, dname), f"({ws},{ws},{ws}) lo = hi = 3", lambda: None)
    for name, (make, call, plain, valid, per_call, bnd, shape, plan) in cases.items():
        dt = m6_dts["bf16"] if name.endswith("_bf16") else f64
        ins = make(dt)
        hold(name, valid(call(ins)), valid(plain(ins)), shape)
        entry = {"ms": cuda_ms(lambda: call(ins), inner=2), "device_ms": device_ms_per_call(lambda: call(ins),
                                                                                         per_call=per_call),
                 "plain_ms": cuda_ms(lambda: plain(ins), reps=3, inner=1), "bound": bnd,
                 "shape": f"{shape}, {'bf16 storage' if dt == torch.bfloat16 else 'float64'}", "launch": plan()}
        del ins
        ins = make(f32)  # the f32 form on the same seeded data
        entry["f32_ms"] = cuda_ms(lambda: call(ins), inner=2)
        entry["f32_device_ms"] = device_ms_per_call(lambda: call(ins), per_call=per_call)
        del ins
        torch.cuda.empty_cache()
        rec["forms"][name] = entry
        log(f"{name} {entry['shape']}: CUDA events {entry['ms']:.4f} ms a call, device {entry['device_ms']:.4f} (f32 "
            f"form {entry['f32_ms']:.4f}, device {entry['f32_device_ms']:.4f}; plain {entry['plain_ms']:.4f}), bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})" + (f"; launch {plan_str(entry['launch'])}" if entry["launch"] else "")
            + f" on {card}")
    del cases
    torch.cuda.empty_cache()
    # each f64 form's registers, spills and blocks an SM (its launch plan
    # above), from the float64 library's ptxas report
    rec["ptxas"] = {"jacobi_wavefront_f64": bk.library_ptxas("jacobi_wavefront_f64"),
                    "jacobi_wavefront_bf16 mean6": [e for e in bk.library_ptxas("jacobi_wavefront_bf16")
                                                    if "Li6E" in e["entry"]],
                    "plane_stencil": bk.library_ptxas("plane_stencil")}
    regs = [(e.get("registers"), e.get("spill_stores", 0)) for e in rec["ptxas"]["jacobi_wavefront_f64"]]
    log(f"phase 21: f64 library, {len(regs)} kernels: registers {min(r for r, _ in regs)}-{max(r for r, _ in regs)}, "
        f"most spill-store bytes {max(s for _, s in regs)}; main-path shapes held and timed in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the routes at full width at f64: 200 steps each with the counters
    # reset before and read after; bitwise against the f64 plain path at
    # step 10 and within F64_ENGINE_RTOL of the f64 torch engine; finite and
    # inside [COLD, HOT] at step 200; Mcells/s beside the f32 vpu run's
    refs = {}
    for size in (N, N - 1):
        plain = torch.full((size,) * 3, (HOT_TEMP + COLD_TEMP) / 2, dtype=f64, device=dev)
        for _ in range(CHECK_AT):
            plain = jk.jacobi_wrap_step_plain(plain, 1)
        eng = Jacobi3D(size, size, size, kernel_impl="torch", dtype=f64)
        eng.realize()
        eng.step(CHECK_AT)
        refs[size] = (plain.cpu(), torch.from_numpy(eng.temperature()))
        del plain, eng
        torch.cuda.empty_cache()
        np.testing.assert_allclose(refs[size][0].numpy(), refs[size][1].numpy(), rtol=F64_ENGINE_RTOL, atol=0)

    def run(key: str, capture: bool = False) -> dict:
        grid, size, kw = J21[key]
        model = Jacobi3D(size, size, size, kernel_impl="cuda", dtype=f64, capture=capture, **kw)
        if grid:
            model.dd.set_partition(2, 2, 2)
        model.realize()
        ledger.reset_launch_counts()
        sync()
        model.step(CHECK_AT)
        sync()
        at_check = torch.from_numpy(model.temperature())
        t0 = time.perf_counter()
        model.step(STEPS - CHECK_AT)
        sync()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in ledger.launch_counts().items() if v}
        final = torch.from_numpy(model.temperature())
        kernel = {"wrap": "jacobi_wrap_step", "shell": "jacobi_plane_step", "slab": "jacobi_slab_step",
                  "wavefront": "jacobi_zring_wavefront_step" if model._wavefront_z_ring
                  else "jacobi_shell_wavefront_step"}[model._pallas_path]
        unit = {"wrap": jk.choose_temporal_k((size,) * 3), "wavefront": model._wavefront_m}.get(model._pallas_path, 1)
        want = sum(-(-k // unit) for k in (CHECK_AT, STEPS - CHECK_AT))
        res = {"path": model._pallas_path, "m": model._wavefront_m, "kernel": kernel, "launches": counts,
               "want": want, "mcells_per_s": size ** 3 * (STEPS - CHECK_AT) / seconds / 1e6,
               "dtype": str(model.dd.get_curr(model.h).dtype), "final": final}
        del model
        torch.cuda.empty_cache()
        plain, eng = refs[size]
        if counts.get(f"{kernel}_f64") != want or counts.get(kernel, 0):
            raise AssertionError(f"phase 21 {key}: launches {counts}, want {want} of {kernel}_f64 and none of {kernel}")
        if res["dtype"] != "torch.float64" or final.dtype != f64:
            raise AssertionError(f"phase 21 {key}: the field is {res['dtype']}, not float64")
        if not torch.equal(at_check, plain):
            raise AssertionError(f"phase 21 {key}: != the f64 plain path at step {CHECK_AT} "
                                 f"(max abs err {max_err(at_check, plain)})")
        np.testing.assert_allclose(at_check.numpy(), eng.numpy(), rtol=F64_ENGINE_RTOL, atol=0)
        if not (torch.isfinite(final).all() and final.min() >= COLD_TEMP and final.max() <= HOT_TEMP):
            raise AssertionError(f"phase 21 {key}: field not finite or outside [COLD, HOT] after {STEPS} steps")
        return res

    for key in J21:
        res = run(key)
        ref32 = f32_routes[key]["f32 vpu"]
        entry = {k: v for k, v in res.items() if k != "final"}
        entry.update(f32_mcells_per_s=ref32["mcells_per_s"], f32_m=ref32["m"], f32_launches=ref32["launches"])
        rec["routes"][key] = entry
        name = f"{res['kernel']}_f64"
        log(f"phase 21 {key} f64: {res['mcells_per_s']:.1f} Mcells/s against {ref32['mcells_per_s']:.1f} (f32, phase "
            f"19), m={res['m']} (f32 {ref32['m']}); {res['launches'][name]} launches of {name}; bitwise equal to the "
            f"f64 plain path and within rtol {F64_ENGINE_RTOL} of the f64 torch engine at step {CHECK_AT} on {card}")
        fe = rec["forms"].get(name)
        if fe is not None and "counts" not in fe:
            fe["counts"], fe["want"] = res["launches"], res["want"]
        if key == "wrap":
            # one f64 route captured against uncaptured: bitwise, launches equal
            cap = run(key, capture=True)
            if cap["launches"] != res["launches"] or not torch.equal(cap["final"], res["final"]):
                raise AssertionError(f"phase 21: captured f64 wrap != uncaptured ({cap['launches']}, "
                                     f"{res['launches']})")
            rec["captured_f64_wrap"] = {"bitwise": True, "launches": cap["launches"]}
            log("phase 21: f64 wrap route captured bitwise equal to uncaptured, launches equal")
            del cap
        del res
    del refs

    # -- the mean-of-6 kernels at full width under bf16 storage and at f64:
    # one periodic 512^3 subdomain with a radius-3 shell (phase 15's
    # geometry), AST_ITERS levels of exchange + mean6_plane_step and of one
    # exchange + one mean6_shell_wavefront_step a pass (m = 3); the counters
    # reset before and read after; f64 plane and wavefront bitwise equal,
    # bf16 within bf16_storage_atol of its roundings of the f64 run
    init = np.random.default_rng(210).random((N, N, N)).astype(np.float32)
    shell3 = (3, 3, 3)
    runs = {}
    for dname, dt in m6_dts.items():
        acc = dname == "bf16"
        for kernel in ("mean6_plane_step", "mean6_shell_wavefront_step"):
            dd = DistributedDomain(N, N, N, device=dev)
            dd.set_radius(3)
            if acc:
                dd.set_storage("bf16")
            h = dd.add_data("u", dtype=f32 if acc else f64)
            dd.realize()
            dd.set_quantity(h, init)
            ledger.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            levels, calls = AST_ITERS, 0
            while levels:
                m = 1 if kernel == "mean6_plane_step" else min(3, levels)
                dd.exchange()
                cur, nxt = dd.get_curr(h)[0, 0, 0], dd.get_next(h)[0, 0, 0]
                if kernel == "mean6_plane_step":
                    m6.mean6_plane_step(cur, shell3, shell3, f32_accumulate=acc, out=nxt)
                else:
                    m6.mean6_shell_wavefront_step(cur, m, 3, f32_accumulate=acc, out=nxt)
                dd.swap()
                levels -= m
                calls += 1
            sync()
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in ledger.launch_counts().items() if v}
            got = dd.get_curr(h)[0, 0, 0, 3:-3, 3:-3, 3:-3].clone()
            del dd
            torch.cuda.empty_cache()
            form = f"{kernel}_{dname}"
            if counts != {form: calls, "blend_slab": 6 * calls}:
                raise AssertionError(f"phase 21 {form} run: launches {counts}, want {calls} of {form} and "
                                     f"{6 * calls} blend_slab")
            if got.dtype != dt or not (torch.isfinite(got.float()).all() and 0 <= float(got.min())
                                       and float(got.max()) <= 1):
                raise AssertionError(f"phase 21 {form} run: {got.dtype}, not finite or outside [0, 1]")
            runs[form] = got
            rec["mean6_runs"][form] = {"launches": calls, "ms_per_level": seconds * 1e3 / AST_ITERS}
            fe = rec["forms"][form]
            fe["counts"], fe["want"] = counts, calls
    ref = runs["mean6_plane_step_f64"]
    if not torch.equal(runs["mean6_shell_wavefront_step_f64"], ref):
        raise AssertionError("phase 21: the f64 mean6 wavefront run != the f64 plane run")
    for form, passes in (("mean6_plane_step_bf16", AST_ITERS), ("mean6_shell_wavefront_step_bf16", AST_ITERS // 3)):
        err = float((runs[form].double() - ref).abs().max())
        limit = bf16_storage_atol(passes)
        rec["mean6_runs"][form].update(max_abs_err_vs_f64=err, limit=limit)
        if err > limit:
            raise AssertionError(f"phase 21 {form} run: {err} against the f64 run exceeds {limit}")
    log(f"phase 21 mean6 runs ({AST_ITERS} levels, {N}^3, shell 3): f64 plane and wavefront bitwise equal; "
        + ", ".join(f"{k} {v['ms_per_level']:.4f} ms a level"
                    + (f", {v['max_abs_err_vs_f64']:.3e} from f64 (limit {v['limit']:.3e})" if "limit" in v else "")
                    for k, v in rec["mean6_runs"].items()) + f" on {card}")
    del runs, ref
    torch.cuda.empty_cache()
    missing = [name for name, f in rec["forms"].items() if "counts" not in f]
    if missing:
        raise AssertionError(f"phase 21: no run launched {missing}")
    rec["errs"] = dict.fromkeys(rec["forms"], 0.0)
    return rec


#: phase 22's contraction forms: the ledger's name suffix -> (compute unit,
#: operand precision) of the runs that stand for it
MXU22 = {"mxu": ("mxu", "f32"), "mxu_bf16in": ("mxu_band", "bf16")}
#: phase 22's Astaroth runs: key -> (schedule, 2x2x2 grid), and the route each takes
AST22 = {"auto 1x1x1": ("auto", False, "wrap"), "wavefront 1x1x1": ("wavefront", False, "wavefront"),
         "per-step 2x2x2": ("per-step", True, "plane")}


def off_mxu_kernel(views, info):
    """A contraction-form kernel that reads x-1 off the centre: the general
    form of the stream wavefront kernel."""
    u = views["u"]
    return {"u": u.sh(-1, 1, 0) * 0.25 + u.sh(1, 0, 0) * 0.25 + u.plane_nbr_sum() * 0.125}


def mxu_vs_vpu_atol(levels: int, top: float, mxu_input: str) -> float:
    """How far a contraction-form mean-of-6 run may lie from its vpu run
    after ``levels`` levels, fields at most ``top`` in magnitude: the
    reassociation bound of ``tests/test_kernel_axes.py``'s
    ``test_stream_mxu_matches_vpu`` (4 roundings a level, half an ulp each
    at the six-sum's magnitude), the card's contraction within 4 ulps a
    level of its plain version at that magnitude, and on bf16 operands
    ``mxu_bf16_input_atol``."""
    six = 6.0 * top
    atol = levels * (4 * 2.0 ** -24 + 4 * 2.0 ** -23) * six
    return atol + (mxu_bf16_input_atol(levels, top) if mxu_input == "bf16" else 0.0)


def hold_contraction(phase: int, rec: dict, errs: dict, form: str, got, want, levels: int, bf16: bool = False,
                     what: str = "") -> None:
    """A contraction form against its plain version: finite, within 4 ulps
    a level (f32 operands), ``mxu_bf16_input_atol`` (bf16 operands) or a
    bf16 ulp (bf16 storage); the largest error is kept in ``errs[form]``
    and the check in ``rec["checks"]``."""
    sync()
    mi = "bf16" if form.endswith("_bf16in") else "f32"
    got, want = (list(got), list(want)) if isinstance(got, (list, tuple)) else ([got], [want])
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"phase {phase} {form} {what}: dtypes {g.dtype} / {w.dtype}, or not finite")
        e = max_err(g, w)
        if bf16:
            ok, limit = ulp_dist(g, w) <= 1, "1 bf16 ulp"
        elif mi == "f32":
            ok, limit = ulp_dist(g, w) <= 4 * levels, f"{4 * levels} ulps"
        else:
            atol = mxu_bf16_input_atol(levels, float(w.abs().max()))
            ok, limit = e <= atol, f"{atol:.3e}"
        if not ok:
            raise AssertionError(f"phase {phase} {form} {what}: kernel against plain version: max abs err {e}, "
                                 f"{ulp_dist(g, w)} ulps, over {limit}")
        err = max(err, e)
    errs[form] = max(errs.get(form, 0.0), err)
    rec["checks"].append({"form": form, "what": what, "max_abs_err": err})


def phase22(card: str, dev: torch.device, ref: torch.Tensor) -> dict:
    """Phase 22 (see the module's docstring): the tensor-core contraction
    form of rows 6-8, 17 and 18.  ``ref``: the f32 vpu Astaroth interiors
    after ``AST_ITERS`` iterations at 512^3 (host, ``(AST_Q, N, N, N)``).
    Returns the phase's record with, under ``forms``, each new form's
    kernels-line numbers."""
    from stencil_tpu_torch.bin import bench_kernels as bk
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.domain import DistributedDomain
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import plane_stencil as m6
    from stencil_tpu_torch.ops import stream as st

    rec = {"checks": [], "forms": {}, "routes": {}, "mean6_runs": {}}
    errs = {}

    def hold(form: str, got, want, levels: int, bf16: bool = False, what: str = "") -> None:
        hold_contraction(22, rec, errs, form, got, want, levels, bf16, what)

    def rand(shape, seed, dt=torch.float32):
        return bk.device_rand(shape, seed, dev, dt)

    # -- every form against its plain version on ragged blocks, f32 and bf16
    # operands, f32 and (f32 operands) bf16 storage
    t0 = time.perf_counter()
    ak = AstarothSim._kernel_mxu
    names8 = [f"d{q}" for q in range(AST_Q)]
    gs_r = (30, 40, 140)
    for suffix, (unit, mi) in MXU22.items():
        for bf16 in (False, True) if mi == "f32" else (False,):
            dt = torch.bfloat16 if bf16 else torch.float32
            kw = {"compute_unit": unit, "mxu_input": mi}
            tag = f"{'bf16 storage' if bf16 else 'f32'}, {unit}"
            org0 = torch.zeros(3, dtype=torch.int32, device=dev)
            for shape, k in (((18, 20, 70), 3), ((9, 2, 1), 1)):
                b = [rand(shape, 600 + q, dt) for q in range(AST_Q)]
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)  # no band tile: the dense form
                    hold(f"stream_wrap_pass_{suffix}", st.stream_wrap_pass(ak, names8, b, k, org0, shape, **kw),
                         st.stream_wrap_pass_plain(ak, names8, b, k, org0, shape, **kw), k, bf16,
                         f"{AST_Q} x {shape} k={k}, {tag}")
            lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
            raws = [rand((2, 17, 19, 70), 610 + q, dt) for q in range(AST_Q)]
            org2 = torch.tensor([[0, 0, 0], [13, 17, 60]], dtype=torch.int32, device=dev)
            inner = (slice(None), slice(1, -2), slice(2, -1), slice(1, -3))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                got = st.stream_plane_pass(ak, names8, raws, lo, hi, 1, org2, gs_r, **kw)
                want = st.stream_plane_pass_plain(ak, names8, raws, lo, hi, 1, org2, gs_r, **kw)
            hold(f"stream_plane_pass_{suffix}", [g[inner] for g in got], [w[inner] for w in want], 1, bf16,
                 f"{AST_Q} x (2,17,19,70), {tag}")
            for g, w in zip(got, want):
                g[inner] = w[inner]
                if not torch.equal(g, w):
                    raise AssertionError(f"phase 22 stream_plane_pass_{suffix}: the shell did not pass through")
            s, zv = 3, 127
            gs_w = (2 * (40 - 2 * s) + 3, 2 * (70 - 2 * s), 2 * (127 - 2 * s))
            orgw = torch.tensor([[5, 0, 7], [gs_w[0] - 3, 70 - 2 * s, 0]], dtype=torch.int32, device=dev)
            raw = [rand((2, 40, 70, 130), 620, dt)]
            zs = [rand((2, 40, 2 * s, 70), 621, dt)]
            S = slice(s, -s)
            got, gz = st.stream_wavefront_pass(ak, names8[:1], raw, 3, s, orgw, gs_w, z_slabs=zs, z_valid=zv, **kw)
            want, wz = st.stream_wavefront_pass_plain(ak, names8[:1], raw, 3, s, orgw, gs_w, z_slabs=zs, z_valid=zv,
                                                      **kw)
            hold(f"stream_wavefront_pass_{suffix}", [got[0][:, S, S, s:zv - s], gz[0][:, S, :, S]],
                 [want[0][:, S, S, s:zv - s], wz[0][:, S, :, S]], 3, bf16, f"(2,40,70,130) m=3 queue, z slabs, {tag}")
            if not bf16:
                got, _ = st.stream_wavefront_pass(off_mxu_kernel, ["u"], raw, 2, s, orgw, gs_w, **kw)
                want, _ = st.stream_wavefront_pass_plain(off_mxu_kernel, ["u"], raw, 2, s, orgw, gs_w, **kw)
                hold(f"stream_wavefront_pass_{suffix}", got[0][:, S, S, S], want[0][:, S, S, S], 2, bf16,
                     f"(2,40,70,130) m=2 general, {tag}")
            kw6 = dict(kw, f32_accumulate=bf16)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for m in (3, 8):
                    r6 = rand((2 * m + 41, 2 * m + 29, 2 * m + 75), 630 + m, dt)
                    S6 = slice(m, -m)
                    hold(f"mean6_shell_wavefront_step_{suffix}",
                         m6.mean6_shell_wavefront_step(r6, m, m, **kw6)[S6, S6, S6],
                         m6.mean6_shell_wavefront_step_plain(r6, m, m, **kw6)[S6, S6, S6], m, bf16,
                         f"{tuple(r6.shape)} m={m}, {tag}")
                b6 = rand((37, 41, 70), 640, dt)
                got = m6.mean6_plane_step(b6, (1, 2, 3), (3, 1, 2), **kw6)
                want = m6.mean6_plane_step_plain(b6, (1, 2, 3), (3, 1, 2), **kw6)
            win = (slice(1, -3), slice(2, -1), slice(3, -2))
            hold(f"mean6_plane_step_{suffix}", got[win], want[win], 1, bf16, f"(37,41,70) lo (1,2,3) hi (3,1,2), {tag}")
            got[win] = want[win]
            if not torch.equal(got, want):
                raise AssertionError(f"phase 22 mean6_plane_step_{suffix}: the shell did not pass through")
            del raws, raw, zs, got, want
    torch.cuda.empty_cache()
    log(f"phase 22: every contraction form against its plain version on ragged blocks, {len(rec['checks'])} checks, "
        f"{time.perf_counter() - t0:.1f} s")

    # -- the main path's shapes: held, then timed beside the vpu form
    t0 = time.perf_counter()
    times = bk.stream_mxu_times(dev, device_ms=lambda call, n: device_ms_per_call(call, per_call=n), plain=True,
                                check=lambda form, got, want, levels: hold(form, got, want, levels,
                                                                           what="the main path's shape"))
    shapes = {"stream_wrap_pass": f"{AST_Q} fields x ({N},{N},{N}) f32, k=1, Astaroth _kernel_mxu",
              "stream_plane_pass": f"{AST_Q} fields x (8,{N // 2 + 6},{N // 2 + 6},{N // 2 + 6}) f32, shell 3",
              "stream_wavefront_pass": f"1 field x (1,{N + 6},{N + 6},{N + 6}) f32 m=3 s=3, z slabs",
              "mean6_shell_wavefront_step": f"({N + 6},{N + 6},{N + 6}) f32, m = 3, s = 3",
              "mean6_plane_step": f"({N + 6},{N + 6},{N + 6}) f32, lo = hi = 3"}
    for name, t in times.items():
        base = name.rsplit("_mxu", 1)[0]
        rec["forms"][name] = {"ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                              "bound": (t["bound_ms"], t["bound_by"]), "bound_of": t["bound_of"],
                              "tensor_core_flops": t["tensor_core_flops"], "vpu_ms": t["vpu_ms"],
                              "vpu_device_ms": t["vpu_device_ms"], "launch": t.get("launch"),
                              "shape": f"{shapes[base]}, {t['compute_unit']} on {t['mxu_input']} operands"}
        f = rec["forms"][name]
        log(f"{name} {f['shape']}: CUDA events {f['ms']:.4f} ms a call, device {f['device_ms']:.4f} (vpu form "
            f"{f['vpu_ms']:.4f}, device {f['vpu_device_ms']:.4f}, x{f['device_ms'] / f['vpu_device_ms']:.2f}; plain "
            f"{f['plain_ms']:.4f}), bound {f['bound'][0]:.4f} ms ({f['bound_of']})"
            + (f"; launch {plan_str(f['launch'])}" if f["launch"] else "") + f" on {card}")
    torch.cuda.empty_cache()
    log(f"phase 22: main-path shapes held and timed in {time.perf_counter() - t0:.1f} s")

    # -- Astaroth at full width under each unit: 24 iterations with the
    # counters reset before and read after, held against the f32 vpu run
    top = float(ref.abs().max())

    def interiors_of(sim) -> list:
        lo, n = sim.dd.shell_radius().lo(), sim.dd.local_spec().sz
        dim = sim.dd.grid_dim()
        return [sim.dd.get_curr(h)[..., lo.x:lo.x + n.x, lo.y:lo.y + n.y, lo.z:lo.z + n.z]
                .permute(0, 3, 1, 4, 2, 5).reshape(dim.x * n.x, dim.y * n.y, dim.z * n.z) for h in sim.handles]

    t0 = time.perf_counter()
    for suffix, (unit, mi) in MXU22.items():
        for key, (schedule, grid, route) in AST22.items():
            sim = AstarothSim(N, N, N, num_quantities=AST_Q, kernel_impl="cuda", schedule=schedule,
                              compute_unit=unit, mxu_input=mi)
            if grid:
                sim.dd.set_partition(2, 2, 2)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # a plane without a band tile runs the dense form
                sim.realize()
            plan = sim._step._stream_plan
            ledger.reset_launch_counts()
            sync()
            t1 = time.perf_counter()
            sim.step(AST_ITERS)
            sync()
            dt = (time.perf_counter() - t1) / AST_ITERS
            counts = {k: v for k, v in ledger.launch_counts().items() if v}
            kernel = f"stream_{plan['route']}_pass"
            form = f"{kernel}_{suffix}"
            groups = AST_Q if plan["grouping"] == "per-field" else 1
            want = groups * (AST_ITERS if plan["route"] != "wavefront" else -(-AST_ITERS // plan["m"]))
            if (plan["route"], plan["compute_unit"], plan["mxu_input"]) != (route, unit, mi) or \
                    counts.get(form, 0) != want or counts.get(kernel, 0):
                raise AssertionError(f"phase 22 astaroth {key} {unit}/{mi}: plan {plan}, launches {counts}, want "
                                     f"{want} of {form} and none of {kernel}")
            err, finite = 0.0, True
            for q, got in enumerate(interiors_of(sim)):
                finite = finite and bool(torch.isfinite(got).all())
                err = max(err, float((got.double() - ref[q].to(dev).double()).abs().max()))
            limit = mxu_vs_vpu_atol(AST_ITERS, top, mi)
            rec["routes"][f"{key} {suffix}"] = {
                "route": plan["route"], "m": plan["m"], "grouping": plan["grouping"], "z_slabs": plan["z_slabs"],
                "compute_unit": unit, "mxu_input": mi, "launches": counts, "max_abs_err_vs_vpu": err,
                "limit": limit, "ms_per_iter": dt * 1e3, "mupdates_per_s": AST_Q * N ** 3 / dt / 1e6}
            log(f"phase 22 astaroth {AST_Q}q {N}^3 {key} {unit}/{mi} ({plan['route']}, m={plan['m']}, "
                f"{plan['grouping']}): {dt * 1e3:.4f} ms/iter; {counts[form]} launches of {form}; max abs err "
                f"against the vpu run {err:.3e} (limit {limit:.3e}) on {card}")
            if not finite or err > limit:
                raise AssertionError(f"phase 22 astaroth {key} {unit}/{mi}: finite {finite}, {err} against the vpu "
                                     f"run exceeds {limit}")
            fe = rec["forms"][form]
            if "counts" not in fe:
                fe["counts"], fe["want"] = counts, want
            del sim
            torch.cuda.empty_cache()
    log(f"phase 22: Astaroth runs in {time.perf_counter() - t0:.1f} s")

    # -- the mean-of-6 kernels at full width under each unit: one periodic
    # 512^3 subdomain with a radius-3 shell, 24 levels of exchange + #18 and
    # of exchange + #17 (m = 3) a pass, held against the vpu run
    init = np.random.default_rng(220).random((N, N, N)).astype(np.float32)
    shell3 = (3, 3, 3)
    runs = {}
    for suffix, (unit, mi) in [(None, ("vpu", "f32"))] + list(MXU22.items()):
        kw = {} if suffix is None else {"compute_unit": unit, "mxu_input": mi}
        for kernel in ("mean6_plane_step", "mean6_shell_wavefront_step"):
            dd = DistributedDomain(N, N, N, device=dev)
            dd.set_radius(3)
            h = dd.add_data("u", dtype=torch.float32)
            dd.realize()
            dd.set_quantity(h, init)
            ledger.reset_launch_counts()
            sync()
            t1 = time.perf_counter()
            levels, calls = AST_ITERS, 0
            while levels:
                m = 1 if kernel == "mean6_plane_step" else min(3, levels)
                dd.exchange()
                cur, nxt = dd.get_curr(h)[0, 0, 0], dd.get_next(h)[0, 0, 0]
                if kernel == "mean6_plane_step":
                    m6.mean6_plane_step(cur, shell3, shell3, out=nxt, **kw)
                else:
                    m6.mean6_shell_wavefront_step(cur, m, 3, out=nxt, **kw)
                dd.swap()
                levels -= m
                calls += 1
            sync()
            seconds = time.perf_counter() - t1
            counts = {k: v for k, v in ledger.launch_counts().items() if v}
            runs[(kernel, suffix)] = dd.get_curr(h)[0, 0, 0, 3:-3, 3:-3, 3:-3].clone()
            del dd
            torch.cuda.empty_cache()
            if suffix is None:
                continue
            form = f"{kernel}_{suffix}"
            if counts.get(form, 0) != calls or counts.get(kernel, 0):
                raise AssertionError(f"phase 22 {form} run: launches {counts}, want {calls} of {form}")
            got, vpu = runs[(kernel, suffix)], runs[(kernel, None)]
            err = max_err(got, vpu)
            limit = mxu_vs_vpu_atol(AST_ITERS, float(vpu.abs().max()), mi)
            rec["mean6_runs"][form] = {"launches": calls, "ms_per_level": seconds * 1e3 / AST_ITERS,
                                       "max_abs_err_vs_vpu": err, "limit": limit}
            if not bool(torch.isfinite(got).all()) or err > limit:
                raise AssertionError(f"phase 22 {form} run: {err} against the vpu run exceeds {limit}")
            fe = rec["forms"][form]
            fe["counts"], fe["want"] = counts, calls
    log(f"phase 22 mean6 runs ({AST_ITERS} levels, {N}^3, shell 3): "
        + ", ".join(f"{k} {v['ms_per_level']:.4f} ms a level, {v['max_abs_err_vs_vpu']:.3e} from vpu (limit "
                    f"{v['limit']:.3e})" for k, v in rec["mean6_runs"].items()) + f" on {card}")
    del runs
    torch.cuda.empty_cache()
    missing = [name for name, f in rec["forms"].items() if "counts" not in f]
    if missing:
        raise AssertionError(f"phase 22: no run launched {missing}")
    rec["errs"] = errs
    return rec


#: phase 23's Astaroth runs at 512^3 on 2x2x2: key -> (schedule, exchange
#: route, stream halo, stream overlap, the route each takes); each stands
#: beside phase 16's vpu run of the same key and, on the plane route, phase
#: 22's array-form contraction run ("per-step 2x2x2")
AST23 = {"per-step fused": ("per-step", "yzpack_pallas", "fused", "auto", "plane"),
         "auto fused": ("auto", "yzpack_pallas", "fused", "auto", "wavefront"),
         "auto split": ("auto", "direct", "auto", "split", "wavefront"),
         "per-step split": ("per-step", "direct", "auto", "split", "plane")}


def phase23(card: str, dev: torch.device, ref: torch.Tensor, f16: dict, mx22: dict) -> dict:
    """Phase 23 (see the module's docstring): the tensor-core contraction
    under the fused halo and the split schedule.  ``ref``: the f32 vpu
    Astaroth interiors after ``AST_ITERS`` iterations at 512^3 (host);
    ``f16`` / ``mx22``: phases 16's and 22's records, whose runs stand
    beside this phase's.  Returns the phase's record with, under
    ``forms``, each new form's kernels-line numbers."""
    from stencil_tpu_torch.bin import bench_kernels as bk
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.ops import stream as st

    rec = {"checks": [], "forms": {}, "routes": {}}
    errs = {}

    def hold(form: str, got, want, levels: int, bf16: bool = False, what: str = "") -> None:
        hold_contraction(23, rec, errs, form, got, want, levels, bf16, what)

    def rand(shape, seed, dt=torch.float32):
        return bk.device_rand(shape, seed, dev, dt)

    def bufs(n, X, Y, Z, lo, hi, nf, seed, dt):
        """Random fused shell buffers (``fused_shell_exchange``'s layouts)."""
        shapes = ((lo.x + hi.x, Y, Z), (lo.y + hi.y, X, Z), (lo.z + hi.z, Y, X))
        return tuple([rand((n, *sh), seed + 10 * j + q, dt) for q in range(nf)] for j, sh in enumerate(shapes))

    # -- each fused form against its plain version on ragged blocks, f32 and
    # bf16 operands, f32 and (f32 operands) bf16 storage
    t0 = time.perf_counter()
    ak = AstarothSim._kernel_mxu
    names8 = [f"d{q}" for q in range(AST_Q)]
    gs_r = (30, 40, 140)
    for suffix, (unit, mi) in MXU22.items():
        for bf16 in (False, True) if mi == "f32" else (False,):
            dt = torch.bfloat16 if bf16 else torch.float32
            kw = {"compute_unit": unit, "mxu_input": mi}
            tag = f"{'bf16 storage' if bf16 else 'f32'}, {unit}"
            lo, hi = Dim3(1, 2, 1), Dim3(2, 1, 3)
            raws = [rand((2, 17, 19, 70), 710 + q, dt) for q in range(AST_Q)]
            fs = bufs(2, 17, 19, 70, lo, hi, AST_Q, 720, dt)
            org2 = torch.tensor([[0, 0, 0], [13, 17, 60]], dtype=torch.int32, device=dev)
            inner = (slice(None), slice(1, -2), slice(2, -1), slice(1, -3))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # no band tile: the dense form
                got = st.stream_plane_pass(ak, names8, raws, lo, hi, 1, org2, gs_r, fused_shell=fs, **kw)
                want = st.stream_plane_pass_plain(ak, names8, raws, lo, hi, 1, org2, gs_r, fused_shell=fs, **kw)
            hold(f"stream_plane_pass_fused_{suffix}", [g[inner] for g in got], [w[inner] for w in want], 1, bf16,
                 f"{AST_Q} x (2,17,19,70) fused, {tag}")
            for g, w in zip(got, want):
                g[inner] = w[inner]
                if not torch.equal(g, w):
                    raise AssertionError(f"phase 23 stream_plane_pass_fused_{suffix}: the shell did not pass through "
                                         "from the buffers")
            s = 3
            s3 = Dim3(s, s, s)
            gs_w = (2 * (40 - 2 * s) + 3, 2 * (70 - 2 * s), 2 * (130 - 2 * s))
            orgw = torch.tensor([[5, 0, 7], [gs_w[0] - 3, 70 - 2 * s, 0]], dtype=torch.int32, device=dev)
            raw = [rand((2, 40, 70, 130), 730, dt)]
            fs1 = bufs(2, 40, 70, 130, s3, s3, 1, 740, dt)
            S = slice(s, -s)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                got = st.stream_wavefront_pass(ak, names8[:1], raw, 3, s, orgw, gs_w, fused_shell=fs1, **kw)[0]
                want = st.stream_wavefront_pass_plain(ak, names8[:1], raw, 3, s, orgw, gs_w, fused_shell=fs1, **kw)[0]
                hold(f"stream_wavefront_pass_fused_{suffix}", got[0][:, S, S, S], want[0][:, S, S, S], 3, bf16,
                     f"(2,40,70,130) m=3 queue, fused, {tag}")
                if not bf16:
                    got = st.stream_wavefront_pass(off_mxu_kernel, ["u"], raw, 2, s, orgw, gs_w, fused_shell=fs1,
                                                   **kw)[0]
                    want = st.stream_wavefront_pass_plain(off_mxu_kernel, ["u"], raw, 2, s, orgw, gs_w,
                                                          fused_shell=fs1, **kw)[0]
                    hold(f"stream_wavefront_pass_fused_{suffix}", got[0][:, S, S, S], want[0][:, S, S, S], 2, bf16,
                         f"(2,40,70,130) m=2 general, fused, {tag}")
            del raws, fs, raw, fs1, got, want
    torch.cuda.empty_cache()
    log(f"phase 23: every fused contraction form against its plain version on ragged blocks, "
        f"{len(rec['checks'])} checks, {time.perf_counter() - t0:.1f} s")

    # -- the main path's shapes: held, then timed beside the vpu fused form
    # and the array contraction form
    t0 = time.perf_counter()
    times = bk.stream_fused_mxu_times(dev, device_ms=lambda call, n: device_ms_per_call(call, per_call=n), plain=True,
                                      check=lambda form, got, want, levels: hold(form, got, want, levels,
                                                                                 what="the main path's shape"))
    ps = N // 2 + 6
    shapes = {"stream_plane_pass": f"{AST_Q} fields x (8,{ps},{ps},{ps}) f32, shell 3, buffers (8,6,{ps},{ps}) x 3 "
                                   "a field",
              "stream_wavefront_pass": f"1 field x (8,{ps},{ps},{ps}) f32 m=3 s=3, buffers (8,6,{ps},{ps}) x 3"}
    for name, t in times.items():
        base = name.split("_fused")[0]
        rec["forms"][name] = {"ms": t["ms"], "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
                              "bound": (t["bound_ms"], t["bound_by"]), "bound_of": t["bound_of"],
                              "tensor_core_flops": t["tensor_core_flops"], "vpu_fused_ms": t["vpu_fused_ms"],
                              "vpu_fused_device_ms": t["vpu_fused_device_ms"], "mxu_array_ms": t["mxu_array_ms"],
                              "mxu_array_device_ms": t["mxu_array_device_ms"], "launch": t.get("launch"),
                              "ptxas": t["ptxas"], "mxu_array_ptxas": t["mxu_array_ptxas"],
                              "shape": f"{shapes[base]}, {t['compute_unit']} on {t['mxu_input']} operands"}
        f = rec["forms"][name]
        log(f"{name} {f['shape']}: CUDA events {f['ms']:.4f} ms a call, device {f['device_ms']:.4f} (vpu fused form "
            f"{f['vpu_fused_ms']:.4f}, device {f['vpu_fused_device_ms']:.4f}; array contraction form "
            f"{f['mxu_array_ms']:.4f}, device {f['mxu_array_device_ms']:.4f}; plain {f['plain_ms']:.4f}), bound "
            f"{f['bound'][0]:.4f} ms ({f['bound_of']})" + (f"; launch {plan_str(f['launch'])}" if f["launch"] else "")
            + f" on {card}")
    torch.cuda.empty_cache()
    log(f"phase 23: main-path shapes held and timed in {time.perf_counter() - t0:.1f} s")

    # -- Astaroth at full width on 2x2x2 under each unit, fused and split:
    # 24 iterations with the counters reset before and read after, held
    # against the f32 vpu run
    top = float(ref.abs().max())

    def interiors_of(sim) -> list:
        lo, n = sim.dd.shell_radius().lo(), sim.dd.local_spec().sz
        dim = sim.dd.grid_dim()
        return [sim.dd.get_curr(h)[..., lo.x:lo.x + n.x, lo.y:lo.y + n.y, lo.z:lo.z + n.z]
                .permute(0, 3, 1, 4, 2, 5).reshape(dim.x * n.x, dim.y * n.y, dim.z * n.z) for h in sim.handles]

    t0 = time.perf_counter()
    for suffix, (unit, mi) in MXU22.items():
        for key, (schedule, route, halo, overlap, want_route) in AST23.items():
            sim = AstarothSim(N, N, N, num_quantities=AST_Q, kernel_impl="cuda", schedule=schedule,
                              exchange_route=route, stream_halo=halo, stream_overlap=overlap, compute_unit=unit,
                              mxu_input=mi)
            sim.dd.set_partition(2, 2, 2)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # a plane without a band tile runs the dense form
                sim.realize()
            plan = sim._step._stream_plan
            fused = halo == "fused"
            if (plan["route"], plan["halo"], plan["overlap"], plan["compute_unit"], plan["mxu_input"],
                    plan["z_slabs"]) != (want_route, "fused" if fused else "array", "off" if fused else "split", unit,
                                         mi, False):
                raise AssertionError(f"phase 23 astaroth {key} {unit}/{mi}: plan {plan}")
            ledger.reset_launch_counts()
            sync()
            t1 = time.perf_counter()
            sim.step(AST_ITERS)
            sync()
            dts = [(time.perf_counter() - t1) / AST_ITERS]
            counts = {k: v for k, v in ledger.launch_counts().items() if v}
            kernel = f"stream_{want_route}_pass"
            form = f"{kernel}_fused_{suffix}" if fused else f"{kernel}_{suffix}"
            groups = AST_Q if plan["grouping"] == "per-field" else 1
            # a pass a step (plane) or a macro (wavefront) a group; under
            # split the interior pass and six band passes
            want = groups * (AST_ITERS if want_route == "plane" else -(-AST_ITERS // plan["m"])) * (1 if fused else 7)
            others = sorted(k for k in counts if k.startswith(kernel) and k != form)
            if counts.get(form, 0) != want or others:
                raise AssertionError(f"phase 23 astaroth {key} {unit}/{mi}: launches {counts}, want {want} of {form} "
                                     f"and none of {others}")
            err, finite = 0.0, True
            for q, got in enumerate(interiors_of(sim)):
                finite = finite and bool(torch.isfinite(got).all())
                err = max(err, float((got.double() - ref[q].to(dev).double()).abs().max()))
            limit = mxu_vs_vpu_atol(AST_ITERS, top, mi)
            if not finite or err > limit:
                raise AssertionError(f"phase 23 astaroth {key} {unit}/{mi}: finite {finite}, {err} against the vpu "
                                     f"run exceeds {limit}")
            sync()
            t1 = time.perf_counter()
            sim.step(AST_ITERS)
            sync()
            dts.append((time.perf_counter() - t1) / AST_ITERS)
            dt = min(dts)
            twin22 = mx22["routes"].get(f"per-step 2x2x2 {suffix}") if want_route == "plane" else None
            entry = {"route": plan["route"], "m": plan["m"], "grouping": plan["grouping"], "exchange_route": route,
                     "halo": plan["halo"], "overlap": plan["overlap"], "compute_unit": unit, "mxu_input": mi,
                     "launches": counts, "max_abs_err_vs_vpu": err, "limit": limit, "ms_per_iter": dt * 1e3,
                     "ms_per_iter_runs": [t * 1e3 for t in dts], "mupdates_per_s": AST_Q * N ** 3 / dt / 1e6,
                     "vpu_ms_per_iter": f16[key]["ms_per_iter"],
                     "array_mxu_ms_per_iter": twin22["ms_per_iter"] if twin22 else None}
            rec["routes"][f"{key} {suffix}"] = entry
            log(f"phase 23 astaroth {AST_Q}q {N}^3 {key} 2x2x2 {unit}/{mi} ({plan['route']}, m={plan['m']}, "
                f"{plan['grouping']}, {route}): {dt * 1e3:.4f} ms/iter against {f16[key]['ms_per_iter']:.4f} (vpu, "
                "phase 16)" + (f" and {twin22['ms_per_iter']:.4f} (array halo, phase 22)" if twin22 else "")
                + f"; {counts[form]} launches of {form}; max abs err against the vpu run {err:.3e} (limit "
                f"{limit:.3e}) on {card}")
            fe = rec["forms"].get(form)
            if fe is not None and "counts" not in fe:
                fe["counts"], fe["want"] = counts, want
            del sim
            torch.cuda.empty_cache()
    log(f"phase 23: Astaroth runs in {time.perf_counter() - t0:.1f} s")
    missing = [name for name, f in rec["forms"].items() if "counts" not in f]
    if missing:
        raise AssertionError(f"phase 23: no run launched {missing}")
    rec["errs"] = errs
    return rec


def main() -> int:
    t_start = time.perf_counter()
    phase_s = {}
    phase_peak_gb = {}

    def phase_end() -> None:
        """Keep the peak device memory of the phase that is running."""
        if phase_s:
            phase_peak_gb[max(phase_s)] = torch.cuda.max_memory_allocated() / 1e9

    def phase_start(phase: int) -> None:
        """Log and keep the seconds since the start at which ``phase`` begins;
        close the previous phase's peak memory and reset the peak."""
        phase_end()
        torch.cuda.reset_peak_memory_stats()
        phase_s[phase] = time.perf_counter() - t_start
        log(f"[{phase_s[phase]:.1f} s] phase {phase}")

    # --- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    from concurrent.futures import ThreadPoolExecutor

    from stencil_tpu_torch.bin import bench_kernels as bk
    from stencil_tpu_torch.bin import bench_pack as bp
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.core.geometry import LocalSpec
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain
    from stencil_tpu_torch.kernels import build, ledger
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.models.jacobi import COLD_TEMP, HOT_TEMP, Jacobi3D
    from stencil_tpu_torch.ops import halo_blend as hb
    from stencil_tpu_torch.ops import jacobi_kernels as jk
    from stencil_tpu_torch.ops import pack as pk
    from stencil_tpu_torch.ops import plane_stencil as m6
    from stencil_tpu_torch.ops import stream as st
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES, halo_exchange_shard
    from stencil_tpu_torch.ops.stream_trace import StreamKernel

    # the traced kernels phase 3 runs: Astaroth's own (one field for the
    # per-field wavefront, all 8 for the joint wrap and plane passes), and
    # ragged cases of a 27-point and a coordinate-forced kernel
    ast_kernel = AstarothSim(8, 8, 8, device=dev)._kernel
    ast_names = [f"d{i}" for i in range(AST_Q)]
    gs_main = (N, N, N)
    ak1 = StreamKernel(ast_kernel, ast_names[:1], 1, gs_main)
    ak8 = StreamKernel(ast_kernel, ast_names, 1, gs_main)
    gs_r = (30, 40, 140)
    ragged_k = {name: StreamKernel(fn, names, 1, gs_r) for name, fn, names in (
        ("k27", k27_kernel, ["u"]), ("forced", forced_kernel, ["u"]), ("mean6x2", ast_kernel, ["a", "b"]),
        ("xdiag", xdiag_kernel, ["u", "c"]))}
    stream_sources = [("stream_wrap", st._source(ak8, "stream_wrap", st._WRAP_LEVELS)),
                      ("stream_plane", st._source(ak8, "stream_plane", [1]))]
    stream_sources += [("stream_wavefront", st._source(ak1, *st._wavefront_variant(m))) for m in (1, 2, 3)]
    # phase 16's fused forms: the plane's over 8 fields, the wavefront's per field
    stream_sources.append(("stream_plane_fused", st._source(ak8, "stream_plane_fused", [1], st._FUSED)))
    stream_sources += [("stream_wavefront_fused", st._source(ak1, *st._wavefront_variant(m, True)))
                       for m in (1, 2, 3)]
    # phase 8's small check runs Astaroth with 2 joint fields (the same body
    # as "mean6x2": field names do not reach the emitted code)
    ak2 = StreamKernel(ast_kernel, ast_names[:2], 1, (32, 32, 32))
    stream_sources += [("stream_wavefront", st._source(ak2, *st._wavefront_variant(m))) for m in (1, 3)]
    # phase 20's dtype builds: Astaroth's kernel over 8 fields (wrap and
    # plane, both forms) and over one (every wavefront depth, both forms, and
    # the ragged wrap and plane checks), the 27-point kernel's wavefront
    for dt in (torch.bfloat16, torch.float64):
        sk8 = StreamKernel(ast_kernel, ast_names, 1, gs_main, dtypes=[dt] * AST_Q)
        sk1 = StreamKernel(ast_kernel, ast_names[:1], 1, gs_main, dtypes=[dt])
        k27d = StreamKernel(k27_kernel, ["u"], 1, gs_r, dtypes=[dt])
        for sk in (sk8, sk1):
            stream_sources += [("stream_wrap", st._source(sk, "stream_wrap", st._WRAP_LEVELS)),
                               ("stream_plane", st._source(sk, "stream_plane", [1])),
                               ("stream_plane_fused", st._source(sk, "stream_plane_fused", [1], st._FUSED))]
        for m in (1, 2, 3):
            stream_sources += [("stream_wavefront", st._source(sk1, *st._wavefront_variant(m))),
                               ("stream_wavefront_fused", st._source(sk1, *st._wavefront_variant(m, True)))]
        for m in (1, 3):
            stream_sources += [("stream_wavefront", st._source(k27d, *st._wavefront_variant(m))),
                               ("stream_wavefront_fused", st._source(k27d, *st._wavefront_variant(m, True)))]
    # phase 22's contraction forms (Astaroth's _kernel_mxu): over 8 fields
    # (wrap, plane) and one (every wavefront depth), on f32 and bf16
    # operands, and under bf16 storage on f32 ones; and the general form's
    # kernel at m = 2
    ast_mxu = AstarothSim._kernel_mxu
    for mi in ("f32", "bf16"):
        for dt in (torch.float32, torch.bfloat16) if mi == "f32" else (torch.float32,):
            sk8 = StreamKernel(ast_mxu, ast_names, 1, gs_main, dtypes=[dt] * AST_Q, compute_unit="mxu", mxu_input=mi)
            sk1 = StreamKernel(ast_mxu, ast_names[:1], 1, gs_main, dtypes=[dt], compute_unit="mxu", mxu_input=mi)
            stream_sources += [("stream_wrap", st._source(sk8, "stream_wrap", st._WRAP_LEVELS)),
                               ("stream_plane", st._source(sk8, "stream_plane", [1]))]
            stream_sources += [("stream_wavefront", st._source(sk1, *st._wavefront_variant(m)))
                               for m in ((1, 2, 3) if dt == torch.float32 else (3,))]
        sko = StreamKernel(off_mxu_kernel, ["u"], 1, gs_r, compute_unit="mxu", mxu_input=mi)
        stream_sources.append(("stream_wavefront", st._source(sko, *st._wavefront_variant(2))))
        # phase 23's fused contraction forms: the plane's over 8 fields,
        # every depth of the wavefront's over one, and the general form's
        for dt in (torch.float32, torch.bfloat16) if mi == "f32" else (torch.float32,):
            sk8 = StreamKernel(ast_mxu, ast_names, 1, gs_main, dtypes=[dt] * AST_Q, compute_unit="mxu", mxu_input=mi)
            sk1 = StreamKernel(ast_mxu, ast_names[:1], 1, gs_main, dtypes=[dt], compute_unit="mxu", mxu_input=mi)
            stream_sources.append(("stream_plane_fused", st._source(sk8, "stream_plane_fused", [1], st._FUSED)))
            stream_sources += [("stream_wavefront_fused", st._source(sk1, *st._wavefront_variant(m, True)))
                               for m in ((1, 2, 3) if dt == torch.float32 else (3,))]
        stream_sources.append(("stream_wavefront_fused", st._source(sko, *st._wavefront_variant(2, True))))
    # phase 15's reference: the plane route of a mean6 user kernel
    stream_sources.append(("stream_plane", st._source(StreamKernel(mean6_kernel, ["u"], 1, gs_main),
                                                      "stream_plane", [1])))
    for sk in ragged_k.values():
        stream_sources += [("stream_wrap", st._source(sk, "stream_wrap", st._WRAP_LEVELS)),
                           ("stream_plane", st._source(sk, "stream_plane", [1])),
                           ("stream_wavefront", st._source(sk, *st._wavefront_variant(2)))]

    # --- 2. build -------------------------------------------------------------
    phase_start(2)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # every nvcc of both calls at once
        jobs = [pool.submit(build.build), pool.submit(build.build_generated, dict.fromkeys(stream_sources))]
        for job in jobs:
            job.result()
    log(f"build: {time.perf_counter() - t0:.2f} s wall for {list(build.SOURCES)} and "
        f"{len(set(stream_sources))} stream variants; "
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in build.BUILD_LOG.items()))

    # --- 3. kernel vs plain on the card -----------------------------------------
    phase_start(3)
    errs = {"jacobi_wrap_step": 0.0, "jacobi_plane_step": 0.0, "blend_slab": 0.0,
            "jacobi_zring_wavefront_step": 0.0, "jacobi_shell_wavefront_step": 0.0,
            "stream_wrap_pass": 0.0, "stream_plane_pass": 0.0, "stream_wavefront_pass": 0.0,
            "jacobi_slab_step": 0.0, "blend_slab_dynamic": 0.0, "pack_zshell_pallas": 0.0,
            "unpack_zshell_pallas": 0.0, "pack_yshell_pallas": 0.0, "unpack_yshell_pallas": 0.0,
            "pallas_pack_slab": 0.0, "pallas_unpack_slab": 0.0, "mean6_shell_wavefront_step": 0.0,
            "mean6_plane_step": 0.0, "stream_plane_pass_fused": 0.0, "stream_wavefront_pass_fused": 0.0}

    def hold(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        sync()
        e = max_err(got, want)
        errs[name] = max(errs[name], e)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain version (max abs err {e})")

    def wavefront_args(n, Xr, Yr, Z, s_off, ring, slabs, gs, seed):
        """Seeded inputs of one wavefront call over n blocks: raw, origins,
        d2 in the form's layout and (optionally) z slabs."""
        raw = seeded((n, Xr, Yr, Z), seed, dev)
        org = torch.tensor([[(7 * b) % gs[0], (5 * b) % gs[1], (3 * b) % gs[2]] for b in range(n)],
                           dtype=torch.int32, device=dev)
        if ring:
            d2 = torch.stack([jk.zring_dist2_plane(int(o[1]) - s_off, int(o[2]), s_off, Yr, Z, gs, dev)
                              for o in org])
        else:
            d2 = torch.stack([jk.yz_dist2_plane(int(o[1]) - s_off, int(o[2]) - s_off, (Yr, Z), gs, dev)
                              for o in org])
        zs = seeded((n, Xr, 2 * s_off, Yr), seed + 1, dev) if slabs else None
        return raw, org, d2, zs

    def hold_wavefront(ring, m, s_off, raw, org, d2, zs, gs, z_valid, what):
        """Kernel vs plain on the valid region: the block interior
        [s, ext - s) of every shelled axis, and the emitted z slabs at
        interior x planes and y rows (shell cells are unspecified)."""
        S = slice(s_off, -s_off)
        if ring:
            name, zsl = "jacobi_zring_wavefront_step", slice(None)
            kw = dict(interior_offset=s_off)
            got = jk.jacobi_zring_wavefront_step(raw, m, org, d2, gs, zs, **kw)
            want = jk.jacobi_zring_wavefront_step_plain(raw, m, org, d2, gs, zs, **kw)
        else:
            name = "jacobi_shell_wavefront_step"
            zsl = slice(s_off, (z_valid or raw.shape[-1]) - s_off)
            kw = dict(interior_offset=s_off, z_slabs=zs, z_valid=z_valid)
            got = jk.jacobi_shell_wavefront_step(raw, m, org, d2, gs, **kw)
            want = jk.jacobi_shell_wavefront_step_plain(raw, m, org, d2, gs, **kw)
        if zs is None:
            got, want = (got,), (want,)
        hold(name, got[0][:, S, S, zsl], want[0][:, S, S, zsl], what)
        if zs is not None:
            hold(name, got[1][:, S, :, S], want[1][:, S, :, S], what + " z_out")

    # the wrap kernel: ragged k = 1..8 and 12 (one march to three), axes
    # shorter than a march's apron, and the main path's call at 512^3 (k =
    # WRAP_AUTO_K) beside k = 1
    ragged = seeded((66, 70, 130), 1, dev)
    for k in (1, 2, 3, 4, 5, 6, 7, 8, 12):
        hold("jacobi_wrap_step", jk.jacobi_wrap_step(ragged, k), jk.jacobi_wrap_step_plain(ragged, k),
             f"66x70x130 k={k}")
    for shape, k in (((16, 5, 7), 4), ((24, 9, 11), 12)):
        tiny = seeded(shape, 3, dev)
        hold("jacobi_wrap_step", jk.jacobi_wrap_step(tiny, k), jk.jacobi_wrap_step_plain(tiny, k), f"{shape} k={k}")
    wrap_k = jk.choose_temporal_k((N, N, N))
    full = seeded((N, N, N), 2, dev)
    for k in (1, wrap_k):
        hold("jacobi_wrap_step", jk.jacobi_wrap_step(full, k), jk.jacobi_wrap_step_plain(full, k), f"{N}^3 k={k}")
    del full

    def crossing_origins(n, ext, gs_c):
        """Block b's start: x such that its ``ext`` planes hold the hot
        sphere's centre (b even) or the cold one's (b odd), y and z near 0."""
        hot_x, cold_x, _ = jk.sphere_params(gs_c[0])
        return torch.tensor([[((hot_x, cold_x)[b % 2] - ext // 2) % gs_c[0], b % gs_c[1], (3 * b) % gs_c[2]]
                             for b in range(n)], dtype=torch.int32, device=dev)

    # jacobi_plane_step (the plane form, a march of depth 1): ragged blocks
    # that both spheres cross, axes shorter than one 32 x 64 tile, partial
    # tiles in y and z, the tile exactly, n = 1 and 8; the whole block
    # compared (the shell copied through); then the shell route's blocks at
    # 512^3 and at 511^3 (the last shard a side padded)
    gs_r = (130, 140, 260)
    blocks_r = seeded((2, 66, 70, 130), 3, dev)
    org_r = torch.tensor([[64, 0, 128], [0, 68, 0]], dtype=torch.int32, device=dev)
    d2_r = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (68, 128), gs_r, dev) for o in org_r])
    hold("jacobi_plane_step", jk.jacobi_plane_step(blocks_r, org_r, d2_r, gs_r),
         jk.jacobi_plane_step_plain(blocks_r, org_r, d2_r, gs_r), "2x66x70x130")
    for n_p, X_p, Y_p, Z_p in ((1, 3, 3, 3), (1, 5, 4, 7), (8, 12, 35, 67), (8, 20, 32, 64), (1, 9, 61, 125)):
        gs_p = (60, Y_p - 1, Z_p)
        blk = seeded((n_p, X_p, Y_p, Z_p), 22, dev)
        o = crossing_origins(n_p, X_p - 2, gs_p)
        dd2 = torch.stack([jk.yz_dist2_plane(int(v[1]), int(v[2]), (Y_p - 2, Z_p - 2), gs_p, dev) for v in o])
        want = jk.jacobi_plane_step_plain(blk, o, dd2, gs_p)
        if n_p == 8 and not ((want == HOT_TEMP).any() and (want == COLD_TEMP).any()):
            raise AssertionError(f"jacobi_plane_step {n_p}x({X_p},{Y_p},{Z_p}): the spheres do not cross")
        hold("jacobi_plane_step", jk.jacobi_plane_step(blk, o, dd2, gs_p), want, f"{n_p}x({X_p},{Y_p},{Z_p})")
    half = N // 2
    gs = (N, N, N)
    blocks = seeded((8, half + 2, half + 2, half + 2), 4, dev)
    org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)],
                       dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in org])
    hold("jacobi_plane_step", jk.jacobi_plane_step(blocks, org, d2, gs),
         jk.jacobi_plane_step_plain(blocks, org, d2, gs), f"8x{half + 2}^3")
    gs_u = (N - 1,) * 3
    d2_u = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs_u, dev) for o in org])
    hold("jacobi_plane_step", jk.jacobi_plane_step(blocks, org, d2_u, gs_u),
         jk.jacobi_plane_step_plain(blocks, org, d2_u, gs_u), f"8x{half + 2}^3 of {N - 1}^3 (padded shards)")
    del d2_u

    small = seeded((3, 17, 19, 23), 5, dev) * 100
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.uint8):
        for axis in (0, 1, 2):
            ext = small.shape[1 + axis]
            for r, pos in ((1, 0), (2, 5), (3, ext - 3)):
                shape = list(small.shape)
                shape[1 + axis] = r
                slab = (seeded(shape, 6 + r, dev) * 100).to(dtype)
                base = small.to(dtype)
                hold("blend_slab", hb.blend_slab(base.clone(), slab, axis, pos),
                     hb.blend_slab_plain(base.clone(), slab, axis, pos), f"{dtype} axis {axis} pos {pos}")
    # the exchange's six writes at the main path's shapes
    main_slabs = []
    for axis in (0, 1, 2):
        for pos in (0, half + 1):
            shape = list(blocks.shape)
            shape[1 + axis] = 1
            main_slabs.append((seeded(shape, 10 + axis * 2 + pos, dev), axis, pos))
    for slab, axis, pos in main_slabs:
        hold("blend_slab", hb.blend_slab(blocks.clone(), slab, axis, pos),
             hb.blend_slab_plain(blocks.clone(), slab, axis, pos), f"8x{half + 2}^3 axis {axis} pos {pos}")
    # blend_slab_dynamic: ragged blocks, an offset per block (the last one
    # differing, as on a padded axis, and one past the end, clamped); then
    # the three +axis halo writes of the uneven wavefront route (511^3 on
    # 2x2x2 at the depth its plan picks: 256 + 255 cells a side)
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.uint8):
        for axis in (0, 1, 2):
            ext = small.shape[1 + axis]
            for r, pos in ((1, [ext - 1, ext - 1, ext - 2]), (2, [0, 5, ext + 3]), (3, [ext - 4] * 2 + [ext - 3]),
                           (2, [-3, ext, 1])):
                shape = list(small.shape)
                shape[1 + axis] = r
                slab = (seeded(shape, 16 + r, dev) * 100).to(dtype)
                p = torch.tensor(pos, dtype=torch.int32, device=dev)
                base = small.to(dtype)
                hold("blend_slab_dynamic", hb.blend_slab_dynamic(base.clone(), slab, axis, p),
                     hb.blend_slab_dynamic_plain(base.clone(), slab, axis, p), f"{dtype} axis {axis} pos {pos}")
                # one block (n = 1, one offset)
                hold("blend_slab_dynamic", hb.blend_slab_dynamic(base[2].clone(), slab[2], axis, p[2:]),
                     hb.blend_slab_dynamic_plain(base[2].clone(), slab[2], axis, p[2:]),
                     f"{dtype} axis {axis} one block, pos {pos[2]}")
    NU = N - 1  # the uneven size
    mu = jk.wavefront_auto_depth(NU - half)  # the depth the padded plan picks
    ru = half + 2 * mu
    dyn_blocks = seeded((8, ru, ru, ru), 18, dev)
    dyn_writes = []  # (slab, axis, per-block offsets): the +axis halo lands after the valid cells
    for axis in (0, 1, 2):
        shape = [8, ru, ru, ru]
        shape[1 + axis] = mu
        last = [(b >> (2 - axis)) & 1 for b in range(8)]  # grid index on `axis`, stack order
        pos = torch.tensor([mu + (NU - half if i else half) for i in last], dtype=torch.int32, device=dev)
        dyn_writes.append((seeded(shape, 19 + axis, dev), axis, pos))
    for slab, axis, pos in dyn_writes:
        hold("blend_slab_dynamic", hb.blend_slab_dynamic(dyn_blocks.clone(), slab, axis, pos),
             hb.blend_slab_dynamic_plain(dyn_blocks.clone(), slab, axis, pos), f"8x{ru}^3 +axis {axis} m={mu}")
    # jacobi_slab_step: ragged blocks with random faces and with their own
    # faces (the periodic wrap), then the slab route's shapes (8 x 256^3)
    def slab_args(n, X, Y, Z, gs_s, seed, own=False):
        blk = seeded((n, X, Y, Z), seed, dev)
        if own:
            faces = [t.contiguous() for t in (blk[:, -1], blk[:, 0], blk[:, :, -1], blk[:, :, 0],
                                              blk[..., -1], blk[..., 0])]
        else:
            faces = [seeded((n,) + s, seed + 1 + i, dev)
                     for i, s in enumerate(((Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y), (X, Y)))]
        o = crossing_origins(n, X, gs_s)
        dd2 = torch.stack([jk.yz_dist2_plane(int(v[1]), int(v[2]), (Y, Z), gs_s, dev) for v in o])
        return blk, faces, o, dd2

    # (the slab form, a march of depth 1: X = 2 with axes shorter than a
    # tile and with partial tiles, partial tiles in y and z, a tile's 30 x 62
    # outputs exactly, n = 1, 3 and 8; both spheres cross where n >= 2)
    for n_s, X_s, Y_s, Z_s in ((1, 2, 3, 5), (1, 2, 1, 1), (8, 2, 31, 63), (3, 7, 33, 70), (8, 5, 30, 62),
                               (1, 9, 61, 125)):
        gs_s = (60, Y_s + 1, Z_s + 2)
        for own in (False, True):
            blk, faces, o, dd2 = slab_args(n_s, X_s, Y_s, Z_s, gs_s, 24, own)
            want = jk.jacobi_slab_step_plain(blk, *faces, o, dd2, gs_s)
            if n_s > 1 and min(X_s, Y_s, Z_s) >= 5 and not ((want == HOT_TEMP).any() and (want == COLD_TEMP).any()):
                raise AssertionError(f"jacobi_slab_step {n_s}x({X_s},{Y_s},{Z_s}): the spheres do not cross")
            hold("jacobi_slab_step", jk.jacobi_slab_step(blk, *faces, o, dd2, gs_s), want,
                 f"{n_s}x({X_s},{Y_s},{Z_s}) own={own}")
    slab_in = seeded((8, half, half, half), 32, dev)
    slab_faces = [seeded((8, half, half), 33 + i, dev) for i in range(6)]
    hold("jacobi_slab_step", jk.jacobi_slab_step(slab_in, *slab_faces, org, d2, gs),
         jk.jacobi_slab_step_plain(slab_in, *slab_faces, org, d2, gs), f"8x{half}^3")
    # the wavefront kernels: ragged blocks, m below and at the shell width,
    # z slabs none and set, dead columns (z_valid < Zr); then the main path's
    # shapes (2x2x2 subdomains of 256^3 at the depth the plan picks)
    for m in (1, 2, 3):
        for s_off in (m, m + 1):
            gs_w = (2 * (22 - 2 * s_off) + 3, 2 * (26 - 2 * s_off), 60)
            for slabs in (False, True):
                hold_wavefront(False, m, s_off, *wavefront_args(2, 22, 26, 30, s_off, False, slabs, gs_w, m),
                               gs_w, z_valid=27, what=f"2x(22,26,30) m={m} s={s_off} slabs={slabs}")
            gs_w = (gs_w[0], gs_w[1], 256)
            hold_wavefront(True, m, s_off, *wavefront_args(2, 22, 26, 128, s_off, True, True, gs_w, m),
                           gs_w, z_valid=None, what=f"2x(22,26,128) m={m} s={s_off}")
    # the depths the main path runs, one march (m = 4) and two (m = 6, 8):
    # three ragged blocks, partial tiles in y and z, 41 interior x planes,
    # gx so small that both spheres cross every block
    for m in (4, 6, 8):
        for s_off in (m, m + 1):
            Xd, Yd = 2 * s_off + 41, 2 * s_off + 29
            for ring, slabs in ((True, True), (False, True), (False, False)):
                Zd = 70 if ring else 75
                zvd = None if ring else Zd - 3
                gs_d = (2 * s_off + 5, Yd - 2 * s_off, Zd if ring else zvd - 2 * s_off)
                hold_wavefront(ring, m, s_off, *wavefront_args(3, Xd, Yd, Zd, s_off, ring, slabs, gs_d, m),
                               gs_d, zvd, f"3x({Xd},{Yd},{Zd}) m={m} s={s_off} ring={ring} slabs={slabs}")
    mw = jk.wavefront_auto_depth(half)  # the depth the 2x2x2 plan picks
    rw = half + 2 * mw
    main_ring = wavefront_args(8, rw, rw, half, mw, True, True, gs, 30)
    hold_wavefront(True, mw, mw, *main_ring, gs, None, f"8x({rw},{rw},{half}) m={mw}")
    main_shell = wavefront_args(8, rw, rw, rw, mw, False, True, gs, 32)
    hold_wavefront(False, mw, mw, *main_shell, gs, rw, f"8x{rw}^3 m={mw} slabs")
    hold_wavefront(False, mw, mw, *main_shell[:3], None, gs, None, f"8x{rw}^3 m={mw} no slabs")

    # the stream kernels: ragged cases, then the Astaroth main path's shapes
    def hold_fields(name, got, want, what):
        for q, (g, w) in enumerate(zip(got, want)):
            hold(name, g, w, f"{what} field {q}")

    def hold_stream_wavefront(sk, raws, m, s_off, org, gs_w, zs, z_valid, what):
        kw = dict(z_slabs=zs, z_valid=z_valid)
        got, got_z = st.stream_wavefront_pass(sk, sk.names, raws, m, s_off, org, gs_w, **kw)
        want, want_z = st.stream_wavefront_pass_plain(sk, sk.names, raws, m, s_off, org, gs_w, **kw)
        S, zv = slice(s_off, -s_off), z_valid or raws[0].shape[-1]
        hold_fields("stream_wavefront_pass", [g[:, S, S, s_off:zv - s_off] for g in got],
                    [w[:, S, S, s_off:zv - s_off] for w in want], what)
        if zs is not None:
            hold_fields("stream_wavefront_pass", [g[:, S, :, S] for g in got_z],
                        [w[:, S, :, S] for w in want_z], what + " z_out")

    wavefront_forms = {}  # the form each traced kernel's wavefront library takes
    for name, sk in ragged_k.items():
        nf = len(sk.names)
        blocks_w = [seeded(gs_r, 40 + q, dev) for q in range(nf)]
        org0 = torch.zeros(3, dtype=torch.int32, device=dev)
        hold_fields("stream_wrap_pass", st.stream_wrap_pass(sk, sk.names, blocks_w, 2, org0, gs_r),
                    st.stream_wrap_pass_plain(sk, sk.names, blocks_w, 2, org0, gs_r), f"{name} {gs_r} k=2")
        raws_p = [seeded((2, 17, 19, 70), 50 + q, dev) for q in range(nf)]
        org_p = torch.tensor([[0, 0, 0], [13, 17, 60]], dtype=torch.int32, device=dev)
        lo_p, hi_p = Dim3(1, 2, 1), Dim3(2, 1, 3)
        hold_fields("stream_plane_pass", st.stream_plane_pass(sk, sk.names, raws_p, lo_p, hi_p, 1, org_p, gs_r),
                    st.stream_plane_pass_plain(sk, sk.names, raws_p, lo_p, hi_p, 1, org_p, gs_r),
                    f"{name} 2x(17,19,70)")
        raws_w = [seeded((2, 22, 26, 40), 60 + q, dev) for q in range(nf)]
        zs_w = [seeded((2, 22, 6, 26), 70 + q, dev) for q in range(nf)]
        org_w = torch.tensor([[5, 0, 7], [27, 20, 0]], dtype=torch.int32, device=dev)
        for slabs in (False, True):
            hold_stream_wavefront(sk, raws_w, 2, 3, org_w, gs_r, zs_w if slabs else None, 37 if slabs else None,
                                  f"{name} 2x(22,26,40) m=2 s=3 slabs={slabs}")
        wavefront_forms[name] = st.stream_wavefront_launch(sk, sk.names, raws_w, 2, 3, gs_r)["form"]
    # the register queue exactly where every x+-1 read is centred
    if wavefront_forms != {"k27": "general", "forced": "queue", "mean6x2": "queue", "xdiag": "general"}:
        raise AssertionError(f"wavefront forms {wavefront_forms}")
    # main path shapes: the wrap pass over 8 fields of 512^3, the plane pass
    # over 8 fields of 8 x 262^3 blocks, the wavefront over one 518^3 field
    # (one subdomain) and one field of 8 x 262^3 blocks (2x2x2)
    org0 = torch.zeros(3, dtype=torch.int32, device=dev)
    main_wrap = [seeded(gs_main, 80 + q, dev) for q in range(AST_Q)]
    hold_fields("stream_wrap_pass", st.stream_wrap_pass(ak8, ast_names, main_wrap, 1, org0, gs_main),
                st.stream_wrap_pass_plain(ak8, ast_names, main_wrap, 1, org0, gs_main), f"{AST_Q}x{N}^3 k=1")
    torch.cuda.empty_cache()
    ps = half + 6
    main_plane = [seeded((8, ps, ps, ps), 90 + q, dev) for q in range(AST_Q)]
    shell3 = Dim3(3, 3, 3)
    hold_fields("stream_plane_pass", st.stream_plane_pass(ak8, ast_names, main_plane, shell3, shell3, 1, org, gs),
                st.stream_plane_pass_plain(ak8, ast_names, main_plane, shell3, shell3, 1, org, gs),
                f"{AST_Q} fields x 8x{ps}^3")
    # the shell packs: ragged blocks of four dtypes, one and three at once,
    # then the plane route's shapes (8 x 262^3, the radius-3 shell's windows)
    packs = {axis: (getattr(pk, f"pack_{axis}shell_pallas"), getattr(pk, f"pack_{axis}shell_pallas_plain"),
                    getattr(pk, f"unpack_{axis}shell_pallas"), getattr(pk, f"unpack_{axis}shell_pallas_plain"))
             for axis in ("z", "y")}

    def hold_packs(axis, blks, windows, seed, what):
        pack, pack_plain, unpack, unpack_plain = packs[axis]
        for start, depth in windows:
            buf = pack(blks, start, depth)
            hold(pack.__name__, buf, pack_plain(blks, start, depth), f"{what} [{start}, {start + depth})")
            new = (seeded(tuple(buf.shape), seed + start, dev) * 100).to(blks.dtype)
            hold(unpack.__name__, unpack(blks.clone(), new, start, depth),
                 unpack_plain(blks.clone(), new, start, depth), f"{what} [{start}, {start + depth})")

    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.uint8):
        base = small.to(dtype)
        for axis, dim in (("z", 2), ("y", 1)):
            ext = small.shape[1 + dim]
            windows = ((0, 1), (5, 3), (ext - 3, 3), (0, ext))
            hold_packs(axis, base, windows, 140, f"{axis} {dtype} 3x(17,19,23)")
            hold_packs(axis, base[1].contiguous(), windows, 150, f"{axis} {dtype} (17,19,23)")
    for axis in ("z", "y"):
        hold_packs(axis, main_plane[0], ((ps - 6, 3), (3, 3), (0, 3), (ps - 3, 3)), 160, f"{axis} 8x{ps}^3")
    # the slab packs: a ragged block of four widths, boxes on faces, an edge,
    # a corner and the whole block (phase 14 holds them at bench-pack's
    # shapes); the mean6 kernels at a ragged size with uneven shells, the
    # wavefront at m = 1, 2, 3 on its valid interior (phase 15: at 518^3)
    slab_boxes = ((Dim3(0, 0, 0), Dim3(3, 19, 23)), (Dim3(2, 16, 0), Dim3(13, 3, 23)),
                  (Dim3(1, 2, 20), Dim3(15, 17, 3)), (Dim3(14, 0, 5), Dim3(3, 3, 11)),
                  (Dim3(14, 16, 20), Dim3(3, 3, 3)), (Dim3(0, 0, 0), Dim3(17, 19, 23)))
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.uint8):
        base = small[0].to(dtype)
        for i, (pos, ext) in enumerate(slab_boxes):
            hold("pallas_pack_slab", pk.pallas_pack_slab(base, pos, ext), pk.pallas_pack_slab_plain(base, pos, ext),
                 f"{dtype} (17,19,23) box {pos} {ext}")
            new = (seeded(tuple(ext), 170 + i, dev) * 100).to(dtype)
            hold("pallas_unpack_slab", pk.pallas_unpack_slab(base.clone(), new, pos, ext),
                 pk.pallas_unpack_slab_plain(base.clone(), new, pos, ext), f"{dtype} (17,19,23) box {pos} {ext}")
    m6_raw = seeded((37, 41, 70), 180, dev)
    for lo, hi in (((1, 1, 1), (1, 1, 1)), ((1, 2, 3), (3, 1, 2))):
        hold("mean6_plane_step", m6.mean6_plane_step(m6_raw, lo, hi), m6.mean6_plane_step_plain(m6_raw, lo, hi),
             f"(37,41,70) lo={lo} hi={hi}")
    for m in range(1, m6.MEAN6_MAX_M + 1):  # one march up to m = 4, then two through the scratch
        sm = max(3, m)
        Sm = slice(sm, -sm)
        hold("mean6_shell_wavefront_step", m6.mean6_shell_wavefront_step(m6_raw, m, sm)[Sm, Sm, Sm],
             m6.mean6_shell_wavefront_step_plain(m6_raw, m, sm)[Sm, Sm, Sm], f"(37,41,70) m={m} s={sm}")
    del m6_raw
    torch.cuda.empty_cache()
    ws = N + 6
    main_wf = ([seeded((1, ws, ws, ws), 100, dev)], seeded((1, ws, 6, ws), 101, dev))
    hold_stream_wavefront(ak1, main_wf[0], 3, 3, org0.view(1, 3), gs_main, [main_wf[1]], ws,
                          f"1x{ws}^3 m=3 slabs")
    main_wf8 = ([main_plane[0]], seeded((8, ps, 6, ps), 102, dev))
    hold_stream_wavefront(ak1, main_wf8[0], 3, 3, org, gs, [main_wf8[1]], ps, f"8x{ps}^3 m=3 slabs")
    torch.cuda.empty_cache()
    log(f"kernel vs plain: bitwise equal on every case; max abs err {errs}; wavefront forms {wavefront_forms}")

    # --- 4. main path, wrap route ---------------------------------------------
    phase_start(4)
    cells = N ** 3
    wrap = Jacobi3D(N, N, N, kernel_impl="cuda")
    wrap.realize()
    ledger.reset_launch_counts()
    sync()
    wrap.step(CHECK_AT)
    sync()
    wrap_at_check = wrap.temperature()
    t0 = time.perf_counter()
    wrap.step(STEPS - CHECK_AT)
    sync()
    wrap_s = time.perf_counter() - t0
    wrap_counts = ledger.launch_counts()
    if wrap._pallas_path != "wrap" or wrap_counts["jacobi_wrap_step"] == 0:
        raise AssertionError(f"wrap route did not launch the wrap kernel: {wrap._pallas_path} {wrap_counts}")
    final = wrap.temperature()
    if not (np.isfinite(final).all() and final.min() >= COLD_TEMP and final.max() <= HOT_TEMP):
        raise AssertionError("wrap route: field not finite or outside [COLD, HOT] after 200 steps")
    log(f"wrap route: {STEPS} steps, launches {wrap_counts}, field in [{final.min()}, {final.max()}]")
    wrap_profile = device_breakdown(wrap)
    log_breakdown("wrap", wrap_profile)
    del wrap, final

    plain = torch.full((N, N, N), (HOT_TEMP + COLD_TEMP) / 2, device=dev)
    for _ in range(CHECK_AT):
        plain = jk.jacobi_wrap_step_plain(plain, 1)
    if not np.array_equal(plain.cpu().numpy(), wrap_at_check):
        raise AssertionError("wrap route != plain path on the card at step 10")
    del plain
    ref = Jacobi3D(N, N, N, kernel_impl="torch")
    ref.realize()
    sync()
    t0 = time.perf_counter()
    ref.step(CHECK_AT)
    sync()
    torch_s = time.perf_counter() - t0
    ref_at_check = ref.temperature()
    del ref
    torch.cuda.empty_cache()
    # the torch engine sums in _kernel's order, the kernels in the TPU kernels'
    np.testing.assert_allclose(wrap_at_check, ref_at_check, rtol=1e-6)
    log("wrap route: bitwise equal to the plain path and within rtol 1e-6 of the torch engine at step 10")

    # --- 5. main path, shell route --------------------------------------------
    phase_start(5)
    shell = Jacobi3D(N, N, N, kernel_impl="cuda", pallas_path="shell")
    shell.dd.set_partition(2, 2, 2)
    shell.realize()
    ledger.reset_launch_counts()
    sync()
    shell.step(CHECK_AT)
    sync()
    shell_at_check = shell.temperature()
    t0 = time.perf_counter()
    shell.step(STEPS - CHECK_AT)
    sync()
    shell_s = time.perf_counter() - t0
    shell_counts = ledger.launch_counts()
    if shell._pallas_path != "shell" or not (
        shell_counts["blend_slab"] > 0 and shell_counts["jacobi_plane_step"] > 0
    ):
        raise AssertionError(f"shell route did not launch its kernels: {shell._pallas_path} {shell_counts}")
    final = shell.temperature()
    if not (np.isfinite(final).all() and final.min() >= COLD_TEMP and final.max() <= HOT_TEMP):
        raise AssertionError("shell route: field not finite or outside [COLD, HOT] after 200 steps")
    if not np.array_equal(shell_at_check, wrap_at_check):
        raise AssertionError("shell route != wrap route at step 10")
    np.testing.assert_allclose(shell_at_check, ref_at_check, rtol=1e-6)
    log(f"shell route: {STEPS} steps, launches {shell_counts}; bitwise equal to the wrap route at step 10")
    shell_profile = device_breakdown(shell)
    log_breakdown("shell", shell_profile)
    stack = shell.dd.get_curr(shell.h)
    del final

    # --- 6. main path, wavefront route -----------------------------------------
    phase_start(6)
    def run_wavefront(**kw):
        model = Jacobi3D(N, N, N, kernel_impl="cuda", **kw)
        model.dd.set_partition(2, 2, 2)
        model.realize()
        ledger.reset_launch_counts()
        sync()
        model.step(CHECK_AT)
        sync()
        at_check = model.temperature()
        t0 = time.perf_counter()
        model.step(STEPS - CHECK_AT)
        sync()
        seconds = time.perf_counter() - t0
        counts = ledger.launch_counts()
        final = model.temperature()
        form = "z-ring" if model._wavefront_z_ring else "padded z-slab"
        if model._pallas_path != "wavefront" or not model._wavefront_z_slabs:
            raise AssertionError(f"expected the wavefront z-slab route, got {model._pallas_path}")
        if not (np.isfinite(final).all() and final.min() >= COLD_TEMP and final.max() <= HOT_TEMP):
            raise AssertionError(f"wavefront {form}: field not finite or outside [COLD, HOT] after 200 steps")
        if not np.array_equal(at_check, wrap_at_check):
            raise AssertionError(f"wavefront {form} != wrap route at step 10")
        np.testing.assert_allclose(at_check, ref_at_check, rtol=1e-6)
        m = model._wavefront_m
        # one launch per macro step of m levels, plus one per remainder
        launches = sum(-(-k // m) for k in (CHECK_AT, STEPS - CHECK_AT))
        kernel = "jacobi_zring_wavefront_step" if model._wavefront_z_ring else "jacobi_shell_wavefront_step"
        if counts[kernel] != launches or counts["blend_slab"] == 0:
            raise AssertionError(f"wavefront {form}: launches {counts}, want {launches} of {kernel}")
        log(f"wavefront route ({form}, m={m}, shells {model.dd.local_spec().raw_size()}): {STEPS} steps, "
            f"launches {counts}; bitwise equal to the wrap route at step 10")
        return model, seconds, counts

    def single_steps(model, calls: int = 20):
        """ms per ``step(1)`` call, the host clock around the call and a
        synchronize: (min, median) over ``calls`` calls after a dropped one."""
        times = []
        for _ in range(calls + 1):
            sync()
            t0 = time.perf_counter()
            model.step(1)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        final = model.temperature()
        if not (np.isfinite(final).all() and final.min() >= COLD_TEMP and final.max() <= HOT_TEMP):
            raise AssertionError("step(1) calls: field not finite or outside [COLD, HOT]")
        return min(times[1:]), statistics.median(times[1:])

    wave, wave_s, wave_counts = run_wavefront()  # pallas_path="auto"
    if not wave._wavefront_z_ring or wave._wavefront_m != mw:
        raise AssertionError(f"auto at 512^3 on 2x2x2: want the z-ring form at m={mw}")
    wave_profile = device_breakdown(wave)
    log_breakdown("wavefront", wave_profile)
    step1 = {"wavefront_zring": single_steps(wave), "shell": single_steps(shell)}
    log("step(1) per call, ms (min, median of 20): "
        + ", ".join(f"{k} {v[0]:.4f}, {v[1]:.4f}" for k, v in step1.items()))
    del wave
    slab, slab_s, slab_counts = run_wavefront(pallas_path="wavefront", z_ring=False)
    slab_profile = device_breakdown(slab)
    log_breakdown("wavefront z-slab", slab_profile)
    del slab
    torch.cuda.empty_cache()

    # --- 7. times ---------------------------------------------------------------
    phase_start(7)
    src = torch.empty((N, N, N), device=dev)
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src))
    copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)
    log(f"copy_ on {N}^3 f32: {copy_ms:.4f} ms, {copy_bw / 1e9:.1f} GB/s")
    del dst

    # the wrap kernel: a call at the main path's k and at k = 1, each read
    # once and written once whatever k (bound by bytes)
    block = seeded((N, N, N), 20, dev)
    wrap_bytes = 2 * cells * 4
    jacobi_wrap = {}
    for k in (wrap_k, 1):
        def wrap_call(k=k):
            return jk.jacobi_wrap_step(block, k)

        jacobi_wrap[k] = {
            "ms": cuda_ms(wrap_call, inner=2), "device_ms": device_ms_per_call(wrap_call),
            "plain_ms": cuda_ms(lambda k=k: jk.jacobi_wrap_step_plain(block, k), reps=3, inner=1),
            "bound_ms": bound(wrap_bytes, 7 * cells * k)[0], "launch": jk.jacobi_wrap_launch((N, N, N), k)}
        w = jacobi_wrap[k]
        log(f"jacobi wrap ({N},{N},{N}) k={k}: device {w['device_ms']:.4f} ms a call, CUDA events {w['ms']:.4f} ms "
            f"(plain {w['plain_ms']:.4f}), bound {w['bound_ms']:.4f} ms; launch {plan_str(w['launch'])} on {card}")
    wrap_ms, wrap_plain_ms = jacobi_wrap[wrap_k]["ms"], jacobi_wrap[wrap_k]["plain_ms"]
    del block, src

    blocks = stack.view(-1, *stack.shape[3:])
    out = torch.empty_like(blocks)
    plane_bytes = 2 * blocks.numel() * 4 + d2.numel() * 4 + org.numel() * 4
    plane_ms = cuda_ms(lambda: jk.jacobi_plane_step(blocks, org, d2, gs, out=out))
    plane_plain_ms = cuda_ms(lambda: jk.jacobi_plane_step_plain(blocks, org, d2, gs, out=out), inner=2)
    # the plane form (a march of depth 1): device ms a call and its launch plan
    plane_dev_ms = device_ms_per_call(lambda: jk.jacobi_plane_step(blocks, org, d2, gs, out=out))
    plane_launch = jk.jacobi_plane_launch(tuple(blocks.shape))
    log(f"jacobi_plane_step {tuple(blocks.shape)}: device {plane_dev_ms:.4f} ms a call, CUDA events "
        f"{plane_ms:.4f} ms (plain {plane_plain_ms:.4f}), bound {bound(plane_bytes, 7 * 8 * half ** 3)[0]:.4f} ms; "
        f"launch {plan_str(plane_launch)} on {card}")

    def exchange_writes(fn):
        def run():
            for slab, axis, pos in main_slabs:
                fn(blocks, slab, axis, pos)
        return run

    blend_bytes = sum(2 * s.numel() * 4 for s, _, _ in main_slabs)
    blend_ms = cuda_ms(exchange_writes(hb.blend_slab))
    blend_plain_ms = cuda_ms(exchange_writes(hb.blend_slab_plain))
    blend_lib_ms = cuda_ms(exchange_writes(lambda b, s, a, p: b.narrow(1 + a, p, s.shape[1 + a]).copy_(s)))
    per_axis = {
        axis: cuda_ms(lambda axis=axis: [hb.blend_slab(blocks, s, a, p) for s, a, p in main_slabs if a == axis])
        for axis in (0, 1, 2)
    }
    log("blend_slab per axis (lo+hi writes of one exchange, ms): "
        + ", ".join(f"axis {a}: {t:.4f}" for a, t in per_axis.items()))
    exchange_ms = cuda_ms(lambda: halo_exchange_shard(stack, shell.dd.radius()))
    log(f"shell route exchange (gathers + 6 blend_slab writes): {exchange_ms:.4f} ms")

    def wavefront_bytes(n, Xr, Yr, W, m, s_off, slabs):
        """Bytes one wavefront call over n blocks must move: each cell its m
        levels reach read once (planes and rows [s-m, ext-s+m), the columns
        the array holds, the slabs' m columns a side, d2 over those rows and
        columns, the origins) and the valid region written once (the block
        interior; the slabs at interior planes and rows).  W is the logical
        plane width (z_valid, or Zi + 2s on the ring), whose s outer columns a
        side come from the slabs when they are given."""
        e = s_off - m  # shell cells no level reaches
        Xa, Ya, Wa = Xr - 2 * e, Yr - 2 * e, W - 2 * e
        Xi, Yi, Wi = Xr - 2 * s_off, Yr - 2 * s_off, W - 2 * s_off
        reads = Xa * Ya * (Wa - 2 * m if slabs else Wa) + Ya * Wa + 3
        writes = Xi * Yi * Wi
        if slabs:
            reads += Xa * 2 * m * Ya
            writes += Xi * 2 * s_off * Yi
        return n * (reads + writes) * 4

    wave_flops = 7 * 8 * half ** 3 * mw  # six adds and a multiply per cell and level
    ring_raw, ring_org, ring_d2, ring_zs = main_ring

    def zring_call():
        return jk.jacobi_zring_wavefront_step(ring_raw, mw, ring_org, ring_d2, gs, ring_zs)

    zring_ms = cuda_ms(zring_call, inner=2)
    zring_plain_ms = cuda_ms(
        lambda: jk.jacobi_zring_wavefront_step_plain(ring_raw, mw, ring_org, ring_d2, gs, ring_zs), reps=3, inner=1)
    zring_bytes = wavefront_bytes(8, rw, rw, half + 2 * mw, mw, mw, True)
    sh_raw, sh_org, sh_d2, sh_zs = main_shell

    def shwf_call():
        return jk.jacobi_shell_wavefront_step(sh_raw, mw, sh_org, sh_d2, gs, z_slabs=sh_zs, z_valid=rw)

    def plain_call():  # the shell form without slabs (the 511^3 auto route's)
        return jk.jacobi_shell_wavefront_step(sh_raw, mw, sh_org, sh_d2, gs)

    shwf_ms = cuda_ms(shwf_call, inner=2)
    shwf_plain_ms = cuda_ms(lambda: jk.jacobi_shell_wavefront_step_plain(sh_raw, mw, sh_org, sh_d2, gs,
                                                                         z_slabs=sh_zs, z_valid=rw),
                            reps=3, inner=1)
    shwf_bytes = wavefront_bytes(8, rw, rw, rw, mw, mw, True)
    # each Jacobi wavefront form at the main path's shapes: device ms a call
    # (a call may launch two marches), CUDA-event ms a call, the bound and
    # the launch plan
    jacobi_wf = {}
    for form, call, shape, ring, slabs, nbytes in (
            ("z-ring", zring_call, tuple(ring_raw.shape), True, True, zring_bytes),
            ("shell z-slab", shwf_call, tuple(sh_raw.shape), False, True, shwf_bytes),
            ("shell", plain_call, tuple(sh_raw.shape), False, False, wavefront_bytes(8, rw, rw, rw, mw, mw, False))):
        jacobi_wf[form] = {"device_ms": device_ms_per_call(call), "ms": cuda_ms(call, inner=2),
                           "bound_ms": bound(nbytes, wave_flops)[0], "shape": shape,
                           "launch": jk.jacobi_wavefront_launch(shape, mw, ring=ring, slabs=slabs)}
        w = jacobi_wf[form]
        log(f"jacobi wavefront {form} {shape} m={mw}: device {w['device_ms']:.4f} ms a call, CUDA events "
            f"{w['ms']:.4f} ms, bound {w['bound_ms']:.4f} ms; launch {plan_str(w['launch'])} on {card}")
    del main_ring, ring_raw, ring_zs, main_shell, sh_raw, sh_zs

    wrap_mcells = cells * (STEPS - CHECK_AT) / wrap_s / 1e6
    shell_mcells = cells * (STEPS - CHECK_AT) / shell_s / 1e6
    wave_mcells = cells * (STEPS - CHECK_AT) / wave_s / 1e6
    slab_mcells = cells * (STEPS - CHECK_AT) / slab_s / 1e6
    torch_mcells = cells * CHECK_AT / torch_s / 1e6
    log(f"route wrap: {wrap_mcells:.1f} Mcells/s ({N}^3 f32, 1 subdomain, {STEPS - CHECK_AT} steps) on {card}")
    log(f"route shell: {shell_mcells:.1f} Mcells/s ({N}^3 f32, 2x2x2 subdomains, {STEPS - CHECK_AT} steps) on {card}")
    log(f"route wavefront z-ring (m={mw}): {wave_mcells:.1f} Mcells/s ({N}^3 f32, 2x2x2 subdomains, "
        f"{STEPS - CHECK_AT} steps) on {card}")
    log(f"route wavefront z-slab (m={mw}): {slab_mcells:.1f} Mcells/s ({N}^3 f32, 2x2x2 subdomains, "
        f"{STEPS - CHECK_AT} steps) on {card}")
    log(f"engine torch: {torch_mcells:.1f} Mcells/s ({N}^3 f32, 1 subdomain, {CHECK_AT} steps) on {card}")

    # --- 8. the Astaroth main path ------------------------------------------------
    phase_start(8)
    del main_wrap, main_plane, main_wf, main_wf8, stack, blocks, out, shell
    torch.cuda.empty_cache()
    ast_cases = (("wavefront", "wavefront", None), ("auto", "wrap", None),
                 ("per-step", "plane", (2, 2, 2)), ("auto", "wavefront", (2, 2, 2)))
    # a small input first: every route against the torch engine, bitwise
    small_ref = AstarothSim(32, 32, 32, num_quantities=2)
    small_ref.realize()
    small_ref.step(7)
    for schedule, route, part in ast_cases:
        sim = AstarothSim(32, 32, 32, num_quantities=2, kernel_impl="cuda", schedule=schedule,
                          subdomains=1 if part is None else 8)
        sim.realize()
        sim.step(7)
        if sim._step._stream_plan["route"] != route or not all(
                np.array_equal(sim.field(i), small_ref.field(i)) for i in range(2)):
            raise AssertionError(f"astaroth 32^3 {schedule} {part}: not the torch engine's fields")
    log("astaroth 32^3, 2 quantities: every route bitwise equal to the torch engine after 7 steps")

    def interiors(sim) -> torch.Tensor:
        """Every field's interior on the card, (q, X, Y, Z) in global order."""
        lo, n = sim.dd.shell_radius().lo(), sim.dd.local_spec().sz
        return torch.stack([
            sim.dd.get_curr(h)[..., lo.x:lo.x + n.x, lo.y:lo.y + n.y, lo.z:lo.z + n.z]
            .permute(0, 3, 1, 4, 2, 5).reshape(N, N, N) for h in sim.handles])

    ast = {}
    ast_first = None
    for schedule, route, part in ast_cases:
        key = f"{schedule} {'x'.join(map(str, part or (1, 1, 1)))}"
        sim = AstarothSim(N, N, N, num_quantities=AST_Q, kernel_impl="cuda", schedule=schedule)
        if part is not None:
            sim.dd.set_partition(*part)
        t0 = time.perf_counter()
        sim.realize()  # allocation, init and the kernels' build
        setup_s = time.perf_counter() - t0
        plan = sim._step._stream_plan
        ledger.reset_launch_counts()
        sync()
        sim.step(AST_ITERS)
        sync()
        counts = ledger.launch_counts()
        if plan["route"] != route:
            raise AssertionError(f"astaroth {key}: route {plan['route']}, want {route}")
        kernel = f"stream_{route}_pass"
        if counts[kernel] == 0:
            raise AssertionError(f"astaroth {key}: {kernel} never launched: {counts}")
        got = interiors(sim)
        if not (bool(torch.isfinite(got).all()) and float(got.abs().max()) <= 1.0):
            raise AssertionError(f"astaroth {key}: fields not finite or outside [-1, 1]")
        if ast_first is None:
            ast_first = got
        elif not torch.equal(got, ast_first):
            raise AssertionError(f"astaroth {key} != {ast_cases[0][0]} after {AST_ITERS} iterations")
        del got
        dts = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            sim.step(AST_ITERS)
            sync()
            dts.append((time.perf_counter() - t0) / AST_ITERS)
        dt = min(dts)
        prof = device_breakdown(sim, AST_ITERS)
        ledger.reset_launch_counts()  # the unit of PERF.md's kernel table
        sim.step(STEPS)
        sync()
        counts_200 = {k: v for k, v in ledger.launch_counts().items() if v}
        ast[key] = {"route": plan["route"], "m": plan["m"], "grouping": plan["grouping"],
                    "z_slabs": plan["z_slabs"], "launches": counts, f"launches_{STEPS}": counts_200,
                    "ms_per_iter": dt * 1e3,
                    "ms_per_iter_runs": [t * 1e3 for t in dts],
                    "mupdates_per_s": AST_Q * N ** 3 / dt / 1e6, "setup_s": setup_s, "profile": prof}
        log(f"astaroth {AST_Q}q {N}^3 schedule={key} ({plan['route']}, m={plan['m']}, {plan['grouping']}): "
            f"{dt * 1e3:.4f} ms/iter, {AST_Q * N ** 3 / dt / 1e6:.1f} Mupdates/s on {card}; launches per "
            f"{AST_ITERS} iterations {dict((k, v) for k, v in counts.items() if v)}, per {STEPS} {counts_200}; "
            f"bitwise equal to {ast_cases[0][0]}")
        log_breakdown(f"astaroth {key}", prof)
        del sim
        torch.cuda.empty_cache()
    ast_ref = ast_first.cpu()  # phases 13 and 16's reference, off the card until then
    ast_ref_host = ast_ref  # and phase 20's
    del ast_first
    torch.cuda.empty_cache()

    # --- 9. stream kernel times at the main path's shapes ------------------------------
    phase_start(9)
    def trace_ops(sk) -> int:
        """Arithmetic operations per cell of one field's update."""
        return sum(n.op not in ("load", "coord", "const") for n in sk.trace().live()) // len(sk.names)

    stream_wavefront_bytes = bk.stream_wavefront_bytes

    ops = trace_ops(ak1)
    wf_raw = [seeded((1, ws, ws, ws), 110, dev)]
    wf_zs = [seeded((1, ws, 6, ws), 111, dev)]
    wf_args = (ak1, ast_names[:1], wf_raw, 3, 3, org0.view(1, 3), gs_main)
    swf_ms = cuda_ms(lambda: st.stream_wavefront_pass(*wf_args, z_slabs=wf_zs, z_valid=ws), inner=2)
    swf_plain_ms = cuda_ms(lambda: st.stream_wavefront_pass_plain(*wf_args, z_slabs=wf_zs, z_valid=ws),
                           reps=3, inner=1)
    swf_bytes = stream_wavefront_bytes(1, ws, ws, ws, 3, 3, True, 1)
    swf_flops = ops * N ** 3 * 3
    # the launch (form, blocks an SM, waves) and its device ms a launch under
    # the profiler, at the one-subdomain shape and the 2x2x2 auto route's
    swf_launch = {}
    wf_cases = ((wf_raw, wf_zs, org0.view(1, 3), ws),
                ([seeded((8, ps, ps, ps), 112, dev)], [seeded((8, ps, 6, ps), 113, dev)], org, ps))
    for raws, zs, org_w, ext in wf_cases:
        n_w = raws[0].shape[0]
        swf_launch[f"({n_w},{ext},{ext},{ext})"] = dict(
            st.stream_wavefront_launch(ak1, ast_names[:1], raws, 3, 3, gs_main, z_slabs=zs, z_valid=ext),
            device_ms=device_ms_per_call(lambda: st.stream_wavefront_pass(
                ak1, ast_names[:1], raws, 3, 3, org_w, gs_main, z_slabs=zs, z_valid=ext), calls=10),
            bound_ms=bound(stream_wavefront_bytes(n_w, ext, ext, ext, 3, 3, True, 1),
                           ops * n_w * (ext - 6) ** 3 * 3)[0])
    if swf_launch[f"(1,{ws},{ws},{ws})"]["form"] != "queue":
        raise AssertionError(f"Astaroth's wavefront kernel is not in the register-queue form: {swf_launch}")
    log("stream_wavefront_pass launches (Astaroth kernel, 1 field, m=3, z slabs): " + "; ".join(
        f"{k} {v['form']} form, {v['threads']} threads, {v['smem_bytes']} B shared, {v['blocks_per_sm']} blocks/SM, "
        f"{v['blocks']} blocks = {v['waves']:.2f} waves ({v['nchunks']} x chunks of {v['xchunk']}), "
        f"{v['device_ms']:.4f} device ms a launch (bound {v['bound_ms']:.4f})" for k, v in swf_launch.items()))
    del wf_raw, wf_zs, wf_cases, raws, zs
    torch.cuda.empty_cache()
    wrap_in = [seeded(gs_main, 120 + q, dev) for q in range(AST_Q)]
    swr_ms = cuda_ms(lambda: st.stream_wrap_pass(ak8, ast_names, wrap_in, 1, org0, gs_main), inner=2)
    swr_plain_ms = cuda_ms(lambda: st.stream_wrap_pass_plain(ak8, ast_names, wrap_in, 1, org0, gs_main),
                           reps=3, inner=1)
    swr_bytes = 2 * AST_Q * N ** 3 * 4 + 12
    del wrap_in
    torch.cuda.empty_cache()
    plane_in = [seeded((8, ps, ps, ps), 130 + q, dev) for q in range(AST_Q)]
    pl_args = (ak8, ast_names, plane_in, shell3, shell3, 1, org, gs)
    spl_ms = cuda_ms(lambda: st.stream_plane_pass(*pl_args), inner=2)
    spl_plain_ms = cuda_ms(lambda: st.stream_plane_pass_plain(*pl_args), reps=3, inner=1)
    spl_bytes = 2 * AST_Q * 8 * ps ** 3 * 4 + 8 * 12
    del plane_in
    torch.cuda.empty_cache()
    log(f"stream kernels at the main path's shapes (ms, CUDA events): wavefront {swf_ms:.4f} "
        f"(plain {swf_plain_ms:.4f}), wrap {swr_ms:.4f} (plain {swr_plain_ms:.4f}), plane {spl_ms:.4f} "
        f"(plain {spl_plain_ms:.4f}) on {card}")

    # --- 10. the slab route ---------------------------------------------------------
    phase_start(10)
    def run_jacobi(size, **kw):
        """A Jacobi3D on 2x2x2 through ``STEPS`` steps, the counters reset
        just before and read just after: (model, field at step 10, seconds of
        the last STEPS - 10 steps, counts); the field is finite and inside
        [COLD, HOT] at the end."""
        model = Jacobi3D(size, size, size, kernel_impl="cuda", **kw)
        model.dd.set_partition(2, 2, 2)
        model.realize()
        ledger.reset_launch_counts()
        sync()
        model.step(CHECK_AT)
        sync()
        at_check = model.temperature()
        t0 = time.perf_counter()
        model.step(STEPS - CHECK_AT)
        sync()
        seconds = time.perf_counter() - t0
        counts = ledger.launch_counts()
        final = model.temperature()
        if not (np.isfinite(final).all() and final.min() >= COLD_TEMP and final.max() <= HOT_TEMP):
            raise AssertionError(f"{size}^3 {kw} ({model._pallas_path}): field not finite or outside "
                                 f"[COLD, HOT] after {STEPS} steps")
        return model, at_check, seconds, counts

    slabm, slab_at_check, slabr_s, slabr_counts = run_jacobi(N, pallas_path="slab")
    if slabm._pallas_path != "slab" or slabr_counts["jacobi_slab_step"] != STEPS:
        raise AssertionError(f"slab route: {slabm._pallas_path}, launches {slabr_counts}, want {STEPS} slab")
    if any(slabr_counts[k] for k in ("blend_slab", "blend_slab_dynamic", "jacobi_plane_step")):
        raise AssertionError(f"slab route wrote halos or ran the plane kernel: {slabr_counts}")
    if not np.array_equal(slab_at_check, wrap_at_check):
        raise AssertionError("slab route != wrap route at step 10")
    slabr_mcells = cells * (STEPS - CHECK_AT) / slabr_s / 1e6
    log(f"slab route: {STEPS} steps, launches {slabr_counts}; bitwise equal to the wrap route at step 10; "
        f"{slabr_mcells:.1f} Mcells/s ({N}^3 f32, 2x2x2 subdomains, {STEPS - CHECK_AT} steps) on {card}")
    slabr_profile = device_breakdown(slabm)
    log_breakdown("slab", slabr_profile)
    del slabm, slab_at_check
    torch.cuda.empty_cache()

    # --- 11. uneven sizes -------------------------------------------------------------
    phase_start(11)
    cells_u = NU ** 3
    wrap_u = Jacobi3D(NU, NU, NU, kernel_impl="cuda")
    wrap_u.realize()
    wrap_u.step(CHECK_AT)
    wrap_u_at_check = wrap_u.temperature()
    if wrap_u._pallas_path != "wrap":
        raise AssertionError(f"{NU}^3 on one subdomain: {wrap_u._pallas_path}, want wrap")
    del wrap_u
    torch.cuda.empty_cache()
    uneven = {}
    for label, kw, path in (("wavefront", {}, "wavefront"), ("shell", {"pallas_path": "shell"}, "shell")):
        model, at_check, seconds, counts = run_jacobi(NU, **kw)
        if model._pallas_path != path or model._wavefront_z_slabs or not model.dd.padded():
            raise AssertionError(f"{NU}^3 {label}: {model._pallas_path}, z slabs {model._wavefront_z_slabs}")
        # every exchange writes the +x, +y and +z halo after the valid cells
        exchanges = STEPS if path == "shell" else sum(-(-k // mu) for k in (CHECK_AT, STEPS - CHECK_AT))
        kernel = "jacobi_plane_step" if path == "shell" else "jacobi_shell_wavefront_step"
        if counts["blend_slab_dynamic"] != 3 * exchanges or counts[kernel] != exchanges:
            raise AssertionError(f"{NU}^3 {label}: launches {counts}, want {3 * exchanges} blend_slab_dynamic "
                                 f"and {exchanges} {kernel}")
        if path == "wavefront" and model._wavefront_m != mu:
            raise AssertionError(f"{NU}^3 auto: depth {model._wavefront_m}, want {mu}")
        if not np.array_equal(at_check, wrap_u_at_check):
            raise AssertionError(f"{NU}^3 {label} on 2x2x2 != the one-subdomain wrap route at step 10")
        mcells = cells_u * (STEPS - CHECK_AT) / seconds / 1e6
        prof = device_breakdown(model)
        uneven[label] = {"path": path, "m": model._wavefront_m, "launches": counts, "mcells_per_s": mcells,
                         "profile": prof}
        log(f"uneven {NU}^3 {label} (m={model._wavefront_m}, raw {model.dd.local_spec().raw_size()}, valid last "
            f"{model.dd.valid_last()}): {STEPS} steps, launches {counts}; bitwise equal to the one-subdomain wrap "
            f"route at step 10; {mcells:.1f} Mcells/s on {card}")
        log_breakdown(f"uneven {label}", prof)
        del model, at_check
        torch.cuda.empty_cache()

    def ast_interiors(sim, size) -> torch.Tensor:
        """Every field's valid interior on the card, (q, X, Y, Z) in global order."""
        lo, n = sim.dd.shell_radius().lo(), sim.dd.local_spec().sz
        dim = sim.dd.grid_dim()
        return torch.stack([
            sim.dd.get_curr(h)[..., lo.x:lo.x + n.x, lo.y:lo.y + n.y, lo.z:lo.z + n.z]
            .permute(0, 3, 1, 4, 2, 5).reshape(dim.x * n.x, dim.y * n.y, dim.z * n.z)[:size, :size, :size]
            for h in sim.handles])

    ref_ast = AstarothSim(NU, NU, NU, num_quantities=AST_Q, kernel_impl="cuda")
    ref_ast.realize()
    ref_ast.step(AST_ITERS)
    if ref_ast._step._stream_plan["route"] != "wrap":
        raise AssertionError("astaroth 511^3 on one subdomain: not the wrap route")
    ast_u_ref = ast_interiors(ref_ast, NU)
    del ref_ast
    torch.cuda.empty_cache()
    ast_u = {}
    for schedule, route in (("auto", "wavefront"), ("per-step", "plane")):
        sim = AstarothSim(NU, NU, NU, num_quantities=AST_Q, kernel_impl="cuda", schedule=schedule)
        sim.dd.set_partition(2, 2, 2)
        sim.realize()
        plan = sim._step._stream_plan
        ledger.reset_launch_counts()
        sync()
        sim.step(AST_ITERS)
        sync()
        counts = ledger.launch_counts()
        if plan["route"] != route or plan["z_slabs"] or counts[f"stream_{route}_pass"] == 0 \
                or counts["blend_slab_dynamic"] == 0:
            raise AssertionError(f"astaroth {NU}^3 {schedule} 2x2x2: plan {plan}, launches {counts}")
        got = ast_interiors(sim, NU)
        if not (bool(torch.isfinite(got).all()) and float(got.abs().max()) <= 1.0):
            raise AssertionError(f"astaroth {NU}^3 {schedule}: fields not finite or outside [-1, 1]")
        if not torch.equal(got, ast_u_ref):
            raise AssertionError(f"astaroth {NU}^3 {schedule} on 2x2x2 != the one-subdomain wrap route "
                                 f"after {AST_ITERS} iterations")
        del got
        dts = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            sim.step(AST_ITERS)
            sync()
            dts.append((time.perf_counter() - t0) / AST_ITERS)
        dt = min(dts)
        prof = device_breakdown(sim, AST_ITERS)
        ast_u[schedule] = {"route": route, "m": plan["m"], "grouping": plan["grouping"], "launches": counts,
                           "ms_per_iter": dt * 1e3, "ms_per_iter_runs": [t * 1e3 for t in dts],
                           "mupdates_per_s": AST_Q * cells_u / dt / 1e6, "profile": prof}
        log(f"astaroth {AST_Q}q {NU}^3 schedule={schedule} 2x2x2 ({route}, m={plan['m']}, {plan['grouping']}): "
            f"{dt * 1e3:.4f} ms/iter, {AST_Q * cells_u / dt / 1e6:.1f} Mupdates/s on {card}; launches per "
            f"{AST_ITERS} iterations {dict((k, v) for k, v in counts.items() if v)}; bitwise equal to the "
            f"one-subdomain wrap route")
        log_breakdown(f"astaroth uneven {schedule}", prof)
        del sim
        torch.cuda.empty_cache()
    ast_u_ref = ast_u_ref.cpu()  # phase 16's reference, off the card until then
    ast_u_ref_host = ast_u_ref  # and phase 20's
    torch.cuda.empty_cache()

    # --- 12. times of the slab and dynamic blend kernels ----------------------------
    phase_start(12)
    slab_out = torch.empty_like(slab_in)
    slab_args_main = (slab_in, *slab_faces, org, d2, gs)
    slabk_ms = cuda_ms(lambda: jk.jacobi_slab_step(*slab_args_main, out=slab_out))
    slabk_plain_ms = cuda_ms(lambda: jk.jacobi_slab_step_plain(*slab_args_main, out=slab_out), inner=2)
    slabk_bytes = (2 * slab_in.numel() + sum(f.numel() for f in slab_faces) + d2.numel() + org.numel()) * 4
    slabk_flops = 7 * slab_in.numel()
    # the slab form (a march of depth 1): device ms a call and its launch plan
    slabk_dev_ms = device_ms_per_call(lambda: jk.jacobi_slab_step(*slab_args_main, out=slab_out))
    slab_launch = jk.jacobi_slab_launch(tuple(slab_in.shape))
    del slab_out, slab_in, slab_faces
    dyn_ms, dyn_dev_ms, dyn_plain_ms, dyn_lib_ms = {}, {}, {}, {}
    for slab, axis, pos in dyn_writes:
        dyn_ms[axis] = cuda_ms(lambda: hb.blend_slab_dynamic(dyn_blocks, slab, axis, pos))
        dyn_dev_ms[axis] = device_ms_per_call(lambda: hb.blend_slab_dynamic(dyn_blocks, slab, axis, pos), calls=20)
        dyn_plain_ms[axis] = cuda_ms(lambda: hb.blend_slab_dynamic_plain(dyn_blocks, slab, axis, pos))
        # the one PyTorch call that makes the same write: scatter_ along the
        # axis with each block's indices pos[b] + i
        shape = [1, 1, 1, 1]
        shape[1 + axis] = mu
        index = (pos.long().view(8, 1, 1, 1) + torch.arange(mu, device=dev).view(shape)).expand(slab.shape)
        index = index.contiguous()
        lib_out = dyn_blocks.clone().scatter_(1 + axis, index, slab)
        if not torch.equal(lib_out, hb.blend_slab_dynamic(dyn_blocks.clone(), slab, axis, pos)):
            raise AssertionError(f"scatter_ and blend_slab_dynamic disagree on axis {axis}")
        del lib_out
        dyn_lib_ms[axis] = cuda_ms(lambda: dyn_blocks.scatter_(1 + axis, index, slab))
        del index
    dyn_bytes = 2 * dyn_writes[0][0].numel() * 4 + 8 * 4  # a write (each axis's): slab read, slab written, offsets
    dyn_desc = dict(zip(hb.BLEND_DYN_DESC_FIELDS, hb._blend_dynamic_launch(dyn_blocks, 0, mu)[0]))
    log("blend_slab_dynamic per +axis halo write at (8,{0},{0},{0}) m={1} (ms: kernel CUDA events, kernel device, "
        "plain, scatter_; bound {2:.4f} each): ".format(ru, mu, bound(dyn_bytes, 0)[0])
        + ", ".join(f"axis {a}: {dyn_ms[a]:.4f}, {dyn_dev_ms[a]:.4f}, {dyn_plain_ms[a]:.4f}, {dyn_lib_ms[a]:.4f}"
                    for a in (0, 1, 2)) + f"; the +x write's descriptor {dyn_desc} on {card}")
    log(f"jacobi_slab_step at 8x{half}^3, six slabs: device {slabk_dev_ms:.4f} ms a call, CUDA events "
        f"{slabk_ms:.4f} ms (plain {slabk_plain_ms:.4f}), bound {bound(slabk_bytes, slabk_flops)[0]:.4f} ms; "
        f"launch {plan_str(slab_launch)} on {card}")
    del dyn_blocks, dyn_writes
    torch.cuda.empty_cache()

    # --- 13. the packed exchange routes -----------------------------------------------
    phase_start(13)
    # blend_slab launches an iteration: 8 fields x 2 directions per sweep
    # that writes through it (x always, y and z unless packed by the kernels)
    blends = {"direct": 48, "zpack_xla": 48, "zpack_pallas": 32, "yzpack_xla": 48, "yzpack_pallas": 16}
    routes_13 = {}
    ref13 = ast_ref.to(dev)
    for route in EXCHANGE_ROUTES:
        sim = AstarothSim(N, N, N, num_quantities=AST_Q, kernel_impl="cuda", schedule="per-step",
                          exchange_route=route)
        sim.dd.set_partition(2, 2, 2)
        sim.realize()
        ledger.reset_launch_counts()
        sync()
        sim.step(AST_ITERS)
        sync()
        counts = ledger.launch_counts()
        z_on, y_on = route.endswith("pallas"), route == "yzpack_pallas"
        want = {"stream_plane_pass": AST_ITERS, "blend_slab": blends[route] * AST_ITERS,
                "pack_zshell_pallas": 16 * AST_ITERS * z_on, "unpack_zshell_pallas": 16 * AST_ITERS * z_on,
                "pack_yshell_pallas": 16 * AST_ITERS * y_on, "unpack_yshell_pallas": 16 * AST_ITERS * y_on}
        if sim.dd.exchange_route() != route or {k: counts[k] for k in want} != want \
                or sum(counts.values()) != sum(want.values()):
            raise AssertionError(f"astaroth per-step {route}: route {sim.dd.exchange_route()}, launches "
                                 f"{counts}, want {want}")
        got = interiors(sim)
        if not torch.equal(got, ref13):
            raise AssertionError(f"astaroth per-step {route} != phase 8's result after {AST_ITERS} iterations")
        del got
        dts = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            sim.step(AST_ITERS)
            sync()
            dts.append((time.perf_counter() - t0) / AST_ITERS)
        dt = min(dts)
        ex_ms = cuda_ms(sim.dd.exchange, inner=2)
        ex_dev_ms = device_ms_per_call(sim.dd.exchange)
        entry = {"launches": counts, "ms_per_iter": dt * 1e3, "ms_per_iter_runs": [t * 1e3 for t in dts],
                 "mupdates_per_s": AST_Q * N ** 3 / dt / 1e6, "exchange_ms": ex_ms,
                 "exchange_device_ms": ex_dev_ms}
        if route in ("direct", "yzpack_pallas"):
            entry["profile"] = device_breakdown(sim, AST_ITERS)
        if route == "yzpack_pallas":
            ledger.reset_launch_counts()  # the unit of PERF.md's kernel table
            sim.step(STEPS)
            sync()
            entry[f"launches_{STEPS}"] = {k: v for k, v in ledger.launch_counts().items() if v}
            pack_counts = counts
        routes_13[route] = entry
        log(f"astaroth {AST_Q}q {N}^3 per-step 2x2x2 exchange_route={route}: {dt * 1e3:.4f} ms/iter, "
            f"{AST_Q * N ** 3 / dt / 1e6:.1f} Mupdates/s, one {AST_Q}-field exchange {ex_ms:.4f} ms "
            f"({ex_dev_ms:.4f} device ms) on {card}; "
            f"launches per {AST_ITERS} iterations {dict((k, v) for k, v in counts.items() if v)}; bitwise "
            f"equal to phase 8's result")
        if "profile" in entry:
            log_breakdown(f"astaroth per-step {route}", entry["profile"])
        del sim
        torch.cuda.empty_cache()
    del ref13
    torch.cuda.empty_cache()
    # the four kernels at that path's shapes: one field's 8 blocks of 262^3,
    # the radius-3 shell; the library call is the same copy as one copy_ (as
    # one allocating pack_yshell_xla for pack_yshell_pallas)
    pk_blocks = seeded((8, ps, ps, ps), 170, dev)
    zbuf = pk.pack_zshell_pallas(pk_blocks, ps - 6, 3)
    ybuf = pk.pack_yshell_pallas(pk_blocks, ps - 6, 3)
    pack_cases = {
        "pack_zshell_pallas": (lambda: pk.pack_zshell_pallas(pk_blocks, ps - 6, 3),
                               lambda: pk.pack_zshell_pallas_plain(pk_blocks, ps - 6, 3),
                               lambda: zbuf.copy_(pk_blocks.narrow(3, ps - 6, 3).permute(0, 3, 2, 1))),
        "unpack_zshell_pallas": (lambda: pk.unpack_zshell_pallas(pk_blocks, zbuf, 0, 3),
                                 lambda: pk.unpack_zshell_pallas_plain(pk_blocks, zbuf, 0, 3),
                                 lambda: pk_blocks.narrow(3, 0, 3).copy_(zbuf.permute(0, 3, 2, 1))),
        "pack_yshell_pallas": (lambda: pk.pack_yshell_pallas(pk_blocks, ps - 6, 3),
                               lambda: pk.pack_yshell_pallas_plain(pk_blocks, ps - 6, 3),
                               lambda: pk.pack_yshell_xla(pk_blocks, ps - 6, 3)),
        "unpack_yshell_pallas": (lambda: pk.unpack_yshell_pallas(pk_blocks, ybuf, 0, 3),
                                 lambda: pk.unpack_yshell_pallas_plain(pk_blocks, ybuf, 0, 3),
                                 lambda: pk_blocks.narrow(2, 0, 3).copy_(ybuf.transpose(1, 2))),
    }
    # like for like, pack_yshell_pallas's library call allocates its buffer
    # as the wrapper does; the copy_ into a buffer made beforehand is kept beside
    def ycopy():
        return ybuf.copy_(pk_blocks.narrow(2, ps - 6, 3).transpose(1, 2))

    # the library copies make what the kernels make
    if not (torch.equal(pack_cases["pack_zshell_pallas"][2](), pk.pack_zshell_pallas(pk_blocks, ps - 6, 3))
            and torch.equal(pack_cases["pack_yshell_pallas"][2](), pk.pack_yshell_pallas(pk_blocks, ps - 6, 3))
            and torch.equal(ycopy(), pk.pack_yshell_pallas(pk_blocks, ps - 6, 3))):
        raise AssertionError("the library copies and the pack kernels disagree")
    pack_ms = {name: [cuda_ms(fn) for fn in fns] for name, fns in pack_cases.items()}
    ycopy_ms = cuda_ms(ycopy)
    # a launch's device time.  In the route: the profile's kernel time an
    # iteration over the launches an iteration (the window cold in L2; the
    # kernels are zshell_tile_kernel <T, true> packing and <T, false>
    # unpacking, yshell_rows_kernel <T, true> and <T, false>).  Back to back on
    # one block the window stays in L2, and CUDA events between calls count the
    # host's issue time.
    route_prof = routes_13["yzpack_pallas"]["profile"]["kernels_ms_per_step"]
    kernel_names = {"pack_zshell_pallas": ("zshell_tile_kernel<", ", true>"),
                    "unpack_zshell_pallas": ("zshell_tile_kernel<", ", false>"),
                    "pack_yshell_pallas": ("yshell_rows_kernel<", ", true>"),
                    "unpack_yshell_pallas": ("yshell_rows_kernel<", ", false>")}
    pack_dev_ms, pack_hot_ms, pack_lib_dev_ms = {}, {}, {}
    for name, fns in pack_cases.items():
        tag, form = kernel_names[name]
        per_iter = [v for k, v in route_prof.items() if tag in k and form in k]
        if route_prof and len(per_iter) != 1:
            raise AssertionError(f"{name}: {len(per_iter)} profiler entries of {tag}: {list(route_prof)}")
        # None where the route's traces held no launch (device_breakdown)
        pack_dev_ms[name] = per_iter[0] / (pack_counts[name] / AST_ITERS) if per_iter else None
        pack_hot_ms[name] = device_ms_per_call(fns[0], calls=20)
        pack_lib_dev_ms[name] = device_ms_per_call(fns[2], calls=20)
    ycopy_dev_ms = device_ms_per_call(ycopy, calls=20)
    ypack_host_us = {kind: host_us_per_call(fn) for kind, fn in
                     (("kernel", pack_cases["pack_yshell_pallas"][0]), ("library", pack_cases["pack_yshell_pallas"][2]),
                      ("copy_", ycopy))}
    yunpack_host_us = {kind: host_us_per_call(pack_cases["unpack_yshell_pallas"][i])
                       for kind, i in (("kernel", 0), ("copy_", 2))}
    pack_bytes = 2 * zbuf.numel() * 4  # the window read once and written once
    # the z pair's sector floor: the 32-byte sectors of the block that the
    # window's 12-byte runs touch, read by the pack beside the buffer's write,
    # filled and written back by the unpack beside the buffer's read
    z_sectors = {name: bk.zshell_sector_bytes(tuple(pk_blocks.shape), 4, z0, 3, pk_blocks.data_ptr())
                 for name, z0 in (("pack_zshell_pallas", ps - 6), ("unpack_zshell_pallas", 0))}
    z_floor_ms = {"pack_zshell_pallas": bound(z_sectors["pack_zshell_pallas"] + pack_bytes // 2, 0)[0],
                  "unpack_zshell_pallas": bound(2 * z_sectors["unpack_zshell_pallas"] + pack_bytes // 2, 0)[0]}
    log("shell packs at (8,{0},{0},{0}) f32 depth 3, each kernel's device ms a launch in the yzpack_pallas route "
        "(cold in L2), back to back (hot), copy_'s back to back, then the byte bound and the sector floor: ".format(ps)
        + "; ".join(f"{k} {ms4(pack_dev_ms[k])}, {pack_hot_ms[k]:.4f}, {pack_lib_dev_ms[k]:.4f}, "
                    f"{bound(pack_bytes, 0)[0]:.4f}, {ms4(z_floor_ms.get(k, bound(pack_bytes, 0)[0]))}"
                    for k in pack_cases) + f" on {card}")
    log("shell packs at (8,{0},{0},{0}) f32 depth 3 (ms: kernel, plain, copy_): ".format(ps)
        + ", ".join(f"{k}: {v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}" for k, v in pack_ms.items()) + "; device ms a "
        "launch in the route (profiler): " + ", ".join(
            f"{k} {ms4(v)}" for k, v in pack_dev_ms.items())
        + "; back to back, hot in L2: " + ", ".join(f"{k} {v:.4f} (library {pack_lib_dev_ms[k]:.4f})"
                                                    for k, v in pack_hot_ms.items())
        + f"; pack_yshell_pallas against the allocating pack_yshell_xla, copy_ {ycopy_ms:.4f} ms, "
        f"{ycopy_dev_ms:.4f} device; host µs a call: " + ", ".join(f"{k} {v:.2f}" for k, v in ypack_host_us.items())
        + "; unpack_yshell_pallas host µs a call: " + ", ".join(f"{k} {v:.2f}" for k, v in yunpack_host_us.items())
        + f" on {card}")
    del pk_blocks, zbuf, ybuf, pack_cases, ycopy
    # blend_slab at the same shapes: each axis's depth-3 low and high writes
    # of one field, held against the plain version; device ms a launch back to
    # back (the blocks hot in L2) and in the direct route's profile (its 16
    # launches an iteration an axis; the kernels are slab_rows_kernel<T,
    # false, axis> and, on z, slab_cells_kernel<T, false, 2>), beside
    # narrow(...).copy_; CUDA-event ms and host µs a call
    bl_blocks = seeded((8, ps, ps, ps), 175, dev)
    direct_prof = routes_13["direct"]["profile"]["kernels_ms_per_step"]
    blend_kernels = ("slab_rows_kernel<", "slab_cells_kernel<")
    blend_step = {}
    for axis in (0, 1, 2):
        shape = [8, ps, ps, ps]
        shape[1 + axis] = 3
        writes = [(seeded(shape, 176 + 2 * axis + i, dev), pos) for i, pos in enumerate((0, ps - 3))]
        for slab, pos in writes:
            hold("blend_slab", hb.blend_slab(bl_blocks.clone(), slab, axis, pos),
                 hb.blend_slab_plain(bl_blocks.clone(), slab, axis, pos), f"8x{ps}^3 depth 3 axis {axis} pos {pos}")

        def blend_writes():
            for slab, pos in writes:
                hb.blend_slab(bl_blocks, slab, axis, pos)

        def copy_writes():
            for slab, pos in writes:
                bl_blocks.narrow(1 + axis, pos, 3).copy_(slab)

        in_route = [v for k, v in direct_prof.items() if any(n in k for n in blend_kernels) and f", {axis}>" in k]
        blend_step[axis] = {
            "device_ms": device_ms_per_call(blend_writes, calls=10) / 2,
            "copy_device_ms": device_ms_per_call(copy_writes, calls=10) / 2,
            "device_ms_in_route": sum(in_route) / 16 if direct_prof else None, "ms": cuda_ms(blend_writes) / 2,
            "copy_ms": cuda_ms(copy_writes) / 2, "host_us": host_us_per_call(blend_writes) / 2,
            "copy_host_us": host_us_per_call(copy_writes) / 2,
            "bound_ms": bound(2 * writes[0][0].numel() * 4, 0)[0]}
    blend_route_ms = (sum(v for k, v in direct_prof.items() if any(n in k for n in blend_kernels))
                      if direct_prof else None)
    log(f"blend_slab at (8,{ps},{ps},{ps}) f32 depth 3, a launch (device ms back to back, in the direct route, "
        "narrow(...).copy_; CUDA-event ms, copy_; host µs, copy_): " + "; ".join(
            f"axis {a} {v['device_ms']:.4f}, {ms4(v['device_ms_in_route'])}, {v['copy_device_ms']:.4f}; {v['ms']:.4f}, "
            f"{v['copy_ms']:.4f}; {v['host_us']:.2f}, {v['copy_host_us']:.2f} (bound {v['bound_ms']:.4f})"
            for a, v in blend_step.items())
        + f"; blend_slab in the direct route: {ms4(blend_route_ms)} device ms an iteration on {card}")
    del bl_blocks, writes
    torch.cuda.empty_cache()

    # --- 14. bench-pack ------------------------------------------------------------------
    phase_start(14)
    BP_ITERS = 20

    def run_bench_pack(*extra):
        """bench_pack.main in-process at 512^3, counters reset just before
        and read just after: (its three lines, counts)."""
        argv = ["--size", str(N), "--iters", str(BP_ITERS), *extra]
        out = io.StringIO()
        ledger.reset_launch_counts()
        sync()
        with contextlib.redirect_stdout(out):
            rc = bp.main(argv)
        sync()
        counts = ledger.launch_counts()
        lines = out.getvalue().strip().splitlines()
        if rc != 0 or len(lines) != 3 or any(int(ln.split()[2]) != N * N * 3 * 4 for ln in lines):
            raise AssertionError(f"bench-pack {argv}: exit {rc}, lines {lines}")
        for line in lines:
            log(f"bench-pack {' '.join(argv)}: {line}")
        return lines, counts

    # a face: one message pack to unpack, a warm-up and BP_ITERS timed calls
    # of each; the round-trip form: a warm-up sample and BP_ITERS samples of 8
    bench_pack_runs = {}
    for label, extra, want in (
            ("pallas", ("--backend", "pallas"),
             {"pallas_pack_slab": 3 * (BP_ITERS + 2), "pallas_unpack_slab": 3 * (BP_ITERS + 1)}),
            ("xla", ("--backend", "xla"), {}),
            ("pallas_inner8", ("--backend", "pallas", "--inner", "8"),
             {"pallas_pack_slab": 3 * (BP_ITERS + 1) * 8, "pallas_unpack_slab": 3 * (BP_ITERS + 1) * 8})):
        lines, counts = run_bench_pack(*extra)
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"bench-pack {label}: launches {counts}, want {want}")
        bench_pack_runs[label] = {"lines": lines, "launches": counts}
    bp_counts = bench_pack_runs["pallas"]["launches"]
    # each face at bench-pack's shapes: kernel vs plain, bitwise; times
    bp_spec = LocalSpec.make(Dim3(N, N, N), Dim3(0, 0, 0), Radius.constant(3))
    bp_block = seeded(tuple(bp_spec.raw_size()), 200, dev)

    def box(t, p, e):
        return t[p.x:p.x + e.x, p.y:p.y + e.y, p.z:p.z + e.z]

    slab_face = {}
    for d in bp.FACES:
        (slot,) = pk.PackPlan.make(bp_spec, [d], [4]).slots
        pos, upos, ext = slot.pos, slot.unpack_pos, slot.extent
        slab = pk.pallas_pack_slab(bp_block, pos, ext)
        hold("pallas_pack_slab", slab, pk.pallas_pack_slab_plain(bp_block, pos, ext), f"{N}^3 r=3 face {d}")
        hold("pallas_unpack_slab", pk.pallas_unpack_slab(bp_block.clone(), slab, upos, ext),
             pk.pallas_unpack_slab_plain(bp_block.clone(), slab, upos, ext), f"{N}^3 r=3 face {d}")
        if not torch.equal(box(bp_block, pos, ext).contiguous(), slab):
            raise AssertionError(f"face {d}: .contiguous() of the box and pallas_pack_slab disagree")
        pack_x, _ = pk.make_pack_fn(bp_spec, [d], [torch.float32])
        pack_p, _ = pk.make_pack_fn_pallas(bp_spec, [d], torch.float32)
        fns = {"pack": (lambda: pk.pallas_pack_slab(bp_block, pos, ext),
                        lambda: pk.pallas_pack_slab_plain(bp_block, pos, ext),
                        lambda: box(bp_block, pos, ext).contiguous()),
               "unpack": (lambda: pk.pallas_unpack_slab(bp_block, slab, upos, ext),
                          lambda: pk.pallas_unpack_slab_plain(bp_block, slab, upos, ext),
                          lambda: box(bp_block, upos, ext).copy_(slab))}
        slab_face[str(d)] = {
            kind: dict(zip(("kernel", "plain", "library"), (cuda_ms(f) for f in fs)),
                       device=device_ms_per_call(fs[0], calls=20), library_device=device_ms_per_call(fs[2], calls=20))
            for kind, fs in fns.items()}
        for kind, fs in fns.items():
            slab_face[str(d)][kind]["host_us"] = {"kernel": host_us_per_call(fs[0]), "library": host_us_per_call(fs[2])}
        slab_face[str(d)]["make_pack_fn"] = cuda_ms(lambda: pack_x([bp_block]))
        slab_face[str(d)]["make_pack_fn_pallas"] = cuda_ms(lambda: pack_p(bp_block))
    slab_bytes = 2 * N * N * 3 * 4  # the box read once and written once
    log(f"slab packs at {ws}^3 f32, radius 3, per face (ms: kernel, plain, library; device ms a launch: kernel, "
        "library; host µs a call: kernel, library): " + "; ".join(
        f"{d} " + ", ".join(f"{k} {v['kernel']:.4f}, {v['plain']:.4f}, {v['library']:.4f}; {v['device']:.4f}, "
                            f"{v['library_device']:.4f}; {v['host_us']['kernel']:.2f}, {v['host_us']['library']:.2f}"
                            for k, v in f.items() if k in ("pack", "unpack"))
        + f"; make_pack_fn {f['make_pack_fn']:.4f}, make_pack_fn_pallas {f['make_pack_fn_pallas']:.4f}"
        for d, f in slab_face.items()) + f" on {card}")
    del bp_block, slab
    torch.cuda.empty_cache()

    # --- 15. the mean6 kernels at full width ---------------------------------------------
    phase_start(15)
    m6_init = np.random.default_rng(210).random((N, N, N)).astype(np.float32)
    m6_shell = Dim3(3, 3, 3)

    def mean6_domain():
        dd = DistributedDomain(N, N, N, device=dev)
        dd.set_radius(3)
        h = dd.add_data("u")
        dd.realize()
        dd.set_quantity(h, m6_init)
        return dd, h

    def m6_interior(dd, h):
        return dd.get_curr(h)[0, 0, 0, 3:-3, 3:-3, 3:-3].clone()

    ref_dd, ref_h = mean6_domain()
    ref_step = ref_dd.make_step(mean6_kernel, engine="stream", x_radius=1, stream_path="plane")
    if ref_step._stream_plan["route"] != "plane":
        raise AssertionError(f"mean6 reference: route {ref_step._stream_plan['route']}, want plane")
    ref_dd.run_step(ref_step, CHECK_AT)
    m6_ref = {CHECK_AT: m6_interior(ref_dd, ref_h)}
    ref_dd.run_step(ref_step, STEPS - CHECK_AT)
    m6_ref[STEPS] = m6_interior(ref_dd, ref_h)
    del ref_dd, ref_step

    def plane_levels(dd, h, levels):
        for _ in range(levels):
            dd.exchange()
            m6.mean6_plane_step(dd.get_curr(h)[0, 0, 0], m6_shell, m6_shell, out=dd.get_next(h)[0, 0, 0])
            dd.swap()

    def wavefront_levels(dd, h, levels):
        while levels:
            m = min(3, levels)
            dd.exchange()
            m6.mean6_shell_wavefront_step(dd.get_curr(h)[0, 0, 0], m, 3, out=dd.get_next(h)[0, 0, 0])
            dd.swap()
            levels -= m

    mean6_runs = {}
    for name, run, want in (("mean6_plane_step", plane_levels, STEPS),
                            ("mean6_shell_wavefront_step", wavefront_levels,
                             sum(-(-k // 3) for k in (CHECK_AT, STEPS - CHECK_AT)))):
        dd, h = mean6_domain()
        ledger.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        run(dd, h, CHECK_AT)
        at_check = m6_interior(dd, h)
        run(dd, h, STEPS - CHECK_AT)
        sync()
        seconds = time.perf_counter() - t0
        counts = ledger.launch_counts()
        final = m6_interior(dd, h)
        # one exchange a launch, whose six halo writes are blend_slab's
        if {k: v for k, v in counts.items() if v} != {name: want, "blend_slab": 6 * want}:
            raise AssertionError(f"{name} run: launches {counts}, want {want} of {name} and {6 * want} blend_slab")
        if not (torch.equal(at_check, m6_ref[CHECK_AT]) and torch.equal(final, m6_ref[STEPS])):
            raise AssertionError(f"{name} run != the stream engine's plane route at level {CHECK_AT} or {STEPS}")
        if not (bool(torch.isfinite(final).all()) and 0.0 <= float(final.min()) and float(final.max()) <= 1.0):
            raise AssertionError(f"{name} run: field not finite or outside [0, 1] after {STEPS} levels")
        mean6_runs[name] = {"launches": counts[name], "ms_per_level": seconds * 1e3 / STEPS}
        log(f"{name} run: {STEPS} levels on one periodic {N}^3 subdomain, shell 3, launches {counts[name]}, "
            f"{seconds * 1e3 / STEPS:.4f} ms a level (exchanges included); bitwise equal to the stream "
            f"engine's plane route at levels {CHECK_AT} and {STEPS}")
        del dd, at_check, final
    del m6_ref
    torch.cuda.empty_cache()
    m6_blk = seeded((ws, ws, ws), 220, dev)
    m6_out = torch.empty_like(m6_blk)
    hold("mean6_plane_step", m6.mean6_plane_step(m6_blk, m6_shell, m6_shell),
         m6.mean6_plane_step_plain(m6_blk, m6_shell, m6_shell), f"{ws}^3 shell 3")
    S3 = slice(3, -3)
    hold("mean6_shell_wavefront_step", m6.mean6_shell_wavefront_step(m6_blk, 3, 3)[S3, S3, S3],
         m6.mean6_shell_wavefront_step_plain(m6_blk, 3, 3)[S3, S3, S3], f"{ws}^3 m=3 s=3")
    m6p_ms = cuda_ms(lambda: m6.mean6_plane_step(m6_blk, m6_shell, m6_shell, out=m6_out))
    m6p_plain_ms = cuda_ms(lambda: m6.mean6_plane_step_plain(m6_blk, m6_shell, m6_shell, out=m6_out), inner=2)
    m6w_ms = cuda_ms(lambda: m6.mean6_shell_wavefront_step(m6_blk, 3, 3, out=m6_out), inner=2)
    m6w_plain_ms = cuda_ms(lambda: m6.mean6_shell_wavefront_step_plain(m6_blk, 3, 3, out=m6_out), reps=3, inner=1)
    m6w_dev_ms = device_ms_per_call(lambda: m6.mean6_shell_wavefront_step(m6_blk, 3, 3, out=m6_out))
    m6w_launch = m6.mean6_wavefront_launch((ws, ws, ws), 3, 3)
    m6p_bytes = 2 * ws ** 3 * 4  # every cell read once and written once
    m6w_bytes = (ws ** 3 + N ** 3) * 4  # every cell read once, the interior written once
    log(f"mean6 kernels at {ws}^3 f32 (ms, CUDA events): mean6_plane_step {m6p_ms:.4f} (plain {m6p_plain_ms:.4f}), "
        f"mean6_shell_wavefront_step m=3 {m6w_ms:.4f} (plain {m6w_plain_ms:.4f}; device {m6w_dev_ms:.4f} a call, "
        f"bound {bound(m6w_bytes, 0)[0]:.4f}); wavefront launch {plan_str(m6w_launch)} on {card}")
    del m6_blk, m6_out
    torch.cuda.empty_cache()

    # --- 16. the fused halo and the split schedule ---------------------------------------
    phase_start(16)
    ast_ref = ast_ref.to(dev)
    f16 = {}
    cases16 = (("per-step fused", "per-step", "yzpack_pallas", "halo", "plane"),
               ("auto fused", "auto", "yzpack_pallas", "halo", "wavefront"),
               ("per-step split", "per-step", "direct", "overlap", "plane"),
               ("auto split", "auto", "direct", "overlap", "wavefront"))
    for key, schedule, route, axis, want_route in cases16:
        fused = axis == "halo"
        kw = {"stream_halo": "fused"} if fused else {"stream_overlap": "split"}
        sim = AstarothSim(N, N, N, num_quantities=AST_Q, kernel_impl="cuda", schedule=schedule,
                          exchange_route=route, **kw)
        sim.dd.set_partition(2, 2, 2)
        sim.realize()
        plan = sim._step._stream_plan
        if plan["route"] != want_route or plan["z_slabs"] or (plan["halo"], plan["overlap"]) != (
                ("fused", "off") if fused else ("array", "split")):
            raise AssertionError(f"astaroth {key}: plan {plan}")
        ledger.reset_launch_counts()
        sync()
        sim.step(AST_ITERS)
        sync()
        counts = ledger.launch_counts()
        # exchanges, and passes of the plan's groups (per field on the wavefront)
        groups = AST_Q if plan["grouping"] == "per-field" else 1
        exchanges = AST_ITERS if want_route == "plane" else -(-AST_ITERS // plan["m"])
        kernel = f"stream_{want_route}_pass"
        if fused:
            # each field's two messages an axis packed; nothing unpacked or blended
            want = {kernel + "_fused": groups * exchanges, kernel: 0, "pack_zshell_pallas": 2 * AST_Q * exchanges,
                    "pack_yshell_pallas": 2 * AST_Q * exchanges, "unpack_zshell_pallas": 0,
                    "unpack_yshell_pallas": 0, "blend_slab": 0, "blend_slab_dynamic": 0}
        else:
            # the interior pass and six band passes a group; each field's six
            # halo writes of the exchange and four y and z band writes
            want = {kernel: 7 * groups * exchanges, kernel + "_fused": 0, "blend_slab": 10 * AST_Q * exchanges}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"astaroth {key}: launches {counts}, want {want}")
        got = interiors(sim)
        if not torch.equal(got, ast_ref):
            raise AssertionError(f"astaroth {key} != phase 8's result after {AST_ITERS} iterations")
        del got
        dts = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            sim.step(AST_ITERS)
            sync()
            dts.append((time.perf_counter() - t0) / AST_ITERS)
        dt = min(dts)
        entry = {"route": want_route, "m": plan["m"], "grouping": plan["grouping"], "exchange_route": route,
                 "halo": plan["halo"], "overlap": plan["overlap"], "launches": counts, "ms_per_iter": dt * 1e3,
                 "ms_per_iter_runs": [t * 1e3 for t in dts], "mupdates_per_s": AST_Q * N ** 3 / dt / 1e6}
        if schedule == "per-step":
            entry["profile"] = device_breakdown(sim, AST_ITERS)
        f16[key] = entry
        log(f"astaroth {AST_Q}q {N}^3 {key} 2x2x2 ({want_route}, m={plan['m']}, {plan['grouping']}, {route}): "
            f"{dt * 1e3:.4f} ms/iter, {AST_Q * N ** 3 / dt / 1e6:.1f} Mupdates/s on {card}; launches per "
            f"{AST_ITERS} iterations {dict((k, v) for k, v in counts.items() if v)}; bitwise equal to phase 8's "
            "result")
        if "profile" in entry:
            log_breakdown(f"astaroth {key}", entry["profile"])
        del sim
        torch.cuda.empty_cache()
    del ast_ref
    torch.cuda.empty_cache()
    # uneven: split at per-block band offsets; fused degrades with its warning
    ast_u_ref = ast_u_ref.to(dev)
    sim = AstarothSim(NU, NU, NU, num_quantities=AST_Q, kernel_impl="cuda", stream_overlap="split")
    sim.dd.set_partition(2, 2, 2)
    sim.realize()
    plan = sim._step._stream_plan
    ledger.reset_launch_counts()
    sync()
    sim.step(AST_ITERS)
    sync()
    counts = ledger.launch_counts()
    if plan["route"] != "wavefront" or plan["z_slabs"] or plan["overlap"] != "split" \
            or counts["stream_wavefront_pass"] == 0 or counts["blend_slab_dynamic"] == 0:
        raise AssertionError(f"astaroth {NU}^3 auto split: plan {plan}, launches {counts}")
    if not torch.equal(ast_interiors(sim, NU), ast_u_ref):
        raise AssertionError(f"astaroth {NU}^3 auto split != the one-subdomain wrap route after {AST_ITERS} "
                             "iterations")
    dts = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        sim.step(AST_ITERS)
        sync()
        dts.append((time.perf_counter() - t0) / AST_ITERS)
    f16[f"{NU} auto split"] = {"route": "wavefront", "m": plan["m"], "launches": counts,
                               "ms_per_iter": min(dts) * 1e3, "ms_per_iter_runs": [t * 1e3 for t in dts],
                               "mupdates_per_s": AST_Q * NU ** 3 / min(dts) / 1e6}
    log(f"astaroth {AST_Q}q {NU}^3 auto split 2x2x2 (wavefront, m={plan['m']}): {min(dts) * 1e3:.4f} ms/iter on "
        f"{card}; launches per {AST_ITERS} iterations {dict((k, v) for k, v in counts.items() if v)}; bitwise "
        "equal to the one-subdomain wrap route")
    del sim, ast_u_ref
    torch.cuda.empty_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = AstarothSim(NU, NU, NU, num_quantities=AST_Q, kernel_impl="cuda", exchange_route="yzpack_pallas",
                          stream_halo="fused")
        sim.dd.set_partition(2, 2, 2)
        sim.realize()
    said = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning) and "halo=fused" in str(w.message)]
    if sim._step._stream_plan["halo"] != "array" or not said:
        raise AssertionError(f"astaroth {NU}^3 fused: plan {sim._step._stream_plan}, warnings {caught}")
    log(f"astaroth {NU}^3 fused request degrades: {said[0]}")
    del sim
    torch.cuda.empty_cache()
    # the fused forms against their plain versions at (8, 262^3), and their times
    f_raws = [seeded((8, ps, ps, ps), 300 + q, dev) for q in range(AST_Q)]
    f_bufs = tuple([seeded((8, 6, ps, ps), 320 + 3 * q + j, dev) for q in range(AST_Q)] for j in range(3))
    fpl_args = (ak8, ast_names, f_raws, shell3, shell3, 1, org, gs)
    hold_fields("stream_plane_pass_fused", st.stream_plane_pass(*fpl_args, fused_shell=f_bufs),
                st.stream_plane_pass_plain(*fpl_args, fused_shell=f_bufs), f"(8,{ps},{ps},{ps}) x {AST_Q} fields")
    fpl_ms = cuda_ms(lambda: st.stream_plane_pass(*fpl_args, fused_shell=f_bufs), inner=2)
    fpl_plain_ms = cuda_ms(lambda: st.stream_plane_pass_plain(*fpl_args, fused_shell=f_bufs), reps=3, inner=1)
    fpl_dev_ms = device_ms_per_call(lambda: st.stream_plane_pass(*fpl_args, fused_shell=f_bufs))
    fpl_array_dev_ms = device_ms_per_call(lambda: st.stream_plane_pass(*fpl_args))
    fpl_bytes = spl_bytes  # each cell read once, from the block or a buffer, and written once
    fpl_flops = ops * AST_Q * 8 * half ** 3
    f1_bufs = tuple([b[0]] for b in f_bufs)
    fwf_args = (ak1, ast_names[:1], f_raws[:1], 3, 3, org, gs_main)
    S3 = slice(3, -3)
    hold("stream_wavefront_pass_fused", st.stream_wavefront_pass(*fwf_args, fused_shell=f1_bufs)[0][0][:, S3, S3, S3],
         st.stream_wavefront_pass_plain(*fwf_args, fused_shell=f1_bufs)[0][0][:, S3, S3, S3],
         f"(8,{ps},{ps},{ps}) m=3, 1 field")
    fwf_ms = cuda_ms(lambda: st.stream_wavefront_pass(*fwf_args, fused_shell=f1_bufs), inner=2)
    fwf_plain_ms = cuda_ms(lambda: st.stream_wavefront_pass_plain(*fwf_args, fused_shell=f1_bufs), reps=3, inner=1)
    fwf_dev_ms = device_ms_per_call(lambda: st.stream_wavefront_pass(*fwf_args, fused_shell=f1_bufs), calls=10)
    fwf_array_dev_ms = device_ms_per_call(lambda: st.stream_wavefront_pass(*fwf_args), calls=10)
    fwf_launch = st.stream_wavefront_launch(ak1, ast_names[:1], f_raws[:1], 3, 3, gs_main, fused=True)
    fwf_bytes = stream_wavefront_bytes(8, ps, ps, ps, 3, 3, False, 1)
    fwf_flops = ops * 8 * half ** 3 * 3
    log(f"fused forms at (8,{ps},{ps},{ps}) f32 (ms: CUDA events, plain, device a call, the array form's device "
        f"a call, bound): stream_plane_pass {AST_Q} fields {fpl_ms:.4f}, {fpl_plain_ms:.4f}, {fpl_dev_ms:.4f}, "
        f"{fpl_array_dev_ms:.4f}, {bound(fpl_bytes, fpl_flops)[0]:.4f}; stream_wavefront_pass m=3 1 field "
        f"{fwf_ms:.4f}, {fwf_plain_ms:.4f}, {fwf_dev_ms:.4f}, {fwf_array_dev_ms:.4f}, "
        f"{bound(fwf_bytes, fwf_flops)[0]:.4f}; wavefront launch {plan_str(fwf_launch)} on {card}")
    del f_raws, f_bufs, f1_bufs
    torch.cuda.empty_cache()
    phase_end()

    # --- 17. the one-dispatch step loop: captured against uncaptured -------------------
    phase_start(17)
    cap17 = {}

    def valid_interiors(dd, handles, size) -> torch.Tensor:
        """Every quantity's valid interior on the card, (q, X, Y, Z) in global order."""
        lo, n = dd.shell_radius().lo(), dd.local_spec().sz
        dim = dd.grid_dim()
        return torch.stack([
            dd.get_curr(h)[..., lo.x:lo.x + n.x, lo.y:lo.y + n.y, lo.z:lo.z + n.z]
            .permute(0, 3, 1, 4, 2, 5).reshape(dim.x * n.x, dim.y * n.y, dim.z * n.z)[:size, :size, :size]
            for h in handles])

    def capture_pair(key, make, steps, size, handles, want_route):
        """``make(capture)`` built twice, uncaptured and captured: two calls of
        ``steps`` each with the counters reset before and read after (equal),
        the valid interiors bitwise; then per model two timed calls (ms/iter,
        host µs of the call), a torch.profiler breakdown of one more, and the
        interiors bitwise again; the captured loop's graphs and capture
        seconds; its graphs freed."""
        models, out = {}, {}
        for captured in (False, True):
            model = make(captured)
            route = getattr(model, "_pallas_path", None) or model._step._stream_plan["route"]
            if route != want_route or model.dd.capture() != captured:
                raise AssertionError(f"{key}: route {route}, capture {model.dd.capture()}")
            ledger.reset_launch_counts()
            sync()
            model.step(steps)
            model.step(steps)
            sync()
            out[captured] = {"launches": ledger.launch_counts()}
            models[captured] = model
        plain, cap = models[False], models[True]
        if out[False]["launches"] != out[True]["launches"]:
            raise AssertionError(f"{key}: captured launches {out[True]['launches']} != uncaptured "
                                 f"{out[False]['launches']}")
        if not cap._step.captured:
            raise AssertionError(f"{key}: the captured run holds no CUDA graph")

        def same(when):
            if not torch.equal(valid_interiors(plain.dd, handles(plain), size),
                               valid_interiors(cap.dd, handles(cap), size)):
                raise AssertionError(f"{key}: captured != uncaptured {when}")

        same(f"after 2 x {steps}")
        for captured, model in models.items():
            dts, host = [], []
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                model.step(steps)
                t1 = time.perf_counter()
                sync()
                dts.append((time.perf_counter() - t0) / steps)
                host.append((t1 - t0) * 1e6)
            out[captured].update(ms_per_iter=min(dts) * 1e3, ms_per_iter_runs=[t * 1e3 for t in dts],
                                 mcells_per_s=size ** 3 * len(handles(model)) / min(dts) / 1e6,
                                 host_us_per_call=min(host), host_us_runs=host,
                                 profile=device_breakdown(model, steps))
        same("at the end")
        loop = cap._step._loop
        out[True].update(graphs=len(loop.graphs), max_graphs=loop.max_graphs, captures=loop.captures,
                         capture_s=loop.capture_seconds, replays=loop.replays)
        loop.release()
        cap17[key] = out
        u, c = out[False], out[True]
        pu, pc = u["profile"], c["profile"]
        log(f"captured {key}, {steps} a call (uncaptured -> captured): {u['ms_per_iter']:.4f} -> "
            f"{c['ms_per_iter']:.4f} ms/iter ({u['mcells_per_s']:.1f} -> {c['mcells_per_s']:.1f} Mcells/s); "
            f"idle share {ms4(pu['idle_share'])} -> {ms4(pc['idle_share'])}, device ms/iter "
            f"{ms4(pu['device_ms_per_step'])} -> {ms4(pc['device_ms_per_step'])}; host µs a call "
            f"{u['host_us_per_call']:.1f} -> {c['host_us_per_call']:.1f}; {c['graphs']} graphs "
            f"(at most {c['max_graphs']}), captured in {c['capture_s']:.3f} s, {c['replays']} replays; "
            f"launches equal {dict((k, v) for k, v in c['launches'].items() if v)}; bitwise equal on {card}")
        del models, plain, cap, model
        torch.cuda.empty_cache()

    def jacobi17(size, part=None, **kw):
        def make(captured):
            model = Jacobi3D(size, size, size, kernel_impl="cuda", capture=captured, **kw)
            if part is not None:
                model.dd.set_partition(*part)
            model.realize()
            return model
        return make

    def astaroth17(part=None, **kw):
        def make(captured):
            sim = AstarothSim(N, N, N, num_quantities=AST_Q, kernel_impl="cuda", capture=captured, **kw)
            if part is not None:
                sim.dd.set_partition(*part)
            sim.realize()
            return sim
        return make

    jac_handles = lambda m: [m.h]  # noqa: E731
    ast_handles = lambda m: m.handles  # noqa: E731
    for key, make, size, route in (
            (f"jacobi wrap {N}^3 1x1x1", jacobi17(N), N, "wrap"),
            (f"jacobi wavefront z-ring {N}^3 2x2x2", jacobi17(N, (2, 2, 2)), N, "wavefront"),
            (f"jacobi auto {NU}^3 2x2x2", jacobi17(NU, (2, 2, 2)), NU, "wavefront"),
            (f"jacobi shell {NU}^3 2x2x2", jacobi17(NU, (2, 2, 2), pallas_path="shell"), NU, "shell")):
        capture_pair(key, make, STEPS, size, jac_handles, route)
    for key, make, route in (
            ("astaroth wavefront 1x1x1", astaroth17(schedule="wavefront"), "wavefront"),
            ("astaroth auto 2x2x2 direct", astaroth17((2, 2, 2)), "wavefront"),
            ("astaroth per-step 2x2x2 direct", astaroth17((2, 2, 2), schedule="per-step"), "plane"),
            ("astaroth auto 2x2x2 yzpack_pallas", astaroth17((2, 2, 2), exchange_route="yzpack_pallas"),
             "wavefront"),
            ("astaroth per-step 2x2x2 yzpack_pallas",
             astaroth17((2, 2, 2), schedule="per-step", exchange_route="yzpack_pallas"), "plane"),
            ("astaroth per-step 2x2x2 yzpack_pallas fused",
             astaroth17((2, 2, 2), schedule="per-step", exchange_route="yzpack_pallas", stream_halo="fused"),
             "plane"),
            ("astaroth auto 2x2x2 yzpack_pallas fused",
             astaroth17((2, 2, 2), exchange_route="yzpack_pallas", stream_halo="fused"), "wavefront"),
            ("astaroth per-step 2x2x2 direct split",
             astaroth17((2, 2, 2), schedule="per-step", stream_overlap="split"), "plane"),
            ("astaroth auto 2x2x2 direct split", astaroth17((2, 2, 2), stream_overlap="split"), "wavefront")):
        capture_pair(key, make, AST_ITERS, N, ast_handles, route)

    # exchange_many(24) against 24 exchange() calls on the 8-field 2x2x2 domain
    class Exchanges:
        """``step(n)``: n exchanges of ``dd``, one call each or ``exchange_many``."""

        def __init__(self, dd, many):
            self.dd, self.many = dd, many

        def step(self, n):
            if self.many:
                self.dd.exchange_many(n)
            else:
                for _ in range(n):
                    self.dd.exchange()

    ex17 = {}
    sims = {}
    for many in (False, True):
        sim = AstarothSim(N, N, N, num_quantities=AST_Q)
        sim.dd.set_partition(2, 2, 2)
        sim.realize()
        ledger.reset_launch_counts()
        sync()
        Exchanges(sim.dd, many).step(AST_ITERS)
        sync()
        ex17[many] = {"launches": ledger.launch_counts()}
        sims[many] = sim
    if ex17[False]["launches"] != ex17[True]["launches"]:
        raise AssertionError(f"exchange_many launches {ex17[True]['launches']} != exchange() "
                             f"{ex17[False]['launches']}")
    for h, g in zip(sims[False].handles, sims[True].handles):
        if not torch.equal(sims[False].dd.get_curr(h), sims[True].dd.get_curr(g)):
            raise AssertionError(f"exchange_many({AST_ITERS}) != {AST_ITERS} exchange() calls")
    for many, sim in sims.items():
        ex = Exchanges(sim.dd, many)
        dts, host = [], []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            ex.step(AST_ITERS)
            t1 = time.perf_counter()
            sync()
            dts.append((time.perf_counter() - t0) / AST_ITERS)
            host.append((t1 - t0) * 1e6)
        ex17[many].update(ms_per_exchange=min(dts) * 1e3, ms_runs=[t * 1e3 for t in dts],
                          host_us_per_call=min(host), profile=device_breakdown(ex, AST_ITERS))
    loop = sims[True].dd._exchange_loop
    ex17[True].update(graphs=len(loop.graphs), captures=loop.captures, capture_s=loop.capture_seconds,
                      replays=loop.replays)
    loop.release()
    u, c = ex17[False], ex17[True]
    log(f"exchange_many({AST_ITERS}) against {AST_ITERS} exchange() calls, {AST_Q} fields {N}^3 2x2x2 direct: "
        f"{u['ms_per_exchange']:.4f} -> {c['ms_per_exchange']:.4f} ms an exchange; idle share "
        f"{ms4(u['profile']['idle_share'])} -> {ms4(c['profile']['idle_share'])}, device ms an exchange "
        f"{ms4(u['profile']['device_ms_per_step'])} -> {ms4(c['profile']['device_ms_per_step'])}; host µs a "
        f"call {u['host_us_per_call']:.1f} -> {c['host_us_per_call']:.1f}; captured in {c['capture_s']:.3f} s; "
        f"launches equal, stacks bitwise equal on {card}")
    cap17["exchange_many"] = ex17
    del sims, sim, ex, loop
    torch.cuda.empty_cache()
    log(f"phase 17 done: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after its graphs were freed")
    phase_end()

    # --- 18. component (N-D) quantities and the debug oracles ------------------------------
    phase_start(18)
    nd18 = phase18(card, dev, NU)
    phase_end()

    # --- 19. the Jacobi kernel axes: bf16 storage, the tensor-core contraction --------------
    phase_start(19)
    ax19 = phase19(card, dev)
    errs.update(ax19["errs"])
    phase_end()

    # --- 20. the stream kernels' field dtypes: bf16 storage, float64 ------------------------
    phase_start(20)
    dt20 = phase20(card, dev, {N: ast_ref_host, NU: ast_u_ref_host},
                   {"ast": ast, "routes_13": routes_13, "f16": f16, "ast_u": ast_u})
    errs.update(dt20["errs"])
    del ast_u_ref_host
    phase_end()

    # --- 21. float64 on the Jacobi kernels; bf16 storage and float64 on the mean-of-6 kernels
    phase_start(21)
    f21 = phase21(card, dev, ax19["routes"])
    errs.update(f21["errs"])
    phase_end()

    # --- 22. the tensor-core contraction form of rows 6-8, 17 and 18 ----------------------
    phase_start(22)
    mx22 = phase22(card, dev, ast_ref_host)
    errs.update(mx22["errs"])
    phase_end()

    # --- 23. the contraction under the fused halo and the split schedule ---------------------
    phase_start(23)
    mx23 = phase23(card, dev, ast_ref_host, f16, mx22)
    errs.update(mx23["errs"])
    del ast_ref_host
    phase_end()

    rows = []
    # launches of a Jacobi run of STEPS steps with one launch a macro of m levels
    macros = {m: sum(-(-k // m) for k in (CHECK_AT, STEPS - CHECK_AT)) for m in (mw, mu)}
    m_ast = ast["wavefront 1x1x1"]["m"]
    # (name, launch counts, steps of their run, launches expected in it, ...)
    specs = [
        ("jacobi_wrap_step", wrap_counts, STEPS, sum(-(-k // wrap_k) for k in (CHECK_AT, STEPS - CHECK_AT)),
         wrap_ms, wrap_plain_ms, None, wrap_bytes, 7 * cells * wrap_k,
         f"({N},{N},{N}) f32, k={wrap_k} (the wrap route's call, {jacobi_wrap[wrap_k]['launch']['launches']} "
         "marches; k = 1 in jacobi_wrap)"),
        ("jacobi_plane_step", shell_counts, STEPS, STEPS, plane_ms, plane_plain_ms, None, plane_bytes,
         7 * 8 * half ** 3, f"(8,{half + 2},{half + 2},{half + 2}) f32"),
        ("blend_slab", shell_counts, STEPS, 6 * STEPS, blend_ms, blend_plain_ms, blend_lib_ms, blend_bytes, 0,
         f"6 writes of one exchange, slabs (8,1,{half + 2},{half + 2}) per axis"),
        ("jacobi_zring_wavefront_step", wave_counts, STEPS, macros[mw], zring_ms, zring_plain_ms, None,
         zring_bytes, wave_flops,
         f"(8,{rw},{rw},{half}) f32 m={mw}, z slabs (8,{rw},{2 * mw},{rw}), d2 (8,{rw},{half + 128})"),
        ("jacobi_shell_wavefront_step", slab_counts, STEPS, macros[mw], shwf_ms, shwf_plain_ms, None,
         shwf_bytes, wave_flops, f"(8,{rw},{rw},{rw}) f32 m={mw}, z slabs (8,{rw},{2 * mw},{rw}), z_valid={rw}"),
        ("stream_wrap_pass", ast["auto 1x1x1"]["launches"], AST_ITERS, AST_ITERS, swr_ms, swr_plain_ms, None,
         swr_bytes, ops * AST_Q * N ** 3, f"{AST_Q} fields x ({N},{N},{N}) f32, k=1, Astaroth kernel"),
        ("stream_plane_pass", ast["per-step 2x2x2"]["launches"], AST_ITERS, AST_ITERS, spl_ms, spl_plain_ms,
         None, spl_bytes, ops * AST_Q * 8 * half ** 3,
         f"{AST_Q} fields x (8,{ps},{ps},{ps}) f32, shell 3, r=1, Astaroth kernel"),
        ("stream_wavefront_pass", ast["wavefront 1x1x1"]["launches"], AST_ITERS, AST_Q * -(-AST_ITERS // m_ast),
         swf_ms, swf_plain_ms, None, swf_bytes, swf_flops,
         f"1 field x (1,{ws},{ws},{ws}) f32 m=3 s=3, z slabs (1,{ws},6,{ws}), Astaroth kernel"),
        ("jacobi_slab_step", slabr_counts, STEPS, STEPS, slabk_ms, slabk_plain_ms, None, slabk_bytes,
         slabk_flops, f"(8,{half},{half},{half}) f32, six face slabs (8,{half},{half}), one level"),
        ("blend_slab_dynamic", uneven["wavefront"]["launches"], STEPS, 3 * macros[mu], dyn_ms[0],
         dyn_plain_ms[0], dyn_lib_ms[0], dyn_bytes, 0,
         f"the +x halo write of the uneven {NU}^3 wavefront: slab (8,{mu},{ru},{ru}) into "
         f"(8,{ru},{ru},{ru}) f32 at per-block offsets"),
    ] + [
        (name, pack_counts, AST_ITERS, 16 * AST_ITERS, ms, plain_ms, lib_ms, pack_bytes, 0,
         f"(8,{ps},{ps},{ps}) f32, depth 3, buffer (8,3,{ps},{ps})")
        for name, (ms, plain_ms, lib_ms) in pack_ms.items()
    ] + [
        (f"pallas_{kind}_slab", bp_counts, BP_ITERS, 3 * (BP_ITERS + 2 if kind == "pack" else BP_ITERS + 1),
         slab_face[str(bp.FACES[2])][kind]["kernel"], slab_face[str(bp.FACES[2])][kind]["plain"],
         slab_face[str(bp.FACES[2])][kind]["library"], slab_bytes, 0,
         f"bench-pack --size {N} --backend pallas: ({ws},{ws},{ws}) f32, the z face's slab ({N},{N},3) "
         "(every face in chip_smoke.json)")
        for kind in ("pack", "unpack")
    ] + [
        ("mean6_plane_step", {k: v["launches"] for k, v in mean6_runs.items()}, STEPS, STEPS, m6p_ms, m6p_plain_ms,
         None, m6p_bytes, 6 * N ** 3, f"({ws},{ws},{ws}) f32, lo = hi = 3"),
        ("mean6_shell_wavefront_step", {k: v["launches"] for k, v in mean6_runs.items()}, STEPS,
         sum(-(-k // 3) for k in (CHECK_AT, STEPS - CHECK_AT)), m6w_ms, m6w_plain_ms, None, m6w_bytes,
         6 * N ** 3 * 3, f"({ws},{ws},{ws}) f32, m = 3, s = 3"),
        ("stream_plane_pass_fused", f16["per-step fused"]["launches"], AST_ITERS, AST_ITERS, fpl_ms, fpl_plain_ms,
         None, fpl_bytes, fpl_flops, f"{AST_Q} fields x (8,{ps},{ps},{ps}) f32, shell 3, buffers (8,6,{ps},{ps}) "
         "x 3 a field, Astaroth kernel"),
        ("stream_wavefront_pass_fused", f16["auto fused"]["launches"], AST_ITERS,
         AST_Q * -(-AST_ITERS // f16["auto fused"]["m"]), fwf_ms, fwf_plain_ms, None, fwf_bytes, fwf_flops,
         f"1 field x (8,{ps},{ps},{ps}) f32 m=3 s=3, buffers (8,6,{ps},{ps}) x 3, Astaroth kernel"),
    ] + [
        # phase 19's forms: the bound is the phase's (bytes at the storage
        # itemsize, f32 or tensor-core operations), given after the shape
        (name, f["counts"], STEPS, f["want"], f["ms"], f["plain_ms"], None, 0, 0, f["shape"], f["bound"])
        for name, f in ax19["forms"].items()
    ] + [
        # phase 20's forms: launches over 24 Astaroth iterations of the
        # route that runs them; the bound is bench_kernels.stream_dtype_times'
        # (bytes at the storage itemsize, or f32 / f64 operations)
        (name, f["counts"], AST_ITERS, f["want"], f["ms"], f["plain_ms"], None, 0, 0, f["shape"], f["bound"])
        for name, f in dt20["forms"].items()
    ] + [
        # phase 21's forms: launches over the f64 Jacobi route's 200 steps, or
        # the mean-of-6 run's 24 levels; the bound is the phase's (bytes at the
        # storage itemsize, or f32 / f64 operations)
        (name, f["counts"], AST_ITERS if name.startswith("mean6") else STEPS, f["want"], f["ms"], f["plain_ms"], None,
         0, 0, f["shape"], f["bound"])
        for name, f in f21["forms"].items()
    ] + [
        # phase 22's forms: launches over 24 Astaroth iterations of the
        # route that runs them, or the mean-of-6 run's 24 levels; the bound
        # is jacobi_bound's (bytes, f32 or tensor-core operations)
        (name, f["counts"], AST_ITERS, f["want"], f["ms"], f["plain_ms"], None, 0, 0, f["shape"], f["bound"])
        for name, f in mx22["forms"].items()
    ] + [
        # phase 23's forms: launches over 24 Astaroth iterations of the fused
        # route that runs them; the bound is jacobi_bound's at the fused
        # rows' bytes
        (name, f["counts"], AST_ITERS, f["want"], f["ms"], f["plain_ms"], None, 0, 0, f["shape"], f["bound"])
        for name, f in mx23["forms"].items()
    ]
    entries = {ledger.wrapper_name(e): e for e in ledger.ported().values()}
    entries.update({name: ledger.form_entry(name) for name in ledger.FORMS})
    for name, counts, steps, want, ms, plain_ms, lib_ms, nbytes, flops, shape, *given in specs:
        if counts.get(name, 0) != want:
            raise AssertionError(f"{name}: {counts.get(name, 0)} launches in its {steps}-step run, want {want}")
        b_ms, b_by = given[0] if given else bound(nbytes, flops)
        e = entries[name]
        rows.append({
            "name": name, "route": e["route"], "source": e["source"], "replaces": e["replaces"],
            "launches": counts[name], "launches_per_step": counts[name] / steps,
            "max_abs_err": errs[name], "bitwise": errs[name] == 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "copy_bound_ms": nbytes / copy_bw * 1e3, "library_ms": lib_ms, "shape": shape,
        })
        if name in pack_dev_ms:
            rows[-1].update(device_ms=pack_dev_ms[name], device_ms_back_to_back=pack_hot_ms[name],
                            library_device_ms=pack_lib_dev_ms[name])
        if name in z_floor_ms:
            rows[-1].update(sector_floor_ms=z_floor_ms[name], sector_bytes=z_sectors[name])
        if name.endswith("_slab") and name.startswith("pallas_"):
            face = slab_face[str(bp.FACES[2])][name.split("_")[1]]
            rows[-1].update(device_ms=face["device"], library_device_ms=face["library_device"], host_us=face["host_us"])
        if name == "pack_yshell_pallas":
            rows[-1]["host_us"] = ypack_host_us
        if name == "unpack_yshell_pallas":
            rows[-1]["host_us"] = yunpack_host_us
        if name == "blend_slab":
            rows[-1].update(per_step_shape=blend_step, direct_route_device_ms_per_iter=blend_route_ms)
        if name == "stream_wavefront_pass":
            rows[-1]["launch"] = swf_launch
        if name == "jacobi_wrap_step":
            w = jacobi_wrap[wrap_k]
            rows[-1].update(device_ms=w["device_ms"], launch=w["launch"], k1=jacobi_wrap[1])
        if name == "jacobi_plane_step":
            rows[-1].update(device_ms=plane_dev_ms, launch=plane_launch)
        if name == "jacobi_slab_step":
            rows[-1].update(device_ms=slabk_dev_ms, launch=slab_launch)
        if name == "jacobi_zring_wavefront_step":
            rows[-1].update(device_ms=jacobi_wf["z-ring"]["device_ms"], launch=jacobi_wf["z-ring"]["launch"])
        if name == "jacobi_shell_wavefront_step":
            rows[-1].update(device_ms=jacobi_wf["shell z-slab"]["device_ms"],
                            launch=jacobi_wf["shell z-slab"]["launch"])
        if name == "mean6_shell_wavefront_step":
            rows[-1].update(device_ms=m6w_dev_ms, launch=m6w_launch)
        if name == "stream_plane_pass_fused":
            rows[-1].update(device_ms=fpl_dev_ms, array_form_device_ms=fpl_array_dev_ms)
        if name == "stream_wavefront_pass_fused":
            rows[-1].update(device_ms=fwf_dev_ms, array_form_device_ms=fwf_array_dev_ms, launch=fwf_launch)
        if name == "blend_slab_dynamic":
            rows[-1].update(device_ms=dyn_dev_ms[0], ms_per_axis=dyn_ms, device_ms_per_axis=dyn_dev_ms,
                            plain_ms_per_axis=dyn_plain_ms, library_ms_per_axis=dyn_lib_ms, descriptor=dyn_desc)
        if name in dt20["forms"]:
            f = dt20["forms"][name]
            rows[-1].update(device_ms=f["device_ms"], f32_ms=f["f32_ms"], f32_device_ms=f["f32_device_ms"],
                            launch=f["launch"], ptxas=f["ptxas"], copy_bound_ms=None)
        if name in f21["forms"]:
            f = f21["forms"][name]
            rows[-1].update(device_ms=f["device_ms"], f32_ms=f["f32_ms"], f32_device_ms=f["f32_device_ms"],
                            launch=f["launch"], copy_bound_ms=None)
        if name in mx23["forms"]:
            f = mx23["forms"][name]
            rows[-1].update(device_ms=f["device_ms"], vpu_fused_ms=f["vpu_fused_ms"],
                            vpu_fused_device_ms=f["vpu_fused_device_ms"], mxu_array_ms=f["mxu_array_ms"],
                            mxu_array_device_ms=f["mxu_array_device_ms"], bound_of=f["bound_of"],
                            tensor_core_flops=f["tensor_core_flops"], launch=f["launch"], copy_bound_ms=None)
        if name in mx22["forms"]:
            f = mx22["forms"][name]
            rows[-1].update(device_ms=f["device_ms"], vpu_ms=f["vpu_ms"], vpu_device_ms=f["vpu_device_ms"],
                            bound_of=f["bound_of"], tensor_core_flops=f["tensor_core_flops"], launch=f["launch"],
                            copy_bound_ms=None)
        if name in ax19["forms"]:
            f = ax19["forms"][name]
            rows[-1].update(device_ms=f["device_ms"], max_ulps=ax19["max_ulps"][name], bound_of=f["bound_of"],
                            tensor_core_flops=f["tensor_core_flops"], launch=f["launch"],
                            copy_bound_ms=None)
    missing = set(entries) - {r["name"] for r in rows}
    if missing:
        raise AssertionError(f"ported kernels without a row: {missing}")

    from stencil_tpu_torch.utils.artifact import atomic_write_json

    atomic_write_json(os.path.join(OUT_DIR, "chip_smoke.json"), {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "kernels": rows, "copy_ms": copy_ms, "copy_gb_per_s": copy_bw / 1e9,
        "blend_per_axis_ms": per_axis, "shell_exchange_ms": exchange_ms,
        "blend_per_step_shape": blend_step, "blend_direct_route_device_ms_per_iter": blend_route_ms,
        "stream_wavefront_launch": swf_launch, "jacobi_wavefront": jacobi_wf, "jacobi_wrap": jacobi_wrap, "profiler_misses": PROFILER_MISSES,
        "step1_ms_min_median": step1, "astaroth": ast,
        "slab_route": {"mcells_per_s": slabr_mcells, "launches": slabr_counts, "profile": slabr_profile},
        "uneven_jacobi": uneven, "uneven_astaroth": ast_u, "packed_routes": routes_13,
        "shell_pack_ms": {k: dict(zip(("kernel", "plain", "library"), v), device_in_route=pack_dev_ms[k],
                                  device_back_to_back=pack_hot_ms[k], library_device=pack_lib_dev_ms[k])
                          for k, v in pack_ms.items()},
        "pack_yshell_copy_": {"ms": ycopy_ms, "device_ms": ycopy_dev_ms, "host_us": ypack_host_us},
        "unpack_yshell_host_us": yunpack_host_us,
        "blend_slab_dynamic_ms": {"kernel": dyn_ms, "device": dyn_dev_ms, "plain": dyn_plain_ms,
                                  "scatter_": dyn_lib_ms, "descriptor": dyn_desc},
        "routes": {"wrap_mcells_per_s": wrap_mcells, "shell_mcells_per_s": shell_mcells,
                   "wavefront_zring_mcells_per_s": wave_mcells,
                   "wavefront_zslab_mcells_per_s": slab_mcells, "wavefront_m": mw,
                   "torch_engine_mcells_per_s": torch_mcells,
                   "wrap_launches": wrap_counts, "shell_launches": shell_counts,
                   "wavefront_zring_launches": wave_counts, "wavefront_zslab_launches": slab_counts},
        "profile": {"wrap": wrap_profile, "shell": shell_profile,
                    "wavefront_zring": wave_profile, "wavefront_zslab": slab_profile},
        "build": {k: v["seconds"] for k, v in build.BUILD_LOG.items()},
        "bench_pack": bench_pack_runs, "slab_faces_ms": slab_face, "mean6_runs": mean6_runs,
        "mean6_ms": {"plane": m6p_ms, "plane_plain": m6p_plain_ms, "wavefront_m3": m6w_ms,
                     "wavefront_m3_device": m6w_dev_ms, "wavefront_m3_plain": m6w_plain_ms,
                     "wavefront_m3_launch": m6w_launch},
        "fused_split": f16, "captured": cap17, "components_and_oracles": nd18,
        "kernel_axes": {k: v for k, v in ax19.items() if k != "errs"},
        "stream_dtypes": {k: v for k, v in dt20.items() if k != "errs"},
        "jacobi_f64_mean6_dtypes": {k: v for k, v in f21.items() if k != "errs"},
        "contraction_forms": {k: v for k, v in mx22.items() if k != "errs"},
        "fused_split_contraction": {k: v for k, v in mx23.items() if k != "errs"},
        "fused_ms": {"plane": {"kernel": fpl_ms, "plain": fpl_plain_ms, "device": fpl_dev_ms,
                               "array_device": fpl_array_dev_ms},
                     "wavefront": {"kernel": fwf_ms, "plain": fwf_plain_ms, "device": fwf_dev_ms,
                                   "array_device": fwf_array_dev_ms, "launch": fwf_launch}},
        "phase_start_s": phase_s, "total_s": time.perf_counter() - t_start,
        "phase_peak_gb": phase_peak_gb, "peak_device_gb": max(phase_peak_gb.values()),
    }, indent=1, sort_keys=False)

    top = max(phase_peak_gb, key=phase_peak_gb.get)
    log(f"peak device memory allocated: {phase_peak_gb[top]:.2f} GB (phase {top}); per phase "
        + ", ".join(f"{p} {g:.2f}" for p, g in phase_peak_gb.items())
        + f" GB; {time.perf_counter() - t_start:.1f} s in all")
    log(card)  # the nvidia-smi line as it prints it: name, power limit
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
