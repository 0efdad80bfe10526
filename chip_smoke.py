#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (stencil_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises, prints its traceback and exits
non-zero before the result line:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles every CUDA source of the port with nvcc, all at once;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on seeded inputs at a ragged size and at the main path's shapes;
   the expected result is bitwise equality;
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
   the wavefront and shell routes;
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
12. times of jacobi_slab_step at the slab route's shapes and of
    blend_slab_dynamic at the uneven wavefront's +x, +y and +z halo writes,
    beside their bounds, plain versions and, for blend_slab_dynamic, the
    library call that makes the same write (``Tensor.scatter_`` with
    per-block indices);
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
    included) and its device ms (torch.profiler, 7 calls) and, on
    ``yzpack_pallas``, a torch.profiler breakdown and the launches of 200
    iterations; then the times of the four shell-pack kernels at that
    path's shapes (8 blocks of 262^3 f32, depth 3), their plain versions
    and the library call that makes the same copy (``Tensor.copy_`` between
    the buffer and the permuted window of the block), and each kernel's
    device ms a launch: in the ``yzpack_pallas`` profile (the window cold
    in L2, the ``device_ms`` of the kernels line) and back to back on one
    block (the window hot in the 50 MB L2).

Phase 2 builds the stream kernels (templates plus the traced Astaroth
kernel's emitted body, and the bodies the phase-3 checks use) in the same
parallel nvcc batch as the other sources; phase 3 also holds every stream
kernel against its plain version, on ragged shapes (a 27-point and a
coordinate-forced kernel, two joint fields) and at the main path's shapes.

Then it prints the card line, one ``{"kernels": [...]}`` JSON line and, as the
last line, ``{"ok": true, "device": {...}}``.  The full record also goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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


def device_breakdown(model, steps: int = 20) -> dict:
    """``steps`` steps of a built model under torch.profiler: wall ms per step
    (profiler on), device ms per step by CUDA kernel, and the device's idle
    share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    busy = sum(kernels.values())
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
            "idle_share": 1 - busy / wall_ms, "kernels_ms_per_step": kernels}


def device_ms_per_call(fn, calls: int = 7) -> float:
    """Device ms per call of ``fn`` under torch.profiler: the CUDA kernels'
    self time over ``calls`` calls, divided by ``calls`` (the host's issue
    time, which CUDA events between calls would count, left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def log_breakdown(route: str, b: dict) -> None:
    top = sorted(b["kernels_ms_per_step"].items(), key=lambda kv: -kv[1])
    log(f"profile {route}: wall {b['wall_ms_per_step']:.4f} ms/step (profiler on), device busy "
        f"{b['device_ms_per_step']:.4f} ms/step, idle share {b['idle_share']:.3f}; "
        + "; ".join(f"{k} {v:.4f}" for k, v in top))


def main() -> int:
    t_start = time.perf_counter()
    phase_s = {}

    def phase_start(phase: int) -> None:
        """Log and keep the seconds since the start at which ``phase`` begins."""
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

    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.kernels import build, ledger
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.models.jacobi import COLD_TEMP, HOT_TEMP, Jacobi3D
    from stencil_tpu_torch.ops import halo_blend as hb
    from stencil_tpu_torch.ops import jacobi_kernels as jk
    from stencil_tpu_torch.ops import pack as pk
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
        ("k27", k27_kernel, ["u"]), ("forced", forced_kernel, ["u"]), ("mean6x2", ast_kernel, ["a", "b"]))}
    stream_sources = [("stream_wrap", st._source(ak8, "stream_wrap", st._WRAP_LEVELS)),
                      ("stream_plane", st._source(ak8, "stream_plane", [1]))]
    stream_sources += [("stream_wavefront", st._source(ak1, *st._wavefront_variant(m))) for m in (1, 2, 3)]
    # phase 8's small check runs Astaroth with 2 joint fields (the same body
    # as "mean6x2": field names do not reach the emitted code)
    ak2 = StreamKernel(ast_kernel, ast_names[:2], 1, (32, 32, 32))
    stream_sources += [("stream_wavefront", st._source(ak2, *st._wavefront_variant(m))) for m in (1, 3)]
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
            "unpack_zshell_pallas": 0.0, "pack_yshell_pallas": 0.0, "unpack_yshell_pallas": 0.0}

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

    ragged = seeded((66, 70, 130), 1, dev)
    for k in (1, 2, 3):
        hold("jacobi_wrap_step", jk.jacobi_wrap_step(ragged, k), jk.jacobi_wrap_step_plain(ragged, k),
             f"66x70x130 k={k}")
    full = seeded((N, N, N), 2, dev)
    hold("jacobi_wrap_step", jk.jacobi_wrap_step(full, 1), jk.jacobi_wrap_step_plain(full, 1), f"{N}^3 k=1")
    del full

    gs_r = (130, 140, 260)
    blocks_r = seeded((2, 66, 70, 130), 3, dev)
    org_r = torch.tensor([[64, 0, 128], [0, 68, 0]], dtype=torch.int32, device=dev)
    d2_r = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (68, 128), gs_r, dev) for o in org_r])
    hold("jacobi_plane_step", jk.jacobi_plane_step(blocks_r, org_r, d2_r, gs_r),
         jk.jacobi_plane_step_plain(blocks_r, org_r, d2_r, gs_r), "2x66x70x130")
    half = N // 2
    gs = (N, N, N)
    blocks = seeded((8, half + 2, half + 2, half + 2), 4, dev)
    org = torch.tensor([[x, y, z] for x in (0, half) for y in (0, half) for z in (0, half)],
                       dtype=torch.int32, device=dev)
    d2 = torch.stack([jk.yz_dist2_plane(int(o[1]), int(o[2]), (half, half), gs, dev) for o in org])
    hold("jacobi_plane_step", jk.jacobi_plane_step(blocks, org, d2, gs),
         jk.jacobi_plane_step_plain(blocks, org, d2, gs), f"8x{half + 2}^3")

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
            for r, pos in ((1, [ext - 1, ext - 1, ext - 2]), (2, [0, 5, ext + 3]), (3, [ext - 4] * 2 + [ext - 3])):
                shape = list(small.shape)
                shape[1 + axis] = r
                slab = (seeded(shape, 16 + r, dev) * 100).to(dtype)
                p = torch.tensor(pos, dtype=torch.int32, device=dev)
                base = small.to(dtype)
                hold("blend_slab_dynamic", hb.blend_slab_dynamic(base.clone(), slab, axis, p),
                     hb.blend_slab_dynamic_plain(base.clone(), slab, axis, p), f"{dtype} axis {axis} pos {pos}")
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
        o = torch.tensor([[(b * X + 2) % gs_s[0], (5 * b) % gs_s[1], (7 * b) % gs_s[2]] for b in range(n)],
                         dtype=torch.int32, device=dev)
        dd2 = torch.stack([jk.yz_dist2_plane(int(v[1]), int(v[2]), (Y, Z), gs_s, dev) for v in o])
        return blk, faces, o, dd2

    for n_s, X_s, Y_s, Z_s in ((1, 2, 3, 5), (3, 7, 33, 70)):
        gs_s = (n_s * X_s + 3, 2 * Y_s + 1, 3 * Z_s)
        for own in (False, True):
            blk, faces, o, dd2 = slab_args(n_s, X_s, Y_s, Z_s, gs_s, 24, own)
            hold("jacobi_slab_step", jk.jacobi_slab_step(blk, *faces, o, dd2, gs_s),
                 jk.jacobi_slab_step_plain(blk, *faces, o, dd2, gs_s), f"{n_s}x({X_s},{Y_s},{Z_s}) own={own}")
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
    torch.cuda.empty_cache()
    ws = N + 6
    main_wf = ([seeded((1, ws, ws, ws), 100, dev)], seeded((1, ws, 6, ws), 101, dev))
    hold_stream_wavefront(ak1, main_wf[0], 3, 3, org0.view(1, 3), gs_main, [main_wf[1]], ws,
                          f"1x{ws}^3 m=3 slabs")
    main_wf8 = ([main_plane[0]], seeded((8, ps, 6, ps), 102, dev))
    hold_stream_wavefront(ak1, main_wf8[0], 3, 3, org, gs, [main_wf8[1]], ps, f"8x{ps}^3 m=3 slabs")
    torch.cuda.empty_cache()
    log(f"kernel vs plain: bitwise equal on every case; max abs err {errs}")

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

    block = seeded((N, N, N), 20, dev)
    wrap_bytes = 2 * cells * 4
    wrap_ms = cuda_ms(lambda: jk.jacobi_wrap_step(block, 1))
    wrap_plain_ms = cuda_ms(lambda: jk.jacobi_wrap_step_plain(block, 1), inner=2)
    del block, src

    blocks = stack.view(-1, *stack.shape[3:])
    out = torch.empty_like(blocks)
    plane_bytes = 2 * blocks.numel() * 4 + d2.numel() * 4 + org.numel() * 4
    plane_ms = cuda_ms(lambda: jk.jacobi_plane_step(blocks, org, d2, gs, out=out))
    plane_plain_ms = cuda_ms(lambda: jk.jacobi_plane_step_plain(blocks, org, d2, gs, out=out), inner=2)

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

    ring_raw, ring_org, ring_d2, ring_zs = main_ring
    zring_ms = cuda_ms(lambda: jk.jacobi_zring_wavefront_step(ring_raw, mw, ring_org, ring_d2, gs, ring_zs), inner=2)
    zring_plain_ms = cuda_ms(
        lambda: jk.jacobi_zring_wavefront_step_plain(ring_raw, mw, ring_org, ring_d2, gs, ring_zs), reps=3, inner=1)
    zring_bytes = wavefront_bytes(8, rw, rw, half + 2 * mw, mw, mw, True)
    del main_ring, ring_raw, ring_zs
    sh_raw, sh_org, sh_d2, sh_zs = main_shell
    shwf_ms = cuda_ms(lambda: jk.jacobi_shell_wavefront_step(sh_raw, mw, sh_org, sh_d2, gs, z_slabs=sh_zs,
                                                             z_valid=rw), inner=2)
    shwf_plain_ms = cuda_ms(lambda: jk.jacobi_shell_wavefront_step_plain(sh_raw, mw, sh_org, sh_d2, gs,
                                                                         z_slabs=sh_zs, z_valid=rw),
                            reps=3, inner=1)
    shwf_bytes = wavefront_bytes(8, rw, rw, rw, mw, mw, True)
    del main_shell, sh_raw, sh_zs
    wave_flops = 7 * 8 * half ** 3 * mw  # six adds and a multiply per cell and level

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
    ast_ref = ast_first.cpu()  # phase 13's reference, off the card until then
    del ast_first
    torch.cuda.empty_cache()

    # --- 9. stream kernel times at the main path's shapes ------------------------------
    phase_start(9)
    def trace_ops(sk) -> int:
        """Arithmetic operations per cell of one field's update."""
        return sum(n.op not in ("load", "coord", "const") for n in sk.trace().live()) // len(sk.names)

    def stream_wavefront_bytes(n, Xr, Yr, W, m, s_off, slabs, fields):
        """Bytes one stream wavefront call must move (as wavefront_bytes,
        without the d2 plane): per field and block, the cells its m levels
        reach read once, the valid region written once; the origins."""
        e = s_off - m
        Xa, Ya, Wa = Xr - 2 * e, Yr - 2 * e, W - 2 * e
        Xi, Yi, Wi = Xr - 2 * s_off, Yr - 2 * s_off, W - 2 * s_off
        reads = Xa * Ya * (Wa - 2 * m if slabs else Wa)
        writes = Xi * Yi * Wi
        if slabs:
            reads += Xa * 2 * m * Ya
            writes += Xi * 2 * s_off * Yi
        return fields * n * (reads + writes) * 4 + n * 12

    ops = trace_ops(ak1)
    wf_raw = [seeded((1, ws, ws, ws), 110, dev)]
    wf_zs = [seeded((1, ws, 6, ws), 111, dev)]
    wf_args = (ak1, ast_names[:1], wf_raw, 3, 3, org0.view(1, 3), gs_main)
    swf_ms = cuda_ms(lambda: st.stream_wavefront_pass(*wf_args, z_slabs=wf_zs, z_valid=ws), inner=2)
    swf_plain_ms = cuda_ms(lambda: st.stream_wavefront_pass_plain(*wf_args, z_slabs=wf_zs, z_valid=ws),
                           reps=3, inner=1)
    swf_bytes = stream_wavefront_bytes(1, ws, ws, ws, 3, 3, True, 1)
    swf_flops = ops * N ** 3 * 3
    del wf_raw, wf_zs
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
    del ast_u_ref
    torch.cuda.empty_cache()

    # --- 12. times of the slab and dynamic blend kernels ----------------------------
    phase_start(12)
    slab_out = torch.empty_like(slab_in)
    slab_args_main = (slab_in, *slab_faces, org, d2, gs)
    slabk_ms = cuda_ms(lambda: jk.jacobi_slab_step(*slab_args_main, out=slab_out))
    slabk_plain_ms = cuda_ms(lambda: jk.jacobi_slab_step_plain(*slab_args_main, out=slab_out), inner=2)
    slabk_bytes = (2 * slab_in.numel() + sum(f.numel() for f in slab_faces) + d2.numel() + org.numel()) * 4
    slabk_flops = 7 * slab_in.numel()
    del slab_out, slab_in, slab_faces
    dyn_ms, dyn_plain_ms, dyn_lib_ms = {}, {}, {}
    for slab, axis, pos in dyn_writes:
        dyn_ms[axis] = cuda_ms(lambda: hb.blend_slab_dynamic(dyn_blocks, slab, axis, pos))
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
    dyn_bytes = 2 * dyn_writes[0][0].numel() * 4 + 8 * 4  # the +x write: slab read, slab written, offsets
    log("blend_slab_dynamic per +axis halo write at (8,{0},{0},{0}) m={1} (ms: kernel, plain, scatter_): ".format(
        ru, mu) + ", ".join(f"axis {a}: {dyn_ms[a]:.4f}, {dyn_plain_ms[a]:.4f}, {dyn_lib_ms[a]:.4f}"
                           for a in (0, 1, 2)))
    log(f"jacobi_slab_step at 8x{half}^3: {slabk_ms:.4f} ms (plain {slabk_plain_ms:.4f}) on {card}")
    del dyn_blocks, dyn_writes
    torch.cuda.empty_cache()

    # --- 13. the packed exchange routes -----------------------------------------------
    phase_start(13)
    # blend_slab launches an iteration: 8 fields x 2 directions per sweep
    # that writes through it (x always, y and z unless packed by the kernels)
    blends = {"direct": 48, "zpack_xla": 48, "zpack_pallas": 32, "yzpack_xla": 48, "yzpack_pallas": 16}
    routes_13 = {}
    ast_ref = ast_ref.to(dev)
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
        if not torch.equal(got, ast_ref):
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
        if route == "yzpack_pallas":
            entry["profile"] = device_breakdown(sim, AST_ITERS)
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
    del ast_ref
    torch.cuda.empty_cache()
    # the four kernels at that path's shapes: one field's 8 blocks of 262^3,
    # the radius-3 shell; the library call is the same copy as one copy_
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
                               lambda: ybuf.copy_(pk_blocks.narrow(2, ps - 6, 3).transpose(1, 2))),
        "unpack_yshell_pallas": (lambda: pk.unpack_yshell_pallas(pk_blocks, ybuf, 0, 3),
                                 lambda: pk.unpack_yshell_pallas_plain(pk_blocks, ybuf, 0, 3),
                                 lambda: pk_blocks.narrow(2, 0, 3).copy_(ybuf.transpose(1, 2))),
    }
    # the library copies make what the kernels make
    if not (torch.equal(pack_cases["pack_zshell_pallas"][2](), pk.pack_zshell_pallas(pk_blocks, ps - 6, 3))
            and torch.equal(pack_cases["pack_yshell_pallas"][2](), pk.pack_yshell_pallas(pk_blocks, ps - 6, 3))):
        raise AssertionError("copy_ into the buffer and the pack kernels disagree")
    pack_ms = {name: [cuda_ms(fn) for fn in fns] for name, fns in pack_cases.items()}
    # a launch's device time.  In the route: the profile's kernel time an
    # iteration over the launches an iteration (the window cold in L2; the
    # kernels are zshell_kernel / yshell_kernel, <T, true> packing).  Back to
    # back on one block the window stays in L2, and CUDA events between calls
    # count the host's issue time.
    route_prof = routes_13["yzpack_pallas"]["profile"]["kernels_ms_per_step"]
    pack_dev_ms, pack_hot_ms = {}, {}
    for name, fns in pack_cases.items():
        tag, packs = name.split("_")[-2][-6:] + "_kernel<", name.startswith("pack")
        per_iter = [v for k, v in route_prof.items() if tag in k and (", true>" in k) == packs]
        if len(per_iter) != 1:
            raise AssertionError(f"{name}: {len(per_iter)} profiler entries of {tag}: {list(route_prof)}")
        pack_dev_ms[name] = per_iter[0] / (pack_counts[name] / AST_ITERS)
        pack_hot_ms[name] = device_ms_per_call(fns[0], calls=20)
    pack_bytes = 2 * zbuf.numel() * 4  # the window read once and written once
    log("shell packs at (8,{0},{0},{0}) f32 depth 3 (ms: kernel, plain, copy_): ".format(ps)
        + ", ".join(f"{k}: {v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}" for k, v in pack_ms.items()) + "; device ms a "
        "launch in the route (profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in pack_dev_ms.items())
        + "; back to back, hot in L2: " + ", ".join(f"{k} {v:.4f}" for k, v in pack_hot_ms.items()) + f" on {card}")
    del pk_blocks, zbuf, ybuf, pack_cases
    torch.cuda.empty_cache()

    rows = []
    # launches of a Jacobi run of STEPS steps with one launch a macro of m levels
    macros = {m: sum(-(-k // m) for k in (CHECK_AT, STEPS - CHECK_AT)) for m in (mw, mu)}
    m_ast = ast["wavefront 1x1x1"]["m"]
    # (name, launch counts, steps of their run, launches expected in it, ...)
    specs = [
        ("jacobi_wrap_step", wrap_counts, STEPS, STEPS, wrap_ms, wrap_plain_ms, None, wrap_bytes, 7 * cells,
         f"({N},{N},{N}) f32, k=1"),
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
    ]
    entries = {ledger.wrapper_name(e): e for e in ledger.ported().values()}
    for name, counts, steps, want, ms, plain_ms, lib_ms, nbytes, flops, shape in specs:
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches in its {steps}-step run, want {want}")
        b_ms, b_by = bound(nbytes, flops)
        e = entries[name]
        rows.append({
            "name": name, "route": e["route"], "source": e["source"], "replaces": e["replaces"],
            "launches": counts[name], "launches_per_step": counts[name] / steps,
            "max_abs_err": errs[name], "bitwise": errs[name] == 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "copy_bound_ms": nbytes / copy_bw * 1e3, "library_ms": lib_ms, "shape": shape,
        })
        if name in pack_dev_ms:
            rows[-1]["device_ms"] = pack_dev_ms[name]
    missing = set(entries) - {r["name"] for r in rows}
    if missing:
        raise AssertionError(f"ported kernels without a row: {missing}")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({
            "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
            "kernels": rows, "copy_ms": copy_ms, "copy_gb_per_s": copy_bw / 1e9,
            "blend_per_axis_ms": per_axis, "shell_exchange_ms": exchange_ms,
            "step1_ms_min_median": step1, "astaroth": ast,
            "slab_route": {"mcells_per_s": slabr_mcells, "launches": slabr_counts, "profile": slabr_profile},
            "uneven_jacobi": uneven, "uneven_astaroth": ast_u, "packed_routes": routes_13,
            "shell_pack_ms": {k: dict(zip(("kernel", "plain", "copy_"), v), device_in_route=pack_dev_ms[k],
                                      device_back_to_back=pack_hot_ms[k]) for k, v in pack_ms.items()},
            "blend_slab_dynamic_ms": {"kernel": dyn_ms, "plain": dyn_plain_ms, "scatter_": dyn_lib_ms},
            "routes": {"wrap_mcells_per_s": wrap_mcells, "shell_mcells_per_s": shell_mcells,
                       "wavefront_zring_mcells_per_s": wave_mcells,
                       "wavefront_zslab_mcells_per_s": slab_mcells, "wavefront_m": mw,
                       "torch_engine_mcells_per_s": torch_mcells,
                       "wrap_launches": wrap_counts, "shell_launches": shell_counts,
                       "wavefront_zring_launches": wave_counts, "wavefront_zslab_launches": slab_counts},
            "profile": {"wrap": wrap_profile, "shell": shell_profile,
                        "wavefront_zring": wave_profile, "wavefront_zslab": slab_profile},
            "build": {k: v["seconds"] for k, v in build.BUILD_LOG.items()},
            "phase_start_s": phase_s, "total_s": time.perf_counter() - t_start,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        }, f, indent=1)

    log(f"peak device memory allocated: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{time.perf_counter() - t_start:.1f} s in all")
    log(card)  # the nvidia-smi line as it prints it: name, power limit
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
