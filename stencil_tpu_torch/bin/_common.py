"""Flags and helpers the ported drivers share (counterpart of
``stencil_tpu/bin/_common.py``): the reference's transport flags
(``add_method_flags``, ``parse_methods``, ``method_str``, ``parse_strategy``),
``--exchange-route``, the kernel axes, ``--partition`` / ``--device``, the
subdomain-grid helpers (``ranks_and_devcount``, ``fit_to_mesh``), the
transfer primitives of the pingpong / bench-alltoallv / measure-buf-exchange
drivers (``endpoints``, ``make_edge_transfer``, ``make_matrix_transfer``,
``measure_edge``, ``measure_matrix_concurrent``, ``WallTimer``),
``--metrics-out``, ``--profile-dir`` (the cadence device-profile capture and
its roofline report), ``--numerics-every``, the checkpoint flags of the run
supervisor, the autotuner's ``--tune`` / ``--no-tune`` / ``--tune-cache``, and
the timing helpers of the tuner's trial protocol (``host_round_trip_s``,
``timed_inner_loop``)."""

from __future__ import annotations

import argparse
import os
import sys
import time

from stencil_tpu_torch.device import copy_gbps, host_round_trip_s  # noqa: F401 -- the drivers' names for them


def add_telemetry_flags(p: argparse.ArgumentParser) -> None:
    """``--metrics-out PATH``: write the telemetry snapshot (counters,
    gauges, histogram stats; JSON) to PATH at exit.  Passing it turns
    telemetry on for the run; with ``STENCIL_TELEMETRY_DIR`` also set, the
    run leaves its JSONL event log and Chrome trace there too."""
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write a telemetry snapshot JSON to PATH at exit (turns telemetry on)")


def add_profile_flags(p: argparse.ArgumentParser) -> None:
    """``--profile-dir DIR``: cadence-gated ``torch.profiler`` captures around
    the driver's dispatches (``STENCIL_PROFILE_EVERY`` sets the cadence;
    unset, one capture).  At exit the device rows are merged into the host
    Chrome trace and a per-phase roofline report lands beside the captures
    (``stencil_tpu/bin/_common.py:81-96``).  A profiler that will not start
    warns and the run goes on."""
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture torch.profiler traces here on the STENCIL_PROFILE_EVERY cadence; at exit the "
                        "device rows are merged into the Chrome trace and roofline.json/.md are written")


def profile_capture_for(args):
    """A ``ProfileCapture`` from ``add_profile_flags``'s choice (the
    environment fills an unset flag), or None: profiling is opt-in."""
    from stencil_tpu_torch.telemetry.device import ProfileCapture

    return ProfileCapture.from_env(dir=getattr(args, "profile_dir", None))


def profile_finalize(args, capture, chrome_path: str = None, device=None) -> None:
    """The device-time artifacts at the end of a run
    (``stencil_tpu/bin/_common.py:99-142``): merge the newest capture's
    device rows into the host Chrome trace at ``chrome_path``, and write
    ``roofline.json`` / ``roofline.md`` into the profile directory: the
    per-phase roofline of the capture's window (``roofline.capture_report``,
    the card's peaks with a measured ``copy_`` bandwidth for HBM), with
    ``launches`` (each kernel family's launches the trace held against those
    its wrappers counted), ``overlap`` (the split schedule's interior and
    exterior per stream), ``comms`` (the per-hop view) and ``card`` (name
    and power limit).  Runs after the last host-trace dump.  A capture with
    no device row (a CPU run) writes nothing and says so; a failure here is
    printed, never raised on the driver's exit path."""
    if capture is None or capture.captures == 0:
        return
    from stencil_tpu_torch.telemetry.device import (
        attribute_device_time, attribute_exchange_directions, launches_held, merge_into_chrome_trace, overlap_report,
    )
    from stencil_tpu_torch.telemetry.roofline import capture_report, comms_roofline, render_markdown
    from stencil_tpu_torch.tune.key import chip_kind
    from stencil_tpu_torch.utils.artifact import atomic_write_json, atomic_write_text

    try:
        if chrome_path is not None:
            merge_into_chrome_trace(chrome_path, capture.dir)
        chip = chip_kind(device)
        on_card = chip != "cpu"
        report = capture_report(capture, chip=chip, measured_hbm_gbps=copy_gbps(device) if on_card else None)
        if report is None:
            print(f"profile: no device rows under {capture.dir} (no device profiler on this run) - no roofline "
                  "report; python -m stencil_tpu_torch.bin.perf_report can build a host-span fallback",
                  file=sys.stderr)
            return
        events = capture.newest_events()
        report["launches"] = launches_held(events, capture.last_launch_deltas)
        report["overlap"] = overlap_report(events)
        report["comms"] = comms_roofline(attribute_exchange_directions(events), capture.counters_snapshot())
        report["via"] = attribute_device_time(events).get("_via")
        if on_card:
            from stencil_tpu_torch.kernels import toolchain

            report["card"] = toolchain()["card"]
        atomic_write_json(os.path.join(capture.dir, "roofline.json"), report)
        atomic_write_text(os.path.join(capture.dir, "roofline.md"), render_markdown(report))
        print(f"profile: roofline report in {capture.dir}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - observability must not fail the run
        print(f"profile finalize failed: {e!r}", file=sys.stderr)


def add_numerics_flag(p: argparse.ArgumentParser) -> None:
    """``--numerics-every N``: a numerics snapshot (per-quantity
    min/max/absmax/mean/L2, non-finite count and first non-finite
    coordinate) every N raw steps, into the engine's ring, running the
    model's guardbands; unset falls back to ``STENCIL_NUMERICS_EVERY``, 0
    disables."""
    p.add_argument("--numerics-every", type=int, default=None, metavar="N",
                   help="field-health snapshot every N raw steps (default: STENCIL_NUMERICS_EVERY; 0 = off)")


def apply_numerics(args, dd) -> None:
    """Apply ``--numerics-every`` to a domain (the domain's constructor has
    read the environment's default)."""
    every = getattr(args, "numerics_every", None)
    if every is not None:
        dd.set_numerics_every(max(every, 0))


def _write_snapshot(path: str) -> None:
    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.utils.artifact import atomic_write_json

    atomic_write_json(path, telemetry.snapshot())


def telemetry_begin(args) -> None:
    """Turn telemetry on when ``--metrics-out`` asks for it; call right
    after ``parse_args``.  A run that turns it on starts from zeroed
    metrics, and the snapshot write is also registered with ``atexit``, so a
    run that dies on an exception still leaves its counters."""
    from stencil_tpu_torch import telemetry

    path = getattr(args, "metrics_out", None)
    if path and not telemetry.enabled():
        telemetry.enable()
        telemetry.reset()
        args._telemetry_owned = True
    if path:
        import atexit

        args._telemetry_atexit = lambda: _write_snapshot(path)
        atexit.register(args._telemetry_atexit)


def telemetry_end(args, profile_capture=None, device=None) -> None:
    """Flush the telemetry files and write the ``--metrics-out`` snapshot
    on ``main``'s clean exit, and leave the process's telemetry as
    ``telemetry_begin`` found it.  ``profile_capture`` (the driver's
    ``ProfileCapture``) is finalized after the Chrome-trace dump, so the
    device rows are merged into the final host trace."""
    from stencil_tpu_torch import telemetry

    arts = {}
    if telemetry.enabled():
        arts = telemetry.write_artifacts()
    if profile_capture is not None:
        profile_finalize(args, profile_capture, chrome_path=arts.get("trace"), device=device)
    path = getattr(args, "metrics_out", None)
    if path:
        _write_snapshot(path)
    hook = getattr(args, "_telemetry_atexit", None)
    if hook is not None:
        import atexit

        atexit.unregister(hook)
        args._telemetry_atexit = None
    if getattr(args, "_telemetry_owned", False):
        telemetry.disable()


def add_checkpoint_flags(p: argparse.ArgumentParser) -> None:
    """The long-run survival flags (``stencil_tpu/bin/_common.py:308-341``):
    ``--checkpoint-dir`` turns the run supervisor on (a ring of atomic
    checkpoints, a final save and exit code 75 on SIGTERM, the FATAL/STALL
    restart budget), ``--checkpoint-every`` sets the step cadence,
    ``--checkpoint-keep`` the ring's size, ``--resume`` continues from the
    newest valid entry.  Unset flags fall back to the
    ``STENCIL_CHECKPOINT_*`` / ``STENCIL_SUPERVISOR_RESTARTS`` environment."""
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="checkpoint ring directory; turns the run supervisor on (reuse an existing ring "
                        "only together with --resume)")
    p.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                   help="checkpoint every N iterations (default: STENCIL_CHECKPOINT_EVERY)")
    p.add_argument("--checkpoint-keep", type=int, default=None, metavar="K",
                   help="retention-ring size (default: STENCIL_CHECKPOINT_KEEP or 3)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid checkpoint in --checkpoint-dir (corrupt entries fall "
                        "back to older ones)")


def supervisor_for(args, dd, label: str, run_state=None, on_mesh_change=None):
    """A ``RunSupervisor`` from ``add_checkpoint_flags``'s choices (the
    environment fills unset flags), or None when no checkpoint directory is
    set anywhere: supervision is opt-in.  ``on_mesh_change`` is the models'
    ``rebuild_after_reshard``, called after the capacity fallback
    re-realized the domain."""
    from stencil_tpu_torch.resilience.supervisor import RunSupervisor, SupervisorConfig

    overrides = {}
    if getattr(args, "checkpoint_every", None) is not None:
        overrides["every_steps"] = max(args.checkpoint_every, 0)
    if getattr(args, "checkpoint_keep", None) is not None:
        overrides["keep"] = max(args.checkpoint_keep, 1)
    cfg = SupervisorConfig.from_env(dir=getattr(args, "checkpoint_dir", None), **overrides)
    if cfg is None:
        return None
    return RunSupervisor(dd, cfg, label=label, run_state=run_state, on_mesh_change=on_mesh_change)


def add_tune_flags(p: argparse.ArgumentParser) -> None:
    """The autotuner's flags (``stencil_tpu/bin/_common.py:145-170``):
    ``--tune`` runs the search for this driver's workload on the card
    before the model builds (zero trials when the cache is warm),
    ``--no-tune`` pins the static picks, ``--tune-cache`` redirects the
    config cache for the run."""
    g = p.add_mutually_exclusive_group()
    g.add_argument("--tune", action="store_true",
                   help="autotune this workload on the card first (cached: a second run makes no trial)")
    g.add_argument("--no-tune", action="store_true", help="ignore tuned configs; use the static picks")
    p.add_argument("--tune-cache", default=None, metavar="DIR",
                   help="tuned-config cache directory (default: STENCIL_TUNE_CACHE or "
                        "~/.cache/stencil_tpu_torch/tune)")


def tune_begin(args) -> None:
    """Apply ``add_tune_flags``'s choices to the tune package; call right
    after ``parse_args``, before any model is built, and pair it with
    ``tune_end``: the overrides are process-global, and an in-process run
    must not inherit the last one's ``--no-tune`` / ``--tune-cache``."""
    from stencil_tpu_torch import tune

    args._tune_restore = tune.overrides()
    if getattr(args, "tune_cache", None):
        tune.set_cache_dir(args.tune_cache)
    if getattr(args, "no_tune", False):
        tune.set_enabled(False)
    elif getattr(args, "tune", False):
        tune.set_enabled(True)


def tune_end(args) -> None:
    from stencil_tpu_torch import tune

    state = getattr(args, "_tune_restore", None)
    if state is not None:
        tune.restore(state)
        args._tune_restore = None


def tune_report_stderr(report) -> None:
    """One stderr line of a driver's autotune outcome."""
    print(f"tune[{report.key.route}]: source={report.source} config={report.config} trials={report.trials} "
          f"pruned={report.pruned}", file=sys.stderr)


def timed_inner_loop(run, inner: int, rt: float, n_iters: int, min_ratio: float = 5.0,
                     max_inner: int = 1 << 14):
    """Per-iteration seconds of a dispatch of ``inner`` iterations with the
    host round trip ``rt`` subtracted (``stencil_tpu/bin/_common.py:481-510``).
    ``run(k)`` runs one synchronized dispatch of ``k`` iterations.  ``inner``
    grows until a dispatch takes ``min_ratio * rt``; when it cannot, the raw
    time is reported with a warning rather than a clamped sample.  Returns
    ``(samples, inner_used)``."""
    run(inner)  # warm at this count
    while True:
        t0 = time.perf_counter()
        run(inner)
        t = time.perf_counter() - t0
        if t >= min_ratio * rt or inner >= max_inner:
            break
        grow = max(2 * inner, int(inner * min_ratio * rt / max(t, 1e-9)))
        inner = min(grow, max_inner)
        run(inner)  # warm at the new count before measuring again
    samples = []
    subtract = t >= min_ratio * rt
    if not subtract:
        print(f"warning: dispatch ({t:.3g}s at inner={inner}) not >> host rt ({rt:.3g}s); reporting raw "
              "per-iter time (rt not subtracted)", file=sys.stderr)
    for _ in range(n_iters):
        t0 = time.perf_counter()
        run(inner)
        t = time.perf_counter() - t0
        samples.append(((t - rt) if subtract else t) / inner)
    return samples, inner


# --- the reference's transport flags (stencil_tpu/bin/_common.py:16-63) ----------------

#: (flag, MethodFlags member name, CSV name): the reference's transport
#: flags (jacobi3d.cu:111-120); all map onto the one on-device exchange
METHOD_FLAGS = (
    ("staged", "CudaMpi", "staged"),
    ("cuda_aware_mpi", "CudaAwareMpi", "cuda-aware"),
    ("colo", "CudaMpiColocated", "colo"),
    ("peer", "CudaMemcpyPeer", "peer"),
    ("kernel", "CudaKernel", "kernel"),
)


def add_method_flags(p: argparse.ArgumentParser) -> None:
    """The reference's transport flags and ``--trivial``: accepted and
    echoed in the CSV's method string, so reference run scripts keep
    working; every one maps onto the one exchange."""
    p.add_argument("--staged", action="store_true", help="Enable RemoteSender/Recver")
    p.add_argument("--cuda-aware-mpi", action="store_true", help="Enable CudaAwareMpiSender/Recver")
    p.add_argument("--colo", action="store_true", help="Enable ColocatedHaloSender/Recver")
    p.add_argument("--peer", action="store_true", help="Enable PeerAccessSender")
    p.add_argument("--kernel", action="store_true", help="Enable PeerCopySender")
    p.add_argument("--trivial", action="store_true", help="Skip node-aware placement")


def parse_methods(args):
    """The ``MethodFlags`` the flags select, ``All`` when none is set."""
    from stencil_tpu_torch.utils.config import MethodFlags

    m = MethodFlags.Non
    for flag, member, _ in METHOD_FLAGS:
        if getattr(args, flag, False):
            m |= getattr(MethodFlags, member)
    return MethodFlags.All if m == MethodFlags.Non else m


def method_str(args) -> str:
    """The CSV's method string (jacobi3d.cu:355-374): the flags' names
    joined by ``/``, ``ppermute`` (the default transport) when none is set."""
    return "/".join(name for flag, _, name in METHOD_FLAGS if getattr(args, flag, False)) or "ppermute"


def parse_strategy(args):
    from stencil_tpu_torch.utils.config import PlacementStrategy

    return PlacementStrategy.Trivial if getattr(args, "trivial", False) else PlacementStrategy.NodeAware


def add_exchange_route_flag(p: argparse.ArgumentParser) -> None:
    """``--exchange-route`` (``stencil_tpu/bin/_common.py:172-193``): pin the
    halo exchange's y/z-sweep route; ``auto`` (default) keeps the planner's
    resolution (``STENCIL_EXCHANGE_ROUTE`` > tuned config > ``direct``)."""
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES

    p.add_argument("--exchange-route", default="auto", choices=("auto",) + EXCHANGE_ROUTES,
                   help="y/z-sweep exchange route: direct slabs, or the z shell (zpack_*) or y and "
                        "z shells (yzpack_*) as packed buffers; *_pallas packs with the CUDA kernels")


def apply_exchange_route(args, dd) -> None:
    """Apply ``--exchange-route`` to a domain before ``realize()``."""
    route = getattr(args, "exchange_route", "auto")
    if route != "auto":
        dd.set_exchange_route(route)


def add_kernel_axis_flags(p: argparse.ArgumentParser) -> None:
    """``--compute-unit`` / ``--mxu-input`` / ``--storage-dtype``
    (``stencil_tpu/bin/_common.py:196-230``): the level kernels' axes;
    ``auto`` (default) resolves the static ``vpu`` / ``f32`` / ``native``,
    and a structural guard (a route or engine without the form) degrades
    with a warning."""
    from stencil_tpu_torch.ops.jacobi_kernels import COMPUTE_UNITS, MXU_INPUTS, STORAGE_DTYPES

    p.add_argument("--compute-unit", default="auto", choices=("auto",) + COMPUTE_UNITS,
                   help="vpu: the six-neighbour fold; mxu / mxu_band: the in-plane sums as a "
                        "band contraction on the tensor cores (wrap and wavefront routes)")
    p.add_argument("--mxu-input", default="auto", choices=("auto",) + MXU_INPUTS,
                   help="the contraction's operands: f32 (three exact TF32 pieces) or bf16 "
                        "(rounded once a read); inert under vpu")
    p.add_argument("--storage-dtype", default="auto", choices=("auto",) + STORAGE_DTYPES,
                   help="native, or bf16: the field stored as bfloat16, the kernels "
                        "accumulating at f32 and rounding once a pass")


def kernel_axis_kwargs(args) -> dict:
    """Model keyword arguments from ``add_kernel_axis_flags``' choices
    (``auto`` is left out: the model resolves it)."""
    out = {}
    for key in ("compute_unit", "mxu_input", "storage_dtype"):
        value = getattr(args, key, "auto")
        if value != "auto":
            out[key] = value
    return out


def parse_partition(text: str):
    """``--partition px,py,pz`` as a tuple of three positive ints."""
    try:
        parts = [int(v) for v in text.split(",")]
    except ValueError:
        parts = []
    if len(parts) != 3 or min(parts) < 1:
        raise argparse.ArgumentTypeError(f"--partition wants px,py,pz, got {text!r}")
    return tuple(parts)


def add_device_flags(p: argparse.ArgumentParser, partition: bool = True) -> None:
    """``--partition px,py,pz`` (the subdomain grid on the one card, where
    the JAX drivers spread the domain over devices) and ``--device``."""
    if partition:
        p.add_argument("--partition", type=parse_partition, default=None,
                       help="subdomain grid px,py,pz on the one device (default 1,1,1)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")


def card_line(device):
    """``nvidia-smi``'s name and power limit when ``device`` is a card, None
    on the CPU: the ``card`` key of the drivers' JSON documents."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    from stencil_tpu_torch.kernels import toolchain

    return toolchain()["card"]


def subdomain_count(args) -> int:
    part = getattr(args, "partition", None) or (1, 1, 1)
    return part[0] * part[1] * part[2]


# --- the subdomain grid (stencil_tpu/bin/_common.py:513-536) ----------------------------


def ranks_and_devcount():
    """(processes, cards in use): the reference's (MPI size, devices per
    rank).  The port runs one process on one card."""
    return 1, 1


def fit_to_mesh(x: int, y: int, z: int, radius, subdomains: int = 1, partition=None):
    """Each axis rounded to the NEAREST multiple of the subdomain grid the
    domain itself would choose for it (``parallel/mesh.make_grid``: the
    forced ``partition``, else the min-interface split of ``subdomains``),
    each subdomain clamped up to the radius shell so ``realize()`` cannot
    reject it: the JAX package's ``fit_to_mesh``, subdomains in place of
    devices."""
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.parallel.mesh import make_grid

    force = Dim3(*partition) if partition is not None else None
    # sizing only: the grid's dim, never its slots, so any device serves
    dim = make_grid((x, y, z), radius, subdomains, force_dim=force, device="cpu").dim()
    lo, hi = radius.lo(), radius.hi()
    min_shard = max(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, 1)
    return tuple(max(round(v / d), min_shard) * d for v, d in zip((x, y, z), dim))


# --- transfers (stencil_tpu/bin/_common.py:539-674) -------------------------------------


def endpoints(device="cuda"):
    """The transfer drivers' endpoints: every visible card under ``cuda``
    (none visible raises), the CPU under ``cpu``.  A list of one endpoint
    pairs it with itself, as the JAX package wraps on one device; the
    functions below take any list, so ``[dev, dev]`` is a pair of two
    buffers on one card."""
    import torch

    from stencil_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def sync_endpoints(eps) -> None:
    from stencil_tpu_torch.device import sync

    for dev in set(eps):
        sync(dev)


def make_edge_transfer(eps, src: int, dst: int, n_elems: int):
    """One transfer of ``n_elems`` f32 from endpoint ``src`` to ``dst``
    (``dst.copy_(src)``: a peer copy between cards, a device-to-device copy
    on one), with its two buffers: ``(go, (a, b))``, ``go()`` enqueues it.
    The primitive under pingpong, bench-alltoallv and measure-buf-exchange."""
    import torch

    a = torch.ones(n_elems, dtype=torch.float32, device=eps[src])
    b = torch.empty(n_elems, dtype=torch.float32, device=eps[dst])

    def go():
        b.copy_(a, non_blocking=True)

    return go, (a, b)


def matrix_pairs(comm):
    """The pairs ``(i, j, nbytes)`` of a bytes matrix that move bytes: every
    ``i != j`` with ``comm[i, j] > 0``, and with one endpoint the endpoint
    with itself (``comm[0, 0] > 0``), as ``measure_edge`` pairs it."""
    n = comm.shape[0]
    return [(i, j, int(comm[i, j])) for i in range(n) for j in range(n) if (i != j or n == 1) and comm[i, j] > 0]


def make_matrix_transfer(eps, comm):
    """The CONTENDED traversal of a bytes matrix: every pair of
    ``matrix_pairs(comm)`` copies its payload on a CUDA stream of its own, all
    enqueued before one synchronize, so the copies run at once, as the
    reference batch-starts them (bench_alltoallv.cu:139-168,
    measure_buf_exchange.cu:120-159).  Streams, unlike ``ppermute``, take
    repeated destinations, so there are no unique-destination rounds.
    Returns ``(go, bufs)``; ``go()`` enqueues one traversal (on the CPU the
    copies run in turn); ``(None, ())`` when no pair moves bytes."""
    import torch

    pairs = matrix_pairs(comm)
    if not pairs:
        return None, ()
    bufs = []
    for i, j, nbytes in pairs:
        k = max(nbytes // 4, 1)
        bufs.append((torch.ones(k, dtype=torch.float32, device=eps[i]),
                     torch.empty(k, dtype=torch.float32, device=eps[j])))
    on_card = eps[0].type == "cuda"
    streams = [torch.cuda.Stream(device=eps[i]) for i, _, _ in pairs] if on_card else None

    def go():
        if not on_card:
            for a, b in bufs:
                b.copy_(a)
            return
        for (i, _, _), (a, b), s in zip(pairs, bufs, streams):
            # each side stream starts after the work already on its card's
            # current stream, then all copies run at once
            s.wait_stream(torch.cuda.current_stream(eps[i]))
            with torch.cuda.stream(s):
                b.copy_(a, non_blocking=True)
        for (i, _, _), s in zip(pairs, streams):
            torch.cuda.current_stream(eps[i]).wait_stream(s)

    return go, bufs


def measure_matrix_concurrent(eps, comm, n_iters: int) -> float:
    """Seconds for one CONTENDED traversal of the bytes matrix (all pairs at
    once; ``make_matrix_transfer``), after one untimed traversal; None when
    no pair moves bytes."""
    go, _ = make_matrix_transfer(eps, comm)
    if go is None:
        return None
    go()
    sync_endpoints(eps)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        go()
    sync_endpoints(eps)
    return (time.perf_counter() - t0) / n_iters


def measure_edge(eps, src: int, dst: int, nbytes: int, n_iters: int) -> float:
    """Seconds a single transfer of ``nbytes`` from ``src`` to ``dst``,
    after one untimed transfer."""
    go, _ = make_edge_transfer(eps, src, dst, max(int(nbytes) // 4, 1))
    go()
    sync_endpoints(eps)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        go()
    sync_endpoints(eps)
    return (time.perf_counter() - t0) / n_iters


class WallTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0
