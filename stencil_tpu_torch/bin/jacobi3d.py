"""jacobi3d driver on PyTorch + CUDA.

Counterpart of ``stencil_tpu/bin/jacobi3d.py`` (reference bin/jacobi3d.cu):
the same CLI shape (positional x y z base size, weak-scaled by
numSubdoms^(1/3) unless --no-weak-scale; --no-overlap; --trivial; the method
flags) and the same CSV row

    jacobi3d,<methods>,ranks,devCount,x,y,z,min(s),trimean(s)

(jacobi3d.cu:378-379), plus ``--partition px,py,pz`` (subdomains on the one
device), ``--device``, and the JAX driver's ``--pallas-path``,
``--halo-multiplier``, ``--temporal-k``, ``--exchange-route``, the kernel
axes ``--compute-unit``, ``--mxu-input`` and ``--storage-dtype``,
``--numerics-every``, ``--metrics-out``, ``--trace DIR`` (a
``torch.profiler`` trace of the timed loop) and ``--profile-dir DIR`` (a
cadence capture around the timed samples, ``STENCIL_PROFILE_EVERY``, and
``roofline.json`` / ``roofline.md`` written there at exit:
``bin/_common.profile_finalize``), the reference's ``--paraview``
(a ``<prefix>jacobi3d_<it>_<id>.txt`` dump every ``--period`` iterations,
default a tenth of ``--iters``, and ``<prefix>jacobi3d_final``; the dumps are
outside the timed samples), and the run supervisor's ``--checkpoint-dir``,
``--checkpoint-every``, ``--checkpoint-keep`` and ``--resume``
(``resilience/supervisor.py``), and the autotuner's ``--tune``,
``--no-tune`` and ``--tune-cache`` (``tune/``; the JAX driver's gating,
``stencil_tpu/bin/jacobi3d.py:106-166``): ``--tune`` on the cuda engine
searches the route the model will take (``wrap`` on one subdomain, else the
wavefront) before the model is built, and on the torch engine the exchange
route, each a warm cache's zero trials; the model then consults the cache.  Each timed
sample is one macro step (``halo multiplier`` iterations: k on the torch
engine under ``--halo-multiplier k``, the depth m on the wavefront route,
else 1) and a device synchronize; the CSV reports it per iteration, as the
JAX driver does for its halo multiplier, so routes of different depths
compare.

    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale --iters 200
    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale \
        --partition 2,2,2 --pallas-path wavefront --iters 200
    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale \
        --partition 2,2,2 --pallas-path slab --iters 200
    python -m stencil_tpu_torch.bin.jacobi3d 511 511 511 --no-weak-scale \
        --partition 2,2,2 --iters 200
    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale \
        --compute-unit mxu_band --mxu-input bf16 --iters 200
    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale \
        --storage-dtype bf16 --iters 200
    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale \
        --partition 2,2,2 --tune --tune-cache tune_cache --iters 200

An uneven size (one the grid does not divide, given with --no-weak-scale)
pads every subdomain to ceil(size / grid) cells per axis, as the domain does.

A supervised run (``--checkpoint-dir``) counts its steps in timed samples:
the checkpoint cadence, ``--iters`` and a resume's step are samples, each
one ``model.step(macro)``.  It makes no untimed warm-up call (the first
sample absorbs the kernels' build), so that a killed and resumed run
advances exactly ``--iters`` samples in all and ends bitwise equal to an
uninterrupted one; SIGTERM ends it with exit code 75 after a final
checkpoint, and ``--resume`` continues from the ring:

    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale --iters 200 \
        --checkpoint-dir ring --checkpoint-every 50
    python -m stencil_tpu_torch.bin.jacobi3d 512 512 512 --no-weak-scale --iters 200 \
        --checkpoint-dir ring --checkpoint-every 50 --resume
    python -m stencil_tpu_torch.status ring
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from stencil_tpu_torch import telemetry
from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.io.paraview import write_paraview
from stencil_tpu_torch.models.jacobi import Jacobi3D, weak_scaled_size
from stencil_tpu_torch.utils.statistics import Statistics

def main(argv=None) -> int:
    p = argparse.ArgumentParser("jacobi3d")
    _common.add_method_flags(p)
    p.add_argument("--no-overlap", action="store_true", help="Don't overlap communication and computation")
    p.add_argument("--prefix", default="", help="prefix for paraview files")
    p.add_argument("--paraview", action="store_true", help="dump paraview files")
    p.add_argument("--iters", "-n", type=int, default=30, help="number of iterations")
    p.add_argument("--period", "-q", type=int, default=-1, help="iterations between checkpoints")
    p.add_argument("--no-weak-scale", action="store_true", help="use x y z as the global size directly")
    p.add_argument("--kernel-impl", choices=["cuda", "torch"], default="cuda",
                   help="hand-written CUDA kernels (fast) or plain tensor code")
    p.add_argument("--pallas-path", choices=["auto", "wrap", "slab", "shell", "wavefront"], default="auto",
                   help="route of the cuda engine (auto: wrap on one subdomain, else the "
                        "temporally blocked wavefront when its depth is >= 2, else slab on "
                        "even sizes, else shell)")
    p.add_argument("--halo-multiplier", type=int, default=1,
                   help="exchange k*radius-wide shells every k steps (torch engine; the "
                        "wavefront route sets its own)")
    p.add_argument("--temporal-k", default="auto",
                   help="levels per kernel pass on the wrap/wavefront routes (int or auto)")
    _common.add_device_flags(p)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed loop to DIR (the nsys analog)")
    _common.add_exchange_route_flag(p)
    _common.add_kernel_axis_flags(p)
    _common.add_numerics_flag(p)
    _common.add_telemetry_flags(p)
    _common.add_profile_flags(p)
    _common.add_checkpoint_flags(p)
    _common.add_tune_flags(p)
    p.add_argument("x", type=int, nargs="?", default=512)
    p.add_argument("y", type=int, nargs="?", default=512)
    p.add_argument("z", type=int, nargs="?", default=512)
    args = p.parse_args(argv)
    _common.tune_begin(args)
    try:
        return _run(args)
    finally:
        # the tune overrides are process-global: an in-process caller's next
        # run must not inherit this one's --no-tune / --tune-cache
        _common.tune_end(args)


def _tune(args, x, y, z, n_sub, strategy) -> None:
    """``--tune``: search this workload before the model is built (the JAX
    driver's gating): the route the model will take on the cuda engine
    (``wrap`` needs one subdomain), the exchange route on the torch engine
    (checked before the probe domain allocates, so a warm cache does no
    device work); the slab and shell routes have no tunable axis."""
    from stencil_tpu_torch import tune
    from stencil_tpu_torch.tune import runners

    single = n_sub == 1
    if args.kernel_impl == "cuda" and args.pallas_path in ("auto", "wrap", "wavefront"):
        if args.pallas_path == "wrap" or (args.pallas_path == "auto" and single):
            if not single:
                print("--tune skipped: pallas_path='wrap' needs a single subdomain (the model build will "
                      "reject it too)", file=sys.stderr)
                return
            report = runners.autotune_jacobi_wrap(x, y, z, device=args.device)
        else:
            report = runners.autotune_jacobi_wavefront(x, y, z, device=args.device, subdomains=n_sub,
                                                       partition=args.partition, strategy=strategy)
        _common.tune_report_stderr(report)
    elif args.kernel_impl == "torch":
        from stencil_tpu_torch.core.radius import Radius
        from stencil_tpu_torch.domain import DistributedDomain

        probe = DistributedDomain(x, y, z, device=args.device)
        r = Radius.constant(0)
        r.set_face(1)  # the Jacobi radius (jacobi3d.cu:205-214)
        probe.set_radius(r)
        probe.set_placement(strategy)
        probe.set_subdomains(n_sub)
        if args.partition is not None:
            probe.set_partition(*args.partition)
        probe.add_data("temp")
        if args.halo_multiplier != 1:
            probe.set_halo_multiplier(args.halo_multiplier)
        if tune.best_config(probe.tune_key("exchange")) is not None:
            print("tune[exchange]: source=cache (warm; zero trials)", file=sys.stderr)
        else:
            probe.realize()
            _common.tune_report_stderr(runners.autotune_exchange(probe))
        del probe


def _run(args) -> int:
    _common.telemetry_begin(args)
    period = args.period if args.period > 0 else max(args.iters // 10, 1)

    part = args.partition or (1, 1, 1)
    n_sub = part[0] * part[1] * part[2]
    if args.no_weak_scale:
        x, y, z = args.x, args.y, args.z
    else:
        x, y, z = (weak_scaled_size(v, n_sub) for v in (args.x, args.y, args.z))

    methods = _common.parse_methods(args)
    strategy = _common.parse_strategy(args)
    if args.tune:
        _tune(args, x, y, z, n_sub, strategy)
    model = Jacobi3D(
        x, y, z,
        overlap=not args.no_overlap,
        strategy=strategy,
        methods=methods,
        subdomains=n_sub,
        kernel_impl=args.kernel_impl,
        pallas_path=args.pallas_path,
        temporal_k=args.temporal_k if args.temporal_k == "auto" else int(args.temporal_k),
        compute_unit=args.compute_unit,
        mxu_input=args.mxu_input,
        storage_dtype=args.storage_dtype,
        device=args.device,
    )
    if args.partition is not None:
        model.dd.set_partition(*args.partition)
    if args.halo_multiplier != 1:
        model.dd.set_halo_multiplier(args.halo_multiplier)
    # the route reaches the torch engine and the stale-shell readback; the
    # cuda routes exchange without one, as the JAX package's do
    model.dd.set_exchange_route(args.exchange_route)
    model.realize()
    _common.apply_numerics(args, model.dd)
    # one macro step per timed sample: the torch engine under a halo
    # multiplier steps in whole macros, and a wavefront call of fewer than m
    # iterations is a whole shallower pass
    macro = model.dd.halo_multiplier()

    iter_time = Statistics()
    prof = _common.profile_capture_for(args)
    dispatch_index = [0]

    def timed_iter():
        # the cadence capture around the sample (a captured sample carries
        # the profiler's cost; the trimean absorbs it)
        idx = dispatch_index[0]
        dispatch_index[0] += 1
        with prof.maybe(idx) if prof is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            model.step(macro)
            model.block_until_ready()
            iter_time.insert((time.perf_counter() - t0) / macro)

    sup = _common.supervisor_for(
        args, model.dd, label="jacobi",
        run_state=lambda: {"model": "jacobi3d", "kernel_impl": args.kernel_impl,
                           "compute_unit": model._compute_unit, "iters": args.iters},
        on_mesh_change=model.rebuild_after_reshard)
    rc = 0
    if sup is not None:
        # no warm-up call (module docstring): the first sample builds
        def advance(n):
            for _ in range(n):
                timed_iter()

        def on_chunk(done, n):
            it = done - n  # the sample just completed (chunk=1), as below
            if args.paraview and it % period == 0:
                write_paraview(model.dd, f"{args.prefix}jacobi3d_{it}")

        with telemetry.trace(args.trace):
            out = sup.run(args.iters, advance, start_step=None if args.resume else 0, chunk=1, on_chunk=on_chunk)
        rc = out.exit_code
    else:
        model.step(macro)  # first call builds the kernels; untimed
        model.block_until_ready()
        with telemetry.trace(args.trace):
            for it in range(args.iters):
                timed_iter()
                if args.paraview and it % period == 0:
                    write_paraview(model.dd, f"{args.prefix}jacobi3d_{it}")
    if args.paraview:
        write_paraview(model.dd, f"{args.prefix}jacobi3d_final")

    if iter_time.count() > 0:
        print(
            f"jacobi3d,{_common.method_str(args)},1,1,"
            f"{x},{y},{z},{iter_time.min()},{iter_time.trimean()}"
        )
    _common.telemetry_end(args, profile_capture=prof, device=model.dd.device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
