"""astaroth-sim driver on PyTorch + CUDA: the Astaroth MHD proxy benchmark.

Counterpart of ``stencil_tpu/bin/astaroth_sim.py`` (reference
bin/astaroth_sim.cu): radius-3 26-direction halos, sin-wave init, the
6-point mean, ``--iters`` timed iterations (default 5, as astaroth_sim.cu:223
fixes), and one CSV row

    astaroth,<methods>,ranks,devCount,x,y,z,min(s),trimean(s)

with ``--quantities``, ``--kernel-impl`` (cuda | torch), ``--schedule``
(auto | per-step | wavefront), ``--exchange-route`` (auto | direct |
zpack_xla | zpack_pallas | yzpack_xla | yzpack_pallas), ``--stream-overlap``
(auto | off | split) and ``--stream-halo`` (auto | array | fused), the stream
engine's split schedule and fused halo (``stencil_tpu/bin/_common.py:247-277``),
the kernel axes ``--compute-unit`` (auto | vpu | mxu | mxu_band: the
in-plane taps contracted on the tensor cores, ``_kernel_mxu``),
``--mxu-input`` (auto | f32 | bf16: the contraction's operands) and
``--storage-dtype`` (native | bf16: the fields stored as bfloat16, the CUDA
kernels accumulating at f32),
the reference's method flags, ``--no-overlap`` and ``--trivial``, plus
``--partition px,py,pz``
(subdomains on the one device), ``--device``, ``--numerics-every`` and
``--metrics-out``, and the run supervisor's ``--checkpoint-dir``,
``--checkpoint-every``, ``--checkpoint-keep`` and ``--resume``, and the
autotuner's ``--tune`` / ``--no-tune`` / ``--tune-cache`` (``tune/``; the
JAX driver's gating, ``stencil_tpu/bin/astaroth_sim.py:100-115``: ``--tune``
on the cuda engine with ``--schedule auto`` searches the stream plan on a
throwaway model first, zero trials when the cache is warm).  Each timed
sample is one iteration and a device synchronize, after one untimed warm-up
step (``realize()`` builds the kernels); a supervised run makes no warm-up
step, so that killed and resumed runs stay bitwise comparable, and exits 75
when preempted.

    python -m stencil_tpu_torch.bin.astaroth_sim --quantities 8 --schedule wavefront --iters 24
    python -m stencil_tpu_torch.bin.astaroth_sim --quantities 8 --partition 2,2,2 \
        --schedule per-step --exchange-route yzpack_pallas --iters 24
    python -m stencil_tpu_torch.bin.astaroth_sim --quantities 8 --partition 2,2,2 \
        --schedule per-step --exchange-route yzpack_pallas --stream-halo fused --iters 24
    python -m stencil_tpu_torch.bin.astaroth_sim --quantities 8 --partition 2,2,2 \
        --stream-overlap split --iters 24
    python -m stencil_tpu_torch.bin.astaroth_sim --quantities 8 --schedule wavefront \
        --storage-dtype bf16 --iters 24
    python -m stencil_tpu_torch.bin.astaroth_sim --quantities 8 --schedule wavefront \
        --compute-unit mxu_band --mxu-input bf16 --iters 24
    python -m stencil_tpu_torch.bin.astaroth_sim --quantities 8 --partition 2,2,2 --tune --iters 24
"""

from __future__ import annotations

import argparse
import sys
import time

from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.utils.statistics import Statistics


def main(argv=None) -> int:
    p = argparse.ArgumentParser("astaroth-sim")
    # cxxopts options (astaroth_sim.cu:89-110): x/y/z size, transport flags
    p.add_argument("--x", type=int, default=512)
    p.add_argument("--y", type=int, default=512)
    p.add_argument("--z", type=int, default=512)
    p.add_argument("--iters", type=int, default=5)  # astaroth_sim.cu:223 fixed 5
    p.add_argument("--quantities", type=int, default=1, help="exchanged fields (real Astaroth: 8)")
    p.add_argument("--remote", dest="staged", action="store_true")
    p.add_argument("--cuda-aware-mpi", dest="cuda_aware_mpi", action="store_true")
    p.add_argument("--colocated", dest="colo", action="store_true")
    p.add_argument("--peer-copy", dest="peer", action="store_true")
    p.add_argument("--kernel", action="store_true")
    p.add_argument("--no-overlap", action="store_true")
    p.add_argument("--trivial", action="store_true")
    p.add_argument("--kernel-impl", choices=["cuda", "torch"], default="cuda",
                   help="hand-written CUDA stream kernels (fast) or plain tensor code")
    p.add_argument("--schedule", choices=["auto", "per-step", "wavefront"], default="auto",
                   help="auto: wrap on one subdomain, else the m <= 3-level wavefront; per-step: "
                        "one exchange per iteration; wavefront: force the temporal schedule")
    _common.add_device_flags(p)
    _common.add_exchange_route_flag(p)
    _common.add_kernel_axis_flags(p)
    p.add_argument("--stream-overlap", default="auto", choices=("auto", "off", "split"),
                   help="stream-engine overlap schedule: off = exchange, then the pass; split = the "
                        "interior pass beside the exchange on a second CUDA stream, then six narrow "
                        "band passes (bitwise the same; auto = off)")
    p.add_argument("--stream-halo", default="auto", choices=("auto", "array", "fused"),
                   help="stream-engine halo consumption: array = unpack the received shell into the "
                        "stacks; fused = the passes read it from the packed messages (bitwise the same; "
                        "needs --exchange-route yzpack_*; auto = array)")
    _common.add_numerics_flag(p)
    _common.add_telemetry_flags(p)
    _common.add_checkpoint_flags(p)
    _common.add_tune_flags(p)
    args = p.parse_args(argv)
    _common.tune_begin(args)
    try:
        return _run(args)
    finally:
        # the tune overrides are process-global: an in-process caller's next
        # run must not inherit this one's --no-tune / --tune-cache
        _common.tune_end(args)


def _run(args) -> int:
    _common.telemetry_begin(args)

    kernel_impl = args.kernel_impl
    if args.no_overlap and kernel_impl == "cuda":
        print("--no-overlap forces --kernel-impl torch", file=sys.stderr)
        kernel_impl = "torch"
    part = args.partition or (1, 1, 1)
    # the nearest size each grid axis divides, at least the radius-3 shell
    # per subdomain (it keeps weak-scaled runs comparable; the domain itself
    # takes uneven sizes)
    x, y, z = _common.fit_to_mesh(args.x, args.y, args.z, Radius.constant(3), partition=part)
    print(f"domain: {x},{y},{z} over {part[0]}x{part[1]}x{part[2]} subdomains", file=sys.stderr)
    strategy = _common.parse_strategy(args)
    if args.tune and kernel_impl == "cuda" and args.schedule != "auto":
        # the stream plan consults the tuned config on the unconstrained
        # auto path only (a forced route is an explicit request)
        print(f"--tune has no effect with --schedule {args.schedule} (forced route; tuned plans apply to "
              "schedule=auto only)", file=sys.stderr)
    if args.tune and kernel_impl == "cuda" and args.schedule == "auto":
        # tune the stream plan on a throwaway model whose trials do not
        # advance its state; the cache is checked before it realizes (tune_key
        # works before realize), so a warm --tune run does no device work
        from stencil_tpu_torch import tune
        from stencil_tpu_torch.tune import runners

        tuner = AstarothSim(x, y, z, num_quantities=args.quantities, strategy=strategy,
                            subdomains=part[0] * part[1] * part[2], kernel_impl="cuda", schedule="auto",
                            exchange_route=args.exchange_route, device=args.device)
        if args.partition is not None:
            tuner.dd.set_partition(*args.partition)
        if tune.best_config(tuner.dd.tune_key("stream")) is not None:
            print("tune[stream]: source=cache (warm; zero trials)", file=sys.stderr)
        else:
            tuner.realize()
            _common.tune_report_stderr(runners.autotune_stream(
                tuner.dd, tuner._kernel, x_radius=1, separable=True, mxu_kernel=tuner._kernel_mxu))
        del tuner
    sim = AstarothSim(
        x, y, z,
        num_quantities=args.quantities,
        overlap=not args.no_overlap,
        strategy=strategy,
        subdomains=part[0] * part[1] * part[2],
        kernel_impl=kernel_impl,
        schedule=args.schedule,
        exchange_route=args.exchange_route,
        stream_overlap=args.stream_overlap,
        stream_halo=args.stream_halo,
        compute_unit=args.compute_unit,
        mxu_input=args.mxu_input,
        storage_dtype=args.storage_dtype,
        device=args.device,
    )
    if args.partition is not None:
        sim.dd.set_partition(*args.partition)
    sim.realize()
    _common.apply_numerics(args, sim.dd)

    iter_time = Statistics()

    def timed_iter():
        t0 = time.perf_counter()
        sim.step()
        sim.block_until_ready()
        iter_time.insert(time.perf_counter() - t0)
        print(f"iter {iter_time.count() - 1}: {iter_time.max():e}s", file=sys.stderr)

    sup = _common.supervisor_for(args, sim.dd, label="astaroth",
                                 run_state=lambda: {"model": "astaroth", "quantities": args.quantities},
                                 on_mesh_change=sim.rebuild_after_reshard)
    rc = 0
    if sup is not None:
        def advance(n):
            for _ in range(n):
                timed_iter()

        rc = sup.run(args.iters, advance, start_step=None if args.resume else 0, chunk=1).exit_code
    else:
        sim.step()  # warm-up, untimed
        sim.block_until_ready()
        for _ in range(args.iters):
            timed_iter()

    # the reference's method string (jacobi3d.cu:355-374); the flags share
    # the jacobi3d driver's destinations
    if iter_time.count() > 0:
        print(f"astaroth,{_common.method_str(args)},1,1,{x},{y},{z},{iter_time.min()},{iter_time.trimean()}")
    _common.telemetry_end(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
