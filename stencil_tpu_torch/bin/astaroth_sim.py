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
(subdomains on the one device) and ``--device``.  Each timed sample is one
iteration and a device synchronize, after one untimed warm-up step
(``realize()`` builds the kernels).

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
"""

from __future__ import annotations

import argparse
import sys
import time

from stencil_tpu_torch.bin.jacobi3d import (
    _METHOD_FLAGS, _add_exchange_route_flag, _add_kernel_axis_flags, _parse_partition,
)
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.utils.config import PlacementStrategy
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
    p.add_argument("--partition", type=_parse_partition, default=None,
                   help="subdomain grid px,py,pz on the one device (default 1,1,1)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    _add_exchange_route_flag(p)
    _add_kernel_axis_flags(p)
    p.add_argument("--stream-overlap", default="auto", choices=("auto", "off", "split"),
                   help="stream-engine overlap schedule: off = exchange, then the pass; split = the "
                        "interior pass beside the exchange on a second CUDA stream, then six narrow "
                        "band passes (bitwise the same; auto = off)")
    p.add_argument("--stream-halo", default="auto", choices=("auto", "array", "fused"),
                   help="stream-engine halo consumption: array = unpack the received shell into the "
                        "stacks; fused = the passes read it from the packed messages (bitwise the same; "
                        "needs --exchange-route yzpack_*; auto = array)")
    args = p.parse_args(argv)

    kernel_impl = args.kernel_impl
    if args.no_overlap and kernel_impl == "cuda":
        print("--no-overlap forces --kernel-impl torch", file=sys.stderr)
        kernel_impl = "torch"
    part = args.partition or (1, 1, 1)
    # the nearest size each grid axis divides, at least the radius-3 shell
    # per subdomain, as the JAX driver's fit_to_mesh does (it keeps
    # weak-scaled runs comparable; the domain itself takes uneven sizes)
    x, y, z = (max(round(v / d), 3) * d for v, d in zip((args.x, args.y, args.z), part))
    print(f"domain: {x},{y},{z} over {part[0]}x{part[1]}x{part[2]} subdomains", file=sys.stderr)
    sim = AstarothSim(
        x, y, z,
        num_quantities=args.quantities,
        overlap=not args.no_overlap,
        strategy=PlacementStrategy.Trivial if args.trivial else PlacementStrategy.NodeAware,
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

    iter_time = Statistics()
    sim.step()  # warm-up, untimed
    sim.block_until_ready()
    for it in range(args.iters):
        t0 = time.perf_counter()
        sim.step()
        sim.block_until_ready()
        iter_time.insert(time.perf_counter() - t0)
        print(f"iter {it}: {iter_time.max():e}s", file=sys.stderr)

    # the reference's method string (jacobi3d.cu:355-374); the flags share
    # the jacobi3d driver's destinations
    names = [name for flag, _, name in _METHOD_FLAGS if getattr(args, flag)] or ["ppermute"]
    if iter_time.count() > 0:
        print(f"astaroth,{'/'.join(names)},1,1,{x},{y},{z},{iter_time.min()},{iter_time.trimean()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
