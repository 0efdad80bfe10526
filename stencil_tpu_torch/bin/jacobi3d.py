"""jacobi3d driver on PyTorch + CUDA.

Counterpart of ``stencil_tpu/bin/jacobi3d.py`` (reference bin/jacobi3d.cu):
the same CLI shape (positional x y z base size, weak-scaled by
numSubdoms^(1/3) unless --no-weak-scale; --no-overlap; --trivial; the method
flags) and the same CSV row

    jacobi3d,<methods>,ranks,devCount,x,y,z,min(s),trimean(s)

(jacobi3d.cu:378-379), plus ``--partition px,py,pz`` (subdomains on the one
device), ``--device``, and the JAX driver's ``--pallas-path``,
``--halo-multiplier``, ``--temporal-k``, ``--exchange-route`` and the kernel
axes ``--compute-unit``, ``--mxu-input`` and ``--storage-dtype``.  Each timed
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

An uneven size (one the grid does not divide, given with --no-weak-scale)
pads every subdomain to ceil(size / grid) cells per axis, as the domain does.
"""

from __future__ import annotations

import argparse
import sys
import time

from stencil_tpu_torch.models.jacobi import Jacobi3D, weak_scaled_size
from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES
from stencil_tpu_torch.ops.jacobi_kernels import COMPUTE_UNITS, MXU_INPUTS, STORAGE_DTYPES
from stencil_tpu_torch.utils.config import MethodFlags, PlacementStrategy
from stencil_tpu_torch.utils.statistics import Statistics

#: (flag, MethodFlags member, CSV name) — the reference's transport flags
#: (jacobi3d.cu:111-120); all map onto the one on-device exchange
_METHOD_FLAGS = (
    ("staged", MethodFlags.CudaMpi, "staged"),
    ("cuda_aware_mpi", MethodFlags.CudaAwareMpi, "cuda-aware"),
    ("colo", MethodFlags.CudaMpiColocated, "colo"),
    ("peer", MethodFlags.CudaMemcpyPeer, "peer"),
    ("kernel", MethodFlags.CudaKernel, "kernel"),
)


def _add_exchange_route_flag(p: argparse.ArgumentParser) -> None:
    """``--exchange-route`` (``stencil_tpu/bin/_common.py:172-193``): pin the
    halo exchange's y/z-sweep route; ``auto`` (default) resolves ``direct``."""
    p.add_argument("--exchange-route", default="auto", choices=("auto",) + EXCHANGE_ROUTES,
                   help="y/z-sweep exchange route: direct slabs, or the z shell (zpack_*) or y and "
                        "z shells (yzpack_*) as packed buffers; *_pallas packs with the CUDA kernels")


def _add_kernel_axis_flags(p: argparse.ArgumentParser) -> None:
    """``--compute-unit`` / ``--mxu-input`` / ``--storage-dtype``
    (``stencil_tpu/bin/_common.py:196-230``): the Jacobi kernels' axes;
    ``auto`` (default) resolves the static ``vpu`` / ``f32`` / ``native``,
    and a structural guard (a route or engine without the form) degrades
    with a warning."""
    p.add_argument("--compute-unit", default="auto", choices=("auto",) + COMPUTE_UNITS,
                   help="vpu: the six-neighbour fold; mxu / mxu_band: the in-plane sums as a "
                        "band contraction on the tensor cores (wrap and wavefront routes)")
    p.add_argument("--mxu-input", default="auto", choices=("auto",) + MXU_INPUTS,
                   help="the contraction's operands: f32 (three exact TF32 pieces) or bf16 "
                        "(rounded once a read); inert under vpu")
    p.add_argument("--storage-dtype", default="auto", choices=("auto",) + STORAGE_DTYPES,
                   help="native, or bf16: the field stored as bfloat16, the kernels "
                        "accumulating at f32 and rounding once a pass")


def _parse_partition(text: str):
    parts = [int(v) for v in text.split(",")]
    if len(parts) != 3 or min(parts) < 1:
        raise argparse.ArgumentTypeError(f"--partition wants px,py,pz, got {text!r}")
    return tuple(parts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("jacobi3d")
    p.add_argument("--staged", action="store_true", help="Enable RemoteSender/Recver")
    p.add_argument("--cuda-aware-mpi", action="store_true", help="Enable CudaAwareMpiSender/Recver")
    p.add_argument("--colo", action="store_true", help="Enable ColocatedHaloSender/Recver")
    p.add_argument("--peer", action="store_true", help="Enable PeerAccessSender")
    p.add_argument("--kernel", action="store_true", help="Enable PeerCopySender")
    p.add_argument("--trivial", action="store_true", help="Skip node-aware placement")
    p.add_argument("--no-overlap", action="store_true", help="Don't overlap communication and computation")
    p.add_argument("--iters", "-n", type=int, default=30, help="number of iterations")
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
    p.add_argument("--partition", type=_parse_partition, default=None,
                   help="subdomain grid px,py,pz on the one device (default 1,1,1)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    _add_exchange_route_flag(p)
    _add_kernel_axis_flags(p)
    p.add_argument("x", type=int, nargs="?", default=512)
    p.add_argument("y", type=int, nargs="?", default=512)
    p.add_argument("z", type=int, nargs="?", default=512)
    args = p.parse_args(argv)

    part = args.partition or (1, 1, 1)
    n_sub = part[0] * part[1] * part[2]
    if args.no_weak_scale:
        x, y, z = args.x, args.y, args.z
    else:
        x, y, z = (weak_scaled_size(v, n_sub) for v in (args.x, args.y, args.z))

    methods = MethodFlags.Non
    for flag, member, _ in _METHOD_FLAGS:
        if getattr(args, flag):
            methods |= member
    if methods == MethodFlags.Non:
        methods = MethodFlags.All
    model = Jacobi3D(
        x, y, z,
        overlap=not args.no_overlap,
        strategy=PlacementStrategy.Trivial if args.trivial else PlacementStrategy.NodeAware,
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
    # one macro step per timed sample: the torch engine under a halo
    # multiplier steps in whole macros, and a wavefront call of fewer than m
    # iterations is a whole shallower pass
    macro = model.dd.halo_multiplier()

    iter_time = Statistics()
    model.step(macro)  # first call builds the kernels; untimed
    model.block_until_ready()
    for _ in range(args.iters):
        t0 = time.perf_counter()
        model.step(macro)
        model.block_until_ready()
        iter_time.insert((time.perf_counter() - t0) / macro)

    names = [name for flag, _, name in _METHOD_FLAGS if getattr(args, flag)] or ["ppermute"]
    if iter_time.count() > 0:
        print(
            f"jacobi3d,{'/'.join(names)},1,1,"
            f"{x},{y},{z},{iter_time.min()},{iter_time.trimean()}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
