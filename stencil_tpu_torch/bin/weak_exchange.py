"""weak-exchange on PyTorch + CUDA: weak.cu's exchange loop under one wall
clock.

Counterpart of ``stencil_tpu/bin/weak_exchange.py`` (reference
bin/weak_exchange.cu:125-179): one elapsed wall time over all iterations,
after one untimed warm-up exchange, in place of the per-phase timers:

    weak,<methods>,x,y,z,s,MPI(B),Colocated(B),cudaMemcpyPeer(B),direct(B),
    iters,gpus,nodes,ranks,elapsed

``--partition px,py,pz`` places the subdomains on the one card and
weak-scales by their count, as ``bin/weak.py`` does.

    python -m stencil_tpu_torch.bin.weak_exchange 256 256 256 30 --partition 2,2,2
"""

from __future__ import annotations

import sys
import time

from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.bin.weak import build_domain, build_parser, csv_size
from stencil_tpu_torch.utils.config import MethodFlags


def main(argv=None) -> int:
    args = build_parser("weak-exchange", overlap_flags=False).parse_args(argv)
    args.trivial = args.naive
    _common.telemetry_begin(args)
    x, y, z = csv_size(args)
    dd = build_domain(x, y, z, args, stats=False)

    # one warm call, so kernel loading stays out of the wall clock
    dd.exchange()
    dd.swap()
    dd.block_until_ready()

    t0 = time.perf_counter()
    for _ in range(args.n_iters):
        dd.exchange()
        dd.swap()
    dd.block_until_ready()
    elapsed = time.perf_counter() - t0

    ranks, dev_count = _common.ranks_and_devcount()
    print(
        f"weak,{_common.method_str(args)},{x},{y},{z},{x * y * z},"
        f"{dd.exchange_bytes_for_method(MethodFlags.CudaMpi)},0,0,0,"
        f"{args.n_iters},{ranks * dev_count},{ranks},{ranks},{elapsed:e}"
    )
    _common.telemetry_end(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
