"""measure-buf-exchange on PyTorch + CUDA: a controller that sizes each
pair's transfer to take the same time.

Counterpart of ``stencil_tpu/bin/measure_buf_exchange.py`` (reference
bin/measure_buf_exchange.cu:32,189-223): find per-pair message sizes that
make every endpoint-to-endpoint copy take the target time (4 ms), by a
damped multiplicative step on the sizes, up to ``--iters`` times.  Each
iteration prints the size matrix ``x`` (MiB), the measured times ``y``, the
step ``dx`` (measure_buf_exchange.cu:91-96,180-185,209-214) and
``y_concurrent``, the time of all pairs at once (``measure_matrix_concurrent``);
then the final sizes.  The endpoints are the visible cards; one card is
paired with itself (a device-to-device copy), and ``--max-mib`` caps a
pair (256 MiB: a copy on one card would otherwise grow to GiBs before it
took 4 ms).

    python -m stencil_tpu_torch.bin.measure_buf_exchange --iters 5
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from stencil_tpu_torch.bin import _common

MiB = 1024 * 1024


def print_mat(label: str, m: np.ndarray, fmt) -> None:
    print(label)
    for i in range(m.shape[0]):
        print(" ".join(fmt(m[i, j]) for j in range(m.shape[1])))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("measure-buf-exchange")
    p.add_argument("--target", type=float, default=4e-3, help="target seconds per pair")
    p.add_argument("--iters", type=int, default=50, help="controller iterations")
    p.add_argument("--sub-iters", type=int, default=3, help="timing reps per measurement")
    p.add_argument("--init-mib", type=float, default=1.0, help="initial size (MiB)")
    p.add_argument("--max-mib", type=float, default=256.0,
                   help="per-pair size cap (MiB): a fast pair (a copy on one card, ~TB/s) would otherwise "
                        "need GB-scale buffers to reach the 4 ms target")
    p.add_argument("--tol", type=float, default=0.05, help="relative convergence tolerance")
    _common.add_device_flags(p, partition=False)
    _common.add_telemetry_flags(p)
    args = p.parse_args(argv)
    _common.telemetry_begin(args)

    eps = _common.endpoints(args.device)
    n = len(eps)
    x = np.zeros((n, n))  # per-pair sizes in bytes
    init_mib = min(args.init_mib, args.max_mib)  # the cap binds the start too
    for i in range(n):
        for j in range(n):
            if i != j or n == 1:
                x[i, j] = init_mib * MiB

    for _ in range(args.iters):
        y = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                if x[i, j] == 0:
                    continue
                y[i, j] = _common.measure_edge(eps, i, j, int(x[i, j]), args.sub_iters)
        # a multiplicative step toward the target time (the reference's
        # per-pair step, measure_buf_exchange.cu:189-223), damped
        active = x > 0
        ratio = np.ones_like(x)
        ratio[active] = args.target / y[active]
        ratio = ratio.clip(0.5, 2.0)
        dx = (x * ratio - x).astype(np.int64)
        print_mat("x", x / MiB, lambda v: f"{v:.2f}")
        print_mat("y", y, lambda v: f"{v:.4e}")
        print_mat("dx", dx, lambda v: f"{int(v)}")
        # all pairs at once at the current sizes (the reference's batch
        # start, measure_buf_exchange.cu:120-159)
        print(f"y_concurrent {_common.measure_matrix_concurrent(eps, x.astype(np.int64), args.sub_iters):.4e}")
        # a capped pair still under the target cannot converge: excused; an
        # over-target pair can always shrink, so it must meet the tolerance
        at_cap = (x >= args.max_mib * MiB) & (y < args.target)
        converged = np.all((np.abs(y[active] - args.target) <= args.tol * args.target) | at_cap[active])
        if converged:
            break
        x = (x + dx).clip(4096, args.max_mib * MiB) * active

    print("final x (MiB)")
    for i in range(n):
        print(" ".join(f"{x[i, j] / MiB:.2f}" for j in range(n)))
    _common.telemetry_end(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
