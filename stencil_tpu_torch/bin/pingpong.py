"""pingpong on PyTorch + CUDA: round-trip time per message size.

Counterpart of ``stencil_tpu/bin/pingpong.py`` (reference bin/pingpong.cu:
56-99): for each pair of neighbouring endpoints ``(i, i + 1)``, the time of a
there-and-back transfer (``b.copy_(a)``, then ``a.copy_(b)``: a peer copy
between cards, a device-to-device copy on one) for message sizes 2^min ..
2^max bytes, each the mean of ``--iters`` round trips between two device
synchronizes.  With one card the pair is the card with itself (two buffers
on it), as the JAX package wraps to self on one device.  One row a pair,
named by endpoint index, one column a size:

    <src>-<dst> <t(2^min)> <t(2^min+1)> ...

    python -m stencil_tpu_torch.bin.pingpong --min 0 --max 27
"""

from __future__ import annotations

import argparse
import sys
import time

from stencil_tpu_torch.bin import _common


def pingpong_times(eps, min_n: int, max_n: int, n_iters: int):
    """For each neighbouring pair of endpoints, seconds a round trip
    ``src -> dst -> src`` a message size."""
    n = len(eps)
    rows = []
    for pair in range(max(n - 1, 1)):
        src, dst = pair, (pair + 1) % n
        times = []
        for p in range(min_n, max_n + 1):
            there, (a, b) = _common.make_edge_transfer(eps, src, dst, max((1 << p) // 4, 1))

            def round_trip():
                there()
                a.copy_(b, non_blocking=True)

            round_trip()  # the first use of the buffers
            _common.sync_endpoints(eps)
            t0 = time.perf_counter()
            for _ in range(n_iters):
                round_trip()
            _common.sync_endpoints(eps)
            times.append((time.perf_counter() - t0) / n_iters)
        rows.append((f"{src}-{dst}", times))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser("pingpong")
    p.add_argument("ranks_per_node", type=int, nargs="?", default=1)
    p.add_argument("--min", type=int, default=0, help="log2 of smallest message")
    p.add_argument("--max", type=int, default=27, help="log2 of largest message")
    p.add_argument("--iters", type=int, default=30)
    _common.add_device_flags(p, partition=False)
    _common.add_telemetry_flags(p)
    args = p.parse_args(argv)
    _common.telemetry_begin(args)

    rows = pingpong_times(_common.endpoints(args.device), args.min, args.max, args.iters)
    for name, times in rows:
        print(name + " " + " ".join(f"{t:e}" for t in times))
    _common.telemetry_end(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
