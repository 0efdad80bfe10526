"""bench-alltoallv on PyTorch + CUDA: transfer bandwidth under five traffic
matrices.

Counterpart of ``stencil_tpu/bin/bench_alltoallv.py`` (reference
bin/bench_alltoallv.cu:139-187): a stencil halo matrix, all-to-all 8 MiB,
all-to-all 1 GiB, block-local 1 GiB, and local 1 GiB with remote 100 M, each
run pair by pair (``measure_edge``: the sum of the pairs' times) and all at
once (``measure_matrix_concurrent``: every pair's copy on a CUDA stream of its
own, enqueued together, then one synchronize).  For the stencil matrix it
prints the per-pair ``bw`` and ``time`` matrices (bench_alltoallv.cu:101-113).
The endpoints are the visible cards.  Every matrix is zero on its diagonal,
so on one card (one endpoint) no pair moves bytes and every total prints
``n/a``, as does block-local 1 GiB on two endpoints (each half is one
endpoint); a total is never printed as 0 s.  ``--scale`` scales every size.

    python -m stencil_tpu_torch.bin.bench_alltoallv --scale 0.1
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from stencil_tpu_torch.bin import _common


def measure_pairs(eps, comm: np.ndarray, n_iters: int):
    """Each pair's transfer time for a bytes matrix, one pair at a time
    (``_common.matrix_pairs``); returns (times, total), the total None when
    no pair moves bytes."""
    times = np.zeros_like(comm, dtype=float)
    pairs = _common.matrix_pairs(comm)
    for i, j, nbytes in pairs:
        times[i, j] = _common.measure_edge(eps, i, j, nbytes, n_iters)
    return times, (sum(times[i, j] for i, j, _ in pairs) if pairs else None)


def seconds(t) -> str:
    """A total as printed: ``n/a`` where no pair moved bytes, never 0."""
    return "n/a" if t is None else f"{t:e}"


def stencil_matrix(n: int, face: int, edge: int, corner: int) -> np.ndarray:
    """A halo traffic matrix: ``n`` endpoints as a 3D rank partition, each
    neighbour weighted by its direction class, periodic (the reference
    embeds a measured 6-GPU matrix, bench_alltoallv.cu:139-150; this makes
    the same structure for any n)."""
    from stencil_tpu_torch.core.dim3 import Dim3
    from stencil_tpu_torch.parallel.partition import RankPartition

    part = RankPartition(Dim3(64, 64, 64), n)
    dim = part.dim()
    comm = np.zeros((n, n))
    for a in range(n):
        ia = part.dimensionize(a)
        for b in range(n):
            if a == b:
                continue
            d = part.dimensionize(b) - ia
            # periodic wrap (partition.hpp:777-790)
            vals = []
            for ax in range(3):
                v = d[ax]
                if v != 0 and v == dim[ax] - 1:
                    v = -1
                if v != 0 and v == 1 - dim[ax]:
                    v = 1
                vals.append(v)
            d = Dim3(*vals)
            if d == Dim3(0, 0, 0) or d.any_gt(1) or d.any_lt(-1):
                continue
            nz = sum(1 for v in (d.x, d.y, d.z) if v != 0)
            comm[a, b] = {1: face, 2: edge, 3: corner}[nz]
    return comm


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench-alltoallv")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--scale", type=float, default=1.0, help="scale all matrix sizes")
    _common.add_device_flags(p, partition=False)
    _common.add_telemetry_flags(p)
    args = p.parse_args(argv)
    _common.telemetry_begin(args)
    run(_common.endpoints(args.device), args.iters, args.scale)
    _common.telemetry_end(args)
    return 0


def run(eps, n_iters: int, scale: float) -> None:
    """Print the five matrices' report over the endpoints ``eps``."""
    n = len(eps)
    MiB = int(1024 * 1024 * scale)
    GiB = int(1024 * 1024 * 1024 * scale)

    # 1) the stencil matrix, with the per-pair bw and time
    comm = stencil_matrix(n, face=8 * MiB, edge=MiB, corner=MiB // 4)
    times, total = measure_pairs(eps, comm, n_iters)
    print("bw")
    for i in range(n):
        print(" ".join(f"{(comm[i, j] / times[i, j]) if times[i, j] else 0:.4e}" for j in range(n)))
    print("time")
    for i in range(n):
        print(" ".join(f"{times[i, j]:.4e}" for j in range(n)))
    print("stencil")
    print(seconds(total))
    # every pair at once (the reference's batch start, bench_alltoallv.cu:
    # 139-168); the sum above is the uncontended baseline
    print("stencil concurrent")
    print(seconds(_common.measure_matrix_concurrent(eps, comm, n_iters)))

    # 2-5) the totals alone (bench_alltoallv.cu:173-187)
    ones = np.ones((n, n)) - np.eye(n)
    local = np.zeros((n, n))
    half = max(n // 2, 1)
    local[:half, :half] = 1
    local[half:, half:] = 1
    np.fill_diagonal(local, 0)
    remote = (ones - local).clip(0)
    for name, m in [
        ("All-to-all 8MiB", ones * 8 * MiB),
        ("All-to-all 1GiB", ones * GiB / max(n - 1, 1)),
        ("Local 1GiB", local * GiB / max(half, 1)),
        ("Local 1GiB Remote 100M", local * GiB / max(half, 1) + remote * 100 * MiB // 8),
    ]:
        _, total = measure_pairs(eps, m, n_iters)
        print(name)
        print(seconds(total))
        print(f"{name} concurrent")
        print(seconds(_common.measure_matrix_concurrent(eps, m.astype(np.int64), n_iters)))


if __name__ == "__main__":
    sys.exit(main())
