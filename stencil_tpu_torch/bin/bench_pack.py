"""bench-pack on PyTorch + CUDA: pack/unpack kernel bandwidth.

Counterpart of ``stencil_tpu/bin/bench_pack.py`` (reference
bin/bench_pack.cu:91-107): for a ``--size``^3 float32 quantity with radius 3,
time packing and unpacking the x, y and z face slabs, and print one line a
face,

    <ext> <dir> <bytes> <packTime> <unpackTime> <GB/s>GB/s

(seconds per call, GB/s of the faster of the two).  ``--backend pallas``
runs the slab kernels (``make_pack_fn_pallas`` / ``make_unpack_fn_pallas``,
one ``pallas_pack_slab`` / ``pallas_unpack_slab`` launch a call), ``xla``
(default) the uint8 buffer of ``make_pack_fn`` / ``make_unpack_fn`` in plain
torch.  Each call is timed on the host clock up to a device synchronize.
With ``--inner k > 1`` it prints ``<ext> <dir> <bytes> roundtrip <s> <GB/s>``
instead: the best of ``--iters`` samples (at least 3), each ``k`` pack and
unpack round trips between two CUDA events (the host clock on the CPU), per
round trip.

    python -m stencil_tpu_torch.bin.bench_pack --backend pallas
    python -m stencil_tpu_torch.bin.bench_pack --backend pallas --inner 8

``--device cpu`` runs the plain versions on the CPU (what ``--interpret``
does in the JAX package's bench-pack); ``--metrics-out PATH`` writes the
telemetry snapshot at exit.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.geometry import LocalSpec
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.device import resolve_device, sync
from stencil_tpu_torch.ops.pack import make_pack_fn, make_pack_fn_pallas, make_unpack_fn, make_unpack_fn_pallas

FACES = (Dim3(1, 0, 0), Dim3(0, 1, 0), Dim3(0, 0, 1))


def _setup(sz: Dim3, direction: Dim3, backend: str, device: torch.device):
    """A seeded raw block and the (pack, unpack) pair of ``backend`` for one
    direction, both taking and returning the block: returns (plan bytes,
    block, pack, unpack)."""
    spec = LocalSpec.make(sz, Dim3(0, 0, 0), Radius.constant(3))
    raw = tuple(spec.raw_size())
    block = torch.from_numpy(np.random.default_rng(0).random(raw).astype(np.float32)).to(device)
    if backend == "pallas":
        pack, plan = make_pack_fn_pallas(spec, [direction], torch.float32)
        unpack, _ = make_unpack_fn_pallas(spec, [direction], torch.float32)
    else:
        pack_x, plan = make_pack_fn(spec, [direction], [torch.float32])
        unpack_x, _ = make_unpack_fn(spec, [direction], [torch.float32])

        def pack(b):
            return pack_x([b])

        def unpack(b, buf):
            return unpack_x(buf, [b])[0]

    return plan.size, block, pack, unpack


def bench(sz: Dim3, direction: Dim3, n_iters: int, backend: str, device: torch.device):
    """Returns (bytes, pack_s_per_call, unpack_s_per_call): one untimed pack
    makes the message, one untimed pack and unpack warm up, then ``n_iters``
    timed calls of each."""
    nbytes, block, pack, unpack = _setup(sz, direction, backend, device)
    packed = pack(block)

    def timed(fn) -> float:
        fn()  # warm-up
        sync(device)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            fn()
            sync(device)
        return (time.perf_counter() - t0) / n_iters

    pack_t = timed(lambda: pack(block))
    unpack_t = timed(lambda: unpack(block, packed))
    return nbytes, pack_t, unpack_t


def bench_roundtrip(sz: Dim3, direction: Dim3, n_samples: int, inner: int, backend: str, device: torch.device):
    """pack -> unpack round trips, ``inner`` per timed sample; one untimed
    sample warms up.  Returns (bytes, best seconds per round trip)."""
    nbytes, block, pack, unpack = _setup(sz, direction, backend, device)

    def run():
        for _ in range(inner):
            unpack(block, pack(block))

    run()
    sync(device)
    samples = []
    for _ in range(n_samples):
        if device.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) * 1e-3 / inner)
        else:
            t0 = time.perf_counter()
            run()
            samples.append((time.perf_counter() - t0) / inner)
    return nbytes, min(samples)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench-pack")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--backend", choices=["xla", "pallas"], default="xla",
                   help="pallas: the slab kernels; xla: the uint8 buffer in plain torch")
    p.add_argument("--inner", type=int, default=1,
                   help="pack+unpack round trips per timed sample (prints roundtrip time instead of "
                        "pack/unpack)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    _common.add_telemetry_flags(p)
    args = p.parse_args(argv)
    _common.telemetry_begin(args)
    device = resolve_device(args.device)

    ext = Dim3(args.size, args.size, args.size)
    if args.inner > 1:
        for d in FACES:
            nbytes, rt_t = bench_roundtrip(ext, d, max(args.iters, 3), args.inner, args.backend, device)
            gbps = 2 * nbytes / rt_t / 1e9  # payload packed + unpacked
            print(f"{ext} {d} {nbytes} roundtrip {rt_t:g} {gbps:.2f}GB/s")
        _common.telemetry_end(args)
        return 0
    for d in FACES:
        nbytes, pack_t, unpack_t = bench(ext, d, args.iters, args.backend, device)
        gbps = nbytes / min(pack_t, unpack_t) / 1e9
        print(f"{ext} {d} {nbytes} {pack_t:g} {unpack_t:g} {gbps:.2f}GB/s")
    _common.telemetry_end(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
