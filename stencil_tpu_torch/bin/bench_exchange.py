"""bench-exchange on PyTorch + CUDA: the exchange microbenchmark over five
radius shapes, and the A/B of every exchange route and axis.

Counterpart of ``stencil_tpu/bin/bench_exchange.py`` (reference
bin/bench_exchange.cu).  On a global extent (default 128³,
bench_exchange.cu:21,84; ``fit_to_mesh`` rounds it to the subdomain grid),
``exchange()`` + ``swap()`` under five radius shapes (+x only, ±x, faces,
faces and edges, uniform), one CSV row each (bench_exchange.cu:57-64, plus
the swept-bytes column):

    name,count,trimean (S),trimean (B/s),stddev,min,avg,max,trimean (B/s swept)

``--route`` pins the y/z-sweep exchange route of the sweep.  Then one JSON
line: ``route_ab``, every route that can engage (``route_supported``) at
the uniform face radius, its whole exchange and the per-axis sweeps it
changes (``_route_measured_axes``: x on ``direct`` only, y on ``direct`` and
the ``yzpack_*`` routes, z on all), alternated under the trial protocol
(``tune.trial.measure_alternating``; rep 0 dropped, median).  Each run is
``n`` in-place calls of ``dd.make_exchange_route_fn(route, axes=...)``, then
one synchronize; the legs a route does not change are shared from
``direct`` and listed in ``shared_legs_with_direct``.  With ``--inner k > 1``
the sweep runs ``k`` exchanges a dispatch (``exchange_many``, one captured
exchange replayed) with the host round trip subtracted.

``--partition px,py,pz`` places the subdomains on the one card (default
1,1,1); ``--device cpu`` runs the plain versions.  The JSON line carries
``card`` (``nvidia-smi``'s name and power limit; None on the CPU).

    python -m stencil_tpu_torch.bin.bench_exchange --partition 2,2,2 --x 512 --y 512 --z 512
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.geometry import sweep_bytes
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.device import sync
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.utils.statistics import Statistics

#: sweep axes of the per-axis breakdown, exchange-axis index by name
_AXES = {"x": 0, "y": 1, "z": 2}


def _domain(ext, radius: Radius, n_quants: int, route, subdomains: int, partition, device):
    x, y, z = _common.fit_to_mesh(ext[0], ext[1], ext[2], radius, subdomains, partition)
    dd = DistributedDomain(x, y, z, device=device)
    dd.set_radius(radius)
    dd.set_subdomains(subdomains)
    if partition is not None:
        dd.set_partition(*partition)
    if route is not None:
        dd.set_exchange_route(route)
    for i in range(n_quants):
        dd.add_data(f"d{i}", dtype=torch.float32)
    dd.realize()
    return dd


def bench(n_iters: int, n_quants: int, ext, radius: Radius, inner: int = 1, rt: float = 0.0, route: str = None,
          subdomains: int = 1, partition=None, device="cuda"):
    """One radius shape: (Statistics of seconds an iteration, bytes of the
    26-message model, swept bytes).  ``inner > 1`` runs that many
    exchanges a dispatch (``exchange_many``) with ``rt`` subtracted;
    ``route`` pins the exchange route (None: the planner's)."""
    dd = _domain(ext, radius, n_quants, route, subdomains, partition, device)
    stats = Statistics()
    swept = sweep_bytes(dd.local_spec(), [4] * n_quants) * dd.num_subdomains()
    if inner > 1:
        def run(k):
            dd.exchange_many(k)
            dd.block_until_ready()

        samples, _ = _common.timed_inner_loop(run, inner, rt, n_iters)
        for s in samples:
            stats.insert(s)
        return stats, dd.exchange_bytes_total(), swept
    dd.exchange()  # the kernels' load
    dd.swap()
    dd.block_until_ready()
    for _ in range(n_iters):
        t0 = time.perf_counter()
        dd.exchange()
        dd.swap()
        dd.block_until_ready()
        stats.insert(time.perf_counter() - t0)
    return stats, dd.exchange_bytes_total(), swept


def report_header() -> str:
    # the reference's columns (bench_exchange.cu:57-64) and the swept bytes:
    # the three sweeps move full-extent slabs, more than the 26-message model
    return "name,count,trimean (S),trimean (B/s),stddev,min,avg,max,trimean (B/s swept)"


def report(cfg: str, bytes_: int, stats: Statistics, swept: int = 0) -> str:
    tm = stats.trimean()
    bps = bytes_ / tm if tm else float("nan")
    sps = swept / tm if tm else float("nan")
    return (f"{cfg},{stats.count()},{tm:e},{bps:e},"
            f"{stats.stddev():e},{stats.min():e},{stats.avg():e},{stats.max():e},{sps:e}")


def sweep_configs(ext, fR: int, eR: int):
    """The five radius shapes of bench_exchange.cu:121-195."""
    tag = f"{ext[0]}-{ext[1]}-{ext[2]}"

    r = Radius.constant(0)
    r.set_dir(Dim3(1, 0, 0), fR)
    yield f"{tag}/px/{fR}", r

    r = Radius.constant(0)
    r.set_dir(Dim3(1, 0, 0), fR)
    r.set_dir(Dim3(-1, 0, 0), fR)
    yield f"{tag}/x/{fR}", r

    r = Radius.constant(0)
    r.set_face(fR)
    yield f"{tag}/faces/{fR}", r

    r = Radius.constant(fR)
    for sx in (1, -1):
        for sy in (1, -1):
            for sz in (1, -1):
                r.set_dir(Dim3(sx, sy, sz), eR)
    yield f"{tag}/face&edge/{fR}/{eR}", r

    yield f"{tag}/uniform/2", Radius.constant(2)


def _route_measured_axes(route: str) -> list:
    """The sweeps a route measures itself: a leg is shared from ``direct``
    only where the route runs the same code for that sweep.  The x sweep is
    the same on every route (nothing packs x); the y sweep differs on the
    ``yzpack_*`` routes, the z sweep on every packed route."""
    from stencil_tpu_torch.ops.exchange import Y_PACK_ROUTES

    if route == "direct":
        return ["x", "y", "z"]
    if route in Y_PACK_ROUTES:
        return ["y", "z"]
    return ["z"]


def route_ab(ext, fR: int, n_quants: int, reps: int, rt: float, inner: int = 4, subdomains: int = 1,
             partition=None, device="cuda") -> dict:
    """Every engageable route's whole exchange and the per-axis sweeps it
    changes, at the uniform radius ``fR``, alternated in one process under
    the trial protocol.  Returns the JSON section."""
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES, route_supported
    from stencil_tpu_torch.tune.trial import measure_alternating

    dd = _domain(ext, Radius.constant(fR), n_quants, None, subdomains, partition, device)
    x, y, z = dd.size().tuple()
    dtypes = [dd.field_dtype(h) for h in dd._handles]
    routes = [r for r in EXCHANGE_ROUTES if r == "direct" or route_supported(r, dtypes, dd.valid_last())]
    stacks = [dd._curr[h.name] for h in dd._handles]

    def make_run(fn):
        def run(n):
            for _ in range(n):
                fn(stacks)
            sync(dd.device)

        return run

    labels, runs = [], []
    for route in routes:
        labels.append((route, "all"))
        runs.append(make_run(dd.make_exchange_route_fn(route)))
        for ax_name in _route_measured_axes(route):
            labels.append((route, ax_name))
            runs.append(make_run(dd.make_exchange_route_fn(route, axes=(_AXES[ax_name],))))
    # one dispatch size, calibrated on the first run, for every run
    _, inner = _common.timed_inner_loop(runs[0], inner, rt, 1)
    for run in runs[1:]:
        run(inner)
    rounds = measure_alternating(runs, inner, rt, reps)

    section: dict = {
        "fit_extent": [x, y, z],
        "radius": fR,
        "quantities": n_quants,
        "packed_eligible": len(routes) > 1,
        "measurement_protocol": {
            "alternating_within_process": True,
            "drop_rep0": True,
            "statistic": "median",
            "reps": reps,
            "inner": inner,
        },
        "routes": {},
    }
    for (route, part), samples in zip(labels, rounds):
        entry = section["routes"].setdefault(route, {"ms_per_exchange": None, "per_axis_ms": {}})
        ms = statistics.median(samples) * 1e3
        if part == "all":
            entry["ms_per_exchange"] = ms
        else:
            entry["per_axis_ms"][part] = ms
    # the legs a route does not change: direct's figures, and which they are
    shared: dict = {}
    for route, entry in section["routes"].items():
        if route == "direct":
            continue
        shared[route] = [ax for ax in ("x", "y", "z") if ax not in entry["per_axis_ms"]]
        for ax_name in shared[route]:
            entry["per_axis_ms"][ax_name] = section["routes"]["direct"]["per_axis_ms"][ax_name]
    section["measurement_protocol"]["shared_legs_with_direct"] = shared
    direct = section["routes"]["direct"]["ms_per_exchange"]
    section["speedup_vs_direct"] = {
        route: (direct / e["ms_per_exchange"]) if e["ms_per_exchange"] else None
        for route, e in section["routes"].items()
        if route != "direct"
    }
    return section


def main(argv=None) -> int:
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES

    p = argparse.ArgumentParser("bench-exchange")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--quantities", type=int, default=1)
    p.add_argument("--x", type=int, default=128)
    p.add_argument("--y", type=int, default=128)
    p.add_argument("--z", type=int, default=128)
    p.add_argument("--face-radius", type=int, default=2, dest="fR")
    p.add_argument("--edge-radius", type=int, default=1, dest="eR")
    p.add_argument("--route", default="auto", choices=("auto",) + EXCHANGE_ROUTES,
                   help="y/z-sweep exchange route of the CSV sweep (auto: env > tuned config > direct)")
    p.add_argument("--ab-reps", type=int, default=3, metavar="N",
                   help="steady-state reps of the route A/B (alternating, rep 0 dropped; 0 skips it)")
    p.add_argument("--inner", type=int, default=None,
                   help="exchanges a dispatch (per-iteration time = (dispatch - host rt) / inner; default 1, "
                        "16 when the host round trip exceeds 10 ms)")
    _common.add_device_flags(p)
    _common.add_telemetry_flags(p)
    args = p.parse_args(argv)
    _common.telemetry_begin(args)

    from stencil_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    rt = _common.host_round_trip_s(dev)
    if args.inner is None:
        args.inner = 1
        if rt > 10e-3:
            args.inner = 16
            print(f"host round trip {rt * 1e3:.0f} ms: auto --inner 16 (per-iter time = (dispatch - rt) / inner)",
                  file=sys.stderr)
    if args.inner == 1:
        rt = 0.0
    ext = (args.x, args.y, args.z)
    route = None if args.route == "auto" else args.route
    n_sub = _common.subdomain_count(args)
    print(report_header())
    for name, radius in sweep_configs(ext, args.fR, args.eR):
        stats, bytes_, swept = bench(args.iters, args.quantities, ext, radius, args.inner, rt, route, n_sub,
                                     args.partition, dev)
        print(report(name, bytes_, stats, swept))
    result = {
        "bench": "exchange",
        "extent": list(ext),
        "quantities": args.quantities,
        "route_flag": args.route,
        "host_round_trip_s": rt,
        "card": _common.card_line(dev),
    }
    if args.ab_reps > 0:
        result["route_ab"] = route_ab(ext, args.fR, args.quantities, args.ab_reps, rt if args.inner > 1 else 0.0,
                                      subdomains=n_sub, partition=args.partition, device=dev)
    print(json.dumps(result))
    _common.telemetry_end(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
