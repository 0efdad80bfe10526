"""bench-serve: the serving layer's rate and latency over windows of
hundreds of requests, beside the same requests through a bare step loop.

``stencil_serve`` and ``chip_smoke.py``'s phase 30 serve a dozen cycles a
leg: enough to check isolation and bitwise results, too few requests (18 in
~65 ms at 512^3) to read a rate or a tail from.  This script builds the
tenants once (3 ``Jacobi3D`` of ``--size`` cubed on the ``--kernel-impl``
engine, on ``--subdomains`` slots, as ``stencil_serve``'s) and, for each of
``--reps`` repetitions and each mode, times two windows:

* **served**: ``--requests`` requests through a ``StencilServer`` of that
  mode (``serial``; ``batched``, ``batch_max`` = the tenant count;
  ``subslice``), a closed loop that tops the queue up to ``DEPTH``
  requests round-robin over the tenants before every ``cycle()``, then
  drains.  A request's latency is the server's, from submission to the
  return of the dispatch that answered it, on the host's clock (the card
  runs behind it);
* **bare**: the same requests, in the order the served window answered
  them, as ``model.step(--steps)`` calls.

Each window's wall clock ends after a device sync.  Served and bare
alternate, so each served window has a bare neighbour on the same card
state.  The tenants return to the full fleet between windows (untimed); the
``subslice`` mode places them on their slices in an untimed cycle first,
so its windows time packed dispatch, not the moves, and its bare window
steps the tenants on those slices.  A window fails the run if a request
was refused or shed, or a batched dispatch fell back to serial.

Output: one line a window and a summary with, per mode, the median and
range over the repetitions of requests/s, Mcells/s (requests x steps x
size^3 / wall), p50 / p99 latency and served / bare; ``--out`` writes the
whole record as JSON.

    python -m stencil_tpu_torch.bin.bench_serve --size 512 --subdomains 8 --steps 8 \\
        --requests 600 --reps 3 --out chiprun_out/bench_serve.json
    python -m stencil_tpu_torch.bin.bench_serve --device cpu --kernel-impl torch --size 16 \\
        --subdomains 8 --requests 24 --reps 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

MODES = ("serial", "batched", "subslice")
TENANTS = 3
#: the closed loop's queued requests: two a tenant, so a batch of every
#: tenant is always ready and the queue never sheds
DEPTH = 2 * TENANTS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_serve", description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=512, help="cubic domain edge per tenant")
    p.add_argument("--subdomains", type=int, default=8, help="the fleet: subdomain slots on the card")
    p.add_argument("--steps", type=int, default=8, help="raw steps per request")
    p.add_argument("--requests", type=int, default=600, help="requests a window")
    p.add_argument("--reps", type=int, default=3, help="served / bare pairs per mode")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kernel-impl", choices=["cuda", "torch"], default="cuda")
    p.add_argument("--out", default=None, help="write the record as JSON here")
    return p


def _to_full_fleet(models, full: int) -> None:
    for m in models.values():
        m._serve_slice = None
        if m.dd.num_subdomains() != full:
            m.dd.reshard(subdomains=full, source="bench")
            m.rebuild_after_reshard()


def _server(mode: str, n_tenants: int, fleet, depth: int):
    from stencil_tpu_torch.serve import StencilServer

    return StencilServer(queue_max=max(2 * depth, 8), batch_max=n_tenants if mode == "batched" else 0,
                         subslice=mode == "subslice", fleet=fleet)


def _served(mode, models, fleet, requests, depth, steps, sync) -> dict:
    """One served window (module docstring); the responses' tenant order
    is the bare window's."""
    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.serve import Request, TenantSpec
    from stencil_tpu_torch.telemetry import names as tm

    order = sorted(models)
    srv = _server(mode, len(order), fleet, depth)
    telemetry.reset()
    out = []
    submitted = 0
    try:
        for tid in order:
            srv.add_tenant(TenantSpec(tenant_id=tid), models[tid])
        sync()
        t0 = time.perf_counter()
        while submitted < requests or srv.queue.depth():
            while submitted < requests and srv.queue.depth() < depth:
                srv.submit(Request(tenant=order[submitted % len(order)], steps=steps))
                submitted += 1
            out.extend(srv.cycle())
        sync()
        wall = time.perf_counter() - t0
    finally:
        srv.close()
    counters = telemetry.snapshot()["counters"]
    bad = [r for r in out if not r.ok]
    if bad or len(out) != requests:
        raise RuntimeError(f"bench_serve {mode}: {len(out)} responses to {requests} requests, "
                           f"{len(bad)} failed ({[r.failure_class for r in bad][:5]})")
    if mode == "batched" and not (counters[tm.SERVE_BATCH_DISPATCHES] > 0
                                  and counters[tm.SERVE_BATCH_FALLBACKS] == 0):
        raise RuntimeError(f"bench_serve batched: dispatches {counters[tm.SERVE_BATCH_DISPATCHES]}, "
                           f"fallbacks {counters[tm.SERVE_BATCH_FALLBACKS]}")
    if mode == "subslice" and not counters[tm.SERVE_SUBSLICE_DISPATCHES] > 0:
        raise RuntimeError("bench_serve subslice: no sub-slice dispatch")
    lat = sorted(r.latency_s for r in out)
    return {"wall_s": wall, "latencies": lat, "order": [r.request.tenant for r in out],
            "batch_dispatches": counters[tm.SERVE_BATCH_DISPATCHES],
            "subslice_dispatches": counters[tm.SERVE_SUBSLICE_DISPATCHES]}


def _bare(models, order, steps, sync) -> float:
    sync()
    t0 = time.perf_counter()
    for tid in order:
        models[tid].step(steps)
    sync()
    return time.perf_counter() - t0


def _quantile(sorted_vals, q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from stencil_tpu_torch.device import resolve_device, sync as device_sync
    from stencil_tpu_torch.kernels import toolchain
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.parallel.topology import slots_on

    dev = resolve_device(args.device)  # no GPU: the port's error, unless --device cpu

    def sync():
        device_sync(dev)

    card = toolchain()["card"] if dev.type == "cuda" else None
    full = args.subdomains
    fleet = slots_on(dev, full)
    models = {}
    for i in range(TENANTS):
        m = Jacobi3D(args.size, args.size, args.size, kernel_impl=args.kernel_impl, subdomains=full, device=dev)
        m.realize()
        models[f"tenant-{chr(ord('a') + i)}"] = m
    cells = args.steps * args.size ** 3
    # untimed: each mode's first dispatches (lazy builds, the allocator) and
    # the sub-slice placement
    for mode in MODES:
        _to_full_fleet(models, full)
        warm = _served(mode, models, fleet, DEPTH, DEPTH, args.steps, sync)
        _bare(models, warm["order"], args.steps, sync)
    windows = []
    for rep in range(args.reps):
        for mode in MODES:
            _to_full_fleet(models, full)
            if mode == "subslice":
                _served(mode, models, fleet, len(models), DEPTH, args.steps, sync)  # the placement
            s = _served(mode, models, fleet, args.requests, DEPTH, args.steps, sync)
            bare_s = _bare(models, s["order"], args.steps, sync)
            lat = s["latencies"]
            w = {"rep": rep, "mode": mode, "requests": args.requests, "served_wall_s": s["wall_s"],
                 "bare_wall_s": bare_s, "requests_per_s": args.requests / s["wall_s"],
                 "bare_requests_per_s": args.requests / bare_s,
                 "mcells_per_s": args.requests * cells / s["wall_s"] / 1e6,
                 "bare_mcells_per_s": args.requests * cells / bare_s / 1e6,
                 "p50_ms": _quantile(lat, 0.50) * 1e3, "p99_ms": _quantile(lat, 0.99) * 1e3,
                 "served_over_bare": bare_s / s["wall_s"],
                 "subdomains": sorted({m.dd.num_subdomains() for m in models.values()}),
                 "batch_dispatches": s["batch_dispatches"], "subslice_dispatches": s["subslice_dispatches"]}
            windows.append(w)
            print(f"bench_serve rep {rep} {mode}: {args.requests} requests served in {s['wall_s']:.4f} s "
                  f"({w['requests_per_s']:.2f} requests/s, {w['mcells_per_s']:.1f} Mcells/s, p50 "
                  f"{w['p50_ms']:.3f} ms, p99 {w['p99_ms']:.3f} ms), bare {bare_s:.4f} s "
                  f"({w['bare_mcells_per_s']:.1f} Mcells/s), served/bare {w['served_over_bare']:.4f}, "
                  f"subdomains {w['subdomains']}; on {card}", flush=True)
    finite = all(bool(m.dd._curr[n].isfinite().all()) for m in models.values() for n in m.dd._curr)
    if not finite:
        raise RuntimeError("bench_serve: a tenant's field is not finite")
    summary = {}
    keys = ("requests_per_s", "mcells_per_s", "p50_ms", "p99_ms", "served_over_bare", "bare_mcells_per_s")
    for mode in MODES:
        ws = [w for w in windows if w["mode"] == mode]
        summary[mode] = {k: {"median": statistics.median(w[k] for w in ws), "min": min(w[k] for w in ws),
                             "max": max(w[k] for w in ws)} for k in keys}
    record = {"bench": "bench_serve", "card": card, "device": str(dev), "kernel_impl": args.kernel_impl,
              "size": args.size, "subdomains": full, "steps": args.steps, "tenants": TENANTS,
              "requests": args.requests, "depth": DEPTH, "reps": args.reps, "windows": windows,
              "summary": summary}
    for mode, s in summary.items():
        print(f"bench_serve {mode} over {args.reps} reps of {args.requests} requests: median "
              f"{s['requests_per_s']['median']:.2f} requests/s, {s['mcells_per_s']['median']:.1f} Mcells/s, p99 "
              f"{s['p99_ms']['median']:.3f} ms, served/bare {s['served_over_bare']['median']:.4f} (range "
              f"{s['served_over_bare']['min']:.4f}-{s['served_over_bare']['max']:.4f}); on {card}", flush=True)
    if args.out:
        from stencil_tpu_torch.utils.artifact import atomic_write_json

        atomic_write_json(args.out, record)
    print(json.dumps({"bench_serve": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
