"""``python -m stencil_tpu_torch.bin.stencil_serve``: the multi-tenant serving
driver and synthetic load generator on PyTorch + CUDA.

Counterpart of ``stencil_tpu/bin/stencil_serve.py``, with its command line
and its ``serve_summary.json`` schema.  Builds N independent Jacobi tenants
sharing one fleet of slots, drives a triangle load ramp (requests per
dispatch cycle climb to ``--peak`` at mid-run, then fall back to zero), and
serves it through ``stencil_tpu_torch.serve.StencilServer``: admission
control, per-tenant envelopes, bounded-queue shedding, batched and
sub-slice dispatch, and (``--elastic``) the load-driven grow/shrink loop
through ``DistributedDomain.reshard``.

It adds to the JAX driver's flags:

* ``--device`` (default ``cuda``; without a GPU the run raises the port's
  no-GPU error unless ``--device cpu`` is passed);
* ``--kernel-impl cuda|torch`` (default ``cuda``: the tenants run the
  hand-written kernels, the wrap kernel on one subdomain, the wavefront
  kernels and the blend kernel of the exchange on several);
* ``--subdomains N`` (default 1): the fleet, ``N`` slots of the one card,
  in place of ``jax.devices()``.  Elastic runs start on ``max(N // 2, 1)``
  subdomains and grow to ``N``, as the JAX driver's half and full fleet.

Chaos comes from the environment: ``STENCIL_FAULT_PLAN`` seeds
``poison_request`` / ``vmem_oom`` / ``overload`` / ``slow_tenant`` entries
against ``serve:<tenant>`` labels (``python -m
stencil_tpu_torch.bin.run_soak --serve`` drives reference-vs-chaos pairs
and compares the per-tenant digests this driver records).

Artifact: ``serve_summary.json`` under ``--out`` with ``bench:
"serve_soak"``: per-tenant table rows and final-field digests, the
throughput, the fleet's p99 and shed rate, the elasticity decisions and
grid transitions, the ``serve.*`` / ``resilience.*`` counters, the batching
histograms, and, the port's additions, the device, the engine, the fleet
and each tenant's subdomains and slots at the end, and the kernel launches
of the run by wrapper and form.

    python -m stencil_tpu_torch.bin.stencil_serve --size 512 --subdomains 8 --steps 8 --cycles 12
    python -m stencil_tpu_torch.bin.stencil_serve --device cpu --kernel-impl torch --subdomains 8
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "stencil_serve",
        description="multi-tenant serving driver + synthetic load generator",
    )
    p.add_argument("--tenants", type=int, default=3, help="tenant count")
    p.add_argument("--size", type=int, default=16, help="cubic domain edge per tenant")
    p.add_argument("--cycles", type=int, default=40, help="load-generator cycles")
    p.add_argument("--steps", type=int, default=1, help="raw steps per request")
    p.add_argument("--peak", type=int, default=3, help="requests/cycle at the ramp peak")
    p.add_argument("--queue-max", type=int, default=32, help="admission queue bound")
    p.add_argument(
        "--deadline-s", type=float, default=30.0,
        help="per-request deadline (generous by default: shedding should "
        "come from injected overload, not CI jitter)",
    )
    p.add_argument(
        "--compile-budget-s", type=float, default=None,
        help="admission budget for a cold build (default: unbounded)",
    )
    p.add_argument(
        "--batch", type=int, default=0,
        help="batch up to N geometry-matched requests into one dispatch "
        "(0/1 disables)",
    )
    p.add_argument(
        "--subslice", action="store_true",
        help="bin-pack non-matching tenants onto disjoint sub-slices of the fleet",
    )
    p.add_argument("--elastic", action="store_true", help="enable the grow/shrink policy")
    p.add_argument("--elastic-high", type=int, default=6, help="grow above this queue depth")
    p.add_argument("--elastic-low", type=int, default=0, help="shrink at/below this depth")
    p.add_argument("--elastic-consecutive", type=int, default=3, help="observations before acting")
    p.add_argument("--elastic-cooldown-s", type=float, default=0.0, help="hold time after acting")
    p.add_argument("--out", default="serve_out", help="artifact/heartbeat directory")
    p.add_argument(
        "--fixed-mesh", action="store_true",
        help="ignore --elastic decisions (the reference leg of the "
        "elasticity bitwise A/B)",
    )
    p.add_argument("--device", default="cuda",
                   help="device of the tenants (cuda, or cpu for the plain versions)")
    p.add_argument("--kernel-impl", choices=["cuda", "torch"], default="cuda",
                   help="the tenants' engine: the hand-written kernels, or plain tensor code")
    p.add_argument("--subdomains", type=int, default=1,
                   help="the fleet: subdomain slots on the card (elastic runs start on half)")
    return p


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _ramp(cycle: int, cycles: int, peak: int) -> int:
    """Triangle profile: 0 -> peak at mid-run -> 0 (int requests/cycle)."""
    half = max(cycles // 2, 1)
    frac = cycle / half if cycle <= half else max(0.0, 2.0 - cycle / half)
    return int(round(peak * frac))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.subdomains < 1:
        raise SystemExit(f"--subdomains must be >= 1, got {args.subdomains}")
    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.device import resolve_device, sync
    from stencil_tpu_torch.kernels import ledger
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.parallel.topology import slots_on
    from stencil_tpu_torch.resilience import inject
    from stencil_tpu_torch.resilience.taxonomy import OverloadError
    from stencil_tpu_torch.serve import (
        AdmissionRefused,
        ElasticityPolicy,
        Request,
        StencilServer,
        TenantSpec,
        pack,
    )
    from stencil_tpu_torch.telemetry import names as tm
    from stencil_tpu_torch.telemetry.flight import FlightRecorder
    from stencil_tpu_torch.utils.artifact import atomic_write_json
    from stencil_tpu_torch.utils.logging import log_info

    dev = resolve_device(args.device)  # no GPU: the port's error, unless --device cpu
    full = args.subdomains
    half = max(full // 2, 1)
    # elastic runs start on the half fleet so the grow leg has somewhere to
    # go (grow reshards half -> full, the post-drain shrink returns it);
    # --fixed-mesh keeps the same starting grid so the bitwise A/B compares
    # like with like
    start = half if args.elastic else full
    current = {"subdomains": start}
    transitions: list = []

    models = {}
    for i in range(args.tenants):
        tid = f"tenant-{chr(ord('a') + i)}"
        m = Jacobi3D(args.size, args.size, args.size, kernel_impl=args.kernel_impl, subdomains=start, device=dev)
        m.realize()
        models[tid] = m

    def capacity(kind: str) -> None:
        if args.fixed_mesh:
            return
        target = full if kind in ("grow", "refit") else half
        if target == current["subdomains"]:
            return  # already there: a repeat decision is a no-op
        for tid, m in models.items():
            stats = m.dd.reshard(subdomains=target, source="policy")
            m.rebuild_after_reshard()
            transitions.append(
                {"kind": kind, "tenant": tid, "seconds": stats.get("seconds")}
            )
        current["subdomains"] = target
        log_info(f"stencil_serve: policy {kind} -> {target} subdomains")

    policy = None
    if args.elastic:
        policy = ElasticityPolicy(
            high=args.elastic_high,
            low=args.elastic_low + 1 if args.elastic_low >= args.elastic_high else args.elastic_low,
            consecutive=args.elastic_consecutive,
            cooldown_s=args.elastic_cooldown_s,
        )

    flight = FlightRecorder(dir=args.out, label="stencil_serve")
    srv = StencilServer(
        queue_max=args.queue_max,
        default_deadline_s=args.deadline_s,
        compile_budget_s=args.compile_budget_s,
        policy=policy,
        capacity=capacity,
        flight=flight,
        batch_max=args.batch,
        subslice=args.subslice,
        fleet=slots_on(dev, full),
    )
    submitted = rejected = 0
    latencies: list = []
    responses: list = []
    launches0 = ledger.launch_counts()
    t_start = time.perf_counter()
    try:
        order = sorted(models)
        for tid in order:
            srv.add_tenant(TenantSpec(tenant_id=tid), models[tid])
        for cycle in range(args.cycles):
            for k in range(_ramp(cycle, args.cycles, args.peak)):
                tid = order[(cycle + k) % len(order)]
                submitted += 1
                try:
                    srv.submit(Request(tenant=tid, steps=args.steps))
                except (OverloadError, AdmissionRefused):
                    rejected += 1
            responses.extend(srv.cycle())
        responses.extend(srv.drain())
        # settle: a few empty cycles after the drain so the elasticity
        # policy can observe the now-idle queue and take its shrink leg
        # (exactly `consecutive` observations: one decision, no repeats)
        for _ in range(args.elastic_consecutive):
            responses.extend(srv.cycle())
        sync(dev)  # the wall clock covers the launches the run queued
    finally:
        srv.close()
    wall_s = max(time.perf_counter() - t_start, 1e-9)
    launches1 = ledger.launch_counts()

    latencies = sorted(r.latency_s for r in responses if r.ok)
    shed = sum(
        1 for r in responses if not r.ok and r.failure_class == "overload"
    )
    p99_ms = (
        latencies[min(len(latencies) - 1, int(0.99 * len(latencies)))] * 1e3
        if latencies
        else None
    )
    plan = inject.active_plan()
    completed = sum(1 for r in responses if r.ok)
    # cells advanced per completed request: every tenant is a cubic Jacobi
    # domain of --size edge stepping --steps raw steps
    mcells = completed * args.steps * (args.size**3) / 1e6
    snap = telemetry.snapshot()
    summary = {
        "bench": "serve_soak",
        "tenants": srv.tenant_table(),
        "digests": {tid: _digest(m.temperature()) for tid, m in models.items()},
        "requests": submitted,
        "rejected": rejected,
        "completed": completed,
        "throughput": {
            "wall_s": wall_s,
            "requests_per_s": completed / wall_s,
            "mcells_per_s": mcells / wall_s,
            "batch_max": args.batch,
            "subslice": bool(args.subslice),
        },
        "shed": shed,
        "shed_rate": (shed / submitted) if submitted else 0.0,
        "p99_ms": p99_ms,
        "elasticity": {
            "enabled": bool(args.elastic and not args.fixed_mesh),
            "decisions": [k for _, k in (policy.decisions if policy else [])],
            "transitions": transitions,
        },
        "fault_plan": os.environ.get(inject.ENV_VAR),
        # the driver can only judge isolation against a reference run:
        # run_soak --serve fills the verdict in after comparing digests; a
        # fault-free run is trivially isolated
        "isolation_ok": True if plan is None else None,
        "counters": {
            k: v
            for k, v in snap.get("counters", {}).items()
            if k.startswith("serve.") or k.startswith("resilience.")
        },
        # packed-dispatch evidence: run_soak asserts batching actually
        # engaged (count > 0) on the packed legs, not just that digests match
        "batching": {
            name: snap.get("histograms", {}).get(name)
            for name in (tm.SERVE_BATCH_SIZE, tm.SERVE_SUBSLICE_COUNT)
        },
        # the port's additions: where the tenants ran, and the kernel
        # launches of the run by wrapper and form (kernels/ledger.py)
        "device": str(dev),
        "kernel_impl": args.kernel_impl,
        "subdomains": {"fleet": full, "start": start, "end": current["subdomains"]},
        "placement": {tid: {"subdomains": m.dd.num_subdomains(), "slots": list(pack.tenant_slots(m))}
                      for tid, m in models.items()},
        "launches": {k: launches1[k] - launches0.get(k, 0) for k in launches1
                     if launches1[k] != launches0.get(k, 0)},
    }
    path = atomic_write_json(os.path.join(args.out, "serve_summary.json"), summary)
    flight.heartbeat(
        args.cycles,
        total_steps=args.cycles,
        phase="complete",
        queue_depth=srv.queue.depth(),
        tenants=srv.tenant_table(),
    )
    log_info(f"stencil_serve: wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
