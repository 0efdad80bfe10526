"""weak on PyTorch + CUDA: the exchange-only weak-scaling CSV and the stream
engine's overlap A/B.

Counterpart of ``stencil_tpu/bin/weak.py`` (reference bin/weak.cu).  The same
CLI: positional ``x y z nIters`` base size, weak-scaled by the subdomain
count to the 1/3 (weak.cu:63-65), radius 3, four float quantities
(weak.cu:120,132-135), ``nIters`` of ``exchange()`` + ``swap()``, then one CSV
row of the bytes per method and every setup and exchange timer
(weak.cu:173-194; ``DomainStats``):

    weak,<methods>,x,y,z,s,MPI(B),Colocated(B),cudaMemcpyPeer(B),direct(B),
    iters,gpus,nodes,ranks,mpi_topo,node_gpus,peer_en,placement,realize,plan,
    create,exchange,swap

Every exchanged byte rides the one on-device exchange and is reported in the
MPI(B) column; the Colocated, cudaMemcpyPeer and direct columns and the
node_gpus and peer_en phases are 0.  ``gpus``, ``nodes`` and ``ranks`` are
the cards, nodes and processes in use: 1, 1 and 1.  Where the JAX driver
spreads the domain over its devices, this one places ``--partition px,py,pz``
subdomains on the one card (default 1,1,1), and weak-scales by their count.

``--overlap`` runs the stream engine's A/B instead: the radius-1 mean of six
(``_mean6_kernel``) as ``stream_overlap="off"`` and ``"split"`` steps over
one realized domain, alternated with the bare exchange under the trial
protocol (``tune.trial.measure_alternating``: alternate within one process,
drop rep 0, steady-state median).  The steps run on a copy of the stacks,
so the domain never advances; the bare exchange is ``n`` in-place calls of
``dd.make_exchange_route_fn`` (idempotent on a filled domain); every run is
``n`` iterations, then one synchronize.  It prints one JSON document (and
writes it to ``--json PATH``): Mcells/s of each schedule, ``split_speedup``,
ms per exchange with the per-hop byte table.  ``--mesh MX,MY,MZ`` sets the
subdomain grid and weak-scales the base size per axis (256³ a subdomain on
2,2,2 is a 512³ global).  The key ``chips`` keeps the JAX name and holds the
subdomain count; ``dryrun`` is true on the CPU (the plain versions), and
``card`` holds ``nvidia-smi``'s name and power limit on the card.  ``--tune``
runs the exchange-route search (and, with ``--overlap``, the stream-plan
search) first.  ``--verify`` (the program-contract verifier, ROADMAP.md queue 1
item 14) and ``--fabric-probe`` (the fabric observatory, item 13) are not
ported: either flag exits non-zero before anything is measured.

    python -m stencil_tpu_torch.bin.weak 256 256 256 30 --partition 2,2,2
    python -m stencil_tpu_torch.bin.weak 256 256 256 --overlap --mesh 2,2,2 --json weak_222.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.device import sync
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.models.jacobi import weak_scaled_size
from stencil_tpu_torch.utils.config import MethodFlags

#: the flags the port refuses, with the ROADMAP item each waits for
REFUSED = {
    "verify": "--verify needs the program-contract verifier (stencil_tpu.analysis), not ported: "
              "ROADMAP.md queue 1 item 14",
    "fabric_probe": "--fabric-probe needs the fabric observatory (telemetry/fabric.py), not ported: "
                    "ROADMAP.md queue 1 item 13",
}


def refuse_unported(args) -> None:
    """Exit non-zero, before anything is built or measured, on a flag whose
    layer the port lacks: a silent no-op would measure something else."""
    for flag, msg in REFUSED.items():
        if getattr(args, flag, False):
            raise SystemExit(msg)


def build_domain(x: int, y: int, z: int, args, stats: bool = True) -> DistributedDomain:
    """The CSV drivers' realized domain: four radius-3 f32 quantities on the
    flags' methods, placement, subdomains and exchange route; ``stats``
    times every exchange into ``DomainStats``."""
    dd = DistributedDomain(x, y, z, device=args.device)
    dd.set_methods(_common.parse_methods(args))
    dd.set_radius(Radius.constant(3))  # weak.cu:120
    dd.set_placement(_common.parse_strategy(args))
    dd.set_subdomains(_common.subdomain_count(args))
    if args.partition is not None:
        dd.set_partition(*args.partition)
    _common.apply_exchange_route(args, dd)
    for i in range(4):  # weak.cu:132-135
        dd.add_data(f"d{i}", dtype=torch.float32)
    if stats:
        dd.enable_exchange_stats(True)
    dd.realize()
    return dd


def csv_size(args):
    """The CSV drivers' global extent: the base size weak-scaled by the
    subdomain count (weak.cu:63-65 round-to-nearest), then rounded to the
    grid (``fit_to_mesh``)."""
    n_sub = _common.subdomain_count(args)
    x, y, z = (weak_scaled_size(v, n_sub) for v in (args.x, args.y, args.z))
    return _common.fit_to_mesh(x, y, z, Radius.constant(3), n_sub, args.partition)


def run(x: int, y: int, z: int, n_iters: int, args, name: str = "weak") -> str:
    """``n_iters`` of ``exchange()`` + ``swap()`` over four radius-3 f32
    quantities, timed into ``DomainStats``; returns the CSV row."""
    dd = build_domain(x, y, z, args)
    if args.tune:
        # the exchange-route search; when its winner differs from the route
        # this realize resolved, realize again so the loop runs the winner
        from stencil_tpu_torch.tune.runners import autotune_exchange

        report = autotune_exchange(dd)
        _common.tune_report_stderr(report)
        tuned_route = (report.config or {}).get("exchange_route")
        if tuned_route and tuned_route != dd.exchange_route():
            dd = build_domain(x, y, z, args)

    for _ in range(n_iters):
        dd.exchange()
        dd.swap()

    ranks, dev_count = _common.ranks_and_devcount()
    s = dd.stats
    return (
        f"{name},{_common.method_str(args)},{x},{y},{z},{x * y * z},"
        f"{dd.exchange_bytes_for_method(MethodFlags.CudaMpi)},"
        f"0,0,0,"
        f"{n_iters},{ranks * dev_count},{ranks},{ranks},"
        f"{s.time_topo:e},{0.0:e},{0.0:e},{s.time_placement:e},"
        f"{s.time_realize:e},{s.time_plan:e},{s.time_create:e},"
        f"{s.time_exchange:e},{s.time_swap:e}"
    )


def _mean6_kernel(views, info):
    """The radius-1 mean of the six face neighbours through the public
    kernel API: the overlap A/B's workload."""
    out = {}
    for name, src in views.items():
        out[name] = (
            src.sh(-1, 0, 0)
            + src.sh(1, 0, 0)
            + src.sh(0, -1, 0)
            + src.sh(0, 1, 0)
            + src.sh(0, 0, -1)
            + src.sh(0, 0, 1)
        ) / 6.0
    return out


def _mean6_kernel_mxu(views, info):
    """``_mean6_kernel``'s declared axis-separable contraction form
    (``plane_nbr_sum``): lets the stream tuner's unit twins engage."""
    out = {}
    for name, src in views.items():
        out[name] = (src.sh(-1, 0, 0) + src.sh(1, 0, 0) + src.plane_nbr_sum()) / 6.0
    return out


def parse_mesh(spec):
    """``"MX,MY,MZ"`` -> (mx, my, mz), or None."""
    if spec is None:
        return None
    parts = [int(v) for v in spec.split(",")]
    if len(parts) != 3 or any(v < 1 for v in parts):
        raise ValueError(f"--mesh wants MX,MY,MZ positive ints, got {spec!r}")
    return tuple(parts)


def overlap_domain_size(args, mesh, subdomains: int, weak_scale: bool, partition=None):
    """The overlap A/B's global extent.  With a mesh the base size is per
    subdomain and weak-scales per axis (exact on non-cubic meshes); strong,
    the global size rounded to the grid.  Without one, the size rounded to
    the grid the domain chooses for ``subdomains`` or takes from
    ``partition`` (``fit_to_mesh``), weak-scaled by their count first."""
    shell = max(args.halo_mult, 1)  # radius 1 x multiplier
    if mesh is not None:
        if weak_scale:
            return (args.x * mesh[0], args.y * mesh[1], args.z * mesh[2])
        return tuple(max(round(v / d), shell) * d for v, d in zip((args.x, args.y, args.z), mesh))
    size = (args.x, args.y, args.z)
    if weak_scale:
        size = tuple(weak_scaled_size(v, subdomains) for v in size)
    return _common.fit_to_mesh(*size, Radius.constant(1), subdomains=subdomains, partition=partition)


def _hop_table(dd, s_exch: float) -> list:
    """The per-hop table of the artifact: the analytic exchange bytes of
    each grid hop (``exchange_hop_bytes``; hops on unsplit axes 0), with
    the measured exchange time apportioned by byte share (``source:
    "analytic"``; a ``--profile-dir`` trace measures directions)."""
    hop_bytes = dd.exchange_hop_bytes()
    total = sum(hop_bytes.values())
    return [
        {
            "axis": axis,
            "side": side,
            "bytes": nb,
            "share_of_bytes": round(nb / total, 4) if total else None,
            "est_ms": round(s_exch * 1e3 * nb / total, 6) if total else None,
            "source": "analytic",
        }
        for (axis, side), nb in sorted(hop_bytes.items())
    ]


def overlap_domain(args, weak_scale: bool = True, name: str = "weak"):
    """The realized, initialised domain of the overlap A/B, and its grid."""
    mesh = parse_mesh(args.mesh)
    grid = mesh or args.partition
    n_sub = grid[0] * grid[1] * grid[2] if grid else 1
    x, y, z = overlap_domain_size(args, mesh, n_sub, weak_scale, partition=grid)
    print(f"{name}-overlap domain: {x},{y},{z} on {n_sub} subdomains", file=sys.stderr)
    dd = DistributedDomain(x, y, z, device=args.device)
    dd.set_radius(Radius.constant(1))
    dd.set_subdomains(n_sub)
    if grid is not None:
        dd.set_partition(*grid)
    dd.set_placement(_common.parse_strategy(args))
    if args.halo_mult > 1:
        dd.set_halo_multiplier(args.halo_mult)
    _common.apply_exchange_route(args, dd)
    hs = [dd.add_data(f"d{i}", dtype=torch.float32) for i in range(args.quantities)]
    dd.realize()
    for i, h in enumerate(hs):
        dd.init_by_coords(h, lambda cx, cy, cz, i=i: torch.sin(0.13 * (cx + 2 * cy + 3 * cz) + i))
    return dd


def overlap_steps(dd) -> dict:
    """The ``off`` and ``split`` stream steps of ``_mean6_kernel`` over
    ``dd`` (on one subdomain split degrades to off with a warning)."""
    return {ov: dd.make_step(_mean6_kernel, engine="stream", mxu_kernel=_mean6_kernel_mxu, stream_overlap=ov)
            for ov in ("off", "split")}


def run_overlap(args, name: str = "weak", weak_scale: bool = True) -> dict:
    """The stream engine's overlap A/B on this grid: ``off`` and ``split``
    steps on a copy of one realized domain's stacks, alternated with the
    bare exchange under the trial protocol; returns the JSON document."""
    from stencil_tpu_torch.tune.trial import measure_alternating

    dd = overlap_domain(args, weak_scale, name)
    dev = dd.device
    x, y, z = dd.size().tuple()

    tune_section = None
    if args.tune:
        from stencil_tpu_torch.tune.runners import autotune_exchange, autotune_stream

        ex_report = autotune_exchange(dd)
        _common.tune_report_stderr(ex_report)
        st_report = autotune_stream(dd, _mean6_kernel, x_radius=1, mxu_kernel=_mean6_kernel_mxu)
        _common.tune_report_stderr(st_report)
        tune_section = {"exchange": ex_report.to_json(), "stream": st_report.to_json()}

    steps = overlap_steps(dd)

    def make_step_run(step):
        # the step's own copy of the stacks: the domain does not advance, and
        # the loop ping-pongs between this copy and its spare set
        curr = {n: t.clone() for n, t in dd._curr.items()}

        def go(n):
            step(curr, n)
            sync(dev)

        return go

    exch_fn = dd.make_exchange_route_fn(dd.exchange_route())
    stacks = [dd._curr[h.name] for h in dd._handles]

    def exch_run(n):
        for _ in range(n):
            exch_fn(stacks)
        sync(dev)

    rt = _common.host_round_trip_s(dev)
    runs = [make_step_run(steps["off"]), make_step_run(steps["split"]), exch_run]
    # the two steps share one dispatch size (calibrated on off, split warmed
    # at it); the bare exchange, many times cheaper, calibrates its own
    _, inner_step = _common.timed_inner_loop(runs[0], 2, rt, 1)
    runs[1](inner_step)
    _, inner_exch = _common.timed_inner_loop(exch_run, inner_step, rt, 1)
    rounds = measure_alternating(runs, [inner_step, inner_step, inner_exch], rt, args.ab_reps)
    s_off, s_split, s_exch = (statistics.median(r) for r in rounds)

    cells = x * y * z
    dim = dd.grid_dim()
    n_sub = dd.num_subdomains()
    doc = {
        "bench": f"{name}_overlap",
        "dryrun": dev.type != "cuda",
        "card": _common.card_line(dev),
        "mesh": [dim.x, dim.y, dim.z],
        "chips": n_sub,
        "global": [x, y, z],
        "cells_per_chip": cells // n_sub,
        "quantities": args.quantities,
        "radius": 1,
        "halo_mult": args.halo_mult,
        "exchange_route": dd.exchange_route(),
        "plans": {
            ov: {k: steps[ov]._stream_plan.get(k) for k in ("route", "m", "z_slabs", "grouping", "overlap")}
            for ov in ("off", "split")
        },
        "measurement_protocol": {
            "alternating_within_process": True,
            "drop_rep0": True,
            "statistic": "median",
            "reps": args.ab_reps,
            "inner": {"step": inner_step, "exchange": inner_exch},
            "host_round_trip_s": rt,
        },
        "overlap": {
            ov: {
                "s_per_iter": s,
                "mcells_per_s": (cells / s / 1e6) if s > 0 else None,
                "mcells_per_s_per_chip": (cells / s / 1e6 / n_sub) if s > 0 else None,
            }
            for ov, s in (("off", s_off), ("split", s_split))
        },
        "split_speedup": (s_off / s_split) if s_split > 0 else None,
        "exchange": {
            "s_per_exchange": s_exch,
            "ms_per_exchange": s_exch * 1e3,
            "bytes_per_exchange": dd.exchange_bytes_total(),
            "hops": _hop_table(dd, s_exch),
        },
    }
    if tune_section is not None:
        doc["tune"] = tune_section
    return doc


def emit_overlap(doc, args) -> None:
    line = json.dumps(doc)
    print(line)
    if args.json:
        from stencil_tpu_torch.utils.artifact import atomic_write_text

        atomic_write_text(args.json, line + "\n")


def build_parser(name: str, overlap_flags: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    p.add_argument("x", type=int, nargs="?", default=512)
    p.add_argument("y", type=int, nargs="?", default=512)
    p.add_argument("z", type=int, nargs="?", default=512)
    p.add_argument("n_iters", type=int, nargs="?", default=30)
    p.add_argument("--kernel", action="store_true")
    p.add_argument("--peer", action="store_true")
    p.add_argument("--colo", action="store_true")
    p.add_argument("--naive", action="store_true", help="trivial placement (weak.cu --naive)")
    p.add_argument("--cuda-aware", dest="cuda_aware_mpi", action="store_true")
    p.add_argument("--staged", action="store_true")
    _common.add_device_flags(p)
    if not overlap_flags:
        # weak_exchange shares the CSV parser but has no A/B and no tuner
        # consult: the flags do not exist there at all
        _common.add_exchange_route_flag(p)
        _common.add_telemetry_flags(p)
        return p
    p.add_argument("--overlap", action="store_true",
                   help="run the stream engine's overlap A/B (off vs split) instead of the exchange-only "
                        "CSV; prints one JSON document")
    p.add_argument("--mesh", default=None, metavar="MX,MY,MZ",
                   help="with --overlap: the subdomain grid on the one device; the base size is per "
                        "subdomain and weak-scales per axis")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="with --overlap: also write the JSON document to PATH")
    p.add_argument("--ab-reps", type=int, default=3, metavar="N",
                   help="steady-state reps of the overlap A/B (alternating, rep 0 dropped, median)")
    p.add_argument("--fabric-probe", action="store_true",
                   help="not ported (the fabric observatory, ROADMAP.md queue 1 item 13): refused")
    p.add_argument("--verify", action="store_true",
                   help="not ported (the program-contract verifier, ROADMAP.md queue 1 item 14): refused")
    p.add_argument("--halo-mult", type=int, default=2, metavar="K",
                   help="halo multiplier of the overlap A/B's domain (K*radius shells; K >= 2 makes the "
                        "wavefront route eligible)")
    p.add_argument("--quantities", type=int, default=1, metavar="N",
                   help="fields exchanged and streamed in the overlap A/B")
    _common.add_exchange_route_flag(p)
    _common.add_tune_flags(p)
    _common.add_telemetry_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser("weak").parse_args(argv)
    args.trivial = args.naive
    refuse_unported(args)
    _common.telemetry_begin(args)
    _common.tune_begin(args)
    try:
        if args.overlap:
            emit_overlap(run_overlap(args, name="weak", weak_scale=True), args)
            _common.telemetry_end(args)
            return 0
        x, y, z = csv_size(args)
        print(f"{_common.subdomain_count(args)} subdomains: {x},{y},{z}={x * y * z}", file=sys.stderr)
        print(run(x, y, z, args.n_iters, args, name="weak"))
        _common.telemetry_end(args)
        return 0
    finally:
        _common.tune_end(args)


if __name__ == "__main__":
    sys.exit(main())
