"""Per-phase roofline report from a telemetry directory.

Counterpart of ``scripts/perf_report.py``, with the same command line but
``--fabric`` (the fabric probe waits for the multi-card port, ROADMAP.md
queue 1 item 13): measured device time per phase joined with the analytic
counters into achieved GB/s and GFLOP/s and the fraction of the card's
roofline (``telemetry/roofline.py``).

Inputs, all from one telemetry directory (a run with
``STENCIL_TELEMETRY_DIR`` set and, for device truth, ``--profile-dir``
pointing inside it):

* ``metrics_<rank>.json`` (``telemetry.write_artifacts``) or an explicit
  ``--metrics`` snapshot: the analytic counters;
* ``torch.profiler`` traces (``*.pt.trace.json[.gz]``, searched
  recursively; ``--profile-dir`` narrows the search): the device rows;
* ``trace_<rank>.json`` (the host Chrome trace): the host-span fallback
  when no trace holds a device row (a CPU run), the report then tagged
  ``"source": "host"``; with ``--merge``, the file the device rows are
  merged into, so Perfetto shows both on one timeline.

With device rows, the report also has a comms section: the exchange's
device time per ``exchange.<axis>.<side>`` scope joined with the analytic
``exchange.hop.*.bytes`` counters into GB/s per hop; ``--json PATH`` writes
it as a ``{"bench": "comms_roofline", ...}`` artifact, the shape
``perf_ledger`` ingests as ``exchange_hop:*`` series.

Outputs: ``roofline.json`` and ``roofline.md`` in the directory (or
``--out-json`` / ``--out-md``).

    python -m stencil_tpu_torch.bin.perf_report /tmp/telem --chip "NVIDIA H100 80GB HBM3" --merge \\
        --json comms_roofline.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "perf_report",
        description="per-phase roofline from a telemetry dir (see module docstring)",
    )
    p.add_argument("dir", help="telemetry directory (metrics + traces)")
    p.add_argument(
        "--metrics",
        default=None,
        metavar="PATH",
        help="metrics snapshot JSON (default: newest metrics_*.json in DIR)",
    )
    p.add_argument(
        "--profile-dir",
        default=None,
        metavar="DIR",
        help="where to look for torch.profiler traces (default: DIR, searched recursively)",
    )
    p.add_argument(
        "--chip",
        default=None,
        help="card name for the peak table (torch.cuda.get_device_name, e.g. "
        "'NVIDIA H100 80GB HBM3'; default: none, achieved rates only)",
    )
    p.add_argument(
        "--hbm-gbps",
        type=float,
        default=None,
        help="measured copy bandwidth (Tensor.copy_ GB/s) to use as the HBM roofline",
    )
    p.add_argument(
        "--merge",
        action="store_true",
        help="also merge the device rows into DIR's host Chrome trace "
        "(trace_*.json) so Perfetto shows one timeline",
    )
    p.add_argument(
        "--json",
        default=None,
        metavar="PATH",
        dest="comms_json",
        help="also write the machine-readable comms-roofline report "
        '({"bench": "comms_roofline", ...}) to PATH, the shape '
        "perf_ledger ingests as exchange_hop:* series",
    )
    p.add_argument("--out-json", default=None, metavar="PATH")
    p.add_argument("--out-md", default=None, metavar="PATH")
    return p


def _load_metrics(args) -> dict:
    path = args.metrics
    if path is None:
        cands = sorted(
            glob.glob(os.path.join(args.dir, "metrics_*.json")),
            key=os.path.getmtime,
        )
        path = cands[-1] if cands else None
    if path is None:
        print("no metrics snapshot found (counters will be absent)", file=sys.stderr)
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _host_attribution(host_trace: str) -> dict:
    """Host-span fallback: sum span durations per name from the Chrome
    trace — same shape as the device attribution, tagged by the caller."""
    from stencil_tpu_torch.telemetry.device import attribute_device_time, load_trace_events

    return attribute_device_time(load_trace_events(host_trace))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from stencil_tpu_torch.telemetry.device import (
        attribute_device_time,
        attribute_exchange_directions,
        find_trace_files,
        load_trace_events,
        merge_device_rows,
    )
    from stencil_tpu_torch.telemetry.roofline import (
        comms_roofline,
        render_markdown,
        roofline_report,
    )
    from stencil_tpu_torch.utils.artifact import atomic_write_json, atomic_write_text

    snapshot = _load_metrics(args)
    profile_dir = args.profile_dir or args.dir
    host_traces = sorted(glob.glob(os.path.join(args.dir, "trace_*.json")))
    # the host Chrome trace is not a profiler dump: exclude it from the
    # device-trace search
    device_traces = [t for t in find_trace_files(profile_dir) if t not in host_traces]

    attribution, source, directions = None, "device", None
    if device_traces:
        events = load_trace_events(device_traces[0])
        if events:
            attribution = attribute_device_time(events)
            if attribution["_total"]["events"] == 0:
                # a trace with no device row (a CPU run: host frames
                # only) is not device truth: fall through to host
                attribution = None
        if attribution is not None:
            # per-direction exchange attribution (device rows only)
            directions = attribute_exchange_directions(events)
            if args.merge and host_traces:
                with open(host_traces[0], encoding="utf-8") as f:
                    doc = json.load(f)
                doc["traceEvents"] = merge_device_rows(
                    doc.get("traceEvents", []), events
                )
                atomic_write_json(host_traces[0], doc, indent=None)
                print(f"merged device rows into {host_traces[0]}", file=sys.stderr)
    if attribution is None and host_traces:
        attribution, source = _host_attribution(host_traces[0]), "host"
        print(
            "no device trace found: falling back to HOST spans "
            "(the host clock of asynchronous calls, not device truth)",
            file=sys.stderr,
        )
    if attribution is None:
        print(f"no trace found under {profile_dir}", file=sys.stderr)
        return 1

    report = roofline_report(
        snapshot,
        attribution,
        chip=args.chip,
        measured_hbm_gbps=args.hbm_gbps,
        source=source,
    )

    comms = comms_roofline(directions, snapshot)
    if comms is not None:
        report["comms"] = comms
    if args.comms_json:
        atomic_write_json(
            args.comms_json,
            {
                "bench": "comms_roofline",
                "chip": args.chip,
                "source": source,
                **(comms or {"coverage": None, "hops": {},
                             "bottleneck": None, "bottleneck_axis": None}),
            },
        )
        print(f"wrote comms roofline to {args.comms_json}", file=sys.stderr)

    out_json = args.out_json or os.path.join(args.dir, "roofline.json")
    out_md = args.out_md or os.path.join(args.dir, "roofline.md")
    atomic_write_json(out_json, report)
    atomic_write_text(out_md, render_markdown(report))
    print(render_markdown(report))
    print(f"wrote {out_json} and {out_md}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
