"""``python -m stencil_tpu_torch.status <dir>``: render a run's flight-recorder
state, live or post-mortem.

Counterpart of ``stencil_tpu/status.py``.  Reads the ``status.json``
heartbeat and ``crash_report.json`` that ``telemetry/flight.py`` writes
under a supervised run's directory (its checkpoint directory) and prints a
summary: phase, progress, steady-state rate, the heartbeat's age (a stale
heartbeat on a ``running`` phase means the process died without a word),
checkpoint age, restarts, watchdog, the last numerics snapshot, the last
error, the fabric observatory's link model (a heartbeat's ``fabric``: the
per-axis link bandwidth, the slowest link, the link matrix; "-" without a
probe), the serving layer's tenant table (a serve heartbeat's
``tenants`` rows, rendered as the JAX package renders them; "-" without
rows), and the crash report's cause with its last events.

``--json`` prints the two documents instead.  It imports neither torch nor
the domain: inspecting a wedged run must not wait on a device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from stencil_tpu_torch.telemetry.flight import read_crash_report, read_status


def _age(ts) -> str:
    try:
        dt = max(time.time() - float(ts), 0.0)
    except (TypeError, ValueError):
        return "?"
    if dt < 120:
        return f"{dt:.1f}s"
    if dt < 7200:
        return f"{dt / 60:.1f}m"
    return f"{dt / 3600:.1f}h"


def _fmt_stat(v) -> str:
    if v is None:
        return "-"
    return f"{v:.6g}"


def _numerics_lines(doc, indent: str = "  ") -> list:
    """Per-quantity health lines from one numerics snapshot document
    (telemetry/numerics.py ``NumericsSnapshot.as_json``)."""
    if not isinstance(doc, dict):
        return []
    lines = []
    step = doc.get("step")
    head = f"{indent}numerics"
    if step is not None:
        head += f" @ step {step}"
    win = doc.get("window")
    if isinstance(win, (list, tuple)) and len(win) == 2:
        head += f" (window {win[0]}..{win[1]}]"
    lines.append(head + ":")
    for name, st in sorted((doc.get("quantities") or {}).items()):
        if not isinstance(st, dict):
            continue
        row = (
            f"{indent}  {name}: min {_fmt_stat(st.get('min'))}, "
            f"max {_fmt_stat(st.get('max'))}, "
            f"mean {_fmt_stat(st.get('mean'))}, "
            f"l2 {_fmt_stat(st.get('l2'))}"
        )
        nbad = st.get("nonfinite") or 0
        if nbad:
            row += f", NON-FINITE x{nbad}"
            coord = st.get("first_nonfinite")
            if isinstance(coord, (list, tuple)):
                row += f" (first at global {tuple(coord)})"
        else:
            row += ", finite"
        lines.append(row)
    return lines


def _tenant_lines(rows, indent: str = "  ") -> list:
    """The serving heartbeat's tenant table (``serve/server.py``
    ``tenant_table`` rows): one aligned line per tenant, state, envelope
    rung, request counters and the per-tenant latency percentiles, as
    ``stencil_tpu/status.py:79-100`` renders them; "-" without rows."""
    if not isinstance(rows, list) or not rows:
        return [f"{indent}tenants: -"]
    lines = [indent + "tenants:"]
    for row in rows:
        if not isinstance(row, dict):
            continue
        pcts = "/".join(
            _fmt_stat(row.get(k)) for k in ("p50_ms", "p95_ms", "p99_ms")
        )
        line = (
            f"{indent}  {row.get('tenant', '?')}: {row.get('state', '?')}"
            f" prio {row.get('priority', 0)}, rung {row.get('rung', 0)},"
            f" {row.get('completed', 0)}/{row.get('admitted', 0)} done,"
            f" shed {row.get('shed', 0)}, retries {row.get('retries', 0)},"
            f" p50/p95/p99 {pcts} ms"
        )
        if row.get("why"):
            line += f" [{row['why']}]"
        lines.append(line)
    return lines


def _fabric_lines(doc, indent: str = "  ") -> list:
    """The fabric observatory's heartbeat state (``telemetry/fabric.summary``
    shape): per-axis median link bandwidth, the slowest-link callout, and
    the per-neighbour matrix (rows = sending flat slot index)."""
    if not isinstance(doc, dict):
        return [f"{indent}fabric: -"]
    topo = "x".join(str(v) for v in (doc.get("topology") or [])) or "?"
    lines = [f"{indent}fabric (topology {topo}, {doc.get('chip', '?')}):"]
    for axis, sides in sorted((doc.get("axes") or {}).items()):
        if not isinstance(sides, dict):
            continue
        per = ", ".join(f"{side} {_fmt_stat(sides.get(side))} GB/s" for side in ("low", "high") if side in sides)
        lines.append(f"{indent}  axis {axis}: {per}")
    slow = doc.get("slowest")
    if isinstance(slow, dict):
        lines.append(f"{indent}  slowest link: {slow.get('axis')}.{slow.get('side')} "
                     f"{slow.get('src')}->{slow.get('dst')} at {_fmt_stat(slow.get('gbps'))} GB/s")
    matrix = doc.get("matrix")
    if isinstance(matrix, list) and matrix and len(matrix) <= 16:
        lines.append(f"{indent}  link matrix (GB/s):")
        for row in matrix:
            cells = " ".join(f"{v:7.2f}" if isinstance(v, (int, float)) and v else "      ." for v in row)
            lines.append(f"{indent}    {cells}")
    return lines


def render(status, crash, stale_after: float = 300.0) -> str:
    """The human view of one run directory's flight state."""
    lines = []
    if status is None and crash is None:
        return "no flight-recorder state found (no status.json / crash_report.json)"
    if status is not None:
        phase = status.get("phase", "?")
        ts = status.get("ts")
        stale = (
            phase == "running"
            and isinstance(ts, (int, float))
            and time.time() - ts > stale_after
        )
        total = status.get("total_steps")
        prog = f"{status.get('step')}/{total}" if total else str(status.get("step"))
        rate = status.get("rate_steps_per_s")
        lines.append(
            f"run '{status.get('label')}' [{phase}]"
            + (" — heartbeat STALE (process likely dead)" if stale else "")
        )
        lines.append(
            f"  step {prog}"
            + (f" @ {rate:.3g} steps/s" if isinstance(rate, (int, float)) else "")
            + f", heartbeat {_age(ts)} ago (pid {status.get('pid')})"
        )
        extras = []
        for key, label in (
            ("checkpoint_age_s", "checkpoint age"),
            ("restarts", "restarts"),
            ("ladder_rung", "ladder rung"),
            ("watchdog", "watchdog"),
            ("mesh", "mesh"),
            ("mesh_transitions", "mesh transitions"),
            ("queue_depth", "queue depth"),
        ):
            if status.get(key) is not None:
                val = status[key]
                if key == "checkpoint_age_s":
                    val = f"{float(val):.1f}s"
                if key == "mesh" and isinstance(val, list):
                    val = "x".join(str(v) for v in val)
                extras.append(f"{label} {val}")
        if extras:
            lines.append("  " + ", ".join(extras))
        # capacity breadcrumbs: the last few grid moves (on one card, the
        # supervisor's restore fallbacks), live or post-mortem
        history = status.get("mesh_history") or []
        for t in history[-5:]:
            frm = "x".join(str(v) for v in (t.get("from") or [])) or "?"
            to = "x".join(str(v) for v in (t.get("to") or [])) or "?"
            lines.append(
                f"  mesh {t.get('kind', '?')} at step {t.get('step')}: "
                f"{frm} -> {to} in {t.get('seconds')}s ({t.get('source')})"
            )
        # numerics observatory: the heartbeat's last per-quantity health
        # snapshot
        lines.extend(_numerics_lines(status.get("numerics")))
        # serving heartbeats carry the per-tenant table
        lines.extend(_tenant_lines(status.get("tenants")))
        # fabric observatory: the probed link model the run started under
        lines.extend(_fabric_lines(status.get("fabric")))
        if status.get("last_error"):
            lines.append(f"  last error: {status['last_error']}")
    if crash is not None:
        lines.append(
            f"crash report [{crash.get('cause')}] at {_age(crash.get('ts'))} ago"
        )
        if crash.get("error"):
            lines.append(f"  error: {crash['error']}")
        # the numerics snapshot ring: on a DIVERGENCE exit this is the
        # field-health history leading up to the trip — render the final
        # snapshot in full, and say how much history the report carries
        ring = crash.get("numerics_ring") or []
        if ring:
            lines.append(f"  numerics ring: {len(ring)} snapshot(s); last:")
            lines.extend(_numerics_lines(ring[-1], indent="    "))
        events = crash.get("events") or []
        if events:
            lines.append(f"  last {len(events)} events:")
            for e in events[-10:]:
                fields = {
                    k: v for k, v in e.items() if k not in ("ts", "event")
                }
                lines.append(f"    {e.get('event')}: {fields}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "stencil_tpu_torch.status",
        description="render a supervised run's flight-recorder state (status.json, crash_report.json)",
    )
    p.add_argument("dir", help="run directory holding status.json / crash_report.json")
    p.add_argument("--json", action="store_true", help="print the raw documents")
    p.add_argument(
        "--stale-after",
        type=float,
        default=300.0,
        metavar="S",
        help="seconds after which a 'running' heartbeat is reported stale",
    )
    args = p.parse_args(argv)
    status = read_status(args.dir)
    crash = read_crash_report(args.dir)
    if args.json:
        print(json.dumps({"status": status, "crash_report": crash}, indent=2))
    else:
        print(render(status, crash, stale_after=args.stale_after))
    return 0 if (status is not None or crash is not None) else 1


if __name__ == "__main__":
    sys.exit(main())
