"""Roofline reports: join measured device time per phase with the analytic
counters the port records.

Counterpart of ``stencil_tpu/telemetry/roofline.py``: the same functions,
the same report on the same inputs.  Two inputs:

* a **metrics snapshot** (``telemetry.snapshot()`` / ``metrics_<rank>.json``,
  or a ``ProfileCapture``'s window deltas): the analytic counters
  ``domain.exchange.bytes``, ``exchange.packed.bytes``, ``kernel.mxu.flops``
  and the per-hop ``exchange.hop.*.bytes``;
* a **device-time attribution** (``telemetry/device.py``): measured device
  microseconds per phase from a ``torch.profiler`` capture, or, where no
  trace holds device rows, host span durations as a stand-in (tagged
  ``"source": "host"``: the host clock of an asynchronous call bounds
  nothing).

``python -m stencil_tpu_torch.bin.perf_report`` renders this module's JSON,
and the drivers' ``--profile-dir`` writes it at exit.

It imports no torch: reports are built offline, often from a dead run's
artifacts.
"""

from __future__ import annotations

from typing import Dict, Optional

from stencil_tpu_torch.telemetry import names

#: nominal peaks keyed by the prefix of ``torch.cuda.get_device_name``: the
#: H100 SXM's data sheet, 3.35 TB/s of HBM3 and 989 dense bf16 tensor-core
#: TFLOP/s.  The f32 figure is the data sheet's 495 TF32 TFLOP/s over the
#: three exact TF32 pieces the port's f32 contraction runs a product
#: (``csrc/band_mma.cuh``), so ``kernel.mxu.flops`` (the JAX package's FLOP
#: model) divides by the rate the port can reach.  Other cards (an H100
#: PCIe, a CPU run) carry None peaks: the report then shows achieved rates
#: with a null roofline fraction instead of inventing a ceiling.
PEAKS: Dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "mxu_gflops_f32": 165_000.0,
                              "mxu_gflops_bf16": 989_000.0},
}

#: phase -> the analytic counter carrying its traffic/work (the join key)
PHASE_BYTES_COUNTERS = {
    "exchange": names.EXCHANGE_BYTES,
    "pack": names.EXCHANGE_PACKED_BYTES,
}
PHASE_FLOPS_COUNTERS = {
    "mxu": names.KERNEL_MXU_FLOPS,
}


def peaks_for(chip: Optional[str],
              measured_hbm_gbps: Optional[float] = None) -> dict:
    """The peak table for ``chip`` (prefix match over ``PEAKS``), with the
    measured copy bandwidth (a ``Tensor.copy_``'s GB/s) substituted for the
    nominal HBM number when given: a card run below its power maximum
    reaches what it measured, not the data sheet."""
    out = {"chip": chip, "hbm_gbps": None, "mxu_gflops_f32": None,
           "mxu_gflops_bf16": None, "hbm_source": None}
    if chip:
        for prefix, vals in PEAKS.items():
            if chip.startswith(prefix):
                out.update(vals)
                out["hbm_source"] = "nominal"
                break
    if measured_hbm_gbps:
        out["hbm_gbps"] = float(measured_hbm_gbps)
        out["hbm_source"] = "measured"
    return out


def _counters(snapshot: Optional[dict]) -> dict:
    return (snapshot or {}).get("counters", {}) or {}


def roofline_report(
    snapshot: Optional[dict],
    attribution: Optional[dict],
    chip: Optional[str] = None,
    measured_hbm_gbps: Optional[float] = None,
    source: str = "device",
    counters_scope: str = "run",
) -> dict:
    """The per-phase roofline join.

    ``attribution`` is ``{phase: {"device_us": ..., "events": ...}}``
    (``telemetry.device.attribute_device_time``; a host-span fallback uses
    the same shape with ``source="host"``).  Phases carrying an analytic
    bytes counter report achieved GB/s and their fraction of the HBM
    roofline; the ``mxu`` phase reports GFLOP/s vs the MXU peak; scope
    phases with no counter (interior/exterior) report time and their share
    of total device time — the overlap-efficiency inputs.

    ``counters_scope`` records what window the counters cover, because the
    join is only honest when numerator and denominator cover the SAME
    window: ``"capture"`` = the counter deltas of the profiled window
    (``ProfileCapture.counters_snapshot`` — what the drivers pass);
    ``"run"`` = whole-run cumulative counters (offline ``perf_report``
    over ``metrics_*.json``), where achieved rates overstate by
    (run work / captured work) unless the run captured its whole measured
    loop.
    """
    counters = _counters(snapshot)
    attribution = attribution or {}
    peaks = peaks_for(chip, measured_hbm_gbps)
    total_us = attribution.get("_total", {}).get("device_us", 0.0)
    phases = {}
    for phase, row in attribution.items():
        if phase.startswith("_"):
            continue
        us = float(row.get("device_us", 0.0))
        s = us / 1e6
        entry = {
            "device_ms": round(us / 1e3, 6),
            "events": int(row.get("events", 0)),
            "share_of_device": round(us / total_us, 4) if total_us else None,
            "bytes": None,
            "gbps": None,
            "flops": None,
            "gflops": None,
            "frac_of_roofline": None,
        }
        bc = PHASE_BYTES_COUNTERS.get(phase)
        if bc is not None:
            b = counters.get(bc)
            if b:
                entry["bytes"] = int(b)
                if s > 0:
                    entry["gbps"] = round(b / s / 1e9, 3)
                    if peaks["hbm_gbps"]:
                        entry["frac_of_roofline"] = round(
                            entry["gbps"] / peaks["hbm_gbps"], 4
                        )
        fc = PHASE_FLOPS_COUNTERS.get(phase)
        if fc is not None:
            fl = counters.get(fc)
            if fl:
                entry["flops"] = int(fl)
                if s > 0:
                    entry["gflops"] = round(fl / s / 1e9, 3)
                    if peaks["mxu_gflops_f32"]:
                        entry["frac_of_roofline"] = round(
                            entry["gflops"] / peaks["mxu_gflops_f32"], 4
                        )
        phases[phase] = entry
    return {
        "source": source,
        "counters_scope": counters_scope,
        "peaks": peaks,
        "total_device_ms": round(total_us / 1e3, 6) if total_us else None,
        "unattributed_device_ms": round(
            attribution.get("_unattributed", {}).get("device_us", 0.0) / 1e3,
            6,
        ),
        "phases": phases,
    }


def capture_report(
    capture,
    chip: Optional[str] = None,
    measured_hbm_gbps: Optional[float] = None,
) -> Optional[dict]:
    """``roofline_report`` for a ``ProfileCapture``'s newest window: the
    dump's attribution joined with the capture-window counter deltas
    (whole-run snapshot fallback, tagged in ``counters_scope``).  Returns
    None when the capture produced no device rows (backend without a
    device profiler): the finalize of ``bin/_common.profile_finalize``."""
    attribution = capture.attribution()
    if attribution is None or attribution["_total"]["events"] == 0:
        return None
    deltas = capture.counters_snapshot()
    from stencil_tpu_torch import telemetry

    return roofline_report(
        deltas if deltas is not None else telemetry.snapshot(),
        attribution,
        chip=chip,
        measured_hbm_gbps=measured_hbm_gbps,
        counters_scope="capture" if deltas is not None else "run",
    )


def comms_roofline(
    direction_attribution: Optional[dict],
    snapshot: Optional[dict],
) -> Optional[dict]:
    """The communication dimension of the roofline: achieved GB/s per grid
    axis per direction.

    Two inputs: ``direction_attribution`` (``device.attribute_exchange_directions``
    over a trace: device time per ``exchange.<axis>.<side>`` scope and the
    coverage of the exchange family) and ``snapshot`` (the analytic
    ``exchange.hop.<axis>.<side>.bytes`` counters).  The JAX package also
    joins a probed link model; the port's subdomains share one card, so its
    probed ceilings stay null (``"fabric": None``) until the multi-card port
    (ROADMAP.md queue 1 item 13).  The bottleneck is the direction with the
    most device time.  Returns None without an attribution."""
    if not direction_attribution:
        return None
    counters = _counters(snapshot)
    span_to_hop = {
        span: hop for hop, span in names.EXCHANGE_DIRECTION_SPANS.items()
    }
    hops = {}
    bottleneck = None
    for span, row in (direction_attribution.get("directions") or {}).items():
        axis, side = span_to_hop[span]
        us = float(row.get("device_us", 0.0))
        s = us / 1e6
        b = counters.get(names.EXCHANGE_HOP_BYTES[(axis, side)])
        entry = {
            "axis": axis,
            "direction": side,
            "device_ms": round(us / 1e3, 6),
            "events": int(row.get("events", 0)),
            "bytes": int(b) if b else None,
            "gbps": round(b / s / 1e9, 3) if (b and s > 0) else None,
            "probed_gbps": None,
            "frac_of_link": None,
        }
        hops[span] = entry
        if us > 0 and (bottleneck is None or us > bottleneck["_us"]):
            bottleneck = {"span": span, "_us": us, **entry}
    if bottleneck is not None:
        bottleneck.pop("_us")
    return {
        "coverage": direction_attribution.get("coverage"),
        "exchange_device_ms": round(
            float(direction_attribution.get("exchange_device_us") or 0.0) / 1e3, 6
        ),
        "attributed_ms": round(
            float(direction_attribution.get("attributed_us") or 0.0) / 1e3, 6
        ),
        "hops": hops,
        "bottleneck": bottleneck,
        "bottleneck_axis": bottleneck["axis"] if bottleneck else None,
        "fabric": None,
    }


def render_markdown(report: dict) -> str:
    """The report as a markdown table."""
    peaks = report.get("peaks", {})
    lines = [
        "# Per-phase roofline",
        "",
        f"- chip: `{peaks.get('chip')}`  "
        f"(HBM peak {peaks.get('hbm_gbps')} GB/s "
        f"[{peaks.get('hbm_source') or 'unknown'}], "
        f"tensor-core f32 peak {peaks.get('mxu_gflops_f32')} GFLOP/s)",
        f"- timing source: **{report.get('source')}** "
        + ("(device truth)" if report.get("source") == "device"
           else "(host spans — async dispatch upper bound only)"),
        f"- counters scope: **{report.get('counters_scope')}** "
        + ("(capture-window deltas — rates are honest)"
           if report.get("counters_scope") == "capture"
           else "(whole-run cumulative — rates overstate unless the "
           "capture covered the whole measured loop)"),
        f"- total device time: {report.get('total_device_ms')} ms "
        f"(unattributed {report.get('unattributed_device_ms')} ms)",
        "",
        "| phase | device ms | events | share | GB/s | GFLOP/s | % of roofline |",
        "|---|---|---|---|---|---|---|",
    ]
    for phase in sorted(report.get("phases", {})):
        e = report["phases"][phase]
        frac = e.get("frac_of_roofline")
        lines.append(
            f"| `{phase}` | {e['device_ms']} | {e['events']} | "
            f"{e.get('share_of_device')} | {e.get('gbps') or ''} | "
            f"{e.get('gflops') or ''} | "
            f"{f'{100 * frac:.1f}%' if frac is not None else ''} |"
        )
    lines.append("")
    comms = report.get("comms")
    if comms:
        cov = comms.get("coverage")
        lines += [
            "## Comms roofline (per mesh hop)",
            "",
            f"- exchange device time: {comms.get('exchange_device_ms')} ms, "
            f"direction coverage "
            + (f"{100 * cov:.1f}%" if cov is not None else "n/a")
            + (
                ""
                if comms.get("fabric")
                else " (no fabric probe joined: probed ceilings null)"
            ),
            "",
            "| hop | device ms | events | bytes | GB/s | probed GB/s | % of link |",
            "|---|---|---|---|---|---|---|",
        ]
        for span in sorted(comms.get("hops", {})):
            e = comms["hops"][span]
            frac = e.get("frac_of_link")
            lines.append(
                f"| `{span}` | {e['device_ms']} | {e['events']} | "
                f"{e.get('bytes') or ''} | {e.get('gbps') or ''} | "
                f"{e.get('probed_gbps') or ''} | "
                f"{f'{100 * frac:.1f}%' if frac is not None else ''} |"
            )
        bn = comms.get("bottleneck")
        if bn:
            lines += [
                "",
                f"**Bottleneck: mesh axis `{bn['axis']}`** "
                f"(`{bn.get('span')}`, {bn['device_ms']} ms of exchange "
                "device time — the hop a topology/placement change must "
                "shrink first).",
            ]
        lines.append("")
    return "\n".join(lines)
