"""Perf ledger: an append-only JSONL record of benchmark series, with a
trailing-median regression gate.

Counterpart of ``stencil_tpu/telemetry/ledger.py``: the same entries and
the same verdicts on the same artifacts.  Every artifact normalizes into
one-line entries

    {"ts": <epoch s>, "key": "<series key>", "value": <float>,
     "unit": "...", "source": "<artifact basename>", ...}

keyed by series and deduped on ``(key, source, ts)``, so re-ingesting a file
is idempotent while regenerated artifacts and fresh runs grow their series.
Appends are append-mode writes, one complete JSON document a line.

Besides the JAX package's artifacts (``BENCH_*.json`` results, weak-scaling
sweeps, ``perf_report --json`` comms rooflines, soak and serve summaries,
``bench_exchange`` route A/Bs), it reads the port's own: a drivers'
``roofline.json`` (``--profile-dir``; each device-timed phase's GB/s or
GFLOP/s, higher is better) and ``bench_pack``'s printed lines saved to a
file (each face's GB/s).  The fabric probe's artifacts wait for the
multi-card port (ROADMAP.md queue 1 item 13) and are not recognized.

The **regression gate** compares each series' newest value against the
median of its trailing window: a drop past the threshold on a
higher-is-better series flags (a rise on a ``better: "lower"`` one).
``python -m stencil_tpu_torch.bin.perf_ledger`` is the CLI (ingest / check
/ show).

It imports no torch: the ledger is bookkeeping over files.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

#: default gate: flag when the newest value drops more than 10% below the
#: trailing median
DEFAULT_THRESHOLD = 0.10
#: trailing entries (before the newest) the median is taken over
DEFAULT_WINDOW = 5


# --- artifact -> entries ------------------------------------------------------


def _bench_doc(doc: dict) -> Optional[dict]:
    """The bench result dict inside an artifact: the raw one-line JSON, the
    judge wrapper's ``parsed`` field, or — when a failed run left
    ``parsed: null`` — the last JSON-looking line of its ``tail``."""
    if not isinstance(doc, dict):
        return None
    if "metric" in doc:
        return doc
    parsed = doc.get("parsed")
    if isinstance(parsed, dict) and "metric" in parsed:
        return parsed
    tail = doc.get("tail")
    if isinstance(tail, str):
        for line in reversed(tail.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    cand = json.loads(line)
                except ValueError:
                    continue
                if isinstance(cand, dict) and "metric" in cand:
                    return cand
    return None


def _entry(ts: float, key: str, value, unit: str, source: str, **extra) -> Optional[dict]:
    if not isinstance(value, (int, float)):
        return None
    e = {"ts": ts, "key": key, "value": float(value), "unit": unit,
         "source": source}
    e.update(extra)
    return e


#: one line of ``bin/bench_pack``: ``<ext> <dir> <bytes> <pack s> <unpack s>
#: <GB/s>GB/s``, or ``<ext> <dir> <bytes> roundtrip <s> <GB/s>GB/s``
_BENCH_PACK_LINE = re.compile(
    r"^(?P<ext>\[[\d,]+\]) (?P<dir>\[[-\d,]+\]) (?P<bytes>\d+) "
    r"(?:roundtrip (?P<rt>\S+)|(?P<pack>\S+) (?P<unpack>\S+)) (?P<gbps>[\d.]+)GB/s$"
)


def _bench_pack_entries(text: str, ts: float, source: str) -> List[dict]:
    """``bench_pack``'s lines as ``bench_pack:<ext>:<dir>:gbps`` (the faster of
    pack and unpack) or ``...:roundtrip_gbps`` series, higher is better."""
    out = []
    for line in text.splitlines():
        m = _BENCH_PACK_LINE.match(line.strip())
        if m is None:
            continue
        kind = "roundtrip_gbps" if m.group("rt") else "gbps"
        out.append(_entry(ts, f"bench_pack:{m.group('ext')}:{m.group('dir')}:{kind}", float(m.group("gbps")),
                          "GB/s", source, bytes=int(m.group("bytes"))))
    return out


def entries_from_artifact(path: str) -> List[dict]:
    """Normalize one artifact file (a ``BENCH_*.json`` bench result, raw or
    judge-wrapped, a ``weak_scaling_summary.json`` sweep, a comms roofline,
    a soak or serve summary, a ``bench_exchange`` route-A/B JSON line saved
    to a file, a drivers' ``roofline.json``, or ``bench_pack``'s lines saved
    to a file) into ledger entries.  Unknown shapes return [] rather than
    raising: the ingest loop runs over globs."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except (OSError, UnicodeDecodeError):
        return []
    ts = os.path.getmtime(path)
    source = os.path.basename(path)
    try:
        doc = json.loads(text)
    except ValueError:
        return _bench_pack_entries(text, ts, source)
    out: List[dict] = []

    bench = _bench_doc(doc)
    if bench is not None:
        # the tune decision is the closest thing a BENCH artifact carries
        # to its workload key — ride it along so ledger diffs can tell a
        # perf change from a config change
        extra = {}
        tune = bench.get("tune") or {}
        if tune.get("config") is not None:
            extra["tune_config"] = tune["config"]
        if tune.get("source"):
            extra["tune_source"] = tune["source"]
        out.append(
            _entry(ts, bench.get("metric", "bench"), bench.get("value"),
                   bench.get("unit", ""), source, **extra)
        )
        for field, unit in (
            ("exchange_path_mcells_per_s_per_chip", "Mcells/s"),
            ("astaroth_8q_mupdates_per_s", "Mupdates/s"),
            ("chip_copy_gbps", "GB/s"),
        ):
            out.append(_entry(ts, f"bench.{field}", bench.get(field), unit, source))
        # the compute-unit A/B legs (bench.py mxu_vs_vpu: vpu / mxu /
        # mxu_band / mxu_band+bf16in) as their own series — higher is
        # better, so the trailing-median gate catches a contraction-leg
        # regression exactly like a headline drop
        mxu_ab = bench.get("mxu_vs_vpu") or {}
        for leg, d in sorted((mxu_ab.get("units") or {}).items()):
            out.append(
                _entry(
                    ts,
                    f"mxu_ab:{leg}:mcells_per_s",
                    (d or {}).get("mcells_per_s"),
                    "Mcells/s",
                    source,
                    k=mxu_ab.get("k"),
                )
            )
        # the numerics observatory's on/off A/B (bench.py
        # numerics_overhead): per-snapshot cost of the fused on-device
        # field-health dispatch — LOWER-is-better (the gate flags a rise),
        # so the "cheap enough to leave on" claim is enforced per round
        num_ab = bench.get("numerics_overhead") or {}
        out.append(
            _entry(
                ts,
                "numerics:overhead",
                num_ab.get("snapshot_ms"),
                "ms",
                source,
                better="lower",
                quantities=num_ab.get("quantities"),
            )
        )
        return [e for e in out if e is not None]

    if isinstance(doc, dict) and doc.get("bench") == "weak_scaling_sweep":
        for m in doc.get("meshes", []):
            mesh = "x".join(str(v) for v in (m.get("mesh") or []))
            for ov, val in (m.get("mcells_per_s_per_chip") or {}).items():
                out.append(
                    _entry(ts, f"weak:{mesh}:{ov}", val, "Mcells/s/chip",
                           source, chips=m.get("chips"))
                )
            # the per-hop attribution table (analytic bytes per mesh hop,
            # bin/weak.py): LOWER-is-better — a rise means the halo traffic
            # over that link GREW (a decomposition/packing regression)
            for hop in m.get("exchange_hops") or []:
                out.append(
                    _entry(
                        ts,
                        f"exchange_hop:{mesh}:{hop.get('axis')}."
                        f"{hop.get('side')}:bytes",
                        hop.get("bytes"),
                        "B",
                        source,
                        better="lower",
                        hop_source=hop.get("source"),
                    )
                )
        return [e for e in out if e is not None]

    if isinstance(doc, dict) and doc.get("bench") == "comms_roofline":
        # perf_report.py --json: measured per-hop exchange rates from the
        # trace join — higher-is-better achieved GB/s per direction, plus
        # the direction-attribution coverage (a drop there means exchange
        # device time stopped landing on registered scopes)
        for span, hop in sorted((doc.get("hops") or {}).items()):
            out.append(
                _entry(
                    ts,
                    f"exchange_hop:{hop.get('axis')}.{hop.get('direction')}:gbps",
                    hop.get("gbps"), "GB/s", source,
                    probed_gbps=hop.get("probed_gbps"),
                    device_ms=hop.get("device_ms"),
                )
            )
        out.append(
            _entry(ts, "exchange_hop:coverage", doc.get("coverage"), "",
                   source, bottleneck_axis=doc.get("bottleneck_axis"))
        )
        return [e for e in out if e is not None]

    if isinstance(doc, dict) and "phases" in doc and "peaks" in doc:
        # a drivers' roofline.json (telemetry/roofline.py): each phase's
        # achieved GB/s and GFLOP/s, higher is better.  Only device-timed
        # reports land: a host-span stand-in bounds nothing.
        if doc.get("source") != "device":
            return []
        chip = (doc.get("peaks") or {}).get("chip")
        for phase, e in sorted((doc.get("phases") or {}).items()):
            out.append(_entry(ts, f"roofline:{phase}:gbps", e.get("gbps"), "GB/s", source, chip=chip,
                              device_ms=e.get("device_ms"), counters_scope=doc.get("counters_scope")))
            out.append(_entry(ts, f"roofline:{phase}:gflops", e.get("gflops"), "GFLOP/s", source, chip=chip,
                              device_ms=e.get("device_ms"), counters_scope=doc.get("counters_scope")))
        return [e for e in out if e is not None]

    if isinstance(doc, dict) and doc.get("bench") == "soak_kill_resume":
        # the chaos soak (scripts/run_soak.py): recovery wall clock and the
        # per-transition in-memory reshard timings — both LOWER-is-better
        # (``better: "lower"``; the gate flags rises, not drops).  Only
        # bitwise-identical soaks land: a failed soak's timings describe a
        # broken run, not a perf point.
        if not doc.get("bitwise_identical"):
            return []
        out.append(
            _entry(
                ts, "soak:recovery_seconds", doc.get("recovery_seconds"),
                "s", source, better="lower", kills=len(doc.get("kills") or []),
            )
        )
        rs = [v for v in doc.get("reshard_seconds") or [] if isinstance(v, (int, float))]
        if rs:
            out.append(
                _entry(
                    ts, "reshard:seconds", _median(rs), "s", source,
                    better="lower", transitions=len(rs),
                )
            )
        return [e for e in out if e is not None]

    if isinstance(doc, dict) and doc.get("bench") == "serve_soak":
        # the serving chaos soak / load-generator artifact (run_soak.py
        # --serve, bin/stencil_serve.py): fleet-wide p99 latency and the
        # shed rate — both LOWER-is-better SLO series.  Only soaks whose
        # isolation verdict held land: a run where a poisoned tenant bled
        # into its neighbors describes a broken server, not an SLO point.
        if not doc.get("isolation_ok", doc.get("bitwise_identical")):
            return []
        out.append(
            _entry(
                ts, "serve:p99_ms", doc.get("p99_ms"), "ms", source,
                better="lower", tenants=len(doc.get("tenants") or []),
            )
        )
        out.append(
            _entry(
                ts, "serve:shed_rate", doc.get("shed_rate"), "", source,
                better="lower", requests=doc.get("requests"),
            )
        )
        # aggregate serving throughput (batched/sub-slice packed dispatch
        # lands here as a rate climb) — HIGHER-is-better, the one serve
        # series where the gate flags drops
        tp = doc.get("throughput") or {}
        out.append(
            _entry(
                ts, "serve:throughput", tp.get("requests_per_s"), "1/s",
                source, mcells_per_s=tp.get("mcells_per_s"),
                batch_max=tp.get("batch_max"), subslice=tp.get("subslice"),
            )
        )
        return [e for e in out if e is not None]

    if isinstance(doc, dict) and doc.get("bench") == "exchange":
        # bench_exchange's route A/B (the packed-route wins): direct's
        # steady-state rate plus every packed route's speedup-vs-direct —
        # all higher-is-better, so the trailing-median gate catches a
        # packed-route regression exactly like a headline drop
        ab = doc.get("route_ab") or {}
        direct = ((ab.get("routes") or {}).get("direct") or {}).get(
            "ms_per_exchange"
        )
        if isinstance(direct, (int, float)) and direct > 0:
            out.append(
                _entry(
                    ts,
                    "exchange_ab:direct:exchanges_per_s",
                    1e3 / direct,
                    "1/s",
                    source,
                    extent=doc.get("extent"),
                    quantities=doc.get("quantities"),
                )
            )
        for route, sp in (ab.get("speedup_vs_direct") or {}).items():
            out.append(
                _entry(ts, f"exchange_ab:{route}:speedup", sp, "x", source)
            )
        return [e for e in out if e is not None]

    return []


# --- the ledger file ----------------------------------------------------------


def read_ledger(path: str) -> List[dict]:
    """All entries, file order (= append order).  Truncated trailing lines
    (a crash mid-append) are skipped — every complete line is one document."""
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return out


def _dedupe_key(e: dict):
    """Identity of one MEASUREMENT: series + source + timestamp.  ``ts``
    must participate — artifact entries stamp the file mtime and live
    bench entries stamp now, so re-ingesting the SAME file is a no-op
    while a regenerated artifact (new mtime) or a fresh ``bench.py
    --ledger`` run (new clock) grows the series; keying on
    ``(key, source)`` alone would cap every repeat-source series at one
    entry forever."""
    return (e.get("key"), e.get("source"), e.get("ts"))


def append_entries(path: str, entries: List[dict]) -> int:
    """Append ``entries`` not already present (dedupe on
    ``(key, source, ts)`` — re-ingesting the same artifacts is
    idempotent); returns how many landed.  Append-mode by design: the
    ledger is the one artifact whose whole point is never rewriting
    history."""
    entries = [e for e in entries if e is not None]
    have = {_dedupe_key(e) for e in read_ledger(path)}
    fresh = [e for e in entries if _dedupe_key(e) not in have]
    if not fresh:
        return 0
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        for e in fresh:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(fresh)


# --- the regression gate ------------------------------------------------------


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if n % 2:
        return xs[n // 2]
    return (xs[n // 2 - 1] + xs[n // 2]) / 2


def check_regressions(
    entries: List[dict],
    threshold: float = DEFAULT_THRESHOLD,
    window: int = DEFAULT_WINDOW,
) -> Tuple[List[dict], List[dict]]:
    """Gate every series: newest value vs the median of up to ``window``
    trailing entries.  Series are higher-is-better throughputs unless the
    newest entry carries ``better: "lower"`` (the soak's seconds series) —
    there a RISE past the threshold flags instead of a drop.  Returns
    ``(rows, regressions)`` — one row per series with >= 2 entries:

        {"key", "value", "trailing_median", "ratio", "n", "regressed"}

    ``regressed`` is True when ``value < (1 - threshold) * median`` (or
    ``value > (1 + threshold) * median`` for lower-is-better series).
    Single-entry series have no history to regress against and are
    reported with ``trailing_median: None``.
    """
    by_key = {}
    for e in entries:
        if isinstance(e.get("value"), (int, float)) and e.get("key"):
            by_key.setdefault(e["key"], []).append(e)
    rows, regressions = [], []
    for key in sorted(by_key):
        # series order is LEDGER order (= append order): the ledger is
        # append-only, so position is the honest round ordering — file
        # mtimes are scrambled by any fresh checkout, and ``ts`` stays
        # informational only
        series = by_key[key]
        newest = series[-1]
        prior = [e["value"] for e in series[:-1]][-window:]
        row = {
            "key": key,
            "value": newest["value"],
            "unit": newest.get("unit", ""),
            "source": newest.get("source"),
            "trailing_median": _median(prior) if prior else None,
            "n": len(series),
            "ratio": None,
            "regressed": False,
        }
        if prior and row["trailing_median"]:
            row["ratio"] = round(newest["value"] / row["trailing_median"], 4)
            if newest.get("better") == "lower":
                row["regressed"] = newest["value"] > (1.0 + threshold) * row[
                    "trailing_median"
                ]
            else:
                row["regressed"] = newest["value"] < (1.0 - threshold) * row[
                    "trailing_median"
                ]
        rows.append(row)
        if row["regressed"]:
            regressions.append(row)
    return rows, regressions
