"""Device-time attribution: parse ``torch.profiler`` traces offline and
attribute DEVICE time to the scopes the port enters and to its kernel
families.

Counterpart of ``stencil_tpu/telemetry/device.py``, with the same names and
the same results on the same events.  The host span tracer (``spans.py``)
sees wall clock only: a call that returns at enqueue looks free, and the
exchange's real cost, the split schedule's overlap and the tensor-core
contraction's share of a step are knowable only from the device timeline.

* **Capture** (``ProfileCapture``): a cadence-gated ``telemetry.trace``
  around numbered dispatches (``STENCIL_PROFILE_EVERY`` / ``--profile-dir``).
  A profiler that will not start warns once and the run goes on unprofiled.
  At a window's edges the capture flushes the counters' pending counts and
  snapshots ``CAPTURE_COUNTERS`` and the kernel wrappers' launch counts
  (``kernels.ledger.launch_counts``), so the roofline divides the window's
  work by the window's device time, and the launches a trace held are held
  against the launches counted.
* **Parse** (``find_trace_files`` / ``load_trace_events``): the Chrome
  trace-event JSON ``torch.profiler`` exports (``*.pt.trace.json``, gzipped
  or plain), read back with the standard library alone.
* **Attribute** (``attribute_device_time``): device-row durations summed per
  phase.  The trace Kineto writes differs from XLA's:

  - device rows are the events of category ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset`` (``DEVICE_CATS``), on pids that are device indices; they
    are selected by category as well as by process name, since Kineto may
    name a card's process after the program;
  - the scope names do not ride in a kernel's arguments, as XLA's op
    metadata carries them.  A row takes the scopes of the
    ``gpu_user_annotation`` intervals (the innermost scope Kineto projected
    onto the row's stream) that hold it, and those of the CPU
    ``user_annotation`` ranges that hold the launch whose ``correlation`` id
    it carries (every enclosing scope, where the launch was recorded); each
    row's ``via`` says which of the two held;
  - ``gpu_user_annotation`` rows are intervals over other rows, not device
    work: they count toward no total.

  A trace with none of those categories (XLA's, or the host Chrome trace
  of ``telemetry.dump_chrome_trace``) is attributed exactly as the JAX
  package attributes it.
* **Merge** (``merge_device_rows`` / ``merge_into_chrome_trace``): the
  device rows appended to the host Chrome trace, shifted onto its clock, so
  Perfetto shows host spans and device kernels on one timeline.

Everything here except ``_OneCapture`` imports neither torch nor anything
of the JAX package: a dead run's trace must parse offline.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

from stencil_tpu_torch.telemetry import names

#: the port's kernel symbols by family (the CUDA source that holds them); a
#: family's launches are counted by the wrappers whose ledger entry names
#: the source
KERNEL_FAMILIES: Dict[str, Tuple[str, ...]] = {
    "stencil_tpu_torch/csrc/jacobi_wavefront.cu": ("jacobi_queue",),
    "stencil_tpu_torch/csrc/pack.cu": ("slab_rows_kernel", "slab_cells_kernel", "yshell_rows_kernel",
                                       "zshell_tile_kernel"),
    "stencil_tpu_torch/csrc/plane_stencil.cu": ("mean6_plane_level", "mean6_plane_mxu"),
    "stencil_tpu_torch/csrc/stream_plane.cu": ("plane_level", "plane_level_mxu", "plane_band"),
    "stencil_tpu_torch/csrc/stream_wavefront.cu": ("wavefront",),
    "stencil_tpu_torch/csrc/stream_wrap.cu": ("wrap_level", "wrap_level_mxu"),
}

#: the named-scope/kernel families device time is attributed to.  The two
#: ``step.overlap.*`` entries are the split schedule's scopes (names.py);
#: ``exchange`` is the time inside ``domain.exchange`` and the direction
#: scopes (the port has no collectives: its sends are torch copies and the
#: halo writes); ``pack`` is the shell and blend kernels of ``csrc/pack.cu``;
#: ``mxu`` the tensor-core contraction kernels: the ``*_mxu`` and fused
#: ``plane_band`` symbols, and the Jacobi kernels' contraction form, whose
#: symbol is the vpu form's (the unit is a build macro) and whose launches
#: the model scopes ``kernel.mxu.flops``.  Matching is case-insensitive
#: substring over the row's name, its string args and its scopes.  Where the
#: JAX package matches XLA's collective, pack and dot kernel names, these
#: match the port's.
PHASE_PATTERNS: Dict[str, Tuple[str, ...]] = {
    names.SPAN_OVERLAP_INTERIOR: (names.SPAN_OVERLAP_INTERIOR,),
    names.SPAN_OVERLAP_EXTERIOR: (names.SPAN_OVERLAP_EXTERIOR,),
    "exchange": (names.SPAN_EXCHANGE,) + tuple(sorted(names.EXCHANGE_DIRECTION_SPANS.values())),
    "pack": KERNEL_FAMILIES["stencil_tpu_torch/csrc/pack.cu"],
    "mxu": ("_mxu", "plane_band", names.KERNEL_MXU_FLOPS),
    "step": (names.SPAN_STEP,),
}

#: one phase per registered exchange direction scope (``exchange.x.low``
#: ...): the per-hop view of the exchange family for the comms roofline;
#: ops/exchange.py enters these around every send of a sweep
EXCHANGE_DIRECTION_PHASES: Dict[str, Tuple[str, ...]] = {
    span: (span,) for span in sorted(names.EXCHANGE_DIRECTION_SPANS.values())
}

#: process-name patterns that mark a trace pid as a DEVICE row source
_DEVICE_PROCESS_RE = re.compile(r"/device:|TPU|GPU|XLA|Device|Chip", re.IGNORECASE)

#: Kineto's categories of device work (the rows that count)
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: Kineto's scope projected onto a stream's device timeline
GPU_ANNOTATION_CAT = "gpu_user_annotation"
#: a ``record_function`` range on the host
CPU_ANNOTATION_CAT = "user_annotation"
#: host-side launch calls, which carry the ``correlation`` id of their row
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})

#: pid offset applied to device processes when merging into the host trace
#: (host spans use pid = rank, a small integer)
DEVICE_PID_BASE = 1000

#: the analytic counters a capture snapshots at its window's edges, so the
#: roofline divides the window's work by the window's device time
CAPTURE_COUNTERS = (
    names.EXCHANGE_BYTES,
    names.EXCHANGE_PACKED_BYTES,
    names.KERNEL_MXU_FLOPS,
) + tuple(sorted(names.EXCHANGE_HOP_BYTES.values()))


# --- locating and loading trace dumps ----------------------------------------


def find_trace_files(profile_dir: str) -> List[str]:
    """Every ``*.trace.json`` / ``*.trace.json.gz`` under ``profile_dir``
    (``*.pt.trace.json`` included), newest first by mtime."""
    out = []
    for dirpath, _dirnames, files in os.walk(profile_dir):
        for f in files:
            if f.endswith((".trace.json", ".trace.json.gz")):
                out.append(os.path.join(dirpath, f))
    return sorted(out, key=lambda p: (os.path.getmtime(p), p), reverse=True)


def load_trace_events(path: str) -> List[dict]:
    """The trace-event list of one dump: the wrapped ``{"traceEvents": [...]}``
    object or a bare array, gzipped or plain.  A truncated or corrupt dump
    returns [] rather than raising: post-mortem tooling runs on those."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError, EOFError):
        return []
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict)]


def is_kineto(events: Iterable[dict]) -> bool:
    """Does the trace hold Kineto's device categories."""
    return any(e.get("cat") in DEVICE_CATS for e in events)


def device_pids(events: Iterable[dict]) -> Dict[int, str]:
    """pid -> process name for every process that is a device timeline: its
    ``process_name`` metadata matches /device:|TPU|GPU|XLA/, or it holds rows
    of a device category (``DEVICE_CATS``, ``gpu_user_annotation``)."""
    events = list(events)
    out: Dict[int, str] = {}
    pnames: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname = str((e.get("args") or {}).get("name", ""))
            pnames[e.get("pid", 0)] = pname
            if _DEVICE_PROCESS_RE.search(pname):
                out[e.get("pid", 0)] = pname
    for e in events:
        if e.get("cat") in DEVICE_CATS or e.get("cat") == GPU_ANNOTATION_CAT:
            pid = e.get("pid", 0)
            if pid not in out:
                out[pid] = f"GPU {pid}" if not _DEVICE_PROCESS_RE.search(pnames.get(pid, "")) else pnames[pid]
    return out


def _event_text(e: dict) -> str:
    """The searchable text of one event: its name plus every string arg."""
    parts = [str(e.get("name", ""))]
    args = e.get("args")
    if isinstance(args, dict):
        parts.extend(str(v) for v in args.values() if isinstance(v, str))
    return " ".join(parts).lower()


def kernel_symbol(name: str) -> str:
    """The bare function name of a demangled kernel name: ``void (anonymous
    namespace)::jacobi_queue<8, 1, false, true>(...)`` -> ``jacobi_queue``."""
    head = name.replace("(anonymous namespace)", "anon")
    for stop in ("<", "("):
        head = head.split(stop, 1)[0]
    head = head.strip().split()[-1] if head.strip() else ""
    return head.rsplit("::", 1)[-1]


_SYMBOL_FAMILY = {sym: src for src, syms in KERNEL_FAMILIES.items() for sym in syms}


def kernel_family(name: str) -> Optional[str]:
    """The CUDA source (``KERNEL_FAMILIES``) of a device row's kernel, or None
    for a kernel that is not the port's (torch's own copies and
    elementwise kernels)."""
    return _SYMBOL_FAMILY.get(kernel_symbol(name))


# --- scopes of Kineto's device rows ------------------------------------------


def _holding(ranges: List[Tuple[float, float, str]], points: List[Tuple[float, int]],
             eps: float = 0.0) -> Dict[int, List[str]]:
    """For each ``(t, key)`` point the names of the ``(start, end, name)``
    ranges that hold it (``start - eps <= t <= end + eps``), outer first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: Dict[int, List[str]] = {}
    active: List[Tuple[float, float, str]] = []
    i = 0
    for t, key in sorted(points):
        while i < len(ranges) and ranges[i][0] - eps <= t:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] + eps >= t]
        if active:
            out[key] = [r[2] for r in active]
    return out


def _row_scopes(events: List[dict], rows: List[int]) -> Tuple[Dict[int, List[str]], Dict[int, str]]:
    """Scope names of each device row (by index into ``events``) and how they
    were found: ``gpu_user_annotation`` (an interval on the row's stream
    holds it), ``correlation`` (a CPU ``user_annotation`` range holds its
    launch), ``both`` or ``none``."""
    gpu: Dict[tuple, List[Tuple[float, float, str]]] = {}
    cpu: Dict[tuple, List[Tuple[float, float, str]]] = {}
    launches: Dict[int, Tuple[tuple, float]] = {}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0) or 0.0)
        where = (e.get("pid"), e.get("tid"))
        if cat == GPU_ANNOTATION_CAT:
            gpu.setdefault(where, []).append((ts, end, str(e.get("name", ""))))
        elif cat == CPU_ANNOTATION_CAT:
            cpu.setdefault(where, []).append((ts, end, str(e.get("name", ""))))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (where, ts)
    by_gpu: Dict[int, List[str]] = {}
    for where, ranges in gpu.items():
        pts = [(float(events[i].get("ts", 0.0)), i) for i in rows
               if (events[i].get("pid"), events[i].get("tid")) == where]
        by_gpu.update(_holding(ranges, pts, eps=0.5))
    by_cpu: Dict[int, List[str]] = {}
    pts_by: Dict[tuple, List[Tuple[float, int]]] = {}
    for i in rows:
        corr = (events[i].get("args") or {}).get("correlation")
        if corr in launches:
            where, ts = launches[corr]
            pts_by.setdefault(where, []).append((ts, i))
    for where, pts in pts_by.items():
        by_cpu.update(_holding(cpu.get(where, []), pts))
    scopes, via = {}, {}
    for i in rows:
        g, c = by_gpu.get(i), by_cpu.get(i)
        scopes[i] = list(dict.fromkeys((c or []) + (g or [])))
        via[i] = "both" if g and c else "gpu_user_annotation" if g else "correlation" if c else "none"
    return scopes, via


# --- attribution -------------------------------------------------------------


def attribute_device_time(
    events: List[dict],
    phases: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> Dict[str, dict]:
    """Sum device-row durations per phase.

    Returns ``{phase: {"device_us": float, "events": int}}`` plus two
    synthetic rows: ``_total`` (all device rows) and ``_unattributed``
    (device time matching no phase).  A row matching several phases counts
    toward each (an interior-scope contraction kernel is both
    ``step.overlap.interior`` and ``mxu`` time), so rows are views of the
    device timeline, not a partition: only ``_total`` is additive.

    Row selection: a Kineto trace (``is_kineto``) counts its device-category
    rows, each matched with its scopes (module docstring); every phase row
    then also carries ``via``, the rows matched through each scope source,
    and a ``_via`` row counts them over all rows.  Otherwise, as in the JAX
    package: with process metadata, only events on device processes count
    (a host-only dump attributes zero device time rather than wall clock);
    with none at all (the host Chrome trace, a bare array), every complete
    event counts: the host-span fallback's input.
    """
    phases = PHASE_PATTERNS if phases is None else phases
    out = {p: {"device_us": 0.0, "events": 0} for p in phases}
    out["_total"] = {"device_us": 0.0, "events": 0}
    out["_unattributed"] = {"device_us": 0.0, "events": 0}
    pats = {p: tuple(s.lower() for s in subs) for p, subs in phases.items()}
    kineto = is_kineto(events)
    if kineto:
        rows = [i for i, e in enumerate(events) if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        scopes, via = _row_scopes(events, rows)
        for p in phases:
            out[p]["via"] = {}
        out["_via"] = {}
    else:
        dev = device_pids(events)
        has_process_meta = any(e.get("ph") == "M" and e.get("name") == "process_name" for e in events)
        rows = [i for i, e in enumerate(events)
                if e.get("ph") == "X" and not (has_process_meta and e.get("pid") not in dev)]
    for i in rows:
        e = events[i]
        dur = float(e.get("dur", 0.0) or 0.0)
        out["_total"]["device_us"] += dur
        out["_total"]["events"] += 1
        text = _event_text(e)
        if kineto:
            text = " ".join([text] + [s.lower() for s in scopes[i]])
            out["_via"][via[i]] = out["_via"].get(via[i], 0) + 1
        hit = False
        for p, subs in pats.items():
            if any(s in text for s in subs):
                out[p]["device_us"] += dur
                out[p]["events"] += 1
                if kineto:
                    out[p]["via"][via[i]] = out[p]["via"].get(via[i], 0) + 1
                hit = True
        if not hit:
            out["_unattributed"]["device_us"] += dur
            out["_unattributed"]["events"] += 1
    return out


def attribute_exchange_directions(events: List[dict]) -> dict:
    """Exchange device time per exchange DIRECTION: the per-hop half of the
    comms roofline join.

    Runs ``attribute_device_time`` with one phase per registered
    ``exchange.<axis>.<side>`` scope plus the whole exchange family, and
    returns::

        {"directions": {span: {"device_us", "events"}},   # all six, zeros kept
         "exchange_device_us": float,   # the exchange-family total
         "attributed_us": float,        # summed direction time
         "coverage": float | None,      # attributed / exchange; None when no
                                        # exchange device time was seen
         "total_device_us": float}

    Direction rows are disjoint views (one direction scope holds a send), so
    ``attributed_us`` is additive and ``coverage`` is the share of the
    exchange that landed on a named hop.  The port's ``domain.exchange``
    scope also holds work outside every direction (the halo writes after a
    sweep's sends), so its coverage stays below 1 where the JAX package's
    collectives reach it."""
    phases = dict(EXCHANGE_DIRECTION_PHASES)
    phases["exchange"] = PHASE_PATTERNS["exchange"]
    att = attribute_device_time(events, phases)
    directions = {span: {k: att[span][k] for k in ("device_us", "events")} for span in EXCHANGE_DIRECTION_PHASES}
    exchange_us = att["exchange"]["device_us"]
    attributed_us = sum(d["device_us"] for d in directions.values())
    return {
        "directions": directions,
        "exchange_device_us": exchange_us,
        "attributed_us": attributed_us,
        "coverage": (attributed_us / exchange_us) if exchange_us > 0 else None,
        "total_device_us": att["_total"]["device_us"],
    }


def _union_us(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _intersect_us(x: List[Tuple[float, float]], y: List[Tuple[float, float]]) -> float:
    """The measure of the intersection of two sorted disjoint interval lists."""
    total = 0.0
    ends = [q[1] for q in y]
    for a, b in x:
        j = bisect.bisect_left(ends, a)
        while j < len(y) and y[j][0] < b:
            total += max(0.0, min(b, y[j][1]) - max(a, y[j][0]))
            j += 1
    return total


def overlap_report(events: List[dict], a: str = names.SPAN_OVERLAP_INTERIOR,
                   b: str = names.SPAN_OVERLAP_EXTERIOR) -> Optional[dict]:
    """Device time of two scopes per stream and the time both ran at once
    (the split schedule's interior and exterior by default) on a Kineto
    trace: ``{a: {"device_us", "events", "streams": {tid: us}}, b: {...},
    "overlap_us": float, "overlap_share": overlap / min(a, b)}``; None on
    another trace."""
    if not is_kineto(events):
        return None
    rows = [i for i, e in enumerate(events) if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    scopes, _via = _row_scopes(events, rows)
    out, spans = {}, {}
    for scope in (a, b):
        rec = {"device_us": 0.0, "events": 0, "streams": {}}
        ivs = []
        for i in rows:
            if any(scope in s for s in scopes[i]):
                e = events[i]
                ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0) or 0.0)
                rec["device_us"] += dur
                rec["events"] += 1
                tid = str(e.get("tid"))
                rec["streams"][tid] = rec["streams"].get(tid, 0.0) + dur
                ivs.append((ts, ts + dur))
        out[scope] = rec
        spans[scope] = _union_us(ivs)
    both = _intersect_us(spans[a], spans[b])
    least = min(out[a]["device_us"], out[b]["device_us"])
    out["overlap_us"] = both
    out["overlap_share"] = both / least if least > 0 else None
    return out


def launches_held(events: List[dict], counted: Optional[Dict[str, int]] = None) -> Dict[str, dict]:
    """Per kernel family (``KERNEL_FAMILIES``, keyed by source): the device
    rows the trace holds of its kernels beside the launches its wrappers
    counted over the same window (``counted``: ``kernels.ledger``'s counts by
    wrapper and form, from ``ProfileCapture``).  ``short`` flags a trace that
    held fewer rows than were counted (Kineto drops launches); the reading
    is reported as it is, never scaled.  A wrapper call may launch more than
    one kernel (the wrap route's marches), so ``held`` may exceed
    ``counted``."""
    held: Dict[str, int] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            fam = kernel_family(str(e.get("name", "")))
            if fam is not None:
                held[fam] = held.get(fam, 0) + 1
    by_source: Dict[str, int] = {}
    if counted:
        from stencil_tpu_torch.kernels import ledger

        sources = {ledger.wrapper_name(e): e["source"] for e in ledger.ported().values()}
        sources.update({name: ledger.form_entry(name)["source"] for name in ledger.FORMS})
        for name, n in counted.items():
            if n and name in sources:
                by_source[sources[name]] = by_source.get(sources[name], 0) + n
    out = {}
    for fam in sorted(set(held) | set(by_source)):
        h, c = held.get(fam, 0), by_source.get(fam, 0) if counted is not None else None
        out[fam] = {"held": h, "counted": c, "short": c is not None and h < c}
    return out


# --- merging device rows into the host Chrome trace --------------------------


def merge_device_rows(
    host_events: List[dict],
    trace_events: List[dict],
    align_ts_us: Optional[float] = None,
) -> List[dict]:
    """Host Chrome-trace events + the device rows of a profiler dump, on one
    timeline.

    Device rows keep their relative timing but are SHIFTED so the earliest
    lands at ``align_ts_us`` (default: the earliest host span; the profiler's
    clock and the host ``perf_counter`` epoch share no zero).  Each row keeps
    its original timestamp under ``args.device_ts_us``; device pids are
    remapped past ``DEVICE_PID_BASE`` and re-announced with ``process_name``
    metadata.  Idempotent: rows of an earlier merge (pid >=
    ``DEVICE_PID_BASE``) are dropped first."""
    host_events = [e for e in host_events if int(e.get("pid", 0) or 0) < DEVICE_PID_BASE]
    dev = device_pids(trace_events)
    if not dev:
        return list(host_events)
    rows = [e for e in trace_events if e.get("ph") == "X" and e.get("pid") in dev]
    if not rows:
        return list(host_events)
    t0_dev = min(float(e.get("ts", 0.0)) for e in rows)
    if align_ts_us is None:
        host_ts = [float(e["ts"]) for e in host_events if e.get("ph") == "X"]
        align_ts_us = min(host_ts) if host_ts else 0.0
    shift = align_ts_us - t0_dev
    pid_map = {pid: DEVICE_PID_BASE + i for i, pid in enumerate(sorted(dev))}
    out = list(host_events)
    for pid, name in sorted(dev.items()):
        out.append({"name": "process_name", "ph": "M", "pid": pid_map[pid], "args": {"name": f"device: {name}"}})
    for e in rows:
        ts = float(e.get("ts", 0.0))
        args = dict(e.get("args") or {})
        args["device_ts_us"] = ts
        out.append({
            "name": e.get("name", ""),
            "ph": "X",
            "ts": ts + shift,
            "dur": float(e.get("dur", 0.0) or 0.0),
            "pid": pid_map[e["pid"]],
            "tid": e.get("tid", 0),
            "args": args,
        })
    return out


def merge_into_chrome_trace(chrome_path: str, profile_dir: str) -> Optional[dict]:
    """Merge the newest profiler dump under ``profile_dir`` into the host
    Chrome trace at ``chrome_path`` (atomic rewrite) and return the
    attribution table (None when either side is missing or empty)."""
    traces = find_trace_files(profile_dir)
    if not traces or not os.path.exists(chrome_path):
        return None
    trace_events = load_trace_events(traces[0])
    if not trace_events:
        return None
    try:
        with open(chrome_path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    doc["traceEvents"] = merge_device_rows(doc.get("traceEvents", []), trace_events)
    from stencil_tpu_torch.utils.artifact import atomic_write

    with atomic_write(chrome_path) as f:
        json.dump(doc, f)
    return attribute_device_time(trace_events)


# --- cadence capture ---------------------------------------------------------


class ProfileCapture:
    """Cadence-gated ``torch.profiler`` capture around numbered dispatches.

    ``maybe(i)`` is a context manager: it traces into ``<dir>/capture_<i>``
    when ``i`` is on the cadence (``every=N``: a capture at i = 0, N, 2N,
    ...; ``every=0``: exactly one, at i = 0) and is a no-op otherwise.  Each
    capture increments ``profile.captures`` and emits ``profile.capture``;
    ``telemetry.trace`` owns the degrade (warn once, run unprofiled).
    """

    def __init__(self, dir: str, every: int = 0):
        self.dir = str(dir)
        self.every = max(int(every), 0)
        self.captures = 0
        #: analytic-counter DELTAS over the newest capture's window
        #: (``CAPTURE_COUNTERS``); None before any capture
        self.last_counter_deltas: Optional[Dict[str, int]] = None
        #: the kernel wrappers' launch-count deltas over the newest window
        #: (``kernels.ledger.launch_counts`` names, nonzero only)
        self.last_launch_deltas: Optional[Dict[str, int]] = None

    @classmethod
    def from_env(cls, dir: Optional[str] = None) -> Optional["ProfileCapture"]:
        """``--profile-dir`` (or ``STENCIL_PROFILE_DIR``) with the
        ``STENCIL_PROFILE_EVERY`` cadence; None when no directory is set
        anywhere: profiling is opt-in."""
        from stencil_tpu_torch.utils.config import env_int, env_str

        dir = dir or env_str("STENCIL_PROFILE_DIR", None)
        if not dir:
            return None
        return cls(dir, every=env_int("STENCIL_PROFILE_EVERY", 0, minimum=0))

    def want(self, index: int) -> bool:
        if self.every == 0:
            return index == 0
        return index % self.every == 0

    def capture_dir(self, index: int) -> str:
        return os.path.join(self.dir, f"capture_{index:06d}")

    def maybe(self, index: int):
        if not self.want(index):
            import contextlib

            return contextlib.nullcontext()
        return _OneCapture(self, index)

    # --- offline views over the newest capture --------------------------------

    def newest_events(self) -> Optional[List[dict]]:
        traces = find_trace_files(self.dir)
        if not traces:
            return None
        return load_trace_events(traces[0]) or None

    def attribution(self) -> Optional[dict]:
        """Attribution over the newest capture (None when nothing was dumped:
        the profiler would not start)."""
        events = self.newest_events()
        return attribute_device_time(events) if events else None

    def launches(self) -> Optional[dict]:
        """``launches_held`` over the newest capture and its window's launch
        counts."""
        events = self.newest_events()
        return launches_held(events, self.last_launch_deltas) if events else None

    def counters_snapshot(self) -> Optional[dict]:
        """The newest capture's counter DELTAS as a snapshot-shaped dict
        (``{"counters": {...}}``) for ``roofline_report``."""
        if self.last_counter_deltas is None:
            return None
        return {"counters": dict(self.last_counter_deltas)}


class _OneCapture:
    """One cadence hit: flush the counters, open the trace, account the
    capture."""

    def __init__(self, owner: ProfileCapture, index: int):
        self.owner = owner
        self.index = index
        self._t0 = 0.0
        self._ctx = None

    @staticmethod
    def _read():
        from stencil_tpu_torch import telemetry
        from stencil_tpu_torch.kernels import ledger

        telemetry.flush()
        reg = telemetry._cfg().registry
        return {name: reg.counter(name).value for name in CAPTURE_COUNTERS}, ledger.launch_counts()

    def __enter__(self):
        from stencil_tpu_torch import telemetry
        from stencil_tpu_torch.telemetry.spans import trace

        self._c0, self._l0 = self._read()
        self._t0 = time.perf_counter()
        self._ctx = trace(self.owner.capture_dir(self.index))
        self._ctx.__enter__()
        telemetry._cfg().captures_open += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        from stencil_tpu_torch import telemetry

        telemetry._cfg().captures_open -= 1
        out = self._ctx.__exit__(exc_type, exc, tb)
        c1, l1 = self._read()
        self.owner.last_counter_deltas = {name: c1[name] - self._c0[name] for name in CAPTURE_COUNTERS}
        self.owner.last_launch_deltas = {k: v - self._l0.get(k, 0) for k, v in l1.items() if v != self._l0.get(k, 0)}
        self.owner.captures += 1
        telemetry.inc(names.PROFILE_CAPTURES)
        telemetry.emit_event(
            names.EVENT_PROFILE_CAPTURE,
            dir=self.owner.capture_dir(self.index),
            index=self.index,
            seconds=round(time.perf_counter() - self._t0, 6),
        )
        return out
