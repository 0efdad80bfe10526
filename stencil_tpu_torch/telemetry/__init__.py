"""Telemetry: metrics registry, span recorder, structured event log.

Counterpart of ``stencil_tpu/telemetry/__init__.py``, the facade's core:

* **metrics** (``metrics.py``): counters, gauges and histograms, histograms
  backed by ``utils/statistics.Statistics``; ``snapshot()`` returns the
  JSON-safe dict the drivers write with ``--metrics-out``;
* **spans** (``spans.py``): nestable wall-clock spans dumped as Chrome
  trace-event JSON, each entering ``torch.profiler.record_function``;
* **events** (``events.py``): the JSONL event log of the signals a program
  consumes (retries, divergence trips, checkpoints, watchdog stalls);
* **numerics** (``numerics.py``): the field-health engine the divergence
  sentinel and the ``--numerics-every`` cadence read;
* **the profiler** (``spans.py``): ``annotate(name)`` labels a region in a
  ``torch.profiler`` trace and ``trace(log_dir)`` captures one; ``scope(name)``
  labels it only while telemetry is on or a capture is open (the hot path's
  form: the exchange's direction scopes, the split schedule's halves);
* **device time** (``device.py``): the cadence capture ``ProfileCapture``
  and the offline parse of its Chrome traces, device time attributed to the
  scopes and the kernel families, the launches a trace held against those
  the wrappers counted; **roofline** (``roofline.py``): that time joined
  with the analytic counters into GB/s and FLOP/s beside the card's peaks;
  **ledger** (``ledger.py``): the append-only perf ledger and its
  regression gate.

Knobs (validated reads, ``utils/config.py``):

* ``STENCIL_TELEMETRY=1|0``: master switch (default: on iff a dir is set);
* ``STENCIL_TELEMETRY_DIR=D``: home of the events, trace and metrics files;
  implies on;
* ``STENCIL_TELEMETRY_EVENTS``: the JSONL sink on/off (default: on iff a
  dir is set).

Rules: while disabled, ``span()`` yields at once and ``observe`` /
``record_span`` return after one attribute check, with nothing formatted;
counters and gauges stay live always (an int add, or a source's pending
count that ``snapshot()`` adds in), so a ``snapshot()`` after a failed run
still counts its retries; the in-memory event ring records always.  Call sites name series through ``telemetry.names`` constants.

The flight recorder (``flight.py``: a supervised run's ``status.json`` and
``crash_report.json``) is here too, rendered by ``python -m
stencil_tpu_torch.status``.  The JAX facade's fabric probe waits for the
multi-card port (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
import weakref
from typing import List, Optional

from stencil_tpu_torch.telemetry import names
from stencil_tpu_torch.telemetry.events import EventSink
from stencil_tpu_torch.telemetry.metrics import MetricsRegistry
from stencil_tpu_torch.telemetry.spans import (  # noqa: F401  (annotate/trace re-export)
    SpanRecorder,
    annotate,
    profiler_scope,
    trace,
)
from stencil_tpu_torch.utils.logging import _rank

#: events kept in the in-memory ring (the tail a crash report reads)
RING_SIZE = 256

#: counters sampled onto Chrome counter tracks at every span record: the
#: cumulative series whose slope is the throughput shown beside the spans
_TRACK_COUNTERS = (names.EXCHANGE_BYTES,)


class _Telemetry:
    """Process-local state (the module functions below delegate)."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self.spans = SpanRecorder()
        self.sink: Optional[EventSink] = None
        self.enabled = False
        self.out_dir: Optional[str] = None
        self._configured = False
        #: the last events, recorded always (one deque append of the dict
        #: the caller built): the runs whose last events matter most are
        #: the ones that die with telemetry off
        self.ring = collections.deque(maxlen=RING_SIZE)
        #: objects that keep counts on their hot path (``add_source``)
        self.sources = weakref.WeakSet()
        #: device-profile captures open now (``device.ProfileCapture``): the
        #: hot path's scopes label their regions while one is
        self.captures_open = 0

    def configure_from_env(self) -> None:
        from stencil_tpu_torch.utils.config import env_bool, env_str

        out_dir = env_str("STENCIL_TELEMETRY_DIR", None)
        enabled = env_bool("STENCIL_TELEMETRY", out_dir is not None)
        events = env_bool("STENCIL_TELEMETRY_EVENTS", out_dir is not None)
        if events and out_dir is None and "STENCIL_TELEMETRY_EVENTS" in os.environ:
            # an explicit EVENTS=1 with nowhere to write is a configuration
            # error: the log asked for would never be written
            raise ValueError(
                "STENCIL_TELEMETRY_EVENTS=1 needs STENCIL_TELEMETRY_DIR to point at a writable directory "
                "(events are a JSONL file; set the dir or unset STENCIL_TELEMETRY_EVENTS)"
            )
        self.enabled = enabled
        self.out_dir = out_dir
        self.sink = EventSink(out_dir) if (enabled and events and out_dir) else None
        self._configured = True


_t = _Telemetry()


def _cfg() -> _Telemetry:
    if not _t._configured:
        _t.configure_from_env()
    return _t


# --- lifecycle ---------------------------------------------------------------


def enabled() -> bool:
    return _cfg().enabled


def enable(dir: Optional[str] = None, events: Optional[bool] = None) -> None:
    """Turn telemetry on (tests, the drivers' ``--metrics-out``).  ``dir``
    adds the JSONL event sink and a default home for the dumps; without it,
    spans and histograms record in memory only."""
    t = _t
    t._configured = True
    t.enabled = True
    if dir is not None:
        t.out_dir = str(dir)
        os.makedirs(t.out_dir, exist_ok=True)
    if events is None:
        events = t.out_dir is not None
    if events and t.out_dir is None:
        raise ValueError("telemetry events need a directory (enable(dir=...))")
    if t.sink is not None:
        t.sink.close()
    t.sink = EventSink(t.out_dir) if events else None


def disable() -> None:
    t = _t
    t._configured = True
    t.enabled = False
    if t.sink is not None:
        t.sink.close()
        t.sink = None
    t.out_dir = None


def reset() -> None:
    """Clear every metric, span and the event ring (counters restart at 0)."""
    t = _cfg()
    _flush(t)
    t.registry.reset()
    t.spans.clear()
    t.ring.clear()


# --- metrics -----------------------------------------------------------------


def inc(name: str, value: int = 1) -> None:
    """Increment a counter; always live (a dict hit and an int add)."""
    _cfg().registry.counter(name).inc(value)


def counter(name: str):
    """The ``Counter`` of ``name``, for a hot path that adds to it directly
    (``counter.value += n``); ``reset()`` zeroes it in place.  Read counts
    through ``snapshot()``, which adds the sources' pending counts first."""
    return _cfg().registry.counter(name)


def add_source(obj) -> None:
    """Register ``obj`` (held weakly), whose ``flush_telemetry()`` adds the
    counts it keeps on its hot path (a ``DistributedDomain``'s dispatches,
    iterations and exchanges: a few list adds a call) to the counters.
    ``snapshot()`` and ``reset()`` flush every live source first, so the
    counts they read are live."""
    _t.sources.add(obj)


def _flush(t: _Telemetry) -> None:
    for src in list(t.sources):
        src.flush_telemetry()


def flush() -> None:
    """Add every source's pending counts to the counters now (a capture
    window's edges read the counters directly)."""
    _flush(_cfg())


def set_gauge(name: str, value: float) -> None:
    _cfg().registry.gauge(name).set(value)


def observe(name: str, value: float) -> None:
    """Record one histogram sample, only while telemetry is enabled."""
    t = _cfg()
    if t.enabled:
        t.registry.histogram(name).observe(value)


def snapshot() -> dict:
    """JSON-safe dict of every metric; each registered counter appears (0
    when untouched) and each registered histogram (empty when never
    observed), so snapshots diff cleanly."""
    t = _cfg()
    _flush(t)
    return t.registry.snapshot(seed_counters=names.ALL_COUNTERS, seed_histograms=names.ALL_HISTOGRAMS)


# --- spans -------------------------------------------------------------------

#: the shared null context the hot path enters while nothing observes it
NULL_SCOPE = contextlib.nullcontext()


def scoping() -> bool:
    """Do the hot path's profiler scopes label their regions now: while
    telemetry is enabled or a device-profile capture is open.  Otherwise a
    call site enters nothing (a ``record_function`` costs microseconds)."""
    t = _cfg()
    return t.enabled or t.captures_open > 0


def scope(name: str):
    """``annotate(name)`` while ``scoping()``, else a shared null context."""
    return profiler_scope(name) if scoping() else NULL_SCOPE



@contextlib.contextmanager
def span(name: str, histogram: Optional[str] = None, **args):
    """Nestable wall-clock span.  Disabled: an immediate yield.  Enabled: a
    Chrome-trace event nested under the enclosing span, the duration
    observed into ``histogram`` when given, and the region labelled in a
    ``torch.profiler`` trace."""
    t = _cfg()
    if not t.enabled:
        yield
        return
    parent = t.spans.current()
    t.spans.push(name)
    t0 = time.perf_counter()
    try:
        with profiler_scope(name):
            yield
    finally:
        dur = time.perf_counter() - t0
        t.spans.pop()
        t.spans.record(name, t0, dur, parent=parent, **args)
        _sample_track_counters(t, t0 + dur)
        if histogram is not None:
            t.registry.histogram(histogram).observe(dur)


def record_span(name: str, t0: float, dur: float, histogram: Optional[str] = None, **args) -> None:
    """A span for a call site that timed itself (``t0`` from
    ``time.perf_counter``, ``dur`` seconds).  No-op while disabled."""
    t = _cfg()
    if not t.enabled:
        return
    t.spans.record(name, t0, dur, **args)
    _sample_track_counters(t, t0 + dur)
    if histogram is not None:
        t.registry.histogram(histogram).observe(dur)


def _sample_track_counters(t: _Telemetry, at: float) -> None:
    """The cumulative track counters onto their Chrome counter tracks at a
    span's end (``at``, a ``perf_counter`` value)."""
    for name in _TRACK_COUNTERS:
        t.spans.sample_counter(name, t.registry.counter(name).value, at)


def dump_chrome_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the recorded spans as Chrome trace-event JSON; returns the path
    (None when there is nothing to write or nowhere to put it)."""
    t = _cfg()
    events = t.spans.chrome_trace_events(pid=_rank())
    if not events:
        return None
    if path is None:
        if t.out_dir is None:
            return None
        path = os.path.join(t.out_dir, f"trace_{_rank()}.json")
    from stencil_tpu_torch.utils.artifact import atomic_write

    with atomic_write(path) as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


# --- events ------------------------------------------------------------------


def emit_event(name: str, **fields) -> None:
    """Append one structured event: to the in-memory ring always, to the
    JSONL sink while enabled with a sink directory."""
    t = _cfg()
    t.ring.append({"ts": time.time(), "event": name, **fields})
    if t.enabled and t.sink is not None:
        t.sink.emit(name, fields)


def recent_events(n: Optional[int] = None) -> List[dict]:
    """The last ``n`` (default: all retained) events of the ring, oldest
    first."""
    out = list(_cfg().ring)
    return out if n is None else out[-n:]


def event_log_path() -> Optional[str]:
    t = _cfg()
    return t.sink.path() if t.sink is not None else None


def dump_metrics(path: Optional[str] = None) -> Optional[str]:
    """Write the metrics snapshot as JSON; returns the path (None when
    there is nowhere to put it).  Default home: ``metrics_<rank>.json``
    beside the trace and the events."""
    t = _cfg()
    if path is None:
        if t.out_dir is None:
            return None
        path = os.path.join(t.out_dir, f"metrics_{_rank()}.json")
    from stencil_tpu_torch.utils.artifact import atomic_write_json

    return atomic_write_json(path, snapshot())


def write_artifacts() -> dict:
    """Flush the end-of-run files (the Chrome trace and the metrics; events
    stream live).  Returns ``{"trace": ..., "events": ..., "metrics": ...}``,
    a path or None each."""
    return {"trace": dump_chrome_trace(), "events": event_log_path(), "metrics": dump_metrics()}
