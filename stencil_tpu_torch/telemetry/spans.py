"""Nestable wall-clock span recorder, its Chrome trace-event dump, and the
profiler's two entry points, ``annotate`` and ``trace``.

Counterpart of ``stencil_tpu/telemetry/spans.py``.  ``annotate(name)`` labels
a region in a ``torch.profiler`` trace (``torch.profiler.record_function``,
the NVTX-range analog, where the JAX package enters ``jax.named_scope``), and
``trace(log_dir)`` captures one (a ``torch.profiler.profile`` written as a
Chrome trace, ``*.pt.trace.json``).  Spans
record (name, start, duration, thread, parent, args) tuples that
``chrome_trace_events`` renders as Chrome trace-event JSON (complete
``"ph":"X"`` events with microsecond timestamps) for ``chrome://tracing`` or
https://ui.perfetto.dev.  Timestamps are ``time.perf_counter`` offsets from
the recorder's epoch.

Where the JAX package enters ``jax.named_scope`` around a span, the port
enters ``torch.profiler.record_function`` (``profiler_scope``), so a span
labels its region in a ``torch.profiler`` trace; the facade enters it only
while telemetry is enabled.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional

#: warn once per process when the profiler will not start: a profiled command
#: line must run unchanged, just without traces
_trace_unavailable_warned = False
#: what a capture's profiler collects on a card before its window opens
#: (``trace``): kernel launches and seconds
WARMUP_LAUNCHES = 64
WARMUP_S = 0.02


def profiler_scope(name: str):
    """``torch.profiler.record_function(name)``: the region's label in a
    ``torch.profiler`` trace."""
    import torch

    return torch.profiler.record_function(name)


#: the JAX facade's name for the region label
annotate = profiler_scope


@contextlib.contextmanager
def trace(log_dir: Optional[str], cuda: Optional[bool] = None):
    """Capture a ``torch.profiler`` trace of the body into ``log_dir`` (a no-op
    when None): CPU activity, and CUDA activity when ``cuda`` (default: a card
    is present), written at the end as ``<host>_<pid>.<ns>.pt.trace.json``
    (Chrome trace events; Perfetto or ``chrome://tracing`` show it).

    The contract of ``stencil_tpu/telemetry/spans.py``'s ``trace``: the
    directory is made up front (a capture that dies mid-run still leaves the
    directory its tooling expects), and a profiler that will not start (one
    already running in the process, a build without Kineto) warns once and
    runs the body unprofiled; a failed export warns and leaves the result
    alone."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    global _trace_unavailable_warned
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = None
    try:
        if torch.autograd.profiler._is_profiler_enabled:
            # torch.profiler sessions do not nest: stopping an inner one
            # would end the outer
            raise RuntimeError("a torch.profiler session is already running in this process")
        # one warm-up step, its rows discarded, before the recorded one: a
        # session opened late in a long process on the H100 lost its first
        # ~26 device rows (~3 ms) when it recorded at once (chip_smoke.py
        # phase 27), so CUPTI first collects WARMUP_LAUNCHES tiny kernels
        # and WARMUP_S of time, outside the window
        prof = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        prof.__enter__()
        if cuda:
            warm = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                warm.add_(1)
            torch.cuda.synchronize()
            time.sleep(WARMUP_S)
        prof.step()
    except Exception as e:  # noqa: BLE001 — degrade, never crash the run
        prof = None
        if not _trace_unavailable_warned:
            _trace_unavailable_warned = True
            from stencil_tpu_torch.utils.logging import log_warn

            log_warn(f"torch.profiler would not start ({e!r}); running unprofiled — {log_dir} will hold no trace")
    try:
        yield
    finally:
        if prof is not None:
            try:
                if cuda:
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                import socket

                prof.export_chrome_trace(os.path.join(
                    log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))
            except Exception as e:  # noqa: BLE001 — a failed finalize must not eat the run's result
                from stencil_tpu_torch.utils.logging import log_warn

                log_warn(f"torch.profiler trace finalize failed: {e!r}")


class SpanRecorder:
    """Thread-safe recorder of completed spans with a per-thread name stack
    (so a span knows its parent at record time)."""

    def __init__(self):
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[dict] = []
        #: (ts_us, series, value) counter samples — rendered as Chrome
        #: counter-track ("ph":"C") events so Perfetto shows cumulative
        #: exchange bytes / MXU flops as a throughput track under the spans
        self._counter_samples: List[tuple] = []
        self._counter_last: dict = {}
        self._tls = threading.local()

    # --- the per-thread nesting stack ----------------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def current(self) -> Optional[str]:
        s = self._stack()
        return s[-1] if s else None

    def push(self, name: str) -> None:
        self._stack().append(name)

    def pop(self) -> None:
        s = self._stack()
        if s:
            s.pop()

    # --- recording ------------------------------------------------------------
    def record(self, name: str, t0: float, dur: float, parent=None, **args) -> None:
        """Record a completed span.  ``t0`` is a ``time.perf_counter`` value;
        ``dur`` is seconds."""
        if parent is None:
            parent = self.current()
        ev = {
            "name": name,
            "ts": (t0 - self.epoch) * 1e6,  # µs, trace-event convention
            "dur": dur * 1e6,
            "tid": threading.get_ident() & 0xFFFF,
            "args": dict(args, parent=parent) if parent else dict(args),
        }
        with self._lock:
            self._events.append(ev)

    def sample_counter(self, name: str, value: float, t: float = None) -> None:
        """Record one counter-track sample at ``t`` (a ``perf_counter``
        value; now when None).  Consecutive identical values are dropped —
        a flat counter contributes one point, not one per span."""
        if t is None:
            t = time.perf_counter()
        ts = (t - self.epoch) * 1e6
        with self._lock:
            if self._counter_last.get(name) == value:
                return
            self._counter_last[name] = value
            self._counter_samples.append((ts, name, value))

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def counter_samples(self) -> List[tuple]:
        with self._lock:
            return list(self._counter_samples)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._counter_samples.clear()
            self._counter_last.clear()

    def chrome_trace_events(self, pid: int = 0) -> List[dict]:
        """The recorded spans as Chrome trace-event dicts (complete events),
        followed by the counter-track samples ("ph":"C" — Perfetto renders
        each series as a value track alongside the spans)."""
        out = [
            {
                "name": e["name"],
                "ph": "X",
                "ts": e["ts"],
                "dur": e["dur"],
                "pid": pid,
                "tid": e["tid"],
                "args": e["args"],
            }
            for e in self.events()
        ]
        out.extend(
            {
                "name": name,
                "ph": "C",
                "ts": ts,
                "pid": pid,
                "args": {"value": value},
            }
            for ts, name, value in self.counter_samples()
        )
        return out
