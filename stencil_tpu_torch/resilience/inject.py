"""Deterministic fault injection: every resilience path testable on the CPU.

Counterpart of ``stencil_tpu/resilience/inject.py``, with its grammar
verbatim.  ``STENCIL_FAULT_PLAN`` holds a comma-separated list of entries:

    entry := phase ':' class [':' label-glob] ['@' skip] ['*' count]
    phase := compile | execute | dispatch | any
    class := vmem_oom | compile_reject | transient | divergence | fatal
           | capacity_loss | sigkill | sigterm | shrink | grow
           | overload | poison_request | slow_tenant

Each entry first lets ``skip`` matching hook calls pass, then fires
``count`` times (default 1), then is spent.  The phases are the JAX
package's three hook sites:

* ``compile``: inside ``DegradationLadder`` (``ladder.py``) when a rung's
  step is built, labelled ``<ladder>:<rung>`` (``jacobi:wrap[k=8]``,
  ``stream:wavefront[m=3]``, ``exchange:yzpack_pallas``);
* ``execute``: inside ``DegradationLadder`` just before the rung's step is
  called, with the same labels;
* ``dispatch``: ``DistributedDomain.run_step`` calls
  ``maybe_fail("dispatch", label)`` before the step is entered, with the
  label the caller passed (the models pass ``jacobi`` and ``astaroth``).

A label pattern matches when the hook label starts with it literally, or
when it matches as an ``fnmatch`` glob with an implicit trailing ``*`` (only
a TRAILING ``*<digits>`` is the count).  Examples:

    STENCIL_FAULT_PLAN='dispatch:transient:jacobi*2'
        -> the next two jacobi dispatches fail with a transient wording;
           the retry loop re-runs each
    STENCIL_FAULT_PLAN='dispatch:transient:astaroth*9'
        -> outlasts the retry budget: the transient propagates
    STENCIL_FAULT_PLAN='dispatch:sigkill:jacobi@7'
        -> the 8th jacobi dispatch kills the process with SIGKILL

Injected VMEM_OOM / COMPILE_REJECT / TRANSIENT / CAPACITY_LOSS / OVERLOAD /
FATAL faults raise ``InjectedFault`` with the JAX package's wording, so they
classify through ``classify()``'s substring matching as real errors do;
DIVERGENCE raises a typed ``DivergenceError``.  ``sigkill`` and ``sigterm``
deliver a real signal to this process.  Capacity (``shrink`` / ``grow``)
notices go to the handler the run supervisor registers for the length of
its ``run()`` (``set_capacity_handler``); with none registered they are
logged and dropped.  Slow-tenant notices go to the handler the serving
layer registers for a server's life (``set_slow_handler``, which inflates
that request's service time); with none registered they are logged and
dropped.

The plan is parsed from the environment on first use and again whenever the
variable's value changes; ``set_plan`` installs one programmatically.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import re
from typing import List, Optional

from stencil_tpu_torch.resilience.taxonomy import (
    DivergenceError,
    FailureClass,
    InjectedFault,
)

ENV_VAR = "STENCIL_FAULT_PLAN"

_PHASES = ("compile", "execute", "dispatch", "any")
_CLASSES = {
    "vmem_oom": FailureClass.VMEM_OOM,
    "compile_reject": FailureClass.COMPILE_REJECT,
    "transient": FailureClass.TRANSIENT_RUNTIME,
    "divergence": FailureClass.DIVERGENCE,
    "capacity_loss": FailureClass.CAPACITY_LOSS,
    "overload": FailureClass.OVERLOAD,
    # a request whose EXECUTION diverges: same typed DivergenceError as
    # 'divergence' (the serving layer's eviction path keys on the class,
    # not the plan-entry spelling), but the chaos grammar keeps the
    # serving-native name so soak plans read as what they model
    "poison_request": FailureClass.DIVERGENCE,
    "fatal": FailureClass.FATAL,
}
#: process-level kill classes: a REAL signal to this process, not an
#: exception — sigkill models preemption-without-warning (no cleanup runs),
#: sigterm the polite notice the supervisor checkpoints on
_KILLS = ("sigkill", "sigterm")
#: seeded capacity-change notices (no exception, no signal): the hook calls
#: the REGISTERED capacity handler (``set_capacity_handler``; the run
#: supervisor installs one for the length of ``run()``), else logs and drops
_CAPACITY = ("shrink", "grow")
#: seeded tenant slowdowns (no exception): the hook calls the REGISTERED
#: slow handler (``set_slow_handler``; the serving layer installs one that
#: inflates the matched request's service time), else logs and drops
_SLOW = ("slow_tenant",)

#: The message each injected class carries — the REAL toolchain wording (the
#: same texts ``taxonomy`` pins), tagged with the injection site.
_MESSAGES = {
    FailureClass.VMEM_OOM: (
        "Ran out of memory in memory space vmem: exceeded scoped vmem "
        "limit by 8.59M"
    ),
    FailureClass.COMPILE_REJECT: (
        "Mosaic failed to compile TPU kernel: unsupported unaligned shape"
    ),
    FailureClass.TRANSIENT_RUNTIME: (
        "UNAVAILABLE: connection reset by peer (remote compile tunnel)"
    ),
    FailureClass.CAPACITY_LOSS: (
        "UNAVAILABLE: TPU is unhealthy: lost device at coordinates [0,1,0]"
    ),
    # the serving layer's own pinned refusal wording (OverloadError's
    # queue-full text — taxonomy._OVERLOAD_MARKERS match it)
    FailureClass.OVERLOAD: "request queue is full; load shed",
    FailureClass.FATAL: "injected fatal failure",
}


@dataclasses.dataclass
class _Entry:
    phase: str
    cls: Optional[FailureClass]  # None for the process-kill classes
    kill: Optional[str]  # "sigkill" | "sigterm" | None
    capacity: Optional[str]  # "shrink" | "grow" | None
    slow: Optional[str]  # "slow_tenant" | None
    label_glob: str
    skip: int
    remaining: int


def _parse_entry(text: str) -> _Entry:
    text = text.strip()
    count = 1
    skip = 0
    # the count suffix is ONLY a trailing '*<digits>' — a '*' elsewhere is
    # part of the label glob (e.g. 'execute:vmem_oom:*wavefront*3')
    m = re.match(r"^(.*)\*(\d+)$", text)
    if m:
        text, count = m.group(1), int(m.group(2))
        if count < 1:
            raise ValueError(f"{ENV_VAR}: count must be >= 1, got {count}")
    # ...and the skip suffix a trailing '@<digits>' before it ('die at the
    # K-th dispatch' = '@K-1', or '@K' counting the fired one as K+1st)
    m = re.match(r"^(.*)@(\d+)$", text)
    if m:
        text, skip = m.group(1), int(m.group(2))
    # split at most twice: ladder labels themselves contain colons
    # ("stream:wavefront[m=3]"), so everything after the class is the glob
    parts = text.split(":", 2)
    if len(parts) == 2:
        phase, cls_name = parts
        label_glob = "*"
    elif len(parts) == 3:
        phase, cls_name, label_glob = parts
    else:
        raise ValueError(
            f"{ENV_VAR}: entry {text!r} is not phase:class[:label][@skip][*count]"
        )
    phase = phase.strip().lower()
    cls_name = cls_name.strip().lower()
    if phase not in _PHASES:
        raise ValueError(
            f"{ENV_VAR}: unknown phase {phase!r} (one of {', '.join(_PHASES)})"
        )
    if (
        cls_name not in _CLASSES
        and cls_name not in _KILLS
        and cls_name not in _CAPACITY
        and cls_name not in _SLOW
    ):
        raise ValueError(
            f"{ENV_VAR}: unknown failure class {cls_name!r} "
            f"(one of {', '.join(_CLASSES)}, {', '.join(_KILLS)}, "
            f"{', '.join(_CAPACITY)}, {', '.join(_SLOW)})"
        )
    return _Entry(
        phase,
        _CLASSES.get(cls_name),
        cls_name if cls_name in _KILLS else None,
        cls_name if cls_name in _CAPACITY else None,
        cls_name if cls_name in _SLOW else None,
        label_glob.strip() or "*",
        skip,
        count,
    )


class FaultPlan:
    """A parsed, stateful fault plan: entries are consumed as they fire."""

    def __init__(self, entries: List[_Entry]):
        self._entries = entries

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        entries = [_parse_entry(e) for e in text.split(",") if e.strip()]
        return cls(entries)

    def pending(self) -> int:
        return sum(e.remaining for e in self._entries)

    def fire(self, phase: str, label: str) -> None:
        """Raise the first matching entry's fault (consuming one charge)."""
        for e in self._entries:
            if e.remaining <= 0:
                continue
            if e.phase != "any" and e.phase != phase:
                continue
            # PREFIX match first — rung labels contain '[m=3]', which
            # fnmatch would misread as a one-character class, so an exact
            # or plain-prefix pattern must match literally; fnmatch globs
            # (with an implicit trailing '*') cover the wildcard cases
            if not (
                label.startswith(e.label_glob)
                or fnmatch.fnmatchcase(label, e.label_glob)
                or fnmatch.fnmatchcase(label, e.label_glob + "*")
            ):
                continue
            if e.skip > 0:
                # an un-fired pass-through: this entry lets the match
                # through but stays armed (independent entries may still
                # fire below)
                e.skip -= 1
                continue
            e.remaining -= 1
            if e.kill is not None:
                _kill(e.kill, phase, label)
                return  # sigterm: the handler ran; the dispatch proceeds
            if e.capacity is not None:
                _capacity_notice(e.capacity, phase, label)
                return  # a notice, not a failure; the dispatch proceeds
            if e.slow is not None:
                _slow_notice(phase, label)
                return  # a slowdown, not a failure; the dispatch proceeds
            _raise(e.cls, phase, label)


def _kill(kind: str, phase: str, label: str) -> None:
    """Deliver a REAL signal to this process.  SIGKILL never returns (the
    kernel reaps us mid-bytecode — exactly a preemption without notice);
    SIGTERM runs the installed handler synchronously at the next bytecode
    boundary and returns, letting the supervisor observe its flag at the
    step boundary."""
    import signal as _signal

    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.telemetry import names as tm

    telemetry.inc(tm.FAULTS_INJECTED)
    telemetry.emit_event(
        tm.EVENT_FAULT, phase=phase, label=label, failure_class=kind
    )
    os.kill(os.getpid(), _signal.SIGKILL if kind == "sigkill" else _signal.SIGTERM)


#: the registered capacity-change handler (``fn(kind, phase, label)``, kind
#: ``shrink`` / ``grow``), installed by the run supervisor for the length of
#: ``run()``
_capacity_handler = {"fn": None}


def set_capacity_handler(fn) -> object:
    """Install (or clear, with ``None``) the capacity-notice handler;
    returns the previous one, so supervisors can nest and restore."""
    prev = _capacity_handler["fn"]
    _capacity_handler["fn"] = fn
    return prev


def _capacity_notice(kind: str, phase: str, label: str) -> None:
    """A seeded grow/shrink notice, counted and handed to the registered
    handler (the supervisor answers it at the next chunk boundary).  No
    handler: logged and dropped, for the notice only means something to a
    supervised run."""
    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.telemetry import names as tm
    from stencil_tpu_torch.utils.logging import log_warn

    telemetry.inc(tm.FAULTS_INJECTED)
    telemetry.emit_event(tm.EVENT_FAULT, phase=phase, label=label, failure_class=kind)
    fn = _capacity_handler["fn"]
    if fn is None:
        log_warn(f"capacity notice {kind!r} injected at {phase}:{label} but no handler is registered "
                 "(no supervisor running); dropped")
        return
    fn(kind, phase, label)


#: the registered tenant-slowdown handler (``fn(phase, label)``), installed
#: by the serving layer for a server's life
_slow_handler = {"fn": None}


def set_slow_handler(fn) -> object:
    """Install (or clear, with ``None``) the slow-tenant handler; returns
    the previous one, so nested servers can restore it."""
    prev = _slow_handler["fn"]
    _slow_handler["fn"] = fn
    return prev


def _slow_notice(phase: str, label: str) -> None:
    """A seeded slow-tenant notice, counted and handed to the registered
    handler (the serving layer inflates the matched request's service
    time).  No handler: logged and dropped, for the notice only means
    something to a serving run."""
    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.telemetry import names as tm
    from stencil_tpu_torch.utils.logging import log_warn

    telemetry.inc(tm.FAULTS_INJECTED)
    telemetry.emit_event(tm.EVENT_FAULT, phase=phase, label=label, failure_class="slow_tenant")
    fn = _slow_handler["fn"]
    if fn is None:
        log_warn(f"slow_tenant notice injected at {phase}:{label} but no handler is registered "
                 "(no serving layer running); dropped")
        return
    fn(phase, label)


def _raise(cls: FailureClass, phase: str, label: str) -> None:
    from stencil_tpu_torch import telemetry
    from stencil_tpu_torch.telemetry import names as tm

    telemetry.inc(tm.FAULTS_INJECTED)
    telemetry.emit_event(
        tm.EVENT_FAULT, phase=phase, label=label, failure_class=cls.value
    )
    site = f" [fault-injected at {phase}:{label}]"
    if cls is FailureClass.DIVERGENCE:
        raise DivergenceError(quantity=f"<injected:{label}>", step=-1)
    # plain message text: VMEM_OOM / COMPILE_REJECT / TRANSIENT rely on
    # classify()'s substring matching, exercising the real code path (the
    # FATAL message matches no marker and classifies FATAL by default)
    raise InjectedFault(_MESSAGES[cls] + site)


# --- module-level plan state ------------------------------------------------
_state = {"raw": None, "plan": None, "explicit": False}


def set_plan(plan: Optional["FaultPlan | str"]) -> None:
    """Install a plan programmatically (tests), bypassing the environment.
    ``None`` clears it and resumes reading ``STENCIL_FAULT_PLAN``."""
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _state["plan"] = plan
    _state["explicit"] = plan is not None
    _state["raw"] = None


#: ``os.environ``'s encoded key of ENV_VAR: ``_plan_text`` reads it from the
#: mapping's data, since ``os.environ.get`` raises and catches a KeyError
#: inside when the variable is unset (~1 µs, on every dispatch)
_ENV_KEY = os.environ.encodekey(ENV_VAR) if hasattr(os.environ, "encodekey") else None


def _plan_text() -> Optional[str]:
    """``os.environ.get(ENV_VAR)``, read from the mapping's data where it
    has one."""
    data = getattr(os.environ, "_data", None)
    if data is None or _ENV_KEY is None:
        return os.environ.get(ENV_VAR)
    raw = data.get(_ENV_KEY)
    return None if raw is None else os.environ.decodevalue(raw)


def active_plan() -> Optional[FaultPlan]:
    if _state["explicit"]:
        return _state["plan"]
    raw = _plan_text()
    if raw != _state["raw"]:  # env changed (or first read): re-parse
        _state["raw"] = raw
        _state["plan"] = FaultPlan.parse(raw) if raw else None
    return _state["plan"]


def maybe_fail(phase: str, label: str = "") -> None:
    """Hook call: raise the next matching injected fault, if any.  Inert
    (one dict lookup + string compare) when no plan is configured."""
    plan = active_plan()
    if plan is not None:
        plan.fire(phase, label)
