"""The degradation ladder: declarative rungs in place of hand-rolled fallback.

Counterpart of ``stencil_tpu/resilience/ladder.py``.  Each call site
supplies its rungs; ``DegradationLadder`` owns the control flow:

* a ``Rung`` names one configuration (``wavefront[m=3]``, ``wrap[k=8]``) and
  knows how to ``build()`` its step impl; free-form state rides
  ``rung.state``;
* ``lower(rung, failure_class, exc)`` gives the next rung down, or ``None``
  (the ladder is exhausted: the failure propagates).  Only VMEM_OOM and
  COMPILE_REJECT descend (``taxonomy.is_degradable``); transient retry
  belongs to the dispatch boundary (``retry.execute_with_retry`` in
  ``DistributedDomain.run_step``), so the two never compound;
* a static ``prefilter(rung)`` may reject a rung before it is built (the
  port's shared-memory models, in place of the JAX package's VMEM and
  kernel-legality models): a reason string descends as VMEM_OOM, a
  ``(reason, FailureClass)`` tuple as that class, and nothing compiles.

Every rung of every ladder the port builds is a CUDA kernel route on a CUDA
domain: no rung runs the torch engine or a plain version there.  A descent
warns, counts ``resilience.ladder.descents`` and emits ``resilience.descent``;
a build observes ``resilience.ladder.build_seconds`` and emits
``domain.compile``.

The re-invocation guard.  A descent re-invokes the lower rung with the
SAME arguments.  The JAX package guards that with ``buffers_live``, a check
of donated buffers that the port, which never donates, could never trip.
The port's guard is the in-place rule that ``run_step`` applies to retry
(``retry.py``): every built step declares ``_writes_in_place``, and once
such a step has been entered, a failure propagates, for a lower rung would
step from half-written buffers.  By default the ladder records whether the
impl it called declares ``_writes_in_place``; a ladder whose impl is the
dispatch itself (``Jacobi3D``'s, above ``run_step``) passes ``entered``, a
callable that says whether that dispatch entered its step.  The injected
``execute`` fault fires before entry, and so descends.

Fault-injection hooks (``inject.maybe_fail``) fire at a rung's build
(``compile``) and before each impl call (``execute``), labelled
``<label>:<rung>``, with the JAX package's rung names, so one
``STENCIL_FAULT_PLAN`` drives the ladders of both packages.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

from stencil_tpu_torch import telemetry
from stencil_tpu_torch.resilience import inject
from stencil_tpu_torch.resilience.taxonomy import FailureClass, classify, is_degradable
from stencil_tpu_torch.telemetry import names as tm
from stencil_tpu_torch.utils.logging import log_warn


@dataclasses.dataclass
class Rung:
    """One ladder configuration: a name (for logs and fault-plan labels), a
    zero-argument ``build`` returning the step impl, and free-form state the
    call site's ``lower`` reads to pick the next rung down.  ``libraries``,
    where the call site can say, returns the ``kernels/build.py`` library
    paths ``build`` loads (``()``: none); ``None``, or a call returning
    ``None``, means it cannot say (``serve/aot.py`` then keeps no
    cross-process stamp)."""

    name: str
    build: Callable[[], Callable]
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    libraries: Optional[Callable[[], Optional[Tuple[str, ...]]]] = None


class DegradationLadder:
    """Owns the current rung, its built impl and classified descent.

    ``step(*args, **kwargs)`` calls the current rung's impl; on a degradable
    failure before the impl was entered it asks ``lower`` for the next rung,
    builds it and calls again, until a call succeeds or the ladder is
    exhausted.  ``descents`` records ``(from_rung, FailureClass)`` per
    descent."""

    def __init__(
        self,
        first: Rung,
        lower: Optional[Callable[[Rung, FailureClass, BaseException], Optional[Rung]]] = None,
        label: str = "step",
        entered: Optional[Callable[[], bool]] = None,
        prefilter: Optional[Callable[[Rung], Union[None, str, Tuple[str, FailureClass]]]] = None,
    ):
        self.label = label
        self.rung = first
        self._lower = lower
        self._prefilter = prefilter
        self._entered = entered
        self._impl: Optional[Callable] = None
        self.descents = []  # [(rung_name, FailureClass), ...]
        # the first rung is built at once; a rung whose BUILD is refused
        # descends: nothing has run yet, so no guard is needed here
        while True:
            try:
                self._ensure_built()
                break
            except Exception as e:
                cls = classify(e)
                failed = self.rung.name
                if not is_degradable(cls) or not self._descend(cls, e):
                    raise
                log_warn(f"{self.label}: {cls.value} building rung {failed!r}; "
                         f"descending to {self.rung.name!r}: {e}")

    def _apply_prefilter(self) -> None:
        """Descend past every rung the static prefilter rejects, recorded
        as the verdict's class, with nothing compiled.  An exhausted ladder
        raises the reject."""
        if self._prefilter is None:
            return
        while True:
            verdict = self._prefilter(self.rung)
            if verdict is None:
                return
            reason, cls = verdict if isinstance(verdict, tuple) else (verdict, FailureClass.VMEM_OOM)
            exc = RuntimeError(f"statically prefiltered: {reason}")
            failed = self.rung.name
            if not self._descend(cls, exc):
                raise exc
            log_warn(f"{self.label}: rung {failed!r} statically prefiltered ({reason}); "
                     f"descending to {self.rung.name!r} without compiling")

    def _ensure_built(self) -> Callable:
        if self._impl is None:
            self._apply_prefilter()
            inject.maybe_fail("compile", f"{self.label}:{self.rung.name}")
            t0 = time.perf_counter()
            self._impl = self.rung.build()
            dt = time.perf_counter() - t0
            telemetry.observe(tm.LADDER_BUILD_SECONDS, dt)
            telemetry.emit_event(tm.EVENT_COMPILE, phase="ladder", label=f"{self.label}:{self.rung.name}",
                                 seconds=round(dt, 6))
        return self._impl

    def built(self) -> Callable:
        """The current rung's built impl (built if needed), for call sites
        that use the ladder for classified BUILD-time descent only and then
        call the impl themselves (``DistributedDomain.realize``'s exchange
        route)."""
        return self._ensure_built()

    def _descend(self, cls: FailureClass, exc: BaseException) -> bool:
        """Install the next rung down; False when the ladder is exhausted."""
        if self._lower is None:
            return False
        nxt = self._lower(self.rung, cls, exc)
        if nxt is None:
            return False
        self.descents.append((self.rung.name, cls))
        telemetry.inc(tm.LADDER_DESCENTS)
        telemetry.emit_event(tm.EVENT_DESCENT, label=self.label, from_rung=self.rung.name, to_rung=nxt.name,
                             failure_class=cls.value)
        self.rung = nxt
        self._impl = None
        return True

    def step(self, *args, **kwargs):
        while True:
            called = False
            try:
                impl = self._ensure_built()
                inject.maybe_fail("execute", f"{self.label}:{self.rung.name}")
                called = True
                return impl(*args, **kwargs)
            except Exception as e:
                cls = classify(e)
                if not is_degradable(cls):
                    raise
                failed = self.rung.name
                # refuse BEFORE descending: lower() rebuilds the model's step,
                # wasted on a re-invocation the guard then vetoes
                if called and (self._entered() if self._entered is not None
                               else getattr(impl, "_writes_in_place", False)):
                    log_warn(f"{self.label}: {cls.value} on rung {failed!r} after the step began to write "
                             "its buffers in place; a lower rung would step from a half-written state, "
                             "propagating")
                    raise
                if not self._descend(cls, e):
                    raise
                log_warn(f"{self.label}: {cls.value} on rung {failed!r}; descending to {self.rung.name!r}: {e}")
