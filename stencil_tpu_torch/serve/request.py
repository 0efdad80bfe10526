"""Serving vocabulary: tenants, requests, responses, admission refusals.

Counterpart of ``stencil_tpu/serve/request.py``, verbatim.  A *tenant* is
one independent simulation domain sharing the fleet with others; a
*request* asks the serving layer to advance that tenant's model by
``steps`` raw iterations before ``deadline_s`` on the server's clock.
Everything here is plain data (the policy lives in ``server.py``) except
``AdmissionRefused``, which carries its taxonomy class so callers handle a
refusal exactly like any other classified failure.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from stencil_tpu_torch.resilience.taxonomy import FailureClass, ResilienceError


class AdmissionRefused(ResilienceError):
    """A request was refused AT ADMISSION (before any execution): the
    static shared-memory verdict failed, the tenant is quarantined/evicted,
    or a cold workload key could not be made warm.  Carries the refusing
    ``failure_class`` per instance: a verdict refusal classifies VMEM_OOM
    (degradable: re-submit a shallower plan), an evicted-tenant refusal
    FATAL (re-submitting changes nothing).  Load refusals raise
    ``OverloadError`` instead (retryable after backoff)."""

    def __init__(self, why: str, failure_class: FailureClass, tenant: str = None):
        self.why = why
        self.failure_class = failure_class
        self.tenant = tenant
        msg = f"admission refused: {why}"
        if tenant is not None:
            msg = f"admission refused for tenant {tenant}: {why}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's standing contract with the server.

    ``priority`` orders dispatch and shedding (HIGHER wins a slot and
    survives a make-room shed); ``retry_allowance`` seeds the tenant's
    shared ``RetryBudget``; ``max_rungs`` bounds how many degradation
    descents the envelope tolerates before the tenant is quarantined."""

    tenant_id: str
    priority: int = 0
    retry_allowance: int = 8
    max_rungs: int = 3
    #: optional stream-plan dict for the static shared-memory verdict at
    #: admission (``analysis.check_vmem``); None skips the check
    plan: Optional[dict] = None


#: server-wide admission order (tie-break within a priority level: FIFO)
_seq = itertools.count()


@dataclasses.dataclass
class Request:
    """One unit of admitted work: advance ``tenant``'s model by ``steps``."""

    tenant: str
    steps: int = 1
    #: ABSOLUTE deadline on the server's (injectable) clock; None = no
    #: deadline (never shed for lateness, still sheddable for priority)
    deadline_s: Optional[float] = None
    priority: int = 0
    #: workload-key digest (tune/key.py) when the request names one: the
    #: AOT-cache lookup key; None inherits the tenant's realized workload
    key_digest: Optional[str] = None
    enqueued_at: float = 0.0
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s


@dataclasses.dataclass
class Response:
    """The outcome the server hands back for one request."""

    request: Request
    ok: bool
    latency_s: float = 0.0
    steps_done: int = 0
    error: Optional[str] = None
    failure_class: Optional[str] = None
