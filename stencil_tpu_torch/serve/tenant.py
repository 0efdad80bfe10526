"""The per-tenant resilience envelope: fault isolation as a state machine.

Counterpart of ``stencil_tpu/serve/tenant.py``, over the port's
``RetryBudget`` (``resilience/retry.py``) and ``Statistics``
(``utils/statistics.py``).  Every classified failure of a tenant's request
is answered INSIDE that tenant's envelope, the serving layer's isolation
contract (chaos-proven by ``python -m stencil_tpu_torch.bin.run_soak
--serve``):

* VMEM_OOM / COMPILE_REJECT — step down THAT tenant's degradation rung
  (``model.step_down`` when the model exposes one, else Jacobi3D's
  ``_step_down``: on the cuda engine the axes, then the wrap or wavefront
  depth; else just the recorded rung); past ``max_rungs`` descents the
  tenant is quarantined instead of thrashing the fleet with doomed
  rebuilds.  The server's ``execute`` hook fires before the model's step
  is entered, so the descent never follows a partly written state.
* DIVERGENCE — quarantine/evict ONLY this tenant: its numerics are broken
  (a poisoned request), and no amount of re-running or degrading fixes
  arithmetic.  Other tenants' fields stay bitwise untouched.
* TRANSIENT_RUNTIME — retried in place by the dispatch wrapper, charged to
  this tenant's shared ``RetryBudget`` (``resilience/retry.py``) so one
  flaky tenant cannot monopolize dispatch slots with endless retries.
* PREEMPTED / STALL / CAPACITY_LOSS / FATAL — not a tenant-local matter:
  the envelope reports ``"propagate"`` and the server/supervisor layer
  owns the response.

The tenant also carries its own latency ``Statistics`` — the p50/p95/p99
the heartbeat tenant table and the serve soak artifact report per tenant.
"""

from __future__ import annotations

from typing import Optional

from stencil_tpu_torch.resilience.retry import RetryBudget
from stencil_tpu_torch.resilience.taxonomy import FailureClass
from stencil_tpu_torch.serve.request import TenantSpec
from stencil_tpu_torch.utils.statistics import Statistics

#: envelope states
ACTIVE = "active"
QUARANTINED = "quarantined"
EVICTED = "evicted"


class Tenant:
    """One admitted tenant: spec + model + envelope state + SLO stats."""

    def __init__(self, spec: TenantSpec, model=None):
        self.spec = spec
        self.model = model
        self.state = ACTIVE
        self.rung = 0  # degradation descents the envelope has answered
        self.budget = RetryBudget(spec.retry_allowance, label=spec.tenant_id)
        self.latency = Statistics()
        self.admitted = 0
        self.completed = 0
        self.shed = 0
        self.retries = 0
        self.why: Optional[str] = None  # quarantine/evict reason

    @property
    def tenant_id(self) -> str:
        return self.spec.tenant_id

    def active(self) -> bool:
        return self.state == ACTIVE

    # --- the envelope ---------------------------------------------------------

    def handle_failure(self, cls: FailureClass, error: str = "") -> str:
        """Answer a classified failure of THIS tenant's request; returns
        the action taken: ``degrade`` | ``evict`` | ``retry_exhausted`` |
        ``propagate``.  Never touches any other tenant's state."""
        if cls in (FailureClass.VMEM_OOM, FailureClass.COMPILE_REJECT):
            self.rung += 1
            # Jacobi3D exposes its runtime descent as ``_step_down(cls) ->
            # bool`` (False = nothing shallower); models without one just
            # get the rung counted against max_rungs
            step_down = getattr(self.model, "step_down", None) or getattr(
                self.model, "_step_down", None
            )
            if callable(step_down):
                try:
                    descended = step_down(cls)
                except Exception:  # noqa: BLE001 — a raising descent means
                    # the ladder is broken, not just exhausted
                    descended = False
                if descended is False:
                    self.quarantine(f"ladder exhausted after {cls.value}")
                    return "evict"
            if self.rung > self.spec.max_rungs:
                self.quarantine(f"{self.rung} descents exceed max_rungs")
                return "evict"
            return "degrade"
        if cls is FailureClass.DIVERGENCE:
            self.quarantine(error or "divergence")
            return "evict"
        if cls is FailureClass.TRANSIENT_RUNTIME:
            # the in-place retries already ran (and were charged to
            # self.budget) inside the dispatch wrapper; reaching the
            # envelope means they exhausted
            return "retry_exhausted"
        return "propagate"

    def quarantine(self, why: str) -> None:
        self.state = QUARANTINED
        self.why = why

    def evict(self, why: str) -> None:
        self.state = EVICTED
        self.why = why

    # --- reporting ------------------------------------------------------------

    def percentile_ms(self, q: float) -> Optional[float]:
        if self.latency.count() == 0:
            return None
        return self.latency.quantile(q) * 1e3

    def table_row(self) -> dict:
        """The heartbeat/status tenant-table entry (JSON-safe scalars)."""
        row = {
            "tenant": self.tenant_id,
            "state": self.state,
            "priority": self.spec.priority,
            "rung": self.rung,
            "admitted": self.admitted,
            "completed": self.completed,
            "shed": self.shed,
            "retries": self.retries,
            "budget_remaining": self.budget.remaining,
        }
        for name, q in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
            v = self.percentile_ms(q)
            row[name] = round(v, 3) if v is not None else None
        if self.why:
            row["why"] = self.why
        return row
