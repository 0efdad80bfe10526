"""The serving loop: admission, fair dispatch, per-tenant envelopes,
shedding, elasticity.

Counterpart of ``stencil_tpu/serve/server.py``.  One ``StencilServer`` owns
many tenants on one fleet of slots (``serve/pack.py``).  The life of a
request:

1. ``submit``: ADMISSION.  The tenant must be active, the static
   shared-memory verdict (``analysis.check_vmem``) must pass for the
   tenant's declared plan, the request's workload key must be warm in the
   AOT cache (or build under the admission budget), and the bounded queue
   must yield a slot (shedding expired and, for a higher-priority arrival,
   the lowest-priority queued request first).  Refusals are CLASSIFIED:
   load refusals are ``OverloadError`` (retryable after backoff), verdict
   refusals are ``AdmissionRefused`` carrying VMEM_OOM (degradable:
   re-submit a shallower plan), evicted-tenant refusals are FATAL.
2. ``cycle``: DISPATCH.  Shed whatever expired while queued, then serve
   the oldest request of the next tenant in round-robin rotation (or a
   geometry-matched batch, or a sub-slice pack), retries charged to that
   tenant's shared budget, every classified failure answered inside that
   tenant's envelope (``tenant.py``): no failure of tenant A ever touches
   tenant B's state or fields.
3. After every cycle the elasticity policy observes the queue depth; a
   grow/shrink decision goes to ``capacity`` (a callback that reshards the
   tenants): the server never moves a grid itself.

The clock and sleep are injectable, so the CPU tests drive deadlines,
backoff and slow-tenant penalties with a fake clock and zero real sleeps.
The fleet's occupancy counts slots (``_model_devices`` /
``_fleet_devices``).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from stencil_tpu_torch import telemetry
from stencil_tpu_torch.resilience import inject
from stencil_tpu_torch.resilience.retry import RetryPolicy, execute_with_retry
from stencil_tpu_torch.resilience.taxonomy import (
    FailureClass,
    OverloadError,
    classify,
)
from stencil_tpu_torch.serve import pack
from stencil_tpu_torch.serve.aot import AOTCache
from stencil_tpu_torch.serve.queue import BoundedQueue
from stencil_tpu_torch.serve.request import AdmissionRefused, Request, Response, TenantSpec
from stencil_tpu_torch.serve.tenant import Tenant
from stencil_tpu_torch.telemetry import names as tm
from stencil_tpu_torch.utils.logging import log_info, log_warn


class StencilServer:
    """Admission + fair dispatch + isolation envelopes over one fleet."""

    def __init__(
        self,
        queue_max: int = 64,
        default_deadline_s: Optional[float] = None,
        compile_budget_s: Optional[float] = None,
        policy=None,
        capacity: Optional[Callable[[str], None]] = None,
        aot: Optional[AOTCache] = None,
        retry_policy: Optional[RetryPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        flight=None,
        slow_penalty_s: float = 0.25,
        batch_max: int = 0,
        subslice: bool = False,
        fleet=None,
        link_model=None,
    ):
        self.tenants: Dict[str, Tenant] = {}
        self.queue = BoundedQueue(queue_max)
        self.default_deadline_s = default_deadline_s
        self.compile_budget_s = compile_budget_s
        self.policy = policy
        self.capacity = capacity
        self.aot = aot if aot is not None else AOTCache(clock=clock)
        self.retry_policy = retry_policy
        self.clock = clock
        self.sleep = sleep
        self.rng = rng
        self.flight = flight
        self.slow_penalty_s = slow_penalty_s
        # throughput packing (serve/pack.py): batch_max >= 2 turns batched
        # dispatch on; subslice turns the bin-packer on; fleet pins the slot
        # pool (derived from the tenants' slots when None); link_model is
        # the measured fabric doc (or slots -> doc callable) the packer
        # scores slices against
        self.batch_max = int(batch_max)
        self.subslice = bool(subslice)
        self.fleet = list(fleet) if fleet is not None else None
        self.link_model = link_model
        self._batch_exec = pack.BatchExecutor()
        self._rotation: List[str] = []
        self._builders: Dict[str, Callable] = {}
        self._slow_pending = False
        self._completed_total = 0
        self._prev_slow_handler = inject.set_slow_handler(self._on_slow)

    def close(self) -> None:
        """Restore the previous slow-tenant hook (pair with construction)."""
        inject.set_slow_handler(self._prev_slow_handler)

    # --- tenants --------------------------------------------------------------

    def add_tenant(self, spec: TenantSpec, model=None) -> Tenant:
        if spec.tenant_id in self.tenants:
            raise ValueError(f"tenant {spec.tenant_id!r} already registered")
        t = Tenant(spec, model)
        self.tenants[spec.tenant_id] = t
        self._rotation.append(spec.tenant_id)
        self._gauge_tenants()
        return t

    def register_workload(self, digest: str, build: Callable[[], object],
                          libraries: Optional[Sequence[str]] = None) -> None:
        """Associate an AOT build (the kernel libraries and the step,
        ``aot.tenant_build``) and the libraries it loads (``None``: cannot
        say, so never stamped warm across processes) with a workload-key
        digest so admission can warm it."""
        self._builders[digest] = (build, libraries)

    def _gauge_tenants(self) -> None:
        telemetry.set_gauge(
            tm.SERVE_TENANTS_ACTIVE,
            sum(1 for t in self.tenants.values() if t.active()),
        )

    # --- admission ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Admit ``req`` into the queue or raise a classified refusal."""
        now = self.clock()
        tenant = self.tenants.get(req.tenant)
        if tenant is None:
            self._reject(req, "unknown tenant", "fatal")
            raise AdmissionRefused(
                "unknown tenant", FailureClass.FATAL, tenant=req.tenant
            )
        if not tenant.active():
            why = f"tenant is {tenant.state} ({tenant.why})"
            self._reject(req, why, "fatal")
            raise AdmissionRefused(why, FailureClass.FATAL, tenant=req.tenant)
        # static shared-memory verdict: reject a plan the card would refuse
        # BEFORE it can waste a dispatch slot failing (analysis/vmem.py)
        if tenant.spec.plan is not None and getattr(tenant.model, "dd", None) is not None:
            from stencil_tpu_torch.analysis import check_vmem

            reason = check_vmem(tenant.model.dd, tenant.spec.plan)
            if reason is not None:
                self._reject(req, reason, FailureClass.VMEM_OOM.value)
                raise AdmissionRefused(
                    reason, FailureClass.VMEM_OOM, tenant=req.tenant
                )
        compile_s = self._warm_key(req)
        if req.deadline_s is None and self.default_deadline_s is not None:
            req.deadline_s = now + self.default_deadline_s
        try:
            self.queue.push(req, now)
        except OverloadError:
            # the shed ladder: expired first, then a lower-priority victim
            # for a HIGHER-priority arrival; refuse only when neither opens
            # a slot (queue.py module docstring)
            for victim in self.queue.shed_expired(now):
                self._shed(victim, "deadline", now)
            if self.queue.full():
                victim = self.queue.shed_lowest_priority(req.priority)
                if victim is not None:
                    self._shed(victim, "priority", now)
            if self.queue.full():
                telemetry.inc(tm.SERVE_REJECTED)
                telemetry.emit_event(
                    tm.EVENT_SERVE_ADMISSION,
                    tenant=req.tenant,
                    admitted=False,
                    why="queue_full",
                    queue_depth=self.queue.depth(),
                )
                raise
            self.queue.push(req, now)
        tenant.admitted += 1
        telemetry.inc(tm.SERVE_ADMITTED)
        telemetry.set_gauge(tm.SERVE_QUEUE_DEPTH, self.queue.depth())
        telemetry.emit_event(
            tm.EVENT_SERVE_ADMISSION,
            tenant=req.tenant,
            admitted=True,
            why="ok",
            queue_depth=self.queue.depth(),
            compile_s=compile_s,
        )

    def _warm_key(self, req: Request) -> Optional[float]:
        """AOT admission: a warm key is free; a cold key with a registered
        build compiles under the admission budget (``aot.py`` owns the
        over-budget refusal).  Returns the compile seconds paid, if any."""
        digest = req.key_digest
        if digest is None or self.aot.warm(digest):
            return None
        entry = self._builders.get(digest)
        if entry is None:
            return None  # no AOT contract for this key; the model self-compiles
        build, libraries = entry
        budget = None if self.aot.stamped(digest) else self.compile_budget_s
        try:
            _, seconds = self.aot.compile(
                digest, build, budget_s=budget, label=req.tenant,
                libraries=libraries,
            )
        except OverloadError:
            self._reject(req, "compile over budget", FailureClass.OVERLOAD.value)
            raise
        return seconds

    def _reject(self, req: Request, why: str, cls: str) -> None:
        telemetry.inc(tm.SERVE_REJECTED)
        telemetry.emit_event(
            tm.EVENT_SERVE_ADMISSION,
            tenant=req.tenant,
            admitted=False,
            why=f"{cls}: {why}"[:300],
            queue_depth=self.queue.depth(),
        )

    # --- shedding -------------------------------------------------------------

    def _shed(self, req: Request, why: str, now: float) -> Response:
        t = self.tenants.get(req.tenant)
        if t is not None:
            t.shed += 1
        telemetry.inc(tm.SERVE_SHED)
        telemetry.emit_event(
            tm.EVENT_SERVE_SHED,
            tenant=req.tenant,
            why=why,
            queue_depth=self.queue.depth(),
            waited_s=max(0.0, now - req.enqueued_at),
        )
        log_warn(f"serve: shed {req.tenant} request (why={why})")
        return Response(
            request=req,
            ok=False,
            latency_s=max(0.0, now - req.enqueued_at),
            error=f"request {why} shed",
            failure_class=FailureClass.OVERLOAD.value,
        )

    # --- dispatch -------------------------------------------------------------

    def _on_slow(self, phase: str, label: str) -> None:
        # the seeded slow_tenant notice (inject.py): inflate the CURRENT
        # request's service time by the penalty at dispatch time
        self._slow_pending = True

    def cycle(self) -> List[Response]:
        """One dispatch cycle: shed expired, then serve as much of the
        queue as one dispatch can carry — a geometry-matched BATCH, a
        sub-slice PACK, or (the default) one request — and observe the
        elasticity policy.  Returns every response produced (shed
        responses included); empty list = nothing queued."""
        now = self.clock()
        out = [self._shed(r, "deadline", now) for r in self.queue.shed_expired(now)]
        served: List[str] = []
        plan = self._plan_packed()
        if plan is not None:
            kind, payload = plan
            if kind == "batched":
                out.extend(self._dispatch_batched(payload))
                served = [r.tenant for r in payload]
            else:
                out.extend(self._dispatch_subslice(payload))
                served = [r.tenant for r, _m, _d in payload]
        else:
            req = self.queue.take(self._rotation)
            if req is not None:
                model = self.tenants[req.tenant].model
                self._gauge_occupancy(self._model_devices(model))
                out.append(self._dispatch(req))
                served = [req.tenant]
        # rotate AFTER serving: the served tenants go to the back, in
        # served order, so dispatch slots keep round-robin fairness
        for tid in served:
            if tid in self._rotation:
                self._rotation.remove(tid)
                self._rotation.append(tid)
        depth = self.queue.depth()
        telemetry.set_gauge(tm.SERVE_QUEUE_DEPTH, depth)
        if self.policy is not None:
            kind = self.policy.observe(depth, self.clock())
            if kind is not None:
                telemetry.emit_event(
                    tm.EVENT_SERVE_ELASTICITY,
                    kind=kind,
                    queue_depth=depth,
                    source="policy",
                )
                log_info(f"serve: elasticity policy requests {kind} (depth {depth})")
                if self.capacity is not None:
                    self.capacity(kind)
        return out

    # --- packed dispatch (serve/pack.py) ----------------------------------------

    def _plan_packed(self):
        """The scheduler policy: a geometry-matched batch wins (one
        dispatch, N tenants), else a sub-slice pack of >= 2 movable
        tenants, else None (serial).  Chosen requests are claimed out of
        the queue before dispatch."""
        if self.batch_max < 2 and not self.subslice:
            return None
        pending = self.queue.peek_all()
        if len(pending) < 2:
            return None
        if self.batch_max >= 2:
            group = pack.plan_batches(
                pending, self.tenants, self._rotation, self.batch_max
            )
            if group:
                claimed = [r for r in group if self.queue.remove(r)]
                if len(claimed) >= 2:
                    return ("batched", claimed)
                for r in claimed:  # unreachable in the single-threaded loop
                    self.queue.push(r, self.clock())
        if self.subslice:
            cands = pack.plan_subslice_candidates(
                pending, self.tenants, self._rotation
            )
            if cands:
                fleet = self._fleet_devices()
                assignments = pack.plan_subslices(
                    [(r, self.tenants[r.tenant].model) for r in cands],
                    fleet,
                    self.link_model,
                )
                if assignments:
                    claimed = [
                        a for a in assignments if self.queue.remove(a[0])
                    ]
                    if len(claimed) >= 2:
                        return ("subslice", claimed)
                    for a in claimed:  # unreachable, as above
                        self.queue.push(a[0], self.clock())
        return None

    def _probe_envelope(self, req: Request):
        """Fire exactly the injected-fault surface a serial dispatch of
        ``req`` would fire (dispatch hook, then the execute hook under the
        retry policy, charged to the tenant's budget) WITHOUT running the
        model — the batched path consumes each member's envelope up front
        so a seeded fault against one tenant of a batch surfaces before
        any state is installed.  Returns (attempts, error-or-None)."""
        tenant = self.tenants[req.tenant]
        label = f"serve:{req.tenant}"
        attempts = [0]

        def probe():
            attempts[0] += 1
            inject.maybe_fail("execute", label)

        try:
            inject.maybe_fail("dispatch", label)
            execute_with_retry(
                probe,
                label=label,
                policy=self.retry_policy,
                budget=tenant.budget,
                sleep=self.sleep,
                rng=self.rng,
            )
        except Exception as e:  # noqa: BLE001 — classified by the caller
            return attempts[0], e
        tenant.retries += max(0, attempts[0] - 1)
        return attempts[0], None

    def _dispatch_batched(self, reqs: List[Request]) -> List[Response]:
        """ONE dispatch for a geometry-matched group: per-member fault
        envelopes fire first (in queue order); then copies of the
        states run in one call and install on success.  ANY classified
        failure — a member's envelope or the batched execution itself —
        falls the group back to serial re-execution, so isolation
        semantics (eviction, shedding, budgets) are exactly the serial
        path's; nothing installs unless the whole batch succeeds."""
        failed = None
        for r in reqs:
            attempts, err = self._probe_envelope(r)
            if err is not None:
                failed = (r, err, attempts)
                break
        if failed is None:
            if self._slow_pending:
                self._slow_pending = False
                self.sleep(self.slow_penalty_s)
            models = [self.tenants[r.tenant].model for r in reqs]
            try:
                self._batch_exec.run(models, reqs[0].steps)
            except Exception as e:  # noqa: BLE001 — classified serially below
                failed = (None, e, 0)
        if failed is not None:
            bad, err, attempts = failed
            telemetry.inc(tm.SERVE_BATCH_FALLBACKS)
            log_warn(
                f"serve: batched dispatch of {len(reqs)} requests fell "
                f"back to serial ({type(err).__name__}: {str(err)[:160]})"
            )
            out = []
            for r in reqs:
                if r is bad:
                    out.append(
                        self._on_dispatch_failure(
                            r, self.tenants[r.tenant], err, attempts
                        )
                    )
                else:
                    out.append(self._dispatch(r))
            return out
        now = self.clock()
        telemetry.inc(tm.SERVE_BATCH_DISPATCHES)
        telemetry.observe(tm.SERVE_BATCH_SIZE, len(reqs))
        self._gauge_occupancy(
            self._model_devices(self.tenants[reqs[0].tenant].model)
        )
        out = []
        for r in reqs:
            tenant = self.tenants[r.tenant]
            latency = max(0.0, now - r.enqueued_at)
            tenant.completed += 1
            tenant.latency.insert(latency)
            self._completed_total += 1
            telemetry.inc(tm.SERVE_COMPLETED)
            telemetry.observe(tm.SERVE_LATENCY_SECONDS, latency)
            out.append(
                Response(
                    request=r, ok=True, latency_s=latency, steps_done=r.steps
                )
            )
        self._heartbeat()
        return out

    def _dispatch_subslice(self, assignments) -> List[Response]:
        """Place each tenant on its disjoint sub-slice, then dispatch
        every request through the UNCHANGED serial envelope back-to-back
        (no synchronization between them: the launches queue on the
        card's stream), and every fault/retry/budget semantic is literally
        the serial path's.  A placement failure (a reshard leaves the state
        as it was) degrades to serial dispatch on whatever grid each
        tenant holds."""
        try:
            pack.place_subslices(assignments)
        except Exception as e:  # noqa: BLE001 — placement only; state restored
            telemetry.inc(tm.SERVE_BATCH_FALLBACKS)
            log_warn(
                f"serve: sub-slice placement of {len(assignments)} tenants "
                f"fell back to serial ({type(e).__name__}: {str(e)[:160]})"
            )
        else:
            telemetry.inc(tm.SERVE_SUBSLICE_DISPATCHES)
            telemetry.observe(tm.SERVE_SUBSLICE_COUNT, len(assignments))
            self._gauge_occupancy(
                sum(
                    self._model_devices(m) for _r, m, _d in assignments
                )
            )
        return [self._dispatch(r) for r, _m, _d in assignments]

    @staticmethod
    def _model_devices(model) -> int:
        """The slots a tenant's dispatch occupies: its subdomain count."""
        dd = getattr(model, "dd", None)
        if dd is None or not getattr(dd, "_realized", False):
            return 0
        return int(dd.num_subdomains())

    def _fleet_devices(self) -> list:
        """The slot pool the bin-packer carves: the pinned ``fleet`` when
        given, else the union of the tenants' current slots."""
        if self.fleet is not None:
            return list(self.fleet)
        from stencil_tpu_torch.parallel.topology import Slot

        seen: Dict[int, object] = {}
        for t in self.tenants.values():
            dd = getattr(t.model, "dd", None)
            if dd is None:
                continue
            for i in pack.tenant_slots(t.model):
                seen.setdefault(i, Slot(i, dd.device))
        return [seen[i] for i in sorted(seen)]

    def _gauge_occupancy(self, busy_devices: int) -> None:
        fleet = len(self._fleet_devices())
        if fleet > 0:
            telemetry.set_gauge(
                tm.SERVE_OCCUPANCY, min(1.0, busy_devices / fleet)
            )

    def _dispatch(self, req: Request) -> Response:
        tenant = self.tenants[req.tenant]
        label = f"serve:{req.tenant}"
        attempts = [0]

        def work():
            attempts[0] += 1
            inject.maybe_fail("execute", label)
            if self._slow_pending:
                # a seeded slow tenant: its request hogs its slot for the
                # penalty — charged to THIS request's latency only
                self._slow_pending = False
                self.sleep(self.slow_penalty_s)
            if tenant.model is not None:
                tenant.model.step(req.steps)

        try:
            inject.maybe_fail("dispatch", label)
            execute_with_retry(
                work,
                label=label,
                policy=self.retry_policy,
                budget=tenant.budget,
                sleep=self.sleep,
                rng=self.rng,
            )
        except Exception as e:  # noqa: BLE001 — classified right below
            return self._on_dispatch_failure(req, tenant, e, attempts[0])
        now = self.clock()
        latency = max(0.0, now - req.enqueued_at)
        tenant.completed += 1
        tenant.retries += max(0, attempts[0] - 1)
        tenant.latency.insert(latency)
        self._completed_total += 1
        telemetry.inc(tm.SERVE_COMPLETED)
        telemetry.observe(tm.SERVE_LATENCY_SECONDS, latency)
        self._heartbeat()
        return Response(
            request=req, ok=True, latency_s=latency, steps_done=req.steps
        )

    def _on_dispatch_failure(
        self, req: Request, tenant: Tenant, e: Exception, attempts: int
    ) -> Response:
        now = self.clock()
        cls = classify(e)
        tenant.retries += max(0, attempts - 1)
        if cls is FailureClass.OVERLOAD:
            # an injected overload at the dispatch hook: shed THIS request,
            # never evict the (healthy) tenant it happened to land on
            return self._shed(req, "injected", now)
        action = tenant.handle_failure(cls, str(e))
        if action == "evict":
            telemetry.inc(tm.SERVE_EVICTED)
            telemetry.emit_event(
                tm.EVENT_SERVE_EVICTION,
                tenant=req.tenant,
                failure_class=cls.value,
                why=str(e)[:300],
            )
            log_warn(
                f"serve: tenant {req.tenant} quarantined after {cls.value}: {e}"
            )
            self._gauge_tenants()
        elif action == "propagate" and cls is FailureClass.PREEMPTED:
            raise e  # a preemption outranks serving bookkeeping
        self._heartbeat()
        return Response(
            request=req,
            ok=False,
            latency_s=max(0.0, now - req.enqueued_at),
            error=str(e)[:300],
            failure_class=cls.value,
        )

    # --- loops + reporting ----------------------------------------------------

    def drain(self, max_cycles: int = 10_000) -> List[Response]:
        """Cycle until the queue is empty (or the cycle bound trips —
        never an unbounded loop inside a bounded-queue package).  A
        truncated drain is NOT silent: it logs the bound and the work
        left behind, and counts ``serve.drain.truncated``."""
        out: List[Response] = []
        for _ in range(max_cycles):
            if self.queue.depth() == 0:
                break
            out.extend(self.cycle())
        remaining = self.queue.depth()
        if remaining > 0:
            telemetry.inc(tm.SERVE_DRAIN_TRUNCATED)
            log_warn(
                f"serve: drain truncated at max_cycles={max_cycles} with "
                f"{remaining} request(s) still queued"
            )
        return out

    def tenant_table(self) -> List[dict]:
        return [t.table_row() for t in self.tenants.values()]

    def _heartbeat(self) -> None:
        if self.flight is None:
            return
        self.flight.heartbeat(
            self._completed_total,
            phase="serving",
            queue_depth=self.queue.depth(),
            tenants=self.tenant_table(),
        )
