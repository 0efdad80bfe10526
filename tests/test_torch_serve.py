"""The port's serving layer (``stencil_tpu_torch/serve/``, ``analysis/vmem.py``,
``bin/stencil_serve.py``, ``bin/run_soak.py``) against the JAX package's.

Every scenario of ``tests/test_serve.py`` runs through BOTH servers on one
injected fake clock with the same fault plan: the OVERLOAD class, jittered
retry budgets, the bounded queue, admission (the shared-memory verdict, the
AOT budget and stamps), shedding, the envelope, isolation under each fault
class with Jacobi tenants at 16^3 on 8 CPU subdomains (the port's torch
engine) and 8 fake devices (the JAX ``jnp`` route), elasticity, the status
table and the ledger.  Compared: the response sequence (ok, failure class,
steps done), the tenant tables without latencies, the ``serve.*`` counters
and the final fields, bitwise (the torch engine equals the ``jnp`` route
bit for bit).  Both ``stencil_serve`` drivers run in process and give the
same digests, counts and decisions; ``run_soak --serve`` runs in process
(its subprocess form is ``slow``).
"""

import ast
import json
import os
import random
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from stencil_tpu import serve as jserve
from stencil_tpu import telemetry as jtelemetry
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.resilience import inject as jinject
from stencil_tpu.resilience import retry as jretry
from stencil_tpu.resilience import taxonomy as jtax
from stencil_tpu_torch import serve
from stencil_tpu_torch import telemetry
from stencil_tpu_torch.analysis import check_vmem
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.resilience import inject
from stencil_tpu_torch.resilience import retry
from stencil_tpu_torch.resilience import taxonomy as tax
from stencil_tpu_torch.serve import aot as paot

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16  # the tenants' cubic edge
SUB = 8  # subdomains / fake devices

JAX = types.SimpleNamespace(name="jax", serve=jserve, inject=jinject, retry=jretry, tax=jtax, telemetry=jtelemetry)
PORT = types.SimpleNamespace(name="torch", serve=serve, inject=inject, retry=retry, tax=tax, telemetry=telemetry)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clear_fault_plans():
    yield
    inject.set_plan(None)
    jinject.set_plan(None)


class FakeClock:
    """Injectable monotonic clock: tests advance time, nothing sleeps."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_server(pkg, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("aot", pkg.serve.AOTCache(stamp_dir=None, clock=kw["clock"]))
    return pkg.serve.StencilServer(**kw)


def jacobi(pkg, n: int = N):
    if pkg is JAX:
        m = JJacobi3D(n, n, n, devices=jax.devices()[:SUB])
    else:
        m = Jacobi3D(n, n, n, kernel_impl="torch", subdomains=SUB, device="cpu")
    m.realize()
    return m


def serve_counters(pkg) -> dict:
    return {k: v for k, v in pkg.telemetry.snapshot()["counters"].items() if k.startswith("serve.")}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def table(srv) -> list:
    """The tenant table without latencies."""
    return [{k: v for k, v in row.items() if not k.endswith("_ms")} for row in srv.tenant_table()]


def responses(out) -> list:
    return [(r.request.tenant, r.ok, r.failure_class, r.steps_done) for r in out]


def _serve_rounds(pkg, srv, order, rounds, steps=1):
    """Submit one request per tenant per round (skipping refused tenants),
    draining between rounds; returns every response."""
    out = []
    for _ in range(rounds):
        for tid in order:
            try:
                srv.submit(pkg.serve.Request(tenant=tid, steps=steps))
            except (pkg.tax.OverloadError, pkg.serve.AdmissionRefused):
                pass
        out.extend(srv.drain())
    return out


# --- the OVERLOAD taxonomy class --------------------------------------------


class TestOverloadTaxonomy:
    @pytest.mark.parametrize("why", ["queue_full", "deadline", "compile_budget"])
    def test_pinned_wordings_classify_overload(self, why):
        e, je = tax.OverloadError(why=why), jtax.OverloadError(why=why)
        assert str(e) == str(je)
        assert tax.classify(e) is tax.FailureClass.OVERLOAD
        assert tax.classify(RuntimeError(str(e))) is tax.FailureClass.OVERLOAD

    def test_deadline_shed_outranks_transient(self):
        msg = str(tax.OverloadError(why="deadline"))
        assert "deadline exceeded" in msg
        assert tax.classify(RuntimeError(msg)) is tax.FailureClass.OVERLOAD
        assert tax.classify(RuntimeError("deadline exceeded")) is tax.FailureClass.TRANSIENT_RUNTIME

    def test_overload_is_never_blindly_retried(self):
        sleeps, calls = [], [0]

        def saturated():
            calls[0] += 1
            raise tax.OverloadError(why="queue_full", queue_depth=64)

        with pytest.raises(tax.OverloadError):
            retry.execute_with_retry(saturated, sleep=sleeps.append)
        assert calls == [1] and sleeps == []

    def test_overload_carries_backoff_hint(self):
        e = tax.OverloadError(why="queue_full", queue_depth=7, retry_after_s=1.5)
        assert e.retry_after_s == 1.5 and e.queue_depth == 7 and "retry after 1.50s" in str(e)

    def test_fault_plan_parses_serving_classes(self):
        text = ("dispatch:overload:serve:*@1,execute:poison_request:serve:tenant-b,"
                "execute:slow_tenant:serve:tenant-a*2")
        got = [[(e.cls.value if e.cls else None, e.slow, e.skip, e.remaining) for e in pkg.inject.FaultPlan.parse(
            text)._entries] for pkg in BOTH]
        assert got[0] == got[1] == [("overload", None, 1, 1), ("divergence", None, 0, 1),
                                    (None, "slow_tenant", 0, 2)]

    def test_slow_handler_receives_the_notice(self):
        seen = []
        prev = inject.set_slow_handler(lambda phase, label: seen.append((phase, label)))
        try:
            inject.set_plan("execute:slow_tenant:serve:t*1")
            inject.maybe_fail("execute", "serve:t")
            inject.maybe_fail("execute", "serve:t")
        finally:
            assert inject.set_slow_handler(prev) is not None
        assert seen == [("execute", "serve:t")]


# --- jittered backoff + shared retry budgets --------------------------------


class TestRetryJitterAndBudget:
    def test_zero_jitter_recovers_the_deterministic_schedule(self):
        p = retry.RetryPolicy(backoff_base_s=0.25, multiplier=2.0, jitter=0.0)
        assert [p.delay_s(a) for a in range(3)] == [0.25, 0.5, 1.0]

    def test_seeded_jitter_equals_the_jax_schedule(self):
        got = [[pkg.retry.RetryPolicy(backoff_base_s=1.0, multiplier=2.0, jitter=0.1).delay_s(
            n, rng=random.Random(7)) for n in range(4)] for pkg in BOTH]
        assert got[0] == got[1]
        for n, d in enumerate(got[1]):
            assert 2.0**n * 0.9 <= d <= 2.0**n * 1.1

    def test_jitter_env_knob(self, monkeypatch):
        monkeypatch.setenv("STENCIL_RETRY_JITTER", "0.5")
        assert retry.RetryPolicy.from_env().jitter == jretry.RetryPolicy.from_env().jitter == 0.5
        monkeypatch.setenv("STENCIL_RETRY_JITTER", "7")
        assert retry.RetryPolicy.from_env().jitter == jretry.RetryPolicy.from_env().jitter == 1.0

    def test_budget_charges_and_replenishes(self):
        b = retry.RetryBudget(2, label="t")
        assert b.try_charge() and b.try_charge() and not b.try_charge()
        b.replenish()
        assert b.remaining == 2

    def test_shared_budget_caps_retries_across_calls(self):
        got = []
        for pkg in BOTH:
            budget = pkg.retry.RetryBudget(2)
            policy = pkg.retry.RetryPolicy(max_retries=3, backoff_base_s=0.0, jitter=0.0)
            state = [0]

            def flaky_once():
                state[0] += 1
                if state[0] == 1:
                    raise RuntimeError("unavailable: tunnel dropped")

            pkg.retry.execute_with_retry(flaky_once, policy=policy, budget=budget, sleep=lambda s: None)
            after_one = budget.remaining

            def always_flaky():
                raise RuntimeError("unavailable: tunnel dropped")

            calls = []
            with pytest.raises(RuntimeError):
                pkg.retry.execute_with_retry(always_flaky, policy=policy, budget=budget, sleep=calls.append)
            got.append((after_one, len(calls), budget.remaining))
        assert got[0] == got[1] == (1, 1, 0)


# --- the bounded queue -------------------------------------------------------


class TestBoundedQueue:
    def test_full_queue_refuses_with_classified_overload(self):
        q = serve.BoundedQueue(2)
        q.push(serve.Request(tenant="a"), now=0.0)
        q.push(serve.Request(tenant="a"), now=0.0)
        with pytest.raises(tax.OverloadError) as ei:
            q.push(serve.Request(tenant="b"), now=0.0)
        assert tax.classify(ei.value) is tax.FailureClass.OVERLOAD
        assert ei.value.queue_depth == 2 and ei.value.retry_after_s is not None

    def test_bound_must_be_positive(self):
        with pytest.raises(ValueError):
            serve.BoundedQueue(0)

    def test_shed_expired_oldest_first(self):
        got = []
        for pkg in BOTH:
            q = pkg.serve.BoundedQueue(8)
            keep = pkg.serve.Request(tenant="a", deadline_s=100.0)
            q.push(pkg.serve.Request(tenant="c", deadline_s=2.0), now=0.0)
            q.push(pkg.serve.Request(tenant="b", deadline_s=1.0), now=0.5)
            q.push(keep, now=1.0)
            got.append(([r.tenant for r in q.shed_expired(now=50.0)], q.peek_all() == [keep]))
        assert got[0] == got[1] == (["c", "b"], True)

    def test_priority_make_room_takes_the_lowest(self):
        q = serve.BoundedQueue(8)
        q.push(serve.Request(tenant="lo", priority=0), now=0.0)
        q.push(serve.Request(tenant="mid", priority=1), now=0.0)
        assert q.shed_lowest_priority(below=2).tenant == "lo"
        assert q.shed_lowest_priority(below=0) is None

    def test_take_is_round_robin_by_rotation(self):
        got = []
        for pkg in BOTH:
            q = pkg.serve.BoundedQueue(8)
            for t in ("a", "a", "b", "c"):
                q.push(pkg.serve.Request(tenant=t), now=0.0)
            seq = [q.take(rot) for rot in (["b", "c", "a"], ["c", "a", "b"], ["a", "b", "c"], ["b", "c", "a"],
                                           ["a"])]
            got.append([r.tenant if r else None for r in seq])
        assert got[0] == got[1] == ["b", "c", "a", "a", None]


# --- admission ---------------------------------------------------------------


class TestAdmission:
    @pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
    def test_unknown_tenant_is_fatal(self, pkg):
        srv = make_server(pkg)
        try:
            with pytest.raises(pkg.serve.AdmissionRefused) as ei:
                srv.submit(pkg.serve.Request(tenant="ghost"))
            assert ei.value.failure_class is pkg.tax.FailureClass.FATAL
        finally:
            srv.close()

    @pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
    def test_evicted_tenant_refusal_is_fatal(self, pkg):
        srv = make_server(pkg)
        try:
            srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a")).quarantine("poisoned")
            with pytest.raises(pkg.serve.AdmissionRefused) as ei:
                srv.submit(pkg.serve.Request(tenant="a"))
            assert ei.value.failure_class is pkg.tax.FailureClass.FATAL and "quarantined" in str(ei.value)
        finally:
            srv.close()

    def test_smem_verdict_refuses_an_oversized_plan(self):
        """The static verdict (analysis.check_vmem) runs at admission: a
        wavefront plan whose kernel asks more shared memory a block than the
        card grants is refused as a degradable VMEM_OOM, in both packages."""
        for pkg in BOTH:
            m = jacobi(pkg)
            srv = make_server(pkg)
            try:
                srv.add_tenant(pkg.serve.TenantSpec(tenant_id="big", plan={"route": "wavefront", "m": 10**6}), m)
                with pytest.raises(pkg.serve.AdmissionRefused) as ei:
                    srv.submit(pkg.serve.Request(tenant="big"))
                assert ei.value.failure_class is pkg.tax.FailureClass.VMEM_OOM
                assert srv.queue.depth() == 0 and serve_counters(pkg)["serve.rejected"] >= 1
            finally:
                srv.close()

    def test_deep_plane_plan_fits_shared_memory(self):
        """Deliberate difference (ROADMAP.md): the plane kernel runs one level
        a launch, so a plane plan's shared memory does not grow with its
        depth.  The JAX VMEM model refuses ``plane[m=10**6]``; the port
        admits it."""
        pm, jm = jacobi(PORT), jacobi(JAX)
        plan = {"route": "plane", "m": 10**6}
        from stencil_tpu.analysis import check_vmem as jcheck

        assert jcheck(jm.dd, plan) is not None
        assert check_vmem(pm.dd, plan) is None
        srv = make_server(PORT)
        try:
            srv.add_tenant(serve.TenantSpec(tenant_id="deep", plan=plan), pm)
            srv.submit(serve.Request(tenant="deep"))
            assert srv.queue.depth() == 1
        finally:
            srv.close()

    @pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
    def test_cold_compile_over_budget_refuses_then_warms(self, pkg):
        clk = FakeClock()
        srv = make_server(pkg, clock=clk, compile_budget_s=0.5)
        builds = [0]

        def build():
            builds[0] += 1
            clk.advance(2.0)
            return object()

        try:
            srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a"))
            srv.register_workload("k1", build)
            with pytest.raises(pkg.tax.OverloadError) as ei:
                srv.submit(pkg.serve.Request(tenant="a", key_digest="k1"))
            assert ei.value.why == "compile_budget" and pkg.tax.classify(ei.value) is pkg.tax.FailureClass.OVERLOAD
            srv.submit(pkg.serve.Request(tenant="a", key_digest="k1"))
            assert builds == [1] and srv.queue.depth() == 1
        finally:
            srv.close()

    def test_warm_key_admits_without_building(self):
        clk = FakeClock()
        srv = make_server(PORT, clock=clk, compile_budget_s=0.5)
        try:
            srv.add_tenant(serve.TenantSpec(tenant_id="a"))
            srv.aot.compile("k1", lambda: object(), label="a")
            srv.register_workload("k1", lambda: pytest.fail("rebuilt a warm key"))
            srv.submit(serve.Request(tenant="a", key_digest="k1"))
        finally:
            srv.close()

    def test_tenant_build_is_the_rung_build(self):
        """A model's AOT build is its ladder rung's build (the kernel
        library and the step); on the CPU it loads no library."""
        m = Jacobi3D(16, 16, 16, kernel_impl="cuda", subdomains=SUB, device="cpu")
        m.realize()
        build, libraries = paot.tenant_build(m)
        assert libraries == ()
        cache = paot.AOTCache(stamp_dir=None, clock=FakeClock())
        step, seconds = cache.compile(m.dd.tune_key("jacobi-wavefront").digest(), build, libraries=libraries)
        assert callable(step) and seconds == 0.0
        with pytest.raises(ValueError, match="no realized ladder"):
            paot.tenant_build(Jacobi3D(8, 8, 8, device="cpu"))

    def test_tenant_build_of_a_stream_tenant(self, monkeypatch):
        """A stream-engine tenant (no Jacobi ladder: its step's) builds its
        rung; on the CPU it loads no library, on the card its rung cannot
        name the generated libraries, so the build is never stamped."""
        from stencil_tpu_torch.models.astaroth import AstarothSim

        m = AstarothSim(16, 16, 16, num_quantities=2, kernel_impl="cuda", device="cpu")
        m.realize()
        build, libraries = paot.tenant_build(m)
        assert libraries == () and callable(build())
        monkeypatch.setattr(m.dd, "device", torch.device("cuda"))
        assert paot.tenant_build(m)[1] is None


class TestAOTStamps:
    def test_stamp_survives_a_process_restart(self, tmp_path):
        d = str(tmp_path / "aot")
        clk = FakeClock()

        def slow_build():
            clk.advance(3.0)
            return object()

        paot.AOTCache(stamp_dir=d, clock=clk).compile("k", slow_build, libraries=())
        fresh = paot.AOTCache(stamp_dir=d, clock=clk)
        assert fresh.stamped("k") and not fresh.warm("k") and fresh.estimate_s("k") == 3.0
        exe, seconds = fresh.compile("k", slow_build, budget_s=0.1)
        assert exe is not None and seconds > 0.1
        doc = json.load(open(os.path.join(d, "k.json")))
        assert doc["torch"] == torch.__version__ and doc["cuda"] == torch.version.cuda and doc["schema"] == 1

    def test_stamp_is_warm_only_while_its_libraries_are_built(self, tmp_path):
        """A stamp counts as warm across processes only while
        kernels/build.py finds the libraries its build loaded; without them
        the recorded seconds are the rebuild's estimate and the budget
        refusal applies again."""
        d, lib = str(tmp_path / "aot"), tmp_path / "libjacobi_wavefront-x.so"
        lib.write_bytes(b"")
        clk = FakeClock()

        def slow_build():
            clk.advance(3.0)
            return object()

        paot.AOTCache(stamp_dir=d, clock=clk).compile("k", slow_build, libraries=[str(lib)])
        assert paot.AOTCache(stamp_dir=d, clock=clk).stamped("k")
        lib.unlink()
        gone = paot.AOTCache(stamp_dir=d, clock=clk)
        assert not gone.stamped("k") and gone.estimate_s("k") == 3.0
        with pytest.raises(tax.OverloadError, match="exceeded the admission budget"):
            gone.compile("k", slow_build, budget_s=0.1)
        assert gone.warm("k")

    def test_corrupt_or_stale_stamp_is_a_miss(self, tmp_path):
        d = str(tmp_path / "aot")
        clk = FakeClock()
        paot.AOTCache(stamp_dir=d, clock=clk).compile("k", lambda: object(), libraries=())
        path = os.path.join(d, "k.json")
        with open(path, "w") as f:
            f.write("{not json")
        assert not paot.AOTCache(stamp_dir=d, clock=clk).stamped("k")
        with open(path, "w") as f:
            json.dump({"schema": 1, "torch": "0.0", "cuda": None, "seconds": 1.0}, f)
        assert not paot.AOTCache(stamp_dir=d, clock=clk).stamped("k")
        with open(path, "w") as f:
            json.dump({"schema": 999, "torch": torch.__version__, "cuda": torch.version.cuda}, f)
        assert not paot.AOTCache(stamp_dir=d, clock=clk).stamped("k")

    def test_a_build_that_cannot_name_its_libraries_gets_no_stamp(self, tmp_path):
        """A build whose rung cannot say what it loads (a stream-engine
        tenant on the card, a bare registered build) stays warm in-process
        only: no stamp, so the next process builds it under the budget."""
        d = str(tmp_path / "aot")
        clk = FakeClock()

        def slow_build():
            clk.advance(3.0)
            return object()

        cache = paot.AOTCache(stamp_dir=d, clock=clk)
        with pytest.raises(tax.OverloadError):
            cache.compile("k", slow_build, budget_s=0.1)
        assert cache.warm("k") and not os.path.exists(os.path.join(d, "k.json"))
        fresh = paot.AOTCache(stamp_dir=d, clock=clk)
        assert not fresh.stamped("k") and fresh.estimate_s("k") is None
        with pytest.raises(tax.OverloadError):
            fresh.compile("k", slow_build, budget_s=0.1)

    def test_server_stamps_only_named_libraries(self, tmp_path):
        """``register_workload``'s libraries reach the stamp: named ones
        stamp, an unnamed build does not."""
        d = str(tmp_path / "aot")
        clk = FakeClock()
        srv = make_server(PORT, clock=clk, aot=paot.AOTCache(stamp_dir=d, clock=clk))
        try:
            srv.add_tenant(serve.TenantSpec(tenant_id="a"))
            srv.register_workload("named", lambda: object(), libraries=())
            srv.register_workload("unnamed", lambda: object())
            srv.submit(serve.Request(tenant="a", key_digest="named"))
            srv.submit(serve.Request(tenant="a", key_digest="unnamed"))
        finally:
            srv.close()
        fresh = paot.AOTCache(stamp_dir=d, clock=clk)
        assert fresh.stamped("named") and not fresh.stamped("unnamed")

    def test_stamp_dir_follows_the_cache_env(self, tmp_path, monkeypatch):
        monkeypatch.delenv("STENCIL_COMPILE_CACHE_DIR", raising=False)
        assert paot.default_stamp_dir() is None
        monkeypatch.setenv("STENCIL_COMPILE_CACHE_DIR", str(tmp_path))
        assert paot.default_stamp_dir() == os.path.join(str(tmp_path), "serve_aot")


# --- shedding + deadlines ----------------------------------------------------


def _shed_expired(pkg):
    clk = FakeClock()
    srv = make_server(pkg, clock=clk, default_deadline_s=5.0)
    try:
        srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a"))
        srv.submit(pkg.serve.Request(tenant="a"))
        clk.advance(6.0)
        out = srv.cycle()
        return responses(out), "deadline" in out[0].error, table(srv)
    finally:
        srv.close()


def _shed_before_refusing(pkg):
    clk = FakeClock()
    srv = make_server(pkg, clock=clk, queue_max=2, default_deadline_s=5.0)
    try:
        srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a"))
        srv.submit(pkg.serve.Request(tenant="a"))
        srv.submit(pkg.serve.Request(tenant="a"))
        clk.advance(6.0)
        srv.submit(pkg.serve.Request(tenant="a"))
        return srv.queue.depth(), table(srv)
    finally:
        srv.close()


def _priority_make_room(pkg):
    srv = make_server(pkg, queue_max=2)
    try:
        srv.add_tenant(pkg.serve.TenantSpec(tenant_id="lo", priority=0))
        srv.add_tenant(pkg.serve.TenantSpec(tenant_id="hi", priority=1))
        srv.submit(pkg.serve.Request(tenant="lo"))
        srv.submit(pkg.serve.Request(tenant="lo"))
        srv.submit(pkg.serve.Request(tenant="hi", priority=1))
        return sorted(r.tenant for r in srv.queue.peek_all()), table(srv)
    finally:
        srv.close()


def _equal_priority_backpressure(pkg):
    srv = make_server(pkg, queue_max=2)
    try:
        srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a"))
        srv.submit(pkg.serve.Request(tenant="a"))
        srv.submit(pkg.serve.Request(tenant="a"))
        with pytest.raises(pkg.tax.OverloadError) as ei:
            srv.submit(pkg.serve.Request(tenant="a"))
        return ei.value.why, srv.queue.depth(), table(srv)
    finally:
        srv.close()


class TestShedding:
    @pytest.mark.parametrize("scenario,want", [
        (_shed_expired, None), (_shed_before_refusing, None), (_priority_make_room, None),
        (_equal_priority_backpressure, None)])
    def test_both_servers_shed_alike(self, scenario, want):
        before = [serve_counters(p) for p in BOTH]
        got = [scenario(p) for p in BOTH]
        moved = [delta(serve_counters(p), b) for p, b in zip(BOTH, before)]
        assert got[0] == got[1]
        assert moved[0] == moved[1]

    def test_expired_request_is_shed_not_evicted(self):
        resp, deadline, rows = _shed_expired(PORT)
        assert resp == [("a", False, "overload", 0)] and deadline
        assert rows[0]["shed"] == 1 and rows[0]["state"] == "active"

    def test_full_queue_sheds_expired_then_admits(self):
        depth, rows = _shed_before_refusing(PORT)
        assert depth == 1 and rows[0]["shed"] == 2

    def test_higher_priority_arrival_sheds_the_lowest(self):
        queued, rows = _priority_make_room(PORT)
        assert queued == ["hi", "lo"] and rows[0]["shed"] == 1

    def test_equal_priority_arrival_is_backpressured(self):
        assert _equal_priority_backpressure(PORT)[:2] == ("queue_full", 2)


# --- the per-tenant envelope (unit) -----------------------------------------


class _LadderModel:
    """Fake model: a ``rungs``-rung descent ladder, then exhaustion."""

    def __init__(self, rungs: int = 2):
        self.rungs = rungs
        self.descents = 0

    def step_down(self, cls) -> bool:
        if self.descents >= self.rungs:
            return False
        self.descents += 1
        return True

    def step(self, n):
        pass


class TestTenantEnvelope:
    def _both(self, spec_kw, model_rungs, classes):
        out = []
        for pkg in BOTH:
            t = pkg.serve.Tenant(pkg.serve.TenantSpec(tenant_id="a", **spec_kw),
                                 _LadderModel(model_rungs) if model_rungs is not None else None)
            acts = [t.handle_failure(getattr(pkg.tax.FailureClass, c)) for c in classes]
            out.append((acts, t.state, t.rung, t.why))
        assert out[0] == out[1]
        return out[1]

    def test_vmem_oom_descends_then_quarantines_on_exhaustion(self):
        acts, state, _, why = self._both({"max_rungs": 5}, 2, ["VMEM_OOM"] * 3)
        assert acts == ["degrade", "degrade", "evict"] and state == serve.QUARANTINED and "ladder exhausted" in why

    def test_max_rungs_bounds_the_descents(self):
        acts, state, _, _ = self._both({"max_rungs": 1}, 99, ["COMPILE_REJECT", "VMEM_OOM"])
        assert acts == ["degrade", "evict"] and state == serve.QUARANTINED

    def test_divergence_evicts_only_this_tenant(self):
        t, other = serve.Tenant(serve.TenantSpec(tenant_id="a")), serve.Tenant(serve.TenantSpec(tenant_id="b"))
        assert t.handle_failure(tax.FailureClass.DIVERGENCE, "poisoned") == "evict"
        assert t.state == serve.QUARANTINED and not t.active() and other.state == serve.ACTIVE

    def test_transient_and_preempted_routing(self):
        acts, state, _, _ = self._both({}, None, ["TRANSIENT_RUNTIME", "PREEMPTED"])
        assert acts == ["retry_exhausted", "propagate"] and state == serve.ACTIVE

    def test_jacobi_step_down_on_the_cuda_engine(self):
        """The envelope's descent reaches Jacobi3D's ``_step_down``: the
        cuda engine's wavefront steps one depth down, the torch engine has
        nothing to descend and quarantines."""
        m = Jacobi3D(32, 32, 32, kernel_impl="cuda", subdomains=SUB, device="cpu")
        m.realize()
        depth = m._wavefront_m
        t = serve.Tenant(serve.TenantSpec(tenant_id="c"), m)
        assert depth >= 2 and t.handle_failure(tax.FailureClass.VMEM_OOM) == "degrade"
        assert m._wavefront_depth == depth - 1 and t.state == serve.ACTIVE
        t2 = serve.Tenant(serve.TenantSpec(tenant_id="d"), jacobi(PORT))
        assert t2.handle_failure(tax.FailureClass.VMEM_OOM) == "evict" and t2.state == serve.QUARANTINED


# --- fault isolation, bitwise (>= 3 tenants, real fields) -------------------


def _isolation(pkg, plan, n_tenants=3, rounds=4, **srv_kw):
    """Serve ``rounds`` rounds of Jacobi tenants under ``plan``; returns
    (responses, tenant table, serve counters moved, final fields, server)."""
    models = {f"tenant-{chr(ord('a') + i)}": jacobi(pkg) for i in range(n_tenants)}
    before = serve_counters(pkg)
    srv_kw.setdefault("queue_max", 16)
    srv = make_server(pkg, **srv_kw)
    try:
        for tid, m in sorted(models.items()):
            srv.add_tenant(pkg.serve.TenantSpec(tenant_id=tid), m)
        pkg.inject.set_plan(plan)
        out = _serve_rounds(pkg, srv, sorted(models), rounds)
    finally:
        srv.close()
        pkg.inject.set_plan(None)
    fields = {tid: np.asarray(m.temperature()) for tid, m in models.items()}
    return responses(out), table(srv), delta(serve_counters(pkg), before), fields, srv


def _reference(steps):
    m = jacobi(PORT)
    if steps:
        m.step(steps)
    return m.temperature()


def _twin(plan, **kw):
    """The same scenario through both servers: everything but latencies equal."""
    j = _isolation(JAX, plan, **kw)
    p = _isolation(PORT, plan, **kw)
    assert p[0] == j[0], "response sequences differ"
    assert p[1] == j[1], "tenant tables differ"
    assert p[2] == j[2], "serve counters differ"
    assert p[3].keys() == j[3].keys()
    for tid in p[3]:
        np.testing.assert_array_equal(p[3][tid], j[3][tid])
    return p


class TestTenantIsolation:
    def test_poison_request_evicts_only_its_tenant_bitwise(self):
        resp, rows, counters, fields, srv = _twin("execute:poison_request:serve:tenant-b@1")
        states = {r["tenant"]: r["state"] for r in rows}
        assert states == {"tenant-a": "active", "tenant-b": "quarantined", "tenant-c": "active"}
        want4 = _reference(4)
        np.testing.assert_array_equal(fields["tenant-a"], want4)
        np.testing.assert_array_equal(fields["tenant-c"], want4)
        np.testing.assert_array_equal(fields["tenant-b"], _reference(1))
        assert counters["serve.evicted"] == 1
        with pytest.raises(serve.AdmissionRefused):
            srv.submit(serve.Request(tenant="tenant-b"))

    def test_vmem_oom_stays_inside_its_envelope_bitwise(self):
        resp, rows, _, fields, _ = _twin("execute:vmem_oom:serve:tenant-c@1")
        tc = [r for r in rows if r["tenant"] == "tenant-c"][0]
        assert tc["rung"] > 0 or tc["state"] != "active"
        want4 = _reference(4)
        np.testing.assert_array_equal(fields["tenant-a"], want4)
        np.testing.assert_array_equal(fields["tenant-b"], want4)
        assert ("tenant-c", False, "vmem_oom", 0) in resp

    def test_injected_overload_sheds_without_evicting(self):
        resp, rows, counters, fields, _ = _twin("dispatch:overload:serve:tenant-a@0*1", n_tenants=2, rounds=2)
        shed = [r for r in resp if not r[1]]
        assert shed == [("tenant-a", False, "overload", 0)]
        assert all(r["state"] == "active" for r in rows) and counters["serve.shed"] == 1
        np.testing.assert_array_equal(fields["tenant-a"], _reference(1))
        np.testing.assert_array_equal(fields["tenant-b"], _reference(2))

    def test_slow_tenant_penalty_served_through_the_injectable_sleep(self):
        got = []
        for pkg in BOTH:
            sleeps, clk = [], FakeClock()
            srv = make_server(pkg, clock=clk, sleep=lambda s: (sleeps.append(s), clk.advance(s)),
                              slow_penalty_s=0.25)
            try:
                srv.add_tenant(pkg.serve.TenantSpec(tenant_id="ok"))
                srv.add_tenant(pkg.serve.TenantSpec(tenant_id="slow"))
                pkg.inject.set_plan("execute:slow_tenant:serve:slow*1")
                srv.submit(pkg.serve.Request(tenant="ok"))
                srv.submit(pkg.serve.Request(tenant="slow"))
                out = srv.drain()
            finally:
                srv.close()
            by = {r.request.tenant: r for r in out}
            got.append((sleeps, responses(out), by["slow"].latency_s, by["ok"].latency_s, table(srv)))
        assert got[0] == got[1]
        assert got[1][0] == [0.25] and got[1][2] >= 0.25 > got[1][3]

    def test_transient_retries_charge_the_tenant_budget(self):
        got = []
        for pkg in BOTH:
            sleeps = []
            srv = make_server(pkg, sleep=sleeps.append, retry_policy=pkg.retry.RetryPolicy(
                max_retries=3, backoff_base_s=0.01, jitter=0.0))
            try:
                srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a", retry_allowance=8))
                pkg.inject.set_plan("execute:transient:serve:a*2")
                srv.submit(pkg.serve.Request(tenant="a"))
                out = srv.drain()
            finally:
                srv.close()
            got.append((responses(out), table(srv), sleeps))
        assert got[0] == got[1]
        assert got[1][1][0]["retries"] == 2 and got[1][1][0]["budget_remaining"] == 6
        assert got[1][2] == [0.01, 0.02]

    def test_exhausted_budget_stops_the_retry_train(self):
        got = []
        for pkg in BOTH:
            srv = make_server(pkg, retry_policy=pkg.retry.RetryPolicy(max_retries=5, backoff_base_s=0.0,
                                                                       jitter=0.0))
            try:
                srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a", retry_allowance=1))
                pkg.inject.set_plan("execute:transient:serve:a*10")
                srv.submit(pkg.serve.Request(tenant="a"))
                out = srv.drain()
            finally:
                srv.close()
            got.append((responses(out), table(srv)))
        assert got[0] == got[1]
        assert got[1][0] == [("a", False, "transient", 0)]
        assert got[1][1][0]["budget_remaining"] == 0 and got[1][1][0]["state"] == "active"

    def test_fault_free_rounds_equal_the_jax_server(self):
        resp, rows, counters, fields, _ = _twin(None, rounds=3)
        assert all(r[1] for r in resp) and counters["serve.completed"] == 9
        for f in fields.values():
            np.testing.assert_array_equal(f, _reference(3))


# --- elasticity hysteresis ---------------------------------------------------


class TestElasticityPolicy:
    def test_dead_band_requires_low_below_high(self):
        with pytest.raises(ValueError):
            serve.ElasticityPolicy(high=4, low=4)

    @pytest.mark.parametrize("kw,depths", [
        ({"high": 4, "low": 0, "consecutive": 3, "cooldown_s": 0.0},
         [0, 0, 0, 5, 5, 5, 5, 5, 5, 5, 2, 2, 0, 0, 0, 0, 0, 0]),
        ({"high": 4, "low": 0, "consecutive": 3, "cooldown_s": 0.0}, [5, 5, 2, 5, 5]),
        ({"high": 4, "low": 0, "consecutive": 2, "cooldown_s": 10.0}, [5, 5, 0, 0, 0]),
    ])
    def test_decisions_equal_the_jax_policy(self, kw, depths):
        times = [0.0, 1.0, 2.0, 3.0, 12.0] if kw["cooldown_s"] else [float(i) for i in range(len(depths))]
        got = []
        for pkg in BOTH:
            p = pkg.serve.ElasticityPolicy(**kw)
            got.append(([p.observe(d, now=t) for d, t in zip(depths, times)], p.decisions))
        assert got[0] == got[1]

    def test_hysteresis_pinned(self):
        p = serve.ElasticityPolicy(high=4, low=0, consecutive=3, cooldown_s=0.0)
        got = [p.observe(d, now=float(i)) for i, d in enumerate(
            [0, 0, 0, 5, 5, 5, 5, 5, 5, 5, 2, 2, 0, 0, 0, 0, 0, 0])]
        assert [g for g in got if g] == ["grow", "shrink"] and got[5] == "grow" and got[14] == "shrink"

    def test_server_loop_grows_once_and_shrinks_once(self):
        got = []
        for pkg in BOTH:
            asked = []
            policy = pkg.serve.ElasticityPolicy(high=2, low=0, consecutive=2, cooldown_s=0.0)
            srv = make_server(pkg, queue_max=16, policy=policy, capacity=asked.append)
            try:
                srv.add_tenant(pkg.serve.TenantSpec(tenant_id="a"))
                for _ in range(6):
                    srv.submit(pkg.serve.Request(tenant="a"))
                for _ in range(8):
                    srv.cycle()
            finally:
                srv.close()
            got.append((asked, [k for _, k in policy.decisions]))
        assert got[0] == got[1] == (["grow", "shrink"], ["grow", "shrink"])

    def test_elastic_reshard_of_served_tenants_is_bitwise(self):
        """The driver's capacity callback on real tenants: a grow from 4 to
        8 subdomains and a shrink back, served in between; fields bitwise
        equal to a tenant that never moved."""
        moving = Jacobi3D(N, N, N, kernel_impl="torch", subdomains=4, device="cpu")
        moving.realize()
        srv = make_server(PORT, queue_max=16)
        try:
            srv.add_tenant(serve.TenantSpec(tenant_id="a"), moving)
            for sub in (8, 4):
                srv.submit(serve.Request(tenant="a", steps=2))
                srv.drain()
                moving.dd.reshard(subdomains=sub, source="policy")
                moving.rebuild_after_reshard()
            srv.submit(serve.Request(tenant="a", steps=2))
            srv.drain()
        finally:
            srv.close()
        np.testing.assert_array_equal(moving.temperature(), _reference(6))


# --- the shared-memory verdict -------------------------------------------------


class TestSmemVerdict:
    @pytest.mark.parametrize("route", ["wrap", "plane", "wavefront"])
    @pytest.mark.parametrize("unit", ["vpu", "mxu"])
    @pytest.mark.parametrize("fields,dtype", [(1, torch.float32), (8, torch.float32), (3, torch.float64)])
    def test_verdict_is_the_kernels_model(self, route, unit, fields, dtype):
        """check_vmem prices every route and depth with the model the kernels
        check before launch: stream_smem_fits for the wavefront (depth,
        fields, ring itemsize, unit), the wrap and plane kernels' own
        tiles otherwise."""
        from stencil_tpu_torch.domain import DistributedDomain
        from stencil_tpu_torch.ops import stream as st

        dd = DistributedDomain(16, 16, 16, device="cpu")
        dd.set_radius(1)
        for i in range(fields):
            dd.add_data(f"q{i}", dtype=dtype)
        dd.realize()
        item = st.ring_itemsize([dtype])
        for m in range(1, 13):
            plan = {"route": route, "m": m, "compute_unit": unit}
            fits = (st.stream_smem_fits(m, fields, item, unit) if route == "wavefront"
                    else st.stream_pass_smem_bytes(fields, unit) <= st.SMEM_PER_BLOCK)
            reason = check_vmem(dd, plan)
            assert (reason is None) == fits, (plan, reason)
            if reason is not None:
                assert reason.startswith(f"plan {route}[m={m}{',mxu' if unit == 'mxu' else ''}] models ")
                assert "bytes of shared memory a block against the 232448-byte budget" in reason
            per_field = dict(plan, grouping="per-field")
            one = (st.stream_smem_fits(m, 1, item, unit) if route == "wavefront"
                   else st.stream_pass_smem_bytes(1, unit) <= st.SMEM_PER_BLOCK)
            assert (check_vmem(dd, per_field) is None) == one

    def test_budget_override_and_malformed_plan(self):
        dd = jacobi(PORT).dd
        assert check_vmem(dd, {"route": "wavefront", "m": 2}) is None
        assert "against the 100-byte budget" in check_vmem(dd, {"route": "wavefront", "m": 2}, budget=100)
        assert check_vmem(dd, {"route": "wrap", "m": 8}, budget=0) is None  # the vpu wrap asks none
        with pytest.raises(ValueError, match="not a stream plan"):
            check_vmem(dd, {"route": "xla"})

    def test_model_equals_the_kernel_tiles(self):
        from stencil_tpu_torch.ops import stream as st

        for name in ("stream_wrap.cu", "stream_plane.cu"):
            src = open(os.path.join(REPO, "stencil_tpu_torch", "csrc", name)).read()
            assert "constexpr int kSR = 32, kSC = 64;" in src
            assert "kMxuSmem = (size_t)(1 + STP_NF) * kTile * sizeof(float);" in src
        assert st.STREAM_PASS_TILE == (32, 64) and st.stream_pass_smem_bytes(8, "vpu") == 0
        assert st.stream_pass_smem_bytes(8, "mxu_band") == 9 * 32 * 64 * 4


# --- status + ledger wiring --------------------------------------------------


class TestStatusAndLedger:
    def test_heartbeat_tenant_table_renders_as_the_jax_status(self, tmp_path, capsys):
        """The port server's heartbeat carries the tenant table; both status
        modules render the same rows line for line."""
        from stencil_tpu.status import _tenant_lines as jtenant_lines
        from stencil_tpu_torch.status import _tenant_lines, main as status_main
        from stencil_tpu_torch.telemetry.flight import FlightRecorder

        srv = make_server(PORT, flight=FlightRecorder(str(tmp_path), label="serve"))
        try:
            srv.add_tenant(serve.TenantSpec(tenant_id="tenant-a"))
            srv.add_tenant(serve.TenantSpec(tenant_id="tenant-b")).quarantine("poisoned request")
            srv.submit(serve.Request(tenant="tenant-a"))
            srv.drain()
        finally:
            srv.close()
        assert status_main([str(tmp_path)]) == 0
        rendered = capsys.readouterr().out
        rows = json.load(open(os.path.join(str(tmp_path), "status.json")))["tenants"]
        want = jtenant_lines(rows)
        assert _tenant_lines(rows) == want and len(want) == 3
        assert "\n".join(want) in rendered and "queue depth" in rendered
        assert "tenant-b: quarantined" in rendered and "[poisoned request]" in rendered
        assert _tenant_lines(None) == ["  tenants: -"]

    def test_status_imports_no_torch(self):
        """``python -m stencil_tpu_torch.status`` imports no torch: no module
        it loads at import time (followed through the package) imports it."""
        seen, todo, bad = set(), ["stencil_tpu_torch.status", "stencil_tpu_torch.serve",
                                  "stencil_tpu_torch.analysis"], []
        while todo:
            mod = todo.pop()
            if mod in seen:
                continue
            seen.add(mod)
            rel = mod.replace(".", os.sep)
            path = os.path.join(REPO, rel + ".py")
            if not os.path.exists(path):
                path = os.path.join(REPO, rel, "__init__.py")
            tree = ast.parse(open(path).read())
            for node in tree.body:  # module level only: function bodies load lazily
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
                for name in names:
                    if name.split(".")[0] in ("torch", "numpy"):
                        bad.append((mod, name))
                    elif name.startswith("stencil_tpu_torch"):
                        todo.append(name)
        assert not bad and "stencil_tpu_torch.telemetry.flight" in seen

    def test_ledger_ingests_only_isolation_verified_serve_soaks(self, tmp_path):
        from stencil_tpu.telemetry.ledger import entries_from_artifact as jentries
        from stencil_tpu_torch.telemetry.ledger import entries_from_artifact

        doc = {"bench": "serve_soak", "isolation_ok": True, "p99_ms": 12.5, "shed_rate": 0.25, "requests": 40,
               "tenants": [{"tenant": "a"}, {"tenant": "b"}]}
        path = str(tmp_path / "serve_summary.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        entries = entries_from_artifact(path)
        assert {e["key"] for e in entries} == {"serve:p99_ms", "serve:shed_rate"}
        assert all(e["better"] == "lower" for e in entries)
        strip = lambda es: sorted((e["key"], e["value"], e.get("better")) for e in es)  # noqa: E731
        assert strip(entries) == strip(jentries(path))
        doc["isolation_ok"] = False
        with open(path, "w") as f:
            json.dump(doc, f)
        assert entries_from_artifact(path) == []


# --- the drivers, in process -------------------------------------------------


def _jax_serve(argv):
    from stencil_tpu.bin import stencil_serve as js

    assert js.main(argv) == 0


def _port_serve(argv):
    from stencil_tpu_torch.bin import stencil_serve as ps

    assert ps.main(argv + ["--device", "cpu", "--kernel-impl", "torch", "--subdomains", str(SUB)]) == 0


@pytest.mark.parametrize("extra", [[], ["--batch", "3"], ["--elastic", "--elastic-high", "2", "--elastic-low", "0"]],
                         ids=["serial", "batched", "elastic"])
def test_stencil_serve_drivers_agree(tmp_path, extra):
    """Both drivers in process at --size 16 --cycles 8: the same digests,
    counts, counters and elasticity decisions (the JAX driver's fleet is the
    8 fake devices, the port's 8 CPU subdomains)."""
    docs = []
    for name, run in (("jax", _jax_serve), ("torch", _port_serve)):
        out = str(tmp_path / name)
        before = serve_counters(JAX if name == "jax" else PORT)
        run(["--size", "16", "--cycles", "8", "--peak", "3", "--out", out] + extra)
        doc = json.load(open(os.path.join(out, "serve_summary.json")))
        doc["moved"] = delta({k: v for k, v in doc["counters"].items() if k.startswith("serve.")}, before)
        docs.append(doc)
    j, p = docs
    for key in ("digests", "requests", "rejected", "completed", "shed", "shed_rate", "isolation_ok", "moved"):
        assert p[key] == j[key], key
    assert p["elasticity"]["decisions"] == j["elasticity"]["decisions"]
    assert [(t["kind"], t["tenant"]) for t in p["elasticity"]["transitions"]] == [
        (t["kind"], t["tenant"]) for t in j["elasticity"]["transitions"]]
    assert [{k: v for k, v in r.items() if not k.endswith("_ms")} for r in p["tenants"]] == [
        {k: v for k, v in r.items() if not k.endswith("_ms")} for r in j["tenants"]]
    assert p["bench"] == "serve_soak" and p["device"] == "cpu" and p["kernel_impl"] == "torch"
    assert set(j) <= set(p)  # the JAX schema, verbatim, plus the port's keys
    if extra and extra[0] == "--batch":
        assert p["moved"]["serve.batch.dispatches"] > 0
    if extra and extra[0] == "--elastic":
        assert p["elasticity"]["decisions"] == ["grow", "shrink"] and p["subdomains"]["start"] == SUB // 2


def test_stencil_serve_needs_a_gpu_or_the_cpu_asked_for(tmp_path):
    from stencil_tpu_torch.bin import run_soak, stencil_serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stencil_serve.main(["--out", str(tmp_path / "s")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_soak.main(["--serve", "--out-dir", str(tmp_path / "k")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_soak.main(["--out-dir", str(tmp_path / "k")])


def test_bench_serve_on_the_cpu(tmp_path):
    """``bin/bench_serve.py`` at 8^3 on 8 CPU slots: every mode's windows
    answer every request, batched and sub-slice dispatch engage, the
    record's summary reads its windows; without a GPU it raises the port's
    error unless ``--device cpu`` is passed."""
    from stencil_tpu_torch.bin import bench_serve

    out = str(tmp_path / "bench_serve.json")
    assert bench_serve.main(["--device", "cpu", "--kernel-impl", "torch", "--size", "8", "--subdomains", str(SUB),
                             "--steps", "1", "--requests", "12", "--reps", "2", "--out", out]) == 0
    doc = json.load(open(out))
    assert [w["mode"] for w in doc["windows"]] == list(bench_serve.MODES) * 2
    by = {w["mode"]: w for w in doc["windows"]}
    assert by["batched"]["batch_dispatches"] > 0 and by["subslice"]["subslice_dispatches"] > 0
    assert by["serial"]["subdomains"] == [SUB] and by["subslice"]["subdomains"] == [2]
    for mode in bench_serve.MODES:
        s = doc["summary"][mode]["served_over_bare"]
        assert s["min"] <= s["median"] <= s["max"] and s["min"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_serve.main(["--size", "8", "--requests", "3", "--reps", "1"])


def test_run_soak_serve_in_process(tmp_path):
    """The serving chaos story, in process, on the CPU: poison and vmem
    isolated bitwise, overload shed without evictions, the batched,
    sub-slice and poisoned-batch legs, one grow and one shrink bitwise."""
    from stencil_tpu_torch.bin import run_soak

    out = str(tmp_path / "soak")
    assert run_soak.main(["--dryrun", "--serve", "--in-process", "--serve-cycles", "12", "--out-dir", out]) == 0
    doc = json.load(open(os.path.join(out, "serve_summary.json")))
    assert doc["isolation_ok"] is True and all(doc["checks"].values()), doc["checks"]
    assert doc["elasticity"]["decisions"] == ["grow", "shrink"] and doc["device"] == "cpu"
    assert doc["overload_shed"] >= 1


def test_run_soak_checks_catch_a_leak():
    """The verdict is not vacuous: a healthy tenant whose digest moved, a
    batched leg that never batched, a poisoned batch without a fallback each
    fail their check."""
    from stencil_tpu_torch.bin.run_soak import serve_checks

    ref = {"digests": {"tenant-a": "1", "tenant-b": "2", "tenant-c": "3"},
           "tenants": [{"tenant": t, "state": "active", "rung": 0} for t in ("tenant-a", "tenant-b", "tenant-c")],
           "counters": {"serve.batch.dispatches": 1, "serve.subslice.dispatches": 1, "serve.batch.fallbacks": 1},
           "shed": 1, "elasticity": {"decisions": ["grow", "shrink"],
                                     "transitions": [{"kind": "grow"}, {"kind": "shrink"}]}}
    quarantined = lambda t: dict(ref, tenants=[dict(r, state="quarantined") if r["tenant"] == t else r  # noqa: E731
                                               for r in ref["tenants"]])
    good = serve_checks(ref, quarantined("tenant-b"), quarantined("tenant-c"), ref, ref, ref,
                        quarantined("tenant-b"), ref, ref)
    assert all(good.values()), good
    leak = dict(quarantined("tenant-b"), digests=dict(ref["digests"], **{"tenant-a": "x"}))
    assert not serve_checks(ref, leak, quarantined("tenant-c"), ref, ref, ref, quarantined("tenant-b"), ref,
                            ref)["poison_isolated"]
    idle = dict(ref, counters={})
    bad = serve_checks(ref, quarantined("tenant-b"), quarantined("tenant-c"), ref, idle, idle, dict(
        quarantined("tenant-b"), counters={}), ref, ref)
    assert not bad["batched_bitwise"] and not bad["subslice_bitwise"] and not bad["batched_poison_isolated"]


@pytest.mark.slow
def test_run_soak_dryrun_subprocesses(tmp_path):
    """The three stories as a user runs them: driver processes on the CPU."""
    for extra in ([], ["--reshard"], ["--serve", "--serve-cycles", "12"]):
        out = str(tmp_path / ("_".join(extra) or "kill"))
        proc = subprocess.run([sys.executable, "-m", "stencil_tpu_torch.bin.run_soak", "--dryrun", "--out-dir", out,
                               *extra], cwd=REPO, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        name = "serve_summary.json" if "--serve" in extra else "soak_summary.json"
        doc = json.load(open(os.path.join(out, name)))
        assert doc.get("isolation_ok", doc.get("bitwise_identical")) is True


def test_make_grid_defaults_to_the_card():
    """A bare make_grid takes the port's default device: on a CPU-only
    torch it raises the port's no-GPU error; the CPU is asked for."""
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.parallel.mesh import make_grid

    if torch.cuda.is_available():
        assert make_grid((8, 8, 8), Radius.constant(1)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        make_grid((8, 8, 8), Radius.constant(1))
    assert make_grid((8, 8, 8), Radius.constant(1), device="cpu").device == torch.device("cpu")
