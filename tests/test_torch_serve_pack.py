"""The port's throughput packing (``stencil_tpu_torch/serve/pack.py``, the
scheduler in ``serve/server.py``) against the JAX package's.

* The planners: ``plan_batches``, ``plan_subslice_candidates`` and
  ``plan_subslices`` on fakes of both packages (8 slots against 8 fake
  devices) pick the same groups, the same orders and the same slices.
* Packed dispatch against a serial twin, bitwise, across the hard mixes of
  ``tests/test_serve_pack.py``: uneven subdomains (17^3 over 8), bf16
  fields, fused multi-quantity domains, a mixed queue where only a subset
  batches, a fault injected against one member of a batch, disjoint
  sub-slices; Jacobi on the torch engine, on the cuda engine's wavefront
  (plain versions here), captured; the stream engine's wavefront.  The same load through the JAX server gives the
  same responses, counters and fields (bitwise for Jacobi and the
  reciprocal-multiply kernels; bf16 within one bf16 rounding).
* The batched call never writes a tenant's live stacks: a member that
  fails leaves every tenant as it was; it holds no step past the call, and
  its steps run outside ``run_step`` (as in the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu import serve as jserve
from stencil_tpu import telemetry as jtelemetry
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.resilience import inject as jinject
from stencil_tpu.resilience.taxonomy import OverloadError as JOverloadError
from stencil_tpu_torch import serve, telemetry
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.parallel.topology import Slot, slots_on
from stencil_tpu_torch.resilience import inject
from stencil_tpu_torch.resilience.taxonomy import OverloadError
from stencil_tpu_torch.serve import pack
from stencil_tpu_torch.telemetry import names as tm

torch.set_num_threads(1)

SUB = 8


@pytest.fixture(autouse=True)
def _clear_fault_plans():
    yield
    inject.set_plan(None)
    jinject.set_plan(None)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_server(srv_mod, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("aot", srv_mod.AOTCache(stamp_dir=None, clock=kw["clock"]))
    return srv_mod.StencilServer(**kw)


def _counter(tel, name: str) -> int:
    return tel.snapshot()["counters"][name]


# --- planner units (no dispatches: fake models of both packages) -------------


class _Dim3:
    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z


class _FakeKey:
    def __init__(self, digest):
        self._d = digest

    def digest(self):
        return self._d


class _FakeDD:
    """The port's fake domain: what the planners read of a realized one."""

    def __init__(self, digest="g", n=2, nbytes=1024, size=(8, 8, 8)):
        self._realized = True
        self._curr = {"q": torch.zeros(nbytes // 4, dtype=torch.float32)}
        self.device = torch.device("cpu")
        self._n = n
        self._digest = digest
        self._size = _Dim3(*size)
        self._handles = ["q"]

    def num_subdomains(self):
        return self._n

    def tune_key(self, route):
        return _FakeKey(self._digest)

    def exchange_route(self):
        return "direct"

    def size(self):
        return self._size

    def field_dtype(self, h):
        return torch.float32


class _JFakeDev:
    def __init__(self, id):
        self.id = id


class _JFakeDD:
    """The JAX package's fake (tests/test_serve_pack.py)."""

    def __init__(self, digest="g", n=2, nbytes=1024, size=(8, 8, 8)):
        self._realized = True
        self._curr = {"q": np.zeros(nbytes // 4, np.float32)}
        self.mesh = type("M", (), {"devices": np.array([_JFakeDev(i) for i in range(n)], dtype=object)})()
        self._digest = digest
        self._size = _Dim3(*size)
        self._handles = ["q"]

    def tune_key(self, route):
        return _FakeKey(self._digest)

    def exchange_route(self):
        return "direct"

    def size(self):
        return self._size

    def field_dtype(self, h):
        return "float32"


class _FakeModel:
    def __init__(self, dd):
        self.dd = dd
        self._step = object()

    def rebuild_after_reshard(self):
        pass


class _FakeTenant:
    def __init__(self, model):
        self.model = model

    def active(self):
        return True


def _tenants(specs):
    """``{tid: kwargs}`` -> (port tenants, JAX tenants) of equal fakes."""
    return ({t: _FakeTenant(_FakeModel(_FakeDD(**kw))) for t, kw in specs.items()},
            {t: _FakeTenant(_FakeModel(_JFakeDD(**kw))) for t, kw in specs.items()})


def _plan_both(specs, pending_ids, rotation, batch_max, steps=None):
    port, jax_t = _tenants(specs)
    steps = steps or [1] * len(pending_ids)
    got = []
    for mod, tenants in ((serve, port), (jserve, jax_t)):
        pending = [mod.Request(tenant=t, steps=s) for t, s in zip(pending_ids, steps)]
        group = mod.pack.plan_batches(pending, tenants, rotation, batch_max)
        got.append(None if group is None else [(r.tenant, pending.index(r)) for r in group])
    assert got[0] == got[1]
    return got[0]


class TestBatchPlanner:
    def test_groups_matching_geometry_oldest_per_tenant(self):
        got = _plan_both({t: {} for t in "abc"}, ["a", "a", "b", "c"], ["a", "b", "c"], 8)
        assert got == [("a", 0), ("b", 2), ("c", 3)]

    def test_rotation_orders_the_group(self):
        assert [t for t, _ in _plan_both({t: {} for t in "abc"}, list("abc"), ["c", "a", "b"], 8)] == list("cab")

    def test_batch_max_caps_the_group(self):
        assert [t for t, _ in _plan_both({t: {} for t in "abcd"}, list("abcd"), list("abcd"), 2)] == ["a", "b"]

    def test_only_the_matching_subset_groups(self):
        port, jax_t = _tenants({"a": {"digest": "g1"}, "b": {"digest": "OTHER"}, "c": {"digest": "g1"},
                                "d": {"digest": "g1"}})
        port["d"].model.dd._realized = jax_t["d"].model.dd._realized = False
        got = []
        for mod, tenants in ((serve, port), (jserve, jax_t)):
            group = mod.pack.plan_batches([mod.Request(tenant=t) for t in "abcd"], tenants, list("abcd"), 8)
            got.append([r.tenant for r in group])
        assert got[0] == got[1] == ["a", "c"]

    def test_mismatched_steps_do_not_group(self):
        assert _plan_both({t: {} for t in "ab"}, ["a", "b"], ["a", "b"], 8, steps=[1, 2]) is None

    def test_other_slots_do_not_group(self):
        """The port's key reads the subdomain count and the slots in place of
        the JAX mesh's devices: tenants on other grids or slices never share
        a batched call."""
        assert _plan_both({"a": {"n": 2}, "b": {"n": 4}}, ["a", "b"], ["a", "b"], 8) is None
        port, _ = _tenants({"a": {}, "b": {}})
        port["b"].model._serve_slice = (2, 3)
        assert pack.plan_batches([serve.Request(tenant=t) for t in "ab"], port, ["a", "b"], 8) is None
        assert pack.tenant_slots(port["a"].model) == (0, 1) and pack.tenant_slots(port["b"].model) == (2, 3)

    def test_disabled_or_singleton_returns_none(self):
        assert _plan_both({"a": {}}, ["a"], ["a"], 8) is None
        assert _plan_both({t: {} for t in "ab"}, ["a", "b"], ["a", "b"], 1) is None


class TestSubslicePlanner:
    def test_greedy_big_tenant_takes_the_fast_slice(self):
        got = []
        for mod, fleet, dd in ((serve, slots_on("cpu", 4), _FakeDD), (jserve, [_JFakeDev(i) for i in range(4)],
                                                                     _JFakeDD)):
            big, small = _FakeModel(dd(digest="A", nbytes=1 << 20)), _FakeModel(dd(digest="B", nbytes=1 << 10))

            def link(devices):
                return {"axes": {"x": {"low": {"gbps_min": 100.0 if devices[0].id == 0 else 1.0}}}}

            out = mod.pack.plan_subslices([(mod.Request(tenant="small"), small), (mod.Request(tenant="big"), big)],
                                          fleet, link)
            got.append({r.tenant: [d.id for d in devs] for r, _m, devs in out})
        assert got[0] == got[1] == {"big": [0, 1], "small": [2, 3]}

    def test_slices_are_disjoint_and_cover_distinct_slots(self):
        got = []
        for mod, fleet, dd in ((serve, slots_on("cpu", 8), _FakeDD), (jserve, [_JFakeDev(i) for i in range(8)],
                                                                     _JFakeDD)):
            models = [_FakeModel(dd(digest=str(i), nbytes=(i + 1) * 4096)) for i in range(3)]
            out = mod.pack.plan_subslices([(mod.Request(tenant=str(i)), m) for i, m in enumerate(models)], fleet)
            got.append(sorted((r.tenant, tuple(d.id for d in devs)) for r, _m, devs in out))
        assert got[0] == got[1]
        sets = [frozenset(ids) for _, ids in got[0]]
        assert all(len(s) == 2 for s in sets) and len(frozenset.union(*sets)) == 6

    def test_single_tenant_or_empty_fleet_returns_none(self):
        m = _FakeModel(_FakeDD())
        assert pack.plan_subslices([(serve.Request(tenant="a"), m)], slots_on("cpu", 1)) is None
        assert pack.plan_subslices([(serve.Request(tenant="a"), m), (serve.Request(tenant="b"), m)],
                                   slots_on("cpu", 1)) is None

    def test_candidates_need_movable_distinct_tenants(self):
        port, jax_t = _tenants({t: {} for t in "abc"})
        port["c"].model.rebuild_after_reshard = jax_t["c"].model.rebuild_after_reshard = None
        del port["c"].model.rebuild_after_reshard, jax_t["c"].model.rebuild_after_reshard
        type_ = type("NoMove", (), {"dd": None})
        got = []
        for mod, tenants in ((serve, port), (jserve, jax_t)):
            tenants["c"].model = type_()
            tenants["c"].model.dd = port["a"].model.dd if mod is serve else jax_t["a"].model.dd
            picks = mod.pack.plan_subslice_candidates([mod.Request(tenant=t) for t in "aabc"], tenants,
                                                      list("abc"))
            got.append([r.tenant for r in picks])
        assert got[0] == got[1] == ["a", "b"]

    def test_slice_cost_reads_torch_itemsizes(self):
        m = _FakeModel(_FakeDD(size=(8, 16, 32)))
        doc = {"axes": {"x": {"low": {"gbps_min": 2.0}, "high": {"gbps_med": 4.0}}, "z": {"low": {"gbps_min": 0}}}}
        assert pack._slice_cost(m, slots_on("cpu", 2), doc) == 2.0 * 16 * 32 * 4 / 2e9
        assert pack._slice_cost(m, slots_on("cpu", 2), None) == 0.0
        assert pack.footprint_bytes(m) == 1024 and pack.SERVE_MODES == jserve.pack.SERVE_MODES


# --- the bitwise contract: packed vs a serial twin ---------------------------


def _mean6(views, info):
    src = views["q"]
    return {"q": (src.sh(1, 0, 0) + src.sh(-1, 0, 0) + src.sh(0, 1, 0) + src.sh(0, -1, 0) + src.sh(0, 0, 1)
                  + src.sh(0, 0, -1)) * (1.0 / 6.0)}


def _coupled(views, info):
    """Fused multi-quantity update: each field's next value reads BOTH."""
    q, r = views["q"], views["r"]
    return {"q": (q.sh(1, 0, 0) + q.sh(-1, 0, 0) + r.center()) * (1.0 / 3.0),
            "r": (r.sh(0, 0, 1) + r.sh(0, 0, -1) + q.center()) * (1.0 / 3.0)}


def _data(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


class _DomainModel:
    """A serving model around a raw DistributedDomain and its built step (the
    JAX test's rig): uneven subdomains, bf16 fields, fused multi-quantity."""

    def __init__(self, shape, kernel, quantities=("q",), dtype=torch.float32, seed=7, subdomains=SUB, mult=1,
                 **step_kw):
        self.dd = DistributedDomain(*shape, device="cpu")
        self.dd.set_radius(Radius.constant(1))
        self.dd.set_subdomains(subdomains)
        if mult > 1:
            self.dd.set_halo_multiplier(mult)
        self.handles = [self.dd.add_data(n, dtype=dtype) for n in quantities]
        self.dd.realize()
        for i, h in enumerate(self.handles):
            self.dd.set_quantity(h, _data(shape, seed + i))
        self._kernel, self._kw = kernel, step_kw
        self._step = self.dd.make_step(kernel, **step_kw)

    def step(self, n):
        self.dd.run_step(self._step, n)

    def rebuild_after_reshard(self):
        self._step = self.dd.make_step(self._kernel, **self._kw)

    def fields(self):
        """The valid interiors at float32 (a bf16 field upcast exactly; numpy
        has no bfloat16, so ``quantity_to_host`` cannot return one)."""
        dd, (X, Y, Z) = self.dd, self.dd.size().tuple()
        return {h.name: dd._to_global(dd._interior_view(dd._curr[h.name]))[..., :X, :Y, :Z].float().numpy()
                for h in self.handles}


class _JDomainModel:
    def __init__(self, shape, kernel, quantities=("q",), dtype=jnp.float32, seed=7):
        self.dd = JDomain(*shape)
        self.dd.set_radius(JRadius.constant(1))
        self.handles = [self.dd.add_data(n, dtype=dtype) for n in quantities]
        self.dd.set_devices(jax.devices()[:SUB])
        self.dd.realize()
        for i, h in enumerate(self.handles):
            self.dd.set_quantity(h, _data(shape, seed + i))
        self._kernel = kernel
        self._step = self.dd.make_step(kernel, donate=False)

    def step(self, n):
        self.dd.run_step(self._step, n)

    def rebuild_after_reshard(self):
        self._step = self.dd.make_step(self._kernel, donate=False)

    def fields(self):
        return {h.name: np.asarray(self.dd.quantity_to_host(h), dtype=np.float32) for h in self.handles}


def _rounds(mod, oerr, srv, order, rounds, steps=1):
    out = []
    for _ in range(rounds):
        for tid in order:
            try:
                srv.submit(mod.Request(tenant=tid, steps=steps))
            except (oerr, mod.AdmissionRefused):
                pass
        out.extend(srv.drain())
    return out


def _serve(mod, oerr, models, rounds=3, steps=1, priority=None, plan=None, **kw):
    """Serve ``rounds`` rounds to ``models``; (responses, table w/o latencies)."""
    order = sorted(models)
    srv = make_server(mod, queue_max=32, **kw)
    inj = inject if mod is serve else jinject
    try:
        for tid in order:
            srv.add_tenant(mod.TenantSpec(tenant_id=tid, priority=(priority or {}).get(tid, 0)), models[tid])
        inj.set_plan(plan)
        out = _rounds(mod, oerr, srv, order, rounds, steps)
    finally:
        srv.close()
        inj.set_plan(None)
    return ([(r.request.tenant, r.ok, r.failure_class, r.steps_done) for r in out],
            [{k: v for k, v in row.items() if not k.endswith("_ms")} for row in srv.tenant_table()])


def _assert_equal(a, b, rtol=0.0):
    fa, fb = a.fields(), b.fields()
    assert fa.keys() == fb.keys()
    for name in fa:
        if rtol:
            np.testing.assert_allclose(fa[name], fb[name], rtol=rtol, atol=rtol)
        else:
            np.testing.assert_array_equal(fa[name], fb[name])


def _packed_vs_serial(factory, jfactory, ids, rounds=2, steps=1, rtol=0.0, counter=tm.SERVE_BATCH_DISPATCHES,
                      plan=None, priority=None, **packed_kw):
    """The same load through a packed port server, a serial port twin and a
    packed JAX server: packed == serial bitwise; packed == JAX (bitwise, or
    within ``rtol``); the responses and tables of both packed servers equal."""
    packed = {t: factory(i) for i, t in enumerate(ids)}
    serial = {t: factory(i) for i, t in enumerate(ids)}
    jpacked = {t: jfactory(i) for i, t in enumerate(ids)}
    before, jbefore = _counter(telemetry, counter), _counter(jtelemetry, counter)
    got = _serve(serve, OverloadError, packed, rounds, steps, priority, plan, **packed_kw)
    jkw = dict(packed_kw)
    if "fleet" in jkw:
        jkw["fleet"] = jax.devices()[:SUB]
    jgot = _serve(jserve, JOverloadError, jpacked, rounds, steps, priority, plan, **jkw)
    moved, jmoved = _counter(telemetry, counter) - before, _counter(jtelemetry, counter) - jbefore
    _serve(serve, OverloadError, serial, rounds, steps, priority, None if plan is None else plan)
    assert moved > 0 and moved == jmoved, (moved, jmoved)
    assert got == jgot
    for tid in ids:
        if plan is None or tid not in plan:
            _assert_equal(packed[tid], serial[tid])
        _assert_equal(packed[tid], jpacked[tid], rtol)
    return packed, serial, got


class TestBatchedBitwise:
    def test_uneven_subdomains_batched_equals_serial(self):
        """17^3 over 8 subdomains: every subdomain boundary lands uneven."""
        _packed_vs_serial(lambda i: _DomainModel((17, 17, 17), _mean6, seed=7 + i),
                          lambda i: _JDomainModel((17, 17, 17), _mean6, seed=7 + i),
                          ("tenant-a", "tenant-b", "tenant-c"), batch_max=8)

    def test_bf16_fields_batched_equals_serial(self):
        """bf16 fields: packed == serial bitwise; against the JAX package
        within one bf16 rounding a level (the two engines round bf16
        arithmetic at different points)."""
        _packed_vs_serial(lambda i: _DomainModel((8, 8, 8), _mean6, dtype=torch.bfloat16, seed=3 + i),
                          lambda i: _JDomainModel((8, 8, 8), _mean6, dtype=jnp.bfloat16, seed=3 + i),
                          ("tenant-a", "tenant-b"), rtol=2 * 2.0**-7, batch_max=8)

    def test_fused_multi_quantity_batched_equals_serial(self):
        _packed_vs_serial(lambda i: _DomainModel((8, 8, 8), _coupled, quantities=("q", "r"), seed=11 + i),
                          lambda i: _JDomainModel((8, 8, 8), _coupled, quantities=("q", "r"), seed=11 + i),
                          ("tenant-a", "tenant-b", "tenant-c"), steps=2, batch_max=8)

    def test_mixed_queue_batches_only_the_matching_subset(self):
        shape = lambda i: (8, 8, 8) if i < 2 else (10, 10, 10)  # noqa: E731
        _packed_vs_serial(lambda i: _DomainModel(shape(i), _mean6, seed=5 + i),
                          lambda i: _JDomainModel(shape(i), _mean6, seed=5 + i),
                          ("tenant-a", "tenant-b", "tenant-c"), priority={"tenant-c": 1}, batch_max=8)


class TestFaultInBatch:
    def test_poison_against_one_member_falls_back_serial_bitwise(self):
        """A poison_request against one tenant of a batch: the group falls
        back to serial re-execution, the poisoned tenant is evicted through
        its unchanged envelope, every healthy member bitwise equal to the
        fault-free serial twin; the JAX server answers the same."""
        ids = ("tenant-a", "tenant-b", "tenant-c")
        fb, jfb = _counter(telemetry, tm.SERVE_BATCH_FALLBACKS), _counter(jtelemetry, tm.SERVE_BATCH_FALLBACKS)
        packed, serial, (resp, rows) = _packed_vs_serial(
            lambda i: _DomainModel((8, 8, 8), _mean6, seed=7 + i), lambda i: _JDomainModel((8, 8, 8), _mean6,
                                                                                         seed=7 + i),
            ids, rounds=3, plan="execute:poison_request:serve:tenant-b@1", batch_max=8)
        assert _counter(telemetry, tm.SERVE_BATCH_FALLBACKS) - fb == _counter(jtelemetry,
                                                                               tm.SERVE_BATCH_FALLBACKS) - jfb > 0
        assert {r["tenant"]: r["state"] for r in rows} == {"tenant-a": "active", "tenant-b": "quarantined",
                                                           "tenant-c": "active"}
        fault_free = {t: _DomainModel((8, 8, 8), _mean6, seed=7 + i) for i, t in enumerate(ids)}
        _serve(serve, OverloadError, fault_free, rounds=3)
        for tid in ("tenant-a", "tenant-c"):
            _assert_equal(packed[tid], fault_free[tid])

    def test_failing_batched_call_leaves_every_tenant_as_it_was(self):
        """The batched call steps copies: a member that fails mid-call
        leaves every tenant's live stacks (identity and values) untouched."""
        models = [_DomainModel((8, 8, 8), _mean6, seed=i) for i in range(3)]
        live = [{n: (t, t.clone()) for n, t in m.dd._curr.items()} for m in models]
        real, calls = models[0]._step, [0]

        def flaky(curr, steps, capture=False):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("a member failed")
            return real(curr, steps)

        models[0]._step = flaky
        with pytest.raises(RuntimeError, match="a member failed"):
            pack.BatchExecutor().run(models, 2)
        for m, before in zip(models, live):
            for n, (t, copy) in before.items():
                assert m.dd._curr[n] is t and torch.equal(t, copy)


class TestSubsliceBitwise:
    def test_subslice_pack_is_disjoint_and_bitwise(self):
        """Two non-matching tenants bin-packed onto disjoint halves of the
        8-slot fleet (each resharded to 4 subdomains): disjoint slots, fields
        bitwise equal to serial twins that never left the full fleet, and to
        the JAX server's packed run."""
        shape = lambda i: (8, 8, 8) if i == 0 else (10, 10, 10)  # noqa: E731
        packed, serial, _ = _packed_vs_serial(
            lambda i: _DomainModel(shape(i), _mean6, seed=21 + i), lambda i: _JDomainModel(shape(i), _mean6,
                                                                                        seed=21 + i),
            ("tenant-a", "tenant-b"), counter=tm.SERVE_SUBSLICE_DISPATCHES, subslice=True,
            fleet=slots_on("cpu", SUB))
        placed = [set(pack.tenant_slots(packed[t])) for t in sorted(packed)]
        assert placed[0] & placed[1] == set() and all(len(s) == 4 for s in placed)
        assert all(packed[t].dd.num_subdomains() == 4 for t in packed)

    def test_same_width_slice_moves_no_data(self):
        """A slice of the tenant's own width on other slots is a relabel: no
        reshard, the stacks untouched."""
        m = _DomainModel((8, 8, 8), _mean6, subdomains=2)
        stacks = dict(m.dd._curr)
        moved = pack.place_subslices([(serve.Request(tenant="a"), m, (Slot(4, m.dd.device), Slot(5, m.dd.device)))])
        assert moved == 1 and pack.tenant_slots(m) == (4, 5) and m.dd._curr == stacks
        assert pack.place_subslices([(serve.Request(tenant="a"), m, (Slot(4, m.dd.device),
                                                                     Slot(5, m.dd.device)))]) == 0


# --- Jacobi end-to-end (the soak's in-process twin) --------------------------


def _jacobi(i, **kw):
    m = Jacobi3D(16, 16, 16, subdomains=SUB, device="cpu", **kw)
    m.realize()
    return m


def _jjacobi(i):
    m = JJacobi3D(16, 16, 16, devices=jax.devices()[:SUB])
    m.realize()
    return m


class _JacobiFields:
    """``fields()`` over a Jacobi model (for ``_assert_equal``)."""

    def __init__(self, m):
        self.m = m

    def fields(self):
        return {"temp": np.asarray(self.m.temperature())}


class TestJacobiPacked:
    @pytest.mark.parametrize("kw", [{"kernel_impl": "torch"}, {"kernel_impl": "torch", "capture": True},
                                    {"kernel_impl": "cuda"}, {"kernel_impl": "cuda", "capture": True}],
                             ids=["torch", "torch-captured", "cuda-wavefront", "cuda-captured"])
    def test_jacobi_batched_equals_serial_and_jax(self, kw):
        """Jacobi tenants: the torch engine, and the cuda engine's wavefront
        route (its kernels' plain versions here), uncaptured and captured:
        batched == serial bitwise, and == the JAX jnp server bitwise."""
        ids = ("tenant-a", "tenant-b", "tenant-c")
        packed = {t: _jacobi(i, **kw) for i, t in enumerate(ids)}
        serial = {t: _jacobi(i, **kw) for i, t in enumerate(ids)}
        jpacked = {t: _jjacobi(i) for i, t in enumerate(ids)}
        if kw["kernel_impl"] == "cuda":
            assert packed["tenant-a"]._pallas_path == "wavefront"
        steps = packed["tenant-a"]._wavefront_m or 1
        before = _counter(telemetry, tm.SERVE_BATCH_DISPATCHES)
        got = _serve(serve, OverloadError, packed, rounds=3, steps=steps, batch_max=8)
        assert _counter(telemetry, tm.SERVE_BATCH_DISPATCHES) > before
        assert got == _serve(jserve, JOverloadError, jpacked, rounds=3, steps=steps, batch_max=8)
        _serve(serve, OverloadError, serial, rounds=3, steps=steps)
        for tid in ids:
            np.testing.assert_array_equal(packed[tid].temperature(), serial[tid].temperature())
            if kw["kernel_impl"] == "torch":
                np.testing.assert_array_equal(packed[tid].temperature(), jpacked[tid].temperature())
            else:  # the kernels' neighbour order: within 1e-6 of the jnp route (ROADMAP.md)
                np.testing.assert_allclose(packed[tid].temperature(), jpacked[tid].temperature(), rtol=1e-6)

    def test_stream_wavefront_batched_equals_serial(self):
        """A stream-engine step (a ladder-backed step: its built rung is
        batched): the wavefront route's plain passes over the copies
        equal serial dispatch."""
        ids = ("tenant-a", "tenant-b")
        mk = lambda i: _DomainModel((16, 16, 16), _mean6, seed=31 + i, mult=2, engine="stream",  # noqa: E731
                                    stream_path="wavefront")
        packed = {t: mk(i) for i, t in enumerate(ids)}
        serial = {t: mk(i) for i, t in enumerate(ids)}
        assert packed["tenant-a"]._step._resilience is not None
        assert packed["tenant-a"]._step._stream_plan["route"] == "wavefront"
        before = _counter(telemetry, tm.SERVE_BATCH_DISPATCHES)
        _serve(serve, OverloadError, packed, rounds=2, steps=2, batch_max=8)
        assert _counter(telemetry, tm.SERVE_BATCH_DISPATCHES) > before
        _serve(serve, OverloadError, serial, rounds=2, steps=2)
        for tid in ids:
            _assert_equal(packed[tid], serial[tid])


class TestBatchedDispatch:
    def test_batched_call_runs_each_member_once(self):
        models = [_DomainModel((8, 8, 8), _mean6, seed=i) for i in range(3)]
        want = []
        for i in range(3):
            twin = _DomainModel((8, 8, 8), _mean6, seed=i)
            twin.step(2)
            want.append(twin.fields()["q"])
        live = [m.dd._curr["q"] for m in models]
        pack.BatchExecutor().run(models, 2)
        for i, m in enumerate(models):
            assert m.dd._curr["q"] is not live[i]
            np.testing.assert_array_equal(m.fields()["q"], want[i])

    @pytest.mark.parametrize("kw", [{"kernel_impl": "cuda"}, {"kernel_impl": "torch"}], ids=["cuda", "torch"])
    def test_members_own_their_results(self, kw):
        """After a batched call no two tenants' stacks share storage, so
        one tenant's later writes never bump another's version counter
        (views of one stacked base would: a resumable step, the z-ring
        wavefront, then re-primes at every call)."""
        models = [_jacobi(i, **kw) for i in range(3)]
        steps = models[0]._wavefront_m or 1
        pack.BatchExecutor().run(models, steps)
        for name in models[0].dd._curr:
            stacks = [m.dd._curr[name] for m in models]
            assert len({t.untyped_storage().data_ptr() for t in stacks}) == len(models)
            before = [t._version for t in stacks]
            stacks[0].add_(0)
            assert [t._version for t in stacks[1:]] == before[1:]

    def test_replaced_steps_are_freed_across_a_reshard(self):
        """Batch, reshard every tenant (8 -> 4 subdomains, the step
        rebuilt), batch again: the steps the reshard replaced are freed (the
        executor holds none), and the fields equal a serial twin's that made
        the same moves."""
        import gc
        import weakref

        ids = ("tenant-a", "tenant-b")
        kw = {"kernel_impl": "cuda"}
        packed = {t: _jacobi(i, **kw) for i, t in enumerate(ids)}
        serial = {t: _jacobi(i, **kw) for i, t in enumerate(ids)}
        steps = packed["tenant-a"]._wavefront_m or 1
        before = _counter(telemetry, tm.SERVE_BATCH_DISPATCHES)
        _serve(serve, OverloadError, packed, rounds=1, steps=steps, batch_max=8)
        _serve(serve, OverloadError, serial, rounds=1, steps=steps)
        old = [weakref.ref(m._step) for m in packed.values()]
        for m in (*packed.values(), *serial.values()):
            m.dd.reshard(subdomains=4)
            m.rebuild_after_reshard()
        gc.collect()
        assert [r() for r in old] == [None, None]
        steps = packed["tenant-a"]._wavefront_m or 1
        _serve(serve, OverloadError, packed, rounds=1, steps=steps, batch_max=8)
        _serve(serve, OverloadError, serial, rounds=1, steps=steps)
        assert _counter(telemetry, tm.SERVE_BATCH_DISPATCHES) == before + 2
        for tid in ids:
            np.testing.assert_array_equal(packed[tid].temperature(), serial[tid].temperature())

    def test_batched_steps_bypass_run_step(self):
        """Pinned (ROADMAP.md, deliberate differences): as in the JAX
        package a batched member's step runs outside ``run_step``, so the
        domain's step tally does not count it; a serial dispatch does."""
        models = [_DomainModel((8, 8, 8), _mean6, seed=i) for i in range(2)]
        tallies = [list(m.dd._tally) for m in models]
        pack.BatchExecutor().run(models, 2)
        assert [list(m.dd._tally) for m in models] == tallies
        models[0].step(2)
        assert models[0].dd._tally[0] == tallies[0][0] + 1


# --- drain truncation --------------------------------------------------------


class _HungModel:
    def step(self, n):
        pass


class TestDrainTruncation:
    def test_drain_truncation_warns_and_counts(self, capsys):
        srv = make_server(serve, queue_max=32)
        before = _counter(telemetry, tm.SERVE_DRAIN_TRUNCATED)
        try:
            srv.add_tenant(serve.TenantSpec(tenant_id="a"), _HungModel())
            for _ in range(5):
                srv.submit(serve.Request(tenant="a"))
            srv.drain(max_cycles=2)
        finally:
            srv.close()
        assert _counter(telemetry, tm.SERVE_DRAIN_TRUNCATED) == before + 1
        err = capsys.readouterr().err
        assert "max_cycles=2" in err and "3 request(s) still queued" in err

    def test_full_drain_stays_quiet(self, capsys):
        srv = make_server(serve, queue_max=8)
        before = _counter(telemetry, tm.SERVE_DRAIN_TRUNCATED)
        try:
            srv.add_tenant(serve.TenantSpec(tenant_id="a"), _HungModel())
            srv.submit(serve.Request(tenant="a"))
            srv.drain()
        finally:
            srv.close()
        assert _counter(telemetry, tm.SERVE_DRAIN_TRUNCATED) == before
        assert "drain truncated" not in capsys.readouterr().err


class TestOccupancy:
    def test_occupancy_counts_slots(self):
        """A full-fleet dispatch occupies every slot; a sub-slice pack sums
        its slices; the fleet defaults to the union of the tenants' slots."""
        models = {t: _DomainModel((8, 8, 8), _mean6, seed=i, subdomains=4) for i, t in enumerate("ab")}
        srv = make_server(serve, queue_max=8)
        try:
            for t, m in models.items():
                srv.add_tenant(serve.TenantSpec(tenant_id=t), m)
            assert [s.id for s in srv._fleet_devices()] == [0, 1, 2, 3]
            assert srv._model_devices(models["a"]) == 4 and srv._model_devices(_HungModel()) == 0
            srv.submit(serve.Request(tenant="a"))
            srv.drain()
            assert telemetry.snapshot()["gauges"][tm.SERVE_OCCUPANCY] == 1.0
        finally:
            srv.close()


# --- ledger wiring -------------------------------------------------------------


def test_ledger_ingests_serve_throughput_higher_is_better(tmp_path):
    import json

    from stencil_tpu.telemetry.ledger import entries_from_artifact as jentries
    from stencil_tpu_torch.telemetry.ledger import entries_from_artifact

    doc = {"bench": "serve_soak", "isolation_ok": True, "p99_ms": 12.5, "shed_rate": 0.0, "requests": 40,
           "tenants": [{"tenant": "a"}], "throughput": {"requests_per_s": 9.5, "mcells_per_s": 1.25,
                                                        "batch_max": 8, "subslice": False}}
    path = str(tmp_path / "serve_summary.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    entries = {e["key"]: e for e in entries_from_artifact(path)}
    tp = entries["serve:throughput"]
    assert tp["value"] == 9.5 and tp["unit"] == "1/s" and "better" not in tp
    assert tp["mcells_per_s"] == 1.25 and tp["batch_max"] == 8
    assert entries["serve:p99_ms"]["better"] == "lower"
    jtp = {e["key"]: e for e in jentries(path)}["serve:throughput"]
    assert {k: v for k, v in tp.items() if k not in ("ts", "source")} == {
        k: v for k, v in jtp.items() if k not in ("ts", "source")}
