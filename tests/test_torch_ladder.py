"""The port's degradation ladders (``stencil_tpu_torch/resilience/ladder.py``)
against the JAX package's.

* the ladder itself: classified descent on VMEM_OOM and COMPILE_REJECT, an
  exhausted ladder re-raising, FATAL and TRANSIENT never descending, the
  static prefilter, and the port's re-invocation guard (a failure after a
  step that writes in place was entered propagates);
* ``Jacobi3D``: the same ``STENCIL_FAULT_PLAN`` drives the JAX model (Pallas
  in interpret mode) and the port's (CPU, the kernels' plain versions)
  through the same descents, rung names letter for letter, and the same
  interiors (bitwise: the ladder parity runs compare routes the Jacobi
  parity tests hold bitwise);
* ``make_stream_step``: the same plans walk the same rungs as the JAX
  stream engine, interiors within the stream parity tolerance;
* the exchange route: a refused packed build descends to ``direct``.

Every case runs in-process at <= 32^3.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.resilience import inject as jinject
from stencil_tpu_torch import telemetry
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.resilience import inject
from stencil_tpu_torch.resilience.ladder import DegradationLadder, Rung
from stencil_tpu_torch.resilience.taxonomy import FailureClass
from stencil_tpu_torch.telemetry import names as tm

torch.set_num_threads(1)

#: the stream parity tolerance (tests/test_torch_stream.py)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("STENCIL_FAULT_PLAN", raising=False)
    inject.set_plan(None)
    jinject.set_plan(None)
    telemetry.reset()
    yield
    inject.set_plan(None)
    jinject.set_plan(None)


def _names(ladder):
    return [(name, cls.value) for name, cls in ladder.descents]


# --- the ladder itself ------------------------------------------------------------


def _toy(fail_messages, writes_in_place=False, prefilter=None):
    names = ["a", "b", "c"]
    log = {"built": [], "ran": []}

    def mk(i):
        def build():
            log["built"].append(names[i])

            def impl(x):
                if i < len(fail_messages):
                    raise RuntimeError(fail_messages[i])
                log["ran"].append(names[i])
                return x * 2

            impl._writes_in_place = writes_in_place
            return impl

        return Rung(name=names[i], build=build)

    def lower(rung, cls, exc):
        i = names.index(rung.name)
        return mk(i + 1) if i + 1 < len(names) else None

    return DegradationLadder(mk(0), lower=lower, label="toy", prefilter=prefilter), log


def test_descends_on_vmem_oom_and_compile_reject():
    telemetry.enable()
    try:
        ladder, log = _toy(["Ran out of memory in memory space vmem (exceeded)",
                            "too many resources requested for launch"])
        assert ladder.step(21) == 42
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    assert log["built"] == ["a", "b", "c"] and log["ran"] == ["c"]
    assert _names(ladder) == [("a", "vmem_oom"), ("b", "vmem_oom")]
    assert snap["counters"][tm.LADDER_DESCENTS] == 2
    assert snap["histograms"][tm.LADDER_BUILD_SECONDS]["count"] == 3
    events = [e for e in telemetry.recent_events() if e["event"] == tm.EVENT_DESCENT]
    assert [(e["from_rung"], e["to_rung"]) for e in events] == [("a", "b"), ("b", "c")]
    assert sum(e["event"] == tm.EVENT_COMPILE for e in telemetry.recent_events()) == 3


def test_exhausted_ladder_reraises():
    ladder, _ = _toy(["vmem exceeded"] * 3)
    with pytest.raises(RuntimeError, match="vmem"):
        ladder.step(1)


def test_fatal_and_transient_do_not_descend():
    for msg in ("a real bug", "UNAVAILABLE: socket closed"):
        ladder, log = _toy([msg])
        with pytest.raises(RuntimeError):
            ladder.step(1)
        assert log["built"] == ["a"]


def test_in_place_step_is_never_re_invoked():
    """The port's guard: a degradable failure raised from INSIDE a step
    that writes its buffers in place propagates; no lower rung runs on the
    half-written state."""
    ladder, log = _toy(["vmem exceeded"], writes_in_place=True)
    with pytest.raises(RuntimeError, match="vmem"):
        ladder.step(1)
    assert ladder.descents == [] and log["built"] == ["a"]
    # ...while the execute hook fires before entry, and descends
    ladder, log = _toy([], writes_in_place=True)
    inject.set_plan("execute:vmem_oom:toy:a")
    assert ladder.step(2) == 4 and _names(ladder) == [("a", "vmem_oom")]


def test_prefilter_descends_without_building():
    ladder, log = _toy([], prefilter=lambda r: "too big" if r.name == "a" else (
        ("illegal", FailureClass.COMPILE_REJECT) if r.name == "b" else None))
    assert log["built"] == ["c"]
    assert _names(ladder) == [("a", "vmem_oom"), ("b", "compile_reject")]
    with pytest.raises(RuntimeError, match="statically prefiltered"):
        _toy([], prefilter=lambda r: "never fits")


def test_compile_phase_descends_at_the_eager_build():
    inject.set_plan("compile:compile_reject:toy:a")
    ladder, log = _toy([])
    assert log["built"] == ["b"] and ladder.rung.name == "b"


# --- Jacobi3D: the same plans through both packages --------------------------------

JACOBI_CASES = {
    # id: (plan, steps, size, subdomains, keywords)
    "wrap_depth": ("execute:vmem_oom:jacobi*1", 8, (24, 24, 24), 1, dict(temporal_k=4)),
    "wrap_compile": ("compile:compile_reject:jacobi*1", 8, (24, 24, 24), 1, dict(temporal_k=4)),
    "wrap_units": ("execute:vmem_oom:jacobi*2", 6, (16, 32, 32), 1, dict(temporal_k=4, compute_unit="mxu_band")),
    "wrap_bf16": ("execute:vmem_oom:jacobi*1", 6, (24, 24, 24), 1, dict(temporal_k=4, storage_dtype="bf16")),
    "wavefront_depth": ("execute:compile_reject:jacobi*1", 8, (24, 24, 24), 1,
                        dict(temporal_k=4, pallas_path="wavefront")),
    "wavefront_8": ("execute:vmem_oom:jacobi*2", 6, (16, 16, 16), 8, dict(temporal_k=3, pallas_path="wavefront")),
    "wavefront_axes": ("execute:vmem_oom:jacobi*3", 6, (16, 16, 16), 8,
                       dict(temporal_k=2, pallas_path="wavefront", compute_unit="mxu", storage_dtype="bf16")),
    "dispatch_site": ("dispatch:vmem_oom:jacobi*1", 5, (24, 24, 24), 1, dict(temporal_k=3)),
}


@pytest.mark.parametrize("case", sorted(JACOBI_CASES))
def test_jacobi_ladder_matches_jax(case):
    plan, steps, size, subdomains, kw = JACOBI_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j = JJacobi3D(*size, devices=jax.devices()[:subdomains], kernel_impl="pallas", interpret=True, **kw)
        jinject.set_plan(plan)
        j.realize()
        j.step(steps)
        t = Jacobi3D(*size, subdomains=subdomains, kernel_impl="cuda", device="cpu", **kw)
        inject.set_plan(plan)
        t.realize()
        t.step(steps)
    assert t._ladder.descents, "the plan drove no descent"
    assert _names(t._ladder) == _names(j._ladder)
    assert t._rung_name() == j._rung_name()
    np.testing.assert_array_equal(t.temperature(), j.temperature())


def test_jacobi_descent_matches_an_undisturbed_run():
    """A descent mid-run keeps the run's arithmetic: wavefront depth 4 to 3
    over the same shell ends bitwise equal to the run at depth 4."""
    ref = Jacobi3D(16, 16, 16, subdomains=8, kernel_impl="cuda", temporal_k=4, pallas_path="wavefront", device="cpu")
    ref.realize()
    ref.step(11)
    t = Jacobi3D(16, 16, 16, subdomains=8, kernel_impl="cuda", temporal_k=4, pallas_path="wavefront", device="cpu")
    t.realize()
    t.step(3)
    inject.set_plan("execute:compile_reject:jacobi:wavefront[depth=4]")
    t.step(8)
    assert t._rung_name() == "wavefront[depth=3]" and t._wavefront_m == 4
    assert t.dd.shell_radius().lo().x == 4
    np.testing.assert_array_equal(t.temperature(), ref.temperature())


def test_jacobi_failure_inside_the_step_propagates(monkeypatch):
    """A VMEM_OOM raised by a kernel launch inside the entered step is not
    re-run on a lower rung: it propagates, nothing descended."""
    t = Jacobi3D(16, 16, 16, kernel_impl="cuda", temporal_k=4, device="cpu")
    t.realize()

    def refused(*a, **k):
        raise RuntimeError("CUDA kernel launch failed (7): too many resources requested for launch")

    monkeypatch.setattr("stencil_tpu_torch.models.jacobi.jacobi_wrap_step", refused)
    t._step = t._make_cuda_step()
    with pytest.raises(RuntimeError, match="too many resources"):
        t.step(4)
    assert t._ladder.descents == [] and t._rung_name() == "wrap[k=4]"


def test_jacobi_prefilter_prices_shared_memory(monkeypatch):
    """A wavefront depth the card cannot grant descends statically, with no
    launch: the shared-memory model is the Hopper prefilter."""
    fits = jk.wavefront_smem_fits
    t = Jacobi3D(16, 16, 16, subdomains=8, kernel_impl="cuda", temporal_k=4, pallas_path="wavefront", device="cpu")
    t.realize()  # planned at depth 4; a toolchain whose blocks grant less:
    monkeypatch.setattr("stencil_tpu_torch.models.jacobi.wavefront_smem_fits",
                        lambda m, unit="vpu", item=4: m <= 2 and fits(m, unit, item))
    t._ladder = t._make_ladder()
    assert _names(t._ladder) == [("wavefront[depth=4]", "vmem_oom"), ("wavefront[depth=3]", "vmem_oom")]
    assert t._rung_name() == "wavefront[depth=2]"


def test_jacobi_ladder_exhausts_on_the_torch_engine():
    """The torch engine's one rung (``xla``) has nothing below it."""
    t = Jacobi3D(16, 16, 16, device="cpu")
    t.realize()
    assert t._rung_name() == "xla"
    inject.set_plan("execute:vmem_oom:jacobi")
    with pytest.raises(RuntimeError, match="vmem"):
        t.step(1)


# --- the stream engine --------------------------------------------------------------


def mean6(views, info):
    out = {}
    for name, src in views.items():
        out[name] = (src.sh(-1, 0, 0) + src.sh(1, 0, 0) + src.sh(0, -1, 0) + src.sh(0, 1, 0)
                     + src.sh(0, 0, -1) + src.sh(0, 0, 1)) / 6.0
    return out


def _init(cx, cy, cz, lib):
    return lib.sin(0.3 * cx + 0.2 * cy) + 0.1 * cz


def _jax_stream(mult, plan, steps, size=24):
    dd = JDomain(size, size, size)
    dd.set_radius(JRadius.constant(1))
    dd.set_devices(jax.devices()[:8])
    h = dd.add_data("u")
    if mult > 1:
        dd.set_halo_multiplier(mult)
    dd.realize()
    dd.init_by_coords(h, lambda x, y, z: _init(x, y, z, jnp))
    jinject.set_plan(plan)
    step = dd.make_step(mean6, engine="stream", interpret=True)
    dd.run_step(step, steps)
    return step, dd.quantity_to_host(h)


def _port_stream(mult, plan, steps, size=24, **kw):
    dd = DistributedDomain(size, size, size, device="cpu")
    dd.set_radius(Radius.constant(1))
    dd.set_subdomains(8)
    h = dd.add_data("u")
    if mult > 1:
        dd.set_halo_multiplier(mult)
    dd.realize()
    dd.init_by_coords(h, lambda x, y, z: _init(x, y, z, torch))
    inject.set_plan(plan)
    step = dd.make_step(mean6, engine="stream", **kw)
    dd.run_step(step, steps)
    return step, dd.quantity_to_host(h)


@pytest.mark.parametrize("plan,mult", [("execute:vmem_oom:stream*2", 3), ("compile:compile_reject:stream*1", 2),
                                       ("execute:compile_reject:stream:wavefront[m=3]", 3)])
def test_stream_ladder_matches_jax(plan, mult):
    js, jv = _jax_stream(mult, plan, 4)
    ts, tv = _port_stream(mult, plan, 4)
    assert ts._resilience.descents
    assert _names(ts._resilience) == _names(js._resilience)
    assert ts._stream_plan["route"] == js._stream_plan["route"]
    assert ts._stream_plan["m"] == js._stream_plan["m"]
    np.testing.assert_allclose(tv, jv, **TOL)


def test_stream_axes_step_down_before_depth():
    """split, then the depth: the schedule drops at the same depth first."""
    ts, tv = _port_stream(3, "execute:vmem_oom:stream*2", 4, stream_overlap="split", stream_z_slabs=False)
    assert _names(ts._resilience) == [("wavefront[m=3,split]", "vmem_oom"), ("wavefront[m=3]", "vmem_oom")]
    assert ts._stream_plan["m"] == 2 and ts._stream_plan["overlap"] == "off"
    _, ref = _port_stream(3, None, 4)
    np.testing.assert_array_equal(tv, ref)


def test_stream_plane_is_the_bottom_rung():
    inject.set_plan(None)
    with pytest.raises(RuntimeError, match="vmem"):
        _port_stream(1, "execute:vmem_oom:stream*2", 2)


def test_stream_step_exposes_the_current_rung_loop():
    """``step._loop`` (what capture and the counters read) follows the
    ladder: after a descent it is the lower rung's loop."""
    ts, _ = _port_stream(3, "execute:vmem_oom:stream*1", 2)
    assert ts._loop.unit == 2 and ts._stream_plan["m"] == 2


# --- the exchange route --------------------------------------------------------------


def test_exchange_route_descends_to_direct():
    """A refused build of a packed route descends to ``direct`` at
    ``realize()``: counted, the route event emitted with source ``ladder``
    after the resolution's own (``explicit``, as the JAX package emits
    both), and ``direct`` recorded as the route taken; the exchange then
    fills the same halos."""
    inject.set_plan("compile:compile_reject:exchange:yzpack_pallas")
    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(Radius.constant(1))
    dd.set_subdomains(8)
    h = dd.add_data("u")
    dd.set_exchange_route("yzpack_pallas")
    dd.realize()
    assert dd.exchange_route() == "direct"
    events = [e for e in telemetry.recent_events() if e["event"] == tm.EVENT_EXCHANGE_ROUTE]
    assert events == [dict(events[0], route="yzpack_pallas", source="explicit"),
                      dict(events[1], route="direct", source="ladder")]
    assert telemetry.snapshot()["counters"][tm.LADDER_DESCENTS] == 1
    dd.init_by_coords(h, lambda x, y, z: _init(x, y, z, torch))
    dd.exchange()
    ref = DistributedDomain(16, 16, 16, device="cpu")
    ref.set_radius(Radius.constant(1))
    ref.set_subdomains(8)
    rh = ref.add_data("u")
    ref.realize()
    ref.init_by_coords(rh, lambda x, y, z: _init(x, y, z, torch))
    ref.exchange()
    np.testing.assert_array_equal(dd.raw_to_host(h), ref.raw_to_host(rh))


def test_exchange_compile_transient_retries():
    """The build's fault hook rides the transient retry, as the JAX
    package's exchange compile does."""
    inject.set_plan("compile:transient:compile:exchange:zpack_pallas")
    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(Radius.constant(1))
    dd.set_subdomains(8)
    dd.add_data("u")
    dd.set_exchange_route("zpack_pallas")
    import os

    os.environ["STENCIL_RETRY_BACKOFF_S"] = "0"
    try:
        dd.realize()
    finally:
        del os.environ["STENCIL_RETRY_BACKOFF_S"]
    assert dd.exchange_route() == "zpack_pallas"
    assert telemetry.snapshot()["counters"][tm.RETRY_ATTEMPTS] == 1
