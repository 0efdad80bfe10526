"""The axis sources of the port against the JAX package's: every planner
axis resolves explicit > env > tuned > static.

For the compute unit, the contraction operands, the storage dtype, the
exchange route, the stream overlap and the stream halo, each resolution's
``(value, source)`` and its telemetry event equal the JAX package's over
explicit requests x environment knobs x tuned values, garbage tuned values
and structural degrades included.  The z-ring layout and the z-slab forms
(``STENCIL_Z_RING``, ``STENCIL_Z_SLABS``) are compared on built Jacobi3D
models, whose layouts must match.  The planners' consults of a tuned depth
(``choose_temporal_k``, the wrap and wavefront plans, ``plan_stream``) and
their fallback on a structurally invalid one are pinned too.

In-process on the CPU, small domains, each test with its own tune cache
directories (one a package: the two packages' files share a key's name).
"""

import itertools
import warnings

import jax.numpy as jnp
import pytest
import torch

from stencil_tpu import telemetry as jtelemetry
from stencil_tpu import tune as jtune
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.ops import jacobi_pallas as jjp
from stencil_tpu.ops import stream as jst
from stencil_tpu.telemetry import names as jtm
from stencil_tpu_torch import telemetry, tune
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.ops import jacobi_kernels as jk
from stencil_tpu_torch.ops import stream as st
from stencil_tpu_torch.telemetry import names as tm

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

KNOBS = ("STENCIL_COMPUTE_UNIT", "STENCIL_MXU_INPUT", "STENCIL_STORAGE_DTYPE", "STENCIL_EXCHANGE_ROUTE",
         "STENCIL_STREAM_OVERLAP", "STENCIL_STREAM_HALO", "STENCIL_Z_RING", "STENCIL_Z_SLABS", "STENCIL_TUNE")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """One cache directory a package, no axis knob set."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    state, jstate = tune.overrides(), jtune.overrides()
    tune.set_cache_dir(str(tmp_path / "port"))
    jtune.set_cache_dir(str(tmp_path / "jax"))
    yield
    tune.restore(state)
    jtune.restore(jstate)


def _env(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def _last(events, name):
    got = [e for e in events if e["event"] == name]
    return {k: v for k, v in got[-1].items() if k != "ts"} if got else None


def _both(port_fn, jax_fn, event):
    """Each package's result and its last ``event``, warnings silenced (the
    port warns where the JAX package logs)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = port_fn()
    want = jax_fn()
    return (got, _last(telemetry.recent_events(), event)), (want, _last(jtelemetry.recent_events(), event))


# --- the kernel axes -----------------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "mxu", "vpu"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compute_unit_equals_jax(monkeypatch, env, dtype):
    _env(monkeypatch, "STENCIL_COMPUTE_UNIT", env)
    for req, tuned, engine_ok in itertools.product((None, "auto", "vpu", "mxu", "mxu_band"),
                                                   (None, "mxu_band", "vpu", "garbage"), (True, False)):
        got, want = _both(
            lambda: jk.resolve_compute_unit(req, tuned, [getattr(torch, dtype)], where="w", engine_ok=engine_ok),
            lambda: jjp.resolve_compute_unit(req, tuned, [jnp.dtype(dtype)], where="w", engine_ok=engine_ok),
            tm.EVENT_KERNEL_COMPUTE_UNIT)
        assert got == want, (req, tuned, engine_ok)
    # a prospective resolution emits nothing, in both
    n, jn = len(telemetry.recent_events()), len(jtelemetry.recent_events())
    assert jk.resolve_compute_unit(None, "mxu", [torch.float32], emit=False)[0] == (env or "mxu")
    jjp.resolve_compute_unit(None, "mxu", [jnp.float32], emit=False)
    assert (len(telemetry.recent_events()), len(jtelemetry.recent_events())) == (n, jn)


@pytest.mark.parametrize("env", [None, "bf16", "f32"])
def test_mxu_input_equals_jax(monkeypatch, env):
    _env(monkeypatch, "STENCIL_MXU_INPUT", env)
    for req, tuned, unit in itertools.product((None, "auto", "f32", "bf16"), (None, "bf16", "f32", "fp8"),
                                              ("vpu", "mxu", "mxu_band")):
        got, want = _both(lambda: jk.resolve_mxu_input(req, tuned, unit, where="w"),
                          lambda: jjp.resolve_mxu_input(req, tuned, unit, where="w"), tm.EVENT_KERNEL_MXU_INPUT)
        assert got == want, (req, tuned, unit)


@pytest.mark.parametrize("env", [None, "bf16", "native"])
def test_storage_dtype_equals_jax(monkeypatch, env):
    _env(monkeypatch, "STENCIL_STORAGE_DTYPE", env)
    for req, tuned, dtype, engine_ok in itertools.product((None, "auto", "native", "bf16"), (None, "bf16", "fp4"),
                                                          ("float32", "float64"), (True, False)):
        got, want = _both(
            lambda: jk.resolve_storage_dtype(req, tuned, [getattr(torch, dtype)], where="w", engine_ok=engine_ok),
            lambda: jjp.resolve_storage_dtype(req, tuned, [jnp.dtype(dtype)], where="w", engine_ok=engine_ok),
            tm.EVENT_KERNEL_STORAGE_DTYPE)
        assert got == want, (req, tuned, dtype, engine_ok)


def test_env_knobs_are_validated_reads(monkeypatch):
    for knob, fn in (("STENCIL_COMPUTE_UNIT", lambda: jk.resolve_compute_unit(None, None, [torch.float32])),
                     ("STENCIL_MXU_INPUT", lambda: jk.resolve_mxu_input(None, None, "mxu")),
                     ("STENCIL_STORAGE_DTYPE", lambda: jk.resolve_storage_dtype(None, None, [torch.float32])),
                     ("STENCIL_STREAM_OVERLAP", lambda: st._overlap_request({})),
                     ("STENCIL_STREAM_HALO", lambda: st._halo_request({}))):
        monkeypatch.setenv(knob, "bogus")
        with pytest.raises(ValueError, match=knob):
            fn()
        monkeypatch.delenv(knob)


# --- the exchange route ----------------------------------------------------------------


def _domains(size=(16, 16, 16)):
    j = JDomain(*size)
    j.set_radius(JRadius.constant(1))
    j.add_data("q", dtype=jnp.float32)
    j.realize()
    t = DistributedDomain(*size, device="cpu")
    t.set_radius(Radius.constant(1))
    t.set_subdomains(8)
    t.add_data("q")
    t.realize()
    return t, j


@pytest.mark.parametrize("size", [(16, 16, 16), (16, 17, 17)])
def test_exchange_route_equals_jax(caches, monkeypatch, size):
    t, j = _domains(size)
    assert t.tune_key("exchange").to_dict() == j.tune_key("exchange").to_dict()
    for req, env, tuned in itertools.product((None, "zpack_xla"), (None, "yzpack_pallas", "auto"),
                                             (None, "zpack_pallas", "garbage")):
        _env(monkeypatch, "STENCIL_EXCHANGE_ROUTE", env)
        for pkg, dd in ((tune, t), (jtune, j)):
            pkg.reset_memo()
            if tuned is not None:
                pkg.record_config(dd.tune_key("exchange"), {"exchange_route": tuned})
        t._exchange_route_req = j._exchange_route_req = req
        got, want = _both(t._resolve_exchange_route, j._resolve_exchange_route, tm.EVENT_EXCHANGE_ROUTE)
        assert got == want, (req, env, tuned)
        for pkg, dd in ((tune, t), (jtune, j)):  # clear the tuned entry for the next case
            pkg.record_config(dd.tune_key("exchange"), {})
    t._exchange_route_req = None
    monkeypatch.setenv("STENCIL_EXCHANGE_ROUTE", "bogus")
    with pytest.raises(ValueError, match="STENCIL_EXCHANGE_ROUTE"):
        t._resolve_exchange_route()


def test_disabled_tuning_ignores_the_tuned_route(caches, monkeypatch):
    t, _ = _domains()
    tune.record_config(t.tune_key("exchange"), {"exchange_route": "zpack_xla"})
    assert t._resolve_exchange_route() == "zpack_xla"
    monkeypatch.setenv("STENCIL_TUNE", "0")
    assert t._resolve_exchange_route() == "direct"


# --- the stream overlap and halo ----------------------------------------------------------


PLANS = [{"route": "plane", "m": 1, "z_slabs": False}, {"route": "wavefront", "m": 2, "z_slabs": True},
         {"route": "wavefront", "m": 2, "z_slabs": False}, {"route": "wrap", "m": 4, "z_slabs": False}]


@pytest.mark.parametrize("env", [None, "split", "off"])
def test_stream_overlap_equals_jax(monkeypatch, env):
    _env(monkeypatch, "STENCIL_STREAM_OVERLAP", env)
    for base, forced, tuned in itertools.product(PLANS, (None, "off", "split"), (None, "split", "off", "bogus")):
        plan = dict(base)
        if tuned is not None:
            plan["overlap"] = tuned
        if forced is not None:
            plan.update(overlap=forced, overlap_forced=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = (st._overlap_request(plan), st._resolve_stream_overlap(plan))
        assert got == (jst._overlap_request(plan), jst._resolve_stream_overlap(plan)), (base, forced, tuned)


@pytest.mark.parametrize("env", [None, "fused", "array"])
def test_stream_halo_equals_jax(monkeypatch, env):
    _env(monkeypatch, "STENCIL_STREAM_HALO", env)
    t, j = _domains()
    for base, forced, tuned, route in itertools.product(PLANS, (None, "array", "fused"), (None, "fused", "bogus"),
                                                        ("direct", "yzpack_pallas")):
        plan = dict(base, overlap="off")
        if tuned is not None:
            plan["halo"] = tuned
        if forced is not None:
            plan.update(halo=forced, halo_forced=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = (st._halo_request(plan), st._resolve_stream_halo(t, plan, route))
        assert got == (jst._halo_request(plan), jst._resolve_stream_halo(j, plan, route)), (base, forced, tuned)


def test_make_stream_step_emits_its_axes(caches, monkeypatch):
    """A built step records each axis's source in its events: env over the
    tuned plan, the tuned plan over the static value."""
    from stencil_tpu_torch.models.astaroth import AstarothSim

    sim = AstarothSim(16, 16, 16, num_quantities=2, kernel_impl="cuda", subdomains=8, device="cpu")
    key = sim.dd.tune_key("stream")
    tune.record_config(key, {"route": "plane", "m": 1, "z_slabs": False, "grouping": "joint", "overlap": "split",
                             "compute_unit": "mxu", "halo": "array"})
    monkeypatch.setenv("STENCIL_STREAM_HALO", "array")
    sim.realize()
    plan = sim._step._stream_plan
    assert (plan["route"], plan["overlap"], plan["compute_unit"]) == ("plane", "split", "mxu")
    ev = telemetry.recent_events()
    assert _last(ev, tm.EVENT_STEP_OVERLAP) == dict(event=tm.EVENT_STEP_OVERLAP, overlap="split", source="tuned",
                                                    route="plane", m=1)
    assert _last(ev, tm.EVENT_STEP_HALO)["source"] == "env"
    assert _last(ev, tm.EVENT_KERNEL_COMPUTE_UNIT) == dict(event=tm.EVENT_KERNEL_COMPUTE_UNIT, unit="mxu",
                                                           source="tuned", where="stream:plane")
    assert jtm.EVENT_STEP_OVERLAP == tm.EVENT_STEP_OVERLAP


# --- the z-ring layout and the z-slab forms -------------------------------------------------


RING = [(None, None, None, None), (False, None, None, None), (True, "0", None, None), (None, "0", None, None),
        (None, "1", False, None), (None, None, False, None), (None, None, True, None), (False, None, True, None),
        (None, None, None, "0"), (None, "1", True, "0")]


@pytest.mark.parametrize("explicit,env,tuned,slabs", RING)
def test_z_ring_and_z_slabs_equal_jax(caches, monkeypatch, explicit, env, tuned, slabs):
    from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    _env(monkeypatch, "STENCIL_Z_RING", env)
    _env(monkeypatch, "STENCIL_Z_SLABS", slabs)
    size = (16, 16, 1024)  # 8 subdomains along z: a z interior of 128 takes the ring
    t = Jacobi3D(*size, kernel_impl="cuda", pallas_path="wavefront", subdomains=8, z_ring=explicit, device="cpu")
    j = JJacobi3D(*size, kernel_impl="pallas", pallas_path="wavefront", interpret=True, z_ring=explicit,
                  dtype=jnp.float32)
    if tuned is not None:
        cfg = {"m": 4, "halo_multiplier": 4, "alias": False, "z_ring": tuned}
        tune.record_config(t.dd.tune_key("jacobi-wavefront"), cfg)
        jtune.record_config(j.dd.tune_key("jacobi-wavefront"), cfg)
    t.realize()
    j.realize()
    assert (t._wavefront_m, t._wavefront_z_slabs, t._wavefront_z_ring) == (
        j._wavefront_m, j._wavefront_z_slabs, j._wavefront_z_ring)
    want_src = "explicit" if explicit is not None else "env" if env else "tuned" if tuned is not None else "static"
    assert t._z_ring_pref(t._tuned_wavefront or {})[1] == want_src


# --- the tuned depths ------------------------------------------------------------------------


def test_choose_temporal_k_consults_and_validates(caches, capfd):
    from stencil_tpu_torch.tune.key import WorkloadKey

    key = WorkloadKey(chip="cpu", domain=(16, 16, 16), dtype="float32", n_fields=1, mesh=(1, 1, 1), radius=1,
                      route="jacobi-wrap")
    static = jk.choose_temporal_k((16, 16, 16))
    tune.record_config(key, {"k": 3})
    assert jk.choose_temporal_k((16, 16, 16), tune_key=key) == 3
    tune.record_config(key, {"k": 99})
    assert jk.choose_temporal_k((16, 16, 16), tune_key=key) == static
    assert "structurally invalid" in capfd.readouterr().err
    tune.record_config(key, {"k": True})  # not a depth
    assert jk.choose_temporal_k((16, 16, 16), tune_key=key) == static
    assert jk.choose_temporal_k((16, 16, 16), 2, tune_key=key) == 2  # explicit never consults


def test_jacobi_models_use_the_tuned_depths(caches, capfd):
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    m = Jacobi3D(16, 16, 16, kernel_impl="cuda", device="cpu")
    tune.record_config(m.dd.tune_key("jacobi-wrap"), {"k": 3, "compute_unit": "mxu_band", "mxu_input": "bf16",
                                                      "storage_dtype": "bf16"})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.realize()
    assert (m._wrap_k, m._compute_unit, m._mxu_input, m.dd.storage_dtype()) == (3, "mxu_band", "bf16", "bf16")

    def wavefront(cfg):
        w = Jacobi3D(32, 32, 32, kernel_impl="cuda", pallas_path="wavefront", device="cpu")
        w.dd.set_partition(2, 2, 2)
        tune.record_config(w.dd.tune_key("jacobi-wavefront"), cfg)
        w.realize()
        return w

    static = wavefront({}).dd.halo_multiplier()
    w = wavefront({"m": 3, "halo_multiplier": 3, "alias": False, "z_ring": False, "compute_unit": "mxu"})
    assert (w._wavefront_m, w._tuned_wavefront["m"], w._compute_unit) == (3, 3, "mxu")
    capfd.readouterr()
    for bad in ({"m": 17}, {"m": 12}, {"m": "4"}):  # past the shards, past the shared memory, not a depth
        w = wavefront(bad)
        assert w._wavefront_m == static and w._tuned_wavefront is None
        assert "structurally invalid" in capfd.readouterr().err


def test_plan_stream_consults_and_validates(caches, capfd):
    d = DistributedDomain(16, 16, 16, device="cpu")
    d.set_radius(Radius.constant(1))
    d.add_data("q")
    d.realize()
    static = st.plan_stream(d, 1)
    tuned = {"route": "wrap", "m": 2, "z_slabs": False, "grouping": "joint"}
    tune.record_config(d.tune_key("stream"), tuned)
    assert st.plan_stream(d, 1) == tuned
    assert st.plan_stream(d, 1, max_m=3)["m"] == min(3, static["m"])  # a depth cap re-plans statically
    assert st.plan_stream(d, 1, path="plane")["route"] == "plane"  # a forced route too
    capfd.readouterr()
    for bad in ({"route": "wavefront", "m": 99, "z_slabs": False, "grouping": "joint"},
                dict(tuned, overlap="sideways"), dict(tuned, grouping="per-field"), dict(tuned, m=9)):
        tune.record_config(d.tune_key("stream"), bad)
        assert st.plan_stream(d, 1) == static
        assert "structurally invalid" in capfd.readouterr().err
