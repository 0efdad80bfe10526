"""The port's telemetry facade (``stencil_tpu_torch/telemetry/``) against the
JAX package's.

* every name constant of the port is the JAX package's string, verbatim;
* a counter, gauge or histogram fed the same values snapshots to the same
  dict in both registries (the statistics exactly);
* the facade's rules: counters live while disabled, histograms and spans
  only while enabled, the JSONL sink, the Chrome trace and the metrics file,
  the event ring, the env knobs;
* the same Jacobi run counts the same dispatches, iterations, exchanges and
  bytes in both packages (the port's torch engine against JAX's ``jnp``);
* the drivers' ``--metrics-out`` writes the snapshot.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from stencil_tpu import telemetry as jtelemetry
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu.telemetry import metrics as jmetrics
from stencil_tpu.telemetry import names as jnames
from stencil_tpu.utils import config as jconfig
from stencil_tpu.utils.statistics import Statistics as JStatistics
from stencil_tpu_torch import telemetry
from stencil_tpu_torch.models.jacobi import Jacobi3D
from stencil_tpu_torch.telemetry import metrics, names
from stencil_tpu_torch.telemetry import names as tm
from stencil_tpu_torch.utils import config
from stencil_tpu_torch.utils.statistics import Statistics

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)

_KNOBS = ("STENCIL_TELEMETRY", "STENCIL_TELEMETRY_DIR", "STENCIL_TELEMETRY_EVENTS")


def _fresh():
    telemetry.disable()
    telemetry.reset()
    telemetry._t._configured = False


@pytest.fixture(autouse=True)
def fresh_telemetry(monkeypatch):
    for var in _KNOBS:
        monkeypatch.delenv(var, raising=False)
    _fresh()
    yield
    _fresh()


def test_names_are_the_jax_strings():
    consts = {k: v for k, v in vars(names).items() if k.isupper() and not k.startswith("ALL_")}
    assert len(consts) > 35
    for key, value in consts.items():
        assert getattr(jnames, key) == value, key
    # each registry is a subset of the JAX package's, of the same kind
    for kind in ("ALL_COUNTERS", "ALL_GAUGES", "ALL_HISTOGRAMS", "ALL_SPANS", "ALL_EVENTS"):
        assert getattr(names, kind) <= getattr(jnames, kind), kind
    strings = [v for v in consts.values() if isinstance(v, str)]
    assert len(set(strings)) == len(strings)
    assert all(s == s.lower() and " " not in s for s in strings)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 17, 100])
def test_registry_snapshot_equals_jax(n):
    """Counters, gauges and histograms fed the same seeded values snapshot to
    the same dict (statistics exactly: the same formulas in the same order)."""
    rng = np.random.default_rng(n)
    vals = rng.random(n).tolist()
    mine, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for reg in (mine, theirs):
        reg.counter(names.STEP_DISPATCHES).inc(n)
        reg.gauge(names.CHECKPOINT_RETAINED).set(n / 3)
        for v in vals:
            reg.histogram(names.STEP_SECONDS).observe(v)
    seeds = dict(seed_counters=names.ALL_COUNTERS, seed_histograms=names.ALL_HISTOGRAMS)
    assert mine.snapshot(**seeds) == theirs.snapshot(**seeds)
    with pytest.raises(ValueError, match="different metric kind"):
        mine.gauge(names.STEP_DISPATCHES)


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.95, 0.99, 1.0])
def test_quantile_equals_jax_and_numpy(q):
    xs = np.random.default_rng(3).random(37).tolist()
    mine, theirs = Statistics(), JStatistics()
    for x in xs:
        mine.insert(x)
        theirs.insert(x)
    assert mine.quantile(q) == theirs.quantile(q)
    assert mine.quantile(q) == pytest.approx(float(np.quantile(xs, q)), rel=1e-12)
    assert math.isnan(Statistics().quantile(q))


@pytest.mark.parametrize("raw", [None, "", "3", "-2", "2.5", "yes", "off", "maybe", "auto"])
def test_env_reads_equal_jax(monkeypatch, raw):
    """``env_int`` / ``env_float`` / ``env_bool`` / ``env_str`` /
    ``env_choice``: the same value, or a ValueError naming the variable, as
    the JAX package's reads."""
    if raw is None:
        monkeypatch.delenv("STENCIL_PROBE", raising=False)
    else:
        monkeypatch.setenv("STENCIL_PROBE", raw)
    calls = [("env_int", (7,), {"minimum": 0}), ("env_float", (0.5,), {"minimum": 0.0}),
             ("env_bool", (False,), {}), ("env_str", ("d",), {}), ("env_choice", ("auto", {"auto", "3"}), {})]
    for name, args, kw in calls:
        results = []
        for mod in (config, jconfig):
            try:
                results.append(getattr(mod, name)("STENCIL_PROBE", *args, **kw))
            except ValueError as e:
                assert "STENCIL_PROBE" in str(e)
                results.append(ValueError)
        assert results[0] == results[1], (name, raw, results)


def test_counters_live_while_disabled_histograms_and_spans_not():
    assert not telemetry.enabled()
    telemetry.inc(tm.RETRY_ATTEMPTS, 2)
    telemetry.counter(tm.RETRY_ATTEMPTS).value += 1
    telemetry.set_gauge(tm.CHECKPOINT_RETAINED, 3)
    telemetry.observe(tm.STEP_SECONDS, 1.0)
    telemetry.record_span(tm.SPAN_STEP, 0.0, 1.0)
    with telemetry.span(tm.SPAN_EXCHANGE, histogram=tm.EXCHANGE_SECONDS):
        pass
    snap = telemetry.snapshot()
    assert snap["counters"][tm.RETRY_ATTEMPTS] == 3
    assert set(names.ALL_COUNTERS) <= set(snap["counters"])
    assert snap["gauges"][tm.CHECKPOINT_RETAINED] == 3.0
    assert snap["histograms"][tm.STEP_SECONDS]["count"] == 0
    assert telemetry.dump_chrome_trace() is None and telemetry.dump_metrics() is None
    # reset zeroes a held counter in place
    held = telemetry.counter(tm.RETRY_ATTEMPTS)
    telemetry.reset()
    assert held.value == 0 and held is telemetry.counter(tm.RETRY_ATTEMPTS)


def test_enabled_records_spans_events_and_files(tmp_path):
    telemetry.enable(dir=str(tmp_path))
    assert telemetry.enabled()
    telemetry.inc(tm.EXCHANGE_BYTES, 64)
    with telemetry.span(tm.SPAN_STEP, histogram=tm.STEP_SECONDS, label="outer"):
        with telemetry.span(tm.SPAN_EXCHANGE):
            pass
    telemetry.emit_event(tm.EVENT_RETRY, label="x", attempt=1)
    telemetry.emit_event(tm.EVENT_FAULT, phase="dispatch", label="y", failure_class="transient")
    arts = telemetry.write_artifacts()
    trace = json.load(open(arts["trace"]))["traceEvents"]
    spans = {e["name"]: e for e in trace if e["ph"] == "X"}
    assert spans[tm.SPAN_EXCHANGE]["args"]["parent"] == tm.SPAN_STEP
    assert spans[tm.SPAN_STEP]["args"]["label"] == "outer"
    assert any(e["ph"] == "C" and e["name"] == tm.EXCHANGE_BYTES for e in trace)
    lines = [json.loads(x) for x in open(arts["events"])]
    assert [x["event"] for x in lines] == [tm.EVENT_RETRY, tm.EVENT_FAULT]
    assert lines[0]["rank"] == 0 and lines[1]["failure_class"] == "transient"
    met = json.load(open(arts["metrics"]))
    assert met["counters"][tm.EXCHANGE_BYTES] == 64 and met["histograms"][tm.STEP_SECONDS]["count"] == 1
    assert [e["event"] for e in telemetry.recent_events(1)] == [tm.EVENT_FAULT]
    assert os.path.basename(arts["events"]) == "events_0.jsonl"


def test_env_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("STENCIL_TELEMETRY_DIR", str(tmp_path))
    telemetry._t._configured = False
    assert telemetry.enabled() and telemetry.event_log_path() == str(tmp_path / "events_0.jsonl")
    _fresh()
    monkeypatch.delenv("STENCIL_TELEMETRY_DIR")
    monkeypatch.setenv("STENCIL_TELEMETRY", "1")
    assert telemetry.enabled() and telemetry.event_log_path() is None
    _fresh()
    monkeypatch.setenv("STENCIL_TELEMETRY", "maybe")
    with pytest.raises(ValueError, match="STENCIL_TELEMETRY"):
        telemetry.enabled()
    _fresh()
    monkeypatch.delenv("STENCIL_TELEMETRY")
    monkeypatch.setenv("STENCIL_TELEMETRY_EVENTS", "1")
    with pytest.raises(ValueError, match="STENCIL_TELEMETRY_DIR"):
        telemetry.enabled()


def test_jacobi_counts_equal_jax():
    """The torch engine and JAX's ``jnp`` engine, 2x2x2, count the same
    dispatches, raw iterations, exchanges and analytic bytes."""
    jtelemetry.reset()
    j = JJacobi3D(16, 16, 16)
    j.realize()
    j.step(3)
    j.step(1)
    t = Jacobi3D(16, 16, 16, subdomains=8, device="cpu")
    t.realize()
    t.step(3)
    t.step(1)
    mine, theirs = telemetry.snapshot(), jtelemetry.snapshot()
    keys = [tm.STEP_DISPATCHES, tm.STEP_ITERATIONS, tm.EXCHANGE_COUNT, tm.EXCHANGE_BYTES,
            *tm.EXCHANGE_HOP_BYTES.values()]
    assert mine["counters"][tm.STEP_DISPATCHES] == 2 and mine["counters"][tm.STEP_ITERATIONS] == 4
    assert {k: mine["counters"][k] for k in keys} == {k: theirs["counters"][k] for k in keys}
    assert mine["gauges"][tm.EXCHANGE_BYTES_PER_EXCHANGE] == theirs["gauges"][tm.EXCHANGE_BYTES_PER_EXCHANGE]
    assert jax.device_count() == 8


def test_driver_metrics_out(tmp_path):
    from stencil_tpu_torch.bin import jacobi3d

    out = tmp_path / "m.json"
    assert jacobi3d.main(["12", "12", "12", "--no-weak-scale", "--device", "cpu", "--kernel-impl", "torch",
                          "--iters", "2", "--metrics-out", str(out)]) == 0
    snap = json.load(open(out))
    assert snap["counters"][tm.STEP_DISPATCHES] == 3  # the untimed first step, then 2
    assert snap["histograms"][tm.STEP_SECONDS]["count"] == 3
    assert not telemetry.enabled()  # the driver left telemetry as it found it


# --- DomainStats, the phase timer and the accounting of the exchange's and the
# stream engine's work (stencil_tpu/domain.py:86-101, :535-615, :1154-1249;
# stencil_tpu/ops/stream.py:2180-2229) --------------------------------------------


def _domains(route=None, size=32, radius=1, nf=1, seed=5, mult=1):
    """The same 2x2x2 domain in both packages, seeded alike."""
    from stencil_tpu.core.radius import Radius as JRadius
    from stencil_tpu.domain import DistributedDomain as JDomain
    from stencil_tpu_torch.core.radius import Radius
    from stencil_tpu_torch.domain import DistributedDomain

    t = DistributedDomain(size, size, size, device="cpu")
    t.set_radius(Radius.constant(radius))
    t.set_subdomains(8)
    j = JDomain(size, size, size)
    j.set_radius(JRadius.constant(radius))
    j.set_devices(jax.devices()[:8])
    if route is not None:
        t.set_exchange_route(route)
        j.set_exchange_route(route)
    if mult > 1:
        t.set_halo_multiplier(mult)
        j.set_halo_multiplier(mult)
    th = [t.add_data(f"q{i}") for i in range(nf)]
    jh = [j.add_data(f"q{i}") for i in range(nf)]
    t.realize()
    j.realize()
    rng = np.random.default_rng(seed)
    for a, b in zip(th, jh):
        v = rng.random((size,) * 3).astype(np.float32)
        t.set_quantity(a, v)
        j.set_quantity(b, v)
    return t, th, j, jh


def _counters(snap, keys):
    return {k: snap["counters"][k] for k in keys}


def test_domain_stats_fields_equal_jax():
    import dataclasses

    from stencil_tpu.domain import DomainStats as JStats
    from stencil_tpu_torch.domain import DomainStats

    assert [(f.name, f.default) for f in dataclasses.fields(DomainStats)] == \
        [(f.name, f.default) for f in dataclasses.fields(JStats)]


@pytest.mark.parametrize("route", ["direct", "yzpack_pallas"])
def test_realize_times_its_phases_and_the_exchange_build(route):
    """A realize fills the setup phases and observes the exchange's build
    into ``domain.compile.seconds`` with a ``domain.compile`` event shaped as
    the JAX package's (``phase``, ``label`` ``realize:<route>``, ``seconds``)."""
    from stencil_tpu import telemetry as jtelemetry

    telemetry.enable()
    jtelemetry.enable()
    try:
        t, _, j, _ = _domains(route)
        for stats in (t.stats, j.stats):
            assert stats.time_create > 0 and stats.time_exchange == stats.time_swap == 0.0
            assert all(getattr(stats, f) >= 0 for f in ("time_topo", "time_placement", "time_realize",
                                                        "time_plan"))
        # (the packed route's ladder emits its rung build as well, phase "ladder")
        mine = [e for e in telemetry.recent_events() if e["event"] == tm.EVENT_COMPILE and e["phase"] == "exchange"]
        theirs = [e for e in jtelemetry.recent_events()
                  if e["event"] == tm.EVENT_COMPILE and e["phase"] == "exchange"]
        assert [(e["phase"], e["label"]) for e in mine] == [(e["phase"], e["label"]) for e in theirs[-1:]] == \
            [("exchange", f"realize:{route}")]
        assert mine[0]["seconds"] == round(t.stats.time_create, 6)
        assert telemetry.snapshot()["histograms"][tm.COMPILE_SECONDS]["count"] == 1
    finally:
        jtelemetry.disable()
        jtelemetry.reset()


def test_exchange_stats_time_exchange_and_swap(monkeypatch):
    """``STENCIL_EXCHANGE_STATS=1`` (or ``enable_exchange_stats``) times every
    ``exchange()`` and ``swap()`` into ``stats``, as in the JAX package;
    without it, and with telemetry off, nothing is timed."""
    t, _, j, _ = _domains()
    for dd in (t, j):
        dd.exchange()
        dd.swap()
        assert dd.stats.time_exchange == dd.stats.time_swap == 0.0
        dd.enable_exchange_stats()
        dd.exchange()
        dd.swap()
        dd.swap()
        assert dd.stats.time_exchange > 0 and dd.stats.time_swap > 0
    assert telemetry.snapshot()["histograms"][tm.EXCHANGE_SECONDS]["count"] == 0  # telemetry off
    monkeypatch.setenv("STENCIL_EXCHANGE_STATS", "1")
    t2, _, _, _ = _domains()
    t2.exchange()
    assert t2.stats.time_exchange > 0
    monkeypatch.setenv("STENCIL_EXCHANGE_STATS", "sometimes")
    from stencil_tpu_torch.domain import DistributedDomain

    with pytest.raises(ValueError, match="STENCIL_EXCHANGE_STATS"):
        DistributedDomain(8, 8, 8, device="cpu")


def test_telemetry_on_times_exchange_and_swap_into_histograms():
    telemetry.enable()
    t, _, _, _ = _domains()
    t.exchange()
    t.swap()
    snap = telemetry.snapshot()
    assert snap["histograms"][tm.EXCHANGE_SECONDS]["count"] == 1
    assert snap["histograms"][tm.SWAP_SECONDS]["count"] == 1
    names_seen = {e["name"] for e in telemetry._t.spans.events()}
    assert {tm.SPAN_EXCHANGE, tm.SPAN_SWAP} <= names_seen
    assert t.stats.time_exchange > 0


@pytest.mark.parametrize("route", ["direct", "zpack_xla", "yzpack_pallas"])
def test_exchange_counters_equal_jax(route):
    """``exchange()`` and ``exchange_many`` on 2x2x2 32^3: the same exchange
    count, bytes, per-hop bytes and packed kernels as the JAX domain; the
    packed bytes are the port's buffers' (no lane pad at X = 34)."""
    from stencil_tpu import telemetry as jtelemetry
    from stencil_tpu_torch.ops import pack

    jtelemetry.reset()
    t, th, j, jh = _domains(route, nf=2)
    for dd in (t, j):
        dd.exchange()
        dd.exchange()
        dd.exchange_many(3)
    keys = [tm.EXCHANGE_COUNT, tm.EXCHANGE_BYTES, tm.EXCHANGE_PACKED_KERNELS, *tm.EXCHANGE_HOP_BYTES.values()]
    mine, theirs = telemetry.snapshot(), jtelemetry.snapshot()
    assert mine["counters"][tm.EXCHANGE_COUNT] == 5
    assert _counters(mine, keys) == _counters(theirs, keys)
    if route == "direct":
        assert mine["counters"][tm.EXCHANGE_PACKED_BYTES] == theirs["counters"][tm.EXCHANGE_PACKED_BYTES] == 0
        return
    # the port's model is the bytes of the buffers its packs make
    block = t.get_curr(th[0]).view(8, *t.local_spec().raw_size().tuple())
    bufs = [pack.pack_zshell_xla(block, 16, 1), pack.pack_zshell_xla(block, 1, 1)]
    if route.startswith("yz"):
        bufs += [pack.pack_yshell_xla(block, 16, 1), pack.pack_yshell_xla(block, 1, 1)]
    assert mine["counters"][tm.EXCHANGE_PACKED_BYTES] == 5 * 2 * sum(b.numel() * b.element_size() for b in bufs)
    assert mine["counters"][tm.EXCHANGE_PACKED_BYTES] < theirs["counters"][tm.EXCHANGE_PACKED_BYTES]


@pytest.mark.parametrize("raw", [(128, 40, 24), (256, 7, 9), (34, 34, 34), (100, 20, 130)])
@pytest.mark.parametrize("lo,hi", [(1, 1), (3, 0), (2, 4)])
def test_packed_message_model(raw, lo, hi):
    """``zpack_message_stats`` equals the JAX model where X is a multiple of
    128 (no lane pad either way) and the port's ``(d, Y, X)`` buffers'
    bytes elsewhere; ``ypack_message_stats`` equals it always."""
    from stencil_tpu.ops import exchange as jex
    from stencil_tpu_torch.ops import exchange as tex

    itemsizes = [4, 2, 8]
    assert tex.ypack_message_stats(raw, lo, hi, itemsizes) == jex.ypack_message_stats(raw, lo, hi, itemsizes)
    mine = tex.zpack_message_stats(raw, lo, hi, itemsizes)
    theirs = jex.zpack_message_stats(raw, lo, hi, itemsizes)
    assert mine[1] == theirs[1]
    if raw[0] % 128 == 0:
        assert mine == theirs
    X, Y, _ = raw
    assert mine[0] == sum(d * Y * X * i for d in (lo, hi) if d for i in itemsizes)


@pytest.mark.parametrize("path", ["plane", "wavefront"])
def test_split_exterior_cells_equal_jax(path):
    """The split schedule's recomputed band cells on 2x2x2 32^3, plane and
    wavefront routes, against the JAX stream engine (interpret mode): the
    same ``step.overlap.exterior_cells`` and exchange counts; 0 under off."""
    from stencil_tpu import telemetry as jtelemetry

    def mean6(views, info):
        return {n: (s.sh(-1, 0, 0) + s.sh(0, -1, 0) + s.sh(0, 0, -1) + s.sh(1, 0, 0) + s.sh(0, 1, 0)
                    + s.sh(0, 0, 1)) / 6.0 for n, s in views.items()}

    jtelemetry.reset()
    # the wavefront route as tests/test_torch_overlap_split.py takes it: a
    # shell of 3 from the halo multiplier, the plan from "auto"
    t, _, j, _ = _domains(nf=2, mult=1 if path == "plane" else 3)
    sp = "plane" if path == "plane" else "auto"
    tstep = t.make_step(mean6, engine="stream", stream_path=sp, stream_overlap="split")
    jstep = j.make_step(mean6, engine="stream", stream_path=sp, interpret=True, stream_overlap="split")
    assert tstep._stream_plan["route"] == jstep._stream_plan["route"] == path
    assert tstep._stream_plan["m"] == jstep._stream_plan["m"]
    for dd, step in ((t, tstep), (j, jstep)):
        dd.run_step(step, 3)
        dd.run_step(step, 1)
    keys = [tm.STEP_OVERLAP_EXTERIOR_CELLS, tm.EXCHANGE_COUNT, tm.EXCHANGE_BYTES, tm.STEP_ITERATIONS]
    mine = _counters(telemetry.snapshot(), keys)
    assert mine == _counters(jtelemetry.snapshot(), keys)
    assert mine[tm.STEP_OVERLAP_EXTERIOR_CELLS] > 0
    off = t.make_step(mean6, engine="stream", stream_path=sp, stream_overlap="off")
    t.run_step(off, 2)
    assert telemetry.snapshot()["counters"][tm.STEP_OVERLAP_EXTERIOR_CELLS] == mine[tm.STEP_OVERLAP_EXTERIOR_CELLS]


def test_mxu_flops_equal_jax():
    """``kernel.mxu.flops``: Astaroth's plane route on 2x2x2 32^3 under
    ``mxu`` (the stream engine's count a step), and the Jacobi wrap route
    under ``mxu_band`` (the model's count a call), against the JAX package's
    after the same calls; 0 under vpu."""
    from stencil_tpu import telemetry as jtelemetry
    from stencil_tpu.models.astaroth import AstarothSim as JAstaroth
    from stencil_tpu_torch.models.astaroth import AstarothSim

    jtelemetry.reset()
    j = JAstaroth(32, 32, 32, num_quantities=2, devices=jax.devices()[:8], kernel_impl="pallas", interpret=True,
                  schedule="per-step", compute_unit="mxu")
    t = AstarothSim(32, 32, 32, num_quantities=2, subdomains=8, device="cpu", kernel_impl="cuda",
                    schedule="per-step", compute_unit="mxu")
    wj = JJacobi3D(20, 16, 18, devices=jax.devices()[:1], kernel_impl="pallas", interpret=True,
                   compute_unit="mxu_band", temporal_k=3)
    wt = Jacobi3D(20, 16, 18, subdomains=1, device="cpu", kernel_impl="cuda", compute_unit="mxu_band",
                  temporal_k=3)
    for m in (j, t, wj, wt):
        m.realize()
    for m in (j, t):
        m.step(2)
    for m in (wj, wt):
        m.step(5)
    mine = telemetry.snapshot()["counters"][tm.KERNEL_MXU_FLOPS]
    assert mine > 0 and mine == jtelemetry.snapshot()["counters"][tm.KERNEL_MXU_FLOPS]
    vpu = Jacobi3D(20, 16, 18, subdomains=1, device="cpu", kernel_impl="cuda", temporal_k=3)
    vpu.realize()
    vpu.step(3)
    assert telemetry.snapshot()["counters"][tm.KERNEL_MXU_FLOPS] == mine
