"""The port's device-time attribution and roofline
(``stencil_tpu_torch/telemetry/device.py``, ``roofline.py``,
``bin/perf_report.py``, the drivers' ``--profile-dir``) against the JAX
package's.

* on XLA-format traces (the JAX package's checked-in fixture and synthetic
  events) both ``device.py`` modules give the same attribution, direction
  attribution and merge; where the port's ``PHASE_PATTERNS`` differ (the
  port's exchange is its scopes, its pack and mxu rows its kernel symbols)
  the difference is pinned;
* on Kineto-format traces (synthetic, and ``tests/data/torch_trace_h100.json.gz``,
  a capture the H100 wrote: one macro step of the 512^3 z-ring wavefront on
  2x2x2) device rows are selected by category, scopes come from
  ``gpu_user_annotation`` intervals or launch correlation, launches held
  are held against launches counted;
* ``roofline_report``, ``capture_report`` and ``comms_roofline`` equal the
  JAX package's on the same snapshot, attribution and peaks;
* ``ProfileCapture``: cadence, ``from_env`` validation, the degrade and the
  window deltas, as ``tests/test_device_trace.py`` pins them for JAX;
* the drivers' ``--profile-dir`` in-process on the CPU: a capture is
  counted and the finalize degrades without a device row.
"""

import ast
import copy
import gzip
import json
import os
import shutil

import pytest
import torch

from stencil_tpu.telemetry import device as jdevice
from stencil_tpu.telemetry import roofline as jroofline
from stencil_tpu_torch import telemetry
from stencil_tpu_torch.telemetry import device, roofline
from stencil_tpu_torch.telemetry import names as tm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "profile_fixture")
CARD_TRACE = os.path.join(REPO, "tests", "data", "torch_trace_h100.json.gz")
_KNOBS = ("STENCIL_TELEMETRY", "STENCIL_TELEMETRY_DIR", "STENCIL_TELEMETRY_EVENTS", "STENCIL_PROFILE_DIR",
          "STENCIL_PROFILE_EVERY")


@pytest.fixture(autouse=True)
def fresh_telemetry(monkeypatch):
    for var in _KNOBS:
        monkeypatch.delenv(var, raising=False)
    telemetry.disable()
    telemetry.reset()
    telemetry._t._configured = False
    yield
    telemetry.disable()
    telemetry.reset()
    telemetry._t._configured = False
    telemetry._t.captures_open = 0


def _fixture_events():
    traces = jdevice.find_trace_files(os.path.join(FIXTURE, "profile"))
    return jdevice.load_trace_events(traces[0])


def _xla_events(seed: int):
    """A seeded XLA-format trace: a device and a host process, rows whose
    args carry scope paths the two packages share (the overlap and direction
    scopes) and rows only one of them recognizes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    texts = [
        ("fusion.1", {"long_name": f"jit(step)/{tm.SPAN_OVERLAP_INTERIOR}/add"}),
        ("fusion.2", {"long_name": f"jit(step)/{tm.SPAN_OVERLAP_EXTERIOR}/sub"}),
        ("copy.3", {"long_name": f"jit(step)/{tm.SPAN_EXCHANGE_Z_LOW}/slice"}),
        ("copy.4", {"long_name": f"jit(step)/{tm.SPAN_EXCHANGE_Y_HIGH}/slice"}),
        ("mystery", {}),
    ]
    events = [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "/host:CPU"}},
    ]
    for i in range(int(rng.integers(5, 30))):
        name, args = texts[int(rng.integers(len(texts)))]
        events.append({"ph": "X", "pid": int(rng.choice([1, 1, 2])), "tid": 0, "name": name,
                       "ts": float(rng.integers(0, 10_000)), "dur": float(rng.integers(1, 500)), "args": args})
    return events


# --- XLA-format traces: the same result through both modules -----------------


@pytest.mark.parametrize("seed", range(6))
def test_xla_traces_attribute_as_jax(seed):
    """Synthetic XLA traces: the same attribution under either package's
    pattern table, the same direction attribution and the same merge."""
    events = _xla_events(seed)
    for phases in (jdevice.PHASE_PATTERNS, jdevice.EXCHANGE_DIRECTION_PHASES, {"x": ("fusion",)}):
        assert device.attribute_device_time(events, phases) == jdevice.attribute_device_time(events, phases)
    # the phases both tables hold by the same scope names agree by default
    mine, theirs = device.attribute_device_time(events), jdevice.attribute_device_time(events)
    for phase in (tm.SPAN_OVERLAP_INTERIOR, tm.SPAN_OVERLAP_EXTERIOR, "_total"):
        assert mine[phase] == theirs[phase]
    assert device.attribute_exchange_directions(events)["directions"] == \
        jdevice.attribute_exchange_directions(events)["directions"]
    host = [{"name": "s", "ph": "X", "ts": 5.0, "dur": 1.0, "pid": 0, "tid": 0, "args": {}}]
    assert device.merge_device_rows(host, events) == jdevice.merge_device_rows(host, events)
    assert device.device_pids(events) == jdevice.device_pids(events)


def test_fixture_trace_attributes_as_jax():
    """The JAX package's checked-in XLA fixture: equal under the JAX table;
    by default the scopes and the total agree and the port's own patterns
    differ where they should (the difference pinned): the port's exchange
    is the ``domain.exchange`` and direction scopes, so XLA's legacy
    ``halo_ppermute_z`` row is not in it; XLA's ``zpack`` / ``dot`` kernels
    are not the port's pack and mxu symbols."""
    events = _fixture_events()
    assert device.attribute_device_time(events, jdevice.PHASE_PATTERNS) == jdevice.attribute_device_time(events)
    mine, theirs = device.attribute_device_time(events), jdevice.attribute_device_time(events)
    for phase in (tm.SPAN_OVERLAP_INTERIOR, tm.SPAN_OVERLAP_EXTERIOR, "_total"):
        assert mine[phase] == theirs[phase]
    assert theirs["exchange"]["device_us"] == pytest.approx(640)
    assert mine["exchange"]["device_us"] == pytest.approx(600)  # the six direction-scoped rows
    assert theirs["pack"]["device_us"] > 0 and mine["pack"]["device_us"] == 0
    assert theirs["mxu"]["device_us"] > 0 and mine["mxu"]["device_us"] == 0
    assert device.attribute_exchange_directions(events)["directions"] == \
        jdevice.attribute_exchange_directions(events)["directions"]
    host = json.load(open(os.path.join(FIXTURE, "trace_0.json")))["traceEvents"]
    assert device.merge_device_rows(host, events) == jdevice.merge_device_rows(host, events)


def test_load_and_find_as_jax(tmp_path):
    p = tmp_path / "bad.trace.json.gz"
    p.write_bytes(b"\x1f\x8b not really gzip")
    assert device.load_trace_events(str(p)) == jdevice.load_trace_events(str(p)) == []
    q = tmp_path / "sub" / "host_1.123.pt.trace.json"
    q.parent.mkdir()
    q.write_text(json.dumps([{"ph": "X", "name": "k", "ts": 0, "dur": 1}]))
    assert device.find_trace_files(str(tmp_path)) == jdevice.find_trace_files(str(tmp_path))
    assert len(device.load_trace_events(str(q))) == 1


def test_merge_into_chrome_trace_idempotent(tmp_path):
    work = tmp_path / "telem"
    shutil.copytree(FIXTURE, work)
    chrome = str(work / "trace_0.json")
    for _ in range(2):
        assert device.merge_into_chrome_trace(chrome, str(work / "profile")) is not None
    doc = json.load(open(chrome))
    rows = [e for e in doc["traceEvents"] if e.get("pid", 0) >= 1000 and e.get("ph") == "X"]
    assert len(rows) == 13


# --- Kineto-format traces -----------------------------------------------------


def _kineto_events():
    """A small trace in Kineto's shape: host pid 4242 (ops, scopes,
    launches), device pid 0 (streams 7 and 13).  The z-low send's copy is
    held by a gpu_user_annotation interval and by its launch's correlation;
    the blend on stream 7 only by correlation (a dropped annotation); the
    interior kernel on stream 7 and an exterior kernel on stream 13 overlap
    by 30 us; one kernel is launched outside every scope."""
    H, D = 4242, 0
    ev = [
        {"ph": "M", "name": "process_name", "pid": H, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": D, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": D, "tid": 0, "args": {"labels": "GPU 0"}},
        # host scopes and launches
        {"ph": "X", "cat": "user_annotation", "name": tm.SPAN_STEP, "pid": H, "tid": 1, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": tm.SPAN_EXCHANGE_Z_LOW, "pid": H, "tid": 1, "ts": 10,
         "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": H, "tid": 1, "ts": 20, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "pid": H, "tid": 1, "ts": 30, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "user_annotation", "name": tm.SPAN_OVERLAP_INTERIOR, "pid": H, "tid": 1, "ts": 100,
         "dur": 50},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "pid": H, "tid": 1, "ts": 110, "dur": 5,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "user_annotation", "name": tm.SPAN_OVERLAP_EXTERIOR, "pid": H, "tid": 1, "ts": 200,
         "dur": 50},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "pid": H, "tid": 1, "ts": 210, "dur": 5,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "pid": H, "tid": 1, "ts": 2000, "dur": 5,
         "args": {"correlation": 5}},
        # device rows
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "pid": D, "tid": 7,
         "ts": 500, "dur": 10, "args": {"correlation": 1, "stream": 7}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": tm.SPAN_EXCHANGE_Z_LOW, "pid": D, "tid": 7,
         "ts": 500, "dur": 10, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::slab_rows_kernel<float, false>(float*)",
         "pid": D, "tid": 7, "ts": 520, "dur": 4, "args": {"correlation": 2, "stream": 7}},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::jacobi_queue<8, 0, true, true>(FormArgs<0>::type)", "pid": D,
         "tid": 7, "ts": 600, "dur": 100, "args": {"correlation": 3, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::plane_level_mxu<float>(MxuFields)",
         "pid": D, "tid": 13, "ts": 670, "dur": 60, "args": {"correlation": 4, "stream": 13}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": tm.SPAN_OVERLAP_EXTERIOR, "pid": D, "tid": 13,
         "ts": 670, "dur": 60, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128, 4>(int)", "pid": D,
         "tid": 7, "ts": 2100, "dur": 3, "args": {"correlation": 5, "stream": 7}},
    ]
    return ev


def test_kineto_rows_scopes_and_sources():
    ev = _kineto_events()
    assert device.is_kineto(ev) and not device.is_kineto(_fixture_events())
    # the card's process is named after the program: selected by category
    assert device.device_pids(ev) == {0: "GPU 0"}
    att = device.attribute_device_time(ev)
    # annotation rows are intervals, not work: 5 device rows
    assert att["_total"] == {"device_us": 177.0, "events": 5}
    assert att["exchange"]["device_us"] == 14.0  # the memcpy and the blend under exchange.z.low
    assert att["exchange"]["via"] == {"both": 1, "correlation": 1}
    assert att["pack"]["device_us"] == 4.0
    assert att["mxu"]["device_us"] == 60.0
    assert att[tm.SPAN_OVERLAP_INTERIOR]["device_us"] == 100.0
    assert att[tm.SPAN_OVERLAP_EXTERIOR]["device_us"] == 60.0
    assert att[tm.SPAN_OVERLAP_EXTERIOR]["via"] == {"both": 1}
    assert att["step"]["device_us"] == 174.0  # every row launched inside domain.step
    assert att["_unattributed"] == {"device_us": 3.0, "events": 1}
    assert att["_via"] == {"both": 2, "correlation": 2, "none": 1}
    d = device.attribute_exchange_directions(ev)
    assert d["directions"][tm.SPAN_EXCHANGE_Z_LOW]["device_us"] == 14.0
    assert d["coverage"] == 1.0
    json.loads(json.dumps(att))


def test_kineto_overlap_per_stream():
    ov = device.overlap_report(_kineto_events())
    assert ov[tm.SPAN_OVERLAP_INTERIOR]["streams"] == {"7": 100.0}
    assert ov[tm.SPAN_OVERLAP_EXTERIOR]["streams"] == {"13": 60.0}
    assert ov["overlap_us"] == 30.0
    assert ov["overlap_share"] == 0.5
    assert device.overlap_report(_fixture_events()) is None


def test_launches_held_against_counted():
    ev = _kineto_events()
    out = device.launches_held(ev, {"blend_slab": 3, "jacobi_zring_wavefront_step": 1, "stream_plane_pass_mxu": 1})
    pack, jac, plane = ("stencil_tpu_torch/csrc/pack.cu", "stencil_tpu_torch/csrc/jacobi_wavefront.cu",
                        "stencil_tpu_torch/csrc/stream_plane.cu")
    assert out[pack] == {"held": 1, "counted": 3, "short": True}
    assert out[jac] == {"held": 1, "counted": 1, "short": False}
    assert out[plane] == {"held": 1, "counted": 1, "short": False}
    # without a window's counts the held rows alone
    assert device.launches_held(ev)[pack] == {"held": 1, "counted": None, "short": False}
    assert device.kernel_symbol("void (anonymous namespace)::zshell_tile_kernel<float>(float*, ZGeom)") == \
        "zshell_tile_kernel"
    assert device.kernel_family("void at::native::vectorized_elementwise_kernel<4>(int)") is None


def test_kineto_merge_keeps_card_rows():
    ev = _kineto_events()
    host = [{"name": "s", "ph": "X", "ts": 50.0, "dur": 1.0, "pid": 0, "tid": 0, "args": {}}]
    merged = device.merge_device_rows(host, ev)
    rows = [e for e in merged if e.get("pid", 0) >= 1000]
    # the device rows and the card's annotation intervals, shifted onto the host clock
    assert len([e for e in rows if e["ph"] == "X"]) == 7
    assert min(e["ts"] for e in rows if e["ph"] == "X") == 50.0


def _card():
    with gzip.open(CARD_TRACE, "rt", encoding="utf-8") as f:
        return json.load(f)


def test_card_trace_attributes_exchange_and_pack():
    """The trace the H100 wrote (one macro step of the 512^3 z-ring
    wavefront on 2x2x2 under ``--profile-dir``, trimmed to its device,
    scope and launch rows): exchange and pack hold device time, the
    wavefront kernel is the Jacobi family, every row found its scopes, and
    the launches held equal those the wrappers counted in the window."""
    assert os.path.getsize(CARD_TRACE) < 200 * 1024
    doc = _card()
    ev = device.load_trace_events(CARD_TRACE)
    assert device.is_kineto(ev)
    att = device.attribute_device_time(ev)
    assert att["_total"]["events"] > 0
    assert att["exchange"]["device_us"] > 0 and att["pack"]["device_us"] > 0
    assert att["step"]["device_us"] > 0
    assert att["pack"]["device_us"] < att["_total"]["device_us"]
    assert att["_via"].get("none", 0) == 0
    d = device.attribute_exchange_directions(ev)
    assert {s for s, r in d["directions"].items() if r["device_us"] > 0} == {
        tm.SPAN_EXCHANGE_X_LOW, tm.SPAN_EXCHANGE_X_HIGH, tm.SPAN_EXCHANGE_Y_LOW, tm.SPAN_EXCHANGE_Y_HIGH}
    held = device.launches_held(ev, doc["launch_counts"])
    jac, pack = "stencil_tpu_torch/csrc/jacobi_wavefront.cu", "stencil_tpu_torch/csrc/pack.cu"
    assert held[jac]["counted"] == doc["launch_counts"]["jacobi_zring_wavefront_step"]
    assert held[pack]["counted"] == doc["launch_counts"]["blend_slab"]
    assert held[jac]["held"] >= 1 and held[pack]["held"] >= 1
    report = roofline.roofline_report({"counters": doc["counter_deltas"]}, att, chip=doc["device"],
                                      counters_scope="capture")
    assert report["peaks"]["hbm_gbps"] == 3350.0
    assert report["phases"]["exchange"]["gbps"] > 0


# --- the roofline join: equal to the JAX package's -----------------------------


@pytest.fixture
def same_peaks(monkeypatch):
    """Both peak tables hold the same entry, so the joins compare."""
    vals = {"hbm_gbps": 1000.0, "mxu_gflops_f32": 50_000.0, "mxu_gflops_bf16": 100_000.0}
    monkeypatch.setitem(roofline.PEAKS, "Test Card", vals)
    monkeypatch.setitem(jroofline.PEAKS, "Test Card", vals)
    return "Test Card"


@pytest.mark.parametrize("chip", ["Test Card", "cpu", None])
@pytest.mark.parametrize("hbm", [None, 550.0])
def test_roofline_report_equals_jax(same_peaks, chip, hbm):
    snap = json.load(open(os.path.join(FIXTURE, "metrics_0.json")))
    att = jdevice.attribute_device_time(_fixture_events())
    for scope in ("run", "capture"):
        assert roofline.roofline_report(snap, att, chip=chip, measured_hbm_gbps=hbm, counters_scope=scope) == \
            jroofline.roofline_report(snap, att, chip=chip, measured_hbm_gbps=hbm, counters_scope=scope)
    host = roofline.roofline_report(snap, att, source="host")
    assert host == jroofline.roofline_report(snap, att, source="host")
    # the same table; the peaks line names the card's tensor cores where JAX names the MXU
    mine, theirs = roofline.render_markdown(host).splitlines(), jroofline.render_markdown(host).splitlines()
    assert mine[:2] + mine[3:] == theirs[:2] + theirs[3:]


def test_comms_roofline_equals_jax():
    snap = json.load(open(os.path.join(FIXTURE, "metrics_0.json")))
    dirs = jdevice.attribute_exchange_directions(_fixture_events())
    mine = roofline.comms_roofline(dirs, snap)
    assert mine == jroofline.comms_roofline(dirs, snap)
    assert mine["fabric"] is None and mine["bottleneck_axis"] == "z"
    assert roofline.comms_roofline(None, snap) is None
    report = roofline.roofline_report(snap, device.attribute_device_time(_fixture_events()))
    report["comms"] = mine
    md = roofline.render_markdown(report)
    assert "Comms roofline" in md and "Bottleneck: mesh axis `z`" in md


def test_card_peaks():
    p = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert (p["hbm_gbps"], p["mxu_gflops_f32"], p["mxu_gflops_bf16"]) == (3350.0, 165_000.0, 989_000.0)
    assert p["hbm_source"] == "nominal"
    assert p["mxu_gflops_f32"] == pytest.approx(495_000.0 / 3)
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3", measured_hbm_gbps=2900.0)["hbm_source"] == "measured"
    for other in ("NVIDIA H100 PCIe", "cpu", None):
        assert roofline.peaks_for(other)["hbm_gbps"] is None
        assert roofline.peaks_for(other)["mxu_gflops_f32"] is None


class _Snap:
    """A capture stand-in: one attribution and window deltas, for both
    ``capture_report``s."""

    def __init__(self, att, deltas):
        self.att, self.deltas = att, deltas

    def attribution(self):
        return copy.deepcopy(self.att)

    def counters_snapshot(self):
        return None if self.deltas is None else {"counters": dict(self.deltas)}


@pytest.mark.parametrize("deltas", [None, {tm.EXCHANGE_BYTES: 6_291_456, tm.KERNEL_MXU_FLOPS: 4_194_304_000}])
def test_capture_report_equals_jax(same_peaks, deltas):
    from stencil_tpu import telemetry as jtelemetry

    att = jdevice.attribute_device_time(_fixture_events())
    cap = _Snap(att, deltas)
    telemetry.reset()
    jtelemetry.reset()
    mine = roofline.capture_report(cap, chip=same_peaks, measured_hbm_gbps=800.0)
    assert mine == jroofline.capture_report(cap, chip=same_peaks, measured_hbm_gbps=800.0)
    assert mine["counters_scope"] == ("run" if deltas is None else "capture")
    empty = _Snap({"_total": {"device_us": 0.0, "events": 0}}, deltas)
    assert roofline.capture_report(empty) is None


# --- ProfileCapture -------------------------------------------------------------


def test_capture_cadence():
    for every, n, want in ((0, 4, [True, False, False, False]), (3, 7, [True, False, False, True, False, False, True])):
        mine, theirs = device.ProfileCapture("d", every=every), jdevice.ProfileCapture("d", every=every)
        assert [mine.want(i) for i in range(n)] == [theirs.want(i) for i in range(n)] == want
    assert device.ProfileCapture("d").capture_dir(7) == jdevice.ProfileCapture("d").capture_dir(7)


def test_capture_from_env(monkeypatch, tmp_path):
    assert device.ProfileCapture.from_env() is None
    monkeypatch.setenv("STENCIL_PROFILE_EVERY", "5")
    prof = device.ProfileCapture.from_env(dir=str(tmp_path))
    assert prof is not None and prof.every == 5
    monkeypatch.setenv("STENCIL_PROFILE_DIR", str(tmp_path / "env"))
    assert device.ProfileCapture.from_env().dir == str(tmp_path / "env")
    for bad in ("sometimes", "-1"):
        monkeypatch.setenv("STENCIL_PROFILE_EVERY", bad)
        with pytest.raises(ValueError, match="STENCIL_PROFILE_EVERY"):
            device.ProfileCapture.from_env(dir=str(tmp_path))


def test_capture_degrades_when_the_profiler_will_not_start(tmp_path, monkeypatch, capsys):
    """A profiler that will not start (one already running) warns once and
    runs the body; the capture is still counted and its event emitted, the
    scopes label while it is open, and nothing is attributed."""
    import stencil_tpu_torch.telemetry.spans as spans_mod

    monkeypatch.setattr(spans_mod, "_trace_unavailable_warned", False)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    prof = device.ProfileCapture(str(tmp_path / "prof"))
    ran = []
    with prof.maybe(0):
        ran.append(telemetry.scoping())
    assert "would not start" in capsys.readouterr().err
    with prof.maybe(1):
        ran.append(telemetry.scoping())  # off the cadence: nothing opened
    assert ran == [True, False]
    assert prof.captures == 1 and os.path.isdir(prof.capture_dir(0))
    assert telemetry.snapshot()["counters"][tm.PROFILE_CAPTURES] == 1
    assert prof.attribution() is None and prof.launches() is None
    assert any(e["event"] == tm.EVENT_PROFILE_CAPTURE for e in telemetry.recent_events())


def test_capture_window_deltas(tmp_path):
    """The roofline's numerator: the counters and the wrappers' launch
    counts at the window's edges, pending hot-path counts flushed first."""
    from stencil_tpu_torch.domain import DistributedDomain
    from stencil_tpu_torch.ops.halo_blend import blend_slab

    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(1)
    dd.add_data("q")
    dd.set_partition(2, 2, 2)
    dd.realize()
    prof = device.ProfileCapture(str(tmp_path / "prof"))
    assert prof.counters_snapshot() is None
    telemetry.inc(tm.EXCHANGE_BYTES, 7000)  # before the window
    dd.exchange()  # pending until a flush
    with prof.maybe(0):
        telemetry.inc(tm.KERNEL_MXU_FLOPS, 300)
        dd.exchange()
        blend_slab.launches += 2  # as a wrapper counts a launch
    telemetry.inc(tm.EXCHANGE_BYTES, 9000)
    snap = prof.counters_snapshot()["counters"]
    assert snap[tm.EXCHANGE_BYTES] == dd.exchange_bytes_total()
    assert snap[tm.KERNEL_MXU_FLOPS] == 300 and snap[tm.EXCHANGE_PACKED_BYTES] == 0
    assert prof.last_launch_deltas == {"blend_slab": 2}
    blend_slab.launches -= 2


def test_scopes_only_while_observed(monkeypatch):
    """With telemetry off and no capture open, the hot path enters no
    profiler scope."""
    entered = []
    monkeypatch.setattr(telemetry, "profiler_scope", lambda name: entered.append(name) or telemetry.NULL_SCOPE)
    from stencil_tpu_torch.domain import DistributedDomain

    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(1)
    dd.add_data("q")
    dd.set_partition(2, 2, 2)
    dd.realize()
    dd.exchange()
    dd.run_step(lambda curr, steps=1: curr)
    assert entered == []
    telemetry.enable()
    dd.exchange()
    dd.run_step(lambda curr, steps=1: curr)
    assert tm.SPAN_EXCHANGE in entered and tm.SPAN_STEP in entered
    assert {tm.SPAN_EXCHANGE_X_LOW, tm.SPAN_EXCHANGE_Z_HIGH} <= set(entered)


# --- the drivers' --profile-dir and --trace, perf_report ----------------------------


def test_driver_profile_dir_degrades_on_cpu(tmp_path, capsys):
    """``jacobi3d.main`` in-process with ``--profile-dir`` (and
    ``STENCIL_PROFILE_EVERY``): the captures are counted and traced (host
    rows only on the CPU), the finalize writes no roofline and says so."""
    from stencil_tpu_torch.bin import jacobi3d

    d = tmp_path / "prof"
    os.environ["STENCIL_PROFILE_EVERY"] = "2"
    try:
        rc = jacobi3d.main(["16", "16", "16", "--no-weak-scale", "--device", "cpu", "--partition", "2,2,2",
                            "--iters", "3", "--profile-dir", str(d)])
    finally:
        del os.environ["STENCIL_PROFILE_EVERY"]
    assert rc == 0
    captured = capsys.readouterr()
    assert captured.out.startswith("jacobi3d,")
    assert "no device rows" in captured.err
    assert telemetry.snapshot()["counters"][tm.PROFILE_CAPTURES] == 2
    assert sorted(os.listdir(d)) == ["capture_000000", "capture_000002"]
    traces = device.find_trace_files(str(d))
    assert len(traces) == 2 and not (d / "roofline.json").exists()
    events = device.load_trace_events(traces[0])
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert tm.SPAN_STEP in names and tm.SPAN_EXCHANGE_X_LOW in names
    assert device.attribute_device_time(events)["_total"]["events"] == 0


def test_driver_trace_flag(tmp_path, capsys):
    from stencil_tpu_torch.bin import jacobi3d

    rc = jacobi3d.main(["16", "16", "16", "--no-weak-scale", "--device", "cpu", "--iters", "2", "--trace",
                        str(tmp_path / "tr")])
    assert rc == 0
    assert len(device.find_trace_files(str(tmp_path / "tr"))) == 1


def test_perf_report_on_a_card_dir(tmp_path, capsys):
    """``bin/perf_report`` over a directory holding the card's trace and a
    metrics snapshot: a device-sourced report with the comms section, the
    ``--json`` artifact the ledger ingests, and the host-span fallback."""
    from stencil_tpu_torch.bin import perf_report
    from stencil_tpu_torch.telemetry.ledger import entries_from_artifact

    doc = _card()
    work = tmp_path / "telem"
    (work / "prof").mkdir(parents=True)
    shutil.copy(CARD_TRACE, work / "prof" / "card.pt.trace.json.gz")
    (work / "metrics_0.json").write_text(json.dumps({"counters": doc["counter_deltas"]}))
    comms = tmp_path / "comms.json"
    assert perf_report.main([str(work), "--chip", doc["device"], "--json", str(comms)]) == 0
    report = json.load(open(work / "roofline.json"))
    assert report["source"] == "device" and report["phases"]["exchange"]["gbps"] > 0
    assert report["comms"]["hops"][tm.SPAN_EXCHANGE_X_LOW]["gbps"] > 0
    keys = {e["key"] for e in entries_from_artifact(str(comms))}
    assert "exchange_hop:x.low:gbps" in keys and "exchange_hop:coverage" in keys
    keys = {e["key"] for e in entries_from_artifact(str(work / "roofline.json"))}
    assert "roofline:exchange:gbps" in keys
    # the host-span fallback, as the JAX script takes it
    host = tmp_path / "host"
    host.mkdir()
    shutil.copy(os.path.join(FIXTURE, "metrics_0.json"), host)
    shutil.copy(os.path.join(FIXTURE, "trace_0.json"), host)
    assert perf_report.main([str(host)]) == 0
    assert json.load(open(host / "roofline.json"))["source"] == "host"
    assert "HOST spans" in capsys.readouterr().err
    assert perf_report.main([str(tmp_path / "empty")]) == 1


def test_parsers_import_no_torch():
    """``device.py``, ``roofline.py`` and ``ledger.py`` import no torch at
    module import (a dead run's trace parses offline): no module-level
    import of torch, and nothing of the port's that imports it."""
    base = os.path.join(REPO, "stencil_tpu_torch", "telemetry")
    for name in ("device.py", "roofline.py", "ledger.py"):
        with open(os.path.join(base, name)) as f:
            tree = ast.parse(f.read())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not any(m.split(".")[0] == "torch" for m in mods), (name, mods)
        assert all(m in ("__future__", "bisect", "gzip", "json", "os", "re", "time", "typing",
                         "stencil_tpu_torch.telemetry") for m in mods), (name, mods)
