"""The port's perf ledger (``stencil_tpu_torch/telemetry/ledger.py``,
``bin/perf_ledger.py``) against the JAX package's.

* every artifact shape the JAX ledger reads (the committed ``BENCH_r*.json``
  as parse fixtures, synthetic raw and judge-wrapped bench results, a
  weak-scaling sweep, a comms roofline, soak and serve summaries, a
  ``bench_exchange`` route A/B) gives the same entries in both;
* ``append_entries`` / ``read_ledger`` and ``check_regressions`` give the
  same ledger and the same verdicts on the same entries;
* the port's own artifacts: a drivers' ``roofline.json`` (device-timed
  only) and ``bench_pack``'s lines; a fabric probe's artifact, which the
  port does not read yet, is pinned as unrecognized;
* the CLI in-process: ingest, show, check and its exit codes, as the JAX
  script's.
"""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest

from stencil_tpu.telemetry import ledger as jledger
from stencil_tpu_torch.bin import perf_ledger
from stencil_tpu_torch.telemetry import ledger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_ARTIFACTS = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json")))


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jperf_ledger", os.path.join(REPO, "scripts", "perf_ledger.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(tmp_path, name, doc, mtime=None):
    p = tmp_path / name
    p.write_text(doc if isinstance(doc, str) else json.dumps(doc))
    if mtime is not None:
        os.utime(p, (mtime, mtime))
    return str(p)


def _artifacts(tmp_path):
    """One synthetic artifact of every shape both ledgers read."""
    bench = {"metric": "jacobi3d_mcells_per_s_per_chip", "value": 123.5, "unit": "Mcells/s",
             "exchange_path_mcells_per_s_per_chip": 50.0, "astaroth_8q_mupdates_per_s": 7.0,
             "chip_copy_gbps": 700.0, "tune": {"config": {"k": 8}, "source": "cache"},
             "mxu_vs_vpu": {"k": 4, "units": {"vpu": {"mcells_per_s": 10.0}, "mxu": {"mcells_per_s": 2.0}}},
             "numerics_overhead": {"snapshot_ms": 1.5, "quantities": 1}}
    docs = {
        "bench.json": bench,
        "judge.json": {"parsed": dict(bench, value=99.0)},
        "tail.json": {"parsed": None, "tail": "noise\n" + json.dumps(dict(bench, value=77.0)) + "\n"},
        "weak.json": {"bench": "weak_scaling_sweep", "meshes": [
            {"mesh": [2, 2, 1], "chips": 4, "mcells_per_s_per_chip": {"off": 10.0, "split": 12.0},
             "exchange_hops": [{"axis": "x", "side": "low", "bytes": 4096, "source": "analytic"}]}]},
        "comms.json": {"bench": "comms_roofline", "coverage": 0.93, "bottleneck_axis": "z", "hops": {
            "exchange.z.low": {"axis": "z", "direction": "low", "gbps": 12.5, "probed_gbps": None,
                               "device_ms": 0.3}}},
        "soak.json": {"bench": "soak_kill_resume", "bitwise_identical": True, "recovery_seconds": 4.0,
                      "kills": [1, 2], "reshard_seconds": [0.5, 0.7, 0.6]},
        "soak_bad.json": {"bench": "soak_kill_resume", "bitwise_identical": False, "recovery_seconds": 4.0},
        "serve.json": {"bench": "serve_soak", "isolation_ok": True, "p99_ms": 30.0, "shed_rate": 0.01,
                       "tenants": ["a"], "requests": 100, "throughput": {"requests_per_s": 5.0}},
        "exchange.json": {"bench": "exchange", "extent": 64, "quantities": 2, "route_ab": {
            "routes": {"direct": {"ms_per_exchange": 2.0}}, "speedup_vs_direct": {"zpack_pallas": 1.1}}},
        "unknown.json": {"bench": "something_else"},
        "list.json": [1, 2, 3],
    }
    return {name: _write(tmp_path, name, doc, mtime=1_700_000_000 + i) for i, (name, doc) in enumerate(docs.items())}


def test_entries_equal_jax_on_every_shape(tmp_path):
    paths = _artifacts(tmp_path)
    for name, path in paths.items():
        assert ledger.entries_from_artifact(path) == jledger.entries_from_artifact(path), name
    assert ledger.entries_from_artifact(paths["unknown.json"]) == []
    assert ledger.entries_from_artifact(paths["soak_bad.json"]) == []
    assert {e["key"] for e in ledger.entries_from_artifact(paths["comms.json"])} == {
        "exchange_hop:z.low:gbps", "exchange_hop:coverage"}
    assert ledger.entries_from_artifact(str(tmp_path / "absent.json")) == []


@pytest.mark.parametrize("path", BENCH_ARTIFACTS, ids=os.path.basename)
def test_committed_bench_artifacts_parse_as_jax(path):
    assert ledger.entries_from_artifact(path) == jledger.entries_from_artifact(path)


def test_append_and_read_equal_jax(tmp_path):
    entries = []
    for path in _artifacts(tmp_path).values():
        entries += ledger.entries_from_artifact(path)
    mine, theirs = tmp_path / "mine.jsonl", tmp_path / "theirs.jsonl"
    assert ledger.append_entries(str(mine), entries) == jledger.append_entries(str(theirs), entries) > 0
    assert mine.read_text() == theirs.read_text()
    # idempotent re-ingest; a crash-truncated last line is skipped alike
    assert ledger.append_entries(str(mine), entries) == 0
    with open(mine, "a") as f:
        f.write('{"key": "trunc')
    assert ledger.read_ledger(str(mine)) == jledger.read_ledger(str(mine)) == jledger.read_ledger(str(theirs))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("threshold,window", [(0.10, 5), (0.02, 2), (0.5, 10)])
def test_check_regressions_equal_jax(seed, threshold, window):
    """Seeded series (some lower-is-better, some single-entry, non-numeric
    values mixed in): the same rows and the same regressions."""
    rng = np.random.default_rng(seed)
    entries = []
    for k in range(int(rng.integers(1, 6))):
        better = "lower" if rng.random() < 0.3 else None
        for i in range(int(rng.integers(1, 9))):
            e = {"ts": float(i), "key": f"s{k}", "value": float(rng.uniform(50, 150)), "unit": "x",
                 "source": f"r{i}"}
            if better:
                e["better"] = better
            entries.append(e)
    entries.append({"key": "bad", "value": "n/a"})
    assert ledger.check_regressions(entries, threshold, window) == \
        jledger.check_regressions(entries, threshold, window)


def test_roofline_json_series(tmp_path):
    """A drivers' ``roofline.json``: one GB/s or GFLOP/s series a device-timed
    phase, higher is better; a host-span stand-in lands nothing."""
    report = {"source": "device", "counters_scope": "capture", "peaks": {"chip": "NVIDIA H100 80GB HBM3"},
              "phases": {"exchange": {"gbps": 812.5, "gflops": None, "device_ms": 0.2},
                         "mxu": {"gbps": None, "gflops": 120000.0, "device_ms": 18.4},
                         "step": {"gbps": None, "gflops": None, "device_ms": 2.6}}}
    path = _write(tmp_path, "roofline.json", report)
    got = {e["key"]: e for e in ledger.entries_from_artifact(path)}
    assert set(got) == {"roofline:exchange:gbps", "roofline:mxu:gflops"}
    assert got["roofline:exchange:gbps"]["value"] == 812.5
    assert got["roofline:mxu:gflops"]["chip"] == "NVIDIA H100 80GB HBM3"
    assert jledger.entries_from_artifact(path) == []  # the JAX ledger reads no roofline.json
    host = _write(tmp_path, "host_roofline.json", dict(report, source="host"))
    assert ledger.entries_from_artifact(host) == []


def test_bench_pack_lines(tmp_path):
    """``bench_pack``'s printed lines saved to a file: one GB/s series a face
    (the pack/unpack form and the round-trip form); other text is skipped."""
    from stencil_tpu_torch.bin import bench_pack

    text = "\n".join([
        "[512,512,512] [1,0,0] 3145728 4.1e-05 3.9e-05 80.66GB/s",
        "[512,512,512] [0,0,1] 3145728 roundtrip 8.3e-05 75.80GB/s",
        "INFO something else",
    ])
    path = _write(tmp_path, "bench_pack.txt", text)
    got = ledger.entries_from_artifact(path)
    assert [(e["key"], e["value"], e["bytes"]) for e in got] == [
        ("bench_pack:[512,512,512]:[1,0,0]:gbps", 80.66, 3145728),
        ("bench_pack:[512,512,512]:[0,0,1]:roundtrip_gbps", 75.8, 3145728)]
    assert jledger.entries_from_artifact(path) == []
    # the lines bench_pack prints parse
    assert bench_pack.FACES and len(got) == 2


def test_fabric_artifacts_not_read_yet(tmp_path):
    """The fabric probe is not ported (the multi-card port): its artifact is
    an unknown shape to the port's ledger."""
    doc = {"bench": "fabric_probe", "chip": "x", "links": [{"axis": "z", "side": "low", "gbps": 50.0}]}
    assert ledger.entries_from_artifact(_write(tmp_path, "fabric.json", doc)) == []


def test_cli_equals_jax(tmp_path, capsys):
    """ingest, show and check in-process: the same ledger file, the same
    table and the same exit codes as the JAX script."""
    paths = _artifacts(tmp_path)
    jcli = _jax_cli()
    mine, theirs = str(tmp_path / "mine.jsonl"), str(tmp_path / "theirs.jsonl")
    arts = [paths[n] for n in ("bench.json", "judge.json", "weak.json", "serve.json")]
    assert perf_ledger.main(["--ledger", mine, "ingest", *arts, str(tmp_path / "nothing*.json")]) == 0
    assert jcli.main(["--ledger", theirs, "ingest", *arts, str(tmp_path / "nothing*.json")]) == 0
    assert open(mine).read() == open(theirs).read()
    capsys.readouterr()
    for argv in (["show"], ["check"], ["check", "--json"], ["check", "--threshold", "0.5", "--window", "2"]):
        rc_mine = perf_ledger.main(["--ledger", mine, *argv])
        out_mine = capsys.readouterr().out
        rc_theirs = jcli.main(["--ledger", theirs, *argv])
        assert (rc_mine, out_mine) == (rc_theirs, capsys.readouterr().out), argv
    # the bench series regressed (123.5 -> 99.0): check exits 1
    assert perf_ledger.main(["--ledger", mine, "check"]) == 1
    assert perf_ledger.main(["--ledger", str(tmp_path / "empty.jsonl"), "show"]) == 2
