"""The port's autotuner (``stencil_tpu_torch/tune/``) against the JAX
package's (``stencil_tpu/tune/``).

* the workload key, the candidate labels and deeper neighbours, and every
  candidate space against the JAX functions on the same inputs (the port's
  spaces count the JAX package's ``alias=True`` candidates instead of
  generating them);
* the trial protocol: ``measure_alternating`` and ``search`` under one fake
  timer and the same ``STENCIL_FAULT_PLAN`` in both packages, and the port's
  whole-depth dispatch sizing;
* the cache (round trip, corrupt and stale files, the counters,
  ``STENCIL_TUNE=0``), the runners cold and warm on the CPU's plain
  versions, the planners' consults, the drivers' ``--tune`` flags, and
  ``STENCIL_CHECKPOINT_DIGESTS`` against the JAX package.

Every test runs in-process on the CPU at small sizes, each with its own
cache directory (the ``tune_dir`` fixture), so no test reads a user's cache.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu import tune as jtune
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.resilience import inject as jinject
from stencil_tpu.tune import space as jspace
from stencil_tpu.tune.key import WorkloadKey as JKey
from stencil_tpu.tune.trial import measure_alternating as j_measure_alternating
from stencil_tpu.tune.trial import search as j_search
from stencil_tpu_torch import telemetry, tune
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.ops import exchange as ex
from stencil_tpu_torch.resilience import inject
from stencil_tpu_torch.telemetry import names as tm
from stencil_tpu_torch.tune import cache as tune_cache
from stencil_tpu_torch.tune import space
from stencil_tpu_torch.tune.key import WorkloadKey
from stencil_tpu_torch.tune.trial import measure_alternating, search, whole_depth_inner

# several test workers share the host's cores; these small tensors need no
# intra-op threads
torch.set_num_threads(1)


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("STENCIL_TUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("STENCIL_TUNE", raising=False)
    tune.reset_memo()
    jtune.reset_memo()
    yield tmp_path
    tune.reset_memo()
    jtune.reset_memo()


def _counter(name):
    return telemetry.snapshot()["counters"][name]


KEYS = [
    dict(chip="testchip", domain=(16, 16, 16), dtype="float32", n_fields=1, mesh=(1, 1, 1), radius=1,
         route="jacobi-wrap"),
    dict(chip="NVIDIA H100 80GB HBM3", domain=(512, 512, 512), dtype="float32", n_fields=8, mesh=(2, 2, 2),
         radius=3, route="stream"),
    dict(chip="cpu", domain=(511, 17, 64), dtype="bfloat16,float32", n_fields=2, mesh=(1, 1, 8), radius=2,
         route="exchange"),
]


def _key(route="jacobi-wrap", domain=(16, 16, 16)):
    return WorkloadKey(chip="testchip", domain=domain, dtype="float32", n_fields=1, mesh=(1, 1, 1), radius=1,
                       route=route)


# --- key, labels, neighbours ---------------------------------------------------------


@pytest.mark.parametrize("fields", KEYS, ids=[k["route"] for k in KEYS])
def test_workload_key_equals_jax(fields):
    mine, theirs = WorkloadKey(**fields), JKey(**fields)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.digest() == theirs.digest() and len(mine.digest()) == 16
    assert mine.label() == theirs.label()
    assert WorkloadKey.from_dict(mine.to_dict()) == mine
    assert mine.digest() != WorkloadKey(**dict(fields, radius=fields["radius"] + 1)).digest()


def test_labels_and_deeper_neighbors_equal_jax():
    cands, _ = jspace.jacobi_wavefront_space(static_m=4, depth_cap=16, z_ring_eligible=True, static_z_ring=True,
                                             ms=[2, 4, 8, 12], mxu_ok=True, bf16_ok=True, band_ok=True)
    cands = cands + [{"k": 1}, {"k": 8, "x": True}, {"exchange_route": "direct"}]
    for c in cands:
        assert space.candidate_label(c) == jspace.candidate_label(c)
        for depth_key in ("m", "k", None):
            assert (space.deeper_neighbors(c, cands, depth_key)
                    == jspace.deeper_neighbors(c, cands, depth_key)), (c, depth_key)
    assert space._DEPTH_GRID == jspace._DEPTH_GRID


# --- the candidate spaces --------------------------------------------------------------


@pytest.mark.parametrize("static_m", [1, 3, 8])
@pytest.mark.parametrize("depth_cap", [4, 8])
@pytest.mark.parametrize("flags", [(False, False, False, False), (True, True, False, False),
                                   (True, False, True, True), (True, True, True, True)])
def test_wavefront_space_equals_jax_without_alias(static_m, depth_cap, flags):
    ring_ok, ring_static, mxu_ok, bf16_ok = flags
    kw = dict(static_m=static_m, depth_cap=depth_cap, z_ring_eligible=ring_ok, static_z_ring=ring_static,
              mxu_ok=mxu_ok, bf16_ok=bf16_ok, band_ok=mxu_ok)
    want, want_pre = jspace.jacobi_wavefront_space(**kw)
    got, got_pre = space.jacobi_wavefront_space(**kw)
    removed = [c for c in want if c["alias"]]
    assert got == [c for c in want if not c["alias"]]
    assert got_pre == want_pre + len(removed)
    assert not any(c["alias"] for c in got)


def test_wavefront_space_prices_shared_memory():
    """A depth the H100 refuses is counted, never generated, and so are its
    twins; the static depth stays."""
    from stencil_tpu_torch.ops.jacobi_kernels import wavefront_smem_fits

    got, pre = space.jacobi_wavefront_space(8, 24, False, True, ms=[4, 8, 12, 16], mxu_ok=True, bf16_ok=True,
                                            band_ok=True)
    assert wavefront_smem_fits(8) and not wavefront_smem_fits(9)
    assert sorted({c["m"] for c in got}) == [4, 8]
    # 12 and 16: both alias forms; 4 and 8: the alias form
    assert pre == 2 * 2 + 2
    got64, pre64 = space.jacobi_wavefront_space(8, 24, False, True, ms=[4, 8], mxu_ok=False, itemsize=8)
    assert [c["m"] for c in got64 if c["storage_dtype"] == "native" and c["compute_unit"] == "vpu"] == [4, 8]


@pytest.mark.parametrize("shape,dtype", [((64, 32, 32), "float32"), ((48, 16, 24), "float32"),
                                         ((40, 24, 40), "float64"), ((12, 16, 16), "float32")])
def test_wrap_space_equals_jax(shape, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for static_k, ks in ((8, None), (3, [1, 2, 4]), (6, [5, 6, 7])):
        if static_k > shape[0] // 2:
            continue
        want = jspace.jacobi_wrap_space(shape, jdt.itemsize, static_k, ks=ks, dtype=jdt)
        got = space.jacobi_wrap_space(shape, tdt.itemsize, static_k, ks=ks, dtype=tdt)
        assert got == want, (shape, static_k)


def _jax_dd(size, radius, dtypes, storage=None):
    d = JDomain(*size)
    d.set_radius(JRadius.constant(radius))
    if storage:
        d.set_storage(storage)
    for i, dt in enumerate(dtypes):
        d.add_data(f"q{i}", dtype=jnp.dtype(dt))
    d.realize()
    return d


def _port_dd(size, radius, dtypes, storage=None):
    d = DistributedDomain(*size, device="cpu")
    d.set_radius(Radius.constant(radius))
    d.set_subdomains(8)
    if storage:
        d.set_storage(storage)
    for i, dt in enumerate(dtypes):
        d.add_data(f"q{i}", dtype=getattr(torch, dt))
    d.realize()
    return d


@pytest.mark.parametrize("size", [(16, 16, 16), (17, 15, 16), (16, 16, 17)])
@pytest.mark.parametrize("storage", [None, "bf16"])
def test_exchange_space_equals_jax(tune_dir, size, storage):
    j = _jax_dd(size, 1, ["float32"], storage)
    t = _port_dd(size, 1, ["float32"], storage)
    assert tuple(t.grid_dim()) == tuple(j.placement.dim())
    assert space.exchange_space(t) == jspace.exchange_space(j)


@pytest.mark.parametrize("case", [((32, 32, 32), 2, 2, True), ((32, 32, 32), 2, 1, False),
                                  ((16, 16, 16), 1, 1, False), ((24, 24, 24), 3, 1, False)])
def test_stream_space_equals_jax_without_alias_flips(tune_dir, case):
    from stencil_tpu.ops.stream import plan_stream as j_plan_stream
    from stencil_tpu_torch.ops.stream import plan_stream

    size, radius, nq, separable = case
    j = _jax_dd(size, radius, ["float32"] * nq)
    t = _port_dd(size, radius, ["float32"] * nq)
    static = plan_stream(t, 1, "auto", separable)
    assert static == j_plan_stream(j, 1, "auto", separable)  # a geometry where both plans agree
    for mxu_ok in (False, True):
        want, want_pre = jspace.stream_space(j, 1, separable, static, mxu_ok=mxu_ok)
        got, got_pre = space.stream_space(t, 1, separable, static, mxu_ok=mxu_ok)
        flips = [c for c in want if c.get("alias")]
        assert got == [c for c in want if not c.get("alias")]
        assert got_pre == want_pre + len(flips)


# --- the trial protocol ----------------------------------------------------------------


def _fake_runs(log, clock, costs):
    def make(name, cost):
        def run(n):
            log.append((name, n))
            clock[0] += cost * n
        return run
    return [make(name, cost) for name, cost in costs]


@pytest.mark.parametrize("inner", [2, [1, 4]])
def test_measure_alternating_equals_jax(inner):
    out = []
    for fn in (measure_alternating, j_measure_alternating):
        log, clock = [], [0.0]
        samples = fn(_fake_runs(log, clock, [("a", 1.0), ("b", 3.0)]), inner, 0.25, reps=3, timer=lambda: clock[0])
        out.append((samples, log))
    assert out[0] == out[1]
    assert [n for n, _ in out[0][1]] == ["a", "b"] * 4


PLANS = {
    "vmem_oom": "compile:vmem_oom:tune:synthetic:k=4",
    "compile_reject": "compile:compile_reject:tune:synthetic:k=4",
    "transient": "execute:transient:tune:synthetic",
    "none": None,
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_search_equals_jax_under_one_fault_plan(plan, monkeypatch):
    monkeypatch.setenv("STENCIL_RETRY_BACKOFF_S", "0.0")
    candidates = [{"k": 1}, {"k": 4}, {"k": 8}, {"k": 2, "unit": "x"}]
    costs = {1: 3.0, 2: 2.0, 4: 1.0, 8: 0.5}
    out = []
    for srch, inj, key in ((search, inject, _key("synthetic")), (j_search, jinject, JKey(**_key("synthetic").__dict__))):
        clock = [0.0]

        def build_run(cand):
            def run(n):
                clock[0] += costs[cand["k"]] * n
            return run

        inj.set_plan(PLANS[plan])
        try:
            r = srch(key, [dict(c) for c in candidates], build_run, depth_key="k", reps=2, rt=0.0,
                     timer=lambda: clock[0])
        finally:
            inj.set_plan(None)
        out.append((r.config, r.trials, r.pruned, [(x.config, x.pruned, x.failure_class) for x in r.results]))
    assert out[0] == out[1]
    if plan == "vmem_oom":
        assert out[0][0] == {"k": 2, "unit": "x"} and out[0][2] == 2  # k=4 and its deeper neighbour k=8
    elif plan == "compile_reject":
        assert out[0][0] == {"k": 8} and out[0][2] == 1


def test_search_runs_whole_depth_calls():
    """Every dispatch of every candidate, the timed rounds included, runs a
    multiple of each survivor's depth (a k = 12 candidate at the JAX
    package's inner of 4 would run one k = 4 call)."""
    seen = {}

    def build_run(cand):
        def run(n):
            seen.setdefault(cand["k"], []).append(n)
        return run

    cands = [{"k": k} for k in (4, 8, 12, 5)]
    r = search(_key("synthetic"), cands, build_run, depth_key="k", reps=2, rt=0.0)
    assert r.inner == 120 and r.trials == 4
    for k, ns in seen.items():
        # the warm-up, the calibration (the first candidate), the warm-up at
        # the rounds' size and the rounds
        assert all(n == 120 for n in ns) and len(ns) >= 4, (k, ns)
    assert whole_depth_inner(4, [{"m": 1}, {"m": 3}, {"m": 2}], "m") == 6
    assert whole_depth_inner(7, [{"exchange_route": "direct"}], None) == 7


def test_search_retries_a_transient_mid_measurement(monkeypatch):
    monkeypatch.setenv("STENCIL_RETRY_MAX", "3")
    monkeypatch.setenv("STENCIL_RETRY_BACKOFF_S", "0.0")
    calls = {"n": 0}

    def build_run(cand):
        def run(n):
            calls["n"] += 1
            if calls["n"] == 4:  # inside the timed rounds
                raise RuntimeError("UNAVAILABLE: connection reset by peer")
        return run

    r = search(_key("synthetic"), [{"k": 1}], build_run, reps=2, rt=0.0)
    assert r.config == {"k": 1} and r.trials == 1


def test_kernel_build_error_prunes_as_compile_reject():
    from stencil_tpu_torch.kernels.build import KernelBuildError

    def build_run(cand):
        if cand["k"] == 2:
            raise KernelBuildError("nvcc failed")
        return lambda n: None

    r = search(_key("synthetic"), [{"k": 1}, {"k": 2}, {"k": 3}], build_run, depth_key="k", reps=1, rt=0.0)
    assert r.result_for({"k": 2}).failure_class == "compile_reject"
    assert not r.result_for({"k": 3}).pruned and r.trials == 2


# --- the cache -------------------------------------------------------------------------


def test_cache_round_trip_and_stamp(tune_dir):
    k = _key()
    assert tune_cache.load(k) is None
    path = tune_cache.store(k, {"k": 12}, meta={"trials": 3})
    assert os.path.dirname(path) == str(tune_dir) and os.path.basename(path) == f"{k.digest()}.json"
    cfg, meta = tune_cache.load(k)
    assert cfg == {"k": 12} and meta["trials"] == 3
    doc = json.load(open(path))
    assert doc["schema"] == tune_cache.SCHEMA == 2
    assert doc["torch"] == torch.__version__ and doc["cuda"] == torch.version.cuda
    assert "jax" not in doc


def test_cache_default_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("STENCIL_TUNE_CACHE", raising=False)
    assert tune_cache.cache_dir() == os.path.expanduser(os.path.join("~", ".cache", "stencil_tpu_torch", "tune"))


def test_cache_corrupt_file_is_a_miss(tune_dir):
    k = _key()
    tune_cache.store(k, {"k": 12})
    with open(tune_cache.path_for(k), "w") as f:
        f.write("{ not json")
    assert tune_cache.load(k) is None


@pytest.mark.parametrize("field,value", [("torch", "0.0.0-other"), ("cuda", "0.0"), ("schema", 1)])
def test_cache_stale_toolchain_or_schema_is_a_miss(tune_dir, field, value):
    k = _key()
    p = tune_cache.store(k, {"k": 12})
    doc = json.load(open(p))
    doc[field] = value
    json.dump(doc, open(p, "w"))
    assert tune_cache.load(k) is None
    assert json.load(open(p))["config"] == {"k": 12}  # the file itself is intact


def test_a_jax_written_entry_is_stale_here(tune_dir):
    """The two packages stamp their files with their own toolchains: the same
    key's digest names the same file, and each reads the other's as a miss."""
    fields = dict(KEYS[0])
    jtune.record_config(JKey(**fields), {"k": 3})
    assert os.path.exists(tune_cache.path_for(WorkloadKey(**fields)))
    assert tune_cache.load(WorkloadKey(**fields)) is None


def test_best_config_counts_hits_and_misses(tune_dir):
    k = _key()
    h0, m0 = _counter(tm.TUNE_CACHE_HIT), _counter(tm.TUNE_CACHE_MISS)
    assert tune.best_config(k) is None
    assert _counter(tm.TUNE_CACHE_MISS) == m0 + 1
    tune.record_config(k, {"k": 9})
    assert tune.best_config(k) == {"k": 9}
    assert _counter(tm.TUNE_CACHE_HIT) == h0 + 1


def test_best_config_disabled_counts_nothing(tune_dir, monkeypatch):
    k = _key()
    tune.record_config(k, {"k": 9})
    h0, m0 = _counter(tm.TUNE_CACHE_HIT), _counter(tm.TUNE_CACHE_MISS)
    monkeypatch.setenv("STENCIL_TUNE", "0")
    assert tune.best_config(k) is None
    assert (_counter(tm.TUNE_CACHE_HIT), _counter(tm.TUNE_CACHE_MISS)) == (h0, m0)
    monkeypatch.setenv("STENCIL_TUNE", "1")
    assert tune.best_config(k) == {"k": 9}
    with tune.disabled():
        assert tune.best_config(k) is None
    monkeypatch.setenv("STENCIL_TUNE", "maybe")
    with pytest.raises(ValueError, match="STENCIL_TUNE"):
        tune.best_config(k)


def test_ensure_when_every_candidate_is_pruned_returns_static(tune_dir):
    inject.set_plan("compile:compile_reject:tune:synthetic*2")
    try:
        r = tune.ensure(_key("synthetic"), [{"k": 1}, {"k": 2}], lambda c: (lambda n: None),
                        static={"k": 1}, reps=1, rt=0.0)
    finally:
        inject.set_plan(None)
    assert r.source == "static" and r.config == {"k": 1} and r.cache_path is None
    assert tune.best_config(_key("synthetic")) is None


# --- the runners on the CPU's plain versions ------------------------------------------


def test_autotune_jacobi_wrap_cold_then_warm(tune_dir):
    from stencil_tpu_torch.tune.runners import autotune_jacobi_wrap

    t0, s0 = _counter(tm.TUNE_TRIALS), _counter(tm.TUNE_SELECTED)
    r1 = autotune_jacobi_wrap(16, 16, 16, device="cpu", reps=1, ks=[1, 2], rt=0.0)
    assert r1.source == "search" and r1.config is not None and 1 <= r1.config["k"] <= 8
    assert r1.static_config == {"k": 8, "compute_unit": "vpu", "storage_dtype": "native"}
    assert r1.trials == 7 and _counter(tm.TUNE_TRIALS) == t0 + 7 and _counter(tm.TUNE_SELECTED) == s0 + 1
    assert r1.inner % 8 == 0 and os.path.exists(r1.cache_path)
    t1, h1 = _counter(tm.TUNE_TRIALS), _counter(tm.TUNE_CACHE_HIT)
    tune.reset_memo()  # the second run reads the file
    r2 = autotune_jacobi_wrap(16, 16, 16, device="cpu", reps=1, ks=[1, 2], rt=0.0)
    assert r2.cache_hit and r2.trials == 0 and r2.config == r1.config
    assert _counter(tm.TUNE_TRIALS) == t1 and _counter(tm.TUNE_CACHE_HIT) == h1 + 1
    # the model built after it resolves the tuned depth and unit
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    m = Jacobi3D(16, 16, 16, kernel_impl="cuda", device="cpu")
    m.realize()
    assert m._wrap_k == r1.config["k"] and m._compute_unit == r1.config["compute_unit"]
    assert m.dd.storage_dtype() == r1.config["storage_dtype"]


def test_autotune_jacobi_wavefront_and_exchange_cold_then_warm(tune_dir):
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.tune.runners import autotune_exchange, autotune_jacobi_wavefront

    r = autotune_jacobi_wavefront(16, 16, 16, device="cpu", partition=(2, 2, 2), reps=1, ms=[1, 2], rt=0.0)
    assert r.source == "search" and r.config["m"] in (1, 2, 3) and not r.config["alias"]
    assert all(r.inner % x.config["m"] == 0 for x in r.results)
    assert autotune_jacobi_wavefront(16, 16, 16, device="cpu", partition=(2, 2, 2), reps=1, ms=[1, 2],
                                     rt=0.0).trials == 0
    m = Jacobi3D(16, 16, 16, kernel_impl="cuda", pallas_path="wavefront", device="cpu")
    m.dd.set_partition(2, 2, 2)
    m.realize()
    assert m._wavefront_m == r.config["m"] and m._tuned_wavefront == r.config
    dd = _port_dd((16, 16, 16), 1, ["float32"])
    before = dd.raw_to_host(dd._handles[0])
    e = autotune_exchange(dd, reps=1, rt=0.0)
    assert e.source == "search" and e.trials == 5 and e.config["exchange_route"] in ex.EXCHANGE_ROUTES
    np.testing.assert_array_equal(dd.raw_to_host(dd._handles[0]), before)
    assert autotune_exchange(dd, reps=1, rt=0.0).trials == 0
    assert _port_dd((16, 16, 16), 1, ["float32"]).exchange_route() == e.config["exchange_route"]


def test_autotune_stream_leaves_the_domain_and_feeds_the_next_step(tune_dir):
    from stencil_tpu_torch.models.astaroth import AstarothSim
    from stencil_tpu_torch.tune.runners import autotune_stream

    sim = AstarothSim(16, 16, 16, num_quantities=2, kernel_impl="cuda", subdomains=8, device="cpu")
    sim.realize()
    before = [sim.dd.raw_to_host(h) for h in sim.handles]
    r = autotune_stream(sim.dd, sim._kernel, x_radius=1, separable=True, reps=1, rt=0.0,
                        mxu_kernel=sim._kernel_mxu)
    assert r.source == "search" and r.trials >= 4 and not any(x.pruned for x in r.results)
    for h, b in zip(sim.handles, before):
        np.testing.assert_array_equal(sim.dd.raw_to_host(h), b)
    sim2 = AstarothSim(16, 16, 16, num_quantities=2, kernel_impl="cuda", subdomains=8, device="cpu")
    sim2.realize()
    plan = sim2._step._stream_plan
    for axis in ("route", "m", "grouping", "overlap", "halo", "compute_unit"):
        assert plan[axis] == r.config[axis], axis


# --- the drivers -----------------------------------------------------------------------


def test_driver_tune_flags(tune_dir, tmp_path):
    import argparse

    from stencil_tpu_torch.bin import _common

    p = argparse.ArgumentParser()
    _common.add_tune_flags(p)
    args = p.parse_args(["--no-tune", "--tune-cache", str(tmp_path / "c")])
    _common.tune_begin(args)
    try:
        assert not tune.enabled()
        assert tune_cache.cache_dir() == str(tmp_path / "c")
    finally:
        _common.tune_end(args)
    assert tune.enabled() and tune_cache.cache_dir() == str(tune_dir)
    with pytest.raises(SystemExit):
        p.parse_args(["--tune", "--no-tune"])


def test_jacobi3d_driver_tunes_then_warm_then_no_tune(tune_dir, tmp_path, capsys):
    from stencil_tpu_torch.bin import jacobi3d

    cache = str(tmp_path / "drv")
    argv = ["16", "16", "16", "--no-weak-scale", "--device", "cpu", "--iters", "2", "--tune", "--tune-cache", cache]
    assert jacobi3d.main(argv) == 0
    err = capsys.readouterr()
    assert "tune[jacobi-wrap]: source=search" in err.err and err.out.startswith("jacobi3d,")
    assert len(os.listdir(cache)) == 1 and tune_cache.cache_dir() == str(tune_dir)
    assert jacobi3d.main(argv) == 0
    assert "source=cache" in capsys.readouterr().err
    assert jacobi3d.main(argv[:-3] + ["--no-tune"]) == 0
    assert tune.enabled()
    # the torch engine tunes the exchange route
    assert jacobi3d.main(["16", "16", "16", "--no-weak-scale", "--device", "cpu", "--iters", "1", "--partition",
                          "2,2,2", "--kernel-impl", "torch", "--tune", "--tune-cache", cache]) == 0
    assert "tune[exchange]: source=search" in capsys.readouterr().err


def test_astaroth_driver_tune(tune_dir, tmp_path, capsys):
    from stencil_tpu_torch.bin import astaroth_sim

    cache = str(tmp_path / "ast")
    argv = ["--x", "16", "--y", "16", "--z", "16", "--quantities", "2", "--partition", "2,2,2", "--device", "cpu",
            "--iters", "1", "--tune", "--tune-cache", cache]
    assert astaroth_sim.main(argv) == 0
    assert "tune[stream]: source=search" in capsys.readouterr().err
    assert astaroth_sim.main(argv) == 0
    assert "tune[stream]: source=cache (warm; zero trials)" in capsys.readouterr().err
    assert astaroth_sim.main(argv[:-3] + ["--schedule", "per-step", "--tune"]) == 0
    assert "--tune has no effect with --schedule per-step" in capsys.readouterr().err


# --- the checkpoint-digest knob against the JAX package --------------------------------


@pytest.mark.parametrize("knob", [None, "1", "0"])
def test_checkpoint_digest_knob_equals_jax(tmp_path, monkeypatch, knob):
    from stencil_tpu.io import checkpoint as jck
    from stencil_tpu_torch.io import checkpoint as ck

    if knob is None:
        monkeypatch.delenv("STENCIL_CHECKPOINT_DIGESTS", raising=False)
    else:
        monkeypatch.setenv("STENCIL_CHECKPOINT_DIGESTS", knob)
    want_raw = knob != "0"
    t = _port_dd((16, 16, 16), 1, ["float32"])
    j = _jax_dd((16, 16, 16), 1, ["float32"])
    ck.save_checkpoint(t, str(tmp_path / "npz"), step=1, backend="npz")
    jck.save_checkpoint(j, str(tmp_path / "jnpz"), step=1, backend="npz")
    ck.save_checkpoint(t, str(tmp_path / "raw"), step=1, backend="raw")
    for path in ("npz", "jnpz"):
        meta = json.load(open(tmp_path / path / "MANIFEST.json"))
        assert all(q["digest"] for q in meta["quantities"]), path  # npz always digests, in both packages
    meta = json.load(open(tmp_path / "raw" / "MANIFEST.json"))
    assert all(bool(q["digest"]) == want_raw for q in meta["quantities"])
    assert ck.validate_checkpoint(str(tmp_path / "raw"))["step"] == 1
    # the knob reads as the JAX package reads it for its orbax backend
    from stencil_tpu.utils.config import env_bool as jenv_bool
    from stencil_tpu_torch.utils.config import env_bool

    assert env_bool("STENCIL_CHECKPOINT_DIGESTS", True) == jenv_bool("STENCIL_CHECKPOINT_DIGESTS", True) == want_raw
