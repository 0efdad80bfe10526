"""The port's scaling and exchange drivers (``bin/weak.py``, ``strong.py``,
``weak_exchange.py``, ``bench_exchange.py``) against the JAX package's, on
the CPU.

* schema: each of ``tests/test_drivers.py``'s asserts on ``weak``,
  ``strong``, their ``--overlap`` documents, ``weak_exchange`` and
  ``bench_exchange``, held on the port's CLI with ``--partition 2,2,2``
  (or ``--mesh``) where the JAX test ran on conftest's 8 fake devices;
* CSV parity: from the same argv, the rows' name, methods, x, y, z, s,
  MPI(B), the three zero columns and iters equal the JAX rows;
* bench-exchange parity: each radius shape's name, modelled and swept bytes
  from ``bench()``, ``_route_measured_axes`` of every route, and
  ``route_ab``'s routes, ``packed_eligible`` and ``shared_legs_with_direct``
  against what the JAX package's ``route_supported`` and
  ``_route_measured_axes`` give (its timed ``route_ab`` is not run);
* ``DistributedDomain.make_exchange_route_fn(route, axes)``: every route and
  axis on 2x2x2 with two seeded quantities, raw arrays bitwise equal to the
  JAX domain's ``make_exchange_route_fn(route, donate=False, axes=...)``;
* the overlap A/B: ``overlap_domain_size`` over a table of arguments, the
  exchange section's bytes and per-hop table against a JAX domain's
  ``_hop_table``, and one ``off`` and one ``split`` step of
  ``_mean6_kernel`` from one seeded state, interiors bitwise equal to each
  other and to the JAX package's ``make_step(engine="xla")``;
* the refusals: ``--verify``, ``--fabric-probe``, and ``--device cuda``
  without a card;
* ``jacobi3d`` and ``astaroth_sim`` print the method strings they printed
  before their flag helpers moved into ``bin/_common.py``.

Every comparison is exact.  JAX's weak ``--overlap`` run is not an oracle
(``tests/test_drivers.py::test_weak_overlap_ab`` fails on its own).
"""

import argparse
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.bin import _common as jcommon
from stencil_tpu.bin import bench_exchange as jbe
from stencil_tpu.bin import strong as jstrong
from stencil_tpu.bin import weak as jweak
from stencil_tpu.bin import weak_exchange as jweak_exchange
from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.ops import exchange as jex
from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.bin import bench_exchange as be
from stencil_tpu_torch.bin import strong, weak, weak_exchange
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.ops import exchange as ex

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
P222 = ["--partition", "2,2,2"]


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert out, "driver printed nothing"
    return out


# --- schema (tests/test_drivers.py) -------------------------------------------------


def test_weak(capsys):
    assert weak.main(["12", "12", "12", "2"] + P222 + CPU) == 0
    row = _lines(capsys)[-1].split(",")
    assert row[0] == "weak"
    assert len(row) == 23  # weak.cu:184-188 column layout
    x, y, z, s = (int(v) for v in row[2:6])
    assert x * y * z == s
    assert int(row[6]) > 0  # the exchange's bytes in the MPI(B) column
    assert float(row[21]) > 0  # accumulated exchange seconds
    assert row[11:14] == ["1", "1", "1"]  # gpus, nodes, ranks: the one card


def test_strong(capsys):
    assert strong.main(["16", "16", "16", "2"] + P222 + CPU) == 0
    row = _lines(capsys)[-1].split(",")
    assert row[0] == "strong"
    assert len(row) == 23
    assert row[2:5] == ["16", "16", "16"]  # NOT weak-scaled


def _overlap_doc(capsys, main, argv):
    assert main(argv + CPU) == 0
    return json.loads(_lines(capsys)[-1])


def test_weak_overlap_ab(capsys, tmp_path):
    path = tmp_path / "weak_221.json"
    doc = _overlap_doc(capsys, weak.main, ["12", "12", "12", "1", "--overlap", "--mesh", "2,2,1", "--ab-reps", "1",
                                           "--json", str(path)])
    assert doc["bench"] == "weak_overlap" and doc["dryrun"] is True and doc["card"] is None
    assert doc["mesh"] == [2, 2, 1] and doc["chips"] == 4
    # per-axis weak scaling: 12^3 a subdomain stays exact on the non-cubic mesh
    assert doc["global"] == [24, 24, 12]
    assert doc["cells_per_chip"] == 12 * 12 * 12
    assert doc["measurement_protocol"]["drop_rep0"] is True
    assert doc["measurement_protocol"]["alternating_within_process"] is True
    for ov in ("off", "split"):
        assert doc["overlap"][ov]["mcells_per_s"] > 0
        assert doc["plans"][ov]["overlap"] == ov
    assert doc["split_speedup"] > 0
    assert doc["exchange"]["ms_per_exchange"] > 0
    assert json.loads(path.read_text()) == doc


def test_strong_overlap_ab(capsys):
    doc = _overlap_doc(capsys, strong.main, ["16", "16", "16", "1", "--overlap", "--mesh", "2,1,1", "--ab-reps", "1"])
    assert doc["bench"] == "strong_overlap"
    assert doc["mesh"] == [2, 1, 1] and doc["global"] == [16, 16, 16]


def test_weak_exchange(capsys):
    assert weak_exchange.main(["12", "12", "12", "2"] + P222 + CPU) == 0
    row = _lines(capsys)[-1].split(",")
    assert row[0] == "weak"
    assert len(row) == 15
    assert float(row[-1]) > 0  # one wall-clock elapsed


def test_bench_exchange(capsys):
    assert be.main(["--iters", "2", "--x", "12", "--y", "12", "--z", "12", "--ab-reps", "1"] + P222 + CPU) == 0
    out = _lines(capsys)
    assert out[0] == "name,count,trimean (S),trimean (B/s),stddev,min,avg,max,trimean (B/s swept)"
    # header + 5 radius shapes (bench_exchange.cu:121-195) + the JSON line
    assert len(out) == 7
    for line in out[1:6]:
        cols = line.split(",")
        assert float(cols[2]) > 0 and float(cols[3]) > 0
        assert float(cols[8]) >= float(cols[3])  # the sweeps move full-extent slabs
    doc = json.loads(out[6])
    assert doc["card"] is None
    ab = doc["route_ab"]
    assert ab["measurement_protocol"]["drop_rep0"] is True
    for entry in ab["routes"].values():
        assert entry["ms_per_exchange"] > 0
        assert set(entry["per_axis_ms"]) == {"x", "y", "z"}
    assert ab["packed_eligible"]
    packed = {"zpack_xla", "zpack_pallas", "yzpack_xla", "yzpack_pallas"}
    assert set(ab["routes"]) == {"direct"} | packed
    assert set(ab["speedup_vs_direct"]) == packed
    assert ab["measurement_protocol"]["shared_legs_with_direct"] == {
        "zpack_xla": ["x", "y"], "zpack_pallas": ["x", "y"], "yzpack_xla": ["x"], "yzpack_pallas": ["x"],
    }


# --- CSV parity with the JAX drivers -----------------------------------------------

METHOD_ARGS = {
    "none": [],
    "staged": ["--staged"],
    "peer_kernel": ["--peer", "--kernel"],
    "all_naive": ["--cuda-aware", "--colo", "--staged", "--peer", "--kernel", "--naive"],
}
CSV_DRIVERS = {
    "weak": (jweak.main, weak.main, ["12", "12", "12", "2"]),
    "strong": (jstrong.main, strong.main, ["16", "20", "24", "2"]),
    "weak_exchange": (jweak_exchange.main, weak_exchange.main, ["14", "12", "10", "3"]),
}


@pytest.mark.parametrize("methods", sorted(METHOD_ARGS))
@pytest.mark.parametrize("driver", sorted(CSV_DRIVERS))
def test_csv_row_equals_jax(capsys, driver, methods):
    jmain, tmain, argv = CSV_DRIVERS[driver]
    argv = argv + METHOD_ARGS[methods]
    assert jmain(argv) == 0
    want = _lines(capsys)[-1].split(",")
    assert tmain(argv + P222 + CPU) == 0
    got = _lines(capsys)[-1].split(",")
    assert len(got) == len(want)
    # name, methods, x, y, z, s, MPI(B), Colocated, cudaMemcpyPeer, direct, iters
    assert got[:11] == want[:11]
    assert got[1] == (want[1] if methods != "none" else "ppermute")


# --- bench-exchange parity -----------------------------------------------------------

EXT = (12, 12, 12)


@pytest.mark.parametrize("shape", range(5))
def test_bench_bytes_equal_jax(shape):
    jname, jradius = list(jbe.sweep_configs(EXT, 2, 1))[shape]
    name, radius = list(be.sweep_configs(EXT, 2, 1))[shape]
    assert name == jname
    assert (radius.lo().tuple(), radius.hi().tuple()) == (tuple(jradius.lo()), tuple(jradius.hi()))
    _, jbytes, jswept = jbe.bench(1, 2, EXT, jradius)
    _, tbytes, tswept = be.bench(1, 2, EXT, radius, subdomains=8, device="cpu")
    assert (tbytes, tswept) == (jbytes, jswept)
    assert jbytes > 0 and jswept >= jbytes


@pytest.mark.parametrize("route", ex.EXCHANGE_ROUTES)
def test_route_measured_axes_equal_jax(route):
    assert be._route_measured_axes(route) == jbe._route_measured_axes(route)


@pytest.mark.parametrize("fR,n_quants", [(2, 1), (1, 2)])
def test_route_ab_sets_equal_jax(fR, n_quants):
    ab = be.route_ab(EXT, fR, n_quants, reps=1, rt=0.0, subdomains=8, device="cpu")
    # what the JAX package's route_ab engages, without timing it
    x, y, z = jcommon.fit_to_mesh(*EXT, JRadius.constant(fR))
    jd = JDomain(x, y, z)
    jd.set_radius(JRadius.constant(fR))
    for i in range(n_quants):
        jd.add_data(f"d{i}", dtype=jnp.float32)
    jd.realize()
    dtypes = [h.dtype for h in jd._handles]
    routes = [r for r in jex.EXCHANGE_ROUTES if r == "direct" or jex.route_supported(r, dtypes, jd._valid_last)]
    assert ab["fit_extent"] == [x, y, z]
    assert list(ab["routes"]) == routes
    assert ab["packed_eligible"] == (len(routes) > 1)
    shared = {r: [a for a in ("x", "y", "z") if a not in jbe._route_measured_axes(r)] for r in routes if r != "direct"}
    assert ab["measurement_protocol"]["shared_legs_with_direct"] == shared
    for entry in ab["routes"].values():
        assert set(entry["per_axis_ms"]) == {"x", "y", "z"} and entry["ms_per_exchange"] > 0


# --- make_exchange_route_fn ------------------------------------------------------------


def _route_domains(route, size=(16, 16, 16), radius=2, nq=2):
    jd = JDomain(*size)
    jd.set_radius(JRadius.constant(radius))
    jd.set_devices(jax.devices()[:8])
    jd.set_exchange_route(route)
    td = DistributedDomain(*size, device="cpu")
    td.set_radius(Radius.constant(radius))
    td.set_subdomains(8)
    td.set_partition(2, 2, 2)
    td.set_exchange_route(route)
    jh = [jd.add_data(f"q{i}", dtype=jnp.float32) for i in range(nq)]
    th = [td.add_data(f"q{i}", dtype=torch.float32) for i in range(nq)]
    jd.realize()
    td.realize()
    rng = np.random.default_rng(7)
    for a, b in zip(jh, th):
        field = rng.standard_normal(size).astype(np.float32)
        jd.set_quantity(a, field)
        td.set_quantity(b, field)
    return jd, jh, td, th


@pytest.mark.parametrize("axes", [(0,), (1,), (2,), (0, 1, 2)])
@pytest.mark.parametrize("route", ex.EXCHANGE_ROUTES)
def test_route_fn_per_axis_equals_jax(route, axes):
    jd, jh, td, th = _route_domains(route)
    assert tuple(td.grid_dim()) == tuple(jd.placement.dim()) == (2, 2, 2)
    jfn = jd.make_exchange_route_fn(route, donate=False, axes=axes)
    jd._curr = jfn(jd._curr)
    fn = td.make_exchange_route_fn(route, axes=axes)
    before = [td.raw_to_host(h) for h in th]
    out = fn([td.get_curr(h) for h in th])
    assert all(o is td.get_curr(h) for o, h in zip(out, th))  # in place
    for a, b, old in zip(jh, th, before):
        got = td.raw_to_host(b)
        np.testing.assert_array_equal(got, jd.raw_to_host(a))
        assert not np.array_equal(got, old)  # the sweeps wrote
    # in place and idempotent on a filled domain
    fn([td.get_curr(h) for h in th])
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(td.raw_to_host(b), jd.raw_to_host(a))


def test_route_fn_rides_the_compile_fault_hook(monkeypatch):
    """The build of a route function fires ``compile:exchange:<route>``
    inside the transient retry (the JAX package's compile unit)."""
    from stencil_tpu_torch.resilience import inject

    seen = []
    monkeypatch.setattr(inject, "maybe_fail", lambda phase, label: seen.append((phase, label)))
    _, _, td, _ = _route_domains("zpack_xla", nq=1)
    seen.clear()
    td.make_exchange_route_fn("yzpack_pallas", axes=(1,))
    assert seen == [("compile", "compile:exchange:yzpack_pallas")]


# --- the overlap A/B -------------------------------------------------------------------


def _args(x, y, z, halo_mult):
    return argparse.Namespace(x=x, y=y, z=z, halo_mult=halo_mult)


@pytest.mark.parametrize("weak_scale", [True, False])
@pytest.mark.parametrize("mesh", [None, (2, 2, 1), (2, 2, 2)])
def test_overlap_domain_size_equals_jax(mesh, weak_scale):
    for x, y, z in ((12, 12, 12), (16, 20, 24), (30, 17, 9)):
        for hm in (1, 2, 3):
            args = _args(x, y, z, hm)
            for n in ((8, 4, 2, 1) if mesh is None else (mesh[0] * mesh[1] * mesh[2],)):
                want = jweak.overlap_domain_size(args, mesh, jax.devices()[:n], weak_scale)
                assert weak.overlap_domain_size(args, mesh, n, weak_scale) == tuple(want), (x, y, z, hm, n)


def _overlap_args(mesh, quantities=1, halo_mult=2, size=12):
    return argparse.Namespace(x=size, y=size, z=size, halo_mult=halo_mult, mesh=mesh, partition=None,
                              quantities=quantities, exchange_route="auto", trivial=False, device="cpu")


def _jax_overlap_domain(mesh, quantities=1, halo_mult=2, size=12):
    m = weak.parse_mesh(mesh)
    jd = JDomain(size * m[0], size * m[1], size * m[2])
    jd.set_radius(JRadius.constant(1))
    jd.set_devices(jax.devices()[: m[0] * m[1] * m[2]])
    jd.set_partition(*m)
    if halo_mult > 1:
        jd.set_halo_multiplier(halo_mult)
    hs = [jd.add_data(f"d{i}", dtype=jnp.float32) for i in range(quantities)]
    jd.realize()
    return jd, hs


@pytest.mark.parametrize("mesh,quantities", [("2,2,1", 1), ("2,2,2", 2), ("1,2,4", 1)])
def test_overlap_exchange_section_equals_jax(mesh, quantities):
    td = weak.overlap_domain(_overlap_args(mesh, quantities))
    jd, _ = _jax_overlap_domain(mesh, quantities)
    assert td.size().tuple() == tuple(jd.size()) and tuple(td.grid_dim()) == tuple(jd.placement.dim())
    assert td.exchange_bytes_total() == jd.exchange_bytes_total()
    for s in (1.25e-4, 3e-3):
        assert weak._hop_table(td, s) == jweak._hop_table(jd, s)


@pytest.mark.parametrize("halo_mult", [1, 2])
def test_overlap_steps_equal_each_other_and_jax(halo_mult):
    """One ``off`` and one ``split`` step of ``_mean6_kernel`` from one
    seeded state: the interiors bitwise equal to each other and to the
    JAX package's ``make_step(engine="xla")`` (a macro step of
    ``halo_mult`` iterations); the domain's own state is left as it was."""
    td = weak.overlap_domain(_overlap_args("2,2,2", 2, halo_mult))
    jd, jh = _jax_overlap_domain("2,2,2", 2, halo_mult)
    rng = np.random.default_rng(11)
    for i, h in enumerate(td._handles):
        field = rng.random(td.size().tuple()).astype(np.float32)
        td.set_quantity(h, field)
        jd.set_quantity(jh[i], field)
    jstep = jd.make_step(jweak._mean6_kernel, engine="xla")
    jd.run_step(jstep, 1)
    want = [np.asarray(jd.quantity_to_host(h)) for h in jh]
    steps = weak.overlap_steps(td)
    assert steps["split"]._stream_plan["overlap"] == "split" and steps["off"]._stream_plan["overlap"] == "off"
    if halo_mult > 1:
        assert steps["off"]._stream_plan["route"] == "wavefront" and steps["off"]._stream_plan["m"] == halo_mult
    start = {n: t.clone() for n, t in td._curr.items()}
    got = {}
    for ov, step in steps.items():
        curr = {n: t.clone() for n, t in start.items()}
        curr = step(curr, halo_mult)
        keep, td._curr = td._curr, curr
        got[ov] = [td.quantity_to_host(h) for h in td._handles]
        td._curr = keep
    for a, b, w in zip(got["off"], got["split"], want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)
    for n, t in td._curr.items():
        assert torch.equal(t, start[n])


def test_overlap_run_leaves_the_domain(monkeypatch, capsys):
    """``run_overlap`` times steps on copies: the domain it measured holds
    its initial state after the A/B."""
    seen = {}
    real = weak.overlap_domain

    def spy(*a, **k):
        dd = real(*a, **k)
        seen["dd"], seen["start"] = dd, {n: t.clone() for n, t in dd._curr.items()}
        return dd

    monkeypatch.setattr(weak, "overlap_domain", spy)
    doc = _overlap_doc(capsys, weak.main, ["8", "8", "8", "1", "--overlap", "--mesh", "2,2,2", "--ab-reps", "1",
                                           "--quantities", "2"])
    assert doc["chips"] == 8 and doc["quantities"] == 2
    assert doc["plans"]["off"]["route"] == "wavefront" and doc["plans"]["split"]["z_slabs"] is False
    for n, t in seen["dd"]._curr.items():
        # the bare exchange refills the shell in place; the interior holds
        assert torch.equal(seen["dd"]._interior_view(t), seen["dd"]._interior_view(seen["start"][n]))


# --- refusals --------------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["--verify", "--fabric-probe"])
@pytest.mark.parametrize("main", [weak.main, strong.main])
def test_unported_flags_are_refused(capsys, main, flag):
    with pytest.raises(SystemExit) as err:
        main(["12", "12", "12", "1", "--overlap", "--mesh", "2,1,1", flag] + CPU)
    assert err.value.code not in (0, None)
    item = "13" if flag == "--fabric-probe" else "14"
    assert f"item {item}" in str(err.value.code)
    assert capsys.readouterr().out == ""  # nothing measured, nothing printed


@pytest.mark.parametrize("argv", [
    ["--overlap", "--verify"], ["--fabric-probe"],
])
def test_unported_flags_are_refused_before_the_csv(capsys, argv):
    with pytest.raises(SystemExit):
        weak.main(["12", "12", "12", "1"] + argv + CPU)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,argv", [
    ("weak", ["12", "12", "12", "1"]),
    ("weak", ["12", "12", "12", "1", "--overlap"]),
    ("strong", ["12", "12", "12", "1"]),
    ("weak_exchange", ["12", "12", "12", "1"]),
    ("bench_exchange", ["--x", "12", "--y", "12", "--z", "12", "--iters", "1"]),
])
def test_cuda_without_a_card_fails(monkeypatch, capsys, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"weak": weak.main, "strong": strong.main, "weak_exchange": weak_exchange.main,
            "bench_exchange": be.main}[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert "," not in capsys.readouterr().out.replace("name,count", "")  # no row


# --- the flag helpers moved into bin/_common.py ---------------------------------------


@pytest.mark.parametrize("argv,want", [
    ([], "ppermute"), (["--staged"], "staged"), (["--peer", "--kernel"], "peer/kernel"),
    (["--cuda-aware-mpi", "--colo", "--trivial"], "cuda-aware/colo"),
])
def test_jacobi3d_and_astaroth_method_strings(capsys, argv, want):
    from stencil_tpu_torch.bin import astaroth_sim, jacobi3d

    assert jacobi3d.main(["--iters", "1", "--no-weak-scale", "8", "8", "8"] + argv + CPU) == 0
    row = _lines(capsys)[-1].split(",")
    assert row[:2] == ["jacobi3d", want] and row[4:7] == ["8", "8", "8"]
    ast_argv = [{"--staged": "--remote", "--colo": "--colocated", "--peer": "--peer-copy",
                 "--cuda-aware-mpi": "--cuda-aware-mpi"}.get(a, a) for a in argv]
    assert astaroth_sim.main(["--x", "8", "--y", "8", "--z", "8", "--iters", "1"] + ast_argv + CPU) == 0
    row = _lines(capsys)[-1].split(",")
    assert row[:2] == ["astaroth", want]


def test_common_flag_helpers_equal_jax():
    """parse_methods / method_str / parse_strategy / kernel_axis_kwargs /
    fit_to_mesh give what the JAX package's give."""
    for flags in ([], ["staged"], ["peer", "kernel", "trivial"], ["cuda_aware_mpi", "colo"]):
        ns = types.SimpleNamespace(staged=False, cuda_aware_mpi=False, colo=False, peer=False, kernel=False,
                                   trivial=False, compute_unit="auto", mxu_input="bf16", storage_dtype="auto")
        for f in flags:
            setattr(ns, f, True)
        assert _common.method_str(ns) == jcommon.method_str(ns)
        assert _common.parse_strategy(ns).name == jcommon.parse_strategy(ns).name
        assert bool(_common.parse_methods(ns)) and _common.parse_methods(ns).name == "Ppermute"
        assert _common.kernel_axis_kwargs(ns) == jcommon.kernel_axis_kwargs(ns)
    for size in ((12, 12, 12), (31, 17, 9), (128, 128, 128)):
        for r in (1, 3):
            assert _common.fit_to_mesh(*size, Radius.constant(r), 8) == jcommon.fit_to_mesh(*size, JRadius.constant(r))
            assert _common.fit_to_mesh(*size, Radius.constant(r), 4) == jcommon.fit_to_mesh(
                *size, JRadius.constant(r), devices=jax.devices()[:4])
    assert _common.ranks_and_devcount() == (1, 1)
    with pytest.raises(argparse.ArgumentTypeError):
        _common.parse_partition("2,2")
    assert _common.parse_partition("1,2,4") == (1, 2, 4)
