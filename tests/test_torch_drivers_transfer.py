"""The port's transfer drivers (``bin/pingpong.py``, ``bench_alltoallv.py``,
``measure_buf_exchange.py``) and their ``bin/_common.py`` primitives against
the JAX package's, on the CPU.

* ``stencil_matrix(n, ...)`` equals the JAX package's for n = 1..12;
* schema: ``tests/test_drivers.py``'s asserts on the three drivers, held on
  the port's CLI with the endpoints patched to 8 CPU devices (the JAX tests'
  8 fake devices);
* with the endpoints so patched and ``measure_edge`` /
  ``measure_matrix_concurrent`` patched, in both packages, to one
  deterministic function of (src, dst, bytes), ``bench_alltoallv`` and
  ``measure_buf_exchange`` print output equal to the JAX drivers' line by
  line; pingpong names its pairs as the JAX driver does;
* the transfer primitives move the bytes they say (every pair's buffer
  equal to its source after a traversal), a one-endpoint list pairs the
  endpoint with itself, and the CPU endpoint list;
* ``--device cuda`` without a card fails in all three.
"""

import numpy as np
import pytest
import torch

from stencil_tpu.bin import _common as jcommon
from stencil_tpu.bin import bench_alltoallv as jba
from stencil_tpu.bin import measure_buf_exchange as jmbe
from stencil_tpu.bin import pingpong as jpp
from stencil_tpu_torch.bin import _common
from stencil_tpu_torch.bin import bench_alltoallv as ba
from stencil_tpu_torch.bin import measure_buf_exchange as mbe
from stencil_tpu_torch.bin import pingpong as pp

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
EIGHT = [torch.device("cpu")] * 8


@pytest.fixture
def eight(monkeypatch):
    """The endpoints: 8 CPU devices, as conftest gives the JAX package."""
    monkeypatch.setattr(_common, "endpoints", lambda device="cuda": list(EIGHT))


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert out, "driver printed nothing"
    return out


@pytest.mark.parametrize("n", range(1, 13))
def test_stencil_matrix_equals_jax(n):
    MiB = 1 << 20
    got = ba.stencil_matrix(n, face=8 * MiB, edge=MiB, corner=MiB // 4)
    want = jba.stencil_matrix(n, face=8 * MiB, edge=MiB, corner=MiB // 4)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n, n) and not np.diag(got).any()


# --- schema (tests/test_drivers.py) ---------------------------------------------------


def test_pingpong(capsys, eight):
    assert pp.main(["--min", "2", "--max", "4", "--iters", "2"] + CPU) == 0
    out = _lines(capsys)
    assert len(out) == 7
    for line in out:
        name, *times = line.split()
        assert "-" in name
        assert len(times) == 3
        assert all(float(t) > 0 for t in times)


def test_pingpong_names_equal_jax(capsys, eight):
    import jax

    want = [name for name, _ in jpp.pingpong_times(jax.devices(), 2, 2, 1)]
    assert [name for name, _ in pp.pingpong_times(EIGHT, 2, 2, 1)] == want
    assert [name for name, _ in pp.pingpong_times(EIGHT[:1], 2, 2, 1)] == ["0-0"]  # one endpoint: itself


def test_bench_alltoallv(capsys, eight):
    assert ba.main(["--iters", "1", "--scale", "0.001"] + CPU) == 0
    out = _lines(capsys)
    assert "bw" in out and "time" in out and "stencil" in out
    assert "All-to-all 8MiB" in out
    assert "Local 1GiB Remote 100M" in out
    for name in ("stencil", "All-to-all 8MiB", "Local 1GiB Remote 100M"):
        i = out.index(f"{name} concurrent")
        assert float(out[i + 1]) > 0


def test_measure_buf_exchange(capsys, eight):
    assert mbe.main(["--iters", "2", "--sub-iters", "1", "--init-mib", "0.05"] + CPU) == 0
    out = _lines(capsys)
    assert out[0] == "x"
    assert "final x (MiB)" in out
    assert any(line.startswith("y_concurrent ") and float(line.split()[1]) > 0 for line in out)
    final = out[out.index("final x (MiB)") + 1:]
    vals = [float(v) for line in final for v in line.split()]
    assert any(v > 0 for v in vals)
    assert all(not np.isnan(v) for v in vals)


# --- output equal to the JAX drivers under one deterministic timer ---------------------


def _edge_s(src, dst, nbytes):
    """A deterministic stand-in for a transfer's seconds."""
    return 1e-6 * (1 + src + 2 * dst) + nbytes / (1e9 * (1 + (src + 3 * dst) % 5))


def _matrix_s(comm):
    comm = np.asarray(comm)
    return float(sum(_edge_s(i, j, comm[i, j]) for i in range(comm.shape[0]) for j in range(comm.shape[1])
                     if i != j and comm[i, j] > 0)) / 3.0


@pytest.fixture
def timers(monkeypatch, eight):
    monkeypatch.setattr(jcommon, "measure_edge", lambda mesh, n, i, j, nb, it: _edge_s(i, j, nb))
    monkeypatch.setattr(jcommon, "measure_matrix_concurrent", lambda mesh, comm, it: _matrix_s(comm))
    # measure_buf_exchange binds both names at its import
    monkeypatch.setattr(jmbe, "measure_edge", lambda mesh, n, i, j, nb, it: _edge_s(i, j, nb))
    monkeypatch.setattr(jmbe, "measure_matrix_concurrent", lambda mesh, comm, it: _matrix_s(comm))
    monkeypatch.setattr(_common, "measure_edge", lambda eps, i, j, nb, it: _edge_s(i, j, nb))
    monkeypatch.setattr(_common, "measure_matrix_concurrent", lambda eps, comm, it: _matrix_s(comm))


@pytest.mark.parametrize("scale", ["0.001", "1.0"])
def test_bench_alltoallv_prints_what_jax_prints(capsys, timers, scale):
    assert jba.main(["--iters", "1", "--scale", scale]) == 0
    want = _lines(capsys)
    assert ba.main(["--iters", "1", "--scale", scale] + CPU) == 0
    assert _lines(capsys) == want


@pytest.mark.parametrize("argv", [
    ["--iters", "4", "--init-mib", "0.05"],
    ["--iters", "50", "--target", "1e-4", "--max-mib", "8"],
    ["--iters", "6", "--target", "2e-6", "--tol", "0.2"],
])
def test_measure_buf_exchange_prints_what_jax_prints(capsys, timers, argv):
    assert jmbe.main(argv) == 0
    want = _lines(capsys)
    assert mbe.main(argv + CPU) == 0
    assert _lines(capsys) == want


# --- the primitives --------------------------------------------------------------------


def test_edge_transfer_copies_and_times():
    go, (a, b) = _common.make_edge_transfer(EIGHT, 2, 5, 1000)
    a.copy_(torch.arange(1000, dtype=torch.float32))
    go()
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert _common.measure_edge(EIGHT[:1], 0, 0, 4096, 2) > 0  # one endpoint: itself


def test_matrix_transfer_copies_every_pair():
    comm = np.zeros((3, 3), dtype=np.int64)
    comm[0, 1], comm[1, 0], comm[2, 1], comm[1, 1] = 400, 40, 4000, 400  # the diagonal is skipped (3 endpoints)
    go, bufs = _common.make_matrix_transfer(EIGHT[:3], comm)
    assert [a.numel() for a, _ in bufs] == [100, 10, 1000]
    for k, (a, _) in enumerate(bufs):
        a.copy_(torch.arange(a.numel(), dtype=torch.float32) + k)
    go()
    assert all(torch.equal(a, b) for a, b in bufs)
    assert _common.make_matrix_transfer(EIGHT[:3], np.zeros((3, 3))) == (None, ())
    assert _common.measure_matrix_concurrent(EIGHT[:3], np.eye(3) * 400, 2) is None  # no pair moves bytes
    assert _common.measure_matrix_concurrent(EIGHT[:3], comm, 2) > 0


def test_one_endpoint_pairs_with_itself():
    """One endpoint: the diagonal is the endpoint with itself, as
    ``measure_edge`` pairs it, so a traversal moves its bytes."""
    go, bufs = _common.make_matrix_transfer(EIGHT[:1], np.full((1, 1), 400))
    assert [a.numel() for a, _ in bufs] == [100]
    bufs[0][0].copy_(torch.arange(100, dtype=torch.float32))
    go()
    assert torch.equal(bufs[0][0], bufs[0][1]) and bufs[0][0].data_ptr() != bufs[0][1].data_ptr()
    assert _common.measure_matrix_concurrent(EIGHT[:1], np.full((1, 1), 4096), 2) > 0
    assert _common.make_matrix_transfer(EIGHT[:1], np.zeros((1, 1))) == (None, ())


@pytest.mark.parametrize("eps,empty", [
    (EIGHT[:1], ["stencil", "All-to-all 8MiB", "All-to-all 1GiB", "Local 1GiB", "Local 1GiB Remote 100M"]),
    (EIGHT[:2], ["Local 1GiB"]),
])
def test_bench_alltoallv_prints_na_where_no_pair_moves_bytes(capsys, eps, empty):
    """A matrix with no pair (each is zero on its diagonal) prints ``n/a``,
    never a time of 0 s; every other total is a positive time."""
    ba.run(eps, 1, 0.001)
    out = _lines(capsys)
    names = ["stencil", "All-to-all 8MiB", "All-to-all 1GiB", "Local 1GiB", "Local 1GiB Remote 100M"]
    for name in names:
        for label in (name, f"{name} concurrent"):
            got = out[out.index(label) + 1]
            assert got == "n/a" if name in empty else float(got) > 0, (label, got)


def test_measure_buf_exchange_one_endpoint_times_the_self_pair(capsys):
    """One endpoint: ``y`` and ``y_concurrent`` both time the self pair."""
    assert mbe.main(["--iters", "2", "--sub-iters", "1", "--init-mib", "0.05"] + CPU) == 0
    out = _lines(capsys)
    conc = [float(line.split()[1]) for line in out if line.startswith("y_concurrent ")]
    ys = [float(out[i + 1]) for i, line in enumerate(out) if line == "y"]
    assert len(conc) == len(ys) == 2 and all(v > 0 for v in conc + ys)


def test_endpoints_on_the_cpu():
    assert _common.endpoints("cpu") == [torch.device("cpu")]


@pytest.mark.parametrize("main,argv", [
    (pp.main, ["--min", "2", "--max", "3"]),
    (ba.main, ["--scale", "0.001"]),
    (mbe.main, ["--iters", "1"]),
])
def test_cuda_without_a_card_fails(monkeypatch, capsys, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert capsys.readouterr().out == ""
