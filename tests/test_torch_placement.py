"""The port's placement layer (``stencil_tpu_torch/parallel/``: ``qap``,
``native_qap``, ``topology``, ``placement``, ``cost``, ``distributed``)
against the JAX package's.

* QAP: cost, the exact and the 2-opt assignments equal to
  ``stencil_tpu.parallel.qap`` on seeded matrices for s = 2..9 (the exact
  solver to 8), and the native library (the port's ``csrc/qap.cpp``, the
  JAX package's ``native/qap.cpp`` below its header, built into
  ``_build/``) equal to the Python solvers for s = 2..12;
* ``comm_matrix``, the distance matrix over CPU slots and the ``NodeAware``
  assignment and cost over 8 CPU slots equal to the JAX package's over the
  8 fake CPU devices of tests/conftest.py; slots on one CUDA device are at
  the SAME tier and keep the identity; two CUDA devices are refused;
* ``projected_exchange_cost`` equal to the JAX package's under one
  ``LinkModel``, ``axis_edge_kinds`` over slot grids, ``write_plan``'s
  message lines equal to the JAX domain's;
* ``distributed.py`` a no-op on one process, and a 2-process gloo group
  (slow);
* the failure taxonomy's ``torch.distributed`` / NCCL wordings.
"""

import multiprocessing
import os
import socket

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.parallel import cost as jcost
from stencil_tpu.parallel import placement as jplacement
from stencil_tpu.parallel import qap as jqap
from stencil_tpu.parallel import topology as jtopology
from stencil_tpu.parallel.partition import ManualPartition as JManual
from stencil_tpu.parallel.partition import NodePartition as JNode
from stencil_tpu.utils.config import PlacementStrategy as JStrategy
from stencil_tpu_torch.bin import bench_qap
from stencil_tpu_torch.core.dim3 import Dim3
from stencil_tpu_torch.core.geometry import LocalSpec
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.parallel import cost, distributed, native_qap, placement, qap, topology
from stencil_tpu_torch.parallel.mesh import make_grid
from stencil_tpu_torch.parallel.partition import ManualPartition, NodePartition
from stencil_tpu_torch.parallel.topology import Slot, slots_on
from stencil_tpu_torch.resilience.taxonomy import FailureClass, classify
from stencil_tpu_torch.utils.config import PlacementStrategy

torch.set_num_threads(1)

#: the bench's three matrix families, seeded as the bench seeds them
KINDS = dict(bench_qap.MATRICES)


def _matrices(kind: str, s: int):
    return KINDS[kind](s, np.random.default_rng(100 + s))


# --- QAP ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("s", range(2, 10))
def test_qap_equals_jax(kind, s):
    w, d = _matrices(kind, s)
    f = list(np.random.default_rng(s).permutation(s))
    assert qap.qap_cost(w, d, f) == jqap.qap_cost(w, d, f)
    assert qap.qap_solve_catch(w, d) == jqap.qap_solve_catch(w, d)
    if s <= 8:
        assert qap.qap_solve(w, d) == jqap.qap_solve(w, d)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_native_equals_python(kind):
    assert native_qap.available(), "csrc/qap.cpp must build with the host compiler"
    for s in range(2, 13):
        w, d = _matrices(kind, s)
        f = list(range(s))[::-1]
        np.testing.assert_allclose(native_qap.qap_cost(w, d, f), qap.qap_cost(w, d, f), rtol=1e-12)
        got, want = native_qap.qap_solve_catch(w, d), qap.qap_solve_catch(w, d)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
        if s <= 7:
            got, want = native_qap.qap_solve(w, d), qap.qap_solve(w, d)
            assert got[0] == want[0]
            np.testing.assert_allclose(got[1], want[1], rtol=1e-12)


def test_native_library_is_built_into_the_package_build_dir():
    path = native_qap.library_path()
    assert os.path.dirname(path) == os.path.join(os.path.dirname(os.path.dirname(native_qap.__file__)), "_build")
    assert os.path.basename(path).startswith("libstencil_qap-") and os.path.exists(path)
    # the port builds its own copy of the source, never the JAX package's
    assert native_qap.SOURCE == os.path.join(os.path.dirname(os.path.dirname(native_qap.__file__)), "csrc", "qap.cpp")


def test_native_source_is_the_jax_package_code():
    """Below its header comment the port's ``csrc/qap.cpp`` is the JAX
    package's ``native/qap.cpp`` line for line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def code(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("#include"):]

    assert code(native_qap.SOURCE) == code(os.path.join(root, "native", "qap.cpp"))


def test_native_off_falls_back_to_python(monkeypatch):
    monkeypatch.setenv("STENCIL_NATIVE", "0")
    monkeypatch.setattr(native_qap, "_STATE", {})
    assert not native_qap.available()
    w, d = _matrices("random", 5)
    assert qap.solve_auto(w, d) == jqap.qap_solve(w, d)
    with pytest.raises(Exception, match="STENCIL_NATIVE=0"):
        native_qap.qap_solve(w, d)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bench_qap_matrices_equal_jax(kind):
    from stencil_tpu.bin import bench_qap as jbench

    jmake = dict((("blkdiag", jbench.make_blkdiag), ("random", jbench.make_random),
                  ("matched", jbench.make_matched)))[kind]
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for s in range(2, 12):
        for a, b in zip(KINDS[kind](s, rng), jmake(s, jrng)):
            np.testing.assert_array_equal(a, b)


def test_bench_qap_prints_the_reference_format(capsys):
    bench_qap.main(["--iters", "1", "--max-size", "6", "--exact-below", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "blkdiag" and lines[1] == "size CRAFT(s) cost exact(s) cost"
    assert lines[2].split()[0] == "2" and len(lines[2].split()) == 5
    assert lines[4].split()[0] == "4" and lines[4].split()[3:] == ["-", "-"]
    assert [ln for ln in lines if not ln[0].isdigit() and not ln.startswith("size")] == ["blkdiag", "random",
                                                                                        "matched"]


# --- comm matrix, topology, placement ----------------------------------------


PARTITIONS = [
    ("node 8, 16^3, r1", (16, 16, 16), 1, ("node", 8)),
    ("node 8, 17^3, r2", (17, 17, 17), 2, ("node", 8)),
    ("node 4, 20x12x16, r1", (20, 12, 16), 1, ("node", 4)),
    ("manual 2x2x2", (16, 16, 16), 1, ("manual", (2, 2, 2))),
    ("manual 4x1x2, r3", (24, 16, 16), 3, ("manual", (4, 1, 2))),
    ("manual 1x1x1", (8, 8, 8), 1, ("manual", (1, 1, 1))),
]


def _parts(size, r, how):
    if how[0] == "node":
        return (NodePartition(Dim3(*size), Radius.constant(r), 1, how[1]),
                JNode(size, JRadius.constant(r), 1, how[1]))
    return ManualPartition(Dim3(*size), Dim3(*how[1])), JManual(size, how[1])


@pytest.mark.parametrize("label,size,r,how", PARTITIONS, ids=[p[0] for p in PARTITIONS])
def test_comm_matrix_equals_jax(label, size, r, how):
    part, jpart = _parts(size, r, how)
    np.testing.assert_array_equal(placement.comm_matrix(part, Radius.constant(r)),
                                  jplacement.comm_matrix(jpart, JRadius.constant(r)))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_cpu_slots_meet_the_fake_devices(n):
    slots = slots_on("cpu", n)
    devs = jax.devices()[:n]
    np.testing.assert_array_equal(topology.distance_matrix(slots), jtopology.distance_matrix(devs))
    np.testing.assert_array_equal(topology.bandwidth_matrix(slots), jtopology.bandwidth_matrix(devs))
    assert topology.num_processes(slots) == jtopology.num_processes(devs) == 1
    assert [[s.id for s in g] for g in topology.devices_by_process(slots)] == \
        [[d.id for d in g] for g in jtopology.devices_by_process(devs)]


@pytest.mark.parametrize("label,size,r,how", PARTITIONS[:5], ids=[p[0] for p in PARTITIONS[:5]])
@pytest.mark.parametrize("strategy", ["NodeAware", "Trivial"])
def test_placement_equals_jax_over_eight_slots(label, size, r, how, strategy):
    part, jpart = _parts(size, r, how)
    n = part.dim().flatten()
    mine = placement.make_placement(PlacementStrategy[strategy], part, slots_on("cpu", n), Radius.constant(r))
    theirs = jplacement.make_placement(JStrategy[strategy], jpart, jax.devices()[:n], JRadius.constant(r))
    assert mine.assignment == theirs.assignment
    if strategy == "NodeAware":
        assert mine.cost == theirs.cost
    grid = mine.slot_grid()
    jgrid = theirs.device_grid()
    assert grid.shape == jgrid.shape
    assert [s.id for s in grid.flat] == [d.id for d in jgrid.flat]
    for i in range(n):
        idx = part.idx(i)
        assert mine.get_idx(mine.get_slot(idx)) == idx
        assert mine.get_device(idx) == torch.device("cpu")
        assert mine.subdomain_size(idx) == Dim3(*theirs.subdomain_size(jpart.idx(i)))
    assert mine.report().splitlines()[0] == f"# placement: dim={mine.dim()} cost={mine.cost}"


def test_domain_placement_is_the_grids():
    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(1)
    dd.set_subdomains(8)
    dd.add_data("q")
    dd.realize()
    jd = JDomain(16, 16, 16)
    jd.set_radius(JRadius.constant(1))
    jd.set_devices(jax.devices()[:8])
    jd.add_data("q")
    jd.realize()
    assert dd.placement is dd.grid.placement
    assert dd.placement.assignment == jd.placement.assignment
    assert [s.id for s in dd.placement.slot_grid().flat] == [d.id for d in jd.mesh.devices.flat]


def test_slots_on_one_card_are_the_same_tier():
    slots = slots_on(torch.device("cuda", 0), 8)  # a device object needs no card
    dist = topology.distance_matrix(slots)
    assert np.all(dist == topology._SELF_DISTANCE)
    part = NodePartition(Dim3(16, 16, 16), Radius.constant(1), 1, 8)
    pl = placement.make_placement(PlacementStrategy.NodeAware, part, slots, Radius.constant(1))
    assert pl.assignment == list(range(8))
    assert pl.cost == qap.qap_cost(placement.comm_matrix(part, Radius.constant(1)), dist, list(range(8)))


def test_two_cuda_devices_are_refused():
    slots = [Slot(0, torch.device("cuda", 0)), Slot(1, torch.device("cuda", 1))]
    part = ManualPartition(Dim3(8, 8, 8), Dim3(2, 1, 1))
    with pytest.raises(ValueError, match="item 13b"):
        placement.make_placement(PlacementStrategy.NodeAware, part, slots, Radius.constant(1))
    grid = make_grid((8, 8, 8), Radius.constant(1), force_dim=Dim3(2, 1, 1), device=torch.device("cuda", 0))
    assert [s.device for s in grid.placement.slots] == [torch.device("cuda", 0)] * 2


def test_other_processes_are_farther():
    slots = [Slot(0, torch.device("cpu"), 0), Slot(1, torch.device("cpu"), 1)]
    assert topology.distance_matrix(slots)[0, 1] == 1.0 + topology._PROCESS_PENALTY
    assert topology.num_processes(slots) == 2


# --- the cost model -----------------------------------------------------------


@pytest.mark.parametrize("kinds", [["ici", "ici", "ici"], ["self", "ici", "dcn"], ["dcn", "self", "self"]])
@pytest.mark.parametrize("r,mult", [(1, 1), (2, 1), (3, 2)])
def test_projected_cost_equals_jax(kinds, r, mult):
    spec = LocalSpec.make(Dim3(32, 24, 16), Dim3(0, 0, 0), Radius.constant(r).scaled(mult))
    jspec = jax_spec((32, 24, 16), r * mult)
    # one link model: the JAX package prices "self" at its ICI rate
    link = cost.LinkModel(device_gbps=123.0, ici_gbps=123.0, dcn_gbps=7.5, latency_us=11.0)
    jlink = jcost.LinkModel(ici_gbps=123.0, dcn_gbps=7.5, latency_us=11.0)
    rows, total = cost.projected_exchange_cost(spec, [4, 8], kinds, link)
    jrows, jtotal = jcost.projected_exchange_cost(jspec, [4, 8], kinds, jlink)
    assert rows == jrows and total == jtotal
    mine = cost.format_cost_report(rows, total, link, mult)
    theirs = jcost.format_cost_report(jrows, jtotal, jlink, mult)
    assert mine[2:] == theirs[2:]


def jax_spec(sz, r):
    from stencil_tpu.core.geometry import LocalSpec as JSpec

    return JSpec.make(sz, (0, 0, 0), JRadius.constant(r))


def test_link_models():
    assert cost.LinkModel().device_gbps == cost.DEVICE_DATASHEET_GBPS and cost.LinkModel().source == "datasheet"
    assert cost.LinkModel.measured("cpu") == cost.LinkModel()
    rt = 2 * (1 << 27) / 1450e9
    assert cost.LinkModel.from_pingpong(1 << 27, rt).ici_gbps == jcost.LinkModel.from_pingpong(1 << 27, rt).ici_gbps
    doc = {"links": [{"axis": "x", "side": "low", "src": 0, "dst": 1, "gbps": 900.0},
                     {"axis": "x", "side": "high", "src": 1, "dst": 0, "gbps": 800.0}]}
    m = cost.LinkModel.from_probe(doc)
    assert m.device_gbps == 800.0 and m.source == "probe"
    assert m.gbps("self") == m.gbps("device") == 800.0 and m.gbps("ici") == cost.NVLINK_DATASHEET_GBPS


def test_axis_edge_kinds_over_slot_grids():
    one = make_grid((16, 16, 16), Radius.constant(1), force_dim=Dim3(2, 2, 1), device="cpu").placement.slot_grid()
    assert cost.axis_edge_kinds(one) == ["device", "device", "self"]
    grid = np.empty((2, 1, 2), dtype=object)
    for i, (x, z) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        grid[x, 0, z] = Slot(i, torch.device("cuda", x), process_index=z)
    assert cost.axis_edge_kinds(grid) == ["ici", "self", "dcn"]


def test_write_plan_messages_equal_jax(tmp_path):
    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(2)
    dd.set_partition(2, 2, 1)
    dd.add_data("a")
    dd.add_data("b", dtype=torch.float64)
    dd.realize()
    jd = JDomain(16, 16, 16)
    jd.set_radius(JRadius.constant(2))
    jd.set_devices(jax.devices()[:4])
    jd.set_partition(2, 2, 1)
    jd.add_data("a")
    jd.add_data("b", dtype=np.float64)
    jd.realize()
    path = dd.write_plan(str(tmp_path / "plan"))
    jpath = jd.write_plan(str(tmp_path / "jplan"))
    assert path == str(tmp_path / "plan_0.txt")
    mine, theirs = open(path).read().splitlines(), open(jpath).read().splitlines()

    def messages(lines, method):
        return [ln.replace(f" method={method}", "") for ln in lines if ln.startswith("dir=") and "method=" in ln]

    assert messages(mine, "copy") == messages(theirs, "ppermute")
    assert [ln for ln in mine if ln.startswith("# total bytes")] == [ln for ln in theirs if ln.startswith("# total")]
    assert mine[0].startswith("# placement: dim=[2,2,1]") and "slot 0 device cpu" in mine[1]
    projected = [ln for ln in mine if ln.startswith("dir=") and "edge=" in ln]
    # x and y split over slots of one device; z unsplit
    assert [ln.split()[2] for ln in projected] == ["edge=device"] * 4 + ["edge=self"] * 2
    assert "(datasheet)" in "\n".join(mine)


# --- distributed --------------------------------------------------------------


def test_distributed_is_a_no_op_on_one_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    distributed.barrier()
    obj = {"a": [1, 2]}
    assert distributed.broadcast_from_host0(obj) is obj
    np.testing.assert_array_equal(distributed.allgather_hosts(np.arange(3)), np.arange(3)[None])
    with pytest.raises(ValueError, match="together"):
        distributed.initialize(coordinator_address="localhost:1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, q) -> None:
    from stencil_tpu_torch.parallel import distributed as d

    torch.set_num_threads(1)
    d.initialize(f"localhost:{port}", num_processes=2, process_id=rank)
    try:
        d.barrier()
        got = d.broadcast_from_host0({"rank": rank})
        stacked = d.allgather_hosts(np.array([rank, 10 * rank]))
        q.put((rank, d.process_index(), d.process_count(), got, stacked.tolist()))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.slow
def test_two_process_gloo_group():
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    out = sorted(q.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    for rank, idx, count, got, stacked in out:
        assert (idx, count, got, stacked) == (rank, 2, {"rank": 0}, [[0, 0], [1, 10]])


# --- the failure taxonomy -------------------------------------------------------


@pytest.mark.parametrize("exc", [
    RuntimeError("NCCL error in: /pytorch/torch/csrc/distributed/c10d/ProcessGroupNCCL.cpp:1970, remote process "
                 "exited or there was a network error, NCCL version 2.21.5\nncclRemoteError: A call failed "
                 "possibly due to a network error or a remote process exiting prematurely."),
    RuntimeError("DistBackendError: NCCL error in: ProcessGroupNCCL.cpp:3356, unhandled system error"),
    torch.distributed.DistBackendError("NCCL communicator was aborted on rank 1"),
    RuntimeError("Device coordinator reported missing chips: 2"),  # the JAX package's wording
])
def test_dist_failures_are_capacity_loss(exc):
    assert classify(exc) is FailureClass.CAPACITY_LOSS


def test_a_sticky_cuda_error_inside_nccl_stays_fatal():
    assert classify(RuntimeError("NCCL error: unhandled cuda error, an illegal memory access was encountered")) \
        is FailureClass.FATAL
