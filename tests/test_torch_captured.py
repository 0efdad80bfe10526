"""The one-dispatch step loop (``ops/captured.py``) on the CPU.

On the CPU a "captured" phase is the same callable on the same storage,
called where the card would replay a CUDA graph, so these tests run the
binding and the bookkeeping the card runs:

* (a) ``run_step`` with ``set_capture(True)`` against capture off, bitwise,
  over calls whose ``steps`` are and are not multiples of the unit (so
  every body, enter and leave key is both captured and replayed), and
  against the JAX package's ``run_step`` on the fake 8-device mesh: Jacobi3D
  (``kernel_impl="cuda"``, the plain versions) on wrap, slab, shell and the
  three wavefront forms against JAX ``pallas`` in interpret mode, bitwise;
  AstarothSim on wrap, plane, wavefront, fused and split against JAX
  ``jnp``, bitwise (interiors);
* (b) ``exchange_many(n)`` against the JAX domain's, raw arrays bitwise, on
  ``direct`` and a packed route, at even and uneven sizes;
* (c) captured calls interleaved with ``set_quantity``, an uncaptured call
  and ``quantity_to_host`` against the all-uncaptured sequence (the z-ring
  route's resumed state among them);
* (d) the launch-counter bookkeeping on a stand-in graph that counts its
  replays;
* (e) the graphs a step holds stay bounded over many ``steps`` values.

Inputs are f32 (conftest turns JAX's 64-bit mode on).
"""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.core.radius import Radius as JRadius
from stencil_tpu.domain import DistributedDomain as JDomain
from stencil_tpu.models.astaroth import AstarothSim as JAstaroth
from stencil_tpu.models.jacobi import Jacobi3D as JJacobi3D
from stencil_tpu_torch.core.radius import Radius
from stencil_tpu_torch.domain import DistributedDomain
from stencil_tpu_torch.kernels import ledger
from stencil_tpu_torch.models.astaroth import AstarothSim
from stencil_tpu_torch.models.jacobi import Jacobi3D, to_torch_state
from stencil_tpu_torch.ops import captured
from stencil_tpu_torch.ops import jacobi_kernels as jk

torch.set_num_threads(1)

#: call sequences: with a unit of 2 or 3, each holds full units, remainders,
#: and both sets of the ping-pong, captured first and replayed after
CALLS = (3, 5, 2, 4)


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# --- (a) Jacobi3D ---------------------------------------------------------------


def _jacobi(size, partition, capture, **kw):
    m = Jacobi3D(*size, device="cpu", kernel_impl="cuda", capture=capture, **kw)
    if partition is not None:
        m.dd.set_partition(*partition)
    m.realize()
    return m


JACOBI_ROUTES = {
    # name: (size, partition, JAX devices, kwargs, route, unit)
    "wrap": ((16, 14, 12), None, 1, dict(temporal_k=3), "wrap", 3),
    "slab": ((16, 16, 16), (2, 2, 2), 8, dict(pallas_path="slab"), "slab", 1),
    "shell": ((16, 16, 16), (2, 2, 2), 8, dict(pallas_path="shell"), "shell", 1),
    "shell-uneven": ((17, 15, 16), (2, 2, 2), 8, dict(pallas_path="shell"), "shell", 1),
    "wavefront-zslab": ((24, 24, 24), (2, 2, 2), 8, dict(pallas_path="wavefront", temporal_k=2), "wavefront", 2),
    "wavefront-zring": ((16, 16, 128), (2, 1, 1), 2, dict(pallas_path="wavefront", temporal_k=2), "wavefront", 2),
    "wavefront-plain": ((23, 24, 22), (2, 2, 2), 8, dict(pallas_path="wavefront", temporal_k=2), "wavefront", 2),
}


@pytest.mark.parametrize("name", sorted(JACOBI_ROUTES))
def test_jacobi_captured_equals_uncaptured_and_jax(name):
    size, partition, ndev, kw, route, unit = JACOBI_ROUTES[name]
    cap, ref = _jacobi(size, partition, True, **kw), _jacobi(size, partition, False, **kw)
    assert cap._pallas_path == route and cap.dd.capture() and not ref.dd.capture()
    loop = cap._step._loop
    assert loop.unit == unit
    for n in CALLS:
        cap.step(n)
        ref.step(n)
        np.testing.assert_array_equal(cap.temperature(), ref.temperature())
    assert cap._step.captured is False  # no graph on the CPU
    assert loop.captures > 0 and loop.replays > 0 and len(loop.graphs) == loop.captures
    assert all(isinstance(g.impl, captured.Eager) for g in loop.graphs.values())
    devices = jax.devices()[:ndev]
    j = JJacobi3D(*size, devices=devices, kernel_impl="pallas", interpret=True, **kw)
    if partition is not None:
        j.dd.set_partition(*partition)
    j.realize()
    j.step(sum(CALLS))
    np.testing.assert_array_equal(cap.temperature(), j.temperature())


# --- (a) AstarothSim ------------------------------------------------------------

N = 16
ASTAROTH_ROUTES = {
    # name: (subdomains, kwargs, route)
    "wrap": (1, dict(), "wrap"),
    "plane": (8, dict(schedule="per-step"), "plane"),
    "wavefront": (8, dict(), "wavefront"),
    "plane-fused": (8, dict(schedule="per-step", exchange_route="yzpack_xla", stream_halo="fused"), "plane"),
    "wavefront-fused": (8, dict(exchange_route="yzpack_pallas", stream_halo="fused"), "wavefront"),
    "plane-split": (8, dict(schedule="per-step", stream_overlap="split"), "plane"),
    "wavefront-split": (8, dict(stream_overlap="split"), "wavefront"),
}


def _astaroth(subdomains, capture, **kw):
    m = AstarothSim(N, N, N, num_quantities=2, subdomains=subdomains, device="cpu", kernel_impl="cuda",
                    capture=capture, **kw)
    m.realize()
    return m


@pytest.mark.parametrize("name", sorted(ASTAROTH_ROUTES))
def test_astaroth_captured_equals_uncaptured_and_jax(name):
    subdomains, kw, route = ASTAROTH_ROUTES[name]
    j = JAstaroth(N, N, N, num_quantities=2, devices=jax.devices()[:subdomains])
    j.realize()
    start = [np.asarray(j.dd.raw_to_host(h)) for h in j.handles]
    cap, ref = _astaroth(subdomains, True, **kw), _astaroth(subdomains, False, **kw)
    assert cap._step._stream_plan["route"] == route
    for m in (cap, ref):
        m.load_state(start)
    for n in CALLS:
        cap.step(n)
        ref.step(n)
        for i in range(2):
            np.testing.assert_array_equal(cap.field(i), ref.field(i))
    loop = cap._step._loop
    assert loop.replays > 0 and cap._step.captured is False
    j.step(sum(CALLS))
    for i in range(2):
        np.testing.assert_array_equal(cap.field(i), np.asarray(j.field(i)))


def test_torch_engine_captured_equals_jax():
    """The torch engine's step is an in-place loop: one set, no spare."""
    j = JAstaroth(N, N, N, num_quantities=2, devices=jax.devices())
    j.realize()
    cap = AstarothSim(N, N, N, num_quantities=2, subdomains=8, device="cpu", capture=True)
    cap.realize()
    cap.load_state([np.asarray(j.dd.raw_to_host(h)) for h in j.handles])
    stacks = [cap.dd.get_curr(h) for h in cap.handles]
    for n in CALLS:
        cap.step(n)
    assert all(a is b for a, b in zip(stacks, [cap.dd.get_curr(h) for h in cap.handles]))
    assert len(cap._step._loop.graphs) == 1
    j.step(sum(CALLS))
    for i in range(2):
        np.testing.assert_array_equal(cap.field(i), np.asarray(j.field(i)))


def test_capture_refuses_a_step_without_a_loop():
    m = Jacobi3D(16, 16, 16, device="cpu", capture=True)
    m.realize()
    with pytest.raises(ValueError, match="make_step or a model"):
        m.dd.run_step(lambda curr, steps: curr, 2)
    m.dd.set_capture(False)
    m.dd.run_step(lambda curr, steps: curr, 2)


# --- (b) exchange_many ------------------------------------------------------------


def _fields(size, seed):
    return [_rand(size, seed + i) for i in range(2)]


@pytest.mark.parametrize("route", ["direct", "yzpack_pallas"])
@pytest.mark.parametrize("size", [(16, 16, 16), (17, 15, 16)])
def test_exchange_many_equals_jax(route, size):
    j = JDomain(*size)
    j.set_radius(JRadius.constant(2))
    j.set_exchange_route(route)
    jh = [j.add_data(f"q{i}", dtype=np.float32) for i in range(2)]
    j.realize()
    t = DistributedDomain(*size, device="cpu")
    t.set_radius(Radius.constant(2))
    t.set_subdomains(8)
    t.set_exchange_route(route)
    th = [t.add_data(f"q{i}", dtype=torch.float32) for i in range(2)]
    t.realize()
    assert t.exchange_route() == j.exchange_route()
    for a, b, f in zip(jh, th, _fields(size, 5)):
        j.set_quantity(a, f)
        t.set_quantity(b, f)
    t.mark_shell_stale()
    j.exchange_many(3)
    t.exchange_many(3)
    assert not t._shell_stale
    loop = t._exchange_loop
    assert loop.captures == 1 and loop.replays == 2
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(t.raw_to_host(b), np.asarray(j.raw_to_host(a)))
    # again: the captured exchange replays, and an exchange is idempotent
    t.exchange_many(2)
    assert loop.replays == 4
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(t.raw_to_host(b), np.asarray(j.raw_to_host(a)))


# --- (c) interleaving -------------------------------------------------------------


@pytest.mark.parametrize("name", ["wavefront-zring", "wavefront-zslab", "shell", "wrap"])
def test_interleaved_calls_equal_uncaptured(name):
    """Captured calls, then a loaded state, an uncaptured call and a
    readback between captured calls: the result equals the all-uncaptured
    sequence (the z-ring route resumes its working array and z slabs while
    the quantity is untouched, and starts again from a loaded state)."""
    size, partition, _, kw, _, _ = JACOBI_ROUTES[name]
    cap, ref = _jacobi(size, partition, True, **kw), _jacobi(size, partition, False, **kw)
    state = _rand((np.asarray(cap.dd.raw_to_host(cap.h)).shape), 9)
    inner = _rand(size, 10)

    def both(fn):
        fn(cap)
        fn(ref)
        np.testing.assert_array_equal(cap.temperature(), ref.temperature())

    both(lambda m: m.step(3))
    both(lambda m: m.dd.set_quantity(m.h, inner))
    both(lambda m: m.step(5))
    both(lambda m: m.step(1))

    def uncaptured(m, n):
        was = m.dd.capture()
        m.dd.set_capture(False)
        m.step(n)
        m.dd.set_capture(was)

    both(lambda m: uncaptured(m, 3))
    both(lambda m: m.step(4))
    both(lambda m: m.temperature())
    both(lambda m: m.step(2))
    both(lambda m: to_torch_state(state, m.dd))
    both(lambda m: m.step(5))
    assert cap._step._loop.replays > 0


# --- (d) the counter bookkeeping --------------------------------------------------


class CountingGraph:
    """A stand-in CUDA graph: the capture runs the phase once (its launches
    count as the card's wrappers count them); a replay counts itself."""

    captured = True
    replays = 0

    def __init__(self, fn):
        fn()

    def replay(self):
        CountingGraph.replays += 1


def _launch():
    """What a wrapper does where it launches its kernel."""
    jk.jacobi_plane_step.launches += 1
    jk.jacobi_wrap_step.launches += 2


def test_graph_books_delta_per_replay():
    ledger.reset_launch_counts()
    CountingGraph.replays = 0
    g = captured.Graph(_launch, CountingGraph)
    assert g.delta == {"jacobi_plane_step": 1, "jacobi_wrap_step": 2}
    assert g.captured
    # the capture itself launched nothing
    assert not any(ledger.launch_counts().values())
    for n in range(1, 6):
        g.replay()
        counts = ledger.launch_counts()
        assert counts["jacobi_plane_step"] == n and counts["jacobi_wrap_step"] == 2 * n
    assert CountingGraph.replays == 5
    assert sum(ledger.launch_counts().values()) == 15
    ledger.reset_launch_counts()


def test_loop_counts_equal_uncaptured_counts():
    """A loop whose body launches (a stand-in): the captured run's counts,
    first occurrences plus booked replays, equal the uncaptured run's."""

    def body(cur, nxt, depth):
        jk.jacobi_plane_step.launches += depth
        nxt.fields[0].copy_(cur.fields[0] + depth)

    def run(capture):
        ledger.reset_launch_counts()
        loop = captured.Loop(["q"], 3, body)
        loop.backend = CountingGraph
        curr = {"q": torch.zeros(4)}
        for n in (7, 5, 3, 1, 8):
            curr = loop.run(curr, n, capture=capture)
        return ledger.launch_counts()["jacobi_plane_step"], loop

    CountingGraph.replays = 0
    want, _ = run(False)
    got, loop = run(True)
    assert want == got == 24
    assert loop.replays == CountingGraph.replays > 0
    assert loop.captured
    ledger.reset_launch_counts()


def test_failed_capture_raises_and_restores_counters():
    ledger.reset_launch_counts()

    def broken(fn):
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        captured.Graph(_launch, broken)
    assert not any(ledger.launch_counts().values())

    calls = []

    def body(cur, nxt, depth):
        calls.append(depth)
        nxt.fields[0].copy_(cur.fields[0])

    loop = captured.Loop(["q"], 1, body)
    loop.backend = broken
    curr = {"q": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="capturing"):
        loop.run(curr, 2, capture=True)
    assert not loop.graphs and calls == [1, 1]  # the warm-up, then the capture
    # the phase raises at once now: it never runs uncaptured again
    with pytest.raises(RuntimeError, match="could not be captured"):
        loop.run(curr, 1, capture=True)
    assert calls == [1, 1]


# --- (e) bounded graphs -----------------------------------------------------------


def test_graphs_stay_bounded():
    """Jacobi's z-slab wavefront (m = 2) and the wrap route (k = 3) over
    twenty distinct ``steps``: the graphs stay within ``2 * unit + 4``, and
    on the wrap route all it can hold are held (one enter, a leave from
    either set, one body per depth from either set)."""
    for name, want in (("wavefront-zslab", None), ("wrap", 3 * 2 + 1 + 2)):
        size, partition, _, kw, _, _ = JACOBI_ROUTES[name]
        m = _jacobi(size, partition, True, **kw)
        loop = m._step._loop
        for n in range(1, 21):
            m.step(n)
            assert len(loop.graphs) <= loop.max_graphs
        if want is not None:
            assert len(loop.graphs) == want
        kinds = {k[0] for k in loop.graphs}
        assert kinds <= {"enter", "body", "leave"}
        assert {k[1] for k in loop.graphs if k[0] == "body"} <= set(range(1, loop.unit + 1))


def test_graphs_dropped_when_storage_changes():
    """The graphs read the storage they were captured on: a step that
    starts from other stacks (after ``swap``) drops them and captures anew."""
    m = _jacobi((16, 16, 16), (2, 2, 2), True, pallas_path="shell")
    m.step(3)
    loop = m._step._loop
    old = list(loop.graphs.values())
    assert len(old) == 2
    m.dd.swap()
    m.step(3)
    assert len(loop.graphs) == 2 and not any(g in old for g in loop.graphs.values())


@pytest.mark.parametrize("model", ["jacobi", "astaroth", "torch engine"])
def test_model_and_its_graphs_freed_by_refcount(model):
    """No reference cycle holds a model, its step or its loop: dropping the
    model frees its stacks, the loop's sets and the loop's graphs at once,
    without the cycle collector (on the card the graphs' memory pool goes
    with them)."""
    import gc
    import weakref

    if model == "jacobi":
        m = _jacobi((16, 16, 16), (2, 2, 2), True, pallas_path="shell")
    elif model == "astaroth":
        m = _astaroth(8, True, schedule="per-step")
    else:
        m = AstarothSim(N, N, N, num_quantities=2, subdomains=8, device="cpu", capture=True)
        m.realize()
    m.step(3)
    loop = m._step._loop
    assert loop.graphs
    refs = [weakref.ref(x) for x in (m.dd, loop, *loop.graphs.values())]
    del loop
    was = gc.isenabled()
    gc.disable()
    try:
        del m
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()
