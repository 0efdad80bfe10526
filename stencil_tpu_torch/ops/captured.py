"""One-dispatch step loops: a built step's iterations as captured CUDA graphs.

The JAX package never dispatches a step from a Python loop:
``DistributedDomain.run_step(step_fn, steps)`` runs ``steps`` iterations in
one jitted ``lax.fori_loop`` (``stencil_tpu/domain.py:1671-1690``),
``make_stream_step`` loops its macro steps so (``stencil_tpu/ops/stream.py:
1843-1857``) and ``exchange_many`` its exchanges (``domain.py:1264-1282``);
the JAX source calls that replayed step "the TPU analog of the reference's
CUDA-Graph pack replay" (``domain.py:1632-1635``, reference
``packer.cuh:168-187``).  No JAX module corresponds to this one; its callers
are ``DistributedDomain.run_step`` and ``exchange_many``.

Every step the port builds is a ``Loop``: ``enter`` (the loop's state from
the quantities' stacks), ``body`` once per depth of ``depths(steps)`` (full
units of ``unit`` iterations, then the remainder), and ``leave`` (the state
back into the stacks).  The state lives in two FIXED sets of tensors, the
body reading one and writing the other (``State``):

* stack-carried loops (no ``work``): the first set is the quantities'
  stacks themselves and the second a spare set the loop keeps; a call ends
  with the stacks rebound to the set that holds the result, as the Jacobi
  ``shell`` route always did (the wavefront, plane and shell routes);
* working loops (``work``): two sets of the loop's own tensors, ``enter``
  copying the stacks in and ``leave`` copying the result back (the
  single-subdomain ``wrap`` routes, ``slab``, the z-ring wavefront);
* in-place loops: one set, the stacks, written in place (the torch engine,
  the exchange).

``extra`` tensors (z slabs) ride in each set.  Uncaptured, ``run`` calls the
phases in turn.  Captured (``run(..., capture=True)``), each phase is a graph
keyed by ``("enter", p)``, ``("body", depth, p)`` or ``("leave", p)``, ``p``
the set that holds the state: kernel arguments, data pointers and streams
are frozen at capture, and every tensor a graph reads or writes is one of
the fixed sets or the stacks, so a replay reads what the last one wrote.
The graphs a loop holds are bounded by ``2 * unit + 4`` whatever ``steps``
callers pass, and are dropped when the stacks' storage changes.  A
captured loop keeps its sets and graphs until ``release()`` or until the
step is dropped; an uncaptured call frees the loop's own sets at its end
(unless the loop resumes), so a step's memory between uncaptured calls is
the stacks alone.  The first
occurrence of a key runs uncaptured (the warm-up: it builds every library,
binds every C entry, fills every descriptor cache and runs every occupancy
query) and is then captured; later occurrences replay.  So a captured call
runs the same phases in the same order on the same storage as an
uncaptured one, and their results agree bit for bit.

Launch counters (``kernels/ledger.py``) are Python-side and a replay does
not run them: ``Graph`` records each counter's delta over the capture,
restores them (a capture launches nothing) and adds the delta on every
replay, so a captured run reports the launches an uncaptured one does.

On the CPU there is no graph: a "captured" phase keeps the same callable on
the same storage and calls it where the card would replay (``Eager``), so
the binding and bookkeeping run in the CPU tests; ``Loop.captured`` is then
False.  On the card a failed capture or replay raises, and a phase whose
capture failed raises at once on every later occurrence; nothing falls
back to the uncaptured phase.
"""

from __future__ import annotations

import functools
import gc
import operator
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from stencil_tpu_torch.kernels import ledger


class State:
    """One set of a loop's tensors: ``fields`` (one per quantity: its stack,
    or the loop's working tensor) and ``extra`` (tensors that ride along)."""

    __slots__ = ("fields", "extra")

    def __init__(self, fields: Sequence[torch.Tensor], extra: Sequence[torch.Tensor] = ()):
        self.fields = list(fields)
        self.extra = list(extra)

    def tensors(self) -> List[torch.Tensor]:
        return self.fields + self.extra


class Eager:
    """The CPU's stand-in for a graph: ``replay`` calls the phase again on
    the storage it was given."""

    captured = False

    def __init__(self, fn: Callable[[], None]):
        self._fn = fn

    def replay(self) -> None:
        self._fn()


class CudaGraph:
    """One phase captured as a CUDA graph on ``stream`` into the memory
    ``pool``; ``replay`` launches it on the current stream.  A capture that
    fails raises (the capture is ended and dropped first).

    The garbage collector is run before the capture and held off during it:
    a graph or event that dies in a reference cycle is destroyed by the
    collector, and a destroy call made while this thread captures
    invalidates the capture."""

    captured = True

    def __init__(self, fn: Callable[[], None], device: torch.device, pool, stream: "torch.cuda.Stream"):
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(device)
        torch.cuda.synchronize(device)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by what fn raised on
                    raise
                graph.capture_end()
            main.wait_stream(stream)
        finally:
            if collecting:
                gc.enable()
        self._graph = graph

    def replay(self) -> None:
        self._graph.replay()


class Graph:
    """A captured phase and the launches it books: ``backend(fn)`` captures
    ``fn`` (``CudaGraph``, or ``Eager`` on the CPU); each counter of
    ``ledger.launch_counts`` that moved during the capture is restored and
    its ``delta`` added again on every ``replay``."""

    def __init__(self, fn: Callable[[], None], backend: Callable):
        before = ledger.launch_counts()
        try:
            self.impl = backend(fn)
        finally:
            after = ledger.launch_counts()
            ledger.set_launch_counts(before)
        self.delta = {k: after[k] - before[k] for k in before if after[k] != before[k]}
        self._counters = [(*ledger.counter(k), d) for k, d in self.delta.items()]

    @property
    def captured(self) -> bool:
        return self.impl.captured

    def replay(self) -> None:
        self.impl.replay()
        for obj, attr, d in self._counters:
            setattr(obj, attr, getattr(obj, attr) + d)


def _call(key, fn: Callable[[], None]) -> None:
    del key
    fn()


def _same(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class Loop:
    """A built step's iteration structure (module docstring).

    ``names``: the quantities it carries; ``unit``: iterations of a full
    body; ``body(cur, nxt, depth)`` advances ``depth <= unit`` iterations
    from ``cur`` into ``nxt`` (``State``; the same set when ``in_place``).
    ``work(stacks)``: one set of working tensors (a working loop);
    ``extra(stacks)``: one set of extra tensors; ``enter(stacks, cur)`` and
    ``leave(stacks, cur)``: the device work before and after the bodies.
    ``resume``: a call whose stacks are untouched since the last call left
    them (the same tensors at the same version) takes up that call's state
    and skips ``enter``."""

    def __init__(self, names: Sequence[str], unit: int, body: Callable, *, work: Callable = None,
                 extra: Callable = None, enter: Callable = None, leave: Callable = None,
                 in_place: bool = False, resume: bool = False):
        if unit < 1:
            raise ValueError(f"unit must be >= 1, got {unit}")
        if in_place and (work is not None or extra is not None):
            raise ValueError("an in-place loop carries the stacks alone")
        self.names = list(names)
        self.unit = int(unit)
        self.body, self.work, self.extra = body, work, extra
        self.enter, self.leave = enter, leave
        self.in_place, self.resume = in_place, resume
        #: the captured phases, by key (bounded by ``max_graphs``)
        self.graphs: Dict[tuple, Graph] = {}
        #: graph backend: None picks ``CudaGraph`` on the card, ``Eager`` on the CPU
        self.backend: Optional[Callable] = None
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self._pair = None
        self._sig = None
        self._kept = None
        self._pool = None
        self._stream = None
        self._failed: Dict[tuple, str] = {}

    @property
    def max_graphs(self) -> int:
        """Enter and leave per set, one body per depth and set."""
        return 2 * self.unit + 4

    @property
    def captured(self) -> bool:
        """Does the loop hold CUDA graphs (False on the CPU)?"""
        return any(g.captured for g in self.graphs.values())

    def depths(self, steps: int) -> List[int]:
        """The bodies' depths for ``steps`` iterations: full units, then the
        remainder."""
        full, rem = divmod(steps, self.unit)
        return [self.unit] * full + ([rem] if rem else [])

    def release(self) -> None:
        """Drop every graph, their memory pool and the loop's own tensors
        (the spare or working sets; the next call makes them anew)."""
        self._drop_graphs()
        self._pair = self._sig = self._kept = None

    def _drop_graphs(self) -> None:
        if any(isinstance(g.impl, CudaGraph) for g in self.graphs.values()):
            torch.cuda.synchronize()  # no graph is destroyed while it runs
        self.graphs.clear()
        self._failed.clear()
        self._pool = None

    def run(self, curr: Dict[str, torch.Tensor], steps: int = 1, capture: bool = False
            ) -> Dict[str, torch.Tensor]:
        """Advance ``steps`` iterations of the quantities in ``curr``; returns
        ``curr`` with each name bound to the storage that holds its result.
        ``capture`` replays the phases' graphs (capturing each at its first
        occurrence)."""
        steps = operator.index(steps)
        if steps < 1:
            return curr
        stacks = [curr[n] for n in self.names]
        cur, nxt, p, resumed = self._bind(stacks)
        phase = self._replay if capture else _call
        if self.enter is not None and not resumed:
            phase(("enter", p), functools.partial(self.enter, stacks, cur))
        for depth in self.depths(steps):
            phase(("body", depth, p), functools.partial(self.body, cur, nxt, depth))
            if not self.in_place:
                cur, nxt, p = nxt, cur, 1 - p
        if self.leave is not None:
            phase(("leave", p), functools.partial(self.leave, stacks, cur))
        if self.work is None and not self.in_place:
            for name, t in zip(self.names, cur.fields):
                curr[name] = t
        self._keep(curr, p)
        if not capture and not self.resume and not self.in_place:
            # uncaptured, a step holds between calls only what it held
            # before capture existed: the stacks
            self.release()
        return curr

    # --- binding ------------------------------------------------------------------

    def _new_set(self, stacks, fields) -> State:
        return State(fields, self.extra(stacks) if self.extra is not None else ())

    def _bind(self, stacks: List[torch.Tensor]):
        """The set holding the state, the other set, the former's index and
        whether the last call's state is taken up."""
        if self.in_place:
            s = State(stacks)
            self._pair = (s, s)
        elif self.work is None:
            pair = self._pair
            if pair is None or not (_same(stacks, pair[0].fields) or _same(stacks, pair[1].fields)):
                # new stacks: they become the first set, the spare set is made anew
                self._pair = (self._new_set(stacks, stacks),
                              self._new_set(stacks, [torch.empty_like(t) for t in stacks]))
                self._kept = None
        elif self._pair is None:
            self._pair = (self._new_set(stacks, self.work(stacks)), self._new_set(stacks, self.work(stacks)))
        pair = self._pair
        sig = frozenset(t.data_ptr() for s in pair for t in s.tensors()) | {t.data_ptr() for t in stacks}
        if sig != self._sig:
            self._drop_graphs()  # the graphs read storage that is gone
            self._sig = sig
        p = 1 if self.work is None and not self.in_place and _same(stacks, pair[1].fields) else 0
        resumed = False
        kept = self._kept
        if self.resume and kept is not None and all(
                t is s and t._version == v for s, (t, v) in zip(stacks, kept[1])):
            p, resumed = kept[0], True
        return pair[p], pair[1 - p], p, resumed

    def _keep(self, curr, p: int) -> None:
        if not self.resume:
            return
        stacks = [curr[n] for n in self.names]
        # inference tensors have no version counter
        self._kept = None if any(t.is_inference() for t in stacks) else (p, [(t, t._version) for t in stacks])

    # --- the captured phases ------------------------------------------------------

    def _backend(self, device: torch.device) -> Callable:
        if self.backend is not None:
            return self.backend
        if device.type != "cuda":
            return Eager
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return functools.partial(CudaGraph, device=device, pool=self._pool, stream=self._stream)

    def _replay(self, key: tuple, fn: Callable[[], None]) -> None:
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            self.replays += 1
            return
        if key in self._failed:
            raise RuntimeError(f"the step's phase {key} could not be captured: {self._failed[key]}")
        fn()  # the first occurrence runs uncaptured: the warm-up, and real work
        device = self._pair[0].fields[0].device
        t0 = time.perf_counter()
        try:
            self.graphs[key] = Graph(fn, self._backend(device))
        except Exception as e:
            self._failed[key] = f"{type(e).__name__}: {e}"
            raise
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1


def window_loop(names: Sequence[str], unit: int, body: Callable, window: tuple) -> Loop:
    """A working loop over the ``window`` view of each quantity's stack (its
    interior): ``enter`` copies each view into the working set, ``leave``
    copies the result back."""

    def work(stacks):
        return [torch.empty_like(t[window], memory_format=torch.contiguous_format) for t in stacks]

    def enter(stacks, cur):
        for b, t in zip(cur.fields, stacks):
            b.copy_(t[window])

    def leave(stacks, cur):
        for b, t in zip(cur.fields, stacks):
            t[window].copy_(b)

    return Loop(names, unit, body, work=work, enter=enter, leave=leave)


def as_step(loop: Loop) -> Callable:
    """``step(curr, steps) -> curr``: the loop run uncaptured (what
    ``make_step`` and the models return); ``step._loop`` is the loop that
    ``DistributedDomain.run_step`` captures, ``step.captured`` whether its
    last captured run held CUDA graphs."""

    def step(curr: Dict[str, torch.Tensor], steps: int = 1) -> Dict[str, torch.Tensor]:
        return loop.run(curr, steps)

    step._loop = loop
    step.captured = False
    return step
