"""Throughput packing: the batch planner and the sub-slice bin-packer.

Counterpart of ``stencil_tpu/serve/pack.py``.  Serial dispatch serves ONE
request per cycle, so tenants timeshare the fleet.  This module gives
``StencilServer.cycle`` two concurrency mechanisms behind one scheduler,
both bitwise-pinned by the soak's packed legs:

* **batched dispatch**: requests whose workloads share a step GEOMETRY
  (same domain shape, subdomain grid, route, dtypes, slots: the tuple the
  AOT key digests) are copied and run in ONE call (``BatchExecutor``): the
  CUDA kernels take one stack a launch, so the call runs the members in
  order over their copies on the current stream, with no synchronization
  between them.  Per-tenant results install only when the whole call
  succeeded; a classified failure against any member falls the group back
  to serial re-execution, so the per-tenant fault envelopes keep their
  exact semantics.

* **sub-slice bin-packing**: tenants whose shapes DON'T match are
  bin-packed onto disjoint contiguous sub-slices of the fleet (greedy
  decreasing by state footprint, each tenant taking the cheapest remaining
  slice under the measured ``fabric.link_model`` cost), then dispatched
  back-to-back without an intermediate synchronization.

The fleet is a list of slots (``parallel/topology.slots_on``: the places of
subdomains on the card), the port's stand-in for the JAX device list, as a
subdomain count stands in for a device count everywhere else in the port.
A tenant sits on the first ``num_subdomains()`` slots until a sub-slice
placement gives it others (``tenant_slots``); placing it on a slice of
another width is ``dd.reshard(subdomains=len(slice))`` and
``rebuild_after_reshard()``.  Slots on different cards wait for more than
one card (ROADMAP.md item 13b).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from stencil_tpu_torch.utils.logging import log_info

#: the packed dispatch modes the scheduler can pick (serial dispatch is the
#: ABSENCE of packing, not a mode)
SERVE_MODES = ("batched", "subslice")


# --- slots -------------------------------------------------------------------


def tenant_slots(model) -> Tuple[int, ...]:
    """The fleet slot ids a tenant's subdomains sit on: the slice
    ``place_subslices`` gave it while its subdomain count still matches,
    else the first ``num_subdomains()`` slots (a domain places its
    subdomains on ``slots_on(device, n)``, ids 0..n-1).  ``()`` without a
    realized domain."""
    dd = getattr(model, "dd", None)
    if dd is None or not getattr(dd, "_realized", False):
        return ()
    n = int(dd.num_subdomains())
    placed = getattr(model, "_serve_slice", None)
    if placed is not None and len(placed) == n:
        return tuple(placed)
    return tuple(range(n))


# --- geometry keys -----------------------------------------------------------


def geometry_key(model, steps: int) -> Optional[tuple]:
    """The batch-compatibility key: two requests may share one batched
    dispatch iff their keys are equal: same autotuner workload digest
    (card / domain / subdomain grid / route / dtype, ``tune/key.py``), same
    buffer shapes and dtypes (halo multiplier and storage axis included),
    same device and slots, same step count.  ``None`` = not batchable (no
    realized domain under the model)."""
    dd = getattr(model, "dd", None)
    step = getattr(model, "_step", None)
    if dd is None or step is None or not getattr(dd, "_realized", False):
        return None
    buffers = tuple(
        (name, tuple(arr.shape), str(arr.dtype))
        for name, arr in sorted(dd._curr.items())
    )
    slots = (str(dd.device), int(dd.num_subdomains()), tenant_slots(model))
    return (
        dd.tune_key(dd.exchange_route()).digest(),
        buffers,
        slots,
        int(steps),
    )


def footprint_bytes(model) -> int:
    """The tenant's resident field-state bytes: the greedy bin-packer's
    decreasing sort key (the biggest tenant chooses its slice first)."""
    dd = getattr(model, "dd", None)
    if dd is None or not getattr(dd, "_realized", False):
        return 0
    return sum(int(arr.numel()) * int(arr.element_size()) for arr in dd._curr.values())


def _packable(tenant) -> bool:
    return (
        tenant is not None
        and tenant.active()
        and tenant.model is not None
        and getattr(tenant.model, "dd", None) is not None
        and getattr(tenant.model.dd, "_realized", False)
    )


def _oldest_per_tenant(pending, rotation) -> list:
    """The oldest queued request of each tenant, in rotation-fair order
    (tenants outside the rotation ride at the back in queue order)."""
    oldest: Dict[str, object] = {}
    for r in pending:
        if r.tenant not in oldest:
            oldest[r.tenant] = r
    order = [t for t in rotation if t in oldest]
    order += [t for t in oldest if t not in order]
    return [oldest[t] for t in order]


# --- the batch planner -------------------------------------------------------


def plan_batches(pending, tenants, rotation, batch_max: int):
    """Pick ONE batch group: the oldest queued request of each packable
    tenant, grouped by ``geometry_key``; the first group (rotation-fair
    order) with >= 2 members dispatches together, capped at ``batch_max``.
    Returns the request list, or ``None`` when nothing groups."""
    if batch_max < 2:
        return None
    keyed: Dict[tuple, list] = {}
    for r in _oldest_per_tenant(pending, rotation):
        t = tenants.get(r.tenant)
        if not _packable(t):
            continue
        k = geometry_key(t.model, r.steps)
        if k is None:
            continue
        keyed.setdefault(k, []).append(r)
    for group in keyed.values():
        if len(group) >= 2:
            return group[:batch_max]
    return None


class BatchExecutor:
    """Runs a geometry-matched group as ONE call over copies of the
    members' states.  Results install only on success: an exception leaves
    every tenant's state untouched for the serial fallback.

    The JAX package compiles a batched callable (``vmap``, or a ``lax.scan``
    over its plane pipeline) and caches it per geometry.  The port's CUDA
    kernels take one stack a launch, so it has no batch axis: the call runs
    the resolved step over each member's copy in turn, on the current
    stream, with no synchronization between them, and holds no step past
    the call (a step a reshard or a descent replaced is freed with its
    buffers).  Each member's step is the unbatched step itself, so its
    result is bitwise a serial dispatch's.  As in the JAX package the step
    runs outside ``DistributedDomain.run_step``: no watchdog, sentinel or
    step and byte tally for batched members."""

    @staticmethod
    def _resolved(model):
        """The step to batch over: a ladder-backed step (``make_stream_step``)
        batches its CURRENTLY-BUILT rung, so degradation decisions keep
        applying under batching; a model's own step batches itself.  It runs
        uncaptured: a captured step's graphs are bound to its tenant's own
        stacks, which the batched call must not write."""
        step = model._step
        ladder = getattr(step, "_resilience", None)
        return ladder.built() if ladder is not None else step

    def run(self, models: Sequence, steps: int) -> None:
        fn = self._resolved(models[0])
        names = sorted(models[0].dd._curr)
        # the call steps COPIES while every tenant's own stacks stay as they
        # were (the serial fallback).  One clone a member, not one
        # torch.stack: views of one stacked base share its version counter,
        # so a member's writes would bump its batch-mates' versions and a
        # resumable step (the z-ring wavefront) would re-prime its working
        # set at each of their later calls.
        copies = [{n: m.dd._curr[n].clone() for n in names} for m in models]
        out = [fn(c, steps) for c in copies]
        for m, res in zip(models, out):
            m.dd._curr = {n: res[n] for n in names}
            m.dd.mark_shell_stale()


# --- the sub-slice bin-packer ------------------------------------------------


def plan_subslice_candidates(pending, tenants, rotation):
    """The oldest queued request of each DISTINCT packable tenant whose
    model can move grids (``rebuild_after_reshard``), rotation-fair order;
    ``None`` unless at least two tenants qualify."""
    picks = []
    for r in _oldest_per_tenant(pending, rotation):
        t = tenants.get(r.tenant)
        if not _packable(t):
            continue
        if not hasattr(t.model, "rebuild_after_reshard"):
            continue
        picks.append(r)
    return picks if len(picks) >= 2 else None


def _slice_cost(model, slots, link) -> float:
    """Modelled shell-exchange seconds a step for ``model`` on ``slots``
    under a measured ``fabric.link_model`` doc: per grid axis, two shells of
    that axis's face area cross the axis's slowest measured link.  ``link``
    is a doc (uniform fabric), a callable ``slots -> doc`` (per-slice
    measured docs), or ``None`` (no fabric data: every slice prices equal
    and the greedy order decides)."""
    doc = link(slots) if callable(link) else link
    axes = (doc or {}).get("axes") or {}
    if not axes:
        return 0.0
    dd = model.dd
    size = dd.size()
    bytes_per_cell = sum(dd.field_dtype(h).itemsize for h in dd._handles)
    area = {
        "x": size.y * size.z,
        "y": size.x * size.z,
        "z": size.x * size.y,
    }
    cost = 0.0
    for axis, face in area.items():
        sides = axes.get(axis)
        if not sides:
            continue
        gbps = min(
            float(s.get("gbps_min", s.get("gbps_med", 0.0)) or 0.0)
            for s in sides.values()
        )
        if gbps <= 0.0:
            continue
        cost += (2.0 * face * bytes_per_cell) / (gbps * 1e9)
    return cost


def plan_subslices(entries, fleet, link=None):
    """Greedy decreasing bin-pack of tenants onto DISJOINT contiguous
    sub-slices of ``fleet`` (a list of slots): the fleet splits into equal
    contiguous slices (one per tenant), tenants sort by descending state
    footprint, and each takes the cheapest remaining slice under
    ``_slice_cost``.  ``entries`` is ``[(request, model), ...]`` (distinct
    tenants); returns ``[(request, model, slice_slots), ...]`` or ``None``
    when the fleet cannot give every tenant a slot."""
    k = min(len(entries), len(fleet))
    if k < 2:
        return None
    entries = list(entries)[:k]
    width = len(fleet) // k
    slices = [tuple(fleet[i * width : (i + 1) * width]) for i in range(k)]
    order = sorted(
        entries, key=lambda e: footprint_bytes(e[1]), reverse=True
    )
    remaining = list(range(k))
    assigned = []
    for req, model in order:
        best = min(
            remaining, key=lambda i: (_slice_cost(model, slices[i], link), i)
        )
        remaining.remove(best)
        assigned.append((req, model, slices[best]))
    return assigned


def place_subslices(assignments) -> int:
    """Move each assigned tenant onto its disjoint sub-slice (a no-op when
    already there): a slice of another width is an in-memory reshard to
    that many subdomains plus the model's step rebuild; a slice of the same
    width on other slots of the one card moves no data, and only the
    tenant's slots change.  Placement is all that happens here: the server
    then dispatches every request through its unchanged serial envelope
    back-to-back, and each tenant's fields stay bitwise identical to
    full-fleet serial execution (grid-shape independence, pinned by the
    soak's ``subslice`` leg).  A reshard failure leaves the tenant's state
    as it was (``DistributedDomain.reshard``), so the caller can degrade to
    serial dispatch on whatever grid each tenant holds.  Returns how many
    tenants moved."""
    moved = 0
    for req, model, slots in assignments:
        current = tenant_slots(model)
        want = tuple(sorted(s.id for s in slots))
        if current != want:
            if model.dd.num_subdomains() != len(want):
                model.dd.reshard(subdomains=len(want), source="subslice")
                model.rebuild_after_reshard()
            model._serve_slice = want
            moved += 1
            log_info(
                f"serve: packed tenant {req.tenant} onto sub-slice "
                f"{list(want)}"
            )
    return moved
