"""The autotune searches of the shipped workloads (counterpart of
``stencil_tpu/tune/runners.py``).

Each runner builds the workload key, computes the static pick under
``tune.disabled()`` (the fallback a search must beat, never its own cached
result), generates the candidate space and hands ``tune.ensure`` a
``build_run`` whose ``run(n)`` runs ``n`` raw iterations of the candidate
and then ``torch.cuda.synchronize`` (the JAX runners' ``_force_done``).  On
a CUDA device every trial launches the hand-written kernels of its route; on
the CPU (the tests) the same calls run the plain versions.  A trial never
falls back: a model whose degradation ladder stepped down while a trial
built or ran it raises with the descent's failure class, and the search
prunes the candidate.  All candidate state stays resident for the whole
search (the alternating rounds need every candidate in one process) and is
freed when it ends.
"""

from __future__ import annotations

from typing import Optional

import torch

from stencil_tpu_torch import tune
from stencil_tpu_torch.device import sync
from stencil_tpu_torch.tune import space
from stencil_tpu_torch.tune.key import WorkloadKey, chip_kind
from stencil_tpu_torch.tune.trial import TuneReport


class LadderDescended(RuntimeError):
    """A trial's model stepped down its degradation ladder, so it no longer
    runs the candidate: classified as the descent's failure class."""

    def __init__(self, what: str, descents):
        super().__init__(f"{what}: the degradation ladder stepped down {descents}; the candidate did not run as "
                         "configured")
        self.failure_class = descents[0][1]


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def autotune_jacobi_wrap(x: int, y: int, z: int, dtype=None, device="cuda", reps: int = 3, ks=None,
                         rt: Optional[float] = None) -> TuneReport:
    """Tune the single-subdomain wrap kernel's depth ``k``, with the unit and
    storage twins at the static depth (``stencil_tpu/tune/runners.py:32-120``).
    A trial is ``jacobi_wrap_step`` over one ``(x, y, z)`` block: ``n // k``
    calls of k levels and one of ``n % k`` (the search sizes ``n`` to whole
    calls), ping-ponged between two buffers a storage dtype, made at the
    first build that needs them (a warm cache touches no device memory)."""
    from stencil_tpu_torch.device import resolve_device
    from stencil_tpu_torch.ops.jacobi_kernels import _dtype, choose_temporal_k, jacobi_wrap_step

    dev = resolve_device(device)
    dtype = _dtype(dtype or torch.float32)
    key = WorkloadKey(chip=chip_kind(dev), domain=(x, y, z), dtype=_dtype_name(dtype), n_fields=1,
                      mesh=(1, 1, 1), radius=1, route="jacobi-wrap")
    with tune.disabled():
        static_k = choose_temporal_k((x, y, z))
    candidates, prefiltered = space.jacobi_wrap_space((x, y, z), dtype.itemsize, static_k, ks=ks, dtype=dtype)
    state = {}

    def build_run(cand):
        storage = cand.get("storage_dtype", "native")
        bdt = torch.bfloat16 if storage == "bf16" else dtype
        if storage not in state:
            state[storage] = [torch.full((x, y, z), 0.5, dtype=bdt, device=dev), torch.empty((x, y, z), dtype=bdt,
                                                                                              device=dev)]
        bufs = state[storage]
        k = cand["k"]
        kw = {"compute_unit": cand.get("compute_unit", "vpu"), "f32_accumulate": storage == "bf16",
              "mxu_input": cand.get("mxu_input", "f32")}

        def run(n):
            a, b = bufs
            blocked, rem = divmod(n, k)
            for depth in [k] * blocked + ([rem] if rem else []):
                jacobi_wrap_step(a, depth, out=b, **kw)
                a, b = b, a
            bufs[0], bufs[1] = a, b
            sync(dev)

        return run

    report = tune.ensure(key, candidates, build_run, depth_key="k",
                         static={"k": static_k, "compute_unit": "vpu", "storage_dtype": "native"},
                         reps=reps, rt=rt, prefiltered=prefiltered)
    state.clear()
    return report


def autotune_jacobi_wavefront(x: int, y: int, z: int, dtype=None, device="cuda", subdomains: int = None,
                              partition=None, reps: int = 3, ms=None, rt: Optional[float] = None,
                              strategy=None) -> TuneReport:
    """Tune the multi-subdomain Jacobi wavefront: depth ``m`` (the halo
    multiplier), the z-ring vs padded layout and the unit and storage twins
    (``stencil_tpu/tune/runners.py:123-247``).  Each candidate is a realized
    ``Jacobi3D`` built as the caller's model will be (``subdomains``,
    ``partition`` and ``strategy`` must match it: they key the workload),
    its ``step(n)`` the trial.  The candidates' models are freed when the
    search ends."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.ops.jacobi_kernels import (
        _ZRING_OFF,
        _dtype,
        band_tile_plan,
        bf16_supported,
        mxu_supported,
    )

    dtype = _dtype(dtype or torch.float32)
    if subdomains is None:
        subdomains = 1 if partition is None else partition[0] * partition[1] * partition[2]

    def make_model(temporal_k="auto", z_ring=None, compute_unit=None, storage_dtype=None, mxu_input=None):
        kwargs = {} if strategy is None else {"strategy": strategy}
        m = Jacobi3D(x, y, z, subdomains=subdomains, dtype=dtype, kernel_impl="cuda", pallas_path="wavefront",
                     temporal_k=temporal_k, z_ring=z_ring, compute_unit=compute_unit, storage_dtype=storage_dtype,
                     mxu_input=mxu_input, device=device, **kwargs)
        if partition is not None:
            m.dd.set_partition(*partition)
        return m

    probe = make_model()
    key = probe.dd.tune_key("jacobi-wavefront")
    with tune.disabled():
        static_m = probe._plan_wavefront()
    info = probe._wavefront_plan_info
    n = info["n"]
    z_ring_eligible = probe._wavefront_z_planned and n[2] % 128 == 0 and 2 * static_m <= _ZRING_OFF
    # the plane the band contraction tiles: the z-ring working plane, or the
    # m-wide shell's raw plane
    plane_z = _ZRING_OFF + n[2] if z_ring_eligible else n[2] + 2 * static_m
    candidates, prefiltered = space.jacobi_wavefront_space(
        static_m,
        # structural caps only: a shard fills an m-wide halo from valid cells,
        # and the periodic coordinate needs 2m < the global extent
        depth_cap=min(info["n_min"], (min(x, y, z) - 1) // 2),
        z_ring_eligible=z_ring_eligible,
        static_z_ring=True,
        ms=ms,
        mxu_ok=mxu_supported([dtype]),
        bf16_ok=bf16_supported([dtype]),
        band_ok=band_tile_plan(n[1] + 2 * static_m, plane_z) is not None,
        itemsize=dtype.itemsize,
    )
    del probe
    models = {}

    def build_run(cand):
        model = make_model(temporal_k=cand["m"], z_ring=cand.get("z_ring"), compute_unit=cand.get("compute_unit"),
                           storage_dtype=cand.get("storage_dtype"), mxu_input=cand.get("mxu_input"))
        model.realize()
        label = space.candidate_label(cand)
        models[label] = model  # resident for the rounds

        def run(n_steps):
            model.step(n_steps)
            model.block_until_ready()
            if model._ladder.descents:
                raise LadderDescended(f"tune:jacobi-wavefront:{label}", model._ladder.descents)

        return run

    report = tune.ensure(key, candidates, build_run, depth_key="m",
                         static={"m": static_m, "halo_multiplier": static_m, "alias": False,
                                 "z_ring": z_ring_eligible, "compute_unit": "vpu", "storage_dtype": "native"},
                         reps=reps, rt=rt, prefiltered=prefiltered)
    models.clear()  # free the candidates' memory before the caller builds its model
    return report


def autotune_exchange(dd, reps: int = 3, rt: Optional[float] = None) -> TuneReport:
    """Tune the exchange's y/z-sweep route for a realized domain
    (``stencil_tpu/tune/runners.py:250-299``).  A trial is ``n`` in-place
    exchanges over the domain's own stacks (exchanging is idempotent on a
    filled domain, so its state does not change); the winner feeds the next
    ``realize()`` of this workload through ``_resolve_exchange_route``."""
    key = dd.tune_key("exchange")
    candidates, prefiltered = space.exchange_space(dd)
    fns = {}

    def build_run(cand):
        route = cand["exchange_route"]
        fn = dd.make_exchange_route_fn(route)
        fns[route] = fn

        def run(n):
            stacks = [dd._curr[h.name] for h in dd._handles]
            for _ in range(n):
                fn(stacks)
            sync(dd.device)

        return run

    report = tune.ensure(key, candidates, build_run, depth_key=None, static={"exchange_route": "direct"},
                         reps=reps, rt=rt, prefiltered=prefiltered)
    fns.clear()
    return report


def autotune_stream(dd, kernel, x_radius: int = 1, separable: bool = False, reps: int = 3,
                    rt: Optional[float] = None, mxu_kernel=None) -> TuneReport:
    """Tune the stream engine's plan (route, depth, grouping, overlap, fused
    halo, compute unit) for a realized domain and user kernel
    (``stencil_tpu/tune/runners.py:302-377``).  Each candidate is resolved as
    a forced plan (``ops/stream.resolve_plan``) and built with all its
    kernels (``_build_plan``: the nvcc runs of new variants land in the
    build, before any timed round); the trials step one copy of the
    domain's stacks, so the domain itself is not advanced, each candidate
    binding it with its own loop's second set.  ``mxu_kernel`` is the
    kernel's declared contraction form; without it the unit twins are
    counted, not generated."""
    from stencil_tpu_torch.ops.jacobi_kernels import mxu_supported, unit_uses_mxu
    from stencil_tpu_torch.ops.stream import _build_plan, plan_stream, resolve_plan

    key = dd.tune_key("stream")
    with tune.disabled():
        static_plan = plan_stream(dd, x_radius, "auto", separable)
    mxu_ok = mxu_kernel is not None and mxu_supported([h.dtype for h in dd._handles])
    candidates, prefiltered = space.stream_space(dd, x_radius, separable, static_plan, mxu_ok=mxu_ok)
    base = {}
    steps = {}

    def build_run(cand):
        plan = resolve_plan(dd, cand, x_radius, separable, overlap=cand["overlap"], halo=cand["halo"],
                            compute_unit=cand["compute_unit"], mxu_input=cand.get("mxu_input", "auto"),
                            mxu_kernel=mxu_kernel,
                            z_slabs=cand.get("z_slabs") if cand["route"] == "wavefront" else None)
        step = _build_plan(dd, plan, mxu_kernel if unit_uses_mxu(plan["compute_unit"]) else kernel, x_radius)
        if not base:
            base.update((name, t.clone()) for name, t in dd._curr.items())
        # the candidate's own binding of the stacks: the shared copy, and
        # then whichever of its loop's two sets holds its result, so that no
        # call makes a new set (the values are the other candidates' too:
        # only the time is read)
        curr = dict(base)
        steps[space.candidate_label(cand)] = (step, curr)

        def run(n):
            step(curr, n)
            sync(dd.device)

        return run

    static = dict(static_plan)
    static.setdefault("halo_multiplier", static.get("m", 1))
    static.setdefault("overlap", "off")
    static.setdefault("halo", "array")
    static.setdefault("compute_unit", "vpu")
    report = tune.ensure(key, candidates, build_run, depth_key="m", static=static, reps=reps, rt=rt,
                         prefiltered=prefiltered)
    steps.clear()
    base.clear()
    return report
