"""Discrete candidate spaces of the autotuner (counterpart of
``stencil_tpu/tune/space.py``).

The axes are the JAX package's: the temporal depth ``k`` (wrap) / ``m``
(wavefront, with ``halo_multiplier == m``), the z-ring vs padded layout, the
stream plan's route, depth and grouping, the split-step ``overlap``, the
fused ``halo``, the exchange route, the ``compute_unit`` (with its
``mxu_input``) and the ``storage_dtype``.  Every space holds the current
static pick, so the winner is never worse than the no-tune fallback under
the same protocol, and each list keeps the JAX package's order.

Two deliberate differences (ROADMAP.md):

* where the JAX package prices a depth with its VMEM model, the port prices
  it with its Hopper shared-memory models: the wrap form's marches
  (``jacobi_kernels.wrap_smem_fits``), the wavefront kernel
  (``wavefront_smem_fits``) and the stream wavefront (``stream.
  stream_smem_fits``).  A depth they refuse is counted in ``prefiltered``
  (``tune.pruned``) and never launched;
* the port refuses in-place wavefronts, so every ``alias=True`` candidate
  (the ``for alias in (False, True)`` of the wavefront space, the stream
  space's alias flip) is counted in ``prefiltered``, not generated; the
  port's candidates carry ``alias=False``, its one form.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def candidate_label(cand: dict) -> str:
    """A short, stable label for logs and fault plans, e.g. ``alias=0/k=8``
    (``stencil_tpu/tune/space.py:61``): ``/``-separated, because
    ``STENCIL_FAULT_PLAN`` splits its entries on commas."""
    parts = []
    for k in sorted(cand):
        v = cand[k]
        if isinstance(v, bool):
            v = int(v)
        parts.append(f"{k}={v}")
    return "/".join(parts)


#: candidate fields derived from the depth, ignored when comparing
#: candidates for deeper-neighbour pruning
_DERIVED_FIELDS = ("halo_multiplier",)


def deeper_neighbors(cand: dict, candidates: List[dict], depth_key: Optional[str]) -> List[dict]:
    """The candidates equal to ``cand`` but for a larger ``depth_key``
    value, which a VMEM_OOM at ``cand`` proves cannot run either
    (``stencil_tpu/tune/space.py:81``)."""
    if not depth_key or depth_key not in cand:
        return []

    def base_of(c):
        return {k: v for k, v in c.items() if k != depth_key and k not in _DERIVED_FIELDS}

    base = base_of(cand)
    return [
        c
        for c in candidates
        if c is not cand and c.get(depth_key) is not None and base_of(c) == base and c[depth_key] > cand[depth_key]
    ]


#: the depth grid (``stencil_tpu/tune/space.py:109``)
_DEPTH_GRID = (4, 8, 12, 16, 20, 24)


def jacobi_wrap_space(shape: Tuple[int, int, int], itemsize: int, static_k: int, ks=None,
                      dtype=None) -> Tuple[List[dict], int]:
    """(candidates, prefiltered) over the wrap kernel's depth ``k`` and, at
    the static depth, the compute-unit and storage twins
    (``stencil_tpu/tune/space.py:112-193``): ``mxu`` only on f32 fields,
    ``mxu_band`` (and its bf16-operand leg) only where the plane admits a
    band tile, ``bf16`` storage only on f32 fields, each twin priced by the
    wrap marches' shared memory (``wrap_smem_fits``; the levels run at the
    native itemsize under bf16 storage).  ``ks`` overrides the depth grid;
    ``dtype`` (default f32) drives the twins' gates."""
    import torch

    from stencil_tpu_torch.ops.jacobi_kernels import (
        _dtype,
        band_tile_plan,
        bf16_supported,
        mxu_supported,
        wrap_smem_fits,
    )

    dtype = _dtype(dtype or torch.float32)
    X, Y, Z = shape
    grid = sorted({static_k, *(ks if ks is not None else _DEPTH_GRID)})
    grid = [k for k in grid if 1 <= k <= max(1, X // 2)]
    kept, prefiltered = [], 0
    for k in grid:
        # the static pick always runs (it is the fallback being defended)
        if k == static_k or wrap_smem_fits(k, "vpu", itemsize):
            kept.append({"k": k, "compute_unit": "vpu", "storage_dtype": "native"})
        else:
            prefiltered += 1
    if mxu_supported([dtype]) and wrap_smem_fits(static_k, "mxu", itemsize):
        kept.append({"k": static_k, "compute_unit": "mxu", "storage_dtype": "native"})
    else:
        prefiltered += 1
    if mxu_supported([dtype]) and band_tile_plan(Y, Z) is not None and wrap_smem_fits(static_k, "mxu_band", itemsize):
        kept.append({"k": static_k, "compute_unit": "mxu_band", "storage_dtype": "native"})
        kept.append({"k": static_k, "compute_unit": "mxu_band", "storage_dtype": "native", "mxu_input": "bf16"})
    else:
        prefiltered += 2
    if bf16_supported([dtype]) and wrap_smem_fits(static_k, "vpu", itemsize):
        kept.append({"k": static_k, "compute_unit": "vpu", "storage_dtype": "bf16"})
    else:
        prefiltered += 1
    return kept, prefiltered


def jacobi_wavefront_space(
    static_m: int,
    depth_cap: int,
    z_ring_eligible: bool,
    static_z_ring: bool,
    ms=None,
    mxu_ok: bool = False,
    bf16_ok: bool = False,
    band_ok: bool = False,
    itemsize: int = 4,
) -> Tuple[List[dict], int]:
    """(candidates, prefiltered) over the multi-subdomain wavefront
    (``stencil_tpu/tune/space.py:196-253``): depth ``m`` (the halo
    multiplier), the layout and, at the static depth, the z-ring twin and
    the compute-unit / storage twins (``mxu_ok`` / ``bf16_ok`` /
    ``band_ok``: the caller's structural gates).  ``depth_cap`` is the
    structural bound.  The JAX package's ``alias=True`` candidate at every
    depth is counted, not generated, and so is a depth, or a unit twin,
    whose kernel the H100's shared memory refuses at the working
    ``itemsize`` (``wavefront_smem_fits``); the static depth always stays."""
    from stencil_tpu_torch.ops.jacobi_kernels import wavefront_smem_fits

    grid = sorted({static_m, *(ms if ms is not None else _DEPTH_GRID)})
    grid = [m for m in grid if 1 <= m <= depth_cap]
    cands: List[dict] = []
    prefiltered = 0

    def cand(m, alias, z_ring, unit="vpu", storage="native"):
        return {
            "m": m,
            "halo_multiplier": m,
            "alias": alias,
            "z_ring": z_ring,
            "compute_unit": unit,
            "storage_dtype": storage,
        }

    for m in grid:
        if m != static_m and not wavefront_smem_fits(m, "vpu", itemsize):
            prefiltered += 2  # both alias forms
            continue
        cands.append(cand(m, False, static_z_ring and z_ring_eligible))
        prefiltered += 1  # alias=True: the in-place wavefront, refused
    if z_ring_eligible:
        cands.append(cand(static_m, False, not static_z_ring))
    static_ring = static_z_ring and z_ring_eligible
    if mxu_ok and wavefront_smem_fits(static_m, "mxu", itemsize):
        cands.append(cand(static_m, False, static_ring, unit="mxu"))
    else:
        prefiltered += 1
    if mxu_ok and band_ok and wavefront_smem_fits(static_m, "mxu_band", itemsize):
        cands.append(cand(static_m, False, static_ring, unit="mxu_band"))
        c = cand(static_m, False, static_ring, unit="mxu_band")
        c["mxu_input"] = "bf16"
        cands.append(c)
    else:
        prefiltered += 2
    if bf16_ok:
        cands.append(cand(static_m, False, static_ring, storage="bf16"))
    else:
        prefiltered += 1
    return cands, prefiltered


def exchange_space(dd) -> Tuple[List[dict], int]:
    """(candidates, prefiltered) over the exchange's y/z-sweep route for a
    realized domain (``stencil_tpu/tune/space.py:256-296``): ``direct``, the
    static fallback, then each packed route that can engage (a ``zpack_*``
    route needs a z sweep, a ``yzpack_*`` route a y sweep); the others are
    counted, not generated."""
    from stencil_tpu_torch.ops.exchange import EXCHANGE_ROUTES, Y_PACK_ROUTES, ypack_supported, zpack_supported

    cands: List[dict] = [{"exchange_route": "direct"}]
    shell = dd.shell_radius()
    dtypes = [dd.field_dtype(h) for h in dd._handles]
    valid_last = dd.valid_last()
    z_ok = (
        shell is not None
        and (shell.axis(2, -1) > 0 or shell.axis(2, +1) > 0)
        and zpack_supported(dtypes, valid_last)
    )
    y_ok = (
        shell is not None
        and (shell.axis(1, -1) > 0 or shell.axis(1, +1) > 0)
        and ypack_supported(dtypes, valid_last)
    )
    prefiltered = 0
    for route in EXCHANGE_ROUTES[1:]:
        if y_ok if route in Y_PACK_ROUTES else z_ok:
            cands.append({"exchange_route": route})
        else:
            prefiltered += 1
    return cands, prefiltered


def stream_space(dd, x_radius: int, separable: bool, static_plan: dict,
                 mxu_ok: bool = False) -> Tuple[List[dict], int]:
    """(candidates, prefiltered) of whole stream-engine plans around the
    static pick (``stencil_tpu/tune/space.py:299-455``): the static plan,
    its two shallower depths, the plane route as the m = 1 baseline, the
    split twins (of the static plan, through its plain form, and of the
    plane baseline), the fused-halo twin (counted when
    ``fused_halo_ineligible``), and the ``mxu`` / ``mxu_band`` twins (counted
    unless ``mxu_ok``: the kernel declares its contraction form and computes
    at f32; ``mxu_band`` also needs a band tile of the raw plane).  Every
    candidate carries ``overlap``, ``halo`` and ``compute_unit``, and each
    non-wrap one ``alias=False``; the JAX package's alias flip is counted,
    not generated.  A non-static wavefront candidate whose pass the H100's
    shared memory refuses (``stream_smem_fits`` at its grouping's field
    count and unit; the counterpart of the JAX package's static VMEM and
    legality verdicts) is counted too."""
    from stencil_tpu_torch.ops.jacobi_kernels import band_tile_plan
    from stencil_tpu_torch.ops.stream import (
        fused_halo_ineligible,
        plain_wavefront_plan,
        plan_stream,
        ring_itemsize,
        stream_smem_fits,
    )

    cands: List[dict] = []

    def add(plan: dict, alias: Optional[bool], overlap: str = "off", unit: str = "vpu",
            halo: str = "array") -> None:
        c = dict(plan)
        if alias is not None:
            c["alias"] = alias
        c["overlap"] = overlap
        c["halo"] = halo
        c["compute_unit"] = unit
        c.setdefault("halo_multiplier", c.get("m", 1))
        if c not in cands:
            cands.append(c)

    prefiltered = 0
    static_alias = False  # the port's one form: a fresh output every pass
    add(static_plan, static_alias if static_plan["route"] != "wrap" else None)
    if static_plan["route"] in ("wavefront", "wrap"):
        m = static_plan["m"]
        depths = sorted({d for d in (*_DEPTH_GRID, m // 2) if 2 <= d < m})[-2:]
        for d in depths:
            shallower = plan_stream(dd, x_radius, static_plan["route"], separable, max_m=d)
            add(shallower, static_alias if shallower["route"] != "wrap" else None)
        if static_plan["route"] == "wavefront":
            prefiltered += 1  # the alias flip: an in-place pass, refused
    if static_plan["route"] != "plane":
        try:
            add(plan_stream(dd, x_radius, "plane", separable), None)
        except ValueError:
            pass
    split_bases: List[Tuple[dict, Optional[bool]]] = []
    if static_plan["route"] in ("plane", "wavefront"):
        base = static_plan
        if static_plan.get("z_slabs"):
            base = plain_wavefront_plan(static_plan)
        if base is not None:
            split_bases.append((base, static_alias))
    for c in cands:
        if c["route"] == "plane" and c["overlap"] == "off":
            split_bases.append((c, c.get("alias")))
            break
    for base, alias_pick in split_bases:
        b = {k: v for k, v in base.items() if k not in ("overlap", "halo", "halo_multiplier")}
        add(b, alias_pick, overlap="split")
    fused_base = None
    if static_plan["route"] in ("plane", "wavefront"):
        fused_base = static_plan
        if static_plan.get("z_slabs"):
            fused_base = plain_wavefront_plan(static_plan)
    if fused_base is not None and fused_halo_ineligible(
        dd,
        dict(fused_base, overlap="off", z_slabs=fused_base.get("z_slabs", False)),
        dd.exchange_route(),
    ) is None:
        b = {k: v for k, v in fused_base.items() if k not in ("overlap", "halo", "halo_multiplier")}
        add(b, static_alias, halo="fused")
    else:
        prefiltered += 1
    if mxu_ok:
        b = {k: v for k, v in static_plan.items() if k not in ("overlap", "halo_multiplier", "compute_unit")}
        add(b, static_alias if static_plan["route"] != "wrap" else None, unit="mxu")
        raw = dd.local_spec().raw_size()
        if band_tile_plan(raw.y, raw.z) is not None:
            add(b, static_alias if static_plan["route"] != "wrap" else None, unit="mxu_band")
        else:
            prefiltered += 1
    else:
        prefiltered += 2
    # the shared-memory verdict (the static pick always survives)
    item = ring_itemsize([dd.field_dtype(h) for h in dd._handles])
    kept = []
    for c in cands:
        is_static = (
            all(c.get(k) == v for k, v in static_plan.items() if k not in ("halo_multiplier", "alias"))
            and c.get("overlap", "off") == "off"
            and c.get("halo", "array") == "array"
            and c.get("compute_unit", "vpu") == "vpu"
        )
        fields = 1 if c.get("grouping") == "per-field" else len(dd._handles)
        if not is_static and c["route"] == "wavefront" and not stream_smem_fits(
                c["m"], fields, item, c.get("compute_unit", "vpu")):
            prefiltered += 1
        else:
            kept.append(c)
    return kept, prefiltered
