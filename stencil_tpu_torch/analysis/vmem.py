"""The static footprint verdict: a stream plan's shared memory against what
the card grants one block, re-derived where the card would otherwise refuse
the launch.

Counterpart of ``stencil_tpu/analysis/vmem.py:87-135`` (``check_vmem``).
The JAX package prices a plan's VMEM blocks against the scoped-VMEM budget;
the port prices the same plan with the one model its kernels already check
before launch, so there is no second model:

* ``wavefront``: ``ops/stream.stream_smem_bytes`` (the plan's depth, the
  fields a pass carries, the levels' itemsize ``ring_itemsize``, the
  compute unit), the model ``plan_stream``, the stream ladder's prefilter
  and ``stream_wavefront_pass``'s own check read;
* ``wrap`` / ``plane``: ``ops/stream.stream_pass_smem_bytes``, what the
  wrap and plane kernels' launchers ask (none in the vpu form, a staging
  tile and a tile of sums a field under a contracting unit).  Both run one
  level a launch, so their footprint does not grow with the plan's depth:
  a deep ``plane`` plan that the JAX model refuses fits here (ROADMAP.md,
  deliberate differences).

The budget is ``SMEM_PER_BLOCK`` (the H100's 227 KiB a block) unless
``budget`` overrides it.  ``None`` is "fits"; a malformed plan raises.
"""

from __future__ import annotations

from typing import Optional

#: the routes a stream plan names
_ROUTES = ("wrap", "wavefront", "plane")


def plan_smem_bytes(dd, plan: dict) -> int:
    """The shared memory one block of ``plan``'s kernel asks on ``dd``'s
    fields (module docstring): the fields a pass carries (one under
    ``grouping="per-field"``, else all), at the storage dtypes' level
    itemsize."""
    from stencil_tpu_torch.ops.stream import ring_itemsize, stream_pass_smem_bytes, stream_smem_bytes

    route = plan.get("route")
    if route not in _ROUTES:
        raise ValueError(f"not a stream plan: {plan!r}")
    m = int(plan.get("m", 1))
    fields = max(len(dd._handles), 1)
    if plan.get("grouping") == "per-field":
        fields = 1
    unit = plan.get("compute_unit", "vpu")
    if route == "wavefront":
        item = ring_itemsize([dd.field_dtype(h) for h in dd._handles])
        return stream_smem_bytes(m, fields, item, unit)
    return stream_pass_smem_bytes(fields, unit)


def check_vmem(dd, plan: dict, budget: Optional[int] = None) -> Optional[str]:
    """Does this stream plan's kernel fit the shared memory the card grants
    one block, on this domain?  ``None`` = fits; otherwise a reason string
    naming the estimate and the budget, in the JAX package's wording with
    shared-memory bytes in place of VMEM."""
    from stencil_tpu_torch.ops.jacobi_kernels import SMEM_PER_BLOCK, unit_uses_mxu

    est = plan_smem_bytes(dd, plan)
    cap = SMEM_PER_BLOCK if budget is None else int(budget)
    if est > cap:
        unit = plan.get("compute_unit", "vpu")
        tags = "".join(
            t
            for t, on in (
                (f",{unit}", unit_uses_mxu(unit)),
                (",fused", plan.get("halo") == "fused"),
            )
            if on
        )
        return (
            f"plan {plan.get('route')}[m={int(plan.get('m', 1))}{tags}] models "
            f"{est} bytes of shared memory a block against the {cap}-byte budget"
        )
    return None
