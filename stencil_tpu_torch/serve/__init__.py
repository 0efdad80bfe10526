"""Multi-tenant serving layer: admission control, tenant fault isolation,
overload shedding, load-driven elasticity, batched and sub-slice dispatch.

Counterpart of ``stencil_tpu/serve/``, with its public surface:

* ``TenantSpec`` / ``Request`` / ``Response``: the request/response
  vocabulary (``request.py``);
* ``AdmissionRefused``: the classified admission refusal;
* ``BoundedQueue``: the deadline-propagating admission queue;
* ``AOTCache``: built tenant steps by ``tune/key.py`` digest;
* ``Tenant``: the per-tenant resilience envelope;
* ``ElasticityPolicy``: queue depth to grow/shrink, with hysteresis;
* ``StencilServer``: the serving loop tying them together;
* ``pack``: the throughput packers: the geometry-matched batch planner
  (``plan_batches`` / ``BatchExecutor``) and the sub-slice bin-packer
  (``plan_subslices`` / ``place_subslices``).

The driver is ``python -m stencil_tpu_torch.bin.stencil_serve`` (synthetic
load generator included); the serving chaos soak is ``python -m
stencil_tpu_torch.bin.run_soak --serve``.  The names load at first use, as
the package's own, so importing ``stencil_tpu_torch.serve`` imports no torch.
"""

import importlib

#: public name -> the module that defines it
_PUBLIC = {
    "ACTIVE": "stencil_tpu_torch.serve.tenant",
    "AOTCache": "stencil_tpu_torch.serve.aot",
    "AdmissionRefused": "stencil_tpu_torch.serve.request",
    "BoundedQueue": "stencil_tpu_torch.serve.queue",
    "ElasticityPolicy": "stencil_tpu_torch.serve.policy",
    "EVICTED": "stencil_tpu_torch.serve.tenant",
    "QUARANTINED": "stencil_tpu_torch.serve.tenant",
    "Request": "stencil_tpu_torch.serve.request",
    "Response": "stencil_tpu_torch.serve.request",
    "StencilServer": "stencil_tpu_torch.serve.server",
    "Tenant": "stencil_tpu_torch.serve.tenant",
    "TenantSpec": "stencil_tpu_torch.serve.request",
}

__all__ = [
    "ACTIVE",
    "AOTCache",
    "AdmissionRefused",
    "BoundedQueue",
    "ElasticityPolicy",
    "EVICTED",
    "QUARANTINED",
    "Request",
    "Response",
    "StencilServer",
    "Tenant",
    "TenantSpec",
    "pack",
]


def __getattr__(name):
    if name == "pack":
        return importlib.import_module("stencil_tpu_torch.serve.pack")
    module = _PUBLIC.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)
