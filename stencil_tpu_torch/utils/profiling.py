"""Re-export shim: the tracing helpers live in ``stencil_tpu_torch.telemetry``.

Counterpart of ``stencil_tpu/utils/profiling.py``.  ``annotate`` (the
NVTX-range analog, ``torch.profiler.record_function``) and ``trace`` (a
``torch.profiler`` capture written as a Chrome trace) are defined in
``stencil_tpu_torch/telemetry/spans.py``; import them from
``stencil_tpu_torch.telemetry``.
"""

from __future__ import annotations

from stencil_tpu_torch.telemetry.spans import annotate, trace  # noqa: F401
