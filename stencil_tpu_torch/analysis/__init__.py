"""Static verdicts over built programs.

Counterpart of ``stencil_tpu/analysis/``, so far only its admission-time
verdict: :func:`check_vmem`, the static footprint check the serving layer
runs at admission (``serve/server.py``), priced by the Hopper shared-memory
model the port's kernels check before launch (``analysis/vmem.py``).  The
program-contract verifier, the kernel-legality verdict and the rest of the
JAX package's ``analysis/`` wait for ROADMAP.md item 14c.

This module stays import-light (no torch at import time).
"""


def check_vmem(dd, plan, budget=None):
    """Static shared-memory verdict for a stream plan on a realized domain:
    ``None`` fits, else the reason (``analysis/vmem.py``)."""
    from stencil_tpu_torch.analysis import vmem as _vmem

    return _vmem.check_vmem(dd, plan, budget=budget)
