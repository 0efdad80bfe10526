"""The admission-time build cache: a tenant's kernels and step, built once,
bounded and pre-warmed.

Counterpart of ``stencil_tpu/serve/aot.py``.  Admission control must answer
"is this workload key WARM?" without running anything: a warm key
dispatches immediately; a cold key pays its build at admission, bounded by
the admission budget (``compile_budget_s``) so one tenant's exotic workload
cannot park the dispatch loop behind an unbounded build.  A build here is
what the JAX package's ``jax.jit(...).lower().compile()`` is there: the
tenant's kernel libraries through ``kernels/build.py`` (nvcc at first use)
and its ladder rung's step (``tenant_build``).  A cold build that blows the
budget is STILL kept (the work is done, discarding it would re-pay it), but
the triggering request is refused with a classified, retryable
``OverloadError(compile_budget)``: its re-submission hits the now-warm key
and admits at once, and every other tenant saw one bounded stall.

Two warmth layers:

* **in-process**: the built step itself, keyed by ``tune/key.py``
  ``WorkloadKey.digest()``;
* **cross-process**: a JSON stamp per digest (``tune/cache.py``'s schema
  and toolchain-stamp pattern: corrupt or stale is a miss, never a crash)
  recording that this key was built before, with the kernel libraries the
  build loaded; a build that cannot name its libraries gets no stamp.  A stamp counts as warm (a rebuild without the budget
  refusal) only while ``kernels/build.py`` finds every one of those
  libraries already built: the rebuild is then a library load.  When they
  are gone the stamp's recorded seconds (``estimate_s``) are what the
  rebuild will cost.  The stamps live under
  ``<STENCIL_COMPILE_CACHE_DIR>/serve_aot``; the toolchain stamp is
  ``kernels.toolchain()``'s torch and cuda versions.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence, Tuple

from stencil_tpu_torch import telemetry
from stencil_tpu_torch.resilience.taxonomy import OverloadError
from stencil_tpu_torch.telemetry import names as tm

#: bump when the stamp vocabulary changes incompatibly (a mismatch is a
#: MISS, never a crash)
SCHEMA = 1


def _toolchain() -> Tuple[str, Optional[str]]:
    """The (torch, cuda) versions a stamp is valid for (``kernels.toolchain``'s
    two version fields, read without its nvidia-smi and nvcc probes)."""
    import torch

    return torch.__version__, torch.version.cuda


def default_stamp_dir() -> Optional[str]:
    """``<STENCIL_COMPILE_CACHE_DIR>/serve_aot`` when the cache directory is
    configured, else None: in-process warmth only."""
    from stencil_tpu_torch.utils.config import env_str

    root = env_str("STENCIL_COMPILE_CACHE_DIR", None)
    if root is None:
        return None
    return os.path.join(os.path.abspath(os.path.expanduser(root)), "serve_aot")


def tenant_build(model) -> Tuple[Callable[[], object], Optional[Tuple[str, ...]]]:
    """``(build, libraries)`` of a realized model's workload: ``build()``
    builds its current ladder rung (the kernel libraries it launches, then
    the step; ``DegradationLadder``'s ``Rung.build``) and returns the step;
    ``libraries`` is what the rung reports it loads (``Rung.libraries``:
    ``()`` for none, as on the CPU), or ``None`` when the rung cannot say,
    and then the build is never stamped warm across processes.  The ladder
    is the model's own (``_ladder``) or its step's (``make_stream_step``)."""
    ladder = getattr(model, "_ladder", None)
    if ladder is None:
        ladder = getattr(getattr(model, "_step", None), "_resilience", None)
    rung = getattr(ladder, "rung", None)
    if rung is None:
        raise ValueError(f"{type(model).__name__} has no realized ladder rung to build")
    libraries = rung.libraries() if rung.libraries is not None else None
    return rung.build, None if libraries is None else tuple(libraries)


class AOTCache:
    """Built steps by workload-key digest, with persisted warmth stamps.
    ``clock`` is injectable (fake-clock tests measure builds without
    sleeping)."""

    def __init__(self, stamp_dir: Optional[str] = None, clock: Callable[[], float] = time.monotonic):
        self._exec: dict = {}
        self._stamps: dict = {}
        self.clock = clock
        self.stamp_dir = stamp_dir if stamp_dir is not None else default_stamp_dir()
        if self.stamp_dir:
            self._load_stamps()

    # --- warmth ---------------------------------------------------------------

    def warm(self, digest: str) -> bool:
        """True when the built step is resident in THIS process."""
        return digest in self._exec

    def stamped(self, digest: str) -> bool:
        """True when a previous process built this key on this toolchain
        AND every kernel library that build loaded is still built (the
        rebuild is then a library load; admission treats it as warm)."""
        doc = self._stamps.get(digest)
        libraries = None if doc is None else doc.get("libraries")
        if not isinstance(libraries, list):
            return False
        return all(os.path.exists(p) for p in libraries)

    def estimate_s(self, digest: str) -> Optional[float]:
        """The seconds the stamped build of ``digest`` took: what a rebuild
        costs when its libraries are gone (None without a stamp)."""
        doc = self._stamps.get(digest)
        return None if doc is None else doc.get("seconds")

    def get(self, digest: str):
        return self._exec.get(digest)

    # --- build ----------------------------------------------------------------

    def compile(
        self,
        digest: str,
        build: Callable[[], object],
        budget_s: Optional[float] = None,
        label: str = "serve",
        key_doc: Optional[dict] = None,
        libraries: Optional[Sequence[str]] = None,
    ):
        """Build (``build()``: the kernel libraries and the step), cache and
        stamp the result for ``digest``; ``libraries`` are the library paths
        the build loaded (``tenant_build``; ``()`` for none).  A build that
        cannot name them (``None``) is kept in-process and never stamped,
        so no later process counts it warm.  Raises a retryable
        ``OverloadError(compile_budget)`` when the measured build exceeded
        ``budget_s`` AND the key was not stamped warm by a previous process,
        AFTER caching, so the refusal can never repeat for this key."""
        t0 = self.clock()
        exe = build()
        seconds = self.clock() - t0
        telemetry.observe(tm.SERVE_COMPILE_SECONDS, seconds)
        self._exec[digest] = exe
        was_stamped = self.stamped(digest)
        if libraries is not None:
            self._store_stamp(digest, seconds, key_doc, libraries)
        if budget_s is not None and seconds > budget_s and not was_stamped:
            raise OverloadError(
                why="compile_budget",
                tenant=label,
                # the key is warm NOW: an immediate re-submission admits
                retry_after_s=0.0,
            )
        return exe, seconds

    # --- persisted stamps (tune/cache.py pattern) -----------------------------

    def _stamp_path(self, digest: str) -> str:
        return os.path.join(self.stamp_dir, f"{digest}.json")

    def _load_stamps(self) -> None:
        try:
            entries = os.listdir(self.stamp_dir)
        except OSError:
            return  # absent dir = cold cache
        torch_v, cuda_v = _toolchain()
        for name in entries:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.stamp_dir, name)) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                continue  # corrupt stamp = miss, never a crash
            if (
                not isinstance(doc, dict)
                or doc.get("schema") != SCHEMA
                or doc.get("torch") != torch_v
                or doc.get("cuda") != cuda_v
            ):
                continue  # stale toolchain: its libraries are too
            self._stamps[name[: -len(".json")]] = doc

    def _store_stamp(self, digest: str, seconds: float, key_doc: Optional[dict], libraries: Sequence[str]) -> None:
        doc = {"schema": SCHEMA, "seconds": seconds, "key": key_doc or {}, "libraries": list(libraries)}
        doc["torch"], doc["cuda"] = _toolchain()
        self._stamps[digest] = doc
        if not self.stamp_dir:
            return
        try:
            from stencil_tpu_torch.utils.artifact import atomic_write_json

            atomic_write_json(self._stamp_path(digest), doc)
        except OSError as e:
            from stencil_tpu_torch.utils.logging import log_warn

            log_warn(
                f"serve AOT stamp for {digest} not persisted ({e}); "
                "the key stays warm in-process only"
            )
