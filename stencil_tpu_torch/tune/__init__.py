"""Measurement-driven autotuner with a persistent config cache (counterpart
of ``stencil_tpu/tune/``).

The planners' static picks (``WRAP_AUTO_K``, the shared-memory models' deepest
wavefront depth, the z-ring layout, ``vpu`` / ``native`` / ``direct`` /
``off`` / ``array``) are fallbacks; this package measures them against their
neighbours on the card and keeps the winner:

* ``best_config(key)``: the consult.  Every planner that consults it in the
  JAX package consults it here (``choose_temporal_k``, ``Jacobi3D``'s wrap
  and wavefront plans and its storage axis, ``plan_stream``,
  ``DistributedDomain._resolve_exchange_route``, ``AstarothSim``), each
  behind its environment knob: explicit > env > tuned > static.  A hit is a
  file read, memoized per process.
* ``ensure(key, candidates, build_run, ...)``: consult or search.  On a miss
  the trial protocol (``trial.py``) runs over the candidate space
  (``space.py``) and the winner is stored, so the second run makes no trial.
* ``runners``: the searches of the shipped workloads
  (``autotune_jacobi_wrap``, ``autotune_jacobi_wavefront``,
  ``autotune_exchange``, ``autotune_stream``), which the drivers' ``--tune``
  runs.

Knobs (validated reads, ``utils/config.py``): ``STENCIL_TUNE=0`` ignores the
tuned configs (the static picks); ``STENCIL_TUNE_CACHE=D`` is the cache
directory (default ``~/.cache/stencil_tpu_torch/tune``), which
``--tune-cache`` overrides for a run.

Every decision is telemetry: the ``tune.cache.hit`` / ``tune.cache.miss`` /
``tune.trials`` / ``tune.pruned`` / ``tune.selected`` counters and the
``tune.decision`` / ``tune.trial`` events.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

from stencil_tpu_torch import telemetry
from stencil_tpu_torch.telemetry import names as tm
from stencil_tpu_torch.tune import cache as _cache
from stencil_tpu_torch.tune.key import WorkloadKey, chip_kind  # noqa: F401 (re-export)
from stencil_tpu_torch.tune.trial import TrialResult, TuneReport, search  # noqa: F401

#: process-local enable override (driver --tune/--no-tune); None = env
_enabled_override: Optional[bool] = None

#: memoized consults: (cache_dir, key.digest()) -> config dict or None
_memo: dict = {}


def enabled() -> bool:
    """Is the tuned-config consult on?  ``STENCIL_TUNE=0`` (or a driver's
    ``--no-tune``) turns every ``best_config`` into a miss that counts
    nothing: the static picks."""
    if _enabled_override is not None:
        return _enabled_override
    from stencil_tpu_torch.utils.config import env_bool

    return env_bool("STENCIL_TUNE", True)


def set_enabled(value: Optional[bool]) -> None:
    """Process-local override (``--tune`` / ``--no-tune``); None restores
    the environment's."""
    global _enabled_override
    _enabled_override = value


@contextlib.contextmanager
def disabled():
    """The consult switched off for a block: the runners compute the static
    pick, the fallback a search must defend, under it."""
    prev = _enabled_override
    set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


def set_cache_dir(path: Optional[str]) -> None:
    """A run's cache directory (driver ``--tune-cache``)."""
    _cache.set_dir_override(path)
    _memo.clear()


def overrides():
    """An opaque snapshot of the process-local overrides, which ``restore``
    takes back: the drivers' ``tune_begin`` / ``tune_end`` keep one run's
    ``--no-tune`` / ``--tune-cache`` out of the next in-process run."""
    return (_enabled_override, _cache._dir_override)


def restore(state) -> None:
    set_enabled(state[0])
    set_cache_dir(state[1])


def reset_memo() -> None:
    """Drop the per-process consult memo (after rewriting cache files)."""
    _memo.clear()


def best_config(key: WorkloadKey) -> Optional[dict]:
    """The stored config for ``key``, or None (the caller takes its static
    pick).  Counts ``tune.cache.hit`` / ``tune.cache.miss`` a consult; a
    disabled consult returns None and counts nothing (the fallback is a
    decision, not a miss)."""
    if not enabled():
        return None
    memo_key = (_cache.cache_dir(), key.digest())
    if memo_key in _memo:
        cfg = _memo[memo_key]
    else:
        loaded = _cache.load(key)
        cfg = loaded[0] if loaded is not None else None
        _memo[memo_key] = cfg
    if cfg is None:
        telemetry.inc(tm.TUNE_CACHE_MISS)
        return None
    telemetry.inc(tm.TUNE_CACHE_HIT)
    return dict(cfg)


def record_config(key: WorkloadKey, config: dict, meta: Optional[dict] = None) -> str:
    """Store ``config`` as the tuned pick for ``key`` (and in the memo, so
    this process sees it at once)."""
    path = _cache.store(key, config, meta)
    _memo[(_cache.cache_dir(), key.digest())] = dict(config)
    return path


def ensure(
    key: WorkloadKey,
    candidates: List[dict],
    build_run: Callable[[dict], Callable[[int], None]],
    *,
    depth_key: Optional[str] = None,
    static: Optional[dict] = None,
    reps: int = 3,
    rt: Optional[float] = None,
    prefiltered: int = 0,
) -> TuneReport:
    """Consult or search: a warm cache returns at once with zero trials;
    otherwise the trial protocol runs over ``candidates`` and the winner is
    stored.  When every candidate is pruned, the report carries ``static``
    (source ``"static"``): tuning never fails a run the fallback serves."""
    cached = best_config(key)
    if cached is not None:
        report = TuneReport(key=key, source="cache", config=cached, static_config=static)
        report.cache_path = _cache.path_for(key)
        telemetry.emit_event(tm.EVENT_TUNE_DECISION, key=key.label(), source="cache", config=cached,
                             trials=0, pruned=0)
        return report
    if not enabled():
        return TuneReport(key=key, source="static", config=static, static_config=static)
    report = search(key, candidates, build_run, depth_key=depth_key, reps=reps, rt=rt, prefiltered=prefiltered)
    report.static_config = static
    if report.config is not None:
        meta = {"trials": report.trials, "pruned": report.pruned, "inner": report.inner,
                "results": report.to_json()["results"]}
        report.cache_path = record_config(key, report.config, meta)
        telemetry.inc(tm.TUNE_SELECTED)
    else:
        report.source = "static"
        report.config = static
    telemetry.emit_event(tm.EVENT_TUNE_DECISION, key=key.label(), source=report.source, config=report.config,
                         trials=report.trials, pruned=report.pruned)
    return report
