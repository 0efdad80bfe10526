"""Telemetry names: every metric, span and event name the port emits.

Counterpart of ``stencil_tpu/telemetry/names.py``, holding the names the
port's layers emit so far.  Each string is the JAX package's verbatim, under
the same constant name, so a counter or an event reads the same in a log of
either package (``tests/test_torch_telemetry.py`` holds every constant here
against the JAX module).  Call sites name a series through these constants,
never a free string.

Naming scheme: ``<subsystem>.<noun>[.<unit>]``, lowercase, dots between
levels, underscores inside a level.  Histograms of seconds end in
``.seconds``; byte counters end in ``.bytes``.
"""

from __future__ import annotations

# --- counters (monotonic; always recorded, the snapshot seeds all of these) --

#: halo exchanges accounted: direct ``exchange()`` / ``exchange_many()``
#: calls plus one per fused-step exchange inside ``run_step`` dispatches
EXCHANGE_COUNT = "domain.exchange.count"
#: analytic bytes those exchanges move (``exchange_bytes_total`` each)
EXCHANGE_BYTES = "domain.exchange.bytes"
#: ``run_step`` dispatches
STEP_DISPATCHES = "domain.step.dispatches"
#: raw stencil iterations advanced through ``run_step``
STEP_ITERATIONS = "domain.step.iterations"
#: transient-failure retry attempts (resilience/retry.py)
RETRY_ATTEMPTS = "resilience.retry.attempts"
#: retries abandoned after the policy's budget ran out
RETRY_EXHAUSTED = "resilience.retry.exhausted"
#: retries refused because the step had begun to write its inputs in place
RETRY_REFUSED = "resilience.retry.refused"
#: degradation-ladder descents (resilience/ladder.py)
LADDER_DESCENTS = "resilience.ladder.descents"
#: faults raised by the STENCIL_FAULT_PLAN hook (resilience/inject.py)
FAULTS_INJECTED = "resilience.faults.injected"
#: divergence-sentinel NaN/Inf detections (resilience/sentinel.py)
SENTINEL_TRIPS = "resilience.sentinel.trips"
#: checkpoints committed (io/checkpoint.py)
CHECKPOINT_SAVES = "checkpoint.saves"
#: bytes of quantity data those checkpoints wrote (interiors at the native
#: dtype, the portable form the digests cover)
CHECKPOINT_SAVE_BYTES = "checkpoint.save.bytes"
#: successful checkpoint restores (restores onto another grid included)
CHECKPOINT_RESTORES = "checkpoint.restores"
#: checkpoints rejected by validation, each one the ring fell back past
CHECKPOINT_INVALID = "checkpoint.invalid"
#: supervisor restarts from the last valid checkpoint after a FATAL/STALL
#: dispatch classification (resilience/supervisor.py restart budget)
SUPERVISOR_RESTARTS = "supervisor.restarts"
#: capacity losses answered by the checkpoint fallback (``re_realize`` and
#: a restore), each one also charged to the supervisor's restart budget
RESHARD_FALLBACKS = "reshard.fallbacks"
#: watchdog deadline trips (resilience/watchdog.py)
WATCHDOG_STALLS = "watchdog.stalls"
#: field-health snapshots taken (telemetry/numerics.py)
NUMERICS_SNAPSHOTS = "numerics.snapshots"
#: guardband violations over those snapshots; also the event's name
NUMERICS_DRIFT = "numerics.drift"
#: analytic bytes moved through packed shell message buffers (the
#: ``zpack_*`` / ``yzpack_*`` exchange routes; 0 under ``direct`` —
#: ops/exchange.py ``zpack_message_stats``)
EXCHANGE_PACKED_BYTES = "exchange.packed.bytes"
#: analytic pack+unpack kernel launches of those packed exchanges
EXCHANGE_PACKED_KERNELS = "exchange.packed.kernels"
#: analytic boundary-band cells recomputed by the split schedule's exterior
#: passes (``overlap=split`` on the stream engine); 0 under ``overlap=off``
STEP_OVERLAP_EXTERIOR_CELLS = "step.overlap.exterior_cells"
#: analytic tensor-core FLOPs of the banded-contraction kernels
#: (``compute_unit=mxu|mxu_band``, ``mxu_flops_per_plane`` for the resolved
#: variant), modelled once per build like the exchange bytes; 0 under vpu
KERNEL_MXU_FLOPS = "kernel.mxu.flops"
#: device-profile captures taken by the cadence profiler
#: (telemetry/device.py ``ProfileCapture``: STENCIL_PROFILE_EVERY /
#: ``--profile-dir``); a capture whose profiler would not start still counts
PROFILE_CAPTURES = "profile.captures"
#: tuned-config cache consultations that found a persisted config (tune/)
TUNE_CACHE_HIT = "tune.cache.hit"
#: consultations that found nothing (cold cache, stale toolchain, corrupt file)
TUNE_CACHE_MISS = "tune.cache.miss"
#: candidate configs actually measured by the autotuner's trial protocol
TUNE_TRIALS = "tune.trials"
#: candidates pruned without a steady-state measurement (the shared-memory
#: model's prefilter, or a VMEM_OOM / COMPILE_REJECT on the card pruning the
#: candidate and its deeper neighbours)
TUNE_PRUNED = "tune.pruned"
#: winning configs selected (and persisted) by a completed search
TUNE_SELECTED = "tune.selected"
#: analytic bytes an exchange moves over one grid hop, one counter per
#: (axis, receive side); 0 on axes the grid does not split
EXCHANGE_HOP_X_LOW_BYTES = "exchange.hop.x.low.bytes"
EXCHANGE_HOP_X_HIGH_BYTES = "exchange.hop.x.high.bytes"
EXCHANGE_HOP_Y_LOW_BYTES = "exchange.hop.y.low.bytes"
EXCHANGE_HOP_Y_HIGH_BYTES = "exchange.hop.y.high.bytes"
EXCHANGE_HOP_Z_LOW_BYTES = "exchange.hop.z.low.bytes"
EXCHANGE_HOP_Z_HIGH_BYTES = "exchange.hop.z.high.bytes"

#: the per-hop byte counter for one (grid axis, receive side)
EXCHANGE_HOP_BYTES = {
    ("x", "low"): EXCHANGE_HOP_X_LOW_BYTES,
    ("x", "high"): EXCHANGE_HOP_X_HIGH_BYTES,
    ("y", "low"): EXCHANGE_HOP_Y_LOW_BYTES,
    ("y", "high"): EXCHANGE_HOP_Y_HIGH_BYTES,
    ("z", "low"): EXCHANGE_HOP_Z_LOW_BYTES,
    ("z", "high"): EXCHANGE_HOP_Z_HIGH_BYTES,
}

ALL_COUNTERS = frozenset({
    EXCHANGE_COUNT,
    EXCHANGE_BYTES,
    EXCHANGE_PACKED_BYTES,
    EXCHANGE_PACKED_KERNELS,
    STEP_OVERLAP_EXTERIOR_CELLS,
    KERNEL_MXU_FLOPS,
    PROFILE_CAPTURES,
    STEP_DISPATCHES,
    STEP_ITERATIONS,
    RETRY_ATTEMPTS,
    RETRY_EXHAUSTED,
    RETRY_REFUSED,
    LADDER_DESCENTS,
    FAULTS_INJECTED,
    SENTINEL_TRIPS,
    CHECKPOINT_SAVES,
    CHECKPOINT_SAVE_BYTES,
    CHECKPOINT_RESTORES,
    CHECKPOINT_INVALID,
    SUPERVISOR_RESTARTS,
    RESHARD_FALLBACKS,
    WATCHDOG_STALLS,
    NUMERICS_SNAPSHOTS,
    NUMERICS_DRIFT,
    TUNE_CACHE_HIT,
    TUNE_CACHE_MISS,
    TUNE_TRIALS,
    TUNE_PRUNED,
    TUNE_SELECTED,
    *EXCHANGE_HOP_BYTES.values(),
})

# --- gauges (last value) -------------------------------------------------------

#: analytic bytes of one exchange over all subdomains
EXCHANGE_BYTES_PER_EXCHANGE = "domain.exchange.bytes_per_exchange"
#: checkpoints the ring retains after pruning (io/checkpoint.py ``save_to_ring``)
CHECKPOINT_RETAINED = "checkpoint.retained"

ALL_GAUGES = frozenset({EXCHANGE_BYTES_PER_EXCHANGE, CHECKPOINT_RETAINED})

# --- histograms (Statistics-backed) ------------------------------------------

#: wall seconds per raw iteration through ``run_step`` (synchronized; only
#: while telemetry is enabled)
STEP_SECONDS = "domain.step.seconds"
#: wall seconds per direct ``exchange()`` call (synchronized)
EXCHANGE_SECONDS = "domain.exchange.seconds"
#: wall seconds per ``swap()`` call
SWAP_SECONDS = "domain.swap.seconds"
#: seconds of the exchange's build at ``realize()`` through the route ladder,
#: the kernel library's build and load included (``DomainStats.time_create``)
COMPILE_SECONDS = "domain.compile.seconds"
#: degradation-ladder rung build seconds (the kernels' nvcc builds included)
LADDER_BUILD_SECONDS = "resilience.ladder.build_seconds"
#: wall seconds per checkpoint commit (gather, digest, write, fsync, rename)
CHECKPOINT_SAVE_SECONDS = "checkpoint.save.seconds"
#: wall seconds per checkpoint restore (load, verify, scatter)
CHECKPOINT_RESTORE_SECONDS = "checkpoint.restore.seconds"
#: wall seconds per numerics snapshot (reductions and the scalars' readback)
NUMERICS_SNAPSHOT_SECONDS = "numerics.snapshot.seconds"

ALL_HISTOGRAMS = frozenset({
    STEP_SECONDS,
    EXCHANGE_SECONDS,
    SWAP_SECONDS,
    COMPILE_SECONDS,
    LADDER_BUILD_SECONDS,
    CHECKPOINT_SAVE_SECONDS,
    CHECKPOINT_RESTORE_SECONDS,
    NUMERICS_SNAPSHOT_SECONDS,
})

# --- spans (Chrome-trace timeline entries) -----------------------------------

SPAN_STEP = "domain.step"
SPAN_EXCHANGE = "domain.exchange"
SPAN_SWAP = "domain.swap"
#: the split schedule's two halves (ops/stream.py ``overlap=split``):
#: profiler scopes (``telemetry.annotate``) around the interior pass and
#: around the exterior (the exchange on the side stream and the band passes)
SPAN_OVERLAP_INTERIOR = "step.overlap.interior"
SPAN_OVERLAP_EXTERIOR = "step.overlap.exterior"
#: the halo exchange's sends, one profiler scope per (grid axis, receive
#: side): ops/exchange.py enters these around every send of a sweep, so a
#: trace attributes the exchange's device time per hop (``exchange.z.low``
#: receives the -1 z-neighbour's shell)
SPAN_EXCHANGE_X_LOW = "exchange.x.low"
SPAN_EXCHANGE_X_HIGH = "exchange.x.high"
SPAN_EXCHANGE_Y_LOW = "exchange.y.low"
SPAN_EXCHANGE_Y_HIGH = "exchange.y.high"
SPAN_EXCHANGE_Z_LOW = "exchange.z.low"
SPAN_EXCHANGE_Z_HIGH = "exchange.z.high"

#: the direction span for one (grid axis, receive side)
EXCHANGE_DIRECTION_SPANS = {
    ("x", "low"): SPAN_EXCHANGE_X_LOW,
    ("x", "high"): SPAN_EXCHANGE_X_HIGH,
    ("y", "low"): SPAN_EXCHANGE_Y_LOW,
    ("y", "high"): SPAN_EXCHANGE_Y_HIGH,
    ("z", "low"): SPAN_EXCHANGE_Z_LOW,
    ("z", "high"): SPAN_EXCHANGE_Z_HIGH,
}


def exchange_direction_span(axis: str, side: str) -> str:
    """The registered span name for one exchange hop (axis in x/y/z, side in
    low/high)."""
    try:
        return EXCHANGE_DIRECTION_SPANS[(axis, side)]
    except KeyError:
        raise ValueError(f"no exchange direction span for {axis!r}/{side!r}") from None


ALL_SPANS = frozenset({
    SPAN_STEP,
    SPAN_EXCHANGE,
    SPAN_SWAP,
    SPAN_OVERLAP_INTERIOR,
    SPAN_OVERLAP_EXTERIOR,
    *EXCHANGE_DIRECTION_SPANS.values(),
})

# --- structured events (JSONL sink) ------------------------------------------

#: a rung was built (fields: phase, label, seconds)
EVENT_COMPILE = "domain.compile"
#: a ladder descent (fields: label, from_rung, to_rung, failure_class)
EVENT_DESCENT = "resilience.descent"
#: a tuning decision (fields: key, source=cache|search|static, config,
#: trials, pruned)
EVENT_TUNE_DECISION = "tune.decision"
#: one autotuner trial finished (fields: key, candidate, seconds_per_iter,
#: or failure_class/error when the candidate was pruned)
EVENT_TUNE_TRIAL = "tune.trial"
#: the exchange planner resolved its y/z-sweep route (fields: route,
#: source=explicit|env|tuned|static, or "<orig>/degraded" when a packed pick
#: structurally could not engage), or a packed route's build was refused
#: and the ladder took ``direct`` (source=ladder)
EVENT_EXCHANGE_ROUTE = "exchange.route"
#: a stream-engine step build resolved its overlap schedule (fields:
#: overlap=off|split, source=explicit|env|tuned|static or "<orig>/degraded",
#: route, m)
EVENT_STEP_OVERLAP = "step.overlap"
#: a stream-engine step build resolved its halo consumption mode (fields:
#: halo=array|fused, source as step.overlap, route, m, exchange_route)
EVENT_STEP_HALO = "step.halo"
#: a kernel build resolved its compute-unit axis (fields:
#: unit=vpu|mxu|mxu_band, source=explicit|env|tuned|static or
#: "<orig>/degraded", where)
EVENT_KERNEL_COMPUTE_UNIT = "kernel.compute_unit"
#: a kernel build resolved its contraction operands' precision (fields:
#: input=f32|bf16, source, unit, where)
EVENT_KERNEL_MXU_INPUT = "kernel.mxu_input"
#: a model build resolved its storage-dtype axis (fields:
#: storage=native|bf16, source, where)
EVENT_KERNEL_STORAGE_DTYPE = "kernel.storage_dtype"
#: the supervisor restarted from the last valid checkpoint (fields: label,
#: step, restart, budget, failure_class, error)
EVENT_SUPERVISOR_RESTART = "supervisor.restart"
#: a capacity loss fell back to checkpoint restore (fields: from_mesh,
#: to_mesh, why, step), charged against the restart budget
EVENT_RESHARD_FALLBACK = "reshard.fallback"
#: sustained healthy progress restored one restart credit (fields: label,
#: step, window, credits_used; STENCIL_RESTART_WINDOW)
EVENT_SUPERVISOR_REPLENISH = "supervisor.replenish"
#: a transient failure is being retried (fields: label, attempt,
#: max_retries, delay_s, error)
EVENT_RETRY = "resilience.retry"
#: the retry budget ran out (fields: label, max_retries, error)
EVENT_RETRY_EXHAUSTED = "resilience.retry_exhausted"
#: a retry was refused because the step had begun to write its inputs in
#: place (fields: label, error)
EVENT_RETRY_REFUSED = "resilience.retry_refused"
#: a STENCIL_FAULT_PLAN fault fired (fields: phase, label, failure_class)
EVENT_FAULT = "resilience.fault_injected"
#: the divergence sentinel tripped (fields: quantity, step, window, coord)
EVENT_DIVERGENCE = "resilience.divergence"
#: a checkpoint committed (fields: path, step, backend, bytes, seconds, reason)
EVENT_CHECKPOINT_SAVE = "checkpoint.save"
#: a checkpoint restored (fields: path, step, backend, elastic, seconds)
EVENT_CHECKPOINT_RESTORE = "checkpoint.restore"
#: a checkpoint failed validation and the ring fell back past it (fields:
#: path, why)
EVENT_CHECKPOINT_FALLBACK = "checkpoint.fallback"
#: the watchdog saw a dispatch pass its deadline (fields: phase,
#: deadline_s, abort)
EVENT_WATCHDOG_STALL = "watchdog.stall"
#: a cadence device-profile capture finished (fields: dir, index, seconds;
#: telemetry/device.py)
EVENT_PROFILE_CAPTURE = "profile.capture"

ALL_EVENTS = frozenset({
    EVENT_COMPILE,
    EVENT_DESCENT,
    EVENT_TUNE_DECISION,
    EVENT_TUNE_TRIAL,
    EVENT_EXCHANGE_ROUTE,
    EVENT_STEP_OVERLAP,
    EVENT_STEP_HALO,
    EVENT_KERNEL_COMPUTE_UNIT,
    EVENT_KERNEL_MXU_INPUT,
    EVENT_KERNEL_STORAGE_DTYPE,
    EVENT_SUPERVISOR_RESTART,
    EVENT_RESHARD_FALLBACK,
    EVENT_SUPERVISOR_REPLENISH,
    EVENT_RETRY,
    EVENT_RETRY_EXHAUSTED,
    EVENT_RETRY_REFUSED,
    EVENT_FAULT,
    EVENT_DIVERGENCE,
    EVENT_CHECKPOINT_SAVE,
    EVENT_CHECKPOINT_RESTORE,
    EVENT_CHECKPOINT_FALLBACK,
    EVENT_WATCHDOG_STALL,
    EVENT_PROFILE_CAPTURE,
    NUMERICS_DRIFT,
})

#: every registered name, any kind
ALL_NAMES = ALL_COUNTERS | ALL_GAUGES | ALL_HISTOGRAMS | ALL_SPANS | ALL_EVENTS
