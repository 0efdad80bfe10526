"""Validated environment reads and the exchange-method and placement enums
(counterpart of ``stencil_tpu/utils/config.py``: its ``env_*`` reads, lines
40-95, and its two enums).

Every ``STENCIL_*`` knob the port reads goes through an ``env_*`` function:
a malformed or out-of-range value raises a ``ValueError`` that names the
variable, and an empty value means the default, as an unset one does.
"""

from __future__ import annotations

import enum
import os


def _parse_env(name: str, raw: str, conv, kind: str, minimum=None):
    try:
        val = conv(raw)
    except (TypeError, ValueError):
        raise ValueError(f"{name}={raw!r} is not a valid {kind} (set a plain {kind} or unset {name})") from None
    if minimum is not None and val < minimum:
        raise ValueError(
            f"{name}={raw!r} is below the minimum {minimum} (a too-small value would silently disable "
            f"the feature {name} tunes)"
        )
    return val


def env_int(name: str, default: int, minimum: int = None) -> int:
    """The integer in ``name``, else ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return _parse_env(name, raw, int, "integer", minimum)


def env_float(name: str, default: float, minimum: float = None) -> float:
    """The number in ``name``, else ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return _parse_env(name, raw, float, "number", minimum)


_BOOL_WORDS = {
    "1": True, "true": True, "yes": True, "on": True,
    "0": False, "false": False, "no": False, "off": False,
}


def env_bool(name: str, default: bool) -> bool:
    """1/true/yes/on or 0/false/no/off in ``name``, else ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    val = _BOOL_WORDS.get(raw.strip().lower())
    if val is None:
        raise ValueError(
            f"{name}={raw!r} is not a valid boolean (use 1/0, true/false, yes/no, on/off, or unset {name})"
        )
    return val


def env_str(name: str, default=None):
    """The string in ``name``, else ``default`` (unset and empty alike)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw


def env_choice(name: str, default: str, choices) -> str:
    """One of ``choices`` in ``name``, else ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    val = raw.strip()
    if val not in choices:
        raise ValueError(f"{name}={raw!r} is not one of {'/'.join(sorted(choices))} (or unset {name})")
    return val


#: the checkpoint backends ``STENCIL_CHECKPOINT_BACKEND`` names: ``auto``
#: (npz, the format both packages read), ``npz``, ``raw`` (the port's
#: raw-stack backend), and ``orbax`` (the JAX package's, which the port
#: refuses with a message naming ``raw``)
CHECKPOINT_BACKENDS = ("auto", "npz", "raw", "orbax")


def supervisor_env() -> dict:
    """The run supervisor's knobs, each a validated read (the JAX package's
    ``SupervisorConfig.from_env``): ``STENCIL_CHECKPOINT_DIR`` (None: no
    supervision), ``STENCIL_CHECKPOINT_EVERY`` (steps, 0 off),
    ``STENCIL_CHECKPOINT_EVERY_S`` (wall seconds, 0 off),
    ``STENCIL_CHECKPOINT_KEEP`` (ring size, >= 1), ``STENCIL_CHECKPOINT_BACKEND``
    (``CHECKPOINT_BACKENDS``), ``STENCIL_CHECKPOINT_VERIFY`` (digest checks
    on restore), ``STENCIL_SUPERVISOR_RESTARTS`` (the restart budget) and
    ``STENCIL_RESTART_WINDOW`` (healthy chunks a replenished credit, 0
    off)."""
    return dict(
        dir=env_str("STENCIL_CHECKPOINT_DIR", None),
        every_steps=env_int("STENCIL_CHECKPOINT_EVERY", 0, minimum=0),
        every_seconds=env_float("STENCIL_CHECKPOINT_EVERY_S", 0.0, minimum=0.0),
        keep=env_int("STENCIL_CHECKPOINT_KEEP", 3, minimum=1),
        backend=env_choice("STENCIL_CHECKPOINT_BACKEND", "auto", CHECKPOINT_BACKENDS),
        verify=env_bool("STENCIL_CHECKPOINT_VERIFY", True),
        max_restarts=env_int("STENCIL_SUPERVISOR_RESTARTS", 2, minimum=0),
        restart_window=env_int("STENCIL_RESTART_WINDOW", 0, minimum=0),
    )


class MethodFlags(enum.Flag):
    Non = 0
    # Ppermute names the default transport: in this package, a neighbour
    # gather over the subdomain-grid axis on the one device
    Ppermute = enum.auto()
    # the debug oracles (domain.py _ORACLES): an all-gather of the global
    # array, and rolls compared against the default transport
    AllGather = enum.auto()
    RollCompare = enum.auto()
    # Reference-compat aliases (stencil.hpp:29-41): all map onto the default
    # transport, accepted so reference-style driver flags keep working
    CudaMpi = Ppermute
    CudaAwareMpi = Ppermute
    CudaMpiColocated = Ppermute
    CudaMemcpyPeer = Ppermute
    CudaKernel = Ppermute
    All = Ppermute

    def and_(self, o: "MethodFlags") -> bool:
        return bool(self & o)


class PlacementStrategy(enum.Enum):
    """partition.hpp:312.  With every subdomain on one device, placement is
    the identity; the strategy is recorded, not acted on."""

    NodeAware = 0
    Trivial = 1
