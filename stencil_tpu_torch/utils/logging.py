"""Leveled, rank-tagged logging (counterpart of ``stencil_tpu/utils/logging.py``).

The reference's SPEW..FATAL macros (include/stencil/logging.hpp:12-53): each
line reads ``LEVEL[file:line]{rank} message`` on stderr and prints when the
configured level is at least the message's verbosity number (SPEW=5, DEBUG=4,
INFO=3, WARN=2, ERROR=1, FATAL=0: a higher level is more verbose).  The level
comes from ``STENCIL_OUTPUT_LEVEL`` (a name or a number, default INFO); a value
that parses as neither warns and falls back to INFO, since importing a logger
must never fail.  ``STENCIL_LOG_TIMESTAMPS`` (1/true/yes/on) prefixes each
line with an ISO-8601 UTC time.  The rank is ``torch.distributed``'s when a
process group is up, else 0.
"""

from __future__ import annotations

import datetime
import os
import sys

# verbosity numbers (CMakeLists.txt:55-66): higher = chattier
SPEW, DEBUG, INFO, WARN, ERROR, FATAL = 5, 4, 3, 2, 1, 0
_NAMES = {SPEW: "SPEW", DEBUG: "DEBUG", INFO: "INFO", WARN: "WARN", ERROR: "ERROR", FATAL: "FATAL"}
_BY_NAME = {v: k for k, v in _NAMES.items()}
_BOOL_WORDS = {"1": True, "true": True, "yes": True, "on": True,
               "0": False, "false": False, "no": False, "off": False}


def _parse_level(raw: str) -> int:
    raw = raw.strip().upper()
    if raw in _BY_NAME:
        return _BY_NAME[raw]
    try:
        return int(raw)
    except ValueError:
        print(f"WARN unrecognized STENCIL_OUTPUT_LEVEL={raw!r}, using INFO", file=sys.stderr)
        return INFO


def _parse_timestamps() -> bool:
    raw = os.environ.get("STENCIL_LOG_TIMESTAMPS", "")
    if raw == "":
        return False
    val = _BOOL_WORDS.get(raw.strip().lower())
    if val is None:
        print(f"WARN STENCIL_LOG_TIMESTAMPS={raw!r} is not a valid boolean (use 1/0, true/false, "
              "yes/no, on/off); timestamps stay off", file=sys.stderr)
        return False
    return val


_LEVEL = _parse_level(os.environ.get("STENCIL_OUTPUT_LEVEL", "INFO"))
_TIMESTAMPS = _parse_timestamps()


def set_level(level) -> None:
    global _LEVEL
    _LEVEL = _parse_level(str(level))


def _rank() -> int:
    """``torch.distributed``'s rank when a process group is up, else 0; a
    log line never imports torch or starts anything itself."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None else None
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # a log line never raises
        return 0
    return 0


def _emit(verbosity: int, msg: str, stacklevel: int = 2) -> None:
    """Print when the level allows.  ``stacklevel`` counts frames above
    ``_emit`` to the line tagged (2: the caller of a ``log_*`` function); a
    wrapper passes a larger one so that its caller is tagged.  A walk past
    the stack's end tags ``?:0``."""
    if _LEVEL < verbosity:
        return
    try:
        f = sys._getframe(stacklevel)
        fname, lineno = os.path.basename(f.f_code.co_filename), f.f_lineno
    except ValueError:
        fname, lineno = "?", 0
    stamp = ""
    if _TIMESTAMPS:
        stamp = datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="microseconds") + " "
    print(f"{stamp}{_NAMES[verbosity]}[{fname}:{lineno}]{{{_rank()}}} {msg}", file=sys.stderr)


def log_spew(msg: str, stacklevel: int = 1) -> None:
    _emit(SPEW, msg, stacklevel + 1)


def log_debug(msg: str, stacklevel: int = 1) -> None:
    _emit(DEBUG, msg, stacklevel + 1)


def log_info(msg: str, stacklevel: int = 1) -> None:
    _emit(INFO, msg, stacklevel + 1)


def log_warn(msg: str, stacklevel: int = 1) -> None:
    _emit(WARN, msg, stacklevel + 1)


def log_error(msg: str, stacklevel: int = 1) -> None:
    _emit(ERROR, msg, stacklevel + 1)


def log_fatal(msg: str, stacklevel: int = 1) -> None:
    """Logs, then raises ``RuntimeError`` where the reference exits
    (logging.hpp:47-50)."""
    _emit(FATAL, msg, stacklevel + 1)
    raise RuntimeError(msg)
