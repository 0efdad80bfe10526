"""Atomic file writes: a temp file in the same directory, fsync, ``os.replace``
(counterpart of ``stencil_tpu/utils/artifact.py``).

A run's records (``chip_smoke.json``, benchmark and plan files) either keep
their old content or become the new content whole: a process that dies
mid-write leaves no truncated file, and the temp file is removed.  The rename
stays inside one filesystem because the temp file lives beside the
destination.  Standard library only.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile


def fsync_dir(path: str) -> None:
    """fsync a directory so that a rename into it is durable (a no-op where
    a directory cannot be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w"):
    """``with atomic_write(p) as f: f.write(...)``: ``path`` keeps its old
    content until the block ends without an error, and then becomes the new
    content at once.  ``mode`` is ``"w"`` or ``"wb"``."""
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_write writes whole files ('w' or 'wb'), not {mode!r}")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_json(path: str, doc, indent: int = 2, sort_keys: bool = True) -> str:
    """Write ``doc`` as JSON with a trailing newline; returns ``path``."""
    with atomic_write(path) as f:
        json.dump(doc, f, indent=indent, sort_keys=sort_keys)
        f.write("\n")
    return path


def atomic_write_text(path: str, text: str) -> str:
    """Write ``text``; returns ``path``."""
    with atomic_write(path) as f:
        f.write(text)
    return path
