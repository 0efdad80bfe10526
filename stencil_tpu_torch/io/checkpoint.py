"""Checkpoint and resume of a ``DistributedDomain``: the npz and raw backends.

Counterpart of ``stencil_tpu/io/checkpoint.py``, with its public functions,
its ``MANIFEST.json`` at SCHEMA 1 and its retention ring:

* **Atomic commit**: a checkpoint is staged into a temporary directory
  beside its destination (the state first, fsync'd; the manifest last,
  through ``utils/artifact.py``) and renamed into place, so a kill at any
  byte leaves the previous checkpoint or none at that path.  The manifest
  is the commit marker.
* **Digests**: one sha256 a quantity over its PORTABLE interior: the valid
  interior cells in C order, components first, at the quantity's native
  dtype (bf16 storage upcast exactly to f32, as the JAX package digests
  it), so a checkpoint of either package verifies in the other.  Restores
  verify the loaded data before installing any of it.
  ``STENCIL_CHECKPOINT_DIGESTS=0`` drops them from ``raw`` saves (they
  cost a host copy's sha256), as it does from the JAX package's orbax
  saves; ``npz`` always digests.
* **Retention ring**: ``save_to_ring`` keeps the newest N checkpoints under
  ``ckpt-<step:012d>``; ``latest_valid`` / ``restore_latest`` walk it
  newest first, skipping (and counting) corrupt or partial entries.
* **Elastic restore**: the npz state is the global interior, so it restores
  onto any subdomain grid (``geometry.mesh`` records the saving grid).

Backends:

* ``npz`` (``backend=None``): the portable global interiors, the format the
  JAX package reads and writes too, so a ring crosses between the packages.
* ``raw``: the port's counterpart of the JAX package's ``orbax`` backend
  (its sharded raw arrays, shells included).  Each quantity's stack
  ``(*components, px, py, pz, Xr, Yr, Zr)`` is written as it lies on the
  device, shells included, at its storage dtype (``raw-<name>.bin``, its
  shape and dtype in the manifest), with the same interior digests and
  geometry.  A restore onto the same grid and storage installs the stacks
  whole; any other grid (or storage axis) cuts the interiors out through the
  manifest's geometry and re-scatters them, as the JAX orbax path's host
  round trip does (``stencil_tpu/io/checkpoint.py:387-422``).  Both
  paths verify the digests before anything is installed.

The JAX package's default is ``orbax`` where orbax is installed; the port's
is ``npz`` (ROADMAP.md queue 3).  ``backend="orbax"``, or a manifest whose
backend is orbax, is refused with a ``ValueError`` naming ``raw``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch import telemetry
from stencil_tpu_torch.resilience.taxonomy import CheckpointCorruptError
from stencil_tpu_torch.telemetry import names as tm
from stencil_tpu_torch.utils.artifact import atomic_write, atomic_write_json, fsync_dir
from stencil_tpu_torch.utils.logging import log_info, log_warn

#: the commit marker and single source of checkpoint metadata
MANIFEST = "MANIFEST.json"

#: the manifest's vocabulary version, the JAX package's; a mismatch is a
#: classified corruption (the ring falls back), never a half-parse
SCHEMA = 1

#: retention-ring entry prefix: ``ckpt-<step:012d>``
RING_PREFIX = "ckpt-"


#: the backends the port reads and writes
BACKENDS = ("npz", "raw")


def _refuse_orbax(where: str) -> None:
    raise ValueError(
        f"{where}: the orbax backend (the JAX package's sharded raw arrays) is not ported; the port writes "
        "its raw stacks with backend='raw' and the portable interiors with 'npz' (ROADMAP.md queue 3)"
    )


def _check_backend(backend: str, where: str) -> None:
    if backend not in BACKENDS:
        _refuse_orbax(where)


def _raw_file(name: str) -> str:
    return f"raw-{name}.bin"


#: the storage dtypes of a raw stack, by the manifest's name; a bfloat16
#: stack is written and read as its 16-bit words
_RAW_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A stack's bytes on the host as numpy (bfloat16 as int16 words)."""
    t = t.detach().to("cpu").contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _interiors_from_stack(stack: torch.Tensor, geom: dict, size) -> torch.Tensor:
    """The valid global interior ``(*components, X, Y, Z)`` of a saved stack
    ``(*components, px, py, pz, Xr, Yr, Zr)``, cut through the SAVING
    domain's geometry (the stack-layout twin of the JAX package's
    ``_interiors_from_raw_global``)."""
    dim, lo = geom["mesh"], geom["shell_lo"]
    valid_last = geom.get("valid_last") or [None, None, None]
    n = [-(-size[a] // dim[a]) for a in range(3)]
    comps = tuple(stack.shape[:-6])
    out = torch.zeros(comps + tuple(size), dtype=stack.dtype)
    for ix in range(dim[0]):
        for iy in range(dim[1]):
            for iz in range(dim[2]):
                idx = (ix, iy, iz)
                v = [valid_last[a] if idx[a] == dim[a] - 1 and valid_last[a] is not None else n[a]
                     for a in range(3)]
                out[..., ix * n[0]:ix * n[0] + v[0], iy * n[1]:iy * n[1] + v[1], iz * n[2]:iz * n[2] + v[2]] = \
                    stack[(Ellipsis, ix, iy, iz) + tuple(slice(lo[a], lo[a] + v[a]) for a in range(3))]
    return out


def _load_raw(path: str, meta: dict, verify: bool) -> dict:
    """Every quantity's saved stack as a CPU tensor, each digest checked on
    its interior when ``verify``; a missing, short or mismatched file
    raises :class:`CheckpointCorruptError`."""
    geom = meta.get("geometry") or {}
    stacks = {}
    for q in meta["quantities"]:
        raw = q.get("raw") or {}
        dtype = _RAW_DTYPES.get(raw.get("dtype"))
        shape = tuple(raw.get("shape") or ())
        if dtype is None or not shape:
            raise CheckpointCorruptError(path, f"manifest has no raw stack for {q['name']!r}")
        fpath = os.path.join(path, _raw_file(q["name"]))
        words = np.int16 if dtype == torch.bfloat16 else torch.empty(0, dtype=dtype).numpy().dtype
        try:
            data = np.fromfile(fpath, dtype=words)
        except OSError as e:
            raise CheckpointCorruptError(path, f"unreadable {_raw_file(q['name'])}: {e}") from None
        if data.size != int(np.prod(shape)):
            raise CheckpointCorruptError(
                path, f"{_raw_file(q['name'])} holds {data.size} values, the manifest {int(np.prod(shape))}")
        t = torch.from_numpy(data).view(dtype).view(shape)
        if verify and q.get("digest"):
            native = _RAW_DTYPES.get(q["dtype"], torch.float32)
            got = _digest(_interiors_from_stack(t, geom, meta["size"]).to(native).numpy())
            if got != q["digest"]:
                raise CheckpointCorruptError(
                    path, f"digest mismatch for {q['name']!r}: manifest {q['digest']} != data {got}")
        stacks[q["name"]] = t
    return stacks


def _dtype_name(dtype) -> str:
    """numpy's name of a quantity's torch dtype (``"float32"``), as the
    JAX package's manifest records it."""
    return str(dtype).replace("torch.", "")


def _digest(arr: np.ndarray) -> str:
    # the array's own bytes, no copy of them (``tobytes`` would make one)
    return "sha256:" + hashlib.sha256(memoryview(np.ascontiguousarray(arr)).cast("B")).hexdigest()


def _commit_dir(stage: str, path: str) -> None:
    """Atomically make ``stage`` the content of ``path``.  An existing
    checkpoint at ``path`` is moved aside first and removed only after the
    new one is in place, so a crash at any point leaves one of the two
    intact."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    old = None
    if os.path.lexists(path):
        old = f"{path}.old.{os.getpid()}"
        if os.path.lexists(old):
            shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    try:
        os.rename(stage, path)
    except BaseException:
        if old is not None and not os.path.lexists(path):
            os.rename(old, path)
        raise
    fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def save_checkpoint(
    dd,
    path: str,
    step: int = 0,
    backend: Optional[str] = None,
    run_state: Optional[dict] = None,
    reason: str = "explicit",
    digests: Optional[bool] = None,
) -> str:
    """Write every quantity, the geometry and the run state atomically;
    returns the backend used (``"npz"``).  ``run_state`` is the caller's
    record (model knobs), merged under the axes the domain records itself
    (``storage_dtype``, ``halo_multiplier``, ``exchange_route``).
    ``digests=False`` records null digests (restores then skip the byte
    check); None digests on ``npz`` always and, on ``raw``, as
    ``STENCIL_CHECKPOINT_DIGESTS`` says (default on;
    ``stencil_tpu/io/checkpoint.py:156-162``, orbax's rule).  ``backend``: ``"npz"`` (None) or ``"raw"`` (module
    docstring)."""
    t0 = time.perf_counter()
    backend = backend or "npz"
    _check_backend(backend, f"save_checkpoint(backend={backend!r})")
    if digests is None:
        from stencil_tpu_torch.utils.config import env_bool

        digests = True if backend == "npz" else env_bool("STENCIL_CHECKPOINT_DIGESTS", True)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    dim = dd.grid_dim()
    raw = dd.local_spec().raw_size()
    lo = dd.shell_radius().lo()
    geometry = {
        "mesh": [dim.x, dim.y, dim.z],
        "raw": [raw.x, raw.y, raw.z],
        "shell_lo": [lo.x, lo.y, lo.z],
        "valid_last": list(dd.valid_last()),
    }
    size = list(dd.size())
    # what the digests cover: the portable interiors (native dtype; bf16
    # storage upcasts exactly).  npz gathers them on the card and saves them.
    # raw copies each stack to the host once and digests its interiors
    # there, on a second thread while the stacks are written (sha256
    # releases the GIL)
    pool = pending = stacks = interiors = None
    if backend == "raw":
        stacks = {h.name: dd.get_curr(h).detach().to("cpu") for h in dd._handles}
        if digests:
            pool = ThreadPoolExecutor(1)
            pending = {h.name: pool.submit(lambda h=h: _digest(
                _interiors_from_stack(stacks[h.name], geometry, size).to(h.dtype).numpy())) for h in dd._handles}
        nbytes = sum(math.prod(size) * h.cell_count() * h.dtype.itemsize for h in dd._handles)
    else:
        interiors = {h.name: dd.quantity_to_host(h) for h in dd._handles}
        nbytes = int(sum(a.nbytes for a in interiors.values()))
    # the caller's record first, the domain's axes last: a caller key never
    # shadows what the domain is
    state = dict(run_state or {})
    state.update(storage_dtype=dd.storage_dtype(), halo_multiplier=dd.halo_multiplier(),
                 exchange_route=dd.exchange_route())
    meta = {
        "schema": SCHEMA,
        "size": list(dd.size()),
        "step": int(step),
        "backend": backend,
        "created": time.time(),
        "quantities": [
            {
                "name": h.name,
                "dtype": _dtype_name(h.dtype),
                "components": list(h.components),
                "digest": _digest(interiors[h.name]) if digests and interiors is not None else None,
                **({"raw": {"shape": list(stacks[h.name].shape), "dtype": _dtype_name(dd.field_dtype(h))}}
                   if backend == "raw" else {}),
            }
            for h in dd._handles
        ],
        "geometry": geometry,
        "run_state": state,
    }
    stage = f"{path}.tmp.{os.getpid()}"
    if os.path.lexists(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    try:
        if backend == "raw":
            for h in dd._handles:
                with atomic_write(os.path.join(stage, _raw_file(h.name)), "wb") as f:
                    _host_bytes(stacks[h.name]).tofile(f)
            for q in meta["quantities"]:
                if pending is not None:
                    q["digest"] = pending[q["name"]].result()
        else:
            with atomic_write(os.path.join(stage, "state.npz"), "wb") as f:
                np.savez(f, **interiors)
        # the manifest LAST: the commit marker within the stage
        atomic_write_json(os.path.join(stage, MANIFEST), meta)
        fsync_dir(stage)
        _commit_dir(stage, path)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    finally:
        if pool is not None:
            pool.shutdown()
    dt = time.perf_counter() - t0
    telemetry.inc(tm.CHECKPOINT_SAVES)
    telemetry.inc(tm.CHECKPOINT_SAVE_BYTES, nbytes)
    telemetry.observe(tm.CHECKPOINT_SAVE_SECONDS, dt)
    telemetry.emit_event(tm.EVENT_CHECKPOINT_SAVE, path=path, step=int(step), backend=backend, bytes=nbytes,
                         seconds=round(dt, 6), reason=reason)
    log_info(f"checkpoint step {step} -> {path} ({backend}, {nbytes} B, {dt:.3f}s)")
    return backend


def load_manifest(path: str) -> dict:
    """The checkpoint's manifest, or a classified error explaining exactly
    why the directory is not usable (the satellite fix: a missing/partial
    manifest must reject with a clear message, not a stack trace
    mid-restore)."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isdir(path):
        raise CheckpointCorruptError(path, "no such directory")
    if not os.path.exists(mpath):
        legacy = os.path.join(path, "meta.json")
        why = (
            "pre-atomic 'meta.json' checkpoint format (schema predates the "
            "manifest; re-save with this version)"
            if os.path.exists(legacy)
            else f"missing {MANIFEST} — not a checkpoint, or an interrupted "
            "save that never committed"
        )
        raise CheckpointCorruptError(path, why)
    try:
        with open(mpath) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(path, f"unreadable manifest: {e}") from None
    if not isinstance(meta, dict) or meta.get("schema") != SCHEMA:
        raise CheckpointCorruptError(
            path,
            f"manifest schema {meta.get('schema') if isinstance(meta, dict) else '?'} "
            f"!= {SCHEMA} (saved by an incompatible version)",
        )
    for key in ("size", "step", "backend", "quantities"):
        if key not in meta:
            raise CheckpointCorruptError(path, f"manifest is missing {key!r}")
    return meta


def validate_checkpoint(path: str, verify_digests: bool = True) -> dict:
    """Full standalone validation: the manifest well-formed, the state
    present, every quantity in it with a matching digest.  Returns the
    manifest; raises :class:`CheckpointCorruptError` otherwise (and a
    ``ValueError`` for an orbax checkpoint)."""
    meta = load_manifest(path)
    _check_backend(meta["backend"], f"checkpoint {path}")
    if meta["backend"] == "raw":
        _load_raw(path, meta, verify_digests)
        return meta
    spath = os.path.join(path, "state.npz")
    if not os.path.exists(spath):
        raise CheckpointCorruptError(path, "missing state.npz")
    try:
        with np.load(spath) as data:
            for q in meta["quantities"]:
                if q["name"] not in data.files:
                    raise CheckpointCorruptError(path, f"state.npz is missing quantity {q['name']!r}")
                if verify_digests and q.get("digest"):
                    got = _digest(data[q["name"]])
                    if got != q["digest"]:
                        raise CheckpointCorruptError(
                            path, f"digest mismatch for {q['name']!r}: manifest {q['digest']} != data {got}")
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(path, f"unreadable state.npz: {e}") from None
    return meta


def _check_compat(dd, meta: dict, path: str) -> None:
    if meta["size"] != list(dd.size()):
        raise ValueError(f"checkpoint size {meta['size']} != domain {list(dd.size())}")
    by_name = {h.name: h for h in dd._handles}
    saved = {q["name"] for q in meta["quantities"]}
    if saved != set(by_name):
        raise ValueError(f"checkpoint quantities {sorted(saved)} != domain {sorted(by_name)} ({path})")
    for q in meta["quantities"]:
        h = by_name[q["name"]]
        if q["dtype"] != _dtype_name(h.dtype) or tuple(q.get("components", ())) != tuple(h.components):
            raise ValueError(
                f"quantity {q['name']!r}: checkpoint dtype/components ({q['dtype']}, {q.get('components')}) "
                f"!= domain ({_dtype_name(h.dtype)}, {list(h.components)})"
            )


def restore_checkpoint(dd, path: str, verify: bool = True) -> int:
    """Load every quantity into a realized domain; returns the saved step.
    The digests are verified on the LOADED interiors before any is
    installed, so a corrupt file raises :class:`CheckpointCorruptError`
    while the domain holds its previous state.  The interiors scatter
    through ``set_quantity`` onto this domain's grid, whatever the saving
    grid was (``elastic`` in the event when they differ).  A raw
    checkpoint onto the same grid and storage installs its stacks whole,
    shells included; onto any other, its interiors re-scatter likewise."""
    t0 = time.perf_counter()
    path = os.path.abspath(path)
    meta = load_manifest(path)
    _check_backend(meta["backend"], f"checkpoint {path}")
    _check_compat(dd, meta, path)
    by_name = {h.name: h for h in dd._handles}
    dim = dd.grid_dim()
    elastic = list((meta.get("geometry") or {}).get("mesh", [])) != [dim.x, dim.y, dim.z]
    if meta["backend"] == "raw":
        _restore_raw(dd, path, meta, verify, by_name)
        return _restored(meta, path, elastic, t0)
    spath = os.path.join(path, "state.npz")
    if not os.path.exists(spath):
        raise CheckpointCorruptError(path, "missing state.npz")
    try:
        data = np.load(spath)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(path, f"unreadable state.npz: {e}") from None
    with data:
        # two phases, load and verify everything, then install: a mismatch
        # on the last quantity leaves the domain whole on its previous state
        loaded = {}
        for q in meta["quantities"]:
            if q["name"] not in data.files:
                raise CheckpointCorruptError(path, f"state.npz is missing quantity {q['name']!r}")
            try:
                arr = data[q["name"]]
            except (OSError, ValueError, zipfile.BadZipFile) as e:
                raise CheckpointCorruptError(path, f"unreadable state.npz: {e}") from None
            if verify and q.get("digest"):
                got = _digest(arr)
                if got != q["digest"]:
                    raise CheckpointCorruptError(
                        path, f"digest mismatch for {q['name']!r}: manifest {q['digest']} != data {got}")
            loaded[q["name"]] = arr
    for q in meta["quantities"]:
        dd.set_quantity(by_name[q["name"]], loaded[q["name"]])
    return _restored(meta, path, elastic, t0)


def _restore_raw(dd, path: str, meta: dict, verify: bool, by_name: dict) -> None:
    """Install a raw checkpoint (module docstring): load and verify every
    stack first, then install the stacks whole when their shapes and
    dtypes are this domain's, else re-scatter their interiors."""
    stacks = _load_raw(path, meta, verify)
    same = all(tuple(t.shape) == tuple(dd._curr[n].shape) and t.dtype == dd._curr[n].dtype
               for n, t in stacks.items())
    if same:
        for n, t in stacks.items():
            dd._curr[n].copy_(t)
        dd.mark_shell_stale()  # the saved shell may have been stale
        return
    geom = meta.get("geometry") or {}
    for n, t in stacks.items():
        h = by_name[n]
        dd.set_quantity(h, _interiors_from_stack(t, geom, meta["size"]).to(h.dtype).numpy())


def _restored(meta: dict, path: str, elastic: bool, t0: float) -> int:
    dt = time.perf_counter() - t0
    telemetry.inc(tm.CHECKPOINT_RESTORES)
    telemetry.observe(tm.CHECKPOINT_RESTORE_SECONDS, dt)
    telemetry.emit_event(tm.EVENT_CHECKPOINT_RESTORE, path=path, step=int(meta["step"]), backend=meta["backend"],
                         elastic=elastic, seconds=round(dt, 6))
    log_info(f"restored step {meta['step']} from {path} ({meta['backend']}{', elastic' if elastic else ''}, "
             f"{dt:.3f}s)")
    return int(meta["step"])


# --- retention ring -----------------------------------------------------------


def ring_entries(root: str) -> List[Tuple[int, str]]:
    """(step, path) for every ring entry under ``root``, oldest first.
    Stage/aside directories from interrupted saves are ignored (and never
    counted against the ring)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if not name.startswith(RING_PREFIX) or name.endswith(".tmp") or ".tmp." in name or ".old." in name:
            continue
        try:
            step = int(name[len(RING_PREFIX):])
        except ValueError:
            continue
        out.append((step, os.path.join(root, name)))
    return sorted(out)


def ring_path(root: str, step: int) -> str:
    return os.path.join(root, f"{RING_PREFIX}{step:012d}")


def save_to_ring(
    dd,
    root: str,
    step: int,
    keep: int = 3,
    backend: Optional[str] = None,
    run_state: Optional[dict] = None,
    reason: str = "cadence",
) -> str:
    """Atomic checkpoint into the retention ring at ``root`` and prune to
    the newest ``keep`` entries; returns the committed path."""
    path = ring_path(root, step)
    save_checkpoint(dd, path, step=step, backend=backend, run_state=run_state, reason=reason)
    entries = ring_entries(root)
    for _, old in entries[: max(len(entries) - max(keep, 1), 0)]:
        shutil.rmtree(old, ignore_errors=True)
    # sweep stage/aside survivors of KILLED saves: same-pid cleanup cannot
    # run after a SIGKILL, and the ring has one writer at a time, so any
    # `.tmp.`/`.old.` ring-prefixed dir here is garbage the size of a full
    # checkpoint
    for name in os.listdir(root):
        if name.startswith(RING_PREFIX) and (".tmp." in name or ".old." in name):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    telemetry.set_gauge(tm.CHECKPOINT_RETAINED, min(len(entries), max(keep, 1)))
    return path


def restore_latest(dd, root: str, verify: bool = True) -> Optional[Tuple[str, dict, int]]:
    """Restore the newest ring checkpoint that RESTORES CLEANLY, falling
    back past entries that fail validation or digest verification; digests
    are hashed once an attempted entry.
    Returns ``(path, manifest, step)``, or None when nothing restores;
    compatibility errors (size/quantity mismatch — a config error, not
    corruption) propagate immediately."""
    for _, path in reversed(ring_entries(root)):
        try:
            meta = load_manifest(path)
            step = restore_checkpoint(dd, path, verify=verify)
            return path, meta, step
        except CheckpointCorruptError as e:
            telemetry.inc(tm.CHECKPOINT_INVALID)
            telemetry.emit_event(tm.EVENT_CHECKPOINT_FALLBACK, path=path, why=e.why)
            log_warn(
                f"checkpoint {path} failed restore ({e.why}); falling back "
                "to the previous ring entry"
            )
    return None


def latest_valid(root: str, verify_digests: bool = True) -> Optional[Tuple[str, dict]]:
    """The newest VALID ring checkpoint as ``(path, manifest)``, or None.
    Corrupt/partial entries are skipped with a warning, a
    ``checkpoint.invalid`` count and a ``checkpoint.fallback`` event: one
    bad checkpoint costs one cadence of progress, not the run."""
    for step, path in reversed(ring_entries(root)):
        try:
            return path, validate_checkpoint(path, verify_digests=verify_digests)
        except CheckpointCorruptError as e:
            telemetry.inc(tm.CHECKPOINT_INVALID)
            telemetry.emit_event(tm.EVENT_CHECKPOINT_FALLBACK, path=path, why=e.why)
            log_warn(
                f"checkpoint {path} failed validation ({e.why}); falling "
                "back to the previous ring entry"
            )
    return None
