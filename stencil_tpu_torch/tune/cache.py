"""Persistent tuned-config cache: one JSON file per workload key
(counterpart of ``stencil_tpu/tune/cache.py``).

Layout: ``<cache_dir>/<key.digest()>.json`` with

    {"schema": 2,
     "torch": "<torch.__version__>", "cuda": "<torch.version.cuda>",
     "key": {...WorkloadKey...},
     "config": {...the winning config...},
     "meta": {...the trials' record...}}

``load`` returns ``(config, meta)`` only when the schema and the torch /
CUDA versions (``kernels.toolchain``) match the running process: another
toolchain is a miss with one info line, as a cold cache is; a corrupt or
truncated file is a miss with a warning, never an error.

The directory is ``STENCIL_TUNE_CACHE`` (a validated read), else
``~/.cache/stencil_tpu_torch/tune``: the port's own, so the two packages'
files never overwrite each other's; the drivers' ``--tune-cache`` overrides
it for a run (``tune.set_cache_dir``).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

from stencil_tpu_torch.tune.key import WorkloadKey
from stencil_tpu_torch.utils.config import env_str

#: the persisted vocabulary's version (the JAX package's: 2 since the
#: ``exchange_route`` field); a mismatch is a miss
SCHEMA = 2

_DEFAULT_DIR = os.path.join("~", ".cache", "stencil_tpu_torch", "tune")

#: process-local override (driver --tune-cache); None = the env / default
_dir_override: Optional[str] = None


def set_dir_override(path: Optional[str]) -> None:
    global _dir_override
    _dir_override = path


def cache_dir() -> str:
    path = _dir_override or env_str("STENCIL_TUNE_CACHE", _DEFAULT_DIR)
    return os.path.abspath(os.path.expanduser(path))


def _toolchain() -> Tuple[str, Optional[str]]:
    """The stamp: ``(torch.__version__, torch.version.cuda)``, the two
    fields of ``kernels.toolchain()`` a tuned config depends on (read
    directly: the stamp is taken at every load and must not query the
    card)."""
    import torch

    return torch.__version__, torch.version.cuda


def path_for(key: WorkloadKey) -> str:
    return os.path.join(cache_dir(), f"{key.digest()}.json")


def load(key: WorkloadKey) -> Optional[Tuple[dict, dict]]:
    """(config, meta) for ``key``, or None on a miss (absent, corrupt, or
    stored by another toolchain or schema)."""
    path = path_for(key)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        from stencil_tpu_torch.utils.logging import log_warn

        log_warn(f"tune cache {path} is unreadable ({e}); treating as a miss")
        return None
    torch_v, cuda_v = _toolchain()
    if (
        not isinstance(doc, dict)
        or doc.get("schema") != SCHEMA
        or doc.get("torch") != torch_v
        or doc.get("cuda") != cuda_v
        or not isinstance(doc.get("config"), dict)
    ):
        from stencil_tpu_torch.utils.logging import log_info

        log_info(
            f"tune cache {path} is stale (schema/toolchain mismatch); "
            "configs must be re-qualified on this toolchain; treating as a miss"
        )
        return None
    return doc["config"], doc.get("meta") or {}


def store(key: WorkloadKey, config: dict, meta: Optional[dict] = None) -> str:
    """Persist the winning config atomically (``utils/artifact.py``: a run
    that dies mid-write leaves no truncated file)."""
    torch_v, cuda_v = _toolchain()
    doc = {
        "schema": SCHEMA,
        "torch": torch_v,
        "cuda": cuda_v,
        "key": key.to_dict(),
        "config": config,
        "meta": meta or {},
    }
    from stencil_tpu_torch.utils.artifact import atomic_write_json

    return atomic_write_json(path_for(key), doc)
