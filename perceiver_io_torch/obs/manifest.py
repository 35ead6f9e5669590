"""Run manifests: the provenance record written beside an artifact.

Port of ``perceiver_io_tpu/obs/manifest.py`` with the ``run-manifest/v1``
schema and its field names. A trace or a metrics stream compares across
runs only when it says what produced it: the commit, the torch and CUDA
versions, the devices, the config. ``build_run_manifest`` collects that,
every probe guarded (a missing git binary or no card degrades a field to
None, never fails the artifact), and ``write_run_manifest`` writes it beside
the artifact as ``<artifact stem>.manifest.json``. ``versions`` holds
``torch``, ``cuda`` (``torch.version.cuda``, None on a CPU build) and
``python`` where the JAX package writes ``jax`` and ``jaxlib``;
``devices`` is ``{"backend": "cuda" | "cpu", "count", "kinds"}`` with the
cards' names. ``ARTIFACT_SCHEMAS`` names every artifact format the port
writes, so a reader can refuse a mismatched file loudly.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from typing import Dict, Optional

MANIFEST_SCHEMA = "run-manifest/v1"

# every artifact schema the port writes
ARTIFACT_SCHEMAS = {
    "serving_metrics": "serving-metrics/v12",
    "train_metrics": "train-metrics/v1",
    "chrome_trace": "chrome-trace/v1",
    "request_journal": "request-journal/v1",
    "run_manifest": MANIFEST_SCHEMA,
}


def _git_sha() -> Optional[str]:
    try:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        out = subprocess.run(["git", "-C", repo, "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def _torch_versions() -> Dict[str, Optional[str]]:
    versions: Dict[str, Optional[str]] = {"torch": None, "cuda": None}
    try:
        import torch

        versions["torch"] = torch.__version__
        versions["cuda"] = torch.version.cuda
    except Exception:
        pass
    return versions


def _devices() -> Dict:
    try:
        import torch

        if torch.cuda.is_available():
            count = torch.cuda.device_count()
            return {"backend": "cuda", "count": count, "kinds": [torch.cuda.get_device_name(i) for i in range(count)]}
        return {"backend": "cpu", "count": 1, "kinds": ["cpu"]}
    except Exception:
        return {"backend": None, "count": None, "kinds": None}


def _jsonable(obj):
    """Best-effort plain-JSON projection of a config object (a dataclass, a
    namespace, a dict); leaves that do not encode become their repr."""
    if obj is None:
        return None
    if hasattr(obj, "__dataclass_fields__"):
        import dataclasses

        try:
            obj = dataclasses.asdict(obj)
        except Exception:
            # asdict deep-copies field values and raises on ones that do not
            # pickle (locks, generators, recorders): take the shallow fields
            obj = dict(vars(obj))
    elif hasattr(obj, "__dict__") and not isinstance(obj, dict):
        obj = dict(vars(obj))
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(k): _jsonable(v) for k, v in obj.items()}
        return repr(obj)


def build_run_manifest(config=None, extra: Optional[Dict] = None) -> Dict:
    """Provenance: git sha, torch/CUDA/python versions, devices, platform,
    the producing config and the artifact schema map."""
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": _git_sha(),
        "versions": {**_torch_versions(), "python": sys.version.split()[0]},
        "platform": platform.platform(),
        "devices": _devices(),
        "config": _jsonable(config),
        "artifact_schemas": dict(ARTIFACT_SCHEMAS),
    }
    if extra:
        manifest.update(_jsonable(extra) or {})
    return manifest


def manifest_path_for(artifact_path: str) -> str:
    stem, _ = os.path.splitext(artifact_path)
    return stem + ".manifest.json"


def write_run_manifest(artifact_path: str, config=None, extra: Optional[Dict] = None) -> str:
    """Write the manifest beside ``artifact_path`` atomically (through
    ``training/checkpoint.atomic_write_json``); returns its path."""
    from perceiver_io_torch.training.checkpoint import atomic_write_json

    path = manifest_path_for(artifact_path)
    atomic_write_json(path, build_run_manifest(config=config, extra=extra), indent=1)
    return path
