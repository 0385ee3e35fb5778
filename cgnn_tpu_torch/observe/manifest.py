"""Run manifest (``cgnn_tpu/observe/manifest.py``): config and environment
fingerprint, written once a run.

Answers "what exactly was this run?" without scraping stdout: the flag
and config dict, the device inventory, the versions and the git SHA
(and dirty bit) of the working tree, in one JSON file
(``manifest.json``) beside ``metrics.jsonl`` and ``trace.json``. The JAX
manifest's keys, with the port's inventory: ``torch_version``,
``cuda_version`` (None for a CPU build of torch), ``backend`` (``cuda``
where a card is visible, else ``cpu``), ``device_count`` and
``devices`` (id, kind from ``torch.cuda.get_device_name``, platform).
There is no ``jax_version``: the port runs no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _git_info() -> dict:
    """Best-effort {git_sha, git_dirty} of the repo this package lives
    in."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=10,
        ).stdout.strip()
        if not sha:
            return {}
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=root, capture_output=True,
            text=True, timeout=10,
        ).stdout.strip()
        return {"git_sha": sha, "git_dirty": bool(dirty)}
    except Exception:  # noqa: BLE001 — no git in the image / not a repo
        return {}


def device_inventory() -> list[dict]:
    """One record a visible device: the cards, else the one CPU."""
    import torch

    if torch.cuda.is_available():
        return [{"id": i, "kind": torch.cuda.get_device_name(i),
                 "platform": "cuda"}
                for i in range(torch.cuda.device_count())]
    return [{"id": 0, "kind": "cpu", "platform": "cpu"}]


def build_manifest(config: dict | None = None, **extra) -> dict:
    """The manifest dict (separated from the write for testability)."""
    import torch

    devices = device_inventory()
    manifest = {
        "time": time.time(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": devices[0]["platform"],
        "device_count": len(devices),
        "devices": devices,
        **_git_info(),
    }
    if config is not None:
        manifest["config"] = {
            k: v for k, v in config.items()
            if isinstance(v, (int, float, str, bool, list, tuple, type(None)))
        }
    manifest.update(extra)
    return manifest


def write_manifest(log_dir: str, config: dict | None = None, **extra) -> str:
    """Write manifest.json under ``log_dir``; returns the path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "manifest.json")
    with open(path, "w") as f:
        # config, versions and inventory are finite by construction:
        # allow_nan=False makes a violation loud
        json.dump(build_manifest(config, **extra), f, indent=1,
                  allow_nan=False)
    return path
