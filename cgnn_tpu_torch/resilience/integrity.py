"""Checkpoint integrity manifests (``cgnn_tpu/resilience/integrity.py``):
per-leaf shape, dtype and checksum, in the JAX package's ``MANIFEST.json``
format 1.

A manifest describes every leaf of a saved tree. In
``train.checkpoint.CheckpointManager`` it is the commit marker (written
last inside a save's temp directory, just before the atomic rename: a
directory without one is an uncommitted save and is never offered for
restore) and the verification of a restore (shape, dtype and crc32 of
the C-contiguous bytes of each leaf), so on-disk corruption falls through
to the next checkpoint of the fallback chain.

A tree here is nested dicts of numpy arrays (or scalars), walked in
sorted-key order; a leaf is keyed by its ``/``-joined path and its dtype
by numpy's name. For the same arrays that is the JAX package's manifest:
``jax.tree_util`` flattens dicts in sorted-key order too.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

MANIFEST_NAME = "MANIFEST.json"
_FORMAT = 1


class IntegrityError(Exception):
    """A restored tree does not match its manifest."""


def _leaf_entries(tree, prefix: str = "") -> list[tuple[str, np.ndarray]]:
    """(path, host array) per leaf, in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, np.asarray(tree))]
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        out += _leaf_entries(tree[key], path)
    return out


def _checksum(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def tree_manifest(tree) -> dict:
    """Manifest dict for a tree of host arrays."""
    return {
        "format": _FORMAT,
        "leaves": {
            path: {
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": _checksum(arr),
            }
            for path, arr in _leaf_entries(tree)
        },
    }


def write_manifest(directory: str, manifest: dict) -> str:
    """Write ``MANIFEST.json`` into ``directory``, fsynced so that a crash
    right after the enclosing atomic rename cannot leave a committed save
    with a torn manifest."""
    path = os.path.join(directory, MANIFEST_NAME)
    with open(path, "w") as f:
        # the entries are finite by construction: fail loudly on a NaN
        # rather than commit an unparseable marker
        json.dump(manifest, f, indent=1, allow_nan=False)
        f.flush()
        os.fsync(f.fileno())
    return path


def read_manifest(directory: str) -> dict | None:
    """The directory's manifest, or None when it is absent or
    unparseable (an uncommitted or corrupted save: callers treat both the
    same)."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        return None
    return manifest


def verify_tree(tree, manifest: dict) -> None:
    """Raise IntegrityError unless every leaf matches the manifest: leaf
    set, shapes, dtypes and crc32 (the disk bytes and the load path)."""
    entries = dict(_leaf_entries(tree))
    expected = manifest["leaves"]
    missing = sorted(set(expected) - set(entries))
    extra = sorted(set(entries) - set(expected))
    if missing or extra:
        raise IntegrityError(
            f"leaf set mismatch: missing={missing[:4]} extra={extra[:4]}")
    for path, arr in entries.items():
        want = expected[path]
        if list(arr.shape) != list(want["shape"]):
            raise IntegrityError(
                f"{path}: shape {list(arr.shape)} != saved {want['shape']}")
        if str(arr.dtype) != want["dtype"]:
            raise IntegrityError(
                f"{path}: dtype {arr.dtype} != saved {want['dtype']}")
        crc = _checksum(arr)
        if crc != want["crc32"]:
            raise IntegrityError(
                f"{path}: crc32 {crc} != saved {want['crc32']} "
                f"(on-disk corruption)")
