"""LRU result cache keyed by a structure fingerprint
(``cgnn_tpu/serve/cache.py``).

The forward pass is deterministic given (parameters, structure, program),
so identical queries within one parameter version are answered from
memory. The fingerprint hashes the featurized arrays (atom features, edge
features, connectivity), so equal structures hit whichever client sent
them; a wire-form structure's key is ``data.rawbatch.raw_fingerprint``
(``raw:``), re-prefixed ``fs:`` when the host featurizes it
(serve/server.py), so a row the raw program computed never answers a
host-featurized request.

Entries are ``(row, param_version)`` and the server serves one only while
its version is live: a flush in flight across a hot reload writes its
rows after the swap's ``clear()``, and the hit-time check is what keeps
them from being served. The ``clear()`` only frees the slots.
"""

from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np


def structure_fingerprint(graph) -> str:
    """Content hash of a featurized structure (blake2b, 20 bytes, hex)."""
    h = hashlib.blake2b(digest_size=20)
    for arr in (graph.atom_fea, graph.edge_fea, graph.centers,
                graph.neighbors):
        a = np.ascontiguousarray(arr)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class ResultCache:
    """Thread-safe bounded LRU: fingerprint -> value."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def put(self, key: str, value) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def snapshot(self) -> tuple:
        """``(hits, misses, size, capacity)``, read together under the
        lock (a hit ratio from two unlocked reads could pair counts that
        never existed together)."""
        with self._lock:
            return (self.hits, self.misses, len(self._data), self.capacity)

    def stats(self) -> dict:
        hits, misses, size, capacity = self.snapshot()
        return {"size": size, "capacity": capacity, "hits": hits,
                "misses": misses}
