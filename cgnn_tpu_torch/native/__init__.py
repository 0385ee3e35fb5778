"""The host C++ neighbor search (``cgnn_tpu/native``'s counterpart),
built with g++ at first use and called through ctypes.

``neighbors.cpp`` is a periodic cell list that returns integer candidate
pairs (center, neighbor, image) sorted as the numpy search emits its
pairs; ``data/neighbors.py`` recomputes their distances with the numpy
search's own arithmetic, so both backends give the same arrays bit for
bit, order included (the canonical tie order of the k-nearest cut).

The library builds through ``ops/_build.build_host`` into
``<checkout>/build/native/`` (a hashed name; a per-process temporary file
renamed into place, so parallel featurization workers do not race). A
ctypes call releases the GIL, so packer threads search in parallel.

Backends (``resolve``): ``'native'`` needs g++ on PATH and raises
without it; ``'auto'`` is native where g++ is on PATH and numpy where it
is not, saying so once on stderr; where g++ is present a failed build
or load raises with the compiler's output; nothing falls back quietly.
``backend_used()`` names the backend of this process's last search
(worker processes keep their own).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "neighbors.cpp"
BACKENDS = ("auto", "native", "numpy")

_lock = threading.Lock()
_fn = None
_said_no_gxx = False
_which: tuple = (None, False)  # (the PATH it was looked up on, found)
_last: str | None = None


def has_compiler() -> bool:
    """Whether g++ is on PATH (looked up again when PATH changes)."""
    global _which
    path = os.environ.get("PATH")
    if _which[0] != path:
        _which = (path, shutil.which("g++") is not None)
    return _which[1]


def resolve(backend: str) -> str:
    """The backend a search with ``backend`` runs: 'native' or 'numpy'.
    Builds and loads the library where it resolves to native, and raises
    where that fails (module docstring)."""
    global _said_no_gxx
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "numpy":
        return "numpy"
    if not has_compiler():
        if backend == "native":
            raise RuntimeError("native neighbor backend needs g++ on PATH "
                               "(backend='numpy' runs the numpy search)")
        if not _said_no_gxx:
            _said_no_gxx = True
            print("neighbor search: g++ not on PATH; using the numpy "
                  "backend", file=sys.stderr)
        return "numpy"
    _entry()
    return "native"


def _entry():
    """The loaded search function, built on first use."""
    global _fn
    if _fn is not None:
        return _fn
    with _lock:
        if _fn is None:
            from cgnn_tpu_torch.ops._build import build_host

            lib = ctypes.CDLL(str(build_host(SOURCE)))
            fn = lib.cgnn_torch_neighbor_candidates
            fn.restype = ctypes.c_longlong
            f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            fn.argtypes = [f64, f64, f64, ctypes.c_longlong, ctypes.c_double,
                           i32, ctypes.c_longlong, i32, i32, i32]
            _fn = fn
    return _fn


def note(backend: str) -> None:
    """Record that a search ran on ``backend``."""
    global _last
    _last = backend


def backend_used() -> str | None:
    """The backend of this process's last search (None before any)."""
    return _last


def candidates(lattice: np.ndarray, frac: np.ndarray, cart: np.ndarray,
               radius: float, images) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Every (center, neighbor, image) within ``radius`` of the wrapped
    positions, images within ``images`` (na, nb, nc), the home self pair
    left out, sorted by (center, neighbor, a, b, c) -> (centers [E] i32,
    neighbors [E] i32, offsets [E, 3] i32)."""
    fn = _entry()
    lattice = np.ascontiguousarray(lattice, np.float64)
    frac = np.ascontiguousarray(frac, np.float64)
    cart = np.ascontiguousarray(cart, np.float64)
    imgs = np.ascontiguousarray(images, np.int32)
    n = len(frac)
    if (lattice.shape != (3, 3) or frac.shape != (n, 3)
            or cart.shape != (n, 3) or imgs.shape != (3,) or imgs.min() < 0):
        raise ValueError(
            f"native neighbor search: lattice {lattice.shape}, frac "
            f"{frac.shape}, cart {cart.shape}, images {imgs.tolist()}")
    # the pairs a uniform density gives, with room: one call as a rule
    volume = abs(float(np.linalg.det(lattice)))
    cap = int(1.5 * n * n * 4.19 * float(radius) ** 3 / volume) + 1024
    for _ in range(3):
        centers = np.empty(cap, np.int32)
        neighbors = np.empty(cap, np.int32)
        offsets = np.empty(cap * 3, np.int32)
        got = fn(lattice, frac, cart, n, float(radius), imgs, cap, centers,
                 neighbors, offsets)
        if got >= 0:
            return (centers[:got], neighbors[:got],
                    offsets[: got * 3].reshape(-1, 3))
        if got == -1:
            raise ValueError("native neighbor search: bad input (a singular "
                             "cell or a non-positive radius)")
        cap = int(-got)
    raise RuntimeError("native neighbor search: capacity negotiation failed")
