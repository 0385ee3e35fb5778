"""Build and load the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

Each ``csrc/<name>.cu`` compiles on first use to
``<checkout>/build/kernels/<name>-<hash>.so`` (the directory is listed in
``.gitignore``), where the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one loads as it is. ``build`` starts
one nvcc per source, all together, and waits for them. Nothing here runs
when the module is imported, and nothing falls back: a missing nvcc or a
failed build raises.

``build_host`` does the same for a host C++ source (the native neighbor
search, ``cgnn_tpu_torch/native``): g++ into
``<checkout>/build/native/<name>-<hash>.so``. Both write to a file named
after the process and rename it into place, so processes that build the
same library at once (featurization workers) never load half of one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "native"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], object] = {}  # (lib, name) -> ctypes function
# name -> {"seconds": wall time of this process's build (0.0 when the
# library was already on disk), "log": nvcc/ptxas output}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_FALLBACK):
        return NVCC_FALLBACK
    raise RuntimeError(
        f"nvcc not found (neither on PATH nor at {NVCC_FALLBACK}): "
        "the CUDA kernels build only where the CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that is not built yet, in parallel.
    -> {name: path of its shared library}."""
    targets = {name: _target(name) for name in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    for name in targets:
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log = f"nvcc timed out after 600 s\n{log}"
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])  # atomic: a reader never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def build_host(source: Path) -> Path:
    """Compile the host C++ ``source`` with g++ unless it is built already
    -> the path of its shared library. Raises where g++ is not on PATH,
    and with the compiler's output where it fails."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(HOST_FLAGS).encode()).hexdigest()
    target = HOST_BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if target.exists():
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {source.name} builds "
                           "only where a C++ compiler is installed")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *HOST_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    build_info[source.stem] = {"seconds": time.perf_counter() - t0,
                               "log": proc.stdout + proc.stderr}
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees half
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def entry(lib: str, name: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """``name`` of ``csrc/<lib>.cu``'s library as a ctypes function that
    takes ``n_ptrs`` device pointers, ``n_ints`` ints, ``n_floats`` floats
    and the stream, and returns the launch's cudaError_t (0 = queued).
    Resolved once, after the first build: later calls are a dict lookup,
    without the lock."""
    fn = _entries.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entries[(lib, name)] = fn
    return fn


def launch(label: str, fn, ptrs, dims: dict, device) -> None:
    """Call an ``entry`` on ``device``'s current stream with the pointers,
    then the ``dims`` values in order; raise on a refused launch. The
    current device is switched only when ``device`` is another card."""
    import torch

    # the current stream's raw cudaStream_t, without a Stream object
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*ptrs, *dims.values(),
                 torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, *dims.values(),
                     torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        shape = ", ".join(f"{k}={v}" for k, v in dims.items())
        raise RuntimeError(
            f"{label} kernel launch failed: cudaError {err} ({shape})")


def counted(n: int = 1) -> int:
    """What a wrapper adds to its ``.launches`` for ``n`` kernels it just
    queued: ``n``, or 0 while the current stream captures a CUDA graph.
    A capture records the kernels and launches nothing; each replay of
    the graph launches them without the wrapper (a trace of the card
    counts those launches)."""
    import torch

    return 0 if torch.cuda.is_current_stream_capturing() else n
