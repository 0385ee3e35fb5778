"""Windowed neighbor gather (``cgnn_tpu/ops/pallas_gather.py``).

``out[n, j] = nodes[nbr[n*M + j]]`` for the dense layout's [N*M] neighbor
slots, under the window contract: node block b (128 rows) reads only the
rows ``[ws[b], ws[b] + window)``, and an index outside that window gives
a zero row. The window starts are clamped to ``N - window`` and aligned
down to 128, as the JAX wrapper does. On a real batch with
``window >= window_width(max graph nodes)`` and starts from
``window_starts``, every neighbor lies inside its window and the result
equals ``nodes[nbr]``. No model path calls it, as in the JAX package
(only its tests do).

- ``windowed_gather_cuda``, the wrapper of kernel 7 (``csrc/
  windowed_gather.cu``): f32 CUDA tensors only, launches on the current
  stream, raises on a refused launch, counts ``.launches``;
- ``windowed_gather_reference``, its plain PyTorch version: a masked
  ``index_select`` with the same clamping;
- ``windowed_gather(nodes, neighbors, win_starts, window, impl)``:
  ``impl='pallas'`` launches the kernel on a CUDA tensor (or raises) and
  runs the plain version on a CPU tensor; ``impl='xla'`` asks for the
  plain version by name.

Both select: a non-finite value in a window row reaches only the slots
that read that row (the JAX kernel's one-hot matmul spreads it over its
block as 0 * inf), so the two agree on finite inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.ops.fused_epilogue import runs_kernel

TN = 128  # node rows per window block


def window_width(max_graph_nodes: int) -> int:
    """Static window for a dataset: a 128-slot block can straddle one
    graph cut at its start and another at its end, plus one extra tile
    for the 128-row alignment of the window start."""
    need = 2 * TN + 2 * (int(max_graph_nodes) - 1)
    return max(TN, -(-need // TN) * TN)


def window_starts(n_blocks: int, n_pad: int, window: int) -> np.ndarray:
    """[n_blocks] i32 aligned window starts: block b's graphs' node span
    sits inside ``[ws[b], ws[b] + window)`` (the JAX package's
    ``pallas_cgconv._win_starts``)."""
    pad_left = max((window - 2 * TN) // 2, 0)
    ws = np.arange(n_blocks, dtype=np.int64) * TN - pad_left
    ws = (ws // TN) * TN
    ws = np.clip(ws, 0, max(n_pad - window, 0))
    return ws.astype(np.int32)


def _check_shapes(nodes, neighbors, win_starts, window) -> int:
    """The JAX wrapper's preconditions -> M."""
    n = nodes.shape[0]
    e = neighbors.shape[0]
    if nodes.dim() != 2 or neighbors.dim() != 1 or win_starts.dim() != 1:
        raise ValueError(
            f"nodes must be [N, F], neighbors [N*M] and win_starts [N/128], "
            f"got {tuple(nodes.shape)}, {tuple(neighbors.shape)}, "
            f"{tuple(win_starts.shape)}")
    if n % TN or n == 0:
        raise ValueError(f"node capacity {n} is not a positive multiple of "
                         f"{TN}")
    if window % TN or not 0 < window <= n:
        raise ValueError(f"window {window} must be a multiple of {TN} in "
                         f"(0, N={n}]")
    if e % n:
        raise ValueError(f"{e} neighbor slots are not N * M for N={n}")
    if win_starts.shape[0] != n // TN:
        raise ValueError(f"win_starts has {win_starts.shape[0]} entries, "
                         f"want N/128 = {n // TN}")
    return e // n


def windowed_gather_reference(nodes, neighbors, win_starts,
                              window: int) -> torch.Tensor:
    """The plain version: ``nodes[nbr]`` with out-of-window slots zeroed
    (selected, not multiplied) -> [N, M, F] in the nodes' dtype. The
    starts as the JAX wrapper takes them: min(ws, max(N - window, 0)),
    then floored to a multiple of 128."""
    m = _check_shapes(nodes, neighbors, win_starts, window)
    n = nodes.shape[0]
    ws = torch.clamp(win_starts.to(torch.int32), max=max(n - window, 0))
    ws = torch.div(ws, TN, rounding_mode="floor") * TN
    idx = neighbors.to(torch.int64)
    start = ws.to(torch.int64).repeat_interleave(TN * m)
    inside = (idx >= 0) & (idx >= start) & (idx < start + window)
    rows = nodes.index_select(0, torch.where(inside, idx, 0))
    out = torch.where(inside[:, None], rows, torch.zeros_like(rows))
    return out.reshape(n, m, nodes.shape[1])


def windowed_gather_cuda(nodes, neighbors, win_starts,
                         window: int) -> torch.Tensor:
    """Kernel 7 (replaces pallas_gather.py ``_kernel``): nodes [N, F] f32,
    neighbors [N*M] i32, win_starts [N/128] i32, contiguous on one CUDA
    device -> the output of ``windowed_gather_reference``."""
    dev = nodes.device
    if dev.type != "cuda":
        raise ValueError(f"windowed_gather_cuda takes CUDA tensors, got {dev}")
    m = _check_shapes(nodes, neighbors, win_starts, window)
    for name, t, dtype in (("nodes", nodes, torch.float32),
                           ("neighbors", neighbors, torch.int32),
                           ("win_starts", win_starts, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, nodes on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, f = nodes.shape
    out = torch.empty((n, m, f), dtype=torch.float32, device=dev)
    if m == 0 or f == 0:
        return out
    _build.launch(  # the kernel clamps and aligns the starts itself
        "windowed_gather",
        _build.entry("windowed_gather", "windowed_gather_f32", 4, 4),
        (nodes.data_ptr(), neighbors.data_ptr(), win_starts.data_ptr(),
         out.data_ptr()),
        dict(N=n, M=m, F=f, window=window), dev)
    windowed_gather_cuda.launches += 1
    return out


windowed_gather_cuda.launches = 0


def windowed_gather(nodes: torch.Tensor, neighbors: torch.Tensor,
                    win_starts: torch.Tensor, window: int,
                    impl: str = "pallas") -> torch.Tensor:
    """[N, M, F] neighbor rows under the window contract (module
    docstring)."""
    if runs_kernel(impl, nodes):
        return windowed_gather_cuda(nodes.contiguous(),
                                    neighbors.contiguous(),
                                    win_starts.contiguous(), window)
    return windowed_gather_reference(nodes, neighbors, win_starts, window)


def windowed_gather_cost(n: int, m: int, f: int) -> dict:
    """Compulsory bytes of one kernel-7 call: the [N, M, F] f32 output
    written once, the [N, F] f32 nodes, [N*M] i32 indices and [N/128] i32
    window starts read once. No arithmetic."""
    return {"bytes": n * m * f * 4 + n * f * 4 + n * m * 4 + (n // TN) * 4,
            "flops": 0}
