"""Segment sum of edge messages over sorted centers
(``cgnn_tpu/ops/pallas_scatter.py``): the flat COO layout's aggregation,
``aggregate_edge_messages(impl='pallas')``.

The packer keeps ``centers`` non-decreasing (data/graph.py), so node n's
messages are the contiguous rows ``[offsets[n], offsets[n+1])``, with the
offsets from a device ``searchsorted`` (``segment_offsets``; ``bincount``
would read its maximum back to the host) or those a COO training batch
carries (``center_offsets``). The sum accumulates in f32 and
is cast back to the messages' dtype. No mask: padding edges carry zero
messages because CGConv masks them, as in the JAX package.

- ``segment_sum_sorted_cuda``, the wrapper of kernel 6 (``csrc/
  segment_sum.cu``): f32 CUDA tensors only, launches on the current
  stream, raises on a refused launch, counts ``.launches``;
- ``segment_sum_sorted_reference``, its plain PyTorch version:
  ``torch.segment_reduce`` over the same offsets;
- ``segment_sum_sorted(messages, centers, num_nodes, impl)``, the
  differentiable op: ``impl='pallas'`` launches the kernel on a CUDA
  tensor (or raises) and runs the plain version on a CPU tensor;
  ``impl='xla'`` asks for the plain version by name. Its backward is the
  gather ``g[centers]`` (``SegmentSumSorted``), the JAX ``_bwd``.
"""

from __future__ import annotations

import torch

from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.ops.fused_epilogue import runs_kernel

MAX_F = 256  # the kernel keeps at most 8 channels a lane


def segment_offsets(centers: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[N + 1] i32 first-edge offsets of each node in sorted ``centers``
    (no host sync)."""
    return torch.searchsorted(
        centers, torch.arange(num_nodes + 1, dtype=centers.dtype,
                              device=centers.device), out_int32=True)


def segment_sum_sorted_reference(messages: torch.Tensor,
                                 offsets: torch.Tensor) -> torch.Tensor:
    """[E, F] messages, [N + 1] offsets -> [N, F] sums, accumulated in f32
    and cast back to the messages' dtype; an empty node gets 0.
    ``unsafe=True`` skips the validation that reads the lengths back to
    the host (``segment_offsets`` makes valid offsets)."""
    out = torch.segment_reduce(messages.float(), "sum", offsets=offsets,
                               axis=0, unsafe=True)
    return out.to(messages.dtype)


def long_range_rows(f: int) -> int:
    """L: a node with more rows than this is summed by its whole block
    (two rounds of the kernel's rows in flight, ``kLong`` in
    csrc/segment_sum.cu)."""
    per_lane = 1 if f <= 32 else 2 if f <= 64 else 4 if f <= 128 else 8
    return 2 * (32 // per_lane)


def segment_sum_sorted_cuda(messages: torch.Tensor,
                            offsets: torch.Tensor) -> torch.Tensor:
    """Kernel 6 (replaces pallas_scatter.py ``_kernel``): messages [E, F]
    f32 and offsets [N + 1] i32, contiguous on one CUDA device -> [N, F]
    f32, each node's rows summed in an order fixed by the offsets (edge
    order; parts in part order for a node of more than
    ``long_range_rows(F)`` rows)."""
    dev = messages.device
    if dev.type != "cuda":
        raise ValueError(
            f"segment_sum_sorted_cuda takes CUDA tensors, got {dev}")
    if messages.dim() != 2 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError(
            f"messages must be [E, F] and offsets [N + 1], got "
            f"{tuple(messages.shape)} and {tuple(offsets.shape)}")
    if offsets.device != dev:
        raise ValueError(f"offsets is on {offsets.device}, messages on {dev}")
    if messages.dtype != torch.float32:
        raise ValueError(
            f"messages must be {torch.float32}, got {messages.dtype}")
    if offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be {torch.int32}, got {offsets.dtype}")
    if not messages.is_contiguous():
        raise ValueError("messages must be contiguous")
    if not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous")
    n = offsets.numel() - 1
    f = messages.shape[1]
    if not 1 <= f <= MAX_F:
        raise ValueError(f"F={f} outside the kernel's [1, {MAX_F}]")
    out = messages.new_empty((n, f))
    if n == 0:
        return out
    _build.launch(
        "segment_sum_sorted",
        _build.entry("segment_sum", "segment_sum_sorted_f32", 3, 2),
        (messages.data_ptr(), offsets.data_ptr(), out.data_ptr()),
        {"N": n, "F": f}, dev)
    segment_sum_sorted_cuda.launches += _build.counted(1)
    return out


segment_sum_sorted_cuda.launches = 0


class SegmentSumSorted(torch.autograd.Function):
    """The sorted segment sum with the gather ``g[centers]`` as its
    backward (the op is linear; centers get no gradient)."""

    @staticmethod
    def forward(ctx, messages, centers, num_nodes: int, impl: str,
                offsets=None):
        ctx.save_for_backward(centers)
        if offsets is None:
            offsets = segment_offsets(centers, num_nodes)
        if runs_kernel(impl, messages):
            return segment_sum_sorted_cuda(messages.contiguous(),
                                           offsets).to(messages.dtype)
        return segment_sum_sorted_reference(messages, offsets)

    @staticmethod
    def backward(ctx, g):
        (centers,) = ctx.saved_tensors
        return g.index_select(0, centers), None, None, None, None


def segment_sum_sorted(messages: torch.Tensor, centers: torch.Tensor,
                       num_nodes: int, impl: str = "pallas",
                       offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Sum [E, F] ``messages`` into [num_nodes, F] over non-decreasing
    ``centers`` [E] i32 (module docstring); ``offsets``: the centers'
    [num_nodes + 1] i32 ``segment_offsets`` where the caller has them."""
    return SegmentSumSorted.apply(messages, centers, num_nodes, impl,
                                  offsets)


def segment_sum_cost(e: int, n: int, f: int) -> dict:
    """Compulsory bytes and f32 operations of one kernel-6 call: the [E, F]
    f32 messages and [E] i32 centers read once, the [N, F] f32 sums written
    once (the offsets the wrapper derives from the centers are not
    counted); one add a message element."""
    return {"bytes": e * f * 4 + e * 4 + n * f * 4, "flops": e * f}
