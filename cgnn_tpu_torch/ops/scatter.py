"""Segment sum of edge messages over sorted centers
(``cgnn_tpu/ops/pallas_scatter.py``): the flat COO layout's aggregation,
``aggregate_edge_messages(impl='pallas')``, and the fixed-order
gather/sum pair that every sorted sum of the port is built from.

The packer keeps ``centers`` non-decreasing (data/graph.py), so node n's
messages are the contiguous rows ``[offsets[n], offsets[n+1])``, with the
offsets from a device ``searchsorted`` (``segment_offsets``; ``bincount``
would read its maximum back to the host) or those a COO training batch
carries (``center_offsets``). The sum accumulates in f32 and
is cast back to the messages' dtype. No mask: padding edges carry zero
messages because CGConv masks them, as in the JAX package.

- ``segment_sum_sorted_cuda`` and ``segment_sum_sorted_bf16_cuda``, the
  wrappers of kernel 6's f32 and bf16 instances (``csrc/
  segment_sum.cu``): CUDA tensors of their dtype only, launch on the
  current stream, raise on a refused launch, count ``.launches``;
- ``segment_sum_sorted_reference``, their plain PyTorch version:
  ``torch.segment_reduce`` over the same offsets, in f32 (f64 stays f64);
- ``SortedGather`` and ``SortedSum``, each the other's transpose:
  ``values[indices]``, and the sum of ``ct``'s rows into the rows they
  were gathered from, taken in stable sorted order of the indices
  (``order``; None when the indices are sorted already) and summed over
  each row's run (``offsets``). Each one's backward is the other through
  ``.apply``, so the pair can be differentiated any number of times (the
  force task differentiates twice) and every sum, at every order, runs in
  the packer's order. ``impl='pallas'`` sums with kernel 6 on a CUDA
  tensor (or raises) and with the plain version on a CPU tensor;
  ``impl='xla'`` asks for the plain version by name;
- ``segment_sum_sorted(messages, centers, num_nodes, impl)``, the
  aggregation: ``SortedSum`` over the sorted centers. Its backward is the
  gather ``g[centers]``, the JAX ``_bwd``.
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
    (f64 in f64) and cast back to the messages' dtype; an empty node gets
    0. ``unsafe=True`` skips the validation that reads the lengths back to
    the host (``segment_offsets`` makes valid offsets)."""
    acc = torch.promote_types(messages.dtype, torch.float32)
    out = torch.segment_reduce(messages.to(acc), "sum", offsets=offsets,
                               axis=0, unsafe=True)
    return out.to(messages.dtype)


def long_range_rows(f: int) -> int:
    """L: a node with more rows than this is summed by its whole block
    (two rounds of the kernel's rows in flight, ``kLong`` in
    csrc/segment_sum.cu)."""
    per_lane = 1 if f <= 32 else 2 if f <= 64 else 4 if f <= 128 else 8
    return 2 * (32 // per_lane)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _segment_sum_cuda(name: str, dtype, messages: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    dev = messages.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if messages.dim() != 2 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError(
            f"messages must be [E, F] and offsets [N + 1], got "
            f"{tuple(messages.shape)} and {tuple(offsets.shape)}")
    if offsets.device != dev:
        raise ValueError(f"offsets is on {offsets.device}, messages on {dev}")
    if messages.dtype != dtype:
        raise ValueError(f"messages must be {dtype}, got {messages.dtype}")
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
        _build.entry("segment_sum", f"segment_sum_sorted_{_SUFFIX[dtype]}",
                     3, 2),
        (messages.data_ptr(), offsets.data_ptr(), out.data_ptr()),
        {"N": n, "F": f}, dev)
    return out


def segment_sum_sorted_cuda(messages: torch.Tensor,
                            offsets: torch.Tensor) -> torch.Tensor:
    """Kernel 6 (replaces pallas_scatter.py ``_kernel``): messages [E, F]
    f32 and offsets [N + 1] i32, contiguous on one CUDA device -> [N, F]
    f32, each node's rows summed in an order fixed by the offsets (edge
    order; parts in part order for a node of more than
    ``long_range_rows(F)`` rows)."""
    out = _segment_sum_cuda("segment_sum_sorted_cuda", torch.float32,
                            messages, offsets)
    segment_sum_sorted_cuda.launches += _build.counted(1)
    return out


def segment_sum_sorted_bf16_cuda(messages: torch.Tensor,
                                 offsets: torch.Tensor) -> torch.Tensor:
    """Kernel 6's bf16 instance: bf16 messages -> [N, F] bf16 sums, each
    accumulated in f32 in the f32 instance's order, then rounded to
    nearest even (pallas_scatter.py:83-88); offsets as
    ``segment_sum_sorted_cuda``'s."""
    out = _segment_sum_cuda("segment_sum_sorted_bf16_cuda", torch.bfloat16,
                            messages, offsets)
    segment_sum_sorted_bf16_cuda.launches += _build.counted(1)
    return out


segment_sum_sorted_cuda.launches = 0
segment_sum_sorted_bf16_cuda.launches = 0
# each message dtype's instance of kernel 6, by wrapper name (looked up
# when called)
KERNEL_INSTANCES = {torch.float32: "segment_sum_sorted_cuda",
                    torch.bfloat16: "segment_sum_sorted_bf16_cuda"}


def sum_sorted(rows: torch.Tensor, offsets: torch.Tensor,
               impl: str) -> torch.Tensor:
    """Rows [E, F] summed over each run of ``offsets`` -> [N, F]: kernel 6
    (the instance of the rows' dtype) when ``impl`` takes a kernel on
    this tensor, else the plain version. Not differentiable itself: the
    ops below call it."""
    if runs_kernel(impl, rows):
        name = KERNEL_INSTANCES.get(rows.dtype)
        if name is None:
            raise ValueError(f"kernel 6 has no instance for {rows.dtype} "
                             f"messages (f32 and bf16 only)")
        return globals()[name](rows.contiguous(), offsets)
    return segment_sum_sorted_reference(rows, offsets)


class SortedGather(torch.autograd.Function):
    """``values[indices]``; its backward is ``SortedSum`` (module
    docstring)."""

    @staticmethod
    def forward(ctx, values, indices, order, offsets, impl: str):
        ctx.save_for_backward(indices, order, offsets)
        ctx.impl = impl
        return values.index_select(0, indices)

    @staticmethod
    def backward(ctx, ct):
        indices, order, offsets = ctx.saved_tensors
        return (SortedSum.apply(ct, indices, order, offsets, ctx.impl),
                None, None, None, None)


class SortedSum(torch.autograd.Function):
    """The transpose of ``SortedGather``: ``out[r] = sum of ct[e] over e
    with indices[e] == r``, the rows taken in ``order`` (None: as they
    are), each run of ``offsets`` summed in that order -> [len(offsets) -
    1, F] in ct's dtype. Its backward is ``SortedGather``."""

    @staticmethod
    def forward(ctx, ct, indices, order, offsets, impl: str):
        ctx.save_for_backward(indices, order, offsets)
        ctx.impl = impl
        rows = ct if order is None else ct.index_select(0, order)
        return sum_sorted(rows, offsets, impl)

    @staticmethod
    def backward(ctx, g):
        indices, order, offsets = ctx.saved_tensors
        return (SortedGather.apply(g, indices, order, offsets, ctx.impl),
                None, None, None, None)


def segment_sum_sorted(messages: torch.Tensor, centers: torch.Tensor,
                       num_nodes: int, impl: str = "pallas",
                       offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Sum [E, F] ``messages`` into [num_nodes, F] over non-decreasing
    ``centers`` [E] i32 (module docstring); ``offsets``: the centers'
    [num_nodes + 1] i32 ``segment_offsets`` where the caller has them.
    Differentiable any number of times, every sum in edge order."""
    if offsets is None:
        offsets = segment_offsets(centers, num_nodes)
    return SortedSum.apply(messages, centers, None, offsets, impl)


def segment_sum_cost(e: int, n: int, f: int, elem_bytes: int = 4) -> dict:
    """Compulsory bytes and f32 operations of one kernel-6 call: the [E, F]
    messages and [E] i32 centers read once, the [N, F] sums written once
    (``elem_bytes`` a message and sum element: 2 for the bf16 instance;
    the offsets the wrapper derives from the centers are not counted);
    one add a message element."""
    return {"bytes": e * f * elem_bytes + e * 4 + n * f * elem_bytes,
            "flops": e * f}
