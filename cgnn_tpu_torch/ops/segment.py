"""Gather and segment reductions on tensors (``cgnn_tpu/ops/segment.py``),
``aggregate_edge_messages``, the COO layout's aggregation, and the two
gathers whose backward sums in a fixed order: ``gather_fixed_order`` (the
COO layout's endpoint gather) and ``gather_transpose`` (the dense
layout's neighbor gather). Each backward is an op of its own through
``.apply``, whose backward is the gather again, so both can be
differentiated any number of times (the force task differentiates
twice), every sum in the packer's order, with no host sync."""

from __future__ import annotations

import torch

from cgnn_tpu_torch.ops.scatter import (
    SortedGather,
    segment_sum_sorted,
)

AGGREGATION_IMPLS = ("xla", "sort", "pallas")


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """values[indices] — the edge-endpoint gather ([N, F] + [E] -> [E, F])."""
    return values.index_select(0, indices)


def gather_fixed_order(values: torch.Tensor, indices: torch.Tensor,
                       order: torch.Tensor | None, offsets: torch.Tensor,
                       impl: str = "xla") -> torch.Tensor:
    """``values[indices]`` whose backward sums each row's cotangents in a
    fixed order, so a training run repeats its bits (``index_select``'s
    own backward is ``index_add_``, whose CUDA atomics add in an order
    that changes from run to run): the cotangent rows taken in stable
    sorted order of the indices (``order``; None when the indices are
    sorted already), then summed over each row's run (``offsets``), by
    kernel 6 for ``impl='pallas'`` on a card (ops/scatter.py; its bf16
    instance for a bf16 cotangent), by its plain version otherwise. The
    packer makes both once a batch (data/graph.py ``csr_transpose``).
    That sum's own backward is this gather (ops/scatter.py
    ``SortedGather``/``SortedSum``): differentiable any number of
    times."""
    return SortedGather.apply(values, indices, order, offsets, impl)


def transpose_cotangent(ct, in_slots, in_mask, over_slots, over_nodes,
                        over_mask, num_nodes: int) -> torch.Tensor:
    """The backward of the neighbor gather through the packed transpose
    mapping ([E, F] -> [N, F]): a gather of ``ct`` by ``in_slots``, a
    masked sum over the in-degree axis, then the overflow rows summed
    into their (sorted) ``over_nodes``. Every sum runs in a fixed order:
    the overflow tier goes through ``torch.segment_reduce`` in ct's
    dtype, not ``index_add_``, whose CUDA atomics add in an order that
    changes from run to run. Nothing here waits for the device: the
    segment offsets come from ``searchsorted`` on the sorted
    ``over_nodes`` (``bincount`` would read its maximum back to the host),
    and the reduce skips its validation, which reads the lengths back
    (pack_graphs builds ``over_nodes`` sorted and in [0, N)). First order
    as written: ``gather_transpose`` wraps it in an op whose backward is
    the gather."""
    contrib = ct.index_select(0, in_slots).reshape(*in_mask.shape,
                                                   ct.shape[-1])
    grad = (contrib * in_mask[..., None].to(ct.dtype)).sum(dim=1)
    if over_slots is not None:
        rows = ct.index_select(0, over_slots) * over_mask[:, None].to(
            ct.dtype)
        offsets = torch.searchsorted(
            over_nodes, torch.arange(num_nodes + 1, dtype=over_nodes.dtype,
                                     device=over_nodes.device))
        grad = grad + torch.segment_reduce(rows, "sum", offsets=offsets,
                                           axis=0, unsafe=True)
    return grad


class _GatherTranspose(torch.autograd.Function):
    """``nodes[neighbors]``; its backward is ``_TransposeCotangent``."""

    @staticmethod
    def forward(ctx, nodes, neighbors, in_slots, in_mask, over_slots,
                over_nodes, over_mask):
        ctx.save_for_backward(neighbors, in_slots, in_mask, over_slots,
                              over_nodes, over_mask)
        ctx.num_nodes = nodes.shape[0]
        return nodes.index_select(0, neighbors)

    @staticmethod
    def backward(ctx, ct):
        return (_TransposeCotangent.apply(ct, *ctx.saved_tensors,
                                          ctx.num_nodes),
                None, None, None, None, None, None)


class _TransposeCotangent(torch.autograd.Function):
    """``transpose_cotangent`` as an op; its backward is the neighbor
    gather (``_GatherTranspose``): the JAX ``linear_call`` pair, whose
    transpose of the transpose is the forward gather."""

    @staticmethod
    def forward(ctx, ct, neighbors, in_slots, in_mask, over_slots,
                over_nodes, over_mask, num_nodes: int):
        ctx.save_for_backward(neighbors, in_slots, in_mask, over_slots,
                              over_nodes, over_mask)
        return transpose_cotangent(ct.contiguous(), in_slots, in_mask,
                                   over_slots, over_nodes, over_mask,
                                   num_nodes)

    @staticmethod
    def backward(ctx, g):
        return (_GatherTranspose.apply(g, *ctx.saved_tensors),
                None, None, None, None, None, None, None)


def gather_transpose(nodes, neighbors, in_slots=None, in_mask=None,
                     over_slots=None, over_nodes=None, over_mask=None):
    """``nodes[neighbors]`` whose backward is the scatter-free transpose
    (``transpose_cotangent``) when the batch carries the mapping
    (data/graph.py ``transpose_slots``), else the plain gather's scatter.

    Equal to the plain gather's gradient only when the cotangent is zero
    on the padding edge slots the mapping leaves out; CGConv guarantees
    that (the edge mask on the messages, masked BatchNorm statistics).
    With the mapping it can be differentiated any number of times: the
    backward's own backward is this gather (the JAX ``linear_call``).
    """
    if in_slots is None:
        return gather(nodes, neighbors)
    return _GatherTranspose.apply(nodes, neighbors, in_slots, in_mask,
                                  over_slots, over_nodes, over_mask)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def aggregate_edge_messages(messages: torch.Tensor, centers: torch.Tensor,
                            num_nodes: int, impl: str | None = None,
                            offsets: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Sum per-edge [E, F] messages into [num_nodes, F] node rows by their
    ``centers``. ``impl`` (None = ``'xla'``, the JAX default):

    - ``'xla'``: ``segment_sum``, the library scatter-add (the JAX
      package's ``jax.ops.segment_sum``; no kernel behind it);
    - ``'sort'``: a stable argsort of the centers, then ``segment_sum``
      over the sorted rows (the JAX ``_aggregate_sort``);
    - ``'pallas'``: the sorted segment sum (ops/scatter.py): kernel 6 on a
      CUDA tensor, its plain version on a CPU tensor. Needs the packer's
      non-decreasing centers; ``offsets``, their segment offsets, where
      the batch carries them (``center_offsets``).
    """
    impl = impl or "xla"
    if impl == "xla":
        return segment_sum(messages, centers, num_nodes)
    if impl == "sort":
        order = torch.argsort(centers, stable=True)
        return segment_sum(messages.index_select(0, order),
                           centers.index_select(0, order), num_nodes)
    if impl == "pallas":
        return segment_sum_sorted(messages, centers, num_nodes,
                                  offsets=offsets)
    raise ValueError(f"unknown aggregation impl {impl!r} "
                     f"(one of {AGGREGATION_IMPLS})")


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Masked segment mean: sum(w*x)/sum(w); empty segments return 0.
    ``weights`` (e.g. a node mask) keeps padding rows out of both the
    numerator and the denominator.

    The rows of nonzero weight must have non-decreasing ``segment_ids``,
    as every packer lays nodes out (``pack_graphs``: real nodes by graph,
    padding after; the raw expander: one block a structure). Each
    segment is then summed in row order by ``torch.segment_reduce``, the
    same bits run to run on the card, where ``index_add_`` would add
    with atomics in no fixed order; a zero-weight row joins the segment
    of the last weighted row before it (``cummax``), adding zeros. The
    offsets come from ``searchsorted``, so nothing waits for the
    device."""
    data = data * weights[..., None]
    ids = torch.where(weights > 0, segment_ids,
                      torch.zeros_like(segment_ids))
    key = torch.cummax(ids, dim=0).values
    offsets = torch.searchsorted(
        key, torch.arange(num_segments + 1, dtype=key.dtype,
                          device=key.device))
    denom = torch.segment_reduce(weights, "sum", offsets=offsets, axis=0,
                                 unsafe=True)
    total = torch.segment_reduce(data, "sum", offsets=offsets, axis=0,
                                 unsafe=True)
    return total / torch.clamp_min(denom, 1.0)[..., None]
