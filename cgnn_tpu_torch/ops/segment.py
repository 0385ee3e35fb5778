"""Gather and segment reductions on tensors (``cgnn_tpu/ops/segment.py``),
and ``aggregate_edge_messages``, the COO layout's aggregation."""

from __future__ import annotations

import torch

from cgnn_tpu_torch.ops.scatter import segment_sum_sorted

AGGREGATION_IMPLS = ("xla", "sort", "pallas")


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """values[indices] — the edge-endpoint gather ([N, F] + [E] -> [E, F])."""
    return values.index_select(0, indices)


def transpose_cotangent(ct, in_slots, in_mask, over_slots, over_nodes,
                        over_mask, num_nodes: int) -> torch.Tensor:
    """The backward of the neighbor gather through the packed transpose
    mapping ([E, F] -> [N, F]): a gather of ``ct`` by ``in_slots``, a
    masked sum over the in-degree axis, then the overflow rows summed
    into their (sorted) ``over_nodes``. Every sum runs in a fixed order:
    the overflow tier goes through ``torch.segment_reduce``, not
    ``index_add_``, whose CUDA atomics add in an order that changes from
    run to run. Nothing here waits for the device: the segment offsets
    come from ``searchsorted`` on the sorted ``over_nodes`` (``bincount``
    would read its maximum back to the host), and the reduce skips its
    validation, which reads the lengths back (pack_graphs builds
    ``over_nodes`` sorted and in [0, N))."""
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
    @staticmethod
    def forward(ctx, nodes, neighbors, in_slots, in_mask, over_slots,
                over_nodes, over_mask):
        ctx.save_for_backward(in_slots, in_mask, over_slots, over_nodes,
                              over_mask)
        ctx.num_nodes = nodes.shape[0]
        return nodes.index_select(0, neighbors)

    @staticmethod
    def backward(ctx, ct):
        grad = transpose_cotangent(ct.contiguous(), *ctx.saved_tensors,
                                   ctx.num_nodes)
        return grad, None, None, None, None, None, None


def gather_transpose(nodes, neighbors, in_slots=None, in_mask=None,
                     over_slots=None, over_nodes=None, over_mask=None):
    """``nodes[neighbors]`` whose backward is the scatter-free transpose
    (``transpose_cotangent``) when the batch carries the mapping
    (data/graph.py ``transpose_slots``), else the plain gather's scatter.

    Equal to the plain gather's gradient only when the cotangent is zero
    on the padding edge slots the mapping leaves out; CGConv guarantees
    that (the edge mask on the messages, masked BatchNorm statistics).
    First order only.
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
                            num_nodes: int,
                            impl: str | None = None) -> torch.Tensor:
    """Sum per-edge [E, F] messages into [num_nodes, F] node rows by their
    ``centers``. ``impl`` (None = ``'xla'``, the JAX default):

    - ``'xla'``: ``segment_sum``, the library scatter-add (the JAX
      package's ``jax.ops.segment_sum``; no kernel behind it);
    - ``'sort'``: a stable argsort of the centers, then ``segment_sum``
      over the sorted rows (the JAX ``_aggregate_sort``);
    - ``'pallas'``: the sorted segment sum (ops/scatter.py): kernel 6 on a
      CUDA tensor, its plain version on a CPU tensor. Needs the packer's
      non-decreasing centers.
    """
    impl = impl or "xla"
    if impl == "xla":
        return segment_sum(messages, centers, num_nodes)
    if impl == "sort":
        order = torch.argsort(centers, stable=True)
        return segment_sum(messages.index_select(0, order),
                           centers.index_select(0, order), num_nodes)
    if impl == "pallas":
        return segment_sum_sorted(messages, centers, num_nodes)
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
    numerator and the denominator."""
    data = data * weights[..., None]
    denom = segment_sum(weights, segment_ids, num_segments)
    total = segment_sum(data, segment_ids, num_segments)
    return total / torch.clamp_min(denom, 1.0)[..., None]
