"""Gather and segment reductions on tensors (``cgnn_tpu/ops/segment.py``)."""

from __future__ import annotations

import torch


def gather(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """values[indices] — the edge-endpoint gather ([N, F] + [E] -> [E, F])."""
    return values.index_select(0, indices)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


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
