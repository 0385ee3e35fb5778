"""Masked BatchNorm (``cgnn_tpu/ops/norm.py``), eval mode.

Eval normalizes with the running statistics, so no validity mask enters:
``y = (x - running_mean) * rsqrt(running_var + eps) * weight + bias``,
in float32. Train mode (masked one-pass moments and the running update)
comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over rows [..., C] (statistics over every leading axis).

    Parameter names follow ``torch.nn.BatchNorm1d``: ``weight`` is the JAX
    ``scale``, ``running_mean``/``running_var`` the ``batch_stats``
    ``mean``/``var``.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm train mode comes with the training slice")
        y = (x.float() - self.running_mean) * torch.rsqrt(
            self.running_var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)
