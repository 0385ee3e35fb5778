"""Masked BatchNorm (``cgnn_tpu/ops/norm.py``).

Padding rows of a packed batch must not enter the batch statistics, so
train mode takes a validity mask over the leading axes. Semantics, as the
JAX module defines them:

- statistics over every axis but the last, in float32 (float64 for a
  float64 input);
- float32: one-pass moments E[x^2] - E[x]^2, shifted by the mean of the
  first leading row (``x[:1]``, real data: packing puts padding last), so
  a mean far above the spread does not cancel; float64: the two-pass form;
- the biased variance normalizes;
- the running update uses momentum 0.1 and the unbiased variance
  var * n / max(n - 1, 1), done in place on the buffers under no_grad;
  an all-padding batch leaves the running statistics untouched;
- eval mode normalizes with the running statistics.

``nn.BatchNorm1d`` cannot stand in: it takes no mask.
"""

from __future__ import annotations

import torch
from torch import nn


def masked_moments(x: torch.Tensor, mask: torch.Tensor | None):
    """-> (mean, biased var, n_real) over every axis but the last, in the
    statistics dtype (float64 for float64 input, else float32).
    Differentiable in ``x``; the cancellation shift is not."""
    stat_dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(stat_dtype)
    axes = tuple(range(x.dim() - 1))
    one_pass = stat_dtype == torch.float32
    if one_pass:
        shift = xf[:1].mean(dim=axes).detach()
        xs = xf - shift
    else:
        xs = xf
    if mask is not None:
        m = mask.to(stat_dtype)
        n_real = m.sum()
        xm = xs * m[..., None]
        s1 = xm.sum(dim=axes)
        s2 = (xm * xs).sum(dim=axes) if one_pass else None
    else:
        m = None
        # a fill on the device: a host scalar made into a tensor here
        # would be a host-to-device copy, which a CUDA graph cannot take
        n_real = xf.new_full((), float(xf[..., 0].numel()))
        s1 = xs.sum(dim=axes)
        s2 = (xs * xs).sum(dim=axes) if one_pass else None
    n = torch.clamp_min(n_real, 1.0)
    if one_pass:
        mean_s = s1 / n
        var = torch.clamp_min(s2 / n - mean_s * mean_s, 0.0)
        return mean_s + shift, var, n_real
    mean = s1 / n
    centered = (xf - mean) ** 2
    if m is not None:
        centered = centered * m[..., None]
    return mean, centered.sum(dim=axes) / n, n_real


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, n_real,
                         momentum: float = 0.1) -> None:
    """The momentum update of a BatchNorm's running statistics, in place:
    running = (1 - momentum) * running + momentum * batch, with the
    unbiased variance var * n / max(n - 1, 1); a batch with no real row
    changes nothing."""
    has_rows = n_real > 0
    one = torch.ones((), dtype=n_real.dtype, device=n_real.device)
    unbiased = var * n_real / torch.maximum(n_real - one, one)
    new_mean = (1.0 - momentum) * running_mean + momentum * mean
    new_var = (1.0 - momentum) * running_var + momentum * unbiased
    running_mean.copy_(torch.where(has_rows, new_mean, running_mean))
    running_var.copy_(torch.where(has_rows, new_var, running_var))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over rows [..., C] (statistics over every leading axis).

    Parameter names follow ``torch.nn.BatchNorm1d``: ``weight`` is the JAX
    ``scale``, ``running_mean``/``running_var`` the ``batch_stats``
    ``mean``/``var``.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.training:
            mean, var, n_real = masked_moments(x, mask)
            update_running_stats(self.running_mean, self.running_var,
                                 mean.detach(), var.detach(),
                                 n_real.detach(), self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        y = (x.to(stat_dtype) - mean) * torch.rsqrt(
            var.to(stat_dtype) + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)
