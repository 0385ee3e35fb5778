"""Target normalization (``cgnn_tpu/train/normalizer.py``): per-task
mean/std of shape [T], fitted on the training targets, applied to the
targets in the loss and to the predictions to denormalize them. Every
constructor takes the device its tensors go to; there is no default."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Normalizer:
    mean: torch.Tensor  # [T] f32
    std: torch.Tensor  # [T] f32

    @classmethod
    def from_arrays(cls, mean, std, device) -> "Normalizer":
        return cls(
            mean=torch.as_tensor(np.asarray(mean, np.float32), device=device),
            std=torch.as_tensor(np.asarray(std, np.float32), device=device),
        )

    @classmethod
    def fit(cls, targets, mask=None, *, device) -> "Normalizer":
        """Per-task masked mean/std over a training sample ([S, T]
        arrays), in f64 on the host; the std is floored at 1e-6
        (sqrt of the 1e-12 variance floor)."""
        t = np.atleast_2d(np.asarray(targets, np.float64))
        m = (np.ones_like(t) if mask is None
             else np.atleast_2d(np.asarray(mask, np.float64)))
        n = np.maximum(m.sum(axis=0), 1.0)
        mean = (t * m).sum(axis=0) / n
        var = (((t - mean) ** 2) * m).sum(axis=0) / n
        return cls.from_arrays(mean, np.sqrt(np.maximum(var, 1e-12)),
                               device)

    @classmethod
    def identity(cls, num_targets: int = 1, *, device) -> "Normalizer":
        """No-op normalizer (pre-normalized targets)."""
        return cls.from_arrays(np.zeros(num_targets), np.ones(num_targets),
                               device)

    def to(self, device) -> "Normalizer":
        return Normalizer(self.mean.to(device), self.std.to(device))

    def norm(self, x):
        return (x - self.mean) / self.std

    def denorm(self, x):
        return x * self.std + self.mean
