"""Target normalization (``cgnn_tpu/train/normalizer.py``): per-task
mean/std of shape [T], stored beside the parameters and applied to
denormalize predictions."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Normalizer:
    mean: torch.Tensor  # [T] f32
    std: torch.Tensor  # [T] f32

    @classmethod
    def from_arrays(cls, mean, std, device="cpu") -> "Normalizer":
        return cls(
            mean=torch.as_tensor(np.asarray(mean, np.float32), device=device),
            std=torch.as_tensor(np.asarray(std, np.float32), device=device),
        )

    def to(self, device) -> "Normalizer":
        return Normalizer(self.mean.to(device), self.std.to(device))

    def denorm(self, x):
        return x * self.std + self.mean
