"""Optimizer and train state (``cgnn_tpu/train/state.py``).

The update is plain ``torch.optim`` with optax's semantics, as the JAX
package's ``make_optimizer`` chains them:

- SGD with momentum is optax ``trace``: buf = g + momentum * buf,
  p -= lr * buf (torch's SGD with dampening 0); its weight decay is
  coupled into the gradient (torch's SGD ``weight_decay``);
- Adam is optax ``adam`` (b1 0.9, b2 0.999, eps 1e-8; no weight decay);
  AdamW is optax ``adamw``, decoupled: p -= lr * (adam + wd * p);
- ``grad_clip > 0`` clips by the global norm, optax's way, before the
  coupled weight decay;
- the learning-rate milestones count OPTIMIZER STEPS: the update with
  0-based index s uses lr * gamma ** #{milestones m <= s}, as optax's
  ``piecewise_constant_schedule`` does. Callers that think in epochs
  multiply by the batches per epoch (``count_batches``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import torch

from cgnn_tpu_torch.train.normalizer import Normalizer


@dataclasses.dataclass(frozen=True)
class MultiStepSchedule:
    """torch MultiStepLR in optimizer steps (module docstring)."""

    base_lr: float
    milestones: tuple[int, ...] = ()
    gamma: float = 0.1

    def __call__(self, count: int) -> float:
        hits = sum(1 for m in self.milestones if m <= count)
        return self.base_lr * self.gamma ** hits


def clip_by_global_norm(params: Sequence[torch.Tensor],
                        max_norm: float) -> None:
    """optax ``clip_by_global_norm``, in place on the ``.grad``s: when the
    global norm reaches ``max_norm``, scale every gradient by
    max_norm / norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))


class Optimizer:
    """One optimizer update per ``step()`` (module docstring); ``count``
    is the number of updates applied."""

    def __init__(self, params: Iterable[torch.Tensor], optim: str = "sgd",
                 lr: float = 0.01, momentum: float = 0.9,
                 weight_decay: float = 0.0,
                 lr_milestones: Sequence[int] = (), lr_gamma: float = 0.1,
                 grad_clip: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = MultiStepSchedule(
            lr, tuple(int(m) for m in lr_milestones), lr_gamma)
        self.grad_clip = grad_clip
        self.count = 0
        kind = optim.lower()
        if kind == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=lr,
                                         momentum=momentum,
                                         weight_decay=weight_decay)
        elif kind == "adam":
            self.inner = torch.optim.Adam(self.params, lr=lr)
        elif kind == "adamw":
            self.inner = torch.optim.AdamW(self.params, lr=lr,
                                           weight_decay=weight_decay)
        else:
            raise ValueError(f"unknown optimizer {optim!r} (sgd|adam|adamw)")

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip > 0:
            clip_by_global_norm(self.params, self.grad_clip)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1


def make_optimizer(params, optim: str = "sgd", lr: float = 0.01,
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   lr_milestones: Sequence[int] = (), lr_gamma: float = 0.1,
                   grad_clip: float = 0.0) -> Optimizer:
    """SGD+momentum, Adam or AdamW with a MultiStepLR schedule in
    optimizer steps (the JAX ``make_optimizer``'s defaults)."""
    return Optimizer(params, optim, lr, momentum, weight_decay,
                     lr_milestones, lr_gamma, grad_clip)


@dataclasses.dataclass
class TrainState:
    """What the train step mutates: the model (parameters and BatchNorm
    running statistics), the optimizer (its state and schedule), and the
    target normalizer it reads. ``step`` counts applied updates."""

    model: torch.nn.Module
    optimizer: Optimizer
    normalizer: Normalizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def init_train_state(model_cfg, data_cfg, train_graphs, *, batch_size: int,
                     device, seed: int = 0, optim: str = "sgd",
                     lr: float = 0.01, momentum: float = 0.9,
                     weight_decay: float = 0.0,
                     lr_milestones_epochs: Sequence[int] = (100,)):
    """A fresh TrainState as ``python -m cgnn_tpu_torch.train`` starts one
    -> (state, node_cap): the model on ``device`` with the numpy-seeded
    init (convert.init_params), the normalizer fitted on the training
    targets, and the optimizer with its epoch milestones counted in
    optimizer steps (x the snug batches per epoch, as train.py does)."""
    import numpy as np

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import build_model
    from cgnn_tpu_torch.data.graph import capacities_for, count_batches

    model = build_model(model_cfg, data_cfg, device=device)
    model.load_state_dict(convert.from_flax_variables(
        convert.init_params(model_cfg, data_cfg, seed=seed)))
    normalizer = Normalizer.fit(
        np.stack([g.target for g in train_graphs]),
        np.stack([np.ones_like(g.target) if g.target_mask is None
                  else g.target_mask for g in train_graphs]),
        device=device)
    dense_m = model_cfg.dense_m
    node_cap, edge_cap = capacities_for(train_graphs, batch_size,
                                        dense_m=dense_m)
    per_epoch = max(1, count_batches(train_graphs, batch_size, node_cap,
                                     edge_cap, snug=True))
    optimizer = make_optimizer(
        model.parameters(), optim=optim, lr=lr, momentum=momentum,
        weight_decay=weight_decay,
        lr_milestones=[m * per_epoch for m in lr_milestones_epochs])
    return TrainState(model, optimizer, normalizer), node_cap
