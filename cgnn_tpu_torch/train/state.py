"""Optimizer and train state (``cgnn_tpu/train/state.py``).

The update has optax's semantics, as the JAX package's
``make_optimizer`` chains them:

- SGD with momentum is optax ``trace``: buf = g + momentum * buf,
  p -= lr * buf; its weight decay is coupled into the gradient;
- Adam is optax ``adam`` (b1 0.9, b2 0.999, eps 1e-8; no weight decay);
  AdamW is optax ``adamw``, decoupled: p -= lr * (adam + wd * p);
- ``grad_clip > 0`` clips by the global norm, optax's way, before the
  coupled weight decay;
- the learning-rate milestones count OPTIMIZER STEPS: the update with
  0-based index s uses lr * gamma ** #{milestones m <= s}, as optax's
  ``piecewise_constant_schedule`` does. Callers that think in epochs
  multiply by the batches per epoch (``count_batches``).

The update can be captured in a CUDA graph (train/graphs.py): every
buffer exists from construction (SGD's momentum, Adam's moments, zeros),
the step count and the learning rate live on the device (the rate is a
row of a table of the schedule's values, picked by the milestones the
device count has passed, so a milestone falls inside a replay), and
nothing reads the device back. ``count`` is the host's mirror of the
device count: a step raises it, except inside a capture, where the
caller raises it once a replay (``advance``). The update is written in
plain tensor ops (``torch.optim`` reads its rate and step on the host):
SGD's equals ``torch.optim.SGD``'s bit for bit (its rate enters through
one fused multiply-add, as torch's ``alpha`` does), Adam's and AdamW's
``torch.optim.Adam``'s and ``AdamW``'s to f32 round-off.
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

    def table(self) -> list[float]:
        """The rate after k milestones, k = 0 .. len(milestones)."""
        return [self.base_lr * self.gamma ** k
                for k in range(len(self.milestones) + 1)]


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


_SLOTS = {"sgd": ("momentum_buffer",), "adam": ("exp_avg", "exp_avg_sq"),
          "adamw": ("exp_avg", "exp_avg_sq")}
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class OptimizerSlots:
    """The optimizer's per-parameter buffers, torch.optim's names and
    ``state``/``state_dict``/``load_state_dict`` layout, so checkpoints
    keep their format. ``load_state_dict`` copies into the buffers in
    place: a captured graph holds their addresses, and a restore that
    rebound them would leave it updating stale copies."""

    def __init__(self, params: list, kind: str, hyper: dict):
        self.params = params
        self.hyper = hyper
        self.state = {p: {k: torch.zeros_like(p, memory_format=
                                              torch.preserve_format)
                          for k in _SLOTS[kind]}
                      for p in params}

    def state_dict(self) -> dict:
        return {"state": {i: dict(self.state[p])
                          for i, p in enumerate(self.params)},
                "param_groups": [dict(self.hyper, params=list(
                    range(len(self.params))))]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        for i, slots in sd["state"].items():
            own = self.state[self.params[int(i)]]
            for k, v in slots.items():
                if k in own:  # a torch.optim checkpoint's "step" is count
                    own[k].copy_(torch.as_tensor(v))


class Optimizer:
    """One optimizer update per ``step()`` (module docstring); ``count``
    is the number of updates applied (host mirror of the device count)."""

    def __init__(self, params: Iterable[torch.Tensor], optim: str = "sgd",
                 lr: float = 0.01, momentum: float = 0.9,
                 weight_decay: float = 0.0,
                 lr_milestones: Sequence[int] = (), lr_gamma: float = 0.1,
                 grad_clip: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.kind = optim.lower()
        if self.kind not in _SLOTS:
            raise ValueError(f"unknown optimizer {optim!r} (sgd|adam|adamw)")
        self.schedule = MultiStepSchedule(
            lr, tuple(int(m) for m in lr_milestones), lr_gamma)
        self.grad_clip = grad_clip
        self.momentum = momentum
        self.weight_decay = weight_decay
        dev, dtype = self.params[0].device, self.params[0].dtype
        self._count_t = torch.zeros((), dtype=torch.int64, device=dev)
        self._milestones = torch.tensor(self.schedule.milestones or (2**62,),
                                        dtype=torch.int64, device=dev)
        self._lr_table = torch.tensor(self.schedule.table(), dtype=dtype,
                                      device=dev)
        self._count = 0
        self.lr_scale = 1.0
        self.inner = OptimizerSlots(self.params, self.kind, dict(
            lr=lr, momentum=momentum, weight_decay=weight_decay))

    @property
    def count(self) -> int:
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        """Set both counts (a restore): the device one in place."""
        self._count = int(value)
        self._count_t.fill_(int(value))

    def advance(self, steps: int = 1) -> None:
        """Raise the host mirror by ``steps`` updates that a graph replay
        applied on the device."""
        self._count += steps

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor an update writes besides the parameters: the
        buffers and the device count (train/graphs.py snapshots them)."""
        return [self._count_t] + [t for p in self.params
                                  for t in self.inner.state[p].values()]

    @torch.no_grad()
    def scale_lr(self, factor: float) -> None:
        """Multiply every rate of the schedule by ``factor`` (the
        divergence guard's cut, resilience/guard.py): the device table is
        rewritten in place, from the schedule's rates times the running
        ``lr_scale``, so a captured graph keeps reading it and a run cut
        twice by f holds the same table as one resumed at f * f."""
        self.lr_scale *= float(factor)
        self._lr_table.copy_(torch.tensor(
            [v * self.lr_scale for v in self.schedule.table()],
            dtype=self._lr_table.dtype))

    def lr(self) -> torch.Tensor:
        """The device rate of the next update: the schedule's table row
        for the milestones the device count has passed."""
        hits = (self._milestones <= self._count_t).sum()
        return self._lr_table.index_select(0, hits.view(1)).squeeze(0)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        if self.grad_clip > 0:
            clip_by_global_norm(self.params, self.grad_clip)
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        lr = self.lr()
        slots = [self.inner.state[p] for p in params]
        if self.kind == "sgd":
            if self.weight_decay:
                grads = torch._foreach_add(grads, params,
                                           alpha=self.weight_decay)
            bufs = [s["momentum_buffer"] for s in slots]
            torch._foreach_mul_(bufs, self.momentum)
            torch._foreach_add_(bufs, grads)
            # p + buf * (-lr) in one fused multiply-add: torch's
            # add_(buf, alpha=-lr) to the bit
            neg = -lr
            for p, b in zip(params, bufs):
                p.addcmul_(b, neg)
        else:
            self._adam(params, grads, slots, lr)
        self._count_t.add_(1)
        if not _capturing(self._count_t):
            self._count += 1

    def _adam(self, params, grads, slots, lr) -> None:
        """torch.optim.Adam's (AdamW's) single-tensor update with the
        rate and the step on the device; the bias corrections in f64."""
        wd = self.weight_decay
        if self.kind == "adamw" and wd:
            torch._foreach_mul_(params, 1.0 - lr * wd)
        m = [s["exp_avg"] for s in slots]
        v = [s["exp_avg_sq"] for s in slots]
        torch._foreach_lerp_(m, grads, 1.0 - _B1)
        torch._foreach_mul_(v, _B2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - _B2)
        step = (self._count_t + 1).double()
        bc1 = 1.0 - torch.pow(_B1, step)
        bc2_sqrt = torch.sqrt(1.0 - torch.pow(_B2, step))
        step_size = (lr.double() / bc1).to(lr.dtype)
        for p, mi, vi in zip(params, m, v):
            denom = (vi.sqrt() / bc2_sqrt.to(vi.dtype)).add_(_EPS)
            p.sub_(mi / denom * step_size)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


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
                     lr_milestones_epochs: Sequence[int] = (100,),
                     task: str = "regression"):
    """A fresh TrainState as ``python -m cgnn_tpu_torch.train`` starts one
    -> (state, node_cap, edge_cap): the model on ``device`` with the
    numpy-seeded init (convert.init_params) and its dropout generator
    seeded from ``seed``, the normalizer fitted on the training targets
    (a classifier's is the identity, as train.py's), the optimizer with its epoch milestones counted in
    optimizer steps (x the snug batches per epoch, as train.py does), and
    the snug batch capacities of the model's layout (``dense_m=0``: COO,
    whose edge capacity is its own). ``task='force'`` builds the force
    field (config.build_force_model) with its own tree."""
    import numpy as np

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import build_model
    from cgnn_tpu_torch.data.graph import capacities_for, count_batches

    model = build_model(model_cfg, data_cfg, device=device, task=task,
                        dropout_seed=seed)
    model.load_state_dict(convert.from_flax_variables(
        convert.init_params(model_cfg, data_cfg, seed=seed, task=task)))
    if model_cfg.classification:
        normalizer = Normalizer.identity(model_cfg.num_targets,
                                         device=device)
    else:
        normalizer = Normalizer.fit(
            np.stack([g.target for g in train_graphs]),
            np.stack([np.ones_like(g.target) if g.target_mask is None
                      else g.target_mask for g in train_graphs]),
            device=device)
    node_cap, edge_cap = capacities_for(train_graphs, batch_size,
                                        dense_m=model_cfg.dense_m or None)
    per_epoch = max(1, count_batches(train_graphs, batch_size, node_cap,
                                     edge_cap, snug=True))
    optimizer = make_optimizer(
        model.parameters(), optim=optim, lr=lr, momentum=momentum,
        weight_decay=weight_decay,
        lr_milestones=[m * per_epoch for m in lr_milestones_epochs])
    return TrainState(model, optimizer, normalizer), node_cap, edge_cap
