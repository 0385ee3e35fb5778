"""Train, eval and predict steps (``cgnn_tpu/train/step.py``).

Metrics are returned as sums (``loss_sum``, ``mae_sum``, ``count``), never
means, so accumulation over batches is exact; they stay tensors on the
device. The train step runs the model in ``.train()``, so the BatchNorm
running statistics update inside the forward (flax's
``mutable=["batch_stats"]``), then takes ``loss.backward()`` and one
optimizer update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from cgnn_tpu_torch.data.compact import CompactBatch
from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.data.rawbatch import RawBatch
from cgnn_tpu_torch.train.normalizer import Normalizer


@dataclasses.dataclass
class InferenceState:
    """What a predict step reads: the eval model and its normalizer, on
    one device (the JAX TrainState's apply_fn/variables/normalizer)."""

    model: torch.nn.Module
    normalizer: Normalizer


def regression_loss(out, batch: GraphBatch, normalizer: Normalizer):
    """Masked MSE on normalized targets; metrics in original units, with
    one MAE per task column when T > 1."""
    t_norm = normalizer.norm(batch.targets)
    w = batch.target_mask * batch.graph_mask[:, None]
    se = (out - t_norm) ** 2 * w
    n = torch.clamp_min(w.sum(), 1.0)
    loss = se.sum() / n
    ae = torch.abs(normalizer.denorm(out) - batch.targets) * w
    metrics = {"loss_sum": se.sum(), "mae_sum": ae.sum(), "count": w.sum()}
    if out.shape[-1] > 1:
        for t in range(out.shape[-1]):
            metrics[f"mae_task{t}_sum"] = ae[:, t].sum()
            metrics[f"mae_task{t}_count"] = w[:, t].sum()
    return loss, metrics


def make_train_step() -> Callable:
    """(state, batch) -> metric sums; updates ``state`` in place."""

    def train_step(state, batch: GraphBatch) -> dict:
        state.model.train()
        out = state.model(batch)
        loss, metrics = regression_loss(out, batch, state.normalizer)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step() -> Callable:
    """(state, batch) -> metric sums, with the running BatchNorm stats."""

    @torch.no_grad()
    def eval_step(state, batch: GraphBatch) -> dict:
        state.model.eval()
        out = state.model(batch)
        _, metrics = regression_loss(out, batch, state.normalizer)
        return metrics

    return eval_step


def make_predict_step(raw_expander: Callable | None = None,
                      expander: Callable | None = None) -> Callable:
    """(state, batch) -> denormalized predictions [G, T]; padding graph
    slots are zeroed.

    ``expander`` (``data.compact.make_expander``) adds compact staging: a
    ``CompactBatch`` is rebuilt into its GraphBatch on the device first.
    ``raw_expander`` (``ops.neighbor_search.make_raw_expander``) adds the
    raw wire: a ``RawBatch`` is turned into a GraphBatch by the device
    neighbor search and featurization, and the step returns ``(predictions
    [G, T], cap_overflow [G] bool, n_edges [G] i32)``, all on the device
    (no host sync inside). A flagged structure's row must never be served.
    """

    @torch.inference_mode()
    def predict_step(state: InferenceState, batch):
        if raw_expander is not None and isinstance(batch, RawBatch):
            gb, overflow, n_edges = raw_expander(batch)
            out = state.model(gb)
            preds = state.normalizer.denorm(out) * gb.graph_mask[:, None]
            return preds, overflow, n_edges
        if expander is not None and isinstance(batch, CompactBatch):
            batch = expander(batch)
        out = state.model(batch)
        return state.normalizer.denorm(out) * batch.graph_mask[:, None]

    return predict_step
