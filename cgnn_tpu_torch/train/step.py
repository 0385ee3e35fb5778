"""Train, eval and predict steps (``cgnn_tpu/train/step.py``).

Metrics are returned as sums (``loss_sum``, ``mae_sum``, ``count``; a
classifier's ``correct_sum`` in place of ``mae_sum``), never means, so
accumulation over batches is exact; they stay tensors on the
device. The train step runs the model in ``.train()``, so the BatchNorm
running statistics update inside the forward (flax's
``mutable=["batch_stats"]``), then takes ``loss.backward()`` and one
optimizer update.

The train and eval steps can be captured whole as CUDA graphs
(train/graphs.py): the gradients are set to None and made anew inside
the step, the optimizer's rate and count live on the device, and no op
reads the device back. The loops add a step's metric sums into static
accumulators (``metrics.DeviceSums``) inside the graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from cgnn_tpu_torch.data.compact import CompactBatch
from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.data.rawbatch import RawBatch
from cgnn_tpu_torch.observe.health import step_with_health
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


def classification_loss(out, batch: GraphBatch, normalizer=None):
    """NLL of the label column's log-prob (the reference's NLLLoss after
    LogSoftmax) over the real graph slots, and the count of correct
    argmax predictions. Labels must lie in [0, num_classes): a gather on
    the card asserts on one outside (the entry point checks them on the
    host first)."""
    del normalizer  # a classifier's is the identity
    labels = batch.targets[:, 0].long()
    w = batch.graph_mask
    nll = -out.gather(1, labels[:, None])[:, 0] * w
    n = torch.clamp_min(w.sum(), 1.0)
    loss = nll.sum() / n
    correct = (out.argmax(dim=-1) == labels).to(w.dtype) * w
    return loss, {"loss_sum": nll.sum(), "correct_sum": correct.sum(),
                  "count": w.sum()}


def model_task(model) -> tuple[bool, torch.dtype]:
    """(classification, edge storage dtype) of a model: what the steps,
    the packers and the expanders follow."""
    return (bool(getattr(model, "classification", False)),
            getattr(model, "dtype", torch.float32))


def is_force(model) -> bool:
    """Whether ``model`` is the force field (models/forcefield.py), whose
    steps are train/force_step.py's."""
    return getattr(model, "task", "") == "force"


def loss_for(classification: bool) -> Callable:
    return classification_loss if classification else regression_loss


def complete_sharded_grads(model) -> None:
    """Sum the gradients of ``model.sharded_parameters()`` over its graph
    group, in one collective: each rank's are partial (its own edges'),
    and the sum is the whole gradient, the same bits on every rank. The
    node-side parameters' gradients are whole already and stay as they
    are (summing them would count them G times). A no-op for a model
    that is not graph-sharded."""
    group = getattr(model, "graph_group", None)
    if group is None or group.size == 1:
        return
    grads = [p.grad for p in model.sharded_parameters()
             if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    group.all_reduce_(flat)
    with torch.no_grad():
        torch._foreach_copy_(grads, [v.view(g.shape) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


def make_grad_step(expander: Callable | None = None,
                   classification: bool = False) -> Callable:
    """(state, batch) -> metric sums: the train step up to its optimizer
    update. The forward runs in ``.train()`` (the BatchNorm running
    statistics update), and the gradient of the batch's mean loss is left
    in each parameter's ``.grad``. The data-parallel step
    (parallel/data_parallel.py) reduces across ranks between this part
    and the update, as the JAX step ``pmean``s its grads and statistics
    before ``apply_gradients``. A graph-sharded model's step (the model
    built with a ``graph_group``) is the sharded grad step: after the
    backward, every rank of the group holds the whole gradients, the
    same on each (``complete_sharded_grads``), its loss and metric sums
    are the group's, equal on every rank, and the collectives inside the
    forward and backward keep it eager (no captured graph: gloo's cannot
    be captured). ``expander``, ``classification``: as
    ``make_train_step``."""
    compute_loss = loss_for(classification)

    def grad_step(state, batch: GraphBatch) -> dict:
        if expander is not None and isinstance(batch, CompactBatch):
            batch = expander(batch)
        state.model.train()
        out = state.model(batch)
        loss, metrics = compute_loss(out, batch, state.normalizer)
        state.optimizer.zero_grad()
        loss.backward()
        complete_sharded_grads(state.model)
        return {k: v.detach() for k, v in metrics.items()}

    return grad_step


def make_train_step(expander: Callable | None = None,
                    classification: bool = False,
                    grad_health: bool = False) -> Callable:
    """(state, batch) -> metric sums; updates ``state`` in place: the
    grad part (``make_grad_step``), then one optimizer update.
    ``expander`` (``data.compact.make_expander``) rebuilds a
    ``CompactBatch`` on the device first; ``classification`` takes
    ``classification_loss``, else ``regression_loss``. ``grad_health``
    adds the in-graph grad-norm, update-norm and NaN/Inf-count metrics
    (observe/health.py): extra metric outputs only, the update untouched,
    so the trajectory is the same with it on or off."""
    grad_step = make_grad_step(expander, classification)

    def train_step(state, batch: GraphBatch) -> dict:
        metrics = grad_step(state, batch)
        if grad_health:
            return step_with_health(state, metrics, state.optimizer.step)
        state.optimizer.step()
        return metrics

    return train_step


def make_eval_step(expander: Callable | None = None,
                   classification: bool = False) -> Callable:
    """(state, batch) -> metric sums, with the running BatchNorm stats
    (``expander``, ``classification``: as ``make_train_step``)."""
    compute_loss = loss_for(classification)

    @torch.no_grad()
    def eval_step(state, batch: GraphBatch) -> dict:
        if expander is not None and isinstance(batch, CompactBatch):
            batch = expander(batch)
        state.model.eval()
        out = state.model(batch)
        _, metrics = compute_loss(out, batch, state.normalizer)
        return metrics

    return eval_step


def make_predict_step(raw_expander: Callable | None = None,
                      expander: Callable | None = None) -> Callable:
    """(state, batch) -> denormalized predictions [G, T] (a classifier's
    [G, num_classes] log-probs, through its identity normalizer);
    padding graph slots are zeroed.

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
