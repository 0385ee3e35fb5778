"""Train, eval and predict steps of the force task
(``cgnn_tpu/train/force_step.py``; BASELINE config #5).

The loss is the energy + force composite of ML force fields:

    L = w_e * MSE(E_norm) + w_f * MSE(F / std)

Energies are normalized with the target normalizer (mean and std of the
training energies); force labels are scaled by 1/std, so the predicted
forces, ``-d(E_norm)/dr`` up to the same 1/std, live on a matching scale.
Metrics are sums in original units, as the other tasks' (``loss_sum``,
``mae_sum`` of the energies, ``count``, ``force_mae_sum`` and
``force_mae_count``).

The train step differentiates twice: the forces are a gradient over the
positions taken with ``create_graph=True`` (models/forcefield.py
``energy_and_forces``), and the composite loss is then differentiated to
the parameters (``loss.backward(inputs=...)``: the positions' leaf gets no
gradient). Every gather and sum on both passes is a fixed-order op, so a
step repeats its bits run to run, and none reads the device back: the
steps are captured whole as CUDA graphs like the other tasks' (the
autograd graph of a step is freed by its own backward, so nothing of it
outlives a replay).
"""

from __future__ import annotations

from typing import Callable

import torch

from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.models.forcefield import energy_and_forces
from cgnn_tpu_torch.observe.health import step_with_health
from cgnn_tpu_torch.train.normalizer import Normalizer


def force_loss(energies, forces, batch: GraphBatch, normalizer: Normalizer,
               w_energy: float = 1.0, w_force: float = 10.0):
    """The composite masked loss -> (loss, metric sums in original
    units), the JAX ``force_loss`` term for term."""
    std = normalizer.std[0]
    e_norm_target = normalizer.norm(batch.targets)[:, 0]
    gw = batch.graph_mask
    n_g = torch.clamp_min(gw.sum(), 1.0)
    e_se = (energies - e_norm_target) ** 2 * gw
    e_loss = e_se.sum() / n_g

    f_target_scaled = batch.node_targets / std
    nw = batch.node_mask[:, None]
    f_se = ((forces - f_target_scaled) ** 2) * nw
    n_f = torch.clamp_min(nw.sum() * 3.0, 1.0)
    f_loss = f_se.sum() / n_f

    loss = w_energy * e_loss + w_force * f_loss
    e_ae = torch.abs(normalizer.denorm(energies[:, None])[:, 0]
                     - batch.targets[:, 0]) * gw
    f_ae = torch.abs(forces * std - batch.node_targets) * nw
    metrics = {
        "loss_sum": loss * n_g,  # so the loss averages like the others
        "mae_sum": e_ae.sum(),
        "count": gw.sum(),
        "force_mae_sum": f_ae.sum(),
        "force_mae_count": nw.sum() * 3.0,
    }
    return loss, metrics


def make_force_grad_step(w_energy: float = 1.0,
                         w_force: float = 10.0) -> Callable:
    """(state, batch) -> metric sums: the force train step up to its
    optimizer update, the composite loss's parameter gradients left in
    each ``.grad``. The data-parallel step (parallel/data_parallel.py
    ``ParallelTrainStep``) takes it as its grad part: it averages the
    gradients and the statistics over the ranks and sums the metric
    sums, so the guard's NaN check reads the loss every rank agrees on,
    as the JAX step with ``axis_name`` pmeans and psums before its
    health check (``cgnn_tpu/train/force_step.py:116-128``)."""

    def grad_step(state, batch: GraphBatch) -> dict:
        model = state.model
        model.train()
        energies, forces = energy_and_forces(model, batch, create_graph=True)
        loss, metrics = force_loss(energies, forces, batch, state.normalizer,
                                   w_energy, w_force)
        state.optimizer.zero_grad()
        loss.backward(inputs=list(state.optimizer.params))
        return {k: v.detach() for k, v in metrics.items()}

    return grad_step


def make_force_train_step(w_energy: float = 1.0,
                          w_force: float = 10.0,
                          grad_health: bool = False) -> Callable:
    """(state, batch) -> metric sums; one composite-loss update of
    ``state`` in place (module docstring): the grad part
    (``make_force_grad_step``), then the optimizer update (with the
    grad-health metrics when ``grad_health``, as train/step.py's)."""
    grad_step = make_force_grad_step(w_energy, w_force)

    def train_step(state, batch: GraphBatch) -> dict:
        metrics = grad_step(state, batch)
        if grad_health:
            return step_with_health(state, metrics, state.optimizer.step)
        state.optimizer.step()
        return metrics

    return train_step


def make_force_eval_step(w_energy: float = 1.0,
                         w_force: float = 10.0) -> Callable:
    """(state, batch) -> metric sums (eval mode; the forces are still a
    gradient, so autograd stays on)."""

    def eval_step(state, batch: GraphBatch) -> dict:
        state.model.eval()
        energies, forces = energy_and_forces(state.model, batch)
        _, metrics = force_loss(energies, forces, batch, state.normalizer,
                                w_energy, w_force)
        return {k: v.detach() for k, v in metrics.items()}

    return eval_step


def make_force_predict_step() -> Callable:
    """(state, batch) -> (energies [G] denormalized, padding slots 0;
    forces [N, 3] in original units, padding nodes 0)."""

    def predict_step(state, batch: GraphBatch):
        state.model.eval()
        energies, forces = energy_and_forces(state.model, batch)
        std = state.normalizer.std[0]
        e = state.normalizer.denorm(energies[:, None])[:, 0] * (
            batch.graph_mask)
        return e.detach(), (forces * std).detach()

    return predict_step
