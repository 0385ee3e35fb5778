"""In-graph gradient-health metrics (``cgnn_tpu/observe/health.py``):
grad and update norms, NaN/Inf counts.

Computed inside the train step (train/step.py, train/force_step.py,
parallel/data_parallel.py build it with ``grad_health=True``) as tensor
ops with no host read, so a captured step graph holds them: they ride
the existing metric plumbing (the static ``DeviceSums`` accumulators,
the one fetch an epoch, and at ``--telemetry step`` the step stream).
Everything is derived from values the step already has (gradients, the
parameters before and after the update, the loss); nothing here feeds
back into the update, so the trajectory is bit-identical with or without
it.

Keys follow the (sum, count) convention: ``*_sum`` with a matching
``*_count`` of 1 a step, so the epoch means are per-step means and a
step record's are the raw values. Norms accumulate in f32, as the JAX
module's (in f64 for an f64 model, where the JAX module still rounds
to f32).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _acc_dtype(tensors) -> torch.dtype:
    return torch.promote_types(tensors[0].dtype, torch.float32)


def flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every element of ``tensors`` in one vector (accumulation dtype):
    the snapshot of the parameters before an update."""
    dtype = _acc_dtype(tensors)
    return torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of ``tensors``."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(flat(tensors))


def nonfinite_count(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Total NaN/Inf elements over ``tensors`` (an f32 scalar)."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return _nonfinite(flat(tensors))


def _nonfinite(v: torch.Tensor) -> torch.Tensor:
    return (~torch.isfinite(v)).sum().to(torch.float32)


def _as_metrics(gnorm, bad, unorm, loss) -> dict:
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    out = {
        "grad_norm_sum": gnorm,
        "grad_norm_count": one,
        "update_norm_sum": unorm,
        "update_norm_count": one,
        "nonfinite_grads_sum": bad,
        "nonfinite_grads_count": one,
    }
    if loss is not None:
        out["nonfinite_loss_sum"] = (~torch.isfinite(loss)).to(torch.float32)
        out["nonfinite_loss_count"] = one
    return out


@torch.no_grad()
def grad_health_metrics(grads: Sequence[torch.Tensor],
                        old_params: Sequence[torch.Tensor],
                        new_params: Sequence[torch.Tensor],
                        loss: torch.Tensor | None = None) -> dict:
    """The step's health metric sums (the JAX function's keys):
    ``grads`` the applied gradients, the parameters before and after the
    update, ``loss`` the step's loss (any scalar that is finite exactly
    when it is)."""
    grads = list(grads)
    return _as_metrics(global_norm(grads), nonfinite_count(grads),
                       torch.linalg.vector_norm(flat(list(new_params))
                                                - flat(list(old_params))),
                       loss)


@torch.no_grad()
def step_with_health(state, metrics: dict, update) -> dict:
    """``update()`` (the optimizer step of ``state``), with the health
    metrics of the gradients it applies added to ``metrics``: their norm
    and non-finite count read before the update (before any clipping, as
    the JAX step reads them), the update's norm after it, and the
    finiteness of ``metrics["loss_sum"]``."""
    params = [p for p in state.optimizer.params if p.grad is not None]
    grads = flat([p.grad for p in params])  # one copy for both reads
    gnorm, bad = torch.linalg.vector_norm(grads), _nonfinite(grads)
    old = flat(params)
    update()
    unorm = torch.linalg.vector_norm(flat(params) - old)
    return {**metrics, **_as_metrics(gnorm, bad, unorm,
                                     metrics.get("loss_sum"))}
