"""The predict step (``cgnn_tpu/train/step.py`` ``make_predict_step``),
for the full-fidelity ``GraphBatch`` form."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.train.normalizer import Normalizer


@dataclasses.dataclass
class InferenceState:
    """What a predict step reads: the eval model and its normalizer, on
    one device (the JAX TrainState's apply_fn/variables/normalizer)."""

    model: torch.nn.Module
    normalizer: Normalizer


def make_predict_step() -> Callable:
    """(state, batch) -> denormalized predictions [G, T]; padding graph
    slots are zeroed."""

    @torch.inference_mode()
    def predict_step(state: InferenceState, batch: GraphBatch):
        out = state.model(batch)
        return state.normalizer.denorm(out) * batch.graph_mask[:, None]

    return predict_step
