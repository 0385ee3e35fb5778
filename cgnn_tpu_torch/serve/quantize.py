"""Serving precision tiers (``cgnn_tpu/serve/quantize.py``).

Every rung of the serving ladder is captured once a tier at warm-up, and
each request picks its tier: ``f32`` for calibration traffic, ``bf16`` for
the bulk, ``int8`` weights for throughput. Tiers (``TIERS``):

- ``f32``: the checkpoint's own model (whatever dtype it was trained in;
  the label means no serving-side degradation);
- ``bf16``: the same parameters applied through the bf16 compute path
  (``Dense(compute_dtype=bf16)``, models/heads.py; the bf16 instances of
  the kernels on the card): a clone of the model's modules whose
  parameters and buffers ARE the f32 model's tensors, so the tier keeps
  no second copy of the weights and a hot swap's in-place copy reaches
  it. Edge features arrive in the wire's dtype and are cast to bf16
  first, inside the step;
- ``int8``: blocked symmetric int8 weights under the bf16 compute path.
  Every 2-D kernel with more than 8 output columns outside ``embedding``
  and ``fc_out`` is quantized per (32-row input block, output column),
  scale = absmax / 127; q and its scales are tensors at fixed addresses
  that the captured predict graph reads, and the graph dequantizes them
  (q * scale in f32, THEN the model's cast to bf16: rounding the scale
  first double-rounds every weight) before it runs the bf16 model.
  Biases, BatchNorm and the normalizer stay f32.

Layouts: the flax kernel is [in, out]. The port's ``fc_full.kernel`` is
too, and an ``nn.Linear`` weight is [out, in]: its quantization runs on
the transpose, so q and the scales are the JAX package's bit for bit
(``QuantizedKernel.linear`` records that the parameter is [out, in]).
The quantization itself is numpy, the JAX package's arithmetic.

A tier is a ``TierSpec``: ``state_for`` derives the tier's state from the
native one once per entry (the JAX package also drops the optimizer state
there; an InferenceState has none), and a hot swap re-derives only what
the tier holds of its own (``payload``: the int8 q and scales, computed
outside any lock) and copies it in place (``load``), so no graph is
captured again. Accuracy is gated, not assumed: the MAE ratio to f32 is
held at 1.005 at most (tests/test_torch_quantize.py, chip_smoke.py).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch
from torch import nn

TIERS = ("f32", "bf16", "int8")

# scales per (input block, output column): per column alone drifted to the
# edge of the 0.5% gate on small models in the JAX package; 32-row blocks
# halve the absmax a scale covers
_QBLOCK = 32

# modules whose kernels stay full precision: the embedding (the input's
# first touch) and the output head (its error lands 1:1 on the answer)
_KEEP_FULL_PRECISION = ("embedding", "fc_out")


@dataclasses.dataclass
class QuantizedKernel:
    """Blocked symmetric int8 weight: ``q`` [blocks * _QBLOCK, out] int8
    in the [in, out] layout (the input dim padded to the block) and f32
    ``scale`` [blocks, out]; ``in_dim`` undoes the padding; ``linear``: the
    parameter is an ``nn.Linear`` weight [out, in], the transpose of q's
    layout."""

    q: torch.Tensor
    scale: torch.Tensor
    in_dim: int = 0
    linear: bool = False


def quantize_kernel(w, block: int = _QBLOCK,
                    linear: bool = False) -> QuantizedKernel:
    """Blocked symmetric int8 quantization of a 2-D [in, out] kernel."""
    w32 = np.asarray(w, np.float32)
    in_dim, out = w32.shape
    b = max(1, min(block, in_dim))
    pad = (-in_dim) % b
    wp = np.pad(w32, ((0, pad), (0, 0)))
    wb = wp.reshape(-1, b, out)
    absmax = np.abs(wb).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(wb / scale[:, None, :]), -127, 127).astype(np.int8)
    return QuantizedKernel(q=torch.from_numpy(q.reshape(-1, out)),
                           scale=torch.from_numpy(scale), in_dim=in_dim,
                           linear=linear)


def _targeted(name: str, t: torch.Tensor) -> bool | None:
    """None when ``name`` is not quantized, else whether it is an
    ``nn.Linear`` weight ([out, in]) rather than a kernel ([in, out])."""
    *mods, leaf = name.split(".")
    if t.ndim != 2 or not t.is_floating_point() or any(
            m in _KEEP_FULL_PRECISION for m in mods):
        return None
    if leaf == "kernel" and t.shape[1] > 8:
        return False
    if leaf == "weight" and t.shape[0] > 8:
        return True
    return None


def quantize_params(params: dict) -> dict:
    """A model's parameters by name (``named_parameters`` or a
    ``state_dict``) with each targeted 2-D weight replaced by its
    QuantizedKernel; every other entry passes through untouched."""
    out = {}
    for name, t in params.items():
        linear = _targeted(name, t)
        if linear is None:
            out[name] = t
            continue
        w = t.detach().float().cpu().numpy()
        out[name] = quantize_kernel(w.T if linear else w, linear=linear)
    return out


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor, in_dim: int,
                      linear: bool, dtype=None) -> torch.Tensor:
    """q * scale in f32, the block padding cut, in the parameter's own
    layout; cast to ``dtype`` only after the product."""
    out = q.shape[-1]
    qb = q.to(torch.float32).reshape(scale.shape[0], -1, out)
    w = (qb * scale[:, None, :]).reshape(-1, out)[:in_dim]
    if linear:
        w = w.t()
    return w if dtype is None else w.to(dtype)


def dequantize_params(params: dict, dtype=None) -> dict:
    """QuantizedKernel entries -> dense weights in their parameter's
    layout (``dequantize_kernel``); other entries pass through."""
    return {k: (dequantize_kernel(v.q, v.scale, v.in_dim, v.linear, dtype)
                if isinstance(v, QuantizedKernel) else v)
            for k, v in params.items()}


def bf16_clone(model: nn.Module) -> nn.Module:
    """The model's modules computing in bf16, their parameters and
    buffers the model's own tensors (no copy)."""
    memo = {id(t): t for t in itertools.chain(model.parameters(),
                                              model.buffers())}
    gen = getattr(model, "_generator", None)
    if gen is not None:
        memo[id(gen)] = gen
    clone = copy.deepcopy(model, memo)
    if hasattr(clone, "dtype"):
        clone.dtype = torch.bfloat16
    for m in clone.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.bfloat16
    return clone.eval()


class TierModel(nn.Module):
    """A bf16 or int8 tier's model (module docstring): ``inner`` is the
    bf16 clone; with ``quantized`` (``quantize_params`` output), each
    targeted weight is a pair of buffers ``q<k>``/``scale<k>`` dequantized
    in every forward and handed to the clone in place of the f32 weight
    (``torch.func.functional_call``)."""

    def __init__(self, model: nn.Module, quantized: dict | None = None):
        super().__init__()
        self.inner = bf16_clone(model)
        dev = next(model.parameters()).device
        self._quant: list[tuple[str, int, bool]] = []
        for k, (name, v) in enumerate((quantized or {}).items()):
            self.register_buffer(f"q{k}", v.q.to(dev))
            self.register_buffer(f"scale{k}", v.scale.to(dev))
            self._quant.append((name, v.in_dim, v.linear))

    @torch.no_grad()
    def load_quantized(self, quantized: dict) -> None:
        """Copy a newer quantization of the same model in place."""
        for k, (name, _, _) in enumerate(self._quant):
            getattr(self, f"q{k}").copy_(quantized[name].q)
            getattr(self, f"scale{k}").copy_(quantized[name].scale)

    def forward(self, batch):
        if batch.edges.dtype != torch.bfloat16:
            batch = dataclasses.replace(batch,
                                        edges=batch.edges.to(torch.bfloat16))
        if not self._quant:
            return self.inner(batch)
        weights = {name: dequantize_kernel(getattr(self, f"q{k}"),
                                           getattr(self, f"scale{k}"),
                                           in_dim, linear)
                   for k, (name, in_dim, linear) in enumerate(self._quant)}
        return torch.func.functional_call(self.inner, weights, (batch,))


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One precision tier: how its state derives from the native one."""

    name: str

    def state_for(self, state):
        """Native InferenceState -> this tier's, on the same device: the
        native state itself for f32, else a ``TierModel`` over its model
        and the same normalizer tensors."""
        from cgnn_tpu_torch.train.step import InferenceState

        if self.name == "f32":
            return state
        return InferenceState(
            TierModel(state.model, self.payload(state)).eval(),
            state.normalizer)

    def payload(self, state) -> dict | None:
        """What a hot swap copies into this tier beyond the native
        tensors it shares: the int8 quantization of ``state``'s weights
        (host tensors), else None."""
        if self.name != "int8":
            return None
        return {k: v for k, v in quantize_params(
            dict(state.model.named_parameters())).items()
            if isinstance(v, QuantizedKernel)}

    def load(self, tier_state, payload) -> None:
        """Copy ``payload`` into ``tier_state``'s tensors in place."""
        if payload is not None:
            tier_state.model.load_quantized(payload)


def build_tier_specs(precisions: Sequence[str]) -> dict:
    """{tier: TierSpec} for the requested precision set (build it once a
    server: its states are derived once an entry)."""
    unknown = set(precisions) - set(TIERS)
    if unknown:
        raise ValueError(f"unknown precision tier(s) {sorted(unknown)}; "
                         f"valid: {TIERS}")
    return {t: TierSpec(t) for t in dict.fromkeys(precisions)}


def parse_precisions(spec: str) -> tuple[str, ...]:
    """``'f32,bf16'`` -> ('f32', 'bf16'); f32 always comes first (the
    default tier and the parity baseline). Raises on an unknown tier."""
    tiers = tuple(dict.fromkeys(
        ("f32", *(t.strip() for t in str(spec).split(",") if t.strip()))))
    build_tier_specs(tiers)
    return tiers
