"""Output heads (``cgnn_tpu/models/heads.py``).

``MultiTaskHead``: the multi-task configuration (BASELINE.json config #3:
formation energy, band gap, bulk and shear modulus) shares one conv trunk
and gives each task its own softplus MLP stack over the pooled crystal
features. Missing labels are left out of the loss by ``target_mask``.

``ForceHead``: the force field's per-atom energy readout
(models/forcefield.py).
"""

from __future__ import annotations

import torch
from torch import nn

from cgnn_tpu_torch.ops.fused_epilogue import softplus


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: with a ``compute_dtype`` (bf16), the
    input, the f32 weight and the bias are cast to it and the product is
    taken in it; without one, the input is cast to the weight's dtype
    (``nn.Linear`` on the parameters' own precision, f32 or f64). A
    module, so forward hooks see it (``--debug-nans``)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype=None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return nn.functional.linear(x.to(dt), self.weight.to(dt),
                                    self.bias.to(dt))


class MultiTaskHead(nn.Module):
    """Per-task MLP stacks, [G, H] -> [G, T]: for task t, ``n_h - 1``
    softplus layers ``task{t}_fc{i}`` (H -> H), then ``task{t}_out``
    (H -> 1); the T columns concatenated. Names follow the JAX parameter
    tree (``head/task{t}_...``)."""

    def __init__(self, num_tasks: int, h_fea_len: int = 128, n_h: int = 1,
                 compute_dtype=None):
        super().__init__()
        self.num_tasks = num_tasks
        self.n_h = n_h
        for t in range(num_tasks):
            for i in range(n_h - 1):
                self.add_module(f"task{t}_fc{i}",
                                Dense(h_fea_len, h_fea_len, compute_dtype))
            self.add_module(f"task{t}_out",
                            Dense(h_fea_len, 1, compute_dtype))

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        outs = []
        for t in range(self.num_tasks):
            h = pooled
            for i in range(self.n_h - 1):
                h = softplus(getattr(self, f"task{t}_fc{i}")(h))
            outs.append(getattr(self, f"task{t}_out")(h))
        return torch.cat(outs, dim=-1)


class ForceHead(nn.Module):
    """Per-atom scalar energy, [N, F] -> [N]: ``out(softplus(fc(x)))``,
    zeroed on padding nodes (the JAX ``ForceHead``; its tree is
    ``ForceHead_0/{fc,out}``). Energies depend on positions only through
    distances, so forces taken as their gradient are equivariant."""

    def __init__(self, in_features: int, h_fea_len: int = 64,
                 compute_dtype=None):
        super().__init__()
        self.fc = Dense(in_features, h_fea_len, compute_dtype)
        self.out = Dense(h_fea_len, 1, compute_dtype)

    def forward(self, node_fea: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        e = self.out(softplus(self.fc(node_fea)))[:, 0]
        return e * node_mask.to(e.dtype)
