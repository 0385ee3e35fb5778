"""CGCNN in PyTorch, eval mode, dense slot layout (``cgnn_tpu/models/cgcnn.py``).

Per conv layer, over the dense [N, M] edge slots (node n owns slots
[n*M, (n+1)*M) of the packed batch):

    z      = fc_full(v_i, v_j, e_ij)       # 2F+G -> 2F, no concat
    z      = BN1(z)                        # running stats
    msg    = sigmoid(z[:F]) * softplus(z[F:]), padding slots dropped
    agg_i  = sum over the M slots
    v_i'   = softplus(v_i + BN2(agg_i))

and the full model: Linear(92->F) embedding, n_conv such layers, masked
per-crystal mean pooling, softplus MLP head. ``cgconv_impl`` picks how a
conv runs (config.py): ``'pallas'``/``'xla'`` the fused op of
ops/fused_cgconv.py, ``''`` the unfused plain path written out below.

Module and parameter names follow the JAX parameter tree (``conv_0``,
``fc_full.kernel``, ``bn1``, ``conv_to_fc``, ``fc_out``) so convert.py maps
one onto the other by name. Not ported yet: the flat COO branch, train
mode, ``MultiTaskHead`` and classification.
"""

from __future__ import annotations

import torch
from torch import nn

from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.ops.fused_cgconv import (
    FcFullParams,
    fused_cgconv_eval,
    softplus,
)
from cgnn_tpu_torch.ops.norm import MaskedBatchNorm
from cgnn_tpu_torch.ops.segment import gather, segment_mean


class CGConv(nn.Module):
    """One edge-gated crystal-graph convolution, dense branch."""

    def __init__(self, features: int, nbr_fea_len: int, dense_m: int,
                 cgconv_impl: str = ""):
        super().__init__()
        if cgconv_impl not in ("", "xla", "pallas"):
            raise ValueError(
                f"cgconv_impl must be '', 'xla' or 'pallas', got "
                f"{cgconv_impl!r}")
        self.features = features
        self.dense_m = dense_m
        self.cgconv_impl = cgconv_impl
        self.fc_full = FcFullParams(2 * features + nbr_fea_len, 2 * features)
        self.bn1 = MaskedBatchNorm(2 * features)
        self.bn2 = MaskedBatchNorm(features)

    def forward(self, nodes, edges, neighbors, edge_mask, node_mask):
        if self.training:
            raise NotImplementedError(
                "CGConv train mode comes with the training slice")
        f, m = self.features, self.dense_m
        n = nodes.shape[0]
        e = edges if edges.dim() == 3 else edges.reshape(n, m, -1)
        if self.cgconv_impl:
            agg = fused_cgconv_eval(
                nodes, e, self.fc_full.kernel, self.fc_full.bias,
                self.bn1.weight, self.bn1.bias, neighbors,
                edge_mask.reshape(n, m), self.bn1.running_mean,
                self.bn1.running_var, eps=self.bn1.eps,
                impl=self.cgconv_impl,
            ).to(nodes.dtype)
        else:
            v_j = gather(nodes, neighbors).reshape(n, m, f)
            k = self.fc_full.kernel
            z = (
                (nodes @ k[:f])[:, None, :]
                + v_j @ k[f: 2 * f]
                + e.to(nodes.dtype) @ k[2 * f:]
            ) + self.fc_full.bias
            z = self.bn1(z)
            gate, core = z.chunk(2, dim=-1)
            msg = torch.sigmoid(gate) * softplus(core)
            msg = msg * edge_mask.reshape(n, m, 1).to(msg.dtype)
            agg = msg.sum(dim=1)
        agg = self.bn2(agg)
        out = softplus(nodes + agg)
        return out * node_mask[:, None].to(out.dtype)


class CrystalGraphConvNet(nn.Module):
    """Full CGCNN regression model. Returns [G, num_targets], one row per
    graph slot; padding slots are zeroed."""

    def __init__(
        self,
        orig_atom_fea_len: int,
        nbr_fea_len: int,
        atom_fea_len: int = 64,
        n_conv: int = 3,
        h_fea_len: int = 128,
        n_h: int = 1,
        num_targets: int = 1,
        dense_m: int | None = None,
        cgconv_impl: str = "",
    ):
        super().__init__()
        if dense_m is None:
            raise NotImplementedError(
                "the flat COO branch is not ported yet; use dense_m")
        self.n_conv = n_conv
        self.n_h = n_h
        self.embedding = nn.Linear(orig_atom_fea_len, atom_fea_len)
        for i in range(n_conv):
            self.add_module(f"conv_{i}", CGConv(
                atom_fea_len, nbr_fea_len, dense_m, cgconv_impl))
        self.conv_to_fc = nn.Linear(atom_fea_len, h_fea_len)
        for i in range(n_h - 1):
            self.add_module(f"fc_{i}", nn.Linear(h_fea_len, h_fea_len))
        self.fc_out = nn.Linear(h_fea_len, num_targets)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        nodes = self.embedding(batch.nodes)
        nodes = nodes * batch.node_mask[:, None].to(nodes.dtype)
        for i in range(self.n_conv):
            nodes = getattr(self, f"conv_{i}")(
                nodes, batch.edges, batch.neighbors, batch.edge_mask,
                batch.node_mask)
        crys = segment_mean(nodes, batch.node_graph, batch.graph_capacity,
                            weights=batch.node_mask.to(nodes.dtype))
        crys = softplus(self.conv_to_fc(softplus(crys)))
        for i in range(self.n_h - 1):
            crys = softplus(getattr(self, f"fc_{i}")(crys))
        out = self.fc_out(crys)
        return out * batch.graph_mask[:, None].to(out.dtype)
