"""CGCNN in PyTorch (``cgnn_tpu/models/cgcnn.py``).

Per conv layer, over the dense [N, M] edge slots (node n owns slots
[n*M, (n+1)*M) of the packed batch):

    z      = fc_full(v_i, v_j, e_ij)       # 2F+G -> 2F, no concat
    z      = BN1(z)                        # masked batch stats in train
    msg    = sigmoid(z[:F]) * softplus(z[F:]), padding slots dropped
    agg_i  = sum over the M slots
    v_i'   = softplus(v_i + BN2(agg_i))

and the full model: Linear(92->F) embedding, n_conv such layers, masked
per-crystal mean pooling, softplus MLP head. ``cgconv_impl`` picks how a
conv runs (config.py): ``'pallas'``/``'xla'`` the whole-conv fused op of
ops/fused_cgconv.py, ``''`` the unfused path written out below, whose
BN1 -> gate -> sum chain ``fused_epilogue`` (``'pallas'``/``'xla'``) can
replace with ops/fused_epilogue.py's op. Train and eval mode follow
``nn.Module.train()``/``.eval()``; in train mode the batch statistics
update the running ones inside the forward, and the v_j gather takes the
batch's transpose mapping for its backward when the batch carries one.

``dense_m=None`` is the flat COO branch, over the batch's [E] edges:

    z      = cat(v_i, v_j, e_ij) @ fc_full + b   # gathers by centers and
                                                 # neighbors
    z      = BN1(z) over the real edges
    msg    = sigmoid(z[:F]) * softplus(z[F:]), padding edges zeroed
    agg_i  = aggregate_edge_messages(msg, centers, impl=aggregation_impl)

then BN2 and the residual as above. ``aggregation_impl='pallas'`` runs
kernel 6 (ops/scatter.py) on the card. The COO branch takes neither
``cgconv_impl`` nor ``fused_epilogue`` (both fuse the dense layout).

Module and parameter names follow the JAX parameter tree (``conv_0``,
``fc_full.kernel``, ``bn1``, ``conv_to_fc``, ``fc_out``) so convert.py maps
one onto the other by name; ``fc_full.kernel`` is [2F+G, 2F] in both
layouts. Not ported yet: ``MultiTaskHead`` and classification.
"""

from __future__ import annotations

import torch
from torch import nn

from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.ops.fused_cgconv import (
    FcFullParams,
    fused_cgconv,
    fused_cgconv_eval,
    softplus,
)
from cgnn_tpu_torch.ops.fused_epilogue import FusedBN1GateSum
from cgnn_tpu_torch.ops.norm import MaskedBatchNorm, update_running_stats
from cgnn_tpu_torch.ops.segment import (
    AGGREGATION_IMPLS,
    aggregate_edge_messages,
    gather,
    gather_transpose,
    segment_mean,
)


class CGConv(nn.Module):
    """One edge-gated crystal-graph convolution: the dense branch, or the
    flat COO branch when ``dense_m`` is None."""

    def __init__(self, features: int, nbr_fea_len: int, dense_m: int | None,
                 cgconv_impl: str = "", fused_epilogue: str = "",
                 aggregation_impl: str | None = None):
        super().__init__()
        for name, v in (("cgconv_impl", cgconv_impl),
                        ("fused_epilogue", fused_epilogue)):
            if v not in ("", "xla", "pallas"):
                raise ValueError(
                    f"{name} must be '', 'xla' or 'pallas', got {v!r}")
        if cgconv_impl and fused_epilogue:
            raise ValueError("cgconv_impl subsumes fused_epilogue (the whole "
                             "conv is one op); pick one")
        if dense_m is None and (cgconv_impl or fused_epilogue):
            raise NotImplementedError(
                "cgconv_impl and fused_epilogue require the dense layout "
                "(dense_m)")
        if aggregation_impl not in (None, *AGGREGATION_IMPLS):
            raise ValueError(f"aggregation_impl must be None or one of "
                             f"{AGGREGATION_IMPLS}, got {aggregation_impl!r}")
        self.features = features
        self.dense_m = dense_m
        self.cgconv_impl = cgconv_impl
        self.aggregation_impl = aggregation_impl
        self.fc_full = FcFullParams(2 * features + nbr_fea_len, 2 * features)
        self.bn1 = (FusedBN1GateSum(2 * features, impl=fused_epilogue)
                    if fused_epilogue else MaskedBatchNorm(2 * features))
        self.bn2 = MaskedBatchNorm(features)

    def forward(self, nodes, edges, centers, neighbors, edge_mask,
                node_mask, transpose=None):
        """``transpose``: the batch's ``(in_slots, in_mask, over_slots,
        over_nodes, over_mask)`` or None (dense layout only)."""
        if self.dense_m is None:
            agg = self._coo_aggregate(nodes, edges, centers, neighbors,
                                      edge_mask)
        else:
            agg = self._dense_aggregate(nodes, edges, neighbors, edge_mask,
                                        transpose)
        agg = self.bn2(agg, node_mask)
        out = softplus(nodes + agg)
        return out * node_mask[:, None].to(out.dtype)

    def _coo_aggregate(self, nodes, edges, centers, neighbors, edge_mask):
        v_i = gather(nodes, centers)
        v_j = gather(nodes, neighbors)
        z = torch.cat([v_i, v_j, edges.to(nodes.dtype)], dim=-1)
        z = z @ self.fc_full.kernel + self.fc_full.bias
        z = self.bn1(z, edge_mask)
        gate, core = z.chunk(2, dim=-1)
        msg = torch.sigmoid(gate) * softplus(core)
        msg = msg * edge_mask[:, None].to(msg.dtype)
        return aggregate_edge_messages(msg, centers, nodes.shape[0],
                                       impl=self.aggregation_impl)

    def _dense_aggregate(self, nodes, edges, neighbors, edge_mask,
                         transpose):
        f, m = self.features, self.dense_m
        n = nodes.shape[0]
        e = edges if edges.dim() == 3 else edges.reshape(n, m, -1)
        emask = edge_mask.reshape(n, m)
        bn1 = self.bn1
        if self.cgconv_impl:
            conv = (nodes, e, self.fc_full.kernel, self.fc_full.bias,
                    bn1.weight, bn1.bias, neighbors, emask)
            if self.training:
                agg, mean, var, n_real = fused_cgconv(
                    *conv, transpose, eps=bn1.eps, impl=self.cgconv_impl)
                update_running_stats(bn1.running_mean, bn1.running_var,
                                     mean.detach(), var.detach(),
                                     n_real.detach(), bn1.momentum)
            else:
                agg = fused_cgconv_eval(
                    *conv, bn1.running_mean, bn1.running_var, eps=bn1.eps,
                    impl=self.cgconv_impl)
            agg = agg.to(nodes.dtype)
        else:
            v_j = gather_transpose(nodes, neighbors, *(transpose or ()))
            v_j = v_j.reshape(n, m, f)
            k = self.fc_full.kernel
            z = (
                (nodes @ k[:f])[:, None, :]
                + v_j @ k[f: 2 * f]
                + e.to(nodes.dtype) @ k[2 * f:]
            ) + self.fc_full.bias
            if isinstance(bn1, FusedBN1GateSum):
                agg = bn1(z, emask).to(nodes.dtype)
            else:
                z = bn1(z, emask)
                gate, core = z.chunk(2, dim=-1)
                msg = torch.sigmoid(gate) * softplus(core)
                # load-bearing for gradients, not only values: the
                # scatter-free gather backward assumes zero cotangent on
                # padding slots, which this mask (with the masked BN
                # statistics) guarantees
                msg = msg * emask[..., None].to(msg.dtype)
                agg = msg.sum(dim=1)
        return agg


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
        fused_epilogue: str = "",
        aggregation_impl: str | None = None,
    ):
        super().__init__()
        self.n_conv = n_conv
        self.n_h = n_h
        self.embedding = nn.Linear(orig_atom_fea_len, atom_fea_len)
        for i in range(n_conv):
            self.add_module(f"conv_{i}", CGConv(
                atom_fea_len, nbr_fea_len, dense_m, cgconv_impl,
                fused_epilogue, aggregation_impl))
        self.conv_to_fc = nn.Linear(atom_fea_len, h_fea_len)
        for i in range(n_h - 1):
            self.add_module(f"fc_{i}", nn.Linear(h_fea_len, h_fea_len))
        self.fc_out = nn.Linear(h_fea_len, num_targets)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        nodes = self.embedding(batch.nodes.to(self.embedding.weight.dtype))
        nodes = nodes * batch.node_mask[:, None].to(nodes.dtype)
        transpose = None
        if batch.in_slots is not None:
            transpose = (batch.in_slots, batch.in_mask, batch.over_slots,
                         batch.over_nodes, batch.over_mask)
        for i in range(self.n_conv):
            nodes = getattr(self, f"conv_{i}")(
                nodes, batch.edges, batch.centers, batch.neighbors,
                batch.edge_mask, batch.node_mask, transpose)
        crys = segment_mean(nodes, batch.node_graph, batch.graph_capacity,
                            weights=batch.node_mask.to(nodes.dtype))
        crys = softplus(self.conv_to_fc(softplus(crys)))
        for i in range(self.n_h - 1):
            crys = softplus(getattr(self, f"fc_{i}")(crys))
        out = self.fc_out(crys)
        return out * batch.graph_mask[:, None].to(out.dtype)
