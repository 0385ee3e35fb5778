"""CGCNN in PyTorch (``cgnn_tpu/models/cgcnn.py``).

Per conv layer, over the dense [N, M] edge slots (node n owns slots
[n*M, (n+1)*M) of the packed batch):

    z      = fc_full(v_i, v_j, e_ij)       # 2F+G -> 2F, no concat
    z      = BN1(z)                        # masked batch stats in train
    msg    = sigmoid(z[:F]) * softplus(z[F:]), padding slots dropped
    agg_i  = sum over the M slots
    v_i'   = softplus(v_i + BN2(agg_i))

and the full model: Linear(92->F) embedding, n_conv such layers, masked
per-crystal mean pooling, softplus MLP head; for classification the head
ends in ``num_classes`` log-probs (LogSoftmax), with inverted dropout
after ``conv_to_fc`` in train mode; ``multi_task_head`` replaces the MLP
head with models/heads.py's ``MultiTaskHead`` (one stack a target). ``cgconv_impl`` picks how a
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
kernel 6 (ops/scatter.py) on the card. When the batch carries the COO
transpose (``nbr_order``, ``nbr_offsets``, ``center_offsets``: training
batches, data/graph.py), the two endpoint gathers' backward sums each
node's cotangents in a fixed order (``gather_fixed_order``, kernel 6
again under ``'pallas'``), so COO training repeats its bits run to run,
as the dense layout's transpose does. The COO branch takes neither
``cgconv_impl`` nor ``fused_epilogue`` (both fuse the dense layout).

``dtype=torch.bfloat16`` is the JAX ``dtype=bfloat16`` compute: f32
parameters and BatchNorm statistics, every Dense as flax's
``Dense(dtype=...)`` (input, weight and bias cast to bf16, the product
in bf16), activations in bf16, the output promoted back to f32. The
whole-conv op then takes bf16 nodes and edges (its bf16 kernel
instances on the card).

Dropout draws its keep mask from the model's own ``torch.Generator``
(``dropout_generator``, on the parameters' device, seeded from
``dropout_seed``), never the global one: train/graphs.py registers it
with every captured train step, so each replay draws a fresh mask, and
train/checkpoint.py saves and restores its state.

Module and parameter names follow the JAX parameter tree (``conv_0``,
``fc_full.kernel``, ``bn1``, ``conv_to_fc``, ``fc_out``, ``head/task{t}_
...``) so convert.py maps one onto the other by name; ``fc_full.kernel``
is [2F+G, 2F] in both layouts.
"""

from __future__ import annotations

import torch
from torch import nn

from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.models.heads import Dense, MultiTaskHead
from cgnn_tpu_torch.ops.fused_cgconv import (
    FcFullParams,
    fused_cgconv,
    fused_cgconv_eval,
    softplus,
)
from cgnn_tpu_torch.ops.fused_epilogue import FusedBN1GateSum
from cgnn_tpu_torch.ops.norm import MaskedBatchNorm, update_running_stats
from cgnn_tpu_torch.ops.scatter import segment_sum_sorted
from cgnn_tpu_torch.ops.segment import (
    AGGREGATION_IMPLS,
    aggregate_edge_messages,
    gather,
    gather_fixed_order,
    gather_transpose,
    segment_mean,
)


class CGConv(nn.Module):
    """One edge-gated crystal-graph convolution: the dense branch, or the
    flat COO branch when ``dense_m`` is None.

    ``use_batchnorm=False`` (the force field's trunk, as the JAX
    ``CGConv(use_batchnorm=False)``) drops BN1 and BN2 and with them
    ``cgconv_impl`` and ``fused_epilogue``, which fuse BN1.
    ``fixed_order_sum`` sums a COO training batch's messages with the
    fixed-order op (ops/scatter.py ``segment_sum_sorted``, over the
    batch's ``center_offsets``) whatever ``aggregation_impl`` says, so a
    model differentiated twice keeps every sum in edge order (the library
    scatter-add's derivative of a derivative is a scatter-add again)."""

    def __init__(self, features: int, nbr_fea_len: int, dense_m: int | None,
                 cgconv_impl: str = "", fused_epilogue: str = "",
                 aggregation_impl: str | None = None, compute_dtype=None,
                 use_batchnorm: bool = True, fixed_order_sum: bool = False):
        super().__init__()
        # None: the parameters' own precision (f32, or f64 in tests)
        self.compute_dtype = compute_dtype
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
        if not use_batchnorm and (cgconv_impl or fused_epilogue):
            raise NotImplementedError(
                "cgconv_impl and fused_epilogue fuse the BN1 -> gate -> sum "
                "chain: they require use_batchnorm")
        if aggregation_impl not in (None, *AGGREGATION_IMPLS):
            raise ValueError(f"aggregation_impl must be None or one of "
                             f"{AGGREGATION_IMPLS}, got {aggregation_impl!r}")
        self.features = features
        self.dense_m = dense_m
        self.cgconv_impl = cgconv_impl
        self.aggregation_impl = aggregation_impl
        self.fixed_order_sum = fixed_order_sum
        self.fc_full = FcFullParams(2 * features + nbr_fea_len, 2 * features)
        if use_batchnorm:
            self.bn1 = (FusedBN1GateSum(2 * features, impl=fused_epilogue)
                        if fused_epilogue else MaskedBatchNorm(2 * features))
            self.bn2 = MaskedBatchNorm(features)
        else:  # the force field's trunk: the tree holds fc_full alone
            self.bn1 = self.bn2 = None

    def forward(self, nodes, edges, centers, neighbors, edge_mask,
                node_mask, transpose=None):
        """``transpose``: the batch's ``(in_slots, in_mask, over_slots,
        over_nodes, over_mask)`` (dense) or ``(center_offsets, nbr_order,
        nbr_offsets)`` (COO), or None."""
        if self.dense_m is None:
            agg = self._coo_aggregate(nodes, edges, centers, neighbors,
                                      edge_mask, transpose)
        else:
            agg = self._dense_aggregate(nodes, edges, neighbors, edge_mask,
                                        transpose)
        if self.bn2 is not None:
            agg = self.bn2(agg, node_mask)
        out = softplus(nodes + agg)
        return out * node_mask[:, None].to(out.dtype)

    def _coo_aggregate(self, nodes, edges, centers, neighbors, edge_mask,
                       transpose):
        center_offsets = None
        if transpose is None:
            v_i, v_j = gather(nodes, centers), gather(nodes, neighbors)
        else:
            center_offsets, nbr_order, nbr_offsets = transpose
            impl = "pallas" if self.aggregation_impl == "pallas" else "xla"
            v_i = gather_fixed_order(nodes, centers, None, center_offsets,
                                     impl)
            v_j = gather_fixed_order(nodes, neighbors, nbr_order,
                                     nbr_offsets, impl)
        z = torch.cat([v_i, v_j, edges.to(nodes.dtype)], dim=-1)
        dt = self.compute_dtype or self.fc_full.kernel.dtype
        z = (z.to(dt) @ self.fc_full.kernel.to(dt)
             + self.fc_full.bias.to(dt))
        if self.bn1 is not None:
            z = self.bn1(z, edge_mask)
        gate, core = z.chunk(2, dim=-1)
        msg = torch.sigmoid(gate) * softplus(core)
        msg = msg * edge_mask[:, None].to(msg.dtype)
        if self.fixed_order_sum and center_offsets is not None:
            return segment_sum_sorted(msg, centers, nodes.shape[0], impl,
                                      offsets=center_offsets)
        return aggregate_edge_messages(msg, centers, nodes.shape[0],
                                       impl=self.aggregation_impl,
                                       offsets=center_offsets)

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
                    *conv, transpose, eps=bn1.eps, impl=self.cgconv_impl,
                    dtype=self.compute_dtype or torch.float32)
                update_running_stats(bn1.running_mean, bn1.running_var,
                                     mean.detach(), var.detach(),
                                     n_real.detach(), bn1.momentum)
            else:
                agg = fused_cgconv_eval(
                    *conv, bn1.running_mean, bn1.running_var, eps=bn1.eps,
                    impl=self.cgconv_impl,
                    dtype=self.compute_dtype or torch.float32)
            agg = agg.to(nodes.dtype)
        else:
            v_j = gather_transpose(nodes, neighbors, *(transpose or ()))
            v_j = v_j.reshape(n, m, f)
            dt = self.compute_dtype or self.fc_full.kernel.dtype
            k = self.fc_full.kernel.to(dt)
            z = (
                (nodes.to(dt) @ k[:f])[:, None, :]
                + v_j.to(dt) @ k[f: 2 * f]
                + e.to(nodes.dtype).to(dt) @ k[2 * f:]
            ) + self.fc_full.bias.to(dt)
            if isinstance(bn1, FusedBN1GateSum):
                agg = bn1(z, emask).to(nodes.dtype)
            else:
                if bn1 is not None:
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


def apply_dropout(x: torch.Tensor, keep: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``'s inverted dropout given its keep mask:
    ``where(keep, x / keep_prob, 0)``, keep_prob rounded to x's dtype
    first, as JAX rounds a weakly typed scalar (a fill on the device: a
    host scalar made into a tensor would be a copy a capture cannot
    take)."""
    keep_prob = x.new_full((), 1.0 - rate)
    return torch.where(keep, x / keep_prob, x.new_zeros(()))


class CrystalGraphConvNet(nn.Module):
    """Full CGCNN. Returns [G, num_targets] (regression; the multi-task
    head's T columns) or [G, num_classes] log-probs (classification), in
    f32, one row per graph slot; padding slots are zeroed."""

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
        classification: bool = False,
        num_classes: int = 2,
        dropout: float = 0.0,
        dtype=torch.float32,
        multi_task_head: bool = False,
        dropout_seed: int = 0,
    ):
        super().__init__()
        self.n_conv = n_conv
        self.n_h = n_h
        self.classification = classification
        self.dropout = dropout
        # the configured dtype (also the edge features' storage type);
        # f32 computes in the parameters' own precision
        self.dtype = dtype
        cdt = None if dtype == torch.float32 else dtype
        self.dropout_seed = dropout_seed
        self._generator = None
        self.embedding = Dense(orig_atom_fea_len, atom_fea_len, cdt)
        for i in range(n_conv):
            self.add_module(f"conv_{i}", CGConv(
                atom_fea_len, nbr_fea_len, dense_m, cgconv_impl,
                fused_epilogue, aggregation_impl, cdt))
        self.conv_to_fc = Dense(atom_fea_len, h_fea_len, cdt)
        # the JAX rule: the multi-task head replaces the fc stack, and a
        # classifier never takes it
        self.head = (MultiTaskHead(num_targets, h_fea_len, n_h, cdt)
                     if multi_task_head and not classification else None)
        if self.head is None:
            for i in range(n_h - 1):
                self.add_module(f"fc_{i}", Dense(h_fea_len, h_fea_len, cdt))
            self.fc_out = Dense(
                h_fea_len, num_classes if classification else num_targets,
                cdt)

    def dropout_generator(self) -> torch.Generator:
        """The dropout mask's generator, on the parameters' device, made
        on first use from ``dropout_seed``."""
        dev = self.conv_to_fc.weight.device
        gen = self._generator
        if gen is None or gen.device != dev:
            gen = self._generator = torch.Generator(device=dev)
            gen.manual_seed(self.dropout_seed)
        return gen

    def draws_dropout(self) -> bool:
        """Whether a train-mode forward draws from ``dropout_generator``."""
        return self.classification and self.dropout > 0

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        nodes = self.embedding(batch.nodes)
        nodes = nodes * batch.node_mask[:, None].to(nodes.dtype)
        transpose = None
        if batch.in_slots is not None:
            transpose = (batch.in_slots, batch.in_mask, batch.over_slots,
                         batch.over_nodes, batch.over_mask)
        elif batch.nbr_order is not None:
            transpose = (batch.center_offsets, batch.nbr_order,
                         batch.nbr_offsets)
        for i in range(self.n_conv):
            nodes = getattr(self, f"conv_{i}")(
                nodes, batch.edges, batch.centers, batch.neighbors,
                batch.edge_mask, batch.node_mask, transpose)
        crys = segment_mean(nodes, batch.node_graph, batch.graph_capacity,
                            weights=batch.node_mask.to(nodes.dtype))
        crys = softplus(self.conv_to_fc(softplus(crys)))
        if self.training and self.draws_dropout():
            keep = torch.rand(crys.shape, device=crys.device,
                              generator=self.dropout_generator()) < (
                                  1.0 - self.dropout)
            crys = apply_dropout(crys, keep, self.dropout)
        if self.head is not None:
            out = self.head(crys)
        else:
            for i in range(self.n_h - 1):
                crys = softplus(getattr(self, f"fc_{i}")(crys))
            out = self.fc_out(crys)
            if self.classification:
                out = torch.log_softmax(out, dim=-1)
        out = out * batch.graph_mask[:, None].to(out.dtype)
        # low-precision compute comes back in f32 (f64 stays f64)
        return out.to(torch.promote_types(out.dtype, torch.float32))
