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

Graph sharding (``graph_group``, a ``parallel.dist.Group``: the JAX
``edge_axis_name``; ``set_graph_group``) splits every batch's edge work
over the group's ranks, each holding the whole node and graph leaves and
only its own part of the edge leaves (parallel/edge_parallel.py
``rank_view``):

- dense: rank s owns the node strip ``[s*N/G, (s+1)*N/G)`` and its
  [N/G, M] edge slots, so each node's message sum is whole on its rank;
  the strips are all-gathered into the full [N, F] aggregate (backward:
  the rank's strip of the cotangent);
- COO: rank s holds a contiguous chunk of the center-sorted edge list
  and sums it to a partial [N, F], made whole by an all-reduce (backward:
  the identity);

with BN1's moments over every rank's edges (ops/norm.py ``group``), and
the nodes entering the sharded region through ``Group.enter``, whose
backward sums the ranks' partial node cotangents. The edge-side
parameters (``fc_full``, ``bn1``: ``sharded_parameters``) get partial
gradients on each rank and are summed over the group after the backward
(train/step.py); the node-side ones (the embedding, ``bn2``, the head)
are whole on every rank already. ``cgconv_impl`` and ``fused_epilogue``
are refused with it (the JAX rule: they fuse the unsharded dense conv).
The parameter tree does not change.

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
        # graph sharding's group (CrystalGraphConvNet.set_graph_group)
        self.graph_group = None
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
        if self.graph_group is not None:
            agg = self._sharded_aggregate(nodes, edges, centers, neighbors,
                                          edge_mask, transpose)
        elif self.dense_m is None:
            agg = self._coo_aggregate(nodes, edges, centers, neighbors,
                                      edge_mask, transpose)
        else:
            agg = self._dense_aggregate(nodes, edges, neighbors, edge_mask,
                                        transpose)
        if self.bn2 is not None:
            agg = self.bn2(agg, node_mask)
        out = softplus(nodes + agg)
        return out * node_mask[:, None].to(out.dtype)

    def _sharded_aggregate(self, nodes, edges, centers, neighbors,
                           edge_mask, transpose):
        """This rank's share of the conv's edge work under graph sharding
        (module docstring) -> the whole [N, F] aggregate, the same on
        every rank of the group."""
        grp = self.graph_group
        n, f = nodes.shape[0], self.features
        nodes_v = grp.enter(nodes)
        if self.dense_m is None:
            return grp.sum_partials(self._coo_aggregate(
                nodes_v, edges, centers, neighbors, edge_mask, transpose,
                grp))
        m = self.dense_m
        e = edges if edges.dim() == 3 else edges.reshape(-1, m,
                                                         edges.shape[-1])
        n_strip = e.shape[0]
        if n_strip * grp.size != n:
            raise ValueError(
                f"a node strip of {n_strip} rows over {grp.size} graph "
                f"shards does not cover the batch's {n} nodes")
        if transpose is not None:
            # a rank's mapping arrives as its row of the per-shard stack
            # ([1, ...], parallel/edge_parallel.py rank_view); a stack for
            # another shard count would drop cotangents silently
            if transpose[1].dim() == 3:
                if transpose[1].shape[0] != 1:
                    raise ValueError(
                        f"per-shard transpose mapping was built for "
                        f"{transpose[1].shape[0]}x this group's graph-shard "
                        f"count (pack with transpose_shards == the "
                        f"group's size)")
                transpose = tuple(None if t is None else t[0]
                                  for t in transpose)
            v_j = gather_transpose(nodes_v, neighbors, *transpose)
        else:
            v_j = gather(nodes_v, neighbors)
        v_j = v_j.reshape(n_strip, m, f)
        lo = grp.index * n_strip
        strip = nodes_v[lo:lo + n_strip]
        dt = self.compute_dtype or self.fc_full.kernel.dtype
        k = self.fc_full.kernel.to(dt)
        z = (
            (strip.to(dt) @ k[:f])[:, None, :]
            + v_j.to(dt) @ k[f: 2 * f]
            + e.to(nodes.dtype).to(dt) @ k[2 * f:]
        ) + self.fc_full.bias.to(dt)
        emask = edge_mask.reshape(n_strip, m)
        if self.bn1 is not None:
            z = self.bn1(z, emask, group=grp)
        gate, core = z.chunk(2, dim=-1)
        msg = torch.sigmoid(gate) * softplus(core)
        msg = msg * emask[..., None].to(msg.dtype)
        return grp.gather_strips(msg.sum(dim=1))

    def _coo_aggregate(self, nodes, edges, centers, neighbors, edge_mask,
                       transpose, group=None):
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
            z = self.bn1(z, edge_mask, group=group)
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
        self.cgconv_impl = cgconv_impl
        self.fused_epilogue = fused_epilogue
        self.graph_group = None
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

    def set_graph_group(self, group) -> "CrystalGraphConvNet":
        """Shard every conv's edge work over ``group`` (a
        ``parallel.dist.Group``; None: unsharded again), the JAX
        ``edge_axis_name`` (module docstring). Refused, with the JAX
        message, for ``cgconv_impl`` and ``fused_epilogue``."""
        if group is not None and self.fused_epilogue:
            raise NotImplementedError(
                "fused_epilogue requires the dense layout with BatchNorm "
                "(it fuses the BN1->gate->mask->sum chain) and no graph "
                "sharding")
        if group is not None and self.cgconv_impl:
            raise NotImplementedError(
                "cgconv_impl (the whole-conv fused kernel) requires the "
                "dense layout with BatchNorm and no graph sharding")
        self.graph_group = group
        for i in range(self.n_conv):
            getattr(self, f"conv_{i}").graph_group = group
        return self

    def sharded_parameters(self) -> list:
        """The parameters used inside the sharded region (each conv's
        ``fc_full`` and ``bn1``): their gradients are partial on each
        rank of a graph group."""
        return [p for i in range(self.n_conv)
                for name in ("fc_full", "bn1")
                if (mod := getattr(getattr(self, f"conv_{i}"), name))
                is not None
                for p in mod.parameters()]

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
