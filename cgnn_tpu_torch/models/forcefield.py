"""The differentiable force field (``cgnn_tpu/models/forcefield.py``):
positions -> energy -> forces by autograd.

The edge distances are recomputed inside the forward from positions,
neighbor indices and periodic image offsets (``edge_distances``), so
forces are exactly ``F = -dE/dr`` and rotation-equivariant: the energy
depends on positions only through interatomic distances. The trunk is
CGConv without BatchNorm (models/cgcnn.py), the readout a per-atom
energy (models/heads.py ``ForceHead``) summed per crystal.

A train step differentiates twice: the forces are a gradient taken with
``create_graph=True``, and the loss on them is differentiated again to
the parameters (train/force_step.py). Every gather and sum on that path
is one of the fixed-order ops of ops/segment.py and ops/scatter.py, each
of which is differentiable any number of times with every sum in the
packer's order:

- the positions' endpoint gathers: ``gather_transpose`` (dense: the
  neighbor side; the center side is a broadcast over the node's M slots,
  whose transpose is a sum over them) or ``gather_fixed_order`` (COO,
  both sides), where the batch carries its transpose;
- the trunk's gathers and the COO messages' sum (``fixed_order_sum``);
- the per-crystal energy sum (``SortedSum`` over the node rows, which the
  packer lays out by graph), not ``index_add_``.

The Gaussian centres (``gaussian_centres``) are numpy's ``arange`` in the
model's dtype, as ``jnp.arange(dmin, dmax + step, step, dtype=...)``
computes them (its length from the float64 quotient, each value ``start +
i * delta`` in f32, rounded to the dtype).

Module and parameter names follow the JAX tree: ``embedding``,
``conv_{i}/fc_full``, ``ForceHead_0/{fc,out}``, no ``batch_stats``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.models.cgcnn import CGConv
from cgnn_tpu_torch.models.heads import Dense, ForceHead
from cgnn_tpu_torch.ops.scatter import SortedSum
from cgnn_tpu_torch.ops.segment import (
    gather,
    gather_fixed_order,
    gather_transpose,
)


def gaussian_centres(dmin: float, dmax: float, step: float,
                     dtype=torch.float32) -> torch.Tensor:
    """``jnp.arange(dmin, dmax + step, step, dtype=dtype)``: numpy's
    arange (the length ``ceil((stop - start) / step)`` in float64; the
    first two values rounded to ``dtype`` from float64, the rest ``start +
    i * (second - start)`` in f32 (f64 for a float64 dtype), rounded)."""
    stop = dmax + step
    n = max(0, int(math.ceil((stop - dmin) / step)))
    acc = torch.promote_types(dtype, torch.float32)
    first = torch.tensor(dmin, dtype=torch.float64).to(dtype).to(acc)
    second = torch.tensor(dmin + step, dtype=torch.float64).to(dtype).to(acc)
    i = torch.arange(n, dtype=torch.int64).to(acc)
    mu = first + i * (second - first)
    if n > 1:
        mu[1] = second
    if n > 0:
        mu[0] = first
    return mu.to(dtype)


def gaussian_expand(d: torch.Tensor, mu: torch.Tensor,
                    inv_width: torch.Tensor) -> torch.Tensor:
    """exp(-(d - mu)^2 / step^2), the JAX ``gaussian_expand`` (the
    featurizer's GaussianDistance), differentiable. ``inv_width`` is
    ``step**2`` as a 0-d tensor of d's dtype on d's device, as JAX rounds
    a weakly typed scalar to the array's dtype before dividing."""
    return torch.exp(-((d[..., None] - mu) ** 2) / inv_width)


def edge_distances(batch: GraphBatch, positions: torch.Tensor,
                   dense_m: int | None = None) -> torch.Tensor:
    """[E] periodic distances recomputed from ``positions`` [N, 3],
    differentiable in them: ``|pos[j] + offset @ lattice - pos[i]|``,
    with ``+1e-12`` under the square root so the gradient stays finite on
    padding edges (rel == 0), the lattice gathered by
    ``node_graph[centers]``. The gathers of ``positions`` are the fixed-
    order ones where the batch carries its transpose (module docstring),
    summed by their plain version; ``dense_m`` says the layout (None:
    COO)."""
    lat_e = batch.lattices.index_select(
        0, batch.node_graph.index_select(0, batch.centers))  # [E, 3, 3]
    shift = torch.einsum("ek,ekj->ej", batch.edge_offsets, lat_e)
    n = positions.shape[0]
    if dense_m is not None:
        # slot k belongs to node k // M on every slot of the dense layout:
        # the center gather is a broadcast, its transpose a sum over M
        pos_c = positions[:, None, :].expand(n, dense_m, 3).reshape(-1, 3)
        transpose = () if batch.in_slots is None else (
            batch.in_slots, batch.in_mask, batch.over_slots,
            batch.over_nodes, batch.over_mask)
        pos_j = gather_transpose(positions, batch.neighbors, *transpose)
    elif batch.nbr_order is not None:
        pos_c = gather_fixed_order(positions, batch.centers, None,
                                   batch.center_offsets)
        pos_j = gather_fixed_order(positions, batch.neighbors,
                                   batch.nbr_order, batch.nbr_offsets)
    else:
        pos_c = gather(positions, batch.centers)
        pos_j = gather(positions, batch.neighbors)
    rel = pos_j + shift - pos_c
    return torch.sqrt((rel * rel).sum(dim=-1) + 1e-12)


def graph_sum(values: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """[N] per-node values -> [G] per-graph sums in node order, by the
    fixed-order sum (no atomics; differentiable any number of times).
    Real nodes lie in graph order; a padding node (graph slot 0, value 0)
    joins the run of the last real node before it (``cummax``), adding 0.
    The offsets come from ``searchsorted``: no host sync."""
    ids = torch.where(batch.node_mask > 0, batch.node_graph,
                      torch.zeros_like(batch.node_graph))
    key = torch.cummax(ids, dim=0).values
    offsets = torch.searchsorted(
        key, torch.arange(batch.graph_capacity + 1, dtype=key.dtype,
                          device=key.device), out_int32=True)
    return SortedSum.apply(values[:, None], key, None, offsets, "xla")[:, 0]


class ForceFieldCGCNN(nn.Module):
    """CGCNN trunk + per-atom energy readout over in-model edge features;
    ``forward(batch, positions=None)`` -> per-graph total energies [G]
    in f32 (f64 stays f64), padding slots zero. ``positions`` defaults to
    ``batch.positions``; the force path passes a leaf to differentiate.

    ``dense_m``: the dense layout (None: COO; batches packed with the
    same M). ``aggregation_impl``: the COO aggregation, ``'pallas'``
    refused (module ``config.build_model``)."""

    task = "force"  # train/step.py ``is_force``

    def __init__(self, orig_atom_fea_len: int, atom_fea_len: int = 64,
                 n_conv: int = 3, h_fea_len: int = 64, dmin: float = 0.0,
                 dmax: float = 8.0, step: float = 0.2,
                 dtype=torch.float32, aggregation_impl: str | None = None,
                 dense_m: int | None = None):
        super().__init__()
        self.n_conv = n_conv
        self.dense_m = dense_m
        self.aggregation_impl = aggregation_impl
        # the configured dtype (what the distances are cast to, as the
        # JAX d.astype(dtype)); f32 computes in the parameters' precision
        self.dtype = dtype
        cdt = None if dtype == torch.float32 else dtype
        mu = gaussian_centres(dmin, dmax, step, dtype)
        # not in the state dict (the JAX tree has no such leaf); buffers,
        # so they move with the model and a capture reads them in place
        self.register_buffer("mu", mu, persistent=False)
        self.register_buffer("inv_width",
                             torch.tensor(step ** 2, dtype=torch.float64)
                             .to(dtype), persistent=False)
        self.embedding = Dense(orig_atom_fea_len, atom_fea_len, cdt)
        for i in range(n_conv):
            self.add_module(f"conv_{i}", CGConv(
                atom_fea_len, mu.numel(), dense_m,
                aggregation_impl=aggregation_impl, compute_dtype=cdt,
                use_batchnorm=False, fixed_order_sum=True))
        self.ForceHead_0 = ForceHead(atom_fea_len, h_fea_len, cdt)

    def forward(self, batch: GraphBatch,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        if positions is None:
            positions = batch.positions
        # the model's dtype (the buffers follow .double() in tests)
        dt = self.mu.dtype
        d = edge_distances(batch, positions, self.dense_m).to(dt)
        edge_fea = gaussian_expand(d, self.mu, self.inv_width) * (
            batch.edge_mask[:, None].to(dt))
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
                nodes, edge_fea, batch.centers,
                batch.neighbors, batch.edge_mask, batch.node_mask,
                transpose)
        atom_energy = self.ForceHead_0(nodes, batch.node_mask)
        out_dtype = torch.promote_types(atom_energy.dtype, torch.float32)
        per_graph = graph_sum(atom_energy.to(out_dtype), batch)
        return per_graph * batch.graph_mask.to(out_dtype)


def energy_and_forces(model: ForceFieldCGCNN, batch: GraphBatch,
                      create_graph: bool = False):
    """(energies [G], forces [N, 3]) with ``F = -dE/dr`` on the real
    nodes (0 on padding), in the model's current mode. ``create_graph``
    keeps the forces differentiable (the train step's second
    derivative)."""
    pos = batch.positions.detach().requires_grad_(True)
    with torch.enable_grad():
        energies = model(batch, pos)
        (grad_pos,) = torch.autograd.grad(energies.sum(), pos,
                                          create_graph=create_graph)
    forces = -grad_pos * batch.node_mask[:, None].to(grad_pos.dtype)
    return energies, forces
