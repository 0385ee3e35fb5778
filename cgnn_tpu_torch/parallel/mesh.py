"""Devices and rank layout of a multi-process run
(``cgnn_tpu/parallel/mesh.py``).

The JAX package builds one ``Mesh(('data',))`` over every visible device
(``make_mesh``), or a ``('data', 'graph')`` mesh for graph sharding
(``make_2d_mesh``), and runs one program on it. The port runs one
process a card, so its "mesh" is the process group (parallel/dist.py)
and each process needs only its own card: the rank modulo the visible
cards (one host; ranks beyond the cards share them, which only gloo
allows). ``make_2d_mesh``'s device order becomes the rank layout of a
D x G run: rank r has data index r // G and graph index r % G, so a
graph group is G adjacent ranks (``graph_group_ranks``) and a data group
the ranks of one graph index (``data_group_ranks``).
"""

from __future__ import annotations

import torch


def device_count() -> int:
    """Visible CUDA cards (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def rank_device(device, rank: int) -> torch.device:
    """The device of process ``rank`` for a run asked for on ``device``:
    the CPU as it is; on CUDA the card ``rank`` modulo the visible cards
    (an explicit index is kept)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = device_count()
    return torch.device("cuda", rank % n) if n else dev


def rank_layout(rank: int, graph_shards: int) -> tuple[int, int]:
    """(data index, graph index) of ``rank`` in a run of ``graph_shards``
    graph shards (``make_2d_mesh``'s row-major device order)."""
    return rank // graph_shards, rank % graph_shards


def graph_group_ranks(data_index: int, graph_shards: int) -> list:
    """The G adjacent ranks that shard one data index's batches."""
    return list(range(data_index * graph_shards,
                      (data_index + 1) * graph_shards))


def data_group_ranks(graph_index: int, world: int,
                     graph_shards: int) -> list:
    """The ranks of one graph index, one a data index: the ranks whose
    gradients a data-parallel step averages."""
    return list(range(graph_index, world, graph_shards))
