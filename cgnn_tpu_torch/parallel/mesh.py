"""Devices of a data-parallel run (``cgnn_tpu/parallel/mesh.py``).

The JAX package builds one ``Mesh(('data',))`` over every visible device
and runs one program on it. The port runs one process a card, so its
"mesh" is the process group (parallel/dist.py) and each process needs
only its own card: the rank modulo the visible cards (one host; ranks
beyond the cards share them, which only gloo allows).
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
