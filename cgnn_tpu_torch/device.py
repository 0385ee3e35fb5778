"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to CUDA. A
CUDA request without a usable card raises: nothing runs on the CPU unless
the caller asked for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            f"(pass device='cpu' to run the plain versions on the CPU)")
    return dev
