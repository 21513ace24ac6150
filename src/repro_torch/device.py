"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  Without
a card it raises unless the caller asked for the CPU (``device="cpu"``): the
port never continues on the CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; None means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "visible; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev
