"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The requested device; ``cuda`` without a card raises: nothing falls
    back to the CPU (pass ``device="cpu"`` to run there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return dev
