"""The device an entry point runs on, and the one-copy upload of host arrays."""

from __future__ import annotations

import numpy as np
import torch

from ceres_slam_tpu_torch.utils import telemetry

_ALIGN = 16  # bytes: the kernels read their records with 16-byte loads


def resolve(device) -> torch.device:
    """The requested device; ``cuda`` without a card raises: nothing falls
    back to the CPU (pass ``device="cpu"`` to run there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return dev


def upload(arrays: dict, device) -> dict:
    """Host numpy arrays -> tensors on ``device`` in one host-to-device copy:
    the arrays are packed into one byte buffer (pinned on CUDA), each at a
    16-byte aligned offset, copied once, and returned as typed views of the
    device buffer under the same names."""
    device = torch.device(device)
    arrays = {k: np.ascontiguousarray(a) for k, a in arrays.items()}
    offsets, n = {}, 0
    for k, a in arrays.items():
        offsets[k] = n
        n += -(-a.nbytes // _ALIGN) * _ALIGN
    host = torch.empty(max(n, _ALIGN), dtype=torch.uint8, pin_memory=device.type == "cuda")
    buf = host.numpy()
    for k, a in arrays.items():
        buf[offsets[k]:offsets[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = telemetry.to_device(host, device, non_blocking=True) if device.type == "cuda" else host
    out = {}
    for k, a in arrays.items():
        dt = torch.bool if a.dtype == np.bool_ else getattr(torch, a.dtype.name)
        out[k] = dev[offsets[k]:offsets[k] + a.nbytes].view(dt).view(a.shape)
    return out
