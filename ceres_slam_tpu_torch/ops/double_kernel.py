"""P: ``o = 2 x`` — the CUDA kernel, its wrapper and its plain version.

``double_kernel`` replaces the Pallas TPU kernel ``double_kernel`` of
``scripts/probe_pallas_scan.py``, a probe of whether a kernel can run
inside a compiled loop. Its Hopper counterpart is a probe of whether a
launch can be captured in a CUDA graph and replayed
(``apps/probe_graph_loop.py``). The CUDA source, with the note on what
bounds it on an H100, is ``csrc/double_kernel.cu``. Two launch forms
mirror the TPU probe's ``grid=(4,)`` and ``grid=(1,)``: 4 blocks of 256
threads (``one_block=False``) and 1 block that loops over the array.
"""

from __future__ import annotations

import ctypes

import torch

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("double_kernel.cu",)
_fn: list = []


def double_kernel_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x * 2``."""
    return x * 2


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    p, i = ctypes.c_void_p, ctypes.c_int
    # x, o, n, one_block, device, multi_device, stream
    lib = cuda_build.load("double_kernel", _SOURCES,
                          {"double_kernel_f32": [p, p, i, i, i, i, p]})
    _fn[:] = [lib.double_kernel_f32]
    return str(cuda_build.library_path("double_kernel", _SOURCES))


def double_kernel(x: torch.Tensor, one_block: bool = False, out: torch.Tensor | None = None):
    """``2 x`` for a contiguous float32 tensor ``x``, written to ``out``
    (a new tensor by default; ``out`` may be ``x`` itself). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on the
    current stream (and counts the launch in ``.launches``), which a CUDA
    graph can capture."""
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f"double_kernel takes a non-empty contiguous float32 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor of x's shape, dtype and device")
    if x.device.type == "cpu":
        y = double_kernel_plain(x)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"double_kernel runs on cpu or cuda, not {x.device}")
    if not _fn:
        build()
    out = torch.empty_like(x) if out is None else out
    dev = x.get_device()
    err = _fn[0](x.data_ptr(), out.data_ptr(), x.numel(), int(one_block), dev,
                 torch.cuda.device_count() > 1, cuda_build.current_stream(dev))
    if err:
        raise cuda_build.launch_error(err, "double_kernel")
    double_kernel.launches += 1
    return out


double_kernel.launches = 0
