"""The fused CG update of the full-batch PCG — CUDA kernel and wrapper.

``cg_update`` runs, in place and in one launch, everything of a CG
iteration of ``solver/pcg.py`` after its matvec (``schur_kernel.schur_sp``):
the step, the residual, the block-Jacobi preconditioner's two triangular
solves, the direction, the count and the stop test. The CUDA source, with
what bounds it and its design, is ``csrc/cg_step.cu``. It has no plain
version of its own: ``pcg.cg_body`` with the in-place loop body of
``pcg._cg_in_place`` is that, the CPU's path and the kernel's reference on
the card. ``pcg`` takes it only where it can observe that it applies
(``pcg.fused_inputs``).
"""

from __future__ import annotations

import ctypes

import torch

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("cg_step.cu",)
BLOCK = 64  # poses a block (kBlock in csrc/cg_step.cu)


class _CgArgs(ctypes.Structure):
    """``CgArgs`` in csrc/cg_step.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("x", "r", "z", "p", "rz", "sp", "dots", "chol", "bound", "i", "pred", "scratch")]
    _fields_ += [(name, ctypes.c_int) for name in
                 ("K", "max_iters", "device", "multi_device")]


_fns: dict = {}


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    sig = [ctypes.POINTER(_CgArgs), ctypes.c_void_p]  # arguments, stream
    lib = cuda_build.load("cg_step", _SOURCES, {"cg_update_f32": sig, "cg_update_f64": sig})
    _fns.update({torch.float32: lib.cg_update_f32, torch.float64: lib.cg_update_f64})
    return str(cuda_build.library_path("cg_step", _SOURCES))


def cg_update(s, Sp: torch.Tensor, dots: torch.Tensor, chol: torch.Tensor, bound: torch.Tensor,
              i: torch.Tensor, pred: torch.Tensor, max_iters: int) -> None:
    """One CG iteration's update on the card, in place: ``s`` the iterate
    ``(x, r, z, p, rz)`` (``pcg.CGState``: ``[K, 6]`` each, ``rz`` 0-d),
    ``Sp [K, 6]`` and ``dots [K]`` from ``schur_sp``, the block-Jacobi
    factors ``chol [K, 6, 6]`` (blocks column-major, as a batched
    Cholesky leaves them: ``chol.mT`` contiguous), the 0-d stop ``bound``,
    the int32 count
    ``i`` and test ``pred`` (one element each). Two kernels; counts one
    launch in ``.launches``. Raises on tensors off the card or of another shape,
    dtype or device."""
    x = s[0]
    K, dt = x.shape[0], x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"cg_update runs on the card, not {x.device}")
    want = [(t, (K, 6), dt) for t in (*s[:4], Sp)]
    want += [(s[4], (), dt), (dots, (K,), dt), (chol, (K, 6, 6), dt), (bound, (), dt),
             (i, (1,), torch.int32), (pred, (1,), torch.int32)]
    for t, shape, dtype in want:
        dense = t.mT.is_contiguous() if t is chol else t.is_contiguous()
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device or not dense:
            raise ValueError(f"cg_update: a {t.dtype} {tuple(t.shape)} tensor on {t.device}, "
                             f"strides {t.stride()}, expected a dense {dtype} {shape} on "
                             f"{x.device}")
    if not _fns:
        build()
    scratch = x.new_empty((2 * -(-K // BLOCK) + 1,))
    args = _CgArgs(*(t.data_ptr() for t in (*s, Sp, dots, chol, bound, i, pred, scratch)), K,
                   max_iters, x.get_device(), torch.cuda.device_count() > 1)
    err = _fns[dt](ctypes.byref(args), cuda_build.current_stream(x.get_device()))
    if err:
        raise cuda_build.launch_error(err, "cg_update")
    cg_update.launches += 1


cg_update.launches = 0
