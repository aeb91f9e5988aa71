"""K3: the coupling half of the Schur matvec — CUDA kernel, wrapper and plain version.

``schur_uy`` replaces the Pallas TPU kernel
``ceres_slam_tpu/ops/pallas_kernels.py::schur_uy_packed`` (with its wrapper
``schur_uy``); the CUDA source, with the note on what bounds it on an H100
and how its design answers that, is ``csrc/schur_uy.cu``. The plain
PyTorch version ``schur_uy_plain`` sums over the same segments in slot
order (``index_add_`` in observation order): the CPU path and the kernel's
reference on the card.

``Uy [K, 6] = sum_j U_j Cinv_j U_j^T v`` for the component-flat couplings
``U18 [N, 18]``, the damped inverted landmark blocks ``Cinv [J, 3, 3]`` and
``v [K, 6]``. ``U18`` and ``Cinv`` are the same for every CG iteration of
an LM iteration: ``bind`` checks them once against the problem's
``FullBatchPlan`` (``ops/full_batch_plan.py``), and a call checks only
``v``, allocates its output and launches with one argument struct.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import cuda_build, full_batch_plan, lie

_SOURCES = ("schur_uy.cu",)


class _UyArgs(ctypes.Structure):
    """``UyArgs`` in csrc/schur_uy.cu: the plan and this LM iteration's blocks."""

    _fields_ = [("plan", full_batch_plan._Plan), ("U18", ctypes.c_void_p),
                ("cinv", ctypes.c_void_p)]


class UyBinding(NamedTuple):
    """K3's inputs fixed over an LM iteration, checked by ``bind``."""

    plan: full_batch_plan.FullBatchPlan
    U18: torch.Tensor  # [N, 18]
    Cinv: torch.Tensor  # [J, 3, 3]
    args: _UyArgs | None  # the C side's copy (None on the CPU)


def bind(plan: full_batch_plan.FullBatchPlan, U18: torch.Tensor, Cinv: torch.Tensor) -> UyBinding:
    """Check ``U18 [N, 18]`` and ``Cinv [J, 3, 3]`` against the plan (the
    plan's dtype and device, contiguous) and bind them for ``schur_uy``."""
    ref = plan.rec
    for name, t, shape in (("U18", U18, (plan.N, 18)), ("Cinv", Cinv, (plan.J, 3, 3))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != ref.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {ref.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, the plan on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    args = None
    if plan.args is not None:
        if U18.data_ptr() % 16:
            raise ValueError("U18 is not 16-byte aligned (the kernel loads its rows in pairs)")
        args = _UyArgs(plan.args, U18.data_ptr(), Cinv.data_ptr())
    return UyBinding(plan, U18, Cinv, args)


def schur_uy_plain(bound: UyBinding, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and output)."""
    p, U = bound.plan, bound.U18.view(-1, 6, 3)
    utv = torch.zeros((p.J, 3), dtype=v.dtype, device=v.device).index_add_(
        0, p.point_idx, torch.einsum("nac,na->nc", U, v[p.pose_idx]))
    y = lie._mv(bound.Cinv, utv)
    return torch.zeros((p.K, 6), dtype=v.dtype, device=v.device).index_add_(
        0, p.pose_idx, lie._mv(U, y[p.point_idx]))


def _library() -> ctypes.CDLL:
    p = ctypes.c_void_p
    sig = [ctypes.POINTER(_UyArgs), p, p, p]  # binding, v, out, stream
    sp = [ctypes.POINTER(_UyArgs), p, p, p, p, p]  # binding, p, Hpp, Sp, dots, stream
    return cuda_build.load("schur_uy", _SOURCES, {"schur_uy_f32": sig, "schur_uy_f64": sig,
                                                  "schur_sp_f32": sp, "schur_sp_f64": sp})


_fns: dict = {}


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    lib = _library()
    _fns.update({torch.float32: lib.schur_uy_f32, torch.float64: lib.schur_uy_f64,
                 ("sp", torch.float32): lib.schur_sp_f32, ("sp", torch.float64): lib.schur_sp_f64})
    return str(cuda_build.library_path("schur_uy", _SOURCES))


def _bad_v(v, K, ref):
    if v.device.type == "cuda" and v.data_ptr() % 16:
        raise ValueError("v is not 16-byte aligned (the kernel loads its rows in pairs)")
    if tuple(v.shape) != (K, 6):
        raise ValueError(f"v: shape {tuple(v.shape)}, expected {(K, 6)}")
    if v.dtype != ref.dtype:
        raise ValueError(f"v: dtype {v.dtype}, expected {ref.dtype}")
    if v.device != ref.device:
        raise ValueError(f"v is on {v.device}, the plan on {ref.device}")
    raise ValueError("v is not contiguous")


def schur_uy(bound: UyBinding, v: torch.Tensor) -> torch.Tensor:
    """``Uy [K, 6]``. A binding on the CPU takes the plain version; on CUDA
    the kernel runs (and counts the launch in ``.launches``). Only ``v``
    is checked here (shape, dtype, device, contiguity, and on the card a
    16-byte aligned start)."""
    U18, args = bound.U18, bound.args
    K = bound.plan.K
    if args is None:  # the plan is on the CPU
        if (v.shape != (K, 6) or v.dtype != U18.dtype or v.device != U18.device
                or not v.is_contiguous()):
            _bad_v(v, K, U18)
        return schur_uy_plain(bound, v)
    if (v.shape != (K, 6) or v.dtype is not U18.dtype or v.get_device() != args.plan.device
            or not v.is_contiguous() or v.data_ptr() % 16):
        _bad_v(v, K, U18)
    if not _fns:
        build()
    out = U18.new_empty((K, 6))
    err = _fns[U18.dtype](args, v.data_ptr(), out.data_ptr(),
                          cuda_build.current_stream(args.plan.device))
    if err:
        raise cuda_build.launch_error(err, "schur_uy")
    schur_uy.launches += 1
    return out


schur_uy.launches = 0


def schur_sp(bound: UyBinding, p: torch.Tensor, Hpp: torch.Tensor):
    """The matvec of a fused CG iteration (``solver/pcg.py``) on the card:
    ``(Sp, dots)``, ``Sp [K, 6] = Hpp p - Uy`` (``Hpp [K, 6, 6]``, the
    damped pose blocks) and ``dots [K]``, each pose's share ``p_k . Sp_k``
    of the iteration's first dot. K3's two phases, the pose phase extended,
    so it counts as a K3 launch (``schur_uy.launches``, K3 in either form)
    and in its own ``.launches`` (the fused form alone). Checks ``p`` as
    ``schur_uy`` checks ``v``, and ``Hpp``; raises off the card."""
    U18, args = bound.U18, bound.args
    K = bound.plan.K
    if args is None:
        raise ValueError("schur_sp runs on the card: the plan is on the CPU")
    if (p.shape != (K, 6) or p.dtype is not U18.dtype or p.get_device() != args.plan.device
            or not p.is_contiguous() or p.data_ptr() % 16):
        _bad_v(p, K, U18)
    if (Hpp.shape != (K, 6, 6) or Hpp.dtype is not U18.dtype or Hpp.device != p.device
            or not Hpp.is_contiguous()):
        raise ValueError(f"Hpp: {Hpp.dtype} {tuple(Hpp.shape)} on {Hpp.device}, expected a "
                         f"contiguous {U18.dtype} {(K, 6, 6)} on {p.device}")
    if not _fns:
        build()
    Sp, dots = U18.new_empty((K, 6)), U18.new_empty((K,))
    err = _fns[("sp", U18.dtype)](args, p.data_ptr(), Hpp.data_ptr(), Sp.data_ptr(),
                                  dots.data_ptr(), cuda_build.current_stream(args.plan.device))
    if err:
        raise cuda_build.launch_error(err, "schur_sp")
    schur_uy.launches += 1
    schur_sp.launches += 1
    return Sp, dots


schur_sp.launches = 0


def random_inputs(N: int, J: int, K: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded K3 arguments ``(bound, v)`` at a full-batch shape: the plan of
    ``full_batch_plan.random_problem`` (pose-ordered rows and a padding tail
    at pose 0), random couplings with the masked rows' zeroed, SPD ``Cinv``."""
    plan, _, _ = full_batch_plan.random_problem(N, J, K, dtype, device, seed)
    rng = np.random.default_rng(seed + 1)
    U18 = rng.normal(0, 1.0, (N, 18))
    U18[~plan.valid.cpu().numpy()] = 0.0
    A = rng.normal(0, 0.3, (J, 3, 3))
    Cinv = A @ A.transpose(0, 2, 1) + np.eye(3)

    def put(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

    return bind(plan, put(U18), put(Cinv)), put(rng.normal(0, 1.0, (K, 6)))
