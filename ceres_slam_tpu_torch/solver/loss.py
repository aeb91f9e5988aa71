"""Huber and Cauchy robust-loss IRLS weights (port of ``ceres_slam_tpu/solver/loss.py``).

The loss ``rho(s)`` applies to the squared norm ``s = |r|^2`` of a residual
block; IRLS rescales the whitened residual and Jacobian by ``sqrt(rho'(s))``.
"""

from __future__ import annotations

import torch


def huber_weight(sq_norm: torch.Tensor, a: float) -> torch.Tensor:
    """``sqrt(rho'(s))`` for Huber: ``rho(s) = s`` if ``s <= a^2`` else ``2a sqrt(s) - a^2``."""
    a2 = a * a
    safe = torch.clamp(sq_norm, min=a2)
    return torch.where(sq_norm <= a2, torch.ones_like(sq_norm), torch.sqrt(a / torch.sqrt(safe)))


def huber_rho(sq_norm: torch.Tensor, a: float) -> torch.Tensor:
    a2 = a * a
    return torch.where(sq_norm <= a2, sq_norm, 2.0 * a * torch.sqrt(torch.clamp(sq_norm, min=a2)) - a2)


def cauchy_weight(sq_norm: torch.Tensor, a: float) -> torch.Tensor:
    """``sqrt(rho'(s))`` for Cauchy: ``rho(s) = a^2 log(1 + s/a^2)``."""
    return 1.0 / torch.sqrt(1.0 + sq_norm / (a * a))


def cauchy_rho(sq_norm: torch.Tensor, a: float) -> torch.Tensor:
    a2 = a * a
    return a2 * torch.log1p(sq_norm / a2)
