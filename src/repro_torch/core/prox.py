"""Proximal operator library (Section II of the paper), on tensors.

``PROX_REGISTRY`` maps the regularizer names used by configs to
``(prox_fn, value_fn)`` pairs; ``prox_fn(v, t)`` solves
``argmin_z  h(z) + 1/(2t) ||z - v||^2``.  A scalar threshold is rounded to
the tensor's dtype before use, as the reference's weak typing does.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def soft_threshold(a: torch.Tensor, b) -> torch.Tensor:
    """Paper's S(a; b) = max(0, 1 - b/|a|) * a, elementwise (b >= 0)."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    mag = torch.abs(a)
    safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    return torch.where(mag > b, (1.0 - b / safe) * a, torch.zeros_like(a))


def prox_l1(v: torch.Tensor, t, lam: float = 1.0) -> torch.Tensor:
    """prox of lam*||.||_1 with step t  ==  soft threshold at lam*t."""
    return soft_threshold(v, lam * t)


def prox_l2sq(v: torch.Tensor, t, lam: float = 1.0) -> torch.Tensor:
    """prox of (lam/2)||.||_2^2 with step t  ==  scaling."""
    return v / (1.0 + lam * t)


def prox_zero(v: torch.Tensor, t, lam: float = 1.0) -> torch.Tensor:
    return v


def prox_elastic_net(v: torch.Tensor, t, lam1: float = 1.0,
                     lam2: float = 1.0) -> torch.Tensor:
    """prox of lam1*||.||_1 + (lam2/2)*||.||_2^2."""
    return soft_threshold(v, lam1 * t) / (1.0 + lam2 * t)


def prox_box(v: torch.Tensor, t, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    """prox of the indicator of [lo, hi]^d  ==  projection (step-free)."""
    return torch.clamp(v, lo, hi)


def l1_value(z: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    return lam * torch.sum(torch.abs(z))


def l2sq_value(z: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    return 0.5 * lam * torch.sum(z * z)


def zero_value(z: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    return torch.zeros((), dtype=z.dtype, device=z.device)


ProxFn = Callable[..., torch.Tensor]
PROX_REGISTRY: Dict[str, Tuple[ProxFn, ProxFn]] = {
    "l1": (prox_l1, l1_value),
    "l2sq": (prox_l2sq, l2sq_value),
    "none": (prox_zero, zero_value),
}
