"""Plain PyTorch versions of the hand-written kernels.

They are what a CPU tensor runs, what the tests hold against the JAX
package, and what ``chip_smoke.py`` holds each kernel against on the card.
Shapes carry any leading batch axes: a (..., N, D), b and mask (..., N),
x (..., D).  Rows with mask 0 contribute exactly zero.
"""
from __future__ import annotations

import torch

from repro_torch.core import prox as prox_mod


def _margins(a, x):
    return (a @ x[..., None])[..., 0]                # (..., N)


def logistic_vjp_ref(a, b, mask, x):
    """(loss (...), grad (..., D)) of sum_n mask_n log1p(exp(-b_n a_n·x))."""
    m = -b * _margins(a, x)
    loss = torch.sum(mask * torch.logaddexp(torch.zeros_like(m), m), dim=-1)
    c = mask * (-b) * torch.sigmoid(m)
    return loss, (c[..., None, :] @ a)[..., 0, :]


def svm_vjp_ref(a, b, mask, x, gamma: float):
    """Smoothed-hinge twin of ``logistic_vjp_ref`` (smoothing width gamma)."""
    m = b * _margins(a, x)
    one = torch.ones_like(m)
    zero = torch.zeros_like(m)
    val = torch.where(m >= 1.0, zero,
                      torch.where(m <= 1.0 - gamma, 1.0 - m - gamma / 2,
                                  (1.0 - m) ** 2 / (2 * gamma)))
    dldm = torch.where(m >= 1.0, zero,
                       torch.where(m <= 1.0 - gamma, -one,
                                   -(1.0 - m) / gamma))
    c = mask * dldm * b
    loss = torch.sum(mask * val, dim=-1)
    return loss, (c[..., None, :] @ a)[..., 0, :]


def soft_threshold_ref(omega, z_old, thr):
    """omega, z_old (D,); thr a float32 scalar ->
    (z_new (D,), ||z_new - z_old||² (), nnz(z_new) () int64)."""
    z_new = prox_mod.soft_threshold(omega, thr)
    diff = z_new - z_old
    return z_new, torch.sum(diff * diff), torch.count_nonzero(z_new)
