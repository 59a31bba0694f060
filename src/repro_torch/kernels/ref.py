"""Plain PyTorch versions of the hand-written kernels.

They are what a CPU tensor runs, what the tests hold against the JAX
package, and what ``chip_smoke.py`` holds each kernel against on the card.
Shapes carry any leading batch axes: a (..., N, D), b and mask (..., N),
x (..., D).  Rows with mask 0 contribute exactly zero.  The attention
kernels' plain versions are the model's own functions in
``models/attention.py``, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import prox as prox_mod
from repro_torch.models import attention as attn_mod


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


def softmax_vjp_ref(a, y, mask, X):
    """Multinomial value+grad (problems/softmax.py's loss): a (..., N, D),
    y (..., N) int labels, mask (..., N), X (..., D, C) -> (loss (...),
    grad (..., D, C)).  Masked rows contribute exactly zero to both."""
    C = X.shape[-1]
    logits = a @ X                                   # (..., N, C)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, y[..., None])[..., 0]
    loss = torch.sum(mask * (lse - picked), dim=-1)
    resid = mask[..., None] * (torch.softmax(logits, dim=-1)
                               - torch.nn.functional.one_hot(y, C).to(X.dtype))
    return loss, a.transpose(-1, -2) @ resid


def soft_threshold_ref(omega, z_old, thr):
    """omega, z_old (D,); thr a float32 scalar ->
    (z_new (D,), ||z_new - z_old||² (), nnz(z_new) () int64)."""
    z_new = prox_mod.soft_threshold(omega, thr)
    diff = z_new - z_old
    return z_new, torch.sum(diff * diff), torch.count_nonzero(z_new)


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q (B,S,H,hd), k/v (B,Skv,KV,hd) -> (B,S,H,hd).  Naive oracle."""
    return attn_mod.naive_attention(q, k, v, causal=causal, window=window)


def decode_attention_ref(q, k_cache, v_cache, positions):
    """q (B,1,H,hd), caches (B,Smax,KV,hd), positions (B,) -> (B,1,H,hd)."""
    return attn_mod.decode_attention(q, k_cache, v_cache, positions)
