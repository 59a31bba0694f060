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
from repro_torch.data.logreg import add_at, lane_flat_indices
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


def _rows_margins(idx, vals, x):
    """Each row's <a_n, x>: idx, vals (W, N, k), x (W, d) -> (W, N),
    summed over the row's nonzeros in the order the row lists them, as
    the kernel's rows mode sums them."""
    flat = idx.reshape(idx.shape[0], -1).to(torch.int64)
    prod = vals * x.gather(1, flat).view(idx.shape)
    ax = torch.zeros(prod.shape[:-1], dtype=prod.dtype, device=prod.device)
    for j in range(prod.shape[-1]):
        ax = ax + prod[..., j]
    return ax


def _rows_grad(idx, vals, c, d):
    """sum_n c_n a_n per lane, by ``add_at`` in row order: (W, d)."""
    grad = torch.zeros((idx.shape[0], d), dtype=vals.dtype,
                       device=vals.device)
    contrib = (c[..., None] * vals).reshape(-1)
    return add_at(grad, lane_flat_indices(idx.to(torch.int64), d), contrib)


def logistic_vjp_rows_ref(idx, vals, b, mask, x):
    """``logistic_vjp_ref`` over sparse rows, as the margin kernel's rows
    mode takes them: idx, vals (W, N, k), b and mask (W, N), x (W, d) ->
    (loss (W,), grad (W, d)).  The masked gather and ``add_at`` of
    ``LogRegProblem._masked_loss_value_and_grad``, its margins summed in
    the kernel's order; duplicate indices in a row add up."""
    margins = -b * _rows_margins(idx, vals, x)
    loss = torch.sum(mask * torch.logaddexp(torch.zeros_like(margins),
                                            margins), dim=-1)
    c = mask * (-b * torch.sigmoid(margins))
    return loss, _rows_grad(idx, vals, c, x.shape[-1])


def svm_vjp_rows_ref(idx, vals, b, mask, x, gamma: float):
    """Smoothed-hinge twin of ``logistic_vjp_rows_ref``: the masked gather
    and ``add_at`` of ``SVMProblem._masked_loss_value_and_grad``."""
    m = b * _rows_margins(idx, vals, x)
    one = torch.ones((), dtype=m.dtype, device=m.device)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    val = torch.where(m >= one, zero,
                      torch.where(m <= one - gamma, one - m - gamma / 2,
                                  (one - m) ** 2 / (2 * gamma)))
    dldm = torch.where(m >= one, zero,
                       torch.where(m <= one - gamma, -one,
                                   -(one - m) / gamma))
    loss = torch.sum(mask * val, dim=-1)
    return loss, _rows_grad(idx, vals, mask * dldm * b, x.shape[-1])


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
