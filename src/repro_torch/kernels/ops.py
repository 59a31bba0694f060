"""Public wrappers around the hand-written kernels.

Dispatch goes by the tensor's device and nothing else: a CPU tensor runs
the plain version in ``ref.py``; a CUDA tensor launches the kernel, and a
kernel that cannot build or launch raises.  Nothing falls back.
``fused_softmax_vjp`` has no kernel, here as in the reference: it runs its
plain version on either device.

The margin wrappers take a leading worker axis: A (W, N, D), b and mask (W, N),
x (W, D) give (loss (W,), grad (W, D)); the unbatched forms drop W.  Shards
are staged unpadded; the kernels mask ragged edges themselves, so no call
copies A.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import logistic_vjp as lv_k
from repro_torch.kernels import ref
from repro_torch.kernels import soft_threshold as st_k
from repro_torch.models import attention as attn_mod


def _margin(A, b, x, mask, *, loss: str, gamma: float):
    single = A.dim() == 2
    if single:
        A, b, x = A[None], b[None], x[None]
        mask = None if mask is None else mask[None]
    if mask is None:
        mask = torch.ones(A.shape[:2], dtype=torch.float32, device=A.device)
    # the kernel runs in float32 whatever the caller's dtype, as the
    # reference's wrapper casts A, b, mask and x into float32 buffers; the
    # results stay float32 (a float64 caller's arithmetic widens them).
    # Callers stage A, b and mask in float32 once, so only x is cast here
    A, b, mask, x = (t.to(torch.float32) for t in (A, b, mask, x))
    if A.is_cuda:
        f, g = lv_k.margin_vjp_cuda(A, b.contiguous(), mask.contiguous(),
                                    x.contiguous(), loss=loss, gamma=gamma)
    elif loss == "logistic":
        f, g = ref.logistic_vjp_ref(A, b, mask, x)
    else:
        f, g = ref.svm_vjp_ref(A, b, mask, x, gamma)
    return (f[0], g[0]) if single else (f, g)


def fused_logistic_vjp(A, b, x, *, mask=None):
    """Loss+grad of sum_n mask_n * log1p(exp(-b_n <a_n, x>)).

    A (N, D), b (N,) ±1, x (D,); ``mask`` an optional {0,1} row mask
    (masked rows contribute exactly zero).  A leading worker axis batches:
    A (W, N, D), b/mask (W, N), x (W, D) -> (loss (W,), grad (W, D)).
    Computed in float32 and returned in float32 for any input dtype."""
    return _margin(A, b, x, mask, loss="logistic", gamma=0.0)


def fused_svm_vjp(A, b, x, *, gamma: float, mask=None):
    """Smoothed-hinge twin of ``fused_logistic_vjp`` (``gamma`` the
    smoothing width).  Same shapes, batching and masking."""
    return _margin(A, b, x, mask, loss="hinge", gamma=float(gamma))


def fused_softmax_vjp(A, y, x, *, n_classes: int, mask=None):
    """Multinomial value+grad with the margin wrappers' contract: A (N, D),
    y (N,) int labels, x the flattened (D·C,) variable, an optional row
    mask; a leading worker axis batches (A (W, N, D), y/mask (W, N), x
    (W, D·C) -> (loss (W,), grad (W, D·C))).

    The reference has no Pallas body here: its wrapper runs the jnp oracle
    in every mode (C is small and the (N, D) @ (D, C) pair needs no kernel
    of its own).  So this runs the plain version, ``ref.softmax_vjp_ref``,
    on CPU and CUDA tensors alike, by design and not as a fallback."""
    if mask is None:
        mask = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    X = x.reshape(x.shape[:-1] + (A.shape[-1], n_classes))
    f, g = ref.softmax_vjp_ref(A, y, mask, X)
    return f, g.reshape(x.shape)


def fused_z_update(omega_bar, z_old, thr: float):
    """z_new = S(omega_bar; thr), ||z_new - z_old||² and nnz(z_new).

    omega_bar, z_old (D,); thr a scalar, rounded to float32."""
    if omega_bar.is_cuda:
        return st_k.soft_threshold_cuda(omega_bar.contiguous(),
                                        z_old.contiguous(), thr)
    return ref.soft_threshold_ref(
        omega_bar, z_old, torch.tensor(thr, dtype=torch.float32))


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q (B,S,H,hd), k/v (B,Skv,KV,hd) -> (B,S,H,hd), in the model's layout
    (no transpose on either path)."""
    if q.is_cuda:
        return fa_k.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    return attn_mod.block_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, positions):
    """q (B,1,H,hd), caches (B,Smax,KV,hd), positions (B,) -> (B,1,H,hd).
    On the card the cache is read in place; positions go as int32."""
    if q.is_cuda:
        return dec_k.decode_attention_cuda(
            q, k_cache, v_cache, positions.to(torch.int32).contiguous())
    return attn_mod.decode_attention(q, k_cache, v_cache, positions)
