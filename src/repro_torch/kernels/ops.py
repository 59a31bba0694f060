"""Public wrappers around the hand-written kernels.

Dispatch goes by the tensor's device and nothing else: a CPU tensor runs
the plain version in ``ref.py``; a CUDA tensor launches the kernel, and a
kernel that cannot build or launch raises.  Nothing falls back.

Every wrapper takes a leading worker axis: A (W, N, D), b and mask (W, N),
x (W, D) give (loss (W,), grad (W, D)); the unbatched forms drop W.  Shards
are staged unpadded; the kernels mask ragged edges themselves, so no call
copies A.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import logistic_vjp as lv_k
from repro_torch.kernels import ref
from repro_torch.kernels import soft_threshold as st_k


def _margin(A, b, x, mask, *, loss: str, gamma: float):
    single = A.dim() == 2
    if single:
        A, b, x = A[None], b[None], x[None]
        mask = None if mask is None else mask[None]
    if mask is None:
        mask = torch.ones(A.shape[:2], dtype=A.dtype, device=A.device)
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

    A (N, D) f32, b (N,) ±1, x (D,); ``mask`` an optional {0,1} row mask
    (masked rows contribute exactly zero).  A leading worker axis batches:
    A (W, N, D), b/mask (W, N), x (W, D) -> (loss (W,), grad (W, D))."""
    return _margin(A, b, x, mask, loss="logistic", gamma=0.0)


def fused_svm_vjp(A, b, x, *, gamma: float, mask=None):
    """Smoothed-hinge twin of ``fused_logistic_vjp`` (``gamma`` the
    smoothing width).  Same shapes, batching and masking."""
    return _margin(A, b, x, mask, loss="hinge", gamma=float(gamma))


def fused_z_update(omega_bar, z_old, thr: float):
    """z_new = S(omega_bar; thr), ||z_new - z_old||² and nnz(z_new).

    omega_bar, z_old (D,); thr a scalar, rounded to float32."""
    if omega_bar.is_cuda:
        return st_k.soft_threshold_cuda(omega_bar.contiguous(),
                                        z_old.contiguous(), thr)
    return ref.soft_threshold_ref(
        omega_bar, z_old, torch.tensor(thr, dtype=torch.float32))
