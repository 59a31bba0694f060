"""Sparse linear SVM via the smoothed (Huberized) hinge loss — the
counterpart of ``repro.problems.svm``.

Global problem over the Koh-Kim-Boyd sparse shards (the same generator as
the logreg workload, so the two run on identical data):

    min_x  sum_n  l_gamma(b_n <a_n, x>)  +  lam1 ||x||_1

with the quadratically smoothed hinge

    l_gamma(m) = 0                      m >= 1
               = (1 - m)^2 / (2 gamma)  1 - gamma < m < 1
               = 1 - m - gamma/2        m <= 1 - gamma

Engines as for logreg: the loop engine gathers and scatters on one sparse
shard; the batched engine runs all W lanes on the stacked sparse shards
(``kernel="torch"``) or on dense shards staged once on the device for the
fused margin kernel's hinge instantiation (``kernel="cuda"``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.logreg_paper import scaled
from repro_torch.core import prox
from repro_torch.data.logreg import worker_shard_sparse
from repro_torch.kernels import ops
from repro_torch.problems import base


def hinge_terms(m: torch.Tensor, gamma: float):
    """(l_gamma(m), l_gamma'(m)) elementwise, in the reference's float
    steps (constants rounded to m's dtype)."""
    one = torch.ones((), dtype=m.dtype, device=m.device)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    val = torch.where(m >= one, zero,
                      torch.where(m <= one - gamma, one - m - gamma / 2,
                                  (one - m) ** 2 / (2 * gamma)))
    dldm = torch.where(m >= one, zero,
                       torch.where(m <= one - gamma, -one,
                                   -(one - m) / gamma))
    return val, dldm


class SVMProblem(base.FistaShardProblem):
    """See module docstring.  h(z) = lam1 ||z||_1 at the master."""

    def __init__(self, n_samples: int = 1536, n_features: int = 96, *,
                 density: float = 0.05, lam1: float = 0.05,
                 smoothing: float = 0.5, seed: int = 0, fista=None,
                 fixed_inner=None, dtype="float32", device="cuda"):
        super().__init__(n_samples, n_features, seed=seed, fista=fista,
                         fixed_inner=fixed_inner, dtype=dtype, device=device)
        self.lam1 = float(lam1)
        self.smoothing = float(smoothing)
        # the KKB generator's config record is the addressing scheme
        self._data_cfg = scaled(n_samples, n_features, density=density,
                                lam1=lam1, seed=seed)

    def _gen_shard(self, wid: int, n_workers: int):
        idx, vals, b = worker_shard_sparse(self._data_cfg, wid, n_workers,
                                           device=self.device)
        return idx, vals.to(self.dtype), b.to(self.dtype)

    def _loss_value_and_grad(self, shard):
        idx, vals, b = shard
        gamma = self.smoothing
        flat_idx = idx.reshape(-1)

        def vg(x):
            m = b * torch.sum(vals * x[idx], dim=-1)         # margins (N,)
            val, dldm = hinge_terms(m, gamma)
            contrib = ((dldm * b)[:, None] * vals).reshape(-1)
            grad = torch.zeros_like(x).index_add_(0, flat_idx, contrib)
            return torch.sum(val), grad
        return vg

    def _masked_loss_value_and_grad(self, batch, mask):
        # padded rows (vals=0, b=0) sit at margin 0 inside the linear
        # branch: the mask zeroes their value; their scatter is already 0
        idx, vals, b = batch                         # (W, N, k), (W, N)
        W = idx.shape[0]
        gamma = self.smoothing
        flat_idx = idx.reshape(W, -1)

        def vg(X):
            m = b * torch.sum(vals * X.gather(1, flat_idx).view(idx.shape),
                              dim=-1)                        # (W, N)
            val, dldm = hinge_terms(m, gamma)
            contrib = ((mask * dldm * b)[..., None] * vals).reshape(W, -1)
            grad = torch.zeros_like(X).scatter_add_(1, flat_idx, contrib)
            return torch.sum(mask * val, dim=-1), grad
        return vg

    # -- fused-kernel path (SchedulerConfig(kernel="cuda")) -----------------
    def kernel_batch_shards(self, n_workers: int):
        """Dense twin of ``batch_shards`` for the margin kernel (see
        ``base.dense_kernel_batch``)."""
        return base.dense_kernel_batch(self, n_workers)

    def _masked_kernel_loss_value_and_grad(self, batch, mask):
        A, b = batch
        gamma = self.smoothing

        def vg(X):
            return ops.fused_svm_vjp(A, b, X, gamma=gamma, mask=mask)
        return vg

    def prox_h(self, v, t):
        return prox.prox_l1(v, t, self.lam1)

    @property
    def h_l1_lam(self):
        return self.lam1

    def h_value(self, z) -> float:
        return self.lam1 * float(torch.sum(torch.abs(z)))


base.register("svm", SVMProblem)
