"""Distributed Lasso: least squares + l1, the closed-form-friendly workload —
the counterpart of ``repro.problems.lasso``.

Global problem over the row-partitioned data (A, b):

    min_x  sum_w 0.5 ||A_w x - b_w||^2  +  lam1 ||x||_1

Each worker's augmented subproblem is an unconstrained quadratic, so the
Algorithm-2 body has a direct solve

    x = (A_w^T A_w + rho I)^{-1} (A_w^T b_w + rho (z - u))

from the eigendecomposition of the d x d Gram matrix, factored once per
(wid, W) (``torch.linalg.eigh``, as the reference calls LAPACK outside any
kernel); ``inner_iters`` is 1.  ``direct=False`` runs the shared FISTA
path instead.  The eigenvectors' signs may differ between LAPACK and
cuSOLVER; ``V (V^T rhs) / (lam + rho)`` does not depend on them.

Data, a pure function of (seed, global row index): rows a_i ~ N(0, I_d), a
shared ``density``-sparse ground truth x_true (N(0, 1) values on a uniform
index subset), b_i = <a_i, x_true> + noise * N(0, 1).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import prox
from repro_torch.data import threefry as tf
from repro_torch.data.logreg import shard_rows, top_k_indices
from repro_torch.problems import base


def lasso_direct_all(evals, evecs, Atb, z, us, rho):
    """Every worker's closed-form solve from its cached eigendecomposition:
    x_w = V_w (V_w^T rhs_w) / (lam_w + rho)."""
    rhs = Atb + rho * (z[None, :] - us)                   # (W, d)
    proj = torch.einsum("wdk,wd->wk", evecs, rhs)         # V^T rhs
    return torch.einsum("wdk,wk->wd", evecs, proj / (evals + rho))


class LassoProblem(base.FistaShardProblem):
    """See module docstring.  h(z) = lam1 ||z||_1 at the master."""

    def __init__(self, n_samples: int = 1536, n_features: int = 96, *,
                 density: float = 0.1, noise: float = 0.02,
                 lam1: float = 0.1, seed: int = 0, direct: bool = True,
                 fista=None, fixed_inner=None, dtype="float32",
                 device="cuda"):
        super().__init__(n_samples, n_features, seed=seed, fista=fista,
                         fixed_inner=fixed_inner, dtype=dtype, device=device)
        self.density = float(density)
        self.noise = float(noise)
        self.lam1 = float(lam1)
        self.direct = bool(direct)
        self._factor_cache: Dict[Tuple, Tuple] = {}

    def x_true(self) -> torch.Tensor:
        """The shared sparse ground truth (off-row key stream)."""
        keys = tf.split(self._aux_key(0), 2)
        k_idx, k_val = tf.split_key(keys, 0), tf.split_key(keys, 1)
        d = self.n_features
        nnz = max(1, round(self.density * d))
        # lax.top_k of the uniforms: a uniform nnz-subset, ties to the
        # lower index
        idx = top_k_indices(tf.random_bits(k_idx, d), nnz)
        x = torch.zeros((d,), dtype=torch.float32, device=self.device)
        x[idx] = tf.normal(k_val, nnz)
        return x

    def _gen_shard(self, wid: int, n_workers: int):
        lo, hi = shard_rows(self.total_samples, n_workers, wid)
        sub = tf.split(self._row_keys(lo, hi), 2)
        A = tf.normal(tf.split_key(sub, 0), self.n_features)   # (R, d)
        eps = tf.normal(tf.split_key(sub, 1), 0)                # (R,)
        b = A @ self.x_true() + self.noise * eps
        return A.to(self.dtype), b.to(self.dtype)

    def _loss_value_and_grad(self, shard):
        A, b = shard

        def vg(x):
            r = A @ x - b
            return 0.5 * torch.dot(r, r), A.T @ r
        return vg

    def _masked_loss_value_and_grad(self, batch, mask):
        # zero-padded rows already have r = 0; the mask keeps it exact
        A, b = batch                                 # (W, N, d), (W, N)

        def vg(X):
            r = mask * (torch.bmm(A, X[..., None])[..., 0] - b)
            return (0.5 * torch.sum(r * r, dim=-1),
                    torch.bmm(r[:, None, :], A)[:, 0, :])
        return vg

    def _factor(self, wid: int, n_workers: int):
        key = (wid, n_workers)
        if key not in self._factor_cache:
            A, b = self._shard(wid, n_workers)
            evals, evecs = torch.linalg.eigh(A.T @ A)
            self._factor_cache[key] = (evals, evecs, A.T @ b)
        return self._factor_cache[key]

    def _rho(self, rho) -> torch.Tensor:
        return torch.tensor(rho, dtype=self.dtype, device=self.device)

    def solve(self, wid, n_workers, x0, z, u, rho):
        if not self.direct:
            return super().solve(wid, n_workers, x0, z, u, rho)
        evals, evecs, Atb = self._factor(wid, n_workers)
        rho = self._rho(rho)
        rhs = Atb + rho * (z - u)
        x_new = evecs @ ((evecs.T @ rhs) / (evals + rho))
        return x_new.to(self.dtype), 1

    # -- batched engine: all W Gram factors stacked, one solve per round ----
    def _batched_factor(self, n_workers: int):
        key = ("batch", n_workers)
        if key not in self._factor_cache:
            (A, b), _ = self.batch_shards(n_workers)   # pad rows are 0
            evals, evecs = torch.linalg.eigh(
                torch.einsum("wnd,wne->wde", A, A))
            Atb = torch.einsum("wnd,wn->wd", A, b)
            self._factor_cache[key] = (evals, evecs, Atb)
        return self._factor_cache[key]

    def solve_all(self, xs, us, z, rho, kernel: str = "torch"):
        # the direct path has no streaming loss to fuse, so kernel="cuda"
        # leaves the worker side alone (the master's fused z-update still
        # applies); direct=False hands the kwarg to the FISTA engine
        if not self.direct:
            return super().solve_all(xs, us, z, rho, kernel=kernel)
        n_workers = int(xs.shape[0])
        evals, evecs, Atb = self._batched_factor(n_workers)
        x_new = lasso_direct_all(evals, evecs, Atb, z, us, self._rho(rho))
        return x_new.to(self.dtype), np.ones(n_workers, np.int64)

    def prox_h(self, v, t):
        return prox.prox_l1(v, t, self.lam1)

    @property
    def h_l1_lam(self):
        return self.lam1

    def h_value(self, z) -> float:
        return self.lam1 * float(torch.sum(torch.abs(z)))


base.register("lasso", LassoProblem)
