"""The paper's workload: l1-logistic regression on sparse Koh-Kim-Boyd
shards (Section III) — the counterpart of ``repro.problems.logreg``.

Two engines share the data:
  * the loop engine solves one worker at a time on its sparse shard
    (gather for the margins, ``data.logreg.add_at`` for the gradient);
  * the batched engine runs all W workers as lanes of one FISTA, either
    on the stacked sparse shards (``kernel="torch"``) or on the same
    shards staged once on the device as the fused margin kernel's rows
    mode reads them (``kernel="cuda"``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.logreg_paper import LogRegConfig, scaled
from repro_torch.core import prox
from repro_torch.core.fista import FistaOptions
from repro_torch.data import logreg as data_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.problems import base


class LogRegProblem(base.BatchedShardProblem):
    """l1-logistic regression on sparse Koh-Kim-Boyd shards.

    The batched path's ``_masked_loss_value_and_grad`` is the masked twin
    of ``data.logreg.sparse_logistic_value_and_grad``: zero-padded rows
    have vals=0, so their gradient scatter is exactly 0, and the mask
    zeroes their log(2) value."""

    def __init__(self, logreg_cfg: LogRegConfig, *,
                 fista: FistaOptions = FistaOptions(),
                 fixed_inner: Optional[int] = None,
                 dtype=torch.float32, device="cuda"):
        self.cfg = logreg_cfg
        self.fista = fista
        self.fixed_inner = fixed_inner
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_features = logreg_cfg.n_features
        self._shard_cache: Dict[Tuple[int, int], Tuple] = {}

    def n_samples(self, wid: int, n_workers: int) -> int:
        lo, hi = data_mod.shard_rows(self.cfg.n_samples, n_workers, wid)
        return hi - lo

    def _shard(self, wid: int, W: int):
        key = (wid, W)
        if key not in self._shard_cache:
            idx, vals, b = self._load_or_gen(wid, W)
            self._shard_cache[key] = (idx, vals.to(self.dtype),
                                      b.to(self.dtype))
        return self._shard_cache[key]

    def _load_or_gen(self, wid: int, W: int):
        """Worker ``wid``'s shard, cached on disk when ``REPRO_DATA_CACHE``
        names a directory (off otherwise): the reference's file names and
        ``.npz`` keys (idx int32, vals and b float32, as the reference
        writes them), so each package reads the other's cache."""
        cache_dir = os.environ.get("REPRO_DATA_CACHE", "")
        if not cache_dir:
            return data_mod.worker_shard_sparse(self.cfg, wid, W,
                                                device=self.device)
        c = self.cfg
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"logreg_n{c.n_samples}_d"
                            f"{c.n_features}_p{c.density}_s{c.seed}_w{wid}"
                            f"of{W}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return (torch.as_tensor(z["idx"].astype(np.int64)
                                        ).to(self.device),
                        torch.as_tensor(z["vals"]).to(self.device),
                        torch.as_tensor(z["b"]).to(self.device))
        idx, vals, b = data_mod.worker_shard_sparse(c, wid, W,
                                                    device=self.device)
        np.savez(path, idx=idx.cpu().numpy().astype(np.int32),
                 vals=vals.cpu().numpy(), b=b.cpu().numpy())
        return idx, vals, b

    def _sparse_vg(self, wid: int, n_workers: int):
        idx, vals, b = self._shard(wid, n_workers)
        return data_mod.sparse_logistic_value_and_grad(idx, vals, b,
                                                       self.cfg.n_features)

    def solve(self, wid, n_workers, x0, z, u, rho):
        return base.solve_one(self._sparse_vg(wid, n_workers), x0, z, u,
                              rho, self)

    def _masked_loss_value_and_grad(self, batch, mask):
        idx, vals, b = batch                         # (W, N, k), (W, N)
        W = idx.shape[0]
        d = self.cfg.n_features
        flat_idx = idx.reshape(W, -1)
        grad_idx = data_mod.lane_flat_indices(idx, d)

        def vg(X):
            ax = torch.sum(vals * X.gather(1, flat_idx).view(idx.shape),
                           dim=-1)                   # (W, N)
            margins = -b * ax
            f = torch.sum(mask * torch.logaddexp(torch.zeros_like(margins),
                                                 margins), dim=-1)
            coef = mask * (-b * torch.sigmoid(margins))
            contrib = (coef[..., None] * vals).reshape(-1)
            grad = torch.zeros((W, d), dtype=X.dtype, device=X.device)
            return f, data_mod.add_at(grad, grad_idx, contrib)
        return vg

    # -- fused-kernel path (SchedulerConfig(kernel="cuda")) -----------------
    def kernel_batch_shards(self, n_workers: int):
        """The stacked shards staged as the margin kernel's rows mode reads
        them (see ``base.sparse_kernel_batch``)."""
        return base.sparse_kernel_batch(self, n_workers)

    def _masked_kernel_loss_value_and_grad(self, batch, mask):
        def vg(X):
            return ops.fused_logistic_vjp_rows(batch, X, mask=mask)
        return vg

    def prox_h(self, v, t):
        return prox.prox_l1(v, t, self.cfg.lam1)

    @property
    def h_l1_lam(self):
        """prox_h is soft-thresholding at lam1*t: exposing lam1 lets the
        scheduler fuse the z-update (kernel="cuda")."""
        return self.cfg.lam1

    def objective(self, x, n_workers: int) -> float:
        """Full phi(x) for convergence reporting."""
        total = self.h_value(x)
        for w in range(n_workers):
            total += self.local_value(w, n_workers, x)
        return total

    def h_value(self, z) -> float:
        return self.cfg.lam1 * float(torch.sum(torch.abs(z)))

    def local_value(self, wid: int, n_workers: int, x) -> float:
        f, _ = self._sparse_vg(wid, n_workers)(x)
        return float(f)


@base.register("logreg")
def make_logreg(n_samples: int = 2048, n_features: int = 128,
                density: float = 0.05, lam1: float = 0.3, seed: int = 0,
                fista=None, fixed_inner: Optional[int] = None,
                dtype="float32", device="cuda") -> LogRegProblem:
    """Factory for the registry, with the reference's defaults (the
    instance ``tests/test_api.py::SEED_ANCHOR`` pins).  Pass
    n_samples=600_000, n_features=10_000, density=0.001, lam1=1.0 for the
    paper's instance.  ``fista`` defaults to dict(min_iters=1,
    eps_grad=1e-3); pass ``fista={}`` for plain FistaOptions()."""
    if fista is None:
        fista = dict(min_iters=1, eps_grad=1e-3)
    cfg = scaled(n_samples, n_features, density=density, lam1=lam1,
                 seed=seed)
    return LogRegProblem(cfg, fista=base.as_fista_options(fista),
                         fixed_inner=fixed_inner, dtype=base.as_dtype(dtype),
                         device=device)
