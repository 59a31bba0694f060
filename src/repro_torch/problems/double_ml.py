"""Double Machine Learning (partially linear model) as a phase-structured
workload — the counterpart of ``repro.problems.double_ml``.  K-fold
cross-fitted nuisance regressions fan out, a one-dimensional combine stage
computes the debiased treatment effect.

The statistical model (Chernozhukov et al.'s partially linear regression):

    Y = theta0 * D + g0(X) + eps        (outcome)
    D = m0(X) + v                       (treatment, confounded through X)

Regressing Y on D alone is biased by the confounding (m0 and g0 share
support by construction).  Cross-fitting removes it: split the n rows into
K folds (row i is in fold i % K); for each fold k fit both nuisances on the
complement (lasso regressions of Y on X and of D on X), predict them out of
fold, and solve the partialling-out score on the residuals:

    theta_hat = sum_i d~_i y~_i / sum_i d~_i^2,
    y~_i = Y_i - X_i beta_y^(fold i),   d~_i = D_i - X_i beta_d^(fold i)

One registered factory, two roles:

* ``role="nuisance"`` (default): the lasso regression of ``target`` ("y" or
  "d") on X over the complement of ``fold``; wire messages are p-vectors,
  both engines and the fused l1 z-update apply.
* ``role="combine"``: the one-dimensional residual least squares.
  ``consume_stage_results`` takes the nuisance stages' ``StageResult``s at
  dispatch and reads each fitted beta and its (target, fold) from the
  stage's own spec.  Without inputs the betas stay zero and it computes the
  naive, biased estimate.

Every instance regenerates the same data from (seed, global row index),
drawn by ``data.threefry`` as the reference draws it (``fold_in``,
``split``, ``uniform``, ``top_k``, ``normal``): the row keys and the
coefficient draws are keyed off the full n, so all 2K+1 stage problems see
one dataset.  The draws are float32 (normals within 3 ulp of the
reference's); a float64 problem widens them.

``double_ml_dag(...)`` builds the ready-to-submit ``DagSpec``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import prox
from repro_torch.data import threefry as tf
from repro_torch.data.logreg import shard_rows, top_k_indices
from repro_torch.problems import base

ROLES = ("nuisance", "combine")
TARGETS = ("y", "d")


class DoubleMLProblem(base.FistaShardProblem):
    """See module docstring.  ``n_samples``/``n_features`` describe the
    full dataset (n rows, p covariates) for both roles; the wire dimension
    is p for nuisance stages and 1 for the combine stage."""

    def __init__(self, n_samples: int = 1024, n_features: int = 24, *,
                 role: str = "nuisance", target: str = "y", fold: int = 0,
                 n_folds: int = 4, theta: float = 1.5,
                 density: float = 0.25, confound: float = 0.6,
                 noise_d: float = 1.0, noise_y: float = 0.5,
                 lam1: float = 0.02, seed: int = 0, fista=None,
                 fixed_inner=None, dtype="float32", device="cuda"):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if target not in TARGETS:
            raise ValueError(f"target must be one of {TARGETS}, "
                             f"got {target!r}")
        if n_folds < 2:
            raise ValueError("n_folds must be >= 2 (cross-fitting)")
        if not 0 <= fold < n_folds:
            raise ValueError(f"fold must be in [0, {n_folds}), got {fold}")
        self.full_n = int(n_samples)
        self.p = int(n_features)
        self.role = role
        self.target = target
        self.fold = int(fold)
        self.n_folds = int(n_folds)
        self.theta = float(theta)
        self.density = float(density)
        self.confound = float(confound)
        self.noise_d = float(noise_d)
        self.noise_y = float(noise_y)
        self.lam1 = float(lam1)
        every = np.arange(self.full_n, dtype=np.int64)
        if role == "nuisance":
            # train on the complement of `fold`
            rows = every[every % self.n_folds != self.fold]
            wire_d = self.p
        else:
            rows = every
            wire_d = 1
        super().__init__(len(rows), wire_d, seed=seed, fista=fista,
                         fixed_inner=fixed_inner, dtype=dtype, device=device)
        self._rows = rows
        # out-of-fold nuisance coefficients, filled by
        # consume_stage_results (combine role); zeros = naive estimate
        self._beta = {t: np.zeros((self.n_folds, self.p), np.float64)
                      for t in TARGETS}
        self._coef_cache = None

    # -- the shared data model (pure function of seed + global row) --------

    def _dml_aux_key(self, tag: int) -> tf.Key:
        """Off-row draws keyed past the full n (not total_samples, which
        depends on the role) so every stage instance agrees."""
        return tf.fold_in(tf.prng_key(self.seed, device=self.device),
                          self.full_n + tag)

    def _sparse_vec(self, key: tf.Key) -> torch.Tensor:
        keys = tf.split(key, 2)
        k_idx, k_val = tf.split_key(keys, 0), tf.split_key(keys, 1)
        nnz = max(1, round(self.density * self.p))
        idx = top_k_indices(tf.random_bits(k_idx, self.p), nnz)
        v = torch.zeros((self.p,), dtype=torch.float32, device=self.device)
        v[idx] = tf.normal(k_val, nnz)
        return v

    def coefs(self):
        """(g0, m0): outcome and treatment coefficients, float32.  m0 mixes
        g0's direction with an independent one, so D and g0(X) correlate —
        the confounding that biases the naive regression."""
        if self._coef_cache is None:
            g = self._sparse_vec(self._dml_aux_key(1))
            h = self._sparse_vec(self._dml_aux_key(2))
            m = self.confound * g + self.confound * h
            self._coef_cache = (g, m)
        return self._coef_cache

    def _gen_rows(self, idx: np.ndarray):
        """(X, D, Y) for the given global row indices, float32."""
        g, m = self.coefs()
        keys = tf.fold_in(tf.prng_key(self.seed, device=self.device),
                          torch.as_tensor(idx, device=self.device))
        sub = tf.split(keys, 3)
        kx, kd, ky = (tf.split_key(sub, j) for j in range(3))
        X = tf.normal(kx, self.p)                             # (R, p)
        V = tf.normal(kd, 0)                                  # (R,)
        E = tf.normal(ky, 0)
        D = X @ m + self.noise_d * V
        Y = self.theta * D + X @ g + self.noise_y * E
        return X, D, Y

    # -- stage handoff (combine role) ---------------------------------------

    def consume_stage_results(self, inputs: Dict[str, object]):
        """Receive the nuisance stages' ``StageResult``s (the cluster calls
        this at combine dispatch).  Each input's (target, fold) is read from
        its own spec's problem_kwargs: names don't matter."""
        if self.role != "combine":
            raise RuntimeError("only the combine role consumes stage "
                               "results")
        for name, sr in inputs.items():
            kw = dict(sr.result.spec.problem_kwargs)
            if kw.get("role", "nuisance") != "nuisance":
                continue
            target = kw.get("target", "y")
            fold = int(kw.get("fold", 0))
            if not 0 <= fold < self.n_folds:
                raise ValueError(f"stage {name!r}: fold {fold} out of "
                                 f"range for n_folds={self.n_folds}")
            beta = np.asarray(sr.z, np.float64)
            if beta.shape != (self.p,):
                raise ValueError(f"stage {name!r}: nuisance solution has "
                                 f"shape {beta.shape}, expected "
                                 f"({self.p},)")
            self._beta[target][fold] = beta
        # residuals changed: drop every cached shard and stacked batch
        self._shard_cache.clear()
        self._batch_cache = None
        self._kernel_batch_cache = None

    # -- shards -------------------------------------------------------------

    def _gen_shard(self, wid: int, n_workers: int):
        lo, hi = shard_rows(self.total_samples, n_workers, wid)
        idx = self._rows[lo:hi]
        X, D, Y = self._gen_rows(idx)
        if self.role == "nuisance":
            t = Y if self.target == "y" else D
            return X.to(self.dtype), t.to(self.dtype)
        folds = torch.as_tensor(idx % self.n_folds, device=self.device)
        by = torch.as_tensor(self._beta["y"], dtype=torch.float32,
                             device=self.device)[folds]       # (m, p)
        bd = torch.as_tensor(self._beta["d"], dtype=torch.float32,
                             device=self.device)[folds]
        y_t = Y - torch.sum(X * by, dim=1)
        d_t = D - torch.sum(X * bd, dim=1)
        return d_t.to(self.dtype), y_t.to(self.dtype)

    # -- losses -------------------------------------------------------------

    def _loss_value_and_grad(self, shard):
        if self.role == "nuisance":
            A, b = shard

            def vg(x):
                r = A @ x - b
                return 0.5 * torch.dot(r, r), A.T @ r
            return vg
        d_t, y_t = shard

        def vg(th):
            r = d_t * th[0] - y_t
            return 0.5 * torch.dot(r, r), torch.dot(d_t, r)[None]
        return vg

    def _masked_loss_value_and_grad(self, batch, mask):
        if self.role == "nuisance":
            A, b = batch                             # (W, N, p), (W, N)

            def vg(X):
                r = mask * (torch.bmm(A, X[..., None])[..., 0] - b)
                return (0.5 * torch.sum(r * r, dim=-1),
                        torch.bmm(r[:, None, :], A)[:, 0, :])
            return vg
        d_t, y_t = batch                             # (W, N) each

        def vg(X):
            r = mask * (d_t * X[:, :1] - y_t)
            return (0.5 * torch.sum(r * r, dim=-1),
                    torch.sum(d_t * r, dim=-1)[:, None])
        return vg

    # -- master regularizer -------------------------------------------------

    def prox_h(self, v, t):
        if self.role == "nuisance":
            return prox.prox_l1(v, t, self.lam1)
        return v                         # h = 0 for the scalar theta

    @property
    def h_l1_lam(self) -> Optional[float]:
        return self.lam1 if self.role == "nuisance" else None

    def h_value(self, z) -> float:
        if self.role == "nuisance":
            return self.lam1 * float(torch.sum(torch.abs(z)))
        return 0.0

    # -- reporting helpers --------------------------------------------------

    def closed_form_theta(self) -> float:
        """The exact partialling-out estimate under the current betas
        (zeros until consume_stage_results): sum d~ y~ / sum d~^2 over all
        n rows.  What the combine stage's ADMM converges to."""
        if self.role != "combine":
            raise RuntimeError("combine role only")
        num = den = 0.0
        for w in range(4):               # stream in 4 chunks
            d_t, y_t = self._gen_shard(w, 4)
            num += float(torch.dot(d_t, y_t))
            den += float(torch.dot(d_t, d_t))
        return num / den


def double_ml_dag(*, n_samples: int = 1024, n_features: int = 24,
                  n_folds: int = 4, theta: float = 1.5,
                  density: float = 0.25, confound: float = 0.6,
                  noise_d: float = 1.0, noise_y: float = 0.5,
                  lam1: float = 0.02, seed: int = 0,
                  nuisance_workers: int = 2, combine_workers: int = 1,
                  nuisance_rounds: int = 5, combine_rounds: int = 4,
                  pool_seed: int = 0, warm_provider: bool = False,
                  label: str = "double_ml"):
    """The ready-to-submit ``DagSpec``: 2K nuisance stages (both targets x
    K folds, ``nuisance_workers`` each) fanning into one ``combine`` stage.
    Submit with ``api.submit_dag``; the estimate is
    ``run.stage_results["combine"].z[0]`` after ``run_all()``.

    ``warm_provider=True`` backs every stage's pool with the keep-alive
    provider, so a cluster with ``share_provider=True`` can warm-start later
    stages on the fan-out's retired sandboxes."""
    from repro_torch.api import ExperimentSpec           # lazy: no cycle
    from repro_torch.runtime.cluster import DagSpec, StageSpec
    from repro_torch.runtime.pool import PoolConfig, ProviderConfig
    from repro_torch.runtime.scheduler import SchedulerConfig

    common = dict(n_samples=n_samples, n_features=n_features,
                  n_folds=n_folds, theta=theta, density=density,
                  confound=confound, noise_d=noise_d, noise_y=noise_y,
                  lam1=lam1, seed=seed)

    def pool():
        if warm_provider:
            return PoolConfig(seed=pool_seed,
                              provider=ProviderConfig(enabled=True))
        return PoolConfig(seed=pool_seed)

    stages = []
    for k in range(n_folds):
        for tgt in TARGETS:
            stages.append(StageSpec(
                name=f"nuis_{tgt}{k}",
                spec=ExperimentSpec(
                    problem="double_ml",
                    problem_kwargs={**common, "role": "nuisance",
                                    "target": tgt, "fold": k},
                    scheduler=SchedulerConfig(
                        n_workers=nuisance_workers, replication=1,
                        pool=pool()),
                    max_rounds=nuisance_rounds,
                    label=f"{label}/nuis_{tgt}{k}")))
    stages.append(StageSpec(
        name="combine",
        spec=ExperimentSpec(
            problem="double_ml",
            problem_kwargs={**common, "role": "combine"},
            scheduler=SchedulerConfig(
                n_workers=combine_workers, replication=1,
                pool=pool()),
            max_rounds=combine_rounds,
            label=f"{label}/combine"),
        after=tuple(s.name for s in stages)))
    return DagSpec(stages=tuple(stages), label=label)


base.register("double_ml", DoubleMLProblem)
