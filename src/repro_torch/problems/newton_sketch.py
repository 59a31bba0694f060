"""The ``logreg_l2`` workload: l2-regularized logistic regression — the
counterpart of ``LogRegL2Problem`` in ``repro.problems.newton_sketch``.

In the reference this module holds the OverSketched Newton workload
(``newton_sketch``) and its first-order ADMM twin, ``logreg_l2``, which
solves the same objective on the same rows,

    f(z) = sum_i log(1 + exp(-b_i a_i^T z)) + (lam2/2) ||z||^2 .

Only the twin is ported here; ``NewtonSketchProblem`` waits for the
second-order path (``core/sketch.py``, ``core/coding.py`` and the
scheduler's Newton round; ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.logreg_paper import scaled
from repro_torch.problems import base
from repro_torch.problems.logreg import LogRegProblem


class LogRegL2Problem(LogRegProblem):
    """logreg with h(z) = (lam2/2)||z||², prox_h(v, t) = v / (1 + t·lam2).
    No l1 term, so the scheduler never fuses the z-update."""

    h_l1_lam = None        # shadows the parent's property

    def __init__(self, logreg_cfg, *, lam2: float = 1e-3, **kw):
        super().__init__(logreg_cfg, **kw)
        self.lam2 = float(lam2)

    def prox_h(self, v, t):
        return v / (1.0 + t * self.lam2)

    def h_value(self, z) -> float:
        return 0.5 * self.lam2 * float(torch.dot(z, z))


@base.register("logreg_l2")
def make_logreg_l2(n_samples: int = 2048, n_features: int = 128,
                   density: float = 0.05, lam2: float = 1e-3,
                   seed: int = 0, fista=None,
                   fixed_inner: Optional[int] = None,
                   dtype="float32", device="cuda") -> LogRegL2Problem:
    """The same canonical instance as ``logreg`` (lam1=0; the l2 term
    lives in prox_h)."""
    if fista is None:
        fista = dict(min_iters=1, eps_grad=1e-3)
    cfg = scaled(n_samples, n_features, density=density, lam1=0.0,
                 seed=seed)
    return LogRegL2Problem(cfg, lam2=lam2,
                           fista=base.as_fista_options(fista),
                           fixed_inner=fixed_inner,
                           dtype=base.as_dtype(dtype), device=device)
