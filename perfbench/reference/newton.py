"""Plain OverSketched Newton on sparse rows: the benchmark's reference for
the second-order round, and the comparison that judges it.

Written from Gupta et al., "OverSketched Newton" (arXiv:1903.08857), for
f(z) = sum_i log(1 + exp(-b_i a_i.z)) + lam2/2 ||z||^2: the Hessian
A' = D(z)^(1/2) A (D the logistic weights s(1 - s)) is sketched by n_tasks
independent count-sketch blocks S_k of block_rows = ceil(sketch_dim /
n_blocks) rows each (n_blocks = n_tasks - redundancy); the straggler code
decodes the exact sum of all block Grams, so H = (1 / n_tasks) sum_k
(S_k A')^T (S_k A') + lam2 I; the gradient is exact; the step p solves
H p = -grad (the gradient itself when H is singular or p is no descent
direction), and an Armijo search from alpha = 1 halves alpha up to
``line_search_max`` times (c = 1e-4), keeping the best trial when none
passes.  The residuals are r = ||grad|| and s = ||alpha p||.

The count-sketch hash is copied from the port's ``core/sketch.py``
(``count_sketch_map``: numpy's RandomState seeded [seed, k] for block k),
as it stood when the benchmark was written, so that the reference and the
program sketch with the same map; the program draws its own copy.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# blocks sketched and multiplied at once
BLOCK_CHUNK = 8


def count_sketch_map(n_rows: int, m: int, seed) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Row i of block ``seed`` lands in bucket ``buckets[i]`` with sign
    ``signs[i]``."""
    rng = np.random.RandomState(seed)
    buckets = rng.randint(0, m, size=n_rows).astype(np.int32)
    signs = (rng.randint(0, 2, size=n_rows) * 2 - 1).astype(np.float32)
    return buckets, signs


class Sketch:
    """The blocked count sketch: ``n_tasks`` blocks of ``block_rows``."""

    def __init__(self, n_rows: int, n_tasks: int, sketch_dim: int,
                 redundancy: int, seed: int, device):
        self.n_tasks = n_tasks
        self.n_blocks = n_tasks - redundancy
        self.block_rows = int(math.ceil(sketch_dim / self.n_blocks))
        maps = [count_sketch_map(n_rows, self.block_rows, [seed, k])
                for k in range(n_tasks)]
        self.buckets = torch.as_tensor(np.stack([b for b, _ in maps]),
                                       device=device).long()
        self.signs = torch.as_tensor(np.stack([s for _, s in maps]),
                                     device=device)


def objective(rows, z, lam2: float) -> float:
    idx, vals, b = rows
    m = -b * torch.sum(vals * z[idx], dim=1)
    return float(torch.sum(torch.logaddexp(torch.zeros_like(m), m))
                 + 0.5 * lam2 * torch.dot(z, z))


def newton_round(rows, z, sk: Sketch, lam2: float, ls_max: int, *,
                 dtype=torch.float64, tf32: bool = False) -> dict:
    """One round from z: the gradient, the summed block Grams, the step.
    The sketch and the Grams run in ``dtype`` (TF32 products when
    ``tf32``), the solve and the search in float64 on float64 rows."""
    idx, vals64, b64 = rows
    d = z.shape[0]
    vals, b = vals64.to(dtype), b64.to(dtype)
    zt = z.to(dtype)
    m = -b * torch.sum(vals * zt[idx], dim=1)
    sig = torch.sigmoid(m)
    coef = -b * sig
    g_loss = torch.zeros(d, dtype=dtype, device=z.device)
    g_loss.index_add_(0, idx.reshape(-1), (coef[:, None] * vals).reshape(-1))
    wv = torch.sqrt(sig * (1.0 - sig))[:, None] * vals
    gram = torch.zeros((d, d), dtype=dtype, device=z.device)
    br = sk.block_rows
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for k0 in range(0, sk.n_tasks, BLOCK_CHUNK):
            k1 = min(k0 + BLOCK_CHUNK, sk.n_tasks)
            c = k1 - k0
            dest = (sk.buckets[k0:k1, :, None] * d + idx[None]
                    + (torch.arange(c, device=z.device) * (br * d))
                    [:, None, None])
            sa = torch.zeros(c * br * d, dtype=dtype, device=z.device)
            sa.index_add_(0, dest.reshape(-1),
                          (sk.signs[k0:k1, :, None].to(dtype)
                           * wv[None]).reshape(-1))
            sa = sa.view(c * br, d)
            gram.addmm_(sa.T, sa)
            del sa, dest
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    z64 = z.double()
    grad = g_loss.double() + lam2 * z64
    H = gram.double() / sk.n_tasks
    H.diagonal().add_(lam2)
    sol, info = torch.linalg.solve_ex(H, grad)
    p = -grad if int(info) != 0 else -sol
    if float(grad @ p) >= 0.0:
        p = -grad
    rows64 = (idx, vals64.double(), b64.double())
    f0 = objective(rows64, z64, lam2)
    gtp = float(grad @ p)
    alpha, best_alpha, best_f = 1.0, 1.0, math.inf
    for _ in range(ls_max):
        f_try = objective(rows64, z64 + alpha * p, lam2)
        if f_try <= f0 + 1e-4 * alpha * gtp:
            best_alpha = alpha
            break
        if f_try < best_f:
            best_alpha, best_f = alpha, f_try
        alpha *= 0.5
    step = best_alpha * p
    return dict(grad_sum=g_loss, gram=gram, z_new=z64 + step,
                r_norm=float(torch.linalg.vector_norm(grad)),
                s_norm=float(torch.linalg.vector_norm(step)))


def task_iters(n_rows: int, d: int, sk: Sketch, redundancy: int) -> int:
    """The simulator's cost of a task in row-pass equivalents: r = s + 1
    sketch passes, each a stream over the rows plus the block's Gram."""
    per_block = 1.0 + sk.block_rows * d / max(n_rows, 1)
    return max(1, int(round((redundancy + 1) * per_block)))


def sample_positions(d: int, n: int, seed: int, device):
    """``n`` off-diagonal (i, j) of a d x d matrix, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, d, size=n)
    j = (i + rng.integers(1, d, size=n)) % d
    return (torch.as_tensor(i, device=device),
            torch.as_tensor(j, device=device))


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    num = float(torch.linalg.vector_norm(a - b))
    return 0.0 if num == 0.0 else \
        num / max(float(torch.linalg.vector_norm(b)), 1e-300)


def scalar_rel(a: float, b: float) -> float:
    return 0.0 if a == b else abs(a - b) / max(abs(b), 1e-300)


def gram_entries(gram, pos: Tuple[torch.Tensor, torch.Tensor]):
    """(the sampled off-diagonal entries, the diagonal) of a d x d Gram."""
    return gram[pos[0], pos[1]], torch.diagonal(gram)
