"""Synthetic l1-logistic-regression data (Koh-Kim-Boyd, Section III of the
paper), generated on the device and bit-faithful to ``repro.data.logreg``.

Per sample n, from the key ``fold_in(PRNGKey(seed), n)`` split four ways:
  * label b_n = ±1 with probability 1/2,
  * k = round(p*d) distinct feature indices: the top k of d iid uniforms,
  * values ~ N(nu_n, 1) with nu_n ~ U[0,1] for b=+1, U[-1,0] for b=-1.

Sample identity is tied to the global row index, so any worker (or any
fleet size) regenerates exactly its own rows.  ``idx`` and ``b`` equal the
reference's bit for bit; ``vals`` agree to 2 ulp, because the normal draw
goes through float32 erfinv (see ``threefry.erfinv_f32``).

Ties: ``lax.top_k`` orders equal uniforms by the lower index first.  The
uniform is a 23-bit integer m scaled by 2**-23, so ranking the integer
``m * 2**s + (2**s - 1 - j)`` (2**s >= d) orders by value and then by
index with no ties left, and ``torch.topk`` on it gives the reference's
indices in the reference's order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.logreg_paper import LogRegConfig
from repro_torch.data import threefry as tf
from repro_torch.device import deterministic

# elements of the (rows, d) uniform draw generated at once; bounds the
# int64 temporaries of the hash to a few hundred MB each
CHUNK_ELEMENTS = 1 << 25


def shard_rows(n_samples: int, n_workers: int, w: int) -> Tuple[int, int]:
    """Row range [lo, hi) for worker w under near-even split."""
    base, rem = divmod(n_samples, n_workers)
    lo = w * base + min(w, rem)
    hi = lo + base + (1 if w < rem else 0)
    return lo, hi


def _row_keys(cfg: LogRegConfig, lo: int, hi: int, device=None) -> tf.Key:
    base = tf.prng_key(cfg.seed, device=device)
    return tf.fold_in(base, torch.arange(lo, hi, device=device))


def _gen_row_sparse(keys: tf.Key, d: int, k: int):
    """Rows in sparse form, one per key: (idx (R, k) int64, vals (R, k)
    f32, b (R,) ±1 f32)."""
    sub = tf.split(keys, 4)
    kb, knu, kidx, kval = (tf.split_key(sub, j) for j in range(4))
    b = torch.where(tf.bernoulli_half(kb), 1.0, -1.0).to(torch.float32)
    nu = tf.uniform(knu) * b
    idx = top_k_indices(tf.random_bits(kidx, d), k)
    vals = nu[:, None] + tf.normal(kval, k)
    return idx, vals, b


def top_k_indices(bits: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(uniform, k)[1]`` over the last axis of the uniforms the
    32-bit draws ``bits`` give: ranked by value, ties to the lower index."""
    d = bits.shape[-1]
    shift = max(1, (d - 1).bit_length())
    rank = (tf.mantissa(bits) << shift) | (
        (1 << shift) - 1 - torch.arange(d, device=bits.device))
    return torch.topk(rank, k, dim=-1).indices


def worker_shard_sparse(cfg: LogRegConfig, w: int, n_workers: int,
                        device=None):
    """Worker w's rows in sparse (idx, vals, b) form, generated on
    ``device`` in row chunks.  The paper instance (N=600 000, d=10 000)
    draws 6·10⁹ uniforms in all; a chunk holds ``CHUNK_ELEMENTS``."""
    lo, hi = shard_rows(cfg.n_samples, n_workers, w)
    d = cfg.n_features
    k = max(1, round(cfg.density * d))
    step = max(1, CHUNK_ELEMENTS // d)
    parts = [_gen_row_sparse(_row_keys(cfg, r, min(r + step, hi), device),
                             d, k)
             for r in range(lo, hi, step)]
    if not parts:
        return (torch.zeros((0, k), dtype=torch.int64, device=device),
                torch.zeros((0, k), dtype=torch.float32, device=device),
                torch.zeros((0,), dtype=torch.float32, device=device))
    return tuple(torch.cat(p) for p in zip(*parts))


def worker_shard(cfg: LogRegConfig, w: int, n_workers: int, device=None):
    """Worker w's rows dense: the rows of ``worker_shard_sparse`` scattered
    into a (rows, d) float32 A, zero off the selected indices, and b."""
    idx, vals, b = worker_shard_sparse(cfg, w, n_workers, device=device)
    A = torch.zeros((idx.shape[0], cfg.n_features), dtype=torch.float32,
                    device=idx.device)
    return A.scatter_(1, idx, vals), b


def add_at(out: torch.Tensor, index: torch.Tensor,
           src: torch.Tensor) -> torch.Tensor:
    """``out.view(-1)[index] += src`` over flat indices, duplicates summed
    in a fixed order, so the result repeats bit for bit: on the CPU one
    serial pass in element order, on CUDA a stable sort of the indices and
    a sum over each run of equal indices in sorted order (``index_put_``
    with ``accumulate=True`` under deterministic algorithms; float atomics,
    as ``index_add_`` and ``scatter_add_`` use, sum in arrival order).
    Returns ``out``."""
    with deterministic():
        out.view(-1).index_put_((index,), src, accumulate=True)
    return out


def sparse_logistic_value_and_grad(idx: torch.Tensor, vals: torch.Tensor,
                                   b: torch.Tensor, d: int):
    """vg(x) for one sparse shard: margins by gather, grad by ``add_at``."""
    flat_idx = idx.reshape(-1)

    def vg(x):
        ax = torch.sum(vals * x[idx], dim=-1)                # (N,)
        margins = -b * ax
        f = torch.sum(torch.logaddexp(torch.zeros_like(margins), margins))
        coef = -b * torch.sigmoid(margins)                   # (N,)
        contrib = (coef[:, None] * vals).reshape(-1)
        grad = torch.zeros((d,), dtype=x.dtype, device=x.device)
        return f, add_at(grad, flat_idx, contrib)
    return vg


def lane_flat_indices(idx: torch.Tensor, d: int) -> torch.Tensor:
    """Stacked gather indices idx (W, N, k) -> flat indices into a (W, d)
    gradient, lane w's offset by w·d, for ``add_at``."""
    W = idx.shape[0]
    lanes = torch.arange(W, dtype=idx.dtype, device=idx.device) * d
    return (idx.reshape(W, -1) + lanes[:, None]).reshape(-1)


def logistic_value_and_grad(A: torch.Tensor, b: torch.Tensor):
    """Dense value+grad of f(x) = sum_n log(1 + exp(-b_n <a_n, x>))."""
    def vg(x):
        margins = -b * (A @ x)                               # (N,)
        f = torch.sum(torch.logaddexp(torch.zeros_like(margins), margins))
        grad = A.T @ (-b * torch.sigmoid(margins))
        return f, grad
    return vg


def full_objective(shards, x: torch.Tensor, lam1: float) -> torch.Tensor:
    """phi(x) = total logistic loss + lam1*||x||_1 over a list of dense
    (A, b) shards."""
    total = lam1 * torch.sum(torch.abs(x))
    for A, b in shards:
        f, _ = logistic_value_and_grad(A, b)(x)
        total = total + f
    return total
