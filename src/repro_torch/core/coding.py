"""Straggler-robust aggregation: gradient coding (Tandon et al., ICML'17) —
the PyTorch counterpart of ``repro.core.coding``.

Gradient coding assigns each data shard to r = s+1 workers so the master
reconstructs the exact sum of shard values from any W - s responses.  Two
published schemes:

* **Fraction Repetition (FRS)** — workers form W/r groups; every worker in
  group g holds the same r shards; decoding picks one responder per group
  with coefficient 1.  Requires r | W; tolerates any s = r-1 stragglers.
* **Cyclic repetition** — worker w holds shards {w, ..., w+r-1 (mod W)}
  with coefficients from the nullspace construction; decoding solves
  a^T B = 1^T restricted to the responders (lstsq at runtime).

The constructions and the decode coefficients are numpy, as in the
reference, so ``B`` and ``a`` equal the reference's bit for bit;
``encode`` and ``decode`` combine torch tensors on their own device.
"""
from __future__ import annotations

import numpy as np
import torch


def frs_matrix(n_workers: int, r: int) -> np.ndarray:
    """B (W, K=W shards): FRS assignment/coefficients, r-fold replication."""
    if n_workers % r:
        raise ValueError(f"FRS needs r | W (got W={n_workers}, r={r})")
    B = np.zeros((n_workers, n_workers), np.float32)
    n_groups = n_workers // r
    for g in range(n_groups):
        shards = [g * r + j for j in range(r)]
        for j in range(r):
            w = g * r + j
            B[w, shards] = 1.0
    return B


def _build_cyclic(H: np.ndarray, n_workers: int, r: int) -> np.ndarray:
    """One cyclic-construction attempt from a given H (s, W).  Raises
    np.linalg.LinAlgError when some s×s subsystem is singular, too
    ill-conditioned to trust, or yields badly scaled coefficients (rounding
    such a B to f32 breaks the decode identity aᵀB = 1ᵀ at the 1e-4
    exactness tolerance)."""
    W = n_workers
    B = np.zeros((W, W))
    for i in range(W):
        cols = [(i + j) % W for j in range(r)]
        sub = H[:, cols[1:]]
        if np.linalg.cond(sub) > 1e12:
            raise np.linalg.LinAlgError(
                f"ill-conditioned cyclic subsystem at row {i}")
        B[i, cols[0]] = 1.0
        # solve H[:, cols[1:]] @ x = -H[:, cols[0]]  (s x s system)
        x = np.linalg.solve(sub, -H[:, cols[0]])
        if not np.all(np.isfinite(x)):
            raise np.linalg.LinAlgError(
                f"non-finite cyclic coefficients at row {i}")
        if np.abs(x).max() > 100.0:
            raise np.linalg.LinAlgError(
                f"badly scaled cyclic coefficients at row {i} "
                f"(max |coeff| = {np.abs(x).max():.1f})")
        B[i, cols[1:]] = x
    return B.astype(np.float32)


def cyclic_matrix(n_workers: int, r: int, seed: int = 0,
                  max_retries: int = 8) -> np.ndarray:
    """B (W, W): Tandon et al. Algorithm 2 (cyclic repetition scheme).

    Worker w covers shards {w, ..., w+s mod W} (s = r-1) with coefficients
    chosen so 1^T lies in the span of any W-s rows: a random H (s, W) whose
    columns sum to zero, then each row's coefficients in the null space of
    the corresponding H columns.  A failed attempt reseeds H
    deterministically (seed+attempt) up to ``max_retries`` extra times
    before raising."""
    W, s = n_workers, r - 1
    if s == 0:
        return np.eye(W, dtype=np.float32)
    last_err: Exception | None = None
    for attempt in range(max_retries + 1):
        rng = np.random.RandomState(seed + attempt)
        H = rng.randn(s, W)
        H[:, -1] = -H[:, :-1].sum(axis=1)      # columns sum to zero
        try:
            return _build_cyclic(H, W, r)
        except np.linalg.LinAlgError as err:
            last_err = err
    raise ValueError(
        f"cyclic_matrix(W={W}, r={r}): all {max_retries + 1} H draws "
        f"produced a singular/ill-conditioned subsystem; last failure: "
        f"{last_err}")


def _as_coeffs(C: np.ndarray, values: torch.Tensor) -> torch.Tensor:
    """Coefficients in the values' dtype, on their device."""
    return torch.as_tensor(C, device=values.device).to(values.dtype)


def encode(B: np.ndarray, shard_grads: torch.Tensor) -> torch.Tensor:
    """Worker messages: m_w = sum_k B[w,k] * g_k.  shard_grads (K, d)."""
    return _as_coeffs(B, shard_grads) @ shard_grads


def _frs_groups(B: np.ndarray):
    """Row supports of an FRS matrix, or None when B is not FRS-shaped.

    FRS structure: binary B whose distinct row supports are disjoint and
    partition the K columns; rows sharing a support form a group of
    identical replicas."""
    binary = (B == 0) | (B == 1)
    if not binary.all():
        return None
    supports = {}
    for w in range(B.shape[0]):
        key = B[w].tobytes()
        supports.setdefault(key, (np.nonzero(B[w])[0], []))[1].append(w)
    covered = np.zeros(B.shape[1], np.int64)
    for cols, _ in supports.values():
        if len(cols) == 0:
            return None
        covered[cols] += 1
    if not (covered == 1).all():                # disjoint + exhaustive
        return None
    return list(supports.values())


def decode_coeffs(B: np.ndarray, responders: np.ndarray) -> np.ndarray:
    """a (|responders|,) with  a^T B[responders] = 1^T  (exact sum).

    FRS: closed form (one representative per group, coefficient 1).
    General B: lstsq in float64, downcast to float32 on return so message
    combination stays in wire precision.  Raises if the responder set
    cannot reconstruct (too many stragglers)."""
    responders = np.asarray(responders)
    groups = _frs_groups(B)
    if groups is not None:
        resp_set = set(int(w) for w in responders)
        pos = {int(w): i for i, w in enumerate(responders)}
        a = np.zeros(len(responders), np.float32)
        for _, members in groups:
            rep = next((w for w in members if w in resp_set), None)
            if rep is None:
                raise ValueError(
                    "responder set cannot reconstruct the exact sum "
                    f"(no responder in group {members}; "
                    f"{len(responders)}/{B.shape[0]} responders)")
            a[pos[rep]] = 1.0
        return a
    Bs = B[responders].astype(np.float64)                # (R, K)
    ones = np.ones(B.shape[1], np.float64)
    a, *_ = np.linalg.lstsq(Bs.T, ones, rcond=None)
    if not np.allclose(Bs.T @ a, ones, atol=1e-4):
        raise ValueError("responder set cannot reconstruct the exact sum "
                         f"({len(responders)}/{B.shape[0]} responders)")
    return a.astype(np.float32)


def decode(B: np.ndarray, responders: np.ndarray,
           messages: torch.Tensor) -> torch.Tensor:
    """Exact sum of all shard values from responder messages (R, d)."""
    return _as_coeffs(decode_coeffs(B, responders), messages) @ messages


def max_stragglers(r: int) -> int:
    return r - 1
