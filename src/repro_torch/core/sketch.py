"""Sketched linear algebra for second-order serverless optimization
(OverSketch-style blocked sketched Gram, Gupta et al. 2019) — the PyTorch
counterpart of ``repro.core.sketch``.

The Newton Hessian ``H = A'ᵀA'`` (``A'`` the weighted data matrix) is
approximated by a sketched Gram ``(S A')ᵀ(S A')`` computed as a sum of
independent block contributions, so it distributes over serverless
workers like a gradient does, and the same straggler defenses apply.

The sketch ``S`` is a stack of ``n_tasks = n_blocks + s`` independent
sketch blocks ``S_k`` (count-sketch or SRHT) of ``block_rows`` rows each,
scaled ``1/sqrt(n_tasks)``, so ``(S A)ᵀ(S A)`` is the mean of the block
Grams and any ``n_blocks`` of the blocks still carry ``sketch_dim`` rows.
Two straggler defenses:

* **ignore-extra-blocks** (``coded=False``) — the master sums the blocks
  that arrived: an unbiased sketched Hessian whose realization depends on
  which blocks arrived;
* **decode-from-any-subset** (``coded=True``, default) — the per-block
  values are linearly encoded with a gradient-coding matrix
  (``core/coding.py``: FRS when ``(s+1) | n_tasks``, else cyclic), so the
  master reconstructs the exact full-stack sum from any ``n_blocks`` of
  the ``n_tasks`` responses.

The maps (count-sketch buckets and signs, the SRHT rows, the code ``B``)
are numpy, drawn as the reference draws them, so they equal the
reference's bit for bit.  The block algebra runs on torch tensors on their
own device.  The count sketch scatters with ``data.logreg.add_at``: every
sum over rows that share a bucket runs in a fixed order (element order on
the CPU, a sorted segment sum on the card), so two runs agree bit for bit.
It also takes sparse gather-format rows (idx, vals) with per-row weights,
which is how the Newton workload sketches ``D^{1/2} A`` without a dense A.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import coding
from repro_torch.data.logreg import add_at

# nonzeros per add_at call of the count sketch: bounds the flat index and
# the sort behind it to a few hundred MB each
SCATTER_CHUNK = 1 << 26
# the SRHT plan holds its dense maps (n_tasks, block_rows, n_rows); past
# this many elements (512 MiB in float32) it is refused
SRHT_MAX_ELEMENTS = 1 << 27


# ---------------------------------------------------------------------------
# Sketch operators (numpy, as the reference)
# ---------------------------------------------------------------------------


def count_sketch_map(n_rows: int, m: int, seed) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Count-sketch hash: (buckets (n,), signs (n,)) — row i lands in
    bucket ``buckets[i]`` with sign ``signs[i]``.  ``E[SᵀS] = I``."""
    rng = np.random.RandomState(seed)
    buckets = rng.randint(0, m, size=n_rows).astype(np.int32)
    signs = (rng.randint(0, 2, size=n_rows) * 2 - 1).astype(np.float32)
    return buckets, signs


def count_sketch_matrix(n_rows: int, m: int, seed=0) -> np.ndarray:
    """Materialized count-sketch ``S`` (m, n): one ±1 per column."""
    buckets, signs = count_sketch_map(n_rows, m, seed)
    S = np.zeros((m, n_rows), np.float32)
    S[buckets, np.arange(n_rows)] = signs
    return S


def _popcount(a: np.ndarray) -> np.ndarray:
    out = np.zeros_like(a)
    x = a.copy()
    while x.any():
        out += x & 1
        x >>= 1
    return out


def srht_matrix(n_rows: int, m: int, seed=0) -> np.ndarray:
    """Subsampled randomized Hadamard transform ``S`` (m, n):
    ``sqrt(n_pad/m) · P · (H/sqrt(n_pad)) · D`` with ``D`` a random ±1
    diagonal, ``H`` the ``n_pad = 2^ceil(log2 n)`` Hadamard matrix and
    ``P`` a uniform row sample, truncated to the first n columns.  Only the
    m sampled Hadamard rows are materialized (``H[j,i] =
    (-1)^popcount(j&i)``)."""
    if n_rows < 1:
        raise ValueError("srht needs n_rows >= 1")
    rng = np.random.RandomState(seed)
    n_pad = 1 << max(int(math.ceil(math.log2(n_rows))), 0)
    signs = (rng.randint(0, 2, size=n_rows) * 2 - 1).astype(np.float32)
    rows = rng.choice(n_pad, size=m, replace=(m > n_pad))
    i = np.arange(n_rows, dtype=np.int64)
    H = np.where(_popcount(rows[:, None].astype(np.int64) & i[None, :]) % 2,
                 np.float32(-1.0), np.float32(1.0))
    return np.sqrt(np.float32(n_pad) / m) / np.sqrt(np.float32(n_pad)) \
        * H * signs[None, :]


def sketch_matrix(method: str, n_rows: int, m: int, seed=0) -> np.ndarray:
    """Dispatcher: a dense (m, n) sketch with ``E[SᵀS] = I``."""
    if method == "count":
        return count_sketch_matrix(n_rows, m, seed)
    if method == "srht":
        return srht_matrix(n_rows, m, seed)
    raise ValueError(f"unknown sketch method {method!r} "
                     f"(choose 'count' or 'srht')")


def sketched_gram(A: np.ndarray, sketch_dim: int, *, method: str = "count",
                  seed=0) -> np.ndarray:
    """One-shot ``AᵀSᵀSA`` at the given sketch dimension (no blocking)."""
    S = sketch_matrix(method, A.shape[0], sketch_dim, seed)
    SA = S @ np.asarray(A)
    return SA.T @ SA


# ---------------------------------------------------------------------------
# The blocked, over-provisioned, optionally coded plan
# ---------------------------------------------------------------------------


def _rows_of(M, weights, n_cols):
    """(idx (n, k), weighted vals (n, k), d) for a dense (n, d) matrix or
    gather-format rows (idx, vals); ``weights`` (n,) scales each row."""
    if isinstance(M, tuple):
        idx, vals = M
        if n_cols is None:
            raise ValueError("sparse rows need n_cols")
        d = int(n_cols)
    else:
        n, d = M.shape
        idx = torch.arange(d, device=M.device).expand(n, d)
        vals = M
    if weights is not None:
        vals = weights[:, None] * vals
    return idx, vals, d


class BlockSketch:
    """Over-provisioned blocked sketch of an (n_rows, d) row matrix.

    ``n_tasks`` worker tasks, ``redundancy`` s of them expendable:
    ``n_blocks = n_tasks - s`` blocks suffice, each an independent
    ``block_rows = ceil(sketch_dim / n_blocks)``-row sketch of the full
    matrix.  The apply methods take a dense (n, d) tensor, or sparse rows
    ``(idx, vals)`` with ``n_cols=d``, and optional per-row ``weights``.
    """

    def __init__(self, n_rows: int, n_tasks: int, *, sketch_dim: int,
                 redundancy: int = 1, method: str = "count",
                 coded: bool = True, scheme: str = "auto", seed: int = 0):
        if n_tasks < 1:
            raise ValueError("need n_tasks >= 1")
        if not 0 <= redundancy < n_tasks:
            raise ValueError(f"redundancy must be in [0, n_tasks) "
                             f"(got s={redundancy}, n_tasks={n_tasks})")
        if sketch_dim < 1:
            raise ValueError("need sketch_dim >= 1")
        self.n_rows = int(n_rows)
        self.n_tasks = int(n_tasks)
        self.redundancy = int(redundancy)
        self.n_blocks = self.n_tasks - self.redundancy
        self.block_rows = int(math.ceil(sketch_dim / self.n_blocks))
        self.sketch_dim = int(sketch_dim)
        self.method = method
        self.coded = bool(coded)
        self.seed = int(seed)
        if method not in ("count", "srht"):
            raise ValueError(f"unknown sketch method {method!r}")
        # per-block operators (independent seeds)
        if method == "count":
            maps = [count_sketch_map(n_rows, self.block_rows,
                                     [self.seed, k])
                    for k in range(self.n_tasks)]
            self.buckets = np.stack([b for b, _ in maps])     # (W, n)
            self.signs = np.stack([s for _, s in maps])       # (W, n)
            self._S = None
        else:
            size = self.n_tasks * self.block_rows * self.n_rows
            if size > SRHT_MAX_ELEMENTS:
                raise ValueError(
                    f"the srht plan would hold {size} dense map elements "
                    f"(n_tasks x block_rows x n_rows), over "
                    f"SRHT_MAX_ELEMENTS = {SRHT_MAX_ELEMENTS}: use "
                    f"method='count' at this size")
            self.buckets = self.signs = None
            self._S = np.stack([srht_matrix(n_rows, self.block_rows,
                                            [self.seed, k])
                                for k in range(self.n_tasks)])  # (W, b, n)
        # the straggler code over per-block values
        r = self.redundancy + 1
        if not self.coded or r == 1:
            self.B: Optional[np.ndarray] = (np.eye(self.n_tasks, dtype=np.float32)
                                            if self.coded else None)
        elif scheme == "frs" or (scheme == "auto"
                                 and self.n_tasks % r == 0):
            self.B = coding.frs_matrix(self.n_tasks, r)
        elif scheme in ("auto", "cyclic"):
            self.B = coding.cyclic_matrix(self.n_tasks, r)
        else:
            raise ValueError(f"unknown coding scheme {scheme!r}")
        self._device_maps: Dict[torch.device, Tuple] = {}

    def _maps(self, device: torch.device) -> Tuple:
        """The operators on ``device``, moved there once: (buckets int64,
        signs f32) for the count sketch, (S f32,) for SRHT."""
        if device not in self._device_maps:
            if self._S is None:
                maps = (torch.as_tensor(self.buckets, device=device).long(),
                        torch.as_tensor(self.signs, device=device))
            else:
                maps = (torch.as_tensor(self._S, device=device),)
            self._device_maps[device] = maps
        return self._device_maps[device]

    # -- per-task structure (the workload's timing model reads these) -------
    def blocks_of_task(self, w: int) -> np.ndarray:
        """Block ids task ``w`` must compute: the support of its coding
        row (r = s+1 blocks) when coded, else just its own block."""
        if self.B is None or self.redundancy == 0:
            return np.array([w])
        return np.nonzero(self.B[w])[0]

    def blocks_per_task(self) -> int:
        return (self.redundancy + 1) if self.coded else 1

    # -- block application --------------------------------------------------
    def _apply(self, k0: int, k1: int, M, weights, n_cols) -> torch.Tensor:
        """``S_k M`` for blocks k0 <= k < k1: (k1 - k0, block_rows, d)."""
        idx, vals, d = _rows_of(M, weights, n_cols)
        dev, br = vals.device, self.block_rows
        if self._S is not None:
            (S,) = self._maps(dev)
            if isinstance(M, tuple):             # SRHT mixes dense rows
                dense = torch.zeros((idx.shape[0], d), dtype=vals.dtype,
                                    device=dev)
                rows = torch.arange(idx.shape[0], device=dev)[:, None] * d
                vals = add_at(dense, (rows + idx).reshape(-1),
                              vals.reshape(-1))
            return torch.einsum("wbn,nd->wbd", S[k0:k1].to(vals.dtype), vals)
        buckets, signs = self._maps(dev)
        n, nz = idx.shape
        out = torch.zeros((k1 - k0, br, d), dtype=vals.dtype, device=dev)
        per = max(1, SCATTER_CHUNK // max(n * nz, 1))
        for c0 in range(k0, k1, per):
            c1 = min(c0 + per, k1)
            # flat destination of nonzero (k, i, j): bucket row of row i in
            # block k, column idx[i, j]; blocks laid out one after another
            dest = (buckets[c0:c1, :, None] * d + idx[None]).reshape(
                c1 - c0, -1)
            dest += torch.arange(c1 - c0, device=dev)[:, None] * (br * d)
            contrib = signs[c0:c1].to(vals.dtype)[:, :, None] * vals[None]
            add_at(out[c0 - k0:c1 - k0], dest.reshape(-1),
                   contrib.reshape(-1))
        return out

    def apply_block(self, k: int, M, *, weights=None,
                    n_cols=None) -> torch.Tensor:
        """``S_k M`` for one block (unscaled: ``E[(S_k M)ᵀ(S_k M)] = MᵀM``)."""
        return self._apply(k, k + 1, M, weights, n_cols)[0]

    def apply_all(self, M, *, weights=None, n_cols=None) -> torch.Tensor:
        """Every block in one call: (n_tasks, block_rows, d)."""
        return self._apply(0, self.n_tasks, M, weights, n_cols)

    def block_grams(self, M, **kw) -> torch.Tensor:
        """(n_tasks, d, d) per-block Gram contributions (unscaled)."""
        SA = self.apply_all(M, **kw)
        return torch.einsum("wbd,wbe->wde", SA, SA)

    # -- full-stack oracles (tests / master-side references) ----------------
    def sketch(self, M, **kw) -> torch.Tensor:
        """The full over-provisioned ``S M``, scaled ``1/sqrt(n_tasks)``
        so ``(SM)ᵀ(SM)`` is the mean of block Grams."""
        SA = self.apply_all(M, **kw)
        scale = torch.sqrt(torch.tensor(float(self.n_tasks), dtype=SA.dtype,
                                        device=SA.device))
        return SA.reshape(-1, SA.shape[-1]) / scale

    def gram(self, M, **kw) -> torch.Tensor:
        """``(SM)ᵀ(SM)`` of the full stack — exactly what the coded decode
        reconstructs under any ``redundancy`` dropped blocks."""
        SA = self.sketch(M, **kw)
        return SA.T @ SA

    # -- straggler code over per-block values -------------------------------
    def encode(self, values: torch.Tensor) -> torch.Tensor:
        """Per-task messages from per-block values (n_tasks, L): the
        coding combination ``B @ values`` when coded, else identity."""
        if values.shape[0] != self.n_tasks:
            raise ValueError(f"expected {self.n_tasks} block values, "
                             f"got {values.shape[0]}")
        if self.B is None:
            return values
        return coding.encode(self.B, values)

    def decode_sum(self, responders, messages) -> Tuple[torch.Tensor, int]:
        """(Σ of block values, n_blocks_summed) from responder messages.

        ``messages[i]`` is responder i's message: a (R, L) tensor, or any
        sequence that builds a row when read; only rows with a nonzero
        coefficient are read, one at a time, and summed in responder order
        in the messages' dtype.

        Coded: the exact sum over all ``n_tasks`` blocks, from any
        ``n_blocks`` responders (``coding.decode_coeffs``; raises when the
        subset cannot reconstruct).  Uncoded: the plain sum over the
        arrived blocks (ignore-extra-blocks; requires at least ``n_blocks``
        of them)."""
        with trace.span("newton.decode"):
            responders = np.asarray(responders)
            if self.B is not None:
                a = coding.decode_coeffs(self.B, responders)
                n_used = self.n_tasks
            elif len(responders) < self.n_blocks:
                raise ValueError(
                    f"ignore-extra-blocks needs >= {self.n_blocks} of "
                    f"{self.n_tasks} blocks, got {len(responders)}")
            else:
                a = np.ones(len(responders), np.float32)
                n_used = len(responders)
            total = None
            for i in np.flatnonzero(a):
                m = messages[int(i)]
                if total is None:
                    total = torch.zeros_like(m)
                total.add_(m, alpha=float(a[i]))
            return total, n_used
