"""The workload layer: the ``WorkerProblem`` contract, a name→factory
registry, and the shared scaffolding for shard-partitioned FISTA
workloads — the PyTorch counterpart of ``repro.problems.base``.

Contract (what the scheduler calls):
  * ``n_features`` — flat decision-vector length on the wire,
  * ``n_samples(wid, W)`` — shard size, used by the timing model,
  * ``solve(wid, W, x0, z, u, rho)`` — the Algorithm-2 worker body:
    ``argmin_x f_w(x) + rho/2 ||x - (z - u)||^2`` warm-started at x0,
    returning ``(x_new, real_inner_iteration_count)``,
  * ``prox_h(v, t)`` — the master's prox of the global regularizer h.

Batched-engine contract (``SchedulerConfig(engine="batched")``):
  * ``solve_all(xs, us, z, rho, kernel="torch")`` — all W worker bodies as
    one lane-batched FISTA (``core.fista``) over stacked shards.
    ``kernel="cuda"`` routes the masked loss through the fused wrappers in
    ``repro_torch.kernels.ops`` via the ``_masked_kernel_loss_value_and_grad``
    / ``kernel_batch_shards`` hooks.

Every problem holds ``device`` and ``dtype``; its shards, and every tensor
the scheduler builds for it, live there.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Protocol, Tuple, Union

import numpy as np
import torch

from repro_torch.core import fista as fista_mod
from repro_torch.core.fista import FistaOptions
from repro_torch.data.logreg import add_at, shard_rows
from repro_torch.data import threefry as tf
from repro_torch.device import resolve_device


class WorkerProblem(Protocol):
    """The per-worker subproblem: the scheduler is workload-agnostic."""

    n_features: int

    def n_samples(self, wid: int, n_workers: int) -> int: ...

    def solve(self, wid: int, n_workers: int, x0: torch.Tensor,
              z: torch.Tensor, u: torch.Tensor, rho: float
              ) -> Tuple[torch.Tensor, int]: ...

    def prox_h(self, v: torch.Tensor, t: float) -> torch.Tensor: ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ProblemFactory = Callable[..., WorkerProblem]
_REGISTRY: Dict[str, ProblemFactory] = {}


def register(name: str, factory: Optional[ProblemFactory] = None):
    """Register a workload factory under ``name`` (directly or as a
    decorator).  Factories take keyword arguments only, ``device`` among
    them."""
    def _do(f: ProblemFactory) -> ProblemFactory:
        if name in _REGISTRY:
            raise ValueError(f"problem {name!r} is already registered")
        _REGISTRY[name] = f
        return f
    return _do(factory) if factory is not None else _do


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def make(name: str, *, device="cuda", **kwargs) -> WorkerProblem:
    """Instantiate the workload registered under ``name`` on ``device``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown problem {name!r}; registered: "
                       f"{available()}") from None
    return factory(device=device, **kwargs)


def available() -> list:
    return sorted(_REGISTRY)


def as_fista_options(fista: Union[None, dict, FistaOptions]) -> FistaOptions:
    """Accept a FistaOptions, a JSON-friendly kwargs dict, or None."""
    if fista is None:
        return FistaOptions()
    if isinstance(fista, dict):
        return FistaOptions(**fista)
    return fista


def as_dtype(dtype) -> torch.dtype:
    """"float32" / "float64" / a torch dtype -> the torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def solve_augmented(vg: Callable, x0: torch.Tensor, center: torch.Tensor,
                    rho: torch.Tensor, fixed: Optional[int],
                    fista_opts: FistaOptions):
    """The Algorithm-2 body shared by both engines, over lanes: minimize
    f(x) + rho/2 ||x - center||^2 from x0 (L, d) by FISTA (adaptive, or
    ``fista_fixed`` when ``fixed`` is set).  Returns (x_new (L, d),
    inner-iteration counts (L,))."""
    def aug(x):
        f, g = vg(x)
        dx = x - center
        return f + 0.5 * rho * torch.sum(dx * dx, dim=-1), g + rho * dx

    x_new, info = fista_mod.solve_lanes(aug, x0, fista_opts, fixed)
    return x_new, info.k


def densify_sparse_rows(idx: torch.Tensor, vals: torch.Tensor,
                        d: int) -> torch.Tensor:
    """Gather-format sparse rows (idx (..., N, k), vals (..., N, k)) ->
    dense (..., N, d) rows on their own device, duplicate indices summed —
    exactly the matrix whose row products ``sum(vals * x[idx])`` are.  One
    ``add_at`` builds the whole stack, so the paper's 24 GB batch never
    passes through host memory."""
    lead = tuple(idx.shape[:-1])
    k = idx.shape[-1]
    a = torch.zeros(lead + (d,), dtype=vals.dtype, device=vals.device)
    rows = torch.arange(math.prod(lead), device=vals.device) * d
    flat = (rows[:, None] + idx.reshape(-1, k)).reshape(-1)
    return add_at(a, flat, vals.reshape(-1))


class SparseRows(NamedTuple):
    """Sparse rows as the margin kernel's rows mode reads them, W lanes:
    the rows in ELL form, a fixed k nonzeros a row (``idx`` int32 column
    indices and ``vals`` float32, (W, N, k); a padded row all zero), their
    labels ``b`` (W, N) float32, and a column-major copy of each lane
    (CSC): lane w's entries of column j are ``csc_row[w, e]`` (the row
    within the lane, int32) and ``csc_val[w, e]`` (float32) for e in
    [col_ptr[w, j], col_ptr[w, j + 1]), by row.  ``col_ptr`` (W, d + 1)
    int32; the CSC arrays (W, S), S the most entries of any lane, the
    rest zero.  The unbatched form drops W."""
    idx: torch.Tensor
    vals: torch.Tensor
    b: torch.Tensor
    col_ptr: torch.Tensor
    csc_row: torch.Tensor
    csc_val: torch.Tensor


def stage_sparse_rows(idx: torch.Tensor, vals: torch.Tensor, b: torch.Tensor,
                      mask: torch.Tensor, d: int) -> SparseRows:
    """Stacked gather-format rows (idx, vals (W, N, k), b and the row mask
    (W, N)) -> ``SparseRows`` on their own device.  The CSC copy holds the
    entries of the rows the mask keeps, ordered stably by (column, row),
    with duplicate indices within a row summed into one entry in the
    order the row lists them (as ``densify_sparse_rows`` sums them); the
    ELL arrays keep every row as given.  Values are float32: a float64
    problem's values are float32 draws widened, so nothing rounds."""
    W, N, k = idx.shape
    dev = idx.device
    if W * N * k and (int(idx.min()) < 0 or int(idx.max()) >= d):
        raise ValueError(f"column indices must lie in [0, {d})")
    if N * k >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"int32 indices cannot address (N, k, d) = "
                         f"{(N, k, d)}")
    live = (mask != 0)[..., None].expand(W, N, k).reshape(-1)
    lane = torch.arange(W, device=dev).view(W, 1, 1).expand(W, N, k)
    row = torch.arange(N, device=dev).view(1, N, 1).expand(W, N, k)
    key = ((lane.reshape(-1) * d + idx.reshape(-1).to(torch.int64)) * N
           + row.reshape(-1))[live]
    key, order = torch.sort(key, stable=True)
    merged = vals.reshape(-1).to(torch.float32)[live][order]
    key, inv = torch.unique_consecutive(key, return_inverse=True)
    if key.numel() < inv.numel():
        # a row lists an index twice.  The generators never do, and the
        # first add_at of a process took 13 s on an H100 (its sort-based
        # accumulate), so rows without repeats skip it
        merged = add_at(torch.zeros(key.shape, dtype=torch.float32,
                                    device=dev), inv, merged)
    lane_col = key // N
    lane_of = lane_col // d
    col_ptr = torch.zeros((W, d + 1), dtype=torch.int64, device=dev)
    col_ptr[:, 1:] = torch.cumsum(
        torch.bincount(lane_col, minlength=W * d).view(W, d), dim=1)
    per_lane = col_ptr[:, -1]
    pos = (torch.arange(key.numel(), device=dev)
           - (torch.cumsum(per_lane, 0) - per_lane)[lane_of])
    S = max(1, int(per_lane.max())) if W else 1
    csc_row = torch.zeros((W, S), dtype=torch.int32, device=dev)
    csc_val = torch.zeros((W, S), dtype=torch.float32, device=dev)
    csc_row[lane_of, pos] = (key % N).to(torch.int32)
    csc_val[lane_of, pos] = merged
    return SparseRows(idx.to(torch.int32).contiguous(),
                      vals.to(torch.float32).contiguous(),
                      b.to(torch.float32).contiguous(),
                      col_ptr.to(torch.int32), csc_row, csc_val)


def carry_shards(problem, shards: Dict[Tuple[int, int], Tuple]) -> None:
    """Seed ``problem``'s shard cache from numpy shards, keyed (wid, W):
    integer leaves become int64, float leaves the problem's dtype, all on
    its device.  Tests hand the JAX package's shards over this way, so a
    fault in data generation cannot hide or imitate a solver fault."""
    def leaf(a):
        t = torch.as_tensor(np.array(a), device=problem.device)
        return (t.to(torch.int64) if not t.is_floating_point()
                else t.to(problem.dtype))
    for key, shard in shards.items():
        problem._shard_cache[key] = tuple(leaf(a) for a in shard)
    # whatever was built from the old shards goes: stacked batches, the
    # kernel's staging, lasso's Gram factors
    problem._batch_cache = None
    problem._kernel_batch_cache = None
    getattr(problem, "_factor_cache", {}).clear()


def dense_kernel_batch(problem, n_workers: int) -> Tuple:
    """The dense twin of ``batch_shards`` for workloads on sparse
    gather-format shards (idx, vals, b) — logreg and svm — for the dense
    margin kernel (``ops.fused_logistic_vjp`` / ``fused_svm_vjp``): the
    stacked batch scattered into (W, Nmax, d) rows on the device, cached
    per fleet size beside the rows staging.  The kernel runs in float32
    for every problem dtype, so A, b and the mask are staged in float32 (a
    float64 problem's values are float32 draws widened, so nothing
    rounds).  Returns ((A, b), mask)."""
    if problem._kernel_batch_cache is None:
        problem._kernel_batch_cache = {}
    key = ("dense", n_workers)
    if key not in problem._kernel_batch_cache:
        (idx, vals, b), mask = problem.batch_shards(n_workers)
        dense = densify_sparse_rows(idx, vals.to(torch.float32),
                                    problem.n_features)
        problem._kernel_batch_cache[key] = (
            (dense, b.to(torch.float32)), mask.to(torch.float32))
    return problem._kernel_batch_cache[key]


def sparse_kernel_batch(problem, n_workers: int) -> Tuple:
    """What ``kernel_batch_shards`` gives for workloads on sparse
    gather-format shards (idx, vals, b) — logreg and svm: the stacked
    batch staged once per fleet size as ``SparseRows`` (see
    ``stage_sparse_rows``) on the device, cached; a new W stages anew.
    Returns (rows, mask), the mask float32."""
    if problem._kernel_batch_cache is None:
        problem._kernel_batch_cache = {}
    if n_workers not in problem._kernel_batch_cache:
        (idx, vals, b), mask = problem.batch_shards(n_workers)
        problem._kernel_batch_cache[n_workers] = (
            stage_sparse_rows(idx, vals, b, mask, problem.n_features),
            mask.to(torch.float32))
    return problem._kernel_batch_cache[n_workers]


# ---------------------------------------------------------------------------
# Batched execution: all W subproblems as lanes of one FISTA
# ---------------------------------------------------------------------------


class BatchedShardProblem:
    """The batched engine's problem-side contract, as a mixin.

    Stacks all W per-worker shards into leading-axis tensors once per fleet
    size (cached) and runs every worker's FISTA as one lane of
    ``core.fista``.  Shards of unequal length are zero-padded to the
    longest one and a per-row {0,1} mask rides along; padded rows must
    contribute exactly zero to value and gradient.

    Host classes provide ``_shard(wid, W)`` (a tuple of row-leading
    tensors), ``fista``/``fixed_inner``/``dtype``/``device``, and

        _masked_loss_value_and_grad(batch, mask) -> vg(X (W, d))
                                                  -> (f (W,), grad (W, d))
    """

    _batch_cache: Optional[Dict[int, Tuple]] = None
    _kernel_batch_cache: Optional[Dict[int, Tuple]] = None
    # lam for h(z) = lam * ||z||_1 when the master regularizer is l1: lets
    # the scheduler fuse the z-update into one kernel (kernel="cuda")
    h_l1_lam: Optional[float] = None

    # -- host hooks ---------------------------------------------------------
    def _masked_loss_value_and_grad(self, batch, mask) -> Callable:
        raise NotImplementedError

    def _masked_kernel_loss_value_and_grad(self, batch, mask) -> Callable:
        """Fused-kernel twin of ``_masked_loss_value_and_grad``; defaults
        to the plain path."""
        return self._masked_loss_value_and_grad(batch, mask)

    def kernel_batch_shards(self, n_workers: int) -> Tuple:
        """The stacked batch the kernel solver consumes (same contract as
        ``batch_shards``)."""
        return self.batch_shards(n_workers)

    def supports_batched(self) -> bool:
        cls = type(self)
        return (cls.solve_all is not BatchedShardProblem.solve_all
                or cls._masked_loss_value_and_grad
                is not BatchedShardProblem._masked_loss_value_and_grad)

    def supports_kernel(self) -> bool:
        return self.supports_batched()

    # -- stacking -----------------------------------------------------------
    def batch_shards(self, n_workers: int) -> Tuple:
        """(stacked shard tuple with leading axis W, row mask (W, Nmax)),
        cached per W, zero-padded to the longest shard."""
        if self._batch_cache is None:
            self._batch_cache = {}
        if n_workers not in self._batch_cache:
            shards = [self._shard(w, n_workers) for w in range(n_workers)]
            rows = [int(s[0].shape[0]) for s in shards]
            nmax = max(rows)

            def pad(leaf, n):
                if n == nmax:
                    return leaf
                return torch.cat([leaf, leaf.new_zeros(
                    (nmax - n,) + tuple(leaf.shape[1:]))])

            stacked = tuple(torch.stack([pad(l, n) for l, n in
                                         zip(leaves, rows)])
                            for leaves in zip(*shards))
            mask = torch.zeros((n_workers, nmax), dtype=self.dtype,
                               device=self.device)
            for w, n in enumerate(rows):
                mask[w, :n] = 1.0
            self._batch_cache[n_workers] = (stacked, mask)
        return self._batch_cache[n_workers]

    # -- the one-call solver ------------------------------------------------
    def solve_all(self, xs: torch.Tensor, us: torch.Tensor, z: torch.Tensor,
                  rho: float, kernel: str = "torch"
                  ) -> Tuple[torch.Tensor, np.ndarray]:
        """All W Algorithm-2 bodies as lanes of one FISTA: returns
        (x_new (W, d), per-worker real inner-iteration counts (W,)).
        ``kernel="cuda"`` evaluates each lane's loss through the fused
        margin kernel (one launch for all W lanes)."""
        n_workers = int(xs.shape[0])
        if kernel == "cuda":
            batch, mask = self.kernel_batch_shards(n_workers)
            vg = self._masked_kernel_loss_value_and_grad(batch, mask)
        else:
            batch, mask = self.batch_shards(n_workers)
            vg = self._masked_loss_value_and_grad(batch, mask)
        rho_t = torch.tensor(rho, dtype=self.dtype, device=self.device)
        xs_new, ks = solve_augmented(vg, xs, z[None, :] - us, rho_t,
                                     self.fixed_inner, self.fista)
        return xs_new, ks.cpu().numpy()


# ---------------------------------------------------------------------------
# Shared scaffolding for shard-partitioned smooth-loss workloads
# ---------------------------------------------------------------------------


class FistaShardProblem(BatchedShardProblem):
    """Scaffolding for the built-in workloads: a deterministic per-(wid, W)
    shard cache and the loop engine's FISTA over ``f_w + the augmented
    quadratic``.  Subclasses implement ``_gen_shard`` (a pure function of
    (seed, wid, W)), ``_loss_value_and_grad`` (vg(x (d,)) over one shard),
    ``prox_h`` and ``h_value``."""

    def __init__(self, n_samples: int, n_features: int, *, seed: int = 0,
                 fista=None, fixed_inner: Optional[int] = None,
                 dtype="float32", device="cuda"):
        self.total_samples = int(n_samples)
        self.n_features = int(n_features)
        self.seed = int(seed)
        self.fista = as_fista_options(fista)
        self.fixed_inner = fixed_inner
        self.dtype = as_dtype(dtype)
        self.device = resolve_device(device)
        self._shard_cache: Dict[Tuple[int, int], Tuple] = {}

    # -- subclass hooks -----------------------------------------------------
    def _gen_shard(self, wid: int, n_workers: int):
        raise NotImplementedError

    def _loss_value_and_grad(self, shard) -> Callable:
        raise NotImplementedError

    def prox_h(self, v: torch.Tensor, t: float) -> torch.Tensor:
        raise NotImplementedError

    def h_value(self, z: torch.Tensor) -> float:
        raise NotImplementedError

    # -- shared machinery ---------------------------------------------------
    def _row_keys(self, lo: int, hi: int) -> tf.Key:
        """Per-GLOBAL-row keys: re-sharding partitions the same dataset."""
        base = tf.prng_key(self.seed, device=self.device)
        return tf.fold_in(base, torch.arange(lo, hi, device=self.device))

    def _aux_key(self, tag: int) -> tf.Key:
        """A key past every row index, for shard-independent draws."""
        base = tf.prng_key(self.seed, device=self.device)
        return tf.fold_in(base, self.total_samples + tag)

    def n_samples(self, wid: int, n_workers: int) -> int:
        lo, hi = shard_rows(self.total_samples, n_workers, wid)
        return hi - lo

    def _shard(self, wid: int, n_workers: int):
        key = (wid, n_workers)
        if key not in self._shard_cache:
            self._shard_cache[key] = self._gen_shard(wid, n_workers)
        return self._shard_cache[key]

    def solve(self, wid, n_workers, x0, z, u, rho):
        return solve_one(self._loss_value_and_grad(self._shard(wid,
                                                               n_workers)),
                         x0, z, u, rho, self)

    # -- conformance / reporting --------------------------------------------
    def local_value(self, wid: int, n_workers: int, x) -> float:
        f, _ = self._loss_value_and_grad(self._shard(wid, n_workers))(x)
        return float(f)

    def objective(self, x, n_workers: int) -> float:
        total = float(self.h_value(x))
        for w in range(n_workers):
            total += self.local_value(w, n_workers, x)
        return total


def solve_one(vg1: Callable, x0, z, u, rho: float, problem):
    """The loop engine's worker body: one lane of ``solve_augmented`` over
    a single-shard vg(x (d,)) -> (f, grad)."""
    def vg(X):
        f, g = vg1(X[0])
        return f[None], g[None]
    rho_t = torch.tensor(rho, dtype=problem.dtype, device=problem.device)
    x_new, k = solve_augmented(vg, x0[None], (z - u)[None], rho_t,
                               problem.fixed_inner, problem.fista)
    return x_new[0], int(k[0])
