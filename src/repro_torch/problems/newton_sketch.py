"""OverSketched Newton: the second-order workload family (PAPERS.md,
Gupta et al. 2019) and its ADMM twin — the PyTorch counterpart of
``repro.problems.newton_sketch``.

Where the first-order workloads send a FISTA shard solve to each worker,
``newton_sketch`` sends a Hessian sketch block: task w computes its blocks
of the over-provisioned blocked sketch (``core/sketch.py``) of the weighted
data matrix ``A' = D(z)^{1/2} A`` plus its per-block gradient shard, and
ships the coded combination ``m_w = Σ_k B[w,k]·[g_k | vec((S_k A')ᵀ(S_k
A'))]`` — one flat vector of ``d + d²`` floats.  The master decodes the
exact full-sketch Gram and full gradient from any ``n_tasks - redundancy``
responses and takes a globalized Newton step (sketched-Hessian solve +
Armijo backtracking on the true l2-regularized logistic objective).

The objective is  f(z) = Σ_i log(1 + exp(-b_i·aᵢᵀz)) + (lam2/2)·‖z‖² on
the ``logreg`` workload's rows, so ``logreg_l2`` (below) solves the same
problem by ADMM.

At the paper's size (N=600 000, d=10 000) one message is 400 MB and the
reference's W=64 round holds 25.6 GB of them, plus a dense A.  Here the
rows stay sparse: the round sketches them on the problem's device
(``BlockSketch.apply_all`` on (idx, vals) with weights √w), and
``round_messages_all`` returns a ``RoundMessages`` handle that holds the
sketched blocks and builds a task's message when it is read.  The master's
decode reads the responders' messages one at a time, so nothing of size d²
is stacked or leaves the device; the decode, the solve and the line search
run in float64 on the problem's device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.logreg_paper import scaled
from repro_torch.core.sketch import BlockSketch
from repro_torch.data import logreg as data_mod
from repro_torch.data.logreg import add_at, shard_rows
from repro_torch.device import resolve_device
from repro_torch.problems import base
from repro_torch.problems.logreg import LogRegProblem


class RoundMessages:
    """One round's task messages, held as their parts on the problem's
    device: the sketched blocks ``SA`` (W, block_rows, d) and the gradient
    shards (W, d).  ``msgs[w]`` builds task w's message, the flat
    ``[Σ_k B[w,k] g_k | vec(Σ_k B[w,k] (S_k A')ᵀ(S_k A'))]`` of ``d + d²``
    floats in the round's dtype, with one Gram product over the rows of w's
    blocks; ``len(msgs)`` is W."""

    def __init__(self, plan: BlockSketch, SA: torch.Tensor,
                 grads: torch.Tensor):
        self.plan = plan
        self.SA = SA
        self.grads = grads

    def __len__(self) -> int:
        return self.plan.n_tasks

    def __getitem__(self, w: int) -> torch.Tensor:
        """Task ``w``'s message (see the class docstring)."""
        with trace.span("newton.gram"):
            w = int(w)
            d = self.grads.shape[1]
            if self.plan.B is None:
                blocks, coeff = np.array([w]), np.ones(1, np.float32)
            else:
                blocks = np.flatnonzero(self.plan.B[w])
                coeff = self.plan.B[w, blocks]
            c = torch.as_tensor(coeff, device=self.SA.device).to(
                self.SA.dtype)
            bidx = torch.as_tensor(blocks, device=self.SA.device)
            out = torch.empty(d + d * d, dtype=self.SA.dtype,
                              device=self.SA.device)
            out[:d] = c @ self.grads[bidx]
            rows = self.SA[bidx]
            torch.matmul((rows * c[:, None, None]).reshape(-1, d).T,
                         rows.reshape(-1, d), out=out[d:].view(d, d))
            return out


class _Picked:
    """The responders' messages in responder order, read on demand."""

    def __init__(self, messages, responders):
        self.messages = messages
        self.responders = responders

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.messages[int(self.responders[i])]


class NewtonSketchProblem:
    """Second-order worker problem: the per-round task is a coded
    Hessian-sketch block.  ``second_order = True`` routes the scheduler
    through ``run_round_newton`` (round messages up, Newton step at the
    master) instead of the ADMM x/z/u machinery."""

    second_order = True

    def __init__(self, logreg_cfg, *, lam2: float = 1e-3,
                 sketch: str = "count", sketch_dim: Optional[int] = None,
                 redundancy: int = 1, coded: bool = True,
                 scheme: str = "auto", line_search_max: int = 20,
                 dtype=torch.float32, device="cuda"):
        self.cfg = logreg_cfg
        self.lam2 = float(lam2)
        self.sketch = sketch
        self.sketch_dim = int(sketch_dim if sketch_dim is not None
                              else 8 * logreg_cfg.n_features)
        self.redundancy = int(redundancy)
        self.coded = bool(coded)
        self.scheme = scheme
        self.ls_max = int(line_search_max)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_features = logreg_cfg.n_features
        # the rows, keyed (0, 1) like a one-worker logreg shard, so
        # ``base.carry_shards`` can seed them
        self._shard_cache: Dict[Tuple[int, int], Tuple] = {}
        self._rows64: Optional[Tuple] = None
        self._plans: Dict[int, BlockSketch] = {}
        self._row_block: Dict[int, torch.Tensor] = {}
        self._round_cache: Optional[Tuple] = None    # (key, msgs, iters)

    # -- data ---------------------------------------------------------------
    def _rows(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """All N rows in sparse (idx, vals, b) form: the samples of the
        reference's dense ``worker_shard(cfg, 0, 1)``."""
        if (0, 1) not in self._shard_cache:
            idx, vals, b = data_mod.worker_shard_sparse(
                self.cfg, 0, 1, device=self.device)
            self._shard_cache[(0, 1)] = (idx, vals.to(self.dtype),
                                         b.to(self.dtype))
        return self._shard_cache[(0, 1)]

    def _data64(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """float64 view of the rows for the master's line search: the
        Armijo test compares objective values whose differences shrink
        below float32 epsilon near convergence."""
        idx, vals, b = self._rows()
        if self._rows64 is None or self._rows64[0] is not idx:
            self._rows64 = (idx, vals.double(), b.double())
        return self._rows64

    def _plan(self, n_workers: int) -> BlockSketch:
        if n_workers not in self._plans:
            self._plans[n_workers] = BlockSketch(
                self.cfg.n_samples, n_workers, sketch_dim=self.sketch_dim,
                redundancy=min(self.redundancy, n_workers - 1),
                method=self.sketch, coded=self.coded, scheme=self.scheme,
                seed=self.cfg.seed + 1)
        return self._plans[n_workers]

    # -- scheduler contract -------------------------------------------------
    @property
    def message_floats(self) -> int:
        """Uplink floats per task: gradient shard (d) + vec Gram (d²)."""
        return self.n_features + self.n_features ** 2

    def n_samples(self, wid: int, n_workers: int) -> int:
        """Rows streamed per sketch pass (every block touches all N rows);
        block multiplicity is modeled in ``task_iters``."""
        return self.cfg.n_samples

    def task_iters(self, n_workers: int) -> int:
        """Deterministic per-task cost in row-pass equivalents: r = s+1
        sketch passes when coded (1 uncoded), each one stream over the N
        rows plus the block Gram (≈ block_rows·d row-equivalents)."""
        plan = self._plan(n_workers)
        per_block = 1.0 + plan.block_rows * self.n_features / max(
            self.cfg.n_samples, 1)
        return max(1, int(round(plan.blocks_per_task() * per_block)))

    # -- worker rounds ------------------------------------------------------
    def _row_blocks(self, n_workers: int) -> torch.Tensor:
        """Gradient-shard partition: row i belongs to block k iff i is in
        ``shard_rows(N, W, k)``, the first-order workloads' near-even
        split, here protected by the same code as the Gram."""
        if n_workers not in self._row_block:
            N = self.cfg.n_samples
            out = np.zeros(N, np.int64)
            for k in range(n_workers):
                lo, hi = shard_rows(N, n_workers, k)
                out[lo:hi] = k
            self._row_block[n_workers] = torch.as_tensor(out,
                                                         device=self.device)
        return self._row_block[n_workers]

    def round_messages_all(self, z, n_workers: int
                           ) -> Tuple[RoundMessages, np.ndarray]:
        """Batched engine hook: every task's work in one pass — margins,
        the weighted sketch of all blocks, the gradient shards.  Returns
        (messages ``RoundMessages``, iters (W,))."""
        idx, vals, b = self._rows()
        plan = self._plan(n_workers)
        z = torch.as_tensor(z, device=self.device).to(self.dtype)
        margins = -b * torch.sum(vals * z[idx], dim=-1)
        sig = torch.sigmoid(margins)
        coef = -b * sig                               # ∇ loss = Aᵀ coef
        w = sig * (1.0 - sig)                         # Hessian weights
        with trace.span("newton.scatter"):
            SA = plan.apply_all((idx, vals), weights=torch.sqrt(w),
                                n_cols=self.n_features)  # (W, rows, d)
        grads = torch.zeros((n_workers, self.n_features), dtype=self.dtype,
                            device=self.device)
        flat = self._row_blocks(n_workers)[:, None] * self.n_features + idx
        add_at(grads, flat.reshape(-1), (coef[:, None] * vals).reshape(-1))
        iters = np.full(n_workers, self.task_iters(n_workers), np.int64)
        return RoundMessages(plan, SA, grads), iters

    def round_message(self, wid: int, n_workers: int, z
                      ) -> Tuple[torch.Tensor, int]:
        """Loop engine hook: task ``wid``'s message.  The round is computed
        once per (z, W) and read per task, so loop and batched engines
        emit identical messages by construction."""
        zt = torch.as_tensor(z, device=self.device).to(self.dtype)
        key = (n_workers, zt.cpu().numpy().tobytes())
        if self._round_cache is None or self._round_cache[0] != key:
            self._round_cache = (key, *self.round_messages_all(zt, n_workers))
        _, msgs, iters = self._round_cache
        return msgs[wid], int(iters[wid])

    # -- master step --------------------------------------------------------
    def _objective64(self, z64: torch.Tensor) -> float:
        idx, vals, b = self._data64()
        margins = -b * torch.sum(vals * z64[idx], dim=-1)
        return float(torch.sum(torch.logaddexp(torch.zeros_like(margins),
                                               margins))
                     + 0.5 * self.lam2 * torch.dot(z64, z64))

    def _newton_direction(self, H: torch.Tensor,
                          grad: torch.Tensor) -> torch.Tensor:
        """p = -H⁻¹ grad in float64; -grad when H is singular or p is not a
        descent direction (the globalization guard)."""
        with trace.span("newton.solve"):
            sol, info = torch.linalg.solve_ex(H, grad)
            p = -grad if int(info) != 0 else -sol
            if float(grad @ p) >= 0.0:
                p = -grad
            return p

    def _line_search(self, z64: torch.Tensor, p: torch.Tensor,
                     grad: torch.Tensor) -> Tuple[float, bool, int]:
        """Armijo backtracking from alpha = 1.  Returns (alpha, whether the
        Armijo test accepted it, objective evaluations); when no trial
        passes, the best trial's alpha."""
        with trace.span("newton.line_search"):
            f0 = self._objective64(z64)
            gTp = float(grad @ p)
            alpha, best_alpha, best_f = 1.0, 1.0, np.inf
            for n in range(1, self.ls_max + 1):
                f_try = self._objective64(z64 + alpha * p)
                if f_try <= f0 + 1e-4 * alpha * gTp:     # Armijo
                    return alpha, True, n + 1
                if f_try < best_f:
                    best_alpha, best_f = alpha, f_try
                alpha *= 0.5
            return best_alpha, False, self.ls_max + 1

    def decode(self, messages, responders: np.ndarray,
               n_workers: int) -> Tuple[torch.Tensor, int]:
        """(Σ of the blocks' values, n_blocks_summed) from the responders'
        messages, ``messages[w]`` being task w's (a ``RoundMessages`` or a
        list of rows): only the responders' are read, one at a time, and
        combined in their dtype (``BlockSketch.decode_sum``)."""
        return self._plan(n_workers).decode_sum(
            responders, _Picked(messages, responders))

    def master_step(self, z, messages, responders: np.ndarray,
                    n_workers: int) -> Tuple[torch.Tensor, float, float]:
        """Decode → sketched-Hessian solve → Armijo line search.

        ``messages[w]`` is task w's message for every task; the decode
        (``decode``) reads only the responders', then widens the sum to
        float64, as the reference combines.  Returns (z_new float64,
        r_norm, s_norm) with r_norm = ‖∇f(z)‖₂ (the convergence residual)
        and s_norm = ‖α·p‖₂ (the step size)."""
        d = self.n_features
        plan = self._plan(n_workers)
        responders = np.asarray(responders)
        z64 = torch.as_tensor(z, device=self.device).double()
        total, n_used = self.decode(messages, responders, n_workers)
        total = total.double()
        g_loss = total[:d]
        if not plan.coded:
            # ignore-extra-blocks: rescale the partial gradient by the
            # share of data rows actually covered by the arrived shards
            N = self.cfg.n_samples
            rows = sum(shard_rows(N, n_workers, int(k))[1]
                       - shard_rows(N, n_workers, int(k))[0]
                       for k in responders)
            g_loss = g_loss * (N / max(rows, 1))
        grad = g_loss + self.lam2 * z64
        # H = total/n_used + lam2·I, in place on the widened total (no
        # further d² temporaries; the same roundings)
        H = total[d:].view(d, d)
        H /= n_used
        H.diagonal().add_(self.lam2)
        p = self._newton_direction(H, grad)
        alpha, _, _ = self._line_search(z64, p, grad)
        step = alpha * p
        return (z64 + step, float(torch.linalg.vector_norm(grad)),
                float(torch.linalg.vector_norm(step)))

    # -- reporting / conformance helpers ------------------------------------
    def full_grad(self, z) -> torch.Tensor:
        """Exact ∇f(z) in float64 on the problem's device."""
        idx, vals, b = self._data64()
        z64 = torch.as_tensor(z, device=self.device).double()
        margins = -b * torch.sum(vals * z64[idx], dim=-1)
        coef = -b / (1.0 + torch.exp(-margins))
        g = torch.zeros(self.n_features, dtype=torch.float64,
                        device=self.device)
        add_at(g, idx.reshape(-1), (coef[:, None] * vals).reshape(-1))
        return g + self.lam2 * z64

    def objective(self, x, n_workers: int = 1) -> float:
        return self._objective64(torch.as_tensor(x, device=self.device)
                                 .double())

    def h_value(self, z) -> float:
        return 0.5 * self.lam2 * float(torch.dot(z, z))

    def prox_h(self, v, t):
        """Protocol stub — the Newton path never runs the ADMM z-update."""
        return v

    def solve(self, wid, n_workers, x0, z, u, rho):
        raise NotImplementedError(
            "newton_sketch is a second-order workload: workers compute "
            "Hessian-sketch blocks (round_message), not FISTA shard solves")


@base.register("newton_sketch")
def make_newton_sketch(n_samples: int = 2048, n_features: int = 128,
                       density: float = 0.05, lam2: float = 1e-3,
                       seed: int = 0, sketch: str = "count",
                       sketch_dim: Optional[int] = None,
                       redundancy: int = 1, coded: bool = True,
                       scheme: str = "auto", line_search_max: int = 20,
                       dtype="float32", device="cuda"
                       ) -> NewtonSketchProblem:
    """Registry factory, with the reference's defaults: the canonical
    reduced logreg instance's rows; ``sketch_dim`` defaults to 8·d."""
    cfg = scaled(n_samples, n_features, density=density, lam1=0.0,
                 seed=seed)
    return NewtonSketchProblem(cfg, lam2=lam2, sketch=sketch,
                               sketch_dim=sketch_dim,
                               redundancy=redundancy, coded=coded,
                               scheme=scheme,
                               line_search_max=line_search_max,
                               dtype=base.as_dtype(dtype), device=device)


class LogRegL2Problem(LogRegProblem):
    """logreg with h(z) = (lam2/2)||z||², prox_h(v, t) = v / (1 + t·lam2):
    the ADMM twin of ``newton_sketch`` (same rows, same objective).  No l1
    term, so the scheduler never fuses the z-update."""

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
