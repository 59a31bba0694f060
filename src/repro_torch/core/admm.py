"""Global-variable-consensus ADMM (Eqs. 5-7 / Algorithms 1-2 of the paper) —
the counterpart of ``repro.core.admm``.

Two execution styles over the same math:

* ``admm_solve`` — every worker as one lane of a batched FISTA over stacked
  shards; the master reduce is a mean over the worker axis.
* the event-driven form in ``repro_torch.runtime.scheduler`` — the same
  per-worker math (``worker_round``) invoked worker by worker by the
  serverless pool simulator.  Both adapt the penalty by ``new_penalty``.

Notation: Algorithm 1 accumulates omega = mean_w(x^w + u^w) and
q = sum_w ||x^w - z||^2; the z-update is the prox of h at omega with
penalty W*rho (Boyd §7.1 consensus form).  Scalars are float32 tensors, as
the reference's are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fista as fista_mod
from repro_torch.core.fista import FistaOptions


@dataclasses.dataclass(frozen=True)
class AdmmOptions:
    rho0: float = 1.0
    max_iters: int = 100          # K
    eps_primal: float = 2e-2      # eps_r
    eps_dual: float = 2e-2        # eps_s
    # penalty adaptation (Boyd §3.4.1, the paper's rule)
    mu: float = 10.0
    tau_inc: float = 2.0
    tau_dec: float = 2.0
    fista: FistaOptions = FistaOptions()


class WorkerState(NamedTuple):
    x: torch.Tensor               # local primal copy (d,)
    u: torch.Tensor               # local (scaled) dual (d,)


class MasterState(NamedTuple):
    z: torch.Tensor               # global consensus variable (d,)
    z_prev: torch.Tensor
    rho: torch.Tensor             # penalty (scalar)
    r_norm: torch.Tensor          # primal residual norm
    s_norm: torch.Tensor          # dual residual norm
    k: int                        # round counter


def _f32(v, device=None) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def init_worker(d: int, device=None) -> WorkerState:
    return WorkerState(x=torch.zeros((d,), device=device),
                       u=torch.zeros((d,), device=device))


def init_master(d: int, rho0: float, device=None) -> MasterState:
    return MasterState(z=torch.zeros((d,), device=device),
                       z_prev=torch.zeros((d,), device=device),
                       rho=_f32(rho0, device), r_norm=_f32(math.inf, device),
                       s_norm=_f32(math.inf, device), k=0)


# ---------------------------------------------------------------------------
# Worker side (Algorithm 2 body)
# ---------------------------------------------------------------------------


def worker_round(local_vg: Callable, state: WorkerState, z: torch.Tensor,
                 rho: torch.Tensor, opts: FistaOptions, *,
                 fixed_iters: Optional[int] = None
                 ) -> Tuple[WorkerState, torch.Tensor, torch.Tensor, int]:
    """One ADMM round for one worker; ``local_vg(x (d,)) -> (f, grad)``.
    Returns (new_state, q = ||x_k - z_k||^2, omega = x_{k+1} + u_{k+1},
    inner_iters)."""
    r = state.x - z
    u_new = state.u + r
    q = torch.dot(r, r)
    center = z - u_new

    def aug_vg(X):
        f, g = local_vg(X[0])
        diff = X[0] - center
        return ((f + 0.5 * rho * torch.dot(diff, diff))[None],
                (g + rho * diff)[None])

    x_new, info = fista_mod.solve_lanes(aug_vg, state.x[None], opts,
                                        fixed_iters)
    x_new = x_new[0]
    return WorkerState(x=x_new, u=u_new), q, x_new + u_new, int(info.k[0])


# ---------------------------------------------------------------------------
# Master side (Algorithm 1 body)
# ---------------------------------------------------------------------------


def new_penalty(rho, r_norm: float, s_norm: float,
                opts: AdmmOptions) -> np.float32:
    """Boyd §3.4.1 residual-balancing rule (the paper's new_penalty), in
    float32 like the reference's ``new_penalty(jnp.float32(rho), ...)``.

    When rho changes, every worker's SCALED dual must be rescaled,
    u <- u * (rho_old / rho_new) (Boyd §3.4.1): u = y/rho, and it is y,
    not u, that is the persistent dual."""
    rho = np.float32(rho)
    if r_norm > opts.mu * s_norm:
        return rho * np.float32(opts.tau_inc)
    if s_norm > opts.mu * r_norm:
        return rho / np.float32(opts.tau_dec)
    return rho


def master_update(master: MasterState, omega_bar: torch.Tensor,
                  q_sum: torch.Tensor, n_workers: int, prox_h: Callable,
                  opts: AdmmOptions) -> MasterState:
    """z-update (Eq. 6), residuals, penalty adaptation."""
    rho = master.rho
    # Eq. 6: argmin_z h(z) + (W*rho/2)||z - omega_bar||^2
    z_new = prox_h(omega_bar, 1.0 / (n_workers * rho))
    r_norm = torch.sqrt(q_sum)
    s_norm = rho * torch.linalg.vector_norm(z_new - master.z) * torch.sqrt(
        _f32(n_workers, rho.device))
    rho_new = _f32(new_penalty(float(rho), float(r_norm), float(s_norm),
                               opts), rho.device)
    return MasterState(z=z_new, z_prev=master.z, rho=rho_new,
                       r_norm=r_norm, s_norm=s_norm, k=master.k + 1)


def converged(master: MasterState, opts: AdmmOptions) -> bool:
    resid_ok = bool(master.r_norm <= opts.eps_primal
                    and master.s_norm <= opts.eps_dual)
    return resid_ok or master.k >= opts.max_iters


# ---------------------------------------------------------------------------
# Batched synchronous solve (every worker a lane)
# ---------------------------------------------------------------------------


class AdmmTrace(NamedTuple):
    r_norms: torch.Tensor
    s_norms: torch.Tensor
    rhos: torch.Tensor
    inner_iters: torch.Tensor


def admm_solve(batched_vg: Callable, d: int, n_workers: int,
               opts: AdmmOptions, prox_h: Callable, *,
               fixed_inner: Optional[int] = None,
               trace_len: Optional[int] = None, device=None
               ) -> Tuple[torch.Tensor, MasterState, AdmmTrace]:
    """Synchronous parallel consensus ADMM over W lanes.

    ``batched_vg(x_stack (W, d)) -> (loss (W,), grad (W, d))`` evaluates
    the worker-local smooth losses over stacked shards.  Every worker's
    FISTA is a lane of ``core.fista`` (each lane keeps its own stopping
    rule and iteration count, as under the reference's vmap).  Returns
    (z*, final master state, trace of the first ``trace_len`` rounds —
    default ``opts.max_iters``; later rounds are not recorded)."""
    T = trace_len or opts.max_iters
    x = torch.zeros((n_workers, d), device=device)
    u = torch.zeros((n_workers, d), device=device)
    master = init_master(d, opts.rho0, device)
    nan = torch.full((T,), math.nan, device=device)
    trace = AdmmTrace(r_norms=nan.clone(), s_norms=nan.clone(),
                      rhos=nan.clone(),
                      inner_iters=torch.zeros((T,), dtype=torch.int32,
                                              device=device))
    while not converged(master, opts):
        # ---- Algorithm 2, all workers at once -----------------------------
        r = x - master.z[None, :]
        u = u + r
        q = torch.sum(r * r, dim=-1)
        center = master.z[None, :] - u
        rho = master.rho

        def aug_vg(X):
            f, g = batched_vg(X)
            diff = X - center
            return (f + 0.5 * rho * torch.sum(diff * diff, dim=-1),
                    g + rho * diff)

        x, info = fista_mod.solve_lanes(aug_vg, x, opts.fista, fixed_inner)
        omega = x + u

        # ---- Algorithm 1, master reduce + z-update ------------------------
        new = master_update(master, torch.mean(omega, dim=0),
                            torch.sum(q), n_workers, prox_h, opts)
        if master.k < T:
            trace.r_norms[master.k] = new.r_norm
            trace.s_norms[master.k] = new.s_norm
            trace.rhos[master.k] = master.rho
            trace.inner_iters[master.k] = int(info.k.max())
        # rho changed -> rescale the scaled duals (see new_penalty)
        u = u * (master.rho / new.rho)
        master = new
    return master.z, master, trace
