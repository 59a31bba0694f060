"""FISTA with backtracking (Beck & Teboulle '09) — the paper's local solver,
written once over a leading lane axis.

Every tensor carries a leading axis of L independent problems (L = 1 for
one worker, W for the batched engine).  ``value_and_grad(X)`` takes X
(L, d) and returns (f (L,), grad (L, d)).  The reference runs one
``lax.while_loop`` per lane under ``vmap``; here a Python loop runs while
any lane is active, and a finished lane's x, y, t, lip, f_x and k freeze
exactly where its own loop would have stopped, so each lane's ``k`` equals
its unbatched iteration count.  The inner backtracking loop masks the
same way: a lane stops doubling its Lipschitz estimate once its
sufficient-decrease test holds.

Termination follows Section III of the paper:
  * run at least ``min_iters`` (K_w) iterations,
  * stop when ||grad|| <= eps_g  OR  (F_{k-1} - F_k)/F_{k-1} <= eps_f,
  * hard cap at ``max_iters``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import trace


@dataclasses.dataclass(frozen=True)
class FistaOptions:
    min_iters: int = 1            # K_w in the paper
    max_iters: int = 500
    eps_grad: float = 1e-2        # eps_g
    eps_fval: float = 1e-12       # eps_f (relative improvement)
    l0: float = 1.0               # initial Lipschitz estimate
    eta: float = 2.0              # backtracking multiplier
    max_backtracks: int = 30


class FistaState(NamedTuple):
    x: torch.Tensor               # (L, d) current iterate
    y: torch.Tensor               # (L, d) extrapolated point
    t: torch.Tensor               # (L,) momentum scalar
    lip: torch.Tensor             # (L,) current Lipschitz estimate
    f_x: torch.Tensor             # (L,) F(x)
    g_norm: torch.Tensor          # (L,) ||grad F(y)|| of last step
    rel_impr: torch.Tensor        # (L,) last relative improvement
    k: torch.Tensor               # (L,) int64 iteration counter


VG = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _backtrack(vg: VG, y, f_y, g_y, lip, opts: FistaOptions,
               active: torch.Tensor) -> torch.Tensor:
    """Per lane, find L (by eta-doubling) with
    F(y - g/L) <= F(y) - ||g||^2/(2L); lanes not ``active`` keep theirs."""
    with trace.span("fista.backtrack"):
        gsq = torch.sum(g_y * g_y, dim=-1)
        searching = active.clone()
        for _ in range(opts.max_backtracks):
            if not bool(searching.any()):
                break
            x_try = y - g_y / lip[:, None]
            f_try, _ = vg(x_try)
            trace.count("fista.evals")
            ok = f_try <= f_y - 0.5 * gsq / lip + 1e-12 * torch.abs(f_y)
            lip = torch.where(searching & ~ok, lip * opts.eta, lip)
            searching = searching & ~ok
    return lip


def _step(vg: VG, st: FistaState, opts: FistaOptions,
          active: torch.Tensor) -> FistaState:
    with trace.span("fista.step"):
        f_y, g_y = vg(st.y)
        trace.count("fista.evals")
        lip = _backtrack(vg, st.y, f_y, g_y, st.lip, opts, active)
        x_new = st.y - g_y / lip[:, None]
        f_new, _ = vg(x_new)
        trace.count("fista.evals")
        # monotone safeguard (MFISTA-lite): never accept an increase over x_k
        worse = f_new > st.f_x
        x_new = torch.where(worse[:, None], st.x, x_new)
        f_new = torch.where(worse, st.f_x, f_new)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * st.t * st.t))
        y_new = x_new + ((st.t - 1.0) / t_new)[:, None] * (x_new - st.x)
        rel = (st.f_x - f_new) / torch.clamp_min(torch.abs(st.f_x), 1e-30)
        new = FistaState(x=x_new, y=y_new, t=t_new, lip=lip, f_x=f_new,
                         g_norm=torch.linalg.vector_norm(g_y, dim=-1),
                         rel_impr=rel, k=st.k + 1)
        # lanes whose loop has ended keep their state, as under vmap
        return FistaState(*(torch.where(active[:, None] if n.dim() == 2
                                        else active, n, o)
                            for n, o in zip(new, st)))


def _init(vg: VG, x0: torch.Tensor, opts: FistaOptions) -> FistaState:
    f0, _ = vg(x0)
    trace.count("fista.evals")
    lanes = x0.shape[0]

    def full(v):
        return torch.full((lanes,), v, dtype=f0.dtype, device=f0.device)
    return FistaState(x=x0, y=x0, t=full(1.0), lip=full(opts.l0), f_x=f0,
                      g_norm=full(float("inf")),
                      rel_impr=full(float("inf")),
                      k=torch.zeros((lanes,), dtype=torch.int64,
                                    device=f0.device))


def _running(st: FistaState, opts: FistaOptions) -> torch.Tensor:
    not_min = st.k < opts.min_iters
    under_max = st.k < opts.max_iters
    grad_big = st.g_norm > opts.eps_grad
    impr_big = st.rel_impr > opts.eps_fval
    return under_max & (not_min | (grad_big & impr_big))


def fista(value_and_grad: VG, x0: torch.Tensor,
          opts: FistaOptions = FistaOptions()
          ) -> Tuple[torch.Tensor, FistaState]:
    """Minimise every lane's F from ``value_and_grad``; x0 (L, d).
    Returns (x* (L, d), final state)."""
    st = _init(value_and_grad, x0, opts)
    active = _running(st, opts)
    while bool(active.any()):
        st = _step(value_and_grad, st, opts, active)
        active = _running(st, opts)
    return st.x, st


def fista_fixed(value_and_grad: VG, x0: torch.Tensor, n_iters: int,
                opts: FistaOptions = FistaOptions()
                ) -> Tuple[torch.Tensor, FistaState]:
    """Fixed-iteration-count FISTA: every lane runs ``n_iters`` steps."""
    st = _init(value_and_grad, x0, opts)
    every = torch.ones((x0.shape[0],), dtype=torch.bool, device=x0.device)
    for _ in range(n_iters):
        st = _step(value_and_grad, st, opts, every)
    return st.x, st


def solve_lanes(value_and_grad: VG, x0: torch.Tensor,
                opts: FistaOptions, fixed: Optional[int] = None
                ) -> Tuple[torch.Tensor, FistaState]:
    """Adaptive FISTA, or ``fista_fixed`` when ``fixed`` is set."""
    if fixed is not None:
        return fista_fixed(value_and_grad, x0, fixed, opts)
    return fista(value_and_grad, x0, opts)
