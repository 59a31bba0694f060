"""Plain consensus ADMM for l1-regularised logistic regression on sparse
rows: the benchmark's reference, and the comparison that judges a solve.

Written from the paper (arXiv:1901.03161, Algorithms 1 and 2 and Section
III): each of W workers holds the rows of its shard (the near-even split)
and solves its x-update, argmin f_w(x) + rho/2 ||x - (z - u)||^2, by FISTA
with backtracking (Beck and Teboulle 2009) and a monotone safeguard; the
master averages omega = x + u, soft-thresholds at lam / (W rho) for z,
takes the residuals r = ||x - z|| over the workers and s = rho sqrt(W)
||z - z_prev||, and balances rho (Boyd et al. 2011, section 3.4.1: times
2 when r > 10 s, halved when s > 10 r, in float32), rescaling the scaled
duals u.  Plain PyTorch on whatever device the rows are on; no kernel,
no code and no state of the program.

Two uses:

* ``run_solve`` runs a whole solve from cold in a given precision and
  returns what the program's solve is captured as; in bfloat16 it is the
  control, the reference put in the program's place one precision lower.
* ``judge`` holds a captured solve, round by round, against the
  reference in float64 from the solve's own state at the start of each
  round.  A float32 FISTA ends where its relative improvement rounds to
  zero, which float32 rounding decides, so the reference runs each lane
  for as many iterations as the solve reports; the counts themselves are
  held to the stopping rule at the reference's iterates (``stop_gap``),
  to their bounds, and by the simulator's clock.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference.simulator import SyncSim, shard_rows


@dataclasses.dataclass(frozen=True)
class Fista:
    min_iters: int = 1
    max_iters: int = 500
    eps_grad: float = 1e-2
    eps_fval: float = 1e-12
    l0: float = 1.0
    eta: float = 2.0
    max_backtracks: int = 30


@dataclasses.dataclass(frozen=True)
class Admm:
    lam1: float
    rho0: float
    eps_primal: float
    eps_dual: float
    mu: float = 10.0
    tau_inc: float = 2.0
    tau_dec: float = 2.0


class LaneRows:
    """The rows by worker lane, for W lanes of x at once."""

    def __init__(self, rows, n_workers: int, n_features: int, dtype):
        idx, vals, b = rows
        n = idx.shape[0]
        dev = idx.device
        lane = torch.empty(n, dtype=torch.long, device=dev)
        for w in range(n_workers):
            lo, hi = shard_rows(n, n_workers, w)
            lane[lo:hi] = w
        self.W, self.d, self.dtype = n_workers, n_features, dtype
        self.lane = lane
        self.flat = lane[:, None] * n_features + idx
        self.vals = vals.to(dtype)
        self.b = b.to(dtype)

    def value_and_grad(self, X):
        """f_w(x_w) = sum over w's rows of log(1 + exp(-b a.x_w)) and its
        gradient, for every lane: X (W, d) -> ((W,), (W, d))."""
        ax = torch.sum(self.vals * X.reshape(-1)[self.flat], dim=1)
        m = -self.b * ax
        loss = torch.logaddexp(torch.zeros_like(m), m)
        f = torch.zeros(self.W, dtype=X.dtype, device=X.device)
        f.index_add_(0, self.lane, loss)
        coef = -self.b * torch.sigmoid(m)
        g = torch.zeros(self.W * self.d, dtype=X.dtype, device=X.device)
        g.index_add_(0, self.flat.reshape(-1),
                     (coef[:, None] * self.vals).reshape(-1))
        return f, g.view(self.W, self.d)


def fista(vg, x0, opts: Fista, counts: Optional[torch.Tensor] = None):
    """FISTA with backtracking over lanes: vg(X) -> (F (L,), grad (L, d)).
    Lanes stop by the paper's rule (at least ``min_iters``; then when the
    gradient norm falls to ``eps_grad`` or the relative improvement to
    ``eps_fval``; at most ``max_iters``), or after exactly ``counts``
    iterations each when given.  A lane that has stopped keeps its state.
    Returns (x (L, d), iterations (L,), where each lane stopped: the
    rule's gradient norm and relative improvement of its last iteration,
    ``g`` and ``rel``, and the gradient norm of the one before,
    ``g_prev``; inf where there is none)."""
    lanes = x0.shape[0]
    f_x, _ = vg(x0)
    full = lambda v: torch.full((lanes,), v, dtype=f_x.dtype,  # noqa: E731
                                device=f_x.device)
    x, y, t, lip = x0, x0, full(1.0), full(opts.l0)
    g_norm, rel, g_prev = full(math.inf), full(math.inf), full(math.inf)
    k = torch.zeros(lanes, dtype=torch.long, device=x0.device)

    def running():
        if counts is not None:
            return k < counts
        return (k < opts.max_iters) & ((k < opts.min_iters)
                                       | ((g_norm > opts.eps_grad)
                                          & (rel > opts.eps_fval)))

    active = running()
    while bool(active.any()):
        f_y, g_y = vg(y)
        gsq = torch.sum(g_y * g_y, dim=-1)
        searching = active.clone()
        for _ in range(opts.max_backtracks):
            if not bool(searching.any()):
                break
            f_try, _ = vg(y - g_y / lip[:, None])
            ok = f_try <= f_y - 0.5 * gsq / lip + 1e-12 * torch.abs(f_y)
            lip = torch.where(searching & ~ok, lip * opts.eta, lip)
            searching = searching & ~ok
        x_new = y - g_y / lip[:, None]
        f_new, _ = vg(x_new)
        worse = f_new > f_x
        x_new = torch.where(worse[:, None], x, x_new)
        f_new = torch.where(worse, f_x, f_new)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y_new = x_new + ((t - 1.0) / t_new)[:, None] * (x_new - x)
        rel_new = (f_x - f_new) / torch.clamp_min(torch.abs(f_x), 1e-30)
        a1 = active[:, None]
        x, y = torch.where(a1, x_new, x), torch.where(a1, y_new, y)
        t = torch.where(active, t_new, t)
        f_x = torch.where(active, f_new, f_x)
        g_prev = torch.where(active, g_norm, g_prev)
        g_norm = torch.where(active, torch.linalg.vector_norm(g_y, dim=-1),
                             g_norm)
        rel = torch.where(active, rel_new, rel)
        k = k + active.long()
        active = running()
    return x, k, SimpleNamespace(g=g_norm, rel=rel, g_prev=g_prev)


def augmented(lane_rows: LaneRows, center, rho: float):
    def vg(X):
        f, g = lane_rows.value_and_grad(X)
        dx = X - center
        return f + 0.5 * rho * torch.sum(dx * dx, dim=-1), g + rho * dx
    return vg


def soft_threshold(v, thr):
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - thr, 0.0)


def new_penalty(rho: float, r: float, s: float, a: Admm) -> float:
    """Residual balancing, in float32 as the configuration states rho."""
    rho = np.float32(rho)
    if r > a.mu * s:
        return float(rho * np.float32(a.tau_inc))
    if s > a.mu * r:
        return float(rho / np.float32(a.tau_dec))
    return float(rho)


def run_solve(lane_rows: LaneRows, admm: Admm, opts: Fista, rounds: int,
              sim: SyncSim) -> List[dict]:
    """A whole solve from cold in ``lane_rows.dtype``, captured as the
    program's solve is (see ``judge``)."""
    W, d, dt = lane_rows.W, lane_rows.d, lane_rows.dtype
    dev = lane_rows.vals.device
    x = torch.zeros((W, d), dtype=dt, device=dev)
    u = torch.zeros_like(x)
    z = torch.zeros(d, dtype=dt, device=dev)
    rho = float(np.float32(admm.rho0))
    out = []
    for _ in range(rounds):
        r = x - z[None, :]
        us = u + r
        r_norm = float(torch.sqrt(torch.sum(r * r)))
        x_new, its, _ = fista(augmented(lane_rows, z[None, :] - us, rho),
                              x, opts)
        omega = torch.mean(x_new + us, dim=0)
        thr = admm.lam1 / (W * rho)
        z_new = soft_threshold(omega, thr)
        ssq = float(torch.sum((z_new - z) ** 2))
        s_norm = rho * math.sqrt(ssq) * math.sqrt(W)
        rho_new = new_penalty(rho, r_norm, s_norm, admm)
        counts = its.cpu().numpy()
        sim_time, cost = sim.round(counts)
        metrics = SimpleNamespace(
            r_norm=r_norm, s_norm=s_norm, rho=rho_new, inner_iters=counts,
            sim_time=sim_time, cost_usd=cost,
            z_nnz=int(torch.count_nonzero(z_new)))
        out.append(dict(x0=x, us=us, z=z, rho=rho, x_new=x_new,
                        counts=counts, omega=omega, z_new=z_new, thr=thr,
                        metrics=metrics))
        u = us * (rho / rho_new) if rho_new != rho else us
        x, z, rho = x_new, z_new, rho_new
        if r_norm <= admm.eps_primal and s_norm <= admm.eps_dual:
            break
    return out


# float32's epsilon: the scale of relative improvement below which a
# float32 solver's improvement rounds to zero
F32_EPS = 2.0 ** -23


def stop_gap(stop, counts: torch.Tensor, opts: Fista) -> float:
    """How far the lanes' counts miss the stopping rule, read at the
    float64 reference's iterates after those counts (``fista``'s
    ``stop``); the widest lane, 1 or under where the rule holds:

    * a lane that stopped below ``max_iters``: the smaller of its last
      gradient norm over ``eps_grad`` and its last relative improvement
      over the larger of ``eps_fval`` and float32's epsilon (a float32
      solver's improvement rounds to zero at that scale, which rounding
      decides, not the reference);
    * a lane at least ``min_iters`` steps in one step before it stopped:
      ``eps_grad`` over that step's gradient norm, over 1 where the
      gradient test held a step early.  (That step's improvement is not
      read: float32 rounding decides where it reached zero.)"""
    k = counts.to(stop.g.device)
    zero = torch.zeros_like(stop.g)
    early = torch.minimum(stop.g / opts.eps_grad,
                          torch.clamp_min(stop.rel, 0.0)
                          / max(opts.eps_fval, F32_EPS))
    early = torch.where(k < opts.max_iters, early, zero)
    late = torch.where(k - 1 >= opts.min_iters, opts.eps_grad / stop.g_prev,
                       zero)
    return float(torch.max(torch.maximum(early, late)))


def _rel(a, b, floor=0.0) -> float:
    a, b = a.double(), b.double()
    den = max(float(torch.linalg.vector_norm(b)), floor)
    num = float(torch.linalg.vector_norm(a - b))
    return 0.0 if num == 0.0 else num / max(den, 1e-300)


def _scalar_rel(a: float, b: float) -> float:
    return 0.0 if a == b else abs(a - b) / max(abs(b), 1e-300)


def judge(solves: List[List[dict]], lane_rows: LaneRows, admm: Admm,
          opts: Fista, rounds: int, make_sim, complete: List[bool]
          ) -> List[Dict[str, float]]:
    """Hold captured solves against the float64 reference.  Each round's
    record holds the state the round started from (x0, us = u + x0 - z,
    z, rho), what it produced (x_new, counts, omega, z_new) and the
    program's RoundMetrics (``metrics``).  Returns, for each round in
    order, the compared numbers:

    * ``x_gap``: the x-update, by lane: ||x_new - x_ref|| over the larger
      of ||x_ref|| and the median lane's, the widest lane;
    * ``stop_gap``: the counts against the stopping rule (``stop_gap``);
    * ``master_gap``: the widest relative gap of omega, z (against
      ||omega||), r, s and the state carried into the round (x, z and the
      rescaled dual from the round before; zero and rho0 at a solve's
      start);
    * ``exact_mismatches``: rho against the rule, counts against the
      metrics and their bounds, nnz(z), the simulated seconds and dollars
      against the simulator fed the same counts, and the solve's end
      against the tolerance: each disagreement counts one.
    """
    if lane_rows.dtype != torch.float64:
        raise ValueError("the judge runs the reference in float64")
    W = lane_rows.W
    dev = lane_rows.vals.device
    f64 = torch.float64
    out: List[Dict[str, float]] = []
    # round index -> (state, rho, counts, x_ref, stop): solves that start a
    # round from the same state reuse its reference
    refs: Dict[int, tuple] = {}
    for si, solve in enumerate(solves):
        sim = make_sim()
        prev = None
        for ki, rec in enumerate(solve):
            bad = 0
            x0, us, z = (rec[n].to(dev, f64) for n in ("x0", "us", "z"))
            x_new = rec["x_new"].to(dev, f64)
            z_new = rec["z_new"].to(dev, f64)
            omega = rec["omega"].to(dev, f64)
            rho, m = float(rec["rho"]), rec["metrics"]
            counts = np.asarray(rec["counts"], np.int64)
            # the state carried in
            if prev is None:
                carry = max(float(torch.linalg.vector_norm(t))
                            for t in (x0, us, z))
                bad += int(rho != float(np.float32(admm.rho0)))
            else:
                p_rho = float(prev["rho"])
                u_in = prev["us"].to(dev, f64)
                if rho != p_rho:
                    u_in = u_in * (p_rho / rho)
                us_ref = u_in + prev["x_new"].to(dev, f64) \
                    - prev["z_new"].to(dev, f64)
                carry = max(_rel(x0, prev["x_new"]), _rel(z, prev["z_new"]),
                            _rel(us, us_ref))
                bad += int(rho != float(prev["metrics"].rho))
            # the x-update, from this state, as many iterations per lane
            cached = refs.get(ki)
            if (cached is not None and cached[1] == rho
                    and np.array_equal(cached[2], counts)
                    and all(torch.equal(a, b)
                            for a, b in zip(cached[0], (x0, us, z)))):
                x_ref, stopped = cached[3], cached[4]
            else:
                k = torch.as_tensor(counts, device=dev)
                x_ref, _, stop = fista(
                    augmented(lane_rows, z[None, :] - us, rho), x0, opts,
                    counts=k)
                stopped = stop_gap(stop, k, opts)
                refs[ki] = ((x0, us, z), rho, counts, x_ref, stopped)
            norms = torch.linalg.vector_norm(x_ref, dim=1)
            den = torch.clamp_min(norms, float(torch.median(norms)))
            lane_gap = torch.linalg.vector_norm(x_new - x_ref, dim=1) / \
                torch.clamp_min(den, 1e-300)
            # the master
            omega_ref = torch.mean(x_new + us, dim=0)
            z_ref = soft_threshold(omega, admm.lam1 / (W * rho))
            r_ref = float(torch.linalg.vector_norm(x0 - z[None, :]))
            s_ref = rho * float(torch.linalg.vector_norm(z_new - z)) \
                * math.sqrt(W)
            master = max(
                carry, _rel(omega, omega_ref),
                _rel(z_new, z_ref, float(torch.linalg.vector_norm(omega_ref))),
                _scalar_rel(float(m.r_norm), r_ref),
                _scalar_rel(float(m.s_norm), s_ref))
            # what must hold exactly
            its = np.asarray(m.inner_iters, np.int64)
            bad += int(float(m.rho) != new_penalty(rho, float(m.r_norm),
                                                   float(m.s_norm), admm))
            bad += int(not np.array_equal(its, counts))
            bad += int(bool((counts < opts.min_iters).any()
                            or (counts > opts.max_iters).any()))
            if int(m.z_nnz) >= 0:
                bad += int(int(m.z_nnz) != int(torch.count_nonzero(z_new)))
            sim_time, cost = sim.round(counts)
            bad += int(float(m.sim_time) != sim_time)
            bad += int(float(m.cost_usd) != cost)
            # the solve ends at the tolerance or at the round limit
            met = (float(m.r_norm) <= admm.eps_primal
                   and float(m.s_norm) <= admm.eps_dual)
            last = ki == len(solve) - 1
            if not last:
                bad += int(met)
            elif complete[si]:
                bad += int(not met and len(solve) != rounds)
            out.append({"x_gap": float(lane_gap.max()),
                        "stop_gap": stopped,
                        "master_gap": master,
                        "exact_mismatches": float(bad)})
            prev = rec
    return out
