"""Consensus ADMM for LM training (a port of ``repro/core/trainer.py``).

Global-variable-consensus ADMM (Eqs. 5-7) applied to neural-network
training: every data-parallel worker keeps its own parameter copy ``x^w``
and scaled dual ``u^w``, runs ``K_w`` local AdamW steps on the augmented
Lagrangian

    L_w(x) = loss(x; batch_w) + rho/2 * ||x - (z - u^w)||^2,

and the consensus step averages ``omega = x + u`` over workers, applies
the prox of the regularizer h (Algorithm 1) and adapts rho.  Also the
data-parallel AdamW baseline (``make_sgd_step``).

The round keeps the reference's order of operations and roundings: q from
the previous x and z, u += x - z in float32, K local steps that each take
every worker's augmented gradient ``g + rho (x - (z - u))`` in float32 and
then ONE AdamW update of the W-stacked tree (so the global-norm clip spans
all workers), omega-bar, the prox at t = 1/(W rho) cast to the leaf's
dtype, s from the cast z and the old rho, then the clipped penalty rule and
the rescale u <- u rho / rho_new.

How the port runs it, none of which changes the math:
  * workers run one after another; x, u and the moments stay stacked on a
    leading W axis and are updated in place (a round consumes the state it
    is given and returns a new ``ConsensusState`` over the same tensors);
  * the centre z - u is never materialised for the tree: each worker's
    augmented gradient is formed leaf by leaf, in flat chunks;
  * the l1 z-update runs through ``ops.fused_z_update`` leaf by leaf (the
    CUDA kernel on the card, its plain version on the CPU); "l2sq" and
    "none" are plain tensor code, as in the reference;
  * the penalty rule is ``core.admm.new_penalty``'s, as tensor ops on the
    device (its comparisons in float64, as the host rule compares Python
    floats), so rho is never read back to the host, and a round runs on
    ``meta`` tensors (the dry-run) as on the card; the price is that the
    duals are rescaled by rho / rho_new every round, by 1.0 exactly when
    rho stays: one more read and write of u.  Under "l1" the z-update
    kernel takes its threshold lam / (W rho) as an argument, so the card
    reads that scalar back once per leaf;
  * ``worker_sum`` (a sharded round, ``launch/steps.py``): the state and
    batch given hold this rank's workers only (their leading axis), and
    ``worker_sum(t)`` sums a per-rank partial over the ranks of the other
    workers — q, the consensus sum, the loss and the clip's global norm.
    Without it the state holds all ``n_workers``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prox as prox_mod
from repro_torch.kernels import ops
from repro_torch.models import model as model_mod
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.optimizers import flat_chunks
from repro_torch.tree import flatten, leaves, tree_map

Tree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    n_workers: int = 16
    local_steps: int = 4                  # K_w
    rho0: float = 0.01
    prox: str = "none"                    # "l1" | "l2sq" | "none"
    lam: float = 1e-4                     # regularizer weight for h
    # penalty adaptation (Boyd §3.4.1)
    adapt_rho: bool = True
    mu: float = 10.0
    tau: float = 2.0
    rho_min: float = 1e-4
    rho_max: float = 1e2
    optimizer: opt_mod.AdamWConfig = opt_mod.AdamWConfig(weight_decay=0.0)


class ConsensusState(NamedTuple):
    x: Tree            # stacked (W, ...) worker primal copies
    u: Tree            # stacked (W, ...) scaled duals (float32)
    z: Tree            # global consensus params (unstacked)
    opt: Tree          # stacked AdamW state over x
    rho: torch.Tensor  # float32 scalars ...
    r_norm: torch.Tensor
    s_norm: torch.Tensor
    round: torch.Tensor  # ... and an int32 one


def init_state(cfg: ModelConfig, ccfg: ConsensusConfig, *,
               generator: torch.Generator, device="cuda") -> ConsensusState:
    """z drawn by ``model.init_params`` from ``generator``; every worker's
    x a copy of z; u and the moments zero."""
    z = model_mod.init_params(cfg, generator=generator, device=device)
    W = ccfg.n_workers
    x = tree_map(lambda t: t[None].expand((W,) + t.shape).clone(), z)
    dev = leaves(z)[0].device
    scalar = lambda v: torch.tensor(v, dtype=F32, device=dev)
    return ConsensusState(
        x=x, u=tree_map(lambda t: torch.zeros(t.shape, dtype=F32,
                                              device=dev), x),
        z=z, opt=opt_mod.adamw_init(x), rho=scalar(ccfg.rho0),
        r_norm=scalar(float("inf")), s_norm=scalar(float("inf")),
        round=torch.tensor(0, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# The parts of a round (module functions, so a profiler can wrap each)
# ---------------------------------------------------------------------------


def dual_ascent(xs: List[torch.Tensor], us: List[torch.Tensor],
                zs: List[torch.Tensor]) -> torch.Tensor:
    """u += x - z (float32) in place, for every worker; returns
    q = sum over workers and leaves of ||x - z||^2."""
    q = torch.zeros((), dtype=F32, device=zs[0].device)
    for x, u, z in zip(xs, us, zs):
        for w in range(x.shape[0]):
            for xc, uc, zc in flat_chunks(x[w], u[w], z):
                d = xc.float() - zc.float()
                q = q + torch.sum(d * d)
                uc += d
    return q


def value_and_grads(loss_fn: Callable, ps: List[torch.Tensor], build,
                    batch: Dict[str, torch.Tensor], unread=frozenset()):
    """(loss, grads) of ``loss_fn(build(ps), batch)``, grads in the
    parameters' dtype, leaf for leaf with ``ps``.  A leaf whose index is in
    ``unread`` (``unread_leaves``) may go unread by the loss and then gets
    zeros, as ``jax.grad`` gives; any other leaf the loss does not reach
    raises."""
    req = [p.detach().requires_grad_() for p in ps]
    loss = loss_fn(build(req), batch)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    missing = [i for i, g in enumerate(grads) if g is None and i not in unread]
    if missing:
        raise RuntimeError(f"the loss does not reach leaves {missing}")
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(req, grads)]


def unread_leaves(cfg: ModelConfig, tree) -> frozenset:
    """Indices (in ``flatten`` order) of the leaves of a parameter tree the
    loss does not read: the audio family's input embedding table (its
    inputs are embeddings; the table embeds sampled codes at decode)."""
    if cfg.family != "audio":
        return frozenset()
    return frozenset(i for i, leaf in enumerate(leaves(tree))
                     if leaf is tree["embed"])


def augment(grads, xs, us, zs, rho: torch.Tensor, w: int,
            out: List[torch.Tensor]) -> None:
    """out[w] = g + rho (x[w] - (z - u[w])), all float32, leaf by leaf."""
    for g, x, u, z, o in zip(grads, xs, us, zs, out):
        for gc, xc, uc, zc, oc in flat_chunks(g, x[w], u[w], z, o[w]):
            oc.copy_(gc.float() + rho * (xc.float() - (zc.float() - uc)))


def omega_bar(x: torch.Tensor, u: torch.Tensor, n_workers: int,
              worker_sum=None) -> torch.Tensor:
    """mean over workers of x + u, float32 — THE consensus all-reduce."""
    acc = x[0].float() + u[0]
    for w in range(1, x.shape[0]):
        acc = acc + (x[w].float() + u[w])
    if worker_sum is not None:
        acc = worker_sum(acc)
    return acc / n_workers


def z_update(kind: str, lam: float, omega: torch.Tensor, z: torch.Tensor,
             t: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(prox_h(omega, t) cast to z's dtype, its nnz for "l1" else None)."""
    if kind == "l1":
        zn, _, nnz = ops.fused_z_update(omega, z.float(), lam * t)
        return zn.to(z.dtype), nnz
    prox_fn = prox_mod.PROX_REGISTRY[kind][0]
    return prox_fn(omega, t, lam).to(z.dtype), None


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.float() - b.float()
    return torch.sum(d * d)


def adapt_penalty(rho: torch.Tensor, r_norm: torch.Tensor,
                  s_norm: torch.Tensor, ccfg: ConsensusConfig) -> torch.Tensor:
    """``core.admm.new_penalty`` (Boyd §3.4.1) and the clip to [rho_min,
    rho_max], in float32 on rho's device."""
    r, s = r_norm.double(), s_norm.double()
    new = torch.where(r > ccfg.mu * s, rho * ccfg.tau,
                      torch.where(s > ccfg.mu * r, rho / ccfg.tau, rho))
    return torch.clamp(new, float(np.float32(ccfg.rho_min)),
                       float(np.float32(ccfg.rho_max)))


def rescale_duals(us: List[torch.Tensor], ratio: torch.Tensor) -> None:
    """u <- u * rho / rho_new in place (Boyd §3.4.1: it is y = rho u, not
    u, that persists across a change of rho)."""
    for u in us:
        u.mul_(ratio)


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------


def make_round_step(cfg: ModelConfig, ccfg: ConsensusConfig,
                    loss_fn: Optional[Callable] = None, *,
                    worker_sum: Optional[Callable] = None) -> Callable:
    """The ADMM round: (state, batch) -> (state, metrics).

    ``batch`` leaves carry a leading worker axis (W, B_w, ...).  One call =
    one ADMM round = Algorithm 2 for all workers + Algorithm 1's master
    reduce and z-update.  The state's x, u and moments are updated in
    place.  Metrics: loss (the last local step's, mean over workers),
    r_norm, s_norm, rho, and z_nnz under prox "l1".  ``worker_sum``: see
    the module's docstring."""
    if loss_fn is None:
        loss_fn = lambda p, b: model_mod.loss_fn(p, cfg, b)[0]
    W = ccfg.n_workers

    def round_step(state: ConsensusState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[ConsensusState, Dict[str, torch.Tensor]]:
        rho = state.rho
        xs, build = flatten(state.x)
        us, zs = leaves(state.u), leaves(state.z)
        unread = unread_leaves(cfg, state.x)

        # ---- Algorithm 2: dual ascent + local solve ----------------------
        q_sum = dual_ascent(xs, us, zs)
        if worker_sum is not None:
            q_sum = worker_sum(q_sum)
        aug = [torch.empty_like(x, dtype=F32) for x in xs]
        for _ in range(ccfg.local_steps):
            losses = []
            for w in range(xs[0].shape[0]):
                loss, grads = value_and_grads(
                    loss_fn, [x[w] for x in xs], build,
                    {k: v[w] for k, v in batch.items()}, unread)
                losses.append(loss)
                augment(grads, xs, us, zs, rho, w, aug)
                del grads
            opt_mod.adamw_update(ccfg.optimizer, state.x, build(aug),
                                 state.opt, sq_sum=worker_sum)
        del aug

        # ---- Algorithm 1: master reduce + z-update ------------------------
        t = 1.0 / (W * rho)
        z_new, sq, nnz = [], torch.zeros((), dtype=F32, device=rho.device), 0
        for x, u, z in zip(xs, us, zs):
            zn, nz = z_update(ccfg.prox, ccfg.lam,
                              omega_bar(x, u, W, worker_sum), z, t)
            sq = sq + sq_dist(zn, z)
            z_new.append(zn)
            if nz is not None:
                nnz = nnz + nz
        r_norm = torch.sqrt(q_sum)
        s_norm = rho * torch.sqrt(sq * W)
        rho_new = rho
        if ccfg.adapt_rho:
            rho_new = adapt_penalty(rho, r_norm, s_norm, ccfg)
            rescale_duals(us, rho / rho_new)

        new_state = ConsensusState(
            x=state.x, u=state.u, z=build(z_new), opt=state.opt,
            rho=rho_new, r_norm=r_norm, s_norm=s_norm,
            round=state.round + 1)
        loss = torch.stack(losses).mean()
        if worker_sum is not None:
            loss = worker_sum(loss * len(losses)) / W
        metrics = {"loss": loss, "r_norm": r_norm,
                   "s_norm": s_norm, "rho": rho_new}
        if ccfg.prox == "l1":
            metrics["z_nnz"] = nnz
        return new_state, metrics

    return round_step


# ---------------------------------------------------------------------------
# Conventional data-parallel step (the baseline the paper compares against:
# one gradient all-reduce per step)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SgdTrainConfig:
    optimizer: opt_mod.AdamWConfig = opt_mod.AdamWConfig()


def make_sgd_step(cfg: ModelConfig, tcfg: SgdTrainConfig = SgdTrainConfig()
                  ) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); params
    and the moments are updated in place."""
    def step(params, opt_state, batch):
        ps, build = flatten(params)
        loss, grads = value_and_grads(
            lambda p, b: model_mod.loss_fn(p, cfg, b)[0], ps, build, batch,
            unread_leaves(cfg, params))
        params, opt_state, om = opt_mod.adamw_update(
            tcfg.optimizer, params, build(grads), opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step
