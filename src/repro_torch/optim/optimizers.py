"""Optimizers on trees of tensors (a port of ``repro/optim/optimizers.py``).

State is a plain dict of trees: ``{"m", "v", "step"}`` for AdamW,
``{"mom", "step"}`` for SGD, moments in float32 whatever the parameters'
dtype, ``step`` one int32 scalar for the whole tree.  The update runs in
float32 with the reference's roundings and is cast back to the
parameters' dtype.  The global-norm clip spans every leaf of the tree it
is handed: a tree stacked over workers gets one norm across all of them.

Unlike the reference, ``adamw_update`` and ``sgd_update`` write the new
parameters and moments into the tensors they are given (and return them):
at granite_8b's width a functional update would hold two copies of the
float32 moments.  Every leaf is updated in flat chunks of ``CHUNK``
elements, so the float32 temporaries stay a few hundred MB whatever the
leaf; the arithmetic is elementwise, so chunking changes no result (the
sums over chunks are taken in chunk order).  DTensor leaves (a sharded
step) are chunked shard by shard (``parallel/shards.py``), so a 1x1 mesh
repeats the unsharded sums bit for bit.  ``sq_sum`` sums the global
norm's squares across ranks that hold other parts of the tree (the ADMM
workers of a sharded round).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.parallel.shards import on_shards
from repro_torch.tree import flatten, leaves, tree_map

Tree = Any

CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0            # global-norm clip; 0 disables


@dataclasses.dataclass(frozen=True)
class SgdConfig:
    lr: float = 1e-2
    momentum: float = 0.9
    nesterov: bool = False
    grad_clip: float = 0.0


@on_shards("flat_chunks")
def flat_chunks(*tensors):
    """Matching flat views of at most ``CHUNK`` elements of tensors of one
    shape (contiguous)."""
    flat = [t.view(-1) for t in tensors]
    n = flat[0].numel()
    for lo in range(0, n, CHUNK):
        yield tuple(f[lo:lo + CHUNK] for f in flat)


def _global_norm(tree: Tree, sq_sum=None) -> torch.Tensor:
    ls = leaves(tree)
    tot = torch.zeros((), dtype=torch.float32, device=ls[0].device)
    for leaf in ls:
        for (c,) in flat_chunks(leaf):
            tot = tot + torch.sum(torch.square(c.float()))
    return torch.sqrt(tot if sq_sum is None else sq_sum(tot))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _grads_in_f32(grads: Tree, grad_clip: float, sq_sum=None):
    """(gf(g_chunk), gnorm): gf gives a chunk of a gradient in float32,
    clipped and rounded to the gradient's dtype first when a clip is set,
    as the reference's ``clip_by_global_norm`` returns it."""
    gnorm = _global_norm(grads, sq_sum)
    if not grad_clip:
        return (lambda g: g.float()), gnorm
    scale = _clip_scale(gnorm, grad_clip)
    return (lambda g: (g.float() * scale).to(g.dtype).float()), gnorm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Tree) -> Tree:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    first = leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree, state: Tree,
                 lr_scale=1.0, *, sq_sum=None) -> Tuple[Tree, Tree, Tree]:
    """Returns (params, state, metrics); ``params`` and ``state``'s moments
    are updated in place."""
    gf, gnorm = _grads_in_f32(grads, cfg.grad_clip, sq_sum)
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale
    ps, _ = flatten(params)
    for p, g, m, v in zip(ps, leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        for pc, gc, mc, vc in flat_chunks(p, g, m, v):
            g32 = gf(gc)
            mc.copy_(cfg.b1 * mc + (1.0 - cfg.b1) * g32)
            vc.copy_(cfg.b2 * vc + (1.0 - cfg.b2) * g32 * g32)
            delta = (mc / bc1) / (torch.sqrt(vc / bc2) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * pc.float()
            pc.copy_(pc.float() - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------


def sgd_init(params: Tree) -> Tree:
    first = leaves(params)[0]
    return {"mom": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def sgd_update(cfg: SgdConfig, params: Tree, grads: Tree, state: Tree,
               lr_scale=1.0) -> Tuple[Tree, Tree, Tree]:
    """Returns (params, state, metrics); ``params`` and the momentum are
    updated in place."""
    gf, gnorm = _grads_in_f32(grads, cfg.grad_clip)
    lr = cfg.lr * lr_scale
    for p, g, mom in zip(leaves(params), leaves(grads),
                         leaves(state["mom"])):
        for pc, gc, mc in flat_chunks(p, g, mom):
            g32 = gf(gc)
            mc.copy_(cfg.momentum * mc + g32)
            d = g32 + cfg.momentum * mc if cfg.nesterov else mc
            pc.copy_(pc.float() - lr * d)
    state["step"] = state["step"] + 1
    return params, state, {"grad_norm": gnorm}


def make_optimizer(kind: str, **kw) -> Tuple[Callable, Callable, Any]:
    """(init_fn, update_fn(cfg,...), cfg) triple by name."""
    if kind == "adamw":
        return adamw_init, adamw_update, AdamWConfig(**kw)
    if kind == "sgd":
        return sgd_init, sgd_update, SgdConfig(**kw)
    raise ValueError(f"unknown optimizer {kind!r}")
