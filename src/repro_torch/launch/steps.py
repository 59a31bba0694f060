"""Step assembly: (arch, shape, mode, mesh) -> a sharded step (a port of
``repro/launch/steps.py``).

This is the one place that knows how to put a workload on a mesh; the
dry-run and ``chip_smoke.py`` consume ``build_step``.  Nothing here
allocates: a bundle's arguments are ``meta`` tensors (``model.param_specs``,
``configs.input_specs``, ``init_cache(abstract=True)``), and ``lower_step``
places real or fake tensors of the same structure by the bundle's specs.

Modes
-----
  sgd    : conventional data-parallel AdamW step (ZeRO-1 moments, optional
           FSDP weights) — one gradient reduction per step.
  admm   : one consensus-ADMM round (the paper's technique): K_w local Adam
           steps + ONE consensus all-reduce over the worker axes.
  prefill: fill the KV cache from a full prompt, return last-token logits.
  decode : one new token against the cache.

How a sharded step runs, none of which changes the math: eagerly, on
DTensors (each rank computes its shards; DTensor inserts the collectives
the placements need) with ``implicit_replication`` for the plain tensors
the model makes (positions, masks) and the activation rules installed
(``parallel/ctx.py``).  The ADMM state's leading worker axis is
``Shard(0)`` over the worker axes (``stacked_spec_tree``); the round runs
on each rank's workers as DTensors over the remaining mesh dims, and the
trainer's cross-worker sums go through ``worker_sum``, an all-reduce over
the worker axes.  No ``torch.compile`` is asked for.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig,
                                      cell_is_applicable, input_specs)
from repro_torch.core import trainer as trainer_mod
from repro_torch.launch import op_analysis
from repro_torch.models import model as model_mod
from repro_torch.optim import optimizers as opt_mod
from repro_torch.parallel import ctx, shards, sharding
from repro_torch.parallel.sharding import P
from repro_torch.tree import leaves, tree_map

Tree = Any

# archs whose per-worker ADMM state exceeds one 16-GPU worker's memory at
# W = data-axis size; their "worker" is a whole pod
_ADMM_POD_WORKER_PARAMS = 20e9


class StepBundle(NamedTuple):
    fn: Callable                 # the step, on DTensors
    args: Tuple[Tree, ...]       # meta-tensor trees
    in_specs: Tuple[Tree, ...]
    out_specs: Tree              # placements of the results, or None
    rules: Dict[str, P]          # activation rules to install while running
    meta: Dict[str, Any]


def admm_worker_axes(cfg: ModelConfig, mesh) -> Optional[Tuple[str, ...]]:
    """Which mesh axes form the ADMM worker pool for this arch (None =
    technique memory-inapplicable on this mesh)."""
    if cfg.param_count() > _ADMM_POD_WORKER_PARAMS:
        names = sharding.mesh_shape(mesh).axis_names
        return ("pod",) if "pod" in names else None
    return sharding.dp_axes(mesh)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, mode: str, *,
               consensus: Optional[Dict[str, Any]] = None
               ) -> Optional[StepBundle]:
    """The step of ``mode`` for (cfg, shape) on ``mesh`` (a ``DeviceMesh``
    or a ``MeshShape``), or None where the cell or mode does not apply.
    ``consensus``: ``ConsensusConfig`` fields for the admm round (its
    worker count is the mesh's)."""
    ok, _ = cell_is_applicable(cfg, shape)
    if not ok:
        return None
    rules = sharding.activation_rules(cfg, mesh, shape.global_batch)
    if mode == "sgd":
        return _build_sgd(cfg, shape, mesh, rules)
    if mode == "admm":
        return _build_admm(cfg, shape, mesh, consensus or {})
    if mode == "prefill":
        return _build_serve(cfg, shape, mesh, rules, "prefill")
    if mode == "decode":
        return _build_serve(cfg, shape, mesh, rules, "decode")
    raise ValueError(f"unknown mode {mode!r}")


def default_modes(shape: ShapeConfig) -> Tuple[str, ...]:
    if shape.kind == "train":
        return ("sgd", "admm")
    if shape.kind == "prefill":
        return ("prefill",)
    return ("decode",)


# ---------------------------------------------------------------------------
# train (sgd)
# ---------------------------------------------------------------------------


def _build_sgd(cfg, shape, mesh, rules) -> StepBundle:
    params = model_mod.param_specs(cfg)
    opt = opt_mod.adamw_init(params)
    batch = input_specs(cfg, shape)

    p_spec = sharding.param_spec_tree(cfg, params, mesh)
    z_spec = sharding.zero1_spec_tree(cfg, params, mesh)
    opt_spec = {"m": z_spec, "v": z_spec, "step": P()}
    b_spec = sharding.batch_spec_tree(batch, mesh)
    metrics = {"loss": P(), "grad_norm": P()}
    return StepBundle(
        fn=trainer_mod.make_sgd_step(cfg), args=(params, opt, batch),
        in_specs=(p_spec, opt_spec, b_spec),
        out_specs=(p_spec, opt_spec, metrics), rules=rules,
        meta={"mode": "sgd", "tokens": shape.global_batch * shape.seq_len})


# ---------------------------------------------------------------------------
# train (admm consensus round)
# ---------------------------------------------------------------------------


def _build_admm(cfg, shape, mesh, consensus, *, local_steps: int = 4
                ) -> Optional[StepBundle]:
    waxes = admm_worker_axes(cfg, mesh)
    if waxes is None:
        return None
    sizes = sharding.mesh_shape(mesh).shape
    W = math.prod(sizes[a] for a in waxes)
    if shape.global_batch % W:
        return None
    ccfg = trainer_mod.ConsensusConfig(
        **dict(dict(local_steps=local_steps), **consensus, n_workers=W))
    state = trainer_mod.init_state(cfg, ccfg, generator=None, device="meta")

    # per-worker batch: (W, B_w, ...) on every input leaf
    B_w = shape.global_batch // W
    batch = {k: torch.empty((W, B_w) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta")
             for k, v in input_specs(cfg, shape).items()}

    free_dp = tuple(a for a in sharding.dp_axes(mesh) if a not in waxes)
    # the inner (per-worker) spec may not reuse the worker axes; big archs
    # FSDP the worker state over the remaining data axes
    inner = sharding.param_spec_tree(cfg, state.z, mesh,
                                     fsdp=cfg.fsdp and bool(free_dp),
                                     worker_axes=waxes)
    stacked = sharding.stacked_spec_tree(inner, waxes)
    state_spec = trainer_mod.ConsensusState(
        x=stacked, u=stacked, z=inner,
        opt={"m": stacked, "v": stacked, "step": P()},
        rho=P(), r_norm=P(), s_norm=P(), round=P())

    w = waxes if len(waxes) > 1 else waxes[0]
    free_sz = math.prod(sizes[a] for a in free_dp)
    inner_b = ((free_dp if len(free_dp) > 1 else free_dp[0])
               if free_dp and B_w % free_sz == 0 else None)
    b_spec = {k: P(w, inner_b, *([None] * (v.dim() - 2)))
              for k, v in batch.items()}

    # activation rules inside a worker: batch dims may only use the dp
    # axes NOT consumed by the worker stacking
    rules = {"btd": P(inner_b, None, None), "btv": P(inner_b, None, "model")}
    eff_heads = cfg.attn_head_pad or cfg.n_heads
    if eff_heads and eff_heads % sharding.model_size(mesh) == 0:
        rules["bshd"] = P(inner_b, None, "model", None)

    metrics = {"loss": P(), "r_norm": P(), "s_norm": P(), "rho": P()}
    if ccfg.prox == "l1":
        metrics["z_nnz"] = P()
    return StepBundle(
        fn=_sharded_round(cfg, ccfg, waxes), args=(state, batch),
        in_specs=(state_spec, b_spec), out_specs=(state_spec, metrics),
        rules=rules,
        meta={"mode": "admm", "n_workers": W, "local_steps": ccfg.local_steps,
              "tokens": shape.global_batch * shape.seq_len
              * ccfg.local_steps})


def _sharded_round(cfg, ccfg, waxes) -> Callable:
    """The trainer's round on DTensors whose leading worker axis is
    sharded over ``waxes``: each rank runs its own workers as DTensors
    over the remaining mesh dims, with the cross-worker sums all-reduced
    over the worker axes."""
    def round_step(state, batch):
        from torch.distributed._functional_collectives import all_reduce
        from torch.distributed.tensor import DTensor, Replicate
        mesh = leaves(state.z)[0].device_mesh
        names = mesh.mesh_dim_names
        wdims = [names.index(a) for a in waxes]
        rest = tuple(a for a in names if a not in waxes)
        if not rest:
            raise ValueError("an ADMM worker needs a mesh dim of its own "
                             "beside the worker axes")
        sub = mesh[rest]

        def worker_sum(t):
            local = t.to_local()
            for j in wdims:
                local = all_reduce(local, "sum", (mesh, j))
            return shards.wrap(local, t.device_mesh, t.placements, t.shape)

        def back(t, like):
            if not isinstance(t, DTensor):
                t = shards.wrap(t, sub, [Replicate()] * sub.ndim)
            return _to_full(t, mesh, like, wdims)
        step = trainer_mod.make_round_step(cfg, ccfg, worker_sum=worker_sum)
        to_sub = lambda t: _to_worker(t, sub, wdims)
        new, metrics = step(tree_map(to_sub, state), tree_map(to_sub, batch))
        # x, u and the moments were updated in place through the views
        out = trainer_mod.ConsensusState(
            x=state.x, u=state.u, z=tree_map(back, new.z, state.z),
            opt=dict(state.opt, step=back(new.opt["step"],
                                          state.opt["step"])),
            **{k: back(getattr(new, k), getattr(state, k))
               for k in ("rho", "r_norm", "s_norm", "round")})
        return out, {k: back(v, state.rho) for k, v in metrics.items()}
    return round_step


def _to_worker(t, sub, wdims):
    """A DTensor of the full mesh as this rank's workers: its local shard
    as a DTensor over ``sub`` (the mesh dims beside the worker dims ``wdims``,
    which shard at most the leading axis)."""
    from torch.distributed.tensor import Shard
    local = t.to_local()
    shape = list(t.shape)
    if any(t.placements[j] == Shard(0) for j in wdims):
        shape[0] = local.shape[0]
    return shards.wrap(local, sub, [p for j, p in enumerate(t.placements)
                                    if j not in wdims], shape)


def _to_full(v, mesh, like, wdims):
    """``_to_worker``'s inverse: ``like``'s placements on the worker dims,
    ``v``'s on the rest."""
    from torch.distributed.tensor import Shard
    it = iter(v.placements)
    places = [like.placements[j] if j in wdims else next(it)
              for j in range(mesh.ndim)]
    shape = list(v.shape)
    for j in wdims:
        if places[j] == Shard(0):
            shape[0] *= mesh.shape[j]
    return shards.wrap(v.to_local(), mesh, places, shape)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _build_serve(cfg, shape, mesh, rules, mode) -> StepBundle:
    params = model_mod.param_specs(cfg)
    batch = input_specs(cfg, shape)
    cache = model_mod.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 abstract=True)
    p_spec = sharding.param_spec_tree(cfg, params, mesh, fsdp=cfg.fsdp_serve)
    b_spec = sharding.batch_spec_tree(batch, mesh)
    c_spec = sharding.cache_spec_tree(cfg, cache, mesh)

    if mode == "prefill":
        def step(params, batch, cache):
            return model_mod.prefill(params, cfg, batch, cache,
                                     last_only=True)
        tokens = shape.global_batch * shape.seq_len
    else:
        def step(params, batch, cache):
            return model_mod.decode_step(params, cfg, batch, cache)
        tokens = shape.global_batch
    dp = sharding.dp_axes(mesh)
    lead = (dp if len(dp) > 1 else dp[0]) \
        if shape.global_batch % sharding.dp_size(mesh) == 0 else None
    return StepBundle(
        fn=step, args=(params, batch, cache),
        in_specs=(p_spec, b_spec, c_spec),
        out_specs=(P(lead, None, "model"), c_spec), rules=rules,
        meta={"mode": mode, "tokens": tokens})


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoweredStep:
    """A bundle's step with its arguments placed on a mesh: the
    counterpart of ``jax.jit(...).lower(...)``.  ``run()`` runs it once;
    ``cost()`` runs it once under ``op_analysis.OpCounter``."""
    bundle: StepBundle
    mesh: Any
    args: Tuple[Tree, ...]

    def run(self):
        from torch.distributed.tensor.experimental import implicit_replication
        with ctx.use_rules(self.bundle.rules), implicit_replication():
            out = self.bundle.fn(*self.args)
            if self.bundle.out_specs is not None:
                out = sharding.distribute(out, self.mesh,
                                          self.bundle.out_specs)
        return out

    def cost(self, *, pod_ranks: int = 256):
        """(the step's result, ``op_analysis`` summary of this rank)."""
        counter = op_analysis.OpCounter(pod_ranks)
        counter.add_args(self.args)
        with counter:
            out = self.run()
        return out, counter.summary()


def lower_step(bundle: StepBundle, mesh, args: Optional[Tuple] = None
               ) -> LoweredStep:
    """Place ``args`` (real tensors; by default the bundle's own ``meta``
    tensors, which run the step with no data, as the dry-run does) on
    ``mesh`` by the bundle's ``in_specs``."""
    if args is None:
        args = bundle.args
    placed = tuple(sharding.distribute(a, mesh, s)
                   for a, s in zip(args, bundle.in_specs))
    return LoweredStep(bundle, mesh, placed)
