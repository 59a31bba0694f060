"""Sharding rules: tree path -> partition spec, for every arch family (a
port of ``repro/parallel/sharding.py``).

The production mesh is fixed by the launch layer: ``(16, 16)`` with axes
``("data", "model")`` per pod, and ``(2, 16, 16)`` with ``("pod", "data",
"model")`` across pods.  This module owns the mapping from parameter /
activation / cache trees onto those axes, leaf for leaf the reference's:

* **Parameters** — Megatron tensor parallelism over ``"model"``: column-
  parallel in-projections (attention QKV, MLP up/gate, MoE experts' up/gate,
  Mamba in_proj, RWKV r/k/v/g and channel-mix up), row-parallel
  out-projections (attention O, MLP down, ...), always on the flat feature
  axis (H*hd, d_ff).
* **FSDP** (``cfg.fsdp``) — weights additionally sharded over the data axes
  on the other matrix dimension.
* **ZeRO-1** — optimizer moments use the FSDP spec even when parameters do
  not, and the replicated leaves are sharded on their first divisible axis.
* **KV caches** — decode caches shard the *sequence-slot* axis over
  ``"model"`` (heads would need KV % 16 == 0, which GQA configs break).
* **ADMM consensus state** — per-worker parameter copies are *stacked* on a
  leading worker axis mapped to the data axes.

A spec is ``P``: a tuple with one part per tensor dim, each ``None``, an
axis name or a tuple of names.  The rules read a mesh only through its
axis names and sizes (``MeshShape``, the counterpart of JAX's
``AbstractMesh``), so they run without a process group; ``to_placements``
and ``distribute`` turn specs into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig

Tree = Any


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``;
    ``P()`` is a replicated scalar."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)



def mesh_shape(mesh) -> MeshShape:
    """A ``MeshShape`` for a ``MeshShape`` or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ("pod", "data") on a multi-pod mesh."""
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh).shape
    return math.prod(shape[a] for a in dp_axes(mesh))


def model_size(mesh) -> int:
    return mesh_shape(mesh).shape["model"]


def _dp(mesh):
    ax = dp_axes(mesh)
    return ax if len(ax) > 1 else ax[0]


# ---------------------------------------------------------------------------
# Trees with paths
# ---------------------------------------------------------------------------


def map_with_path(fn, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, NamedTuples,
    lists and tuples; a path is the dict keys, field names and indices down
    to the leaf.  A ``P`` is a leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=path + (str(k),)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_with_path(fn, v, *(r[i] for r in rest),
                                          path=path + (f,))
                            for i, (f, v) in enumerate(zip(tree._fields,
                                                           tree))])
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest),
                                        path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def map_specs(fn, spec_tree, *rest):
    return map_with_path(lambda _, s, *r: fn(s, *r), spec_tree, *rest)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

# matrix-leaf classification: name -> role over the trailing (in, out) axes
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "wr", "wg", "wck"}
_ROW = {"wo", "w_down", "w_out", "wcv"}
_REP_MAT = {"wcr", "lora_a", "lora_b", "router", "conv_w"}


def _leaf_role(path: Tuple[str, ...]) -> str:
    """Classify a leaf by its tree path (innermost matrix name wins)."""
    names = list(path)
    leaf = names[-1]
    if leaf in ("w", "b"):
        owner = names[-2] if len(names) > 1 else ""
        if owner in _COL:
            return "col" if leaf == "w" else "col_bias"
        if owner in _ROW:
            return "row" if leaf == "w" else "rep"
        if owner in _REP_MAT:
            return "rep"
        return "rep"
    if leaf in _COL:          # moe leaves are bare tensors, not {"w": ...}
        return "col"
    if leaf in _ROW:
        return "row"
    if leaf == "embed":
        return "embed"
    if leaf == "head":
        return "head"
    return "rep"


def _divisible(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _free_dp(mesh, worker_axes):
    free = tuple(a for a in dp_axes(mesh) if a not in worker_axes)
    dp = free if len(free) > 1 else (free[0] if free else None)
    shape = mesh_shape(mesh).shape
    return dp, (math.prod(shape[a] for a in free) if free else 0)


def param_spec_tree(cfg: ModelConfig, params_shapes: Tree, mesh, *,
                    fsdp: Optional[bool] = None,
                    worker_axes: Tuple[str, ...] = ()) -> Tree:
    """A ``P`` tree matching ``params_shapes`` (tensors, meta ones
    included: only ``.shape`` is read).

    ``worker_axes``: axes consumed by a leading stacked-worker dimension
    (ADMM consensus state) — they are excluded from FSDP use and the spec
    gets the worker axis prepended by the caller, not here."""
    use_fsdp = cfg.fsdp if fsdp is None else fsdp
    dp, dpsz = _free_dp(mesh, worker_axes)

    def spec_of(path, leaf) -> P:
        role = _leaf_role(path)
        shape = tuple(leaf.shape)
        nd = len(shape)

        def pad(trailing: Sequence) -> P:
            return P(*([None] * (nd - len(trailing)) + list(trailing)))

        if role == "col":
            tr = [None, "model"]
            if use_fsdp and dp and _divisible(shape[-2], dpsz):
                tr[0] = dp
            return pad(tr)
        if role == "row":
            tr = ["model", None]
            if use_fsdp and dp and _divisible(shape[-1], dpsz):
                tr[1] = dp
            return pad(tr)
        if role == "col_bias":
            return pad(["model"])
        if role == "embed":
            # (V, d): d over model (local row lookup, then one all-gather)
            tr = [None, "model"]
            if use_fsdp and dp and _divisible(shape[0], dpsz):
                tr[0] = dp
            return P(*tr)
        if role == "head":
            # (V, d): vocab-parallel logits (no collective in the matmul)
            tr = ["model", None]
            if use_fsdp and dp and _divisible(shape[1], dpsz):
                tr[1] = dp
            return P(*tr)
        # replicated (norm scales, biases, mu mixes, conv, lora, router, ...)
        return P(*([None] * nd))

    return map_with_path(spec_of, params_shapes)


def zero1_spec_tree(cfg: ModelConfig, params_shapes: Tree, mesh, *,
                    worker_axes: Tuple[str, ...] = ()) -> Tree:
    """Optimizer-moment specs: FSDP sharding (ZeRO-1) + dp-shard the
    replicated leaves on their first dp-divisible axis."""
    base = param_spec_tree(cfg, params_shapes, mesh, fsdp=True,
                           worker_axes=worker_axes)
    dp, dpsz = _free_dp(mesh, worker_axes)

    def upgrade(spec: P, leaf) -> P:
        if not dp or any(s is not None for s in spec):
            return spec
        shape = tuple(leaf.shape)
        parts = list(spec)
        for i in range(len(shape) - 1, -1, -1):    # prefer trailing axes
            if _divisible(shape[i], dpsz):
                parts[i] = dp
                return P(*parts)
        return spec

    return map_specs(upgrade, base, params_shapes)


def stacked_spec_tree(spec_tree: Tree, worker_axes: Tuple[str, ...]) -> Tree:
    """Prepend the ADMM worker axis to every leaf spec (stacked copies)."""
    w = worker_axes if len(worker_axes) > 1 else worker_axes[0]
    return map_specs(lambda s: P(w, *s), spec_tree)


# ---------------------------------------------------------------------------
# Activation rules (repro_torch.parallel.ctx)
# ---------------------------------------------------------------------------


def activation_rules(cfg: ModelConfig, mesh,
                     global_batch: Optional[int] = None) -> Dict[str, P]:
    dp = _dp(mesh)
    if global_batch is not None and not _divisible(global_batch,
                                                   dp_size(mesh)):
        dp = None        # e.g. long_500k's batch of 1: replicate batch dims
    rules = {
        "btd": P(dp, None, None),
        "btv": P(dp, None, "model"),
    }
    eff_heads = cfg.attn_head_pad or cfg.n_heads
    if eff_heads and _divisible(eff_heads, model_size(mesh)):
        rules["bshd"] = P(dp, None, "model", None)
    if cfg.n_experts and cfg.moe_slot_sharding:
        # routed slot buffers (E, cap, d): shard the capacity axis so the
        # expert compute is slot-local (many-small-expert MoEs only)
        rules["moe_slots"] = P(None, "model", None)
    return rules


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_spec_tree(specs: Dict[str, torch.Tensor], mesh) -> Dict[str, P]:
    """Shard the leading batch axis over the data axes when divisible
    (long_500k has global_batch=1 -> replicated)."""
    dp = _dp(mesh)
    dpsz = dp_size(mesh)

    def one(s) -> P:
        lead = dp if _divisible(s.shape[0], dpsz) else None
        return P(lead, *([None] * (len(s.shape) - 1)))

    return {k: one(v) for k, v in specs.items()}


# cache leaf name -> (batch axis index, model-sharded axis index or None):
#   dense/moe/audio : k/v        (L, B, S, KV, hd)       -> S over model
#   vlm             : k/v        (G, n, B, S, KV, hd)    -> S over model
#                     k_img/v_img(G, B, T_img, KV, hd)   -> replicated tail
#   hybrid          : ssm        (L, B, nh, hd, N)       -> nh over model
#                     conv       (L, B, 3, conv_dim)     -> conv_dim over model
#                     attn_k/v   (G, B, S, KV, hd)       -> S over model
#   ssm (rwkv)      : wkv        (L, B, H, hd, hd)       -> H over model
#                     shift_t/c  (L, B, d)               -> d over model
CACHE_LAYOUT = {
    "k": (-4, -3), "v": (-4, -3),
    "k_img": (-4, None), "v_img": (-4, None),
    "attn_k": (-4, -3), "attn_v": (-4, -3),
    "ssm": (-4, -3), "conv": (-3, -1), "wkv": (-4, -3),
    "shift_t": (-2, -1), "shift_c": (-2, -1),
}


def cache_spec_tree(cfg: ModelConfig, cache_shapes: Tree, mesh) -> Tree:
    """Decode-cache specs: batch over data axes, slots/state over model
    (``CACHE_LAYOUT``, the layouts of ``models.model.init_cache``)."""
    dp = _dp(mesh)
    dpsz = dp_size(mesh)
    msz = model_size(mesh)

    def spec_of(path, leaf) -> P:
        b_ax, m_ax = CACHE_LAYOUT[path[-1]]
        shape = tuple(leaf.shape)
        nd = len(shape)
        parts = [None] * nd
        if _divisible(shape[b_ax], dpsz):
            parts[b_ax % nd] = dp
        if m_ax is not None and _divisible(shape[m_ax], msz):
            parts[m_ax % nd] = "model"
        return P(*parts)

    return map_with_path(spec_of, cache_shapes)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def to_placements(mesh, spec: P):
    """DTensor placements for ``spec`` on ``mesh``, one per mesh dim.

    A tensor dim sharded over several axes (``("pod", "data")``) is
    ``Shard(d)`` on each of them; DTensor splits in mesh-dim order, which
    is JAX's major-to-minor order, so rank (p, d) holds chunk p * n_data +
    d.  The axes of a part must come in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_shape(mesh).axis_names
    owner: Dict[str, int] = {}
    for d, part in enumerate(spec):
        axes = () if part is None else (part if isinstance(part, tuple)
                                         else (part,))
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec}: axes {unknown} are not in the "
                             f"mesh's {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            owner[a] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in names)


def divides(shape, mesh, spec: P) -> bool:
    """Does every split of ``spec`` divide its dim of ``shape`` evenly?"""
    sizes = mesh_shape(mesh).shape
    return len(spec) == len(shape) and all(
        part is None or shape[d] % math.prod(
            sizes[a] for a in (part if isinstance(part, tuple) else (part,)))
        == 0 for d, part in enumerate(spec))


def local_box(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard of an evenly split
    tensor; a dim split over several mesh dims is cut in mesh-dim order
    (major to minor)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.shape[j]
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly over {n} ranks")
            size[p.dim] //= n
            off[p.dim] += coord[j] * size[p.dim]
    return size, off


def _place(t, mesh, spec):
    from torch.distributed.tensor import DTensor
    want = to_placements(mesh, spec)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == want else t.redistribute(mesh,
                                                                     want)
    size, off = local_box(t.shape, mesh, want)
    local = t
    for d, (n, o) in enumerate(zip(size, off)):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    # a meta shard gets storage of its own (its bytes are what a rank
    # holds); a real one stays a view of the tensor when it is contiguous
    if local.device.type == "meta" and local is not t:
        local = local.clone()
    elif not local.is_contiguous():
        local = local.contiguous()
    return DTensor.from_local(local, mesh, want, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(tree: Tree, mesh, spec_tree: Tree) -> Tree:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` under its spec: the
    counterpart of the reference's ``to_named`` + ``device_put``.  Each
    rank keeps its own chunk, a view of the leaf where it is contiguous
    (the whole leaf on a 1x1 mesh, so nothing is copied); nothing is sent.
    A DTensor leaf is redistributed to the spec."""
    return map_with_path(lambda _, t, s: _place(t, mesh, s), tree, spec_tree)
