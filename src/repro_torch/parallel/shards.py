"""How the port's operations run on DTensor shards (a sharded step,
``launch/steps.py``): the one module that decides it.

Most of a sharded step is DTensor's own per-operator propagation.  A
function of the model, kernel or optimizer layers that needs more is
marked ``@on_shards(rule)``: on plain tensors it runs as written; when a
positional argument is a DTensor, the call goes to
``RULES[rule](fn, *args, **kw)`` with ``fn`` the function as written.  A
rule runs ``fn`` on each rank's local shards where that is exact, and
wraps the results back with the placements — and, for autograd, the
gradient placements — that make it so; otherwise it hands the DTensors to
``fn`` and DTensor's propagation.  The layers import nothing else of the
distribution layer.

  rule         marks                        on DTensors
  heads        attention.block_attention,   each rank's own query heads
               attention.cross_attention    against the K/V heads they read
  split_dim    layers.split_dim,            a dim split over ranks that do
  merge_dims   layers.merge_dims            not divide its outer part is
                                            gathered first (GQA's 8 K/V
                                            heads, granite_moe's 24 query
                                            heads on 16 ranks), and so is
                                            its cotangent
  kv_write     attention.update_cache       each rank writes the slots it
                                            holds; nothing of the cache moves
  embed_grad   layers._embed_grad           each rank's rows, partial sums
  moe          moe.moe_ff                   each rank's tokens through its
                                            d_ff slice of every expert
  kernel       ops.flash_attention,         the card's kernel on local
               ops.cross_attention          shards where that is exact,
                                            else raises; the plain version
                                            on the CPU
  decode       ops.decode_attention         a cache split by slots: each
                                            rank's partial decode over its
                                            own slots, the softmax states
                                            combined by two all-reduces (on
                                            either device); else "kernel"
  z_update     ops.fused_z_update           elementwise on each shard, the
                                            two sums all-reduced
  flat_chunks  optimizers.flat_chunks       each shard chunked as the
                                            unsharded leaf is
  scan         ssm.ssd_chunked,             each rank's batch and heads
               ssm.wkv6_chunked             over the whole sequence (a
                                            split sequence gathered)

Two conventions hold for every rule: a local result wrapped back into a
DTensor is contiguous, and so is a gradient handed back through
``to_local`` (``local``).  DTensor takes the global strides to be
contiguous, and a view of a transposed local shard fails.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.parallel.sharding import local_box

RULES: Dict[str, Callable] = {}


def on_shards(rule: str):
    """Mark a function whose DTensor calls go to ``RULES[rule]``."""
    def mark(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if any(isinstance(a, DTensor) for a in args):
                return RULES[rule](fn, *args, **kw)
            return fn(*args, **kw)
        return call
    return mark


def _rule(name: str):
    def register(fn):
        RULES[name] = fn
        return fn
    return register


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local(t: DTensor, grad_placements=None) -> torch.Tensor:
    """This rank's shard of ``t``; its gradient goes back to ``t`` under
    ``grad_placements`` (default: ``t``'s), contiguous."""
    return _ContiguousGrad.apply(t.to_local(grad_placements=grad_placements))


def wrap(x: torch.Tensor, mesh, placements, shape=None) -> DTensor:
    """``x`` (contiguous) as this rank's shard of a DTensor of global
    ``shape`` (default: ``x``'s)."""
    shape = torch.Size(x.shape if shape is None else shape)
    return DTensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


# ---------------------------------------------------------------------------
# model layers
# ---------------------------------------------------------------------------


@_rule("heads")
def _own_heads(fn, q, k, v, **kw):
    """Attention on DTensor q split over heads (dim 2) on some mesh dims:
    each rank runs ``fn`` on its local query heads and the K/V heads they
    read (K/V gathered on a mesh dim whose ranks do not divide KV; their
    gradient there is partial, a sum over the ranks' heads); batch splits
    ride along.  Other placements (and uneven splits) are DTensor's: DTensor
    cannot cut GQA's (KV, G) groups when KV does not divide over the ranks,
    and would otherwise gather every head onto every rank."""
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    if Shard(2) not in q.placements or any(
            p not in (Replicate(), Shard(0), Shard(2)) for p in q.placements):
        return fn(q, k, v, **kw)
    kv_places, grads = [], []
    for j, p in enumerate(q.placements):
        gather = p == Shard(2) and KV % mesh.shape[j]
        kv_places.append(Replicate() if gather else p)
        grads.append(Partial() if gather else p)
    try:
        h_size, h_off = local_box(q.shape, mesh, q.placements)
        k_size, k_off = local_box(k.shape, mesh, kv_places)
    except ValueError:
        return fn(q, k, v, **kw)
    G = H // KV
    if h_size[2] % G and G % h_size[2]:
        return fn(q, k, v, **kw)
    lo, hi = h_off[2] // G, -(-(h_off[2] + h_size[2]) // G)
    kl, vl = (local(t.redistribute(mesh, kv_places), grads)
              [:, :, lo - k_off[2]:hi - k_off[2]] for t in (k, v))
    o = fn(local(q), kl, vl, **kw)
    return wrap(o, mesh, q.placements, q.shape)


def _whole(t: DTensor, d: int, n: int) -> DTensor:
    """``t`` gathered on the mesh dims that split its dim ``d``, when their
    ranks do not divide ``n``, the number of heads (or K/V groups) that dim
    holds: DTensor cannot cut a head in two."""
    dims = [j for j, p in enumerate(t.placements) if p == Shard(d)]
    if n % math.prod(t.device_mesh.shape[j] for j in dims):
        t = t.redistribute(t.device_mesh, [
            Replicate() if j in dims else p
            for j, p in enumerate(t.placements)])
    return t


class _WholeGrad(torch.autograd.Function):
    """The identity; its cotangent comes ``_whole`` on dim ``d``."""
    @staticmethod
    def forward(ctx, x, d, n):
        ctx.d, ctx.n = d, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.d, ctx.n), None, None


@_rule("split_dim")
def _whole_splits(fn, x, dim: int, sizes):
    """Cutting ``dim`` into ``sizes`` on a DTensor: both ``x`` and the
    output's cotangent come whole on the mesh dims whose ranks do not
    divide the outer size ``sizes[0]`` (GQA's 8 K/V heads on a 16-wide
    "model" axis, where the reference's partitioner chooses its own
    layout); the unflatten and its backward then split no head."""
    d = dim % x.dim()
    out = fn(_whole(x, d, sizes[0]), dim, sizes)
    return _WholeGrad.apply(out, d, sizes[0])


@_rule("merge_dims")
def _whole_merges(fn, x, dim: int):
    """Merging ``dim`` with the next on a DTensor, the inverse of
    ``split_dim``: ``x`` and the output's cotangent come whole on the mesh
    dims whose ranks do not divide ``x.shape[dim]`` (granite_moe's 24 query
    heads, whose merged cotangent a row-parallel output projection hands
    back split 16 ways)."""
    d = dim % x.dim()
    n = x.shape[d]
    return _WholeGrad.apply(fn(_whole(x, d, n), dim), d, n)


@_rule("kv_write")
def _write_own_slots(fn, cache, new, positions, *, ring: bool = False):
    """The decode step's cache write on a DTensor cache: each rank writes
    the tokens whose slot and row fall in its own shard, into its local
    tensor; a row whose slot lies on another rank rewrites a value it
    holds.  ``new`` is brought to the cache's placements with the slot axis
    replicated; nothing of the cache moves."""
    mesh, places = cache.device_mesh, cache.placements
    new_l = new.redistribute(
        mesh, [Replicate() if p == Shard(1) else p for p in places]
    ).to_local()[:, 0]
    if isinstance(positions, DTensor):
        positions = positions.full_tensor()
    slots = positions.long()
    if ring:
        slots = slots % cache.shape[1]
    shape, off = local_box(cache.shape, mesh, places)
    rows = slots[off[0]:off[0] + shape[0]] - off[1]
    inside = (rows >= 0) & (rows < shape[1])
    lc = cache.to_local()
    idx = torch.arange(shape[0], device=lc.device)
    at = torch.clamp(rows, 0, shape[1] - 1)
    lc[idx, at] = torch.where(inside[:, None, None], new_l, lc[idx, at])
    return cache


@_rule("embed_grad")
def _embed_grad_sharded(fn, ct, tokens, V: int):
    """The embedding's backward on a DTensor cotangent (B, S, d): each rank
    sums its own rows into a (V, d-shard) table; a mesh dim that splits the
    rows leaves the sums partial, one that splits d shards the table's
    d."""
    mesh = ct.device_mesh
    rows = [p if p in (Shard(0), Shard(1)) else Replicate()
            for p in ct.placements]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    g = fn(ct.to_local(), tokens.redistribute(mesh, rows).to_local(), V)
    places = [Partial() if p in (Shard(0), Shard(1))
              else p if p.is_partial()
              else Shard(1) if p == Shard(2) else Replicate()
              for p in ct.placements]
    return wrap(g, mesh, places, (V, ct.shape[-1]))


@_rule("moe")
def _moe_sharded(fn, p, x, **kw):
    """The MoE layer on DTensors: each rank's tokens (the batch split over
    the data axes) through its d_ff slice of every expert.  Routing and
    dispatch are local to a group of tokens; the expert outputs are partial
    sums over the ranks that split d_ff.  The aux loss is a mean over groups
    of tokens: each rank's is the mean over its own, and the ranks that
    split d_ff compute the same one, so it goes back as a partial sum of
    aux / n over the n ranks of both.  Its gradient then comes to each rank
    whole, and is a share that the ranks' partial gradients sum to once
    (DTensor hands a partial's gradient back replicated, "avg" included,
    so a partial average would count it n times)."""
    mesh = x.device_mesh
    batch = [j for j, q in enumerate(x.placements) if q == Shard(0)]
    x = x.redistribute(mesh, [Shard(0) if j in batch else Replicate()
                              for j in range(mesh.ndim)])
    tp = [j for j, q in enumerate(p["w_up"].placements)
          if q == Shard(2) and j not in batch]
    n = math.prod(mesh.shape[j] for j in batch + tp)

    def place(dim):        # a d_ff split on the tp dims, else replicated
        return [Shard(dim) if j in tp else Replicate()
                for j in range(mesh.ndim)]

    def grads(dim):        # summed over the batch's ranks
        return [Shard(dim) if j in tp else Partial() if j in batch
                else Replicate() for j in range(mesh.ndim)]
    lp = {"router": local(
        p["router"].redistribute(mesh, [Replicate()] * mesh.ndim),
        [Partial() if j in batch or j in tp else Replicate()
         for j in range(mesh.ndim)])}
    for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
        if name in p:
            lp[name] = local(p[name].redistribute(mesh, place(dim)),
                             grads(dim))
    partial = [Partial() if j in tp else q for j, q in enumerate(x.placements)]
    out, aux = fn(lp, local(x, partial), **kw)
    return (wrap(out, mesh, partial, x.shape),
            wrap(aux / n, mesh, [Partial() if j in batch or j in tp
                                 else Replicate() for j in range(mesh.ndim)]))


# each chunked scan's positional operands: the dim of its heads (None: it
# has none); an operand of three or more dims leads with the batch
SCAN_HEADS = {"ssd_chunked": (2, 2, 0, None, None),      # x, dt, A, B, C
              "wkv6_chunked": (2, 2, 2, 2, 0)}           # r, k, v, w, u


@_rule("scan")
def _scan_local(fn, *args, initial_state=None, **kw):
    """A chunked scan (``ssm.ssd_chunked``, ``ssm.wkv6_chunked``) on
    DTensors.  The recurrence runs along the sequence, so each rank runs
    ``fn`` on its own batch rows and heads over the whole sequence: on each
    mesh dim the first operand's split is kept where it is the batch (dim
    0) or the heads and divides them evenly, every operand is brought to
    it, and any other split (the sequence, a head's channels) or partial
    sum is gathered.  The output (B, S, heads, ·) and the final state (B,
    heads, ·, ·) go back split alike, replicated along what was gathered.
    Unsplit operands (plain tensors) count as replicated."""
    heads = SCAN_HEADS[fn.__name__]
    x = args[0]
    mesh = x.device_mesh
    ops_dims = [(t, 0 if t.dim() > 2 else None, h)
                for t, h in zip(args, heads)]
    if initial_state is not None:
        ops_dims.append((initial_state, 0, 1))
    roles = []
    for j, p in enumerate(x.placements):
        role = ("batch" if p == Shard(0) else
                "heads" if p == Shard(heads[0]) else None)
        n = math.prod(mesh.shape[i] for i, q in enumerate(x.placements)
                      if q == p)
        even = role is not None and all(
            t.shape[d] % n == 0 for t, b, h in ops_dims
            for d in [b if role == "batch" else h] if d is not None)
        roles.append(role if even else None)

    def places(b, h):
        return [Shard(b) if r == "batch" and b is not None else
                Shard(h) if r == "heads" and h is not None else Replicate()
                for r in roles]

    def lcl(t, b, h):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return local(t.redistribute(mesh, places(b, h)))
    loc = [lcl(*od) for od in ops_dims]
    state = loc.pop() if initial_state is not None else None
    y, fin = fn(*loc, initial_state=state, **kw)
    B, S, H = x.shape[:3]
    return (wrap(y, mesh, places(0, 2), (B, S, H, y.shape[-1])),
            wrap(fin, mesh, places(0, 1), (B, H) + tuple(fin.shape[2:])))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@_rule("kernel")
def _kernel(fn, *operands, **kw):
    """An attention kernel's wrapper on DTensor operands: the kernel on
    local shards on the card (``kernel_on_shards``); on the CPU the plain
    attention on the DTensors."""
    if not operands[0].is_cuda:
        return fn(*operands, **kw)
    return kernel_on_shards(fn, *operands, **kw)


def _split_roles(name, operands, skip=()):
    """Per mesh dim, the role that splits every operand alike there:
    "batch" (dim 0) or "heads" (dim 2 of the 4-d operands: q's heads and
    the K/V heads alike), or None where the dim has size 1, replicates
    every operand or is in ``skip``.  Raises with the placements named on a
    mesh dim where neither role holds (a split head dim, a query split by
    batch where a cache splits its slots, K/V heads replicated beside
    split query heads), or where a role does not split evenly."""
    mesh = operands[0].device_mesh
    if any(not isinstance(t, DTensor) or t.device_mesh != mesh
           for t in operands):
        raise ValueError(f"{name}: every operand must be a DTensor on one "
                         f"mesh")
    # per operand: role -> tensor dim (a role it lacks: must be replicated)
    roles = [{"batch": 0, "heads": 2} if t.dim() == 4 else {"batch": 0}
             for t in operands]
    split = []                       # per mesh dim: the role split, or None
    for j, n in enumerate(mesh.shape):
        ps = [t.placements[j] for t in operands]
        if j in skip or n == 1 or all(isinstance(p, Replicate) for p in ps):
            split.append(None)
            continue
        role = next((r for r in ("batch", "heads") if all(
            p == (Shard(rs[r]) if r in rs else Replicate())
            for p, rs in zip(ps, roles)) and any(r in rs for rs in roles)),
            None)
        if role is None:
            raise ValueError(
                f"{name}: the kernel runs on shards split alike by batch or "
                f"by heads (a decode cache also by slots), not on mesh dim "
                f"{j} ({mesh.mesh_dim_names[j] if mesh.mesh_dim_names else j}"
                f", size {n}) with {[repr(p) for p in ps]} on "
                f"{[tuple(t.shape) for t in operands]}")
        for t, rs in zip(operands, roles):
            if role in rs and t.shape[rs[role]] % n:
                raise ValueError(f"{name}: {role} dim of {tuple(t.shape)} "
                                 f"does not split evenly over {n} ranks")
        split.append(role)
    return split


def kernel_on_shards(fn, *operands, **kw):
    """``fn`` on each rank's local shards of DTensor ``operands``, its
    output wrapped back — only where that is exact: every mesh dim of size
    1, or replicated on every operand, or splitting every operand alike on
    the batch (dim 0), or on the heads (dim 2 of q, k and v; the K/V heads
    split alike).  Any other placement raises with the placements named
    (``_split_roles``); a decode cache split by slots goes to rule
    "decode" first.  Nothing is gathered to run a kernel."""
    split = _split_roles(fn.__name__, operands)
    q = operands[0]
    mesh = q.device_mesh
    o = fn(*(t.to_local() for t in operands), **kw)
    out_dim = {"batch": 0, "heads": 2}
    shape = list(o.shape)
    for r, n in zip(split, mesh.shape):
        if r is not None:
            shape[out_dim[r]] *= n
    return wrap(o, mesh, [Replicate() if r is None else Shard(out_dim[r])
                          for r in split], shape)


def _reduce_over(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``t`` all-reduced (``op`` "max" or "sum") over the group of each
    mesh dim in ``dims`` in turn: over all their ranks together."""
    for j in dims:
        t = funcol.all_reduce(t, op, (mesh, j))
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


@_rule("decode")
def _decode_over_slots(fn, q, k_cache, v_cache, positions):
    """``ops.decode_attention`` on DTensors.  Where the caches split their
    slot axis (dim 1) on some mesh dims, each rank decodes over its own
    slots (``ops.decode_attention_partial``: the kernel's partial mode on
    the card, its plain version on the CPU or meta) with the global
    positions (whole, as in ``kv_write``) and its shard's slot offset from
    ``local_box``, and the ranks of those mesh dims combine their softmax
    states (``attention.combine_partials``: an all-reduce MAX of m, one
    SUM of the packed (o w, w): B H (hd + 2) floats).  On those dims q
    comes whole, its heads gathered where the column-parallel projection
    split them (B H hd elements).  On the other mesh dims q is brought to
    the caches' batch split where they split the batch, and summed where
    it is a partial sum (an FSDP projection's); batch and head splits
    there run as in ``kernel_on_shards``.  The output goes back in q's
    placements, the heads by a local slice (where q was a partial sum, in
    the placement it was brought to).  Nothing of the caches or the
    scores moves.  Without a slot split: rule "kernel"."""
    mesh = k_cache.device_mesh
    slots = [j for j, p in enumerate(k_cache.placements)
             if p == Shard(1) and mesh.shape[j] > 1]
    if not slots:
        return _kernel(fn, q, k_cache, v_cache, positions)
    from repro_torch.kernels import ops        # both import this module
    from repro_torch.models import attention
    if not (isinstance(q, DTensor) and isinstance(v_cache, DTensor)) or any(
            v_cache.placements[j] != Shard(1) or q.placements[j] == Shard(0)
            for j in slots):
        raise ValueError(
            f"{fn.__name__}: k_cache splits its slots on mesh dims {slots}; "
            f"the partial decode needs v_cache split alike and q not split "
            f"by batch there, got q {getattr(q, 'placements', None)}, "
            f"v_cache {getattr(v_cache, 'placements', None)}")
    # the other dims first, so the heads are gathered on this rank's batch
    mid = [p if j in slots
           else Shard(0) if k_cache.placements[j] == Shard(0)
           else Replicate() if p.is_partial() else p
           for j, p in enumerate(q.placements)]
    qw = q.redistribute(mesh, mid).redistribute(
        mesh, [Replicate() if j in slots else p for j, p in enumerate(mid)])
    _split_roles(fn.__name__, (qw, k_cache, v_cache), skip=slots)
    if isinstance(positions, DTensor):
        positions = positions.full_tensor()
    _, k_off = local_box(k_cache.shape, mesh, k_cache.placements)
    q_size, q_off = local_box(qw.shape, mesh, qw.placements)
    o, m, l = ops.decode_attention_partial(
        qw.to_local(), k_cache.to_local(), v_cache.to_local(),
        positions[q_off[0]:q_off[0] + q_size[0]], k_off[1],
        k_cache.shape[1])
    o = attention.combine_partials(
        o, m, l, lambda t: _reduce_over(t, "max", mesh, slots),
        lambda t: _reduce_over(t, "sum", mesh, slots), dtype=q.dtype)
    back = [w if p.is_partial() else p
            for p, w in zip(q.placements, qw.placements)]
    return wrap(o, mesh, qw.placements, q.shape).redistribute(mesh, back)


@_rule("z_update")
def _z_update_sharded(fn, omega_bar, z_old, thr):
    """The z-update on DTensors: elementwise on each rank's shard (z_old
    brought to omega_bar's placements), through the kernel or the plain
    version as the shard's device says; the two sums are partial over the
    mesh dims that split the tensor and are all-reduced there, so every
    rank holds the whole tensor's."""
    mesh = omega_bar.device_mesh
    places = [Replicate() if p.is_partial() else p
              for p in omega_bar.placements]
    omega_bar = omega_bar.redistribute(mesh, places)
    z_old = z_old.redistribute(mesh, places)
    if isinstance(thr, DTensor):
        thr = thr.to_local()
    zn, ssq, nnz = fn(omega_bar.to_local(), z_old.to_local(), thr)
    split = [Partial() if isinstance(p, Shard) else Replicate()
             for p in places]
    whole = [Replicate()] * mesh.ndim
    return (wrap(zn, mesh, places, omega_bar.shape),
            *(wrap(t, mesh, split).redistribute(mesh, whole)
              for t in (ssq, nnz)))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@_rule("flat_chunks")
def _dtensor_chunks(fn, *tensors):
    """DTensors of one mesh, shape and placement: ``fn``'s chunks of each
    rank's shard, as 1-d DTensors split (``Shard(0)``) on the mesh dims that
    split the tensors — so a 1x1 mesh repeats the unsharded chunks and
    their sums bit for bit.  DTensors of differing placements (ZeRO-1
    moments beside tensor-parallel weights) come whole, in one chunk.  The
    chunks are views: an update in place reaches the leaves."""
    first = tensors[0]
    if not all(isinstance(t, DTensor) and t.device_mesh == first.device_mesh
               and t.placements == first.placements
               and t.shape == first.shape for t in tensors):
        yield tensors
        return
    mesh = first.device_mesh
    places = [Shard(0) if isinstance(p, Shard) else p
              for p in first.placements]
    n_split = math.prod(mesh.shape[j] for j, p in enumerate(first.placements)
                        if isinstance(p, Shard))
    for chunk in fn(*(t.to_local() for t in tensors)):
        yield tuple(wrap(c, mesh, places, (c.numel() * n_split,))
                    for c in chunk)
