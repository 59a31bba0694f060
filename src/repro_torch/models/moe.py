"""Mixture-of-experts FF layer with capacity dispatch (a port of
``repro/models/moe.py``).

Routing keeps the reference's rule exactly.  Tokens route in groups of
``gs`` tokens (one sequence by default, or ``group_size`` shrunk to a
divisor of S).  Within a group: router logits and softmax in float32;
the top ``k`` experts, ties going to the lower expert index (a stable
descending sort, as ``jax.lax.top_k`` breaks them); gate values
renormalised by ``max(sum, 1e-9)``; an assignment's slot in its expert's
buffer is the cumulative count of the expert's assignments in token
order; it is dropped unless ``slot < cap``, with
``cap = min(int(max(k * gs * cf / E, 1)), gs)``; the Switch aux loss,
averaged over groups.  At decode a group is one token, so cap = 1 and
nothing drops.

Dispatch and combine differ in form, not in value.  The reference
multiplies by dense one-hot (token, expert, slot) tensors
(``td,tec->ecd`` and ``ecd,tec->td``), which at granite_moe's prefill
cost about as many operations as the experts.  Here dispatch gathers
each slot's token (an empty slot reads a zero row: the one-hot sum of
one term), the experts run as one batched matmul over all groups'
slots, ``(E, groups * cap, d)``, and combine gathers each token's k
expert outputs and sums them in float32, choice by choice in the
order of the top-k, with no atomics, so a repeat is bit for bit.  The
reference's two ``moe_slots`` hints sit on the (E, groups * cap, d) slot
buffers that take the place of its ``xe`` and ``ye``.

Both gathers differentiate by gathers too (``gather_rows``), never by an
index accumulation: a kept slot holds one assignment and a token at most
k, so dispatch's gradient for token t is the sum of its k slots'
cotangents, in the order of the top-k (a dropped one reads zero), and
combine's for slot s is its one assignment's cotangent (an empty slot
gets zero).  A backward pass therefore repeats bit for bit on the card
too, where ``rows[index]``'s own backward adds atomically.

On DTensors (a sharded step) the layer runs on each rank's own tokens
with its d_ff slice of every expert (the rule "moe" of
``parallel/shards.py``); the slot buffers are then local tensors, which
the ``moe_slots`` hint leaves as they are.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel.ctx import constrain
from repro_torch.parallel.shards import on_shards


def init_moe(d_model: int, d_ff: int, n_experts: int, top_k: int,
             mlp_kind: str, dtype, *, generator, device):
    std = d_model ** -0.5
    kw = dict(generator=generator, device=device)
    p = {
        "router": layers.normal((d_model, n_experts), std, dtype, **kw),
        "w_up": layers.normal((n_experts, d_model, d_ff), std, dtype, **kw),
        "w_down": layers.normal((n_experts, d_ff, d_model), d_ff ** -0.5,
                                dtype, **kw),
    }
    if mlp_kind == "swiglu":
        p["w_gate"] = layers.normal((n_experts, d_model, d_ff), std, dtype,
                                    **kw)
    return p


def group_len(S: int, size: Optional[int]) -> int:
    """Tokens per routing group: ``size`` (default S), shrunk to a
    divisor of S."""
    gs = min(size or S, S)
    while S % gs:
        gs -= 1
    return gs


def capacity(top_k: int, gs: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group."""
    return min(int(max(top_k * gs * capacity_factor / n_experts, 1)), gs)


class Routing(NamedTuple):
    """One call's routing over G groups of gs tokens."""
    probs: torch.Tensor       # (G, gs, E) float32 router softmax
    gate_idx: torch.Tensor    # (G, gs, k) int64 experts, best first
    gate_vals: torch.Tensor   # (G, gs, k) float32, renormalised
    slot: torch.Tensor        # (G, gs, k) int64 rank in the expert's group
    kept: torch.Tensor        # (G, gs, k) bool: slot < cap
    counts: torch.Tensor      # (G, E) int64 tokens choosing each expert


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int,
          cap: int) -> Routing:
    """The routing of xg (G, gs, d) by ``router`` (d, E)."""
    E = router.shape[-1]
    logits = xg.float() @ router.float()                         # (G,gs,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    active = F.one_hot(gate_idx, E).sum(dim=2)                   # (G,gs,E)
    rank = torch.cumsum(active, dim=1) - 1                       # token order
    slot = torch.gather(rank, 2, gate_idx)
    return Routing(probs, gate_idx, gate_vals, slot, slot < cap,
                   active.sum(dim=1))


def _experts(p, xe: torch.Tensor) -> torch.Tensor:
    """(E, n, d) slot rows through each expert's MLP -> (E, n, d)."""
    if "w_gate" in p:
        h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.bmm(xe, p["w_up"]), approximate="tanh")
    return torch.bmm(h, p["w_down"])


def _pad(t: torch.Tensor) -> torch.Tensor:
    """``t`` (n, d) with a zero row n appended."""
    return torch.cat([t, t.new_zeros((1, t.shape[-1]))])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, inv):
        ctx.save_for_backward(inv)
        return _pad(table)[idx]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        g = _pad(g.reshape(-1, g.shape[-1]))
        acc = g[inv[:, 0]].float()
        for m in range(1, inv.shape[1]):
            acc = acc + g[inv[:, m]].float()
        return acc.to(g.dtype), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """``table`` (n, d)'s rows at ``idx`` (any shape; n reads a zero row),
    whose gradient is a fixed-order gather: row r of ``table`` gets the
    cotangent rows at ``inv[r, 0]``, ``inv[r, 1]``, ... summed in that
    order in float32, where ``inv`` (n, m) lists the positions of the
    flattened ``idx`` that read row r (``idx.numel()``: none)."""
    return _GatherRows.apply(table, idx, inv)


@on_shards("moe")
def moe_ff(p, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
           group_size: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar float32)."""
    B, S, d = x.shape
    gs = group_len(S, group_size)
    G, T = B * (S // gs), B * S
    E = p["router"].shape[-1]
    cap = capacity(top_k, gs, E, capacity_factor)
    r = route(p["router"], x.reshape(G, gs, d), top_k, cap)

    # slot (e, g, c) of the (E, G*cap) buffer; a dropped assignment points
    # one past its end, at a zero row
    n_slots = E * G * cap
    flat = (r.gate_idx * (G * cap)
            + torch.arange(G, device=x.device)[:, None, None] * cap
            + r.slot)
    flat = torch.where(r.kept, flat, n_slots).reshape(T, top_k)
    # the assignment t * k + j each kept slot holds (an empty one T * k);
    # the dropped all land on the spare entry n_slots
    asg = torch.full((n_slots + 1,), T * top_k, dtype=torch.long,
                     device=x.device)
    asg.scatter_(0, flat.reshape(-1),
                 torch.arange(T * top_k, device=x.device))
    asg = asg[:n_slots, None]
    xe = gather_rows(x.reshape(T, d), asg[:, 0] // top_k, flat)
    xe = constrain(xe.reshape(E, G * cap, d), "moe_slots")
    ye = constrain(_experts(p, xe), "moe_slots")
    yk = gather_rows(ye.reshape(n_slots, d), flat, asg)           # (T,k,d)

    # the reference rounds the combine weights to x's dtype
    w = torch.where(r.kept, r.gate_vals, 0.0).to(x.dtype).reshape(T, top_k)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        out = out + w[:, j, None].float() * yk[:, j].float()

    frac = r.counts.float() / (gs * top_k)                       # (G, E)
    aux = E * torch.sum(frac * r.probs.mean(dim=1), dim=-1)
    return out.to(x.dtype).reshape(B, S, d), aux.mean()
