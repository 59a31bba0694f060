"""Attention for prefill and decode (a port of ``repro/models/attention.py``).

``block_attention`` and ``decode_attention`` are the plain PyTorch
versions of the two hand-written kernels (``kernels/flash_attention.py``,
``kernels/decode_attention.py``): what a CPU tensor runs through
``kernels/ops.py``, and what ``chip_smoke.py`` holds each kernel against on
the card.  ``cross_attention`` (the VLM's, no mask) is the plain version
of flash's ``causal=False`` instantiation and of the decode kernel over
all of an image cache's slots.  They keep the reference's float32 scores
and softmax and its grouped GQA layout: query head ``h = kv * G + g``
attends with KV head ``kv``, and K/V are never repeated across the G
query heads.

Unlike the reference, the port updates KV caches in place
(``update_cache``), so a decode step does not copy the cache.

On DTensors (a sharded step) the functions marked ``on_shards`` follow
the rules of ``parallel/shards.py``: the attention of each rank's own
query heads, and a cache write into each rank's own slots.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers
from repro_torch.parallel.shards import on_shards

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype, *, generator, device,
                   bias: bool = False):
    kw = dict(generator=generator, device=device)
    return {
        "wq": layers.init_dense(d_model, n_heads * head_dim, dtype,
                                bias=bias, **kw),
        "wk": layers.init_dense(d_model, n_kv_heads * head_dim, dtype,
                                bias=bias, **kw),
        "wv": layers.init_dense(d_model, n_kv_heads * head_dim, dtype,
                                bias=bias, **kw),
        "wo": layers.init_dense(n_heads * head_dim, d_model, dtype, **kw),
    }


# ---------------------------------------------------------------------------
# Prefill: causal (optionally windowed) GQA over a full sequence
# ---------------------------------------------------------------------------

def _mask(Sq, Skv, causal, window, device):
    """(Sq, Skv) bool: key c is visible to query i."""
    qpos = torch.arange(Sq, device=device)
    kpos = torch.arange(Skv, device=device)
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        ok = qpos[:, None] >= kpos[None, :]
        if window is not None:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def _grouped(q, KV):
    return layers.split_dim(q, 2, (KV, q.shape[2] // KV))


@on_shards("heads")
def block_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    chunk: int = 512) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H, hd).

    The reference's online-softmax sweep, over KV chunks of ``chunk``
    keys (every query row at once; the mask removes what causality and
    the window exclude): float32 scores, ``m_safe = max(m, -1e30)``,
    the ``alpha`` rescale and ``l == 0 -> 1``.  P stays float32 in P·V."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    qg = _grouped(q, KV).float()
    scale = hd ** -0.5
    ok = _mask(Sq, Skv, causal, window, q.device)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qg.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(qg.shape[:-1], device=q.device)
    for c0 in range(0, Skv, chunk):
        kj = k[:, c0:c0 + chunk].float()
        vj = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kj) * scale
        okj = ok[:, c0:c0 + chunk]
        s = s.masked_fill(~okj[None, :, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.clamp(m_new, min=NEG_INF)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(torch.clamp(m, min=NEG_INF) - m_safe)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p,
                                                    vj)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).reshape(B, Sq, H, hd).to(q.dtype)


def naive_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """The full masked softmax: the oracle ``ref.flash_attention_ref``."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    s = torch.einsum("bqkgd,bckd->bqkgc", _grouped(q, KV).float(),
                     k.float()) * hd ** -0.5
    if causal:
        ok = _mask(Sq, Skv, causal, window, q.device)
        s = s.masked_fill(~ok[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Cross attention (no mask, short kv): chunked over q only
# ---------------------------------------------------------------------------

@on_shards("heads")
def cross_attention(q, k, v, *, chunk_q: int = 512) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, T, KV, hd) -> (B, Sq, H, hd): every query
    attends to all T keys.  The reference's plain version: float32 scores
    and softmax over query chunks of ``chunk_q`` (one chunk when Sq is
    not a multiple)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    cq = min(chunk_q, Sq)
    if Sq % cq:
        cq = Sq
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, Sq, cq):
        s = torch.einsum("bqkgd,bckd->bqkgc",
                         _grouped(q[:, q0:q0 + cq], KV).float(),
                         kf) * hd ** -0.5
        outs.append(torch.einsum("bqkgc,bckd->bqkgd",
                                 torch.softmax(s, dim=-1), vf))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode: one new token against a (possibly ring) KV cache
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, positions) -> torch.Tensor:
    """q (B, 1, H, hd), caches (B, Smax, KV, hd) (keys post-RoPE),
    positions (B,) the index of the new token -> (B, 1, H, hd).

    Valid slots are arange(Smax) <= position — correct for both linear and
    ring (sliding-window) caches because ring slots are all valid once
    position >= Smax and attention is order-independent over slots."""
    B, _, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    qg = layers.split_dim(q[:, 0], 1, (KV, H // KV)).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * hd ** -0.5
    valid = (torch.arange(Smax, device=q.device)[None, :]
             <= positions.to(q.device)[:, None])              # (B, Smax)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, positions,
                             slot_offset: int, s_total: int):
    """One shard of a decode over a cache whose slot axis is split: the
    caches (B, S, KV, hd) hold slots [slot_offset, slot_offset + S) of an
    ``s_total``-slot cache -> (o (B, 1, H, hd), m (B, 1, H), l (B, 1, H)),
    float32.  The reference kernel's masking on global slot indices (a
    slot is live iff it is <= the position, or every slot once the
    position reaches ``s_total``: a ring that has wrapped) and its
    ``NEG_INF`` floor: m is the shard's score max floored at -1e30, l the
    sum of exp(s - m) over its live slots, o the P·V sum divided by l (0
    where no slot is live, as l == 0 -> 1)."""
    B, _, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    qg = layers.split_dim(q[:, 0], 1, (KV, H // KV)).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * hd ** -0.5
    slot = slot_offset + torch.arange(S, device=q.device)
    pos = positions.to(q.device).long()[:, None]
    valid = (pos >= s_total) | (slot[None, :] <= pos)         # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return (o.reshape(B, 1, H, hd), m.reshape(B, 1, H), l.reshape(B, 1, H))


def combine_partials(o, m, l, max_reduce, sum_reduce, dtype=None):
    """Merge shards' softmax states (``decode_attention_partial``'s or the
    kernel's partial mode's) into one decode output: M = max(m), w = l
    exp(m - M), o = sum(o w) / sum(w) (sum(w) == 0 -> 1), cast to ``dtype``
    last.  ``max_reduce`` and ``sum_reduce`` reduce over the shards:
    all-reduces over a mesh dim's group, or a reduction over a stacked
    leading axis; the two sums go as one packed tensor, so a combine takes
    two reductions.  Every m is floored at -1e30, so an empty shard
    (l = 0) weighs 0 and nothing is NaN."""
    M = max_reduce(m)
    w = l * torch.exp(m - M)
    s = sum_reduce(torch.cat([o * w[..., None], w[..., None]], dim=-1))
    den = s[..., -1:]
    out = s[..., :-1] / torch.where(den == 0.0, torch.ones_like(den), den)
    return out if dtype is None else out.to(dtype)


@on_shards("kv_write")
def update_cache(cache: torch.Tensor, new: torch.Tensor,
                 positions: torch.Tensor, *, ring: bool = False):
    """Write one token per sequence, in place: cache (B, Smax, KV, hd),
    new (B, 1, KV, hd), sequence b's token at slot positions[b] (modulo
    Smax for a ring cache).  Returns ``cache``."""
    B, Smax = cache.shape[:2]
    slots = positions.long()
    if ring:
        slots = slots % Smax
    cache[torch.arange(B, device=cache.device), slots] = new[:, 0]
    return cache
