"""Decoder stack for serving and training (a port of
``repro/models/model.py``).

The dense family only: ``init_params``, ``init_cache``, ``forward``,
``loss_fn``, ``prefill`` and ``decode_step`` keep the reference's names,
arguments and parameter tree — nested dicts with every layer's leaves
stacked along a leading axis (``params["blocks"]["attn"]["wq"]["w"]`` is
(L, d, H*hd), in ``x @ w`` orientation).  A Python loop over layers takes
the place of ``lax.scan``; layer i's parameters and cache are views, never
copies.

Differences from the reference, none of which changes the math:
  * attention in ``forward``, ``prefill`` and ``decode_step`` goes through
    ``kernels/ops.py``: the hand-written flash and decode kernels on the
    card, their plain versions (``attention.block_attention`` /
    ``decode_attention``) on the CPU.  The kernels have no backward, so
    ``loss_fn`` runs ``attention.block_attention`` under autograd on either
    device, as the reference trains through its jnp sweep;
  * ``remat`` checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant) where the reference wraps the scan body in
    ``jax.checkpoint``; it takes effect only when grad mode is on;
  * caches are updated in place: ``prefill`` and ``decode_step`` write
    into the ``cache`` they are given and return that same dict;
  * the RoPE tables are computed once per call and shared by the layers;
  * ``attn_head_pad`` (a TPU mesh padding) is ignored, and the sharding
    hints (``constrain``) have no counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention, layers
from repro_torch.tree import flatten, tree_map

Params = Dict[str, Any]

SERVED_FAMILIES = ("dense",)


def _require_served(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family ({cfg.name}) is not ported; "
            f"the port serves {SERVED_FAMILIES} only (ROADMAP.md, Queue 1: "
            f"'The other LM families')")


# ===========================================================================
# Parameters
# ===========================================================================


def param_shapes(cfg: ModelConfig) -> Params:
    """The dense family's parameter tree as nested dicts of shapes, with
    the layer axis leading in ``blocks`` — the reference's pytree."""
    _require_served(cfg, "param_shapes")
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    H, KV, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def lin(d_in, d_out, bias=False):
        p = {"w": (L, d_in, d_out)}
        if bias:
            p["b"] = (L, d_out)
        return p
    attn = {"wq": lin(d, H * hd, cfg.qkv_bias),
            "wk": lin(d, KV * hd, cfg.qkv_bias),
            "wv": lin(d, KV * hd, cfg.qkv_bias),
            "wo": lin(H * hd, d)}
    if cfg.mlp == "swiglu":
        mlp = {"w_gate": lin(d, ff), "w_up": lin(d, ff), "w_down": lin(ff, d)}
    else:
        mlp = {"w_up": lin(d, ff), "w_down": lin(ff, d)}
    shapes = {"embed": (cfg.padded_vocab, d), "final_norm": (d,),
              "blocks": {"ln1": (L, d), "ln2": (L, d), "attn": attn,
                         "mlp": mlp}}
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.padded_vocab, d)
    return shapes


def _init_block_dense(cfg: ModelConfig, dtype, *, generator, device):
    """One transformer block (attn + mlp)."""
    kw = dict(generator=generator, device=device)
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attention.init_attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype,
            bias=cfg.qkv_bias, **kw),
        "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype, **kw),
    }


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters drawn on ``device`` from ``generator`` (which must
    live on that device), with the reference's initialisers: normal
    1/sqrt(d_in) for dense weights, 0.02 for the tables, ones for norms.
    Layers are drawn one at a time into the stacked tensors, so the float32
    temporaries stay one layer large."""
    _require_served(cfg, "init_params")
    dev = resolve_device(device)
    dtype = layers.dtype_of(cfg)
    kw = dict(generator=generator, device=dev)
    params: Params = {
        "embed": layers.init_embedding(cfg.padded_vocab, cfg.d_model, dtype,
                                       **kw),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.init_embedding(cfg.padded_vocab, cfg.d_model,
                                               dtype, **kw)
    blocks = None
    for i in range(cfg.n_layers):
        layer = _init_block_dense(cfg, dtype, **kw)
        if blocks is None:
            blocks = tree_map(lambda t: t.new_empty((cfg.n_layers,) + t.shape),
                              layer)
        tree_map(lambda dst, src: dst[i].copy_(src), blocks, layer)
    params["blocks"] = blocks
    return params


def _layers(blocks: Params) -> List[Params]:
    """Every layer's parameters (views), by ``unbind``: under autograd the
    stacked leaf's gradient is then one stack of the layers' gradients."""
    leaves, build = flatten(blocks)
    return [build(ls) for ls in zip(*(torch.unbind(t) for t in leaves))]


# ===========================================================================
# Block applications — full sequence (prefill)
# ===========================================================================


def _attn_seq(p, cfg: ModelConfig, x, positions, *, window, rope,
              kv_out: bool = False, attend=ops.flash_attention):
    """Pre-norm GQA attention over a full sequence, through ``attend``.
    Optionally return (k, v)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = layers.dense(p["attn"]["wq"], h).reshape(B, S, H, hd)
    k = layers.dense(p["attn"]["wk"], h).reshape(B, S, KV, hd)
    v = layers.dense(p["attn"]["wv"], h).reshape(B, S, KV, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta, tables=rope)
    k = layers.apply_rope(k, positions, cfg.rope_theta, tables=rope)
    o = attend(q, k, v, causal=True, window=window)
    x = x + layers.dense(p["attn"]["wo"], o.reshape(B, S, H * hd))
    return (x, (k, v)) if kv_out else x


def _ff_seq(p, cfg: ModelConfig, x):
    """Pre-norm MLP."""
    return x + layers.mlp(p["mlp"], layers.rms_norm(x, p["ln2"],
                                                    cfg.norm_eps))


def _block_seq(p, cfg: ModelConfig, x, positions, *, rope,
               kv_out: bool = False, attend=ops.flash_attention):
    out = _attn_seq(p, cfg, x, positions, window=cfg.sliding_window,
                    rope=rope, kv_out=kv_out, attend=attend)
    if kv_out:
        x, kv = out
        return _ff_seq(p, cfg, x), kv
    return _ff_seq(p, cfg, out)


# ===========================================================================
# Full-sequence forward
# ===========================================================================


def _lm_logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return layers.lm_logits(head, x, n_valid=cfg.vocab_size)


def _embed_input(params, cfg: ModelConfig, batch) -> torch.Tensor:
    return layers.embed(params["embed"], batch["tokens"])


def _forward(params, cfg: ModelConfig, batch, *, remat: bool, attend):
    _require_served(cfg, "forward")
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope = layers.rope_tables(positions, cfg.hd, cfg.rope_theta)

    def block(p, x):
        return _block_seq(p, cfg, x, positions, rope=rope, attend=attend)
    remat = remat and torch.is_grad_enabled()
    for p in _layers(params["blocks"]):
        x = checkpoint(block, p, x, use_reentrant=False) if remat \
            else block(p, x)
    x = layers.grad_downcast(x)       # cotangents in x's dtype upstream
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, cfg, x), torch.zeros((), device=x.device)


def forward(params, cfg: ModelConfig, batch, *, remat: bool = True):
    """Full-sequence forward -> (logits float32 (B, S, V), aux_loss 0),
    attention through ``ops.flash_attention`` (which refuses autograd
    inputs on the card: differentiate ``loss_fn``)."""
    return _forward(params, cfg, batch, remat=remat,
                    attend=ops.flash_attention)


AUX_WEIGHT = 0.01


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = True):
    """(ce + AUX_WEIGHT * aux, {"ce", "aux"}) of ``batch["labels"]``; the
    forward's attention is ``attention.block_attention`` on every device,
    so the loss differentiates."""
    logits, aux = _forward(params, cfg, batch, remat=remat,
                           attend=attention.block_attention)
    ce = layers.cross_entropy(logits, batch["labels"])
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# Serving: caches, prefill, decode
# ===========================================================================


def _attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Params:
    """The decode cache, zeros: k and v of (L, B, Smax, KV, hd), Smax =
    max_len (or the sliding window, a ring)."""
    _require_served(cfg, "init_cache")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, _attn_cache_len(cfg, max_len),
             cfg.n_kv_heads, cfg.hd)
    dtype = layers.dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _write_prefill(cache_kv, new, Smax: int):
    """Write S prefill tokens into an Smax-slot cache (ring-consistent), in
    place."""
    S = new.shape[1]
    if S <= Smax:
        cache_kv[:, :S] = new
        return cache_kv
    # keep the last Smax tokens at slot = pos % Smax
    idx = torch.arange(S - Smax, S, device=new.device) % Smax
    cache_kv[:, idx] = new[:, S - Smax:]
    return cache_kv


def cache_max_len(cfg: ModelConfig, cache) -> int:
    return cache["k"].shape[2]


def prefill(params, cfg: ModelConfig, batch, cache, *,
            last_only: bool = False) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt, filling ``cache`` in place. Returns (logits,
    cache).

    ``last_only`` returns logits for the final position only (B, 1, V) —
    what a serving step needs; avoids materialising (B, S, V) float32."""
    _require_served(cfg, "prefill")
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope = layers.rope_tables(positions, cfg.hd, cfg.rope_theta)
    Smax = cache_max_len(cfg, cache)
    for i, p in enumerate(_layers(params["blocks"])):
        x, (k, v) = _block_seq(p, cfg, x, positions, rope=rope, kv_out=True)
        _write_prefill(cache["k"][i], k, Smax)
        _write_prefill(cache["v"][i], v, Smax)
    if last_only:
        x = x[:, -1:]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache


def _attn_decode(p, cfg: ModelConfig, x, positions, ck, cv, *, ring: bool,
                 rope):
    """One-token attention vs cache, x (B, 1, d); writes the new token's
    k and v into ck, cv in place."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = layers.dense(p["attn"]["wq"], h).reshape(B, 1, H, hd)
    k = layers.dense(p["attn"]["wk"], h).reshape(B, 1, KV, hd)
    v = layers.dense(p["attn"]["wv"], h).reshape(B, 1, KV, hd)
    q = layers.apply_rope(q, None, cfg.rope_theta, tables=rope)
    k = layers.apply_rope(k, None, cfg.rope_theta, tables=rope)
    attention.update_cache(ck, k, positions, ring=ring)
    attention.update_cache(cv, v, positions, ring=ring)
    o = ops.decode_attention(q, ck, cv, positions)
    return x + layers.dense(p["attn"]["wo"], o.reshape(B, 1, H * hd))


def decode_step(params, cfg: ModelConfig, batch,
                cache) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence.

    batch: {"tokens" (B, 1), "positions" (B,)}.  Returns (logits (B, 1, V)
    float32, cache), the cache updated in place."""
    _require_served(cfg, "decode_step")
    x = _embed_input(params, cfg, batch)
    positions = batch["positions"]
    rope = layers.rope_tables(positions[:, None], cfg.hd, cfg.rope_theta)
    ring = cfg.sliding_window is not None
    for i, p in enumerate(_layers(params["blocks"])):
        x = _attn_decode(p, cfg, x, positions, cache["k"][i], cache["v"][i],
                         ring=ring, rope=rope)
        x = _ff_seq(p, cfg, x)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache
