"""Decoder stack for serving and training (a port of
``repro/models/model.py``).

Every family of the reference: dense, moe and audio (a stack of
transformer blocks), vlm (groups of self blocks, each group closed by a
gated cross-attention block over the image's K/V), hybrid (groups of
Mamba2 blocks, each closed by one shared attention block, then a tail of
Mamba2 blocks) and ssm (RWKV6 blocks).  ``init_params``, ``init_cache``,
``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` keep the
reference's names, arguments and trees — nested dicts with the layers'
leaves stacked along leading axes (``params["blocks"]["attn"]["wq"]["w"]``
is (L, d, H*hd), in ``x @ w`` orientation; ``self_blocks`` is (G, n_self,
...), ``mamba_groups`` (G, attn_every, ...)).  A Python loop over layers
takes the place of ``lax.scan``; layer i's parameters and cache are views,
never copies.

Differences from the reference, none of which changes the math:
  * attention in ``forward``, ``prefill`` and ``decode_step`` goes through
    ``kernels/ops.py``: the hand-written flash and decode kernels on the
    card (the VLM's cross-attention through flash's ``causal=False``
    instantiation at prefill and the decode kernel at decode), their
    plain versions on the CPU.  The kernels have no backward, so
    ``loss_fn`` runs ``attention.block_attention`` and
    ``attention.cross_attention`` under autograd on either device, as the
    reference trains through its jnp sweeps;
  * ``remat`` checkpoints the reference's unit (``torch.utils.checkpoint``,
    non-reentrant): a layer, a VLM group, a hybrid group, a layer of the
    hybrid tail; it takes effect only when grad mode is on;
  * caches are updated in place: ``prefill`` and ``decode_step`` write
    into the ``cache`` they are given and return that same dict;
  * the RoPE tables are computed once per call and shared by the layers;
  * ``attn_head_pad`` (a TPU mesh padding) is ignored.

The sharding hints sit where the reference's do: ``constrain`` on the
queries (``bshd``), the residual stream after each feed-forward and after
the embedding (``btd``) and the logits (``btv``); and at one more place,
the residual after attention (``btd``), which the reference's partitioner
places by itself: without it DTensor's per-operator choice leaves the
row-parallel output partial and the residual stream split over d, and
then gathers the MLP's weights.  They act only on DTensors under a rule
set (``parallel/ctx.py``, installed by ``launch/steps.lower_step``).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.parallel.ctx import constrain
from repro_torch.tree import flatten, tree_map

Params = Dict[str, Any]

D_CONV = 4   # mamba2 depthwise conv kernel size
LORA_W = 64  # rank of the RWKV6 data-dependent decay lora


# ===========================================================================
# Parameters
# ===========================================================================


def _init_block_dense(cfg: ModelConfig, dtype, kw):
    """One transformer block (attn + mlp or moe)."""
    p = {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, kw["device"]),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, kw["device"]),
        "attn": attention.init_attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype,
            bias=cfg.qkv_bias, **kw),
    }
    if cfg.n_experts:
        p["moe"] = moe.init_moe(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                cfg.top_k, cfg.mlp, dtype, **kw)
    else:
        p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                   **kw)
    return p


def _init_block_cross(cfg: ModelConfig, dtype, kw):
    """VLM cross-attention block (cross-attn + mlp, tanh-gated; the gates
    start at zero)."""
    dev = kw["device"]
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, dev),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, dev),
        "xattn": attention.init_attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype, **kw),
        "mlp": layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, dtype, **kw),
        "gate_attn": torch.zeros((), dtype=dtype, device=dev),
        "gate_mlp": torch.zeros((), dtype=dtype, device=dev),
    }


def _mamba_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, d_in + 2 * cfg.ssm_state


def _init_block_mamba(cfg: ModelConfig, dtype, kw):
    """A_log, D and dt_bias stay float32 whatever ``cfg.dtype``."""
    d, dev, f32 = cfg.d_model, kw["device"], torch.float32
    d_in, nh, conv_dim = _mamba_dims(cfg)
    return {
        "ln": layers.init_rmsnorm(d, dtype, dev),
        # in_proj -> [z (d_in), xBC (d_in + 2N), dt (nh)]
        "w_in": layers.init_dense(d, 2 * d_in + 2 * cfg.ssm_state + nh,
                                  dtype, **kw),
        "conv_w": layers.normal((D_CONV, conv_dim), D_CONV ** -0.5, dtype,
                                **kw),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32,
                                          device=dev)),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
        "norm": layers.init_rmsnorm(d_in, dtype, dev),
        "w_out": layers.init_dense(d_in, d, dtype, **kw),
    }


def _rwkv_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def _init_block_rwkv(cfg: ModelConfig, dtype, kw):
    """w0 and u stay float32 whatever ``cfg.dtype``; lora_b starts at
    zero."""
    d, hd, dev, f32 = cfg.d_model, cfg.rwkv_head_dim, kw["device"], \
        torch.float32
    H = _rwkv_heads(cfg)

    def mix():
        return torch.rand((d,), generator=kw["generator"], device=dev,
                          dtype=f32).to(dtype)

    def lin(d_in, d_out):
        return layers.init_dense(d_in, d_out, dtype, **kw)
    return {
        "ln1": layers.init_rmsnorm(d, dtype, dev),
        "ln2": layers.init_rmsnorm(d, dtype, dev),
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_w": mix(),
        "mu_g": mix(),
        "w0": torch.full((d,), -2.0, dtype=f32, device=dev),
        "lora_a": layers.normal((d, LORA_W), 0.01, dtype, **kw),
        "lora_b": torch.zeros((LORA_W, d), dtype=dtype, device=dev),
        "u": layers.normal((H, hd), 0.1, f32, **kw),
        "wr": lin(d, d), "wk": lin(d, d), "wv": lin(d, d), "wg": lin(d, d),
        "wo": lin(d, d),
        "gn": layers.init_rmsnorm(d, dtype, dev),
        # channel mix
        "mu_ck": mix(), "mu_cr": mix(),
        "wck": lin(d, cfg.d_ff), "wcv": lin(cfg.d_ff, d), "wcr": lin(d, d),
    }


def _vlm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, self_layers_per_group). One cross block per group."""
    g = cfg.cross_attn_every
    if cfg.n_layers % g:
        raise ValueError(f"vlm depth {cfg.n_layers} must be a multiple of "
                         f"cross_attn_every = {g}")
    return cfg.n_layers // g, g - 1


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, tail): groups of attn_every mamba blocks + shared attn."""
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


def _stack(lead: Tuple[int, ...], draw):
    """``draw()``'s tree, drawn once per index of ``lead`` into tensors
    stacked along those leading axes (the float32 temporaries stay one
    layer large)."""
    out = None
    for idx in itertools.product(*map(range, lead)):
        layer = draw()
        if out is None:
            out = tree_map(lambda t: t.new_empty(lead + t.shape), layer)
        tree_map(lambda dst, src: dst[idx].copy_(src), out, layer)
    return out


def init_params(cfg: ModelConfig, *, generator, device="cuda") -> Params:
    """Random parameters drawn on ``device`` from ``generator`` (which must
    live on that device), with the reference's initialisers: normal
    1/sqrt(d_in) for dense weights, 0.02 for the tables, ones for norms,
    the reference's constants and zeros elsewhere.  On the ``meta``
    device (``generator=None``) it allocates nothing: ``param_specs``."""
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

    def blocks(init, *lead):
        return _stack(lead, lambda: init(cfg, dtype, kw))
    if cfg.family in ("dense", "moe", "audio"):
        params["blocks"] = blocks(_init_block_dense, cfg.n_layers)
    elif cfg.family == "vlm":
        G, n_self = _vlm_groups(cfg)
        params["self_blocks"] = blocks(_init_block_dense, G, n_self)
        params["cross_blocks"] = blocks(_init_block_cross, G)
    elif cfg.family == "hybrid":
        G, tail = _hybrid_groups(cfg)
        params["mamba_groups"] = blocks(_init_block_mamba, G, cfg.attn_every)
        if tail:
            params["mamba_tail"] = blocks(_init_block_mamba, tail)
        params["shared_attn"] = _init_block_dense(cfg, dtype, kw)
    elif cfg.family == "ssm":
        params["blocks"] = blocks(_init_block_rwkv, cfg.n_layers)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return params


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors: each leaf's shape and dtype
    (float32 for the mamba and rwkv leaves the reference keeps in float32
    in any model), nothing allocated."""
    return init_params(cfg, generator=None, device="meta")


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as nested dicts of shapes."""
    return tree_map(lambda t: tuple(t.shape), param_specs(cfg))


def _layers(blocks: Params) -> List[Params]:
    """The parameters along the leading axis (views), by ``unbind``: under
    autograd the stacked leaf's gradient is then one stack of the layers'
    gradients.  A doubly stacked tree gives groups, whose layers are
    ``_layers`` of each."""
    leaves, build = flatten(blocks)
    return [build(ls) for ls in zip(*(torch.unbind(t) for t in leaves))]


# ===========================================================================
# Block applications — full sequence (prefill)
# ===========================================================================


def _attn_seq(p, cfg: ModelConfig, x, positions, *, window, rope, attend):
    """Pre-norm GQA attention over a full sequence, through ``attend``.
    Returns (x, (k, v))."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = layers.split_heads(layers.dense(p["attn"]["wq"], h), H, hd)
    k = layers.split_heads(layers.dense(p["attn"]["wk"], h), KV, hd)
    v = layers.split_heads(layers.dense(p["attn"]["wv"], h), KV, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta, tables=rope)
    k = layers.apply_rope(k, positions, cfg.rope_theta, tables=rope)
    q = constrain(q, "bshd")
    o = attend(q, k, v, causal=True, window=window)
    x = constrain(x + layers.dense(p["attn"]["wo"], layers.merge_dims(o, 2)),
                  "btd")
    return x, (k, v)


def _ff_seq(p, cfg: ModelConfig, x):
    """Pre-norm MLP or MoE. Returns (x, aux_loss)."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = moe.moe_ff(p["moe"], h, top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor,
                            group_size=cfg.moe_group_size or None)
    else:
        y = layers.mlp(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return constrain(x + y, "btd"), aux


def _block_seq(p, cfg: ModelConfig, x, positions, *, rope, attend):
    """Returns (x, aux, (k, v))."""
    x, kv = _attn_seq(p, cfg, x, positions, window=cfg.sliding_window,
                      rope=rope, attend=attend)
    x, aux = _ff_seq(p, cfg, x)
    return x, aux, kv


def _cross_block_seq(p, cfg: ModelConfig, x, img_kv, *, cross):
    """VLM gated cross-attention block. img_kv = (k_img, v_img)."""
    H, hd = cfg.n_heads, cfg.hd
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = layers.split_heads(layers.dense(p["xattn"]["wq"], h), H, hd)
    o = cross(q, *img_kv)
    o = layers.dense(p["xattn"]["wo"], layers.merge_dims(o, 2))
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * o
    y = layers.mlp(p["mlp"], layers.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * y


def _img_kv(p, cfg: ModelConfig, img_embeds):
    """Project image embeddings to cross-attn K/V (per cross block)."""
    return tuple(layers.split_heads(layers.dense(p["xattn"][w], img_embeds),
                                    cfg.n_kv_heads, cfg.hd)
                 for w in ("wk", "wv"))


# -- mamba2 ------------------------------------------------------------------


def _causal_conv_seq(x, w, b, state=None):
    """Depthwise causal conv1d. x (B,S,C), w (D_CONV,C).  state (B,D_CONV-1,C)
    holds the previous tokens (zeros at sequence start)."""
    B, S, C = x.shape
    pad = (x.new_zeros((B, D_CONV - 1, C)) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                            # (B, S+3, C)
    out = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(D_CONV))
    return out + b.to(x.dtype), xp[:, S:]


def _mamba_block_seq(p, cfg: ModelConfig, x, conv_state=None,
                     ssm_state=None):
    """Returns (x, new conv state, new ssm state)."""
    d_in, nh, conv_dim = _mamba_dims(cfg)
    N = cfg.ssm_state
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = layers.dense(p["w_in"], h)
    z = zxbcdt[..., :d_in]
    xBC, new_conv = _causal_conv_seq(zxbcdt[..., d_in:d_in + conv_dim],
                                     p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    Bsz, S = x.shape[:2]
    xh = xBC[..., :d_in].reshape(Bsz, S, nh, cfg.ssm_head_dim)
    dt = F.softplus(zxbcdt[..., d_in + conv_dim:].float() + p["dt_bias"])
    y, new_ssm = ssm.ssd_chunked(
        xh, dt, -torch.exp(p["A_log"]), xBC[..., d_in:d_in + N],
        xBC[..., d_in + N:], chunk=cfg.ssm_chunk, initial_state=ssm_state)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bsz, S, d_in) * F.silu(z)
    y = layers.rms_norm(y, p["norm"], cfg.norm_eps)
    return x + layers.dense(p["w_out"], y), new_conv, new_ssm


# -- rwkv6 -------------------------------------------------------------------


def _token_shift(x, state=None):
    """(B,S,d) -> previous token per position; state = last token of
    context."""
    first = x.new_zeros((x.shape[0], 1, x.shape[2])) if state is None \
        else state[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_time_mix_seq(p, cfg: ModelConfig, x, shift_state=None,
                       wkv_state=None):
    B, S, d = x.shape
    H, hd = _rwkv_heads(cfg), cfg.rwkv_head_dim
    xs = _token_shift(x, shift_state)

    def mix(mu):
        return x + (xs - x) * p[mu].to(x.dtype)
    r = layers.dense(p["wr"], mix("mu_r")).reshape(B, S, H, hd)
    k = layers.dense(p["wk"], mix("mu_k")).reshape(B, S, H, hd)
    v = layers.dense(p["wv"], mix("mu_v")).reshape(B, S, H, hd)
    g = F.silu(layers.dense(p["wg"], mix("mu_g")))
    # Finch: data-dependent per-channel decay via a low-rank adapter
    dw = torch.tanh(mix("mu_w").float() @ p["lora_a"].float()) \
        @ p["lora_b"].float()
    w_log = -torch.exp(p["w0"] + dw).reshape(B, S, H, hd)        # <= 0
    o, new_wkv = ssm.wkv6_chunked(r, k, v, w_log, p["u"],
                                  chunk=cfg.ssm_chunk or 64,
                                  initial_state=wkv_state)
    # per-head group norm, then the gate
    o = o.float()
    o = o * torch.rsqrt(torch.mean(o * o, dim=-1, keepdim=True)
                        + cfg.norm_eps)
    o = (o.reshape(B, S, d) * p["gn"].float()).to(x.dtype)
    return layers.dense(p["wo"], o * g), x[:, -1], new_wkv


def _rwkv_channel_mix_seq(p, x, shift_state=None):
    xs = _token_shift(x, shift_state)
    xk = x + (xs - x) * p["mu_ck"].to(x.dtype)
    xr = x + (xs - x) * p["mu_cr"].to(x.dtype)
    kk = torch.square(torch.relu(layers.dense(p["wck"], xk)))
    out = torch.sigmoid(layers.dense(p["wcr"], xr)) * \
        layers.dense(p["wcv"], kk)
    return out, x[:, -1]


def _rwkv_block_seq(p, cfg: ModelConfig, x, shift_t=None, wkv=None,
                    shift_c=None):
    """Returns (x, new shift_t, new wkv, new shift_c)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    dt, new_shift_t, new_wkv = _rwkv_time_mix_seq(p, cfg, h, shift_t, wkv)
    x = x + dt
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    dc, new_shift_c = _rwkv_channel_mix_seq(p, h, shift_c)
    return x + dc, new_shift_t, new_wkv, new_shift_c


# ===========================================================================
# Full-sequence forward
# ===========================================================================


def _lm_logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return layers.lm_logits(head, x, n_valid=cfg.vocab_size)


def _embed_input(params, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.family == "audio":
        return batch["embeds"]
    return layers.embed(params["embed"], batch["tokens"])


def _forward(params, cfg: ModelConfig, batch, *, remat: bool, attend, cross):
    x = constrain(_embed_input(params, cfg, batch), "btd")
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope = layers.rope_tables(positions, cfg.hd, cfg.rope_theta) \
        if cfg.n_heads else None
    remat = remat and torch.is_grad_enabled()

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)

    def block(p, x):
        return _block_seq(p, cfg, x, positions, rope=rope, attend=attend)[:2]
    auxs = []
    if cfg.family in ("dense", "moe", "audio"):
        for p in _layers(params["blocks"]):
            x, aux = run(block, p, x)
            auxs.append(aux)
    elif cfg.family == "vlm":
        img_embeds = batch["img_embeds"]

        def group(pg, pc, x):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for p in _layers(pg):
                x, a = block(p, x)
                aux = aux + a
            x = _cross_block_seq(pc, cfg, x, _img_kv(pc, cfg, img_embeds),
                                 cross=cross)
            return x, aux
        for pg, pc in zip(_layers(params["self_blocks"]),
                          _layers(params["cross_blocks"])):
            x, aux = run(group, pg, pc, x)
            auxs.append(aux)
    elif cfg.family == "hybrid":
        def group(pg, x):
            for p in _layers(pg):
                x = _mamba_block_seq(p, cfg, x)[0]
            return block(params["shared_attn"], x)
        for pg in _layers(params["mamba_groups"]):
            x, aux = run(group, pg, x)
            auxs.append(aux)
        for p in _layers(params.get("mamba_tail", {})):
            x = run(lambda p, x: _mamba_block_seq(p, cfg, x)[0], p, x)
    elif cfg.family == "ssm":
        for p in _layers(params["blocks"]):
            x = run(lambda p, x: _rwkv_block_seq(p, cfg, x)[0], p, x)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    aux_total = torch.stack(auxs).sum() if auxs else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    x = layers.grad_downcast(x)       # cotangents in x's dtype upstream
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(_lm_logits(params, cfg, x), "btv"), aux_total


def forward(params, cfg: ModelConfig, batch, *, remat: bool = True):
    """Full-sequence forward -> (logits float32 (B, S, V), aux_loss),
    attention through ``ops.flash_attention`` and ``ops.cross_attention``
    (which refuse autograd inputs on the card: differentiate
    ``loss_fn``)."""
    return _forward(params, cfg, batch, remat=remat,
                    attend=ops.flash_attention, cross=ops.cross_attention)


AUX_WEIGHT = 0.01


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = True):
    """(ce + AUX_WEIGHT * aux, {"ce", "aux"}) of ``batch["labels"]``; the
    forward's attention is the plain versions on every device, so the loss
    differentiates."""
    logits, aux = _forward(params, cfg, batch, remat=remat,
                           attend=attention.block_attention,
                           cross=attention.cross_attention)
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
               device="cuda", abstract: bool = False) -> Params:
    """The decode cache, zeros, in the reference's layout: k and v of
    (L, B, Smax, KV, hd), Smax = max_len (or the sliding window, a ring);
    the VLM's (G, n_self, ...) and its image K/V (G, B, n_img_tokens, KV,
    hd); the hybrid's float32 ssm and conv states per mamba block and
    one K/V per shared-attention application (G, ...); the ssm's float32
    wkv state and token shifts per layer.  ``abstract`` describes it on
    the ``meta`` device instead (shapes and dtypes, nothing allocated)."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    dtype, f32 = layers.dtype_of(cfg), torch.float32

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    kv = (batch, _attn_cache_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    if cfg.family in ("dense", "moe", "audio"):
        L = (cfg.n_layers,)
        return {"k": zeros(L + kv), "v": zeros(L + kv)}
    if cfg.family == "vlm":
        G, n_self = _vlm_groups(cfg)
        img = (G, batch, cfg.n_img_tokens, cfg.n_kv_heads, cfg.hd)
        return {"k": zeros((G, n_self) + kv), "v": zeros((G, n_self) + kv),
                "k_img": zeros(img), "v_img": zeros(img)}
    if cfg.family == "hybrid":
        G, _ = _hybrid_groups(cfg)
        _, nh, conv_dim = _mamba_dims(cfg)
        L = cfg.n_layers
        return {"ssm": zeros((L, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                             f32),
                "conv": zeros((L, batch, D_CONV - 1, conv_dim)),
                "attn_k": zeros((G,) + kv), "attn_v": zeros((G,) + kv)}
    if cfg.family == "ssm":
        L, d, hd = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
        return {"wkv": zeros((L, batch, _rwkv_heads(cfg), hd, hd), f32),
                "shift_t": zeros((L, batch, d)),
                "shift_c": zeros((L, batch, d))}
    raise ValueError(f"unknown family {cfg.family!r}")


def _write_prefill(cache_kv, new, Smax: int):
    """Write S prefill tokens into an Smax-slot cache (ring-consistent), in
    place."""
    S = new.shape[1]
    if S <= Smax:
        cache_kv[:, :S] = new
        return cache_kv
    # keep the last Smax tokens at slot = pos % Smax: a roll of them,
    # copied whole (a sharded cache takes it shard by shard)
    cache_kv.copy_(torch.roll(new[:, S - Smax:], (S - Smax) % Smax, 1))
    return cache_kv


def cache_max_len(cfg: ModelConfig, cache) -> int:
    if cfg.family in ("dense", "moe", "audio"):
        return cache["k"].shape[2]
    if cfg.family == "vlm":
        return cache["k"].shape[3]
    if cfg.family == "hybrid":
        return cache["attn_k"].shape[2]
    return 0  # ssm: stateful, no kv slots


def _hybrid_serve(params, cfg: ModelConfig, x, cache, attn, *,
                  carry: bool):
    """The hybrid stack over x while serving: every mamba block's conv and
    ssm states written into ``cache`` (and started from it when ``carry``,
    a decode step), the shared attention block after each group through
    ``attn(p, x, k_cache, v_cache)``, on a cache of its own per group."""
    G, _ = _hybrid_groups(cfg)

    def mamba(p, x, li):
        states = (cache["conv"][li], cache["ssm"][li]) if carry else ()
        x, conv, state = _mamba_block_seq(p, cfg, x, *states)
        cache["conv"][li].copy_(conv)
        cache["ssm"][li].copy_(state)
        return x
    for g, pg in enumerate(_layers(params["mamba_groups"])):
        for i, p in enumerate(_layers(pg)):
            x = mamba(p, x, g * cfg.attn_every + i)
        x = attn(params["shared_attn"], x, cache["attn_k"][g],
                 cache["attn_v"][g])
    for j, p in enumerate(_layers(params.get("mamba_tail", {}))):
        x = mamba(p, x, G * cfg.attn_every + j)
    return x


def _rwkv_serve(params, cfg: ModelConfig, x, cache, *, carry: bool):
    """The rwkv stack over x while serving: every block's token shifts and
    wkv state written into ``cache`` (and started from it when
    ``carry``)."""
    names = ("shift_t", "wkv", "shift_c")
    for i, p in enumerate(_layers(params["blocks"])):
        states = [cache[n][i] for n in names] if carry else ()
        x, *new = _rwkv_block_seq(p, cfg, x, *states)
        for n, t in zip(names, new):
            cache[n][i].copy_(t)
    return x


def prefill(params, cfg: ModelConfig, batch, cache, *,
            last_only: bool = False) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt, filling ``cache`` in place. Returns (logits,
    cache).

    ``last_only`` returns logits for the final position only (B, 1, V) —
    what a serving step needs; avoids materialising (B, S, V) float32."""
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope = layers.rope_tables(positions, cfg.hd, cfg.rope_theta) \
        if cfg.n_heads else None
    Smax = cache_max_len(cfg, cache)

    def block(p, x, ck, cv):
        x, _, (k, v) = _block_seq(p, cfg, x, positions, rope=rope,
                                  attend=ops.flash_attention)
        _write_prefill(ck, k, Smax)
        _write_prefill(cv, v, Smax)
        return x
    if cfg.family in ("dense", "moe", "audio"):
        for i, p in enumerate(_layers(params["blocks"])):
            x = block(p, x, cache["k"][i], cache["v"][i])
    elif cfg.family == "vlm":
        for g, (pg, pc) in enumerate(zip(_layers(params["self_blocks"]),
                                         _layers(params["cross_blocks"]))):
            for i, p in enumerate(_layers(pg)):
                x = block(p, x, cache["k"][g, i], cache["v"][g, i])
            k_img, v_img = _img_kv(pc, cfg, batch["img_embeds"])
            cache["k_img"][g].copy_(k_img)
            cache["v_img"][g].copy_(v_img)
            x = _cross_block_seq(pc, cfg, x, (k_img, v_img),
                                 cross=ops.cross_attention)
    elif cfg.family == "hybrid":
        x = _hybrid_serve(params, cfg, x, cache, block, carry=False)
    elif cfg.family == "ssm":
        x = _rwkv_serve(params, cfg, x, cache, carry=False)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
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
    q = layers.split_heads(layers.dense(p["attn"]["wq"], h), H, hd)
    k = layers.split_heads(layers.dense(p["attn"]["wk"], h), KV, hd)
    v = layers.split_heads(layers.dense(p["attn"]["wv"], h), KV, hd)
    q = layers.apply_rope(q, None, cfg.rope_theta, tables=rope)
    k = layers.apply_rope(k, None, cfg.rope_theta, tables=rope)
    attention.update_cache(ck, k, positions, ring=ring)
    attention.update_cache(cv, v, positions, ring=ring)
    o = ops.decode_attention(q, ck, cv, positions)
    return constrain(x + layers.dense(p["attn"]["wo"],
                                      o.reshape(B, 1, H * hd)), "btd")


def decode_step(params, cfg: ModelConfig, batch,
                cache) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence.

    batch: {"tokens" (B, 1) | "embeds" (B, 1, d), "positions" (B,)}.
    Returns (logits (B, 1, V) float32, cache), the cache updated in
    place."""
    x = _embed_input(params, cfg, batch)
    positions = batch["positions"]
    rope = layers.rope_tables(positions[:, None], cfg.hd, cfg.rope_theta) \
        if cfg.n_heads else None
    ring = cfg.sliding_window is not None

    def block(p, x, ck, cv):
        x = _attn_decode(p, cfg, x, positions, ck, cv, ring=ring, rope=rope)
        return _ff_seq(p, cfg, x)[0]
    if cfg.family in ("dense", "moe", "audio"):
        for i, p in enumerate(_layers(params["blocks"])):
            x = block(p, x, cache["k"][i], cache["v"][i])
    elif cfg.family == "vlm":
        for g, (pg, pc) in enumerate(zip(_layers(params["self_blocks"]),
                                         _layers(params["cross_blocks"]))):
            for i, p in enumerate(_layers(pg)):
                x = block(p, x, cache["k"][g, i], cache["v"][g, i])
            x = _cross_block_seq(pc, cfg, x,
                                 (cache["k_img"][g], cache["v_img"][g]),
                                 cross=ops.cross_attention)
    elif cfg.family == "hybrid":
        x = _hybrid_serve(params, cfg, x, cache, block, carry=True)
    elif cfg.family == "ssm":
        x = _rwkv_serve(params, cfg, x, cache, carry=True)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache
