"""Core layers of the LM side (a port of ``repro/models/layers.py``).

Parameters are nested dicts of tensors; init functions draw from an
explicit ``torch.Generator`` on the device they are given.  The rounding
points are the reference's: norms, RoPE and the logits compute in float32
and cast back to the activations' dtype; dense layers run in the
parameters' dtype (float32 accumulation inside the matmul).

Training adds the reference's ``grad_downcast`` and ``cross_entropy``.  The
embedding's backward sums the rows of repeated tokens in a fixed order
(a stable sort of the tokens, under deterministic algorithms), so a
training step repeats bit for bit on the card, where ``table[tokens]``'s
own backward adds floats atomically.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import deterministic
from repro_torch.parallel.shards import on_shards

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def normal(shape, std: float, dtype, generator, device):
    """Normal draws in float32, scaled, cast to ``dtype`` (the reference's
    ``(normal(key, shape, f32) * std).astype(dtype)``)."""
    out = torch.randn(shape, generator=generator, device=device,
                      dtype=torch.float32)
    return out.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def init_dense(d_in: int, d_out: int, dtype, *, generator, device,
               bias: bool = False):
    """{"w": (d_in, d_out)} in ``x @ w`` orientation, plus "b" if asked."""
    p = {"w": normal((d_in, d_out), d_in ** -0.5, dtype, generator, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Rotary position embeddings (GPT-NeoX rotate-half convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of shape (..., S, 1, hd/2) for ``apply_rope``.  A model
    call computes them once and hands them to every layer."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               tables=None) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).
    ``tables`` is ``rope_tables(positions, hd, theta)`` when precomputed."""
    cos, sin = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, kind: str, dtype, *, generator,
             device):
    kw = dict(generator=generator, device=device)
    if kind == "swiglu":
        return {
            "w_gate": init_dense(d_model, d_ff, dtype, **kw),
            "w_up": init_dense(d_model, d_ff, dtype, **kw),
            "w_down": init_dense(d_ff, d_model, dtype, **kw),
        }
    if kind == "gelu":
        return {
            "w_up": init_dense(d_model, d_ff, dtype, **kw),
            "w_down": init_dense(d_ff, d_model, dtype, **kw),
        }
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        h = F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(p["w_up"], x), approximate="tanh")
    return dense(p["w_down"], h)


# ---------------------------------------------------------------------------
# Gradient dtype barrier
# ---------------------------------------------------------------------------

class _GradDowncast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype)


def grad_downcast(x: torch.Tensor) -> torch.Tensor:
    """Identity that casts the COTANGENT to x's dtype (the reference's
    ``custom_vjp`` barrier where the residual stream meets the float32
    head)."""
    return _GradDowncast.apply(x)


@on_shards("split_dim")
def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x`` with ``dim`` cut into ``sizes`` (a view)."""
    return x.unflatten(dim, sizes)


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd)."""
    return split_dim(x, -1, (n, hd))


@on_shards("merge_dims")
def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dims ``dim`` and ``dim + 1`` as one: the inverse of
    ``split_dim`` ((B, S, H, hd) -> (B, S, H * hd))."""
    return x.flatten(dim, dim + 1)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embedding(vocab: int, d_model: int, dtype, *, generator, device):
    return normal((vocab, d_model), 0.02, dtype, generator, device)


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, ct):
        tokens, = ctx.saved_tensors
        return _embed_grad(ct, tokens, ctx.table_shape[0]), None


@on_shards("embed_grad")
def _embed_grad(ct, tokens, V: int) -> torch.Tensor:
    d = ct.shape[-1]
    grad = torch.zeros((V, d), dtype=ct.dtype, device=ct.device)
    with deterministic():
        grad.index_put_((tokens.reshape(-1).long(),), ct.reshape(-1, d),
                        accumulate=True)
    return grad


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; repeated tokens' cotangents are summed in a fixed
    order."""
    return _Embed.apply(table, tokens)


def lm_logits(head_w: torch.Tensor, x: torch.Tensor,
              n_valid: Optional[int] = None) -> torch.Tensor:
    """head_w: (vocab, d_model) — returns float32 logits.

    The head is cast to float32 for the product, as in the reference: at
    granite_8b's size that is a 0.8 GB temporary per call.  ``n_valid``
    masks vocab padding rows to -1e30."""
    logits = x.float() @ head_w.float().T
    V = head_w.shape[0]
    if n_valid is not None and n_valid < V:
        valid = torch.arange(V, device=logits.device) < n_valid
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, float32. logits (..., V), labels (...).

    The reference's form: the max is detached (``stop_gradient``), and the
    label pick is an iota compare and a masked sum."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    V = logits.shape[-1]
    hit = torch.arange(V, device=logits.device) == labels[..., None]
    ll = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    return torch.mean(lse - ll)
