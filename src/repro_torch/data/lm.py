"""Synthetic LM token pipeline (a port of ``repro/data/lm.py``):
deterministic, shardable, stateless.

Every worker regenerates its shard as a pure function of (seed, global
step, shard index), drawn on the device from the port's threefry
(``data/threefry.py``) in the reference's partitionable layout.  Tokens
are Zipfian (inverse CDF on a uniform) and labels next-token shifted.

Against the reference: tokens and labels are equal bit for bit.  The
uniform is ``jax.random.uniform(key, shape, minval=1e-6, maxval=1.0)``
with its affine map (one rounding, as XLA's fused multiply-add) and its
``max(minval, .)`` clamp; the power
``u ** (1 / (1 - a))`` is taken in float64 and rounded to float32, on
every device (a float32 ``torch.pow`` differs from XLA's on about 2% of
draws and moves a token by one rank now and then).  The audio and VLM
embeddings are normal draws, within 3 ulp of the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import threefry as tf
from repro_torch.device import resolve_device
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    seed: int = 0
    zipf_a: float = 1.2          # Zipf exponent


def _uniform(key: tf.Key, n: int, minval: float, maxval: float):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the
    [0, 1) draw times (maxval - minval) plus minval, floored at minval.
    XLA fuses the multiply-add (one rounding), so it runs here in float64,
    where the product of two float32 values is exact, and is rounded to
    float32 once."""
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    u = (tf.uniform(key, n).double() * span + lo).float()
    return torch.clamp_min(u, lo)


def _zipf_tokens(key: tf.Key, shape, vocab: int, a: float) -> torch.Tensor:
    """Zipf-ish sampling via inverse-CDF on uniform (approximate, O(1))."""
    u = _uniform(key, math.prod(shape), 1e-6, 1.0)
    # inverse of CDF ~ rank^{1-a}: rank = u^{1/(1-a)} over [1, V]; the
    # exponent is a float32 as the reference's weakly typed one
    r = torch.pow(u.double(), float(np.float32(1.0 / (1.0 - a)))).float()
    r = torch.clamp(r, 1.0, float(vocab))
    return (r - 1.0).to(torch.int32).reshape(shape)


def _normal(key: tf.Key, shape, dtype) -> torch.Tensor:
    return (tf.normal(key, math.prod(shape)).reshape(shape) * 0.02).to(dtype)


def batch_for(cfg: ModelConfig, shape: ShapeConfig, step: int,
              dcfg: LMDataConfig = LMDataConfig(), *,
              batch_override: Optional[int] = None,
              seq_override: Optional[int] = None,
              device="cuda") -> Dict[str, torch.Tensor]:
    """One global batch for (arch, shape, step) — pure function, drawn on
    ``device``.  Tokens, labels and positions are int32."""
    dev = resolve_device(device)
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    if shape.kind == "decode":
        S = 1
    key = tf.fold_in(tf.prng_key(dcfg.seed, device=dev), step)
    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        batch["embeds"] = _normal(key, (B, S, cfg.d_model), dtype_of(cfg))
    else:
        toks = _zipf_tokens(key, (B, S + 1), cfg.vocab_size, dcfg.zipf_a)
        batch["tokens"] = toks[:, :S]
        if shape.kind == "train":
            batch["labels"] = toks[:, 1:]
    if cfg.family == "vlm":
        batch["img_embeds"] = _normal(tf.fold_in(key, 1),
                                      (B, cfg.n_img_tokens, cfg.d_model),
                                      dtype_of(cfg))
    if cfg.family == "audio" and shape.kind == "train":
        batch["labels"] = _zipf_tokens(tf.fold_in(key, 2), (B, S),
                                       cfg.vocab_size, dcfg.zipf_a)
    if shape.kind == "decode":
        batch["positions"] = torch.zeros((B,), dtype=torch.int32,
                                         device=dev)
    return batch


def worker_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, w: int,
                 n_workers: int, dcfg: LMDataConfig = LMDataConfig(), *,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Worker w's slice of the global batch — regenerable by any replacement
    worker (same (seed, step, w) -> same data)."""
    full = batch_for(cfg, shape, step, dcfg, device=device)
    per = shape.global_batch // n_workers
    lo = w * per
    return {k: v[lo:lo + per] for k, v in full.items()}
