"""Architecture registry: one module per assigned architecture (a copy of
``repro/configs/__init__.py`` without JAX).

``get_config(name)`` returns the full published config; ``reduced(cfg)``
returns a tiny same-family config for CPU smoke tests.  The paper's own
workload lives beside them in ``logreg_paper.py``.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    LM_SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_applicable,
    get_shape,
    input_specs,
)

ARCH_IDS = (
    "musicgen_large",
    "granite_moe_3b_a800m",
    "mixtral_8x7b",
    "qwen2_5_14b",
    "granite_8b",
    "stablelm_3b",
    "qwen2_7b",
    "llama3_2_vision_90b",
    "zamba2_1_2b",
    "rwkv6_1_6b",
)

# accept dashes too (CLI convenience)
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update(
    {
        "musicgen-large": "musicgen_large",
        "granite-moe-3b-a800m": "granite_moe_3b_a800m",
        "mixtral-8x7b": "mixtral_8x7b",
        "qwen2.5-14b": "qwen2_5_14b",
        "granite-8b": "granite_8b",
        "stablelm-3b": "stablelm_3b",
        "qwen2-7b": "qwen2_7b",
        "llama-3.2-vision-90b": "llama3_2_vision_90b",
        "zamba2-1.2b": "zamba2_1_2b",
        "rwkv6-1.6b": "rwkv6_1_6b",
    }
)


def get_config(name: str) -> ModelConfig:
    key = _ALIASES.get(name, name)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for smoke tests (CPU, one fwd/train step)."""
    small = dict(
        n_layers=2 if cfg.family not in ("hybrid",) else max(2, cfg.attn_every),
        d_model=64,
        n_heads=0 if cfg.n_heads == 0 else 4,
        n_kv_heads=0 if cfg.n_kv_heads == 0 else min(cfg.n_kv_heads, 2),
        d_ff=128,
        vocab_size=128,
        head_dim=16 if cfg.n_heads else None,
        dtype="float32",
    )
    if cfg.n_experts:
        # capacity_factor=8 makes the tiny configs effectively dropless so
        # prefill/decode equivalence tests are exact (full configs keep 1.25)
        small.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff=32,
                     capacity_factor=8.0)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "ssm":
        small.update(rwkv_head_dim=16)
    if cfg.sliding_window:
        small.update(sliding_window=32)
    if cfg.cross_attn_every:
        small.update(cross_attn_every=2, n_img_tokens=8, n_layers=4)
    if cfg.family == "hybrid":
        small.update(attn_every=2, n_layers=4)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


__all__ = [
    "ARCH_IDS",
    "LM_SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "cell_is_applicable",
    "get_config",
    "get_shape",
    "input_specs",
    "reduced",
]
