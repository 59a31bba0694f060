"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer.

Backbone only; the vision tower is a stub (input_specs supplies precomputed,
projected patch embeddings of shape (B, n_img_tokens, d_model)).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_2_vision_90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    cross_attn_every=5,
    n_img_tokens=1601,
    mlp="swiglu",
    rope_theta=5e5,
    fsdp=True,               # 88B params: 11 GB/chip TP-only does not leave room for training state
    fsdp_serve=True,         # params + 32k KV cache exceed HBM with weights TP-only resident
)
