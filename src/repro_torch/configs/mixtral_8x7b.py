"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,           # per-expert FF width
    vocab_size=32_000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    mlp="swiglu",
    rope_theta=1e6,
    moe_group_size=1024,   # dispatch/expert FLOP balance (H3)
    fsdp=True,               # 47B total params: TP-only shard (5.9 GB/chip) + grads is too tight
)
