"""qwen2.5-14b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-14B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_5_14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13_824,
    vocab_size=152_064,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1e6,
    attn_head_pad=48,      # 40 heads -> 3/chip (H2)
)
