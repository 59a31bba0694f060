"""qwen2-7b [dense] — GQA kv=4, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1e6,
    attn_head_pad=32,      # 28 heads -> pad to 2/chip on the 16-way model axis (H2)
)
