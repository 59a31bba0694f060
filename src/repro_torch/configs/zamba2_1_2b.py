"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_1_2b",
    family="hybrid",
    n_layers=38,            # mamba2 blocks
    d_model=2048,
    n_heads=32,             # shared attention block
    n_kv_heads=32,
    d_ff=8192,              # shared attention block MLP
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,           # shared attn applied every 6 mamba blocks
    mlp="gelu",
)
