"""rwkv6-1.6b (Finch) [ssm] — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1_6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65_536,
    rwkv_head_dim=64,
    ssm_chunk=32,          # wkv intra-chunk (B,C,C,H,K) decay tensor traffic
                           # and FLOPs scale with C; 128 -> 32 is 4x (§Perf H5)
)
