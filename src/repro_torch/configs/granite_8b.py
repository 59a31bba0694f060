"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    mlp="swiglu",
)
