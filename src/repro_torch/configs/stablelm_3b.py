"""stablelm-3b [dense] [hf:stabilityai/stablelm-3b; unverified tier]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    mlp="swiglu",
)
