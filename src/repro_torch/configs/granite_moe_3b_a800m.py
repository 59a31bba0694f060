"""granite-moe-3b-a800m [moe] — 40 experts top-8 [hf:ibm-granite/granite-3.0-3b-a800m].

Assignment note: the inline spec says "MoE 40e top-8"; the trailing comment
says 32 experts.  HF granite-3.0-3b-a800m has 40 experts/top-8 — we use 40
(DESIGN.md §4, config notes).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_3b_a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,              # per-expert FF width
    vocab_size=49_155,
    vocab_padded=49_408,   # 49155 % 16 != 0; padded logit rows masked to -inf
    n_experts=40,
    top_k=8,
    mlp="swiglu",
    attn_head_pad=32,      # 24 heads -> 2/chip (H2)
    moe_group_size=512,    # dispatch FLOPs ~ group size; 4096-token groups cost 11x the experts (H3)
    moe_slot_sharding=True,  # 40 small experts: slot-local compute beats ff-sharding (H4)
)
