"""Config dataclasses shared by every architecture (a copy of
``repro/configs/base.py`` without JAX).

A ``ModelConfig`` fully describes one backbone; a ``ShapeConfig`` describes
one (seq_len, global_batch, kind) workload cell; ``input_specs`` describes
one step's inputs as ``meta`` tensors (the reference's ShapeDtypeStructs),
which the dry-run and ``launch/steps.py`` build on.  The port ignores ``attn_head_pad``: it pads query heads for a TPU mesh and
does not change the math.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                      # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # default: d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"               # "swiglu" | "gelu"
    sliding_window: Optional[int] = None

    # MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid -----------------------------------------------------------
    ssm_state: int = 0                # Mamba2 state size N
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0               # hybrid: shared attn every k ssm blocks

    # RWKV -------------------------------------------------------------------
    rwkv_head_dim: int = 64

    # VLM --------------------------------------------------------------------
    cross_attn_every: int = 0         # cross-attn layer every k layers
    n_img_tokens: int = 0

    # Common -----------------------------------------------------------------
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # Sharding ----------------------------------------------------------------
    # Megatron-style vocab padding: embedding/head tables are allocated at
    # ``padded_vocab`` rows (a multiple of the mesh) and the padded logits are
    # masked to -inf.  Zero math change; see DESIGN.md §7.
    vocab_padded: Optional[int] = None
    # Attention COMPUTE-layout head padding (§Perf H2): query heads are
    # zero-padded to this count inside the attention op so the head axis
    # shards over the 16-way model axis (28/40/24-head configs otherwise
    # force GSPMD to partition the score contraction — an all-reduce of the
    # scores inside every attention block).  Parameters are untouched; the
    # padded heads' outputs are sliced away.
    attn_head_pad: int = 0
    # MoE routing group size in tokens (§Perf H3): dispatch/combine one-hot
    # FLOPs scale with group size; whole-sequence groups at 40 experts cost
    # ~11x the expert matmuls.  0 = one sequence per group.
    moe_group_size: int = 0
    # §Perf H4: shard the routed (E, cap, d) slot buffers over "model" so
    # expert compute is slot-local and the post-expert reduction shrinks
    # 16x.  Pays off when expert weights are SMALL (many-expert MoEs —
    # GSPMD re-gathers the ff-sharded expert weights per layer); large-
    # expert MoEs (mixtral) are better off with ff-sharded compute.
    moe_slot_sharding: bool = False
    # FSDP: additionally shard weight matrices over the data axes (ZeRO-3
    # style per-layer all-gather).  Set for archs whose TP-only shard does
    # not fit one chip's HBM during training.
    fsdp: bool = False
    # Serving variant of the above (weights resident is preferable; only the
    # 90B arch needs 2-D weight sharding to fit params + KV cache).
    fsdp_serve: bool = False

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return self.vocab_padded or self.vocab_size

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.n_heads == 0

    @property
    def subquadratic(self) -> bool:
        """True if the arch can decode with O(1)-per-token state at 500k ctx."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        total = v * d                                  # embedding
        if not self.tie_embeddings:
            total += v * d                             # lm head
        for i in range(self.n_layers):
            total += self._layer_params(i)
        if self.family == "hybrid" and self.attn_every:
            total += self._attn_params()               # one shared attn block
        total += d                                      # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only top_k experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dead = self.n_layers * (self.n_experts - self.top_k) * self._expert_params()
        return self.param_count() - dead

    # -- helpers -------------------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.qkv_bias:
            p += (self.n_heads + 2 * self.n_kv_heads) * hd
        return p

    def _expert_params(self) -> int:
        mult = 3 if self.mlp == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nh = d_in // self.ssm_head_dim
        # in_proj produces [z, x, B, C, dt]; out_proj back to d
        return d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d + 4 * d_in + 2 * nh

    def _rwkv_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,w,g projections + output + lora-ish decay (ignored) ...
        return 5 * d * d + d * d + 2 * self.d_ff * d

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        if self.family == "ssm":            # rwkv
            return self._rwkv_params() + 2 * d
        if self.family == "hybrid":         # mamba2 backbone
            return self._mamba_params() + 2 * d
        p = 2 * d                            # norms
        # vlm: every cross_attn_every-th block is a gated cross-attn block
        # with the SAME matrix shapes as a self block (+2 scalar gates)
        p += self._attn_params()
        if self.n_experts:
            p += self.n_experts * self._expert_params() + d * self.n_experts
        else:
            mult = 3 if self.mlp == "swiglu" else 2
            p += mult * d * self.d_ff
        return p


# ---------------------------------------------------------------------------
# Shape (workload) configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in LM_SHAPES]}")


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic decode state (see DESIGN.md)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "pure full-attention arch: 524288-token dense KV decode excluded "
            "by the shape's sub-quadratic requirement (DESIGN.md §4)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Input specs — meta-tensor stand-ins for the dry-run
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """One step's inputs as ``meta`` tensors (shape and dtype, nothing
    allocated), with the reference's keys:

    train   -> {tokens/embeds, labels}
    prefill -> {tokens/embeds}
    decode  -> {tokens/embeds (1 new position), positions}  (the cache is
               described by ``models.model.init_cache(..., abstract=True)``)
    """
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    specs = {}
    if cfg.family == "audio":
        # modality frontend is a stub: precomputed frame embeddings
        specs["embeds"] = meta((b, s, cfg.d_model), torch.bfloat16)
    else:
        specs["tokens"] = meta((b, s), torch.int32)
    if cfg.family == "vlm":
        specs["img_embeds"] = meta((b, cfg.n_img_tokens, cfg.d_model),
                                   torch.bfloat16)
    if shape.kind == "train":
        specs["labels"] = meta((b, s), torch.int32)
    if shape.kind == "decode":
        specs["positions"] = meta((b,), torch.int32)
    return specs
