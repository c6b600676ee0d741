"""Model / run configuration system.

``ModelConfig`` is a plain frozen dataclass covering every assigned
architecture family (dense / MoE / MLA / hybrid RG-LRU / SSD / enc-dec /
VLM).  ``ShapeConfig`` describes the four assigned input-shape cells.
Architectures register themselves in ``repro_torch.configs`` (one module
per arch).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    # mixer pattern: one entry per layer cycle, e.g. ("rglru","rglru","attn")
    # cycled over n_layers; default all-attention
    mixer_pattern: Sequence[str] = ("attn",)
    ffn: str = "swiglu"                # swiglu | geglu | moe | none
    # -- attention extras
    causal: bool = True                # False: bidirectional (encoder stacks)
    window: int | None = None          # local attention window (recurrentgemma)
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    # -- MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # -- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # -- RG-LRU / hybrid
    d_rnn: int = 0                     # RG-LRU width (recurrentgemma: d_model)
    conv_width: int = 4
    # -- SSD (mamba2)
    d_state: int = 0
    expand: int = 2
    ssd_head_dim: int = 64
    ssd_chunk: int = 256
    # -- enc-dec
    n_enc_layers: int = 0              # 0 -> decoder-only
    # -- training
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "full"                # none | full (per-layer checkpoint)
    microbatches: int = 1              # grad-accumulation splits of the batch
    opt_dtype: str = "float32"         # Adam moment dtype (bf16 for 200B+)
    seq_shard: bool = False            # Megatron-style sequence-sharded
                                       # activations between layers (§Perf)
    flash_causal_skip: bool = False    # unrolled-q flash: skip fully-masked
                                       # KV blocks (halves causal FLOPs, §Perf)
    moe_dispatch_shard: bool = False   # shard [E, cap, D] dispatch over
                                       # (model=EP, dp=token-slots) (§Perf)
    flash_vjp: bool = False            # recompute-based flash backward:
                                       # no stacked f32 probability residuals
    # fraction of prefix positions that come from the modality frontend stub
    # (audio frames / vision patches); input_specs provides embeddings
    frontend_prefix: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding tables are padded to a multiple of 256 so the vocab axis
        shards over any mesh (tokens never index the pad; logits beyond
        ``vocab`` are sliced off at the serving boundary)."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:          # SSD inner width
        return self.expand * self.d_model

    @property
    def n_ssd_heads(self) -> int:
        return self.d_inner // self.ssd_head_dim

    def cycle_len(self) -> int:
        return len(self.mixer_pattern)

    # --- parameter count (for 6ND model-flops accounting) -----------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (embedding included once)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        Dh = self.resolved_head_dim
        total = V * D * (1 if self.tie_embeddings else 2)
        per_cycle = 0
        for mixer in self.mixer_pattern:
            if mixer == "attn":
                if self.kv_lora_rank:
                    qd = self.qk_nope_head_dim + self.qk_rope_head_dim
                    per_cycle += D * self.n_heads * qd          # W_q
                    per_cycle += D * (self.kv_lora_rank + self.qk_rope_head_dim)
                    per_cycle += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_head_dim + self.v_head_dim)
                    per_cycle += self.n_heads * self.v_head_dim * D
                else:
                    per_cycle += D * self.n_heads * Dh
                    per_cycle += 2 * D * self.n_kv_heads * Dh
                    per_cycle += self.n_heads * Dh * D
            elif mixer == "rglru":
                dr = self.d_rnn or D
                per_cycle += 2 * D * dr + dr * D   # in/out projections (x2 gates)
                per_cycle += dr * self.conv_width + 3 * dr  # conv + lru gates
            elif mixer == "ssd":
                di, n = self.d_inner, self.d_state
                per_cycle += D * (2 * di + 2 * n + self.n_ssd_heads)
                per_cycle += di * D
            if self.ffn == "swiglu" or self.ffn == "geglu":
                per_cycle += 3 * D * F
            elif self.ffn == "moe":
                per_cycle += D * self.n_experts  # router
                e = self.n_experts + self.n_shared_experts
                per_cycle += 3 * D * self.moe_d_ff * (
                    (self.top_k + self.n_shared_experts) if active_only else e)
        n_cycles = L / len(self.mixer_pattern)
        total += int(per_cycle * n_cycles)
        if self.n_enc_layers:
            # encoder layers: self-attn + ffn; decoder adds cross-attn
            enc = self.n_enc_layers * (4 * D * self.n_heads * Dh + 3 * D * F)
            cross = L * (2 * D * self.n_kv_heads * Dh + 2 * D * self.n_heads * Dh)
            total += enc + cross
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# sub-quadratic archs that run long_500k (others skip-by-design)
SUBQUADRATIC = {"recurrentgemma-9b", "mamba2-780m"}
