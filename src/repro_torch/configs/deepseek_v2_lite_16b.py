"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H vocab=102400, MLA
kv_lora=512, MoE 2 shared + 64 routed top-6 [arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    mixer_pattern=("mla",),
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    ffn="moe", n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    microbatches=4,
)
