"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536(moe)
vocab=102400, MLA kv_lora=512, MoE 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    mixer_pattern=("mla",),
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    ffn="moe", n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    microbatches=8, opt_dtype="bfloat16",
)
