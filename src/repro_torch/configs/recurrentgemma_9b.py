"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1, MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern 2 recurrent : 1
attention [arXiv:2402.19427; unverified].  Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    mixer_pattern=("rglru", "rglru", "attn"),
    ffn="geglu", window=2048, d_rnn=4096, microbatches=8,
)
