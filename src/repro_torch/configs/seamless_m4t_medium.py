"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].  The audio
frontend is a STUB: input_specs provides precomputed frame embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    n_enc_layers=12, ffn="swiglu", microbatches=2,
)
