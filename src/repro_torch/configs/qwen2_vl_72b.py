"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].  The
vision frontend is a STUB: input_specs provides patch embeddings for a
prefix of the sequence plus 3-D (t,h,w) M-RoPE positions."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    mrope_sections=(16, 24, 24),
    frontend_prefix=0.25, microbatches=16,
)
