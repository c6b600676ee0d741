"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].
Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=0, vocab=50280,
    mixer_pattern=("ssd",), ffn="none",
    d_state=128, expand=2, ssd_head_dim=64, ssd_chunk=256, microbatches=4,
)
