"""Reduced-size configs of the same family for CPU smoke tests.

Every assigned architecture gets a structurally-identical miniature (same
mixer pattern, same FFN type, same MLA/MoE/SSD wiring — small widths, few
layers, tiny vocab).  Full configs run only on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    cyc = cfg.cycle_len()
    n_layers = cyc * 2 + (1 if cfg.n_layers % cyc else 0)  # cycles + tail
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=0 if cfg.ffn == "none" else 128,
        vocab=256,
        head_dim=16,
        remat="none",
    )
    if cfg.kv_lora_rank:
        kw.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16)
    if cfg.ffn == "moe":
        kw.update(n_experts=8, n_shared_experts=cfg.n_shared_experts and 1,
                  top_k=2, moe_d_ff=32)
    if "rglru" in cfg.mixer_pattern:
        kw.update(d_rnn=64, window=16)
    if "ssd" in cfg.mixer_pattern:
        kw.update(d_state=16, ssd_head_dim=16, expand=2, ssd_chunk=8)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, n_layers=2)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(2, 3, 3))   # sums to head_dim/2 = 8
    return dataclasses.replace(cfg, **kw)
