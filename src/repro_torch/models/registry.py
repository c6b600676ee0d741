"""Model registry: bundles (init / loss / forward / decode) built from a
``ModelConfig``, and the dry-run's input specs for every shape cell: the
counterpart of the reference's ``repro/models/registry.py``.

A bundle's ``init`` returns the model module, which is what the other
members take as ``params``; ``abstract_params`` returns the same module
on the ``meta`` device (shapes and dtypes, no memory), and
``abstract_cache`` the decode cache there.  :func:`input_specs` gives
meta tensors in place of the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import SUBQUADRATIC, ModelConfig, ShapeConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]                  # (seed=0, device="cuda") -> model
    abstract_params: Callable[[], Any]        # () -> model on meta
    loss: Callable[..., Any]                  # (model, batch) -> scalar
    forward: Callable[..., Any]               # (model, batch) -> logits
    decode_step: Callable[..., tuple]         # (model, cache, tok, pos)
    abstract_cache: Callable[..., Any]        # (batch, max_len) -> meta cache
    init_cache: Callable[..., Any]            # (batch, max_len, device="cuda")
    params_from_jax: Callable[..., Any]       # (tree, device="cuda") -> model


def build_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.n_enc_layers:
        return ModelBundle(
            cfg=cfg,
            init=lambda seed=0, device="cuda": encdec_lib.init_encdec(
                cfg, seed, device),
            abstract_params=lambda: encdec_lib.abstract_params(cfg),
            loss=encdec_lib.lm_loss,
            forward=encdec_lib.forward,
            decode_step=encdec_lib.decode_step,
            abstract_cache=lambda batch, max_len: encdec_lib.abstract_cache(
                cfg, batch, max_len, max_tgt=max(1024, max_len // 32)),
            init_cache=lambda batch, max_len, device="cuda":
                encdec_lib.init_cache(cfg, batch, max_len,
                                      max_tgt=max(1024, max_len // 32),
                                      device=device),
            params_from_jax=lambda tree, device="cuda":
                encdec_lib.params_from_jax(tree, cfg, device),
        )
    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0, device="cuda": lm_lib.init_lm(cfg, seed, device),
        abstract_params=lambda: lm_lib.abstract_params(cfg),
        loss=lm_lib.lm_loss,
        forward=lm_lib.forward,
        decode_step=lm_lib.decode_step,
        abstract_cache=lambda batch, max_len: lm_lib.abstract_cache(
            cfg, batch, max_len),
        init_cache=lambda batch, max_len, device="cuda": lm_lib.init_cache(
            cfg, batch, max_len, device),
        params_from_jax=lambda tree, device="cuda": lm_lib.params_from_jax(
            tree, cfg, device),
    )


# ---------------------------------------------------------------- specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors standing in for every model input of one cell, of the
    reference's shapes and dtypes.

    train/prefill: a token batch (plus stub frontend embeddings for
    audio/vlm archs, plus M-RoPE positions).  decode: one token per
    sequence + position scalar (the KV cache is built separately via
    ``abstract_cache``).
    """
    B, L = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    if shape.kind in ("train", "prefill"):
        if cfg.n_enc_layers:
            # enc-dec: frames are the long (audio) side; text targets short
            lt = max(128, min(1024, L // 32))
            return {"frames": _meta((B, L, cfg.d_model), dt),
                    "tokens": _meta((B, lt), torch.int32)}
        batch: dict = {}
        if cfg.frontend_prefix > 0:
            lp = int(L * cfg.frontend_prefix)
            batch["embeds"] = _meta((B, lp, cfg.d_model), dt)
            batch["tokens"] = _meta((B, L - lp), torch.int32)
            if cfg.mrope_sections:
                batch["positions"] = _meta((B, L, 3), torch.int32)
        else:
            batch["tokens"] = _meta((B, L), torch.int32)
        return batch

    # decode: one new token against a seq_len-deep cache
    return {"tokens": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def cell_is_runnable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention; encoder-only archs have no
    decode step (none assigned).  Returns (runnable, reason-if-skipped)."""
    if shape_name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, ("full O(L²) attention at 524k context — skipped by "
                       "design (DESIGN.md §4); run for SSM/hybrid archs only")
    return True, ""
