"""Model registry: bundles (init / loss / forward / decode) built from a
``ModelConfig``, the counterpart of the reference's
``repro/models/registry.py``.

A bundle's ``init`` returns the model module, which is what the other
members take as ``params``.  The members of the dry-run
(``abstract_params``, ``abstract_cache``, and the module-level
``input_specs`` / ``cell_is_runnable``) come with that slice; reading one
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib

_LATER = {"abstract_params": "the dry-run slice (ROADMAP queue 1, item 5c)",
          "abstract_cache": "the dry-run slice (ROADMAP queue 1, item 5c)"}


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Any]                  # (seed=0, device="cuda") -> model
    loss: Callable[..., Any]                  # (model, batch) -> scalar
    forward: Callable[..., Any]               # (model, batch) -> logits
    decode_step: Callable[..., tuple]         # (model, cache, tok, pos)
    init_cache: Callable[..., Any]            # (batch, max_len, device="cuda")
    params_from_jax: Callable[..., Any]       # (tree, device="cuda") -> model

    def __getattr__(self, name):
        if name in _LATER:
            raise NotImplementedError(f"ModelBundle.{name} comes with "
                                      f"{_LATER[name]}")
        raise AttributeError(name)


def build_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.n_enc_layers:
        return ModelBundle(
            cfg=cfg,
            init=lambda seed=0, device="cuda": encdec_lib.init_encdec(
                cfg, seed, device),
            loss=encdec_lib.lm_loss,
            forward=encdec_lib.forward,
            decode_step=encdec_lib.decode_step,
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
        loss=lm_lib.lm_loss,
        forward=lm_lib.forward,
        decode_step=lm_lib.decode_step,
        init_cache=lambda batch, max_len, device="cuda": lm_lib.init_cache(
            cfg, batch, max_len, device),
        params_from_jax=lambda tree, device="cuda": lm_lib.params_from_jax(
            tree, cfg, device),
    )
