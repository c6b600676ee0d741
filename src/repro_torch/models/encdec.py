"""Encoder-decoder backbone (Seamless-M4T medium): the reference's
``repro/models/encdec.py``.

The audio frontend is a stub as in the reference: the encoder consumes
precomputed frame embeddings [B, L_src, D].  Encoder = bidirectional
self-attention stack; decoder = causal self-attention + cross-attention
stack.  The decode cache holds the self-attention KV and the cross KV;
like the reference's serve loop, nothing here fills ``cross_k`` /
``cross_v`` (they stay the zeros of ``init_cache``).  ``cfg.remat ==
"full"`` recomputes each encoder and decoder layer in the backward, as
the reference checkpoints each scanned layer.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.ffn import DenseFFN
from repro_torch.models.layers import (Weights, decode_attention,
                                       flash_attention, glorot,
                                       make_compute_copies, rms_norm)
from repro_torch.models.lm import (compute_dtype, generator, load_reference,
                                   remat_call, sharded_xent, step_position)
from repro_torch.models.mixers import Attention


class CrossAttention(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Dh = cfg.d_model, cfg.resolved_head_dim
        self.param("wq", D, cfg.n_heads * Dh, device=device)
        self.param("wk", D, cfg.n_kv_heads * Dh, device=device)
        self.param("wv", D, cfg.n_kv_heads * Dh, device=device)
        self.param("wo", cfg.n_heads * Dh, D, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            p = getattr(self, name)
            p.copy_(glorot(p.shape, gen, p.device))

    def kv(self, enc_out):
        cfg = self.cfg
        B, Ls, _ = enc_out.shape
        Dh = cfg.resolved_head_dim
        k = enc_out @ self.w("wk", enc_out.dtype)
        v = enc_out @ self.w("wv", enc_out.dtype)
        return (k.reshape(B, Ls, cfg.n_kv_heads, Dh),
                v.reshape(B, Ls, cfg.n_kv_heads, Dh))

    def query(self, x):
        B, Lt, _ = x.shape
        return (x @ self.w("wq", x.dtype)).reshape(
            B, Lt, self.cfg.n_heads, self.cfg.resolved_head_dim)

    def forward(self, x, k, v):
        B, Lt, _ = x.shape
        out = flash_attention(self.query(x), k, v, causal=False)
        return out.reshape(B, Lt, -1) @ self.w("wo", x.dtype)


class EncLayer(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # bidirectional self-attention
        self.attn = Attention(dataclasses.replace(cfg, causal=False),
                              device=device)
        self.param("attn_norm", cfg.d_model, device=device)
        self.ffn = DenseFFN(cfg, device=device)
        self.param("ffn_norm", cfg.d_model, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.attn.reset_parameters(gen)
        self.ffn.reset_parameters(gen)
        self.attn_norm.fill_(1.0)
        self.ffn_norm.fill_(1.0)

    def forward(self, x, positions):
        eps = self.cfg.norm_eps
        x = x + self.attn(rms_norm(x, self.attn_norm, eps), positions)
        return x + self.ffn(rms_norm(x, self.ffn_norm, eps))


class DecLayer(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, device=device)
        self.param("attn_norm", cfg.d_model, device=device)
        self.cross = CrossAttention(cfg, device=device)
        self.param("cross_norm", cfg.d_model, device=device)
        self.ffn = DenseFFN(cfg, device=device)
        self.param("ffn_norm", cfg.d_model, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.attn.reset_parameters(gen)
        self.cross.reset_parameters(gen)
        self.ffn.reset_parameters(gen)
        for name in ("attn_norm", "cross_norm", "ffn_norm"):
            getattr(self, name).fill_(1.0)

    def forward(self, x, positions, enc_out):
        eps = self.cfg.norm_eps
        x = x + self.attn(rms_norm(x, self.attn_norm, eps), positions)
        k, v = self.cross.kv(enc_out)
        x = x + self.cross(rms_norm(x, self.cross_norm, eps), k, v)
        return x + self.ffn(rms_norm(x, self.ffn_norm, eps))

    def decode(self, x, cache, pos):
        """One decoder step against the cross cache."""
        eps = self.cfg.norm_eps
        x = x + self.attn.decode(rms_norm(x, self.attn_norm, eps),
                                 cache["self"], pos)
        q = self.cross.query(rms_norm(x, self.cross_norm, eps))
        out = decode_attention(q, cache["cross_k"], cache["cross_v"],
                               cache["cross_k"].shape[1])
        x = x + out.reshape(x.shape[0], 1, -1) @ self.cross.w("wo", x.dtype)
        return x + self.ffn(rms_norm(x, self.ffn_norm, eps))


class EncDec(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.param("embed", cfg.padded_vocab, D, device=device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device=device)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device=device)
                                        for _ in range(cfg.n_layers))
        self.param("enc_norm", D, device=device)
        self.param("final_norm", D, device=device)
        self.param("lm_head", D, cfg.padded_vocab, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.embed.copy_(torch.randn(self.embed.shape, generator=gen,
                                     device=self.embed.device) * 0.02)
        for layer in [*self.enc_layers, *self.dec_layers]:
            layer.reset_parameters(gen)
        self.enc_norm.fill_(1.0)
        self.final_norm.fill_(1.0)
        self.lm_head.copy_(glorot(self.lm_head.shape, gen,
                                  self.lm_head.device))

    def encode(self, frames):
        """frames: [B, L_src, D] frontend-stub embeddings."""
        x = frames.to(compute_dtype(self.cfg))
        B, L, _ = x.shape
        positions = torch.arange(L, device=x.device).expand(B, L)
        for layer in self.enc_layers:
            x = remat_call(self.cfg, layer, x, positions)
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def forward(self, batch: dict) -> torch.Tensor:
        """batch: {"frames": [B, Ls, D], "tokens": [B, Lt]} -> logits
        [B, Lt, padded_vocab]."""
        enc_out = self.encode(batch["frames"])
        x = self.w("embed", compute_dtype(self.cfg))[batch["tokens"]]
        B, Lt, _ = x.shape
        positions = torch.arange(Lt, device=x.device).expand(B, Lt)
        for layer in self.dec_layers:
            x = remat_call(self.cfg, layer, x, positions, enc_out)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self.w("lm_head", x.dtype)

    def decode(self, cache: dict, tokens, pos) -> torch.Tensor:
        x = self.w("embed", compute_dtype(self.cfg))[tokens]
        for layer, c in zip(self.dec_layers, cache["dec"]):
            x = layer.decode(x, c, pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = x @ self.w("lm_head", x.dtype)
        return logits[:, 0, :self.cfg.vocab]


# ---------------------------------------------------------------- API
def init_encdec(cfg: ModelConfig, seed: int = 0, device="cuda") -> EncDec:
    dev = resolve_device(device)
    model = EncDec(cfg, device=dev)
    model.reset_parameters(generator(seed, dev))
    make_compute_copies(model, compute_dtype(cfg))
    return model


def abstract_params(cfg: ModelConfig) -> EncDec:
    """The model on the ``meta`` device, built without a generator (no
    memory, no values)."""
    return EncDec(cfg, device=torch.device("meta"))


def forward(model: EncDec, batch: dict) -> torch.Tensor:
    return model(batch)


def lm_loss(model: EncDec, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy of the decoder (the last position
    excluded), a float32 scalar."""
    logits = model(batch)
    return sharded_xent(logits[:, :-1], batch["tokens"][:, 1:]).mean()


def init_cache(cfg: ModelConfig, batch: int, max_src: int, max_tgt: int,
               device="cuda") -> dict:
    dev = resolve_device(device)
    dt = compute_dtype(cfg)
    shape = (batch, max_src, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"dec": [{"self": Attention.cache(cfg, batch, max_tgt, dt, dev),
                     "cross_k": torch.zeros(shape, dtype=dt, device=dev),
                     "cross_v": torch.zeros(shape, dtype=dt, device=dev)}
                    for _ in range(cfg.n_layers)]}


def abstract_cache(cfg: ModelConfig, batch: int, max_src: int,
                   max_tgt: int) -> dict:
    """``init_cache``'s tree of tensors on the ``meta`` device."""
    return init_cache(cfg, batch, max_src, max_tgt, device="meta")


def decode_step(model: EncDec, cache: dict, tokens, pos):
    """One decoder step; returns ``(logits [B, vocab], cache)``, the cache
    updated in place."""
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = step_position(pos, position_limit(model.cfg, cache), dev)
    return model.decode(cache, tokens, pos), cache


def position_limit(cfg: ModelConfig, cache: dict) -> int | None:
    """The positions the decoder's self-attention cache holds."""
    return cache["dec"][0]["self"]["k"].shape[1] if cache["dec"] else None


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> EncDec:
    """An EncDec carrying the reference's ``init_encdec`` pytree (numpy
    leaves), its stacked encoder and decoder layers unstacked."""
    return load_reference(EncDec(cfg, device=resolve_device(device)), tree,
                          cfg)
