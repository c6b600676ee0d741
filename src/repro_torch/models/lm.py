"""Generic decoder-only LM covering the dense / MoE / MLA / hybrid / SSM /
VLM architectures: the reference's ``repro/models/lm.py``.

Layers are grouped into *cycles* (one pass over ``cfg.mixer_pattern``,
e.g. RecurrentGemma's (rglru, rglru, attn)).  The reference stacks the
cycles' parameters on a leading axis and scans them; here ``LM.cycles``
is a ``ModuleList`` of per-cycle ``ModuleDict``s (keys ``layer{j}``), run
in order, and the remnant layers (``n_layers % cycle``) are ``LM.tail``.

Modality frontends are stubs as in the reference: ``batch["embeds"]``
(precomputed frame / patch embeddings) is put ahead of the token
embeddings, with M-RoPE positions from ``batch["positions"]``.

Parameters are float32; activations run in ``cfg.dtype``, for serving
with bfloat16 copies of the weights made once (:func:`make_compute_copies`;
a model turned :func:`~repro_torch.models.layers.trainable` casts at every
use instead).  ``cfg.remat == "full"`` recomputes each cycle in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
around its scanned cycle); the tail layers are not checkpointed, as in
the reference.  Logits of ``forward`` keep the padded vocabulary, and
``lm_loss`` takes its cross-entropy over all of it, as the reference
does; ``decode_step`` slices them to ``cfg.vocab``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import mixers as mix
from repro_torch.models.layers import (Weights, glorot,
                                       make_compute_copies, rms_norm)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


# ------------------------------------------------------------------ layers
class Layer(Weights):
    """Pre-norm residual block: mixer, then the FFN (if any)."""

    def __init__(self, mixer_type: str, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mixer_type = mixer_type
        self.mixer = mix.MIXERS[mixer_type](cfg, device=device)
        self.param("mixer_norm", cfg.d_model, device=device)
        self.ffn = ffn_lib.make_ffn(cfg, device=device)
        if self.ffn is not None:
            self.param("ffn_norm", cfg.d_model, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.mixer.reset_parameters(gen)
        self.mixer_norm.fill_(1.0)
        if self.ffn is not None:
            self.ffn.reset_parameters(gen)
            self.ffn_norm.fill_(1.0)

    def _ffn(self, x):
        if self.ffn is not None:
            x = x + self.ffn(rms_norm(x, self.ffn_norm, self.cfg.norm_eps))
        return x

    def forward(self, x, positions):
        h = rms_norm(x, self.mixer_norm, self.cfg.norm_eps)
        return self._ffn(x + self.mixer(h, positions))

    def decode(self, x, cache, pos):
        h = rms_norm(x, self.mixer_norm, self.cfg.norm_eps)
        return self._ffn(x + self.mixer.decode(h, cache, pos))


class LM(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        n_cycles, n_tail = divmod(cfg.n_layers, cfg.cycle_len())
        self.param("embed", cfg.padded_vocab, cfg.d_model, device=device)
        self.param("final_norm", cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.param("lm_head", cfg.d_model, cfg.padded_vocab,
                       device=device)
        self.cycles = nn.ModuleList(
            nn.ModuleDict({f"layer{j}": Layer(mt, cfg, device=device)
                           for j, mt in enumerate(cfg.mixer_pattern)})
            for _ in range(n_cycles))
        self.tail = nn.ModuleList(Layer(cfg.mixer_pattern[i], cfg,
                                        device=device)
                                  for i in range(n_tail))

    def layers(self) -> list[Layer]:
        """Every layer in execution order."""
        return ([c[f"layer{j}"] for c in self.cycles
                 for j in range(len(self.cfg.mixer_pattern))]
                + list(self.tail))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's distributions (values differ from jax.random):
        embedding normal x 0.02, glorot-normal projections, ones for the
        norms, the fixed RG-LRU / SSD tables."""
        self.embed.copy_(torch.randn(self.embed.shape, generator=gen,
                                     device=self.embed.device) * 0.02)
        self.final_norm.fill_(1.0)
        if not self.cfg.tie_embeddings:
            self.lm_head.copy_(glorot(self.lm_head.shape, gen,
                                      self.lm_head.device))
        for layer in self.layers():
            layer.reset_parameters(gen)

    def head(self, dtype) -> torch.Tensor:
        return (self.w("embed", dtype).T if self.cfg.tie_embeddings
                else self.w("lm_head", dtype))

    def embed_inputs(self, batch: dict):
        """Token embeddings, optionally prefixed by frontend-stub
        embeddings, and the positions ([B, L], or [B, L, 3] for M-RoPE)."""
        cfg = self.cfg
        dt = compute_dtype(cfg)
        x = self.w("embed", dt)[batch["tokens"]]
        if batch.get("embeds") is not None:
            x = torch.cat([batch["embeds"].to(dt), x], dim=1)
        B, L, _ = x.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(L, device=x.device).expand(B, L)
            if cfg.mrope_sections:
                positions = positions[..., None].expand(B, L, 3)
        return x, positions

    def forward(self, batch: dict, last_only: bool = False) -> torch.Tensor:
        """Full-sequence forward (training and prefill).  Logits [B, L,
        padded_vocab], or [B, 1, padded_vocab] with ``last_only`` (sliced
        before the unembedding)."""
        x, positions = self.embed_inputs(batch)
        for cycle in self.cycles:
            # the reference's anchors at each cycle: batch over dp, and
            # with seq_shard the sequence over model (Megatron-style)
            x = constrain(x, "dp", "model" if self.cfg.seq_shard else None,
                          None)
            x = remat_call(self.cfg, run_cycle, cycle, x, positions)
        for layer in self.tail:
            x = layer(x, positions)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        return constrain(x @ self.head(x.dtype), "dp", None, "model")

    def decode(self, cache: dict, tokens: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        """One serving step; ``cache`` is written in place.  Returns
        logits [B, vocab]."""
        cfg = self.cfg
        x = self.w("embed", compute_dtype(cfg))[tokens]        # [B, 1, D]
        for layer, c in zip(self.layers(), layer_caches(cfg, cache)):
            x = layer.decode(x, c, pos)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = constrain(x @ self.head(x.dtype), "dp", None, "model")
        return logits[:, 0, :cfg.vocab]


def run_cycle(cycle: nn.ModuleDict, x, positions):
    """One pass over the mixer pattern."""
    for j in range(len(cycle)):
        x = cycle[f"layer{j}"](x, positions)
    return x


def remat_call(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``cfg.remat`` is
    "full" and autograd is recording."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ------------------------------------------------------------------ loss
def sharded_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy in float32: the reference's logsumexp
    with a max that carries no gradient, over every column of ``logits``.
    The reference picks the target logit with a one-hot contraction (which
    keeps a vocab axis sharded); here it is a ``gather``, the same number
    for finite logits (the one-hot sum adds exact zeros) without a
    [B, L, V] one-hot.  The port has no vocab sharding; the name is the
    reference's."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m.squeeze(-1) + torch.log(torch.exp(logits - m).sum(dim=-1))
    tgt = torch.gather(logits, -1, targets.long()[..., None]).squeeze(-1)
    return lse - tgt


def lm_loss(model: LM, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy on token positions (frontend prefix and
    the final position excluded), a float32 scalar."""
    logits = model(batch)
    n_prefix = 0 if batch.get("embeds") is None else batch["embeds"].shape[1]
    targets = batch["tokens"][:, 1:]
    return sharded_xent(logits[:, n_prefix:-1], targets).mean()


# ------------------------------------------------------------------ API
def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """A randomly initialised LM from ``seed`` (a ``torch.Generator`` on
    the device), with its compute copies."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    model.reset_parameters(generator(seed, dev))
    make_compute_copies(model, compute_dtype(cfg))
    return model


def abstract_params(cfg: ModelConfig) -> LM:
    """The LM on the ``meta`` device, built without a generator: every
    parameter's shape and dtype, no memory and no values (the dry-run's
    counterpart of ``init_lm``)."""
    return LM(cfg, device=torch.device("meta"))


def forward(model: LM, batch: dict, last_only: bool = False) -> torch.Tensor:
    return model(batch, last_only=last_only)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """The decode cache: ``{"cycles": [{layer{j}: {...}}, ...] (when there
    are cycles), "tail": [{...}, ...]}``, zeros in ``cfg.dtype`` (float32
    for the recurrent states)."""
    dev = resolve_device(device)
    dt = compute_dtype(cfg)
    n_cycles, n_tail = divmod(cfg.n_layers, cfg.cycle_len())

    def one(mt):
        return mix.MIXERS[mt].cache(cfg, batch, max_len, dt, dev)

    cache: dict[str, Any] = {}
    if n_cycles:
        cache["cycles"] = [{f"layer{j}": one(mt)
                            for j, mt in enumerate(cfg.mixer_pattern)}
                           for _ in range(n_cycles)]
    cache["tail"] = [one(cfg.mixer_pattern[i]) for i in range(n_tail)]
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``init_cache``'s tree of tensors on the ``meta`` device."""
    return init_cache(cfg, batch, max_len, device="meta")


def step_position(pos, max_len: int | None, device) -> torch.Tensor:
    """``pos`` as a 0-d int64 tensor on ``device``.  A Python int is
    checked against ``max_len`` (the reference's dynamic_update_slice
    would clamp it; the serve loop never goes past the cache)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long).reshape(())
    return torch.full((), check_position(pos, max_len), dtype=torch.long,
                      device=device)


def check_position(pos: int, max_len: int | None) -> int:
    pos = int(pos)
    if pos < 0 or (max_len is not None and pos >= max_len):
        raise ValueError(f"decode position {pos} outside the cache "
                         f"(max_len {max_len})")
    return pos


def layer_caches(cfg: ModelConfig, cache: dict) -> list[dict]:
    """Every layer's cache in execution order."""
    return ([c[f"layer{j}"] for c in cache.get("cycles", [])
             for j in range(cfg.cycle_len())] + list(cache["tail"]))


def position_limit(cfg: ModelConfig, cache: dict) -> int | None:
    """The positions ``cache`` holds: the length of its first global
    attention or MLA cache (None when every layer keeps a recurrent state
    or a local-window ring buffer)."""
    for c in layer_caches(cfg, cache):
        if "kv_c" in c:
            return c["kv_c"].shape[1]
        if "k" in c and not cfg.window:
            return c["k"].shape[1]
    return None


def decode_step(model: LM, cache: dict, tokens, pos):
    """One serving step: ``tokens`` [B, 1] new ids, ``pos`` the number of
    tokens already in the cache (an int, or a 0-d tensor on the device).
    Returns ``(logits [B, vocab], cache)``, the cache updated in place."""
    dev = model.embed.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = step_position(pos, position_limit(model.cfg, cache), dev)
    return model.decode(cache, tokens, pos), cache


# ------------------------------------------------------------------ weights
def load_tree(module: nn.Module, tree, prefix: str = "") -> set[str]:
    """Copy a reference parameter pytree (numpy leaves) into ``module``:
    dict keys name submodules and parameters, a stacked dict (leading
    layer axis) fills a ``ModuleList`` layer by layer, a list fills it
    item by item.  Returns the dotted names of the parameters written."""
    done: set[str] = set()
    for key, val in tree.items():
        target = (module[key] if isinstance(module, nn.ModuleDict)
                  else getattr(module, key))
        name = f"{prefix}{key}"
        if isinstance(target, nn.ModuleList):
            items = (val if isinstance(val, (list, tuple))
                     else [_index_tree(val, i) for i in range(len(target))])
            if len(items) != len(target):
                raise ValueError(f"{name}: {len(items)} entries for "
                                 f"{len(target)} layers")
            for i, (m, v) in enumerate(zip(target, items)):
                done |= load_tree(m, v, f"{name}.{i}.")
        elif isinstance(target, nn.Module):
            done |= load_tree(target, val, f"{name}.")
        else:
            arr = np.array(val)
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{name}: shape {arr.shape}, expected "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.as_tensor(arr, dtype=target.dtype))
            done.add(name)
    return done


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_reference(model: nn.Module, tree, cfg: ModelConfig) -> nn.Module:
    """Fill ``model`` from the reference's pytree; every parameter must be
    written exactly once.  Makes the compute copies."""
    done = load_tree(model, tree)
    want = {n for n, _ in model.named_parameters()}
    if done != want:
        raise ValueError(f"parameters not in the tree: {sorted(want - done)}"
                         f"; keys of no parameter: {sorted(done - want)}")
    make_compute_copies(model, compute_dtype(cfg))
    return model


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> LM:
    """An LM carrying the reference's parameters (``init_lm``'s pytree with
    numpy leaves): the stacked cycles are unstacked into per-layer
    modules."""
    return load_reference(LM(cfg, device=resolve_device(device)), tree, cfg)
