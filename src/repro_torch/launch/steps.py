"""Step functions: the counterparts of the reference's
``make_train_step`` / ``init_state`` / ``make_prefill_step`` /
``make_serve_step`` (``repro/launch/steps.py``) and of its
``jax.jit(bundle.decode_step, donate_argnums=1)``: :class:`CapturedDecode`,
the decode step as one CUDA graph per cache.

A training state is ``{"params": model, "opt": adamw state}`` (plus
``"ef"`` with compressed gradients); the train step updates it in place,
the counterpart of the reference's donated state.  ``abstract_state``
comes with the dry-run slice.
"""
from __future__ import annotations

import torch

from repro_torch.device import capture_graph
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.layers import trainable
from repro_torch.models.registry import ModelBundle
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def split_batch(batch: dict, mb: int) -> list[dict]:
    """``mb`` microbatches of consecutive rows, the reference's
    ``x.reshape(mb, B // mb, ...)``."""
    rows = next(iter(batch.values())).shape[0]
    if rows % mb:
        raise ValueError(f"batch of {rows} rows in {mb} microbatches")
    return [{k: v.reshape(mb, rows // mb, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(mb)]


def loss_and_grads(bundle: ModelBundle, model, batch: dict,
                   mb: int = 1) -> torch.Tensor:
    """The loss of ``batch`` (a float32 0-d tensor, detached) with its
    gradients left in each parameter's ``.grad``.  With ``mb`` > 1 the
    batch is cut into microbatches run one after another: their losses
    and gradients add from zero in slice order (``.grad`` accumulates
    across the backward calls), then both are divided by ``mb``."""
    model.zero_grad(set_to_none=True)
    if mb == 1:
        loss = bundle.loss(model, batch)
        loss.backward()
        return loss.detach()
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(batch.values())).device)
    for micro in split_batch(batch, mb):
        loss = bundle.loss(model, micro)
        loss.backward()
        total = total + loss.detach()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(mb)
    return total / mb


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig):
    """``train_step(state, batch) -> (state, metrics)``: the loss and
    gradients (microbatched by ``cfg.microbatches``), then AdamW, all in
    place.  ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d
    device tensors (nothing is read back to the host)."""
    mb = max(1, bundle.cfg.microbatches)

    def train_step(state: dict, batch: dict):
        model = state["params"]
        loss = loss_and_grads(bundle, model, batch, mb)
        params = dict(model.named_parameters())
        metrics = adamw_update({n: p.grad for n, p in params.items()},
                               state["opt"], params, opt_cfg)
        return state, dict(metrics, loss=loss)
    return train_step


def train_state(bundle: ModelBundle, model) -> dict:
    """``{"params", "opt"}`` around ``model``, turned trainable (grads on,
    compute copies dropped), with zero moments in ``cfg.opt_dtype``."""
    trainable(model)
    return {"params": model,
            "opt": adamw_init(dict(model.named_parameters()),
                              getattr(torch, bundle.cfg.opt_dtype))}


def init_state(bundle: ModelBundle, seed: int = 0, device="cuda") -> dict:
    """A fresh training state: the model from ``seed`` (a
    ``torch.Generator`` on ``device``) and its optimizer state."""
    return train_state(bundle, bundle.init(seed, device))


def make_prefill_step(bundle: ModelBundle):
    """(model, batch) -> last-position logits [B, padded_vocab]."""
    def prefill_step(params, batch):
        if bundle.cfg.n_enc_layers:
            return bundle.forward(params, batch)[:, -1, :]
        return lm_lib.forward(params, batch, last_only=True)[:, 0]
    return prefill_step


def make_serve_step(bundle: ModelBundle):
    """(model, cache, {"tokens", "pos"}) -> (logits, cache)."""
    def serve_step(params, cache, batch):
        return bundle.decode_step(params, cache, batch["tokens"],
                                  batch["pos"])
    return serve_step


def cache_leaves(cache) -> list[torch.Tensor]:
    """The tensors of a cache pytree, in a fixed order."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    items = cache.values() if isinstance(cache, dict) else cache
    return [t for item in items for t in cache_leaves(item)]


class _Captured:
    """One cache's step: its static token and position inputs, the step
    body, and (on a card) the graph that replays it."""

    def __init__(self, step, params, cache, shape, device):
        self.tokens = torch.zeros(shape, dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.body = lambda: step(params, cache, self.tokens, self.pos)[0]
        self.graph = None
        if device.type == "cuda":
            # the capture sequence runs the step once uncaptured, which
            # writes the cache: put its content back afterwards
            leaves = cache_leaves(cache)
            saved = [t.clone() for t in leaves]
            self.graph, self.out = capture_graph(self.body, device)
            for t, s in zip(leaves, saved):
                t.copy_(s)

    def run(self) -> torch.Tensor:
        if self.graph is None:
            return self.body()
        self.graph.replay()
        return self.out


class CapturedDecode:
    """``bundle.decode_step`` captured as one ``torch.cuda.CUDAGraph`` per
    cache (so one per (batch, max_len) in a serve loop).  Call it as the
    step: ``decode(params, cache, tokens, pos) -> (logits, cache)``.

    The graph reads and writes the cache it was captured with, in place,
    and ``pos`` reaches it through a device scalar; a new cache (or model,
    or batch) is captured anew.  A capture that fails raises.  On the CPU
    the same body (static inputs, then the step) runs uncaptured.  The
    logits returned are a copy, valid after later calls."""

    def __init__(self, bundle: ModelBundle):
        self.bundle = bundle
        self._limit = (encdec_lib.position_limit if bundle.cfg.n_enc_layers
                       else lm_lib.position_limit)
        self._steps: dict[tuple, _Captured] = {}

    @property
    def captures(self) -> int:
        return sum(s.graph is not None for s in self._steps.values())

    def __call__(self, params, cache, tokens, pos):
        leaves = cache_leaves(cache)
        dev = leaves[0].device
        tokens = torch.as_tensor(tokens, device=dev)
        key = (id(params), tuple(tokens.shape),
               tuple((t.data_ptr(), tuple(t.shape)) for t in leaves))
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = _Captured(
                self.bundle.decode_step, params, cache, tuple(tokens.shape),
                dev)
        step.tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            step.pos.copy_(pos)
        else:
            step.pos.fill_(lm_lib.check_position(
                pos, self._limit(self.bundle.cfg, cache)))
        return step.run().clone(), cache
