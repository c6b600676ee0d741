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
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import constrain, residual_entries
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
        return _with_prefix(cfg, batch, x)

    def forward(self, batch: dict, last_only: bool = False) -> torch.Tensor:
        """Full-sequence forward (training and prefill).  Logits [B, L,
        padded_vocab], or [B, 1, padded_vocab] with ``last_only`` (sliced
        before the unembedding)."""
        x, positions = self.embed_inputs(batch)
        for cycle in self.cycles:
            # the reference's anchor at each cycle: batch over dp, and
            # with seq_shard the sequence over model (Megatron-style)
            x = constrain(x, *residual_entries(self.cfg.seq_shard))
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


def _with_prefix(cfg: ModelConfig, batch: dict, x: torch.Tensor):
    """Token embeddings ``x`` behind the frontend-stub embeddings (when
    the batch has them), and the positions ([B, L], or [B, L, 3] for
    M-RoPE)."""
    x = _prefixed(batch, x)
    B, L, _ = x.shape
    return x, _positions(cfg, batch, B, L, x.device)


def _prefixed(batch: dict, x: torch.Tensor) -> torch.Tensor:
    if batch.get("embeds") is not None:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    return x


def _positions(cfg: ModelConfig, batch: dict, B: int, L: int, device):
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(L, device=device).expand(B, L)
        if cfg.mrope_sections:
            positions = positions[..., None].expand(B, L, 3)
    return positions


def residual_len(batch: dict) -> int:
    """The length of the residual stream of ``batch``: its tokens behind
    the frontend prefix (when it has one)."""
    n = batch["tokens"].shape[1]
    if batch.get("embeds") is not None:
        n += batch["embeds"].shape[1]
    return n


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
    [B, L, V] one-hot.  On a model group the vocabulary is split over
    the ranks and :func:`xent_tp` reduces the same three terms across
    them."""
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


# ------------------------------------------------------------ model group
# The forward and loss on tensor-parallel model groups
# (``distributed/tensor_parallel.py``), one group a data-parallel rank:
# each ``tp.Run`` (or ``tp.DecodeRun``) holds its group, ``models[r]``
# rank r's local replica and ``feeds[device]`` its rows' inputs on each
# member device.  The residual stream is a ``tp.Rep`` (one tensor per
# device), or each rank's slice of the sequence on a group with ``seq``;
# the groups go layer by layer in lockstep, so an MoE layer can route
# every rank's rows together.
def vocab_embed_tp(group, models: dict, feeds: dict, dtype,
                   extend=None) -> dict:
    """The token embeddings as the residual stream: a vocabulary-parallel
    lookup (ids outside a rank's rows give zeros) combined over the
    ranks (``group.combine``), or where the vocabulary does not split,
    the whole table's lookup on each device.  ``extend(t, device)`` is
    applied to the whole embeddings before the stream is cut (the
    frontend prefix)."""
    if not getattr(models[group.members[0]], "tp_split", False):
        out = {d: models[r].w("embed", dtype)[feeds[d]["tokens"]]
               for d, r in group.places().items()}
        if extend is not None:
            out = {d: extend(t, d) for d, t in out.items()}
        return group.keep(out)
    parts = {}
    for r in group.members:
        w = models[r].w("embed", dtype)
        ids = feeds[group.devices[r]]["tokens"] - r * w.shape[0]
        inside = (ids >= 0) & (ids < w.shape[0])
        parts[r] = torch.where(inside[..., None],
                               w[torch.where(inside, ids, 0)], 0)
    return group.combine(parts, extend=extend)


def embed_tp(group, models: dict, feeds: dict, cfg: ModelConfig):
    """:meth:`LM.embed_inputs` on the group: the residual stream (token
    embeddings behind the frontend prefix) and the positions on every
    device (``tp.Rep``, whole)."""
    x = vocab_embed_tp(group, models, feeds, compute_dtype(cfg),
                       lambda t, d: _prefixed(feeds[d], t))
    positions = {}
    for d, f in feeds.items():
        positions[d] = _positions(cfg, f, f["tokens"].shape[0],
                                  residual_len(f), d)
    return x, positions


def ffn_tp(runs, layers: dict, x: dict, n_ranks: int) -> dict:
    """The FFN half of :meth:`Layer.forward` / :meth:`Layer.decode` on the
    model group of every run (``layers[rank][r]`` is the layer of model
    rank r of data-parallel ``rank``, ``x[rank]`` its stream after the
    mixer): each group's norm and FFN on its own rows, but an MoE layer
    whose rows are split over ``n_ranks`` > 1 data-parallel ranks routes
    every rank's rows together (``tp.gather_rows``), as the single-device
    step routes its whole (micro)batch, and each group keeps its own
    rows' outputs.  With ``moe_dispatch_shard``, where the ranks divide
    the capacity, each group runs the expert GEMMs of its share of the
    slots only (``ffn.moe_dp``)."""
    run0 = runs[0]
    l0 = layers[run0.rank][run0.group.members[0]]
    if l0.ffn is None:
        return x
    eps, dt = l0.cfg.norm_eps, compute_dtype(l0.cfg)
    h = {run.rank: tp.norm_each(run.group, layers[run.rank], "ffn_norm",
                                x[run.rank], eps) for run in runs}
    moe = isinstance(l0.ffn, ffn_lib.MoEFFN)
    ffns = {run.rank: {r: layer.ffn for r, layer in layers[run.rank].items()}
            for run in runs}
    full = routed = None
    if moe and n_ranks > 1:
        full = tp.gather_rows(
            {run.rank: run.group for run in runs},
            {run.rank: h[run.rank][run.group.members[0]] for run in runs},
            n_ranks)
        B, L = next(iter(full[run0.rank].values())).shape[:2]
        if ffn_lib.slots_split(l0.cfg, B * L, n_ranks):
            routed = ffn_lib.moe_dp(runs, ffns, full, n_ranks)
    out = {}
    for run in runs:
        g, hb = run.group, h[run.rank]
        if full is None:
            y = tp.branch(g, ffns[run.rank], lambda m, r: m(hb[r]), dt,
                          (lambda gg, mods: ffn_lib.moe_tp(gg, mods, hb))
                          if moe else None)
        else:
            # the whole batch routed on every group, its own rows kept
            fb = full[run.rank]
            own = {} if routed is None else routed[run.rank]
            y = tp.branch(g, ffns[run.rank], lambda m, r: ffn_lib.moe_ffn(
                m, g.at(fb, r), own.get(r))[run.rows], dt, lambda gg, mods:
                ffn_lib.moe_tp(gg, mods, hb, fb, run.rows,
                               None if routed is None else own))
        out[run.rank] = tp.residual(x[run.rank], y)
    return out


def layer_runs_tp(runs, layers: dict, x: dict, positions: dict,
                  n_ranks: int) -> dict:
    """:meth:`Layer.forward` on the model group of every run (``tp.Run``;
    ``layers[rank][r]``, ``x[rank]`` and ``positions[rank]`` as in
    :func:`ffn_tp`): each group's mixer on its own rows, then
    :func:`ffn_tp`."""
    out = {}
    for run in runs:
        g, ls = run.group, layers[run.rank]
        l0 = ls[g.members[0]]
        eps, dt = l0.cfg.norm_eps, compute_dtype(l0.cfg)
        h = tp.norm_each(g, ls, "mixer_norm", x[run.rank], eps)
        pos = positions[run.rank]
        ssd = isinstance(l0.mixer, mix.SSD)
        out[run.rank] = tp.residual(x[run.rank], tp.branch(
            g, {r: ls[r].mixer for r in g.members},
            lambda m, r: m(h[r], g.at(pos, r)), dt,
            (lambda gg, mods: gg.combine(mix.ssd_partials(gg, mods, h), dt))
            if ssd else None))
    return ffn_tp(runs, layers, out, n_ranks)


def run_cycle_tp(runs, cycles: dict, x: dict, positions: dict,
                 n_ranks: int) -> dict:
    """:func:`run_cycle` on every run's group (``cycles[rank][r]``)."""
    run0 = runs[0]
    for j in range(len(cycles[run0.rank][run0.group.members[0]])):
        x = layer_runs_tp(runs, {b: {r: c[f"layer{j}"] for r, c in by.items()}
                                 for b, by in cycles.items()},
                          x, positions, n_ranks)
    return x


def logits_tp(group, models: dict, x: dict, last_only: bool) -> dict:
    """The final norm and the unembedding: each rank's logits over its
    vocabulary rows (``{rank: [B, L, V / T]}``), or where the vocabulary
    does not split, the whole logits on each device (by its first
    member).  With the sequence split the norm runs on each rank's slice
    and the slices are gathered before the head."""
    m0 = models[group.members[0]]
    ranks = (group.members if getattr(m0, "tp_split", False)
             else tuple(group.places().values()))
    if group.seq:
        h = tp.norm_each(group, models, "final_norm", x, m0.cfg.norm_eps)
    out = {}
    for r in ranks:
        m = models[r]
        y = (h[r] if group.seq
             else rms_norm(group.at(x, r), m.final_norm, m.cfg.norm_eps))
        if last_only:
            y = y[:, -1:]
        head = (m.head(y.dtype) if isinstance(m, LM)
                else m.w("lm_head", y.dtype))
        out[r] = y @ head
    return out


def forward_tp(runs, n_ranks: int = 1, last_only: bool = False) -> dict:
    """:meth:`LM.forward` of each run's rows (``tp.Run``, the rows split
    over ``n_ranks`` data-parallel ranks): ``{rank: logits_tp's
    blocks}``."""
    run0 = runs[0]
    m0 = run0.models[run0.group.members[0]]
    cfg = m0.cfg
    x, positions = {}, {}
    for run in runs:
        x[run.rank], positions[run.rank] = embed_tp(run.group, run.models,
                                                    run.feeds, cfg)
    for c in range(len(m0.cycles)):
        x = remat_call(cfg, run_cycle_tp, runs,
                       {run.rank: {r: run.models[r].cycles[c]
                                   for r in run.group.members}
                        for run in runs}, x, positions, n_ranks)
    for i in range(len(m0.tail)):
        x = layer_runs_tp(runs, {run.rank: {r: run.models[r].tail[i]
                                            for r in run.group.members}
                                 for run in runs}, x, positions, n_ranks)
    return {run.rank: logits_tp(run.group, run.models, x[run.rank],
                                last_only) for run in runs}


def layer_decode_tp(runs, layers: dict, x: dict, caches: dict,
                    n_ranks: int) -> dict:
    """:meth:`Layer.decode` on the model group of every run of a decode
    step (``tp.DecodeRun``; ``layers[rank][r]`` is the layer of model rank
    r of data-parallel ``rank``, ``caches[rank][r]`` its cache blocks,
    ``x[rank]`` the residual stream): each group's mixer
    (``mixers.decode_tp``), then :func:`ffn_tp`."""
    out = {}
    for run in runs:
        g, ls = run.group, layers[run.rank]
        l0 = ls[g.members[0]]
        eps, dt = l0.cfg.norm_eps, compute_dtype(l0.cfg)
        h = tp.norm_each(g, ls, "mixer_norm", x[run.rank], eps)
        out[run.rank] = tp.residual(x[run.rank], mix.decode_tp(
            g, {r: layer.mixer for r, layer in ls.items()}, h,
            caches[run.rank], run.pos, dt))
    return ffn_tp(runs, layers, out, n_ranks)


def decode_tp(runs, n_ranks: int) -> dict:
    """:meth:`LM.decode` on the model group of every run of a decode step
    (``tp.DecodeRun``): ``{rank: logits_tp's blocks [B, 1, V / T]}``, the
    cache blocks written in place."""
    run0 = runs[0]
    cfg = run0.models[run0.group.members[0]].cfg
    dt = compute_dtype(cfg)
    x = {run.rank: vocab_embed_tp(run.group, run.models, run.feeds, dt)
         for run in runs}
    layers = {run.rank: {r: run.models[r].layers()
                         for r in run.group.members} for run in runs}
    caches = {run.rank: {r: layer_caches(cfg, run.caches[r])
                         for r in run.group.members} for run in runs}
    for i in range(cfg.n_layers):
        x = layer_decode_tp(
            runs, {b: {r: ls[i] for r, ls in by.items()}
                   for b, by in layers.items()}, x,
            {b: {r: cs[i] for r, cs in by.items()}
             for b, by in caches.items()}, n_ranks)
    return {run.rank: logits_tp(run.group, run.models, x[run.rank], False)
            for run in runs}


def xent_tp(group, models: dict, logits: dict, targets: dict) -> dict:
    """:func:`sharded_xent` of :func:`logits_tp`'s blocks, on every
    device: the max over the ranks (no gradient), the sum of exps over the
    ranks, and the target logit from the rank whose rows hold it, each
    all-reduced over [B, L]."""
    if not getattr(models[group.members[0]], "tp_split", False):
        return {group.devices[r]: sharded_xent(t, targets[group.devices[r]])
                for r, t in logits.items()}
    lf = {r: t.float() for r, t in logits.items()}
    m = group.all_max({r: t.amax(dim=-1, keepdim=True).detach()
                       for r, t in lf.items()})
    s = group.all_reduce({r: torch.exp(t - group.at(m, r)).sum(dim=-1)
                          for r, t in lf.items()})
    picked = {}
    for r, t in lf.items():
        ids = group.at(targets, r).long() - r * t.shape[-1]
        inside = (ids >= 0) & (ids < t.shape[-1])
        got = torch.gather(t, -1, torch.where(inside, ids, 0)[..., None])
        picked[r] = torch.where(inside, got.squeeze(-1), 0.0)
    tgt = group.all_reduce(picked)
    return {d: m[d].squeeze(-1) + torch.log(s[d]) - tgt[d] for d in s}


def lm_loss_tp(runs, n_ranks: int = 1) -> torch.Tensor:
    """:func:`lm_loss` of a (micro)batch whose rows the runs split over
    ``n_ranks`` data-parallel ranks (``tp.rows_mean``), on the first
    run's home device."""
    logits = forward_tp(runs, n_ranks)
    xent = {}
    for run in runs:
        g = run.group
        home = run.feeds[g.home]
        n_prefix = (0 if home.get("embeds") is None
                    else home["embeds"].shape[1])
        blocks = {r: t[:, n_prefix:-1] for r, t in logits[run.rank].items()}
        targets = {d: f["tokens"][:, 1:] for d, f in run.feeds.items()}
        xent[run.rank] = xent_tp(g, run.models, blocks, targets)[g.home]
    return tp.rows_mean(runs, xent, n_ranks)


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
