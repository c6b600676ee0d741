"""Step functions: the counterparts of the reference's
``make_train_step`` / ``init_state`` / ``make_prefill_step`` /
``make_serve_step`` (``repro/launch/steps.py``) and of its
``jax.jit(bundle.decode_step, donate_argnums=1)``: :class:`CapturedDecode`,
the decode step as one CUDA graph per cache.

A training state is ``{"params": model, "opt": adamw state}`` (plus
``"ef"`` with compressed gradients); the train step updates it in place,
the counterpart of the reference's donated state.  ``abstract_state`` is
that state on the ``meta`` device, for the dry-run.

On a mesh (``init_state`` / ``make_train_step`` with ``mesh=``) the state
is stored by the sharding rules: ``{"params": {name: Sharded}, "opt":
{"mu": {name: Sharded}, "nu": ..., "step"}}``, parameters and both moments
placed by ``param_spec`` (the reference's ZeRO-3 on top of TP), under the
names a single-device checkpoint uses.  A step (:class:`MeshCompute`)
binds one trainable replica per device of the mesh to the weights (a leaf
that is one whole block on that device is used in place, any other is
gathered into a buffer of the replica's), runs the reference's logical
step there (microbatches of consecutive
rows, each microbatch whole on the device of the first data-parallel rank
that holds its rows, so MoE capacity and slot order stay per microbatch;
a batch whose rows the data axes do not divide is replicated and each
microbatch still runs once), reduces the replicas' gradients in rank
order and updates each shard in place (``sharded_adamw_update``: one
global norm over the shards).  Tensor-parallel splitting of the products
is not done: every replica computes whole products.
"""
from __future__ import annotations

import torch

from repro_torch.device import capture_graph
from repro_torch.distributed import sharding
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.layers import trainable
from repro_torch.models.registry import ModelBundle
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     sharded_adamw_update)


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


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig, mesh=None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and
    gradients (microbatched by ``cfg.microbatches``), then AdamW, all in
    place.  ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as 0-d
    device tensors (nothing is read back to the host).  With ``mesh`` the
    step takes a state of ``init_state(..., mesh=mesh)``."""
    mb = max(1, bundle.cfg.microbatches)
    if mesh is not None:
        compute = MeshCompute(bundle, mesh)

        def sharded_step(state: dict, batch: dict):
            loss, grads = compute.loss_and_grads(state["params"], batch, mb)
            metrics = sharded_adamw_update(grads, state["opt"],
                                           state["params"], opt_cfg)
            return state, dict(metrics, loss=loss)
        return sharded_step

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


def init_state(bundle: ModelBundle, seed: int = 0, device="cuda",
               mesh=None) -> dict:
    """A fresh training state: the model from ``seed`` (a
    ``torch.Generator`` on ``device``) and its optimizer state; with
    ``mesh``, both placed on it by the sharding rules (the same
    parameter values)."""
    model = bundle.init(seed, device)
    if mesh is None:
        return train_state(bundle, model)
    return sharded_state(bundle, model, mesh)


def abstract_state(bundle: ModelBundle, mesh=None) -> dict:
    """``init_state``'s state on the ``meta`` device, with no memory and no
    values: ``bundle.abstract_params()`` turned trainable and its zero
    moments in ``cfg.opt_dtype`` (``adamw_init``'s).  With ``mesh`` (a
    mesh of meta coordinates), the ``Sharded`` storage ``sharded_state``
    places by ``param_spec``: the blocks each coordinate holds."""
    model = bundle.abstract_params()
    if mesh is None:
        return train_state(bundle, model)
    return sharded_state(bundle, model, mesh)


def sharded_state(bundle: ModelBundle, model, mesh) -> dict:
    """The training state of ``model``'s parameters placed on ``mesh`` by
    ``params_shardings``, with zero moments placed alike in
    ``cfg.opt_dtype`` and the step on the mesh's first device."""
    specs = sharding.params_shardings(model, mesh)
    params = {n: sharding.shard(p, specs[n], mesh)
              for n, p in model.named_parameters()}
    mdt = getattr(torch, bundle.cfg.opt_dtype)
    return {"params": params,
            "opt": {"mu": {n: sharding.zeros_like(l, mdt)
                           for n, l in params.items()},
                    "nu": {n: sharding.zeros_like(l, mdt)
                           for n, l in params.items()},
                    "step": torch.zeros((), dtype=torch.int32,
                                        device=mesh.devices.flat[0])}}


def state_shardings(params, mesh) -> dict:
    """The spec tree of a sharded training state on ``mesh`` (parameters
    and both moments by the rules, the step unsharded): what a resharding
    ``CheckpointManager.restore`` takes.  ``params``: a model or a dict of
    its parameters."""
    specs = sharding.params_shardings(params, mesh)
    return {"params": specs, "opt": {"mu": specs, "nu": specs, "step": None}}


class MeshCompute:
    """The compute side of a sharded train step: one trainable replica of
    the model per device of ``mesh``, built without memory and bound to
    the weights each step (:meth:`bind`), the microbatches run on the
    replicas and the gradients reduced."""

    def __init__(self, bundle: ModelBundle, mesh):
        self.bundle, self.mesh = bundle, mesh
        self.replicas: dict[torch.device, torch.nn.Module] = {}
        self.gathered: dict[tuple, torch.Tensor] = {}
        dp = sharding.dp_axes(mesh)
        self.n_dp = sharding._size(mesh, dp)
        # each data-parallel rank's coordinate and device: its (pod, data)
        # coordinates, every other axis at 0
        self.rank_coord = []
        for r in range(self.n_dp):
            at, rest = dict.fromkeys(mesh.axis_names, 0), r
            for a in reversed(dp):
                at[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
            self.rank_coord.append(tuple(at.values()))
        self.rank_device = [mesh.device(c) for c in self.rank_coord]

    def replica(self, device) -> torch.nn.Module:
        """The replica on ``device``: its parameters on the meta device
        until :meth:`bind` points them at the weights."""
        if device not in self.replicas:
            self.replicas[device] = trainable(self.bundle.abstract_params())
        return self.replicas[device]

    @torch.no_grad()
    def bind(self, device, params: dict) -> torch.nn.Module:
        """The replica on ``device`` with each parameter pointed at the
        weights of ``params`` (name -> ``Sharded``): a leaf that is one
        whole block held on ``device`` is that tensor itself (no copy; the
        step's in-place update reaches it), any other leaf is gathered
        into a buffer the replica keeps.  On the ``(1, 1)`` mesh no weight
        is copied and the replica holds no memory of its own."""
        model = self.replica(device)
        for n, p in list(model.named_parameters()):
            leaf = params[n]
            t = (leaf.tensors.get(((0,) * len(leaf.shape), device))
                 if leaf.block_shape == leaf.shape else None)
            if t is None:
                t = self.gathered.get((device, n))
                if t is None:
                    t = self.gathered[(device, n)] = torch.empty(
                        leaf.shape, dtype=leaf.dtype, device=device)
                sharding.gather_into(leaf, t)
            if p.is_meta or p.data_ptr() != t.data_ptr():
                mod, _, name = n.rpartition(".")
                model.get_submodule(mod)._parameters[name] = \
                    torch.nn.Parameter(t, requires_grad=p.requires_grad)
        return model

    def owner_ranks(self, batch: dict, mb: int) -> list[int]:
        """The data-parallel rank each microbatch runs on: the first rank
        holding its first row (``batch_spec``: rows over the dp axes when
        they divide; else every rank holds every row, and rank 0 runs
        it)."""
        name, leaf = next(iter(batch.items()))
        rows = leaf.shape[0]
        spec = sharding.batch_spec(name, tuple(leaf.shape), self.mesh)
        per_rank = rows // self.n_dp if spec[0] is not None else rows
        return [(i * (rows // mb)) // per_rank for i in range(mb)]

    def owners(self, batch: dict, mb: int) -> list[torch.device]:
        """The device each microbatch runs on (:meth:`owner_ranks`)."""
        return [self.rank_device[r] for r in self.owner_ranks(batch, mb)]

    def loss_and_grads(self, params: dict, batch: dict, mb: int = 1):
        """The loss of ``batch`` (``loss_and_grads``'s order) and the whole
        gradient of each parameter, on the device of rank 0's replica (None
        where no microbatch reached the parameter)."""
        micros = split_batch(batch, mb)
        owners = self.owners(batch, mb)
        models = {d: self.bind(d, params) for d in dict.fromkeys(owners)}
        replicas = list(models.values())
        for model in replicas:
            model.zero_grad(set_to_none=True)
        home = owners[0]
        with self.mesh:
            if mb == 1:
                loss = self.bundle.loss(
                    models[home], {k: v.to(home) for k, v in batch.items()})
                loss.backward()
                loss = loss.detach()
            else:
                total = torch.zeros((), dtype=torch.float32, device=home)
                for micro, dev in zip(micros, owners):
                    loss = self.bundle.loss(
                        models[dev], {k: v.to(dev) for k, v in micro.items()})
                    loss.backward()
                    total = total + loss.detach().to(home)
                loss = total / mb
        return loss, _reduce_grads(replicas, home, mb)


@torch.no_grad()
def _reduce_grads(replicas, home, mb: int) -> dict:
    """Each parameter's gradient summed over the replicas in rank order
    on ``home``, divided by ``mb`` (in place on one replica, as
    ``loss_and_grads`` does)."""
    grads = {}
    named = [dict(m.named_parameters()) for m in replicas]
    for n in named[0]:
        parts = [m[n].grad.to(home) for m in named if m[n].grad is not None]
        if not parts:
            grads[n] = None
            continue
        g = parts[0]
        for other in parts[1:]:
            g = g + other
        if mb > 1:
            g.div_(mb)
        grads[n] = g
    return grads


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
