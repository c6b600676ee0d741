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
runs the reference's logical step: microbatches of consecutive rows,
placed as the reference's anchor of the residual stream places them
(``sharding.residual_entries`` resolved on a microbatch's [rows, L, D]).
Where it keeps the dp axes, every data-parallel rank runs its share of
each microbatch's rows on its own devices, the ranks layer by layer in
lockstep so that an MoE layer routes the whole microbatch (capacity and
slot order as one device's), and the microbatch's loss is each rank's
sum over its tokens, added in rank order and divided once.  Where it
does not (rows the dp axes do not divide), each microbatch runs whole on
the first data-parallel rank that holds its rows (a batch the data axes
do not divide is replicated, and each microbatch still runs once).  A
rank's devices are its model group, tensor-parallel as GSPMD splits the
reference's products (``distributed/tensor_parallel.py``): each model
rank's local replica holds its compute blocks (a stored block in place,
any other gathered over the data axes), computes its heads, FFN columns,
vocabulary rows or experts, the partials are all-reduced at the layer
boundaries, and each rank's gradient blocks are reduced over the
data-parallel ranks in rank order.  With ``seq_shard`` (decoder-only),
where the anchor keeps ``model`` on the sequence, the residual stream
between layers is each model rank's slice of the sequence: all-gathered
before each layer, the partials reduce-scattered after it.  On a mesh of
one data-parallel rank with a ``model`` axis of 1 the group is one
device whose replica is the whole model, and the step is
``make_train_step``'s arithmetic, bitwise; so is any mesh whose
microbatch rows do not split, on a ``model`` axis of 1.
Each shard is updated in place (``stored_grads``, then
``sharded_adamw_update``: one global norm over the whole gradient).
``make_prefill_step(bundle, mesh)`` is the prefill forward placed alike:
each data-parallel rank's rows on its model group where the anchor keeps
dp (logits concatenated in rank order), else the whole batch on rank
0's.  ``make_serve_step(bundle, mesh)``
is the decode step against a cache placed by ``cache_shardings``
(``sharding.shard_cache``): each data-parallel rank's model group runs its
rows, each model rank on its own blocks of the weights and of the cache
(k and v split over the length, combined by the split-KV softmax), and
each rank's cache blocks are written in place (:meth:`MeshCompute.decode`);
``CapturedDecode(bundle, serve_step)`` captures that step as one CUDA
graph.
"""
from __future__ import annotations

import torch

from repro_torch.device import capture_graph
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models.layers import make_compute_copies, trainable
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
    step takes a state of ``init_state(..., mesh=mesh)`` and computes on
    :class:`MeshCompute` (``step.compute``)."""
    mb = max(1, bundle.cfg.microbatches)
    if mesh is not None:
        compute = MeshCompute(bundle, mesh)

        def sharded_step(state: dict, batch: dict):
            loss, grads = compute.loss_and_grads(state["params"], batch, mb)
            grads, sq_sums = stored_grads(grads, state["params"])
            metrics = sharded_adamw_update(grads, sq_sums, state["opt"],
                                           state["params"], opt_cfg)
            return state, dict(metrics, loss=loss)
        sharded_step.compute = compute      # its replicas and tallies
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
    """The compute side of a sharded train, prefill or decode step on
    ``mesh``.  Each data-parallel rank's ``model`` ranks form a
    :class:`~repro_torch.distributed.tensor_parallel.ModelGroup` (one rank
    on a ``model`` axis of 1), one local replica per (device, model rank)
    holds that rank's compute blocks (:meth:`bind_rank`; on a ``model``
    axis of 1 the whole model), each microbatch runs on its owner ranks'
    groups (:meth:`owner_ranks`: every rank on its rows, or one rank
    whole), and each rank's gradient blocks are reduced over the owner
    ranks; a decode step runs each rank's rows on its group
    (:meth:`decode`)."""

    def __init__(self, bundle: ModelBundle, mesh):
        self.bundle, self.mesh = bundle, mesh
        self.replicas: dict = {}
        self.serving: dict = {}
        self.gathered: dict[tuple, torch.Tensor] = {}
        self.plans: dict[int, tp.Plan] = {}
        self.tallies: dict[int, tp.Tally] = {}
        dp = sharding.dp_axes(mesh)
        self.n_dp = sharding._size(mesh, dp)
        self.n_model = tp.model_size(mesh)
        # each data-parallel rank's coordinate and device: its (pod, data)
        # coordinates, every other axis at 0
        self.rank_coord = []
        for r in range(self.n_dp):
            at, rest = dict.fromkeys(mesh.axis_names, 0), r
            for a in reversed(dp):
                at[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
            self.rank_coord.append(tuple(at.values()))
        self.rank_device = [mesh.device(c) for c in self.rank_coord]

    def coord(self, rank: int, m: int = 0) -> tuple:
        """The mesh coordinate of data-parallel ``rank``'s model rank
        ``m``."""
        at = dict(zip(self.mesh.axis_names, self.rank_coord[rank]))
        if "model" in at:
            at["model"] = m
        return tuple(at.values())

    def group_devices(self, rank: int) -> list:
        """The devices of ``rank``'s model group, in model-rank order."""
        return [self.mesh.device(self.coord(rank, m))
                for m in range(self.n_model)]

    def plan(self, m: int) -> tp.Plan:
        """Model rank ``m``'s compute blocks (``tp.local_model``)."""
        if m not in self.plans:
            self.plans[m] = tp.local_model(self.bundle, self.mesh, m)
        return self.plans[m]

    def rank_replica(self, device, m: int) -> torch.nn.Module:
        """Model rank ``m``'s local replica on ``device`` (on the meta
        device until :meth:`bind_rank`): the plan's own for the first
        device, so that no unbound copy is left holding parameters."""
        key = (device, m)
        if key not in self.replicas:
            taken = any(k[1] == m for k in self.replicas)
            self.replicas[key] = (
                tp.local_model(self.bundle, self.mesh, m).model if taken
                else self.plan(m).model)
        return self.replicas[key]

    def bind_rank(self, device, params: dict, m: int) -> torch.nn.Module:
        """Model rank ``m``'s local replica on ``device`` bound to its
        compute blocks of ``params`` (name -> ``Sharded``): a block that
        is one stored block held on ``device`` is that tensor itself (no
        copy; the step's in-place update reaches it), any other is
        gathered (over the data axes, or re-sliced where the compute block
        crosses the stored ones: kv heads, SSD's ``w_in``) into a buffer
        the replica keeps.  On the ``(1, 1)`` mesh no weight is copied and
        the replica holds no memory of its own."""
        return self._bind(self.rank_replica(device, m), self.plan(m).splits,
                          device, params, m)

    def serving_replica(self, device, params: dict, m: int):
        """:meth:`bind_rank`'s replica with its compute copies
        (``make_compute_copies``), made on the first decode with
        ``params`` and kept: a decode step reads weights that do not
        change (after an update of ``params``, a new step)."""
        key = (device, m)
        if self.serving.get(key) is not params:
            make_compute_copies(self.bind_rank(device, params, m),
                                getattr(torch, self.bundle.cfg.dtype))
            self.serving[key] = params
        return self.replicas[key]

    @torch.no_grad()
    def _bind(self, model, splits, device, params, m):
        for n, p in list(model.named_parameters()):
            leaf, sp = params[n], splits.get(n)
            t = None
            want = tp.region(leaf.shape, sp)
            if want is not None and all(
                    s.stop - s.start == b and s.start % b == 0
                    for s, b in zip(want, leaf.block_shape)):
                block = tuple(s.start // b for s, b in
                              zip(want, leaf.block_shape))
                t = leaf.tensors.get((block, device))
            if t is None:
                key = (device, m, n)
                t = self.gathered.get(key)
                if t is None:
                    t = self.gathered[key] = torch.empty(
                        sp.local_shape(leaf.shape) if sp else leaf.shape,
                        dtype=leaf.dtype, device=device)
                if sp is None:
                    sharding.gather_into(leaf, t)
                else:
                    for off, where in sp.regions(leaf.shape):
                        sharding.gather_region(leaf, where, t.narrow(
                            sp.dim, off, where[sp.dim].stop
                            - where[sp.dim].start))
            if p.is_meta or p.data_ptr() != t.data_ptr():
                mod, _, name = n.rpartition(".")
                model.get_submodule(mod)._parameters[name] = \
                    torch.nn.Parameter(t, requires_grad=p.requires_grad)
        return model

    def layout(self, batch: dict, rows: int) -> tuple[int, bool]:
        """How a step places (micro)batches of ``rows`` rows of ``batch``:
        the number of data-parallel ranks their rows split over and
        whether their sequence splits over ``model``.  The reference's
        anchor of the residual stream (``sharding.residual_entries``, with
        ``seq_shard`` for the decoder-only LM) resolved on its shape
        [rows, L, d_model]: all the dp axes or none, and the sequence
        where ``model`` > 1 divides it."""
        cfg = self.bundle.cfg
        seq = bool(cfg.seq_shard) and not cfg.n_enc_layers
        spec = sharding.resolve(
            (rows, lm_lib.residual_len(batch), cfg.d_model),
            sharding.residual_entries(seq), self.mesh)
        return ((self.n_dp if spec[0] is not None else 1),
                seq and self.n_model > 1 and spec[1] is not None)

    def owner_ranks(self, batch: dict, mb: int) -> list[tuple[int, ...]]:
        """The data-parallel ranks each microbatch runs on: every rank,
        each on its share of the rows in rank order, where the residual
        anchor keeps dp on a microbatch's rows (:meth:`layout`); else the
        first rank holding its first row, which runs it whole
        (``batch_spec``: rows over the dp axes when they divide; else
        every rank holds every row, and rank 0 runs it)."""
        name, leaf = next(iter(batch.items()))
        rows = leaf.shape[0]
        n_ranks, _ = self.layout(batch, rows // mb)
        if n_ranks > 1:
            return [tuple(range(n_ranks))] * mb
        spec = sharding.batch_spec(name, tuple(leaf.shape), self.mesh)
        per_rank = rows // self.n_dp if spec[0] is not None else rows
        return [((i * (rows // mb)) // per_rank,) for i in range(mb)]

    def owners(self, batch: dict, mb: int) -> list[tuple]:
        """The devices each microbatch runs on (:meth:`owner_ranks`; each
        owner group's model rank 0's)."""
        return [tuple(self.rank_device[r] for r in ranks)
                for ranks in self.owner_ranks(batch, mb)]

    def group(self, rank: int, seq: bool = False) -> tp.ModelGroup:
        """Data-parallel ``rank``'s model group (``seq``: the sequence
        split over it), tallying into ``tallies[rank]``."""
        return tp.ModelGroup(self.group_devices(rank),
                             tally=self.tallies.setdefault(rank, tp.Tally()),
                             seq=seq)

    def bound(self, groups: dict, params: dict) -> tuple[dict, dict]:
        """The bound local replicas of ``groups``' ranks, one per (device,
        model rank) (``{(device, m): replica}``), and each group's
        ``{rank: {m: replica}}``."""
        local = {}
        for r, g in groups.items():
            for m, d in enumerate(g.devices):
                if (d, m) not in local:
                    local[(d, m)] = self.bind_rank(d, params, m)
        return local, {r: {m: local[(d, m)] for m, d in enumerate(g.devices)}
                       for r, g in groups.items()}

    @staticmethod
    def runs(groups: dict, models: dict, batch: dict,
             ranks: tuple) -> list:
        """The :class:`~repro_torch.distributed.tensor_parallel.Run` of
        each of ``ranks`` on ``batch`` (one (micro)batch): its share of
        the rows in rank order, or every row for one rank.  ``groups`` /
        ``models``: each rank's group and replicas."""
        rows = next(iter(batch.values())).shape[0]
        per = rows // len(ranks)
        out = []
        for i, b in enumerate(ranks):
            sl = slice(i * per, (i + 1) * per)
            part = batch if len(ranks) == 1 else {k: v[sl]
                                                  for k, v in batch.items()}
            out.append(tp.Run(b, groups[b], models[b],
                              tp.feeds_on(groups[b], part), sl))
        return out

    def loss_and_grads(self, params: dict, batch: dict, mb: int = 1):
        """The loss of ``batch`` (``loss_and_grads``'s order: microbatch
        losses summed from zero, then divided by ``mb``) and each
        parameter's gradient, a :class:`~repro_torch.distributed.
        tensor_parallel.Grad` of the model ranks' blocks (one whole piece
        on a ``model`` axis of 1; None where no microbatch reached the
        parameter)."""
        owners = self.owner_ranks(batch, mb)
        rows = next(iter(batch.values())).shape[0] // mb
        _, seq = self.layout(batch, rows)
        n_ranks = len(owners[0])
        self.tallies = {}
        groups = {r: self.group(r, seq) for ranks in owners for r in ranks}
        # one local replica per (device, model rank): groups on the same
        # devices share them, and their rows accumulate into the same
        # .grad
        local, models = self.bound(groups, params)
        for model in local.values():
            model.zero_grad(set_to_none=True)
        home = groups[owners[0][0]].home
        with self.mesh:
            total = torch.zeros((), dtype=torch.float32, device=home)
            for micro, ranks in zip(split_batch(batch, mb), owners):
                loss = tp.step_loss(self.bundle, self.runs(
                    groups, models, micro, ranks), n_ranks)
                loss.backward()
                total = total + loss.detach().to(home)
            loss = total / mb if mb > 1 else total
        with torch.no_grad():
            # each model rank's gradients summed over its replicas (one a
            # device) in the order their ranks first ran
            by_rank = []
            for m in range(self.n_model):
                named = [dict(mod.named_parameters())
                         for (_, k), mod in local.items() if k == m]
                grads = {}
                for n in named[0]:
                    parts = [nm[n].grad for nm in named
                             if nm[n].grad is not None]
                    g = parts[0] if parts else None
                    for other in parts[1:]:
                        g = g + other.to(g.device)
                    grads[n] = g
                by_rank.append(grads)
            shapes = {n: leaf.shape for n, leaf in params.items()}
            return loss, tp.piece_grads(
                [(g, self.plan(m).splits) for m, g in enumerate(by_rank)],
                shapes, mb)

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict) -> torch.Tensor:
        """``make_prefill_step``'s logits of ``batch``: each data-parallel
        rank's rows on its model group where the residual anchor keeps dp
        (:meth:`layout`), concatenated in rank order on rank 0's device;
        else the whole batch on rank 0's group."""
        rows = next(iter(batch.values())).shape[0]
        n_ranks, seq = self.layout(batch, rows)
        self.tallies = {}
        ranks = tuple(range(n_ranks))
        groups = {b: self.group(b, seq) for b in ranks}
        _, models = self.bound(groups, params)
        with self.mesh:
            out = tp.step_prefill(self.bundle, self.runs(
                groups, models, batch, ranks), n_ranks)
        if n_ranks == 1:
            return out[0]
        home = groups[0].home
        return torch.cat([out[b].to(home) for b in ranks])

    @torch.no_grad()
    def decode(self, params: dict, cache, batch: dict,
               model_rank: int | None = None):
        """``make_serve_step``'s step on the mesh: ``(logits [B, vocab],
        cache)`` for ``batch`` (``{"tokens" [B, 1], "pos"}``) against
        ``cache`` (``sharding.shard_cache``'s tree), every rank's cache
        blocks written in place.  Rows split over the data axes
        (``batch_spec``) run on their ranks' model groups; a batch they do
        not divide runs on rank 0's, and its cache blocks are then copied
        to the data-parallel replicas on other devices.  Each group's
        bytes are tallied into ``tallies[rank]``.  With ``model_rank``
        (the dry-run's counted mode) only that rank of rank 0's group
        runs, on its rows."""
        cfg = self.bundle.cfg
        home = self.rank_device[0]
        tokens = torch.as_tensor(batch["tokens"], device=home).long()
        limit = (encdec_lib.position_limit if cfg.n_enc_layers
                 else lm_lib.position_limit)(cfg, cache)
        pos = lm_lib.step_position(batch["pos"], limit, home)
        spec = sharding.batch_spec("tokens", tuple(tokens.shape), self.mesh)
        n_ranks = self.n_dp if spec[0] is not None else 1
        per = tokens.shape[0] // n_ranks
        members = None if model_rank is None else (model_rank,)
        self.tallies = {}
        runs = []
        for b in (range(n_ranks) if model_rank is None else (0,)):
            g = tp.ModelGroup(self.group_devices(b), members=members,
                              tally=self.tallies.setdefault(b, tp.Tally()))
            rows = slice(b * per, (b + 1) * per)
            runs.append(tp.DecodeRun(
                b, g, {m: self.serving_replica(g.devices[m], params, m)
                       for m in g.members},
                {d: {"tokens": tokens[rows].to(d)} for d in g.places()},
                {m: tp.cache_blocks(cache, self.coord(b, m))
                 for m in g.members}, g.rep(pos), rows))
        with self.mesh:
            out = tp.group_decode(self.bundle, runs, n_ranks)
        logits = torch.cat([out[b].to(home) for b in sorted(out)])
        if n_ranks == 1 and self.n_dp > 1 and model_rank is None:
            self._copy_to_replicas(cache)
        return logits, cache

    def decode_step(self, params: dict, cache, tokens, pos):
        """:meth:`decode` with ``bundle.decode_step``'s arguments (what
        :class:`CapturedDecode` calls)."""
        return self.decode(params, cache, {"tokens": tokens, "pos": pos})

    @torch.no_grad()
    def _copy_to_replicas(self, cache) -> None:
        """Each cache block rank 0's group wrote, copied to the copies of
        the same block on other devices (rows replicated over the data
        axes; on one device the coordinates share one tensor)."""
        written = [self.coord(0, m) for m in range(self.n_model)]
        for leaf in sharding.tree_leaves(cache).values():
            src = {leaf.where[c][0]: leaf.tensors[leaf.where[c]]
                   for c in written}
            for (block, _), t in leaf.tensors.items():
                if t is not src[block]:
                    t.copy_(src[block])


@torch.no_grad()
def stored_grads(grads: dict, params: dict) -> tuple[dict, list]:
    """What ``sharded_adamw_update`` takes from ``grads`` (name ->
    :class:`~repro_torch.distributed.tensor_parallel.Grad` or None): each
    leaf's gradient cut to its stored blocks (``{block index: tensor}``,
    None for a zero gradient), and the sums of squares of the whole
    gradient, each distinct piece once, leaf by leaf in ``params``'
    order (a piece that is a whole leaf sums as ``adamw_update`` sums
    it)."""
    blocks, sq_sums = {}, []
    for n, leaf in params.items():
        g = grads.get(n)
        if g is None:
            blocks[n] = None
            continue
        sq_sums += [torch.sum(torch.square(t.float())) for _, _, t in g.pieces]
        blocks[n] = {b: g.block(leaf.slices(b))
                     for b in dict.fromkeys(key[0] for key in leaf.tensors)}
    return blocks, sq_sums


def make_prefill_step(bundle: ModelBundle, mesh=None):
    """(model, batch) -> last-position logits [B, padded_vocab].  With
    ``mesh`` the step takes the parameters placed on it (name ->
    ``Sharded``, e.g. ``sharded_state``'s) and runs each data-parallel
    rank's rows on its model group (:meth:`MeshCompute.prefill`)."""
    if mesh is not None:
        return MeshCompute(bundle, mesh).prefill

    def prefill_step(params, batch):
        if bundle.cfg.n_enc_layers:
            return bundle.forward(params, batch)[:, -1, :]
        return lm_lib.forward(params, batch, last_only=True)[:, 0]
    return prefill_step


def make_serve_step(bundle: ModelBundle, mesh=None):
    """(model, cache, {"tokens", "pos"}) -> (logits, cache).  With
    ``mesh`` the step takes the parameters placed on it (name ->
    ``Sharded``) and a cache placed by ``sharding.shard_cache`` and runs
    :meth:`MeshCompute.decode` (``serve_step.compute``: its replicas and
    tallies)."""
    if mesh is not None:
        compute = MeshCompute(bundle, mesh)

        def sharded_serve_step(params, cache, batch):
            return compute.decode(params, cache, batch)
        sharded_serve_step.compute = compute
        return sharded_serve_step

    def serve_step(params, cache, batch):
        return bundle.decode_step(params, cache, batch["tokens"],
                                  batch["pos"])
    return serve_step


def cache_leaves(cache) -> list[torch.Tensor]:
    """The tensors of a cache pytree (a placed cache: each ``Sharded``
    leaf's distinct tensors), in a fixed order."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    if isinstance(cache, sharding.Sharded):
        return list(cache.tensors.values())
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
    ``serve_step``, a ``make_serve_step(bundle, mesh)``, captures that
    mesh step instead (``params`` placed on the mesh, ``cache`` by
    ``sharding.shard_cache``; its replicas shared): one graph per placed
    cache, holding every rank's ops.

    The graph reads and writes the cache it was captured with, in place,
    and ``pos`` reaches it through a device scalar; a new cache (or model,
    or batch) is captured anew.  A capture that fails raises.  On the CPU
    the same body (static inputs, then the step) runs uncaptured.  The
    logits returned are a copy, valid after later calls."""

    def __init__(self, bundle: ModelBundle, serve_step=None):
        self.bundle = bundle
        self.step = (bundle.decode_step if serve_step is None
                     else serve_step.compute.decode_step)
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
                self.step, params, cache, tuple(tokens.shape), dev)
        step.tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            step.pos.copy_(pos)
        else:
            step.pos.fill_(lm_lib.check_position(
                pos, self._limit(self.bundle.cfg, cache)))
        return step.run().clone(), cache
