"""Tensor-parallel compute over the ``model`` axis, single-controller: what
GSPMD does for the reference's sharded step (``repro/launch/steps.py``
under the shardings of ``repro/distributed/sharding.py``), written out for
one process that drives every coordinate of the mesh.

*The model group* (:class:`ModelGroup`) is the ``model`` coordinates of
one data-parallel rank, their devices in model-rank order.  Each rank runs
its share of every split layer on a local replica that holds only its
blocks of the weights (:func:`local_model`): its attention heads (and the
kv heads those use), FFN columns, vocabulary rows, experts, RG-LRU
channels or SSD heads.  The partial results are reduced at the layer
boundaries.  What every rank holds alike, the residual stream and the
positions, is a :data:`Rep`: one tensor per distinct device, shared by
the ranks on it (as ``Sharded`` shares blocks), so a mesh of T ranks on
one card holds one residual stream, not T.

*Sequence parallelism* (``ModelGroup(..., seq=True)``, the reference's
``seq_shard``): between layers each rank holds its slice [rows, L / T, D]
of the residual stream (a dict rank -> slice).  The norms run on the
slices, which are all-gathered over the sequence before each layer
(:func:`norm_each`); the row-parallel partials are reduce-scattered in
place of the all-reduce (:meth:`ModelGroup.combine`: the same rank-order
sum, cut), and a module that runs whole keeps each rank's slice of its
output (:meth:`ModelGroup.keep`).

*Rows over the data-parallel ranks* (:class:`Run`): a train or prefill
step whose rows the dp axes split runs each rank's rows on its own model
group, the groups layer by layer in lockstep, so that an MoE layer routes
the whole (micro)batch (:func:`gather_rows`) as one device does; the
loss is each rank's sum over its tokens, added in rank order and divided
once (:func:`rows_mean`).  With ``moe_dispatch_shard`` each group runs
the expert GEMMs of its share of the slots, whose outputs are then
all-gathered over the ranks (:func:`gather_slots`).

*Collectives* are plain tensor ops, differentiated by autograd: an
all-reduce sums the partials in model-rank order on the first rank's
device and copies the sum to every other device; an all-gather is a
``cat`` in rank order.  :class:`Tally` counts the bytes of each
collective's result on one rank: forward (recomputes included) and
backward (an all-reduce's gradient is all-reduced too: it is the
gradient of the replicated input that the next split layer's ranks each
differentiate in part).

*Counted mode* (``ModelGroup(devices, members=(r,))``): only rank ``r``'s
local ops run; an all-reduce passes its own partial through (the other
ranks' partials would add into it in place) and still tallies the bytes,
so a step on the ``meta`` device under ``roofline.StepCounter`` counts one
rank's program exactly (``launch/dryrun.py``).

*The layer rule.*  A layer splits when the rules keep ``model`` on its
main weight and its heads (experts, channels) divide over the group; else
it runs whole, once on each device, its weights gathered over ``model``
(:attr:`Plan.whole` names such layers).

*Decode* (:func:`group_decode`): each rank reads and writes its own
blocks of the cache placed by ``cache_shardings`` (:class:`CacheBlock`).
Attention's k and v are split over the cache length, so each rank runs the
softmax over its slice for every head and the group combines the slices
(``mixers.attention_decode_tp``: an all-max, then all-reduces of the
rescaled sums and values); the new token's k and v are all-gathered and
written by the rank whose slice holds the slot, a write predicated on the
device (:func:`owner_write`).  A leaf whose compute region crosses the
stored blocks (SSD's conv) is gathered for the step and its stored shares
written back (:func:`gather_region`, :func:`write_back`); a layer that runs
whole gathers and writes back every leaf (:func:`whole_decode`).  An MoE
layer routes the whole step's batch, every data-parallel rank's rows
gathered (:func:`gather_rows`), as the single-device step does.

*Gradients.*  A rank's gradient is that of its compute block; the blocks
of the ranks that hold the same slice (a replicated leaf, kv heads shared
by several ranks' queries, SSD's ``B``/``C``) are summed in rank order,
and :class:`Grad` holds each leaf's gradient as disjoint pieces along one
dimension, from which ``launch.steps.stored_grads`` cuts each stored
block for the optimizer.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.distributed import sharding
from repro_torch.models.layers import rms_norm

Rep = dict   # torch.device -> torch.Tensor: one tensor per distinct device


class Tally:
    """Bytes of the group's collectives for one rank: ``bytes[(kind,
    phase)]``, kind one of ``roofline.COLLECTIVES``, phase "forward",
    "backward" or "cache" (a decode's cache regions gathered and written
    back)."""

    def __init__(self):
        self.bytes = collections.Counter()

    def add(self, kind: str, phase: str, n: int) -> None:
        self.bytes[(kind, phase)] += n

    def total(self, kind: str) -> int:
        return sum(v for (k, _), v in self.bytes.items() if k == kind)

    def as_dict(self) -> dict:
        """``{kind: {phase: bytes}}``."""
        out: dict = {}
        for (kind, phase), v in sorted(self.bytes.items()):
            out.setdefault(kind, {})[phase] = v
        return out

    def add_between(self, a: "Tally", b: "Tally", times: int) -> None:
        """Add ``times`` what was tallied between the copies ``a`` and
        ``b`` (taken in that order)."""
        for key, v in b.bytes.items():
            self.bytes[key] += times * (v - a.bytes.get(key, 0))

    def copy(self) -> "Tally":
        t = Tally()
        t.bytes = collections.Counter(self.bytes)
        return t


class ModelGroup:
    """The ``model`` ranks of one data-parallel rank: ``devices[m]`` runs
    rank ``m``.  ``members`` are the ranks whose ops run here: all of them,
    or one in counted mode."""

    def __init__(self, devices, members=None, tally: Tally | None = None,
                 seq: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        self.members = (tuple(range(len(self.devices))) if members is None
                        else tuple(members))
        self.counted = len(self.members) < len(self.devices)
        self.tally = tally if tally is not None else Tally()
        self.seq = seq

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tally_rank(self) -> int:
        """The rank whose bytes the tally holds where ranks differ (a
        decode's cache regions): the first member.  The activation
        collectives move the same bytes on every rank."""
        return self.members[0]

    @property
    def home(self) -> torch.device:
        """The first member's device (where the loss is read)."""
        return self.devices[self.members[0]]

    def places(self) -> dict:
        """Each distinct device of the members -> its first member rank."""
        out = {}
        for r in self.members:
            out.setdefault(self.devices[r], r)
        return out

    def rep(self, t: torch.Tensor) -> Rep:
        """``t`` on every member device (itself on its own)."""
        return {d: t if t.device == d else t.to(d) for d in self.places()}

    def at(self, rep: Rep, r: int) -> torch.Tensor:
        """Rank ``r``'s tensor of a replicated value."""
        return rep[self.devices[r]]

    def _count(self, kind: str, t: torch.Tensor, out=None,
               back=None) -> None:
        """Tally ``t``'s bytes forward and, when it has a gradient,
        ``out``'s (default ``t``) backward, as ``kind`` or as ``back`` =
        (kind, bytes) where the backward is another collective."""
        self.tally.add(kind, "forward", _bytes(t))
        out = t if out is None else out
        if out.requires_grad and torch.is_grad_enabled():
            bk, n = back if back is not None else (kind, _bytes(out))
            out.register_hook(lambda g: self.tally.add(bk, "backward", n))

    def all_reduce(self, parts: dict, dtype=None) -> Rep:
        """Sum of the members' partials in rank order, rounded to ``dtype``
        (default the partials'), on every device."""
        total = parts[self.members[0]]
        if not self.counted:
            for r in self.members[1:]:
                total = total + parts[r].to(total.device)
        out = total.to(dtype) if dtype is not None else total
        self._count("all-reduce", total, out)
        return self.rep(out)

    def all_max(self, parts: dict) -> Rep:
        """Elementwise max of the members' (gradient-free) tensors."""
        out = parts[self.members[0]]
        if not self.counted:
            for r in self.members[1:]:
                out = torch.maximum(out, parts[r].to(out.device))
        self._count("all-reduce", out)
        return self.rep(out)

    def _cut(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Rank ``r``'s slice of ``t``'s sequence (dimension 1)."""
        n = t.shape[1] // self.size
        return t.narrow(1, r * n, n)

    def combine(self, parts: dict, dtype=None, extend=None) -> dict:
        """The members' row-parallel partials summed into the residual
        stream: all-reduced (a :data:`Rep`), or with the sequence split
        (``seq``) reduce-scattered: the same rank-order sum, rounded to
        ``dtype``, cut along the sequence, each member's slice on its
        device (``{rank: slice}``; in counted mode the rank's own partial
        passes through).  ``extend(t, device)`` is applied to the sum
        before any cut (the frontend prefix ahead of the token
        embeddings)."""
        if not self.seq:
            out = self.all_reduce(parts, dtype)
            return (out if extend is None
                    else {d: extend(t, d) for d, t in out.items()})
        total = parts[self.members[0]]
        if not self.counted:
            for r in self.members[1:]:
                total = total + parts[r].to(total.device)
        full = total.to(dtype) if dtype is not None else total
        if extend is not None:
            full = extend(full, full.device)
        out = {r: self._cut(full, r).to(self.devices[r])
               for r in self.members}
        self._count("reduce-scatter", self._cut(total, self.tally_rank),
                    out[self.tally_rank], back=("all-gather", _bytes(full)))
        return out

    def seq_gather(self, parts: dict) -> Rep:
        """The members' slices of the sequence (``parts[rank]``, dimension
        1) concatenated in rank order, on every device, with a gradient
        (reduce-scattered back to the slices); in counted mode the rank's
        own slice among empty ones (the others' arrive)."""
        if self.counted:
            (r,) = self.members
            own = parts[r]
            n = own.shape[1]
            full = own.new_empty((own.shape[0], n * self.size,
                                  *own.shape[2:]))
            full.narrow(1, r * n, n).copy_(own)
        else:
            full = torch.cat([parts[r].to(self.home) for r in self.members],
                             1)
        self._count("all-gather", full,
                    back=("reduce-scatter", _bytes(full) // self.size))
        return self.rep(full)

    def keep(self, rep: Rep) -> dict:
        """A value every member device holds whole (a module that ran
        whole) as the residual stream: itself, or with the sequence split
        each member's slice of its device's tensor."""
        if not self.seq:
            return rep
        return {r: self._cut(self.at(rep, r), r) for r in self.members}

    @torch.no_grad()
    def all_gather(self, parts: dict, dim: int) -> Rep:
        """The members' blocks concatenated along ``dim`` in rank order (no
        gradient); in counted mode the rank's own block placed in a buffer
        of the whole shape (the others' blocks arrive into it)."""
        if self.counted:
            (r,) = self.members
            own = parts[r]
            n = own.shape[dim]
            shape = list(own.shape)
            shape[dim] = n * self.size
            out = own.new_empty(shape)
            out.narrow(dim, r * n, n).copy_(own)
        else:
            out = torch.cat([parts[r].to(self.home) for r in self.members],
                            dim)
        self._count("all-gather", out)
        return self.rep(out)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------------ layer helpers
def norm_each(group: ModelGroup, mods: dict, name: str, x: dict,
              eps: float) -> dict:
    """Each member's ``rms_norm`` of the residual stream ``x`` with its own
    copy of the (replicated) weight ``name``; with the sequence split, of
    its own slice, the normed slices then all-gathered
    (:meth:`ModelGroup.seq_gather`), so every member gets the whole
    sequence."""
    if group.seq:
        full = group.seq_gather({r: rms_norm(x[r], getattr(mods[r], name),
                                             eps) for r in group.members})
        return {r: group.at(full, r) for r in group.members}
    return {r: rms_norm(group.at(x, r), getattr(mods[r], name), eps)
            for r in group.members}


def residual(x: dict, y: dict) -> dict:
    """The residual add of two values of the stream (both :data:`Rep`, or
    both a rank's slices)."""
    return {k: x[k] + y[k] for k in x}


def branch(group: ModelGroup, mods: dict, run, dtype, split=None) -> dict:
    """The output of one layer branch as the residual stream, in
    ``dtype``.  A split module (``tp_split``): each member's partial
    (``run(module, rank)``) combined (:meth:`ModelGroup.combine`), or
    ``split(group, mods)`` for a module whose ranks meet inside it.  A
    whole module: ``run`` once on each device, by its first member rank
    (:meth:`ModelGroup.keep`)."""
    m0 = mods[group.members[0]]
    if getattr(m0, "tp_split", False):
        if split is not None:
            return split(group, mods)
        return group.combine({r: run(mods[r], r) for r in group.members},
                             dtype)
    return group.keep({d: run(mods[r], r)
                       for d, r in group.places().items()})


# ------------------------------------------------------------ the plan
@dataclasses.dataclass(frozen=True)
class Split:
    """A rank's compute block of one leaf: the ``ranges`` of dimension
    ``dim`` (ascending), concatenated; every other dimension whole."""
    dim: int
    ranges: tuple[tuple[int, int], ...]

    def local_shape(self, shape) -> tuple[int, ...]:
        out = list(shape)
        out[self.dim] = sum(b - a for a, b in self.ranges)
        return tuple(out)

    def regions(self, shape):
        """``(offset in the local tensor, region of the global one)`` of
        each range."""
        off = 0
        for a, b in self.ranges:
            region = [slice(0, n) for n in shape]
            region[self.dim] = slice(a, b)
            yield off, tuple(region)
            off += b - a


@dataclasses.dataclass
class Plan:
    """A model rank's local replica (on ``meta`` until bound), the compute
    block of each split leaf, and the layers that run whole."""
    model: torch.nn.Module
    splits: dict
    whole: list


def _one(a: int, b: int) -> tuple:
    return ((a, b),)


def _reparam(mod, splits: dict) -> None:
    """Re-register each split parameter of ``mod`` at its local shape."""
    for name, sp in splits.items():
        old = mod._parameters[name]
        mod.register_parameter(name, torch.nn.Parameter(
            torch.empty(sp.local_shape(old.shape), dtype=old.dtype,
                        device="meta"), requires_grad=False))


def _attention(mod, T: int, m: int):
    """Heads of q (and the kv heads they read) by column, ``wo`` by row."""
    cfg = mod.cfg
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if H % T:
        return None
    hq, G = H // T, H // Hkv
    if hq % G and G % hq:
        return None
    q0 = m * hq
    k0, k1 = q0 // G, (q0 + hq - 1) // G + 1
    q, kv = _one(q0 * Dh, (q0 + hq) * Dh), _one(k0 * Dh, k1 * Dh)
    out = {"wq": Split(1, q), "wk": Split(1, kv), "wv": Split(1, kv),
           "wo": Split(0, q)}
    if "bq" in mod._parameters:
        out |= {"bq": Split(0, q), "bk": Split(0, kv), "bv": Split(0, kv)}
    mod.cfg = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=k1 - k0,
                                  head_dim=Dh)
    return out


def _mla(mod, T: int, m: int):
    """``wq``, ``w_uk``, ``w_uv`` by heads, ``wo`` by row; the latent
    down-projections and their norm whole."""
    cfg = mod.cfg
    H = cfg.n_heads
    if H % T:
        return None
    h = H // T
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    mod.cfg = dataclasses.replace(cfg, n_heads=h)
    return {"wq": Split(1, _one(m * h * qd, (m + 1) * h * qd)),
            "w_uk": Split(1, _one(m * h * nope, (m + 1) * h * nope)),
            "w_uv": Split(1, _one(m * h * vd, (m + 1) * h * vd)),
            "wo": Split(0, _one(m * h * vd, (m + 1) * h * vd))}


def _rglru(mod, T: int, m: int):
    """Every RG-LRU channel parameter by channel, ``w_out`` by row."""
    dr = mod.w_in.shape[1]
    if dr % T:
        return None
    c = _one(m * dr // T, (m + 1) * dr // T)
    out = {n: Split(1, c) for n in ("w_in", "w_gate", "conv_w")}
    out |= {n: Split(0, c) for n in ("w_out", "conv_b", "w_rgate", "b_rgate",
                                     "w_igate", "b_igate", "lam")}
    return out


def _ssd(mod, T: int, m: int):
    """SSD heads: ``w_in``'s z, x and dt columns of the rank's heads with
    B and C whole, the conv on the rank's x channels and B, C, the
    per-head tables, ``out_norm`` and ``w_out`` on its ``d_inner``
    slice."""
    di, n, H = mod.d_inner, mod.d_state, mod.n_heads
    if H % T:
        return None
    dl, hl = di // T, H // T
    d0, h0 = m * dl, m * hl
    z, x = (d0, d0 + dl), (di + d0, di + d0 + dl)
    bc, dt = (2 * di, 2 * di + 2 * n), (2 * di + 2 * n + h0,
                                       2 * di + 2 * n + h0 + hl)
    conv = ((d0, d0 + dl), (di, di + 2 * n))
    heads = _one(h0, h0 + hl)
    mod.d_inner, mod.n_heads = dl, hl
    return {"w_in": Split(1, (z, x, bc, dt)), "conv_w": Split(1, conv),
            "conv_b": Split(0, conv), "a_log": Split(0, heads),
            "dt_bias": Split(0, heads), "d_skip": Split(0, heads),
            "out_norm": Split(0, (z,)), "w_out": Split(0, (z,))}


def _dense(mod, T: int, m: int):
    """``w_gate`` and ``w_up`` by column, ``w_down`` by row."""
    F = mod.w_gate.shape[1]
    if F % T:
        return None
    f = _one(m * F // T, (m + 1) * F // T)
    return {"w_gate": Split(1, f), "w_up": Split(1, f),
            "w_down": Split(0, f)}


def _moe(mod, T: int, m: int):
    """The experts over ``model`` (EP) and the shared experts as a dense
    FFN; the router whole."""
    E = mod.w_gate.shape[0]
    if E % T:
        return None
    shared = {}
    if mod.shared is not None:
        shared = _dense(mod.shared, T, m)
        if shared is None:
            return None
        _reparam(mod.shared, shared)
        mod.shared.tp_split = True
    e = _one(m * E // T, (m + 1) * E // T)
    return ({n: Split(0, e) for n in ("w_gate", "w_up", "w_down")}
            | {f"shared.{n}": sp for n, sp in shared.items()})


def _splitters():
    from repro_torch.models import encdec, ffn, mixers
    return {mixers.Attention: (_attention, "wq"),
            encdec.CrossAttention: (_attention, "wq"),
            mixers.MLA: (_mla, "wq"), mixers.RGLRU: (_rglru, "w_in"),
            mixers.SSD: (_ssd, "w_in"), ffn.DenseFFN: (_dense, "w_gate"),
            ffn.MoEFFN: (_moe, "w_gate")}


def _keeps_model(name: str, shape, mesh) -> bool:
    spec = sharding.param_spec(name, tuple(shape), mesh)
    return any("model" in ((e,) if isinstance(e, str) else (e or ()))
               for e in spec)


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def local_model(bundle, mesh, m: int) -> Plan:
    """Rank ``m``'s local replica of ``bundle``'s model on ``mesh`` (built
    on ``meta``, trainable) and its compute blocks.  On a mesh whose
    ``model`` axis is 1 it is the whole model and nothing splits."""
    from repro_torch.models.layers import trainable

    T = model_size(mesh)
    model = bundle.abstract_params()
    splits, whole = {}, []
    if T > 1:
        table = _splitters()
        for path, mod in list(model.named_modules()):
            entry = table.get(type(mod))
            if entry is None or path.endswith(".shared"):
                continue
            fn, main = entry
            if not _keeps_model(f"{path}.{main}",
                                mod._parameters[main].shape, mesh):
                out = None
            else:
                out = fn(mod, T, m)
            if out is None:
                whole.append(path)
                continue
            _reparam(mod, {n: sp for n, sp in out.items() if "." not in n})
            mod.tp_split = True
            splits |= {f"{path}.{n}": sp for n, sp in out.items()}
        V = model.embed.shape[0]
        if V % T == 0 and _keeps_model("embed", model.embed.shape, mesh):
            v = _one(m * V // T, (m + 1) * V // T)
            root = {"embed": Split(0, v)}
            if "lm_head" in model._parameters:
                root["lm_head"] = Split(1, v)
            _reparam(model, root)
            model.tp_split = True
            splits |= root
        else:
            whole.append("embed")
    return Plan(trainable(model), splits, whole)


def region(shape, sp: Split | None):
    """The global region of a one-range compute block (the whole leaf for
    None); None for a block of several ranges."""
    if sp is None:
        return tuple(slice(0, n) for n in shape)
    if len(sp.ranges) != 1:
        return None
    return next(sp.regions(shape))[1]


def held_block(leaf, sp: Split | None, coord) -> bool:
    """Whether the compute block ``sp`` of ``leaf`` is coordinate
    ``coord``'s own stored block (bound in place, nothing gathered)."""
    want = region(leaf.shape, sp)
    return want is not None and leaf.slices(leaf.where[tuple(coord)][0]) \
        == want


# ------------------------------------------------------------ gradients
@dataclasses.dataclass
class Grad:
    """The reduced gradient of one leaf of ``shape``: disjoint ``pieces``
    ``(start, stop, tensor)`` along ``dim``, ascending.  A part no piece
    covers is zero (in a counted step: what other ranks' pieces hold)."""
    shape: tuple
    dim: int
    pieces: list

    def block(self, where) -> torch.Tensor:
        """The gradient of the region ``where`` (one slice a dimension)."""
        want = where[self.dim]
        parts, pos = [], want.start
        ref = self.pieces[0][2]

        def gap(n):
            shape = [s.stop - s.start for s in where]
            shape[self.dim] = n
            return torch.zeros(shape, dtype=ref.dtype, device=ref.device)

        for a, b, t in self.pieces:
            lo, hi = max(a, want.start), min(b, want.stop)
            if lo >= hi:
                continue
            if lo > pos:
                parts.append(gap(lo - pos))
            idx = list(where)
            idx[self.dim] = slice(lo - a, hi - a)
            parts.append(t[tuple(idx)])
            pos = hi
        if pos < want.stop:
            parts.append(gap(want.stop - pos))
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(ref.device) for p in parts], self.dim)

    def whole(self) -> torch.Tensor:
        return self.block(tuple(slice(0, n) for n in self.shape))


def piece_grads(ranks, shapes: dict, mb: int = 1) -> dict:
    """Each leaf's :class:`Grad` from the model ranks' local gradients:
    ``ranks`` lists ``(grads, splits)`` in rank order (``grads[name]``
    None where the rank has none); each rank's gradient is cut into its
    compute block's ranges, ranges that several ranks hold are summed in
    rank order, and each piece is divided by ``mb`` (in place)."""
    out = {}
    for name, shape in shapes.items():
        pieces, dim = {}, 0
        for grads, splits in ranks:
            g = grads.get(name)
            if g is None:
                continue
            sp = splits.get(name)
            dim = sp.dim if sp is not None else 0
            ranges = sp.ranges if sp is not None else ((0, shape[0]),)
            off = 0
            for a, b in ranges:
                chunk = g.narrow(dim, off, b - a)
                off += b - a
                prev = pieces.get((a, b))
                pieces[(a, b)] = (chunk if prev is None
                                  else prev + chunk.to(prev.device))
        if not pieces:
            out[name] = None
            continue
        keys = sorted(pieces)
        for (_, b), (a2, _) in zip(keys, keys[1:]):
            if a2 < b:
                raise AssertionError(f"{name}: overlapping pieces {keys}")
        if mb > 1:
            for t in pieces.values():
                t.div_(mb)
        out[name] = Grad(tuple(shape), dim,
                         [(a, b, pieces[(a, b)]) for a, b in keys])
    return out


@dataclasses.dataclass
class Run:
    """One data-parallel rank's part of a train or prefill step: its model
    group, each member's bound replica, its rows' inputs on each device
    (``feeds[device]``, :func:`feeds_on`) and which rows of the
    (micro)batch are its."""
    rank: int
    group: ModelGroup
    models: dict
    feeds: dict
    rows: slice


def feeds_on(group: ModelGroup, batch: dict) -> dict:
    """``batch`` on every member device of ``group``."""
    return {d: {k: v.to(d) for k, v in batch.items()}
            for d in group.places()}


def _family(bundle):
    from repro_torch.models import encdec, lm
    return encdec if bundle.cfg.n_enc_layers else lm


def rows_mean(runs: list, xent: dict, n_ranks: int) -> torch.Tensor:
    """The mean over a (micro)batch's tokens of the per-token losses each
    run holds for its rows (``xent[rank]``, on its group's home): with
    one rank holding every row, its mean (the single-device arithmetic);
    else each rank's sum, the sums added in rank order on the first run's
    home, divided once by the token count (``n_ranks`` times a rank's; in
    counted mode the other ranks' sums arrive)."""
    if n_ranks == 1:
        (run,) = runs
        return xent[run.rank].mean()
    runs = sorted(runs, key=lambda run: run.rank)
    home = runs[0].group.home
    total = None
    for run in runs:
        part = xent[run.rank].sum().to(home)
        total = part if total is None else total + part
    return total / (xent[runs[0].rank].numel() * n_ranks)


def step_loss(bundle, runs: list, n_ranks: int) -> torch.Tensor:
    """``bundle.loss`` of one (micro)batch whose rows are split over
    ``n_ranks`` data-parallel ranks, each :class:`Run` on its rows: a
    float32 scalar on the first run's home device."""
    return _family(bundle).lm_loss_tp(runs, n_ranks)


def step_prefill(bundle, runs: list, n_ranks: int) -> dict:
    """``make_prefill_step``'s last-position logits [rows, padded_vocab]
    of each run's rows (rows split over ``n_ranks`` data-parallel ranks),
    ``{rank: tensor}`` on each group's home device."""
    logits = _family(bundle).forward_tp(runs, n_ranks, last_only=True)
    out = {}
    for run in runs:
        g = run.group
        if getattr(run.models[g.members[0]], "tp_split", False):
            full = g.all_gather(logits[run.rank], dim=-1)
        else:
            full = {g.devices[r]: t for r, t in logits[run.rank].items()}
        out[run.rank] = full[g.home][:, 0]
    return out


# ------------------------------------------------------------ decode
@dataclasses.dataclass
class CacheBlock:
    """A model rank's stored block of one decode-cache leaf on its
    data-parallel rank's rows: the tensor ``t`` (one tensor for the ranks
    that hold the same block on one device), its offset ``lo`` in each
    dimension of ``shape`` (the leaf on those rows, whole over ``model``)
    and the ``Sharded`` leaf's ``(block, device)`` key of it."""
    t: torch.Tensor
    lo: tuple
    shape: tuple
    key: tuple

    @property
    def whole(self) -> bool:
        return tuple(self.t.shape) == tuple(self.shape)

    @property
    def dim(self) -> int | None:
        """The dimension split over ``model`` (None for a whole block)."""
        for d in range(1, len(self.shape)):
            if self.t.shape[d] != self.shape[d]:
                return d
        return None

    def slab(self, dim: int, a: int, b: int) -> torch.Tensor:
        """The block's part of the leaf's range ``[a, b)`` of ``dim``."""
        return self.t.narrow(dim, a - self.lo[dim], b - a)


def cache_blocks(tree, coord):
    """The blocks mesh coordinate ``coord`` holds of a cache tree of
    ``Sharded`` leaves (``sharding.shard_cache``), as :class:`CacheBlock`
    in the same tree."""
    if isinstance(tree, sharding.Sharded):
        key = tree.where[tuple(coord)]
        t = tree.tensors[key]
        starts = [s.start for s in tree.slices(key[0])]
        return CacheBlock(t, (0, *starts[1:]), (t.shape[0], *tree.shape[1:]),
                          key)
    if isinstance(tree, dict):
        return {k: cache_blocks(v, coord) for k, v in tree.items()}
    return [cache_blocks(v, coord) for v in tree]


def _nbytes(t: torch.Tensor, dim: int, n: int) -> int:
    """Bytes of ``n`` positions of ``t`` along ``dim``."""
    return t.numel() // max(t.shape[dim], 1) * n * t.element_size()


def owner_write(blk: CacheBlock, dim: int, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """Write ``new`` (one position along ``dim``) at the leaf's position
    ``slot`` (a 0-d device tensor) into ``blk`` if its slice holds it; a
    block that does not rewrites what it had at its clamped position.  The
    choice is made on the device, so the step reads nothing on the host
    and can be captured."""
    n = blk.t.shape[dim]
    local = slot - blk.lo[dim]
    inside = (local >= 0) & (local < n)
    idx = torch.clamp(local, 0, n - 1).reshape(1)
    keep = blk.t.index_select(dim, idx)
    blk.t.index_copy_(dim, idx, torch.where(inside, new.to(blk.t.dtype),
                                            keep))


def gather_region(group: ModelGroup, blocks: dict, r: int, dim: int,
                  ranges) -> torch.Tensor:
    """Rank ``r``'s compute region of one cache leaf: the ``ranges`` of
    ``dim`` (concatenated) of its rows, copied from the group's stored
    blocks (``blocks[rank]``: each block index once, the copy on r's device
    first).  In counted mode only r's own block is read (the rest arrives
    into the buffer).  The bytes not from r's own block are tallied, for
    the tally's rank, as a cache all-gather."""
    own = blocks[r]
    shape = list(own.shape)
    shape[dim] = sum(b - a for a, b in ranges)
    out = own.t.new_empty(shape)
    sources = {own.key[0]: own}
    for s in group.members:
        b = blocks[s]
        prev = sources.get(b.key[0])
        if prev is None or (prev.t.device != own.t.device
                            and b.t.device == own.t.device):
            sources[b.key[0]] = b
    if group.counted:
        sources = {own.key[0]: own}
    from_own, off = 0, 0
    for a, b in ranges:
        for src in sources.values():
            lo = max(a, src.lo[dim])
            hi = min(b, src.lo[dim] + src.t.shape[dim])
            if lo < hi:
                out.narrow(dim, off + lo - a, hi - lo).copy_(
                    src.slab(dim, lo, hi))
                if src is own:
                    from_own += _nbytes(out, dim, hi - lo)
        off += b - a
    if r == group.tally_rank:
        group.tally.add("all-gather", "cache",
                        out.numel() * out.element_size() - from_own)
    return out


def _uncovered(lo: int, hi: int, filled: list) -> list:
    """The parts of ``[lo, hi)`` outside the intervals of ``filled``."""
    parts = [(lo, hi)] if lo < hi else []
    for a, b in filled:
        parts = [p for x, y in parts
                 for p in ((x, min(y, a)), (max(x, b), y)) if p[0] < p[1]]
    return parts


def write_back(group: ModelGroup, blocks: dict, bufs: dict,
               dim: int) -> None:
    """Write the ranks' compute regions (``bufs[rank] = (tensor,
    ranges)``, made by :func:`gather_region` and since updated) into the
    members' stored blocks, each distinct tensor once: each part from a
    rank that stores the block where its region holds that part, else
    from the first rank (in rank order) whose region does.  In counted
    mode the rank's own block takes only its own region's part (the rest
    arrives).  The bytes a block takes from other ranks are tallied for
    the tally's rank."""
    done = set()
    for s in group.members:
        blk = blocks[s]
        if blk.key in done:
            continue
        done.add(blk.key)
        storing = [q for q in group.members if blocks[q].key == blk.key]
        order = ([q for q in storing if q in bufs]
                 + [q for q in bufs if q not in storing])
        start, n = blk.lo[dim], blk.t.shape[dim]
        filled, from_storing = [], 0
        for q in order:
            buf, ranges = bufs[q]
            off = 0
            for a, b in ranges:
                for lo, hi in _uncovered(max(a, start), min(b, start + n),
                                         filled):
                    blk.slab(dim, lo, hi).copy_(
                        buf.narrow(dim, off + lo - a, hi - lo))
                    filled.append((lo, hi))
                    if q in storing:
                        from_storing += _nbytes(blk.t, dim, hi - lo)
                off += b - a
        if group.tally_rank in storing:
            group.tally.add("all-gather", "cache",
                            blk.t.numel() * blk.t.element_size()
                            - from_storing)


def whole_decode(group: ModelGroup, mods: dict, caches: dict, run,
                 write: bool = True) -> Rep:
    """A module that runs whole on the group (the layer rule): on each
    device, by its first member, ``run(module, rank, cache)`` with each
    leaf of the module's cache (``caches[rank]``: name -> CacheBlock) at
    its whole rows: the stored block itself where it is whole, else
    gathered, and (``write``) written back once every device has run."""
    views, pending = {}, []
    for d, r in group.places().items():
        views[r] = {}
        for name, blk in caches[r].items():
            if blk.whole:
                views[r][name] = blk.t
                continue
            dim = blk.dim
            ranges = ((0, blk.shape[dim]),)
            buf = gather_region(group, {q: caches[q][name]
                                        for q in group.members}, r, dim,
                                ranges)
            views[r][name] = buf
            pending.append((name, dim, r, buf, ranges))
    out = {d: run(mods[r], r, views[r]) for d, r in group.places().items()}
    if write:
        for name in dict.fromkeys(p[0] for p in pending):
            parts = [p for p in pending if p[0] == name]
            write_back(group, {q: caches[q][name] for q in group.members},
                       {r: (buf, ranges) for _, _, r, buf, ranges in parts},
                       parts[0][1])
    return out


def gather_rows(groups: dict, parts: dict, n_ranks: int) -> dict:
    """Every data-parallel rank's rows (``parts[rank]``, on its group's
    home) concatenated in rank order, on every device of each group of
    ``groups`` ({rank: ModelGroup}): ``{rank: Rep}``, with a gradient
    (each rank's rows' gradients reduce-scattered back).  Where only some
    of the ``n_ranks`` ranks run here (counted mode), the others' rows
    arrive into the buffer.  Tallied into each group's tally as an
    all-gather."""
    out = {}
    for b, g in groups.items():
        if len(parts) == n_ranks:
            full = torch.cat([parts[k].to(g.home) for k in sorted(parts)])
        else:
            own = parts[b]
            n = own.shape[0]
            full = own.new_empty((n * n_ranks, *own.shape[1:]))
            full.narrow(0, b * n, n).copy_(own)
        g._count("all-gather", full,
                 back=("reduce-scatter", _bytes(full) // n_ranks))
        out[b] = g.rep(full)
    return out


def gather_slots(groups: dict, parts: dict, n_ranks: int) -> dict:
    """The expert slot outputs of every data-parallel rank (``parts[rank]
    [r]``: [experts, cap / n_ranks, D] of model rank r, on its device of
    the rank's group ``groups[rank]``; ``ffn.moe_dp``) concatenated in
    rank order along the slot axis, for each of those model ranks on its
    device of each group: ``{rank: {r: [experts, cap, D]}}``, with a
    gradient (reduce-scattered back to each rank's share).  A rank that
    ran nothing of its own (a module that runs whole, once per device)
    reads its device's share; the results on one device are one tensor.
    Where only some of the ``n_ranks`` ranks run here (counted mode), the
    others' shares arrive into the buffer.  Tallied into each group's
    tally as an all-gather, for its tally rank."""
    out, made = {}, {}
    for b, g in groups.items():
        out[b] = {}
        for r, own in parts[b].items():
            dev = g.devices[r]
            if len(parts) == n_ranks:
                srcs = [by[r] if r in by else
                        by[groups[k].places()[groups[k].devices[r]]]
                        for k, by in sorted(parts.items())]
                key = (tuple(map(id, srcs)), dev)
                if key not in made:
                    made[key] = torch.cat([t.to(dev) for t in srcs], 1)
                full = made[key]
            else:
                n = own.shape[1]
                full = own.new_empty((own.shape[0], n * n_ranks,
                                      *own.shape[2:]))
                full.narrow(1, b * n, n).copy_(own)
            out[b][r] = full
        t = out[b][g.tally_rank]
        g._count("all-gather", t, back=("reduce-scatter",
                                        _bytes(t) // n_ranks))
    return out


@dataclasses.dataclass
class DecodeRun:
    """One data-parallel rank's part of a decode step: its model group,
    each member's bound replica, its rows' tokens on each device
    (``feeds[device]["tokens"]``), each member's cache blocks (a tree of
    :class:`CacheBlock`), the position on each device, and which rows of
    the step's batch are its."""
    rank: int
    group: ModelGroup
    models: dict
    feeds: dict
    caches: dict
    pos: Rep
    rows: slice


def group_decode(bundle, runs: list, n_ranks: int) -> dict:
    """``make_serve_step``'s logits [rows, vocab] of each run's rows
    (:class:`DecodeRun`, rows split over ``n_ranks`` data-parallel
    ranks), ``{rank: tensor}`` on each group's home device; every cache
    block written in place."""
    blocks = _family(bundle).decode_tp(runs, n_ranks)
    out = {}
    for run in runs:
        g, logits = run.group, blocks[run.rank]
        if getattr(run.models[g.members[0]], "tp_split", False):
            full = g.all_gather(logits, dim=-1)
        else:
            full = {g.devices[r]: t for r, t in logits.items()}
        out[run.rank] = full[g.home][:, 0, :bundle.cfg.vocab]
    return out
