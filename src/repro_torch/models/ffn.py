"""Feed-forward layers: dense SwiGLU / GeGLU and Mixture-of-Experts.

The MoE dispatch is the reference's gather -> grouped GEMM -> weighted
scatter (``repro/models/ffn.py``): top-k routing, a capacity-bounded slot
table per expert, one batched product over all experts, and the weighted
sum back to the tokens.  The reference's final ``segment_sum`` becomes a
DETERMINISTIC reduction: each token's K contributions are gathered from
their slots and added one by one in increasing slot order (no atomics),
so two runs of a step, and a step and its CUDA-graph replay, agree
bitwise.  ``moe_dispatch_report`` is the static analyzer decision under
``core.perfmodel.TPUV5E``, equal to the reference's.

``moe_dispatch_shard`` (the reference constrains the dispatched slots
[E, cap, D] to ``("model", "dp", None)``) takes effect where a step's rows
are split over the data-parallel ranks and those divide the capacity:
each rank's group runs the grouped GEMM on its share of the slots only,
and the slot outputs are all-gathered over the ranks (:func:`moe_dp`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import Weights, gelu, glorot, silu


# ------------------------------------------------------------------ dense
class DenseFFN(Weights):
    """SwiGLU (or GeGLU) of width ``d_ff`` (default ``cfg.d_ff``)."""

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None,
                 act: str | None = None, device=None):
        super().__init__()
        D, Fw = cfg.d_model, d_ff or cfg.d_ff
        self.gate = gelu if (act or cfg.ffn) == "geglu" else silu
        self.param("w_gate", D, Fw, device=device)
        self.param("w_up", D, Fw, device=device)
        self.param("w_down", Fw, D, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("w_gate", "w_up", "w_down"):
            p = getattr(self, name)
            p.copy_(glorot(p.shape, gen, p.device))

    def forward(self, x):
        """``swiglu`` / ``geglu`` of ``layers.py``, op for op."""
        g = x @ self.w("w_gate", x.dtype)
        u = x @ self.w("w_up", x.dtype)
        return self.out_product(self.gate(g) * u, "w_down")


# ------------------------------------------------------------------ MoE
class MoEFFN(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Fw, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.param("router", D, E, device=device)
        self.param("w_gate", E, D, Fw, device=device)
        self.param("w_up", E, D, Fw, device=device)
        self.param("w_down", E, Fw, D, device=device)
        self.shared = (DenseFFN(cfg, Fw * cfg.n_shared_experts, act="swiglu",
                                device=device)
                       if cfg.n_shared_experts else None)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("router", "w_gate", "w_up", "w_down"):
            p = getattr(self, name)
            p.copy_(glorot(p.shape, gen, p.device))
        if self.shared is not None:
            self.shared.reset_parameters(gen)

    def forward(self, x):
        return moe_ffn(self, x)


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert: ``max(1, int(T K capacity_factor / E))``."""
    return max(1, int(tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


class MoERoute(NamedTuple):
    """A batch's routing: slots per expert, the token of each slot (0 =
    empty, else id + 1) and its occupancy [E, cap], each slot's gate
    weight [E, cap], and each token's K slots in slot order [T, K] (the
    sentinel E * cap for a dropped choice)."""
    cap: int
    slot_token: torch.Tensor
    occupied: torch.Tensor
    slot_w: torch.Tensor
    order: torch.Tensor


def moe_route(m: MoEFFN, xf: torch.Tensor) -> MoERoute:
    """Top-k routing of ``xf`` [T, D] with capacity-bounded slots per
    expert; choices past an expert's capacity are dropped, as in the
    reference (at decode, T = B)."""
    cfg = m.cfg
    E, K = cfg.n_experts, cfg.top_k
    T = xf.shape[0]
    dt, dev = xf.dtype, xf.device

    logits = xf @ m.w("router", dt)
    probs = torch.softmax(logits.float(), dim=-1)
    # torch.topk's order among EQUAL probabilities is unspecified (the
    # reference's lax.top_k takes the lower expert first)
    top_p, top_e = torch.topk(probs, K, dim=-1)             # [T, K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # capacity-bounded slots per expert
    cap = moe_capacity(cfg, T)
    flat_e = top_e.reshape(-1)                              # [T*K]
    onehot = F.one_hot(flat_e, E)                           # [T*K, E]
    pos_in_e = torch.cumsum(onehot, dim=0) * onehot         # 1-based slot
    slot = pos_in_e.amax(dim=-1) - 1                        # [T*K]
    keep = slot < cap                                       # overflow dropped
    dest = torch.where(keep, flat_e * cap + slot, E * cap)  # sentinel E*cap

    # token ids into the [E*cap] slot table; the sentinel slot takes every
    # dropped choice and is cut off
    token_id = torch.arange(T, device=dev).repeat_interleave(K)
    slot_token = torch.zeros(E * cap + 1, dtype=torch.long, device=dev)
    slot_token.scatter_(0, dest, token_id + 1)              # 0 = empty
    slot_token = slot_token[:-1].reshape(E, cap)
    flat_w = top_p.reshape(-1).to(dt)                       # [T*K]
    slot_w = torch.zeros(E * cap + 1, dtype=dt, device=dev)
    slot_w.scatter_(0, dest, torch.where(keep, flat_w, 0.0))
    order = torch.sort(dest.reshape(T, K), dim=-1).values
    return MoERoute(cap, slot_token, slot_token > 0,
                    slot_w[:-1].reshape(E, cap), order)


def moe_experts(m: MoEFFN, slot_token, occupied, xf, dt) -> torch.Tensor:
    """The slots' tokens [E, cap, D] (zeros in empty slots; any run of the
    slots, :func:`moe_dp`) through the grouped GEMM of ``m``'s experts."""
    gathered = torch.where(occupied[..., None],
                           xf[torch.clamp(slot_token - 1, min=0)],
                           0.0).to(dt)                      # [E, cap, D]
    g = torch.bmm(gathered, m.w("w_gate", dt))
    u = torch.bmm(gathered, m.w("w_up", dt))
    return torch.bmm(silu(g) * u, m.w("w_down", dt))       # [E, cap, D]


def moe_combine(y_e, slot_w, occupied, order) -> torch.Tensor:
    """The weighted scatter back: each token's kept choices, summed in slot
    order (the reference's serial segment sum); ``order`` indexes the
    [E * cap] slots of ``y_e``, one past them for a dropped choice (the
    zero row)."""
    E, cap, D = y_e.shape
    contrib = y_e * slot_w[..., None]
    contrib = torch.where(occupied[..., None], contrib, 0.0).reshape(E * cap, D)
    rows = torch.cat([contrib, contrib.new_zeros((1, D))])  # + sentinel row
    picked = rows[order]                                    # [T, K, D]
    out = picked[:, 0]
    for k in range(1, order.shape[1]):
        out = out + picked[:, k]
    return out


def moe_ffn(m: MoEFFN, x: torch.Tensor, routed=None) -> torch.Tensor:
    """Token-choice top-k MoE with capacity-bounded gather / scatter
    dispatch; x: [B, L, D].  ``routed``: the routing of ``x`` and its
    slot outputs, made elsewhere (:func:`moe_dp`)."""
    B, L, D = x.shape
    xf = x.reshape(B * L, D)
    if routed is None:
        route = moe_route(m, xf)
        y_e = moe_experts(m, route.slot_token, route.occupied, xf, x.dtype)
    else:
        route, y_e = routed
    out = moe_combine(y_e, route.slot_w, route.occupied, route.order)
    if m.shared is not None:
        out = out + m.shared(xf)
    return out.reshape(B, L, D)


def moe_tp(group, mods: dict, h: dict, full: dict | None = None,
           rows: slice | None = None, routed: dict | None = None) -> dict:
    """The split MoE layer on a tensor-parallel model group, experts over
    ``model`` (EP), its output on every device: every rank routes alike
    (the router is whole), runs the grouped GEMM of its ``E / T``
    experts and combines its own experts' slots per token in slot order
    (another rank's slots read the zero row); the ranks' combines are
    all-reduced, so each token's choices are summed rank by rank (the
    reference's single slot-order sum, reassociated where a token's
    choices lie on more than one rank), and the shared experts (a split
    dense FFN) are combined apart and added, as the whole layer adds
    them (``group.combine``: all-reduced, or reduce-scattered over the
    sequence).  With ``full`` (a step whose rows are split over the
    data-parallel ranks: the whole batch's inputs [B, L, D] on every
    device, of which this group's are the batch rows ``rows``), every
    group routes the whole batch and combines its own rows; ``routed``
    (``{rank: (route, slot outputs [E / T, cap, D])}``, :func:`moe_dp`)
    holds each rank's routing and its experts' slot outputs, made
    before."""
    parts, shared = {}, {}
    for r in group.members:
        m, x = mods[r], h[r]
        B, L, D = x.shape
        xf = x.reshape(B * L, D)
        n = m.w_gate.shape[0]
        lo = slice(r * n, (r + 1) * n)
        if routed is None:
            src = xf if full is None else group.at(full, r).reshape(-1, D)
            route = moe_route(m, src)
            y_e = moe_experts(m, route.slot_token[lo], route.occupied[lo],
                              src, x.dtype)
        else:
            route, y_e = routed[r]
        order = route.order
        if rows is not None:
            order = order.reshape(-1, L, order.shape[-1])[rows].flatten(0, 1)
        local = order - r * n * route.cap
        inside = (local >= 0) & (local < n * route.cap)
        parts[r] = moe_combine(y_e, route.slot_w[lo], route.occupied[lo],
                               torch.where(inside, local, n * route.cap)
                               ).reshape(B, L, D)
        if m.shared is not None:
            shared[r] = m.shared(xf).reshape(B, L, D)
    out = group.combine(parts)
    if shared:
        extra = group.combine(shared, h[group.members[0]].dtype)
        out = {k: out[k] + extra[k] for k in out}
    return out


def slots_split(cfg: ModelConfig, tokens: int, n_ranks: int) -> bool:
    """Whether ``moe_dispatch_shard`` splits the slots of a routing of
    ``tokens`` tokens over ``n_ranks`` > 1 data-parallel ranks that split
    the rows: where the reference's ``("model", "dp", None)`` keeps dp on
    the slot axis of [E, cap, D] (``sharding.resolve``: the dp axes,
    here of size ``n_ranks``, divide the capacity)."""
    return (bool(cfg.moe_dispatch_shard) and n_ranks > 1
            and moe_capacity(cfg, tokens) % n_ranks == 0)


def moe_dp(runs, ffns: dict, full: dict, n_ranks: int) -> dict:
    """``moe_dispatch_shard`` on the model groups of ``runs`` (``tp.Run``
    or ``tp.DecodeRun``, rows split over ``n_ranks`` data-parallel ranks;
    ``ffns[rank][r]``: the MoE module of model rank r, ``full[rank]``: the
    whole batch's inputs [B, L, D] on each device of the rank's group,
    ``tp.gather_rows``).  Every group routes the whole batch, as without
    the flag; data rank b's group runs the grouped GEMM only on the slots
    [b cap / n_ranks, (b + 1) cap / n_ranks) of its experts (a split
    module: its model rank's E / T, on each rank; one that runs whole: all
    E, once per device), and the slot outputs are all-gathered over the
    data ranks in rank order (``tp.gather_slots``).  ``{rank: {r: (route,
    slot outputs [experts, cap, D])}}``: what :func:`moe_tp` and
    :func:`moe_ffn` then combine, each token's choices in slot order, as
    without the flag."""
    routes, parts = {}, {}
    for run in runs:
        g, mods = run.group, ffns[run.rank]
        split = getattr(mods[g.members[0]], "tp_split", False)
        routes[run.rank], parts[run.rank] = {}, {}
        for r in (g.members if split else g.places().values()):
            m = mods[r]
            src = g.at(full[run.rank], r)
            src = src.reshape(-1, src.shape[-1])
            route = moe_route(m, src)
            n = m.w_gate.shape[0]
            e = slice(r * n, (r + 1) * n) if split else slice(None)
            c = route.cap // n_ranks
            s = slice(run.rank * c, (run.rank + 1) * c)
            routes[run.rank][r] = route
            parts[run.rank][r] = moe_experts(
                m, route.slot_token[e, s], route.occupied[e, s], src,
                src.dtype)
    gathered = tp.gather_slots({run.rank: run.group for run in runs}, parts,
                               n_ranks)
    return {b: {r: (route, gathered[b][r]) for r, route in by.items()}
            for b, by in routes.items()}


def moe_dispatch_report(cfg: ModelConfig, tokens: int) -> dict:
    """Static analyzer decision for the MoE dispatch: density of the
    token -> expert activation matrix and the chosen primitive under the
    TPU hardware model (the reference's model, kept for the decision; its
    seconds are model outputs, not measurements)."""
    from repro_torch.core.perfmodel import TPUV5E, TaskShape, t_dense, t_spdmm
    density = cfg.top_k / cfg.n_experts
    task = TaskShape(m=tokens, n=cfg.n_experts * cfg.moe_d_ff,
                     d=cfg.d_model, alpha_x=density, alpha_y=1.0)
    td, ts = t_dense(task, TPUV5E), t_spdmm(task, TPUV5E)
    return {"density": density, "t_dense": td, "t_sparse": ts,
            "primitive": "SpDMM(grouped-GEMM dispatch)" if ts < td else "GEMM"}


def make_ffn(cfg: ModelConfig, device=None):
    """The layer's FFN module, or None for ``ffn == "none"``."""
    if cfg.ffn == "moe":
        return MoEFFN(cfg, device=device)
    if cfg.ffn == "none":
        return None
    return DenseFFN(cfg, device=device)
