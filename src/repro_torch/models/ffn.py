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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Weights, geglu, glorot, silu, swiglu


# ------------------------------------------------------------------ dense
class DenseFFN(Weights):
    """SwiGLU (or GeGLU) of width ``d_ff`` (default ``cfg.d_ff``)."""

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None,
                 act: str | None = None, device=None):
        super().__init__()
        D, Fw = cfg.d_model, d_ff or cfg.d_ff
        self.act = geglu if (act or cfg.ffn) == "geglu" else swiglu
        self.param("w_gate", D, Fw, device=device)
        self.param("w_up", D, Fw, device=device)
        self.param("w_down", Fw, D, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("w_gate", "w_up", "w_down"):
            p = getattr(self, name)
            p.copy_(glorot(p.shape, gen, p.device))

    def forward(self, x):
        return self.act(x, self.w("w_gate", x.dtype), self.w("w_up", x.dtype),
                        self.w("w_down", x.dtype))


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


def moe_ffn(m: MoEFFN, x: torch.Tensor) -> torch.Tensor:
    """Token-choice top-k MoE with capacity-bounded gather / scatter
    dispatch; x: [B, L, D].  Choices past an expert's capacity are dropped,
    as in the reference (at decode, T = B)."""
    cfg = m.cfg
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * L
    dt = x.dtype
    dev = x.device
    xf = x.reshape(T, D)

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
    occupied = slot_token > 0
    gathered = torch.where(occupied[..., None],
                           xf[torch.clamp(slot_token - 1, min=0)],
                           0.0).to(dt)                      # [E, cap, D]

    # grouped GEMM over experts
    g = torch.bmm(gathered, m.w("w_gate", dt))
    u = torch.bmm(gathered, m.w("w_up", dt))
    y_e = torch.bmm(silu(g) * u, m.w("w_down", dt))       # [E, cap, D]

    # weighted scatter back: each token's kept choices, summed in slot
    # order (the reference's serial segment sum); dropped choices read the
    # zero row at the sentinel
    flat_w = top_p.reshape(-1).to(dt)                       # [T*K]
    slot_w = torch.zeros(E * cap + 1, dtype=dt, device=dev)
    slot_w.scatter_(0, dest, torch.where(keep, flat_w, 0.0))
    contrib = y_e * slot_w[:-1].reshape(E, cap)[..., None]
    contrib = torch.where(occupied[..., None], contrib, 0.0).reshape(E * cap, D)
    rows = torch.cat([contrib, contrib.new_zeros((1, D))])  # + sentinel row
    order = torch.sort(dest.reshape(T, K), dim=-1).values
    picked = rows[order]                                    # [T, K, D]
    out = picked[:, 0]
    for k in range(1, K):
        out = out + picked[:, k]

    if m.shared is not None:
        out = out + m.shared(xf)
    return out.reshape(B, L, D)


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
