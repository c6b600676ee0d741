"""Shared transformer building blocks: the reference's
``repro/models/layers.py`` in PyTorch.

Norms and RoPE run in float32 and cast back; attention is the reference's
both-chunked online softmax (``flash_attention``) for full sequences and a
masked softmax over the padded cache for one decode step, GQA in grouped
form without repeating KV heads, every contraction in float32.
``flash_attention`` is differentiated by autograd, which keeps every
block's probabilities for the backward; ``flash_attention_vjp`` (chosen
by ``cfg.flash_vjp``) is the same forward with the reference's
recompute-based backward (``_FlashCore``), which keeps only q, k, v, the
output and the logsumexp.

:class:`Weights` is the base of every layer with parameters: parameters
stay float32 (``param_dtype``) and each is read in the compute dtype
through :meth:`Weights.w`.  For serving, that read comes from a copy made
once by :func:`make_compute_copies` (the same rounding as the
reference's ``.astype(x.dtype)`` at every use).  A parameter that
requires grad is always cast at its use instead, so its gradient flows
into the float32 parameter; :func:`trainable` turns a model to that mode
and drops its copies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e30          # the reference's fill for masked scores


# --------------------------------------------------------------- weights
class Weights(nn.Module):
    """A layer whose float32 parameters are read in the compute dtype."""

    def __init__(self):
        super().__init__()
        self._compute: dict[str, torch.Tensor] = {}

    def param(self, name: str, *shape: int, device=None) -> None:
        """Register an (uninitialised) float32 parameter without grad
        (:func:`trainable` turns grad on)."""
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=torch.float32, device=device),
            requires_grad=False))

    def w(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Parameter ``name`` in ``dtype``: itself, its compute copy (only
        while it requires no grad: a copy carries no gradient and goes
        stale at the first update), or a cast made now."""
        p = self._parameters[name]
        if p.dtype == dtype:
            return p
        copy = self._compute.get(name)
        if copy is not None and copy.dtype == dtype and not p.requires_grad:
            return copy
        return p.to(dtype)


@torch.no_grad()
def make_compute_copies(model: nn.Module, dtype: torch.dtype) -> None:
    """Turn ``model`` to serving: its parameters require no grad, and every
    :class:`Weights` layer gets a ``dtype`` copy of each of its parameters
    (none when ``dtype`` is float32).  Call again after the parameters
    change (after training: the counterpart of :func:`trainable`)."""
    model.requires_grad_(False)
    for m in model.modules():
        if isinstance(m, Weights):
            m._compute = {n: p.to(dtype)
                          for n, p in m.named_parameters(recurse=False)
                          if p.dtype != dtype}


def trainable(model: nn.Module) -> nn.Module:
    """Turn ``model`` to training: every parameter requires grad and every
    compute copy is dropped (their memory freed; each use casts the
    float32 parameter).  A trained model that is served again goes back
    through :func:`make_compute_copies`."""
    model.requires_grad_(True)
    for m in model.modules():
        if isinstance(m, Weights):
            m._compute = {}
    return model


def glorot(shape, gen: torch.Generator, device=None) -> torch.Tensor:
    """Glorot-normal float32 tensor drawn from ``gen``."""
    fan_in, fan_out = shape[-2], shape[-1]
    s = np.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=gen, device=device) * s


# --------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w.float()).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dtype)


# --------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _freqs_on(head_dim: int, theta: float,
              device: torch.device) -> torch.Tensor:
    """The float32 frequency table on ``device``, uploaded once (a CUDA
    graph capture cannot upload it; the eager step before it does)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotary embedding.  ``x``: [B, L, H, Dh]; ``positions``: [B, L]
    (classic) or [B, L, 3] (M-RoPE; ``sections`` splits the Dh/2
    frequency slots over the temporal / height / width streams)."""
    dh = x.shape[-1]
    freqs = _freqs_on(dh, float(theta), x.device)               # (Dh/2,)
    if sections is None:
        angles = positions[..., None].float() * freqs          # [B,L,Dh/2]
    else:
        if positions.ndim != 3 or positions.shape[-1] != len(sections):
            raise ValueError(f"M-RoPE positions {tuple(positions.shape)} "
                             f"for sections {sections}")
        if sum(sections) != dh // 2:
            raise ValueError(f"sections {sections} for head dim {dh}")
        parts, off = [], 0
        for i, sec in enumerate(sections):
            parts.append(positions[..., i:i + 1].float()
                         * freqs[off:off + sec])
            off += sec
        angles = torch.cat(parts, dim=-1)                      # [B,L,Dh/2]
    cos = torch.cos(angles)[:, :, None, :]                     # [B,L,1,Dh/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def flash_attention(
    q: torch.Tensor,               # [B, Lq, Hq, Dh]
    k: torch.Tensor,               # [B, Lk, Hkv, Dh]
    v: torch.Tensor,               # [B, Lk, Hkv, Dh]
    *,
    causal: bool = True,
    window: int | None = None,     # local attention: kv in (qpos-window, qpos]
    q_offset: int = 0,             # global position of q[0]
    q_chunk: int = 512,
    kv_chunk: int = 512,
    kv_len_mask: int | None = None,    # only the first N kv positions valid
    causal_skip: bool = False,         # visit only kv blocks <= the q block
) -> torch.Tensor:
    """Both-chunked online-softmax attention with grouped (GQA) heads, the
    reference's double scan as two Python loops over the blocks.

    A fully masked kv block leaves the running max, denominator and
    numerator exactly as they were (p is forced to 0, the correction is
    exp(0) = 1), so ``causal_skip``, which never visits the blocks above
    the diagonal, gives the same result."""
    opts = _flash_opts(q, k, causal, window, q_offset, q_chunk, kv_chunk,
                       kv_len_mask, causal_skip)
    return _flash_pieces(q, k, v, opts)[0]


def flash_attention_vjp(q, k, v, *, causal=True, window=None, q_offset=0,
                        q_chunk=512, kv_chunk=512, kv_len_mask=None,
                        causal_skip=False):
    """:func:`flash_attention` with the recompute-based custom backward
    (``_FlashCore``): the same forward, bitwise."""
    opts = _flash_opts(q, k, causal, window, q_offset, q_chunk, kv_chunk,
                       kv_len_mask, causal_skip)
    return _FlashCore.apply(q, k, v, opts)


def _flash_opts(q, k, causal, window, q_offset, q_chunk, kv_chunk,
                kv_len_mask, causal_skip) -> tuple:
    """The reference's ``opts``: (causal, window, q_offset, q chunk, kv
    chunk, valid kv length, causal_skip)."""
    Lk = k.shape[1]
    return (causal, window, q_offset, min(q_chunk, q.shape[1]),
            min(kv_chunk, Lk), kv_len_mask if kv_len_mask is not None else Lk,
            causal_skip)


def _flash_blocks(q, k, v, qc: int, kc: int):
    """q, k, v padded to whole chunks, in float32 blocks: q [B, nq, qc,
    Hkv, G, Dh], k and v [B, nk, kc, Hkv, Dh]."""
    B, Lq, Hq, Dh = q.shape
    _, Lk, Hkv, _ = k.shape
    nq, nk = -(-Lq // qc), -(-Lk // kc)
    qb = F.pad(q, (0, 0, 0, 0, 0, nq * qc - Lq)).reshape(
        B, nq, qc, Hkv, Hq // Hkv, Dh).float()
    kb = F.pad(k, (0, 0, 0, 0, 0, nk * kc - Lk)).reshape(
        B, nk, kc, Hkv, Dh).float()
    vb = F.pad(v, (0, 0, 0, 0, 0, nk * kc - Lk)).reshape(
        B, nk, kc, Hkv, Dh).float()
    return qb, kb, vb


def _flash_mask(opts, iq: int, ik: int, device) -> torch.Tensor:
    """[qc, kc] visibility of kv block ``ik`` from q block ``iq``."""
    causal, window, q_offset, qc, kc, valid_k, _ = opts
    q_pos = torch.arange(qc, device=device) + (iq * qc + q_offset)
    k_pos = torch.arange(kc, device=device) + ik * kc
    mask = k_pos[None, :] < valid_k
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def _flash_pieces(q, k, v, opts):
    """The shared forward: the output [B, Lq, Hq, Dh] in q's dtype and the
    logsumexp of every row, [nq, B, Hkv, G, qc] in float32."""
    causal, _, _, qc, kc, _, causal_skip = opts
    B, Lq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(Dh)
    qb, kb, vb = _flash_blocks(q, k, v, qc, kc)
    nq, nk = qb.shape[1], kb.shape[1]
    dev = q.device

    blocks, lses = [], []
    for iq in range(nq):
        m = torch.full((B, Hkv, G, qc), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, qc, Dh), dtype=torch.float32,
                          device=dev)
        n_vis = (min(nk, (iq * qc + qc + kc - 1) // kc)
                 if causal and causal_skip else nk)
        for ik in range(n_vis):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb[:, iq], kb[:, ik]) * scale
            mask = _flash_mask(opts, iq, ik, dev)
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bhgqk,bkhd->bhgqd", p, vb[:, ik]))
            m = m_new
        l = torch.clamp(l, min=1e-20)
        blocks.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(l))
    out = torch.cat(blocks, dim=1).reshape(B, nq * qc, Hq, Dh)
    return out[:, :Lq].to(q.dtype), torch.stack(lses)


class _FlashCore(torch.autograd.Function):
    """Flash attention whose backward recomputes each block's
    probabilities from the saved logsumexp (the reference's
    ``_flash_core`` custom VJP): it saves (q, k, v, out, lse), O(L) per
    head, where autograd through :func:`flash_attention` keeps a
    [qc, kc] float32 block for every (q, kv) block pair."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = _flash_pieces(q, k, v, opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward(ctx.opts, q, k, v, out, lse, g), None)


def _flash_backward(opts, q, k, v, out, lse, g):
    """The reference's two passes: dq over q blocks (each against every kv
    block), then dk and dv over kv blocks (each against every q block);
    p = exp(s - lse) under the mask, ds = p (dp - delta) with delta =
    rowsum(do * out)."""
    _, _, _, qc, kc, _, _ = opts
    B, Lq, Hq, Dh = q.shape
    _, Lk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(Dh)
    qb, kb, vb = _flash_blocks(q, k, v, qc, kc)
    nq, nk = qb.shape[1], kb.shape[1]
    dev = q.device
    pad_q = (0, 0, 0, 0, 0, nq * qc - Lq)
    dop = F.pad(g.float(), pad_q)
    outp = F.pad(out.float(), pad_q)
    dob = dop.reshape(B, nq, qc, Hkv, G, Dh)
    delta = ((dop * outp).sum(-1).reshape(B, nq, qc, Hkv, G)
             .permute(1, 0, 3, 4, 2))                     # [nq, B, Hkv, G, qc]

    def p_of(iq, ik):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb[:, iq], kb[:, ik]) * scale
        return torch.where(_flash_mask(opts, iq, ik, dev),
                           torch.exp(s - lse[iq][..., None]), 0.0)

    def ds_of(iq, ik, p):
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dob[:, iq], vb[:, ik])
        return p * (dp - delta[iq][..., None])

    dq_blocks = []
    for iq in range(nq):
        dq = torch.zeros((B, qc, Hkv, G, Dh), dtype=torch.float32, device=dev)
        for ik in range(nk):
            ds = ds_of(iq, ik, p_of(iq, ik))
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kb[:, ik]) * scale
        dq_blocks.append(dq)

    dk_blocks, dv_blocks = [], []
    for ik in range(nk):
        dk = torch.zeros((B, kc, Hkv, Dh), dtype=torch.float32, device=dev)
        dv = torch.zeros_like(dk)
        for iq in range(nq):
            p = p_of(iq, ik)
            dv = dv + torch.einsum("bhgqk,bqhgd->bkhd", p, dob[:, iq])
            dk = dk + torch.einsum("bhgqk,bqhgd->bkhd", ds_of(iq, ik, p),
                                   qb[:, iq]) * scale
        dk_blocks.append(dk)
        dv_blocks.append(dv)

    dq = torch.cat(dq_blocks, dim=1).reshape(B, nq * qc, Hq, Dh)[:, :Lq]
    dk = torch.cat(dk_blocks, dim=1)[:, :Lk]
    dv = torch.cat(dv_blocks, dim=1)[:, :Lk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(
    q: torch.Tensor,           # [B, 1, Hq, Dh]: one new token
    k_cache: torch.Tensor,     # [B, Lmax, Hkv, Dh]
    v_cache: torch.Tensor,
    cur_len,                   # valid cache length INCLUDING the new token
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-step attention over a (padded) KV cache.  ``cur_len`` is an
    int or a 0-d tensor on the cache's device (never read on the host)."""
    B, Lmax, Hkv, Dh = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(Dh)
    qg = q.reshape(B, 1, Hkv, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) * scale
    pos = torch.arange(Lmax, device=q.device)
    mask = pos < cur_len
    if window is not None:
        mask = mask & (pos > cur_len - 1 - window)
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


# --------------------------------------------------------------- activations
# jax.nn's formulas written out op by op: in bfloat16 each op rounds, as the
# reference's do on the CPU (torch's fused F.silu / F.gelu round once, and
# then differ from the reference in a third to two fifths of the elements)
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation; its constants
    are rounded to x's dtype as jax rounds them."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype)
    s = c(float(np.float32(np.sqrt(2 / np.pi))))
    return x * (0.5 * (1.0 + torch.tanh(s * (x + c(0.044715) * (x * x * x)))))


# --------------------------------------------------------------- MLPs
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (silu(g) * u) @ w_down.to(x.dtype)


def geglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
          w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (gelu(g) * u) @ w_down.to(x.dtype)
