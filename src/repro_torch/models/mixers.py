"""Sequence mixers: GQA attention, MLA (DeepSeek-V2), RG-LRU (Griffin /
RecurrentGemma), SSD (Mamba-2), as ``nn.Module``s.

Uniform interface per mixer (the reference's four functions per row of
``MIXERS``):

    Mixer(cfg, device)                 float32 parameters, uninitialised
    .reset_parameters(gen)             the reference's init distributions
    .forward(x, positions)             -> y          (full sequence)
    .decode(x, cache, pos)             -> y          (one step; ``cache``
                                                      written in place)
    Mixer.cache(cfg, batch, max_len, dtype, device)  -> cache dict

``pos`` is a 0-d int tensor on the device (tokens already in the cache):
the decode step reads nothing on the host, so it can be captured in a
CUDA graph.  Parameter names are the reference's pytree keys.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (NEG, Weights, apply_rope,
                                       decode_attention, flash_attention,
                                       flash_attention_vjp, gelu, glorot,
                                       rms_norm, silu)


def _attention(cfg: ModelConfig):
    """The full-sequence attention of ``cfg``: with the recompute-based
    custom backward when ``cfg.flash_vjp`` is set."""
    return flash_attention_vjp if cfg.flash_vjp else flash_attention


def _step_positions(pos: torch.Tensor, batch: int,
                    mrope: bool = False) -> torch.Tensor:
    """[B, 1] (or [B, 1, 3] for M-RoPE) positions of a decode step."""
    positions = pos.reshape(1, 1).expand(batch, 1)
    if mrope:
        positions = positions[..., None].expand(batch, 1, 3)
    return positions


# ===================================================================== GQA
class Attention(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Dh = cfg.d_model, cfg.resolved_head_dim
        self.param("wq", D, cfg.n_heads * Dh, device=device)
        self.param("wk", D, cfg.n_kv_heads * Dh, device=device)
        self.param("wv", D, cfg.n_kv_heads * Dh, device=device)
        self.param("wo", cfg.n_heads * Dh, D, device=device)
        if cfg.qkv_bias:
            self.param("bq", cfg.n_heads * Dh, device=device)
            self.param("bk", cfg.n_kv_heads * Dh, device=device)
            self.param("bv", cfg.n_kv_heads * Dh, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            p = getattr(self, name)
            p.copy_(glorot(p.shape, gen, p.device))
        if self.cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                getattr(self, name).zero_()

    def _qkv(self, x, positions):
        cfg = self.cfg
        B, L, _ = x.shape
        Dh = cfg.resolved_head_dim
        q = x @ self.w("wq", x.dtype)
        k = x @ self.w("wk", x.dtype)
        v = x @ self.w("wv", x.dtype)
        if cfg.qkv_bias:
            q = q + self.w("bq", x.dtype)
            k = k + self.w("bk", x.dtype)
            v = v + self.w("bv", x.dtype)
        q = q.reshape(B, L, cfg.n_heads, Dh)
        k = k.reshape(B, L, cfg.n_kv_heads, Dh)
        v = v.reshape(B, L, cfg.n_kv_heads, Dh)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        return q, k, v

    def forward(self, x, positions):
        cfg = self.cfg
        q, k, v = self._qkv(x, positions)
        out = _attention(cfg)(q, k, v, causal=cfg.causal, window=cfg.window,
                              causal_skip=cfg.flash_causal_skip)
        B, L = x.shape[:2]
        return out.reshape(B, L, -1) @ self.w("wo", x.dtype)

    @staticmethod
    def cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
        Dh = cfg.resolved_head_dim
        # local attention only ever reads the last `window` positions
        clen = min(max_len, cfg.window) if cfg.window else max_len
        shape = (batch, clen, cfg.n_kv_heads, Dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode(self, x, cache, pos):
        """``x``: [B, 1, D]; writes k, v at ``pos`` (``pos % clen`` in the
        local-window ring buffer) in place."""
        cfg = self.cfg
        B = x.shape[0]
        positions = _step_positions(pos, B, bool(cfg.mrope_sections))
        q, k, v = self._qkv(x, positions)
        clen = cache["k"].shape[1]
        slot = (pos % clen if cfg.window else pos).reshape(1)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        if cfg.window:
            # ring buffer: every stored slot is within the window
            valid = torch.clamp(pos + 1, max=clen)
        else:
            valid = pos + 1
        out = decode_attention(q, cache["k"], cache["v"], valid)
        return out.reshape(B, 1, -1) @ self.w("wo", x.dtype)


# ===================================================================== MLA
class MLA(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.d_model, cfg.n_heads
        qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.param("wq", D, H * qd, device=device)
        self.param("w_dkv", D, cfg.kv_lora_rank, device=device)
        self.param("w_kpe", D, cfg.qk_rope_head_dim, device=device)
        self.param("kv_norm", cfg.kv_lora_rank, device=device)
        self.param("w_uk", cfg.kv_lora_rank, H * cfg.qk_nope_head_dim,
                   device=device)
        self.param("w_uv", cfg.kv_lora_rank, H * cfg.v_head_dim,
                   device=device)
        self.param("wo", H * cfg.v_head_dim, D, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("wq", "w_dkv", "w_kpe", "w_uk", "w_uv", "wo"):
            p = getattr(self, name)
            p.copy_(glorot(p.shape, gen, p.device))
        self.kv_norm.fill_(1.0)

    def _qc(self, x, positions):
        """Queries and the compressed KV stream (all that MLA caches)."""
        cfg = self.cfg
        B, L, _ = x.shape
        nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q = (x @ self.w("wq", x.dtype)).reshape(B, L, cfg.n_heads,
                                                nope + rope_d)
        qn, qr = q[..., :nope], q[..., nope:]
        qr = apply_rope(qr, positions, cfg.rope_theta)
        kv_c = rms_norm(x @ self.w("w_dkv", x.dtype), self.kv_norm,
                        cfg.norm_eps)
        kpe = x @ self.w("w_kpe", x.dtype)
        kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
        return qn, qr, kv_c, kpe

    def forward(self, x, positions):
        """Training / prefill path: K and V decompressed from the latent."""
        cfg = self.cfg
        B, L, _ = x.shape
        H = cfg.n_heads
        qn, qr, kv_c, kpe = self._qc(x, positions)
        k_n = (kv_c @ self.w("w_uk", x.dtype)).reshape(
            B, L, H, cfg.qk_nope_head_dim)
        v = (kv_c @ self.w("w_uv", x.dtype)).reshape(B, L, H, cfg.v_head_dim)
        k = torch.cat([k_n, kpe[:, :, None, :].expand(
            B, L, H, cfg.qk_rope_head_dim)], dim=-1)
        q = torch.cat([qn, qr], dim=-1)
        # pad V's head dim up to QK's for the shared flash attention
        qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        v_p = F.pad(v, (0, qd - cfg.v_head_dim))
        out = _attention(cfg)(q, k, v_p, causal=True,
                              causal_skip=cfg.flash_causal_skip)
        out = out[..., :cfg.v_head_dim].reshape(B, L, H * cfg.v_head_dim)
        return out @ self.w("wo", x.dtype)

    @staticmethod
    def cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
        return {"kv_c": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "kpe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                   dtype=dtype, device=device)}

    def decode(self, x, cache, pos):
        """Absorbed-matmul decode: attention runs in the rank-r latent
        space over the cached (kv_c, k_pe)."""
        cfg = self.cfg
        B = x.shape[0]
        H = cfg.n_heads
        qn, qr, kv_c, kpe = self._qc(x, _step_positions(pos, B))
        slot = pos.reshape(1)
        cache["kv_c"].index_copy_(1, slot, kv_c.to(cache["kv_c"].dtype))
        cache["kpe"].index_copy_(1, slot, kpe.to(cache["kpe"].dtype))
        kv_cache, pe_cache = cache["kv_c"], cache["kpe"]
        # absorb W_uk into the query: q_lat [B, 1, H, r]
        w_uk = self.w("w_uk", x.dtype).reshape(cfg.kv_lora_rank, H,
                                               cfg.qk_nope_head_dim)
        q_lat = torch.einsum("bqhn,rhn->bqhr", qn, w_uk)
        scale = 1.0 / np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        s = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), kv_cache.float())
             + torch.einsum("bqhr,bkr->bhqk", qr.float(),
                            pe_cache.float())) * scale
        mask = torch.arange(kv_cache.shape[1], device=x.device) < pos + 1
        s = torch.where(mask, s, NEG)
        prob = torch.softmax(s, dim=-1)
        out_lat = torch.einsum("bhqk,bkr->bqhr", prob,
                               kv_cache.float()).to(x.dtype)
        w_uv = self.w("w_uv", x.dtype).reshape(cfg.kv_lora_rank, H,
                                               cfg.v_head_dim)
        out = torch.einsum("bqhr,rhv->bqhv", out_lat, w_uv)
        return out.reshape(B, 1, H * cfg.v_head_dim) @ self.w("wo", x.dtype)


# ===================================================================== RG-LRU
_LRU_C = 8.0


def causal_conv(x, w, b):
    """Depthwise causal conv of width W over x [B, L, C] (full sequence),
    summed tap by tap in x's dtype as the reference."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    L = x.shape[1]
    for i in range(W):
        out = out + xp[:, i:i + L] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def lru_scan(a: torch.Tensor, gated: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + gated_t over axis 1 from h_0 = 0, in float32.

    The reference uses ``lax.associative_scan``, which has no torch
    counterpart; this is a SEQUENTIAL scan over L (one step per position,
    the decode step's own arithmetic).  The summation order differs from
    the reference's log-step tree, so the two agree within a tolerance."""
    h = torch.zeros_like(gated[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gated[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


class RGLRU(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        dr = cfg.d_rnn or D
        self.param("w_in", D, dr, device=device)     # recurrent branch
        self.param("w_gate", D, dr, device=device)   # GeLU gate branch
        self.param("w_out", dr, D, device=device)
        self.param("conv_w", cfg.conv_width, dr, device=device)
        self.param("conv_b", dr, device=device)
        # diagonal RG-LRU gates
        for name in ("w_rgate", "b_rgate", "w_igate", "b_igate", "lam"):
            self.param(name, dr, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("w_in", "w_gate", "w_out"):
            p = getattr(self, name)
            p.copy_(glorot(p.shape, gen, p.device))
        self.conv_w.copy_(glorot(self.conv_w.shape, gen, self.conv_w.device)
                          * 0.5)
        for name in ("conv_b", "w_rgate", "b_rgate", "w_igate", "b_igate"):
            getattr(self, name).zero_()
        # lambda so that a = sigmoid(lambda)^c lies in (0.9, 0.999)
        dr = self.lam.shape[0]
        self.lam.copy_(torch.as_tensor(
            np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, dr)) / _LRU_C)),
            dtype=torch.float32))

    def _gates(self, u):
        """a_t (decay) and the gated input of the linear recurrence."""
        uf = u.float()
        r = torch.sigmoid(uf * self.w_rgate + self.b_rgate)
        i = torch.sigmoid(uf * self.w_igate + self.b_igate)
        log_a = -_LRU_C * F.softplus(self.lam) * r
        a = torch.exp(log_a)
        gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                       min=1e-12)) * (i * uf)
        return a, gated

    def forward(self, x, positions):
        del positions
        u = x @ self.w("w_in", x.dtype)
        g = x @ self.w("w_gate", x.dtype)
        u = causal_conv(u, self.conv_w, self.conv_b)
        a, gated = self._gates(u)
        h = lru_scan(a, gated)
        y = h.to(x.dtype) * gelu(g)
        return y @ self.w("w_out", x.dtype)

    @staticmethod
    def cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
        dr = cfg.d_rnn or cfg.d_model
        return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, dr),
                                    dtype=dtype, device=device)}

    def decode(self, x, cache, pos):
        del pos
        u = x @ self.w("w_in", x.dtype)                        # [B, 1, dr]
        g = x @ self.w("w_gate", x.dtype)
        hist = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)
        w = self.w("conv_w", x.dtype)
        u_c = (torch.einsum("bwr,wr->br", hist.to(x.dtype), w)[:, None]
               + self.w("conv_b", x.dtype))
        a, gated = self._gates(u_c)
        h = a[:, 0] * cache["h"] + gated[:, 0]
        cache["h"].copy_(h)
        cache["conv"].copy_(hist[:, 1:])
        y = h[:, None].to(x.dtype) * gelu(g)
        return y @ self.w("w_out", x.dtype)


# ===================================================================== SSD
def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., T] -> lower-triangular pairwise sums (float32), -inf above
    the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -torch.inf)


def ssd_scan(x_dt, dA, Bm, Cm, chunk: int):
    """Chunked SSD (Mamba-2 Listing 1).  x_dt: [b, l, h, p] (premultiplied
    by dt), dA: [b, l, h], B, C: [b, l, n].  Returns y [b, l, h, p]."""
    b, l, h, p = x_dt.shape
    n = Bm.shape[-1]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    x_dt = F.pad(x_dt, (0, 0, 0, 0, 0, pad))
    dA = F.pad(dA, (0, 0, 0, pad))
    Bm = F.pad(Bm, (0, 0, 0, pad))
    Cm = F.pad(Cm, (0, 0, 0, pad))

    xc = x_dt.reshape(b, nc, q, h, p)
    Ac = dA.reshape(b, nc, q, h).permute(0, 3, 1, 2)           # [b,h,c,q]
    Bc = Bm.reshape(b, nc, q, n)
    Cc = Cm.reshape(b, nc, q, n)

    A_cum = torch.cumsum(Ac, dim=-1)                           # [b,h,c,q]
    Lmat = torch.exp(segsum(Ac))                               # [b,h,c,q,q]
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Lmat, xc)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)          # [b,h,c,q]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    chunk_decay = torch.exp(A_cum[..., -1])                    # [b,h,c]

    s = torch.zeros((b, h, p, n), dtype=x_dt.dtype, device=x_dt.device)
    prev = []
    for c in range(nc):               # emit the state BEFORE each chunk
        prev.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [b,c,h,p,n]
    state_decay = torch.exp(A_cum)                             # [b,h,c,q]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, nc * q, h, p)
    return y[:, :l]


class SSD(Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        di, n, H = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads
        self.param("w_in", D, 2 * di + 2 * n + H, device=device)  # z,x,B,C,dt
        self.param("conv_w", cfg.conv_width, di + 2 * n, device=device)
        self.param("conv_b", di + 2 * n, device=device)
        self.param("a_log", H, device=device)
        self.param("dt_bias", H, device=device)
        self.param("d_skip", H, device=device)
        self.param("out_norm", di, device=device)
        self.param("w_out", di, D, device=device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        H = self.a_log.shape[0]
        self.w_in.copy_(glorot(self.w_in.shape, gen, self.w_in.device))
        self.conv_w.copy_(glorot(self.conv_w.shape, gen, self.conv_w.device)
                          * 0.5)
        self.conv_b.zero_()
        self.a_log.copy_(torch.as_tensor(np.log(np.linspace(1.0, 16.0, H)),
                                         dtype=torch.float32))
        self.dt_bias.copy_(torch.as_tensor(
            np.log(np.expm1(np.linspace(1e-3, 1e-1, H))), dtype=torch.float32))
        self.d_skip.fill_(1.0)
        self.out_norm.fill_(1.0)
        self.w_out.copy_(glorot(self.w_out.shape, gen, self.w_out.device))

    def _proj(self, x):
        cfg = self.cfg
        di, n = cfg.d_inner, cfg.d_state
        zxbcdt = x @ self.w("w_in", x.dtype)
        return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
                zxbcdt[..., 2 * di + 2 * n:])

    def _post(self, y, z, x_in, d_skip):
        cfg = self.cfg
        b, l = y.shape[:2]
        y = (y + d_skip * x_in).reshape(b, l, cfg.d_inner)   # D skip
        y = rms_norm(y * silu(z), self.out_norm, cfg.norm_eps)
        return y @ self.w("w_out", y.dtype)

    def forward(self, x, positions):
        del positions
        cfg = self.cfg
        di, n, H, P = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads, cfg.ssd_head_dim
        z, xbc, dt_raw = self._proj(x)
        xbc = silu(causal_conv(xbc, self.conv_w, self.conv_b))
        x_in = xbc[..., :di].reshape(*x.shape[:2], H, P)
        Bm = xbc[..., di:di + n]
        Cm = xbc[..., di + n:]
        dt = F.softplus(dt_raw.float() + self.dt_bias)           # [b, l, H]
        dA = -torch.exp(self.a_log) * dt
        x_dt = x_in * dt[..., None].to(x.dtype)
        y = ssd_scan(x_dt.float(), dA, Bm.float(), Cm.float(),
                     cfg.ssd_chunk).to(x.dtype)
        return self._post(y, z, x_in, self.w("d_skip", x.dtype)[:, None])

    @staticmethod
    def cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
        return {"state": torch.zeros((batch, cfg.n_ssd_heads,
                                      cfg.ssd_head_dim, cfg.d_state),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1,
                                     cfg.d_inner + 2 * cfg.d_state),
                                    dtype=dtype, device=device)}

    def decode(self, x, cache, pos):
        del pos
        cfg = self.cfg
        di, n, H, P = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads, cfg.ssd_head_dim
        B = x.shape[0]
        z, xbc, dt_raw = self._proj(x)
        hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
        w = self.w("conv_w", x.dtype)
        xbc_c = (torch.einsum("bwf,wf->bf", hist.to(x.dtype), w)[:, None]
                 + self.w("conv_b", x.dtype))
        xbc_c = silu(xbc_c)
        x_in = xbc_c[..., :di].reshape(B, 1, H, P)
        Bm = xbc_c[..., di:di + n]                               # [B, 1, n]
        Cm = xbc_c[..., di + n:]
        dt = F.softplus(dt_raw.float() + self.dt_bias)[:, 0]     # [B, H]
        dA = torch.exp(-torch.exp(self.a_log) * dt)              # [B, H]
        # S = dA S + dt x (x) B ;  y = C S
        s = cache["state"] * dA[..., None, None]
        s = s + torch.einsum("bhp,bn,bh->bhpn", x_in[:, 0].float(),
                             Bm[:, 0].float(), dt)
        y = torch.einsum("bhpn,bn->bhp", s, Cm[:, 0].float())
        cache["state"].copy_(s)
        cache["conv"].copy_(hist[:, 1:])
        y = y[:, None].to(x.dtype)                               # [B,1,H,P]
        return self._post(y, z, x_in, self.w("d_skip", x.dtype)[:, None])


# ===================================================================== registry
MIXERS = {"attn": Attention, "mla": MLA, "rglru": RGLRU, "ssd": SSD}
