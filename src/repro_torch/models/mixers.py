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

:func:`decode_tp` is one decode step of a mixer on a tensor-parallel model
group (``distributed/tensor_parallel.py``), each rank on its own blocks of
the cache placed by ``cache_shardings``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import (NEG, Weights, apply_rope,
                                       decode_attention,
                                       decode_attention_partial,
                                       finish_partials, flash_attention,
                                       flash_attention_vjp, gelu, glorot,
                                       rescale_partial, rms_norm, silu)


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
        return self.out_product(out.reshape(B, L, -1), "wo")

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
        return self.out_product(out.reshape(B, 1, -1), "wo")


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
        return self.out_product(out, "wo")

    @staticmethod
    def cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
        return {"kv_c": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                "kpe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                   dtype=dtype, device=device)}

    def decode(self, x, cache, pos):
        """Absorbed-matmul decode: attention runs in the rank-r latent
        space over the cached (kv_c, k_pe)."""
        qn, qr, kv_c, kpe = self._qc(x, _step_positions(pos, x.shape[0]))
        self._write(cache, kv_c, kpe, pos)
        return self.out_product(self._attend(qn, qr, cache, pos), "wo")

    @staticmethod
    def _write(cache, kv_c, kpe, pos) -> None:
        slot = pos.reshape(1)
        cache["kv_c"].index_copy_(1, slot, kv_c.to(cache["kv_c"].dtype))
        cache["kpe"].index_copy_(1, slot, kpe.to(cache["kpe"].dtype))

    def _attend(self, qn, qr, cache, pos):
        """The heads' output [B, 1, H * v_head_dim] over the latent
        cache."""
        cfg = self.cfg
        B = qn.shape[0]
        H = cfg.n_heads
        x_dtype = qn.dtype
        kv_cache, pe_cache = cache["kv_c"], cache["kpe"]
        # absorb W_uk into the query: q_lat [B, 1, H, r]
        w_uk = self.w("w_uk", x_dtype).reshape(cfg.kv_lora_rank, H,
                                               cfg.qk_nope_head_dim)
        q_lat = torch.einsum("bqhn,rhn->bqhr", qn, w_uk)
        scale = 1.0 / np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        s = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), kv_cache.float())
             + torch.einsum("bqhr,bkr->bhqk", qr.float(),
                            pe_cache.float())) * scale
        mask = torch.arange(kv_cache.shape[1], device=qn.device) < pos + 1
        s = torch.where(mask, s, NEG)
        prob = torch.softmax(s, dim=-1)
        out_lat = torch.einsum("bhqk,bkr->bqhr", prob,
                               kv_cache.float()).to(x_dtype)
        w_uv = self.w("w_uv", x_dtype).reshape(cfg.kv_lora_rank, H,
                                               cfg.v_head_dim)
        out = torch.einsum("bqhr,rhv->bqhv", out_lat, w_uv)
        return out.reshape(B, 1, H * cfg.v_head_dim)


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
        return self.out_product(y, "w_out")

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
        return self.out_product(y, "w_out")


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
        # the widths the forward reads: a tensor-parallel rank's module
        # holds its heads' share of d_inner and of the heads
        self.d_inner, self.d_state, self.n_heads = di, n, H
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
        di, n = self.d_inner, self.d_state
        zxbcdt = x @ self.w("w_in", x.dtype)
        return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
                zxbcdt[..., 2 * di + 2 * n:])

    def _gated(self, y, z, x_in, d_skip):
        """The D skip and the output gate: what ``out_norm`` normalizes."""
        b, l = y.shape[:2]
        y = (y + d_skip * x_in).reshape(b, l, self.d_inner)   # D skip
        return y * silu(z)

    def _post(self, y, z, x_in, d_skip):
        y = rms_norm(self._gated(y, z, x_in, d_skip), self.out_norm,
                     self.cfg.norm_eps)
        return y @ self.w("w_out", y.dtype)

    def forward(self, x, positions):
        del positions
        return self._post(*self._scan(x), self.w("d_skip", x.dtype)[:, None])

    def _scan(self, x):
        """The projection, the conv and the chunked scan: (y, z, x_in)."""
        cfg = self.cfg
        di, n, H, P = self.d_inner, self.d_state, self.n_heads, cfg.ssd_head_dim
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
        return y, z, x_in

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
        return self._post(*self._step(x, cache),
                          self.w("d_skip", x.dtype)[:, None])

    def _step(self, x, cache):
        """The projection, the conv over the cached window and one state
        update, both written in place: (y, z, x_in) as :meth:`_scan`."""
        cfg = self.cfg
        di, n, H, P = self.d_inner, self.d_state, self.n_heads, cfg.ssd_head_dim
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
        return y[:, None].to(x.dtype), z, x_in                   # [B,1,H,P]


def ssd_partials(group, mods: dict, h: dict, scan=None) -> dict:
    """The split SSD on a tensor-parallel model group: each rank runs its
    heads (``mods[r]`` holds their share of ``w_in``, the conv, the
    per-head tables and ``out_norm``; B and C whole), ``out_norm``'s mean
    square is the all-reduced sum of the ranks' squares over the whole
    ``d_inner``, and each rank's rows of ``w_out`` give its partial of the
    output.  ``scan(module, rank)`` gives a rank's (y, z, x_in): the
    full-sequence scan by default, one decode step in
    :func:`ssd_decode_tp`."""
    gated = {}
    for r in group.members:
        m = mods[r]
        y, z, x_in = scan(m, r) if scan else m._scan(h[r])
        gated[r] = m._gated(y, z, x_in, m.w("d_skip", h[r].dtype)[:, None])
    sq = group.all_reduce({r: (g.float() * g.float()).sum(dim=-1,
                                                         keepdim=True)
                           for r, g in gated.items()})
    out = {}
    for r, g in gated.items():
        m = mods[r]
        var = group.at(sq, r) / m.cfg.d_inner
        y = ((g.float() * torch.rsqrt(var + m.cfg.norm_eps))
             * m.out_norm.float()).to(g.dtype)
        out[r] = m.out_product(y, "w_out")
    return out


# ===================================================================== group decode
def decode_tp(group, mods: dict, h: dict, caches: dict, pos: dict,
              dtype) -> dict:
    """One decode step of a mixer on a tensor-parallel model group, its
    output on every device (``tp.Rep``) in ``dtype``: ``mods[r]`` is rank
    r's module, ``h[r]`` its input [B, 1, D], ``caches[r]`` its blocks of
    the layer's cache (name -> ``tp.CacheBlock``), ``pos`` the position on
    each device.  A module that runs whole (the layer rule) runs
    :meth:`decode` on each device with its cache leaves whole; on a group
    of one rank that is the single-device decode itself."""
    m0 = mods[group.members[0]]
    if not getattr(m0, "tp_split", False):
        return tp.whole_decode(group, mods, caches, lambda m, r, c: m.decode(
            h[r], c, group.at(pos, r)))
    if isinstance(m0, Attention):
        return attention_decode_tp(group, mods, h, caches, pos, dtype)
    if isinstance(m0, MLA):
        return mla_decode_tp(group, mods, h, caches, pos, dtype)
    if isinstance(m0, RGLRU):
        return group.all_reduce({r: mods[r].decode(h[r], _tensors(caches[r]),
                                                   group.at(pos, r))
                                 for r in group.members}, dtype)
    return ssd_decode_tp(group, mods, h, caches, dtype)


def _tensors(blocks: dict) -> dict:
    """A rank's cache blocks as the tensors a module's ``decode`` takes;
    each must be the rank's compute block (heads, channels) or whole."""
    return {n: b.t for n, b in blocks.items()}


def _take(t: torch.Tensor, dim: int, idx: list[int]) -> torch.Tensor:
    """``t``'s positions ``idx`` along ``dim`` (Python ints: slices, no
    device index)."""
    if idx == list(range(t.shape[dim])):
        return t
    runs, start = [], 0
    for i in range(1, len(idx) + 1):
        if i == len(idx) or idx[i] != idx[i - 1] + 1:
            runs.append(t.narrow(dim, idx[start], i - start))
            start = i
    return runs[0] if len(runs) == 1 else torch.cat(runs, dim)


def _kv_layout(group, hq: int, Hkv: int) -> tuple[int, list[int]]:
    """The group size of the GQA heads, and where each kv head lies in the
    ranks' kv heads gathered in rank order (each taken from the first rank
    whose queries read it)."""
    G = hq * group.size // Hkv
    nk = max(1, hq // G)
    idx = []
    for j in range(Hkv):
        r = j * G // hq
        idx.append(r * nk + j - r * hq // G)
    return G, idx


def attend_tp(group, q: dict, kb: dict, vb: dict, valid: dict, hq: int,
              G: int) -> dict:
    """Each member's attention output of its own ``hq`` query heads
    [B, 1, hq, Dh] (``q[r]`` its heads' queries) against the cache blocks
    ``kb[r]``, ``vb[r]`` (``tp.CacheBlock`` [B, L, Hkv, Dh]) of which the
    first ``valid`` positions (on each device) are visible.  Blocks split
    over the length: the queries of every head are all-gathered, each rank
    runs the softmax of every head over its slice
    (``decode_attention_partial``, float32) and the group combines the
    slices: the all-max of the row maxima, the all-reduces of the sums and
    values rescaled to it, divided once.  A whole (replicated) cache: each
    rank reads its own kv heads from its copy."""
    mem = group.members
    if kb[mem[0]].whole:
        out = {}
        for r in mem:
            k0, nk = r * hq // G, max(1, hq // G)
            out[r] = decode_attention(q[r], kb[r].t.narrow(2, k0, nk),
                                      vb[r].t.narrow(2, k0, nk),
                                      group.at(valid, r))
        return out
    q_all = group.all_gather(q, dim=2)
    parts = {r: decode_attention_partial(
        group.at(q_all, r), kb[r].t, vb[r].t, group.at(valid, r),
        kb[r].lo[1]) for r in mem}
    m_all = group.all_max({r: p[0] for r, p in parts.items()})
    scaled = {r: rescale_partial(*p, group.at(m_all, r))
              for r, p in parts.items()}
    l_sum = group.all_reduce({r: s[0] for r, s in scaled.items()})
    acc = group.all_reduce({r: s[1] for r, s in scaled.items()})
    return {r: finish_partials(group.at(l_sum, r), group.at(acc, r),
                               q[r].dtype).narrow(2, r * hq, hq)
            for r in mem}


def attention_decode_tp(group, mods: dict, h: dict, caches: dict, pos: dict,
                        dtype) -> dict:
    """:meth:`Attention.decode` on a model group whose ranks split the
    heads: each rank projects its q heads and its kv heads; the new
    token's k and v of every kv head are all-gathered (each head once)
    and written by the rank whose length slice holds the slot (``pos``,
    ``pos % clen`` in a window's ring), a write predicated on the device
    (a cache replicated over ``model`` is written once a device); then
    :func:`attend_tp`, and each rank's heads through its rows of ``wo``,
    all-reduced."""
    mem = group.members
    cfg = mods[mem[0]].cfg
    hq = cfg.n_heads
    k_blk = {r: caches[r]["k"] for r in mem}
    v_blk = {r: caches[r]["v"] for r in mem}
    clen, Hkv = k_blk[mem[0]].shape[1:3]
    G, idx = _kv_layout(group, hq, Hkv)
    q, k, v = {}, {}, {}
    for r in mem:
        positions = _step_positions(group.at(pos, r), h[r].shape[0],
                                    bool(cfg.mrope_sections))
        q[r], k[r], v[r] = mods[r]._qkv(h[r], positions)
    k_all = group.all_gather(k, dim=2)
    v_all = group.all_gather(v, dim=2)
    slot, valid = {}, {}
    for d, p in pos.items():
        slot[d] = p % clen if cfg.window else p
        valid[d] = torch.clamp(p + 1, max=clen) if cfg.window else p + 1
    if k_blk[mem[0]].whole:
        for d, r in group.places().items():
            for blk, new in ((k_blk[r], k_all[d]), (v_blk[r], v_all[d])):
                blk.t.index_copy_(1, slot[d].reshape(1),
                                  _take(new, 2, idx).to(blk.t.dtype))
    else:
        for r in mem:
            d = group.devices[r]
            tp.owner_write(k_blk[r], 1, slot[d], _take(k_all[d], 2, idx))
            tp.owner_write(v_blk[r], 1, slot[d], _take(v_all[d], 2, idx))
    out = attend_tp(group, q, k_blk, v_blk, valid, hq, G)
    return group.all_reduce({r: mods[r].out_product(
        out[r].reshape(h[r].shape[0], 1, -1), "wo") for r in mem}, dtype)


def mla_decode_tp(group, mods: dict, h: dict, caches: dict, pos: dict,
                  dtype) -> dict:
    """:meth:`MLA.decode` on a model group whose ranks split the heads:
    the latent cache is replicated over ``model`` (one copy a device,
    written once a device); each rank runs its heads' whole softmax over
    it and its rows of ``wo``, all-reduced."""
    mem = group.members
    for r in mem:
        if not all(b.whole for b in caches[r].values()):
            raise ValueError("MLA's latent cache is split over model: "
                             f"{[b.t.shape for b in caches[r].values()]}")
    qc = {r: mods[r]._qc(h[r], _step_positions(group.at(pos, r),
                                                h[r].shape[0]))
          for r in mem}
    for d, r in group.places().items():
        MLA._write(_tensors(caches[r]), qc[r][2], qc[r][3], pos[d])
    return group.all_reduce({r: mods[r].out_product(mods[r]._attend(
        qc[r][0], qc[r][1], _tensors(caches[r]), group.at(pos, r)), "wo")
        for r in mem}, dtype)


def ssd_decode_tp(group, mods: dict, h: dict, caches: dict, dtype) -> dict:
    """:meth:`SSD.decode` on a model group whose ranks split the heads:
    each rank's state block is its heads'; the conv window is stored split
    evenly over its channels, which crosses the rank's compute channels
    (its x slice, B and C whole), so each rank's region is gathered for
    the step (``tp.gather_region``) and the stored shares written back
    after it (``tp.write_back``); the output as :func:`ssd_partials`."""
    mem, T = group.members, group.size
    conv = {r: caches[r]["conv"] for r in mem}
    regions = {}
    for r in mem:
        dl, n = mods[r].d_inner, mods[r].d_state
        ranges = ((r * dl, (r + 1) * dl), (dl * T, dl * T + 2 * n))
        regions[r] = (tp.gather_region(group, conv, r, 2, ranges), ranges)
    out = group.all_reduce(ssd_partials(group, mods, h, lambda m, r: m._step(
        h[r], {"state": caches[r]["state"].t, "conv": regions[r][0]})),
        dtype)
    tp.write_back(group, conv, regions, 2)
    return out


# ===================================================================== registry
MIXERS = {"attn": Attention, "mla": MLA, "rglru": RGLRU, "ssd": SSD}
